"""The five transformer configs this port added against the JAX package on
the CPU: granite-3-2b, yi-6b and deepseek-67b (dense) and deepseek-moe-16b
and llama4-scout-17b-a16e (MoE).

The test config of each is ``reduced()`` (d_model 128, 4 query heads,
vocab 512) with 4 layers in 4 modules, so that the tiers spread (module
boundaries [1, 2, 3]), and 2 KV heads where the full config groups its
query heads (all but deepseek-moe-16b, which is MHA), so the grouped heads
are exercised; fp32. The time model prices the full config, as the CLI
does.

  * EXACT: every config field; the parameter shapes and counts, total and
    active, of the full config, tied and untied; the registry and the
    CLI's ``--arch`` accept each; the clocks, tier assignments, uplink
    bytes and stragglers of a 3-round DTFL run.
  * CLOSE: forward, client_forward, server_forward and aux_head_apply on
    the JAX package's own initial parameters, copied through the bridge:
    atol = rtol = 1e-5, as ``tests/test_torch_transformer.py`` holds
    SmolLM-360M; an MoE model's aux loss (C,) atol 1e-6. The 3-round run
    starts from the JAX trainer's round-0 parameters and aux heads and is
    held to SmolLM-360M's bounds (``tests/test_torch_dtfl.py``), in units
    of U = lr x local steps: max 0.5 U, 99th percentile 0.1 U, median
    0.01 U. Measured (max / 99th percentile / median over the trees):
    deepseek-moe-16b 0.398 / 0.032 / 0.0006 U, llama4-scout 0.129 /
    0.00023 / 9.9e-6 U, the dense three 0.060 / 4.5e-5 / 1.9e-6 U.
    ``reduced()`` gives the three dense configs the same shapes (they
    differ in name, tied embeddings, which DTFL unties, and the full
    config that prices them).
  * SPREAD: the two MoE configs in bf16, as both CLIs build them reduced (4
    clients, batches of 4 x 64 tokens, 3 rounds; the run ``chip_smoke.py``
    holds card against CPU), the port from the JAX trainer's round-0
    weights. Logs EXACT. In bf16 a route flipped at a near-tie moves a
    token's whole expert update, so the parameters are held to the JAX
    package's own spread, measured here: the JAX run again from weights
    moved by one ulp in half their elements. Bounds, per tree: max 1 U
    (as ``tests/test_torch_xlstm.py``), 99th percentile and median at most
    twice the JAX run's own. Measured on the CPU (max / 99th percentile /
    median, U), port against JAX and JAX against itself: deepseek-moe-16b
    0.478 / 0.173 / 0.0090 and 0.442 / 0.141 / 0.0054, llama4-scout 0.503 /
    0.187 / 0.0108 and 0.436 / 0.167 / 0.0081 (the dense yi-6b 0.280 /
    0.089 / 0.0017 and 0.261 / 0.086 / 0.0013).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import optim as joptim
from repro.configs import get_config as jget_config
from repro.core import tiering as jtiering
from repro.data.pipeline import SeqClientDataset as JSeqClientDataset
from repro.data.synthetic import SeqTask as JSeqTask
from repro.fed.adapter import TransformerAdapter as JAdapter
from repro.fed.client import HeteroEnv as JHeteroEnv
from repro.fed.client import SimClient as JSimClient
from repro.fed.dtfl import DTFLTrainer as JTrainer
from repro.launch import train as jtrain
from repro.models import model as JM
from repro_torch import optim as toptim
from repro_torch import presets, registry
from repro_torch.bridge import from_numpy_tree, to_numpy_tree
from repro_torch.configs import get_config
from repro_torch.core import tiering
from repro_torch.data.pipeline import SeqClientDataset
from repro_torch.data.synthetic import SeqTask
from repro_torch.fed.adapter import TransformerAdapter
from repro_torch.fed.client import HeteroEnv, SimClient
from repro_torch.fed.dtfl import DTFLTrainer
from repro_torch.launch import train
from repro_torch.models import model as M
from repro_torch.tree import tree_map

torch.set_num_threads(2)
ARCHS = ("granite-3-2b", "yi-6b", "deepseek-67b", "deepseek-moe-16b", "llama4-scout-17b-a16e")


def _test_cfg(cfg):
    red = dict(n_layers=4, n_modules=4, dtype="float32")
    if cfg.n_kv_heads < cfg.n_heads:
        red["n_kv_heads"] = 2
    return cfg.reduced().replace(**red)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _stacked(tree):
    """A JAX tree (one model) as the port's: torch leaves with a client axis."""
    return tree_map(lambda t: t[None], from_numpy_tree(_np(tree), "cpu"))


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _shapes(tree[key], f"{prefix}/{key}").items()}
    return {prefix: tuple(tree.shape)}


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax_and_is_accepted(arch, capsys):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert vars(cfg) == vars(jcfg)
    assert vars(_test_cfg(cfg)) == vars(_test_cfg(jcfg))
    assert (cfg.resolved_head_dim, cfg.padded_vocab, cfg.d_ff_shared_resolved) == \
        (jcfg.resolved_head_dim, jcfg.padded_vocab, jcfg.d_ff_shared_resolved)
    assert registry.archs.is_ported(arch) and registry.archs.build(arch) == cfg
    assert train.build_parser().parse_args(["--arch", arch]).arch == arch
    assert "has no port" not in capsys.readouterr().err
    spec = presets.llm(arch, clients=2, seq_len=16)
    assert spec.spec_hash() == japi.ExperimentSpec.from_json(spec.to_json()).spec_hash()
    fed = spec.build(device="cpu")
    assert fed.adapter.cfg == cfg.reduced().replace(tie_embeddings=False)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tied", [True, False], ids=["as-configured", "untied"])
def test_param_shapes_and_counts_equal_jax(arch, tied):
    cfg, jcfg = get_config(arch), jget_config(arch)
    if not tied:
        cfg, jcfg = cfg.replace(tie_embeddings=False), jcfg.replace(tie_embeddings=False)
    shapes = M.init(None, cfg, device="meta")
    jshapes = jax.eval_shape(lambda k: JM.init(k, jcfg), jax.random.PRNGKey(0))
    assert _shapes(shapes) == _shapes(jshapes)
    assert M.count_params_analytic(cfg) == JM.count_params_analytic(jcfg)
    assert M.count_params_analytic(cfg, active_only=True) == \
        JM.count_params_analytic(jcfg, active_only=True)


def _forward_outputs(arch):
    # untied, as DTFL trains every config (granite ties its embeddings)
    cfg, jcfg = (_test_cfg(c).replace(tie_embeddings=False)
                 for c in (get_config(arch), jget_config(arch)))
    params = jax.jit(lambda k: JM.init(k, jcfg))(jax.random.PRNGKey(0))
    aux = jax.jit(lambda k: JM.aux_head_init(k, jcfg))(jax.random.PRNGKey(1))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (3, 40)).astype(np.int32)
    tier = 2
    jc, js = jtiering.split_params(params, jcfg, tier)

    @jax.jit
    def jax_side(params, jc, js, aux, tokens):
        logits, maux = JM.forward(params, jcfg, {"tokens": tokens})
        z, caux = JM.client_forward(jc, jcfg, {"tokens": tokens})
        slogits, saux = JM.server_forward(js, jcfg, z)
        alogits = JM.aux_head_apply(aux, jcfg, z)
        return (logits, z, slogits, alogits), (maux, caux, saux)

    want, want_aux = jax_side(params, jc, js, aux, jnp.asarray(tokens))
    batch = {"tokens": torch.from_numpy(tokens)[None]}
    tc, ts = tiering.split_params(from_numpy_tree(_np(params), "cpu"), cfg, tier)
    tc, ts = (tree_map(lambda t: t[None], h) for h in (tc, ts))
    logits, maux = M.forward(_stacked(params), cfg, batch)
    z, caux = M.client_forward(tc, cfg, batch)
    slogits, saux = M.server_forward(ts, cfg, z)
    alogits = M.aux_head_apply(_stacked(aux), cfg, z)
    return cfg, (logits, z, slogits, alogits), (maux, caux, saux), want, want_aux


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_halves_and_aux_head_match_jax_fp32(arch):
    cfg, got, got_aux, want, want_aux = _forward_outputs(arch)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == (1,) + w.shape
        np.testing.assert_allclose(g[0].detach().numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
    for g, w in zip(got_aux, want_aux):
        if cfg.family == "moe":
            assert tuple(g.shape) == (1,)
            np.testing.assert_allclose(g.detach().numpy(), [float(w)], rtol=0, atol=1e-6)
        else:
            assert g == 0.0 and float(w) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_three_rounds_match_jax(arch):
    """A 3-round DTFL run on the test config, priced on the full config; 4
    clients with the CLI's LM data (2 batches of 4 x 32 tokens each). The
    JAX trainer is built directly (the CLI cannot make this config); the
    port starts from its round-0 parameters and aux heads."""
    jfull, full = jget_config(arch), get_config(arch)
    jad = JAdapter(_test_cfg(jfull), seq_len=32, cost_cfg=jfull)
    tad = TransformerAdapter(_test_cfg(full), seq_len=32, cost_cfg=full)
    jtask, task = JSeqTask(vocab=jad.cfg.vocab), SeqTask(vocab=tad.cfg.vocab)
    jt = JTrainer(jad, [JSimClient(i, JSeqClientDataset(jtask, 2, 4, 32, i), None)
                        for i in range(4)], JHeteroEnv(4), joptim.adam(1e-3), seed=0)
    tt = DTFLTrainer(tad, [SimClient(i, SeqClientDataset(task, 2, 4, 32, i), None)
                           for i in range(4)], HeteroEnv(4), toptim.adam(1e-3), seed=0,
                     device="cpu")
    tt.params = from_numpy_tree(_np(jt.params), "cpu")
    tt.aux = {m: from_numpy_tree(_np(a), "cpu") for m, a in jt.aux.items()}
    eval_batch = next(task.batches(4, 32, 1, seed=99))

    jlogs = jt.run(3, eval_batch)
    tlogs = tt.run(3, eval_batch)
    assert len(tlogs) == len(jlogs) == 3
    for a, b in zip(jlogs, tlogs):
        assert (b.clock, b.assignment, b.uplink_bytes, b.straggler) == \
            (a.clock, a.assignment, a.uplink_bytes, a.straggler)
    assert len({t for log in tlogs for t in log.assignment.values()}) > 1, \
        "expected several tiers across the rounds"

    unit = 1e-3 * 3 * 2
    for got, want in [(tt.params, jt.params)] + [(tt.aux[m], jt.aux[m]) for m in jt.aux]:
        d = np.concatenate([np.abs(g - w).ravel() for g, w in zip(
            jax.tree.leaves(to_numpy_tree(got)), jax.tree.leaves(_np(want)))])
        assert np.isfinite(d).all()
        assert d.max() <= 0.5 * unit, d.max() / unit
        assert np.quantile(d, 0.99) <= 0.1 * unit, np.quantile(d, 0.99) / unit
        assert np.median(d) <= 0.01 * unit, np.median(d) / unit


def _one_ulp_up(tree, seed: int = 1):
    """Every leaf with half its elements moved one fp32 ulp up (seeded)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: jnp.asarray(np.where(
        rng.random(x.shape) < 0.5, np.nextafter(x, np.float32(np.inf)), x)), _np(tree))


def _spread(got_trees, want_trees, unit):
    """(max, 99th percentile, median) |got - want| in U, one row per tree."""
    rows = []
    for got, want in zip(got_trees, want_trees):
        d = np.concatenate([np.abs(np.asarray(g) - np.asarray(w)).ravel() for g, w in zip(
            jax.tree.leaves(got), jax.tree.leaves(want))])
        assert np.isfinite(d).all()
        rows.append(np.array([d.max(), np.quantile(d, 0.99), np.median(d)]) / unit)
    return rows


@pytest.mark.parametrize("arch", ("deepseek-moe-16b", "llama4-scout-17b-a16e"))
def test_three_rounds_bf16_moe_within_the_jax_package_own_spread(arch):
    flags = ["--arch", arch, "--clients", "4", "--batch-size", "4", "--seq-len", "64",
             "--rounds", "3", "--lr", "1e-3"]
    jfeds = [jtrain.spec_from_args(jtrain.build_parser().parse_args(flags)).build()
             for _ in range(2)]
    jt, jt2 = (fed.trainer for fed in jfeds)
    assert jt.adapter.cfg.dtype == "bfloat16" and jt.adapter.cfg.family == "moe"
    tt, eval_batch = train.build(train.build_parser().parse_args(flags + ["--device", "cpu"]))
    tt.params = from_numpy_tree(_np(jt.params), "cpu")
    tt.aux = {m: from_numpy_tree(_np(a), "cpu") for m, a in jt.aux.items()}
    jt2.params = _one_ulp_up(jt.params)

    jlogs, jlogs2 = (fed.run() for fed in jfeds)
    tlogs = tt.run(3, eval_batch)
    assert len(tlogs) == len(jlogs) == 3
    for a, b in zip(jlogs, tlogs):
        assert (b.clock, b.assignment, b.uplink_bytes, b.straggler) == \
            (a.clock, a.assignment, a.uplink_bytes, a.straggler)
    unit = 1e-3 * 3 * max(c.n_batches for c in tt.clients)
    want = [_np(jt.params)] + [_np(jt.aux[m]) for m in jt.aux]
    port = _spread([to_numpy_tree(tt.params)] + [to_numpy_tree(tt.aux[m]) for m in jt.aux],
                   want, unit)
    own = _spread([_np(jt2.params)] + [_np(jt2.aux[m]) for m in jt.aux], want, unit)
    for (pmax, p99, pmed), (_, o99, omed) in zip(port, own):
        assert pmax <= 1.0, pmax
        assert p99 <= 2 * o99, (p99, o99)
        assert pmed <= 2 * omed, (pmed, omed)
