"""The port's hybrid family (hymba-1.5b) against the JAX package on the CPU.

The test config is hymba-1.5b ``reduced()`` (d_model 128, 4 query heads
over 2 KV heads, hd 32, d_ff 512, vocab 512, ssm_state 8) with 4 layers in
4 modules (boundaries [1, 2, 3]) and a window of 16, so the sliding window
masks at the test lengths; fp32. Inputs are made with numpy from a seed,
weights by the JAX package and copied through the bridge.

  * EXACT: every config field; the parameter shapes and counts of the full
    config, total and active, and ``count_params_analytic`` against the
    sizes of ``init``; the registry, ``presets.llm`` and the CLI accept the
    arch; the clocks, tiers, uplink bytes and stragglers of a 3-round DTFL
    run.
  * CLOSE, tolerances at each test: ``mamba_apply`` (one chunk of 16, three
    chunks, and a ragged S whose chunk is 10) and the hybrid block, forward
    and gradients; the forward halves and the aux head; the parameters
    after 3 rounds.
"""
import functools

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
from repro.models import model as JM
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
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
from repro_torch.models import ssm
from repro_torch.models import transformer as tfm
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

torch.set_num_threads(2)
ARCH = "hymba-1.5b"
FULL, JFULL = get_config(ARCH), jget_config(ARCH)
RED = dict(n_layers=4, n_modules=4, n_kv_heads=2, window=16, dtype="float32")
CFG, JCFG = FULL.reduced().replace(**RED), JFULL.reduced().replace(**RED)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _stacked(tree):
    """A JAX tree (one model) as the port's: torch leaves with a client axis."""
    return tree_map(lambda t: t[None], from_numpy_tree(_np(tree), "cpu"))


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _shapes(tree[key], f"{prefix}/{key}").items()}
    return {prefix: tuple(tree.shape)}


def test_config_matches_jax_and_is_accepted(capsys):
    assert vars(FULL) == vars(JFULL)
    assert vars(CFG) == vars(JCFG)
    assert (FULL.resolved_head_dim, FULL.padded_vocab) == (64, 32001)
    assert registry.archs.is_ported(ARCH) and registry.archs.build(ARCH) == FULL
    assert train.build_parser().parse_args(["--arch", ARCH]).arch == ARCH
    assert "has no port" not in capsys.readouterr().err
    spec = presets.llm(ARCH, clients=2, seq_len=16)
    assert spec.spec_hash() == japi.ExperimentSpec.from_json(spec.to_json()).spec_hash()
    fed = spec.build(device="cpu")
    assert fed.adapter.cfg == FULL.reduced().replace(tie_embeddings=False)
    assert tfm.block_kind(FULL) == "hybrid"


@pytest.mark.parametrize("tied", [False, True], ids=["as-configured", "tied"])
def test_param_shapes_and_counts_equal_jax(tied):
    cfg, jcfg = FULL.replace(tie_embeddings=tied), JFULL.replace(tie_embeddings=tied)
    shapes = M.init(None, cfg, device="meta")
    jshapes = jax.eval_shape(lambda k: JM.init(k, jcfg), jax.random.PRNGKey(0))
    assert _shapes(shapes) == _shapes(jshapes)
    assert M.count_params_analytic(cfg) == JM.count_params_analytic(jcfg)
    assert M.count_params_analytic(cfg, active_only=True) == \
        JM.count_params_analytic(jcfg, active_only=True) == M.count_params_analytic(cfg)


def test_count_params_analytic_matches_init():
    """The analytic count against the sizes of a real ``init``, as
    ``tests/test_models.py::test_param_count_analytic_matches_init``."""
    for cfg in (FULL.reduced(), CFG):
        params = M.init(torch.Generator().manual_seed(0), cfg)
        assert sum(t.numel() for t in tree_leaves(params)) == M.count_params_analytic(cfg)


# ---------------------------------------------------------------------------
# the Mamba heads and the hybrid block, forward and gradients
# ---------------------------------------------------------------------------

def _grads_close(got, want, rtol, atol):
    """Within rtol, and atol of the leaf's largest magnitude."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol * max(float(np.abs(want).max()), 1e-30))


def _vjp_pair(jfn, tfn, jparams, x, seed):
    """Outputs and the gradients of sum(out * cot) w.r.t. x and the
    parameters, JAX then the port."""
    rng = np.random.default_rng(seed)
    want = jax.jit(jfn)(jnp.asarray(x), jparams)
    cot = rng.standard_normal(want.shape).astype(np.float32)
    jgx, jgp = jax.jit(jax.grad(lambda x, p: jnp.sum(jfn(x, p) * cot), argnums=(0, 1)))(
        jnp.asarray(x), jparams)
    tx = torch.from_numpy(x)[None].requires_grad_(True)
    tp = tree_map(lambda t: t.requires_grad_(True), _stacked(jparams))
    got = tfn(tx, tp)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1,) + want.shape
    leaves = tree_leaves(tp)
    grads = torch.autograd.grad(got, [tx] + leaves, torch.from_numpy(cot)[None])
    tgp = tree_map(lambda t: t[0].numpy(), tree_unflatten(tp, list(grads[1:])))
    return (got[0].detach().numpy(), grads[0][0].numpy(), tgp), (np.asarray(want),
                                                                np.asarray(jgx), _np(jgp))


@pytest.mark.parametrize("S", [16, 48, 20], ids=["one chunk", "three chunks", "chunk 10"])
def test_mamba_apply_matches_jax_fp32(S):
    """The S6 heads: the chunk P = 16 (10 at S = 20, the largest divisor
    below 16), the state carried across chunks, the doubling scan inside a
    chunk against JAX's associative scan, each chunk recomputed in the
    backward. fp32; forward within 1e-5 (relative, and absolute of the
    largest magnitude), gradients within rtol 1e-4 and atol 1e-5 of the
    leaf's largest magnitude (tests/test_torch_step.py's fp32 rule).
    Measured: forward 1.9e-7, gradients 6.4e-7 of their largest magnitude."""
    p = jax.jit(lambda k: jssm.mamba_param_init(k, JCFG))(jax.random.PRNGKey(2))
    x = np.random.default_rng(S).standard_normal((2, S, CFG.d_model)).astype(np.float32)
    got, want = _vjp_pair(lambda x, p: jssm.mamba_apply(x, p, JCFG),
                          lambda x, p: ssm.mamba_apply(x, p, CFG), p, x, seed=S + 1)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5 * np.abs(want[0]).max())
    _grads_close(got[1], want[1], 1e-4, 1e-5)
    assert set(got[2]) == set(want[2])
    for k in want[2]:
        _grads_close(got[2][k], want[2][k], 1e-4, 1e-5)


def test_mamba_softplus_is_jax_softplus():
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) and its gradient
    ``exp(x - softplus(x))``, across ``F.softplus``'s threshold of 20, down
    to -60 (above where exp(x) is an fp32 denormal, which XLA flushes to
    0): the value within 2 ulp, the gradient within 1 (the two libraries'
    exp and log1p; measured: 2 ulp at 60 of 1,205 points, 1 ulp at 64)."""
    x = np.concatenate([np.linspace(-60, 60, 1201), [19.99, 20.0, 20.01, 100.0]])
    x = x.astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    wgrad = np.asarray(jax.grad(lambda x: jnp.sum(jax.nn.softplus(x)))(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = ssm.softplus(tx)
    (g,) = torch.autograd.grad(got.sum(), tx)
    assert (np.abs(got.detach().numpy() - want) <= 2 * np.spacing(want)).all()
    assert (np.abs(g.numpy() - wgrad) <= np.spacing(wgrad)).all()


@pytest.mark.parametrize("S", [48, 40], ids=["window masks", "ragged"])
def test_hybrid_block_matches_jax_fp32(S):
    """The hymba block: windowed attention (window 16) beside the Mamba
    heads on one norm, the fused normed outputs, the MLP. fp32; the rules
    of the Mamba test above. Measured: forward 4.6e-7 of its largest
    magnitude, gradients 1.3e-6 of their leaf's."""
    bp = jax.jit(lambda k: jtfm.block_init(k, JCFG, "hybrid"))(jax.random.PRNGKey(3))
    x = np.random.default_rng(S).standard_normal((2, S, CFG.d_model)).astype(np.float32)
    got, want = _vjp_pair(lambda x, p: jtfm.block_apply(x, p, JCFG, "hybrid")[0],
                          lambda x, p: tfm.hybrid_block_apply(x, p, CFG), bp, x, seed=S + 2)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5 * np.abs(want[0]).max())
    _grads_close(got[1], want[1], 1e-4, 1e-5)
    jax.tree.map(lambda g, w: _grads_close(g, w, 1e-4, 1e-5), got[2], want[2])


@functools.lru_cache(maxsize=None)
def _forward_outputs():
    params = jax.jit(lambda k: JM.init(k, JCFG))(jax.random.PRNGKey(0))
    aux = jax.jit(lambda k: JM.aux_head_init(k, JCFG))(jax.random.PRNGKey(1))
    tokens = np.random.default_rng(0).integers(0, CFG.vocab, (3, 40)).astype(np.int32)
    tier = 2
    jc, js = jtiering.split_params(params, JCFG, tier)

    @jax.jit
    def jax_side(params, jc, js, aux, tokens):
        logits, _ = JM.forward(params, JCFG, {"tokens": tokens})
        z, _ = JM.client_forward(jc, JCFG, {"tokens": tokens})
        slogits, _ = JM.server_forward(js, JCFG, z)
        return logits, z, slogits, JM.aux_head_apply(aux, JCFG, z)

    want = jax_side(params, jc, js, aux, jnp.asarray(tokens))
    batch = {"tokens": torch.from_numpy(tokens)[None]}
    tc, ts = (tree_map(lambda t: t[None], h) for h in
              tiering.split_params(from_numpy_tree(_np(params), "cpu"), CFG, tier))
    logits, maux = M.forward(_stacked(params), CFG, batch)
    z, _ = M.client_forward(tc, CFG, batch)
    slogits, _ = M.server_forward(ts, CFG, z)
    got = (logits, z, slogits, M.aux_head_apply(_stacked(aux), CFG, z))
    assert maux == 0.0
    return [np.asarray(w) for w in want], [g[0].detach().numpy() for g in got]


def test_forward_halves_and_aux_head_match_jax_fp32():
    """forward, client_forward (tier 2: layers 0-1), server_forward and
    aux_head_apply on the JAX package's own initial parameters: atol = rtol
    = 1e-5, as ``tests/test_torch_llm_configs.py`` holds the other configs."""
    want, got = _forward_outputs()
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# DTFL: three rounds, and the CLI
# ---------------------------------------------------------------------------

def test_three_rounds_match_jax():
    """A 3-round DTFL run on the test config, priced on the full
    hymba-1.5b; 4 clients with the CLI's LM data (2 batches of 4 x 32
    tokens each: the window of 16 masks). The port starts from the JAX
    trainer's round-0 parameters and aux heads. EXACT: clocks, tiers,
    uplink bytes, stragglers. CLOSE: the other LLM configs' bounds
    (tests/test_torch_llm_configs.py), in units of U = lr x local steps:
    max 0.5 U, 99th percentile 0.1 U, median 0.01 U. Measured over the
    trees: max 0.302 U, 99th percentile 0.00084 U, median 1.7e-5 U."""
    jad = JAdapter(JCFG, seq_len=32, cost_cfg=JFULL)
    tad = TransformerAdapter(CFG, seq_len=32, cost_cfg=FULL)
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


def test_hymba_cli_runs_on_the_cpu_when_asked(capsys):
    logs = train.main(["--arch", ARCH, "--clients", "2", "--rounds", "1", "--batch-size", "2",
                       "--seq-len", "16", "--device", "cpu"])
    assert len(logs) == 1 and np.isfinite(logs[0].acc)
    assert f"[train] dtfl {ARCH}: 1 rounds" in capsys.readouterr().out
