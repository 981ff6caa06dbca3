"""The port's dense transformer (SmolLM-360M's family) against the JAX
package on the CPU.

The config is ``smollm-360m`` reduced to 6 layers, 4 query heads over 2 KV
heads (hd 32), 4 modules, so that the tiers spread (module boundaries
[2, 4, 5]) and the grouped heads are exercised; the time model prices the
full SmolLM-360M, as the CLI does. ``reduced()`` alone has 2 layers, 4 KV
heads and 2 modules: one tier and no grouping.

  * EXACT: module boundaries, split/merge, parameter shapes and the
    analytic parameter count, the per-tier cost table, the LM batches.
  * CLOSE: forward, client_forward, server_forward and aux_head_apply on
    the JAX package's own initial parameters, copied through the bridge:
    fp32 (``dtype="float32"``) atol 1e-5, rtol 1e-5 (both sides sum fp32
    products in other orders; the logits are O(0.1)); bf16 2e-2, the JAX
    package's own bf16 tolerance for attention (``tests/test_kernels.py:27``),
    since the two frameworks round activations to bf16 at different places
    (relative, and absolute in units of the largest magnitude), and no
    further from the fp32 evaluation than the JAX package's own bf16 is.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import tiering as jtiering
from repro.data.pipeline import SeqClientDataset as JSeqClientDataset
from repro.data.synthetic import SeqTask as JSeqTask
from repro.fed.adapter import TransformerAdapter as JAdapter
from repro.models import model as JM
from repro_torch.bridge import from_numpy_tree, to_numpy_tree
from repro_torch.configs import get_config
from repro_torch.core import tiering
from repro_torch.data.pipeline import SeqClientDataset
from repro_torch.data.synthetic import SeqTask
from repro_torch.fed.adapter import TransformerAdapter
from repro_torch.models import model as M
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(2)
FULL = get_config("smollm-360m")
CFG = FULL.reduced().replace(n_layers=6, n_kv_heads=2, n_modules=4)
JFULL = jget_config("smollm-360m")
JCFG = JFULL.reduced().replace(n_layers=6, n_kv_heads=2, n_modules=4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _stacked(tree):
    """A JAX tree (one model) as the port's: torch leaves with a client axis."""
    return tree_map(lambda t: t[None], from_numpy_tree(_np(tree), "cpu"))


def _shapes(tree, prefix=""):
    """{path: shape} of a nested dict of arrays, tensors or shape structs."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _shapes(tree[key], f"{prefix}/{key}").items()}
    return {prefix: tuple(tree.shape)}


def test_config_matches_jax():
    for name in ("smollm-360m",):
        assert get_config(name) == get_config(name)   # frozen, comparable
        assert vars(get_config(name)) == vars(jget_config(name))
    assert vars(CFG) == vars(JCFG)
    assert (CFG.resolved_head_dim, CFG.padded_vocab) == (JCFG.resolved_head_dim, JCFG.padded_vocab)
    for name in ("pixtral-12b", "whisper-base"):     # ported since: every assigned arch
        assert vars(get_config(name)) == vars(jget_config(name))


@pytest.mark.parametrize("n_layers,n_modules", [(6, 4), (32, 8), (2, 2), (2, 8), (12, 8),
                                                (1, 8), (5, 3), (40, 8)])
def test_module_boundaries_equal_jax(n_layers, n_modules):
    assert tiering.module_boundaries(n_layers, n_modules) == \
        jtiering.module_boundaries(n_layers, n_modules)
    assert tiering.module_boundaries(6, 4) == [2, 4, 5]


@pytest.mark.parametrize("cfg,jcfg", [
    (CFG, JCFG), (CFG.replace(tie_embeddings=False), JCFG.replace(tie_embeddings=False)),
    (FULL, JFULL), (FULL.replace(tie_embeddings=False), JFULL.replace(tie_embeddings=False)),
    (FULL.reduced(), JFULL.reduced()),
], ids=["test-cfg", "test-cfg-untied", "full", "full-untied", "reduced"])
def test_param_shapes_and_count_equal_jax(cfg, jcfg):
    shapes = M.init(None, cfg, device="meta")
    jshapes = jax.eval_shape(lambda k: JM.init(k, jcfg), jax.random.PRNGKey(0))
    assert _shapes(shapes) == _shapes(jshapes)
    assert M.count_params_analytic(cfg) == JM.count_params_analytic(jcfg)
    assert M.count_params_analytic(cfg, active_only=True) == \
        JM.count_params_analytic(jcfg, active_only=True)
    assert cfg.param_count() == jcfg.param_count()


def test_split_and_merge_equal_jax_and_invert():
    params = jax.jit(lambda k: JM.init(k, JCFG))(jax.random.PRNGKey(0))
    tp = from_numpy_tree(_np(params), "cpu")
    for tier in range(1, tiering.n_tiers(CFG) + 1):
        jc, js = jtiering.split_params(params, JCFG, tier)
        tc, ts = tiering.split_params(tp, CFG, tier)
        for got, want in ((tc, jc), (ts, js)):
            assert sorted(got) == sorted(want)
            for g, w in zip(tree_leaves(to_numpy_tree(got)), jax.tree.leaves(_np(want))):
                np.testing.assert_array_equal(g, w)
        # merge takes a cohort's halves (client axis first), as the trainer's
        stacked = tiering.merge_params(tree_map(lambda t: t[None], tc),
                                       tree_map(lambda t: t[None], ts), axis=1)
        for g, w in zip(tree_leaves(stacked), tree_leaves(tp)):
            assert torch.equal(g[0], w)
    # the adapter: split one model at a 0-based tier, merge the cohort's halves
    ad = TransformerAdapter(CFG, seq_len=32, cost_cfg=FULL)
    tp = from_numpy_tree(_np(jax.jit(lambda k: JM.init(k, ad.cfg))(jax.random.PRNGKey(1))), "cpu")
    for tier in range(ad.n_tiers):
        c, s = ad.split(tp, tier)
        assert c["blocks"]["ln1"].shape[0] == tiering.module_boundaries(6, 4)[tier]
        merged = ad.merge(*(tree_map(lambda t: t[None], h) for h in (c, s)))
        assert all(torch.equal(g[0], w) for g, w in zip(tree_leaves(merged), tree_leaves(tp)))


@pytest.mark.parametrize("batch_size,seq_len", [(4, 32), (2, 512), (8, 128)])
def test_tier_costs_equal_jax(batch_size, seq_len):
    for cfg, jcfg, cost, jcost in ((CFG, JCFG, FULL, JFULL), (FULL, JFULL, None, None),
                                   (FULL.reduced(), JFULL.reduced(), FULL, JFULL)):
        got = TransformerAdapter(cfg, seq_len=seq_len, cost_cfg=cost).tier_costs(batch_size)
        want = JAdapter(jcfg, seq_len=seq_len, cost_cfg=jcost).tier_costs(batch_size)
        for field in vars(want):
            a, b = getattr(got, field), getattr(want, field)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b, field


def test_seq_client_dataset_batches_equal_jax():
    for vocab in (512, 49_152):
        got = SeqClientDataset(SeqTask(vocab=vocab), 2, 3, 16, 5)
        want = JSeqClientDataset(JSeqTask(vocab=vocab), 2, 3, 16, 5)
        assert (len(got), got.n_batches) == (len(want), want.n_batches)
        for epoch in (0, 131, 263):
            pairs = list(zip(got.epoch(epoch), want.epoch(epoch)))
            assert len(pairs) == 2
            for a, b in pairs:
                assert sorted(a) == sorted(b) == ["labels", "tokens"]
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])


@functools.lru_cache(maxsize=None)
def _forward_outputs(dtype):
    """(JAX, port) outputs of forward, client_forward (tier 2), server_forward
    and aux_head_apply on the JAX package's initial parameters; fp32 numpy."""
    cfg = CFG.replace(dtype=dtype, tie_embeddings=False)
    jcfg = JCFG.replace(dtype=dtype, tie_embeddings=False)
    params = jax.jit(lambda k: JM.init(k, jcfg))(jax.random.PRNGKey(0))
    aux = jax.jit(lambda k: JM.aux_head_init(k, jcfg))(jax.random.PRNGKey(1))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (3, 40)).astype(np.int32)
    tier = 2
    jc, js = jtiering.split_params(params, jcfg, tier)

    @jax.jit
    def jax_side(params, jc, js, aux, tokens):
        logits, _ = JM.forward(params, jcfg, {"tokens": tokens})
        z, _ = JM.client_forward(jc, jcfg, {"tokens": tokens})
        slogits, _ = JM.server_forward(js, jcfg, z)
        alogits = JM.aux_head_apply(aux, jcfg, z)
        return logits, z, slogits, alogits

    want = jax_side(params, jc, js, aux, jnp.asarray(tokens))
    batch = {"tokens": torch.from_numpy(tokens)[None]}
    tc, ts = tiering.split_params(from_numpy_tree(_np(params), "cpu"), cfg, tier)
    tc, ts = (tree_map(lambda t: t[None], h) for h in (tc, ts))
    logits, _ = M.forward(_stacked(params), cfg, batch)
    z, _ = M.client_forward(tc, cfg, batch)
    slogits, _ = M.server_forward(ts, cfg, z)
    alogits = M.aux_head_apply(_stacked(aux), cfg, z)
    got = (logits, z, slogits, alogits)
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        assert tuple(g.shape) == (1,) + w.shape
    return ([np.asarray(w.astype(jnp.float32)) for w in want],
            [g[0].float().detach().numpy() for g in got])


def test_forward_halves_and_aux_head_match_jax_fp32():
    for got, want in zip(*_forward_outputs("float32")[::-1]):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_forward_halves_and_aux_head_match_jax_bf16():
    """bf16: within 2e-2 of the JAX package's bf16 outputs (relative, and
    absolute in units of the largest magnitude: the residual stream z grows
    to ~8 and carries 4 layers of bf16 roundings taken at other places);
    and no further from the fp32 evaluation than the JAX package's bf16
    outputs are, up to a factor 1.5 (measured: 1.10-1.21)."""
    ref = _forward_outputs("float32")[0]
    jax_bf16, port_bf16 = _forward_outputs("bfloat16")
    for got, want, exact in zip(port_bf16, jax_bf16, ref):
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, atol=2e-2 * scale, rtol=2e-2)
        assert np.abs(got - exact).max() <= 1.5 * np.abs(want - exact).max()
