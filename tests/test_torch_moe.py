"""The port's MoE FFN (``repro_torch/models/moe.py``) and the ``moe`` block
kind against the JAX package on the CPU.

Configs: deepseek-moe-16b and llama4-scout reduced (``reduced()``: d_model
128, 4 experts, top-2 and top-1, expert d_ff 256, shared d_ff 256), and
the same with ``capacity_factor = n_experts`` (capacity = the group's
every assignment, so nothing is dropped; ``tests/test_models.py:83`` pins
it so). Inputs are numpy draws from a seed: 2 clients x 3 sequences x 320
tokens, 960 tokens a client, so two dispatch groups of 480. The router is
scaled up and the inputs have a mean of 1, which gives each expert a
logit offset of its own, so the experts' loads are uneven and the capacity
drops tokens in the dropping cases (asserted, not assumed; 94 of 3,840
deepseek and 146 of 1,920 llama4 assignments here).

  * EXACT: ``group_shape``, ``capacity``, parameter shapes, the active
    parameter counts and the MoE tier costs and simulated times; the
    routes (each token's top-k experts) and each assignment's queue
    position, against the JAX package's own router on the same inputs.
  * CLOSE, fp32: outputs rtol = atol = 1e-5 (both sides sum the same fp32
    products in other orders; outputs reach 11, measured max |diff|
    8.0e-6); the load-balance loss atol 1e-6 (it is O(1), E x the dot of
    two means; measured 1.2e-7). bf16 (the full-size
    dtype): outputs 2e-2, as the dense transformer's bf16 tests
    (``tests/test_torch_transformer.py``).
  * BITS, bf16 forward and backward under a seeded bf16 cotangent: the
    output and the gradients of the routed and shared experts are bf16
    values on both sides; at most 2% of each may differ in their bits
    (measured at most 0.7%, one f32 accumulation order against another;
    autograd of SiLU's forward ops, in place of ``jax.nn.silu``'s
    transpose, makes 60% of the w1 gradients differ). The fp32 gradients
    of x and the router: atol 1e-2 and 1e-3 of their largest magnitude
    (measured 4.7e-3 and 1.3e-4: a few tokens' combine cotangents
    one bf16 ulp apart).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import timemodel as jtimemodel
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro_torch.bridge import from_numpy_tree
from repro_torch.configs import get_config
from repro_torch.core import timemodel
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models import transformer as tfm

torch.set_num_threads(2)
MOE_ARCHS = ("deepseek-moe-16b", "llama4-scout-17b-a16e")
C, B, S = 2, 3, 320


def _cfgs(arch, drop: bool):
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    if not drop:
        cfg = cfg.replace(capacity_factor=float(cfg.n_experts))
        jcfg = jcfg.replace(capacity_factor=float(jcfg.n_experts))
    return cfg, jcfg


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _shapes(tree[key], f"{prefix}/{key}").items()}
    return {prefix: tuple(tree.shape)}


def _inputs(cfg, seed=0, router_scale=15.0):
    """Per-client MoE parameters (C, ...) and x (C, B, S, D), numpy fp32."""
    rng = np.random.default_rng(seed)
    params = jax.vmap(lambda k: jmoe.moe_param_init(k, cfg))(
        jax.random.split(jax.random.PRNGKey(seed), C))
    params = jax.tree.map(np.asarray, params)
    params["router"] = params["router"] * router_scale
    x = (rng.standard_normal((C, B, S, cfg.d_model)) + 1.0).astype(np.float32)
    return params, x


def _jax_routes(x, router, cfg):
    """The JAX package's router (``repro/models/moe.py:64-66``) per client:
    (top-k experts, GShard queue positions), (C, G, Tg, K)."""
    G, Tg = jmoe.group_shape(B * S)

    def one(xc, rc):
        logits = xc.reshape(G, Tg, -1).astype(jnp.float32) @ rc
        return jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)[1]

    topi = np.asarray(jax.vmap(one)(jnp.asarray(x), jnp.asarray(router)))
    pos = np.zeros_like(topi)
    for c, g in np.ndindex(topi.shape[:2]):
        queued = np.zeros(cfg.n_experts, np.int64)
        for k in range(cfg.top_k):          # k-th choices after all (k-1)-th ones
            for t in range(Tg):
                e = topi[c, g, t, k]
                pos[c, g, t, k] = queued[e]
                queued[e] += 1
    return topi, pos


@pytest.mark.parametrize("n_tokens", [1, 7, 96, 512, 513, 960, 2048, 4096, 5000])
def test_group_shape_and_capacity_equal_jax(n_tokens):
    assert moe.GROUP_SIZE == jmoe.GROUP_SIZE
    assert moe.group_shape(n_tokens) == jmoe.group_shape(n_tokens)
    for arch in MOE_ARCHS:
        for cfg, jcfg in (_cfgs(arch, True), _cfgs(arch, False),
                          (get_config(arch), jget_config(arch))):
            tg = moe.group_shape(n_tokens)[1]
            assert moe.capacity(tg, cfg) == jmoe.capacity(tg, jcfg)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_moe_param_init_shapes_equal_jax(arch, reduced):
    cfg, jcfg = get_config(arch), jget_config(arch)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    got = moe.moe_param_init(None, cfg, lead=(3,), device="meta")
    want = jax.eval_shape(jax.vmap(lambda k: jmoe.moe_param_init(k, jcfg)),
                          jax.random.split(jax.random.PRNGKey(0), 3))
    assert _shapes(got) == _shapes(want)
    block = tfm.block_init(None, cfg, device="meta")
    jblock = jax.eval_shape(lambda k: jtfm.block_init(k, jcfg, "moe"), jax.random.PRNGKey(0))
    assert _shapes(block) == _shapes(jblock)
    assert tfm.block_kind(cfg) == jtfm.block_kind(jcfg) == "moe"


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("drop", [True, False], ids=["dropping", "no-drop"])
@pytest.mark.parametrize("fn", ["moe_apply", "moe_apply_gather"])
def test_moe_matches_jax_with_equal_routes(arch, drop, fn):
    cfg, jcfg = _cfgs(arch, drop)
    cfg, jcfg = cfg.replace(dtype="float32"), jcfg.replace(dtype="float32")
    params, x = _inputs(jcfg)
    tp, tx = from_numpy_tree(params, "cpu"), torch.from_numpy(x)

    # the routes first: the same experts, the same queue positions
    _, _, topi, pos = moe.route(tx, tp, cfg)
    want_topi, want_pos = _jax_routes(x, params["router"], jcfg)
    np.testing.assert_array_equal(topi.numpy(), want_topi)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    cap = moe.capacity(moe.group_shape(B * S)[1], cfg)
    dropped = int((pos >= cap).sum())
    assert (dropped > 0) == drop, dropped

    jfn = jax.jit(jax.vmap(lambda xc, pc: getattr(jmoe, fn)(xc, pc, jcfg)))
    want, want_aux = jax.tree.map(np.asarray, jfn(jnp.asarray(x), params))
    got, aux = getattr(moe, fn)(tx, tp, cfg)
    assert got.shape == (C, B, S, cfg.d_model) and aux.shape == (C,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aux.numpy(), want_aux, rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_matches_jax_bf16(arch):
    """The full-size dtype: bf16 expert products, fp32 router."""
    cfg, jcfg = _cfgs(arch, True)
    params, x = _inputs(jcfg, seed=1)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).bfloat16()
    tp = from_numpy_tree(params, "cpu")
    _, _, topi, _ = moe.route(tx, tp, cfg)
    want_topi, _ = _jax_routes(np.asarray(xb.astype(jnp.float32)), params["router"], jcfg)
    np.testing.assert_array_equal(topi.numpy(), want_topi)
    want, want_aux = jax.jit(jax.vmap(lambda xc, pc: jmoe.moe_apply(xc, pc, jcfg)))(xb, params)
    got, aux = moe.moe_apply(tx, tp, cfg)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2 * scale)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_gradients_match_jax_bf16(arch):
    cfg, jcfg = _cfgs(arch, True)
    params, x = _inputs(jcfg, seed=1)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    gb = jnp.asarray(np.random.default_rng(2).standard_normal(x.shape).astype(np.float32),
                     dtype=jnp.bfloat16)

    def jax_side(xb, params, gb):
        (out, aux), vjp = jax.vjp(jax.vmap(lambda xc, pc: jmoe.moe_apply(xc, pc, jcfg)),
                                  xb, params)
        return (out, aux) + vjp((gb, jnp.ones_like(aux)))

    want, _, want_gx, want_gp = jax.jit(jax_side)(xb, params, gb)
    tx = torch.from_numpy(np.asarray(xb, dtype=np.float32)).bfloat16().requires_grad_(True)
    tp = from_numpy_tree(params, "cpu")
    for leaf in jax.tree.leaves(tp):
        leaf.requires_grad_(True)
    got, aux = moe.moe_apply(tx, tp, cfg)
    torch.autograd.backward([got, aux], [torch.from_numpy(np.asarray(gb, dtype=np.float32))
                                         .bfloat16(), torch.ones_like(aux)])

    def f32(t):
        return np.asarray(t, dtype=np.float32)

    got_gp = jax.tree.map(lambda t: t.grad.numpy(), tp)
    bf16_valued = [("out", got.detach().float().numpy(), f32(want))] + [
        (jax.tree_util.keystr(path), g, f32(w)) for (path, w), g in zip(
            jax.tree_util.tree_flatten_with_path(want_gp)[0], jax.tree.leaves(got_gp))
        if "router" not in jax.tree_util.keystr(path)]
    assert len(bf16_valued) == 1 + 3 + 3 * bool(cfg.n_shared_experts)
    for name, g, w in bf16_valued:
        assert (g != w).mean() <= 0.02, (name, (g != w).mean())
    for g, w, tol in ((tx.grad.float().numpy(), f32(want_gx), 1e-2),
                      (got_gp["router"], f32(want_gp["router"]), 1e-3)):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * np.abs(w).max())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_block_and_stack_match_jax_with_aux_per_client(arch):
    """A 2-layer ``moe`` stack at a client axis of 2, fp32: the stack's
    output and its aux, the sum over layers of each client's load-balance
    loss, (C,), against the JAX stack under ``vmap``."""
    cfg, jcfg = _cfgs(arch, True)
    cfg, jcfg = cfg.replace(dtype="float32"), jcfg.replace(dtype="float32")
    stacked = jax.vmap(lambda k: jtfm.stack_init(k, jcfg, "moe", 2))(
        jax.random.split(jax.random.PRNGKey(3), C))
    stacked = jax.tree.map(np.asarray, stacked)
    stacked["moe"]["router"] = stacked["moe"]["router"] * 15.0
    x = (np.random.default_rng(3).standard_normal((C, B, S, cfg.d_model)) + 1.0).astype(np.float32)
    ts, tx = from_numpy_tree(stacked, "cpu"), torch.from_numpy(x)

    jstack = jax.jit(jax.vmap(lambda xc, sc: jtfm.stack_apply(xc, sc, jcfg, "moe")))
    want, want_aux = jax.tree.map(np.asarray, jstack(jnp.asarray(x), stacked))
    got, aux = tfm.stack_apply(tx, ts, cfg)
    assert aux.shape == (C,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aux.numpy(), want_aux, rtol=0, atol=2e-6)

    # one block: the same layer-0 output and aux
    jblock = jax.jit(jax.vmap(lambda xc, bc: jtfm.block_apply(xc, bc, jcfg, "moe")))
    b0 = jax.tree.map(lambda t: t[:, 0], stacked)
    want0, want_aux0 = jax.tree.map(np.asarray, jblock(jnp.asarray(x), b0))
    got0, aux0 = tfm.moe_block_apply(tx, from_numpy_tree(b0, "cpu"), cfg)
    np.testing.assert_allclose(got0.numpy(), want0, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aux0.numpy(), want_aux0, rtol=0, atol=1e-6)
    assert float((aux - aux0).abs().min()) > 0       # the second layer adds its own


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_active_param_counts_equal_jax(arch, reduced):
    cfg, jcfg = get_config(arch), jget_config(arch)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    total, active = M.count_params_analytic(cfg), M.count_params_analytic(cfg, active_only=True)
    assert total == JM.count_params_analytic(jcfg)
    assert active == JM.count_params_analytic(jcfg, active_only=True)
    assert total - active == (cfg.n_experts - cfg.top_k) * cfg.n_layers * 3 * cfg.d_model * cfg.d_ff
    assert (cfg.param_count(), cfg.active_param_count()) == \
        (jcfg.param_count(), jcfg.active_param_count())


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("batch_size,seq_len", [(4, 512), (8, 64)])
def test_moe_tier_costs_and_times_equal_jax(arch, batch_size, seq_len):
    """The per-tier cost table of the full MoE config at 8 modules, as the
    adapter prices it (untied embeddings), and the simulated times of every
    tier on the paper's profiles: bit for bit."""
    cfg = get_config(arch).replace(tie_embeddings=False)
    jcfg = jget_config(arch).replace(tie_embeddings=False)
    got = timemodel.transformer_tier_costs(cfg, batch_size, seq_len)
    want = jtimemodel.transformer_tier_costs(jcfg, batch_size, seq_len)
    for field in dataclasses.fields(got):
        np.testing.assert_array_equal(np.asarray(getattr(got, field.name)),
                                      np.asarray(getattr(want, field.name)), err_msg=field.name)
    assert timemodel._active_layer_params(cfg) == jtimemodel._active_layer_params(jcfg)
    for tier in range(cfg.n_modules - 1):
        for prof, jprof in zip(timemodel.PAPER_PROFILES, jtimemodel.PAPER_PROFILES):
            assert timemodel.simulate_client_times(got, tier, prof, 2) == \
                jtimemodel.simulate_client_times(want, tier, jprof, 2)
