"""The port's functional train steps (``core/local_loss.py``:
``init_tier_state``, ``make_dtfl_train_step``, ``make_full_train_step``)
against the JAX package's (``repro/core/local_loss.py:46-142``), two steps
each from the same state and batches.

Configs: the reduced smollm-360m, deepseek-moe-16b and pixtral-12b in
fp32, the MoE's capacity pinned to its expert count as
``tests/test_models.py:81-83`` pins it (no token is dropped in either
package, so no route decides a drop); pixtral-12b at its own head dim, 160
(K4's backward at hd 160 here in its plain version), with an 8-patch image
frontend over the first half of the 16 positions, seeded numpy normals.
The JAX package makes the weights, the aux head and the optimizer states;
the bridge copies them, every tree taking the port's client axis of 1.
The DTFL step runs at every tier the reduced config has (``n_modules`` 2:
tier 1).

Tolerances, as ``tests/test_torch_step.py``'s: both metrics and every
state leaf within rtol 1e-4 and atol 1e-5 of the leaf's largest magnitude
(fp32 products and reductions summed in another order), except in the
parameters where a gradient element lies within rounding of zero: Adam's
step there is ``lr * sign(g)`` of a noise sign, so at most 1% of a leaf's
elements may differ by up to the full step difference, 2 * lr a step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import get_config as jget_config
from repro.core import local_loss as jll
from repro.models import model as JM
from repro_torch import optim
from repro_torch.bridge import from_numpy_tree
from repro_torch.configs import get_config
from repro_torch.core import local_loss
from repro_torch.fed.cohort import broadcast_state
from repro_torch.models import model as M
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

torch.set_num_threads(2)
LR = 1e-3
B, S, STEPS = 2, 16, 2
ARCHS = ("smollm-360m", "deepseek-moe-16b", "pixtral-12b")
# overrides of the reduced config: pixtral-12b's head dim, and an image
# that leaves text positions
OVERRIDES = {"pixtral-12b": dict(head_dim=160, n_frontend_tokens=8)}


def _cfgs(arch, **extra):
    """(port, JAX) configs of ``arch``: reduced, fp32."""
    out = []
    for cfg in (get_config(arch), jget_config(arch)):
        red = cfg.reduced().replace(dtype="float32", **OVERRIDES.get(arch, {}), **extra)
        if red.n_experts:
            red = red.replace(capacity_factor=float(red.n_experts))
        out.append(red)
    return tuple(out)


def _stacked(tree):
    """A JAX tree of one client as the port's: a client axis of 1."""
    return tree_map(lambda t: t[None], from_numpy_tree(jax.tree.map(np.asarray, tree), "cpu"))


def _opt(jopt_state):
    """A JAX Adam state as the port's: the learning rate a number."""
    return {"lr": float(jopt_state["lr"]), "t": torch.tensor(np.asarray(jopt_state["t"]))[None],
            "m": _stacked(jopt_state["m"]), "v": _stacked(jopt_state["v"])}


def _batches(cfg):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(STEPS):
        batch = {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
                 for k in ("tokens", "labels")}
        if cfg.frontend != "none":
            batch["frontend"] = rng.standard_normal(
                (B, cfg.n_frontend_tokens, cfg.d_frontend)).astype(np.float32)
        out.append(batch)
    return out


def _by_path(tree, jax_tree: bool) -> dict:
    """{path: leaf as numpy, one client}, paths as tuples of keys."""
    out = {}
    if jax_tree:
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = tuple(getattr(p, "key", getattr(p, "name", getattr(p, "idx", None)))
                        for p in path)
            out[key] = np.asarray(leaf)
    else:
        # the port's learning rate is a Python number, the JAX package's fp32
        tree_map_with_path(lambda p, t: out.__setitem__(
            p, t.detach().numpy()[0] if torch.is_tensor(t) else np.float32(t)), tree)
    return out


def _close(got, want, what):
    want, got = np.asarray(want), np.asarray(got)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale, err_msg=what)


def _assert_state_close(got, want, what):
    g, w = _by_path(got, False), _by_path(want, True)
    assert sorted(g, key=str) == sorted(w, key=str), what
    for path, wl in w.items():
        gl, name = g[path], f"{what} {path}"
        is_param = gl.dtype.kind == "f" and not {"m", "v", "lr"} & set(map(str, path))
        if not is_param:
            _close(gl, wl, name)
            continue
        diff = np.abs(gl - wl)
        far = diff > 1e-4 * np.abs(wl) + 1e-5 * max(1.0, float(np.abs(wl).max()))
        assert (diff[far] <= 2 * LR * STEPS + 1e-6).all(), name
        assert far.mean() <= 0.01, name


def test_init_tier_state_splits_as_jax():
    """The halves and the zero optimizer states equal the JAX package's from
    the same weights; the aux head (a draw of the port's own stream) has
    the JAX head's shapes; every tensor carries a client axis of 1."""
    cfg, jcfg = (c.replace(tie_embeddings=False) for c in _cfgs("smollm-360m"))
    jparams = JM.init(jax.random.PRNGKey(0), jcfg)
    jstate = jll.init_tier_state(jax.random.PRNGKey(1), jcfg, jparams, 1, joptim.adam(LR))
    state = local_loss.init_tier_state(torch.Generator().manual_seed(1), cfg,
                                       from_numpy_tree(jax.tree.map(np.asarray, jparams), "cpu"),
                                       1, optim.adam(LR))
    for field in ("client_params", "server_params", "client_opt", "server_opt"):
        g, w = _by_path(getattr(state, field), False), _by_path(getattr(jstate, field), True)
        assert g.keys() == w.keys()
        for path in w:
            np.testing.assert_array_equal(g[path], w[path], err_msg=f"{field} {path}")
    assert {p: v.shape for p, v in _by_path(state.aux_params, False).items()} == {
        p: v.shape for p, v in _by_path(jstate.aux_params, True).items()}
    assert all(t.shape[0] == 1 for t in tree_leaves(state) if torch.is_tensor(t))


@pytest.mark.parametrize("arch", ARCHS)
def test_dtfl_train_step_matches_jax(arch):
    cfg, jcfg = (c.replace(tie_embeddings=False) for c in _cfgs(arch))
    jopt, opt = joptim.adam(LR), optim.adam(LR)
    jparams = JM.init(jax.random.PRNGKey(0), jcfg)
    assert cfg.n_modules - 1 == 1
    for tier in range(1, cfg.n_modules):
        js = jll.init_tier_state(jax.random.PRNGKey(1), jcfg, jparams, tier, jopt)
        state = local_loss.DTFLState(
            _stacked(js.client_params), _stacked(js.aux_params), _stacked(js.server_params),
            _opt(js.client_opt), _opt(js.aux_opt), _opt(js.server_opt))
        jstep = jax.jit(jll.make_dtfl_train_step(jcfg, jopt))
        step = local_loss.make_dtfl_train_step(cfg, opt)
        for i, batch in enumerate(_batches(cfg)):
            js, jm = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
            state, m = step(state, {k: torch.from_numpy(v)[None] for k, v in batch.items()})
            assert isinstance(m, local_loss.DTFLMetrics)
            assert m.client_loss.shape == m.server_loss.shape == (1,)
            _close(m.client_loss[0], jm.client_loss, f"tier {tier} step {i} client loss")
            _close(m.server_loss[0], jm.server_loss, f"tier {tier} step {i} server loss")
        assert isinstance(state, local_loss.DTFLState)
        _assert_state_close(state, js, f"tier {tier}")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_train_step_matches_jax(arch):
    cfg, jcfg = _cfgs(arch)
    jopt, opt = joptim.adam(LR), optim.adam(LR)
    jparams = JM.init(jax.random.PRNGKey(0), jcfg)
    jo = jopt.init(jparams)
    params, o = _stacked(jparams), _opt(jo)
    jstep = jax.jit(jll.make_full_train_step(jcfg, jopt))
    step = local_loss.make_full_train_step(cfg, opt)
    for i, batch in enumerate(_batches(cfg)):
        jparams, jo, jloss = jstep(jparams, jo, {k: jnp.asarray(v) for k, v in batch.items()})
        params, o, loss = step(params, o, {k: torch.from_numpy(v)[None]
                                           for k, v in batch.items()})
        assert loss.shape == (1,)
        _close(loss[0], jloss, f"step {i} loss")
    _assert_state_close({"params": params, "opt": o}, {"params": jparams, "opt": jo}, arch)


def test_steps_keep_the_trainers_arithmetic():
    """``make_full_train_step`` is the baselines' cohort step at C = 1: from
    the same state and batch, bit for bit."""
    from repro_torch.fed.adapter import TransformerAdapter
    from repro_torch.fed.base import full_step

    cfg, _ = _cfgs("smollm-360m")
    opt = optim.adam(LR)
    one = M.init(torch.Generator().manual_seed(0), cfg)
    params, o = broadcast_state((one, opt.init(one)), 1)
    batch = {k: torch.from_numpy(v)[None] for k, v in _batches(cfg)[0].items()}
    p1, o1, l1 = local_loss.make_full_train_step(cfg, opt)(params, o, batch)
    new, l2 = full_step(TransformerAdapter(cfg, seq_len=S), opt)({"p": params, "o": o}, batch)
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p1), tree_leaves(new["p"])))
