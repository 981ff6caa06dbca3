"""The port's encoder-decoder (whisper-base) and VLM (pixtral-12b) families
against the JAX package on the CPU: K4's plain version at the two new
shapes (cross-attention with Sq != Sk, head dim 160), the model API and
serving.

Configs are ``reduced()`` with 4 decoder layers, 4 query heads over 2 KV
heads and 4 modules, so the tiers spread (boundaries [1, 2, 3]) and the
grouped heads are exercised; whisper-base keeps ``reduced()``'s 2 encoder
layers and 16 frames, pixtral-12b its 16 patches, and a third config is
pixtral-12b at its own head dim, 160. Weights are made by the JAX package
and copied through the bridge; tokens (S = 24, so text positions follow
the 16 patches) and the frontend (``0.1 * normal``, as
``tests/test_models.py:20`` draws it) with numpy from a seed.

Tolerances, with their reasons:
  * K4's plain version against the JAX package's jnp attention and its
    Pallas kernel (interpret mode): fp32 1e-5, bf16 2e-2, as
    ``tests/test_torch_attention_xent.py`` states them.
  * forward, encode, the split halves and the aux head: fp32 atol 1e-5,
    rtol 1e-5; bf16 2e-2 relative and absolute of the largest magnitude,
    and no further from the fp32 evaluation than the JAX package's own
    bf16 outputs are, up to 1.5x, as ``tests/test_torch_transformer.py``
    states them.
  * decode: ``decode_step`` with the cross caches filled against the JAX
    package's ``decode_step`` with ``_fill_cross_cache``
    (``tests/test_models.py:63-75``) within 1e-5 (relative, and absolute of
    the largest magnitude); against the port's forward within 2e-4, the
    JAX package's own bound (``tests/test_models.py:99``).
  * EXACT: parameter counts at full size, the bridge's leaves, greedy
    tokens against the JAX decode loop, ``--split-tier`` tokens against the
    monolithic run's, the CLIs' lines, and where training stops.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import tiering as jtiering
from repro.kernels.flash_attention import flash_attention as jflash
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.models import layers as jlayers
from repro.models import model as JM
from repro_torch.bridge import from_numpy_tree, to_numpy_tree
from repro_torch.configs import get_config
from repro_torch.core import tiering
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import attention_bwd_ref, attention_ref
from repro_torch.launch import serve
from repro_torch.launch import train
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(2)
# the test configs: (arch, overrides of the reduced config)
CONFIGS = {"whisper-base": ("whisper-base", {}),
           "pixtral-12b": ("pixtral-12b", {}),
           "pixtral-12b-hd160": ("pixtral-12b", {"head_dim": 160})}
B, S = 3, 24
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(name, dtype="float32"):
    """(port, JAX) test configs of ``name``."""
    arch, extra = CONFIGS[name]
    kw = dict(n_layers=4, n_kv_heads=2, n_modules=4, dtype=dtype, **extra)
    return get_config(arch).reduced().replace(**kw), jget_config(arch).reduced().replace(**kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _stacked(tree):
    """A JAX tree (one model) as the port's: torch leaves with a client axis."""
    return tree_map(lambda t: t[None], from_numpy_tree(_np(tree), "cpu"))


def _batch(cfg, seed=0, batch=B, seq=S):
    """numpy tokens (batch, seq) and the frontend (batch, P, d_front)."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32),
            "frontend": (0.1 * rng.standard_normal(
                (batch, cfg.n_frontend_tokens, cfg.d_frontend or cfg.d_model))
            ).astype(np.float32)}


def _tbatch(batch):
    return {k: torch.from_numpy(v)[None] for k, v in batch.items()}


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _inputs(shapes, dtype, seed=0):
    """numpy fp32 normals, rounded to ``dtype`` the same way on both sides
    (through JAX's cast), as (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    js = [jnp.asarray(rng.normal(0, 1, s).astype(np.float32)).astype(jdt) for s in shapes]
    ts = [torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt) for j in js]
    return js, ts


def _tol(dtype):
    return 1e-5 if dtype == "float32" else 2e-2


# ---------------------------------------------------------------------------
# K4's plain version at the new shapes, and the wrapper's limits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Sk,H,KV", [(24, 16, 4, 2), (7, 40, 4, 4), (30, 9, 6, 1)])
def test_plain_cross_attention_matches_jax_attention(dtype, Sq, Sk, H, KV):
    """Sq != Sk: the plain version and the port's ``attention`` against
    ``repro.models.layers.attention(..., causal=False)``, grouped heads."""
    shapes = [(3, Sq, H, 32), (3, Sk, KV, 32), (3, Sk, KV, 32)]
    (jq, jk, jv), (tq, tk, tv) = _inputs(shapes, dtype)
    want = jax.jit(lambda q, k, v: jlayers.attention(q, k, v, causal=False))(jq, jk, jv)
    got, lse = attention_ref(tq, tk, tv, causal=False)
    assert got.shape == tq.shape and lse.shape == (3, H, Sq) and got.dtype == tq.dtype
    tol = _tol(dtype)
    np.testing.assert_allclose(_np32(got), _np32(want), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np32(layers.attention(tq, tk, tv, causal=False)),
                               _np32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_at_head_dim_160_matches_pallas_kernel_and_jax(dtype, causal):
    """hd 160 (pixtral-12b's), Sq = Sk = 128: the plain version against the
    Pallas kernel in interpret mode, one head per sequence, and against the
    JAX package's jnp attention with 8 query heads over 2."""
    (jq, jk, jv), (tq, tk, tv) = _inputs([(2, 128, 160)] * 3, dtype)
    want = jflash(jq, jk, jv, causal=causal, interpret=True)
    got, _ = attention_ref(tq[:, :, None], tk[:, :, None], tv[:, :, None], causal=causal)
    tol = _tol(dtype)
    np.testing.assert_allclose(_np32(got[:, :, 0]), _np32(want), atol=tol, rtol=tol)
    shapes = [(2, 128, 8, 160), (2, 128, 2, 160), (2, 128, 2, 160)]
    (jq, jk, jv), (tq, tk, tv) = _inputs(shapes, dtype, seed=1)
    want = jax.jit(lambda q, k, v: jlayers.attention(q, k, v, causal=causal))(jq, jk, jv)
    got, _ = attention_ref(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(_np32(got), _np32(want), atol=tol, rtol=tol)


def test_wrapper_refuses_masks_across_lengths_and_backward_at_new_shapes():
    """Sq != Sk takes neither causality nor a window. The backward at Sq !=
    Sk runs (its plain version here; the square kernels over query chunks
    on the card) and equals ``attention_bwd_ref`` on random inputs (which
    ``tests/test_torch_kernels.py`` holds against fp64 autograd there); so
    does the backward at hd 160 (pixtral-12b's heads), called directly and
    through autograd of ``flash_attention``."""
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(*s, generator=g)
                   for s in ((2, 24, 4, 32), (2, 16, 2, 32), (2, 16, 2, 32), (2, 24, 4, 32)))
    for mask in (dict(causal=True), dict(causal=False, window=8)):
        with pytest.raises(ValueError, match="Sq 24 != Sk 16"):
            fa.attn_forward(q, k, v, **mask)
    o, lse = fa.attn_forward(q, k, v, causal=False)
    got = fa.attn_backward(q, k, v, o, lse, do, causal=False)
    want = attention_bwd_ref(q, k, v, o, lse, do, causal=False)
    assert all(a.abs().max() > 0 and torch.equal(a, b) for a, b in zip(got, want))
    q, k, v, do = (torch.randn(*s, generator=g)
                   for s in ((2, 8, 4, 160), (2, 8, 2, 160), (2, 8, 2, 160), (2, 8, 4, 160)))
    o, lse = fa.attn_forward(q, k, v, causal=True)
    got = fa.attn_backward(q, k, v, o, lse, do, causal=True)
    want = attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    assert all(a.abs().max() > 0 and torch.equal(a, b) for a, b in zip(got, want))
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    fa.flash_attention(qa, ka, va, causal=True).backward(do)
    assert all(torch.equal(t.grad, w) for t, w in zip((qa, ka, va), want))


# ---------------------------------------------------------------------------
# the model API
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _forward_outputs(name, dtype):
    """(JAX, port) outputs on the JAX package's initial parameters, as fp32
    numpy lists of equal length: forward's logits, encode's output (the
    encoder-decoder), and for each tier 1-3 client_forward's z (and the
    encoder output it hands over), server_forward's logits and
    aux_head_apply's logits."""
    cfg, jcfg = _cfgs(name, dtype)
    params = jax.jit(lambda k: JM.init(k, jcfg))(jax.random.PRNGKey(0))
    aux = jax.jit(lambda k: JM.aux_head_init(k, jcfg))(jax.random.PRNGKey(1))
    batch = _batch(cfg)
    tiers = (1, 2, 3)
    halves = [jtiering.split_params(params, jcfg, t) for t in tiers]

    @jax.jit
    def jax_side(params, halves, aux, batch):
        out = [JM.forward(params, jcfg, batch)[0]]
        if jcfg.family == "encdec":
            out.append(JM.encode(params, jcfg, batch))
        for jc, js in halves:
            z, _ = JM.client_forward(jc, jcfg, batch)
            out += list(z) if jcfg.family == "encdec" else [z]
            out += [JM.server_forward(js, jcfg, z)[0], JM.aux_head_apply(aux, jcfg, z)]
        return out

    want = jax_side(params, halves, aux, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = _tbatch(batch)
    tp = _stacked(params)
    with torch.no_grad():
        got = [M.forward(tp, cfg, tb)[0]]
        if cfg.family == "encdec":
            got.append(M.encode(tp, cfg, tb))
        for t in tiers:
            tc, ts = tiering.split_params(tp, cfg, t, axis=1)
            z, _ = M.client_forward(tc, cfg, tb)
            got += list(z) if cfg.family == "encdec" else [z]
            got += [M.server_forward(ts, cfg, z)[0], M.aux_head_apply(_stacked(aux), cfg, z)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype) and tuple(g.shape) == (1,) + w.shape
    return [_np32(w) for w in want], [_np32(g[0]) for g in got]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_encode_halves_and_aux_head_match_jax_fp32(name):
    want, got = _forward_outputs(name, "float32")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_encode_halves_and_aux_head_match_jax_bf16(name):
    ref = _forward_outputs(name, "float32")[0]
    jax_bf16, port_bf16 = _forward_outputs(name, "bfloat16")
    for got, want, exact in zip(port_bf16, jax_bf16, ref):
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, atol=2e-2 * scale, rtol=2e-2)
        assert np.abs(got - exact).max() <= 1.5 * np.abs(want - exact).max()


def test_vlm_patches_reach_the_text_and_need_room():
    """pixtral's forward with the image differs from the dense forward of
    the same weights at the text positions too (attention carries the
    patches on); fewer positions than patches raise."""
    cfg, _ = _cfgs("pixtral-12b")
    params = tree_map(lambda t: t[None], M.init(torch.Generator().manual_seed(0), cfg))
    tb = _tbatch(_batch(cfg))
    with torch.no_grad():
        vlm, _ = M.forward(params, cfg, tb)
        dense, _ = M.forward(params, cfg.replace(family="dense"), tb)
    P = cfg.n_frontend_tokens
    assert (vlm[:, :, P:] - dense[:, :, P:]).abs().amin(-1).max() > 0
    with pytest.raises(ValueError, match="do not fit"):
        M.embed_tokens(params, cfg, _tbatch(_batch(cfg, seq=P - 1)))


@pytest.mark.parametrize("arch", ["whisper-base", "pixtral-12b"])
def test_param_counts_and_leaves_equal_jax_at_full_size(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for active in (False, True):
        assert M.count_params_analytic(cfg, active) == JM.count_params_analytic(jcfg, active)
    shapes = jax.eval_shape(lambda k: JM.init(k, jcfg), jax.random.PRNGKey(0))
    got = M.init(None, cfg, device="meta")
    jl = {k: tuple(v.shape) for k, v in _flat(shapes).items()}
    assert {k: tuple(v.shape) for k, v in _flat(got).items()} == jl


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], f"{prefix}/{key}").items()}
    return {prefix: tree}


def test_bridge_carries_the_encoder_and_projector_unchanged():
    """``front_proj``, ``enc_blocks`` and ``enc_ln`` cross leaf by leaf both
    ways, bit for bit, and the port's tiering puts them on the client."""
    cfg, jcfg = _cfgs("whisper-base")
    params = _np(jax.jit(lambda k: JM.init(k, jcfg))(jax.random.PRNGKey(0)))
    back = to_numpy_tree(from_numpy_tree(params, "cpu"))
    for key in ("front_proj", "enc_blocks", "enc_ln"):
        want, got = _flat(params[key]), _flat(back[key])
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    client, server = tiering.split_params(from_numpy_tree(params, "cpu"), cfg, 2)
    assert {"front_proj", "enc_blocks", "enc_ln"} <= set(client)
    assert not {"front_proj", "enc_blocks", "enc_ln"} & set(server)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _jax_cross_cache(jcfg, params, batch, cache):
    """``tests/test_models.py:63-75``: each decoder layer's cross keys and
    values, ``enc @ xattn.wk[i]``."""
    enc = JM.encode(params, jcfg, batch)
    dt = jlayers.cdtype(jcfg)
    hd = jcfg.resolved_head_dim
    n = enc.shape[0]
    for name, w in (("xk", "wk"), ("xv", "wv")):
        cache["layers"][name] = jnp.stack([
            (enc.astype(dt) @ params["blocks"]["xattn"][w][i].astype(dt))
            .reshape(n, -1, jcfg.n_kv_heads, hd) for i in range(jcfg.n_layers)])
    return cache


@functools.lru_cache(maxsize=None)
def _decode_runs(name):
    """The JAX decode loop, the port's decode loop and the port's forward
    (the dense forward for the VLM, whose decode embeds tokens only) over
    the same tokens, fp32: logits (B, S, V) each, as numpy."""
    cfg, jcfg = _cfgs(name)
    params = jax.jit(lambda k: JM.init(k, jcfg))(jax.random.PRNGKey(0))
    batch = _batch(cfg, seed=1, seq=16)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    cache = JM.init_cache(jcfg, B, 16)
    if jcfg.family == "encdec":
        cache = _jax_cross_cache(jcfg, params, jbatch, cache)
    step = jax.jit(lambda p, t, c: JM.decode_step(p, jcfg, t, c))
    want = []
    for t in range(16):
        lg, cache = step(params, jbatch["tokens"][:, t], cache)
        want.append(np.asarray(lg))
    tp, tb = _stacked(params), _tbatch(batch)
    tcache, got = M.init_cache(cfg, B, 16), []
    with torch.no_grad():
        if cfg.family == "encdec":
            M.fill_cross_cache(tp["blocks"], cfg, M.encode(tp, cfg, tb), tcache)
        for t in range(16):
            lg, tcache = M.decode_step(tp, cfg, tb["tokens"][:, :, t], tcache)
            got.append(lg[0].numpy())
        fcfg = cfg if cfg.family == "encdec" else cfg.replace(family="dense")
        fwd, _ = M.forward(tp, fcfg, tb)
    return np.stack(want, 1), np.stack(got, 1), fwd[0].numpy()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_step_with_cross_cache_matches_jax(name):
    want, got, _ = _decode_runs(name)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_matches_own_forward(name):
    _, got, fwd = _decode_runs(name)
    np.testing.assert_allclose(got, fwd, rtol=0, atol=2e-4)


def test_cross_cache_layout_matches_jax():
    """A decoder layer's cache holds the JAX package's k, v, xk and xv with a
    client axis in front, each in memory of its own (the captured step
    writes k and v in place and reads xk and xv)."""
    cfg, jcfg = _cfgs("whisper-base")
    jcache = JM.init_cache(jcfg, 3, 12)
    cache = M.init_cache(cfg, 3, 12)
    jl = jax.tree.map(lambda a: (tuple(a.shape[1:]), str(a.dtype)), jcache["layers"])
    for layer in cache["layers"]:
        tl = tree_map(lambda t: (tuple(t.shape[1:]), str(t.dtype).removeprefix("torch.")), layer)
        assert tl == jl and all(t.shape[0] == 1 for t in tree_leaves(layer))
    leaves = tree_leaves(cache)
    assert len({t.data_ptr() for t in leaves}) == len(leaves)


@pytest.mark.parametrize("name", ["whisper-base", "pixtral-12b"])
def test_greedy_tokens_match_jax_decode_loop(name):
    """``generate`` (prompt of 6 stepped, then 10 greedy tokens; whisper
    with a seeded frontend) gives the tokens of the JAX package's decode
    loop from the same weights (``repro/launch/serve.py:114-125``)."""
    cfg, jcfg = _cfgs(name)
    params = jax.jit(lambda k: JM.init(k, jcfg))(jax.random.PRNGKey(0))
    batch = _batch(cfg, seed=2, seq=6)
    total = 16
    cache = JM.init_cache(jcfg, B, total)
    frontend = None
    if jcfg.family == "encdec":
        cache = _jax_cross_cache(jcfg, params, {k: jnp.asarray(v) for k, v in batch.items()},
                                 cache)
        frontend = torch.from_numpy(batch["frontend"])[None]
    step = jax.jit(lambda p, t, c: JM.decode_step(p, jcfg, t, c))
    prompt = batch["tokens"]
    tok = jnp.asarray(prompt[:, 0])
    want = [tok]
    for i in range(total - 1):
        logits, cache = step(params, tok, cache)
        tok = jnp.asarray(prompt[:, i + 1]) if i + 1 < 6 else jnp.argmax(logits, -1)
        want.append(tok)
    want = np.stack([np.asarray(t) for t in want], 1)
    got = serve.generate(cfg, _stacked(params), torch.from_numpy(prompt)[None], total - 6,
                         frontend=frontend)
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("name", ["whisper-base", "pixtral-12b"])
def test_split_tier_gives_the_monolithic_tokens(name):
    """At every tier, the client's half (and whisper's encoder) then the
    server's half of each step, each with its own caches, the server's
    cross caches filled from the client's encoder output: the tokens of the
    monolithic run, bit for bit, with a seeded frontend."""
    cfg, _ = _cfgs(name)
    gen = torch.Generator().manual_seed(0)
    params = tree_map(lambda t: t[None], M.init(gen, cfg))
    prompt = torch.randint(0, cfg.vocab, (1, 2, 5), generator=gen)
    frontend = None
    if cfg.family == "encdec":
        frontend = 0.1 * torch.randn(1, 2, cfg.n_frontend_tokens, cfg.d_frontend, generator=gen)
    mono = serve.generate(cfg, params, prompt, 8, frontend=frontend)
    for tier in (1, 2, 3):
        assert torch.equal(serve.generate(cfg, params, prompt, 8, split_tier=tier,
                                          frontend=frontend), mono)
    if frontend is not None:     # the frames reach the tokens
        assert not torch.equal(serve.generate(cfg, params, prompt, 8,
                                              frontend=torch.zeros_like(frontend)), mono)
        with pytest.raises(ValueError, match="takes its frontend"):
            serve.generate(cfg, params, prompt, 8)


@pytest.mark.parametrize("arch", ["whisper-base", "pixtral-12b"])
def test_serve_cli_prints_the_jax_cli_lines(arch, capsys):
    """The port's CLI at the reduced size prints the JAX CLI's lines (the
    split line equal, the result line of the same form); whisper's
    ``--split-tier`` run gives the monolithic tokens."""
    argv = ["--arch", arch, "--batch", "2", "--prompt-len", "4", "--tokens", "8"]
    seq = serve.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert tuple(seq.shape) == (1, 2, 12)
    line = re.compile(rf"\[serve\] {re.escape(arch)}: 2 seqs x 12 steps in [0-9.]+s "
                      r"\([0-9.]+ tok/s\); sample: \[[0-9, ]+\]")
    assert line.fullmatch(out[-1]), out
    assert out[-1].endswith(f"sample: {seq[0, 0, :24].tolist()}")
    split = serve.main(argv + ["--device", "cpu", "--split-tier", "1"])
    tout = capsys.readouterr().out.strip().splitlines()
    assert torch.equal(split, seq)
    jserve.main(argv + ["--split-tier", "1"])
    jout = capsys.readouterr().out.strip().splitlines()
    assert jout[0] == tout[0] and len(jout) == len(tout) == 2
    assert line.fullmatch(jout[-1]), jout


@pytest.mark.parametrize("arch,where", [("whisper-base", "encode"),
                                        ("pixtral-12b", "embed_tokens")])
def test_train_cli_fails_where_the_jax_cli_fails(arch, where):
    """``--arch whisper-base`` and ``pixtral-12b`` build and then fail at the
    first client step with ``KeyError: 'frontend'`` in the same function
    (``encode``; ``embed_tokens``) in both packages: the LM batches carry
    tokens and labels only."""
    argv = ["--arch", arch, "--clients", "2", "--rounds", "1", "--batch-size", "2",
            "--seq-len", "16"]
    for main, extra in ((train.main, ["--device", "cpu"]), (jtrain.main, [])):
        with pytest.raises(KeyError, match="frontend") as err:
            main(argv + extra)
        # the port reads the frames in a helper of those functions
        assert where in [entry.name for entry in err.traceback[-2:]], main
