"""The port's serving path (KV-cache decode and the serve CLI) against the
JAX package on the CPU.

The four families the port trains: smollm-360m (dense, tied embeddings),
deepseek-moe-16b (MoE, capacity pinned to the expert count as
``tests/test_models.py:81-83`` pins it, so no token is dropped in either
path), xlstm-350m (4 layers, an sLSTM every 2nd, so both cells decode) and
hymba-1.5b (hybrid; Mamba state and a KV ring). Each is ``reduced()`` in
fp32; weights are made by the JAX package and copied through the bridge,
tokens with numpy from a seed.

  * CLOSE: ``decode_step``'s logits against the JAX package's, step by
    step, within 1e-5 (relative, and absolute of the largest magnitude);
    the port's decode against its own forward at 2e-4 (the JAX package's
    own bound, ``tests/test_models.py:99``), also with hymba's window of 8
    over 24 steps, so the ring wraps twice.
    A ring layer at hymba's heads against attention over exactly its last
    W tokens alone, within 1e-5.
  * EXACT: the greedy tokens of ``launch/serve.py::generate`` against the
    JAX package's decode loop from the same weights and prompt; the
    ``--split-tier`` tokens against the monolithic run's; the serve CLI's
    printed lines. whisper-base and pixtral-12b are held in
    ``tests/test_torch_encdec_vlm.py``.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import model as JM
from repro_torch.bridge import from_numpy_tree
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.models.layers import attn_apply, attn_decode_apply, attn_param_init
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(2)
ARCHS = ("smollm-360m", "deepseek-moe-16b", "xlstm-350m", "hymba-1.5b")


def _cfgs(arch, **extra):
    """(port, JAX) test configs of ``arch``: reduced, fp32."""
    out = []
    for cfg in (get_config(arch), jget_config(arch)):
        red = cfg.reduced().replace(dtype="float32", **extra)
        if red.n_experts:
            red = red.replace(capacity_factor=float(red.n_experts))
        if red.family == "ssm":
            red = red.replace(n_layers=4, slstm_every=2)
        out.append(red)
    return tuple(out)


def _stacked(tree):
    """A JAX tree (one model) as the port's: torch leaves with a client axis."""
    return tree_map(lambda t: t[None], from_numpy_tree(jax.tree.map(np.asarray, tree), "cpu"))


@functools.lru_cache(maxsize=None)
def _decode_runs(arch, window=None, B=2, S=16):
    """The JAX decode loop, the port's decode loop and the port's forward
    over the same tokens: logits (B, S, V) each, as numpy."""
    extra = {} if window is None else {"window": window}
    cfg, jcfg = _cfgs(arch, **extra)
    params = jax.jit(lambda k: JM.init(k, jcfg))(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    step = jax.jit(lambda p, t, c: JM.decode_step(p, jcfg, t, c))
    cache, want = JM.init_cache(jcfg, B, S), []
    for t in range(S):
        lg, cache = step(params, jnp.asarray(tokens[:, t]), cache)
        want.append(np.asarray(lg))
    tp, tt = _stacked(params), torch.from_numpy(tokens)[None]
    tcache, got = M.init_cache(cfg, B, S), []
    with torch.no_grad():
        for t in range(S):
            lg, tcache = M.decode_step(tp, cfg, tt[:, :, t], tcache)
            got.append(lg[0].numpy())
        fwd, _ = M.forward(tp, cfg, {"tokens": tt})
    assert tcache["pos"] == S
    return cfg, np.stack(want, 1), np.stack(got, 1), fwd[0].numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch):
    """Measured: within 1.1e-6 of the largest magnitude (hymba's Mamba
    state, the xLSTM's cells and the MoE route included)."""
    _, want, got, _ = _decode_runs(arch)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_own_forward(arch):
    """The JAX package's own bound, 2e-4 absolute (``tests/test_models.py:99``).
    Measured: at most 7.8e-7 (logits up to 0.94 in magnitude)."""
    _, _, got, fwd = _decode_runs(arch)
    np.testing.assert_allclose(got, fwd, rtol=0, atol=2e-4)


def test_sliding_window_decode_ring_buffer():
    """hymba with a window of 8 over 24 steps (``tests/test_models.py:102-118``):
    the cache keeps 8 slots and wraps; decode equals the windowed forward
    within 2e-4 and the JAX package's ring decode within 1e-5."""
    cfg, want, got, fwd = _decode_runs("hymba-1.5b", window=8, S=24)
    cache = M.init_cache(cfg, 2, 24)
    assert cache["layers"][0]["k"].shape[2] == 8 and M._is_ring(cfg, 8)
    assert M.cache_len_for(cfg, 24, long_context=False) == 8
    np.testing.assert_allclose(got, fwd, rtol=0, atol=2e-4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_cache_layout_matches_jax():
    """Per family, each layer's cache holds the JAX package's leaves with a
    client axis in front, in the same dtypes, each in memory of its own;
    an xLSTM layer only those of the cell it runs, the one its
    ``is_slstm`` flag picks."""
    for arch in ARCHS:
        cfg, jcfg = _cfgs(arch)
        jcache = JM.init_cache(jcfg, 3, 12)
        cache = M.init_cache(cfg, 3, 12)
        assert len(cache["layers"]) == cfg.n_layers and cache["pos"] == 0
        jl = jax.tree.map(lambda a: (tuple(a.shape[1:]), str(a.dtype)), jcache["layers"])
        leaves = tree_leaves(cache)
        assert all(t.shape[0] == 1 for t in tree_leaves(cache["layers"]))
        # no two leaves share memory: a step captured in a CUDA graph
        # writes each in place (serve.stepper refuses aliased caches)
        assert len({t.data_ptr() for t in leaves}) == len(leaves), arch
        flags = M.init(torch.Generator().manual_seed(0), cfg)["blocks"].get("is_slstm")
        for i, layer in enumerate(cache["layers"]):
            tl = tree_map(lambda t: (tuple(t.shape[1:]), str(t.dtype).removeprefix("torch.")),
                          layer)
            if cfg.family == "ssm":
                assert list(tl) == ["slstm" if flags[i] > 0.5 else "mlstm"], (arch, i)
            assert tl == {k: jl[k] for k in tl} and set(jl) - set(tl) <= {"mlstm", "slstm"}, arch
        assert M._attn_cache_len(cache) == JM._attn_cache_len(jcache)


def test_ring_decode_attends_to_exactly_the_last_window_tokens():
    """One attention layer at hymba's heads (25 over 5) with a ring of
    W = 8 slots, stepped over 20 tokens: from position W on, each step's
    output equals causal attention over exactly the last W tokens alone
    (RoPE scores depend on the distance only), within 1e-5 of the largest
    magnitude; with W + 1 or W - 1 of them it is off by more than 1e-3.
    Measured: 4.6e-7, and at least 0.25 off by one."""
    cfg = get_config("hymba-1.5b").reduced().replace(
        dtype="float32", n_heads=25, n_kv_heads=5, head_dim=16, d_model=80, window=8)
    W, S = cfg.window, 20
    gen = torch.Generator().manual_seed(3)
    p = tree_map(lambda t: t[None], attn_param_init(gen, cfg))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 2, S, 80))).float()
    cache = {k: torch.zeros(1, 2, W, 5, 16) for k in ("k", "v")}
    with torch.no_grad():
        ys = []
        for t in range(S):
            y, cache = attn_decode_apply(x[:, :, t:t + 1], p, cfg, cache,
                                         torch.tensor(t), ring=True)
            ys.append(y)

        def last(n, t):         # causal attention over tokens t - n + 1 .. t alone
            return attn_apply(x[:, :, t - n + 1:t + 1], p, cfg, causal=True, window=0)[:, :, -1:]

        for t in range(W, S):
            scale = float(ys[t].abs().max())
            assert float((ys[t] - last(W, t)).abs().max()) <= 1e-5 * scale, t
            for n in (W - 1, W + 1):
                assert float((ys[t] - last(n, t)).abs().max()) > 1e-3 * scale, (t, n)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax_decode_loop(arch):
    """``generate`` (prompt of 6 stepped, then 10 greedy tokens) from the
    JAX package's weights and prompt gives the tokens of the JAX package's
    own loop (``repro/launch/serve.py:114-125``) exactly."""
    cfg, jcfg = _cfgs(arch)
    params = jax.jit(lambda k: JM.init(k, jcfg))(jax.random.PRNGKey(0))
    prompt = np.random.default_rng(2).integers(0, cfg.vocab, (3, 6)).astype(np.int32)
    total = 16
    step = jax.jit(lambda p, t, c: JM.decode_step(p, jcfg, t, c))
    cache, tok = JM.init_cache(jcfg, 3, total), jnp.asarray(prompt[:, 0])
    want = [tok]
    for i in range(total - 1):
        logits, cache = step(params, tok, cache)
        tok = jnp.asarray(prompt[:, i + 1]) if i + 1 < 6 else jnp.argmax(logits, -1)
        want.append(tok)
    want = np.stack([np.asarray(t) for t in want], 1)
    got = serve.generate(cfg, _stacked(params), torch.from_numpy(prompt)[None], total - 6)
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_split_tier_gives_the_monolithic_tokens(arch):
    """The client's half then the server's half of every step, each with
    its own cache, at every tier of a 4-layer, 4-module model: the tokens
    of the monolithic run, bit for bit (a tied model's server holds
    embed^T)."""
    cfg = _cfgs(arch)[0].replace(n_layers=4, n_modules=4)
    gen = torch.Generator().manual_seed(0)
    params = tree_map(lambda t: t[None], M.init(gen, cfg))
    prompt = torch.randint(0, cfg.vocab, (1, 2, 5), generator=gen)
    mono = serve.generate(cfg, params, prompt, 8)
    for tier in (1, 2, 3):
        assert torch.equal(serve.generate(cfg, params, prompt, 8, split_tier=tier), mono)


def test_serve_cli_on_the_cpu(capsys):
    """The port's CLI prints the JAX CLI's lines; ``--split-tier`` gives the
    monolithic tokens; without a card it raises unless asked for the CPU."""
    argv = ["--arch", "hymba-1.5b", "--batch", "2", "--prompt-len", "4", "--tokens", "8",
            "--device", "cpu"]
    seq = serve.main(argv)
    out = capsys.readouterr().out
    assert tuple(seq.shape) == (1, 2, 12)
    line = re.compile(r"\[serve\] hymba-1\.5b: 2 seqs x 12 steps in [0-9.]+s \([0-9.]+ tok/s\); "
                      r"sample: \[[0-9, ]+\]")
    assert line.fullmatch(out.strip().splitlines()[-1]), out
    assert out.strip().endswith(f"sample: {seq[0, 0, :24].tolist()}")
    split = serve.main(argv + ["--split-tier", "1"])
    out = capsys.readouterr().out
    assert "[serve] split-tier 1: client blocks=1 server blocks=1 (z hand-off per token: " \
           f"{2 * 128 * 2} bytes)" in out
    assert torch.equal(split, seq)
    jserve.main(["--arch", "hymba-1.5b", "--batch", "2", "--prompt-len", "4", "--tokens", "8",
                 "--split-tier", "1"])
    jout = capsys.readouterr().out.strip().splitlines()
    assert jout[0] == out.strip().splitlines()[0]
    assert line.fullmatch(jout[-1]), jout


def test_serve_refuses_unported_archs_and_needs_a_card(monkeypatch, capsys):
    """Every assigned arch parses (whisper-base and pixtral-12b are served
    since they were ported: ``tests/test_torch_encdec_vlm.py``); a
    non-transformer arch does not; without a card the CLI raises."""
    for arch in ("whisper-base", "pixtral-12b"):
        assert serve.build_parser().parse_args(["--arch", arch]).arch == arch
    with pytest.raises(SystemExit):
        serve.build_parser().parse_args(["--arch", "resnet-56"])
    assert "invalid arch" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "smollm-360m", "--tokens", "2"])
