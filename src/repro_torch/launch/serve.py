"""Serving entry point of the port: batched greedy decoding with a KV cache
(pair: ``repro/launch/serve.py``).

The JAX CLI's flags, plus ``--device``: the run goes to the card unless
``--device cpu``. The prompt is stepped one token at a time, then the
model decodes greedily; it prints the JAX CLI's lines. Decoding is torch
ops (``models/model.py::decode_step``), as the JAX package's is plain
``jnp``: no kernel sits on the steps. On the card each step is one CUDA
graph replay (``stepper``). An encoder-decoder (whisper-base) first
encodes its frontend, the stubbed audio frames (on K4: bidirectional
attention over the frames), and fills every decoder layer's cross cache
from the result (``models/model.py::fill_cross_cache``); the CLI feeds
zero frames, as the JAX CLI does (with zero frames ``front_proj``,
attention, the MLP and ``rmsnorm`` all map 0 to 0, so the cross caches are
zero and cross-attention adds nothing: ``generate`` takes a frontend for
runs that need one). A VLM (pixtral-12b) decodes tokens only, as the JAX
package's decode does. With ``--split-tier`` the model is
split at that DTFL tier (``core/tiering.py::split_params``): every step
runs the client's half (embed + its blocks) and hands z to the server's
half (the remaining blocks + head), each with its own cache; the encoder
runs on the client, and each half fills its own layers' cross caches from
its output, which crosses once. The JAX CLI prints the split and decodes
the whole model; both give the same tokens.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m --tokens 32 \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b --full-size \\
      --tokens 1024 --split-tier 3
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import registry, resolve_device
from repro_torch.configs import get_config
from repro_torch.core import tiering
from repro_torch.models import model as M
from repro_torch.tree import tree_leaves, tree_map


def _arch(name: str) -> str:
    if name not in registry.ASSIGNED_ARCH_NAMES:
        raise argparse.ArgumentTypeError(
            f"invalid arch {name!r}; choose from {', '.join(registry.ASSIGNED_ARCH_NAMES)}")
    return name


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", type=_arch,
                    help="transformer arch: " + ", ".join(registry.ASSIGNED_ARCH_NAMES))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--split-tier", type=int, default=0,
                    help="DTFL split serving at this tier (0 = monolithic)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def build_model(cfg, *, batch: int, prompt_len: int, seed: int = 0, device=None) -> tuple:
    """(params, prompt) for ``cfg``: one model (C = 1) drawn from ``seed``
    on the device, then the prompt (1, batch, prompt_len) of tokens below
    the vocab, from the same generator."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = tree_map(lambda t: t[None], M.init(gen, cfg, device=device))
    prompt = torch.randint(0, cfg.vocab, (1, batch, prompt_len), generator=gen, device=device)
    return params, prompt


def stepper(cfg, params, batch: int, total: int, *, split_tier: int = 0,
            frontend: "torch.Tensor | None" = None):
    """A function ``tok (1, B) -> logits (1, B, V)`` that decodes the next
    of up to ``total`` positions, with its own caches. ``split_tier`` > 0
    runs every step as the client's half and the server's half of that
    tier's split, each with its cache. An encoder-decoder takes its
    ``frontend`` (1, B, P, d_front): the encoder runs once here (on the
    client under a split) and each half fills its layers' cross caches
    from its output, which the captured step then only reads; other
    families take none. On the card the step is captured
    once in a CUDA graph (after a warm-up step on copies of the caches) and
    each call replays it: the same torch ops, launched without the host's
    per-op work, as the JAX package jits its step. There the returned
    logits are a buffer that the next call overwrites."""
    device = params["embed"].device
    if (frontend is None) != (cfg.family != "encdec"):
        raise ValueError("an encoder-decoder's stepper takes its frontend, and no other "
                         f"family's does (family {cfg.family!r})")
    cache = M.init_cache(cfg, batch, total, device=device)
    if split_tier:
        s = tiering.split_layer(cfg, split_tier)
        cp, sp = tiering.split_params(params, cfg, split_tier, axis=1)
        if "lm_head" not in sp:       # a tied model: the server holds embed^T
            sp["lm_head"] = params["embed"].transpose(1, 2)
        caches = [{"layers": cache["layers"][:s], "pos": cache["pos"]},
                  {"layers": cache["layers"][s:], "pos": torch.zeros_like(cache["pos"])}]
        halves = [(cp, caches[0]), (sp, caches[1])]

        def step(tok, caches):
            z, client = M.client_decode(cp, cfg, tok, caches[0])
            logits, server = M.server_decode(sp, cfg, z, caches[1])
            return logits, [client, server]
    else:
        caches = cache
        halves = [(params, cache)]

        def step(tok, cache):
            return M.decode_step(params, cfg, tok, cache)

    if frontend is not None:
        with torch.no_grad():
            enc = M.encode(halves[0][0], cfg, {"frontend": frontend})
            for half, half_cache in halves:
                M.fill_cross_cache(half["blocks"], cfg, enc, half_cache)

    if device.type != "cuda":
        state = [caches]

        def run(tok):
            logits, state[0] = step(tok, state[0])
            return logits
        return run

    leaves = tree_leaves(caches)
    if len({t.data_ptr() for t in leaves}) != len(leaves):
        raise ValueError("cache tensors share memory; the captured step writes each in place")
    tok_in = torch.zeros((1, batch), dtype=torch.int64, device=device)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.no_grad(), torch.cuda.stream(side):
        step(tok_in, tree_map(torch.clone, caches))
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.no_grad(), torch.cuda.graph(graph):
        logits, new = step(tok_in, caches)
        if len(tree_leaves(new)) != len(leaves):
            raise ValueError("a decode step changed the caches' layout")
        tree_map(_write_back, caches, new)

    return _Replay(graph, tok_in, logits, (caches, step))


def _write_back(old: torch.Tensor, got: torch.Tensor) -> None:
    """A captured step's new state or position into the cache leaf it
    replaces, paired by key (k and v are written in place)."""
    if got.shape != old.shape or got.dtype != old.dtype:
        raise ValueError("a decode step changed the caches' layout")
    if got is not old:
        old.copy_(got)


class _Replay:
    """One captured decode step. It holds what the graph reads and writes
    (the caches, and the parameters through ``step``) for as long as it may
    be replayed: freed, their memory would go to other tensors."""

    def __init__(self, graph, tok_in, logits, held):
        self.graph, self.tok_in, self.logits, self.held = graph, tok_in, logits, held

    def __call__(self, tok: torch.Tensor) -> torch.Tensor:
        self.tok_in.copy_(tok)
        self.graph.replay()
        return self.logits


def generate(cfg, params, prompt: torch.Tensor, n_tokens: int, *, split_tier: int = 0,
             frontend: "torch.Tensor | None" = None) -> torch.Tensor:
    """Step the prompt (1, B, P) through the caches, then decode greedily;
    returns the (1, B, P + n_tokens) tokens (``stepper`` runs each step,
    after encoding an encoder-decoder's ``frontend``)."""
    total = prompt.shape[2] + n_tokens
    step = stepper(cfg, params, prompt.shape[1], total, split_tier=split_tier,
                   frontend=frontend)
    tok = prompt[:, :, 0]
    out = [tok]
    with torch.no_grad():
        for i in range(total - 1):
            logits = step(tok)
            tok = prompt[:, :, i + 1] if i + 1 < prompt.shape[2] else logits.argmax(-1)
            out.append(tok)
    return torch.stack(out, dim=2)


def main(argv=None) -> torch.Tensor:
    """Parse ``argv``, serve, print the JAX CLI's lines; returns the tokens
    (1, B, prompt_len + tokens)."""
    args = build_parser().parse_args(argv)
    full = get_config(args.arch)
    cfg = full if args.full_size else full.reduced()
    params, prompt = build_model(cfg, batch=args.batch, prompt_len=args.prompt_len,
                                 seed=args.seed, device=args.device)
    B = args.batch
    total = args.prompt_len + args.tokens
    if args.split_tier:
        s = tiering.split_layer(cfg, args.split_tier)
        print(f"[serve] split-tier {args.split_tier}: client blocks={s} "
              f"server blocks={cfg.n_layers - s} "
              f"(z hand-off per token: {B * cfg.d_model * 2} bytes)")
    frontend = None
    if cfg.family == "encdec":    # zero frames, as the JAX CLI feeds
        frontend = torch.zeros((1, B, cfg.n_frontend_tokens, cfg.d_frontend or cfg.d_model),
                               device=prompt.device)
    t0 = time.time()
    seq = generate(cfg, params, prompt, args.tokens, split_tier=args.split_tier,
                   frontend=frontend)
    if seq.is_cuda:
        torch.cuda.synchronize(seq.device)
    dt_all = time.time() - t0
    print(f"[serve] {args.arch}: {B} seqs x {total} steps in {dt_all:.1f}s "
          f"({B * total / dt_all:.1f} tok/s); sample: {seq[0, 0, :24].tolist()}")
    return seq


if __name__ == "__main__":
    main()
