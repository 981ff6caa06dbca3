"""Step builders of the dry-run (pair: ``repro/launch/steps.py:1``): the
DTFL tier train step, the full train step, prefill and decode.

Each builder returns the step function, its arguments, their specs
(``launch/specs.py``) and the specs of what it returns, beside the
returned trees' stand-ins (``outs``), the activation specs of the preset
and ``cfg``. Without ``device`` the arguments are fake tensors made under
one ``FakeTensorMode`` (``mode``; run the step inside it), on the card
where this torch was built with CUDA and else on the meta device: the
autograd engine of a CPU-only build has no device guard for CUDA, so a
backward over fake CUDA tensors aborts there. Either way the kernels'
wrappers take them to their ops' fake bodies. With ``device`` they are
real tensors there, weights drawn from seed 0, and ``mode`` is None.

Every argument carries the port's client axis (C = 1). The train step is
the paper's technique, a DTFL tier step at ``DEFAULT_TIER`` with Adam;
``full`` the monolithic step. Prefill and decode take bf16 weights, as
``repro/launch/steps.py:109-118``; a decode cache's ``pos`` is 0, as the
JAX package's ``init_cache`` leaves it.
"""
from __future__ import annotations

import contextlib

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import optim
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core import local_loss
from repro_torch.fed.cohort import broadcast_state
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as M
from repro_torch.tree import tree_map

DEFAULT_TIER = 4  # paper's M=7; mid tier (1-based)


def trace_device() -> str:
    """Where fake arguments claim to live: the card with a CUDA build of
    torch, else the meta device."""
    return "cuda" if torch.backends.cuda.is_built() else "meta"


def _context(device):
    """(the fake mode the arguments are made in, or None for real ones;
    their device; the draw's generator)."""
    if device is None:
        return FakeTensorMode(), trace_device(), None
    return None, device, torch.Generator(device=device).manual_seed(0)


def _batch(cfg: ArchConfig, shape: InputShape, device, gen) -> dict:
    """Tokens and labels drawn from ``gen`` (zeros in a fake trace), and a
    frontend's embeddings, at ``specs.input_specs``' shapes."""
    batch = {}
    for name, t in S.input_specs(cfg, shape).items():
        if t.is_floating_point():
            batch[name] = torch.randn(t.shape, generator=gen, device=device).to(t.dtype)
        else:
            batch[name] = torch.randint(0, cfg.vocab, t.shape, generator=gen, device=device,
                                        dtype=t.dtype)
    return batch


def _loss_like(device) -> torch.Tensor:
    return torch.zeros((1,), device=device)


# ===========================================================================
# DTFL tier train step
# ===========================================================================

def build_dtfl_train(cfg: ArchConfig, shape: InputShape, mesh: Mesh, *,
                     tier: int = DEFAULT_TIER, preset: str = "baseline", device=None) -> dict:
    cfg = cfg.replace(tie_embeddings=False)
    opt = optim.adam(1e-3)
    mode, dev, gen = _context(device)
    with mode or contextlib.nullcontext():
        state = local_loss.init_tier_state(gen, cfg, M.init(gen, cfg, device=dev), tier, opt)
        batch = _batch(cfg, shape, dev, gen)
        metrics = local_loss.DTFLMetrics(_loss_like(dev), _loss_like(dev))
    cps = S.tree_pspecs(state.client_params, mesh)
    aps = S.tree_pspecs(state.aux_params, mesh)
    sps = S.tree_pspecs(state.server_params, mesh)
    state_specs = local_loss.DTFLState(
        cps, aps, sps, S.opt_state_pspecs(state.client_opt, cps),
        S.opt_state_pspecs(state.aux_opt, aps), S.opt_state_pspecs(state.server_opt, sps))
    return dict(
        fn=local_loss.make_dtfl_train_step(cfg, opt),
        args=(state, batch),
        in_specs=(state_specs, S.batch_pspecs(cfg, shape, mesh)),
        outs=(state, metrics),
        out_specs=(state_specs, local_loss.DTFLMetrics((), ())),
        act_specs=S.activation_pspecs(cfg, shape, mesh, preset),
        cfg=cfg, mode=mode, tier=tier,
    )


# ===========================================================================
# monolithic train step (baseline / FedAvg-style)
# ===========================================================================

def build_full_train(cfg: ArchConfig, shape: InputShape, mesh: Mesh, *, device=None) -> dict:
    opt = optim.adam(1e-3)
    mode, dev, gen = _context(device)
    with mode or contextlib.nullcontext():
        one = M.init(gen, cfg, device=dev)
        params, opt_state = broadcast_state((one, opt.init(one)), 1)
        batch = _batch(cfg, shape, dev, gen)
        loss = _loss_like(dev)
    p_specs = S.tree_pspecs(params, mesh)
    o_specs = S.opt_state_pspecs(opt_state, p_specs)
    return dict(
        fn=local_loss.make_full_train_step(cfg, opt),
        args=(params, opt_state, batch),
        in_specs=(p_specs, o_specs, S.batch_pspecs(cfg, shape, mesh)),
        outs=(params, opt_state, loss),
        out_specs=(p_specs, o_specs, ()),
        act_specs=S.activation_pspecs(cfg, shape, mesh),
        cfg=cfg, mode=mode, tier=None,
    )


# ===========================================================================
# serve: prefill (full forward) and decode (one token + cache)
# ===========================================================================

def _bf16_params(cfg: ArchConfig, device, gen) -> dict:
    """One model with a client axis of 1, its fp32 leaves in bf16."""
    return tree_map(lambda t: (t.to(torch.bfloat16) if t.dtype == torch.float32 else t)[None],
                    M.init(gen, cfg, device=device))


def _logits_spec(cfg: ArchConfig, shape: InputShape, mesh: Mesh) -> tuple:
    return S._drop_indivisible((S.batch_axes(shape, mesh), "model"),
                               (shape.global_batch, cfg.padded_vocab), mesh)


def build_prefill(cfg: ArchConfig, shape: InputShape, mesh: Mesh, *, device=None) -> dict:
    def prefill(params, batch):
        logits, _ = M.forward(params, cfg, batch)
        return logits[:, :, -1]  # next-token logits

    mode, dev, gen = _context(device)
    with mode or contextlib.nullcontext():
        params = _bf16_params(cfg, dev, gen)
        batch = _batch(cfg, shape, dev, gen)
        batch.pop("labels")
        logits = torch.zeros((1, shape.global_batch, cfg.padded_vocab),
                             dtype=torch.bfloat16, device=dev)
    bspecs = S.batch_pspecs(cfg, shape, mesh)
    bspecs.pop("labels")
    return dict(
        fn=prefill,
        args=(params, batch),
        in_specs=(S.tree_pspecs(params, mesh), bspecs),
        outs=logits,
        out_specs=_logits_spec(cfg, shape, mesh),
        act_specs=S.activation_pspecs(cfg, shape, mesh),
        cfg=cfg, mode=mode, tier=None,
    )


def build_decode(cfg: ArchConfig, shape: InputShape, mesh: Mesh, *,
                 preset: str = "baseline", device=None) -> dict:
    def serve_step(params, token, cache):
        return M.decode_step(params, cfg, token, cache)

    mode, dev, gen = _context(device)
    with mode or contextlib.nullcontext():
        params = _bf16_params(cfg, dev, gen)
        ins = S.input_specs(cfg, shape, device=dev)
        token = torch.randint(0, cfg.vocab, ins["token"].shape, generator=gen, device=dev,
                              dtype=torch.int32)
        logits = torch.zeros((1, shape.global_batch, cfg.padded_vocab),
                             dtype=torch.bfloat16, device=dev)
    cache = ins["cache"]
    c_specs = S.cache_pspecs(cache, shape, mesh, preset)
    return dict(
        fn=serve_step,
        args=(params, token, cache),
        in_specs=(S.tree_pspecs(params, mesh, preset), (S.batch_axes(shape, mesh),), c_specs),
        outs=(logits, cache),
        out_specs=(_logits_spec(cfg, shape, mesh), c_specs),
        act_specs=S.activation_pspecs(cfg, shape, mesh, preset),
        cfg=cfg, mode=mode, tier=None,
    )


BUILDERS = {
    "train": build_dtfl_train,
    "full": build_full_train,
    "prefill": build_prefill,
    "decode": build_decode,
}


def builder_for(shape: InputShape, step: "str | None" = None):
    if step:
        return BUILDERS[step]
    return BUILDERS[{"train": "train", "prefill": "prefill", "decode": "decode"}[shape.kind]]
