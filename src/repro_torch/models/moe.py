"""Mixture-of-Experts FFN: GShard-style grouped, capacity-based top-k
dispatch (pair: ``repro/models/moe.py``).

Every tensor carries the leading client axis C. The JAX cohort vmaps over
clients, so the groups, the capacity and the load-balance loss are each
client's own: the T = B * S tokens of one client are cut into G groups of
Tg (``group_shape``), each expert takes at most ``capacity(Tg)`` tokens of
a group, and the tokens over capacity are dropped (combine weight zero).
The dispatch and combine tensors are (C, G, Tg, E, cap), the expert weights
(C, E, d, f). Shared experts (DeepSeekMoE, llama4-scout) run densely beside
the routed path.

Dtypes as in the JAX package: the router product and its softmax in fp32,
the dispatch, the expert products and the combine in ``cdtype(cfg)``. The
expert products are plain einsums there, outside any Pallas kernel, and
stay ``torch.einsum`` here.

Routing order: the top-k choices are the first k of a stable descending
sort, so equal probabilities go to the lower expert index first, as
``jax.lax.top_k`` orders them (``torch.topk`` promises no order for ties).
The k-th choices queue behind every (k-1)-th choice of the group (GShard's
rank order, ``_queue_positions``), so the same tokens are dropped.

On ``DTensor``s (the dry-run's sharded trace) the experts sit on the model
axis, as the JAX package's specs and GSPMD place them: the router, the
sort, the queue positions and the one-hot tensors run on DTensor's own
rules; after the dispatch einsum the expert queues move onto the experts'
split (an all-to-all, ``sharding.py::on_experts``); each card's products
take its own experts; the combine's partial sums meet the tokens' layout.
A plain tensor takes none of these steps.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.layers import (Params, cdtype, client_mm, dense_init, mlp_apply,
                                       mlp_param_init, silu)
from repro_torch.models.shardctx import constrain
from repro_torch.sharding import even_split, gather_fsdp, on_experts, pin_grad, placed_as

GROUP_SIZE = 512  # tokens per dispatch group (perf/memory knob)


def moe_param_init(gen, cfg, *, lead: tuple = (), device="cpu") -> Params:
    """Router (d, E), routed experts ``we1``/``we3`` (E, d, f) and ``we2``
    (E, f, d), and the shared experts' SwiGLU MLP; ``lead`` prepended."""
    d, fe, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p: Params = {
        "router": dense_init(gen, d, E, scale=0.02, lead=lead, device=device),
        "we1": torch.randn(lead + (E, d, fe), generator=gen, device=device) / math.sqrt(d),
        "we3": torch.randn(lead + (E, d, fe), generator=gen, device=device) / math.sqrt(d),
        "we2": torch.randn(lead + (E, fe, d), generator=gen, device=device) / math.sqrt(fe),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_param_init(gen, d, cfg.d_ff_shared_resolved, lead=lead, device=device)
    return p


def group_shape(n_tokens: int) -> tuple[int, int]:
    """(G, Tg): the largest group of at most GROUP_SIZE tokens that divides
    ``n_tokens``."""
    tg = min(GROUP_SIZE, n_tokens)
    while n_tokens % tg:
        tg -= 1
    return n_tokens // tg, tg


def capacity(tokens_per_group: int, cfg) -> int:
    cap = int(math.ceil(tokens_per_group * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(cap, cfg.top_k)


def _one_hot(idx: torch.Tensor, n: int, dtype=torch.float32) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _queue_positions(topi: torch.Tensor, n_experts: int) -> torch.Tensor:
    """(C, G, Tg, K) rank of each (token, k) assignment in its expert's
    queue: the k-th choices after all (k-1)-th choices of the group, each
    round in token order (``repro/models/moe.py:72-77``)."""
    prior = torch.zeros(topi.shape[:2] + (1, n_experts), dtype=torch.int64,
                        device=topi.device)
    pos = []
    for k in range(topi.shape[-1]):
        oh = _one_hot(topi[..., k], n_experts, torch.int64)           # (C, G, Tg, E)
        rank = torch.cumsum(oh, dim=2) - oh + prior
        prior = prior + oh.sum(dim=2, keepdim=True)
        pos.append((rank * oh).sum(dim=-1))
    return torch.stack(pos, dim=-1)


def route(x: torch.Tensor, p: Params, cfg):
    """The router of one MoE layer on x (C, B, S, D): returns the fp32
    probabilities (C, G, Tg, E), the top-k probabilities and experts (C, G,
    Tg, K), and each assignment's queue position (C, G, Tg, K); an
    assignment at a position >= ``capacity(Tg)`` is dropped."""
    C, B, S, D = x.shape
    G, Tg = group_shape(B * S)
    logits = client_mm(pin_grad(x.reshape(C, B * S, D)).float(), p["router"].float())
    probs = torch.softmax(pin_grad(even_split(logits, 1, G).reshape(C, G, Tg, -1)), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = vals[..., :cfg.top_k], idx[..., :cfg.top_k]
    return probs, topv, topi, _queue_positions(topi, cfg.n_experts)


def _experts(xe: torch.Tensor, p: Params, dt: torch.dtype) -> torch.Tensor:
    """The routed SwiGLU experts on their queues xe (C, G, E, cap, D).

    On ``DTensor``s, as GSPMD places them (``repro/models/moe.py:85-89``):
    the queues move onto the experts' split (an all-to-all on the model
    axis), the weights are gathered over their FSDP split, and each card
    runs its own experts' products; the outputs stay on the experts'
    split."""
    w1, w3, w2 = (p[k].to(dt) for k in ("we1", "we3", "we2"))
    q = on_experts(xe, w1, 2)
    if isinstance(w1, DTensor):
        w1, w3, w2 = gather_fsdp(w1, q, 2), gather_fsdp(w3, q, 2), gather_fsdp(w2, q, 3)
    h = silu(torch.einsum("cgesd,cedf->cgesf", q, w1))
    h = h * torch.einsum("cgesd,cedf->cgesf", q, w3)
    return torch.einsum("cgesf,cefd->cgesd", h, w2)


def _finish(y: torch.Tensor, x: torch.Tensor, p: Params, cfg, probs, topi):
    """Output (C, B, S, D) in x's dtype with the shared experts added, and
    the Switch-style load-balance loss (C,) of each client."""
    out = pin_grad(y.reshape(x.shape)).to(x.dtype)
    if cfg.n_shared_experts:  # (on DTensors its partial sums meet out's layout)
        out = out + placed_as(mlp_apply(x, p["shared"], cfg), out)
    E = cfg.n_experts
    me = probs.mean(dim=(1, 2))                                        # (C, E)
    fe_frac = _one_hot(topi[..., 0], E).mean(dim=(1, 2))
    return out, E * (me * fe_frac).sum(dim=-1)


def moe_apply(x: torch.Tensor, p: Params, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """x (C, B, S, D) -> (out, load-balance aux loss (C,)), by the one-hot
    dispatch and combine einsums of the JAX package."""
    C, B, S, D = x.shape
    G, Tg = group_shape(B * S)
    E, cap, dt = cfg.n_experts, capacity(Tg, cfg), cdtype(cfg)
    x = constrain(x, "act")  # a partial sum (the decode's) summed once, for all its readers
    probs, topv, topi, pos = route(x, p, cfg)

    dispatch = torch.zeros((C, G, Tg, E, cap), device=x.device)
    combine = torch.zeros((C, G, Tg, E, cap), device=x.device)
    for k in range(cfg.top_k):
        keep = (pos[..., k] < cap) & (topi[..., k] >= 0)
        slot = _one_hot(torch.where(keep, pos[..., k], cap), cap)      # (C, G, Tg, cap)
        sel = _one_hot(topi[..., k], E) * keep[..., None]
        d_k = sel[..., :, None] * slot[..., None, :]                    # (C, G, Tg, E, cap)
        dispatch = dispatch + d_k
        combine = combine + d_k * topv[..., k][..., None, None]

    # (on DTensors tokens split over more cards than there are groups are
    # gathered first: the decode's one group)
    xg = pin_grad(even_split(x.reshape(C, B * S, D), 1, G).reshape(C, G, Tg, D)).to(dt)
    xe = torch.einsum("cgtes,cgtd->cgesd", dispatch.to(dt), xg)
    ye = _experts(xe, p, dt)                                            # (C, G, E, cap, D)
    # on DTensors: each card combines its own experts' outputs, and the
    # partial sums meet in the tokens' layout (a reduce-scatter, as GSPMD's)
    y = placed_as(torch.einsum("cgtes,cgesd->cgtd", combine.to(dt), ye), xg)
    return _finish(y, x, p, cfg, probs, topi)


def moe_apply_gather(x: torch.Tensor, p: Params, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """``moe_apply`` by index plumbing: token ids are scattered into the
    (E, cap) expert queues and the inputs gathered from them; each token's
    K expert outputs are gathered back and weighted. Dropped assignments
    all go to the dump slot E * cap, which is sliced off; an empty queue
    slot reads token 0, and no combine picks it."""
    C, B, S, D = x.shape
    G, Tg = group_shape(B * S)
    E, K, cap, dt = cfg.n_experts, cfg.top_k, capacity(Tg, cfg), cdtype(cfg)
    probs, topv, topi, pos = route(x, p, cfg)
    keep = pos < cap                                                    # (C, G, Tg, K)

    tok = torch.arange(Tg, device=x.device).reshape(1, 1, Tg, 1).expand(C, G, Tg, K)
    slot = torch.where(keep, topi * cap + pos, E * cap)                 # flat queue slot
    queue = torch.zeros((C, G, E * cap + 1), dtype=torch.int64, device=x.device)
    queue = queue.scatter(2, slot.reshape(C, G, -1), tok.reshape(C, G, -1))[..., :E * cap]
    xg = x.reshape(C, G, Tg, D).to(dt)
    xe = torch.gather(xg, 2, queue[..., None].expand(C, G, E * cap, D))
    ye = _experts(xe.reshape(C, G, E, cap, D), p, dt)

    safe = torch.clamp_max(slot, E * cap - 1).reshape(C, G, Tg * K, 1)
    picked = torch.gather(ye.reshape(C, G, E * cap, D), 2, safe.expand(C, G, Tg * K, D))
    w = (topv * keep).to(dt)
    y = torch.einsum("cgtk,cgtkd->cgtd", w, picked.reshape(C, G, Tg, K, D))
    return _finish(y, x, p, cfg, probs, topi)
