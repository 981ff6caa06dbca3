"""Recurrent sequence mixers: mLSTM and sLSTM (xLSTM) and the Mamba-style
S6 heads (hymba). Pair: ``repro/models/ssm.py:1``.

On the port's leading client axis: x (C, B, S, D), parameters (C, ...),
decode states (C, B, ...). The mLSTM cell runs on kernel K5
(``kernels/mlstm_chunk.py``): the hand-written CUDA kernels for a CUDA
tensor, the plain chunk form (the JAX package's ``_mlstm_chunk_scan`` op
order and chunk, ``kernels/ref.py::MLSTM_CHUNK``) for a CPU tensor. The
sLSTM and the S6 scan have no kernel in the JAX package either: they stay
torch ops (the sLSTM one step of a Python loop per position, the S6 one
step per chunk of ``MAMBA_CHUNK`` positions). The one-token decode forms
are torch ops in both packages. Dtype policy as in the JAX package:
parameters fp32, projections in ``cfg.dtype``, the cells, gates and the
S6 scan in fp32; fp32 products stay fp32 (the port never turns TF32 on).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.mlstm_chunk import mlstm_chunk
from repro_torch.models.layers import (Params, cdtype, client_mm, dense_init, per_client, rmsnorm,
                                      silu)

MAMBA_CHUNK = 16


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_param_init(gen, cfg, *, lead: tuple = (), device="cpu") -> Params:
    d, H = cfg.d_model, cfg.n_heads
    di = 2 * d
    kw = dict(lead=lead, device=device)
    return {
        "ln": torch.ones(lead + (d,), device=device),
        "w_up": dense_init(gen, d, di, **kw),
        "w_gate": dense_init(gen, d, di, **kw),
        "wq": dense_init(gen, di, di, **kw),
        "wk": dense_init(gen, di, di, **kw),
        "wv": dense_init(gen, di, di, **kw),
        "w_if": dense_init(gen, d, 2 * H, scale=0.02, **kw),
        "b_if": torch.cat([torch.zeros(lead + (H,), device=device),
                           3.0 * torch.ones(lead + (H,), device=device)], dim=-1),
        "w_down": dense_init(gen, di, d, **kw),
    }


def mlstm_apply(x: torch.Tensor, p: Params, cfg) -> torch.Tensor:
    """Full-sequence mLSTM block, x (C, B, S, D) -> x + out. The steps keep
    ``repro/models/ssm.py:106-125``'s dtypes: k divided by sqrt(dh) in the
    compute dtype, the gates fp32 from ``+ b_if``, the cell fp32, its output
    cast back before ``* silu(z)``."""
    C, B, S, _ = x.shape
    H = cfg.n_heads
    dt = cdtype(cfg)
    h = rmsnorm(x, p["ln"], cfg.norm_eps).to(dt)
    u = client_mm(h, p["w_up"].to(dt))                          # (C, B, S, di)
    z = client_mm(h, p["w_gate"].to(dt))
    di = u.shape[-1]
    dh = di // H

    def heads(t):   # (C, B, S, di) -> (C*B*H, S, dh) fp32
        t = t.reshape(C, B, S, H, dh).permute(0, 1, 3, 2, 4)
        return t.float().reshape(C * B * H, S, dh).contiguous()

    q = heads(client_mm(u, p["wq"].to(dt)))
    k = heads(client_mm(u, p["wk"].to(dt)) / math.sqrt(dh))
    v = heads(client_mm(u, p["wv"].to(dt)))
    gates = client_mm(h, p["w_if"].to(dt)).float()
    gates = gates + per_client(p["b_if"], gates)
    ig, fg = torch.split(gates, H, dim=-1)                      # (C, B, S, H) each

    def per_head(t):   # (C, B, S, H) -> (C*B*H, S)
        return t.permute(0, 1, 3, 2).reshape(C * B * H, S).contiguous()

    hcell = mlstm_chunk(q, k, v, per_head(F.logsigmoid(fg)), per_head(torch.sigmoid(ig)))
    hcell = hcell.reshape(C, B, H, S, dh).permute(0, 1, 3, 2, 4).reshape(C, B, S, di).to(dt)
    out = client_mm(hcell * silu(z), p["w_down"].to(dt))
    return x + out.to(x.dtype)


def mlstm_state_init(cfg, batch: int, *, lead: tuple = (), device="cpu") -> Params:
    H = cfg.n_heads
    dh = 2 * cfg.d_model // H
    return {"C": torch.zeros(lead + (batch, H, dh, dh), device=device),
            "n": torch.zeros(lead + (batch, H, dh), device=device)}


def mlstm_decode(x: torch.Tensor, p: Params, cfg, state: Params) -> tuple[torch.Tensor, Params]:
    """One-step mLSTM, x (C, B, 1, D) (``repro/models/ssm.py:137-162``):
    k cast to fp32 before its division by sqrt(dh), the per-step
    recurrence ``C = f C + i k v^T``, ``n = f n + i k``."""
    C, B = x.shape[:2]
    H = cfg.n_heads
    dt = cdtype(cfg)
    h = rmsnorm(x, p["ln"], cfg.norm_eps).to(dt)[:, :, 0]               # (C, B, D)
    u = client_mm(h, p["w_up"].to(dt))
    z = client_mm(h, p["w_gate"].to(dt))
    di = u.shape[-1]
    dh = di // H
    q = client_mm(u, p["wq"].to(dt)).reshape(C, B, H, dh).float()
    k = client_mm(u, p["wk"].to(dt)).reshape(C, B, H, dh).float() / math.sqrt(dh)
    v = client_mm(u, p["wv"].to(dt)).reshape(C, B, H, dh).float()
    gates = client_mm(h, p["w_if"].to(dt)).float()
    gates = gates + per_client(p["b_if"], gates)
    ig, fg = torch.split(gates, H, dim=-1)                              # (C, B, H)
    i_t, f_t = torch.sigmoid(ig), torch.sigmoid(fg)
    cell = f_t[..., None, None] * state["C"] + i_t[..., None, None] * (
        k[..., :, None] * v[..., None, :])                              # [k x v]
    n = f_t[..., None] * state["n"] + i_t[..., None] * k
    num = torch.einsum("cbhde,cbhd->cbhe", cell, q)
    denom = torch.clamp_min(torch.abs(torch.einsum("cbhd,cbhd->cbh", n, q)), 1.0)
    hcell = (num / denom[..., None]).reshape(C, B, di).to(dt)
    out = client_mm(hcell * silu(z), p["w_down"].to(dt))
    return x + out[:, :, None].to(x.dtype), {"C": cell, "n": n}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_param_init(gen, cfg, *, lead: tuple = (), device="cpu") -> Params:
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    kw = dict(lead=lead, device=device)
    return {
        "ln": torch.ones(lead + (d,), device=device),
        "w": dense_init(gen, d, 4 * d, **kw),                  # i, f, z, o pre-activations
        "r": torch.randn(lead + (H, dh, 4 * dh), generator=gen, device=device) / math.sqrt(dh),
        "b": torch.cat([torch.zeros(lead + (d,), device=device),
                        3.0 * torch.ones(lead + (d,), device=device),
                        torch.zeros(lead + (2 * d,), device=device)], dim=-1),
        "w_down": dense_init(gen, d, d, **kw),
    }


def _slstm_cell(carry, wx: torch.Tensor, r: torch.Tensor):
    """carry (h, c, n, m), each (C, B, H, dh); wx (C, B, H, 4dh) input
    pre-activations; r (C, H, dh, 4dh). The stabilizer m starts at -inf."""
    h, c, n, m = carry
    pre = wx + torch.einsum("cbhd,chde->cbhe", h, r)
    i_t, f_t, z_t, o_t = torch.chunk(pre, 4, dim=-1)
    m_new = torch.maximum(f_t + m, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(f_t + m - m_new)
    c_new = f_p * c + i_p * torch.tanh(z_t)
    n_new = f_p * n + i_p
    h_new = torch.sigmoid(o_t) * c_new / torch.maximum(n_new, torch.ones_like(n_new))
    return h_new, c_new, n_new, m_new


def slstm_apply(x: torch.Tensor, p: Params, cfg) -> torch.Tensor:
    """Full-sequence sLSTM block, x (C, B, S, D) -> x + out; the recurrence
    is one Python step per position (``repro/models/ssm.py:199-217``)."""
    C, B, S, D = x.shape
    H = cfg.n_heads
    dh = D // H
    dt = cdtype(cfg)
    hx = rmsnorm(x, p["ln"], cfg.norm_eps).to(dt)
    wx = client_mm(hx, p["w"].to(dt)).float()
    wx = (wx + per_client(p["b"], wx)).reshape(C, B, S, H, 4 * dh)
    r = p["r"].float()
    zeros = torch.zeros((C, B, H, dh), dtype=torch.float32, device=x.device)
    carry = (zeros, zeros, zeros, torch.full_like(zeros, -torch.inf))
    hs = []
    for t in range(S):
        carry = _slstm_cell(carry, wx[:, :, t], r)
        hs.append(carry[0])
    hs = torch.stack(hs, dim=2).reshape(C, B, S, D).to(dt)
    return x + client_mm(hs, p["w_down"].to(dt)).to(x.dtype)


def slstm_state_init(cfg, batch: int, *, lead: tuple = (), device="cpu") -> Params:
    H = cfg.n_heads
    shape = lead + (batch, H, cfg.d_model // H)
    # four tensors: a step captured in a CUDA graph writes each in place
    return {"h": torch.zeros(shape, device=device), "c": torch.zeros(shape, device=device),
            "n": torch.zeros(shape, device=device),
            "m": torch.full(shape, -torch.inf, device=device)}


def slstm_decode(x: torch.Tensor, p: Params, cfg, state: Params) -> tuple[torch.Tensor, Params]:
    """One-step sLSTM, x (C, B, 1, D): one ``_slstm_cell`` step."""
    C, B, _, D = x.shape
    H = cfg.n_heads
    dt = cdtype(cfg)
    hx = rmsnorm(x, p["ln"], cfg.norm_eps).to(dt)[:, :, 0]
    wx = client_mm(hx, p["w"].to(dt)).float()
    wx = (wx + per_client(p["b"], wx)).reshape(C, B, H, 4 * (D // H))
    h, c, n, m = _slstm_cell((state["h"], state["c"], state["n"], state["m"]), wx,
                             p["r"].float())
    out = client_mm(h.reshape(C, B, D).to(dt), p["w_down"].to(dt))[:, :, None]
    return x + out.to(x.dtype), {"h": h, "c": c, "n": n, "m": m}


# ---------------------------------------------------------------------------
# Mamba-style S6 (hymba's SSM heads)
# ---------------------------------------------------------------------------

def mamba_param_init(gen, cfg, *, lead: tuple = (), device="cpu") -> Params:
    d = cfg.d_model
    di = d  # hymba: SSM heads operate at model width
    N = cfg.ssm_state
    kw = dict(lead=lead, device=device)
    a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32, device=device))
    return {
        "w_in": dense_init(gen, d, 2 * di, **kw),
        "conv": torch.randn(lead + (cfg.d_conv, di), generator=gen, device=device) * 0.1,
        "w_bc": dense_init(gen, di, 2 * N, scale=0.02, **kw),
        "w_dt": dense_init(gen, di, di, scale=0.02, **kw),
        "b_dt": torch.full(lead + (di,), -4.6, device=device),  # softplus^-1(0.01)
        "a_log": a_log.expand(lead + (di, N)).contiguous(),
        "d_skip": torch.ones(lead + (di,), device=device),
        "w_out": dense_init(gen, di, d, **kw),
    }


class _Softplus(torch.autograd.Function):
    """``jax.nn.softplus``, which is ``jnp.logaddexp(x, 0)``:
    ``max(x, 0) + log1p(exp(-|x|))``, and its custom JVP's derivative
    ``exp(x - softplus(x))``. ``F.softplus`` turns into the identity above
    its threshold, with another gradient there."""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(x - out)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return _Softplus.apply(x)


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, x (C, B, S, di), w (C, k, di): a Python sum
    of the k shifted slices, in the JAX package's order."""
    k, S = w.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return sum(xp[:, :, i:i + S] * per_client(w[:, i], x) for i in range(k))


def _doubling_scan(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` along axis 2 in log2(P)
    doubling steps, each the associative combine ``(a_l a_r, b_l a_r + b_r)``
    of position t with t - d. Returns (prod a, the state from h_0 = 0)."""
    d, P = 1, a.shape[2]
    while d < P:
        b = torch.cat([b[:, :, :d], b[:, :, :-d] * a[:, :, d:] + b[:, :, d:]], dim=2)
        a = torch.cat([a[:, :, :d], a[:, :, :-d] * a[:, :, d:]], dim=2)
        d *= 2
    return a, b


def _mamba_chunk(xch, dt_t, Bt, Ct, h, A):
    """One chunk of the S6 scan (``repro/models/ssm.py:325-334``) from its
    inputs xch (C, B, P, di) fp32, step sizes dt_t (C, B, P, di) and
    projections Bt, Ct (C, B, P, N), and the carried state h (C, B, di,
    N). Returns (the state at the chunk's end, y (C, B, P, di))."""
    a = torch.exp(dt_t[..., None] * A[:, None, None])                  # (C, B, P, di, N)
    b = dt_t[..., None] * Bt[..., None, :] * xch[..., None]
    aa, bb = _doubling_scan(a, b)
    hs = aa * h[:, :, None] + bb
    y = torch.einsum("cbpdn,cbpn->cbpd", hs, Ct)
    return hs[:, :, -1], y


def mamba_apply(x: torch.Tensor, p: Params, cfg) -> torch.Tensor:
    """Full-sequence S6, x (C, B, S, D) -> (C, B, S, D), no residual (the
    caller adds it). The projections that do not depend on the state (B_t,
    C_t and the step sizes) run over the whole sequence at once; the scan
    runs chunk by chunk, P = ``MAMBA_CHUNK`` positions (or the largest
    divisor of S below it), the state carried across chunks. The (C, B, P,
    di, N) tensors of a chunk are not kept for the backward: each chunk
    runs under ``checkpoint`` and is computed again in the backward (the
    JAX package checkpoints each block), so autograd keeps the chunk's
    input state (C, B, di, N) only."""
    C, B, S, D = x.shape
    dt = cdtype(cfg)
    u = client_mm(x.to(dt), p["w_in"].to(dt))
    xs, z = torch.chunk(u, 2, dim=-1)                                  # (C, B, S, di)
    xf = silu(_on_shards(_causal_conv, xs, (p["conv"].to(dt), None, 2))).float()
    # .float(): fp32 products over bf16 weights too (the dry-run's serving
    # steps), as the JAX package's type promotion gives them
    Bt, Ct = torch.chunk(client_mm(xf, p["w_bc"].float()), 2, dim=-1)  # (C, B, S, N)
    pre = client_mm(xf, p["w_dt"].float())
    dt_t = softplus(pre + per_client(p["b_dt"], pre))                  # (C, B, S, di)
    A = -torch.exp(p["a_log"])                                         # (C, di, N)
    # each input with its (rows, channels) dimensions
    y = _on_shards(_scan, xf, (dt_t, 1, 3), (Bt, 1, None), (Ct, 1, None), (A, None, 1))
    y = y + per_client(p["d_skip"], xf) * xf
    y = client_mm(y.to(dt) * silu(z), p["w_out"].to(dt))
    return y.to(x.dtype)


def _scan(xf, dt_t, Bt, Ct, A) -> torch.Tensor:
    """The S6 scan's outputs y (C, B, S, di) from h_0 = 0, chunk by chunk
    (``mamba_apply``)."""
    C, B, S, di = xf.shape
    P = min(MAMBA_CHUNK, S)
    while S % P:
        P -= 1
    h = torch.zeros((C, B, di, A.shape[-1]), device=xf.device)
    ys = []
    for start in range(0, S, P):
        args = [t[:, :, start:start + P] for t in (xf, dt_t, Bt, Ct)] + [h, A]
        if torch.is_grad_enabled():
            h, y = checkpoint(_mamba_chunk, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            h, y = _mamba_chunk(*args)
        ys.append(y)
    return torch.cat(ys, dim=2)


def _on_shards(fn, x, *others):
    """``fn(x, *others)``; on ``DTensor``s each card over its own shards, as
    a shard_map would run it, for a ``fn`` that runs along the sequence
    and on each row (B, x's dimension 1) and channel (di, dimension 3) on
    its own (the causal conv, the scan): a split of either needs no
    collective. ``others`` are (tensor, its rows' dimension, its channels'
    dimension) triples (None: it has none). The inputs are first placed so
    (a split of the sequence or a partial sum is gathered); ``fn`` then
    runs on the local tensors, whose ops a sharded trace counts as it
    counts any card's, without DTensor's dispatch at every op of every
    chunk. Returns x's shape, placed as x's rows and channels."""
    if not isinstance(x, DTensor):
        return fn(x, *(t for t, _, _ in others))
    mesh = x.device_mesh
    place = tuple(p if p in (Shard(1), Shard(3)) else Replicate() for p in x.placements)

    def placed(rows, chans):
        return tuple(Shard(rows) if p == Shard(1) and rows is not None
                     else Shard(chans) if p == Shard(3) and chans is not None else Replicate()
                     for p in place)

    local = [t.redistribute(mesh, pl).to_local(grad_placements=pl)
             for t, pl in [(x, place)] + [(t, placed(r, c)) for t, r, c in others]]
    return DTensor.from_local(fn(*local), mesh, place, run_check=False, shape=x.shape,
                              stride=torch.empty(x.shape, device="meta").stride())


def mamba_state_init(cfg, batch: int, *, lead: tuple = (), device="cpu") -> Params:
    di = cfg.d_model
    return {"h": torch.zeros(lead + (batch, di, cfg.ssm_state), device=device),
            "conv": torch.zeros(lead + (batch, cfg.d_conv - 1, di), device=device)}


def mamba_decode(x: torch.Tensor, p: Params, cfg, state: Params) -> tuple[torch.Tensor, Params]:
    """One-step S6, x (C, B, 1, D) (``repro/models/ssm.py:350-370``): the
    conv over the kept inputs in fp32, one step of the recurrence."""
    dt = cdtype(cfg)
    u = client_mm(x.to(dt)[:, :, 0], p["w_in"].to(dt))
    xs, z = torch.chunk(u, 2, dim=-1)                                  # (C, B, di)
    hist = torch.cat([state["conv"], xs[:, :, None].float()], dim=2)   # (C, B, k, di)
    xc = silu(torch.einsum("cbkd,ckd->cbd", hist, p["conv"].float()))
    Bt, Ct = torch.chunk(client_mm(xc, p["w_bc"].float()), 2, dim=-1)  # (C, B, N)
    pre = client_mm(xc, p["w_dt"].float())
    dt_t = softplus(pre + per_client(p["b_dt"], pre))
    A = -torch.exp(p["a_log"])
    a = torch.exp(dt_t[..., None] * A[:, None])                        # (C, B, di, N)
    b = dt_t[..., None] * Bt[:, :, None, :] * xc[..., None]
    h = a * state["h"] + b
    y = torch.einsum("cbdn,cbn->cbd", h, Ct) + per_client(p["d_skip"], xc) * xc
    y = client_mm(y.to(dt) * silu(z), p["w_out"].to(dt))
    return y[:, :, None].to(x.dtype), {"h": h, "conv": hist[:, :, 1:]}
