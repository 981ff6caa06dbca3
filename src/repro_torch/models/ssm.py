"""xLSTM's recurrent sequence mixers: mLSTM and sLSTM (pair: ``repro/models/ssm.py:1``).

The full-sequence forms only, on the port's leading client axis: x
(C, B, S, D), parameters (C, ...). The mLSTM cell runs on kernel K5
(``kernels/mlstm_chunk.py``): the hand-written CUDA kernels for a CUDA
tensor, the plain chunk form (the JAX package's ``_mlstm_chunk_scan`` op
order and chunk, ``kernels/ref.py::MLSTM_CHUNK``) for a CPU tensor. The
sLSTM has no kernel in the JAX package either: it stays torch ops, one
step of a Python loop per position. Dtype policy as in the JAX package:
parameters fp32, projections in ``cfg.dtype``, the cells and gates in
fp32. Decoding and Mamba come with later slices.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.mlstm_chunk import mlstm_chunk
from repro_torch.models.layers import (Params, cdtype, client_mm, dense_init, per_client, rmsnorm,
                                      silu)


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
