"""Plain PyTorch versions of the port's kernels (pair: ``repro/kernels/ref.py``).

Each function repeats its kernel's arithmetic in torch ops. The kernel
wrappers use them for tensors on the CPU; on the card they are what a
kernel is held against.
"""
from __future__ import annotations

import math

import torch


def int8_roundtrip_ref(x: torch.Tensor) -> torch.Tensor:
    """Int8 quantize/dequantize of ``x`` (R, n) with one scale per row.

    Row-wise form of ``repro/kernels/ref.py:63`` (``int8_roundtrip_ref``,
    one scale per tensor) in the same op order:
    ``s = max(max|x|, 1e-12) / 127``, ``clip(round(x / s), -127, 127) * s``,
    computed in fp32 and returned in ``x``'s dtype. ``torch.round`` rounds
    half to even like ``jnp.round``."""
    xf = x.float()
    amax = torch.clamp_min(xf.abs().amax(dim=1, keepdim=True), 1e-12)
    # divide by a tensor: on CUDA, dividing by a Python scalar becomes a
    # multiply by its reciprocal, which is not the IEEE quotient
    s = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / s), -127.0, 127.0)
    return (q * s).to(x.dtype)


# the clamp of the squared distances, and the distance it leaves behind:
# sqrt(max(d2, D2_MIN)) equals D_MIN exactly where d2 <= D2_MIN
D2_MIN = 1e-12
D_MIN = float(torch.sqrt(torch.tensor(D2_MIN, dtype=torch.float32)))


def pairwise_dist_ref(x: torch.Tensor) -> torch.Tensor:
    """Euclidean distances within each client: (C, B, F) -> (C, B, B), fp32.

    ``repro/privacy/__init__.py:18`` (``_pairwise_dist``) and
    ``repro/kernels/ref.py:55`` over a leading client axis, in the same op
    order: ``sq = sum(x*x)``, ``d2 = sq_i + sq_j - 2 x x^T``,
    ``sqrt(max(d2, 1e-12))``."""
    x = x.float()
    sq = torch.sum(x * x, dim=-1)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.bmm(x, x.transpose(1, 2))
    return torch.sqrt(torch.clamp_min(d2, D2_MIN))


def pairwise_dist_bwd_ref(x: torch.Tensor, dist: torch.Tensor,
                          g_dist: torch.Tensor) -> torch.Tensor:
    """Gradient of ``sum(g_dist * pairwise_dist(x))`` w.r.t. ``x`` (C, B, F).

    With ``H = 0.5 g / D`` where the clamp let ``d2`` through (``D > D_MIN``;
    0 elsewhere, so a tie at the clamp routes no gradient) and ``S = H +
    H^T``, the gradient is ``2 (diag(rowsum S) - S) x``. The diagonal of
    ``H`` is dropped: its ``sq`` and cross terms cancel exactly
    (``+4 H_ii x_i - 4 H_ii x_i``), where autodiff leaves their rounding."""
    x = x.float()
    eye = torch.eye(dist.shape[-1], dtype=torch.bool, device=dist.device)
    h = torch.where((dist > D_MIN) & ~eye, 0.5 * g_dist / dist, torch.zeros_like(dist))
    s = h + h.transpose(1, 2)
    w = torch.diag_embed(s.sum(dim=-1)) - s
    return 2.0 * torch.bmm(w, x)


def fused_xent_ref(logits: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token cross-entropy: logits (T, V), labels (T,) -> (loss, lse),
    both (T,) fp32.

    ``repro/kernels/ref.py:72`` (``fused_xent_ref``) and
    ``repro/core/local_loss.py:27`` (``token_xent``'s per-token term) in the
    same op order: ``lse = logsumexp(x)`` in fp32, ``loss = lse - x[label]``;
    lse is kept for the backward. A label outside [0, V) picks 0, as the
    kernel's."""
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1)
    lab, ok = _in_range(labels, x.shape[1])
    picked = torch.where(ok, torch.gather(x, -1, lab[:, None])[:, 0], 0.0)
    return lse - picked, lse


def _in_range(labels: torch.Tensor, V: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(the labels clamped into [0, V) as int64, whether each was in it)."""
    lab = labels.long()
    return lab.clamp(0, V - 1), (lab >= 0) & (lab < V)


def fused_xent_bwd_ref(logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
                       g: torch.Tensor) -> torch.Tensor:
    """Gradient of ``sum(g * loss)`` w.r.t. ``logits`` (T, V), in the logits'
    dtype: ``g_t (exp(x - lse_t) - [v == label_t])``, computed in fp32; a
    label outside [0, V) has no one-hot term."""
    p = torch.exp(logits.float() - lse[:, None])
    lab, ok = _in_range(labels, p.shape[1])
    hit = torch.zeros_like(p).scatter_(1, lab[:, None], ok.float()[:, None])
    return (g[:, None] * (p - hit)).to(logits.dtype)


def _visible(Sq: int, Sk: int, causal: bool, window: int, device) -> torch.Tensor:
    """(Sq, Sk) bool: query i may attend to key j."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    return mask


def _grouped(t: torch.Tensor, kv: int) -> torch.Tensor:
    """(N, S, H, hd) -> (N, S, KV, G, hd) fp32: query head h = kv * G + g."""
    N, S, H, hd = t.shape
    return t.float().reshape(N, S, kv, H // kv, hd)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                  window: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash attention's function, materialized: q (N, Sq, H, hd), k and v
    (N, Sk, KV, hd) -> (o (N, Sq, H, hd) in q's dtype, lse (N, H, Sq) fp32).
    Sk differs from Sq for cross-attention (every key visible there, as
    ``repro/models/layers.py:236-240`` calls it).

    The Pallas kernel's arithmetic (``repro/kernels/flash_attention.py:29``)
    without the blocking: fp32 scores ``q.k * (1 / sqrt(hd))``, masked;
    ``p = exp(s - rowmax)``, ``l = sum p``; ``o = (p cast to v's dtype) @ v
    / max(l, 1e-30)``; ``lse = rowmax + log(max(l, 1e-30))``. Heads are
    grouped as ``repro/models/layers.py:136``: query head h reads KV head
    h // (H / KV)."""
    N, S, H, hd = q.shape
    KV = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("nqkgd,nskd->nkgqs", _grouped(q, KV), k.float()) * scale
    vis = _visible(S, k.shape[1], causal, window, q.device)
    s = torch.where(vis, s, -torch.inf)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(s - m), 0.0)
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    acc = torch.einsum("nkgqs,nskd->nkgqd", p.to(v.dtype).float(), v.float())
    o = (acc / l).permute(0, 3, 1, 2, 4).reshape(N, S, H, hd).to(q.dtype).contiguous()
    lse = (m + torch.log(l)).reshape(N, H, S)
    return o, lse


def attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool, window: int = 0):
    """FlashAttention-2's backward of :func:`attention_ref` on the same
    inputs, materialized: ``D = rowsum(dO * O)``, ``P = exp(s - lse)``,
    ``dV = (P cast to v's dtype)^T dO``, ``dS = P (dO V^T - D)``,
    ``dQ = scale dS K``, ``dK = scale dS^T Q``, dK and dV summed over the
    G query heads of each KV head. Returns (dq, dk, dv) in the inputs'
    dtypes."""
    N, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg, dog = _grouped(q, KV), _grouped(do, KV)
    kf, vf = k.float(), v.float()
    D = (do.float() * o.float()).sum(-1).reshape(N, S, KV, G).permute(0, 2, 3, 1)
    s = torch.einsum("nqkgd,nskd->nkgqs", qg, kf) * scale
    vis = _visible(S, k.shape[1], causal, window, q.device)
    p = torch.where(vis, torch.exp(s - lse.reshape(N, KV, G, S)[..., None]), 0.0)
    dv = torch.einsum("nkgqs,nqkgd->nskd", p.to(v.dtype).float(), dog)
    dp = torch.einsum("nqkgd,nskd->nkgqs", dog, vf)
    ds = p * (dp - D[..., None])
    dq = torch.einsum("nkgqs,nskd->nqkgd", ds, kf) * scale
    dk = torch.einsum("nkgqs,nqkgd->nskd", ds, qg) * scale
    return dq.reshape(N, S, H, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def mlstm_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_f: torch.Tensor,
              i_gate: torch.Tensor) -> torch.Tensor:
    """The mLSTM's per-step recurrence (``repro/kernels/ref.py:27``): q, k, v
    (BH, S, dh); gates (BH, S) -> h (BH, S, dh) in q's dtype.

    ``C_t = f_t C_{t-1} + i_t k_t v_t^T``, ``n_t = f_t n_{t-1} + i_t k_t``,
    ``h_t = (q_t^T C_t) / max(|n_t . q_t|, 1)``, with ``f_t = exp(log_f_t)``."""
    BH, S, dh = q.shape
    dt = torch.promote_types(q.dtype, torch.float32)
    C = torch.zeros((BH, dh, dh), dtype=dt, device=q.device)
    n = torch.zeros((BH, dh), dtype=dt, device=q.device)
    one = torch.ones((), dtype=dt, device=q.device)
    hs = []
    for t in range(S):
        f = torch.exp(log_f[:, t])[:, None, None]
        ig = i_gate[:, t]
        C = f * C + ig[:, None, None] * (k[:, t, :, None] * v[:, t, None, :])
        n = f[:, :, 0] * n + ig[:, None] * k[:, t]
        num = torch.einsum("bde,bd->be", C, q[:, t])
        den = torch.maximum(torch.abs(torch.einsum("bd,bd->b", n, q[:, t])), one)
        hs.append(num / den[:, None])
    return torch.stack(hs, dim=1).to(q.dtype)


MLSTM_CHUNK = 256   # repro/models/ssm.py:25


def mlstm_chunk_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_f: torch.Tensor,
                    i_gate: torch.Tensor, *, chunk: int = MLSTM_CHUNK) -> torch.Tensor:
    """The chunkwise-parallel mLSTM, from zero state: q, k, v (BH, S, dh);
    gates (BH, S) -> h (BH, S, dh).

    ``repro/models/ssm.py:52-98`` (``_mlstm_chunk_scan``) in its op order,
    on the kernel's (BH, S, dh) layout, with its chunk length: the largest
    divisor of S up to ``chunk`` (``repro/models/ssm.py:59-61``). Per chunk: ``cum = cumsum(log_f)``,
    ``D = where(s <= t, exp(cum_t - cum_s) * i_s, 0)``,
    ``h = ((q k^T * D) v + (q C) exp(cum)) / max(|n_t . q_t|, 1)``, then the
    carried ``C`` and ``n`` move to the chunk's end. Like the reference, it
    takes ``exp`` over the whole (P, P) and masks after, so with strong
    forgetting the masked half can overflow (its backward is then NaN)."""
    BH, S, dh = q.shape
    P = min(chunk, S)
    while S % P:
        P -= 1
    C = torch.zeros((BH, dh, dh), dtype=q.dtype, device=q.device)
    n = torch.zeros((BH, dh), dtype=q.dtype, device=q.device)
    mask = torch.tril(torch.ones((P, P), dtype=torch.bool, device=q.device))
    # max against a tensor: at a tie its gradient splits evenly, as jnp.maximum's
    one = torch.ones((), dtype=q.dtype, device=q.device)
    hs = []
    for c0 in range(0, S, P):
        qb, kb, vb = q[:, c0:c0 + P], k[:, c0:c0 + P], v[:, c0:c0 + P]
        lf, ig = log_f[:, c0:c0 + P], i_gate[:, c0:c0 + P]
        cum = torch.cumsum(lf, dim=-1)
        d_in = torch.exp(cum)
        diff = cum[..., :, None] - cum[..., None, :]
        D = torch.where(mask, torch.exp(diff) * ig[..., None, :], 0.0)
        scores = torch.einsum("btd,bsd->bts", qb, kb)
        intra = torch.einsum("bts,bse->bte", scores * D, vb)
        inter = torch.einsum("bde,btd->bte", C, qb) * d_in[..., None]
        num = intra + inter
        n_intra = torch.einsum("bts,bsd->btd", D, kb)
        n_t = d_in[..., None] * n[..., None, :] + n_intra
        denom = torch.maximum(torch.abs(torch.einsum("btd,btd->bt", n_t, qb)), one)
        hs.append(num / denom[..., None])
        w = torch.exp(cum[..., -1:] - cum)
        C = torch.exp(cum[..., -1])[..., None, None] * C + torch.einsum(
            "bs,bsd,bse->bde", w * ig, kb, vb)
        n = torch.exp(cum[..., -1])[..., None] * n + torch.einsum("bs,bsd->bd", w * ig, kb)
    return torch.cat(hs, dim=1)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it (test-only):
    to the nearest value with 10 fraction bits, ties away from zero, done on
    the int32 view (sign and magnitude), so the low 13 bits come out 0."""
    bits = x.float().contiguous().view(torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return ((bits & -0x80000000) | mag).view(torch.float32)


def _round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 ``x`` to fp32, rounded toward zero (test-only)."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def split_tf32_matmul(a: torch.Tensor, b: torch.Tensor, products: int = 3,
                      acc: torch.Tensor | None = None, group: int | None = None) -> torch.Tensor:
    """``a (..., M, K) @ b (..., K, N)`` in fp32 as the split-TF32 kernels take
    it on the tensor cores (test-only). Each operand is split into big =
    tf32(x) and small = tf32(x - big). Per k-step of 8 the products are
    small.big, big.small and big.big (``products=3``), or big.big alone
    (``products=1``, one TF32 product), each an exact sum of 8 terms.

    Without ``group`` (K5's kernels, ``csrc/mlstm_chunk.cu``) a k-step's
    products are summed exactly, rounded once to fp32 and added to the fp32
    running sum with one rounding. With ``group`` (K4's fp32 kernels,
    ``csrc/flash_attention.cu``) the tensor cores add each product to their
    fp32 fragment with one rounding, taken here toward zero (the worse of
    the roundings they may use); the fragment starts from zero every
    ``group`` k-steps and is then added to the running sum with one
    round-to-nearest rounding, or, with ``group=0``, spans the whole depth
    and is the result. The running sum starts from ``acc`` or zero."""
    a, b = a.float(), b.float()
    ab, bb = tf32_rna(a), tf32_rna(b)
    asm, bsm = tf32_rna(a - ab), tf32_rna(b - bb)
    shape = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]) + (a.shape[-2], b.shape[-1])
    out = torch.zeros(shape, dtype=torch.float32) if acc is None else acc.float()
    pairs = ((asm, bb), (ab, bsm), (ab, bb)) if products == 3 else ((ab, bb),)
    K = a.shape[-1]
    if group is None:
        for k0 in range(0, K, 8):
            ks = slice(k0, k0 + 8)
            step = sum(x[..., ks].double() @ y[..., ks, :].double() for x, y in pairs)
            out = (out.double() + step.float().double()).float()
        return out
    span = K if group == 0 else 8 * group
    for g0 in range(0, K, span):
        frag = torch.zeros(shape, dtype=torch.float32)
        for k0 in range(g0, min(g0 + span, K), 8):
            ks = slice(k0, k0 + 8)
            for x, y in pairs:
                step = x[..., ks].double() @ y[..., ks, :].double()
                frag = _round_toward_zero(frag.double() + step)
        out = frag if group == 0 else (out.double() + frag.double()).float()
    return out
