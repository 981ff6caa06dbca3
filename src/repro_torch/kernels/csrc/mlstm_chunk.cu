// K5 on Hopper: the chunkwise-parallel mLSTM cell (xLSTM's matrix memory),
// forward and backward, fp32 throughout.
//
// Replaces the Pallas kernel src/repro/kernels/mlstm_chunk.py::mlstm_chunk
// (body _mlstm_kernel). Per row b of (BH, S, dh) q, k, v and (BH, S) gates
// log_f, i, chunk by chunk with the memory C (dh, dh) and normalizer n (dh)
// carried across chunks from zero:
//   cum_t = sum_{t' <= t} log_f_t'            (within the chunk)
//   D_ts  = exp(cum_t - cum_s) i_s for s <= t, else 0
//   A_ts  = (q_t . k_s) D_ts
//   h_t   = (sum_s A_ts v_s + exp(cum_t) q_t C) / max(|exp(cum_t) n.q_t + sum_s A_ts|, 1)
//   C    <- exp(cum_P) C + sum_s u_s k_s v_s^T,  n <- exp(cum_P) n + sum_s u_s k_s,
//   u_s   = exp(cum_P - cum_s) i_s.
// The Pallas kernel has no VJP (the JAX model differentiates its jnp chunk
// scan); here every mLSTM on the card runs on these kernels, so the backward
// is a kernel too. The plain versions are src/repro_torch/kernels/ref.py::
// mlstm_chunk_ref (and autograd through it).
//
// Bound. On the path (BH = 48, S = 512, dh = 512) a forward does about
// 3 P^2 dh + 2 P dh^2 multiply-adds per (row, chunk of P = 256): ~45 GFLOP,
// 0.67 ms at the 67 TFLOP/s fp32 rate against ~0.06 ms for its ~200 MB of
// bytes, so it is bound by operations; the backward does about twice that.
// fp32 products on the FMA units: TF32 would break fp32 parity.
//
// Design. The memory C is 1 MiB at dh = 512 and does not fit one SM, so the
// work is split into passes that each run as many blocks as the card holds:
//   forward  prep (cum, exp(cum), u, exp(cum_P) per chunk; one thread a chunk)
//            scores (A per (row, chunk, 64 x 64 tile), only tiles with s <= t)
//            state  (one block per (row, 32-column slab of C): the slab lives
//                    in registers and walks the chunks in order, writing C at
//                    every chunk start for the output pass and the backward)
//            norm   (one block per row: n walks the chunks; n.q, row sums of
//                    A, the denominator)
//            out    (h per (row, chunk, 64 x 64 tile): [A | q] [v ; C])
//   backward bprep  (one block per row: r_t = d loss / d(n_t.q_t) from g.h,
//                    and the reverse walk of dn)
//            bstate (the reverse walk of dC per slab, written at every chunk
//                    end; <dC, C> for the gate of the carried state)
//            bscores (dA = dnum v^T + r, the scores again: dS = dA D and the
//                    gate term H = dA (q.k) exp(cum_t - cum_s))
//            dq, dk, dv (64 x 64 tiles: the state term, then the chunk's own)
//            gates  (row and column sums of H, the reverse cumulative sum
//                    that turns d cum into d log_f)
// Every product is one 64 x 64 (or dh x 32) tile in registers, staged
// through shared memory 16 deep. Every output element has one writer and
// every sum a fixed order: no float atomics, the same bits every run.
// exp is taken only where s <= t. Any S: the last chunk is ragged and
// masked. dh <= 512.
//
// Build without --use_fast_math (expf and IEEE division as written).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kP = 256;          // chunk length
constexpr int kT = 64;           // tile of the per-chunk products
constexpr int kBK = 16;          // depth staged per step
constexpr int kE = 32;           // columns of C per state block
constexpr int kThreads = 256;
constexpr int kMaxDh = 512;

struct Dims {
  int BH, S, dh, nch;
};

__device__ __forceinline__ int chunk_len(const Dims& d, int c) { return min(kP, d.S - c * kP); }

// acc[TM][TN] += sum_{k0 <= k < k1} a(m, k) b(k, n) over a BM x BN tile.
// Thread (ty, tx) owns rows ty + TY i and columns tx + TX j. A_KMAJOR: a's
// consecutive k are adjacent in memory (else consecutive m); B_NMAJOR: b's
// consecutive n are adjacent (else consecutive k). Loads past k1 are 0.
template <int BM, int BN, int TM, int TN, bool A_KMAJOR, bool B_NMAJOR, class FA, class FB>
__device__ __forceinline__ void tile_mm(float (&acc)[TM][TN], int k0, int k1, FA a, FB b,
                                        float* sA, float* sB) {
  constexpr int TX = BN / TN, TY = BM / TM, NT = TX * TY;
  constexpr int LA = BM + 4, LB = BN + 4;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  for (int kb = k0; kb < k1; kb += kBK) {
    for (int idx = tid; idx < BM * kBK; idx += NT) {
      const int m = A_KMAJOR ? idx / kBK : idx % BM;
      const int kk = A_KMAJOR ? idx % kBK : idx / BM;
      sA[kk * LA + m] = (kb + kk < k1) ? a(m, kb + kk) : 0.f;
    }
    for (int idx = tid; idx < kBK * BN; idx += NT) {
      const int n = B_NMAJOR ? idx % BN : idx / kBK;
      const int kk = B_NMAJOR ? idx / BN : idx % kBK;
      sB[kk * LB + n] = (kb + kk < k1) ? b(kb + kk, n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float ra[TM], rb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) ra[i] = sA[kk * LA + ty + TY * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) rb[j] = sB[kk * LB + tx + TX * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// the 64 x 64 tiles: 16 x 16 threads, 4 x 4 each
constexpr int kTM = 4;
constexpr int kTY = kT / kTM;
constexpr int kSmemA = kBK * (kT + 4), kSmemB = kBK * (kT + 4);

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// sum over the 16 lanes with the same ty (they differ in lane bits 0-3)
__device__ __forceinline__ float tx_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// a fixed-order sum over the block's 256 threads
__device__ float block_sum(float x, float* red) {
  const int tid = threadIdx.x;
  red[tid] = x;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// one thread per (row, chunk): cum, alpha = exp(cum), u = exp(cum_P - cum) i,
// beta = exp(cum_P)
__global__ void mlstm_prep(const float* __restrict__ lf, const float* __restrict__ ig,
                           float* __restrict__ cum, float* __restrict__ alpha,
                           float* __restrict__ u, float* __restrict__ beta, Dims d) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= d.BH * d.nch) return;
  const int bh = i / d.nch, c = i % d.nch, L = chunk_len(d, c);
  const size_t o = (size_t)bh * d.S + (size_t)c * kP;
  float run = 0.f;
  for (int t = 0; t < L; ++t) {
    run += lf[o + t];
    cum[o + t] = run;
    alpha[o + t] = expf(run);
  }
  for (int t = 0; t < L; ++t) u[o + t] = expf(run - cum[o + t]) * ig[o + t];
  beta[i] = expf(run);
}

// A_ts = (q_t . k_s) exp(cum_t - cum_s) i_s for s <= t, one 64 x 64 tile;
// grid (s tile, t tile, row * chunk); tiles above the diagonal are skipped
// (no pass reads them), masked entries of a written tile are 0.
__global__ void __launch_bounds__(kThreads)
mlstm_scores(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ cum, const float* __restrict__ ig,
             float* __restrict__ amat, Dims d) {
  const int st = blockIdx.x, tt = blockIdx.y, bc = blockIdx.z;
  const int bh = bc / d.nch, c = bc % d.nch, L = chunk_len(d, c);
  if (st > tt || tt * kT >= L) return;
  __shared__ float sA[kSmemA], sB[kSmemB];
  const size_t row = (size_t)bh * d.S + (size_t)c * kP;   // first position of the chunk
  const int t0 = tt * kT, s0 = st * kT, dh = d.dh;
  const float* qc = q + row * dh;
  const float* kc = k + row * dh;
  float acc[kTM][kTM];
  zero(acc);
  tile_mm<kT, kT, kTM, kTM, true, false>(
      acc, 0, dh,
      [&](int m, int kk) { return t0 + m < L ? qc[(size_t)(t0 + m) * dh + kk] : 0.f; },
      [&](int kk, int n) { return s0 + n < L ? kc[(size_t)(s0 + n) * dh + kk] : 0.f; }, sA, sB);
  const int tx = threadIdx.x % kTY, ty = threadIdx.x / kTY;
  float* out = amat + (size_t)bc * kP * kP;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int t = t0 + ty + kTY * i;
#pragma unroll
    for (int j = 0; j < kTM; ++j) {
      const int s = s0 + tx + kTY * j;
      float a = 0.f;
      if (s <= t && t < L) a = acc[i][j] * (expf(cum[row + t] - cum[row + s]) * ig[row + s]);
      out[(size_t)t * kP + s] = a;
    }
  }
}

// the state pass: one block per (32-column slab of C, row). The slab
// (dh x 32, in registers: BM = dh rounded up to 64 .. 512) walks the chunks
// in order; C at every chunk start goes to cst (BH, nch, dh, dh).
template <int BM>
__global__ void __launch_bounds__(kThreads)
mlstm_state(const float* __restrict__ k, const float* __restrict__ v,
            const float* __restrict__ u, const float* __restrict__ beta,
            float* __restrict__ cst, Dims d) {
  constexpr int TM = BM / 64, TN = 8, TX = kE / TN, TY = BM / TM;
  __shared__ float sA[kBK * (BM + 4)], sB[kBK * (kE + 4)];
  const int e0 = blockIdx.x * kE, bh = blockIdx.y, dh = d.dh;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  float acc[TM][TN];
  zero(acc);
  for (int c = 0; c < d.nch; ++c) {
    float* cc = cst + ((size_t)bh * d.nch + c) * dh * dh;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int r = ty + TY * i, e = e0 + tx + TX * j;
        if (r < dh && e < dh) cc[(size_t)r * dh + e] = acc[i][j];
      }
    if (c == d.nch - 1) break;
    const float b = beta[bh * d.nch + c];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] *= b;
    const size_t row = (size_t)bh * d.S + (size_t)c * kP;
    const float* kc = k + row * dh;
    const float* vc = v + row * dh;
    const float* uc = u + row;
    tile_mm<BM, kE, TM, TN, false, true>(
        acc, 0, chunk_len(d, c),
        [&](int m, int s) { return m < dh ? uc[s] * kc[(size_t)s * dh + m] : 0.f; },
        [&](int s, int n) { return e0 + n < dh ? vc[(size_t)s * dh + e0 + n] : 0.f; }, sA, sB);
  }
}

// one block per row: n walks the chunks; nq_t = exp(cum_t) n.q_t + sum_s A_ts,
// den_t = max(|nq_t|, 1); n at every chunk start goes to nst (BH, nch, dh)
__global__ void __launch_bounds__(kThreads)
mlstm_norm(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ amat, const float* __restrict__ alpha,
           const float* __restrict__ u, const float* __restrict__ beta,
           float* __restrict__ nst, float* __restrict__ nq, float* __restrict__ den, Dims d) {
  __shared__ float n[kMaxDh];
  const int bh = blockIdx.x, tid = threadIdx.x, lane = tid % 32, warp = tid / 32, dh = d.dh;
  for (int i = tid; i < dh; i += kThreads) n[i] = 0.f;
  __syncthreads();
  for (int c = 0; c < d.nch; ++c) {
    const int L = chunk_len(d, c);
    const size_t row = (size_t)bh * d.S + (size_t)c * kP;
    for (int i = tid; i < dh; i += kThreads) nst[((size_t)bh * d.nch + c) * dh + i] = n[i];
    for (int t = warp; t < L; t += kThreads / 32) {
      const float* qt = q + (row + t) * dh;
      const float* at = amat + (((size_t)bh * d.nch + c) * kP + t) * kP;
      float nqt = 0.f, rs = 0.f;
      for (int i = lane; i < dh; i += 32) nqt = fmaf(n[i], qt[i], nqt);
      for (int s = lane; s <= t; s += 32) rs += at[s];
      const float x = alpha[row + t] * warp_sum(nqt) + warp_sum(rs);
      if (lane == 0) {
        nq[row + t] = x;
        den[row + t] = fmaxf(fabsf(x), 1.f);
      }
    }
    __syncthreads();
    if (c < d.nch - 1) {
      const float b = beta[bh * d.nch + c];
      for (int i = tid; i < dh; i += kThreads) {
        float a = b * n[i];
        for (int s = 0; s < L; ++s) a = fmaf(u[row + s], k[(row + s) * dh + i], a);
        n[i] = a;
      }
    }
    __syncthreads();
  }
}

// h_t = (sum_s A_ts v_s + exp(cum_t) q_t C) / den_t, one 64 x 64 tile;
// grid (e tile, t tile, row * chunk)
__global__ void __launch_bounds__(kThreads)
mlstm_out(const float* __restrict__ q, const float* __restrict__ v,
          const float* __restrict__ amat, const float* __restrict__ cst,
          const float* __restrict__ alpha, const float* __restrict__ den,
          float* __restrict__ h, Dims d) {
  const int et = blockIdx.x, tt = blockIdx.y, bc = blockIdx.z;
  const int c = bc % d.nch, L = chunk_len(d, c);
  if (tt * kT >= L) return;
  __shared__ float sA[kSmemA], sB[kSmemB];
  const int bh = bc / d.nch, t0 = tt * kT, e0 = et * kT, dh = d.dh;
  const size_t row = (size_t)bh * d.S + (size_t)c * kP;
  const float* ac = amat + (size_t)bc * kP * kP;
  const float* vc = v + row * dh;
  const float* qc = q + row * dh;
  const float* cc = cst + (size_t)bc * dh * dh;
  float intra[kTM][kTM], inter[kTM][kTM];
  zero(intra);
  zero(inter);
  tile_mm<kT, kT, kTM, kTM, true, true>(
      intra, 0, min(t0 + kT, L),
      [&](int m, int s) { return ac[(size_t)(t0 + m) * kP + s]; },
      [&](int s, int n) { return e0 + n < dh ? vc[(size_t)s * dh + e0 + n] : 0.f; }, sA, sB);
  if (c > 0)   // C is 0 at the first chunk
    tile_mm<kT, kT, kTM, kTM, true, true>(
        inter, 0, dh,
        [&](int m, int i) { return t0 + m < L ? qc[(size_t)(t0 + m) * dh + i] : 0.f; },
        [&](int i, int n) { return e0 + n < dh ? cc[(size_t)i * dh + e0 + n] : 0.f; }, sA, sB);
  const int tx = threadIdx.x % kTY, ty = threadIdx.x / kTY;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int t = t0 + ty + kTY * i;
    if (t >= L) continue;
#pragma unroll
    for (int j = 0; j < kTM; ++j) {
      const int e = e0 + tx + kTY * j;
      if (e < dh)
        h[(row + t) * dh + e] = (intra[i][j] + inter[i][j] * alpha[row + t]) / den[row + t];
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// one block per row: r_t = d loss / d nq_t, with dden_t = -(g_t . h_t) / den_t
// and d max(|x|, 1) / dx = sign(x) where |x| > 1, half of it at |x| = 1
// (as jnp.maximum and torch.maximum split a tie); then dn walks the chunks
// in reverse: dnend (BH, nch, dh) is dn at every chunk's end, dbn (BH, nch)
// its product with n at the chunk's start.
__global__ void __launch_bounds__(kThreads)
mlstm_bprep(const float* __restrict__ q, const float* __restrict__ h,
            const float* __restrict__ g, const float* __restrict__ nq,
            const float* __restrict__ den, const float* __restrict__ alpha,
            const float* __restrict__ beta, const float* __restrict__ nst,
            float* __restrict__ r, float* __restrict__ dnend, float* __restrict__ dbn, Dims d) {
  __shared__ float red[kThreads];
  const int bh = blockIdx.x, tid = threadIdx.x, lane = tid % 32, warp = tid / 32, dh = d.dh;
  const size_t row0 = (size_t)bh * d.S;
  for (int t = warp; t < d.S; t += kThreads / 32) {
    const float* gt = g + (row0 + t) * dh;
    const float* ht = h + (row0 + t) * dh;
    float gh = 0.f;
    for (int i = lane; i < dh; i += 32) gh = fmaf(gt[i], ht[i], gh);
    gh = warp_sum(gh);
    if (lane == 0) {
      const float x = nq[row0 + t], ax = fabsf(x);
      const float slope = ax > 1.f ? 1.f : (ax == 1.f ? 0.5f : 0.f);
      const float dden = -gh / den[row0 + t];
      r[row0 + t] = x > 0.f ? dden * slope : (x < 0.f ? -dden * slope : 0.f);
    }
  }
  __syncthreads();
  constexpr int kPer = kMaxDh / kThreads;
  float dn[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) dn[j] = 0.f;
  for (int c = d.nch - 1; c >= 0; --c) {
    const size_t sc = (size_t)bh * d.nch + c;
    const size_t row = row0 + (size_t)c * kP;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + kThreads * j;
      if (i < dh) {
        dnend[sc * dh + i] = dn[j];
        part = fmaf(dn[j], nst[sc * dh + i], part);
      }
    }
    part = block_sum(part, red);
    if (tid == 0) dbn[sc] = part;
    if (c == 0) break;
    const float b = beta[sc];
    const int L = chunk_len(d, c);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + kThreads * j;
      if (i < dh) {
        float a = b * dn[j];
        for (int t = 0; t < L; ++t) a = fmaf(alpha[row + t] * r[row + t], q[(row + t) * dh + i], a);
        dn[j] = a;
      }
    }
  }
}

// the reverse state pass: dC_c = beta_c dC_{c+1} + sum_t exp(cum_t) q_t (g_t / den_t)^T
// per (32-column slab, row); dC at every chunk's end goes to dcend (BH, nch,
// dh, dh), and the slab's part of <dC_{c+1}, C_c> to dbc (slab, BH, nch).
template <int BM>
__global__ void __launch_bounds__(kThreads)
mlstm_bstate(const float* __restrict__ q, const float* __restrict__ g,
             const float* __restrict__ den, const float* __restrict__ alpha,
             const float* __restrict__ beta, const float* __restrict__ cst,
             float* __restrict__ dcend, float* __restrict__ dbc, Dims d) {
  constexpr int TM = BM / 64, TN = 8, TX = kE / TN, TY = BM / TM;
  __shared__ float sA[kBK * (BM + 4)], sB[kBK * (kE + 4)], red[kThreads];
  const int slab = blockIdx.x, e0 = slab * kE, bh = blockIdx.y, dh = d.dh;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  float acc[TM][TN];
  zero(acc);
  for (int c = d.nch - 1; c >= 0; --c) {
    const size_t sc = (size_t)bh * d.nch + c;
    float* dc = dcend + sc * dh * dh;
    const float* cc = cst + sc * dh * dh;
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int rr = ty + TY * i, e = e0 + tx + TX * j;
        if (rr < dh && e < dh) {
          dc[(size_t)rr * dh + e] = acc[i][j];
          part = fmaf(acc[i][j], cc[(size_t)rr * dh + e], part);
        }
      }
    part = block_sum(part, red);
    if (threadIdx.x == 0) dbc[((size_t)slab * d.BH + bh) * d.nch + c] = part;
    if (c == 0) break;
    const float b = beta[sc];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] *= b;
    const size_t row = (size_t)bh * d.S + (size_t)c * kP;
    const float* qc = q + row * dh;
    const float* gc = g + row * dh;
    tile_mm<BM, kE, TM, TN, false, true>(
        acc, 0, chunk_len(d, c),
        [&](int m, int t) { return m < dh ? alpha[row + t] * qc[(size_t)t * dh + m] : 0.f; },
        [&](int t, int n) {
          return e0 + n < dh ? gc[(size_t)t * dh + e0 + n] / den[row + t] : 0.f;
        },
        sA, sB);
  }
}

// per (s tile, t tile, row * chunk), s <= t: dA = (g_t / den_t) . v_s + r_t and
// the scores again; A = (q.k) D, dS = dA D, H = dA (q.k) exp(cum_t - cum_s)
__global__ void __launch_bounds__(kThreads)
mlstm_bscores(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ g,
              const float* __restrict__ den, const float* __restrict__ r,
              const float* __restrict__ cum, const float* __restrict__ ig,
              float* __restrict__ amat, float* __restrict__ dsm, float* __restrict__ hm, Dims d) {
  const int st = blockIdx.x, tt = blockIdx.y, bc = blockIdx.z;
  const int bh = bc / d.nch, c = bc % d.nch, L = chunk_len(d, c);
  if (st > tt || tt * kT >= L) return;
  __shared__ float sA[kSmemA], sB[kSmemB];
  const size_t row = (size_t)bh * d.S + (size_t)c * kP;
  const int t0 = tt * kT, s0 = st * kT, dh = d.dh;
  const float* qc = q + row * dh;
  const float* kc = k + row * dh;
  const float* vc = v + row * dh;
  const float* gc = g + row * dh;
  float da[kTM][kTM], sc[kTM][kTM];
  zero(da);
  zero(sc);
  tile_mm<kT, kT, kTM, kTM, true, false>(
      da, 0, dh,
      [&](int m, int i) {
        return t0 + m < L ? gc[(size_t)(t0 + m) * dh + i] / den[row + t0 + m] : 0.f;
      },
      [&](int i, int n) { return s0 + n < L ? vc[(size_t)(s0 + n) * dh + i] : 0.f; }, sA, sB);
  tile_mm<kT, kT, kTM, kTM, true, false>(
      sc, 0, dh,
      [&](int m, int i) { return t0 + m < L ? qc[(size_t)(t0 + m) * dh + i] : 0.f; },
      [&](int i, int n) { return s0 + n < L ? kc[(size_t)(s0 + n) * dh + i] : 0.f; }, sA, sB);
  const int tx = threadIdx.x % kTY, ty = threadIdx.x / kTY;
  const size_t base = (size_t)bc * kP * kP;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int t = t0 + ty + kTY * i;
#pragma unroll
    for (int j = 0; j < kTM; ++j) {
      const int s = s0 + tx + kTY * j;
      float a = 0.f, ds = 0.f, hh = 0.f;
      if (s <= t && t < L) {
        const float e = expf(cum[row + t] - cum[row + s]);
        const float dd = e * ig[row + s];
        const float dA = da[i][j] + r[row + t];
        a = sc[i][j] * dd;
        ds = dA * dd;
        hh = dA * (sc[i][j] * e);
      }
      const size_t o = base + (size_t)t * kP + s;
      amat[o] = a;
      dsm[o] = ds;
      hm[o] = hh;
    }
  }
}

// dq_t = exp(cum_t) (C_c (g_t / den_t) + r_t n_c) + sum_s dS_ts k_s; the d tile's
// part of q_t . (C_c g_t / den_t + r_t n_c), the gradient of exp(cum_t), to
// dal (d tile, BH, S). Grid (d tile, t tile, row * chunk).
__global__ void __launch_bounds__(kThreads)
mlstm_dq(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ g, const float* __restrict__ den,
         const float* __restrict__ r, const float* __restrict__ alpha,
         const float* __restrict__ cst, const float* __restrict__ nst,
         const float* __restrict__ dsm, float* __restrict__ dq, float* __restrict__ dal, Dims d) {
  const int dt = blockIdx.x, tt = blockIdx.y, bc = blockIdx.z;
  const int bh = bc / d.nch, c = bc % d.nch, L = chunk_len(d, c);
  if (tt * kT >= L) return;
  __shared__ float sA[kSmemA], sB[kSmemB];
  const size_t row = (size_t)bh * d.S + (size_t)c * kP;
  const int t0 = tt * kT, d0 = dt * kT, dh = d.dh;
  const float* gc = g + row * dh;
  const float* qc = q + row * dh;
  const float* kc = k + row * dh;
  const float* cc = cst + (size_t)bc * dh * dh;
  const float* nc = nst + (size_t)bc * dh;
  const float* ds = dsm + (size_t)bc * kP * kP;
  float acc[kTM][kTM];
  zero(acc);
  if (c > 0)
    tile_mm<kT, kT, kTM, kTM, true, false>(
        acc, 0, dh,
        [&](int m, int e) {
          return t0 + m < L ? gc[(size_t)(t0 + m) * dh + e] / den[row + t0 + m] : 0.f;
        },
        [&](int e, int n) { return d0 + n < dh ? cc[(size_t)(d0 + n) * dh + e] : 0.f; }, sA, sB);
  const int tx = threadIdx.x % kTY, ty = threadIdx.x / kTY;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int t = t0 + ty + kTY * i;
    const bool tin = t < L;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < kTM; ++j) {
      const int dd = d0 + tx + kTY * j;
      if (tin && dd < dh) {
        acc[i][j] = fmaf(r[row + t], nc[dd], acc[i][j]);
        part = fmaf(qc[(size_t)t * dh + dd], acc[i][j], part);
        acc[i][j] *= alpha[row + t];
      }
    }
    part = tx_sum(part);
    if (tin && tx == 0) dal[((size_t)dt * d.BH + bh) * d.S + c * kP + t] = part;
  }
  tile_mm<kT, kT, kTM, kTM, true, true>(
      acc, 0, min(t0 + kT, L),
      [&](int m, int s) { return ds[(size_t)(t0 + m) * kP + s]; },
      [&](int s, int n) { return d0 + n < dh ? kc[(size_t)s * dh + d0 + n] : 0.f; }, sA, sB);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int t = t0 + ty + kTY * i;
    if (t >= L) continue;
#pragma unroll
    for (int j = 0; j < kTM; ++j) {
      const int dd = d0 + tx + kTY * j;
      if (dd < dh) dq[(row + t) * dh + dd] = acc[i][j];
    }
  }
}

// dk_s = u_s (dC_end v_s + dn_end) + sum_{t >= s} dS_ts q_t; the d tile's part of
// k_s . (dC_end v_s + dn_end), the gradient of u_s, to du (d tile, BH, S).
// Grid (d tile, s tile, row * chunk).
__global__ void __launch_bounds__(kThreads)
mlstm_dk(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, const float* __restrict__ u,
         const float* __restrict__ dcend, const float* __restrict__ dnend,
         const float* __restrict__ dsm, float* __restrict__ dk, float* __restrict__ du, Dims d) {
  const int dt = blockIdx.x, st = blockIdx.y, bc = blockIdx.z;
  const int bh = bc / d.nch, c = bc % d.nch, L = chunk_len(d, c);
  if (st * kT >= L) return;
  __shared__ float sA[kSmemA], sB[kSmemB];
  const size_t row = (size_t)bh * d.S + (size_t)c * kP;
  const int s0 = st * kT, d0 = dt * kT, dh = d.dh;
  const float* vc = v + row * dh;
  const float* kc = k + row * dh;
  const float* qc = q + row * dh;
  const float* dcc = dcend + (size_t)bc * dh * dh;
  const float* dnc = dnend + (size_t)bc * dh;
  const float* ds = dsm + (size_t)bc * kP * kP;
  float acc[kTM][kTM];
  zero(acc);
  if (c < d.nch - 1)   // nothing flows back into the last chunk's state update
    tile_mm<kT, kT, kTM, kTM, true, false>(
        acc, 0, dh,
        [&](int m, int e) { return s0 + m < L ? vc[(size_t)(s0 + m) * dh + e] : 0.f; },
        [&](int e, int n) { return d0 + n < dh ? dcc[(size_t)(d0 + n) * dh + e] : 0.f; }, sA, sB);
  const int tx = threadIdx.x % kTY, ty = threadIdx.x / kTY;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int s = s0 + ty + kTY * i;
    const bool s_in = s < L;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < kTM; ++j) {
      const int dd = d0 + tx + kTY * j;
      if (s_in && dd < dh) {
        acc[i][j] += dnc[dd];
        part = fmaf(kc[(size_t)s * dh + dd], acc[i][j], part);
        acc[i][j] *= u[row + s];
      }
    }
    part = tx_sum(part);
    if (s_in && tx == 0) du[((size_t)dt * d.BH + bh) * d.S + c * kP + s] = part;
  }
  tile_mm<kT, kT, kTM, kTM, false, true>(
      acc, s0, L,
      [&](int m, int t) { return ds[(size_t)t * kP + s0 + m]; },
      [&](int t, int n) { return d0 + n < dh ? qc[(size_t)t * dh + d0 + n] : 0.f; }, sA, sB);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int s = s0 + ty + kTY * i;
    if (s >= L) continue;
#pragma unroll
    for (int j = 0; j < kTM; ++j) {
      const int dd = d0 + tx + kTY * j;
      if (dd < dh) dk[(row + s) * dh + dd] = acc[i][j];
    }
  }
}

// dv_s = u_s k_s^T dC_end + sum_{t >= s} A_ts g_t / den_t; grid (e tile, s tile,
// row * chunk)
__global__ void __launch_bounds__(kThreads)
mlstm_dv(const float* __restrict__ k, const float* __restrict__ g,
         const float* __restrict__ den, const float* __restrict__ u,
         const float* __restrict__ dcend, const float* __restrict__ amat,
         float* __restrict__ dv, Dims d) {
  const int et = blockIdx.x, st = blockIdx.y, bc = blockIdx.z;
  const int bh = bc / d.nch, c = bc % d.nch, L = chunk_len(d, c);
  if (st * kT >= L) return;
  __shared__ float sA[kSmemA], sB[kSmemB];
  const size_t row = (size_t)bh * d.S + (size_t)c * kP;
  const int s0 = st * kT, e0 = et * kT, dh = d.dh;
  const float* kc = k + row * dh;
  const float* gc = g + row * dh;
  const float* dcc = dcend + (size_t)bc * dh * dh;
  const float* ac = amat + (size_t)bc * kP * kP;
  float acc[kTM][kTM];
  zero(acc);
  const int tx = threadIdx.x % kTY, ty = threadIdx.x / kTY;
  if (c < d.nch - 1) {
    tile_mm<kT, kT, kTM, kTM, true, true>(
        acc, 0, dh,
        [&](int m, int i) { return s0 + m < L ? kc[(size_t)(s0 + m) * dh + i] : 0.f; },
        [&](int i, int n) { return e0 + n < dh ? dcc[(size_t)i * dh + e0 + n] : 0.f; }, sA, sB);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int s = s0 + ty + kTY * i;
      const float us = s < L ? u[row + s] : 0.f;
#pragma unroll
      for (int j = 0; j < kTM; ++j) acc[i][j] *= us;
    }
  }
  tile_mm<kT, kT, kTM, kTM, false, true>(
      acc, s0, L,
      [&](int m, int t) { return ac[(size_t)t * kP + s0 + m]; },
      [&](int t, int n) {
        return e0 + n < dh ? gc[(size_t)t * dh + e0 + n] / den[row + t] : 0.f;
      },
      sA, sB);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int s = s0 + ty + kTY * i;
    if (s >= L) continue;
#pragma unroll
    for (int j = 0; j < kTM; ++j) {
      const int e = e0 + tx + kTY * j;
      if (e < dh) dv[(row + s) * dh + e] = acc[i][j];
    }
  }
}

// one block per (row, chunk): the gate gradients.
//   d i_s   = sum_{t >= s} H_ts + du_s w_s,               w_s = exp(cum_P - cum_s)
//   d cum_t = sum_{s <= t} H_ts i_s - i_t sum_{t' >= t} H_t't + exp(cum_t) dal_t
//             - du_t i_t w_t   (+ sum_s du_s i_s w_s + dbeta exp(cum_P) at t = P)
//   d log_f = the reverse cumulative sum of d cum within the chunk.
__global__ void __launch_bounds__(kThreads)
mlstm_gates(const float* __restrict__ cum, const float* __restrict__ alpha,
            const float* __restrict__ ig, const float* __restrict__ beta,
            const float* __restrict__ hm, const float* __restrict__ dal,
            const float* __restrict__ du, const float* __restrict__ dbc,
            const float* __restrict__ dbn, float* __restrict__ dlf, float* __restrict__ dig,
            Dims d) {
  __shared__ float dcum[kP], dw[kP];
  const int bc = blockIdx.x, bh = bc / d.nch, c = bc % d.nch, L = chunk_len(d, c);
  const size_t row = (size_t)bh * d.S + (size_t)c * kP;
  const float* hc = hm + (size_t)bc * kP * kP;
  const int n_dt = (d.dh + kT - 1) / kT, n_slab = (d.dh + kE - 1) / kE;
  const float last = cum[row + L - 1];
  for (int t = threadIdx.x; t < L; t += kThreads) {
    float rowg = 0.f, colh = 0.f, da = 0.f, dut = 0.f;
    for (int s = 0; s <= t; ++s) rowg = fmaf(hc[(size_t)t * kP + s], ig[row + s], rowg);
    for (int t2 = t; t2 < L; ++t2) colh += hc[(size_t)t2 * kP + t];
    for (int j = 0; j < n_dt; ++j) {
      da += dal[((size_t)j * d.BH + bh) * d.S + c * kP + t];
      dut += du[((size_t)j * d.BH + bh) * d.S + c * kP + t];
    }
    const float w = expf(last - cum[row + t]);
    const float g = dut * ig[row + t] * w;
    dig[row + t] = colh + dut * w;
    dw[t] = g;
    dcum[t] = rowg - ig[row + t] * colh + alpha[row + t] * da - g;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sw = 0.f;
    for (int t = 0; t < L; ++t) sw += dw[t];
    float db = dbn[bc];
    for (int j = 0; j < n_slab; ++j) db += dbc[((size_t)j * d.BH + bh) * d.nch + c];
    dcum[L - 1] += sw + db * beta[bc];
    float run = 0.f;
    for (int t = L - 1; t >= 0; --t) {
      run += dcum[t];
      dlf[row + t] = run;
    }
  }
}

bool dims_ok(long long BH, long long S, long long dh) {
  const long long nch = (S + kP - 1) / kP;
  return BH >= 1 && S >= 1 && dh >= 1 && dh <= kMaxDh && BH * S <= 0x7fffffffLL &&
         BH * nch <= 65535 && BH <= 65535;
}

template <int BM>
cudaError_t launch_state(const float* k, const float* v, const float* u, const float* beta,
                         float* cst, Dims d, cudaStream_t st) {
  mlstm_state<BM><<<dim3((d.dh + kE - 1) / kE, d.BH), kThreads, 0, st>>>(k, v, u, beta, cst, d);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_bstate(const float* q, const float* g, const float* den, const float* alpha,
                          const float* beta, const float* cst, float* dcend, float* dbc, Dims d,
                          cudaStream_t st) {
  mlstm_bstate<BM><<<dim3((d.dh + kE - 1) / kE, d.BH), kThreads, 0, st>>>(
      q, g, den, alpha, beta, cst, dcend, dbc, d);
  return cudaGetLastError();
}

}  // namespace

#define CHECK_LAUNCH()                          \
  do {                                          \
    cudaError_t e_ = cudaGetLastError();        \
    if (e_ != cudaSuccess) return e_;           \
  } while (0)

// The forward: h (BH, S, dh) from q, k, v (BH, S, dh) and lf, ig (BH, S), all
// fp32 and contiguous. Scratch and saved state, sized by the caller (nch =
// ceil(S / 256)): cum, alpha, u, nq, den (BH, S); beta (BH, nch); amat (BH,
// nch, 256, 256); cst (BH, nch, dh, dh); nst (BH, nch, dh). Five launches on
// `stream`: prep, scores, state, norm, out. Returns a cudaError_t.
extern "C" int mlstm_chunk_forward(const float* q, const float* k, const float* v,
                                   const float* lf, const float* ig, float* h, float* cum,
                                   float* alpha, float* u, float* beta, float* amat, float* cst,
                                   float* nst, float* nq, float* den, long long BH, long long S,
                                   long long dh, void* stream) {
  if (!dims_ok(BH, S, dh)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d{static_cast<int>(BH), static_cast<int>(S), static_cast<int>(dh),
               static_cast<int>((S + kP - 1) / kP)};
  const int nt = kP / kT, ndt = (d.dh + kT - 1) / kT;
  mlstm_prep<<<(d.BH * d.nch + 127) / 128, 128, 0, st>>>(lf, ig, cum, alpha, u, beta, d);
  CHECK_LAUNCH();
  mlstm_scores<<<dim3(nt, nt, d.BH * d.nch), kThreads, 0, st>>>(q, k, cum, ig, amat, d);
  CHECK_LAUNCH();
  cudaError_t e;
  if (dh <= 64) e = launch_state<64>(k, v, u, beta, cst, d, st);
  else if (dh <= 128) e = launch_state<128>(k, v, u, beta, cst, d, st);
  else if (dh <= 256) e = launch_state<256>(k, v, u, beta, cst, d, st);
  else e = launch_state<512>(k, v, u, beta, cst, d, st);
  if (e != cudaSuccess) return e;
  mlstm_norm<<<d.BH, kThreads, 0, st>>>(q, k, amat, alpha, u, beta, nst, nq, den, d);
  CHECK_LAUNCH();
  mlstm_out<<<dim3(ndt, nt, d.BH * d.nch), kThreads, 0, st>>>(q, v, amat, cst, alpha, den, h, d);
  CHECK_LAUNCH();
  return cudaSuccess;
}

// The backward of h w.r.t. q, k, v, lf, ig for the output gradient g (like
// h), from the forward's saved h, cum, alpha, u, beta, cst, nst, nq, den.
// Scratch, sized by the caller: r (BH, S); dnend (BH, nch, dh); dbn (BH,
// nch); dcend (BH, nch, dh, dh); amat, dsm, hm (BH, nch, 256, 256); dal, du
// (ceil(dh / 64), BH, S); dbc (ceil(dh / 32), BH, nch). Seven launches on
// `stream`: bprep, bstate, bscores, dq, dk, dv, gates. Returns a cudaError_t.
extern "C" int mlstm_chunk_backward(const float* q, const float* k, const float* v,
                                    const float* ig, const float* h, const float* g,
                                    const float* cum, const float* alpha, const float* u,
                                    const float* beta, const float* cst, const float* nst,
                                    const float* nq, const float* den, float* r, float* dnend,
                                    float* dbn, float* dcend, float* amat, float* dsm, float* hm,
                                    float* dal, float* du, float* dbc, float* dq, float* dk,
                                    float* dv, float* dlf, float* dig, long long BH, long long S,
                                    long long dh, void* stream) {
  if (!dims_ok(BH, S, dh)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d{static_cast<int>(BH), static_cast<int>(S), static_cast<int>(dh),
               static_cast<int>((S + kP - 1) / kP)};
  const int nt = kP / kT, ndt = (d.dh + kT - 1) / kT;
  mlstm_bprep<<<d.BH, kThreads, 0, st>>>(q, h, g, nq, den, alpha, beta, nst, r, dnend, dbn, d);
  CHECK_LAUNCH();
  cudaError_t e;
  if (dh <= 64) e = launch_bstate<64>(q, g, den, alpha, beta, cst, dcend, dbc, d, st);
  else if (dh <= 128) e = launch_bstate<128>(q, g, den, alpha, beta, cst, dcend, dbc, d, st);
  else if (dh <= 256) e = launch_bstate<256>(q, g, den, alpha, beta, cst, dcend, dbc, d, st);
  else e = launch_bstate<512>(q, g, den, alpha, beta, cst, dcend, dbc, d, st);
  if (e != cudaSuccess) return e;
  const dim3 tiles(nt, nt, d.BH * d.nch), dtiles(ndt, nt, d.BH * d.nch);
  mlstm_bscores<<<tiles, kThreads, 0, st>>>(q, k, v, g, den, r, cum, ig, amat, dsm, hm, d);
  CHECK_LAUNCH();
  mlstm_dq<<<dtiles, kThreads, 0, st>>>(q, k, g, den, r, alpha, cst, nst, dsm, dq, dal, d);
  CHECK_LAUNCH();
  mlstm_dk<<<dtiles, kThreads, 0, st>>>(q, k, v, u, dcend, dnend, dsm, dk, du, d);
  CHECK_LAUNCH();
  mlstm_dv<<<dtiles, kThreads, 0, st>>>(k, g, den, u, dcend, amat, dv, d);
  CHECK_LAUNCH();
  mlstm_gates<<<d.BH * d.nch, kThreads, 0, st>>>(cum, alpha, ig, beta, hm, dal, du, dbc, dbn,
                                                 dlf, dig, d);
  CHECK_LAUNCH();
  return cudaSuccess;
}

extern "C" const char* mlstm_chunk_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
