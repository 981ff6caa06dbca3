// K4 on Hopper: causal / sliding-window flash attention, forward and
// backward, with grouped KV heads.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel): per (batch*head, q block) an online
// softmax over kv blocks with fp32 (m, l, acc), p cast to v's dtype before
// the product with v, O = acc / max(l, 1e-30). The Pallas kernel has no
// VJP (the JAX package trains through jnp attention and autodiff); here the
// kernels are the only path on the card, so the backward is FlashAttention-2's:
//   D_i = sum_d dO_id O_id,  P_ij = exp(s_ij - lse_i),
//   dV_j = sum_i P_ij dO_i,  dS_ij = P_ij (dO_i . V_j - D_i),
//   dQ_i = scale sum_j dS_ij K_j,  dK_j = scale sum_i dS_ij Q_i,
// with P cast to v's dtype in dV as in the forward's product.
//
// Layout: the model's own, after RoPE: q, o, dO (N, S, H, hd); k, v
// (N, S, KV, hd), H a multiple of KV, query head h reading KV head h / G
// (G = H / KV), as the JAX package's grouped form q.reshape(B, S, KV, G, hd)
// does. lse and D are (N, H, S) fp32. Types fp32 or bf16 (one for all of q,
// k, v); statistics, accumulators and the scores fp32. Any S (the ragged
// tail is masked: keys >= S score -inf, rows >= S are not written), any
// hd <= 128 (staged zero-padded to 32, 64 or 128). The plain versions are
// src/repro_torch/kernels/ref.py::attention_ref and ::attention_bwd_ref.
//
// Bound. On the path (N*H = 16*15, S = 512, hd = 64, causal, bf16) the
// forward reads q, k, v and writes o, ~42 MB, against ~8 GFLOP of products:
// ~0.013 ms by bytes at the H100's 3.35 TB/s, ~0.008 ms by the 989 TFLOP/s
// bf16 tensor-core rate. This first version runs the products on the fp32
// FMA units (67 TFLOP/s), so it is bound by operations, ~0.12 ms, and more
// by its shared-memory loads (two per two FMAs in the score loop). Tensor
// cores (mma.sync / wgmma) are later work.
//
// Design. A block of 256 threads owns a 64-row tile of queries of one head
// (forward, dQ) or a 64-row tile of keys of one KV head (dK/dV). Tiles are
// staged in shared memory as fp32 with rows padded to hd + 1 words (no bank
// conflicts on column walks). Each thread owns a 4 x 4 micro-tile of the
// 64 x 64 score tile: rows 4*(t/16)..+3, columns t%16 + 16j, so a row's 16
// owners are 16 lanes of one warp and row reductions are shuffles within
// them. Causal and window limits skip whole tiles outside the mask. The
// dK/dV kernel sums the G query heads of its group and every q tile in a
// fixed order, and every output element has one writer: no float atomics,
// the results do not change from run to run.
//
// Build without --use_fast_math (expf, logf and IEEE division as written).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per tile
constexpr int kBK = 64;          // key rows per tile
constexpr int kThreads = 256;    // 16 row groups x 16 column lanes

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// the cast of p to v's dtype (a no-op for fp32)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// max and sum over the 16 lanes that own one row (lanes differ in bits 0-3)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int S, int causal, int window) {
  return qpos < S && kpos < S && (!causal || qpos >= kpos) && (!window || qpos - kpos < window);
}

// Stage rows [r0, r0 + 64) of one head into sm (64 x (HD + 1) fp32), zero
// beyond S and beyond hd. `base` points at (row 0, this head, d 0);
// consecutive rows are `stride` elements apart.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* sm, const T* __restrict__ base, long long stride,
                                      int r0, int S, int hd) {
  constexpr int LD = HD + 1;
  for (int i = threadIdx.x; i < 64 * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, s = r0 + r;
    sm[r * LD + d] = (s < S && d < hd) ? to_f(base[s * stride + d]) : 0.f;
  }
}

template <int HD>
constexpr int fwd_smem() { return (kBQ + 2 * kBK) * (HD + 1) * 4 + kBQ * (kBK + 1) * 4; }
template <int HD>
constexpr int dq_smem() { return (2 * kBQ + 2 * kBK) * (HD + 1) * 4 + kBQ * (kBK + 1) * 4; }
template <int HD>
constexpr int dkdv_smem() {
  return (2 * kBQ + 2 * kBK) * (HD + 1) * 4 + 2 * kBK * (kBQ + 1) * 4 + 2 * kBQ * 4;
}

// ---------------------------------------------------------------------------
// forward: grid (q tiles, H, N)
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int S, int H, int KV, int hd, int causal,
    int window, float scale) {
  constexpr int LD = HD + 1, ND = HD / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sP = sV + kBK * LD;      // kBQ x (kBK + 1), p cast to T
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, n = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const long long qstride = static_cast<long long>(H) * hd;
  const long long kstride = static_cast<long long>(KV) * hd;
  const T* qb = q + (static_cast<long long>(n) * S * H + h) * hd;
  const T* kb = k + (static_cast<long long>(n) * S * KV + kvh) * hd;
  const T* vb = v + (static_cast<long long>(n) * S * KV + kvh) * hd;

  stage<T, HD>(sQ, qb, qstride, q0, S, hd);
  float m[4], l[4], acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) acc[i][dd] = 0.f;
  }

  const int k_end = causal ? min(S, q0 + kBQ) : S;
  const int k_begin = window ? max(0, q0 - window + 1) : 0;
  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();   // the previous tile's sK, sV, sP are consumed
    stage<T, HD>(sK, kb, kstride, k0, S, hd);
    stage<T, HD>(sV, vb, kstride, k0, S, hd);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(tr * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sK[(tc + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + tr * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = visible(qpos, k0 + tc + 16 * j, S, causal, window);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      // nothing visible in this row so far: no mass, nothing to rescale
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        sum += p;
        sP[(tr * 4 + i) * (kBK + 1) + tc + 16 * j] = round_to<T>(p);
      }
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int dd = 0; dd < ND; ++dd) acc[i][dd] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[4], vv[ND];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(tr * 4 + i) * (kBK + 1) + j];
#pragma unroll
      for (int dd = 0; dd < ND; ++dd) vv[dd] = sV[j * LD + tc + 16 * dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int dd = 0; dd < ND; ++dd) acc[i][dd] = fmaf(p[i], vv[dd], acc[i][dd]);
    }
  }

  T* ob = o + (static_cast<long long>(n) * S * H + h) * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    if (row >= S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) {
      const int d = tc + 16 * dd;
      if (d < hd) ob[row * qstride + d] = from_f<T>(acc[i][dd] / lc);
    }
    if (tc == 0) lse[(static_cast<long long>(n) * H + h) * S + row] = m[i] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// backward, dQ (and D): grid (q tiles, H, N)
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ dbuf, T* __restrict__ dq, int S, int H, int KV, int hd, int causal,
    int window, float scale) {
  constexpr int LD = HD + 1, ND = HD / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kBQ * LD;
  float* sK = sdO + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sdS = sV + kBK * LD;     // kBQ x (kBK + 1)
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, n = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const long long qstride = static_cast<long long>(H) * hd;
  const long long kstride = static_cast<long long>(KV) * hd;
  const long long qoff = (static_cast<long long>(n) * S * H + h) * hd;
  const T* kb = k + (static_cast<long long>(n) * S * KV + kvh) * hd;
  const T* vb = v + (static_cast<long long>(n) * S * KV + kvh) * hd;
  const long long soff = (static_cast<long long>(n) * H + h) * S;

  stage<T, HD>(sQ, q + qoff, qstride, q0, S, hd);
  stage<T, HD>(sdO, dout + qoff, qstride, q0, S, hd);

  // D_i = sum_d dO_id O_id over this row's 16 lanes; the row's lse
  float Drow[4], lrow[4], acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    float part = 0.f;
    if (row < S) {
      for (int d = tc; d < hd; d += 16)
        part = fmaf(to_f(dout[qoff + row * qstride + d]), to_f(o[qoff + row * qstride + d]), part);
    }
    Drow[i] = row_sum(part);
    lrow[i] = row < S ? lse[soff + row] : 0.f;
    if (row < S && tc == 0) dbuf[soff + row] = Drow[i];
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) acc[i][dd] = 0.f;
  }

  const int k_end = causal ? min(S, q0 + kBQ) : S;
  const int k_begin = window ? max(0, q0 - window + 1) : 0;
  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();
    stage<T, HD>(sK, kb, kstride, k0, S, hd);
    stage<T, HD>(sV, vb, kstride, k0, S, hd);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[4], g[4], b[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sQ[(tr * 4 + i) * LD + d];
        g[i] = sdO[(tr * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = sK[(tc + 16 * j) * LD + d];
        c[j] = sV[(tc + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], c[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + tr * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = visible(qpos, k0 + tc + 16 * j, S, causal, window);
        const float p = ok ? expf(s[i][j] * scale - lrow[i]) : 0.f;
        sdS[(tr * 4 + i) * (kBK + 1) + tc + 16 * j] = p * (dp[i][j] - Drow[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float ds[4], kk[ND];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sdS[(tr * 4 + i) * (kBK + 1) + j];
#pragma unroll
      for (int dd = 0; dd < ND; ++dd) kk[dd] = sK[j * LD + tc + 16 * dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int dd = 0; dd < ND; ++dd) acc[i][dd] = fmaf(ds[i], kk[dd], acc[i][dd]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    if (row >= S) continue;
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) {
      const int d = tc + 16 * dd;
      if (d < hd) dq[qoff + row * qstride + d] = from_f<T>(acc[i][dd] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dK and dV: grid (k tiles, KV, N); runs after flash_bwd_dq (D)
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dbuf,
    T* __restrict__ dk, T* __restrict__ dv, int S, int H, int KV, int hd, int causal,
    int window, float scale) {
  constexpr int LD = HD + 1, ND = HD / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kBK * LD;
  float* sQ = sV + kBK * LD;
  float* sdO = sQ + kBQ * LD;
  float* sPt = sdO + kBQ * LD;        // kBK x (kBQ + 1): P^T cast to T
  float* sdSt = sPt + kBK * (kBQ + 1);  // kBK x (kBQ + 1): dS^T
  float* sL = sdSt + kBK * (kBQ + 1);   // kBQ lse of the staged rows
  float* sD = sL + kBQ;                 // kBQ D of the staged rows
  const int k0 = blockIdx.x * kBK, kvh = blockIdx.y, n = blockIdx.z;
  const int G = H / KV;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;   // keys tr*4+i, queries tc+16j
  const long long qstride = static_cast<long long>(H) * hd;
  const long long kstride = static_cast<long long>(KV) * hd;
  const long long koff = (static_cast<long long>(n) * S * KV + kvh) * hd;

  stage<T, HD>(sK, k + koff, kstride, k0, S, hd);
  stage<T, HD>(sV, v + koff, kstride, k0, S, hd);
  float gk[4][ND], gv[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) gk[i][dd] = gv[i][dd] = 0.f;

  // queries that can see a key of this tile
  const int q_begin = causal ? k0 : 0;
  const int q_end = window ? min(S, k0 + kBK - 1 + window) : S;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long long qoff = (static_cast<long long>(n) * S * H + h) * hd;
    const long long soff = (static_cast<long long>(n) * H + h) * S;
    for (int q0 = (q_begin / kBQ) * kBQ; q0 < q_end; q0 += kBQ) {
      __syncthreads();
      stage<T, HD>(sQ, q + qoff, qstride, q0, S, hd);
      stage<T, HD>(sdO, dout + qoff, qstride, q0, S, hd);
      if (threadIdx.x < kBQ) {
        const int row = q0 + threadIdx.x;
        sL[threadIdx.x] = row < S ? lse[soff + row] : 0.f;
        sD[threadIdx.x] = row < S ? dbuf[soff + row] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float a[4], c[4], b[4], g2[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = sK[(tr * 4 + i) * LD + d];
          c[i] = sV[(tr * 4 + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[j] = sQ[(tc + 16 * j) * LD + d];
          g2[j] = sdO[(tc + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(b[j], a[i], s[i][j]);
            dp[i][j] = fmaf(g2[j], c[i], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + tr * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = tc + 16 * j;
          const bool ok = visible(q0 + qi, kpos, S, causal, window);
          const float p = ok ? expf(s[i][j] * scale - sL[qi]) : 0.f;
          sPt[(tr * 4 + i) * (kBQ + 1) + qi] = round_to<T>(p);
          sdSt[(tr * 4 + i) * (kBQ + 1) + qi] = p * (dp[i][j] - sD[qi]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kBQ; ++j) {
        float p[4], ds[4], qq[ND], gg[ND];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = sPt[(tr * 4 + i) * (kBQ + 1) + j];
          ds[i] = sdSt[(tr * 4 + i) * (kBQ + 1) + j];
        }
#pragma unroll
        for (int dd = 0; dd < ND; ++dd) {
          qq[dd] = sQ[j * LD + tc + 16 * dd];
          gg[dd] = sdO[j * LD + tc + 16 * dd];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int dd = 0; dd < ND; ++dd) {
            gv[i][dd] = fmaf(p[i], gg[dd], gv[i][dd]);
            gk[i][dd] = fmaf(ds[i], qq[dd], gk[i][dd]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + tr * 4 + i;
    if (row >= S) continue;
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) {
      const int d = tc + 16 * dd;
      if (d < hd) {
        dk[koff + row * kstride + d] = from_f<T>(gk[i][dd] * scale);
        dv[koff + row * kstride + d] = from_f<T>(gv[i][dd]);
      }
    }
  }
}

bool dims_ok(long long N, long long S, long long H, long long KV, long long hd) {
  return N >= 1 && N <= 65535 && S >= 1 && S <= 0x7fffffffLL - kBQ && H >= 1 && H <= 65535 &&
         KV >= 1 && H % KV == 0 && hd >= 1 && hd <= 128 && N * S * H * hd < (1LL << 62);
}

template <typename T, int HD>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int N, int S,
               int H, int KV, int hd, int causal, int window, float scale, cudaStream_t st) {
  constexpr int smem = fwd_smem<HD>();
  // once per instantiation, at the first call (before any CUDA-graph
  // capture; the port drives one device)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((S + kBQ - 1) / kBQ, H, N);
  flash_fwd<T, HD><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, S, H, KV, hd, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, float* dbuf, void* dq, void* dk, void* dv, int N, int S, int H,
               int KV, int hd, int causal, int window, float scale, cudaStream_t st) {
  constexpr int smem_q = dq_smem<HD>(), smem_kv = dkdv_smem<HD>();
  static const cudaError_t attr = [] {   // once per instantiation, as launch_fwd
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dkdv<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
    return e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  flash_bwd_dq<T, HD><<<dim3((S + kBQ - 1) / kBQ, H, N), kThreads, smem_q, st>>>(
      qt, kt, vt, static_cast<const T*>(o), dot, lse, dbuf, static_cast<T*>(dq), S, H, KV, hd,
      causal, window, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv<T, HD><<<dim3((S + kBK - 1) / kBK, KV, N), kThreads, smem_kv, st>>>(
      qt, kt, vt, dot, lse, dbuf, static_cast<T*>(dk), static_cast<T*>(dv), S, H, KV, hd, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: (N, S, H, hd); k, v: (N, S, KV, hd), one dtype (0 fp32, 1 bf16),
// contiguous; lse: (N, H, S) fp32; scale the fp32 of 1 / sqrt(hd), as the
// caller computes it. Launches flash_fwd on `stream`; does
// not synchronise. Returns a cudaError_t.
extern "C" int flash_attention_forward(const void* q, const void* k, const void* v, void* o,
                                       float* lse, long long N, long long S, long long H,
                                       long long KV, long long hd, int causal, long long window,
                                       float scale, int bf16, void* stream) {
  if (!dims_ok(N, S, H, KV, hd) || window < 0 || window > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(N), s = static_cast<int>(S), h = static_cast<int>(H),
            kv = static_cast<int>(KV), d = static_cast<int>(hd), w = static_cast<int>(window);
#define FWD(T, HD) launch_fwd<T, HD>(q, k, v, o, lse, n, s, h, kv, d, causal, w, scale, st)
  if (bf16) {
    if (hd <= 32) return FWD(__nv_bfloat16, 32);
    if (hd <= 64) return FWD(__nv_bfloat16, 64);
    return FWD(__nv_bfloat16, 128);
  }
  if (hd <= 32) return FWD(float, 32);
  if (hd <= 64) return FWD(float, 64);
  return FWD(float, 128);
#undef FWD
}

// The backward: dq like q, dk and dv like k; dbuf (N, H, S) fp32 scratch
// for D. Launches flash_bwd_dq then flash_bwd_dkdv on `stream`; does not
// synchronise. Returns a cudaError_t.
extern "C" int flash_attention_backward(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const float* lse,
                                        float* dbuf, void* dq, void* dk, void* dv, long long N,
                                        long long S, long long H, long long KV, long long hd,
                                        int causal, long long window, float scale, int bf16,
                                        void* stream) {
  if (!dims_ok(N, S, H, KV, hd) || window < 0 || window > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(N), s = static_cast<int>(S), h = static_cast<int>(H),
            kv = static_cast<int>(KV), d = static_cast<int>(hd), w = static_cast<int>(window);
#define BWD(T, HD)                                                                            \
  launch_bwd<T, HD>(q, k, v, o, dout, lse, dbuf, dq, dk, dv, n, s, h, kv, d, causal, w, scale, \
                    st)
  if (bf16) {
    if (hd <= 32) return BWD(__nv_bfloat16, 32);
    if (hd <= 64) return BWD(__nv_bfloat16, 64);
    return BWD(__nv_bfloat16, 128);
  }
  if (hd <= 32) return BWD(float, 32);
  if (hd <= 64) return BWD(float, 64);
  return BWD(float, 128);
#undef BWD
}

extern "C" const char* flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
