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
// hd <= 160, forward and backward (staged zero-padded to 32, 64, 128 or
// 160; 160 is pixtral-12b's heads: rows of 168 bf16, 336 bytes, still
// 16-byte multiples for cp.async and ldmatrix, and 21 16-byte groups, odd,
// so ldmatrix stays conflict-free). The forward also takes k, v of their
// own length Sk (N, Sk, KV, hd) without a mask: the decoder's
// cross-attention over the encoder's output; keys >= Sk score -inf. The
// backward takes Sq = Sk (the wrapper runs it over query chunks across
// lengths). The plain versions are
// src/repro_torch/kernels/ref.py::attention_ref and ::attention_bwd_ref.
//
// Bound. On the path (N*H = 16*15, S = 512, hd = 64, causal, bf16) the
// forward reads q, k, v and writes o, ~42 MB, against ~8 GFLOP of products:
// ~0.013 ms by bytes at the H100's 3.35 TB/s, ~0.008 ms by the 989 TFLOP/s
// bf16 tensor-core rate; the backward ~0.025 ms by bytes, ~0.020 ms by its
// five products. The softmax's exp (one MUFU op an element, 16 a clock on
// an SM) and the shared-memory reads of the K/V fragments (each warp reads
// the whole tile) cost about as much as the products at this width.
//
// bf16: the tensor cores (namespace tc, flash_mma_*). mma.sync m16n8k16
// (bf16 in, fp32 accumulate) with operands from shared memory by ldmatrix
// (.trans for the right-hand operand of P V, dS K, P^T dO and dS^T Q). A
// block of 4 warps owns a 64-row tile of queries of one head (forward,
// dQ) or of keys of one KV head (dK/dV), each warp 16 rows; the other
// operand streams through a two-stage ring of 64-row bf16 tiles filled by
// cp.async 16 bytes a thread, the next tile in flight while this one is
// computed. Rows are padded by 16 bytes, so ldmatrix has no bank
// conflicts. The scores' accumulator layout is the A layout of the next
// product, so P (and dS) go from registers to the tensor cores without a
// trip through shared memory; row max and sum are shuffles within a quad.
// exp is exp2f of one FFMA (the row max kept unscaled, as FlashAttention-2
// does). dS stays fp32 as in the plain version: it enters dQ and dK as two
// bf16 products, hi = bf16(dS) and lo = bf16(dS - hi), ~16 bits of its
// mantissa; P enters dV as bf16, as in the forward. Masks are applied only
// to tiles the band or the ragged edge cuts. The forward and dQ launch the
// q tiles with the most keys first. Above hd 128 the dK/dV accumulators
// would not fit one warp's registers: flash_mma_bwd_dkdv<HD, 2> gives each
// 16 key rows two warps, a half of the head dim each.
//
// fp32: the tensor cores too, in split TF32 (namespace tf, flash_tf32_*).
// Each fp32 operand is split where its fragment is loaded into big =
// tf32(x) and small = tf32(x - big), both rounded as cvt.rna.tf32.f32
// rounds (K5's split, csrc/mlstm_chunk.cu), and each fp32 product is three
// mma.sync m16n8k8 TF32 products, small.big + big.small + big.big (the
// dropped small.small is ~2^-22 of it). One TF32 product keeps 11 bits of
// each input, ~5e-4 relative, and breaks the fp32 tolerances (2e-5
// forward, 1e-4 backward); big + small keeps ~22 bits, and the products'
// errors stay within a few times those of fp32 FMAs
// (tests/test_torch_attention_split.py emulates the kernels' arithmetic
// against the plain versions and the JAX package). Q K^T and dO V^T (K Q^T,
// V dO^T) are summed over the head dim in the tensor cores' fragments. The
// long sums, P V and dS K over keys, P^T dO and dS^T Q over the G heads'
// queries, take a fresh fragment every 32 rows, added to the fp32
// accumulator with one round-to-nearest add: the tensor cores need not
// round their own fp32 sums to nearest.
//   Bound: three TF32 products per fp32 product at 495 TFLOP/s, 165 TFLOP/s
// of fp32 products where the FMA units give 67; one exp (MUFU) a score,
// about a tenth of that. What holds the kernels back is issue: every warp
// splits every K or V element it reads (five integer and float
// instructions), so they issue about eight instructions an HMMA.
//   Design: the bf16 path's structure (4 warps of 16 rows a block, a
// two-stage cp.async ring of 64-row tiles filled 16 bytes a thread, the q
// tiles with the most keys first, tiles outside the band skipped, masks
// only where the band or the ragged edge cuts), with fp32 tiles unpadded
// in shared memory and swizzled, the 16-byte chunk c of row r at chunk
// c ^ sw(r), so that both fragment reads hit 32 banks: a float2 along a row
// (every A operand, and B stored [n][k]: K in Q K^T, V in dO V^T, Q and dO
// in K Q^T and V dO^T) and a float down a column (B stored [k][n]: V in
// P V, K in dS K, dO and Q in P^T dO and dS^T Q). The k-steps pair the
// physical columns 2t, 2t + 1 with the mma's k = t, t + 4, so the scores'
// accumulator layout is the A layout of the next product, and P and dS go
// from registers to the tensor cores without shuffles or shared memory.
// Above hd 64 the forward streams 32-key tiles in one stage (80 KB at hd
// 160: two blocks an SM, where 64-key tiles in two stages, 200 KB, leave
// one block of four warps, bound by latency). The backward takes its
// scores 32 keys (dQ) or 32 queries (dK/dV) at a time, so that they fit
// beside the accumulators, streams in one stage at hd 160 (two stages of
// six tiles would be 240 KB), and above hd 64 gives each 16 key rows of
// dK/dV two warps, each every other 8-column tile of dK and dV.
//
// Both: causal and window limits skip whole tiles outside the mask. The
// dK/dV kernel sums the G query heads of its group and every q tile in a
// fixed order, and every output element has one writer: no float atomics,
// the results do not change from run to run.
//
// Build without --use_fast_math (expf, exp2f, logf and IEEE division as
// written).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

// Sq != Sk only for cross-attention, which has neither causality nor a window
__device__ __forceinline__ bool visible(int qpos, int kpos, int Sq, int Sk, int causal,
                                        int window) {
  return qpos < Sq && kpos < Sk && (!causal || qpos >= kpos) && (!window || qpos - kpos < window);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (see the note at the top). Each thread holds two
// rows of its warp's 16 (g and g + 8, g = lane / 4) and, of every 8-column
// accumulator tile, columns 2t and 2t + 1 (t = lane % 4).
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kB = 64;                 // rows per tile, queries or keys
constexpr int kThreads = 128;          // 4 warps x 16 rows
constexpr float kLog2e = 1.4426950408889634f;
// bf16 per shared row: 16 bytes of padding, so that the 8 rows an ldmatrix
// reads start in 8 different 16-byte bank groups (no bank conflicts)
template <int HD> __host__ __device__ constexpr int ld() { return HD + 8; }
template <int HD> __host__ __device__ constexpr int tile_bytes() { return kB * ld<HD>() * 2; }
template <int HD> constexpr int fwd_smem() { return 5 * tile_bytes<HD>(); }  // Q, 2 x (K, V)
template <int HD> constexpr int dq_smem() { return 6 * tile_bytes<HD>(); }   // Q, dO, 2 x (K, V)
template <int HD> constexpr int dkdv_smem() {   // K, V, 2 x (Q, dO, lse, D)
  return 6 * tile_bytes<HD>() + 4 * kB * 4;
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared: `bytes` of them copied, the rest zero-filled
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr(dst)), "l"(src),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr(dst)), "l"(src),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(saddr(p)) : "memory");
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(saddr(p)) : "memory");
}
// c (16 x 8, fp32) += a (16 x 16) b (16 x 8)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two floats as a bf16 pair, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragment addresses in a row-major tile of LD bf16 per row, for one lane.
// A (16 x 16) at rows r0.., columns c0..: registers a0..a3 of the mma.
template <int LD>
__device__ __forceinline__ const bf16* frag_a(const bf16* s, int r0, int c0, int lane) {
  return s + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8;
}
// B of two n8 tiles from a tile stored [n][k] (rows n0..n0+15, columns
// c0..c0+15 the depth): {b0, b1} of tile n0, then of tile n0 + 8
template <int LD>
__device__ __forceinline__ const bf16* frag_b(const bf16* s, int n0, int c0, int lane) {
  return s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + c0 + ((lane >> 3) & 1) * 8;
}
// B of two n8 tiles from a tile stored [k][n] (rows k0..k0+15 the depth,
// columns n0..n0+15), read with ldmatrix .trans
template <int LD>
__device__ __forceinline__ const bf16* frag_bt(const bf16* s, int k0, int n0, int lane) {
  return s + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LD + n0 + (lane >> 4) * 8;
}

// Rows [r0, r0 + 64) of one head into a 64 x LD tile, zero beyond S and hd.
// vec: hd % 8 == 0 and 16-byte aligned tensors, so cp.async 16 bytes at a
// time; otherwise element by element (synchronous; visible at the next
// __syncthreads, as the copies are).
template <int HD, int NTHREADS = kThreads>
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* __restrict__ base,
                                          long long stride, int r0, int S, int hd, bool vec) {
  constexpr int CPR = HD / 8;          // 16-byte chunks per row
  for (int i = threadIdx.x; i < kB * CPR; i += NTHREADS) {
    const int r = i / CPR, d = (i % CPR) * 8, s = r0 + r;
    bf16* dst = sm + r * ld<HD>() + d;
    if (vec) {
      const bool in = s < S && d < hd;
      cp16(dst, in ? base + s * stride + d : base, in ? 16 : 0);
    } else {
      __align__(16) bf16 e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = (s < S && d + j < hd) ? base[s * stride + d + j] : __float2bfloat16_rn(0.f);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(e);
    }
  }
}

// A 64 x LD tile to rows [r0, r0 + 64) of one head, rows < S and d < hd only.
template <int HD, int NTHREADS = kThreads>
__device__ __forceinline__ void store_tile(bf16* __restrict__ base, long long stride, int r0,
                                           int S, int hd, const bf16* sm, bool vec) {
  constexpr int CPR = HD / 8;
  for (int i = threadIdx.x; i < kB * CPR; i += NTHREADS) {
    const int r = i / CPR, d = (i % CPR) * 8, s = r0 + r;
    if (s >= S || d >= hd) continue;
    const bf16* src = sm + r * ld<HD>() + d;
    if (vec) {
      *reinterpret_cast<uint4*>(base + s * stride + d) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < 8 && d + j < hd; ++j) base[s * stride + d + j] = src[j];
    }
  }
}

// A warp's 16 x 8NT accumulator, times f, as bf16 into rows r0.. and
// columns c0.. of a tile.
template <int HD, int NT>
__device__ __forceinline__ void acc_to_tile(bf16* sm, const float (&acc)[NT][4], float f,
                                            int r0, int c0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    bf16* p = sm + (r0 + g) * ld<HD>() + c0 + nt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(p) = pack(acc[nt][0] * f, acc[nt][1] * f);
    *reinterpret_cast<uint32_t*>(p + 8 * ld<HD>()) = pack(acc[nt][2] * f, acc[nt][3] * f);
  }
}

// does the mask cut the (q0, k0) tile pair (or its ragged edges)?
__device__ __forceinline__ bool cut(int q0, int k0, int Sq, int Sk, int causal, int window) {
  return q0 + kB > Sq || k0 + kB > Sk || (causal && k0 + kB - 1 > q0) ||
         (window && q0 + kB - 1 - k0 >= window);
}

// The A fragment (16 x 16 over columns 16kk..16kk+15) of a warp's 16 x 64
// fp32 accumulator, as bf16: the accumulator layout of two adjacent n8
// tiles is the A layout of one k16 step.
__device__ __forceinline__ void frag_of(uint32_t (&a)[4], const float (&x)[8][4], int kk) {
  a[0] = pack(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}
// the same split in two: hi = bf16(x), lo = bf16(x - hi), so hi + lo
// carries ~16 bits of x's mantissa through the bf16 products
__device__ __forceinline__ void frag_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                           const float (&x)[8][4], int kk) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* v = x[2 * kk + (i >> 1)] + 2 * (i & 1);
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[0], v[1]);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack(v[0] - __low2float(h), v[1] - __high2float(h));
  }
}

// ---------------------------------------------------------------------------
// forward: one block per (q tile, head), the q tiles with the most keys first
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_mma_fwd(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int N, int S, int Sk, int H, int KV, int hd,
    int causal, int window, float scale, int vec) {
  constexpr int LD = ld<HD>(), NT = HD / 8, KS = HD / 16, T = kB * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + T;               // two stages
  bf16* sV = sK + 2 * T;           // two stages
  const int heads = N * H, nqt = (S + kB - 1) / kB;
  const int q0 = (nqt - 1 - static_cast<int>(blockIdx.x) / heads) * kB;
  const int n = (blockIdx.x % heads) / H, h = blockIdx.x % H, kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const long long qstride = static_cast<long long>(H) * hd;
  const long long kstride = static_cast<long long>(KV) * hd;
  const bf16* qb = q + (static_cast<long long>(n) * S * H + h) * hd;
  const bf16* kb = k + (static_cast<long long>(n) * Sk * KV + kvh) * hd;
  const bf16* vb = v + (static_cast<long long>(n) * Sk * KV + kvh) * hd;

  const int k_end = causal ? min(Sk, q0 + kB) : Sk;
  const int kt0 = (window ? max(0, q0 - window + 1) : 0) / kB;
  const int nk = (k_end + kB - 1) / kB - kt0;
  load_tile<HD>(sQ, qb, qstride, q0, S, hd, vec);
  load_tile<HD>(sK, kb, kstride, kt0 * kB, Sk, hd, vec);
  load_tile<HD>(sV, vb, kstride, kt0 * kB, Sk, hd, vec);
  cp_commit();

  uint32_t qf[KS][4];
  float acc[NT][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int row0 = q0 + warp * 16 + g;       // this thread's rows: row0, row0 + 8
  const float sl2 = scale * kLog2e;

  for (int it = 0; it < nk; ++it) {
    const int k0 = (kt0 + it) * kB;
    const bf16* cK = sK + (it & 1) * T;
    const bf16* cV = sV + (it & 1) * T;
    if (it + 1 < nk) {          // the next tile flies while this one is computed
      load_tile<HD>(sK + ((it + 1) & 1) * T, kb, kstride, k0 + kB, Sk, hd, vec);
      load_tile<HD>(sV + ((it + 1) & 1) * T, vb, kstride, k0 + kB, Sk, hd, vec);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) ldsm(qf[kk], frag_a<LD>(sQ, warp * 16, kk * 16, lane));
    }

    // S = Q K^T: 16 rows x 64 keys a warp
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t b[4];
        ldsm(b, frag_b<LD>(cK, j * 16, kk * 16, lane));
        mma(s[2 * j], qf[kk], b[0], b[1]);
        mma(s[2 * j + 1], qf[kk], b[2], b[3]);
      }

    // online softmax over the tile, statistics in registers: m is the raw
    // row max, p = 2^(s sl2 - m sl2) with sl2 = scale log2(e), one FFMA and
    // one EX2 an element
    const bool masked = cut(q0, k0, S, Sk, causal, window);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][2 * r + e];
          if (masked && !visible(row0 + 8 * r, k0 + nt * 8 + 2 * t + e, S, Sk, causal, window))
            x = -INFINITY;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // nothing visible in this row so far: every p and alpha is 2^-inf = 0
      const float mb = mx == -INFINITY ? 0.f : mx * sl2;
      const float alpha = exp2f(m[r] * sl2 - mb);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][2 * r + e];
          x = exp2f(fmaf(x, sl2, -mb));
          sum += x;
        }
      l[r] = alpha * l[r] + sum;     // this thread's share; the quad's sum at the end
      m[r] = mx;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        acc[i][2 * r] *= alpha;
        acc[i][2 * r + 1] *= alpha;
      }
    }

    // O += bf16(P) V, P straight from the registers
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      frag_of(a, s, kk);
#pragma unroll
      for (int dj = 0; dj < KS; ++dj) {
        uint32_t b[4];
        ldsm_t(b, frag_bt<LD>(cV, kk * 16, dj * 16, lane));
        mma(acc[2 * dj], a, b[0], b[1]);
        mma(acc[2 * dj + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();             // this stage is read; the next copy may land in it
  }

  float lc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    lc[r] = fmaxf(l[r], 1e-30f);
    const int row = row0 + 8 * r;
    if (t == 0 && row < S)
      lse[(static_cast<long long>(n) * H + h) * S + row] = m[r] * scale + logf(lc[r]);
  }
  // O = acc / l (IEEE division, as the plain version), through sQ
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    acc[i][0] /= lc[0];
    acc[i][1] /= lc[0];
    acc[i][2] /= lc[1];
    acc[i][3] /= lc[1];
  }
  acc_to_tile<HD>(sQ, acc, 1.f, warp * 16, 0, lane);
  __syncthreads();
  store_tile<HD>(o + (static_cast<long long>(n) * S * H + h) * hd, qstride, q0, S, hd, sQ, vec);
}

// ---------------------------------------------------------------------------
// backward, dQ (and D): one block per (q tile, head), longest first
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_mma_bwd_dq(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ dbuf, bf16* __restrict__ dq, int N, int S, int H, int KV, int hd,
    int causal, int window, float scale, int vec) {
  constexpr int LD = ld<HD>(), NT = HD / 8, KS = HD / 16, T = kB * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + T;
  bf16* sK = sdO + T;              // two stages
  bf16* sV = sK + 2 * T;           // two stages
  const int heads = N * H, nqt = (S + kB - 1) / kB;
  const int q0 = (nqt - 1 - static_cast<int>(blockIdx.x) / heads) * kB;
  const int n = (blockIdx.x % heads) / H, h = blockIdx.x % H, kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const long long qstride = static_cast<long long>(H) * hd;
  const long long kstride = static_cast<long long>(KV) * hd;
  const long long qoff = (static_cast<long long>(n) * S * H + h) * hd;
  const long long soff = (static_cast<long long>(n) * H + h) * S;
  const bf16* kb = k + (static_cast<long long>(n) * S * KV + kvh) * hd;
  const bf16* vb = v + (static_cast<long long>(n) * S * KV + kvh) * hd;

  const int k_end = causal ? min(S, q0 + kB) : S;
  const int kt0 = (window ? max(0, q0 - window + 1) : 0) / kB;
  const int nk = (k_end + kB - 1) / kB - kt0;
  load_tile<HD>(sQ, q + qoff, qstride, q0, S, hd, vec);
  load_tile<HD>(sdO, dout + qoff, qstride, q0, S, hd, vec);
  load_tile<HD>(sK, kb, kstride, kt0 * kB, S, hd, vec);
  load_tile<HD>(sV, vb, kstride, kt0 * kB, S, hd, vec);
  cp_commit();

  // D_i = sum_d dO_id O_id of the warp's 16 rows, two lanes a row (lane
  // 2i + j: row i, half j of d), while the copies fly; then each thread
  // takes D and lse of its own two rows, row0 and row0 + 8
  const int row0 = q0 + warp * 16 + g;
  float Drow[2], lrow[2];
  {
    const int row = q0 + warp * 16 + lane / 2, d0 = (lane & 1) * (HD / 2);
    float part = 0.f;
    if (row < S) {
      const bf16* gp = dout + qoff + row * qstride;
      const bf16* op = o + qoff + row * qstride;
      if (vec) {
        for (int d = d0; d < d0 + HD / 2 && d < hd; d += 8) {
          const uint4 a = *reinterpret_cast<const uint4*>(gp + d);
          const uint4 b = *reinterpret_cast<const uint4*>(op + d);
          const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
          const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            part = fmaf(__low2float(a2[j]), __low2float(b2[j]), part);
            part = fmaf(__high2float(a2[j]), __high2float(b2[j]), part);
          }
        }
      } else {
        for (int d = d0; d < d0 + HD / 2 && d < hd; ++d)
          part = fmaf(__bfloat162float(gp[d]), __bfloat162float(op[d]), part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if ((lane & 1) == 0 && row < S) dbuf[soff + row] = part;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      Drow[r] = __shfl_sync(0xffffffffu, part, 2 * (g + 8 * r));
      lrow[r] = row0 + 8 * r < S ? lse[soff + row0 + 8 * r] * kLog2e : 0.f;
    }
  }

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const float sl2 = scale * kLog2e;      // P = 2^(s sl2 - lse log2(e))

  for (int it = 0; it < nk; ++it) {
    const int k0 = (kt0 + it) * kB;
    const bf16* cK = sK + (it & 1) * T;
    const bf16* cV = sV + (it & 1) * T;
    if (it + 1 < nk) {
      load_tile<HD>(sK + ((it + 1) & 1) * T, kb, kstride, k0 + kB, S, hd, vec);
      load_tile<HD>(sV + ((it + 1) & 1) * T, vb, kstride, k0 + kB, S, hd, vec);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T
    float s[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4], c[4];
      ldsm(a, frag_a<LD>(sQ, warp * 16, kk * 16, lane));
      ldsm(c, frag_a<LD>(sdO, warp * 16, kk * 16, lane));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t b[4];
        ldsm(b, frag_b<LD>(cK, j * 16, kk * 16, lane));
        mma(s[2 * j], a, b[0], b[1]);
        mma(s[2 * j + 1], a, b[2], b[3]);
        ldsm(b, frag_b<LD>(cV, j * 16, kk * 16, lane));
        mma(dp[2 * j], c, b[0], b[1]);
        mma(dp[2 * j + 1], c, b[2], b[3]);
      }
    }
    // dS = P (dP - D), P = exp(s scale - lse), in fp32 (into s)
    const bool masked = cut(q0, k0, S, S, causal, window);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const bool ok =
            !masked || visible(row0 + 8 * r, k0 + nt * 8 + 2 * t + (i & 1), S, S, causal, window);
        const float p = ok ? exp2f(fmaf(s[nt][i], sl2, -lrow[r])) : 0.f;
        s[nt][i] = p * (dp[nt][i] - Drow[r]);
      }
    // dQ += dS K, dS as bf16 hi + lo
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t hi[4], lo[4];
      frag_split(hi, lo, s, kk);
#pragma unroll
      for (int dj = 0; dj < KS; ++dj) {
        uint32_t b[4];
        ldsm_t(b, frag_bt<LD>(cK, kk * 16, dj * 16, lane));
        mma(acc[2 * dj], hi, b[0], b[1]);
        mma(acc[2 * dj + 1], hi, b[2], b[3]);
        mma(acc[2 * dj], lo, b[0], b[1]);
        mma(acc[2 * dj + 1], lo, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  acc_to_tile<HD>(sQ, acc, scale, warp * 16, 0, lane);
  __syncthreads();
  store_tile<HD>(dq + qoff, qstride, q0, S, hd, sQ, vec);
}

// ---------------------------------------------------------------------------
// backward, dK and dV: one block per (k tile, KV head), after flash_mma_bwd_dq
// (D). It walks the G query heads of its group and their q tiles in a fixed
// order, (Q, dO, lse, D) of the next one in flight. SPLIT warps own each 16
// key rows, each the dK and dV columns of its part of the head dim: 1 up to
// hd 128; 2 above, where one warp's dK and dV accumulators alone would be
// 160 fp32 registers a thread at hd 160, beside the 64 of the S^T and dP^T
// tiles (flash_mma_bwd_dkdv<128, 1> already holds 255 and spills). Each
// warp of a pair computes S^T and dP^T over the whole head dim (a pair
// computes both twice), and accumulates 80 columns of dK and of dV.
// ---------------------------------------------------------------------------
template <int HD, int SPLIT>
__global__ void __launch_bounds__(kThreads * SPLIT) flash_mma_bwd_dkdv(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dbuf,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int S, int H, int KV, int hd,
    int causal, int window, float scale, int vec) {
  constexpr int LD = ld<HD>(), KS = HD / 16, T = kB * LD, NTHREADS = kThreads * SPLIT;
  constexpr int COLS = HD / SPLIT, NT = COLS / 8, KC = COLS / 16;   // a warp's columns
  static_assert(COLS % 16 == 0, "a warp's columns are whole k16 steps");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + T;
  bf16* sQ = sV + T;               // two stages
  bf16* sdO = sQ + 2 * T;          // two stages
  float* sL = reinterpret_cast<float*>(sdO + 2 * T);   // two stages of kB
  float* sD = sL + 2 * kB;                             // two stages of kB
  const int heads = N * KV;
  const int k0 = static_cast<int>(blockIdx.x) / heads * kB;   // the most queries first
  const int n = (blockIdx.x % heads) / KV, kvh = blockIdx.x % KV, G = H / KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  // this warp's key rows and head-dim columns
  const int rows = (SPLIT == 1 ? warp : warp % 4) * 16, c0 = SPLIT == 1 ? 0 : warp / 4 * COLS;
  const long long qstride = static_cast<long long>(H) * hd;
  const long long kstride = static_cast<long long>(KV) * hd;
  const long long koff = (static_cast<long long>(n) * S * KV + kvh) * hd;

  // queries that can see a key of this tile
  const int qt0 = (causal ? k0 : 0) / kB;
  const int q_end = window ? min(S, k0 + kB - 1 + window) : S;
  const int nq = (q_end + kB - 1) / kB - qt0, steps = G * nq;
  auto issue = [&](int step, int stage) {      // (Q, dO, lse, D) of step into stage
    const int h = kvh * G + step / nq, q0 = (qt0 + step % nq) * kB;
    const long long qoff = (static_cast<long long>(n) * S * H + h) * hd;
    const long long soff = (static_cast<long long>(n) * H + h) * S;
    load_tile<HD, NTHREADS>(sQ + stage * T, q + qoff, qstride, q0, S, hd, vec);
    load_tile<HD, NTHREADS>(sdO + stage * T, dout + qoff, qstride, q0, S, hd, vec);
    if (SPLIT == 1 || threadIdx.x < 2 * kB) {
      const int r = threadIdx.x % kB, row = q0 + r;
      const float* src = (threadIdx.x < kB ? lse : dbuf) + soff;
      float* dst = (threadIdx.x < kB ? sL : sD) + stage * kB + r;
      cp4(dst, row < S ? src + row : src, row < S ? 4 : 0);
    }
  };
  load_tile<HD, NTHREADS>(sK, k + koff, kstride, k0, S, hd, vec);
  load_tile<HD, NTHREADS>(sV, v + koff, kstride, k0, S, hd, vec);
  issue(0, 0);
  cp_commit();

  float gk[NT][4], gv[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
    gk[i][0] = gk[i][1] = gk[i][2] = gk[i][3] = gv[i][0] = gv[i][1] = gv[i][2] = gv[i][3] = 0.f;
  const int key0 = k0 + rows + g;            // this thread's keys: key0, key0 + 8
  const float sl2 = scale * kLog2e;           // P = 2^(s sl2 - lse log2(e))

  for (int it = 0; it < steps; ++it) {
    const int q0 = (qt0 + it % nq) * kB, st = it & 1;
    const bf16* cQ = sQ + st * T;
    const bf16* cdO = sdO + st * T;
    const float* cL = sL + st * kB;
    const float* cD = sD + st * kB;
    if (it + 1 < steps) {
      issue(it + 1, st ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 64 queries a warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4], c[4];
      ldsm(a, frag_a<LD>(sK, rows, kk * 16, lane));
      ldsm(c, frag_a<LD>(sV, rows, kk * 16, lane));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t b[4];
        ldsm(b, frag_b<LD>(cQ, j * 16, kk * 16, lane));
        mma(s[2 * j], a, b[0], b[1]);
        mma(s[2 * j + 1], a, b[2], b[3]);
        ldsm(b, frag_b<LD>(cdO, j * 16, kk * 16, lane));
        mma(dp[2 * j], c, b[0], b[1]);
        mma(dp[2 * j + 1], c, b[2], b[3]);
      }
    }
    // P^T (into s) and dS^T = P^T (dP^T - D) (into dp), fp32
    const bool masked = cut(q0, k0, S, S, causal, window);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = nt * 8 + 2 * t + (i & 1);
        const bool ok = !masked || visible(q0 + qi, key0 + 8 * (i >> 1), S, S, causal, window);
        const float p = ok ? exp2f(fmaf(s[nt][i], sl2, -cL[qi] * kLog2e)) : 0.f;
        s[nt][i] = p;
        dp[nt][i] = p * (dp[nt][i] - cD[qi]);
      }
    // this warp's columns: dV += bf16(P^T) dO; dK += dS^T Q, dS^T as bf16 hi + lo
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4], hi[4], lo[4];
      frag_of(a, s, kk);
      frag_split(hi, lo, dp, kk);
#pragma unroll
      for (int dj = 0; dj < KC; ++dj) {
        uint32_t b[4];
        ldsm_t(b, frag_bt<LD>(cdO, kk * 16, c0 + dj * 16, lane));
        mma(gv[2 * dj], a, b[0], b[1]);
        mma(gv[2 * dj + 1], a, b[2], b[3]);
        ldsm_t(b, frag_bt<LD>(cQ, kk * 16, c0 + dj * 16, lane));
        mma(gk[2 * dj], hi, b[0], b[1]);
        mma(gk[2 * dj + 1], hi, b[2], b[3]);
        mma(gk[2 * dj], lo, b[0], b[1]);
        mma(gk[2 * dj + 1], lo, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  acc_to_tile<HD>(sK, gk, scale, rows, c0, lane);
  acc_to_tile<HD>(sV, gv, 1.f, rows, c0, lane);
  __syncthreads();
  store_tile<HD, NTHREADS>(dk + koff, kstride, k0, S, hd, sK, vec);
  store_tile<HD, NTHREADS>(dv + koff, kstride, k0, S, hd, sV, vec);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// fp32 on the tensor cores in split TF32 (see the note at the top). The
// fragments are mma.sync m16n8k8's: a thread holds rows g and g + 8 of its
// warp's 16 (g = lane / 4) and, of every 8-column accumulator tile, columns
// 2t and 2t + 1 (t = lane % 4).
// ---------------------------------------------------------------------------
namespace tf {

using tc::cp16;
using tc::cp4;
using tc::cp_commit;
using tc::cp_wait;
constexpr int kB = 64;                 // rows per tile, queries or keys
constexpr int kThreads = 128;          // 4 warps x 16 rows
constexpr int kSmemMax = 232448;       // the dynamic shared memory a block may hold
constexpr float kLog2e = 1.4426950408889634f;

// A tile is rows of HD fp32 (HD a multiple of 32), unpadded; the 16-byte
// chunk c of row r lies at chunk c ^ sw(r), sw(r) in {0, 2, 4, 6} from r mod
// 8, so that a warp's fragment reads hit 32 banks both along the rows and
// across them. The kernels' launch bounds name one block an SM: without a
// minimum, ptxas trims registers toward the next block count and spills.
__host__ __device__ constexpr int sw(int r) { return ((r & 3) ^ ((r >> 2) & 1)) << 1; }
template <int HD> __host__ __device__ constexpr int tile_bytes() { return kB * HD * 4; }
// the forward's streamed K and V tiles: their rows and stages. Up to hd 64,
// 64 rows in two stages (80 KB at hd 64: two blocks an SM); above, 32 rows
// in one stage (80 KB at hd 160: two blocks an SM, where 64 rows in two
// stages, 200 KB, leave one block of four warps, latency-bound)
template <int HD> __host__ __device__ constexpr int fwd_keys() { return HD > 64 ? 32 : 64; }
template <int HD> __host__ __device__ constexpr int fwd_stages() { return HD > 64 ? 1 : 2; }
template <int HD> constexpr int fwd_smem() {   // Q, stages x (K, V)
  return (kB + 2 * fwd_stages<HD>() * fwd_keys<HD>()) * HD * 4;
}
// the backward's streamed tiles in two stages where they fit, else in one
// (hd 160)
template <int HD> __host__ __device__ constexpr int dq_stages() {
  return 6 * tile_bytes<HD>() <= kSmemMax ? 2 : 1;
}
template <int HD> constexpr int dq_smem() {   // Q, dO, stages x (K, V)
  return (2 + 2 * dq_stages<HD>()) * tile_bytes<HD>();
}
template <int HD> __host__ __device__ constexpr int dkdv_stages() {
  return 6 * tile_bytes<HD>() + 4 * kB * 4 <= kSmemMax ? 2 : 1;
}
template <int HD> constexpr int dkdv_smem() {   // K, V, stages x (Q, dO, lse, D)
  return (2 + 2 * dkdv_stages<HD>()) * tile_bytes<HD>() + 2 * dkdv_stages<HD>() * kB * 4;
}
// warps on each 16 key rows of dK/dV: above hd 64 one warp's dK and dV
// accumulators with S^T's and dP^T's would not fit its registers
template <int HD> constexpr int dkdv_split() { return HD > 64 ? 2 : 1; }

// x = big + small, both TF32, each rounded as cvt.rna.tf32.f32 rounds: K5's
// split (csrc/mlstm_chunk.cu), the integer add and mask that cvt.rna
// compiles to, without its guard for inf and NaN
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  const float rest = x - __uint_as_float(big);
  small = (__float_as_uint(rest) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment split: a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4), a3
// (g + 8, t + 4), each as its big and small halves
struct FragA {
  uint32_t big[4], small[4];
};
__device__ __forceinline__ void split_a(FragA& f, float a0, float a1, float a2, float a3) {
  split(a0, f.big[0], f.small[0]);
  split(a1, f.big[1], f.small[1]);
  split(a2, f.big[2], f.small[2]);
  split(a3, f.big[3], f.small[3]);
}
// c += a b over one k-step of 8, b = (b0 at k t, b1 at k t + 4) of column g:
// small.big + big.small + big.big, summed into c by the tensor cores
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split(b0, bb0, bs0);
  split(b1, bb1, bs1);
  mma(c, a.small, bb0, bb1);
  mma(c, a.big, bs0, bs1);
  mma(c, a.big, bb0, bb1);
}

// This lane's word offsets in a tile, for each 8-column step j of a
// 32-column group. The k-steps pair the physical columns 2t and 2t + 1 with
// the mma's k = t and t + 4 (any order of k within a step gives the same
// sum, if both operands take it):
//   pair[j]: (row g, column 8j + 2t), the first of a float2 along a row: A
//     of every product, B stored [n][k] (K in Q K^T, V in dO V^T, Q and dO
//     in the transposed products of dK/dV);
//   col[e][a]: (row 2t + e, column 8(SPLIT a + h) + g): B stored [k][n] (V
//     in P V, K in dS K, dO and Q in P^T dO and dS^T Q), for the warp's
//     column tiles SPLIT i + h (h its half of the head dim).
template <int HD, int SPLIT>
struct Lane {
  int pair[4], col[2][4 / SPLIT];
  __device__ __forceinline__ Lane(int g, int t, int h) {
#pragma unroll
    for (int j = 0; j < 4; ++j) pair[j] = g * HD + (((2 * j) ^ sw(g)) | (t >> 1)) * 4 + 2 * (t & 1);
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int a = 0; a < 4 / SPLIT; ++a)
        col[e][a] = (2 * t + e) * HD +
                    (((2 * (SPLIT * a + h)) ^ sw(2 * t + e)) | (g >> 2)) * 4 + (g & 3);
  }
  // the pair (r0 + g, kk + 2t), (r0 + g, kk + 2t + 1), kk = k32 + 8j; r0 a
  // multiple of 8, k32 of 32
  __device__ __forceinline__ float2 ld_pair(const float* s, int r0, int k32, int j) const {
    return *reinterpret_cast<const float2*>(s + r0 * HD + k32 + pair[j]);
  }
  // (kk + 2t + e, 8 (SPLIT i + h) + g); kk a multiple of 8
  __device__ __forceinline__ float ld_col(const float* s, int kk, int i, int e) const {
    constexpr int A = 4 / SPLIT;
    return s[kk * HD + 32 * (i / A) + col[e][i % A]];
  }
};

// Rows [r0, r0 + ROWS) of one head into a tile, zero beyond S and hd. vec:
// hd % 4 == 0 and 16-byte aligned tensors, so cp.async 16 bytes at a time;
// otherwise 4 bytes at a time.
template <int HD, int NTHREADS = kThreads, int ROWS = kB>
__device__ __forceinline__ void load_tile(float* sm, const float* __restrict__ base,
                                          long long stride, int r0, int S, int hd, bool vec) {
  constexpr int CPR = HD / 4;          // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CPR; i += NTHREADS) {
    const int r = i / CPR, c = i % CPR, d = c * 4, s = r0 + r;
    float* dst = sm + r * HD + ((c ^ sw(r)) << 2);
    const float* src = base + s * stride + d;
    if (vec) {
      const bool in = s < S && d < hd;
      cp16(dst, in ? src : base, in ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = s < S && d + j < hd;
        cp4(dst + j, in ? src + j : base, in ? 4 : 0);
      }
    }
  }
}

// does the mask cut the pair of a 64-row q tile at q0 and a KR-row k tile at
// k0 (or their ragged edges)?
__device__ __forceinline__ bool cut(int q0, int k0, int Sq, int Sk, int causal, int window,
                                    int KR = kB) {
  return q0 + kB > Sq || k0 + KR > Sk || (causal && k0 + KR - 1 > q0) ||
         (window && q0 + kB - 1 - k0 >= window);
}

// A warp's 16 x 8NT accumulator, times f, to rows r0.. of one head (rows
// < S, columns < hd), its column tile i at 8 (SPLIT i + h)
template <int NT, int SPLIT>
__device__ __forceinline__ void store_acc(float* __restrict__ base, long long stride, int r0,
                                          int S, int hd, const float (&acc)[NT][4], float f,
                                          int h, int lane, bool vec) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= S) continue;
    float* p = base + row * stride;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int d = 8 * (SPLIT * i + h) + 2 * t;
      const float x0 = acc[i][2 * r] * f, x1 = acc[i][2 * r + 1] * f;
      if (vec) {
        if (d < hd) *reinterpret_cast<float2*>(p + d) = make_float2(x0, x1);
      } else {
        if (d < hd) p[d] = x0;
        if (d + 1 < hd) p[d + 1] = x1;
      }
    }
  }
}

// The A fragments of k-steps k0..k0 + 3 of P V (or dS K, P^T dO, dS^T Q)
// from the warp's 16 x 8M accumulator x: with columns 2t, 2t + 1 as k = t,
// t + 4, the accumulator layout of n8 tile kk is the A layout, no shuffle
// needed
template <int M>
__device__ __forceinline__ void frags_of(FragA (&a)[4], const float (&x)[M][4], int k0) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    split_a(a[kk], x[k0 + kk][0], x[k0 + kk][2], x[k0 + kk][1], x[k0 + kk][3]);
}

// acc += a b over 32 rows of a tile, b's rows r0..r0 + 31 (r0 a multiple of
// 8) stored [k][n], the warp's column tiles of it: the four k-steps summed
// by the tensor cores in a fresh fragment, added to acc with one fp32
// rounding, so that the long sums (over keys, or queries and heads) round
// to nearest once every 32 terms
template <int HD, int SPLIT, int NT>
__device__ __forceinline__ void mma_rows32(float (&acc)[NT][4], const FragA (&a)[4],
                                           const float* b, int r0, const Lane<HD, SPLIT>& ln) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma3(d, a[kk], ln.ld_col(b, r0 + kk * 8, i, 0), ln.ld_col(b, r0 + kk * 8, i, 1));
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] += d[e];
  }
}

// ---------------------------------------------------------------------------
// forward: one block per (q tile, head), the q tiles with the most keys first
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_tf32_fwd(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int N, int S, int Sk, int H, int KV, int hd,
    int causal, int window, float scale, int vec) {
  constexpr int NT = HD / 8, KR = fwd_keys<HD>(), ST = fwd_stages<HD>(), KT = KR * HD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + kB * HD;        // ST stages of KR rows
  float* sV = sK + ST * KT;        // ST stages of KR rows
  const int heads = N * H, nqt = (S + kB - 1) / kB;
  const int q0 = (nqt - 1 - static_cast<int>(blockIdx.x) / heads) * kB;
  const int n = (blockIdx.x % heads) / H, h = blockIdx.x % H, kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const long long qstride = static_cast<long long>(H) * hd;
  const long long kstride = static_cast<long long>(KV) * hd;
  const float* qb = q + (static_cast<long long>(n) * S * H + h) * hd;
  const float* kb = k + (static_cast<long long>(n) * Sk * KV + kvh) * hd;
  const float* vb = v + (static_cast<long long>(n) * Sk * KV + kvh) * hd;

  const int k_end = causal ? min(Sk, q0 + kB) : Sk;
  const int kt0 = (window ? max(0, q0 - window + 1) : 0) / KR;
  const int nk = (k_end + KR - 1) / KR - kt0;
  load_tile<HD>(sQ, qb, qstride, q0, S, hd, vec);
  load_tile<HD, kThreads, KR>(sK, kb, kstride, kt0 * KR, Sk, hd, vec);
  load_tile<HD, kThreads, KR>(sV, vb, kstride, kt0 * KR, Sk, hd, vec);
  cp_commit();

  const Lane<HD, 1> ln(g, t, 0);
  const float* wQ = sQ + warp * 16 * HD;
  float acc[NT][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int row0 = q0 + warp * 16 + g;       // this thread's rows: row0, row0 + 8
  const float sl2 = scale * kLog2e;

  for (int it = 0; it < nk; ++it) {
    const int k0 = (kt0 + it) * KR, st = ST == 2 ? it & 1 : 0;
    const float* cK = sK + st * KT;
    const float* cV = sV + st * KT;
    if (ST == 2 && it + 1 < nk) {   // the next tile flies while this one is computed
      load_tile<HD, kThreads, KR>(sK + (st ^ 1) * KT, kb, kstride, k0 + KR, Sk, hd, vec);
      load_tile<HD, kThreads, KR>(sV + (st ^ 1) * KT, vb, kstride, k0 + KR, Sk, hd, vec);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    // S = Q K^T: 16 rows x KR keys a warp
    float s[KR / 8][4];
#pragma unroll
    for (int i = 0; i < KR / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int k32 = 0; k32 < HD; k32 += 32)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 x0 = ln.ld_pair(wQ, 0, k32, j), x1 = ln.ld_pair(wQ, 8, k32, j);
        FragA a;
        split_a(a, x0.x, x1.x, x0.y, x1.y);
#pragma unroll
        for (int nt = 0; nt < KR / 8; ++nt) {
          const float2 y = ln.ld_pair(cK, nt * 8, k32, j);
          mma3(s[nt], a, y.x, y.y);
        }
      }

    // online softmax over the tile, statistics in registers: m is the raw
    // row max, p = 2^(s sl2 - m sl2) with sl2 = scale log2(e), one FFMA and
    // one EX2 an element
    const bool masked = cut(q0, k0, S, Sk, causal, window, KR);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int nt = 0; nt < KR / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][2 * r + e];
          if (masked && !visible(row0 + 8 * r, k0 + nt * 8 + 2 * t + e, S, Sk, causal, window))
            x = -INFINITY;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // nothing visible in this row so far: every p and alpha is 2^-inf = 0
      const float mb = mx == -INFINITY ? 0.f : mx * sl2;
      const float alpha = exp2f(m[r] * sl2 - mb);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < KR / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][2 * r + e];
          x = exp2f(fmaf(x, sl2, -mb));
          sum += x;
        }
      l[r] = alpha * l[r] + sum;     // this thread's share; the quad's sum at the end
      m[r] = mx;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        acc[i][2 * r] *= alpha;
        acc[i][2 * r + 1] *= alpha;
      }
    }

    // O += P V, P straight from the registers, 32 keys at a time
#pragma unroll
    for (int kh = 0; kh < KR / 8; kh += 4) {
      FragA a[4];
      frags_of(a, s, kh);
      mma_rows32(acc, a, cV, kh * 8, ln);
    }
    __syncthreads();             // this stage is read; the next copy may land in it
    if (ST == 1 && it + 1 < nk) {
      load_tile<HD, kThreads, KR>(sK, kb, kstride, k0 + KR, Sk, hd, vec);
      load_tile<HD, kThreads, KR>(sV, vb, kstride, k0 + KR, Sk, hd, vec);
      cp_commit();
    }
  }

  float lc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    lc[r] = fmaxf(l[r], 1e-30f);
    const int row = row0 + 8 * r;
    if (t == 0 && row < S)
      lse[(static_cast<long long>(n) * H + h) * S + row] = m[r] * scale + logf(lc[r]);
  }
  // O = acc / l (IEEE division, as the plain version)
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    acc[i][0] /= lc[0];
    acc[i][1] /= lc[0];
    acc[i][2] /= lc[1];
    acc[i][3] /= lc[1];
  }
  store_acc<NT, 1>(o + (static_cast<long long>(n) * S * H + h) * hd, qstride, q0 + warp * 16, S,
                   hd, acc, 1.f, 0, lane, vec);
}

// ---------------------------------------------------------------------------
// backward, dQ (and D): one block per (q tile, head), longest first
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_tf32_bwd_dq(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ o, const float* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ dbuf, float* __restrict__ dq, int N, int S, int H, int KV, int hd,
    int causal, int window, float scale, int vec) {
  constexpr int NT = HD / 8, T = kB * HD, ST = dq_stages<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sdO = sQ + T;
  float* sK = sdO + T;             // ST stages
  float* sV = sK + ST * T;         // ST stages
  const int heads = N * H, nqt = (S + kB - 1) / kB;
  const int q0 = (nqt - 1 - static_cast<int>(blockIdx.x) / heads) * kB;
  const int n = (blockIdx.x % heads) / H, h = blockIdx.x % H, kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const long long qstride = static_cast<long long>(H) * hd;
  const long long kstride = static_cast<long long>(KV) * hd;
  const long long qoff = (static_cast<long long>(n) * S * H + h) * hd;
  const long long soff = (static_cast<long long>(n) * H + h) * S;
  const float* kb = k + (static_cast<long long>(n) * S * KV + kvh) * hd;
  const float* vb = v + (static_cast<long long>(n) * S * KV + kvh) * hd;

  const int k_end = causal ? min(S, q0 + kB) : S;
  const int kt0 = (window ? max(0, q0 - window + 1) : 0) / kB;
  const int nk = (k_end + kB - 1) / kB - kt0;
  load_tile<HD>(sQ, q + qoff, qstride, q0, S, hd, vec);
  load_tile<HD>(sdO, dout + qoff, qstride, q0, S, hd, vec);
  load_tile<HD>(sK, kb, kstride, kt0 * kB, S, hd, vec);
  load_tile<HD>(sV, vb, kstride, kt0 * kB, S, hd, vec);
  cp_commit();

  // D_i = sum_d dO_id O_id of the warp's 16 rows, two lanes a row (lane
  // 2i + j: row i, half j of d), while the copies fly; then each thread
  // takes D and lse of its own two rows, row0 and row0 + 8
  const int row0 = q0 + warp * 16 + g;
  float Drow[2], lrow[2];
  {
    const int row = q0 + warp * 16 + lane / 2, d0 = (lane & 1) * (HD / 2);
    float part = 0.f;
    if (row < S) {
      const float* gp = dout + qoff + row * qstride;
      const float* op = o + qoff + row * qstride;
      if (vec) {
        for (int d = d0; d < d0 + HD / 2 && d < hd; d += 4) {
          const float4 a = *reinterpret_cast<const float4*>(gp + d);
          const float4 b = *reinterpret_cast<const float4*>(op + d);
          part = fmaf(a.x, b.x, part);
          part = fmaf(a.y, b.y, part);
          part = fmaf(a.z, b.z, part);
          part = fmaf(a.w, b.w, part);
        }
      } else {
        for (int d = d0; d < d0 + HD / 2 && d < hd; ++d) part = fmaf(gp[d], op[d], part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if ((lane & 1) == 0 && row < S) dbuf[soff + row] = part;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      Drow[r] = __shfl_sync(0xffffffffu, part, 2 * (g + 8 * r));
      lrow[r] = row0 + 8 * r < S ? lse[soff + row0 + 8 * r] * kLog2e : 0.f;
    }
  }

  const Lane<HD, 1> ln(g, t, 0);
  const float* wQ = sQ + warp * 16 * HD;
  const float* wdO = sdO + warp * 16 * HD;
  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const float sl2 = scale * kLog2e;      // P = 2^(s sl2 - lse log2(e))

  for (int it = 0; it < nk; ++it) {
    const int k0 = (kt0 + it) * kB, st = ST == 2 ? it & 1 : 0;
    const float* cK = sK + st * T;
    const float* cV = sV + st * T;
    if (ST == 2 && it + 1 < nk) {
      load_tile<HD>(sK + (st ^ 1) * T, kb, kstride, k0 + kB, S, hd, vec);
      load_tile<HD>(sV + (st ^ 1) * T, vb, kstride, k0 + kB, S, hd, vec);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    // the tile's keys in two halves of 32, each: S = Q K^T and dP = dO V^T
    // (16 rows x 32 keys a warp), dS, then dQ += dS K; halves keep the
    // scores' registers beside dQ's accumulators at hd 160
    const bool masked = cut(q0, k0, S, S, causal, window);
#pragma unroll 1
    for (int kr = 0; kr < kB; kr += 32) {
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[i][0] = s[i][1] = s[i][2] = s[i][3] = dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
#pragma unroll 1
      for (int k32 = 0; k32 < HD; k32 += 32)   // not unrolled: fewer registers live
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          FragA a, c;
          {
            const float2 x0 = ln.ld_pair(wQ, 0, k32, j), x1 = ln.ld_pair(wQ, 8, k32, j);
            split_a(a, x0.x, x1.x, x0.y, x1.y);
            const float2 y0 = ln.ld_pair(wdO, 0, k32, j), y1 = ln.ld_pair(wdO, 8, k32, j);
            split_a(c, y0.x, y1.x, y0.y, y1.y);
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const float2 y = ln.ld_pair(cK, kr + nt * 8, k32, j);
            mma3(s[nt], a, y.x, y.y);
            const float2 z = ln.ld_pair(cV, kr + nt * 8, k32, j);
            mma3(dp[nt], c, z.x, z.y);
          }
        }
      // dS = P (dP - D), P = exp(s scale - lse), in fp32 (into s)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1, key = k0 + kr + nt * 8 + 2 * t + (i & 1);
          const bool ok = !masked || visible(row0 + 8 * r, key, S, S, causal, window);
          const float p = ok ? exp2f(fmaf(s[nt][i], sl2, -lrow[r])) : 0.f;
          s[nt][i] = p * (dp[nt][i] - Drow[r]);
        }
      // dQ += dS K
      FragA a[4];
      frags_of(a, s, 0);
      mma_rows32(acc, a, cK, kr, ln);
    }
    __syncthreads();
    if (ST == 1 && it + 1 < nk) {   // one stage: the next tile lands after this one is read
      load_tile<HD>(sK, kb, kstride, k0 + kB, S, hd, vec);
      load_tile<HD>(sV, vb, kstride, k0 + kB, S, hd, vec);
      cp_commit();
    }
  }

  store_acc<NT, 1>(dq + qoff, qstride, q0 + warp * 16, S, hd, acc, scale, 0, lane, vec);
}

// ---------------------------------------------------------------------------
// backward, dK and dV: one block per (k tile, KV head), after flash_tf32_bwd_dq
// (D). It walks the G query heads of its group and their q tiles in a fixed
// order, (Q, dO, lse, D) of the next one in flight where two stages fit.
// SPLIT warps own each 16 key rows: 1 up to hd 64; 2 above, each computing
// S^T and dP^T over the whole head dim and accumulating every other 8-column
// tile of dK and dV (half h of the pair: tiles 2i + h).
// ---------------------------------------------------------------------------
template <int HD, int SPLIT>
__global__ void __launch_bounds__(kThreads * SPLIT, 1) flash_tf32_bwd_dkdv(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dbuf, float* __restrict__ dk, float* __restrict__ dv, int N,
    int S, int H, int KV, int hd, int causal, int window, float scale, int vec) {
  constexpr int T = kB * HD, NTHREADS = kThreads * SPLIT, ST = dkdv_stages<HD>();
  constexpr int NT = HD / 8 / SPLIT;       // a warp's 8-column tiles of dK and dV
  static_assert(HD % (8 * SPLIT) == 0, "a warp's columns are whole n8 tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + T;
  float* sQ = sV + T;              // ST stages
  float* sdO = sQ + ST * T;        // ST stages
  float* sL = sdO + ST * T;        // ST stages of kB
  float* sD = sL + ST * kB;        // ST stages of kB
  const int heads = N * KV;
  const int k0 = static_cast<int>(blockIdx.x) / heads * kB;   // the most queries first
  const int n = (blockIdx.x % heads) / KV, kvh = blockIdx.x % KV, G = H / KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  // this warp's key rows and half of the head dim
  const int rows = (warp % 4) * 16, half = warp / 4;
  const long long qstride = static_cast<long long>(H) * hd;
  const long long kstride = static_cast<long long>(KV) * hd;
  const long long koff = (static_cast<long long>(n) * S * KV + kvh) * hd;

  // queries that can see a key of this tile
  const int qt0 = (causal ? k0 : 0) / kB;
  const int q_end = window ? min(S, k0 + kB - 1 + window) : S;
  const int nq = (q_end + kB - 1) / kB - qt0, steps = G * nq;
  auto issue = [&](int step, int stage) {      // (Q, dO, lse, D) of step into stage
    const int hq = kvh * G + step / nq, q0 = (qt0 + step % nq) * kB;
    const long long qoff = (static_cast<long long>(n) * S * H + hq) * hd;
    const long long soff = (static_cast<long long>(n) * H + hq) * S;
    load_tile<HD, NTHREADS>(sQ + stage * T, q + qoff, qstride, q0, S, hd, vec);
    load_tile<HD, NTHREADS>(sdO + stage * T, dout + qoff, qstride, q0, S, hd, vec);
    if (threadIdx.x < 2 * kB) {
      const int r = threadIdx.x % kB, row = q0 + r;
      const float* src = (threadIdx.x < kB ? lse : dbuf) + soff;
      float* dst = (threadIdx.x < kB ? sL : sD) + stage * kB + r;
      cp4(dst, row < S ? src + row : src, row < S ? 4 : 0);
    }
  };
  load_tile<HD, NTHREADS>(sK, k + koff, kstride, k0, S, hd, vec);
  load_tile<HD, NTHREADS>(sV, v + koff, kstride, k0, S, hd, vec);
  issue(0, 0);
  cp_commit();

  const Lane<HD, SPLIT> ln(g, t, half);
  const float* wK = sK + rows * HD;
  const float* wV = sV + rows * HD;
  float gk[NT][4], gv[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
    gk[i][0] = gk[i][1] = gk[i][2] = gk[i][3] = gv[i][0] = gv[i][1] = gv[i][2] = gv[i][3] = 0.f;
  const int key0 = k0 + rows + g;            // this thread's keys: key0, key0 + 8
  const float sl2 = scale * kLog2e;           // P = 2^(s sl2 - lse log2(e))

  for (int it = 0; it < steps; ++it) {
    const int q0 = (qt0 + it % nq) * kB, st = ST == 2 ? it & 1 : 0;
    const float* cQ = sQ + st * T;
    const float* cdO = sdO + st * T;
    const float* cL = sL + st * kB;
    const float* cD = sD + st * kB;
    if (ST == 2 && it + 1 < steps) {
      issue(it + 1, st ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    // the step's queries in two halves of 32, each: S^T = K Q^T (16 keys x
    // 32 queries a warp), P^T, this warp's columns of dV += P^T dO; then
    // dP^T = V dO^T, dS^T = P^T (dP^T - D), dK += dS^T Q
    const bool masked = cut(q0, k0, S, S, causal, window);
#pragma unroll 1
    for (int qr = 0; qr < kB; qr += 32) {
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[i][0] = s[i][1] = s[i][2] = s[i][3] = dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
#pragma unroll 1
      for (int k32 = 0; k32 < HD; k32 += 32)   // not unrolled: fewer registers live
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          FragA a;
          const float2 x0 = ln.ld_pair(wK, 0, k32, j), x1 = ln.ld_pair(wK, 8, k32, j);
          split_a(a, x0.x, x1.x, x0.y, x1.y);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const float2 y = ln.ld_pair(cQ, qr + nt * 8, k32, j);
            mma3(s[nt], a, y.x, y.y);
          }
        }
      // P^T (into s), fp32
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = qr + nt * 8 + 2 * t + (i & 1);
          const bool ok = !masked || visible(q0 + qi, key0 + 8 * (i >> 1), S, S, causal, window);
          s[nt][i] = ok ? exp2f(fmaf(s[nt][i], sl2, -cL[qi] * kLog2e)) : 0.f;
        }
      {
        FragA a[4];
        frags_of(a, s, 0);
        mma_rows32(gv, a, cdO, qr, ln);
      }
#pragma unroll 1
      for (int k32 = 0; k32 < HD; k32 += 32)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          FragA c;
          const float2 y0 = ln.ld_pair(wV, 0, k32, j), y1 = ln.ld_pair(wV, 8, k32, j);
          split_a(c, y0.x, y1.x, y0.y, y1.y);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const float2 z = ln.ld_pair(cdO, qr + nt * 8, k32, j);
            mma3(dp[nt], c, z.x, z.y);
          }
        }
      // dS^T = P^T (dP^T - D) (into dp), fp32
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dp[nt][i] = s[nt][i] * (dp[nt][i] - cD[qr + nt * 8 + 2 * t + (i & 1)]);
      FragA a[4];
      frags_of(a, dp, 0);
      mma_rows32(gk, a, cQ, qr, ln);
    }
    __syncthreads();
    if (ST == 1 && it + 1 < steps) {   // one stage: the next step lands after this one is read
      issue(it + 1, 0);
      cp_commit();
    }
  }

  store_acc<NT, SPLIT>(dk + koff, kstride, k0 + rows, S, hd, gk, scale, half, lane, vec);
  store_acc<NT, SPLIT>(dv + koff, kstride, k0 + rows, S, hd, gv, 1.f, half, lane, vec);
}

}  // namespace tf

// both directions take hd up to 160
bool dims_ok(long long N, long long S, long long Sk, long long H, long long KV, long long hd) {
  return N >= 1 && N <= 65535 && S >= 1 && S <= 0x7fffffffLL - tc::kB && Sk >= 1 &&
         Sk <= 0x7fffffffLL - tc::kB && H >= 1 && H <= 65535 && KV >= 1 && H % KV == 0 &&
         hd >= 1 && hd <= 160 && N * S * H * hd < (1LL << 62) &&
         N * Sk * KV * hd < (1LL << 62);
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// the bf16 kernels' grid: tiles x heads in one dimension
bool mma_grid(long long tiles, long long heads, unsigned* blocks) {
  if (tiles * heads > 0x7fffffffLL) return false;
  *blocks = static_cast<unsigned>(tiles * heads);
  return true;
}

template <int HD>
int launch_fwd_mma(const void* q, const void* k, const void* v, void* o, float* lse, int N,
                   int S, int Sk, int H, int KV, int hd, int causal, int window, float scale,
                   cudaStream_t st) {
  using tc::bf16;
  constexpr int smem = tc::fwd_smem<HD>();
  // once per instantiation, at the first call (before any CUDA-graph
  // capture; the port drives one device)
  static const cudaError_t attr = cudaFuncSetAttribute(
      tc::flash_mma_fwd<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  unsigned blocks;
  if (!mma_grid((S + tc::kB - 1) / tc::kB, static_cast<long long>(N) * H, &blocks))
    return cudaErrorInvalidValue;
  const int vec = hd % 8 == 0 && aligned16({q, k, v, o});
  tc::flash_mma_fwd<HD><<<blocks, tc::kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, N, S, Sk, H, KV, hd, causal, window, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bwd_mma(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* dbuf, void* dq, void* dk, void* dv, int N, int S,
                   int H, int KV, int hd, int causal, int window, float scale, cudaStream_t st) {
  using tc::bf16;
  constexpr int smem_q = tc::dq_smem<HD>(), smem_kv = tc::dkdv_smem<HD>();
  constexpr int split = HD > 128 ? 2 : 1;   // warps on each 16 key rows of dK/dV
  static const cudaError_t attr = [] {   // once per instantiation, as launch_fwd_mma
    cudaError_t e = cudaFuncSetAttribute(tc::flash_mma_bwd_dq<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(tc::flash_mma_bwd_dkdv<HD, split>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
    return e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long tiles = (S + tc::kB - 1) / tc::kB;
  unsigned q_blocks, kv_blocks;
  if (!mma_grid(tiles, static_cast<long long>(N) * H, &q_blocks) ||
      !mma_grid(tiles, static_cast<long long>(N) * KV, &kv_blocks))
    return cudaErrorInvalidValue;
  const int vec = hd % 8 == 0 && aligned16({q, k, v, o, dout, dq, dk, dv});
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  tc::flash_mma_bwd_dq<HD><<<q_blocks, tc::kThreads, smem_q, st>>>(
      qt, kt, vt, static_cast<const bf16*>(o), dot, lse, dbuf, static_cast<bf16*>(dq), N, S, H,
      KV, hd, causal, window, scale, vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tc::flash_mma_bwd_dkdv<HD, split><<<kv_blocks, tc::kThreads * split, smem_kv, st>>>(
      qt, kt, vt, dot, lse, dbuf, static_cast<bf16*>(dk), static_cast<bf16*>(dv), N, S, H, KV,
      hd, causal, window, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_fwd_tf32(const void* q, const void* k, const void* v, void* o, float* lse, int N,
                    int S, int Sk, int H, int KV, int hd, int causal, int window, float scale,
                    cudaStream_t st) {
  constexpr int smem = tf::fwd_smem<HD>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      tf::flash_tf32_fwd<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  unsigned blocks;
  if (!mma_grid((S + tf::kB - 1) / tf::kB, static_cast<long long>(N) * H, &blocks))
    return cudaErrorInvalidValue;
  const int vec = hd % 4 == 0 && aligned16({q, k, v, o});
  tf::flash_tf32_fwd<HD><<<blocks, tf::kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, N, S, Sk, H, KV, hd, causal, window, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bwd_tf32(const void* q, const void* k, const void* v, const void* o,
                    const void* dout, const float* lse, float* dbuf, void* dq, void* dk, void* dv,
                    int N, int S, int H, int KV, int hd, int causal, int window, float scale,
                    cudaStream_t st) {
  constexpr int smem_q = tf::dq_smem<HD>(), smem_kv = tf::dkdv_smem<HD>();
  constexpr int split = tf::dkdv_split<HD>();
  static const cudaError_t attr = [] {   // once per instantiation, as launch_fwd_mma
    cudaError_t e = cudaFuncSetAttribute(tf::flash_tf32_bwd_dq<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(tf::flash_tf32_bwd_dkdv<HD, split>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
    return e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long tiles = (S + tf::kB - 1) / tf::kB;
  unsigned q_blocks, kv_blocks;
  if (!mma_grid(tiles, static_cast<long long>(N) * H, &q_blocks) ||
      !mma_grid(tiles, static_cast<long long>(N) * KV, &kv_blocks))
    return cudaErrorInvalidValue;
  const int vec = hd % 4 == 0 && aligned16({q, k, v, o, dout, dq, dk, dv});
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  tf::flash_tf32_bwd_dq<HD><<<q_blocks, tf::kThreads, smem_q, st>>>(
      qt, kt, vt, static_cast<const float*>(o), dot, lse, dbuf, static_cast<float*>(dq), N, S,
      H, KV, hd, causal, window, scale, vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tf::flash_tf32_bwd_dkdv<HD, split><<<kv_blocks, tf::kThreads * split, smem_kv, st>>>(
      qt, kt, vt, dot, lse, dbuf, static_cast<float*>(dk), static_cast<float*>(dv), N, S, H, KV,
      hd, causal, window, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: (N, S, H, hd); k, v: (N, Sk, KV, hd), one dtype (0 fp32, 1 bf16),
// contiguous; lse: (N, H, S) fp32; scale the fp32 of 1 / sqrt(hd), as the
// caller computes it. Sk != S (cross-attention) takes causal = 0 and
// window = 0; hd up to 160. Launches flash_mma_fwd (bf16) or flash_tf32_fwd
// (fp32) on `stream`; does not synchronise. Returns a cudaError_t.
extern "C" int flash_attention_forward(const void* q, const void* k, const void* v, void* o,
                                       float* lse, long long N, long long S, long long Sk,
                                       long long H, long long KV, long long hd, int causal,
                                       long long window, float scale, int bf16, void* stream) {
  if (!dims_ok(N, S, Sk, H, KV, hd) || window < 0 || window > 0x7fffffffLL ||
      (Sk != S && (causal || window)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(N), s = static_cast<int>(S), sk = static_cast<int>(Sk),
            h = static_cast<int>(H), kv = static_cast<int>(KV), d = static_cast<int>(hd),
            w = static_cast<int>(window);
#define FWD(HD) launch_fwd_tf32<HD>(q, k, v, o, lse, n, s, sk, h, kv, d, causal, w, scale, st)
#define FWD_MMA(HD) \
  launch_fwd_mma<HD>(q, k, v, o, lse, n, s, sk, h, kv, d, causal, w, scale, st)
  if (bf16) {
    if (hd <= 32) return FWD_MMA(32);
    if (hd <= 64) return FWD_MMA(64);
    if (hd <= 128) return FWD_MMA(128);
    return FWD_MMA(160);
  }
#undef FWD_MMA
  if (hd <= 32) return FWD(32);
  if (hd <= 64) return FWD(64);
  if (hd <= 128) return FWD(128);
  return FWD(160);
#undef FWD
}

// The backward: dq like q, dk and dv like k; dbuf (N, H, S) fp32 scratch
// for D; S = Sk, hd up to 160. Launches the dQ kernel then the dK/dV kernel
// (flash_mma_bwd_* in bf16, flash_tf32_bwd_* in fp32) on `stream`; does not
// synchronise. Returns a cudaError_t.
extern "C" int flash_attention_backward(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const float* lse,
                                        float* dbuf, void* dq, void* dk, void* dv, long long N,
                                        long long S, long long H, long long KV, long long hd,
                                        int causal, long long window, float scale, int bf16,
                                        void* stream) {
  if (!dims_ok(N, S, S, H, KV, hd) || window < 0 || window > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(N), s = static_cast<int>(S), h = static_cast<int>(H),
            kv = static_cast<int>(KV), d = static_cast<int>(hd), w = static_cast<int>(window);
#define BWD(HD)                                                                             \
  launch_bwd_tf32<HD>(q, k, v, o, dout, lse, dbuf, dq, dk, dv, n, s, h, kv, d, causal, w, scale, \
                      st)
#define BWD_MMA(HD)                                                                        \
  launch_bwd_mma<HD>(q, k, v, o, dout, lse, dbuf, dq, dk, dv, n, s, h, kv, d, causal, w, scale, \
                     st)
  if (bf16) {
    if (hd <= 32) return BWD_MMA(32);
    if (hd <= 64) return BWD_MMA(64);
    if (hd <= 128) return BWD_MMA(128);
    return BWD_MMA(160);
  }
#undef BWD_MMA
  if (hd <= 32) return BWD(32);
  if (hd <= 64) return BWD(64);
  if (hd <= 128) return BWD(128);
  return BWD(160);
#undef BWD
}

// Dynamic shared memory of a bf16 kernel (0 forward, 1 dQ, 2 dK/dV) at the
// head dim hd, in bytes; the fp32 kernels' likewise (bf16 = 0).
extern "C" int flash_attention_smem_bytes(int kernel, long long hd, int bf16) {
  const int i = hd <= 32 ? 0 : hd <= 64 ? 1 : hd <= 128 ? 2 : 3;
  if (bf16) {
    const int fwd[] = {tc::fwd_smem<32>(), tc::fwd_smem<64>(), tc::fwd_smem<128>(),
                       tc::fwd_smem<160>()};
    const int dq[] = {tc::dq_smem<32>(), tc::dq_smem<64>(), tc::dq_smem<128>(),
                      tc::dq_smem<160>()};
    const int dkdv[] = {tc::dkdv_smem<32>(), tc::dkdv_smem<64>(), tc::dkdv_smem<128>(),
                        tc::dkdv_smem<160>()};
    return kernel == 0 ? fwd[i] : kernel == 1 ? dq[i] : dkdv[i];
  }
  const int fwd[] = {tf::fwd_smem<32>(), tf::fwd_smem<64>(), tf::fwd_smem<128>(),
                     tf::fwd_smem<160>()};
  const int dq[] = {tf::dq_smem<32>(), tf::dq_smem<64>(), tf::dq_smem<128>(),
                    tf::dq_smem<160>()};
  const int dkdv[] = {tf::dkdv_smem<32>(), tf::dkdv_smem<64>(), tf::dkdv_smem<128>(),
                      tf::dkdv_smem<160>()};
  return kernel == 0 ? fwd[i] : kernel == 1 ? dq[i] : dkdv[i];
}

extern "C" const char* flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
