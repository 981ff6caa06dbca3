// K5 on Hopper: the chunkwise-parallel mLSTM cell (xLSTM's matrix memory),
// forward and backward, fp32 in and out.
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
// n is one more column of C (the state update fed v with a column of ones),
// and dn one more column of dC (the reverse walk fed g / den with a column
// r = d loss / d(n.q)), so both ride the walks over C and dC.
// The Pallas kernel has no VJP (the JAX model differentiates its jnp chunk
// scan); here every mLSTM on the card runs on these kernels, so the backward
// is a kernel too. The plain versions are src/repro_torch/kernels/ref.py::
// mlstm_chunk_ref (and autograd through it).
//
// Bound. On the path (BH = 48, S = 512, dh = 512) the forward needs 19.40
// GFLOP of products (causal halves only) and the backward 38.78, against
// ~0.2 GB of bytes: bound by operations, 0.2896 / 0.5788 ms at the 67
// TFLOP/s fp32 rate of the FMA units. Here every product runs on the tensor
// cores in split TF32: each fp32 operand is big = tf32(x) plus small =
// tf32(x - big), both rounded as cvt.rna.tf32.f32 rounds, and a product is
// small.big + big.small + big.big (the dropped small.small is ~2^-22 of
// it), so three TF32 products per fp32 one, 0.1176 / 0.2350 ms at 495
// TFLOP/s. One TF32 product alone keeps 11 bits and breaks fp32 parity; the
// split keeps it (tests/test_torch_mlstm_split.py). The tensor cores need
// not round their own fp32 sum to nearest, so each k-step of 8 sums its
// three products in a fresh fragment that is added to the running sum with
// one round-to-nearest fp32 add.
//
// Design. Every product is a 64 x 64 output tile per block of four warps
// (32 x 32 each, mma.sync m16n8k8 tf32), fed by a two-stage ring of 32-deep
// k-blocks that cp.async copies to shared memory 16 bytes at a time, each
// operand as it lies in memory: a tile contiguous in its depth k is padded
// to rows of 36 floats, a tile contiguous in its rows to rows of 72, so
// that the fragments' 32-bit shared loads of either layout, transposed or
// not, hit 32 banks. Elements are split where their fragment is loaded,
// once per warp and k-step.
//   forward  prep   (one block per (row, chunk): a block scan of log_f gives
//                    cum, exp(cum), u and exp(cum_P))
//            scores (A per (row, chunk, 64 x 64 tile), only tiles with s <= t)
//            state  (one block per (row, 64 x 64 tile of C): the tile walks
//                    the chunks in order and is written at every chunk
//                    start after the first; the first column tile's blocks
//                    also walk n)
//            out    (h per (row, chunk, 64 x 64 tile) = (q C + A v) / den;
//                    den from q.n and A's row sums, summed from the staged
//                    tiles in a fixed order, the same in every tile)
//   backward bprep  (a warp per position: r_t from g.h, and g / den)
//            bstate (the reverse walk of dC per 64 x 64 tile, written at
//                    every chunk end before the last; <dC, C> per tile for
//                    the gate of the carried state; dn in the first column
//                    tile's blocks)
//            bscores (dA = (g/den) v^T + r and the scores again: A and dS =
//                    dA D stored, the row and column sums of the gate term
//                    H = dA (q.k) exp(cum_t - cum_s) per tile)
//            dq, dv, dk (the state term, then the chunk's own; dk runs last:
//                    g / den lives in its output until then)
//            gates  (one block per (row, chunk): the sums of the tiles'
//                    partials, a block scan for d log_f)
// Every output element has one writer and every sum a fixed order: no
// float atomics, the same bits every run. exp is taken only where s <= t.
// Any S: the last chunk is ragged and masked. 1 <= dh <= 512; 16-byte
// copies where dh is a multiple of 4, 4-byte copies otherwise.
//
// Build without --use_fast_math (expf and IEEE division as written).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kP = 256;            // chunk length
constexpr int kT = 64;             // output tile of every product
constexpr int kNT = kP / kT;       // tiles along a chunk
constexpr int kTri = kNT * (kNT + 1) / 2;   // (t tile, s tile) pairs with s <= t
constexpr int kBK = 32;            // depth of a staged k-block
constexpr int kThreads = 128;      // 2 x 2 warps of 32 x 32
constexpr int kMaxDh = 512;
constexpr int kLdK = kBK + 4;      // row stride of a tile staged contiguous in k
constexpr int kLdR = kT + 8;       // row stride of a tile staged contiguous in its rows
constexpr int kTileF = kT * kLdK;  // floats of one staged operand
static_assert(kT * kLdK == kBK * kLdR, "both stagings fill one buffer");
constexpr int kSmemF = 4 * kTileF;  // two operands, two stages: 36,864 bytes

struct Dims {
  int BH, S, dh, nch;
  bool vec;   // dh % 4 == 0 and q, k, v 16-byte aligned: 16-byte copies
};

__device__ __forceinline__ int chunk_len(const Dims& d, int c) { return min(kP, d.S - c * kP); }
__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// copies, the split and the tensor-core product
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = big + small, both TF32, each rounded as cvt.rna.tf32.f32 rounds (to
// nearest, ties away from zero: add half the dropped 13 bits' weight to the
// magnitude, then clear them). Written as the integer add and mask that
// cvt.rna compiles to, without its guard for inf and NaN, which halves the
// split's instructions; for finite x the bits are cvt.rna's.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  const float rest = x - __uint_as_float(big);
  small = (__float_as_uint(rest) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One operand of a block's 64 x 64 tile product: element (r, k), r < 64 the
// row (m of A, n of B), lies at p[r * ld + k] when the operand is staged
// contiguous in k (KC), else at p[k * ld + r]. Rows r >= rows and depths
// k >= k1 read as 0.
struct Op {
  const float* p;
  int ld, rows;
};

// the 64 x 32 k-block of `o` at depth kb into s: 512 pieces of 4 elements
template <bool KC>
__device__ __forceinline__ void stage(float* s, const Op& o, int kb, int k1, bool vec) {
  for (int i = threadIdx.x; i < kT * kBK / 4; i += kThreads) {
    int r, k;
    float* dst;
    const float* src;
    if (KC) {
      r = i / (kBK / 4);
      k = kb + (i % (kBK / 4)) * 4;
      dst = s + r * kLdK + (k - kb);
      src = o.p + (size_t)r * o.ld + k;
    } else {
      k = kb + i / (kT / 4);
      r = (i % (kT / 4)) * 4;
      dst = s + (k - kb) * kLdR + r;
      src = o.p + (size_t)k * o.ld + r;
    }
    if (vec) {
      const int n = KC ? (r < o.rows ? max(0, min(4, k1 - k)) : 0)
                       : (k < k1 ? max(0, min(4, o.rows - r)) : 0);
      cp_async16(dst, n ? src : o.p, 4 * n);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = KC ? (r < o.rows && k + j < k1) : (k < k1 && r + j < o.rows);
        cp_async4(dst + j, ok ? src + j : o.p, ok ? 4 : 0);
      }
    }
  }
}

struct NoHook {
  __device__ void operator()(const float*, int) const {}
};

// acc += sum_{k0 <= k < k1} A(m, k) B(k, n) over the block's 64 x 64 tile;
// acc[i][j] is this warp's m16n8 tile (i, j) in the mma.sync C layout. A is
// staged contiguous in k if KA, B if KB. With SCALE, A(m, k) is multiplied by
// ks[k] (shared memory, 0 past k1) before it is split. hook(sA, kb) sees
// every staged k-block of A once it is visible to the whole block.
template <bool KA, bool KB, bool SCALE, class Hook>
__device__ __forceinline__ void tile_mma(float (&acc)[2][4][4], const Op& a, const Op& b, int k0,
                                         int k1, bool vec, float* sm, const float* ks, Hook hook) {
  const int nk = cdiv(k1 - k0, kBK);
  if (nk <= 0) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  stage<KA>(sm, a, k0, k1, vec);
  stage<KB>(sm + kTileF, b, k0, k1, vec);
  cp_commit();
  for (int it = 0; it < nk; ++it) {
    const int kb = k0 + it * kBK;
    const float* sA = sm + (it & 1) * 2 * kTileF;
    const float* sB = sA + kTileF;
    if (it + 1 < nk) {
      float* nxt = sm + ((it + 1) & 1) * 2 * kTileF;
      stage<KA>(nxt, a, kb + kBK, k1, vec);
      stage<KB>(nxt + kTileF, b, kb + kBK, k1, vec);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    hook(sA, kb);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t ab[2][4], as[2][4], bb[4][2], bs[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = wm + i * 16 + g;
        float x[4];
        if (KA) {
          x[0] = sA[m * kLdK + kk + t];
          x[1] = sA[(m + 8) * kLdK + kk + t];
          x[2] = sA[m * kLdK + kk + t + 4];
          x[3] = sA[(m + 8) * kLdK + kk + t + 4];
        } else {
          x[0] = sA[(kk + t) * kLdR + m];
          x[1] = sA[(kk + t) * kLdR + m + 8];
          x[2] = sA[(kk + t + 4) * kLdR + m];
          x[3] = sA[(kk + t + 4) * kLdR + m + 8];
        }
        if (SCALE) {
          const float s0 = ks[kb + kk + t], s1 = ks[kb + kk + t + 4];
          x[0] *= s0;
          x[1] *= s0;
          x[2] *= s1;
          x[3] *= s1;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) split(x[r], ab[i][r], as[i][r]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + j * 8 + g;
        float y0, y1;
        if (KB) {
          y0 = sB[n * kLdK + kk + t];
          y1 = sB[n * kLdK + kk + t + 4];
        } else {
          y0 = sB[(kk + t) * kLdR + n];
          y1 = sB[(kk + t + 4) * kLdR + n];
        }
        split(y0, bb[j][0], bs[j][0]);
        split(y1, bb[j][1], bs[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float dd[4] = {0.f, 0.f, 0.f, 0.f};
          mma(dd, as[i], bb[j]);
          mma(dd, ab[i], bs[j]);
          mma(dd, ab[i], bb[j]);
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] += dd[r];
        }
    }
    __syncthreads();
  }
}

// the row and column within the block's 64 x 64 tile of acc[i][j][r]
__device__ __forceinline__ int frag_row(int i, int r) {
  return (threadIdx.x >> 6) * 32 + i * 16 + ((threadIdx.x & 31) >> 2) + (r >> 1) * 8;
}
__device__ __forceinline__ int frag_col(int j, int r) {
  return ((threadIdx.x >> 5) & 1) * 32 + j * 8 + (threadIdx.x & 3) * 2 + (r & 1);
}

__device__ __forceinline__ void zero(float (&acc)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
}

// two adjacent outputs: one 8-byte store where both are in and vec allows
__device__ __forceinline__ void put2(float* p, float x, float y, bool ok0, bool ok1, bool vec) {
  if (vec && ok0 && ok1) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  } else {
    if (ok0) p[0] = x;
    if (ok1) p[1] = y;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// a fixed-order sum over the block (red: one float per warp); every thread gets it
__device__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  x = warp_sum(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < nw; ++w) s += red[w];
  __syncthreads();
  return s;
}

// the inclusive scan of x over the block's threads, in a fixed order (part:
// one float per warp)
__device__ float block_scan(float x, float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) part[warp] = x;
  __syncthreads();
  float before = 0.f;
  for (int w = 0; w < warp; ++w) before += part[w];
  __syncthreads();
  return x + before;
}

// Row sums over the tile's 64 columns of v (this thread's fragments), in a
// fixed order: each thread's eight columns, the four lanes of a row, the two
// column halves. Thread r < 64 gets row r's sum. red: 128 floats.
__device__ float tile_row_sum(const float (&v)[2][4][4], float* red) {
  const int lane = threadIdx.x & 31, wn = (threadIdx.x >> 5) & 1;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float x = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x += v[i][j][2 * hh];
        x += v[i][j][2 * hh + 1];
      }
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if ((lane & 3) == 0) red[wn * kT + frag_row(i, 2 * hh)] = x;
    }
  __syncthreads();
  const float s = threadIdx.x < kT ? red[threadIdx.x] + red[kT + threadIdx.x] : 0.f;
  __syncthreads();
  return s;
}

// Column sums over the tile's 64 rows, likewise; thread c < 64 gets column c's.
__device__ float tile_col_sum(const float (&v)[2][4][4], float* red) {
  const int lane = threadIdx.x & 31, wm = threadIdx.x >> 6;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      float x = v[0][j][p];
      x += v[0][j][2 + p];
      x += v[1][j][p];
      x += v[1][j][2 + p];
      x += __shfl_xor_sync(0xffffffffu, x, 4);
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      x += __shfl_xor_sync(0xffffffffu, x, 16);
      if (lane < 4) red[wm * kT + frag_col(j, p)] = x;
    }
  __syncthreads();
  const float s = threadIdx.x < kT ? red[threadIdx.x] + red[kT + threadIdx.x] : 0.f;
  __syncthreads();
  return s;
}

// block l of the kTri (t tile, s tile) pairs with s <= t
__device__ __forceinline__ void tri_tile(int l, int& tt, int& st) {
  tt = 0;
  while (l > tt) l -= ++tt;
  st = l;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// one block per (row, chunk), a thread per position: cum (a block scan),
// alpha = exp(cum), u = exp(cum_P - cum) i, beta = exp(cum_P)
__global__ void __launch_bounds__(kP)
mlstm_prep(const float* __restrict__ lf, const float* __restrict__ ig, float* __restrict__ cum,
           float* __restrict__ alpha, float* __restrict__ u, float* __restrict__ beta, Dims d) {
  __shared__ float part[kP / 32];
  __shared__ float last;
  const int bc = blockIdx.x, bh = bc / d.nch, c = bc % d.nch, L = chunk_len(d, c);
  const size_t row = (size_t)bh * d.S + (size_t)c * kP;
  const int t = threadIdx.x;
  const float x = block_scan(t < L ? lf[row + t] : 0.f, part);
  if (t == L - 1) last = x;
  __syncthreads();
  if (t < L) {
    cum[row + t] = x;
    alpha[row + t] = expf(x);
    u[row + t] = expf(last - x) * ig[row + t];
  }
  if (t == 0) beta[bc] = expf(last);
}

// A_ts = (q_t . k_s) exp(cum_t - cum_s) i_s for s <= t, one 64 x 64 tile;
// grid (kTri pairs with s <= t, row * chunk); masked entries are 0.
__global__ void __launch_bounds__(kThreads)
mlstm_scores(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ cum, const float* __restrict__ ig,
             float* __restrict__ amat, Dims d) {
  __shared__ __align__(16) float sm[kSmemF];
  int tt, st;
  tri_tile(blockIdx.x, tt, st);
  const int bc = blockIdx.y, bh = bc / d.nch, c = bc % d.nch, L = chunk_len(d, c);
  const int t0 = tt * kT, s0 = st * kT, dh = d.dh;
  if (t0 >= L) return;
  const size_t row = (size_t)bh * d.S + (size_t)c * kP;
  float acc[2][4][4];
  zero(acc);
  tile_mma<true, true, false>(acc, Op{q + (row + t0) * dh, dh, L - t0},
                              Op{k + (row + s0) * dh, dh, L - s0}, 0, dh, d.vec, sm, nullptr,
                              NoHook{});
  float* out = amat + (size_t)bc * kP * kP;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = t0 + frag_row(i, 2 * hh), s = s0 + frag_col(j, 0);
        float a[2];
#pragma unroll
        for (int p = 0; p < 2; ++p)
          a[p] = (s + p <= t && t < L)
                     ? acc[i][j][2 * hh + p] *
                           (expf(cum[row + t] - cum[row + s + p]) * ig[row + s + p])
                     : 0.f;
        put2(out + (size_t)t * kP + s, a[0], a[1], true, true, true);
      }
}

// The state walk: one block per (64 x 64 tile of C, row); the tile walks the
// chunks in order, C_{c+1} = beta_c C_c + K^T diag(u) V, and C at the start
// of chunk c + 1 goes to cst (BH, nch - 1, dh, dh). Blocks of the first
// column tile walk n likewise (the column of ones of V), to nst (BH, nch - 1,
// dh). Every chunk but the last is full.
__global__ void __launch_bounds__(kThreads)
mlstm_state(const float* __restrict__ k, const float* __restrict__ v,
            const float* __restrict__ u, const float* __restrict__ beta,
            float* __restrict__ cst, float* __restrict__ nst, Dims d) {
  __shared__ __align__(16) float sm[kSmemF];
  __shared__ float su[kP];
  __shared__ float red[kThreads];
  const int dh = d.dh, nte = cdiv(dh, kT), tid = threadIdx.x;
  const int d0 = (blockIdx.x / nte) * kT, e0 = (blockIdx.x % nte) * kT, bh = blockIdx.y;
  const bool norm = e0 == 0;
  float acc[2][4][4];
  zero(acc);
  float n = 0.f;   // n[d0 + tid] for tid < 64 in the first column tile
  for (int c = 0; c + 1 < d.nch; ++c) {
    const size_t row = (size_t)bh * d.S + (size_t)c * kP;
    const float b = beta[bh * d.nch + c];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] *= b;
    for (int s = tid; s < kP; s += kThreads) su[s] = u[row + s];
    __syncthreads();
    tile_mma<false, false, true>(acc, Op{k + row * dh + d0, dh, dh - d0},
                                 Op{v + row * dh + e0, dh, dh - e0}, 0, kP, d.vec, sm, su,
                                 NoHook{});
    if (norm) {
      const int dd = tid & (kT - 1), half = tid / kT;
      float p = 0.f;
      if (d0 + dd < dh)
        for (int s = half * (kP / 2); s < (half + 1) * (kP / 2); ++s)
          p = fmaf(su[s], k[(row + s) * dh + d0 + dd], p);
      red[tid] = p;
      __syncthreads();
      if (tid < kT) n = fmaf(b, n, red[tid] + red[tid + kT]);
    }
    const size_t sc = (size_t)bh * (d.nch - 1) + c;
    float* cc = cst + sc * dh * dh;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = d0 + frag_row(i, 2 * hh), e = e0 + frag_col(j, 0);
          if (r < dh)
            put2(cc + (size_t)r * dh + e, acc[i][j][2 * hh], acc[i][j][2 * hh + 1], e < dh,
                 e + 1 < dh, d.vec);
        }
    if (norm && tid < kT && d0 + tid < dh) nst[sc * dh + d0 + tid] = n;
    __syncthreads();   // su and red are rewritten for the next chunk
  }
}

// h_t = (exp(cum_t) q_t C + sum_s A_ts v_s) / den_t, one 64 x 64 tile; grid
// (e tile, t tile, row * chunk). den_t = max(|exp(cum_t) q_t.n + sum_s A_ts|,
// 1) from the staged q and A tiles; the first e tile writes nq and den.
__global__ void __launch_bounds__(kThreads)
mlstm_out(const float* __restrict__ q, const float* __restrict__ v,
          const float* __restrict__ amat, const float* __restrict__ cst,
          const float* __restrict__ nst, const float* __restrict__ alpha,
          float* __restrict__ h, float* __restrict__ nq, float* __restrict__ den, Dims d) {
  __shared__ __align__(16) float sm[kSmemF];
  __shared__ float sn[kMaxDh];
  __shared__ float red[2 * kThreads];
  __shared__ float sden[kT];
  const int et = blockIdx.x, tt = blockIdx.y, bc = blockIdx.z;
  const int bh = bc / d.nch, c = bc % d.nch, L = chunk_len(d, c);
  const int t0 = tt * kT, e0 = et * kT, dh = d.dh, tid = threadIdx.x;
  if (t0 >= L) return;
  const size_t row = (size_t)bh * d.S + (size_t)c * kP;
  // thread (row rr, half) sums half of each staged k-block of row rr, from a
  // lane-dependent start so that a warp's reads hit 32 banks
  const int rr = tid & (kT - 1), half = tid / kT, rot = (tid & 31) >> 3;
  float qn = 0.f, rs = 0.f;
  float acc[2][4][4];
  zero(acc);
  if (c > 0) {   // C and n are 0 at the first chunk
    const size_t sc = (size_t)bh * (d.nch - 1) + c - 1;
    for (int i = tid; i < kMaxDh; i += kThreads) sn[i] = i < dh ? nst[sc * dh + i] : 0.f;
    __syncthreads();
    tile_mma<true, false, false>(
        acc, Op{q + (row + t0) * dh, dh, L - t0}, Op{cst + sc * dh * dh + e0, dh, dh - e0}, 0,
        dh, d.vec, sm, nullptr, [&](const float* sA, int kb) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int kk = half * 16 + ((j + rot) & 15);
            qn = fmaf(sA[rr * kLdK + kk], sn[kb + kk], qn);
          }
        });
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = t0 + frag_row(i, r);
        const float a = t < L ? alpha[row + t] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j][r] *= a;
      }
  }
  tile_mma<true, false, false>(
      acc, Op{amat + (size_t)bc * kP * kP + (size_t)t0 * kP, kP, L - t0},
      Op{v + row * dh + e0, dh, dh - e0}, 0, min(t0 + kT, L), d.vec, sm, nullptr,
      [&](const float* sA, int) {
#pragma unroll
        for (int j = 0; j < 16; ++j) rs += sA[rr * kLdK + half * 16 + ((j + rot) & 15)];
      });
  red[tid] = qn;
  red[kThreads + tid] = rs;
  __syncthreads();
  if (tid < kT) {
    const int t = t0 + tid;
    float dn = 1.f;
    if (t < L) {
      const float x = alpha[row + t] * (red[tid] + red[tid + kT]) +
                      (red[kThreads + tid] + red[kThreads + tid + kT]);
      dn = fmaxf(fabsf(x), 1.f);
      if (et == 0) {
        nq[row + t] = x;
        den[row + t] = dn;
      }
    }
    sden[tid] = dn;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int tl = frag_row(i, 2 * hh), t = t0 + tl, e = e0 + frag_col(j, 0);
        if (t < L)
          put2(h + (row + t) * dh + e, acc[i][j][2 * hh] / sden[tl],
               acc[i][j][2 * hh + 1] / sden[tl], e < dh, e + 1 < dh, d.vec);
      }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// a warp per position: r_t = d loss / d nq_t, with dden_t = -(g_t . h_t) /
// den_t and d max(|x|, 1) / dx = sign(x) where |x| > 1, half of it at |x| = 1
// (as jnp.maximum and torch.maximum split a tie); gd_t = g_t / den_t.
__global__ void __launch_bounds__(256)
mlstm_bprep(const float* __restrict__ h, const float* __restrict__ g,
            const float* __restrict__ nq, const float* __restrict__ den,
            float* __restrict__ r, float* __restrict__ gd, Dims d) {
  const int lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (p >= (long long)d.BH * d.S) return;
  const float* gp = g + p * d.dh;
  const float* hp = h + p * d.dh;
  float* op = gd + p * d.dh;
  const float dv = den[p];
  float gh = 0.f;
  for (int i = lane; i < d.dh; i += 32) {
    const float gi = gp[i];
    gh = fmaf(gi, hp[i], gh);
    op[i] = gi / dv;
  }
  gh = warp_sum(gh);
  if (lane == 0) {
    const float x = nq[p], ax = fabsf(x);
    const float slope = ax > 1.f ? 1.f : (ax == 1.f ? 0.5f : 0.f);
    const float dden = -gh / dv;
    r[p] = x > 0.f ? dden * slope : (x < 0.f ? -dden * slope : 0.f);
  }
}

// The reverse walk: dC_c = beta_c dC_{c+1} + Q^T diag(alpha) G, G = g / den,
// per (64 x 64 tile of dC, row), from the last chunk down; dC at the end of
// chunk c - 1 goes to dcend (BH, nch - 1, dh, dh) and the tile's part of
// <dC_c, C_{c-1}>, the gradient of beta_{c-1}, to dbc (tile, BH, nch). Blocks
// of the first column tile walk dn (the column r of G) likewise, to dnend
// (BH, nch - 1, dh), and their part of <dn_c, n_{c-1}> to dbn (d tile, BH,
// nch).
__global__ void __launch_bounds__(kThreads)
mlstm_bstate(const float* __restrict__ q, const float* __restrict__ gd,
             const float* __restrict__ r, const float* __restrict__ alpha,
             const float* __restrict__ beta, const float* __restrict__ cst,
             const float* __restrict__ nst, float* __restrict__ dcend,
             float* __restrict__ dnend, float* __restrict__ dbc, float* __restrict__ dbn, Dims d) {
  __shared__ __align__(16) float sm[kSmemF];
  __shared__ float sal[kP], sar[kP];
  __shared__ float red[kThreads];
  __shared__ float wred[kThreads / 32];
  const int dh = d.dh, nte = cdiv(dh, kT), tid = threadIdx.x, tile = blockIdx.x;
  const int dt = tile / nte, d0 = dt * kT, e0 = (tile % nte) * kT, bh = blockIdx.y;
  const bool norm = e0 == 0;
  float acc[2][4][4];
  zero(acc);
  float dn = 0.f;   // dn[d0 + tid] for tid < 64 in the first column tile
  for (int c = d.nch - 1; c >= 1; --c) {
    const int L = chunk_len(d, c);
    const size_t row = (size_t)bh * d.S + (size_t)c * kP;
    const float b = c < d.nch - 1 ? beta[bh * d.nch + c] : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) acc[i][j][rr] *= b;
    for (int s = tid; s < kP; s += kThreads) {
      const float a = s < L ? alpha[row + s] : 0.f;
      sal[s] = a;
      sar[s] = s < L ? a * r[row + s] : 0.f;
    }
    __syncthreads();
    tile_mma<false, false, true>(acc, Op{q + row * dh + d0, dh, dh - d0},
                                 Op{gd + row * dh + e0, dh, dh - e0}, 0, L, d.vec, sm, sal,
                                 NoHook{});
    const size_t se = (size_t)bh * (d.nch - 1) + c - 1;
    float* dc = dcend + se * dh * dh;
    const float* cc = c >= 2 ? cst + (se - 1) * dh * dh : nullptr;   // C_0 = 0
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int rw = d0 + frag_row(i, 2 * hh), e = e0 + frag_col(j, 0);
          if (rw >= dh) continue;
          const float x0 = acc[i][j][2 * hh], x1 = acc[i][j][2 * hh + 1];
          put2(dc + (size_t)rw * dh + e, x0, x1, e < dh, e + 1 < dh, d.vec);
          if (cc != nullptr) {
            if (e < dh) part = fmaf(x0, cc[(size_t)rw * dh + e], part);
            if (e + 1 < dh) part = fmaf(x1, cc[(size_t)rw * dh + e + 1], part);
          }
        }
    part = block_sum(part, wred);
    if (tid == 0) dbc[((size_t)tile * d.BH + bh) * d.nch + c - 1] = part;
    if (norm) {
      const int dd = tid & (kT - 1), hf = tid / kT;
      float p = 0.f;
      if (d0 + dd < dh)
        for (int s = hf * (kP / 2); s < min(L, (hf + 1) * (kP / 2)); ++s)
          p = fmaf(sar[s], q[(row + s) * dh + d0 + dd], p);
      red[tid] = p;
      __syncthreads();
      float pn = 0.f;
      if (tid < kT) {
        dn = fmaf(b, dn, red[tid] + red[tid + kT]);
        if (d0 + tid < dh) {
          dnend[se * dh + d0 + tid] = dn;
          if (c >= 2) pn = dn * nst[(se - 1) * dh + d0 + tid];
        }
      }
      pn = block_sum(pn, wred);
      if (tid == 0) dbn[((size_t)dt * d.BH + bh) * d.nch + c - 1] = pn;
    }
    __syncthreads();   // sal, sar and red are rewritten for the next chunk
  }
}

// per (t tile, s tile) with s <= t and row * chunk: dA = (g_t / den_t) . v_s +
// r_t and the scores again; A = (q.k) D and dS = dA D go to amat and dsm, and
// the row sums of H i_s and the column sums of H, H = dA (q.k) exp(cum_t -
// cum_s), to hrow (s tile, BH, S) and hcol (t tile, BH, S).
__global__ void __launch_bounds__(kThreads)
mlstm_bscores(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ gd,
              const float* __restrict__ r, const float* __restrict__ cum,
              const float* __restrict__ ig, float* __restrict__ amat, float* __restrict__ dsm,
              float* __restrict__ hrow, float* __restrict__ hcol, Dims d) {
  __shared__ __align__(16) float sm[kSmemF];
  __shared__ float red[2 * kT];
  int tt, st;
  tri_tile(blockIdx.x, tt, st);
  const int bc = blockIdx.y, bh = bc / d.nch, c = bc % d.nch, L = chunk_len(d, c);
  const int t0 = tt * kT, s0 = st * kT, dh = d.dh, tid = threadIdx.x;
  if (t0 >= L) return;
  const size_t row = (size_t)bh * d.S + (size_t)c * kP;
  float da[2][4][4], sc[2][4][4];
  zero(da);
  zero(sc);
  tile_mma<true, true, false>(da, Op{gd + (row + t0) * dh, dh, L - t0},
                              Op{v + (row + s0) * dh, dh, L - s0}, 0, dh, d.vec, sm, nullptr,
                              NoHook{});
  tile_mma<true, true, false>(sc, Op{q + (row + t0) * dh, dh, L - t0},
                              Op{k + (row + s0) * dh, dh, L - s0}, 0, dh, d.vec, sm, nullptr,
                              NoHook{});
  const size_t base = (size_t)bc * kP * kP;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = t0 + frag_row(i, 2 * hh), s = s0 + frag_col(j, 0);
        float a[2], ds[2];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int x = 2 * hh + p;
          float hv = 0.f, wv = 0.f;
          a[p] = ds[p] = 0.f;
          if (s + p <= t && t < L) {
            const float e = expf(cum[row + t] - cum[row + s + p]);
            const float w = ig[row + s + p];
            const float dd = e * w;
            const float dA = da[i][j][x] + r[row + t];
            a[p] = sc[i][j][x] * dd;
            ds[p] = dA * dd;
            hv = dA * (sc[i][j][x] * e);
            wv = hv * w;
          }
          sc[i][j][x] = hv;
          da[i][j][x] = wv;
        }
        put2(amat + base + (size_t)t * kP + s, a[0], a[1], true, true, true);
        put2(dsm + base + (size_t)t * kP + s, ds[0], ds[1], true, true, true);
      }
  const float rsum = tile_row_sum(da, red);
  if (tid < kT && t0 + tid < L) hrow[((size_t)st * d.BH + bh) * d.S + c * kP + t0 + tid] = rsum;
  const float csum = tile_col_sum(sc, red);
  if (tid < kT && s0 + tid < L) hcol[((size_t)tt * d.BH + bh) * d.S + c * kP + s0 + tid] = csum;
}

// dq_t = exp(cum_t) (C_c (g_t / den_t) + r_t n_c) + sum_s dS_ts k_s; the d
// tile's part of q_t . (C_c g_t / den_t + r_t n_c), the gradient of
// exp(cum_t), to dal (d tile, BH, S). Grid (d tile, t tile, row * chunk).
__global__ void __launch_bounds__(kThreads)
mlstm_dq(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ gd, const float* __restrict__ r,
         const float* __restrict__ alpha, const float* __restrict__ cst,
         const float* __restrict__ nst, const float* __restrict__ dsm, float* __restrict__ dq,
         float* __restrict__ dal, Dims d) {
  __shared__ __align__(16) float sm[kSmemF];
  __shared__ float red[2 * kT];
  const int dt = blockIdx.x, tt = blockIdx.y, bc = blockIdx.z;
  const int bh = bc / d.nch, c = bc % d.nch, L = chunk_len(d, c);
  const int t0 = tt * kT, d0 = dt * kT, dh = d.dh, tid = threadIdx.x;
  if (t0 >= L) return;
  const size_t row = (size_t)bh * d.S + (size_t)c * kP;
  float* dalp = dal + ((size_t)dt * d.BH + bh) * d.S + (size_t)c * kP + t0;
  float acc[2][4][4];
  zero(acc);
  if (c > 0) {
    const size_t sc = (size_t)bh * (d.nch - 1) + c - 1;
    tile_mma<true, true, false>(acc, Op{gd + (row + t0) * dh, dh, L - t0},
                                Op{cst + sc * dh * dh + (size_t)d0 * dh, dh, dh - d0}, 0, dh,
                                d.vec, sm, nullptr, NoHook{});
    float w[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int t = t0 + frag_row(i, x), dd = d0 + frag_col(j, x);
          w[i][j][x] = 0.f;
          if (t < L && dd < dh) {
            const float y = fmaf(r[row + t], nst[sc * dh + dd], acc[i][j][x]);
            w[i][j][x] = q[(row + t) * dh + dd] * y;
            acc[i][j][x] = y * alpha[row + t];
          }
        }
    const float s = tile_row_sum(w, red);
    if (tid < kT && t0 + tid < L) dalp[tid] = s;
  } else if (tid < kT && t0 + tid < L) {
    dalp[tid] = 0.f;
  }
  tile_mma<true, false, false>(acc, Op{dsm + (size_t)bc * kP * kP + (size_t)t0 * kP, kP, L - t0},
                               Op{k + row * dh + d0, dh, dh - d0}, 0, min(t0 + kT, L), d.vec, sm,
                               nullptr, NoHook{});
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = t0 + frag_row(i, 2 * hh), dd = d0 + frag_col(j, 0);
        if (t < L)
          put2(dq + (row + t) * dh + dd, acc[i][j][2 * hh], acc[i][j][2 * hh + 1], dd < dh,
               dd + 1 < dh, d.vec);
      }
}

// dv_s = u_s k_s^T dC_end + sum_{t >= s} A_ts g_t / den_t; grid (e tile, s
// tile, row * chunk)
__global__ void __launch_bounds__(kThreads)
mlstm_dv(const float* __restrict__ k, const float* __restrict__ gd,
         const float* __restrict__ u, const float* __restrict__ dcend,
         const float* __restrict__ amat, float* __restrict__ dv, Dims d) {
  __shared__ __align__(16) float sm[kSmemF];
  const int et = blockIdx.x, st = blockIdx.y, bc = blockIdx.z;
  const int bh = bc / d.nch, c = bc % d.nch, L = chunk_len(d, c);
  const int s0 = st * kT, e0 = et * kT, dh = d.dh;
  if (s0 >= L) return;
  const size_t row = (size_t)bh * d.S + (size_t)c * kP;
  float acc[2][4][4];
  zero(acc);
  if (c < d.nch - 1) {   // nothing flows back into the last chunk's state update
    const size_t se = (size_t)bh * (d.nch - 1) + c;
    tile_mma<true, false, false>(acc, Op{k + (row + s0) * dh, dh, L - s0},
                                 Op{dcend + se * dh * dh + e0, dh, dh - e0}, 0, dh, d.vec, sm,
                                 nullptr, NoHook{});
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int s = s0 + frag_row(i, x);
        const float us = s < L ? u[row + s] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j][x] *= us;
      }
  }
  tile_mma<false, false, false>(acc, Op{amat + (size_t)bc * kP * kP + s0, kP, L - s0},
                                Op{gd + row * dh + e0, dh, dh - e0}, s0, L, d.vec, sm, nullptr,
                                NoHook{});
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int s = s0 + frag_row(i, 2 * hh), e = e0 + frag_col(j, 0);
        if (s < L)
          put2(dv + (row + s) * dh + e, acc[i][j][2 * hh], acc[i][j][2 * hh + 1], e < dh,
               e + 1 < dh, d.vec);
      }
}

// dk_s = u_s (dC_end v_s + dn_end) + sum_{t >= s} dS_ts q_t; the d tile's
// part of k_s . (dC_end v_s + dn_end), the gradient of u_s, to du (d tile,
// BH, S). Grid (d tile, s tile, row * chunk). Reads no g / den: that lives
// in dk's memory until this kernel runs.
__global__ void __launch_bounds__(kThreads)
mlstm_dk(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, const float* __restrict__ u,
         const float* __restrict__ dcend, const float* __restrict__ dnend,
         const float* __restrict__ dsm, float* __restrict__ dk, float* __restrict__ du, Dims d) {
  __shared__ __align__(16) float sm[kSmemF];
  __shared__ float red[2 * kT];
  const int dt = blockIdx.x, st = blockIdx.y, bc = blockIdx.z;
  const int bh = bc / d.nch, c = bc % d.nch, L = chunk_len(d, c);
  const int s0 = st * kT, d0 = dt * kT, dh = d.dh, tid = threadIdx.x;
  if (s0 >= L) return;
  const size_t row = (size_t)bh * d.S + (size_t)c * kP;
  float* dup = du + ((size_t)dt * d.BH + bh) * d.S + (size_t)c * kP + s0;
  float acc[2][4][4];
  zero(acc);
  if (c < d.nch - 1) {
    const size_t se = (size_t)bh * (d.nch - 1) + c;
    tile_mma<true, true, false>(acc, Op{v + (row + s0) * dh, dh, L - s0},
                                Op{dcend + se * dh * dh + (size_t)d0 * dh, dh, dh - d0}, 0, dh,
                                d.vec, sm, nullptr, NoHook{});
    float w[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int s = s0 + frag_row(i, x), dd = d0 + frag_col(j, x);
          w[i][j][x] = 0.f;
          if (s < L && dd < dh) {
            const float y = acc[i][j][x] + dnend[se * dh + dd];
            w[i][j][x] = k[(row + s) * dh + dd] * y;
            acc[i][j][x] = y * u[row + s];
          }
        }
    const float sum = tile_row_sum(w, red);
    if (tid < kT && s0 + tid < L) dup[tid] = sum;
  } else if (tid < kT && s0 + tid < L) {
    dup[tid] = 0.f;
  }
  tile_mma<false, false, false>(acc, Op{dsm + (size_t)bc * kP * kP + s0, kP, L - s0},
                                Op{q + row * dh + d0, dh, dh - d0}, s0, L, d.vec, sm, nullptr,
                                NoHook{});
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int s = s0 + frag_row(i, 2 * hh), dd = d0 + frag_col(j, 0);
        if (s < L)
          put2(dk + (row + s) * dh + dd, acc[i][j][2 * hh], acc[i][j][2 * hh + 1], dd < dh,
               dd + 1 < dh, d.vec);
      }
}

// one block per (row, chunk), a thread per position: the gate gradients.
//   d i_s   = sum_{t >= s} H_ts + du_s w_s,               w_s = exp(cum_P - cum_s)
//   d cum_t = sum_{s <= t} H_ts i_s - i_t sum_{t' >= t} H_t't + exp(cum_t) dal_t
//             - du_t i_t w_t   (+ sum_s du_s i_s w_s + dbeta exp(cum_P) at t = P)
//   d log_f = the reverse cumulative sum of d cum within the chunk (a block scan).
__global__ void __launch_bounds__(kP)
mlstm_gates(const float* __restrict__ cum, const float* __restrict__ alpha,
            const float* __restrict__ ig, const float* __restrict__ beta,
            const float* __restrict__ hrow, const float* __restrict__ hcol,
            const float* __restrict__ dal, const float* __restrict__ du,
            const float* __restrict__ dbc, const float* __restrict__ dbn,
            float* __restrict__ dlf, float* __restrict__ dig, Dims d) {
  __shared__ float dcum[kP];
  __shared__ float part[kP / 32];
  const int bc = blockIdx.x, bh = bc / d.nch, c = bc % d.nch, L = chunk_len(d, c);
  const size_t row = (size_t)bh * d.S + (size_t)c * kP, plane = (size_t)d.BH * d.S;
  const int ntd = cdiv(d.dh, kT), t = threadIdx.x;
  float x = 0.f, gw = 0.f;
  if (t < L) {
    const size_t pos = row + t;
    float rowh = 0.f, colh = 0.f, da = 0.f, dut = 0.f;
    for (int st = 0; st <= t / kT; ++st) rowh += hrow[st * plane + pos];
    for (int tt = t / kT; tt <= (L - 1) / kT; ++tt) colh += hcol[tt * plane + pos];
    for (int j = 0; j < ntd; ++j) {
      da += dal[j * plane + pos];
      dut += du[j * plane + pos];
    }
    const float w = expf(cum[row + L - 1] - cum[pos]);
    gw = dut * ig[pos] * w;
    dig[pos] = colh + dut * w;
    x = rowh - ig[pos] * colh + alpha[pos] * da - gw;
  }
  const float sw = block_sum(gw, part);
  if (t == L - 1 && c < d.nch - 1) {   // the last chunk's beta feeds no state
    float db = 0.f;
    for (int j = 0; j < ntd * ntd; ++j) db += dbc[((size_t)j * d.BH + bh) * d.nch + c];
    for (int j = 0; j < ntd; ++j) db += dbn[((size_t)j * d.BH + bh) * d.nch + c];
    x += sw + db * beta[bc];
  } else if (t == L - 1) {
    x += sw;
  }
  dcum[t] = x;
  __syncthreads();
  const float y = block_scan(t < L ? dcum[L - 1 - t] : 0.f, part);
  if (t < L) dlf[row + L - 1 - t] = y;
}

bool dims_ok(long long BH, long long S, long long dh) {
  const long long nch = (S + kP - 1) / kP;
  return BH >= 1 && S >= 1 && dh >= 1 && dh <= kMaxDh && BH * S <= 0x7fffffffLL &&
         BH * nch <= 65535 && BH <= 65535;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

Dims make_dims(long long BH, long long S, long long dh, const float* q, const float* k,
               const float* v) {
  return Dims{static_cast<int>(BH), static_cast<int>(S), static_cast<int>(dh),
              static_cast<int>((S + kP - 1) / kP),
              dh % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v)};
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
// nch, 256, 256); cst (BH, nch - 1, dh, dh) and nst (BH, nch - 1, dh), C and n
// at the start of every chunk after the first. Four launches on `stream`:
// prep, scores, state, out. Returns a cudaError_t.
extern "C" int mlstm_chunk_forward(const float* q, const float* k, const float* v,
                                   const float* lf, const float* ig, float* h, float* cum,
                                   float* alpha, float* u, float* beta, float* amat, float* cst,
                                   float* nst, float* nq, float* den, long long BH, long long S,
                                   long long dh, void* stream) {
  if (!dims_ok(BH, S, dh)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d = make_dims(BH, S, dh, q, k, v);
  const int ntd = cdiv(d.dh, kT);
  mlstm_prep<<<d.BH * d.nch, kP, 0, st>>>(lf, ig, cum, alpha, u, beta, d);
  CHECK_LAUNCH();
  mlstm_scores<<<dim3(kTri, d.BH * d.nch), kThreads, 0, st>>>(q, k, cum, ig, amat, d);
  CHECK_LAUNCH();
  mlstm_state<<<dim3(ntd * ntd, d.BH), kThreads, 0, st>>>(k, v, u, beta, cst, nst, d);
  CHECK_LAUNCH();
  mlstm_out<<<dim3(ntd, kNT, d.BH * d.nch), kThreads, 0, st>>>(q, v, amat, cst, nst, alpha, h,
                                                               nq, den, d);
  CHECK_LAUNCH();
  return cudaSuccess;
}

// The backward of h w.r.t. q, k, v, lf, ig for the output gradient g (like
// h), from the forward's saved h, cum, alpha, beta, cst, nst, nq, den (and
// u). Scratch, sized by the caller: r (BH, S); dcend (BH, nch - 1, dh, dh);
// dnend (BH, nch - 1, dh); dbc (ceil(dh / 64)^2, BH, nch); dbn (ceil(dh /
// 64), BH, nch); amat, dsm (BH, nch, 256, 256); hrow, hcol (4, BH, S); dal,
// du (ceil(dh / 64), BH, S). g / den is kept in dk until dk's kernel, the
// last but one, writes it. Seven launches on `stream`: bprep, bstate,
// bscores, dq, dv, dk, gates. Returns a cudaError_t.
extern "C" int mlstm_chunk_backward(const float* q, const float* k, const float* v,
                                    const float* ig, const float* h, const float* g,
                                    const float* cum, const float* alpha, const float* u,
                                    const float* beta, const float* cst, const float* nst,
                                    const float* nq, const float* den, float* r, float* dcend,
                                    float* dnend, float* dbc, float* dbn, float* amat, float* dsm,
                                    float* hrow, float* hcol, float* dal, float* du, float* dq,
                                    float* dk, float* dv, float* dlf, float* dig, long long BH,
                                    long long S, long long dh, void* stream) {
  if (!dims_ok(BH, S, dh)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d = make_dims(BH, S, dh, q, k, v);
  const int ntd = cdiv(d.dh, kT);
  const dim3 tri(kTri, d.BH * d.nch), tiles(ntd, kNT, d.BH * d.nch);
  float* gd = dk;
  mlstm_bprep<<<static_cast<unsigned>((BH * S + 7) / 8), 256, 0, st>>>(h, g, nq, den, r, gd, d);
  CHECK_LAUNCH();
  mlstm_bstate<<<dim3(ntd * ntd, d.BH), kThreads, 0, st>>>(q, gd, r, alpha, beta, cst, nst, dcend,
                                                           dnend, dbc, dbn, d);
  CHECK_LAUNCH();
  mlstm_bscores<<<tri, kThreads, 0, st>>>(q, k, v, gd, r, cum, ig, amat, dsm, hrow, hcol, d);
  CHECK_LAUNCH();
  mlstm_dq<<<tiles, kThreads, 0, st>>>(q, k, gd, r, alpha, cst, nst, dsm, dq, dal, d);
  CHECK_LAUNCH();
  mlstm_dv<<<tiles, kThreads, 0, st>>>(k, gd, u, dcend, amat, dv, d);
  CHECK_LAUNCH();
  mlstm_dk<<<tiles, kThreads, 0, st>>>(q, k, v, u, dcend, dnend, dsm, dk, du, d);
  CHECK_LAUNCH();
  mlstm_gates<<<d.BH * d.nch, kP, 0, st>>>(cum, alpha, ig, beta, hrow, hcol, dal, du, dbc, dbn,
                                           dlf, dig, d);
  CHECK_LAUNCH();
  return cudaSuccess;
}

extern "C" const char* mlstm_chunk_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
