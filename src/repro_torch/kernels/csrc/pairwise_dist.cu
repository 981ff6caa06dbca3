// K2 on Hopper: pairwise Euclidean distances within each client, forward
// and backward.
//
// Replaces the Pallas kernel src/repro/kernels/dcor.py::pairwise_dist (body
// _dist_kernel), which computes one (bb, bb) distance tile per grid step as
// sqrt(max(|x_i|^2 + |x_j|^2 - 2 x_i.x_j, 1e-12)) with one matrix-unit
// product per tile. The Pallas kernel has no VJP: the JAX package trains
// through jnp and autodiff. Here the input carries a leading client axis,
//   forward:  x (C, B, F) fp32 -> D (C, B, B) fp32,
//   backward: (x, D, gD) -> gx (C, B, F) fp32,
//             H = 0.5 gD / D where D > sqrt(1e-12) and i != j (else 0),
//             S = H + H^T, gx = 2 (diag(rowsum S) - S) x.
// The plain versions are src/repro_torch/kernels/ref.py::pairwise_dist_ref
// and ::pairwise_dist_bwd_ref.
//
// Bound. On the dcor path B is the batch (32) and F is 3,072 (images) or up
// to 65,536 (the stage-1 activation of ResNet-56): a skinny Gram with about
// 16 fp32 operations per byte read, near the H100's fp32 ridge outside the
// tensor cores (67e12 / 3.35e12 = 20). Both bounds matter; the backward
// also writes as many bytes as it reads, so it is bound by bytes.
//
// Forward design. The (B, B) output per client is tiny next to its input,
// so one block per client would leave most of the 132 SMs idle: F is split
// across blocks (split-K). Kernel 1 (gram_partial) gives each block one
// chunk of F and one (32, 32) tile pair of rows, stages 32 x 64 slices of
// both row tiles in shared memory (the next slice's loads in flight in
// registers meanwhile) and accumulates the partial Gram with fmaf, each
// warp owning 4 rows and each lane one column. Partial Grams go
// to a workspace (C, B, B, splits), splits innermost. Kernel 2
// (gram_finish) gives each output one warp: the lanes read the entry's
// partials side by side and add them in a fixed order (lane-strided, then
// a fixed shuffle tree), so the result does not change from run to run (no
// float atomics) and no thread walks all splits alone; then it applies
// d2 = G_ii + G_jj - 2 G_ij, the clamp and the sqrt.
// The squared norms are the Gram's own diagonal, summed in the same order
// as every G_ij: the diagonal of D is exactly sqrt(1e-12), and identical
// rows are exactly sqrt(1e-12) apart. Element (i, j) and (j, i) multiply
// the same pairs in the same order, so D is exactly symmetric. Ragged B and
// F are masked (zeros staged outside the tensor), never rounded to tile
// divisors.
//
// Backward design. One wave of blocks, each owning a client and every
// gridDim.x-th strip of 256 columns of F. A prologue builds the row sums of
// S in shared memory (one warp per row, a fixed shuffle tree); then, per
// (32, 32) tile of W = diag(rowsum S) - S, built in shared memory from D
// and gD (once per block when B <= 32), each thread accumulates 32 outputs
// of its column of x, loading 8 rows of its column at a time so their
// loads are in flight together. x is read once and gx written once, both
// coalesced.
//
// Simple first: no tensor cores (TF32 would break fp32 parity), no TMA.
// Build without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;               // rows per Gram tile (i and j)
constexpr int kKT = 64;                 // columns of x staged per step
constexpr int kStride = kKT + 4;        // row stride in shared memory: 16-byte
                                        // aligned and conflict-free float4 reads
constexpr int kThreads = 256;           // 8 warps
constexpr int kRowsPerWarp = kTile / (kThreads / 32);  // 4
constexpr int kRowsInFlight = 8;        // x loads issued together in the backward
constexpr int64_t kMaxB = 255 * kTile;  // tile pairs must fit gridDim.y

// One thread's share of a staged slice: rows [r0, r0 + 32) x columns
// [k0, k0 + 64) of one client's x, zero where row >= B or k >= kend. It is
// loaded into registers a step ahead (load) and written to shared memory
// s[row * kStride + k] once the previous step's products are done (store),
// so the next slice's loads are in flight while this one is multiplied.
constexpr int kSliceVecs = kTile * kKT / 4 / kThreads;  // float4s per thread: 2

template <bool kVec>
struct Slice {
  float4 v[kSliceVecs];

  __device__ __forceinline__ void load(const float* __restrict__ xc, int64_t B, int64_t F,
                                       int64_t r0, int64_t k0, int64_t kend) {
#pragma unroll
    for (int n = 0; n < kSliceVecs; ++n) {
      const int idx = threadIdx.x + n * kThreads;
      if (kVec) {  // F % 4 == 0 and x 16-byte aligned: a float4 is all in or all out
        const int row = idx / (kKT / 4), k = 4 * (idx % (kKT / 4));
        const int64_t r = r0 + row;
        v[n] = r < B && k0 + k < kend
                   ? __ldg(reinterpret_cast<const float4*>(xc + r * F + k0 + k))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {  // element m of float4 n is flat element idx + m * 512 of the slice
        float e[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int flat = idx + m * kSliceVecs * kThreads;
          const int row = flat / kKT, k = flat % kKT;
          const int64_t r = r0 + row;
          e[m] = r < B && k0 + k < kend ? __ldg(xc + r * F + k0 + k) : 0.f;
        }
        v[n] = make_float4(e[0], e[1], e[2], e[3]);
      }
    }
  }

  __device__ __forceinline__ void store(float* __restrict__ s) const {
#pragma unroll
    for (int n = 0; n < kSliceVecs; ++n) {
      const int idx = threadIdx.x + n * kThreads;
      if (kVec) {
        *reinterpret_cast<float4*>(s + (idx / (kKT / 4)) * kStride + 4 * (idx % (kKT / 4))) =
            v[n];
      } else {
        const float e[4] = {v[n].x, v[n].y, v[n].z, v[n].w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int flat = idx + m * kSliceVecs * kThreads;
          s[(flat / kKT) * kStride + flat % kKT] = e[m];
        }
      }
    }
  }
};

// ws[c, i, j, s] = sum over the s-th chunk of F of x[c, i, k] * x[c, j, k].
// grid (splits, T * T, C) with T = ceil(B / 32); chunk is a multiple of kKT.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gram_partial(const float* __restrict__ x, float* __restrict__ ws, int64_t B, int64_t F,
             int64_t chunk) {
  __shared__ __align__(16) float si[kTile * kStride];
  __shared__ __align__(16) float sj[kTile * kStride];
  const int64_t split = blockIdx.x, splits = gridDim.x;
  const int64_t T = (B + kTile - 1) / kTile;
  const int64_t ti = blockIdx.y / T, tj = blockIdx.y % T;
  const int64_t c = blockIdx.z;
  const float* xc = x + c * B * F;
  const int64_t kbeg = split * chunk;
  const int64_t kend = kbeg + chunk < F ? kbeg + chunk : F;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float acc[kRowsPerWarp];
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) acc[q] = 0.f;

  Slice<kVec> ni, nj;
  ni.load(xc, B, F, ti * kTile, kbeg, kend);
  nj.load(xc, B, F, tj * kTile, kbeg, kend);
  for (int64_t k0 = kbeg; k0 < kend; k0 += kKT) {
    ni.store(si);
    nj.store(sj);
    __syncthreads();
    if (k0 + kKT < kend) {
      ni.load(xc, B, F, ti * kTile, k0 + kKT, kend);
      nj.load(xc, B, F, tj * kTile, k0 + kKT, kend);
    }
#pragma unroll 4
    for (int kk = 0; kk < kKT; kk += 4) {
      const float4 b = *reinterpret_cast<const float4*>(sj + lane * kStride + kk);
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q) {
        // the same address in every lane: a broadcast
        const float4 a =
            *reinterpret_cast<const float4*>(si + (warp * kRowsPerWarp + q) * kStride + kk);
        acc[q] = fmaf(a.x, b.x, acc[q]);
        acc[q] = fmaf(a.y, b.y, acc[q]);
        acc[q] = fmaf(a.z, b.z, acc[q]);
        acc[q] = fmaf(a.w, b.w, acc[q]);
      }
    }
    __syncthreads();  // si, sj are overwritten next step
  }

  const int64_t j = tj * kTile + lane;
  float* wc = ws + c * B * B * splits;
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
    const int64_t i = ti * kTile + warp * kRowsPerWarp + q;
    if (i < B && j < B) wc[(i * B + j) * splits + split] = acc[q];
  }
}

// All lanes return the same sum: each step adds two partials that the
// partner lane adds in the other order, and float addition commutes.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of one entry's partial Grams, the same fixed order for every entry.
__device__ __forceinline__ float split_sum(const float* __restrict__ p, int64_t splits,
                                           int lane) {
  float g = 0.f;
  for (int64_t s = lane; s < splits; s += 32) g += p[s];
  return warp_sum(g);
}

// D[c, i, j] = sqrt(max(G_ii + G_jj - 2 G_ij, 1e-12)), NaN kept; one warp
// per output. grid ceil(C * B * B / 8), block 256.
__global__ void __launch_bounds__(kThreads)
gram_finish(const float* __restrict__ ws, float* __restrict__ out, int64_t C, int64_t B,
            int64_t splits) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= C * B * B) return;  // the whole warp leaves together
  const int64_t c = w / (B * B), ij = w % (B * B), i = ij / B, j = ij % B;
  const float* wc = ws + c * B * B * splits;
  const float gij = split_sum(wc + ij * splits, splits, lane);
  const float gii = split_sum(wc + (i * B + i) * splits, splits, lane);
  const float gjj = split_sum(wc + (j * B + j) * splits, splits, lane);
  const float d2 = gii + gjj - 2.f * gij;
  if (lane == 0) out[w] = sqrtf(isnan(d2) ? d2 : fmaxf(d2, 1e-12f));
}

// H[i, j] of the backward: 0.5 gD / D where the clamp let d2 through.
__device__ __forceinline__ float half_grad(const float* __restrict__ dc,
                                           const float* __restrict__ gc, int64_t B,
                                           int64_t i, int64_t j, float dmin) {
  if (i == j) return 0.f;
  const float d = dc[i * B + j];
  return d > dmin ? __fdiv_rn(0.5f * gc[i * B + j], d) : 0.f;
}

// wt[jj][ii] = W[i0 + ii, j0 + jj] of W = diag(rowsum S) - S, 0 outside B.
__device__ __forceinline__ void fill_w(float (*wt)[kTile], const float* __restrict__ rowsum,
                                       const float* __restrict__ dc,
                                       const float* __restrict__ gc, int64_t B, int64_t i0,
                                       int64_t j0, float dmin) {
  for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
    const int jj = idx / kTile, ii = idx % kTile;
    const int64_t i = i0 + ii, j = j0 + jj;
    float w = 0.f;
    if (i < B && j < B)
      w = i == j ? rowsum[i]
                 : -(half_grad(dc, gc, B, i, j, dmin) + half_grad(dc, gc, B, j, i, dmin));
    wt[jj][ii] = w;
  }
}

// gx[c, :, f] = 2 (diag(rowsum S) - S) x[c, :, f]; each block walks the
// columns blockIdx.x * 256 + [0, 256) in strides of gridDim.x * 256, so
// the row sums (and, for B <= 32, the one tile of W) are built once per
// block. grid (blocks per client, C); dynamic shared memory B floats.
__global__ void __launch_bounds__(kThreads)
dist_backward(const float* __restrict__ x, const float* __restrict__ dist,
              const float* __restrict__ gdist, float* __restrict__ gx, int64_t B, int64_t F) {
  extern __shared__ float rowsum[];
  __shared__ __align__(16) float wt[kTile][kTile];
  const int64_t c = blockIdx.y;
  const float* dc = dist + c * B * B;
  const float* gc = gdist + c * B * B;
  const float* xc = x + c * B * F;
  float* oc = gx + c * B * F;
  const float dmin = sqrtf(1e-12f);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int64_t i = warp; i < B; i += kThreads / 32) {
    float p = 0.f;
    for (int64_t j = lane; j < B; j += 32)
      p += half_grad(dc, gc, B, i, j, dmin) + half_grad(dc, gc, B, j, i, dmin);
    p = warp_sum(p);
    if (lane == 0) rowsum[i] = p;
  }
  __syncthreads();
  const bool one_tile = B <= kTile;
  if (one_tile) {
    fill_w(wt, rowsum, dc, gc, B, 0, 0, dmin);
    __syncthreads();
  }

  for (int64_t f0 = static_cast<int64_t>(blockIdx.x) * kThreads; f0 < F;
       f0 += static_cast<int64_t>(gridDim.x) * kThreads) {  // the same trips in every thread
    const int64_t f = f0 + threadIdx.x;
    const bool live = f < F;
    for (int64_t i0 = 0; i0 < B; i0 += kTile) {
      float acc[kTile];
#pragma unroll
      for (int q = 0; q < kTile; ++q) acc[q] = 0.f;
      for (int64_t j0 = 0; j0 < B; j0 += kTile) {
        if (!one_tile) {
          __syncthreads();  // the last tile's readers are done
          fill_w(wt, rowsum, dc, gc, B, i0, j0, dmin);
          __syncthreads();
        }
        const int64_t jn = B - j0 < kTile ? B - j0 : kTile;
        if (live) {
          for (int jr = 0; jr < jn; jr += kRowsInFlight) {
            float xv[kRowsInFlight];
#pragma unroll
            for (int r = 0; r < kRowsInFlight; ++r)
              xv[r] = jr + r < jn ? __ldg(xc + (j0 + jr + r) * F + f) : 0.f;
#pragma unroll
            for (int r = 0; r < kRowsInFlight; ++r) {
              const int jj = jr + r;  // rows past jn have W = 0 and xv = 0
#pragma unroll
              for (int q = 0; q < kTile; q += 4) {
                const float4 w = *reinterpret_cast<const float4*>(&wt[jj][q]);
                acc[q] = fmaf(w.x, xv[r], acc[q]);
                acc[q + 1] = fmaf(w.y, xv[r], acc[q + 1]);
                acc[q + 2] = fmaf(w.z, xv[r], acc[q + 2]);
                acc[q + 3] = fmaf(w.w, xv[r], acc[q + 3]);
              }
            }
          }
        }
      }
      if (live) {
#pragma unroll
        for (int q = 0; q < kTile; ++q)
          if (i0 + q < B) oc[(i0 + q) * F + f] = 2.f * acc[q];
      }
    }
  }
}

bool dims_ok(long long C, long long B, long long F) {
  return C > 0 && C <= 65535 && B > 0 && B <= kMaxB && F > 0;
}

}  // namespace

// x: (C, B, F) fp32 contiguous; out: (C, B, B) fp32; ws: (C, B, B, splits)
// fp32 scratch with splits = ceil(F / chunk), chunk a positive multiple of
// 64. Launches gram_partial then gram_finish on `stream`, which must belong
// to the calling thread's current device, and does not synchronise.
// Returns a cudaError_t.
extern "C" int pairwise_dist_forward(const float* x, float* out, float* ws, long long C,
                                     long long B, long long F, long long chunk, void* stream) {
  if (!dims_ok(C, B, F) || chunk <= 0 || chunk % kKT != 0) return cudaErrorInvalidValue;
  const long long splits = (F + chunk - 1) / chunk;
  if (splits > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long T = (B + kTile - 1) / kTile;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = F % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15u) == 0;
  const dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>(T * T),
                  static_cast<unsigned>(C));
  if (vec)
    gram_partial<true><<<grid, kThreads, 0, st>>>(x, ws, B, F, chunk);
  else
    gram_partial<false><<<grid, kThreads, 0, st>>>(x, ws, B, F, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long warps_per_block = kThreads / 32;
  const long long nb = (C * B * B + warps_per_block - 1) / warps_per_block;
  if (nb > 0x7fffffffLL) return cudaErrorInvalidValue;
  gram_finish<<<static_cast<unsigned>(nb), kThreads, 0, st>>>(ws, out, C, B, splits);
  return static_cast<int>(cudaGetLastError());
}

// x, gx: (C, B, F) fp32 contiguous; dist, gdist: (C, B, B) fp32 contiguous.
// Launches dist_backward on `stream`; does not synchronise. Returns a
// cudaError_t.
extern "C" int pairwise_dist_backward(const float* x, const float* dist, const float* gdist,
                                      float* gx, long long C, long long B, long long F,
                                      void* stream) {
  if (!dims_ok(C, B, F)) return cudaErrorInvalidValue;
  // one wave: as many blocks as fit on the card at once, shared by the
  // clients, and no more than there are 256-column strips
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dist_backward, kThreads,
                                                        B * sizeof(float));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long strips = (F + kThreads - 1) / kThreads;
  long long bx = (static_cast<long long>(sms) * per_sm + C - 1) / C;
  bx = bx < 1 ? 1 : (bx > strips ? strips : bx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dist_backward<<<dim3(static_cast<unsigned>(bx), static_cast<unsigned>(C)), kThreads,
                  B * sizeof(float), st>>>(x, dist, gdist, gx, B, F);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pairwise_dist_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
