// K1 on Hopper: int8 quantize/dequantize round trip with one scale per row.
//
// Replaces the Pallas kernel src/repro/kernels/quantize.py::int8_roundtrip
// (body _qdq_kernel), which quantizes one flat tensor with a per-tensor scale
// reduced outside its grid. Here the input is (R, n): row r is one wire
// tensor (one client's activation uplink, or one client's copy of a
// parameter leaf) with its own scale
//   s_r = max(max|x_r|, 1e-12) / 127,
//   out = clip(rint(x / s_r), -127, 127) * s_r        (input dtype kept).
// The plain version is src/repro_torch/kernels/ref.py::int8_roundtrip_ref;
// the two are bit-equal.
//
// Bound: memory. The function must read every element once and write it
// once (8 bytes per fp32 element, 4 per bf16) for about five float
// operations, far under the H100's flop-per-byte ridge. The design moves
// 12 bytes per fp32 element: pass 1 reads the row for its absmax, pass 2
// reads it again and writes the result. Both passes use 16-byte vector
// loads on the aligned body of each row, with scalar head and tail loops
// for a row that starts off a 16-byte boundary or whose length is not a
// multiple of the vector width. Rows spread over gridDim.y and each row
// over many blocks of gridDim.x, so a cohort of ten 2M-element rows fills
// the card. Fusing both passes into one (a grid-wide barrier) is later work.
//
// Bit-equality with the plain version rests on:
//  * the absmax as an integer max over the bit patterns of |x|: exact, and
//    a NaN (sign cleared by fabsf) sorts above +inf, so it propagates like
//    torch.amax / jnp.max;
//  * __fdiv_rn for x / s (IEEE division, never a reciprocal multiply);
//  * rintf, which rounds half to even like torch.round / jnp.round;
//  * NaN-propagating max/clip, like torch.clamp / jnp.clip;
//  * __float2bfloat16_rn (round to nearest even) for bf16 output.
// Build without --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecsPerThread = 4;  // work per thread per grid-stride pass

struct F32 {
  using Raw = float;
  static constexpr int kVec = 4;
  __device__ static float load(Raw r) { return r; }
  __device__ static Raw store(float v) { return v; }
};

struct BF16 {
  using Raw = unsigned short;
  static constexpr int kVec = 8;
  __device__ static float load(Raw r) { return __bfloat162float(__ushort_as_bfloat16(r)); }
  __device__ static Raw store(float v) { return __bfloat16_as_ushort(__float2bfloat16_rn(v)); }
};

template <typename D>
union Pack {
  uint4 u;
  typename D::Raw e[D::kVec];
};

__device__ __forceinline__ int abs_bits(float v) { return __float_as_int(fabsf(v)); }

// Number of leading elements of a row before its first 16-byte boundary.
template <typename Raw>
__device__ __forceinline__ int64_t head_len(const Raw* row, int64_t n) {
  const unsigned mis = static_cast<unsigned>(reinterpret_cast<uintptr_t>(row) & 15u);
  const int64_t h = mis ? static_cast<int64_t>((16u - mis) / sizeof(Raw)) : 0;
  return h < n ? h : n;
}

__device__ __forceinline__ int warp_max(int m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// Pass 1: amax_bits[r] = max over the row of the bit pattern of |x|.
// amax_bits must hold zeros on entry.
template <typename D>
__global__ void __launch_bounds__(kThreads)
absmax_rows(const typename D::Raw* __restrict__ x, int* __restrict__ amax_bits,
            int64_t rows, int64_t n) {
  using Raw = typename D::Raw;
  constexpr int V = D::kVec;
  __shared__ int partial[kThreads / 32];
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const Raw* row = x + r * n;
    const int64_t h = head_len(row, n);
    const int64_t nv = (n - h) / V;
    const uint4* body = reinterpret_cast<const uint4*>(row + h);
    int m = 0;
    for (int64_t i = tid; i < nv; i += stride) {
      Pack<D> p;
      p.u = __ldg(body + i);
#pragma unroll
      for (int k = 0; k < V; ++k) m = max(m, abs_bits(D::load(p.e[k])));
    }
    for (int64_t i = tid; i < h; i += stride) m = max(m, abs_bits(D::load(row[i])));
    for (int64_t i = h + nv * V + tid; i < n; i += stride) m = max(m, abs_bits(D::load(row[i])));

    m = warp_max(m);
    if (lane == 0) partial[warp] = m;
    __syncthreads();
    if (warp == 0) {
      m = lane < kThreads / 32 ? partial[lane] : 0;
      m = warp_max(m);
      if (lane == 0 && m != 0) atomicMax(amax_bits + r, m);
    }
    __syncthreads();  // partial[] is reused by the next row
  }
}

__device__ __forceinline__ float row_scale(int bits) {
  const float a = __int_as_float(bits);
  const float s = isnan(a) ? a : fmaxf(a, static_cast<float>(1e-12));
  return __fdiv_rn(s, 127.0f);
}

__device__ __forceinline__ float qdq(float v, float s) {
  float q = rintf(__fdiv_rn(v, s));
  q = isnan(q) ? q : fminf(fmaxf(q, -127.0f), 127.0f);
  return __fmul_rn(q, s);
}

// Pass 2: out = qdq(x, s_r). `vec` is false when x and out differ in their
// offset from a 16-byte boundary; the whole row then takes the scalar path.
template <typename D>
__global__ void __launch_bounds__(kThreads)
qdq_rows(const typename D::Raw* __restrict__ x, typename D::Raw* __restrict__ out,
         const int* __restrict__ amax_bits, int64_t rows, int64_t n, bool vec) {
  using Raw = typename D::Raw;
  constexpr int V = D::kVec;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;

  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const float s = row_scale(amax_bits[r]);
    const Raw* row = x + r * n;
    Raw* orow = out + r * n;
    const int64_t h = vec ? head_len(row, n) : n;
    const int64_t nv = (n - h) / V;
    const uint4* body = reinterpret_cast<const uint4*>(row + h);
    uint4* obody = reinterpret_cast<uint4*>(orow + h);
    for (int64_t i = tid; i < nv; i += stride) {
      Pack<D> p;
      p.u = __ldg(body + i);
#pragma unroll
      for (int k = 0; k < V; ++k) p.e[k] = D::store(qdq(D::load(p.e[k]), s));
      obody[i] = p.u;
    }
    for (int64_t i = tid; i < h; i += stride) orow[i] = D::store(qdq(D::load(row[i]), s));
    for (int64_t i = h + nv * V + tid; i < n; i += stride)
      orow[i] = D::store(qdq(D::load(row[i]), s));
  }
}

template <typename D>
cudaError_t launch(const void* x, void* out, void* amax, int64_t rows, int64_t n,
                   cudaStream_t stream) {
  using Raw = typename D::Raw;
  const int64_t per_block = static_cast<int64_t>(kThreads) * D::kVec * kVecsPerThread;
  int64_t bx = (n + per_block - 1) / per_block;
  bx = bx < 1 ? 1 : (bx > 2048 ? 2048 : bx);
  const unsigned gy = static_cast<unsigned>(rows < 65535 ? rows : 65535);
  const dim3 grid(static_cast<unsigned>(bx), gy);
  const bool vec = ((reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(out)) & 15u) == 0;

  absmax_rows<D><<<grid, kThreads, 0, stream>>>(static_cast<const Raw*>(x),
                                                static_cast<int*>(amax), rows, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  qdq_rows<D><<<grid, kThreads, 0, stream>>>(static_cast<const Raw*>(x), static_cast<Raw*>(out),
                                             static_cast<const int*>(amax), rows, n, vec);
  return cudaGetLastError();
}

}  // namespace

// x, out: (rows, n) contiguous, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1).
// amax: (rows,) 4-byte scratch, zeroed by the caller. Launches the two
// kernels on `stream`, which must belong to the calling thread's current
// device, and does not synchronise. Returns a cudaError_t.
extern "C" int int8_roundtrip_rows(const void* x, void* out, void* amax, long long rows,
                                   long long n, int is_bf16, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<BF16>(x, out, amax, rows, n, st) : launch<F32>(x, out, amax, rows, n, st);
  return static_cast<int>(err);
}

extern "C" const char* int8_roundtrip_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
