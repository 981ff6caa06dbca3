// K3 on Hopper: fused per-token cross-entropy, forward and backward.
//
// Replaces the Pallas kernel src/repro/kernels/fused_xent.py::fused_xent
// (body _xent_kernel): per token an online logsumexp over vocab blocks with
// fp32 (m, l, picked), loss = m + log(max(l, 1e-30)) - logits[label],
// nothing vocab-sized written. The Pallas kernel has no VJP (the JAX
// package trains through jnp token_xent and autodiff); here the backward is
// a kernel too:
//   forward:  logits (T, V) fp32 or bf16, labels (T,) int32
//             -> loss (T,) fp32, lse (T,) fp32;
//   backward: (logits, labels, lse, g) -> dlogits (T, V) in the logits'
//             dtype, g_t (exp(x - lse_t) - [v == label_t]).
// A label outside [0, V) picks 0, as the Pallas kernel's block-wise pick
// does. The plain versions are src/repro_torch/kernels/ref.py::
// fused_xent_ref and ::fused_xent_bwd_ref.
//
// Bound. On the path (the aux and LM heads, T = 8,192 tokens, V = 49,152,
// bf16) the forward reads 805 MB of logits: ~0.24 ms at 3.35 TB/s; one exp
// per element (~0.4 G) is well inside the card's rate. The backward reads
// and writes the logits: ~0.48 ms. Both are bound by bytes.
//
// Design. One warp per token row, 8 rows per block: the row reduction is a
// shuffle tree, no shared memory. Each lane streams 16-byte vectors (8 bf16
// or 4 fp32; two in flight per iteration) when the row length in bytes and
// the base pointers are 16-byte aligned, else single elements; the ragged
// tail of T is masked (no rounding of T or V to block divisors). Each lane
// keeps its own online (m, l), rescaled once per vector; lanes combine in a
// fixed order, so the result does not change from run to run.
//
// Build without --use_fast_math (expf and logf as written).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// elements per 16-byte vector
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

template <typename T>
__device__ __forceinline__ void load16(const T* p, float (&x)[Vec<T>::N]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) x[i] = to_f(e[i]);
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const float (&x)[Vec<T>::N]) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) e[i] = from_f<T>(x[i]);
  *reinterpret_cast<uint4*>(p) = u;
}

// exp(a - m), with a = -inf (no mass yet) giving 0 whatever m is
__device__ __forceinline__ float exp_from(float a, float m) {
  return a == -INFINITY ? 0.f : expf(a - m);
}

// fold n values into the running (m, l): one rescale per call
template <int N>
__device__ __forceinline__ void fold(float& m, float& l, const float (&x)[N]) {
  float cm = x[0];
#pragma unroll
  for (int i = 1; i < N; ++i) cm = fmaxf(cm, x[i]);
  const float m_new = fmaxf(m, cm);
  if (m_new == -INFINITY) return;
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) sum += exp_from(x[i], m_new);
  l = l * exp_from(m, m_new) + sum;
  m = m_new;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) xent_fwd(const T* __restrict__ logits,
                                                     const int* __restrict__ labels,
                                                     float* __restrict__ loss,
                                                     float* __restrict__ lse, long long Tn,
                                                     long long V) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= Tn) return;
  const T* x = logits + row * V;
  float m = -INFINITY, l = 0.f;
  if (kVec) {
    constexpr int N = Vec<T>::N;
    const long long nv = V / N;
    long long i = lane;
    for (; i + 32 < nv; i += 64) {
      float a[N], b[N];
      load16(x + i * N, a);
      load16(x + (i + 32) * N, b);
      fold(m, l, a);
      fold(m, l, b);
    }
    for (; i < nv; i += 32) {
      float a[N];
      load16(x + i * N, a);
      fold(m, l, a);
    }
  } else {
    for (long long i = lane; i < V; i += 32) {
      const float a[1] = {to_f(x[i])};
      fold(m, l, a);
    }
  }
  // combine the lanes' (m, l) by a fixed shuffle tree
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    const float m_new = fmaxf(m, mo);
    if (m_new != -INFINITY) {
      l = l * exp_from(m, m_new) + lo * exp_from(mo, m_new);
      m = m_new;
    }
  }
  if (lane == 0) {
    const int label = labels[row];
    const float picked = (label >= 0 && label < V) ? to_f(x[label]) : 0.f;
    const float z = m + logf(fmaxf(l, 1e-30f));
    lse[row] = z;
    loss[row] = z - picked;
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) xent_bwd(const T* __restrict__ logits,
                                                     const int* __restrict__ labels,
                                                     const float* __restrict__ lse,
                                                     const float* __restrict__ g,
                                                     T* __restrict__ dlogits, long long Tn,
                                                     long long V) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= Tn) return;
  const T* x = logits + row * V;
  T* dx = dlogits + row * V;
  const float z = lse[row], gt = g[row];
  const long long label = labels[row];
  if (kVec) {
    constexpr int N = Vec<T>::N;
    const long long nv = V / N;
    for (long long i = lane; i < nv; i += 32) {
      float a[N];
      load16(x + i * N, a);
#pragma unroll
      for (int e = 0; e < N; ++e)
        a[e] = gt * (expf(a[e] - z) - (i * N + e == label ? 1.f : 0.f));
      store16(dx + i * N, a);
    }
  } else {
    for (long long i = lane; i < V; i += 32)
      dx[i] = from_f<T>(gt * (expf(to_f(x[i]) - z) - (i == label ? 1.f : 0.f)));
  }
}

template <typename T>
bool vec_ok(const void* a, const void* b, long long V) {
  return (V * static_cast<long long>(sizeof(T))) % 16 == 0 &&
         (reinterpret_cast<uintptr_t>(a) & 15u) == 0 && (reinterpret_cast<uintptr_t>(b) & 15u) == 0;
}

bool dims_ok(long long Tn, long long V) {
  return Tn >= 1 && V >= 1 && V <= 0x7fffffffLL && (Tn + kWarps - 1) / kWarps <= 0x7fffffffLL;
}

template <typename T>
int launch_fwd(const void* logits, const int* labels, float* loss, float* lse, long long Tn,
               long long V, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((Tn + kWarps - 1) / kWarps);
  const T* x = static_cast<const T*>(logits);
  if (vec_ok<T>(logits, logits, V))
    xent_fwd<T, true><<<blocks, kThreads, 0, st>>>(x, labels, loss, lse, Tn, V);
  else
    xent_fwd<T, false><<<blocks, kThreads, 0, st>>>(x, labels, loss, lse, Tn, V);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* logits, const int* labels, const float* lse, const float* g,
               void* dlogits, long long Tn, long long V, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((Tn + kWarps - 1) / kWarps);
  const T* x = static_cast<const T*>(logits);
  T* dx = static_cast<T*>(dlogits);
  if (vec_ok<T>(logits, dlogits, V))
    xent_bwd<T, true><<<blocks, kThreads, 0, st>>>(x, labels, lse, g, dx, Tn, V);
  else
    xent_bwd<T, false><<<blocks, kThreads, 0, st>>>(x, labels, lse, g, dx, Tn, V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// logits (T, V) fp32 (bf16 = 0) or bf16 (bf16 = 1), contiguous; labels (T,)
// int32; loss, lse (T,) fp32. Launches xent_fwd on `stream`; does not
// synchronise. Returns a cudaError_t.
extern "C" int fused_xent_forward(const void* logits, const int* labels, float* loss,
                                  float* lse, long long Tn, long long V, int bf16,
                                  void* stream) {
  if (!dims_ok(Tn, V)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<__nv_bfloat16>(logits, labels, loss, lse, Tn, V, st)
              : launch_fwd<float>(logits, labels, loss, lse, Tn, V, st);
}

// g (T,) fp32: the loss cotangent; dlogits like logits. Launches xent_bwd
// on `stream`; does not synchronise. Returns a cudaError_t.
extern "C" int fused_xent_backward(const void* logits, const int* labels, const float* lse,
                                   const float* g, void* dlogits, long long Tn, long long V,
                                   int bf16, void* stream) {
  if (!dims_ok(Tn, V)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd<__nv_bfloat16>(logits, labels, lse, g, dlogits, Tn, V, st)
              : launch_bwd<float>(logits, labels, lse, g, dlogits, Tn, V, st);
}

extern "C" const char* fused_xent_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
