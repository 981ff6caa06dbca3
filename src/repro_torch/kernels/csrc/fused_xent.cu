// K3 on Hopper: fused per-token cross-entropy, forward and backward.
//
// Replaces the Pallas kernel src/repro/kernels/fused_xent.py::fused_xent
// (body _xent_kernel): per token an online logsumexp over vocab blocks with
// fp32 (m, l, picked), loss = m + log(max(l, 1e-30)) - logits[label],
// nothing vocab-sized written. The Pallas kernel has no VJP (the JAX
// package trains through jnp token_xent and autodiff); here the backward is
// a kernel too:
//   forward:  logits (T, V) fp32 or bf16, labels (T,) int32 or int64
//             -> loss (T,) fp32, lse (T,) fp32;
//   backward: (logits, labels, lse, g) -> dlogits (T, V) in the logits'
//             dtype, g_t (exp(x - lse_t) - [v == label_t]).
// A label outside [0, V) picks 0, as the Pallas kernel's block-wise pick
// does. The plain versions are src/repro_torch/kernels/ref.py::
// fused_xent_ref and ::fused_xent_bwd_ref.
//
// Bound. At the path's (8,192, 49,152) bf16 the forward reads 805 MB of
// logits, ~0.24 ms at 3.35 TB/s; the backward reads and writes them, ~0.48
// ms. Both are bound by bytes, but only just by the forward's issue rate:
// 132 SMs must retire ~7 bf16 elements a cycle each (at 1.7-1.9 GHz), which
// leaves about 17 thread instructions an element (4 schedulers x 32 lanes
// a cycle) and takes 44% of the 16 MUFU.EX2 a cycle. The backward has
// twice the bytes an element, so twice the instructions to spend.
//
// Design, against the four things that held the first version back:
//  1. Unaligned rows. A row whose start is not on a 16-byte boundary (an
//     odd V, a view with a storage offset) is cut into a head (up to 7 bf16
//     or 3 fp32 elements before its first boundary), its 16-byte vectors,
//     and a tail; head and tail go element by element, the vectors as
//     uint4 loads, so every row streams on the 16-byte path. The backward
//     needs dlogits at the logits' offset mod 16 (the wrapper allocates it
//     so) and refuses other pointers.
//  2. Instructions an element. The forward takes the max over a batch of
//     kBatch vectors a thread (bf16: packed HMNMX2, two elements an
//     instruction) before one rescale of l, and works in base 2: the values
//     seen sum to 2^c l with c = m log2(e) rounded once, each term is one
//     FFMA and one MUFU.EX2 (ex2.approx.ftz: 2 ulp, a subnormal flushed to
//     0, 2^-126 below any l it joins), and lse = (c + log2 l) ln 2, with no
//     error of c's rounding beyond one ulp of lse. No per-element -inf
//     test: only the rescale is guarded. bf16 goes to fp32 by a shift or a
//     mask, exact. The backward takes (x - lse) log2(e) as a subtraction
//     and a multiply (exact at x = lse, where p - 1 cancels) and packs two
//     bf16 an instruction. Built without --use_fast_math; the intrinsics
//     are written out. Each term then carries EX2's 2 ulp and its
//     argument's one rounding (ulp(arg) / 2, ln 2 of that relative), which
//     stays far inside the tolerances the plain version is held to (loss
//     2e-4, gradient rtol 1e-5 fp32).
//  3. Bytes in flight. A row takes `lanes` threads (a power of two, 1 to a
//     whole block of 256), each kBatch 16-byte loads deep; at small T the
//     wrapper's geometry splits a row over up to 8 warps, combined through
//     shared memory in warp order, and at small V it packs 256 / lanes rows
//     into a block (the ResNet's V = 10: four lanes a row).
//  4. The label. The lane that loads the label's vector keeps it as it
//     streams past (one compare a batch), so no dependent load follows the
//     row; the backward then rewrites that vector with the label's -1, over
//     its own store of it.
// Every sum runs in a fixed order (per thread, the lanes' butterfly, the
// warps in order), so both kernels are bit-identical from run to run on
// the same inputs at the same offset from a 16-byte boundary (the cut, and
// with it the forward's order of summation, moves with the offset).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // a block; a row takes `lanes` of them
constexpr int kBatch = 4;        // 16-byte vectors a thread loads before one rescale
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x in one MUFU.EX2
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t word(const uint4& u, int k) {
  return k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> struct Elt;

template <> struct Elt<float> {
  static constexpr int N = 4;    // elements a 16-byte vector
  __device__ static float at(const uint4& u, int e) { return __uint_as_float(word(u, e)); }
  template <int K> __device__ static float vmax(const uint4 (&u)[K]) {
    float r = at(u[0], 0);
#pragma unroll
    for (int i = 1; i < K * N; ++i) r = fmaxf(r, at(u[i / N], i % N));
    return r;
  }
  __device__ static uint4 pack(const float (&o)[N]) {
    return make_uint4(__float_as_uint(o[0]), __float_as_uint(o[1]), __float_as_uint(o[2]),
                      __float_as_uint(o[3]));
  }
  __device__ static float store(float x) { return x; }
};

template <> struct Elt<__nv_bfloat16> {
  static constexpr int N = 8;
  // element 2k is the low half of word k, 2k + 1 the high half
  __device__ static float at(const uint4& u, int e) {
    const uint32_t w = word(u, e / 2);
    return __uint_as_float(e % 2 ? w & 0xffff0000u : w << 16);
  }
  template <int K> __device__ static float vmax(const uint4 (&u)[K]) {
    __nv_bfloat162 r = bf2(u[0].x);
#pragma unroll
    for (int i = 1; i < 4 * K; ++i) r = __hmax2(r, bf2(word(u[i / 4], i % 4)));
    return fmaxf(__low2float(r), __high2float(r));
  }
  __device__ static uint4 pack(const float (&o)[N]) {
    return make_uint4(u32(__floats2bfloat162_rn(o[0], o[1])),
                      u32(__floats2bfloat162_rn(o[2], o[3])),
                      u32(__floats2bfloat162_rn(o[4], o[5])),
                      u32(__floats2bfloat162_rn(o[6], o[7])));
  }
  __device__ static __nv_bfloat16 store(float x) { return __float2bfloat16_rn(x); }

 private:
  __device__ static __nv_bfloat162 bf2(uint32_t w) {
    return *reinterpret_cast<__nv_bfloat162*>(&w);
  }
  __device__ static uint32_t u32(__nv_bfloat162 h) { return *reinterpret_cast<uint32_t*>(&h); }
};

// A row cut at its 16-byte boundaries: elements [0, head) one at a time,
// then nvec vectors, then elements [tail0, V) one at a time.
struct Split {
  int head, nvec, tail0;
};

template <typename T>
__device__ __forceinline__ Split split_row(const T* x, int V) {
  constexpr int N = Elt<T>::N;
  const int past = static_cast<int>((reinterpret_cast<uintptr_t>(x) & 15u) / sizeof(T));
  const int head = min(V, (N - past) & (N - 1));
  const int nvec = (V - head) / N;
  return {head, nvec, head + nvec * N};
}

// the label of `row`, or -1 outside [0, V)
__device__ __forceinline__ int label_at(const void* labels, int label_bytes, long long row, int V) {
  const long long y = label_bytes == 8 ? __ldg(static_cast<const long long*>(labels) + row)
                                       : __ldg(static_cast<const int*>(labels) + row);
  return y >= 0 && y < V ? static_cast<int>(y) : -1;
}

// A thread's online logsumexp: the values seen sum to 2^(m log2 e) * l,
// m their max (the exponent m * kLog2e is rounded the same way wherever
// it is formed).
struct Lse {
  float m = -INFINITY, l = 0.f;
};

// m log2(e), rounded once and never fused into a neighbouring add
__device__ __forceinline__ float exponent(float m) { return __fmul_rn(m, kLog2e); }

// e[0] = the sum of e, pairwise: strides W, 2W, ... in a fixed order
template <int K, int W = 1>
__device__ __forceinline__ void pairwise(float (&e)[K]) {
  if constexpr (W < K) {
#pragma unroll
    for (int k = 0; k + W < K; k += 2 * W) e[k] += e[k + W];
    pairwise<K, 2 * W>(e);
  }
}

// take in K values whose max is vmax: one guarded rescale, then one FFMA
// and one EX2 each, summed pairwise
template <int K>
__device__ __forceinline__ void absorb(Lse& s, float vmax, const float (&v)[K]) {
  if (vmax > s.m) {
    s.l *= ex2(exponent(s.m) - exponent(vmax));   // 0 * 0 while nothing was seen
    s.m = vmax;
  }
  if (s.m == -INFINITY) return;          // nothing but -inf so far
  const float c = exponent(s.m);
  float e[K];
#pragma unroll
  for (int k = 0; k < K; ++k) e[k] = ex2(fmaf(v[k], kLog2e, -c));
  pairwise(e);
  s.l += e[0];
}

template <typename T, int K>
__device__ __forceinline__ void absorb_vectors(Lse& s, const uint4 (&u)[K]) {
  constexpr int N = Elt<T>::N;
  float v[K * N];
#pragma unroll
  for (int i = 0; i < K * N; ++i) v[i] = Elt<T>::at(u[i / N], i % N);
  absorb(s, Elt<T>::template vmax<K>(u), v);
}

// Picks at a place known only at run time go through select trees on the
// index's bits: a chain of equality tests is turned into an indexed array,
// which lives in local memory (four 16-byte spills a batch).

// vector b of K, K a power of two
template <int K>
__device__ __forceinline__ uint4 vector_at(const uint4 (&u)[K], int b) {
  if constexpr (K == 1) {
    return u[0];
  } else {
    uint4 half[K / 2];
#pragma unroll
    for (int k = 0; k < K / 2; ++k) half[k] = b & (K / 2) ? u[k + K / 2] : u[k];
    return vector_at(half, b);
  }
}

// element e of a vector
template <typename T>
__device__ __forceinline__ float pick(const uint4& u, int e) {
  constexpr int per_word = Elt<T>::N / 4;
  const int k = e / per_word;
  const uint32_t w = k & 2 ? (k & 1 ? u.w : u.z) : (k & 1 ? u.y : u.x);
  if constexpr (per_word == 1) return __uint_as_float(w);
  else return __uint_as_float(e & 1 ? w & 0xffff0000u : w << 16);
}

// Where the label lies among a row's vectors: `vec` is its vector if this
// lane streams that vector, else INT_MAX; `elem` its place in the vector.
struct LabelSlot {
  int vec, elem;
};

template <typename T>
__device__ __forceinline__ LabelSlot label_slot(int label, const Split& sp, int t, int lanes) {
  constexpr int N = Elt<T>::N;
  if (label < sp.head || label >= sp.tail0) return {INT_MAX, 0};
  const int vec = (label - sp.head) / N;
  return {(vec & (lanes - 1)) == t ? vec : INT_MAX, (label - sp.head) % N};
}

// Keep the label's vector as the batch of K vectors at i streams past:
// one compare a batch, and a select tree once a row.
template <int K>
__device__ __forceinline__ void keep_label(uint4& kept, const uint4 (&u)[K], int i,
                                           const LabelSlot& ls, int lanes_log2) {
  const unsigned d = static_cast<unsigned>(ls.vec - i);
  if (d < (static_cast<unsigned>(K) << lanes_log2))
    kept = vector_at(u, static_cast<int>(d >> lanes_log2));
}

// fold another thread's (mo, lo) into s
__device__ __forceinline__ void merge(Lse& s, float mo, float lo) {
  if (mo > s.m) {
    s.l = s.l * ex2(exponent(s.m) - exponent(mo)) + lo;
    s.m = mo;
  } else if (mo != -INFINITY) {
    s.l += lo * ex2(exponent(mo) - exponent(s.m));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    xent_fwd(const T* __restrict__ logits, const void* __restrict__ labels, int label_bytes,
             float* __restrict__ loss, float* __restrict__ lse, long long Tn, int V,
             int lanes_log2) {
  const int lanes = 1 << lanes_log2;
  const int t = threadIdx.x & (lanes - 1);
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads >> lanes_log2) + (threadIdx.x >> lanes_log2);
  Lse s;
  float picked = 0.f;
  if (row < Tn) {
    const T* x = logits + row * V;
    const int label = label_at(labels, label_bytes, row, V);
    const Split sp = split_row(x, V);
    const int nscalar = sp.head + (V - sp.tail0);
    for (int k = t; k < nscalar; k += lanes) {
      const int j = k < sp.head ? k : sp.tail0 + (k - sp.head);
      const float v[1] = {to_f(x[j])};
      absorb(s, v[0], v);
      if (j == label) picked = v[0];
    }
    const uint4* xv = reinterpret_cast<const uint4*>(x + sp.head);
    const LabelSlot ls = label_slot<T>(label, sp, t, lanes);
    uint4 kept = make_uint4(0u, 0u, 0u, 0u);
    int i = t;
    for (; i + (kBatch - 1) * lanes < sp.nvec; i += kBatch * lanes) {
      uint4 u[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) u[b] = __ldg(xv + i + b * lanes);
      absorb_vectors<T>(s, u);
      keep_label(kept, u, i, ls, lanes_log2);
    }
    for (; i < sp.nvec; i += lanes) {
      const uint4 u[1] = {__ldg(xv + i)};
      absorb_vectors<T>(s, u);
      keep_label(kept, u, i, ls, lanes_log2);
    }
    if (ls.vec != INT_MAX) picked = pick<T>(kept, ls.elem);
  }
  // the row's lanes: a butterfly within the warp (rows packed in a warp
  // sit on aligned groups of `lanes`), then the row's warps in order
  const int width = lanes < 32 ? lanes : 32;
#pragma unroll 1
  for (int off = width >> 1; off > 0; off >>= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, s.m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, s.l, off);
    picked += __shfl_xor_sync(0xffffffffu, picked, off);   // one lane holds it, the rest 0
    merge(s, mo, lo);
  }
  if (lanes > 32) {
    __shared__ float part[kThreads / 32][3];
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      part[warp][0] = s.m;
      part[warp][1] = s.l;
      part[warp][2] = picked;
    }
    __syncthreads();
    if (t == 0)
      for (int w = 1; w < (lanes >> 5); ++w) {
        merge(s, part[warp + w][0], part[warp + w][1]);
        picked += part[warp + w][2];
      }
  }
  if (t == 0 && row < Tn) {
    const float z = (exponent(s.m) + log2f(fmaxf(s.l, 1e-30f))) * kLn2;
    lse[row] = z;
    loss[row] = z - picked;
  }
}

// g_t (p - [v == label]) for the N elements of a vector; `hit` is the
// label's place in it, or -1 (then p - 0 folds to p)
template <typename T>
__device__ __forceinline__ uint4 grad_vector(const uint4& u, float z, float gt, int hit) {
  constexpr int N = Elt<T>::N;
  float o[N];
#pragma unroll
  for (int e = 0; e < N; ++e)
    o[e] = gt * (ex2((Elt<T>::at(u, e) - z) * kLog2e) - (e == hit ? 1.f : 0.f));
  return Elt<T>::pack(o);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    xent_bwd(const T* __restrict__ logits, const void* __restrict__ labels, int label_bytes,
             const float* __restrict__ lse, const float* __restrict__ g, T* __restrict__ dlogits,
             long long Tn, int V, int lanes_log2) {
  const int lanes = 1 << lanes_log2;
  const int t = threadIdx.x & (lanes - 1);
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads >> lanes_log2) + (threadIdx.x >> lanes_log2);
  if (row >= Tn) return;
  const T* x = logits + row * V;
  T* dx = dlogits + row * V;   // at x's offset mod 16: the same cut
  const int label = label_at(labels, label_bytes, row, V);
  const float z = __ldg(lse + row), gt = __ldg(g + row);
  const Split sp = split_row(x, V);
  const int nscalar = sp.head + (V - sp.tail0);
  for (int k = t; k < nscalar; k += lanes) {
    const int j = k < sp.head ? k : sp.tail0 + (k - sp.head);
    const float p = ex2((to_f(x[j]) - z) * kLog2e);
    dx[j] = Elt<T>::store(gt * (p - (j == label ? 1.f : 0.f)));
  }
  const uint4* xv = reinterpret_cast<const uint4*>(x + sp.head);
  uint4* dv = reinterpret_cast<uint4*>(dx + sp.head);
  const LabelSlot ls = label_slot<T>(label, sp, t, lanes);
  uint4 kept = make_uint4(0u, 0u, 0u, 0u);
  int i = t;
  for (; i + (kBatch - 1) * lanes < sp.nvec; i += kBatch * lanes) {
    uint4 u[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) u[b] = __ldg(xv + i + b * lanes);
#pragma unroll
    for (int b = 0; b < kBatch; ++b) dv[i + b * lanes] = grad_vector<T>(u[b], z, gt, -1);
    keep_label(kept, u, i, ls, lanes_log2);
  }
  for (; i < sp.nvec; i += lanes) {
    const uint4 u[1] = {__ldg(xv + i)};
    dv[i] = grad_vector<T>(u[0], z, gt, -1);
    keep_label(kept, u, i, ls, lanes_log2);
  }
  // the label's vector once more, over this lane's own store of it
  if (ls.vec != INT_MAX) dv[ls.vec] = grad_vector<T>(kept, z, gt, ls.elem);
}

template <typename T>
bool launch_ok(long long Tn, long long V, int label_bytes, int lanes, long long blocks,
               const void* logits) {
  if (Tn < 1 || V < 1 || V > INT_MAX || (label_bytes != 4 && label_bytes != 8)) return false;
  if (lanes < 1 || lanes > kThreads || (lanes & (lanes - 1))) return false;
  if (blocks < 1 || blocks > INT_MAX || blocks * (kThreads / lanes) < Tn) return false;
  return reinterpret_cast<uintptr_t>(logits) % sizeof(T) == 0;
}

int log2_of(int lanes) {
  int k = 0;
  while ((1 << k) < lanes) ++k;
  return k;
}

template <typename T>
int launch_fwd(const void* logits, const void* labels, int label_bytes, float* loss, float* lse,
               long long Tn, long long V, int lanes, long long blocks, cudaStream_t st) {
  if (!launch_ok<T>(Tn, V, label_bytes, lanes, blocks, logits)) return cudaErrorInvalidValue;
  xent_fwd<T><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const T*>(logits), labels, label_bytes, loss, lse, Tn, static_cast<int>(V),
      log2_of(lanes));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* logits, const void* labels, int label_bytes, const float* lse,
               const float* g, void* dlogits, long long Tn, long long V, int lanes,
               long long blocks, cudaStream_t st) {
  if (!launch_ok<T>(Tn, V, label_bytes, lanes, blocks, logits)) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(logits) & 15u) != (reinterpret_cast<uintptr_t>(dlogits) & 15u))
    return cudaErrorMisalignedAddress;
  xent_bwd<T><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const T*>(logits), labels, label_bytes, lse, g, static_cast<T*>(dlogits), Tn,
      static_cast<int>(V), log2_of(lanes));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// logits (T, V) fp32 (bf16 = 0) or bf16 (bf16 = 1), rows contiguous;
// labels (T,) of label_bytes 4 (int32) or 8 (int64); loss, lse (T,) fp32.
// lanes (threads a row, a power of two up to 256) and blocks come from
// kernels/fused_xent.py::geometry: 256 / lanes rows a block, blocks of
// them covering T. Launches xent_fwd on `stream`; does not synchronise.
// Returns a cudaError_t (cudaErrorInvalidValue for a geometry or shape the
// kernel does not take).
extern "C" int fused_xent_forward(const void* logits, const void* labels, int label_bytes,
                                  float* loss, float* lse, long long Tn, long long V, int bf16,
                                  int lanes, long long blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<__nv_bfloat16>(logits, labels, label_bytes, loss, lse, Tn, V, lanes,
                                          blocks, st)
              : launch_fwd<float>(logits, labels, label_bytes, loss, lse, Tn, V, lanes, blocks,
                                  st);
}

// g (T,) fp32: the loss cotangent; dlogits like logits, at the logits'
// offset from a 16-byte boundary (else cudaErrorMisalignedAddress).
// Launches xent_bwd on `stream`; does not synchronise.
extern "C" int fused_xent_backward(const void* logits, const void* labels, int label_bytes,
                                   const float* lse, const float* g, void* dlogits, long long Tn,
                                   long long V, int bf16, int lanes, long long blocks,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd<__nv_bfloat16>(logits, labels, label_bytes, lse, g, dlogits, Tn, V,
                                          lanes, blocks, st)
              : launch_bwd<float>(logits, labels, label_bytes, lse, g, dlogits, Tn, V, lanes,
                                  blocks, st);
}

extern "C" const char* fused_xent_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
