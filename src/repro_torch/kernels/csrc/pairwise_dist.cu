// K2 on Hopper: pairwise Euclidean distances within each client, forward
// and backward.
//
// Replaces the Pallas kernel src/repro/kernels/dcor.py::pairwise_dist (body
// _dist_kernel), which computes one (bb, bb) distance tile per grid step as
// sqrt(max(|x_i|^2 + |x_j|^2 - 2 x_i.x_j, 1e-12)) with one matrix-unit
// product per tile. The Pallas kernel has no VJP: the JAX package trains
// through jnp and autodiff. Here the input carries a leading client axis,
//   forward:  x (C, B, F) fp32 -> D (C, B, B) fp32,
//             D_ij = sqrt(max(G_ii + G_jj - 2 G_ij, 1e-12)), G = x x^T,
//   backward: (x, D, gD) -> gx (C, B, F) fp32,
//             H = 0.5 gD / D where D > sqrt(1e-12) and i != j (else 0),
//             S = H + H^T, gx = 2 (diag(rowsum S) - S) x.
// The plain versions are src/repro_torch/kernels/ref.py::pairwise_dist_ref
// and ::pairwise_dist_bwd_ref.
//
// Bound. On the dcor path B is the batch (32) and F is 3,072 (images) or up
// to 65,536 (the stage-1 activation of ResNet-56); a transformer with dcor
// would give (4, 4, 491,520). The upper triangle of the Gram costs B(B+1)
// fp32 operations per 4B bytes read: 8.25 per byte at B = 32, 1.25 at
// B = 4, both under the H100's fp32 ridge (67e12 / 3.35e12 = 20). The
// backward reads x and writes gx once. Both are bound by bytes, so both
// stream x through shared memory once, at HBM rate, on fp32 FMA (no tensor
// cores: TF32 would break fp32 parity, and plain FMA keeps the symmetry and
// identical-row contracts below simple).
//
// Forward design: one launch.
// * Tiles sized by B. A mode picks the row tile from B: 4, 8, 16 or 32
//   rows (one tile, B <= tile), or, for B > 32, tiles of 16 rows over the
//   tile pairs ti <= tj only. A block never multiplies more than a few
//   padding rows.
// * Upper triangle only. The tile's entries i <= j are cut into warp tasks
//   of about 64 entries each, every task a register micro-tile: OFF, an 8 x
//   8 block of two row groups (16 rows read a column); TRI, the triangle of
//   one row group; TRI2, the triangles of two row groups (16 rows, 72
//   entries). B = 32 is six OFF and two TRI2 tasks, one a warp: 528 FMAs a
//   column, the triangle's own count; D_ij and D_ji are written from the
//   same value, so D is exactly symmetric.
// * One streaming pass. F is split over one wave of blocks (as many as
//   fit on the card: one an SM at B = 16 and 32, two at B <= 8). Each
//   block stages its rows in 32 KB stages of a three-stage ring fed by
//   16-byte cp.async (two stages, 64 KB, in flight while one is used). A
//   diagonal tile stages its rows once. Each lane of a task's warps owns
//   every 32nd float2 column of a stage and sums its products with fmaf in
//   column order; one LDS.64 feeds 8 (TRI2) to 16 (OFF) FMAs, and a
//   warp's LDS.64 reads 256 contiguous bytes.
// * Fixed-order reductions. Lanes reduce by a butterfly over the lane bits
//   4..0 (transposing: each step halves the entries a lane holds), the
//   warps of a task in warp order, then the block writes its partial tile
//   to a workspace (C, pairs, splits, entries). The last block to finish a
//   (client, tile pair) takes a ticket (every thread fences its stores,
//   then one atomicAdd on a counter), copies the partials into its ring
//   (up to 96 KB in flight) and sums them in split order.
//   For B <= 32 it then applies the distance epilogue; for B > 32 it writes
//   the pair's Gram entries into the output and takes a second ticket per
//   client, whose last holder applies the epilogue to the whole client.
//   Each holder resets its counter, so the counters stay zero between
//   launches and the kernel replays inside a CUDA graph. Two launches that
//   share the counters must not overlap: the port runs K2 on one stream at
//   a time.
// * Every Gram entry, the diagonal included, is summed in one order: the
//   same columns per lane, the same butterfly, the same warp and split
//   order. So the norms are the Gram's own diagonal: D_ii is exactly
//   sqrt(1e-12) and identical rows are exactly sqrt(1e-12) apart. No float
//   atomics: reruns are bit-identical.
//
// Backward design. gx = 2 W x per client, W = diag(rowsum S) - S (B x B).
// One wave of blocks (two an SM), each owning a client and every
// gridDim.x-th strip of columns. When B <= 32 a prologue builds W once in
// shared memory while the ring's first stages load: H from coalesced loads
// of D and gD, S = H + H^T, its row sums in j order; for B > 32 the row
// sums come from a warp each (a fixed shuffle tree) and W is rebuilt for
// each 32 x 32 tile pair. x streams through a ring of 32 KB stages like
// the forward's (B rows of a strip, or one 32-row tile of them); each
// thread owns a register tile of a float4 of columns times 8 (or 4) output
// rows, reads W as broadcast LDS.128 and stores gx with 16-byte stores.
// Each output sums its j terms in order.
//
// Build without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                 // the backward's block: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStageFloats = 8192;            // 32 KB a ring stage
// the forward: threads a block, blocks an SM (at least) and ring depth.
// One block an SM, so the B = 32 kernel may hold 140 registers with its
// column loop unrolled twice, and F is cut into half as many splits for
// the finisher; the kernels of B <= 8 stay small enough for two.
constexpr int kFwdThreads = 256;
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kFwdBlocks = 1;
constexpr int kFwdStages = 3;
constexpr int kFwdRingFloats = kFwdStages * kStageFloats;
// the backward: two blocks an SM, each a three-stage ring (96 KB)
constexpr int kBwdStages = 3;
constexpr int kBwdRingBytes = kBwdStages * kStageFloats * 4;
constexpr int kCross = 0;                     // the mode of B > 32
constexpr int kCrossTile = 16;                // forward rows per tile when B > 32
constexpr int kBwdTile = 32;                  // backward rows per tile when B > 32
constexpr int64_t kMaxB = 255 * 32;

enum TaskKind { kOff, kTri, kTri2 };

__host__ __device__ constexpr int tri_count(int r) { return r * (r + 1) / 2; }

// The forward's layout for mode kMode (4, 8, 16, 32: one tile of that many
// rows; kCross: 16-row tiles, the rows of tile ti then of tile tj staged).
template <int kMode>
struct Fwd {
  static constexpr int kTile = kMode == kCross ? kCrossTile : kMode;
  static constexpr int kRows = kMode == kCross ? 2 * kCrossTile : kMode;  // staged rows
  static constexpr int kKT = kStageFloats / kRows;                        // columns a stage
  static constexpr int kR = kMode == 4 ? 4 : 8;                           // row group
  static constexpr int kTasks = kMode == 32 ? 8 : kMode == 16 ? 2 : kMode == kCross ? 4 : 1;
  static constexpr int kQ = kFwdWarps / kTasks;             // warps a task
  static constexpr int kSteps = kKT / 2 / (kQ * 32);        // float2 columns a lane a stage
  static constexpr int kAcc = kMode == kCross ? 64 : kMode == 4 ? tri_count(4)
                              : kMode == 8 ? tri_count(8) : 2 * tri_count(8);
  static constexpr int kEntries = kMode == 32 ? 6 * 64 + 2 * 72 : kMode == 16 ? 64 + 72
                                  : kMode == kCross ? 4 * 64 : tri_count(kR);
  static constexpr int kWsRow = (kEntries + 3) / 4 * 4;     // a split's partials, 16-byte rows
  static constexpr int kPerPass = kFwdRingFloats / kWsRow;  // splits the finisher stages at once
  static constexpr int kMine = (kEntries + kFwdThreads - 1) / kFwdThreads;  // entries a thread sums
  static_assert(kKT % (2 * kQ * 32) == 0, "a stage is whole float2 columns of every lane");
};

// A warp task: its kind, the staged rows of its groups (sa, sb), which are
// also their first rows in tile ti (sa) and, but for B > 32, tile tj (jb).
struct Task {
  int kind, sa, sb, jb;
};

template <int kMode>
__device__ __forceinline__ Task task_of(int t, bool diag) {
  if constexpr (kMode == 32) {
    // six 8 x 8 blocks above the diagonal, (ga, gb) = (0, 1) (0, 2) (0, 3)
    // (1, 2) (1, 3) (2, 3), then the four triangles in pairs (0, 3) (1, 2):
    // two bits a task, packed so that no table is indexed at run time
    constexpr int kGa = 0x4940, kGb = 0xbfb9;
    const int ga = (kGa >> (2 * t)) & 3, gb = (kGb >> (2 * t)) & 3;
    return {t < 6 ? kOff : kTri2, 8 * ga, 8 * gb, 8 * gb};
  } else if constexpr (kMode == 16) {
    return {t == 0 ? kOff : kTri2, 0, 8, 8};
  } else if constexpr (kMode == kCross) {
    const int jb = 8 * (t & 1);
    return {kOff, 8 * (t >> 1), (diag ? 0 : kCrossTile) + jb, jb};
  } else {
    return {kTri, 0, 0, 0};
  }
}

// (task, entry) of the block's idx-th entry: tasks in order, entries in
// order within each.
template <int kMode>
__device__ __forceinline__ void split_idx(int idx, int& t, int& e) {
  if constexpr (kMode == 32) {
    t = idx < 384 ? idx / 64 : 6 + (idx - 384) / 72;
    e = idx < 384 ? idx % 64 : (idx - 384) % 72;
  } else if constexpr (kMode == 16) {
    t = idx < 64 ? 0 : 1;
    e = idx < 64 ? idx : idx - 64;
  } else if constexpr (kMode == kCross) {
    t = idx / 64;
    e = idx % 64;
  } else {
    t = 0;
    e = idx;
  }
}

// Entry e of a triangle: e = v (v + 1) / 2 + u with u <= v.
__device__ __forceinline__ void tri_uv(int e, int& u, int& v) {
  v = 0;
  while (tri_count(v + 1) <= e) ++v;
  u = e - tri_count(v);
}

// Tile coordinates (i in tile ti, j in tile tj) of entry e of task t.
template <int kMode>
__device__ __forceinline__ void entry_ij(int t, int e, int& i, int& j) {
  const Task k = task_of<kMode>(t, true);
  int u, v;
  if (k.kind == kOff) {
    i = k.sa + e / 8;
    j = k.jb + e % 8;
  } else if (k.kind == kTri) {
    tri_uv(e, u, v);
    i = k.sa + u;
    j = k.sa + v;
  } else {  // two triangles: group a's 36 entries, then group b's
    const int base = e < 36 ? k.sa : k.jb;
    tri_uv(e < 36 ? e : e - 36, u, v);
    i = base + u;
    j = base + v;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void fma2(float& acc, const float2& a, const float2& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
}

// One float2 column of a triangle (columns col, col + 1):
// acc[v (v + 1) / 2 + u] += row u . row v. Two columns at a time keep the
// operands at 2 registers a row.
template <int R, int kKT>
__device__ __forceinline__ void tri_step(float* acc, const float* s, int col) {
  float2 a[R];
#pragma unroll
  for (int u = 0; u < R; ++u) a[u] = ld2(s + u * kKT + col);
#pragma unroll
  for (int v = 0; v < R; ++v)
#pragma unroll
    for (int u = 0; u <= v; ++u) fma2(acc[tri_count(v) + u], a[u], a[v]);
}

// One float2 column of an 8 x 8 block: acc[u * 8 + v] += row a_u . row b_v.
template <int kKT>
__device__ __forceinline__ void off_step(float* acc, const float* sa, const float* sb, int col) {
  float2 a[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) a[u] = ld2(sa + u * kKT + col);
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const float2 b = ld2(sb + v * kKT + col);
#pragma unroll
    for (int u = 0; u < 8; ++u) fma2(acc[u * 8 + v], a[u], b);
  }
}

// Sum over the 32 lanes of acc[0, N), N = 32 m: a butterfly over the lane
// bits 4..0 (O = 16, 8, ..., 1) that halves the entries a lane holds at
// each step, so lane l ends with entries m l + r in acc[r], r < m. Each
// entry is summed by the tree of warp_sum below (pairs differing in bit 4,
// then in bit 3, ...). A template recursion, so that every index of acc is
// a constant and the array stays in registers.
template <int N, int O = 16>
__device__ __forceinline__ void lane_reduce_transpose(float* acc, int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int e = 0; e < N / 2; ++e) {
    const float lo = acc[e], hi = acc[e + N / 2];
    acc[e] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, O);
  }
  if constexpr (O > 1) lane_reduce_transpose<N / 2, O / 2>(acc, lane);
}

// All lanes return the same sum: each step adds two partials that the
// partner lane adds in the other order, and float addition commutes.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Reduce a task's N entries over the lanes and store them to red[0, N).
template <int N>
__device__ __forceinline__ void reduce_store(float* acc, float* red, int lane) {
  constexpr int m = N / 32, rest = N - 32 * m;
  if constexpr (m > 0) {
    lane_reduce_transpose<32 * m>(acc, lane);
#pragma unroll
    for (int r = 0; r < m; ++r) red[m * lane + r] = acc[r];
  }
#pragma unroll
  for (int r = 0; r < rest; ++r) {
    const float v = warp_sum(acc[32 * m + r]);
    if (lane == 0) red[32 * m + r] = v;
  }
}

__device__ __forceinline__ float dist_of(float gii, float gjj, float gij) {
  const float d2 = gii + gjj - 2.f * gij;
  return sqrtf(isnan(d2) ? d2 : fmaxf(d2, 1e-12f));
}

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

// Stage rows [0, nrows) x columns [k0, k0 + kCols) of a (., F) matrix into
// s[row * kCols + col]: row r comes from rowp[r] (nullptr: zeros), columns
// at or past kend are zeros. kVec: F % 4 == 0 and x 16-byte aligned, so a
// float4 is all in or all out of a row.
template <int kCols, bool kVec, int kNT>
__device__ __forceinline__ void stage_rows(float* s, const float* const* rowp, int nrows,
                                           int64_t k0, int64_t kend, const float* any) {
  if constexpr (kVec) {
    constexpr int per_row = kCols / 4;
    for (int idx = threadIdx.x; idx < nrows * per_row; idx += kNT) {
      const int r = idx / per_row, c4 = idx % per_row;
      const int64_t k = k0 + 4 * c4;
      const float* src = rowp[r];
      const int64_t left = kend - k;
      const int bytes = src == nullptr || left <= 0 ? 0 : left >= 4 ? 16 : 4 * static_cast<int>(left);
      cp_async16(s + r * kCols + 4 * c4, bytes ? src + k : any, bytes);
    }
  } else {
    for (int idx = threadIdx.x; idx < nrows * kCols; idx += kNT) {
      const int r = idx / kCols, c = idx % kCols;
      const int64_t k = k0 + c;
      const float* src = rowp[r];
      const int bytes = src != nullptr && k < kend ? 4 : 0;
      cp_async4(s + r * kCols + c, bytes ? src + k : any, bytes);
    }
  }
}

// Forward. grid (splits * pairs, C); block kFwdThreads; dynamic shared memory
// kFwdRingFloats floats. ws: (C, pairs, splits, kWsRow) partial Grams; counters:
// C * pairs (+ C when pairs > 1) ints, zero at launch and left zero.
template <int kMode, bool kVec>
__global__ void __launch_bounds__(kFwdThreads, kFwdBlocks)
pdist_fwd(const float* __restrict__ x, float* __restrict__ out, float* __restrict__ ws,
          int* __restrict__ counters, int64_t B, int64_t F, int64_t chunk, int splits,
          int pairs) {
  using L = Fwd<kMode>;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  __shared__ const float* rowp[L::kRows];
  __shared__ int last;

  const int split = blockIdx.x % splits, p = blockIdx.x / splits;
  const int64_t c = blockIdx.y, C = gridDim.y;
  const float* xc = x + c * B * F;
  int ti = 0, tj = 0;  // p-th pair ti <= tj, row-major over the upper triangle
  if constexpr (kMode == kCross) {
    const int T = static_cast<int>((B + L::kTile - 1) / L::kTile);
    int q = p;
    while (q >= T - ti) q -= T - ti++;
    tj = ti + q;
  }
  const bool diag = ti == tj;
  if (threadIdx.x < L::kRows) {
    const int r = threadIdx.x;
    int64_t row = r;
    if constexpr (kMode == kCross)
      row = r < L::kTile ? ti * L::kTile + r : diag ? B : tj * L::kTile + r - L::kTile;
    rowp[r] = row < B ? xc + row * F : nullptr;
  }
  __syncthreads();

  const int64_t kbeg = split * chunk;
  const int64_t kend = kbeg + chunk < F ? kbeg + chunk : F;
  const int nst = static_cast<int>((kend - kbeg + L::kKT - 1) / L::kKT);
  const int nrows = kMode == kCross && diag ? L::kTile : L::kRows;
  auto load = [&](int n) {
    stage_rows<L::kKT, kVec, kFwdThreads>(ring + (n % kFwdStages) * kStageFloats, rowp, nrows,
                             kbeg + static_cast<int64_t>(n) * L::kKT, kend, x);
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = warp / L::kQ, q = warp % L::kQ;
  const Task task = task_of<kMode>(t, diag);
  float acc[L::kAcc];
#pragma unroll
  for (int e = 0; e < L::kAcc; ++e) acc[e] = 0.f;

#pragma unroll
  for (int n = 0; n < kFwdStages - 1; ++n) {
    if (n < nst) load(n);
    cp_commit();
  }
  for (int n = 0; n < nst; ++n) {
    cp_wait<kFwdStages - 2>();
    __syncthreads();  // stage n is in; everyone is done with stage n - 1
    if (n + kFwdStages - 1 < nst) load(n + kFwdStages - 1);
    cp_commit();
    const float* s = ring + (n % kFwdStages) * kStageFloats;
    // the lane's float2 columns in order (a warp's LDS.64 reads 256
    // contiguous bytes), two at a time
#pragma unroll 2
    for (int m = 0; m < L::kSteps; ++m) {
      const int col = 2 * (lane + 32 * (q + L::kQ * m));
      if constexpr (kMode == 4 || kMode == 8) {
        tri_step<L::kR, L::kKT>(acc, s, col);
      } else {
        if (task.kind == kOff) {
          off_step<L::kKT>(acc, s + task.sa * L::kKT, s + task.sb * L::kKT, col);
        } else if constexpr (kMode != kCross) {  // TRI2
          tri_step<8, L::kKT>(acc, s + task.sa * L::kKT, col);
          tri_step<8, L::kKT>(acc + 36, s + task.sb * L::kKT, col);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free

  // lanes, then the task's warps in order, into ws
  float* red = ring;  // kFwdWarps x 72
  if constexpr (kMode == 4 || kMode == 8) {
    reduce_store<L::kAcc>(acc, red + warp * 72, lane);
  } else {
    if (task.kind == kOff)
      reduce_store<64>(acc, red + warp * 72, lane);
    else if constexpr (kMode != kCross)
      reduce_store<72>(acc, red + warp * 72, lane);
  }
  __syncthreads();
  const int64_t pair_base = (c * pairs + p) * splits;
  for (int idx = threadIdx.x; idx < L::kEntries; idx += kFwdThreads) {
    int tt, e;
    split_idx<kMode>(idx, tt, e);
    float v = red[(tt * L::kQ) * 72 + e];
#pragma unroll
    for (int w = 1; w < L::kQ; ++w) v += red[(tt * L::kQ + w) * 72 + e];
    ws[(pair_base + split) * L::kWsRow + idx] = v;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&counters[c * pairs + p], 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the pair's last block: its Gram entries, the partials in split order,
  // staged through the ring (up to 96 KB of them in flight at once)
  float g[L::kMine];
#pragma unroll
  for (int r = 0; r < L::kMine; ++r) g[r] = 0.f;
  const float* part = ws + pair_base * L::kWsRow;
  for (int s0 = 0; s0 < splits; s0 += L::kPerPass) {
    const int n = splits - s0 < L::kPerPass ? splits - s0 : L::kPerPass;
    for (int q4 = threadIdx.x; q4 < n * L::kWsRow / 4; q4 += kFwdThreads)
      cp_async16(ring + 4 * q4, part + static_cast<int64_t>(s0) * L::kWsRow + 4 * q4, 16);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    for (int s = 0; s < n; ++s)
#pragma unroll
      for (int r = 0; r < L::kMine; ++r) {
        const int idx = threadIdx.x + r * kFwdThreads;
        if (idx < L::kEntries) g[r] += ring[s * L::kWsRow + idx];
      }
    __syncthreads();  // the ring is read before the next pass overwrites it
  }
  float* gt = ring + kFwdWarps * 72;  // B <= 32: the tile's Gram, gt[i * kTile + j] (i <= j)
  float* out_c = out + c * B * B;
  int ei[L::kMine], ej[L::kMine];  // the tile coordinates of each entry
#pragma unroll
  for (int r = 0; r < L::kMine; ++r) {
    const int idx = threadIdx.x + r * kFwdThreads;
    if (idx >= L::kEntries) break;
    int tt, e, i, j;
    split_idx<kMode>(idx, tt, e);
    entry_ij<kMode>(tt, e, i, j);
    ei[r] = i;
    ej[r] = j;
    if constexpr (kMode == kCross) {
      const int64_t gi = ti * L::kTile + i, gj = tj * L::kTile + j;
      if (gi <= gj && gj < B) out_c[gi * B + gj] = g[r];
    } else {
      gt[i * L::kTile + j] = g[r];
    }
  }
  if constexpr (kMode == kCross) {
    float* sq = ring;  // the client's squared norms, B floats
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      counters[c * pairs + p] = 0;
      last = atomicAdd(&counters[C * pairs + c], 1) == pairs - 1;
      if (last) counters[C * pairs + c] = 0;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int64_t i = threadIdx.x; i < B; i += kFwdThreads) sq[i] = __ldcg(out_c + i * B + i);
    __syncthreads();
    // D for i <= j, written to (i, j) and (j, i) from the one value
    for (int64_t idx = threadIdx.x; idx < B * B; idx += kFwdThreads) {
      const int64_t i = idx / B, j = idx % B;
      if (i > j) continue;
      const float d = dist_of(sq[i], sq[j], __ldcg(out_c + idx));
      out_c[i * B + j] = d;
      out_c[j * B + i] = d;
    }
  } else {
    __syncthreads();  // gt is complete
    if (threadIdx.x == 0) counters[c * pairs + p] = 0;
    // each thread's own entries i <= j: D written to (i, j) and (j, i)
#pragma unroll
    for (int r = 0; r < L::kMine; ++r) {
      if (threadIdx.x + r * kFwdThreads >= L::kEntries) break;
      const int i = ei[r], j = ej[r];
      if (j >= B) continue;
      const float d = dist_of(gt[i * L::kTile + i], gt[j * L::kTile + j], g[r]);
      out_c[i * B + j] = d;
      out_c[j * B + i] = d;
    }
  }
}

// H[i, j] of the backward: 0.5 gD / D where the clamp let d2 through.
__device__ __forceinline__ float half_grad(const float* __restrict__ dc,
                                           const float* __restrict__ gc, int64_t B,
                                           int64_t i, int64_t j, float dmin) {
  if (i == j) return 0.f;
  const float d = dc[i * B + j], g = gc[i * B + j];  // both loads in flight together
  return d > dmin ? __fdiv_rn(0.5f * g, d) : 0.f;
}

// Backward. grid (blocks per client, C); block 256; dynamic shared memory
// kBwdRingBytes + kRows^2 floats + B floats (B > 32) or kRows (kRows + 2)
// floats (B <= 32). kMode: 4, 8, 16, 32 (B <= kMode) or
// kCross (32-row tiles).
template <int kMode, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
pdist_bwd(const float* __restrict__ x, const float* __restrict__ dist,
          const float* __restrict__ gdist, float* __restrict__ gx, int64_t B, int64_t F) {
  constexpr int kRows = kMode == kCross ? kBwdTile : kMode;  // rows of x a stage
  constexpr int kKB = kStageFloats / kRows;                  // columns a stage
  constexpr int kG = kRows == 4 ? 4 : 8;                     // output rows a thread
  constexpr int kNC = kThreads / (kRows / kG);               // threads a row group
  constexpr int kV = kKB / 4 / kNC;                          // float4 columns a thread
  static_assert(kV >= 1 && kKB % (4 * kNC) == 0, "whole float4 columns a thread");
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* wt = ring + kBwdStages * kStageFloats;   // wt[j][i] = W[i0 + i, j0 + j]
  float* rowsum = wt + kRows * kRows;
  __shared__ const float* rowp[kRows];

  const int64_t c = blockIdx.y;
  const float* dc = dist + c * B * B;
  const float* gc = gdist + c * B * B;
  const float* xc = x + c * B * F;
  float* oc = gx + c * B * F;
  const float dmin = sqrtf(1e-12f);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int T = static_cast<int>((B + kRows - 1) / kRows);
  const int64_t strips = (F + kKB - 1) / kKB;
  const int64_t mine = (strips - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int64_t nst = mine * T * T;  // steps: (strip, i tile, j tile), j innermost

  // the rows of step n's j tile; all steps of a block share them when T == 1
  auto set_rows = [&](int jt) {
    if (threadIdx.x < kRows) {
      const int64_t row = static_cast<int64_t>(jt) * kRows + threadIdx.x;
      rowp[threadIdx.x] = row < B ? xc + row * F : nullptr;
    }
  };
  auto load = [&](int64_t n) {
    const int64_t strip = blockIdx.x + (n / (T * T)) * gridDim.x;
    stage_rows<kKB, kVec, kThreads>(ring + (n % kBwdStages) * kStageFloats, rowp, kRows, strip * kKB,
                          F, x);
  };
  auto fill_w = [&](int it, int jt) {
    for (int idx = threadIdx.x; idx < kRows * kRows; idx += kThreads) {
      const int jj = idx / kRows, ii = idx % kRows;
      const int64_t i = static_cast<int64_t>(it) * kRows + ii, j = static_cast<int64_t>(jt) * kRows + jj;
      float w = 0.f;
      if (i < B && j < B)
        w = i == j ? rowsum[i]
                   : -(half_grad(dc, gc, B, i, j, dmin) + half_grad(dc, gc, B, j, i, dmin));
      wt[jj * kRows + ii] = w;
    }
  };

  set_rows(0);
  __syncthreads();
  if (T == 1) {
    // the stages in flight while W is built: H from coalesced loads (D
    // and gD together), S = H + H^T in shared memory, its row sums as
    // column sums (S is exactly symmetric: float addition commutes), in j
    // order; W is symmetric too, so wt needs no transpose
    constexpr int kLd = kRows + 1;  // hs row stride: column reads hit 32 banks
    float* hs = rowsum + kRows;
#pragma unroll
    for (int n = 0; n < kBwdStages - 1; ++n) {
      if (n < nst) load(n);
      cp_commit();
    }
#pragma unroll
    for (int r = 0; r < (kRows * kRows + kThreads - 1) / kThreads; ++r) {
      const int idx = threadIdx.x + r * kThreads;
      const int i = idx / kRows, j = idx % kRows;
      if (idx < kRows * kRows) hs[i * kLd + j] = i < B && j < B ? half_grad(dc, gc, B, i, j, dmin) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < (kRows * kRows + kThreads - 1) / kThreads; ++r) {
      const int idx = threadIdx.x + r * kThreads;
      const int i = idx / kRows, j = idx % kRows;
      if (idx < kRows * kRows) wt[idx] = hs[i * kLd + j] + hs[j * kLd + i];
    }
    __syncthreads();
    if (threadIdx.x < kRows) {
      float p = 0.f;
#pragma unroll
      for (int j = 0; j < kRows; ++j) p += wt[j * kRows + threadIdx.x];
      rowsum[threadIdx.x] = p;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < (kRows * kRows + kThreads - 1) / kThreads; ++r) {
      const int idx = threadIdx.x + r * kThreads;
      if (idx < kRows * kRows) wt[idx] = idx / kRows == idx % kRows ? rowsum[idx / kRows] : -wt[idx];
    }
  } else {
    for (int64_t i = warp; i < B; i += kWarps) {
      float p = 0.f;
      for (int64_t j = lane; j < B; j += 32)
        p += half_grad(dc, gc, B, i, j, dmin) + half_grad(dc, gc, B, j, i, dmin);
      p = warp_sum(p);
      if (lane == 0) rowsum[i] = p;
    }
  }

  const int rg = threadIdx.x / kNC, col = threadIdx.x % kNC;
  float4 acc[kV][kG];
#pragma unroll
  for (int v = 0; v < kV; ++v)
#pragma unroll
    for (int u = 0; u < kG; ++u) acc[v][u] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int64_t n = 0; n < nst; ++n) {
    const int jt = static_cast<int>(n % T), it = static_cast<int>((n / T) % T);
    if (T > 1) {  // B > 32: one stage at a time, W's tile rebuilt for each
      __syncthreads();  // everyone is done with the last stage and tile
      set_rows(jt);
      __syncthreads();
      load(n);
      cp_commit();
      fill_w(it, jt);
      cp_wait<0>();
    } else {
      cp_wait<kBwdStages - 2>();
    }
    __syncthreads();  // stage n is in; everyone is done with stage n - 1
    if (T == 1) {
      if (n + kBwdStages - 1 < nst) load(n + kBwdStages - 1);
      cp_commit();
    }
    const float* s = ring + (n % kBwdStages) * kStageFloats;
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const int c4 = col + v * kNC;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float4 xv = ld4(s + j * kKB + 4 * c4);
#pragma unroll
        for (int u4 = 0; u4 < kG / 4; ++u4) {
          const float4 w = ld4(wt + j * kRows + rg * kG + 4 * u4);  // a broadcast
          const float wu[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float4& a = acc[v][4 * u4 + r];
            a.x = fmaf(wu[r], xv.x, a.x);
            a.y = fmaf(wu[r], xv.y, a.y);
            a.z = fmaf(wu[r], xv.z, a.z);
            a.w = fmaf(wu[r], xv.w, a.w);
          }
        }
      }
    }
    if (jt == T - 1) {  // the i tile's outputs are complete
      const int64_t strip = blockIdx.x + (n / (T * T)) * gridDim.x;
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const int64_t f = strip * kKB + 4 * (col + v * kNC);
#pragma unroll
        for (int u = 0; u < kG; ++u) {
          const int64_t i = static_cast<int64_t>(it) * kRows + rg * kG + u;
          const float4 a = acc[v][u];
          const float4 o = make_float4(2.f * a.x, 2.f * a.y, 2.f * a.z, 2.f * a.w);
          acc[v][u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (i >= B || f >= F) continue;
          float* dst = oc + i * F + f;
          if (kVec && f + 4 <= F) {
            *reinterpret_cast<float4*>(dst) = o;
          } else {
            const float e[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
            for (int m = 0; m < 4; ++m)
              if (f + m < F) dst[m] = e[m];
          }
        }
      }
    }
  }
  cp_wait<0>();
}

bool dims_ok(long long C, long long B, long long F) {
  return C > 0 && C <= 65535 && B > 0 && B <= kMaxB && F > 0;
}

int fwd_mode(long long B) { return B <= 4 ? 4 : B <= 8 ? 8 : B <= 16 ? 16 : B <= 32 ? 32 : kCross; }

template <int kMode>
long long fwd_pairs(long long B) {
  if (kMode != kCross) return 1;
  const long long T = (B + kCrossTile - 1) / kCrossTile;
  return T * (T + 1) / 2;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

constexpr int kFwdSmem = kFwdRingFloats * 4;  // the forward's dynamic shared memory

template <int kMode>
constexpr int bwd_smem_max() {
  constexpr int kRows = kMode == kCross ? kBwdTile : kMode;
  return kBwdRingBytes + (kRows * kRows + static_cast<int>(kMaxB)) * static_cast<int>(sizeof(float));
}

template <int kMode>
size_t bwd_smem(long long B) {
  // the ring, wt, the row sums and (B <= 32) H with padded rows
  constexpr int kRows = kMode == kCross ? kBwdTile : kMode;
  static_assert(kRows + kRows * (kRows + 1) <= kMaxB, "the limit covers H's tile");
  return kBwdRingBytes +
         (kRows * kRows + (B > kRows ? B : kRows + kRows * (kRows + 1))) * sizeof(float);
}

template <int kMode, bool kVec>
int launch_fwd(const float* x, float* out, float* ws, long long ws_floats, int* counters,
               long long n_counters, long long C, long long B, long long F, long long chunk,
               long long splits, cudaStream_t st) {
  using L = Fwd<kMode>;
  const long long pairs = fwd_pairs<kMode>(B);
  if (chunk <= 0 || chunk % L::kKT != 0 || splits != (F + chunk - 1) / chunk ||
      splits * pairs > 0x7fffffffLL || ws_floats < C * pairs * splits * L::kWsRow ||
      n_counters < C * pairs + (pairs > 1 ? C : 0))
    return cudaErrorInvalidValue;
  // once per instantiation, at the first call (before any CUDA-graph
  // capture; the port drives one device)
  static const cudaError_t attr = cudaFuncSetAttribute(
      pdist_fwd<kMode, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>(splits * pairs), static_cast<unsigned>(C));
  pdist_fwd<kMode, kVec><<<grid, kFwdThreads, kFwdSmem, st>>>(
      x, out, ws, counters, B, F, chunk, static_cast<int>(splits), static_cast<int>(pairs));
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int launch_fwd_vec(bool vec, const float* x, float* out, float* ws, long long ws_floats,
                   int* counters, long long n_counters, long long C, long long B, long long F,
                   long long chunk, long long splits, cudaStream_t st) {
  return vec ? launch_fwd<kMode, true>(x, out, ws, ws_floats, counters, n_counters, C, B, F,
                                       chunk, splits, st)
             : launch_fwd<kMode, false>(x, out, ws, ws_floats, counters, n_counters, C, B, F,
                                        chunk, splits, st);
}

template <int kMode, bool kVec>
int launch_bwd(const float* x, const float* dist, const float* gdist, float* gx, long long C,
               long long B, long long F, cudaStream_t st) {
  constexpr int kRows = kMode == kCross ? kBwdTile : kMode;
  constexpr int kKB = kStageFloats / kRows;
  const size_t smem = bwd_smem<kMode>(B);
  static const cudaError_t attr = cudaFuncSetAttribute(
      pdist_bwd<kMode, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, bwd_smem_max<kMode>());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // one wave: as many blocks as fit on the card at once, shared by the
  // clients, and no more than there are strips
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pdist_bwd<kMode, kVec>,
                                                        kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long strips = (F + kKB - 1) / kKB;
  long long bx = static_cast<long long>(sms) * per_sm / C;  // rounded down: no straggler wave
  bx = bx < 1 ? 1 : (bx > strips ? strips : bx);
  pdist_bwd<kMode, kVec><<<dim3(static_cast<unsigned>(bx), static_cast<unsigned>(C)), kThreads,
                           smem, st>>>(x, dist, gdist, gx, B, F);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int launch_bwd_vec(bool vec, const float* x, const float* dist, const float* gdist, float* gx,
                   long long C, long long B, long long F, cudaStream_t st) {
  return vec ? launch_bwd<kMode, true>(x, dist, gdist, gx, C, B, F, st)
             : launch_bwd<kMode, false>(x, dist, gdist, gx, C, B, F, st);
}

}  // namespace

// x: (C, B, F) fp32 contiguous; out: (C, B, B) fp32; ws: ws_floats fp32 of
// scratch, 16-byte aligned, at least C * pairs * splits * the entries
// rounded up to 4 (kernels/dcor.py's forward_plan); counters: n_counters ints, zero, at least C * pairs (+ C
// when pairs > 1). chunk: columns of F per split, a positive multiple of
// the mode's stage width; splits = ceil(F / chunk). Launches pdist_fwd once
// on `stream`, which must belong to the calling thread's current device,
// and does not synchronise. Returns a cudaError_t.
extern "C" int pairwise_dist_forward(const float* x, float* out, float* ws, long long ws_floats,
                                     int* counters, long long n_counters, long long C,
                                     long long B, long long F, long long chunk,
                                     long long splits, void* stream) {
  if (!dims_ok(C, B, F)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = F % 4 == 0 && aligned16(x);
  switch (fwd_mode(B)) {
    case 4: return launch_fwd_vec<4>(vec, x, out, ws, ws_floats, counters, n_counters, C, B, F, chunk, splits, st);
    case 8: return launch_fwd_vec<8>(vec, x, out, ws, ws_floats, counters, n_counters, C, B, F, chunk, splits, st);
    case 16: return launch_fwd_vec<16>(vec, x, out, ws, ws_floats, counters, n_counters, C, B, F, chunk, splits, st);
    case 32: return launch_fwd_vec<32>(vec, x, out, ws, ws_floats, counters, n_counters, C, B, F, chunk, splits, st);
    default: return launch_fwd_vec<kCross>(vec, x, out, ws, ws_floats, counters, n_counters, C, B, F, chunk, splits, st);
  }
}

// x, gx: (C, B, F) fp32 contiguous; dist, gdist: (C, B, B) fp32 contiguous.
// Launches pdist_bwd on `stream`; does not synchronise. Returns a
// cudaError_t.
extern "C" int pairwise_dist_backward(const float* x, const float* dist, const float* gdist,
                                      float* gx, long long C, long long B, long long F,
                                      void* stream) {
  if (!dims_ok(C, B, F)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = F % 4 == 0 && aligned16(x) && aligned16(gx);
  switch (fwd_mode(B)) {
    case 4: return launch_bwd_vec<4>(vec, x, dist, gdist, gx, C, B, F, st);
    case 8: return launch_bwd_vec<8>(vec, x, dist, gdist, gx, C, B, F, st);
    case 16: return launch_bwd_vec<16>(vec, x, dist, gdist, gx, C, B, F, st);
    case 32: return launch_bwd_vec<32>(vec, x, dist, gdist, gx, C, B, F, st);
    default: return launch_bwd_vec<kCross>(vec, x, dist, gdist, gx, C, B, F, st);
  }
}

namespace {

template <int kMode>
int occupancy(int backward, long long B, int* blocks) {
  cudaError_t e;
  if (backward) {
    e = cudaFuncSetAttribute(pdist_bwd<kMode, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bwd_smem_max<kMode>());
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, pdist_bwd<kMode, true>, kThreads,
                                                        bwd_smem<kMode>(B));
  } else {
    e = cudaFuncSetAttribute(pdist_fwd<kMode, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kFwdSmem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, pdist_fwd<kMode, true>, kFwdThreads,
                                                        kFwdSmem);
  }
  return static_cast<int>(e);
}

}  // namespace

// Blocks of the forward (backward != 0: the backward) kernel for this B
// that fit on one SM at once, into *blocks. Returns a cudaError_t.
extern "C" int pairwise_dist_blocks_per_sm(int backward, long long B, int* blocks) {
  if (B <= 0 || B > kMaxB) return cudaErrorInvalidValue;
  switch (fwd_mode(B)) {
    case 4: return occupancy<4>(backward, B, blocks);
    case 8: return occupancy<8>(backward, B, blocks);
    case 16: return occupancy<16>(backward, B, blocks);
    case 32: return occupancy<32>(backward, B, blocks);
    default: return occupancy<kCross>(backward, B, blocks);
  }
}

extern "C" const char* pairwise_dist_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
