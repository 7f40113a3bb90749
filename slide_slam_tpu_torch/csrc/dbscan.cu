// Fused two-stage dense DBSCAN for a batch of point sets (N <= 1024 points
// each), one thread-block cluster per set, on an sm_90a card.
//
// Replaces the Pallas TPU kernel slide_slam_tpu/frontend/clustering_pallas.py
// `_dbscan_kernel` (launched by `dbscan_pallas`), and computes what the XLA
// functions on the JAX frontend's path compute, clustering.dbscan and
// clustering.two_stage_cluster:
//   * d2 from coordinate differences, ((dx*dx + dy*dy) + dz*dz), every
//     difference, product and sum rounded on its own (__fsub_rn, __fmul_rn,
//     __fadd_rn, and -fmad=false): the eps test gives the same bits as the
//     plain PyTorch version. The Pallas body forms |p|^2 + |q|^2 - 2 p.q
//     instead, which cancels ~1e-3 of d2 at 50 m coordinates;
//   * core = valid and degree >= min_samples, degree counting self and valid
//     neighbours only;
//   * min-label propagation over core-core edges, SYNCHRONOUS (Jacobi) sweeps
//     from a double-buffered label array, stopping when a sweep changes
//     nothing or after max_iters sweeps (the XLA while_loop's exit);
//   * border points take the min label of their core neighbours; noise and
//     invalid points get -1. A cluster's id is its lowest member index;
//   * with stages = 2, a second DBSCAN over the points that the first one
//     did not call noise (valid & label >= 0), with the second (eps, ms).
//
// Design. Grid = C clusters of `cluster` CTAs of 1024 threads (16 where the
// card can place a cluster that large, else the portable 8); cluster c
// takes point set c, both stages, in one launch. Each CTA holds the set's
// points in shared memory and compacts the current stage's valid points
// (ballot + prefix sum), so rows and columns run over valid points only;
// compaction keeps the order, so the lowest compacted index of a cluster is
// its lowest original index. The compacted N x N eps-adjacency is a bitmask
// of W = ceil(nv/32) words per row, stored word-major (word w of rows
// 0..nv-1 contiguous), so the 32 rows of a tile write and read one 128-byte
// line, through distributed shared memory too. CTA r of the cluster builds
// the 32-row tiles rt = r, r + cluster, ... : a warp takes a 32 x 32 tile,
// lane j holds column j, and one __ballot_sync per row gives that row's word.
// A tile pair whose bounding boxes lie further apart than eps is skipped: its
// gap d2, formed with the same rounded operations, bounds every pair's d2
// from below (rounding is monotone), so no pair of it can pass. CTA r writes
// its rows' words and core bits into the leader CTA's (rank 0) shared memory
// through distributed shared memory, then one cluster barrier. The leader
// runs the sweeps with one thread per row. The first sweep needs no bit
// walk: a core row's first label is its lowest core neighbour (itself
// included), the first set bit of (row AND core). After that a row re-reads
// only the neighbours that changed in the previous sweep (labels only fall,
// so the others cannot lower it: the same labels, sweep by sweep, as a full
// sweep), and __syncthreads_or ends the loop when nothing changed. The band
// owners read the first stage's labels back from the leader for the second.
//
// What bounds it: not the card's memory or arithmetic rate (a scan's four
// problems are ~1 M pair tests and 30 KB), but latency: the launch, four
// cluster barriers, and ~8-11 synchronous sweeps per stage on one SM. The
// cluster spreads the N^2 build over `cluster` SMs; the sweeps stay on one.
// (Ordering the points along a space-filling curve first skips 4x more
// tiles, but measured no faster per scan: the sort and slower sweeps ate
// the gain. Not kept.)
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxPoints = 1024;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWords = kMaxPoints / 32;
constexpr int32_t kInf = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

struct Smem {
  uint32_t adj[kMaxWords * kMaxPoints];   // leader: word w of row i at
                                          // [w * kMaxPoints + i]
  uint32_t core[kMaxWords];               // leader: core bits by compacted row
  uint32_t chg[2][kMaxWords];             // leader: rows changed by a sweep
  float px[kMaxPoints], py[kMaxPoints], pz[kMaxPoints];  // the set's points
  float cx[kMaxPoints], cy[kMaxPoints], cz[kMaxPoints];  // compacted points
  float box[kMaxWords][6];                // per 32-point tile: lo xyz, hi xyz
  int32_t idx[kMaxPoints];                // compacted -> original index
  int32_t deg[kMaxPoints];                // degree of this CTA's rows
  int32_t lab[2][kMaxPoints];             // leader: Jacobi label buffers
  int32_t out[kMaxPoints];                // leader: labels by original index
  int32_t warp_off[kWarps];
  int32_t n_valid;
  uint8_t keep[kMaxPoints];               // this stage's valid flags
};

__device__ __forceinline__ float dist2(float xi, float yi, float zi, float xj,
                                       float yj, float zj) {
  const float dx = __fsub_rn(xi, xj);
  const float dy = __fsub_rn(yi, yj);
  const float dz = __fsub_rn(zi, zj);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Rounded squared gap between two tiles' boxes: <= the rounded d2 of every
// pair (one point from each), since each rounded operation is monotone.
__device__ __forceinline__ float box_gap2(const float* a, const float* b) {
  float g[3];
#pragma unroll
  for (int d = 0; d < 3; ++d)
    g[d] = fmaxf(0.f, fmaxf(__fsub_rn(a[d], b[3 + d]),
                            __fsub_rn(b[d], a[3 + d])));
  return __fadd_rn(__fadd_rn(__fmul_rn(g[0], g[0]), __fmul_rn(g[1], g[1])),
                   __fmul_rn(g[2], g[2]));
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Compact the flagged points (s.keep) in order into s.idx / s.c*, and the
// 32-point tiles' boxes. Returns the number of points kept.
__device__ int compact(Smem& s, int n) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool f = t < n && s.keep[t];
  const uint32_t b = __ballot_sync(kFull, f);
  if (lane == 0) s.warp_off[warp] = __popc(b);
  __syncthreads();
  if (warp == 0) {
    const int v = s.warp_off[lane];
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += u;
    }
    s.warp_off[lane] = incl - v;
    if (lane == 31) s.n_valid = incl;
  }
  __syncthreads();
  const int nv = s.n_valid;
  if (f) {
    const int pos = s.warp_off[warp] + __popc(b & ((1u << lane) - 1u));
    s.idx[pos] = t;
    s.cx[pos] = s.px[t];
    s.cy[pos] = s.py[t];
    s.cz[pos] = s.pz[t];
  }
  s.deg[t] = 0;
  __syncthreads();
  if (warp * 32 < nv) {
    const bool in = t < nv;
    const float inf = __int_as_float(0x7f800000);
    float* bx = s.box[warp];
    const float lo[3] = {warp_min(in ? s.cx[t] : inf),
                         warp_min(in ? s.cy[t] : inf),
                         warp_min(in ? s.cz[t] : inf)};
    const float hi[3] = {warp_max(in ? s.cx[t] : -inf),
                         warp_max(in ? s.cy[t] : -inf),
                         warp_max(in ? s.cz[t] : -inf)};
    if (lane == 0) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        bx[d] = lo[d];
        bx[3 + d] = hi[d];
      }
    }
  }
  __syncthreads();
  return nv;
}

// This CTA's band of the adjacency: row tiles rank, rank + csize, ...;
// words and core bits go to the leader's shared memory.
__device__ void build_band(Smem& s, Smem& lead, int nv, int rank, int csize,
                           float eps2, int min_samples) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = (nv + 31) >> 5;
  const int n_rt = rank < W ? (W - rank + csize - 1) / csize : 0;
  for (int q = warp; q < n_rt * W; q += kWarps) {
    const int rt = rank + (q / W) * csize;
    const int ct = q % W;
    uint32_t mine = 0;
    if (box_gap2(s.box[rt], s.box[ct]) <= eps2) {
      const int j = ct * 32 + lane;
      const float xj = s.cx[j], yj = s.cy[j], zj = s.cz[j];
      const float* rx = s.cx + rt * 32;
      const float* ry = s.cy + rt * 32;
      const float* rz = s.cz + rt * 32;
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        // rx[r] is the same address for the whole warp: a broadcast
        const float d2 = dist2(rx[r], ry[r], rz[r], xj, yj, zj);
        const uint32_t word = __ballot_sync(kFull, d2 <= eps2);
        if (lane == r) mine = word;
      }
      const int left = nv - ct * 32;
      if (left < 32) mine &= (1u << left) - 1u;
    }
    const int row = rt * 32 + lane;
    if (row < nv) {
      lead.adj[ct * kMaxPoints + row] = mine;     // 32 lanes, 128 B
      if (mine) atomicAdd(&s.deg[row], __popc(mine));
    }
  }
  __syncthreads();
  for (int k = warp; k < n_rt; k += kWarps) {
    const int rt = rank + k * csize;
    const int row = rt * 32 + lane;
    const uint32_t cb =
        __ballot_sync(kFull, row < nv && s.deg[row] >= min_samples);
    if (lane == 0) lead.core[rt] = cb;
  }
}

// The leader: synchronous sweeps, border points, labels by original index
// into s.out (-1 for noise and for points not in this stage).
__device__ void sweep_and_label(Smem& s, int nv, int max_iters) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int W = (nv + 31) >> 5;
  const bool live = t < nv;
  const bool core = live && ((s.core[t >> 5] >> lane) & 1u);
  // the words of this row that hold a core neighbour, and the lowest core
  // neighbour (self included): the first sweep's label, with no bit walk
  uint32_t nz = 0;
  int32_t first = kInf;
  if (live)
    for (int w = 0; w < W; ++w) {
      const uint32_t a = s.adj[w * kMaxPoints + t] & s.core[w];
      if (a) {
        if (!nz) first = w * 32 + __ffs(a) - 1;
        nz |= 1u << w;
      }
    }
  int32_t mine = core ? t : kInf;
  bool changed = false;
  if (core && max_iters > 0) {
    changed = first != mine;
    mine = first;
  }
  s.lab[0][t] = mine;
  const uint32_t moved0 = __ballot_sync(kFull, changed);
  if (lane == 0) s.chg[0][warp] = moved0;
  s.out[t] = -1;
  int any = __syncthreads_or(changed);

  // sweeps 2.., each over the neighbours that the previous one changed
  int cur = 0;
  for (int it = 1; any && it < max_iters; ++it) {
    changed = false;
    if (core) {
      const int32_t* lab = s.lab[cur];
      const uint32_t* chg = s.chg[cur];
      int32_t m = mine;
      uint32_t wm = nz;
      while (wm) {
        const int w = __ffs(wm) - 1;
        wm &= wm - 1;
        uint32_t bits = s.adj[w * kMaxPoints + t] & chg[w];
        while (bits) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1;
          m = min(m, lab[w * 32 + b]);
        }
      }
      changed = m != mine;
      mine = m;
      s.lab[cur ^ 1][t] = m;
    }
    const uint32_t moved = __ballot_sync(kFull, changed);
    if (lane == 0) s.chg[cur ^ 1][warp] = moved;
    any = __syncthreads_or(changed);
    cur ^= 1;
  }

  if (live) {
    int32_t m = mine;
    if (!core) {
      const int32_t* lab = s.lab[cur];
      uint32_t wm = nz;
      while (wm) {
        const int w = __ffs(wm) - 1;
        wm &= wm - 1;
        uint32_t bits = s.adj[w * kMaxPoints + t] & s.core[w];
        while (bits) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1;
          m = min(m, lab[w * 32 + b]);
        }
      }
    }
    s.out[s.idx[t]] = m < kInf ? s.idx[m] : -1;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
dbscan_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ valid,
              const float* __restrict__ params, int32_t* __restrict__ labels,
              int n, int stages, int max_iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int set = blockIdx.x / csize;
  Smem& lead = *cluster.map_shared_rank(&s, 0);
  const int t = threadIdx.x;

  if (t < n) {
    const float* p = pts + (static_cast<size_t>(set) * n + t) * 3;
    s.px[t] = p[0];
    s.py[t] = p[1];
    s.pz[t] = p[2];
    s.keep[t] = valid[static_cast<size_t>(set) * n + t] != 0;
  }
  // every CTA of the cluster must be running before any writes into the
  // leader: arrive now, wait just before the first remote write
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  for (int stage = 0; stage < stages; ++stage) {
    const float eps2 = params[set * 4 + 2 * stage];
    const int min_samples = static_cast<int>(params[set * 4 + 2 * stage + 1]);
    if (stage > 0 && t < n) s.keep[t] = lead.out[t] >= 0;
    const int nv = compact(s, n);
    if (stage == 0) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    build_band(s, lead, nv, rank, csize, eps2, min_samples);
    cluster.sync();
    if (rank == 0) sweep_and_label(s, nv, max_iters);
    // the first stage's labels are read back by every CTA, and the leader's
    // adjacency is free again
    if (stage + 1 < stages) cluster.sync();
  }
  if (rank == 0 && t < n)
    labels[static_cast<size_t>(set) * n + t] = s.out[t];
}

// Same launch shape and shared memory, no work: the launch floor.
__global__ void __launch_bounds__(kThreads, 1) empty_kernel(int) {}

// Shared memory and the non-portable cluster sizes, set once per kernel.
template <typename... KArgs>
cudaError_t prepare(void (*kernel)(KArgs...)) {
  static cudaError_t err = [kernel] {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(Smem)));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  return err;
}

cudaLaunchConfig_t launch_config(int sets, int cluster, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sets * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = sizeof(Smem);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The cluster size that `cluster = 0` stands for: 16 CTAs where the card
// can place a cluster that large (an H100 SXM's GPCs hold 16 or more SMs),
// else the portable 8.
int auto_cluster() {
  static const int chosen = [] {
    if (prepare(dbscan_kernel) != cudaSuccess) return 8;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = launch_config(1, 16, nullptr, &attr);
    int fits = 0;
    const cudaError_t e =
        cudaOccupancyMaxActiveClusters(&fits, dbscan_kernel, &cfg);
    if (e != cudaSuccess) cudaGetLastError();   // not sticky: clear it
    return e == cudaSuccess && fits >= 1 ? 16 : 8;
  }();
  return chosen;
}

// Launch `kernel` as `sets` clusters of `cluster` CTAs.
template <typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), int sets, int cluster,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = prepare(kernel);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(sets, cluster ? cluster : auto_cluster(), stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool bad_shape(int sets, int n, int cluster) {
  return sets < 1 || n < 1 || n > kMaxPoints || cluster < 0 || cluster > 16 ||
         (cluster & (cluster - 1)) != 0;
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream` and
// returns the launch's CUDA error (0 on success); neither synchronises.
//
// points [sets, n, 3] f32, valid [sets, n] u8, params [sets, 4] f32 =
// (eps_1^2, min_samples_1, eps_2^2, min_samples_2), labels [sets, n] i32;
// stages 1 (first DBSCAN only) or 2; cluster CTAs per set (1..16, a power
// of two; above 8 needs a GPC with that many free SMs), or 0 for 16 where
// the card can place it, else 8.
extern "C" int dbscan_two_stage_launch(const float* points,
                                       const uint8_t* valid,
                                       const float* params, int32_t* labels,
                                       int sets, int n, int stages,
                                       int max_iters, int cluster,
                                       void* stream) {
  if (bad_shape(sets, n, cluster) || stages < 1 || stages > 2 || max_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(dbscan_kernel, sets, cluster,
                                 static_cast<cudaStream_t>(stream), points,
                                 valid, params, labels, n, stages, max_iters));
}

extern "C" int dbscan_empty_launch(int sets, int cluster, void* stream) {
  if (bad_shape(sets, 1, cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(empty_kernel, sets, cluster,
                                 static_cast<cudaStream_t>(stream), 0));
}

// The cluster size that `cluster = 0` launches with.
extern "C" int dbscan_auto_cluster() { return auto_cluster(); }
