// Fused two-stage DBSCAN for a batch of point sets (up to 65536 points
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
// Above 1024 points (up to kBigMaxPoints = 65536 per set, a whole 64 x 1024
// range image), a second kernel, dbscan_big_kernel, takes the same call. A
// dense N x N bitmask would not scale (512 MiB a set at 65536), and in scan
// order every 32-point tile pair is live. So:
//   * order: the set's valid points go along a Morton curve (10 bits an
//     axis over the set's box): a counting sort on the keys' top 12 bits
//     spreads them over the cluster through global memory, and each CTA
//     sorts its contiguous share by the whole key in shared memory. Tiles
//     of 32 consecutive points are then spatially compact. The order serves
//     locality only: label values stay ORIGINAL indices (a core row starts
//     with its own), so a cluster's id is its lowest original index;
//   * blocks: CTA r owns a contiguous range of row tiles. For each (row
//     tile, column tile) pair whose boxes' gap is within eps (box_gap2) it
//     stores the 32 x 32 bit block in a per-row-tile slot list in a global
//     scratch buffer (bounded by every pair being live, allocated by the
//     wrapper); a pair whose boxes' farthest corners are within eps
//     (box_far2, the same rounded monotone form) is flagged full and stores
//     no bits. Scratch and work grow with the live pairs, not with N^2;
//   * sweeps: each CTA keeps its rows' labels (a Jacobi pair), changed words
//     and their min in shared memory; a row reads other CTAs' labels
//     through distributed shared memory. A sweep is one cluster barrier: no
//     fence and no L2 round trip; every CTA then gathers every tile's
//     changed word (DSMEM). A full block lowers a row to the tile's min
//     changed label with no bit walk. Work items are (row tile, 8 blocks),
//     their minima met with atomicMin, so all 32 warps of a CTA sweep.
// A CTA holds kRowsPerCta = 8192 labels: a set needs n / 8192 CTAs or more
// (8 at 65536). Stamps of the phases come with -DDBSCAN_CLOCKS.
//
// What bounds the N <= 1024 kernel: not the card's memory or arithmetic rate
// (a scan's four problems are ~1 M pair tests and 30 KB), but latency: the launch, four
// cluster barriers, and ~8-11 synchronous sweeps per stage on one SM. The
// cluster spreads the N^2 build over `cluster` SMs; the sweeps stay on one.
// (Ordering the points along a space-filling curve first skips 4x more
// tiles there, but measured no faster per scan: the sort and slower sweeps
// ate the gain. Above 1024 points the build and the sweeps cost more than
// the order, and cluster barriers, live tile pairs and, at large N, the
// 16 SMs of one cluster per set bound the sparse kernel.)
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

// ---------------------------------------------------------------------------
// N > 1024: the points in Morton order, the live 32 x 32 tile pairs as a
// sparse block list in a global scratch buffer, the labels in the cluster's
// shared memory.

constexpr int kBigMaxPoints = 65536;
constexpr int kRowsPerCta = 8192;                 // labels a CTA holds
constexpr int kBigMaxTiles = kBigMaxPoints / 32;
constexpr int kOwnTiles = kRowsPerCta / 32;       // row tiles a CTA owns
constexpr int kKeyBits = 30;                      // 10 bits an axis
constexpr int kBucketBits = 12;                   // the coarse pass's bits
constexpr int kBuckets = 1 << kBucketBits;
constexpr int kChunk = 8;                         // blocks a sweep reads at once
constexpr uint32_t kFullBit = 0x80000000u;        // block list: all pairs in eps
constexpr int kColCache = 2048;                   // block entries a CTA caches
constexpr int kWordCache = 360;                   // blocks' words a CTA caches
constexpr int kListEntries = kWordCache * 64;     // 16-bit list entries in
                                                  // the same memory
constexpr int kListParts = 4;                     // warps a row tile's lists
constexpr int kListMaxDeg = 64;                   // denser rows: blocks

#ifdef DBSCAN_CLOCKS
// Phase stamps of CTA thread 0 (chip_smoke.py, scripts/dbscan_bench.py):
// per CTA kStamps int64: [0] start, [1] ordered, per stage s [2 + 4s]
// compacted and boxed, [3 + 4s] built, [4 + 4s] swept, [5 + 4s] labelled
// (clock64), [10 + s] sweeps, [12] / [13] globaltimer at start / end, and
// per stage s the sweeps' cycles summed [14 + 3s] in relax (to the block
// barrier after it), [15 + 3s] in the tile and flag pushes, [16 + 3s] in
// the cluster barrier.
constexpr int kStamps = 24;
__device__ long long* g_clocks = nullptr;
__device__ __forceinline__ void stamp(int k, long long v) {
  if (threadIdx.x == 0 && g_clocks) g_clocks[blockIdx.x * kStamps + k] = v;
}
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define CLOCK_STAMP(k) stamp((k), clock64())
#define CLOCK_VALUE(k, v) stamp((k), (v))
#define CLOCK_NOW() clock64()
#else
#define CLOCK_STAMP(k) ((void)0)
#define CLOCK_VALUE(k, v) ((void)0)
#define CLOCK_NOW() 0ll
#endif

struct BigSmem {
  union {
    unsigned long long sort[kRowsPerCta];   // the order: key << 32 | index
    int32_t lab[2][kRowsPerCta];            // own rows' labels, Jacobi pair
  };
  union {
    int32_t off[kBuckets];                  // the order: bucket starts
    int32_t acc[kRowsPerCta];               // own rows: degrees, then the
                                            // next labels / border minima
  };
  union {
    float box[kBigMaxTiles][6];             // every tile's lo xyz, hi xyz
    uint32_t all[2][2][kBigMaxTiles];       // a Jacobi pair: every tile's
                                            // changed bits [0] and their min
                                            // label [1] (sweeps); its min
                                            // core label (border)
  };
  uint32_t core[kBigMaxTiles];              // every tile's core bits
  int32_t flag[2][16];                      // a Jacobi pair: whether each
                                            // CTA's rows changed
  int32_t cnt[kOwnTiles];                   // own row tiles: live blocks
  int32_t blk_off[kOwnTiles + 1];           // own row tiles: first block
  float4 rows[kWarps][32];                  // a warp's row tile (build)
  float part[6];                            // this CTA's box of its points
  float lo[3];
  float scale;
  uint32_t colc[kColCache];                 // own blocks' entries in order
                                            // (bits 16..30: word slot + 1)
  uint32_t words[kWordCache][32];           // cached blocks' words, or the
                                            // own rows' neighbour lists
  int32_t ncached;                          // words cached (may overrun)
  int32_t maxdeg;                           // largest own row degree
  int32_t lcap;                             // list entries a row, 0: blocks
  int32_t next;                             // the build's next work item
  int32_t count;                            // points this CTA kept
  int32_t base;
  int32_t total;
  int32_t warp_off[kWarps];
};

// One set's scratch (int32 words, W = ceil(n / 32)): the block list
// (blk: W x W blocks of 32 words, col: W x W column tiles), core words W,
// boxes 6W, Morton keys n, the coarse order (index n, key n), the order n,
// bucket counts and cursors, the stage's points in order (index, x, y, z:
// 32W each), the first stage's labels n. The block list is bounded by
// every tile pair being live: 512 MiB at n = 65536.
struct BigScratch {
  uint32_t* blk;
  uint32_t* col;
  uint32_t* core;
  float* box;
  uint32_t* key;
  int32_t* tmp;
  uint32_t* tkey;
  int32_t* ord;
  int32_t* hist;
  int32_t* cur;
  int32_t* cidx;
  float* cx;
  float* cy;
  float* cz;
  int32_t* out1;
};

__host__ __device__ inline size_t big_scratch_words(int n) {
  const size_t w = (static_cast<size_t>(n) + 31) / 32;
  const size_t words = 33 * w * w + 7 * w + 5 * static_cast<size_t>(n) +
                       4 * 32 * w + 2 * kBuckets;
  return (words + 31) / 32 * 32;               // 128-byte aligned sets
}

__device__ BigScratch big_scratch(int32_t* p, int n) {
  const size_t w = (static_cast<size_t>(n) + 31) / 32;
  BigScratch g;
  uint32_t* u = reinterpret_cast<uint32_t*>(p);
  g.blk = u;
  u += 32 * w * w;
  g.col = u;
  u += w * w;
  g.core = u;
  u += w;
  g.box = reinterpret_cast<float*>(u);
  u += 6 * w;
  g.key = u;
  u += n;
  g.tmp = reinterpret_cast<int32_t*>(u);
  u += n;
  g.tkey = u;
  u += n;
  g.ord = reinterpret_cast<int32_t*>(u);
  u += n;
  g.hist = reinterpret_cast<int32_t*>(u);
  u += kBuckets;
  g.cur = reinterpret_cast<int32_t*>(u);
  u += kBuckets;
  g.cidx = reinterpret_cast<int32_t*>(u);
  u += 32 * w;
  g.cx = reinterpret_cast<float*>(u);
  u += 32 * w;
  g.cy = reinterpret_cast<float*>(u);
  u += 32 * w;
  g.cz = reinterpret_cast<float*>(u);
  u += 32 * w;
  g.out1 = reinterpret_cast<int32_t*>(u);
  return g;
}

// What one CTA of the cluster owns of a stage: row tiles t0 .. t0 + own - 1
// of W, T = ceil(W / cluster) a CTA, over nv points in order.
struct Tiles {
  int nv, W, T, t0, own;
  uint32_t inv_T;                 // ceil(2^32 / T) for T > 1: c / T is
                                  // umulhi(c, inv_T) for c < 2^16
};

__device__ __forceinline__ Tiles tiles_of(int nv, int rank, int csize) {
  Tiles tl;
  tl.nv = nv;
  tl.W = (nv + 31) >> 5;
  tl.T = (tl.W + csize - 1) / csize;
  tl.t0 = rank * tl.T;
  tl.inv_T = tl.T > 1
                 ? static_cast<uint32_t>((0xffffffffull + tl.T) / tl.T)
                 : 0u;
  tl.own = max(0, min(tl.W, tl.t0 + tl.T) - tl.t0);
  return tl;
}

// Whatever a CTA wrote to global memory and another reads after this goes
// through L2 (__stcg / __ldcg).
__device__ __forceinline__ void sync_cluster(cg::cluster_group& cluster) {
  __threadfence();
  cluster.sync();
}

// Exclusive prefix sum of v over the block's threads in order; the sum of
// all into *total. Every thread calls it; it ends in a block barrier.
__device__ int block_scan(BigSmem& s, int v, int* total) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) s.warp_off[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int x = s.warp_off[lane];
    int y = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, y, o);
      if (lane >= o) y += u;
    }
    s.warp_off[lane] = y - x;
    if (lane == 31) s.total = y;
  }
  __syncthreads();
  const int out = s.warp_off[warp] + incl - v;
  *total = s.total;
  __syncthreads();              // warp_off and total serve the next call
  return out;
}

__device__ __forceinline__ uint32_t spread3(uint32_t v) {
  v &= 0x3ffu;
  v = (v | (v << 16)) & 0x030000ffu;
  v = (v | (v << 8)) & 0x0300f00fu;
  v = (v | (v << 4)) & 0x030c30c3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

__device__ __forceinline__ uint32_t cell(float p, float lo, float scale) {
  const int c = __float2int_rz(__fmul_rn(__fsub_rn(p, lo), scale));
  return static_cast<uint32_t>(min(max(c, 0), 1023));
}

// Morton key of a point: 10 bits an axis over the set's cubic box.
__device__ __forceinline__ uint32_t morton(const BigSmem& s, const float* q) {
  return spread3(cell(q[0], s.lo[0], s.scale)) |
         spread3(cell(q[1], s.lo[1], s.scale)) << 1 |
         spread3(cell(q[2], s.lo[2], s.scale)) << 2;
}

// Lanes of `active` with the same bucket b add once: returns this lane's
// slot among them after atomicAdd(ctr + b, their count).
__device__ __forceinline__ int warp_add(int* ctr, uint32_t b,
                                        uint32_t active) {
  const int lane = threadIdx.x & 31;
  const uint32_t peers = __match_any_sync(active, b);
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(ctr + b, __popc(peers));
  base = __shfl_sync(peers, base, leader);
  return base + __popc(peers & ((1u << lane) - 1u));
}

// The set's valid points in Morton order into g.ord (original indices);
// returns their count. A coarse counting sort on the keys' top kBucketBits
// bits spreads the points over the cluster; each CTA then sorts its
// contiguous share by the whole key in shared memory (bitonic). Where a
// bucket straddles two shares its points are split arbitrarily: the order
// serves locality only, and the labels do not depend on it.
__device__ int order_points(BigSmem& s, const BigScratch& g, const float* p,
                            const uint8_t* v, int n, int rank, int csize,
                            cg::cluster_group& cluster) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int cn = (n + csize - 1) / csize;
  const int c0 = min(n, rank * cn), c1 = min(n, c0 + cn);
  for (int b = rank * kThreads + t; b < kBuckets; b += csize * kThreads) {
    __stcg(g.hist + b, 0);
    __stcg(g.cur + b, 0);
  }
  // this CTA's box of its share of the valid points
  const float inf = __int_as_float(0x7f800000);
  float lo[3] = {inf, inf, inf}, hi[3] = {-inf, -inf, -inf};
  for (int i = c0 + t; i < c1; i += kThreads)
    if (v[i])
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        lo[d] = fminf(lo[d], p[3 * i + d]);
        hi[d] = fmaxf(hi[d], p[3 * i + d]);
      }
  float* red = reinterpret_cast<float*>(s.rows);   // [kWarps][6]
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    lo[d] = warp_min(lo[d]);
    hi[d] = warp_max(hi[d]);
  }
  if (lane == 0)
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      red[warp * 6 + d] = lo[d];
      red[warp * 6 + 3 + d] = hi[d];
    }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float a = warp_min(red[lane * 6 + d]);
      const float b = warp_max(red[lane * 6 + 3 + d]);
      if (lane == 0) {
        s.part[d] = a;
        s.part[3 + d] = b;
      }
    }
  }
  sync_cluster(cluster);
  // the set's box, its longest side the keys' scale
  if (warp == 0) {
    const float* q = lane < csize ? cluster.map_shared_rank(s.part, lane)
                                  : nullptr;
    float ext = 0.f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float a = warp_min(q ? q[d] : inf);
      const float b = warp_max(q ? q[3 + d] : -inf);
      ext = fmaxf(ext, b - a);
      if (lane == 0) s.lo[d] = a;
    }
    if (lane == 0) s.scale = ext > 0.f && ext < inf ? 1023.f / ext : 0.f;
  }
  __syncthreads();
  for (int i0 = c0; i0 < c1; i0 += kThreads) {
    const int i = i0 + t;
    const bool f = i < c1 && v[i];
    const uint32_t active = __ballot_sync(kFull, f);
    if (f) {
      const uint32_t key = morton(s, p + 3 * i);
      __stcg(g.key + i, key);
      warp_add(g.hist, key >> (kKeyBits - kBucketBits), active);
    }
  }
  sync_cluster(cluster);
  // bucket starts (every CTA scans the counts itself)
  int h[kBuckets / kThreads], sum = 0;
#pragma unroll
  for (int k = 0; k < kBuckets / kThreads; ++k) {
    h[k] = __ldcg(g.hist + t * (kBuckets / kThreads) + k);
    sum += h[k];
  }
  int nv;
  int run = block_scan(s, sum, &nv);
#pragma unroll
  for (int k = 0; k < kBuckets / kThreads; ++k) {
    s.off[t * (kBuckets / kThreads) + k] = run;
    run += h[k];
  }
  __syncthreads();
  for (int i0 = c0; i0 < c1; i0 += kThreads) {
    const int i = i0 + t;
    const bool f = i < c1 && v[i];
    const uint32_t active = __ballot_sync(kFull, f);
    if (f) {
      const uint32_t key = __ldcg(g.key + i);
      const uint32_t b = key >> (kKeyBits - kBucketBits);
      const int pos = s.off[b] + warp_add(g.cur, b, active);
      __stcg(g.tmp + pos, i);
      __stcg(g.tkey + pos, key);
    }
  }
  sync_cluster(cluster);
  // this CTA's share, sorted by the whole key
  const int L = (nv + csize - 1) / csize;
  const int r0 = min(nv, rank * L), len = min(nv, r0 + L) - r0;
  int P = 1;
  while (P < len) P <<= 1;
  for (int i = t; i < P; i += kThreads)
    s.sort[i] = i < len ? static_cast<unsigned long long>(
                              __ldcg(g.tkey + r0 + i)) << 32 |
                              static_cast<uint32_t>(__ldcg(g.tmp + r0 + i))
                        : ~0ull;
  __syncthreads();
  for (int k = 2; k <= P; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = t; q < P / 2; q += kThreads) {
        const int i = 2 * q - (q & (j - 1));       // bit j of i clear
        const unsigned long long a = s.sort[i], b = s.sort[i + j];
        if ((a > b) == ((i & k) == 0)) {
          s.sort[i] = b;
          s.sort[i + j] = a;
        }
      }
      __syncthreads();
    }
  for (int i = t; i < len; i += kThreads)
    __stcg(g.ord + r0 + i, static_cast<int32_t>(s.sort[i] & 0xffffffffu));
  sync_cluster(cluster);
  return nv;
}

// This stage's points in order into g.cidx / g.cx.. (the ordered valid
// points; in the second stage those the first labelled, prev[i] >= 0),
// then every tile's box into s.box. Returns the stage's tiles.
__device__ Tiles compact_stage(BigSmem& s, const BigScratch& g,
                               const float* p, const int32_t* prev, int nv,
                               int rank, int csize,
                               cg::cluster_group& cluster) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int L = (nv + csize - 1) / csize;
  const int r0 = min(nv, rank * L), r1 = min(nv, r0 + L);
  int kept = 0;
  for (int i0 = r0; i0 < r1; i0 += kThreads) {
    const int i = i0 + t;
    kept += __syncthreads_count(
        i < r1 && (!prev || __ldcg(prev + __ldcg(g.ord + i)) >= 0));
  }
  if (t == 0) s.count = kept;
  cluster.sync();
  if (warp == 0) {
    const int c = lane < csize ? *cluster.map_shared_rank(&s.count, lane) : 0;
    const int before = lane < rank ? c : 0;
    int a = c, b = before;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(kFull, a, o);
      b += __shfl_xor_sync(kFull, b, o);
    }
    if (lane == 0) {
      s.total = a;                // read below, before block_scan runs
      s.base = b;
    }
  }
  __syncthreads();
  const int m = s.total;
  int run = s.base;
  __syncthreads();
  for (int i0 = r0; i0 < r1; i0 += kThreads) {
    const int i = i0 + t;
    const int o = i < r1 ? __ldcg(g.ord + i) : 0;
    const bool f = i < r1 && (!prev || __ldcg(prev + o) >= 0);
    int chunk;
    const int pos = run + block_scan(s, f, &chunk);
    if (f) {
      __stcg(g.cidx + pos, o);
      __stcg(g.cx + pos, p[3 * o]);
      __stcg(g.cy + pos, p[3 * o + 1]);
      __stcg(g.cz + pos, p[3 * o + 2]);
    }
    run += chunk;
  }
  sync_cluster(cluster);
  // own tiles' boxes; a tile with a non-finite coordinate gets lo x = -inf,
  // which keeps its gap a lower bound and takes it out of the all-pairs test
  const Tiles tl = tiles_of(m, rank, csize);
  const float inf = __int_as_float(0x7f800000);
  for (int lt = warp; lt < tl.own; lt += kWarps) {
    const int rt = tl.t0 + lt, j = rt * 32 + lane;
    const bool in = j < m;
    const float x = in ? __ldcg(g.cx + j) : 0.f;
    const float y = in ? __ldcg(g.cy + j) : 0.f;
    const float z = in ? __ldcg(g.cz + j) : 0.f;
    const bool odd = __any_sync(
        kFull, in && !(isfinite(x) && isfinite(y) && isfinite(z)));
    const float b[6] = {warp_min(in ? x : inf), warp_min(in ? y : inf),
                        warp_min(in ? z : inf), warp_max(in ? x : -inf),
                        warp_max(in ? y : -inf), warp_max(in ? z : -inf)};
    if (lane < 6) __stcg(g.box + 6 * rt + lane, lane == 0 && odd ? -inf
                                                                : b[lane]);
  }
  sync_cluster(cluster);
  float* box = &s.box[0][0];
  for (int i = t; i < 6 * tl.W; i += kThreads) box[i] = __ldcg(g.box + i);
  __syncthreads();
  return tl;
}

// Rounded squared distance between the farthest corners of two tiles'
// boxes: >= the rounded d2 of every pair (one point from each), since
// |fsub_rn(p, q)| = fsub_rn(max, min) and each rounded operation is
// monotone. At most eps2: every pair of the two tiles is in eps.
__device__ __forceinline__ float box_far2(const float* a, const float* b) {
  float g[3];
#pragma unroll
  for (int d = 0; d < 3; ++d)
    g[d] = fmaxf(__fsub_rn(a[3 + d], b[d]), __fsub_rn(b[3 + d], a[d]));
  return __fadd_rn(__fadd_rn(__fmul_rn(g[0], g[0]), __fmul_rn(g[1], g[1])),
                   __fmul_rn(g[2], g[2]));
}

// The same bounds between one point and a tile's box.
__device__ __forceinline__ float point_gap2(const float* p, const float* b) {
  float g[3];
#pragma unroll
  for (int d = 0; d < 3; ++d)
    g[d] = fmaxf(0.f, fmaxf(__fsub_rn(b[d], p[d]), __fsub_rn(p[d], b[3 + d])));
  return __fadd_rn(__fadd_rn(__fmul_rn(g[0], g[0]), __fmul_rn(g[1], g[1])),
                   __fmul_rn(g[2], g[2]));
}

__device__ __forceinline__ float point_far2(const float* p, const float* b) {
  float g[3];
#pragma unroll
  for (int d = 0; d < 3; ++d)
    g[d] = fmaxf(__fsub_rn(p[d], b[d]), __fsub_rn(b[3 + d], p[d]));
  return __fadd_rn(__fadd_rn(__fmul_rn(g[0], g[0]), __fmul_rn(g[1], g[1])),
                   __fmul_rn(g[2], g[2]));
}

// Own row tiles' live blocks into the block list: row tile rt's blocks at
// slots rt * W + k, k < s.cnt; a block of tiles within eps of each other
// everywhere is flagged (kFullBit) and not stored. First every (own row
// tile, 32 candidate column tiles) item finds its live and full pairs; then
// the partial blocks' bits are computed, the CTA's blocks split over its
// warps in turn, so that all of them work however few the row tiles. Then
// the core words of every tile into s.core and where each own row tile's
// blocks start in the CTA's list of blocks into s.blk_off; where the list
// fits, it and the first kWordCache partial blocks' words (or the rows'
// neighbour lists) into shared memory.
__device__ void build_blocks(BigSmem& s, const BigScratch& g, const Tiles& tl,
                             float eps2, int min_samples,
                             cg::cluster_group& cluster) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int i = t; i < tl.own * 32; i += kThreads) s.acc[i] = 0;
  for (int i = t; i < tl.own; i += kThreads) s.cnt[i] = 0;
  if (t == 0) {
    s.next = 0;
    s.maxdeg = 0;
  }
  __syncthreads();
  const int G = (tl.W + 31) >> 5;
  for (;;) {                           // items taken in turn
    int q = 0;
    if (lane == 0) q = atomicAdd(&s.next, 1);
    q = __shfl_sync(kFull, q, 0);
    if (q >= tl.own * G) break;
    const int lt = q / G, grp = q - lt * G;
    const int rt = tl.t0 + lt, ct = grp * 32 + lane;
    bool live = false, full = false;
    if (ct < tl.W) {
      live = box_gap2(s.box[rt], s.box[ct]) <= eps2;
      full = live && box_far2(s.box[rt], s.box[ct]) <= eps2;
    }
    const uint32_t lm = __ballot_sync(kFull, live);
    if (!lm) continue;
    int base = 0;
    if (lane == 0) base = atomicAdd(&s.cnt[lt], __popc(lm));
    base = __shfl_sync(kFull, base, 0);
    if (live)
      __stcg(g.col + static_cast<uint32_t>(rt * tl.W + base) +
                 __popc(lm & ((1u << lane) - 1u)),
             static_cast<uint32_t>(ct) | (full ? kFullBit : 0u));
    // a full block adds its columns to every row's degree
    const int rest = tl.nv - ct * 32;
    int add = full ? min(rest, 32) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) add += __shfl_xor_sync(kFull, add, o);
    if (add) atomicAdd(&s.acc[lt * 32 + lane], add);
  }
  __syncthreads();
  if (warp == 0) {
    constexpr int per = kOwnTiles / 32;
    int c[per], sum = 0;
#pragma unroll
    for (int k = 0; k < per; ++k) {
      const int lt = lane * per + k;
      c[k] = lt < tl.own ? s.cnt[lt] : 0;
      sum += c[k];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += u;
    }
    int run = incl - sum;
#pragma unroll
    for (int k = 0; k < per; ++k) {
      s.blk_off[lane * per + k] = run;
      run += c[k];
    }
    if (lane == 31) s.blk_off[kOwnTiles] = run;
  }
  if (t == 0) s.next = 0;
  __syncthreads();
  // the partial blocks' bits, kChunk consecutive blocks of the CTA's list
  // at a time
  const int total = s.blk_off[tl.own];
  int cur = -1;                        // the row tile in s.rows[warp]
  for (;;) {
    int b0 = 0;
    if (lane == 0) b0 = atomicAdd(&s.next, kChunk);
    b0 = __shfl_sync(kFull, b0, 0);
    if (b0 >= total) break;
    int lt = 0, hi = tl.own;           // the last lt with blk_off <= b0
    while (hi - lt > 1) {
      const int mid = (lt + hi) >> 1;
      if (s.blk_off[mid] <= b0) lt = mid;
      else hi = mid;
    }
    const int kn = min(kChunk, total - b0);
    // lane u: the u-th block's entry (its row tile found on the way)
    int ul = lt;
    if (lane < kn)
      while (s.blk_off[ul + 1] <= b0 + lane) ++ul;
    const uint32_t ce =
        lane < kn ? __ldcg(g.col + static_cast<uint32_t>(
                                       (tl.t0 + ul) * tl.W + b0 + lane -
                                       s.blk_off[ul]))
                  : kFullBit;
    for (int u = 0; u < kn; ++u) {
      const uint32_t e = __shfl_sync(kFull, ce, u);
      if (e & kFullBit) continue;
      const int l = __shfl_sync(kFull, ul, u), rt = tl.t0 + l;
      const int c = static_cast<int>(e & 0xffffu);
      if (l != cur) {
        __syncwarp();
        const int row = rt * 32 + lane;
        s.rows[warp][lane] = make_float4(__ldcg(g.cx + row),
                                         __ldcg(g.cy + row),
                                         __ldcg(g.cz + row), 0.f);
        __syncwarp();
        cur = l;
      }
      const int j = c * 32 + lane;
      const float xj = __ldcg(g.cx + j), yj = __ldcg(g.cy + j),
                  zj = __ldcg(g.cz + j);
      const int rest = tl.nv - c * 32;
      const uint32_t cols = rest >= 32 ? kFull : (1u << rest) - 1u;
      // a row whose point is within eps of the column tile's whole box
      // takes every column, one beyond eps of it none (the same bounds as
      // the tiles'); the other rows test their 32 pairs
      const float4 me = s.rows[warp][lane];
      const float pt[3] = {me.x, me.y, me.z};
      const bool all = point_far2(pt, s.box[c]) <= eps2;
      const uint32_t mixed =
          __ballot_sync(kFull, !all && point_gap2(pt, s.box[c]) <= eps2);
      uint32_t mine = all ? kFull : 0u;
      if (mixed) {
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          if (!((mixed >> r) & 1u)) continue;      // the same for the warp
          const float4 q4 = s.rows[warp][r];       // a broadcast
          const uint32_t w = __ballot_sync(
              kFull, dist2(q4.x, q4.y, q4.z, xj, yj, zj) <= eps2);
          if (lane == r) mine = w;
        }
      }
      const uint32_t word = mine & cols;
      __stcg(g.blk + static_cast<uint32_t>(rt * tl.W + b0 + u - s.blk_off[l]) *
                         32u + lane,
             word);
      if (word) atomicAdd(&s.acc[l * 32 + lane], __popc(word));
    }
  }
  __syncthreads();
  for (int lt = warp; lt < tl.own; lt += kWarps) {
    const int rt = tl.t0 + lt, row = rt * 32 + lane;
    const int deg = row < tl.nv ? s.acc[lt * 32 + lane] : 0;
    const uint32_t cb = __ballot_sync(kFull, deg >= min_samples);
    const int top = __reduce_max_sync(kFull, deg);
    if (lane == 0) {
      __stcg(g.core + rt, cb);
      atomicMax(&s.maxdeg, top);
    }
  }
  if (t == 0) s.ncached = 0;
  __syncthreads();
  // where every own row has at most kListMaxDeg neighbours and they fit (a
  // count and the list, 16-bit positions), neighbour lists in shared memory
  // for the sweeps and the border pass: a row then reads its own
  // neighbours only, not 32 x 32 blocks whose bits are mostly clear
  // (sparse stages); denser rows keep the blocks, whose full ones cost one
  // read
  const int cap = tl.own ? kListEntries / (tl.own * 32) : 0;
  const int lcap =
      tl.own && s.maxdeg <= min(cap, kListMaxDeg) ? cap : 0;
  if (t == 0) s.lcap = lcap;
  if (lcap) {
    uint16_t* list = reinterpret_cast<uint16_t*>(s.words);
    for (int lt = warp; lt < tl.own; lt += kWarps) {
      const int rt = tl.t0 + lt;
      const size_t base = static_cast<size_t>(rt) * tl.W;
      uint16_t* mine = list + static_cast<size_t>(lt) * lcap * 32 + lane;
      const bool real = rt * 32 + lane < tl.nv;
      int n = 0;
      for (int k0 = 0; k0 < s.cnt[lt]; k0 += kChunk) {
        const int kn = min(kChunk, s.cnt[lt] - k0);
        const uint32_t ce = lane < kn ? __ldcg(g.col + base + k0 + lane) : 0u;
        uint32_t w[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const uint32_t e = __shfl_sync(kFull, ce, u);
          const int c = static_cast<int>(e & 0xffffu), rest = tl.nv - c * 32;
          w[u] = 0u;
          if (u < kn)
            w[u] = e & kFullBit ? (rest >= 32 ? kFull : (1u << rest) - 1u)
                                : __ldcg(g.blk + (base + k0 + u) * 32 + lane);
          if (c == rt) w[u] &= ~(1u << lane);       // not the row itself
          if (!real) w[u] = 0u;
        }
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const int c = static_cast<int>(__shfl_sync(kFull, ce, u) & 0xffffu);
          for (uint32_t bits = w[u]; bits; bits &= bits - 1)
            mine[++n * 32] = static_cast<uint16_t>(c * 32 + __ffs(bits) - 1);
        }
      }
      mine[0] = static_cast<uint16_t>(n);
    }
  } else if (s.blk_off[tl.own] <= kColCache)
    // where the CTA's entries fit, its entries and as many partial blocks'
    // words as fit into shared memory, for the sweeps and the border pass
    for (int lt = warp; lt < tl.own; lt += kWarps) {
      const size_t base = static_cast<size_t>(tl.t0 + lt) * tl.W;
      for (int k0 = 0; k0 < s.cnt[lt]; k0 += 32) {
        const int k = k0 + lane;
        uint32_t e = k < s.cnt[lt] ? __ldcg(g.col + base + k) : 0u;
        const bool part = k < s.cnt[lt] && !(e & kFullBit);
        const uint32_t pm = __ballot_sync(kFull, part);
        int first = 0;
        if (lane == 0 && pm) first = atomicAdd(&s.ncached, __popc(pm));
        const int slot = __shfl_sync(kFull, first, 0) +
                         __popc(pm & ((1u << lane) - 1u));
        const bool kept = part && slot < kWordCache;
        if (kept) e |= static_cast<uint32_t>(slot + 1) << 16;
        if (k < s.cnt[lt]) s.colc[s.blk_off[lt] + k] = e;
        for (uint32_t cm = __ballot_sync(kFull, kept); cm; cm &= cm - 1) {
          const int j = __ffs(cm) - 1;
          const int sl = __shfl_sync(kFull, slot, j);
          s.words[sl][lane] = __ldcg(g.blk + (base + k0 + j) * 32 + lane);
        }
      }
    }
  sync_cluster(cluster);
  for (int c = threadIdx.x; c < tl.W; c += kThreads) s.core[c] = __ldcg(g.core + c);
  __syncthreads();
}

// One pass over the own row tiles' blocks: for each taking-part row (core
// rows in a sweep, valid non-core rows in the border pass), the min of
// lab[par] over its neighbours in mask[c] (the changed rows of tile c, or
// its core rows), atomically into s.acc. mins[c] is the tile's min label
// over mask[c]: a full block takes it with no word, and a block whose min
// cannot lower a row's best so far is not walked for that row, nor read
// where it can lower none. A block's column labels come in one coalesced
// read (through distributed shared memory from another CTA) and pass along
// the warp by shuffles. The CTA's blocks (own row tiles in order) are
// split evenly over its warps, each reading kChunk blocks at once.
__device__ void relax(BigSmem& s, const BigScratch& g, const Tiles& tl,
                      int par, const uint32_t* mask, const uint32_t* tile_min,
                      bool border, cg::cluster_group& cluster) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rank = static_cast<int>(cluster.block_rank());
  const int32_t* mins = reinterpret_cast<const int32_t*>(tile_min);
  const int total = s.blk_off[tl.own];
  const int per = (total + kWarps - 1) / kWarps;
  const int b0 = warp * per, b1 = min(total, b0 + per);
  if (b0 >= b1) return;
  int lt = 0, hi = tl.own;                // the last lt with blk_off <= b0
  while (hi - lt > 1) {
    const int mid = (lt + hi) >> 1;
    if (s.blk_off[mid] <= b0) lt = mid;
    else hi = mid;
  }
  // the next kChunk blocks from b on, all of row tile lt (lane u: the
  // u-th one's column tile entry): their count and entries
  const bool cached = total <= kColCache;
  auto entries = [&](int b, int l, int* n) -> uint32_t {
    const int k = b - s.blk_off[l];
    *n = min(kChunk, min(b1, s.blk_off[l + 1]) - b);
    if (lane >= *n) return 0u;
    return cached ? s.colc[b + lane]
                  : __ldcg(g.col + static_cast<uint32_t>((tl.t0 + l) * tl.W +
                                                         k + lane));
  };
  int kn_next;
  uint32_t next = entries(b0, lt, &kn_next);
  int cur = -1;                           // the row tile m belongs to
  bool on = false;
  int32_t best = kInf, m = kInf;
  for (int b = b0; b < b1;) {
    const uint32_t ce = next;
    const int kn = kn_next, l = lt, k0 = b - s.blk_off[l];
    b += kn;
    if (b < b1) {                          // read one chunk ahead
      while (s.blk_off[lt + 1] <= b) ++lt;
      next = entries(b, lt, &kn_next);
    }
    const int rt = tl.t0 + l;
    if (l != cur) {                        // a new row tile: flush the last
      if (on && m < best) atomicMin(&s.acc[cur * 32 + lane], m);
      const int rest = tl.nv - rt * 32;
      const uint32_t rows = rest >= 32 ? kFull : (1u << rest) - 1u;
      const uint32_t on_rows = border ? rows & ~s.core[rt] : s.core[rt];
      cur = l;
      on = (on_rows >> lane) & 1u;
      best = m = on ? s.acc[l * 32 + lane] : kInf;
    }
    if (!__any_sync(kFull, on)) continue;
    const uint32_t slot0 = static_cast<uint32_t>(rt * tl.W + k0);  // < 2^22
    uint32_t part = 0;                    // blocks with words to read
    int32_t mn[kChunk];                   // their tiles' min labels
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const uint32_t e = __shfl_sync(kFull, ce, u);
      const int c = static_cast<int>(e & 0xffffu);
      mn[u] = kInf;
      if (u < kn && mask[c]) {
        mn[u] = mins[c];
        if (e & kFullBit) m = min(m, mn[u]);
        else part |= 1u << u;
      }
    }
    // the words of blocks whose min can lower some row, and the labels of
    // their column tiles (lane j: column j), all reads in flight together
    uint32_t w[kChunk];
    int32_t lab[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      w[u] = 0u;
      lab[u] = kInf;
      if (((part >> u) & 1u) && __any_sync(kFull, on && mn[u] < m)) {
        const uint32_t e = __shfl_sync(kFull, ce, u);
        const int c = static_cast<int>(e & 0xffffu);
        const int o = tl.T > 1 ? static_cast<int>(__umulhi(c, tl.inv_T))
                               : c;                             // c / T
        const int sl = static_cast<int>((e >> 16) & 0x7fffu);
        const int32_t* src = &s.lab[par][(c - o * tl.T) * 32 + lane];
        w[u] = (sl ? s.words[sl - 1][lane]
                   : __ldcg(g.blk + ((slot0 + u) * 32u + lane))) & mask[c];
        lab[u] = o == rank ? *src : *cluster.map_shared_rank(src, o);
      }
    }
    // each row's min over its bits, the labels passed along the warp
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      uint32_t bits = on && mn[u] < m ? w[u] : 0u;
      while (__any_sync(kFull, bits)) {
        const int32_t x = __shfl_sync(kFull, lab[u], bits ? __ffs(bits) - 1 : 0);
        if (bits) {
          m = min(m, x);
          bits &= bits - 1;
        }
      }
    }
  }
  if (on && m < best) atomicMin(&s.acc[cur * 32 + lane], m);
}

// relax() for a CTA whose rows have neighbour lists (s.lcap entries a
// row: the count, then 16-bit positions): each row walks its own list,
// kListParts warps to a row tile, each every kListParts-th entry.
__device__ void relax_lists(BigSmem& s, const Tiles& tl, int par,
                            const uint32_t* mask, bool border,
                            cg::cluster_group& cluster) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rank = static_cast<int>(cluster.block_rank());
  const uint16_t* list = reinterpret_cast<const uint16_t*>(s.words);
  const int lcap = s.lcap;
  for (int q = warp; q < tl.own * kListParts; q += kWarps) {
    const int lt = q / kListParts, part = q - lt * kListParts;
    const int rt = tl.t0 + lt;
    const int rest = tl.nv - rt * 32;
    const uint32_t rows = rest >= 32 ? kFull : (1u << rest) - 1u;
    const uint32_t on_rows = border ? rows & ~s.core[rt] : s.core[rt];
    if (!((on_rows >> lane) & 1u)) continue;
    const int32_t best = s.acc[lt * 32 + lane];
    int32_t m = best;
    const uint16_t* mine = list + static_cast<size_t>(lt) * lcap * 32 + lane;
    const int n = mine[0];
#pragma unroll 4
    for (int k = 1 + part; k <= n; k += kListParts) {
      const int j = mine[k * 32], ct = j >> 5;
      if ((mask[ct] >> (j & 31)) & 1u) {
        const int o = tl.T > 1 ? static_cast<int>(__umulhi(ct, tl.inv_T)) : ct;
        const int32_t* src = &s.lab[par][j - o * tl.T * 32];
        m = min(m, o == rank ? *src : *cluster.map_shared_rank(src, o));
      }
    }
    if (m < best) atomicMin(&s.acc[lt * 32 + lane], m);
  }
}

// Own tile lt's word and min label into slot `which` of every CTA's
// shared memory (lanes below the cluster size store one CTA each).
__device__ __forceinline__ void push_tile(BigSmem& s, int which, int rt,
                                          uint32_t word, int32_t mn,
                                          cg::cluster_group& cluster) {
  const int lane = threadIdx.x & 31;
  if (lane == static_cast<int>(cluster.block_rank())) {
    s.all[which][0][rt] = word;
    s.all[which][1][rt] = static_cast<uint32_t>(mn);
  } else if (lane < static_cast<int>(cluster.num_blocks())) {
    *cluster.map_shared_rank(&s.all[which][0][rt], lane) = word;
    *cluster.map_shared_rank(&s.all[which][1][rt], lane) =
        static_cast<uint32_t>(mn);
  }
}

// This CTA's "any row changed" into slot `which` of every CTA; every thread
// calls it (a block barrier).
__device__ __forceinline__ void push_flag(BigSmem& s, int which, int changed,
                                          int rank, cg::cluster_group& cluster) {
  const int any = __syncthreads_or(changed);
  if (threadIdx.x < cluster.num_blocks())
    *cluster.map_shared_rank(&s.flag[which][rank], threadIdx.x) = any;
}

// The synchronous sweeps. A core row's first label is its original index
// (so a cluster's id is its lowest original index whatever the order), and
// the first sweep reads every core row; after that a row reads only the
// neighbours the previous sweep changed (labels only fall, so the others
// cannot lower it). Each CTA keeps its rows' labels as a Jacobi pair in its
// shared memory and stores its tiles' changed words, their min label and
// whether anything changed into the other half of a pair in EVERY CTA's
// shared memory, so one cluster barrier a sweep suffices and each CTA then
// reads all of it locally; none changed ends the loop, as does max_iters.
// Returns the half that holds the final labels; *sweeps the sweeps run.
__device__ int sweep_blocks(BigSmem& s, const BigScratch& g, const Tiles& tl,
                            int max_iters, int* sweeps, int rank, int stage,
                            cg::cluster_group& cluster) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int csize = static_cast<int>(cluster.num_blocks());
  bool mine = false;
  for (int lt = warp; lt < tl.own; lt += kWarps) {
    const int rt = tl.t0 + lt, r = lt * 32 + lane;
    const bool core = (s.core[rt] >> lane) & 1u;
    const int32_t l = core ? __ldcg(g.cidx + rt * 32 + lane) : kInf;
    s.lab[0][r] = l;
    s.acc[r] = l;
    push_tile(s, 0, rt, s.core[rt], __reduce_min_sync(kFull, l), cluster);
    mine |= s.core[rt] != 0u;
  }
  push_flag(s, 0, mine, rank, cluster);
  cluster.sync();
  int par = 0, it = 0;
  long long in_relax = 0, in_push = 0, in_sync = 0;
  (void)in_relax, (void)in_push, (void)in_sync, (void)stage;
  for (;; ++it, par ^= 1) {
    int any = 0;
    for (int r = 0; r < csize; ++r) any |= s.flag[par][r];
    if (!any || it == max_iters) break;
    const long long t0 = CLOCK_NOW();
    if (s.lcap)
      relax_lists(s, tl, par, s.all[par][0], false, cluster);
    else
      relax(s, g, tl, par, s.all[par][0], s.all[par][1], false, cluster);
    __syncthreads();
    const long long t1 = CLOCK_NOW();
    bool changed_any = false;
    for (int lt = warp; lt < tl.own; lt += kWarps) {
      const int r = lt * 32 + lane;
      const int32_t old = s.lab[par][r], nw = s.acc[r];
      s.lab[par ^ 1][r] = nw;
      const bool changed = nw != old;
      const uint32_t moved = __ballot_sync(kFull, changed);
      push_tile(s, par ^ 1, tl.t0 + lt, moved,
                __reduce_min_sync(kFull, changed ? nw : kInf), cluster);
      changed_any |= moved != 0u;
    }
    push_flag(s, par ^ 1, changed_any, rank, cluster);
    const long long t2 = CLOCK_NOW();
    cluster.sync();
    const long long t3 = CLOCK_NOW();
    in_relax += t1 - t0;
    in_push += t2 - t1;
    in_sync += t3 - t2;
  }
  CLOCK_VALUE(14 + 3 * stage, in_relax);
  CLOCK_VALUE(15 + 3 * stage, in_push);
  CLOCK_VALUE(16 + 3 * stage, in_sync);
  *sweeps = it;
  return par;
}

// Border points to the min label of their core neighbours, then the
// stage's labels by original index into dst (-1 for noise). lab[par] holds
// the final labels; the other half of the tile pair is free (the last
// sweep that read it ended in a cluster barrier).
__device__ void label_stage(BigSmem& s, const BigScratch& g, const Tiles& tl,
                            int par, int32_t* dst,
                            cg::cluster_group& cluster) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int lt = warp; lt < tl.own; lt += kWarps) {
    const int rt = tl.t0 + lt;
    const bool core = (s.core[rt] >> lane) & 1u;
    push_tile(s, par ^ 1, rt, s.core[rt],
              __reduce_min_sync(kFull,
                                core ? s.lab[par][lt * 32 + lane] : kInf),
              cluster);
  }
  cluster.sync();
  if (s.lcap)
    relax_lists(s, tl, par, s.core, true, cluster);
  else
    relax(s, g, tl, par, s.core, s.all[par ^ 1][1], true, cluster);
  __syncthreads();
  for (int lt = warp; lt < tl.own; lt += kWarps) {
    const int rt = tl.t0 + lt, row = rt * 32 + lane;
    if (row < tl.nv) {
      const int32_t m = s.acc[lt * 32 + lane];
      __stcg(dst + __ldcg(g.cidx + row), m < kInf ? m : -1);
    }
  }
  // dst is read by the next stage, and no CTA reads or writes this one's
  // shared memory after this
  sync_cluster(cluster);
}

__global__ void __launch_bounds__(kThreads, 1)
dbscan_big_kernel(const float* __restrict__ pts,
                  const uint8_t* __restrict__ valid,
                  const float* __restrict__ params, int32_t* labels,
                  int32_t* scratch, int n, int stages, int max_iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BigSmem& s = *reinterpret_cast<BigSmem*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int set = blockIdx.x / csize;
  const BigScratch g =
      big_scratch(scratch + static_cast<size_t>(set) * big_scratch_words(n), n);
  int32_t* out = labels + static_cast<size_t>(set) * n;
  const float* p = pts + static_cast<size_t>(set) * n * 3;
  const uint8_t* v = valid + static_cast<size_t>(set) * n;
#ifdef DBSCAN_CLOCKS
  CLOCK_VALUE(12, global_ns());
#endif
  CLOCK_STAMP(0);

  // -1 everywhere first: a stage writes only the labels of its points
  for (int i = rank * kThreads + threadIdx.x; i < n; i += csize * kThreads) {
    __stcg(out + i, -1);
    __stcg(g.out1 + i, -1);
  }
  const int nv = order_points(s, g, p, v, n, rank, csize, cluster);
  CLOCK_STAMP(1);
  for (int stage = 0; stage < stages; ++stage) {
    const float eps2 = params[set * 4 + 2 * stage];
    const int min_samples = static_cast<int>(params[set * 4 + 2 * stage + 1]);
    const Tiles tl = compact_stage(s, g, p, stage > 0 ? g.out1 : nullptr, nv,
                                   rank, csize, cluster);
    CLOCK_STAMP(2 + 4 * stage);
    build_blocks(s, g, tl, eps2, min_samples, cluster);
    CLOCK_STAMP(3 + 4 * stage);
    int sweeps;
    const int par =
        sweep_blocks(s, g, tl, max_iters, &sweeps, rank, stage, cluster);
    CLOCK_STAMP(4 + 4 * stage);
    CLOCK_VALUE(10 + stage, sweeps);
    label_stage(s, g, tl, par, stage + 1 < stages ? g.out1 : out, cluster);
    CLOCK_STAMP(5 + 4 * stage);
  }
#ifdef DBSCAN_CLOCKS
  CLOCK_VALUE(13, global_ns());
#endif
}

// Same launch shape and shared memory as the kernel of struct S, no work:
// the launch floor.
template <typename S>
__global__ void __launch_bounds__(kThreads, 1) empty_kernel(S*) {}

// Shared memory and the non-portable cluster sizes, set once per kernel.
template <typename S, typename... KArgs>
cudaError_t prepare(void (*kernel)(KArgs...)) {
  static cudaError_t err = [kernel] {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(S)));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  return err;
}

cudaLaunchConfig_t launch_config(int sets, int cluster, size_t smem,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sets * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
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
template <typename S, typename... KArgs>
int auto_cluster(void (*kernel)(KArgs...)) {
  static const int chosen = [kernel] {
    if (prepare<S>(kernel) != cudaSuccess) return 8;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        launch_config(1, 16, sizeof(S), nullptr, &attr);
    int fits = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&fits, kernel, &cfg);
    if (e != cudaSuccess) cudaGetLastError();   // not sticky: clear it
    return e == cudaSuccess && fits >= 1 ? 16 : 8;
  }();
  return chosen;
}

// Launch `kernel`, whose shared memory is S, as `sets` clusters of
// `cluster` CTAs.
template <typename S, typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), int sets, int cluster,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = prepare<S>(kernel);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(
      sets, cluster ? cluster : auto_cluster<S>(kernel), sizeof(S), stream,
      &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool bad_shape(int sets, int n, int cluster) {
  return sets < 1 || n < 1 || n > kBigMaxPoints || cluster < 0 ||
         cluster > 16 || (cluster & (cluster - 1)) != 0;
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream` and
// returns the launch's CUDA error (0 on success); none synchronises.
//
// points [sets, n, 3] f32, valid [sets, n] u8, params [sets, 4] f32 =
// (eps_1^2, min_samples_1, eps_2^2, min_samples_2), labels [sets, n] i32;
// n <= 1024 runs the shared-memory kernel, 1024 < n <= 65536 the sparse
// one, with `scratch` of dbscan_scratch_words(n) int32 per set (null for
// n <= 1024); stages 1 (first DBSCAN only) or 2; cluster CTAs per set
// (1..16, a power of two; above 8 needs a GPC with that many free SMs;
// above 1024 points at least n / dbscan_rows_per_cta()), or 0 for 16 where
// the card can place it, else 8.
extern "C" int dbscan_two_stage_launch(const float* points,
                                       const uint8_t* valid,
                                       const float* params, int32_t* labels,
                                       int32_t* scratch, int sets, int n,
                                       int stages, int max_iters, int cluster,
                                       void* stream) {
  if (bad_shape(sets, n, cluster) || stages < 1 || stages > 2 ||
      max_iters < 0 || (n > kMaxPoints && scratch == nullptr) ||
      (n > kMaxPoints &&
       n > (cluster ? cluster : auto_cluster<BigSmem>(dbscan_big_kernel)) *
               kRowsPerCta))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= kMaxPoints)
    return static_cast<int>(launch<Smem>(dbscan_kernel, sets, cluster, st,
                                          points, valid, params, labels, n,
                                          stages, max_iters));
  return static_cast<int>(launch<BigSmem>(dbscan_big_kernel, sets, cluster,
                                          st, points, valid, params, labels,
                                          scratch, n, stages, max_iters));
}

// int32 words of scratch per set that dbscan_two_stage_launch needs at n.
extern "C" long long dbscan_scratch_words(int n) {
  return n > kMaxPoints ? static_cast<long long>(big_scratch_words(n)) : 0;
}

// The largest n the kernels take.
extern "C" int dbscan_max_points() { return kBigMaxPoints; }

// The labels a CTA holds above 1024 points: a set of n points needs
// n / dbscan_rows_per_cta() CTAs or more.
extern "C" int dbscan_rows_per_cta() { return kRowsPerCta; }

#ifdef DBSCAN_CLOCKS
// Where dbscan_big_kernel writes its phase stamps (kStamps int64 per CTA,
// blockIdx-major); null stops them.
extern "C" int dbscan_set_clock_buffer(void* buf) {
  long long* p = static_cast<long long*>(buf);
  return static_cast<int>(cudaMemcpyToSymbol(g_clocks, &p, sizeof(p)));
}
#endif

extern "C" int dbscan_empty_launch(int sets, int n, int cluster,
                                   void* stream) {
  if (bad_shape(sets, n, cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= kMaxPoints)
    return static_cast<int>(launch<Smem>(empty_kernel<Smem>, sets, cluster,
                                         st, static_cast<Smem*>(nullptr)));
  return static_cast<int>(launch<BigSmem>(empty_kernel<BigSmem>, sets,
                                          cluster, st,
                                          static_cast<BigSmem*>(nullptr)));
}

// The cluster size that `cluster = 0` launches with at n.
extern "C" int dbscan_auto_cluster(int n) {
  return n <= kMaxPoints ? auto_cluster<Smem>(dbscan_kernel)
                         : auto_cluster<BigSmem>(dbscan_big_kernel);
}
