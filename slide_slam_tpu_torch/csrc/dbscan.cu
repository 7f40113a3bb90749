// Fused dense DBSCAN for one point set of N <= 1024 points, on one thread
// block of an sm_90a card.
//
// Replaces the Pallas TPU kernel slide_slam_tpu/frontend/clustering_pallas.py
// `_dbscan_kernel` (launched by `dbscan_pallas`), and computes what the XLA
// function on the JAX frontend's path computes, clustering.dbscan:
//   * d2 from coordinate differences, ((dx*dx + dy*dy) + dz*dz), every product
//     and sum rounded on its own (__fmul_rn / __fadd_rn, so no FMA
//     contraction): the eps test gives the same bits as the plain PyTorch
//     version. The Pallas body forms |p|^2 + |q|^2 - 2 p.q instead, which
//     cancels ~1e-3 of d2 at 50 m coordinates;
//   * core = valid and degree >= min_samples, degree counting self and
//     valid neighbours only;
//   * min-label propagation over core-core edges, SYNCHRONOUS (Jacobi) sweeps
//     from a double-buffered label array, stopping when a sweep changes
//     nothing or after max_iters sweeps (the XLA while_loop's exit; the
//     Pallas kernel always runs 64 sweeps, which gives the same labels only
//     because the sweeps are synchronous);
//   * border points take the min label of their core neighbours; noise and
//     invalid points get -1. A cluster's id is its lowest member index.
//
// Design. One thread per point, everything in dynamic shared memory:
//   points (3 x N f32), the N x N eps-adjacency as a bitmask with a row
//   stride of W+1 words (W = ceil(N/32); the odd stride keeps the row-per-
//   thread writes free of bank conflicts), a core bitmask (W words), two
//   label buffers (2 x N int32) and the valid flags. At N = 1024 that is
//   12 KB + 132 KB + 128 B + 8 KB + 1 KB, under the 227 KB a block may use;
//   the bitmask stands in for the Pallas kernel's 4 MB f32 VMEM mask. The
//   adjacency is built once; each sweep walks only the set bits of
//   (row AND core) with __ffs, so a sweep costs O(edges), and
//   __syncthreads_or ends the loop as soon as a sweep changes nothing.
//
// What bounds it: one block on one of the card's 132 SMs, so the kernel is
// latency-bound (synchronisation between sweeps and the serial bit walk),
// far from both the memory and the arithmetic bound of the card. Spreading a
// problem over several blocks (a cluster sharing the bitmask through
// distributed shared memory) or batching the per-class problems as a grid
// are left to later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPoints = 1024;

__device__ __forceinline__ float dist2(float xi, float yi, float zi, float xj,
                                       float yj, float zj) {
  float dx = __fsub_rn(xi, xj);
  float dy = __fsub_rn(yi, yj);
  float dz = __fsub_rn(zi, zj);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__global__ void dbscan_kernel(const float* __restrict__ pts,
                              const int32_t* __restrict__ valid, int n,
                              float eps2, int min_samples, int max_iters,
                              int32_t* __restrict__ labels_out) {
  extern __shared__ uint32_t smem[];
  const int W = (n + 31) / 32;
  const int stride = W + 1;
  uint32_t* adj = smem;                          // n * stride
  uint32_t* core_bits = adj + n * stride;        // W
  float* px = reinterpret_cast<float*>(core_bits + W);
  float* py = px + n;
  float* pz = py + n;
  int32_t* lab_a = reinterpret_cast<int32_t*>(pz + n);
  int32_t* lab_b = lab_a + n;
  uint8_t* vld = reinterpret_cast<uint8_t*>(lab_b + n);

  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const bool live = i < n;
  const int32_t kInf = n + 1;

  if (live) {
    px[i] = pts[3 * i + 0];
    py[i] = pts[3 * i + 1];
    pz[i] = pts[3 * i + 2];
    vld[i] = valid[i] != 0;
  }
  __syncthreads();

  // ---- adjacency row i and degree ------------------------------------------
  int degree = 0;
  bool vi = false;
  if (live) {
    vi = vld[i];
    const float xi = px[i], yi = py[i], zi = pz[i];
    for (int w = 0; w < W; ++w) {
      uint32_t bits = 0;
      if (vi) {
        const int j0 = w * 32;
        const int jn = min(32, n - j0);
        for (int b = 0; b < jn; ++b) {
          const int j = j0 + b;
          // px[j] is the same address for the whole warp: a broadcast
          const float d2 = dist2(xi, yi, zi, px[j], py[j], pz[j]);
          if (vld[j] && d2 <= eps2) bits |= 1u << b;
        }
      }
      adj[i * stride + w] = bits;
      degree += __popc(bits);
    }
  }
  const bool core = live && vi && degree >= min_samples;
  // one word of the core bitmask per warp (all 32 lanes take part)
  const uint32_t ballot = __ballot_sync(0xffffffffu, core);
  if (lane == 0 && warp < W) core_bits[warp] = ballot;
  if (live) lab_a[i] = core ? i : kInf;
  __syncthreads();

  // ---- synchronous min-label sweeps over core-core edges --------------------
  int32_t* cur = lab_a;
  int32_t* nxt = lab_b;
  for (int it = 0; it < max_iters; ++it) {
    int changed = 0;
    if (live) {
      int32_t m = cur[i];
      if (core) {
        for (int w = 0; w < W; ++w) {
          uint32_t bits = adj[i * stride + w] & core_bits[w];
          while (bits) {
            const int b = __ffs(bits) - 1;
            m = min(m, cur[w * 32 + b]);
            bits &= bits - 1;
          }
        }
      }
      nxt[i] = m;
      changed = m != cur[i];
    }
    const int any = __syncthreads_or(changed);
    int32_t* t = cur;
    cur = nxt;
    nxt = t;
    if (!any) break;
  }

  // ---- border points and output ---------------------------------------------
  if (live) {
    int32_t out = -1;
    if (core) {
      out = cur[i];
    } else if (vi) {
      int32_t m = kInf;
      for (int w = 0; w < W; ++w) {
        uint32_t bits = adj[i * stride + w] & core_bits[w];
        while (bits) {
          const int b = __ffs(bits) - 1;
          m = min(m, cur[w * 32 + b]);
          bits &= bits - 1;
        }
      }
      out = m < kInf ? m : -1;
    }
    labels_out[i] = out;
  }
}

size_t smem_bytes(int n) {
  const size_t W = (n + 31) / 32;
  return 4 * (n * (W + 1) + W) + 3 * 4 * n + 2 * 4 * n + n;
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises.
extern "C" int dbscan_launch(const float* pts, const int32_t* valid,
                             int32_t* labels, int n, float eps2,
                             int min_samples, int max_iters, void* stream) {
  if (n < 1 || n > kMaxPoints) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      dbscan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = ((n + 31) / 32) * 32;
  dbscan_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      pts, valid, n, eps2, min_samples, max_iters, labels);
  return static_cast<int>(cudaGetLastError());
}
