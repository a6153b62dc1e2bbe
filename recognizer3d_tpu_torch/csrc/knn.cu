// Exact neighbour search kernels for Hopper (sm_90a), C ABI for ctypes.
//
// r3d_knn_topk replaces recognizer3d_tpu/ops/knn_pallas.py::_knn_kernel
// (exact k-NN, k <= 128). r3d_argmin replaces ::_argmin_kernel (exact
// streaming 1-NN). Both compute what the TPU kernels compute, not how:
// the TPU kernels Morton-sort, cull support tiles by bounding box and
// merge survivors through packed keys, all to save VMEM sweeps; exactness
// never depends on that machinery, so these versions are brute force.
//
// r3d_knn_window replaces the lax.approx_min_k selection inside
// recognizer3d_tpu/ops/knn.py::knn_window (the Morton-window search of
// knn="approximate"): on Morton-sorted clouds, query block j (query_block
// consecutive queries) searches only support[starts[j], starts[j] + w).
// It runs the same two kernels over the window instead of the whole
// support (k >= 2: the KNN kernel; k = 1: the argmin kernel) and selects
// EXACTLY within the window, where the TPU's approx_min_k is a partial
// reduction with recall_target < 1: the in-window recall is 1 here. A CUDA
// block's queries lie in one query block (the launcher refuses a
// query_block that is not a multiple of the block's query count), so the
// block stages one window.
//
// KNN design. One warp owns one query; the block's warps share support
// tiles staged in shared memory. The warp holds the sorted best list in
// registers, spread across lanes (entry p = 32*r + lane, r < R, R*32 >= k).
// Each step the 32 lanes evaluate 32 support points at once; a ballot
// collects the points closer than the current k-th best, and each such
// candidate is inserted by the whole warp: its position is a popcount of
// a ballot, the shift is a shuffle. So the insertions, which are rare
// after the first few steps, cost a few warp instructions each and never
// diverge. (One thread per query with the list in shared memory took 1.65
// ms at N = 2,500 on an H100: the lanes' insertions fall at different
// steps, and the warp executes the union of them.)
//
// Ties: candidates arrive in increasing support index and enter behind
// every entry with an equal distance, and one equal to the k-th best is
// refused; so the list equals the first k entries of a stable sort by
// distance, which is the plain version's order.
//
// argmin design: one thread per query, a running (min, argmin) in
// registers; strict "<" keeps the first index on ties, as torch.min does.
//
// Bound on this card. The work is O(M*N) distance evaluations (8 float32
// operations each) against O((M+N)*12) bytes of input, so both kernels are
// bound by operations: the N = 2,500 self-KNN is 50 Mflop, the
// 2,500 -> 61,440 upsample 1.2 Gflop. Culling tiles by box bounds (as the
// TPU kernels do) is what would cut the operations themselves. The window
// search is O(M*w): 65,536 queries over 4,096-point windows are 2.1 Gflop.
//
// Distances: ((dx*dx + dy*dy) + dz*dz) with explicitly rounded intrinsics.
// nvcc would otherwise contract a*a+b into an FMA, and the distances would
// drift an ulp from the plain PyTorch version, flipping near-tied index
// sets. With the intrinsics they are bit-identical.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int KNN_WARPS = 8;       // queries per block, one warp each
constexpr int KNN_TILE = 1024;     // support points staged per step
constexpr int ARGMIN_THREADS = 256;
constexpr int ARGMIN_TILE = 1024;

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float sx, float sy, float sz) {
  const float dx = __fsub_rn(qx, sx);
  const float dy = __fsub_rn(qy, sy);
  const float dz = __fsub_rn(qz, sz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Best list of capacity 32 * R, R registers per lane; requires k <= 32 * R.
// Searches W support rows from the block's window start (all N rows when
// starts is null; then W = N).
template <int R>
__global__ void knn_topk_kernel(const float* __restrict__ query,
                                const float* __restrict__ support,
                                const int* __restrict__ starts,
                                int* __restrict__ idx_out,
                                float* __restrict__ d2_out,
                                int M, int N, int W, int qb, int k) {
  __shared__ float s_pts[KNN_TILE * 3];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int m = blockIdx.x * KNN_WARPS + (threadIdx.x >> 5);
  const bool active = m < M;  // uniform across the warp
  const float* q = query + (static_cast<size_t>(b) * M + (active ? m : 0)) * 3;
  const float qx = q[0], qy = q[1], qz = q[2];
  const int start = starts ? starts[blockIdx.x * KNN_WARPS / qb] : 0;
  const float* s = support + (static_cast<size_t>(b) * N + start) * 3;

  float best_d[R];
  int best_i[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    best_d[r] = CUDART_INF_F;
    best_i[r] = 0;
  }
  const int kth_reg = (k - 1) >> 5, kth_lane = (k - 1) & 31;
  float theta = CUDART_INF_F;  // current k-th best distance, warp-uniform

  for (int base = 0; base < W; base += KNN_TILE) {
    const int n_tile = min(KNN_TILE, W - base);
    __syncthreads();
    for (int t = threadIdx.x; t < n_tile * 3; t += blockDim.x) {
      s_pts[t] = s[static_cast<size_t>(base) * 3 + t];
    }
    __syncthreads();
    if (!active) continue;
    for (int j0 = 0; j0 < n_tile; j0 += 32) {
      const int j = j0 + lane;
      const float d = j < n_tile ? sq_dist(qx, qy, qz, s_pts[3 * j],
                                           s_pts[3 * j + 1], s_pts[3 * j + 2])
                                 : CUDART_INF_F;
      unsigned cand = __ballot_sync(FULL, d < theta);
      while (cand) {
        const int src = __ffs(cand) - 1;
        cand &= cand - 1;
        const float cd = __shfl_sync(FULL, d, src);
        if (!(cd < theta)) continue;  // theta fell since the ballot
        const int ci = base + j0 + src;
        // insertion position: every entry <= cd stays in front
        int pos = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) pos += __popc(__ballot_sync(FULL, best_d[r] <= cd));
        // entries at positions >= pos move up one; the last one drops out
        float nd[R];
        int ni[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float prev_d = __shfl_up_sync(FULL, best_d[r], 1);
          int prev_i = __shfl_up_sync(FULL, best_i[r], 1);
          if (r > 0) {
            const float carry_d = __shfl_sync(FULL, best_d[r > 0 ? r - 1 : 0], 31);
            const int carry_i = __shfl_sync(FULL, best_i[r > 0 ? r - 1 : 0], 31);
            if (lane == 0) {
              prev_d = carry_d;
              prev_i = carry_i;
            }
          }
          const int p = 32 * r + lane;
          nd[r] = p < pos ? best_d[r] : (p == pos ? cd : prev_d);
          ni[r] = p < pos ? best_i[r] : (p == pos ? ci : prev_i);
        }
        float kth = best_d[0];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          best_d[r] = nd[r];
          best_i[r] = ni[r];
          if (r == kth_reg) kth = nd[r];
        }
        theta = __shfl_sync(FULL, kth, kth_lane);
      }
    }
  }
  if (!active) return;
  const size_t out = (static_cast<size_t>(b) * M + m) * k;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = 32 * r + lane;
    if (p < k) {
      idx_out[out + p] = best_i[r] + start;
      d2_out[out + p] = best_d[r];
    }
  }
}

// One thread per query (blockDim.x queries a block); W support rows from the
// block's window start, as in knn_topk_kernel.
__global__ void argmin_kernel(const float* __restrict__ query,
                              const float* __restrict__ support,
                              const int* __restrict__ starts,
                              int* __restrict__ idx_out,
                              float* __restrict__ d2_out, int M, int N, int W,
                              int qb) {
  __shared__ float s_pts[ARGMIN_TILE * 3];
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int m = blockIdx.x * blockDim.x + tid;
  const bool active = m < M;
  const float* q = query + (static_cast<size_t>(b) * M + (active ? m : 0)) * 3;
  const float qx = q[0], qy = q[1], qz = q[2];
  const int start = starts ? starts[blockIdx.x * blockDim.x / qb] : 0;
  const float* s = support + (static_cast<size_t>(b) * N + start) * 3;

  float best = CUDART_INF_F;
  int best_i = 0;
  for (int base = 0; base < W; base += ARGMIN_TILE) {
    const int n_tile = min(ARGMIN_TILE, W - base);
    __syncthreads();
    for (int t = tid; t < n_tile * 3; t += blockDim.x) {
      s_pts[t] = s[static_cast<size_t>(base) * 3 + t];
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < n_tile; ++j) {
      const float d = sq_dist(qx, qy, qz, s_pts[3 * j], s_pts[3 * j + 1],
                              s_pts[3 * j + 2]);
      if (d < best) {
        best = d;
        best_i = base + j;
      }
    }
  }
  if (!active) return;
  idx_out[static_cast<size_t>(b) * M + m] = best_i + start;
  d2_out[static_cast<size_t>(b) * M + m] = best;
}

void launch_knn(const float* query, const float* support, const int* starts,
                int* idx, float* d2, int B, int M, int N, int W, int qb, int k,
                cudaStream_t stream) {
  const dim3 grid((M + KNN_WARPS - 1) / KNN_WARPS, B);
  const dim3 block(KNN_WARPS * 32);
  if (k <= 32) {
    knn_topk_kernel<1><<<grid, block, 0, stream>>>(query, support, starts, idx,
                                                    d2, M, N, W, qb, k);
  } else if (k <= 64) {
    knn_topk_kernel<2><<<grid, block, 0, stream>>>(query, support, starts, idx,
                                                    d2, M, N, W, qb, k);
  } else {
    knn_topk_kernel<4><<<grid, block, 0, stream>>>(query, support, starts, idx,
                                                    d2, M, N, W, qb, k);
  }
}

}  // namespace

// query (B, M, 3), support (B, N, 3) float32; idx (B, M, k) int32 and
// d2 (B, M, k) float32 out, nearest first. Returns cudaGetLastError().
extern "C" int r3d_knn_topk(const float* query, const float* support,
                            int* idx, float* d2, int B, int M, int N, int k,
                            void* stream) {
  if (B == 0 || M == 0) return 0;
  if (k < 1 || k > 128 || k > N) return static_cast<int>(cudaErrorInvalidValue);
  launch_knn(query, support, nullptr, idx, d2, B, M, N, N, 1, k,
             static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// query (B, M, 3), support (B, N, 3) float32; idx (B, M) int32 and
// d2 (B, M) float32 out. Returns cudaGetLastError().
extern "C" int r3d_argmin(const float* query, const float* support, int* idx,
                          float* d2, int B, int M, int N, void* stream) {
  if (B == 0 || M == 0) return 0;
  if (N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + ARGMIN_THREADS - 1) / ARGMIN_THREADS, B);
  argmin_kernel<<<grid, ARGMIN_THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(query, support, nullptr,
                                                       idx, d2, M, N, N, 1);
  return static_cast<int>(cudaGetLastError());
}

// query (B, M, 3) and support (B, N, 3) float32, both Morton-sorted; starts
// (ceil(M / qb),) int32 window starts in [0, N - w]. idx (B, M, k) int32
// (into the support as given) and d2 (B, M, k) float32 out, nearest first.
// k >= 2 needs qb % 8 == 0, k = 1 needs qb % 32 == 0. Returns
// cudaGetLastError().
extern "C" int r3d_knn_window(const float* query, const float* support,
                              const int* starts, int* idx, float* d2, int B,
                              int M, int N, int w, int qb, int k,
                              void* stream) {
  if (B == 0 || M == 0) return 0;
  if (k < 1 || k > 128 || k > w || w > N || qb < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 1) {
    int threads = ARGMIN_THREADS;  // the largest power of two <= 256 dividing qb
    while (threads > 32 && qb % threads != 0) threads >>= 1;
    if (qb % threads != 0) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((M + threads - 1) / threads, B);
    argmin_kernel<<<grid, threads, 0, s>>>(query, support, starts, idx, d2, M,
                                           N, w, qb);
  } else {
    if (qb % KNN_WARPS != 0) return static_cast<int>(cudaErrorInvalidValue);
    launch_knn(query, support, starts, idx, d2, B, M, N, w, qb, k, s);
  }
  return static_cast<int>(cudaGetLastError());
}
