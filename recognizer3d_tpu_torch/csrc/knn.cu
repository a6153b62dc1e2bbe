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
// It selects EXACTLY within the window, where the TPU's approx_min_k is a
// partial reduction with recall_target < 1: the in-window recall is 1
// here. k >= 2 runs knn_window_kernel (below); k = 1 runs the argmin
// kernel over the window (a CUDA block's queries lie in one query block:
// the launcher refuses a query_block that is not a multiple of the
// block's query count, so the block stages one window).
//
// knn_window_kernel. What bounds it on this card is the selection, not the
// distances: on a Morton-sorted 65,536-point mock level at w = 4,096 and
// k = 32, scanning each window in increasing index from its start (about
// 2,048 curve positions away from the query) with an empty best list makes
// 414 insertions a query on average, each 15-20 warp instructions, against
// 128 warp steps of distances (benchmarks/window_select.py counts them).
// The design:
// - one CUDA block owns up to 32 queries of one query block and stages
//   the window once, as x | y | z arrays in shared memory (12 bytes a
//   point: 192 KB at w = 16,384, the widest rung of the recall guard);
// - a warp scans GROUP = 2 consecutive queries together: each lane loads
//   a window point and computes its distance to both, so a shared-memory
//   load serves 2 pairs (groups of 4 measured slower on the H100: more
//   registers, and the queries' insertions run one after another);
// - warm start: the 64R window points around the group's position on the
//   curve are sorted by (distance, index) with a warp bitonic network and
//   the first 32R kept as the best list, so theta starts at an upper bound
//   of the true k-th distance instead of +inf;
// - the rest of the window is scanned in rings of two tiles of 32, one
//   right and one left of the range scanned so far, outward from the warm
//   range: theta is near its final value from the start, and 31
//   insertions a query remain on that level. One vote per ring tells the
//   warp whether any of its 4 (query, tile) pairs has a candidate;
// - each remaining insertion is one warp-wide step as in knn_topk_kernel
//   (position by ballot + popcount, shift by shuffles). A thread queue
//   merged by a bitonic network (WarpSelect) does not pay at 31 insertions
//   a query: with queues of 2, some lane fills after about 8 candidates,
//   and each merge costs about 250 warp instructions.
// The scan is no longer in index order, so every comparison (the filter,
// the insertion position, the refusal) is lexicographic on (distance,
// index): the list is then the first k of a stable sort by distance,
// which is the plain version's order. Windows wider than shared memory
// holds (over 19,370 points; no path asks for one) take knn_topk_kernel
// with the window start table.
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
// Bound on this card. The work is O(M*N) distance evaluations against
// O((M+N)*12) bytes of input, so all three are bound by operations: 9 lane
// instructions a pair (3 subtractions, 3 multiplications, 2 additions, a
// compare; no FMA, see below) at 33.5 T instructions/s. The N = 2,500
// self-KNN is 56 M instructions, the 2,500 -> 61,440 upsample 1.4 G.
// Culling tiles by box bounds (as the TPU kernels do) is what would cut
// the operations themselves. The window search is O(M*w): 65,536 queries
// over 4,096-point windows are 2.4 G instructions, 0.072 ms.
//
// Distances: ((dx*dx + dy*dy) + dz*dz) with explicitly rounded intrinsics.
// nvcc would otherwise contract a*a+b into an FMA, and the distances would
// drift an ulp from the plain PyTorch version, flipping near-tied index
// sets. With the intrinsics they are bit-identical.

#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int KNN_WARPS = 8;       // queries per block, one warp each
constexpr int KNN_TILE = 1024;     // support points staged per step
constexpr int ARGMIN_THREADS = 256;
constexpr int ARGMIN_TILE = 1024;
constexpr int WIN_WARPS = 8;       // knn_window_kernel: warps per block,
constexpr int WIN_GROUP = 2;       // queries a warp scans together,
constexpr int WIN_QUERIES = 32;    // queries per block
constexpr int WIN_MAX_SMEM = 232448;  // shared memory a block may use

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

// (ad, ai) before (bd, bi) in the order of a stable sort by distance
// (bitwise operators: no short-circuit branches in the hot loops)
__device__ __forceinline__ bool lex_less(float ad, int ai, float bd, int bi) {
  return (ad < bd) | ((ad == bd) & (ai < bi));
}

// Sorts the warp's 32 * E (distance, index) pairs, element p = 32 * e + lane,
// ascending by lex_less: a bitonic network, partners by shuffle for strides
// below 32 and within the lane's registers above.
template <int E>
__device__ __forceinline__ void warp_sort(float (&d)[E], int (&i)[E], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * E; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {
        const int es = stride >> 5;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (e & es) continue;
          const int f = e | es;
          const bool up = ((32 * e) & size) == 0;
          const bool swap = up ? lex_less(d[f], i[f], d[e], i[e])
                               : lex_less(d[e], i[e], d[f], i[f]);
          if (swap) {
            const float td = d[e];
            const int ti = i[e];
            d[e] = d[f];
            i[e] = i[f];
            d[f] = td;
            i[f] = ti;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float od = __shfl_xor_sync(FULL, d[e], stride);
          const int oi = __shfl_xor_sync(FULL, i[e], stride);
          const int p = 32 * e + lane;
          const bool want_min = ((p & stride) == 0) == ((p & size) == 0);
          const bool take = want_min ? lex_less(od, oi, d[e], i[e])
                                     : lex_less(d[e], i[e], od, oi);
          if (take) {
            d[e] = od;
            i[e] = oi;
          }
        }
      }
    }
  }
}

// Inserts (cd, ci) into the warp's sorted list (entry p = 32 * r + lane)
// behind every entry lexicographically before it; the last entry drops.
template <int R>
__device__ __forceinline__ void list_insert(float (&bd)[R], int (&bi)[R],
                                            float cd, int ci, int lane) {
  int pos = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    pos += __popc(__ballot_sync(FULL, lex_less(bd[r], bi[r], cd, ci)));
  }
  float nd[R];
  int ni[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float prev_d = __shfl_up_sync(FULL, bd[r], 1);
    int prev_i = __shfl_up_sync(FULL, bi[r], 1);
    if (r > 0) {
      const float carry_d = __shfl_sync(FULL, bd[r > 0 ? r - 1 : 0], 31);
      const int carry_i = __shfl_sync(FULL, bi[r > 0 ? r - 1 : 0], 31);
      if (lane == 0) {
        prev_d = carry_d;
        prev_i = carry_i;
      }
    }
    const int p = 32 * r + lane;
    nd[r] = p < pos ? bd[r] : (p == pos ? cd : prev_d);
    ni[r] = p < pos ? bi[r] : (p == pos ? ci : prev_i);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    bd[r] = nd[r];
    bi[r] = ni[r];
  }
}

// The list's k-th entry, on every lane.
template <int R>
__device__ __forceinline__ void list_kth(const float (&bd)[R], const int (&bi)[R],
                                         int k, float& thd, int& thi) {
  const int kth_reg = (k - 1) >> 5;
  float d = bd[0];
  int i = bi[0];
#pragma unroll
  for (int r = 1; r < R; ++r) {
    if (r == kth_reg) {
      d = bd[r];
      i = bi[r];
    }
  }
  thd = __shfl_sync(FULL, d, (k - 1) & 31);
  thi = __shfl_sync(FULL, i, (k - 1) & 31);
}

// Offers the ballot's candidates (lane src holds distance d of window
// point base + src) to the list in lane order; each enters if it is
// lexicographically before the current k-th entry, and theta follows.
template <int R>
__device__ __forceinline__ void take_candidates(unsigned cand, float d, int base,
                                                float (&bd)[R], int (&bi)[R],
                                                float& thd, int& thi, int k, int lane) {
  while (cand) {
    const int src = __ffs(cand) - 1;
    cand &= cand - 1;
    const float cd = __shfl_sync(FULL, d, src);
    const int ci = base + src;
    if (!lex_less(cd, ci, thd, thi)) continue;  // refused
    list_insert<R>(bd, bi, cd, ci, lane);
    list_kth<R>(bd, bi, k, thd, thi);
  }
}

// Window k-NN, k <= 32 * R (see the design note at the top). Block
// blockIdx.x owns queries [lo, hi) of query block jb; dynamic shared memory
// holds the window as x[w] | y[w] | z[w].
template <int R>
__global__ void __launch_bounds__(WIN_WARPS * 32)
knn_window_kernel(const float* __restrict__ query,
                  const float* __restrict__ support,
                  const int* __restrict__ starts, int* __restrict__ idx_out,
                  float* __restrict__ d2_out, int M, int N, int w, int qb,
                  int k) {
  constexpr int E = 2 * R;  // warm start: 32 * E points, 32 * R kept
  constexpr int Q = WIN_GROUP;
  extern __shared__ float s_win[];
  float* sx = s_win;
  float* sy = s_win + w;
  float* sz = s_win + 2 * w;
  const int subs = (qb + WIN_QUERIES - 1) / WIN_QUERIES;
  const int jb = blockIdx.x / subs;
  const int lo = jb * qb + (blockIdx.x - jb * subs) * WIN_QUERIES;
  const int hi = min(min(lo + WIN_QUERIES, jb * qb + qb), M);
  if (lo >= hi) return;  // uniform across the block
  const int b = blockIdx.y;
  const int start = starts[jb];
  const float* s = support + (static_cast<size_t>(b) * N + start) * 3;
  for (int t = threadIdx.x; t < 3 * w; t += blockDim.x) {
    const int p = t / 3;
    s_win[(t - 3 * p) * w + p] = s[t];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int g0 = lo + (threadIdx.x >> 5) * Q; g0 < hi; g0 += WIN_WARPS * Q) {
    const int nq = min(Q, hi - g0);
    float qx[Q], qy[Q], qz[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {  // a short group repeats its last query
      const float* qp = query + (static_cast<size_t>(b) * M + g0 + min(q, nq - 1)) * 3;
      qx[q] = qp[0];
      qy[q] = qp[1];
      qz[q] = qp[2];
    }
    // the group's middle query mapped onto the support curve, in the window
    const int mid = g0 + nq / 2;
    const int c = static_cast<int>(static_cast<long long>(mid) * N / M) - start;
    const int a0 = min(max(c - 16 * E, 0), max(w - 32 * E, 0));

    float best_d[Q][R], thd[Q];
    int best_i[Q][R], thi[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      float d[E];
      int i[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int j = a0 + 32 * e + lane;
        if (j < w) {
          d[e] = sq_dist(qx[q], qy[q], qz[q], sx[j], sy[j], sz[j]);
          i[e] = j;
        } else {
          d[e] = CUDART_INF_F;
          i[e] = INT_MAX;
        }
      }
      warp_sort<E>(d, i, lane);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        best_d[q][r] = d[r];
        best_i[q][r] = i[r];
      }
      list_kth<R>(best_d[q], best_i[q], k, thd[q], thi[q]);
    }

    // outward from the warm range: ring t is the right tile at a0 + 32(E + t)
    // and the left tile at a0 - 32(t + 1), scanned in that order (a side
    // that has run out of window is masked)
    const int n_right = (w - a0 - 32 * E + 31) / 32;
    const int n_left = (a0 + 31) / 32;
    const int n_rings = max(max(n_right, n_left), 0);
    for (int t = 0; t < n_rings; ++t) {
      const int jr = a0 + 32 * (E + t) + lane;
      const int jl = a0 - 32 * (t + 1) + lane;
      const bool vr = jr < w, vl = jl >= 0;
      const int ir = vr ? jr : 0, il = vl ? jl : 0;
      const float rx = sx[ir], ry = sy[ir], rz = sz[ir];
      const float lx = sx[il], ly = sy[il], lz = sz[il];
      float dr[Q], dl[Q];
      bool pass = false;  // superset of the lexicographic tests below
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        dr[q] = sq_dist(qx[q], qy[q], qz[q], rx, ry, rz);
        dl[q] = sq_dist(qx[q], qy[q], qz[q], lx, ly, lz);
        pass |= (vr & (dr[q] <= thd[q])) | (vl & (dl[q] <= thd[q]));
      }
      if (!__any_sync(FULL, pass)) continue;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        take_candidates<R>(__ballot_sync(FULL, vr & (dr[q] <= thd[q])), dr[q], jr - lane,
                           best_d[q], best_i[q], thd[q], thi[q], k, lane);
        take_candidates<R>(__ballot_sync(FULL, vl & (dl[q] <= thd[q])), dl[q], jl - lane,
                           best_d[q], best_i[q], thd[q], thi[q], k, lane);
      }
    }

#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (q >= nq) break;
      const size_t out = (static_cast<size_t>(b) * M + g0 + q) * k;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int p = 32 * r + lane;
        if (p < k) {
          idx_out[out + p] = best_i[q][r] + start;
          d2_out[out + p] = best_d[q][r];
        }
      }
    }
  }
}

template <int R>
int launch_window(const float* query, const float* support, const int* starts,
                  int* idx, float* d2, int B, int M, int N, int w, int qb,
                  int k, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_window_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int subs = (qb + WIN_QUERIES - 1) / WIN_QUERIES;
  const dim3 grid(((M + qb - 1) / qb) * subs, B);
  knn_window_kernel<R><<<grid, WIN_WARPS * 32, smem, stream>>>(
      query, support, starts, idx, d2, M, N, w, qb, k);
  return 0;
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
    const size_t smem = static_cast<size_t>(w) * 3 * sizeof(float);
    int err = 0;
    if (smem > WIN_MAX_SMEM) {
      launch_knn(query, support, starts, idx, d2, B, M, N, w, qb, k, s);
    } else if (k <= 32) {
      err = launch_window<1>(query, support, starts, idx, d2, B, M, N, w, qb, k, smem, s);
    } else if (k <= 64) {
      err = launch_window<2>(query, support, starts, idx, d2, B, M, N, w, qb, k, smem, s);
    } else {
      err = launch_window<4>(query, support, starts, idx, d2, B, M, N, w, qb, k, smem, s);
    }
    if (err) return err;
  }
  return static_cast<int>(cudaGetLastError());
}
