// Exact neighbour search kernels for Hopper (sm_90a), C ABI for ctypes.
//
// r3d_knn_topk replaces recognizer3d_tpu/ops/knn_pallas.py::_knn_kernel
// (exact k-NN, k <= 128) with knn_cull_kernel, which ports what the TPU
// kernel's box culling and nearest-tile-first traversal are for (below).
// r3d_argmin replaces ::_argmin_kernel (exact streaming 1-NN) with
// argmin_cull_kernel, which culls as the TPU kernel's tile boxes do, over a
// grid of cells that the kernel builds itself (below).
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
// knn_cull_kernel (r3d_knn_topk). The streaming kernel it replaced
// (knn_topk_kernel, kept below) scans every support point in increasing
// index with theta = +inf at the start: on a Morton-sorted 2,500-point
// level at k = 32 that is 2,500 distances and 390 insertions a query, each
// insertion a chain of dependent shuffles (benchmarks/knn_cull.py counts
// them). The TPU kernel
// visits support tiles nearest-box-first from its query block's box, exits
// when the next tile's bound exceeds the block's largest k-th best, and
// skips a tile whose box no query can reach. This kernel computes what that
// machinery is for, in a form that suits a warp:
// - the support is cut into tiles of 32 points (one warp step), and
//   super tiles of 32 tiles; up to CULL_GLOBAL_MIN_POINTS support points
//   each block computes the boxes of all of them into shared memory (a
//   warp reduction a tile) and stages the support itself there (it fits
//   in CULL_STAGE_BYTES); above, the global-memory form below computes the
//   boxes once, and visited tiles are read from global memory, which L2
//   holds (65,536 points are 786 KB);
// - a warp serves a group of 1 or 2 consecutive queries: 2 where the
//   launch fills the card several times over (one point load then feeds
//   two distances), 1 where the whole launch is one wave, since a launch
//   takes as long as its slowest warp (cull_group);
// - each query starts warm: the 2R tiles around the group's position
//   mapped onto the support curve (query m -> m * N / M: its own
//   neighbourhood on a Morton-sorted self-KNN and on the recall guard's
//   evenly spaced re-search) are sorted by (distance, index) with a warp
//   bitonic network and the first 32R kept, so theta starts near its final
//   value instead of +inf;
// - the other tiles are walked nearest-box-first, without a sort: in each
//   batch of 32 super tiles (in increasing index) the alive super tile of
//   least bound comes next, and in it the alive tile of least bound (a vote
//   and a min reduction each, against the thetas of the moment). A tile is
//   alive while its bound is <= theta's distance for some query of the
//   group: a bound equal to it can hold a point at that distance with a
//   smaller index, which the stable sort puts first, so the cull is strict.
//   The walk ends when nothing is alive, the TPU kernel's exact early exit.
//   In increasing index instead, the slowest queries (those whose warm start
//   is poor) made up to 277 insertions on the level above, against 102
//   nearest-first, and a one-wave launch waits for its slowest warp;
// - the box bound is computed with the same explicitly rounded operations
//   as the distances, in the same order; rounding is monotone, so it never
//   exceeds the rounded distance of a point in the box, and culling is
//   exact;
// - the warm tiles are left out of the walk, so no point is offered twice;
//   every comparison (the filter, the insertion position, the refusal) is
//   lexicographic on (distance, index), so the list is the first k of a
//   stable sort by distance, the plain version's order, in any visit
//   order, for queries and supports in any order (Morton order only makes
//   the culling effective);
// - the best list sits in registers across the lanes (entry p = 32 * r +
//   lane, r < R, 32R >= k); an insertion is one warp-wide step (position by
//   ballot + popcount, shift by shuffles), as in the window kernel.
// The global-memory form: the TPU kernel keeps supports over 4 MB in HBM
// (hbm=True) and copies in only the tiles it does not cull. Here, above
// CULL_GLOBAL_MIN_POINTS support points, one launch before the walk,
// knn_box_kernel, computes every tile box and super-tile box once into a
// global scratch (a block a super tile, a warp four tiles, read as float4s
// and reduced through shared memory, the super tile's box from its tiles';
// one set of boxes a cloud). The walk is the same kernel, launched after
// the box pass as a programmatic dependent launch (PDL): the box pass lets
// it start at once, so the walk's blocks can be resident and past their
// prologue when the box pass ends, and wait for it (griddepcontrol.wait)
// before they read a box. (Its first warm start before the wait, which
// reads points only, measured slower on an H100: the restructured loop
// cost the walk 1-3% at 16,384 to 1,048,576 points and the route no time;
// the box pass has just read the support into L2. PERF.md.) It copies the
// super-tile boxes (24 KB at 1,048,576 points) into shared memory and
// reads a tile's box from global memory,
// which L2 holds (786 KB at that size), only when the tile's super tile is
// alive, so every block no longer rereads the support to box it; the
// boxes of over about 300,000 points would not fit in shared memory at
// all. The boxes are the same values in both forms (min and max are
// exact), so the selection is too. Which form is faster depends on the
// support's size: the box pass is a launch of its own, about 5 us at any
// size, which small supports do not win back (benchmarks/launch_ab.py B1
// times both at the served sizes, PERF.md).
//
// knn_topk_kernel (the window route's kernel for windows wider than shared
// memory holds). One warp owns one query; the
// block's warps share support tiles staged in shared memory; each step the
// 32 lanes evaluate 32 support points, a ballot collects those closer than
// the current k-th best, and each is inserted by the whole warp.
// Candidates arrive in increasing support index and enter behind every
// entry with an equal distance, and one equal to the k-th best is refused,
// so the list equals the first k of a stable sort by distance.
//
// argmin_kernel (the window route's k = 1): one thread per query, a
// running (min, argmin) in registers; strict "<" keeps the first index on
// ties, as torch.min does.
//
// argmin_cull_kernel (r3d_argmin, the exact 1-NN of the upsamples). The
// brute-force argmin_kernel evaluated every support point for every query
// (2,500 distances a query on the app frame, 16,384 at approx64k's last
// decoder level). The TPU kernel seeds each query block with its nearest
// tile and skips every tile whose box bound beats no query's best; it runs
// on Morton-sorted clouds, so that tiles are tight. On the app and live
// frames the support (the subsample) and the queries (the full cloud) come
// in no spatial order, and sorting them costs launches on frames that the
// host bounds. So the kernel orders the support itself, by cells:
// - a grid over the support's box, cubic cells, g along the longest side
//   (the least g with g^3 >= 2N, at most NN_GRID_MAX); a point's bin along
//   an axis is int(clamp((x - lo) * inv, 0, G - 1)) in explicitly rounded
//   float32, monotone in x, so a point of a higher bin never has a smaller
//   coordinate;
// - each CUDA block counting-sorts the support by cell in shared memory
//   (histogram by shared atomics, a block scan, a scatter), with the least
//   and largest coordinate of every bin along every axis (slabs), one
//   shared atomic a point (gathering a warp's lanes of one cell into one
//   atomic with __match_any_sync was slower on every served call, sorted
//   supports included: PERF.md). Supports whose
//   cells and points do not fit in NN_STAGE_BYTES (over 4,500 points:
//   approx64k's 16,384-point level) are ordered once, by
//   argmin_order_kernel in a launch before, into global memory (L2);
// - NN_LANES = 4 lanes walk a query's cells together, in growing shells
//   around its own cell; a plane, row or cell is skipped when the rounded
//   bound of its slab gaps is strictly greater than the best distance, a
//   scanned cell's points are split among the lanes, and their bests are
//   merged after the cell (two shuffles), so that every lane takes every
//   decision on the same best. After each shell the walk ends when the
//   rounded bound of everything beyond the shells (over the six sides: the
//   side's gap past the cube, the other axes' gaps to the box) is strictly
//   greater than the best distance. With one lane a query, a warp waits
//   for its slowest query, and the dense cells of a cloud hold hundreds of
//   points;
// - the bounds are rounded as the distance is (box_bound), on coordinates
//   of real points, so they never exceed a rounded distance; a bound equal
//   to the best can hide a tied point of a smaller index, hence the strict
//   tests, and the compare is lexicographic on (distance, index). The
//   result is the first entry of a stable sort by distance, for points in
//   any order (benchmarks/argmin_cull.py models the walk and counts it:
//   about 45 distances a query on the app frame instead of 2,500).
// What bounds it is not the distances: a walk is a chain of dependent
// shared-memory loads, a warp waits for its slowest query, and each block
// orders the support before its first query.
//
// Bound on this card. Brute force is O(M*N) distance evaluations against
// O((M+N)*12) bytes of input, so all three are bound by operations: 9 lane
// instructions a pair (3 subtractions, 3 multiplications, 2 additions, a
// compare; no FMA, see below) at 33.5 T instructions/s. The N = 2,500
// self-KNN is 56 M instructions, the 2,500 -> 61,440 upsample 1.4 G.
// Culling cuts the operations themselves: the culled kernel evaluates about
// 270 distances a query on a Morton-sorted 2,500-point level, not 2,500.
// The window search is O(M*w): 65,536 queries over 4,096-point windows are
// 2.4 G instructions, 0.072 ms.
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
constexpr int MAX_SMEM = 232448;   // shared memory a block may use
constexpr int KNN_WARPS = 8;       // queries per block, one warp each
constexpr int KNN_TILE = 1024;     // support points staged per step
constexpr int ARGMIN_THREADS = 256;
constexpr int ARGMIN_TILE = 1024;
constexpr int WIN_WARPS = 8;       // knn_window_kernel: warps per block,
constexpr int WIN_GROUP = 2;       // queries a warp scans together,
constexpr int WIN_QUERIES = 32;    // queries per block
constexpr int CULL_WARPS = 8;      // knn_cull_kernel: warps per block,
constexpr int CULL_BOX_UNROLL = 4; // tiles a warp boxes at once,
constexpr int BOX_WARPS = 8;       // knn_box_kernel: warps a block (a super
constexpr int BOX_TILES = 4;       // tile a block), tiles a warp,
constexpr int CULL_PDL = 1;        // the walk after the box pass launched with PDL
constexpr int CULL_STAGE_UNROLL = 4;  // support loads in flight a thread,
constexpr int CULL_ONE_WAVE_QUERIES_PER_SM = 64;  // see cull_group
constexpr int CULL_STAGE_BYTES = 100 * 1024;  // support + boxes staged up to
constexpr int CULL_GLOBAL_MIN_POINTS = 2048;  // the global-memory form above

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

// Lower bound of the rounded squared distance of q to any point of the box
// [lo, hi]: the gaps, their squares and their sums rounded as sq_dist
// rounds the differences, squares and sums, in the same order. Rounding is
// monotone, so the bound never exceeds the distance of a point in the box.
__device__ __forceinline__ float box_bound(float qx, float qy, float qz,
                                           const float* box, int stride) {
  const float gx =
      fmaxf(__fsub_rn(box[0], qx), 0.f) + fmaxf(__fsub_rn(qx, box[3 * stride]), 0.f);
  const float gy =
      fmaxf(__fsub_rn(box[stride], qy), 0.f) + fmaxf(__fsub_rn(qy, box[4 * stride]), 0.f);
  const float gz =
      fmaxf(__fsub_rn(box[2 * stride], qz), 0.f) + fmaxf(__fsub_rn(qz, box[5 * stride]), 0.f);
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), __fmul_rn(gz, gz));
}

// The warp's min of lo and max of hi (xyz each), on every lane.
__device__ __forceinline__ void warp_box(float (&lo)[3], float (&hi)[3]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(FULL, lo[a], o));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(FULL, hi[a], o));
    }
  }
}

// Component `lane` (< 6) of the box: lo x, y, z, hi x, y, z (selects, so
// the register arrays are not indexed at run time).
__device__ __forceinline__ float box_component(const float (&lo)[3], const float (&hi)[3],
                                               int lane) {
  const float l = lane == 0 ? lo[0] : (lane == 1 ? lo[1] : lo[2]);
  const float h = lane == 3 ? hi[0] : (lane == 4 ? hi[1] : hi[2]);
  return lane < 3 ? l : h;
}

// The lane with the least key among the lanes where `alive` holds (ties to
// the lowest lane), or -1 where it holds on none. Keys are >= +0, whose
// bits order as the floats do.
__device__ __forceinline__ int nearest_lane(bool alive, float key) {
  if (!__ballot_sync(FULL, alive)) return -1;
  const unsigned bits = alive ? __float_as_uint(key) : 0xffffffffu;
  const unsigned least = __reduce_min_sync(FULL, bits);
  return __ffs(__ballot_sync(FULL, bits == least)) - 1;
}

// Floats of one cloud's boxes in the global-memory form's scratch: tile
// boxes (6 rows of nt: lo xyz | hi xyz), then super-tile boxes (6 rows of
// ns), rounded up to 16 bytes.
inline size_t cull_box_stride(int N) {
  const size_t nt = (N + 31) / 32, ns = (nt + 31) / 32;
  return (6 * (nt + ns) + 3) / 4 * 4;
}

// The global-memory form's box pass: block s of the launch boxes super
// tile s of cloud blockIdx.y into the layout of cull_box_stride at scratch
// + b * stride. Each warp boxes BOX_TILES tiles, its loads for all of them
// in flight at once: a tile's 32 points are 384 contiguous bytes, 24 lanes'
// float4s, which the warp puts in shared memory; then lane o < 24 reduces
// component o % 6 (lo x, y, z, hi x, y, z) of tile o / 6 over its 32
// points (tiles 100 floats apart: the 12 addresses a step read fall in 12
// banks). A reduction by shuffles instead took 60 instructions a tile. The
// block's 32 tile boxes meet in shared memory and one warp reduces them to
// the super tile's box. Points past the support are NaN, which fminf and
// fmaxf skip, so tiles past it are empty boxes (+inf, -inf), as
// knn_cull_kernel's super-tile pass reads them. The kernel lets the walk
// launch at once (programmatic dependent launch, CULL_PDL); the walk waits
// for this grid before it reads a box.
__global__ void __launch_bounds__(BOX_WARPS * 32)
knn_box_kernel(const float* __restrict__ support, float* __restrict__ scratch, int N,
               size_t stride) {
  static_assert(BOX_WARPS * BOX_TILES == 32, "a block boxes one super tile");
  constexpr int TILE_FLOATS = 100;  // 96 a tile, padded
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __shared__ __align__(16) float raw[BOX_WARPS][BOX_TILES * TILE_FLOATS];
  __shared__ float tiles[6][32];
  const int nt = (N + 31) / 32, ns = (nt + 31) / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = blockIdx.x, b = blockIdx.y;
  const float* pts = support + static_cast<size_t>(b) * N * 3;
  float* tbox = scratch + b * stride;
  float* sbox = tbox + 6 * static_cast<size_t>(nt);
  const long long floats = 3LL * N;
  const bool vec = (reinterpret_cast<size_t>(pts) & 15) == 0;  // tiles start 384 t bytes in
  float4 v[BOX_TILES];
#pragma unroll
  for (int u = 0; u < BOX_TILES; ++u) {
    const long long f0 = 96LL * (32LL * s + BOX_TILES * warp + u) + 4 * lane;
    if (vec && lane < 24 && f0 + 4 <= floats) {
      v[u] = *reinterpret_cast<const float4*>(pts + f0);
    } else {
      const bool in = lane < 24;
      v[u].x = in && f0 < floats ? pts[f0] : CUDART_NAN_F;
      v[u].y = in && f0 + 1 < floats ? pts[f0 + 1] : CUDART_NAN_F;
      v[u].z = in && f0 + 2 < floats ? pts[f0 + 2] : CUDART_NAN_F;
      v[u].w = in && f0 + 3 < floats ? pts[f0 + 3] : CUDART_NAN_F;
    }
  }
  float* mine = raw[warp];
  if (lane < 24) {
#pragma unroll
    for (int u = 0; u < BOX_TILES; ++u) {
      *reinterpret_cast<float4*>(mine + u * TILE_FLOATS + 4 * lane) = v[u];
    }
  }
  __syncwarp();
  if (lane < 24) {
    const int u = lane / 6, comp = lane % 6, axis = comp % 3;
    const float* x = mine + u * TILE_FLOATS + axis;
    float lo = CUDART_INF_F, hi = -CUDART_INF_F;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      lo = fminf(lo, x[3 * j]);
      hi = fmaxf(hi, x[3 * j]);
    }
    const float c = comp < 3 ? lo : hi;
    const int ti = BOX_TILES * warp + u, t = 32 * s + ti;
    tiles[comp][ti] = c;
    if (t < nt) tbox[static_cast<size_t>(comp) * nt + t] = c;
  }
  __syncthreads();
  if (warp == 0) {
    float lo[3], hi[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = tiles[a][lane];
      hi[a] = tiles[3 + a][lane];
    }
    warp_box(lo, hi);
    if (lane < 6) sbox[lane * ns + s] = box_component(lo, hi, lane);
  }
}

// Exact k-NN with box culling, k <= 32 * R (see the design note at the
// top). Block blockIdx.x owns queries [qpb * blockIdx.x, +qpb) of batch
// blockIdx.y. Shared-memory form (boxes == null): dynamic shared memory holds
// tile boxes (6 rows of nt: lo xyz | hi xyz) | super-tile boxes (6 rows of
// ns) | the support (3N, staged only), built by the block. Global-memory
// form: cloud b's boxes lie at boxes + b * stride (knn_box_kernel), and
// shared memory holds a copy of its super-tile boxes.
template <int R, int Q>
__global__ void __launch_bounds__(CULL_WARPS * 32, 2)
knn_cull_kernel(const float* __restrict__ query, const float* __restrict__ support,
                const float* __restrict__ boxes, int* __restrict__ idx_out,
                float* __restrict__ d2_out, int M, int N, int k, int qpb, int staged,
                size_t stride) {
  constexpr int E = 2 * R;  // warm start: E tiles, 32 * R points kept
  extern __shared__ float cull_sm[];
  const int nt = (N + 31) / 32, ns = (nt + 31) / 32;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* sg = support + static_cast<size_t>(b) * N * 3;
  const float* pts = sg;  // points as x, y, z triples
  const float* tbox;      // the boxes the walk reads
  const float* sbox;
  if (boxes != nullptr) {
    tbox = boxes + b * stride;
    // the box pass's grid is complete and its boxes visible (a no-op where
    // the walk was launched without PDL); the super-tile boxes into shared
    // memory
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    const float* gs = tbox + 6 * static_cast<size_t>(nt);
    for (int t = threadIdx.x; t < 6 * ns; t += blockDim.x) cull_sm[t] = gs[t];
    sbox = cull_sm;
    __syncthreads();
  } else {
    float* stbox = cull_sm;
    float* ssbox = stbox + 6 * nt;
    float* spts = ssbox + 6 * ns;
    if (staged) {  // CULL_STAGE_UNROLL loads in flight a thread
      for (int t0 = threadIdx.x; t0 < 3 * N; t0 += CULL_STAGE_UNROLL * blockDim.x) {
        float v[CULL_STAGE_UNROLL];
#pragma unroll
        for (int u = 0; u < CULL_STAGE_UNROLL; ++u) {
          const int t = t0 + u * blockDim.x;
          v[u] = t < 3 * N ? sg[t] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < CULL_STAGE_UNROLL; ++u) {
          const int t = t0 + u * blockDim.x;
          if (t < 3 * N) spts[t] = v[u];
        }
      }
      __syncthreads();
      pts = spts;
    }

    // tile boxes, CULL_BOX_UNROLL tiles a warp at a time (their loads overlap)
    for (int t0 = warp; t0 < nt; t0 += CULL_WARPS * CULL_BOX_UNROLL) {
      float lo[CULL_BOX_UNROLL][3], hi[CULL_BOX_UNROLL][3];
#pragma unroll
      for (int u = 0; u < CULL_BOX_UNROLL; ++u) {
        const int j = 32 * (t0 + u * CULL_WARPS) + lane;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float v = j < N ? pts[3 * j + a] : CUDART_INF_F;
          lo[u][a] = v;
          hi[u][a] = j < N ? v : -CUDART_INF_F;
        }
      }
#pragma unroll
      for (int u = 0; u < CULL_BOX_UNROLL; ++u) {
        warp_box(lo[u], hi[u]);
        const int t = t0 + u * CULL_WARPS;
        if (lane < 6 && t < nt) stbox[lane * nt + t] = box_component(lo[u], hi[u], lane);
      }
    }
    __syncthreads();
    for (int s = warp; s < ns; s += CULL_WARPS) {
      const int t = 32 * s + lane;
      float lo[3], hi[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        lo[a] = t < nt ? stbox[a * nt + t] : CUDART_INF_F;
        hi[a] = t < nt ? stbox[(3 + a) * nt + t] : -CUDART_INF_F;
      }
      warp_box(lo, hi);
      if (lane < 6) ssbox[lane * ns + s] = box_component(lo, hi, lane);
    }
    __syncthreads();
    tbox = stbox;
    sbox = ssbox;
  }

  const int q_hi = min(blockIdx.x * qpb + qpb, M);
  for (int g0 = blockIdx.x * qpb + warp * Q; g0 < q_hi; g0 += CULL_WARPS * Q) {
    const int nq = min(Q, q_hi - g0);
    float qx[Q], qy[Q], qz[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {  // a short group repeats its last query
      const float* qp = query + (static_cast<size_t>(b) * M + g0 + min(q, nq - 1)) * 3;
      qx[q] = qp[0];
      qy[q] = qp[1];
      qz[q] = qp[2];
    }
    // warm start: the E tiles around the group's middle query mapped onto
    // the support curve, sorted by (distance, index), 32 * R kept
    const int c = static_cast<int>(static_cast<long long>(g0 + nq / 2) * N / M);
    const int tw0 = min(max((c + 16) / 32 - E / 2, 0), max(nt - E, 0));
    float px[E], py[E], pz[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = 32 * (tw0 + e) + lane;
      px[e] = j < N ? pts[3 * j] : 0.f;
      py[e] = j < N ? pts[3 * j + 1] : 0.f;
      pz[e] = j < N ? pts[3 * j + 2] : 0.f;
    }
    float best_d[Q][R], thd[Q];
    int best_i[Q][R], thi[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      float d[E];
      int i[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int j = 32 * (tw0 + e) + lane;
        d[e] = j < N ? sq_dist(qx[q], qy[q], qz[q], px[e], py[e], pz[e]) : CUDART_INF_F;
        i[e] = j < N ? j : INT_MAX;
      }
      warp_sort<E>(d, i, lane);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        best_d[q][r] = d[r];
        best_i[q][r] = i[r];
      }
      list_kth<R>(best_d[q], best_i[q], k, thd[q], thi[q]);
    }

    // the walk: batches of 32 super tiles in increasing index; in a batch,
    // the alive super tile of least bound next, and in it the alive tile of
    // least bound next. A tile is alive while its bound is <= the theta of
    // the moment of some query of the group (an equal bound can hold a
    // point at theta's distance with a smaller index); the warm tiles are
    // done. The bounds are fixed, the thetas only fall, so a super tile or
    // tile found dead stays dead.
    for (int sb = 0; sb < ns; sb += 32) {
      float slb[Q];
      bool s_open = sb + lane < ns;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        slb[q] = s_open ? box_bound(qx[q], qy[q], qz[q], sbox + sb + lane, ns) : CUDART_INF_F;
      }
      while (true) {
        bool s_alive = false;
        float s_key = CUDART_INF_F;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          s_alive |= slb[q] <= thd[q];
          s_key = fminf(s_key, slb[q]);
        }
        const int sl = nearest_lane(s_open & s_alive, s_key);
        if (sl < 0) break;
        s_open &= lane != sl;
        const int s = sb + sl;
        const int t = 32 * s + lane;
        bool t_open = (t < nt) & ((t < tw0) | (t >= tw0 + E));
        float lb[Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          lb[q] = t_open ? box_bound(qx[q], qy[q], qz[q], tbox + t, nt) : CUDART_INF_F;
        }
        while (true) {
          bool t_alive = false;
          float t_key = CUDART_INF_F;
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            t_alive |= lb[q] <= thd[q];
            t_key = fminf(t_key, lb[q]);
          }
          const int tl = nearest_lane(t_open & t_alive, t_key);
          if (tl < 0) break;
          t_open &= lane != tl;
          const int base = 32 * (32 * s + tl);
          const int j = base + lane;
          const bool pv = j < N;
          const float sx = pv ? pts[3 * j] : 0.f;
          const float sy = pv ? pts[3 * j + 1] : 0.f;
          const float sz = pv ? pts[3 * j + 2] : 0.f;
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            const float d = sq_dist(qx[q], qy[q], qz[q], sx, sy, sz);
            take_candidates<R>(__ballot_sync(FULL, pv & (d <= thd[q])), d, base,
                               best_d[q], best_i[q], thd[q], thi[q], k, lane);
          }
        }
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
          idx_out[out + p] = best_i[q][r];
          d2_out[out + p] = best_d[q][r];
        }
      }
    }
  }
}

// The launch arguments shared by the culled route's launchers.
struct CullLaunch {
  const float* query;
  const float* support;
  const float* boxes;  // the global-memory form's boxes, else null
  int* idx;
  float* d2;
  int B, M, N, k, group, qpb, staged;
  size_t stride, smem;
  cudaStream_t stream;
};

template <int R, int Q>
int launch_cull_rq(const CullLaunch& a) {
  if (a.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_cull_kernel<R, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(a.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the global form's walk follows its box pass with a programmatic
  // dependent launch: its blocks may start before the box pass ends, and
  // wait for it (griddepcontrol.wait) before they read a box
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((a.M + a.qpb - 1) / a.qpb, a.B);
  config.blockDim = dim3(CULL_WARPS * 32);
  config.dynamicSmemBytes = a.smem;
  config.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = a.boxes != nullptr && CULL_PDL ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&config, knn_cull_kernel<R, Q>, a.query,
                                             a.support, a.boxes, a.idx, a.d2, a.M, a.N, a.k,
                                             a.qpb, a.staged, a.stride));
}

template <int R>
int launch_cull_r(const CullLaunch& a) {
  return a.group == 1 ? launch_cull_rq<R, 1>(a) : launch_cull_rq<R, 2>(a);
}

// Queries a warp serves: 2 (one point load feeds two distances) where the
// launch fills the card several times over; 1 where it is one wave, so
// that the launch, which takes as long as its slowest warp, is not held by
// two queries in series. benchmarks/launch_ab.py times both choices at
// every size (on an H100 80GB HBM3 at 700 W: 2 at 2,500 points 0.0332
// against 0.0257 ms, 1 at 65,536 points 2.92 against 0.59 ms).
int cull_group(int queries, int sms) {
  return queries > CULL_ONE_WAVE_QUERIES_PER_SM * sms ? 2 : 1;
}

// Bytes of the tile and super-tile boxes of a support of N points.
inline size_t cull_box_bytes(int N) {
  const size_t nt = (N + 31) / 32, ns = (nt + 31) / 32;
  return 6 * (nt + ns) * sizeof(float);
}

// Whether the exact route takes the global-memory form: above
// CULL_GLOBAL_MIN_POINTS support points, where it measured faster (on an
// H100 80GB HBM3 at 700 W, box pass included: 2,500 points 0.0249 ->
// 0.0243 ms, 4,096 points 0.0363 -> 0.0294 ms, 262,144 points 4.720 ->
// 1.350 ms; at 1,024 points 0.0180 against the shared-memory form's
// 0.0124 ms, at 39 points 0.0084 against 0.0037), and wherever the boxes
// do not fit in shared memory.
inline bool cull_global(int N) {
  return N > CULL_GLOBAL_MIN_POINTS || cull_box_bytes(N) > static_cast<size_t>(MAX_SMEM);
}

// The exact k-NN route: knn_cull_kernel with the support staged in shared
// memory up to CULL_STAGE_BYTES; above CULL_GLOBAL_MIN_POINTS points, the
// global-memory form:
// knn_box_kernel into the scratch (B sets of cull_box_stride(N) floats),
// then the walk on the same stream. The global form's walk holds the
// super-tile boxes in shared memory, which bounds it at about 317 million
// points (a larger support is refused).
int launch_exact(const float* query, const float* support, float* scratch, int* idx,
                 float* d2, int B, int M, int N, int k, cudaStream_t stream) {
  const size_t nt = (N + 31) / 32, ns = (nt + 31) / 32;
  const bool global = cull_global(N);
  const size_t stage_bytes = 3 * static_cast<size_t>(N) * sizeof(float);
  const int staged = !global && cull_box_bytes(N) + stage_bytes <= CULL_STAGE_BYTES;
  const size_t smem = global ? 6 * ns * sizeof(float)
                             : cull_box_bytes(N) + (staged ? stage_bytes : 0);
  if (smem > static_cast<size_t>(MAX_SMEM) || (global && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, sms = 0, err;
  if ((err = cudaGetDevice(&device)) ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device))) {
    return err;
  }
  const size_t stride = global ? cull_box_stride(N) : 0;
  if (global) {
    knn_box_kernel<<<dim3(static_cast<unsigned>(ns), B), BOX_WARPS * 32, 0, stream>>>(
        support, scratch, N, stride);
  }
  const int group = cull_group(B * M, sms);
  // one wave: a query group a warp; else about two blocks an SM, 16 to 256
  // queries a block: larger blocks share the box pass of a large support
  // among more queries
  const int per_block = (M + 2 * sms - 1) / (2 * sms);
  const int qpb = group == 1 ? CULL_WARPS : min(max((per_block + 15) / 16 * 16, 16), 256);
  const CullLaunch a{query, support, global ? scratch : nullptr, idx, d2, B, M, N, k,
                     group, qpb, staged, stride, smem, stream};
  if (k <= 32) return launch_cull_r<1>(a);
  if (k <= 64) return launch_cull_r<2>(a);
  return launch_cull_r<4>(a);
}

// --- argmin_cull_kernel: exact 1-NN over a grid of cells --------------------

constexpr int NN_GRID_MAX = 32;           // cells along the longest side, at most
constexpr int NN_SLAB = NN_GRID_MAX + 1;  // stride of a slab table's axis rows
constexpr int NN_THREADS = 512;           // argmin_cull_kernel's block
constexpr int NN_LANES = 4;               // lanes that walk one query together
constexpr int NN_ORDER_THREADS = 1024;    // argmin_order_kernel
constexpr int NN_STAGE_BYTES = 110 * 1024;  // points + tables ordered in shared memory up to
constexpr float NN_MIN_EXTENT = 1e-30f;   // a longer side than this takes more than one cell
// tables of one grid, in 32-bit words: meta (lo xyz, hi xyz, inv, pad),
// dims (gx, gy, gz, pad), slab_lo, slab_hi, sfx_lo, pfx_hi ([3][NN_SLAB]
// each), then the cell starts (cells + 1)
constexpr int NN_META = 0, NN_DIMS = 8, NN_SLAB_LO = 12;
constexpr int NN_SLAB_HI = NN_SLAB_LO + 3 * NN_SLAB;
constexpr int NN_SFX_LO = NN_SLAB_HI + 3 * NN_SLAB;
constexpr int NN_PFX_HI = NN_SFX_LO + 3 * NN_SLAB;
constexpr int NN_START = NN_PFX_HI + 3 * NN_SLAB;

// g: the least integer with g^3 >= 2n, at most NN_GRID_MAX
__host__ __device__ inline int nn_cells_per_axis(int n) {
  int g = 1;
  while (g < NN_GRID_MAX && static_cast<long long>(g) * g * g < 2LL * n) ++g;
  return g;
}

// 32-bit words of the tables of a grid of at most `cells` cells, rounded up
// to 16 bytes
__host__ __device__ inline int nn_table_words(int cells) {
  return (NN_START + cells + 1 + 3) / 4 * 4;
}

// bytes a CUDA block orders in shared memory: the points (16 bytes each:
// x, y, z, index) and the tables of the largest grid n points can take
inline size_t nn_stage_bytes(int n) {
  const int g = nn_cells_per_axis(n);
  return 16 * static_cast<size_t>(n) + 4 * static_cast<size_t>(nn_table_words(g * g * g));
}

// Each CUDA block orders the support itself in shared memory; above
// NN_STAGE_BYTES argmin_order_kernel orders it once into global memory.
inline bool nn_staged(int n) { return nn_stage_bytes(n) <= NN_STAGE_BYTES; }

// the bin of coordinate x along an axis of g cells (monotone in x)
__device__ __forceinline__ int nn_bin(float x, float lo, float inv, int g) {
  const float t = __fmul_rn(__fsub_rn(x, lo), inv);
  return static_cast<int>(fmaxf(fminf(t, static_cast<float>(g - 1)), 0.f));
}

// floats as ints in the same order, for atomicMin / atomicMax (involution)
__device__ __forceinline__ int nn_ordered(int bits) {
  return bits >= 0 ? bits : bits ^ 0x7fffffff;
}

__device__ __forceinline__ float nn_gap(float q, float lo, float hi) {
  return fmaxf(__fsub_rn(lo, q), 0.f) + fmaxf(__fsub_rn(q, hi), 0.f);
}

__device__ __forceinline__ float nn_bound(float gx, float gy, float gz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), __fmul_rn(gz, gz));
}

// Inclusive sum of v over the block; every thread calls it (blockDim.x a
// multiple of 32).
__device__ __forceinline__ int nn_block_scan(int v) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += u;
  }
  __syncthreads();  // warp_sums free from an earlier call
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    int w = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += u;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  return v + (warp > 0 ? warp_sums[warp - 1] : 0);
}

// Orders the n points of sg (x, y, z triples) by cell, block-wide: pts[p]
// = (x, y, z, index bits) in cell order (any order inside a cell), and the
// grid's tables in tab (shared memory). Every thread calls it.
__device__ void nn_build_grid(const float* __restrict__ sg, int n, float4* pts, float* tab) {
  int* itab = reinterpret_cast<int*>(tab);
  // the support's box
  float lo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  float hi[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float v = sg[3 * i + a];
      lo[a] = fminf(lo[a], v);
      hi[a] = fmaxf(hi[a], v);
    }
  }
  warp_box(lo, hi);
  __shared__ float box_part[32][6];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < 6) box_part[warp][lane] = box_component(lo, hi, lane);
  __syncthreads();
  if (threadIdx.x == 0) {
    float ext_max = 0.f;
    for (int a = 0; a < 3; ++a) {
      float l = CUDART_INF_F, h = -CUDART_INF_F;
      for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
        l = fminf(l, box_part[w][a]);
        h = fmaxf(h, box_part[w][3 + a]);
      }
      tab[NN_META + a] = l;
      tab[NN_META + 3 + a] = h;
      ext_max = fmaxf(ext_max, __fsub_rn(h, l));
    }
    const int g = nn_cells_per_axis(n);
    const float inv = ext_max >= NN_MIN_EXTENT ? __fdiv_rn(static_cast<float>(g), ext_max) : 0.f;
    tab[NN_META + 6] = inv;
    for (int a = 0; a < 3; ++a) {
      const float ext = __fsub_rn(tab[NN_META + 3 + a], tab[NN_META + a]);
      itab[NN_DIMS + a] = min(static_cast<int>(__fmul_rn(ext, inv)) + 1, g);
    }
  }
  __syncthreads();
  const float inv = tab[NN_META + 6];
  const int gx = itab[NN_DIMS], gy = itab[NN_DIMS + 1], gz = itab[NN_DIMS + 2];
  const int cells = gx * gy * gz;
  const float blo[3] = {tab[NN_META], tab[NN_META + 1], tab[NN_META + 2]};
  const int gd[3] = {gx, gy, gz};
  int* count = itab + NN_START;
  for (int c = threadIdx.x; c <= cells; c += blockDim.x) count[c] = 0;
  for (int t = threadIdx.x; t < 3 * NN_SLAB; t += blockDim.x) {
    itab[NN_SLAB_LO + t] = nn_ordered(__float_as_int(CUDART_INF_F));
    itab[NN_SLAB_HI + t] = nn_ordered(__float_as_int(-CUDART_INF_F));
  }
  __syncthreads();
  // histogram of cells, slab extents. An extent is read before it is
  // updated, so that most points update none.
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int cell = 0;
#pragma unroll
    for (int a = 2; a >= 0; --a) {
      const float v = sg[3 * i + a];
      const int bin = nn_bin(v, blo[a], inv, gd[a]);
      cell = cell * gd[a] + bin;
      const int key = nn_ordered(__float_as_int(v));
      int* lo_at = itab + NN_SLAB_LO + a * NN_SLAB + bin;
      int* hi_at = itab + NN_SLAB_HI + a * NN_SLAB + bin;
      if (key < *static_cast<volatile int*>(lo_at)) atomicMin(lo_at, key);
      if (key > *static_cast<volatile int*>(hi_at)) atomicMax(hi_at, key);
    }
    atomicAdd(count + cell, 1);
  }
  __syncthreads();
  // counts -> inclusive ends: each thread a contiguous run of cells
  const int per = (cells + blockDim.x - 1) / blockDim.x;
  const int c0 = min(static_cast<int>(threadIdx.x) * per, cells), c1 = min(c0 + per, cells);
  int run = 0;
  for (int c = c0; c < c1; ++c) run += count[c];
  int end = nn_block_scan(run) - run;
  for (int c = c0; c < c1; ++c) {
    end += count[c];
    count[c] = end;
  }
  if (threadIdx.x == 0) count[cells] = n;
  // slabs back to floats; suffix minima and prefix maxima, one thread an axis
  if (threadIdx.x < 3) {
    const int a = threadIdx.x;
    const int ga = a == 0 ? gx : (a == 1 ? gy : gz);
    float* slo = tab + NN_SLAB_LO + a * NN_SLAB;
    float* shi = tab + NN_SLAB_HI + a * NN_SLAB;
    for (int j = 0; j < ga; ++j) {
      slo[j] = __int_as_float(nn_ordered(__float_as_int(slo[j])));
      shi[j] = __int_as_float(nn_ordered(__float_as_int(shi[j])));
    }
    float* sfx = tab + NN_SFX_LO + a * NN_SLAB;
    float* pfx = tab + NN_PFX_HI + a * NN_SLAB;
    float m = CUDART_INF_F;
    sfx[ga] = m;
    for (int j = ga - 1; j >= 0; --j) sfx[j] = m = fminf(m, slo[j]);
    m = -CUDART_INF_F;
    for (int j = 0; j < ga; ++j) pfx[j] = m = fmaxf(m, shi[j]);
  }
  __syncthreads();
  // scatter: each point takes the last free place of its cell's run, so
  // that the ends become the starts
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float x = sg[3 * i], y = sg[3 * i + 1], z = sg[3 * i + 2];
    const int cell = (nn_bin(z, blo[2], inv, gz) * gy + nn_bin(y, blo[1], inv, gy)) * gx +
                     nn_bin(x, blo[0], inv, gx);
    pts[atomicSub(count + cell, 1) - 1] = make_float4(x, y, z, __int_as_float(i));
  }
  __syncthreads();
}

// The nearest point of the grid (tab, pts) to q: (distance, index) least
// lexicographically, walked by the NN_LANES lanes of a group (lane l of the
// group, gmask its lanes). The walk of the design note: shells of cells
// around q's cell; a plane, row or cell skipped when its bound is strictly
// greater than the best; a cell's points split among the lanes, whose bests
// are merged after the cell, so that every decision sees the same best on
// every lane; the walk ended by the strict bound of everything beyond the
// shells.
__device__ __forceinline__ void nn_walk(float qx, float qy, float qz, const float* tab,
                                        const float4* pts, int l, unsigned gmask,
                                        float& best_d, int& best_i) {
  const int* itab = reinterpret_cast<const int*>(tab);
  const float lo[3] = {tab[NN_META], tab[NN_META + 1], tab[NN_META + 2]};
  const float hi[3] = {tab[NN_META + 3], tab[NN_META + 4], tab[NN_META + 5]};
  const float inv = tab[NN_META + 6];
  const int gd[3] = {itab[NN_DIMS], itab[NN_DIMS + 1], itab[NN_DIMS + 2]};
  const float q[3] = {qx, qy, qz};
  int c[3];
  float box_gap[3];
  int reach = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    c[a] = nn_bin(q[a], lo[a], inv, gd[a]);
    box_gap[a] = nn_gap(q[a], lo[a], hi[a]);
    reach = max(reach, max(c[a], gd[a] - 1 - c[a]));
  }
  const float* slo = tab + NN_SLAB_LO;
  const float* shi = tab + NN_SLAB_HI;
  const int* start = itab + NN_START;
  best_d = CUDART_INF_F;
  best_i = 0;  // a row of infinite distances: index 0, as the stable sort
  for (int r = 0;; ++r) {
    for (int dz = -r; dz <= r; ++dz) {
      const int z = c[2] + dz;
      if (z < 0 || z >= gd[2]) continue;
      const float gz = nn_gap(qz, slo[2 * NN_SLAB + z], shi[2 * NN_SLAB + z]);
      if (nn_bound(0.f, 0.f, gz) > best_d) continue;
      for (int dy = -r; dy <= r; ++dy) {
        const int y = c[1] + dy;
        if (y < 0 || y >= gd[1]) continue;
        const float gy = nn_gap(qy, slo[NN_SLAB + y], shi[NN_SLAB + y]);
        if (nn_bound(0.f, gy, gz) > best_d) continue;
        // inside the shell's faces only x = -r and x = r are on the shell
        const int step = (dz == -r || dz == r || dy == -r || dy == r) ? 1 : 2 * r;
        for (int dx = -r; dx <= r; dx += step) {
          const int x = c[0] + dx;
          if (x < 0 || x >= gd[0]) continue;
          const int cell = (z * gd[1] + y) * gd[0] + x;
          const int s0 = start[cell], s1 = start[cell + 1];
          if (s0 == s1) continue;
          if (nn_bound(nn_gap(qx, slo[x], shi[x]), gy, gz) > best_d) continue;
          for (int j = s0 + l; j < s1; j += NN_LANES) {
            const float4 p = pts[j];
            const float d = sq_dist(qx, qy, qz, p.x, p.y, p.z);
            const int i = __float_as_int(p.w);
            if (lex_less(d, i, best_d, best_i)) {
              best_d = d;
              best_i = i;
            }
          }
#pragma unroll
          for (int o = 1; o < NN_LANES; o <<= 1) {
            const float od = __shfl_xor_sync(gmask, best_d, o);
            const int oi = __shfl_xor_sync(gmask, best_i, o);
            if (lex_less(od, oi, best_d, best_i)) {
              best_d = od;
              best_i = oi;
            }
          }
        }
      }
    }
    if (r >= reach) return;
    // everything beyond the cube of shells 0..r, over its six sides
    float beyond = CUDART_INF_F;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int up = c[a] + r + 1, down = c[a] - r - 1;
      const float g_up =
          up < gd[a] ? fmaxf(__fsub_rn(tab[NN_SFX_LO + a * NN_SLAB + up], q[a]), 0.f)
                     : CUDART_INF_F;
      const float g_down =
          down >= 0 ? fmaxf(__fsub_rn(q[a], tab[NN_PFX_HI + a * NN_SLAB + down]), 0.f)
                    : CUDART_INF_F;
      const float g = fminf(g_up, g_down);
      beyond = fminf(beyond, nn_bound(a == 0 ? g : box_gap[0], a == 1 ? g : box_gap[1],
                                      a == 2 ? g : box_gap[2]));
    }
    if (beyond > best_d) return;
  }
}

// Orders each batch item's support into global memory: block b writes the
// points and then the tables of its grid at scratch + b * stride (words).
__global__ void __launch_bounds__(NN_ORDER_THREADS)
argmin_order_kernel(const float* __restrict__ support, float* __restrict__ scratch, int N,
                    size_t stride) {
  extern __shared__ float nn_sm[];  // the tables
  const int b = blockIdx.x;
  float* out = scratch + b * stride;
  nn_build_grid(support + static_cast<size_t>(b) * N * 3, N, reinterpret_cast<float4*>(out),
                nn_sm);
  const int* itab = reinterpret_cast<const int*>(nn_sm);
  const int words = NN_START + itab[NN_DIMS] * itab[NN_DIMS + 1] * itab[NN_DIMS + 2] + 1;
  for (int t = threadIdx.x; t < words; t += blockDim.x) out[4 * N + t] = nn_sm[t];
}

// Exact 1-NN, NN_LANES lanes a query (see the design note at the top).
// Block blockIdx.x owns queries [qpb * blockIdx.x, +qpb) of batch item
// blockIdx.y. Staged: the block orders the support in dynamic shared memory
// (points | tables); else it reads batch item b's grid that
// argmin_order_kernel wrote at scratch + b * stride.
__global__ void __launch_bounds__(NN_THREADS)
argmin_cull_kernel(const float* __restrict__ query, const float* __restrict__ support,
                   const float* __restrict__ scratch, int* __restrict__ idx_out,
                   float* __restrict__ d2_out, int M, int N, int qpb, size_t stride) {
  extern __shared__ float4 nn_pts[];
  const int b = blockIdx.y;
  const float4* pts;
  const float* tab;
  if (scratch == nullptr) {
    float* stab = reinterpret_cast<float*>(nn_pts + N);
    nn_build_grid(support + static_cast<size_t>(b) * N * 3, N, nn_pts, stab);
    pts = nn_pts;
    tab = stab;
  } else {
    pts = reinterpret_cast<const float4*>(scratch + b * stride);
    tab = scratch + b * stride + 4 * static_cast<size_t>(N);
  }
  const int l = threadIdx.x % NN_LANES, lane = threadIdx.x & 31;
  const unsigned gmask = ((1u << NN_LANES) - 1) << (lane - l);
  const int q_hi = min(blockIdx.x * qpb + qpb, M);
  for (int m = blockIdx.x * qpb + threadIdx.x / NN_LANES; m < q_hi;
       m += NN_THREADS / NN_LANES) {
    const float* qp = query + (static_cast<size_t>(b) * M + m) * 3;
    float d;
    int i;
    nn_walk(qp[0], qp[1], qp[2], tab, pts, l, gmask, d, i);
    if (l == 0) {
      idx_out[static_cast<size_t>(b) * M + m] = i;
      d2_out[static_cast<size_t>(b) * M + m] = d;
    }
  }
}

// words between two batch items' grids in the order launch's scratch
inline size_t nn_scratch_stride(int N) {
  const int g = nn_cells_per_axis(N);
  return 4 * static_cast<size_t>(N) + nn_table_words(g * g * g);
}

// The exact 1-NN route: argmin_cull_kernel, after argmin_order_kernel where
// the support is not ordered in shared memory (scratch: B grids of
// nn_scratch_stride(N) words).
int launch_argmin(const float* query, const float* support, float* scratch, int* idx,
                  float* d2, int B, int M, int N, cudaStream_t stream) {
  int device = 0, sms = 0, err;
  if ((err = cudaGetDevice(&device)) ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device))) {
    return err;
  }
  const bool staged = nn_staged(N);
  const size_t stride = staged ? 0 : nn_scratch_stride(N);
  const size_t smem = staged ? nn_stage_bytes(N) : 0;
  if (staged) {
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(argmin_cull_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem)))) {
      return err;
    }
  } else {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int g = nn_cells_per_axis(N);
    const size_t tab_bytes = 4 * static_cast<size_t>(nn_table_words(g * g * g));
    if (tab_bytes > 48 * 1024 &&
        (err = cudaFuncSetAttribute(argmin_order_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(tab_bytes)))) {
      return err;
    }
    argmin_order_kernel<<<B, NN_ORDER_THREADS, tab_bytes, stream>>>(support, scratch, N, stride);
  }
  // NN_THREADS / NN_LANES queries a pass; where each block orders the
  // support, about two blocks an SM at most, each ordering it once for all
  // of its passes
  const int per_pass = NN_THREADS / NN_LANES;
  const int passes = (M + per_pass - 1) / per_pass;
  const int per_batch = staged ? max(1, min(passes, (2 * sms + B - 1) / B)) : passes;
  const int qpb = (M + per_batch - 1) / per_batch;
  argmin_cull_kernel<<<dim3(per_batch, B), NN_THREADS, smem, stream>>>(
      query, support, staged ? nullptr : scratch, idx, d2, M, N, qpb, stride);
  return 0;
}

}  // namespace

// Bytes of scratch that r3d_knn_topk needs for B supports of N points: 0
// where the block builds the boxes in shared memory, else the
// global-memory form's boxes (cull_global).
extern "C" long long r3d_knn_topk_scratch_bytes(int B, int N) {
  return cull_global(N) ? 4LL * B * static_cast<long long>(cull_box_stride(N)) : 0;
}

// query (B, M, 3), support (B, N, 3) float32; scratch of
// r3d_knn_topk_scratch_bytes(B, N) bytes (null where that is 0); idx (B, M,
// k) int32 and d2 (B, M, k) float32 out, nearest first. Returns
// cudaGetLastError().
extern "C" int r3d_knn_topk(const float* query, const float* support, float* scratch,
                            int* idx, float* d2, int B, int M, int N, int k,
                            void* stream) {
  if (B == 0 || M == 0) return 0;
  if (k < 1 || k > 128 || k > N) return static_cast<int>(cudaErrorInvalidValue);
  const int err = launch_exact(query, support, scratch, idx, d2, B, M, N, k,
                               static_cast<cudaStream_t>(stream));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// Bytes of scratch that r3d_argmin needs for B supports of N points: 0
// where each CUDA block orders the support in shared memory.
extern "C" long long r3d_argmin_scratch_bytes(int B, int N) {
  return nn_staged(N) ? 0 : 4LL * B * static_cast<long long>(nn_scratch_stride(N));
}

// query (B, M, 3), support (B, N, 3) float32; scratch of
// r3d_argmin_scratch_bytes(B, N) bytes, 16-byte aligned (null where that is
// 0); idx (B, M) int32 and d2 (B, M) float32 out. Returns
// cudaGetLastError().
extern "C" int r3d_argmin(const float* query, const float* support, float* scratch, int* idx,
                          float* d2, int B, int M, int N, void* stream) {
  if (B == 0 || M == 0) return 0;
  if (N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int err = launch_argmin(query, support, scratch, idx, d2, B, M, N,
                                static_cast<cudaStream_t>(stream));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// Whether r3d_knn_window at k >= 2 scans windows of w points with the
// streaming knn_topk_kernel (windows wider than shared memory holds).
extern "C" int r3d_knn_window_streams(int w) {
  return static_cast<size_t>(w) * 3 * sizeof(float) > static_cast<size_t>(MAX_SMEM);
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
    if (r3d_knn_window_streams(w)) {
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
