// The n_out smallest priorities of each row, for Hopper (sm_90a), C ABI for
// ctypes.
//
// r3d_select_smallest replaces the lax.approx_min_k selection of
// recognizer3d_tpu/data/pipeline.py::z_filter_subsample (line 115: the
// n_out smallest random priorities of a depth frame, on the TPU's
// PartialReduce hardware, recall 0.95). It selects exactly, as the JAX
// package's off-TPU branch and its DeviceDatasetCache sampler do with
// lax.top_k(-priority, n_out): for priority (B, N) float32 it writes order
// (B, n_out) int64, the indices of each row's n_out smallest priorities in
// ascending priority, ties to the lower index. That is the first n_out of
// a stable sort (ops/select_kernels.py::select_smallest_plain), bit for
// bit. Its callers: the live depth path (1 x 786,432 -> 16,384 a frame)
// and every train step's batch assembly (B x n_max -> n_points).
//
// Keys. Both callers give finite priorities >= +0.0 (a uniform draw) and
// +inf (points outside the z band, padding rows). On that domain the
// float32 bits, read as uint32, order exactly as the values do. order_key
// maps any float32 to a uint32 that orders as a comparison sort does: the
// bits of a value >= +0.0 with the top bit set, a negative value's bits
// inverted, -0.0 as +0.0, every NaN last. Packed with the index, key << 32
// | index is distinct for every element of a row, and the ascending order
// of the packed keys IS the stable order: no tie is left to chance, and
// the result does not depend on how blocks are scheduled.
//
// Bound on this card: bytes. The function must read 4·B·N bytes of
// priorities and write 8·B·n_out bytes of indices (1 x 786,432 -> 16,384:
// 3.28 MB, 0.00098 ms at 3.35 TB/s); it does a few integer operations an
// element. At these sizes what holds a design back is not the bytes but
// the dependent steps between them: a pass needs the sums of the one
// before. The design before this one ran 9 dependent launches and a
// memset a call, a few microseconds each (0.068 ms at the live shape).
//
// One launch a call: a row is owned by a thread block cluster of C blocks
// (1 to 16, a power of two; 16 is above the portable 8 and is asked for
// with cudaFuncAttributeNonPortableClusterSizeAllowed), which run at once
// on neighbouring SMs and reach each other's shared memory (DSMEM,
// cluster.map_shared_rank). The cluster's phases are separated by cluster
// barriers (arrive with release, wait with acquire, for shared and global
// memory alike), so no state crosses a launch, nothing is cleared
// beforehand and no block has to find out that it is the last. Block r of
// a row takes its elements [r * chunk, +chunk) and positions [r * kpb,
// +kpb) of the row's n_out sorted keys. A block is 16 warps.
//
// 1. Threshold: T, the n_out-th smallest key, by radix selection on its
//    digits from the top (11, 11 and 10 bits). Each block histograms the
//    keys of its slice that match the digits found so far into its shared
//    memory (the lanes' elements in the warp's largest bin, the +inf run of
//    a depth frame, add with one atomic). Block q keeps the cluster's sums
//    of bins [q * L, +L) (L = 2048 / C): each block adds its nonzero bins
//    into their owners' by DSMEM atomics, and after one cluster barrier
//    every block reads the C range totals, finds the range of the rank,
//    reads its L sums and picks the same digit. After the third digit,
//    need = the rank left: how many keys equal to T to take.
//    From the second digit on, each warp takes a contiguous part of the
//    slice, in index order. In a staged slice the second digit's pass also
//    keeps the candidates, the keys whose top digit is at most the first
//    digit of T (only these can be selected or matter to the third digit;
//    about 2.5% of a depth frame), packed with their indices, in the
//    warp's part itself: an entry overwrites only elements the warp has
//    read. A warp whose candidates outgrow that room puts back the keys
//    it overwrote and goes on with its whole part. The later sweeps read
//    each warp's candidates, or its part.
// 2. Selection, and the first sort pass with it. Each warp counts its
//    keys equal to T, and those below T by their lowest key byte, the
//    first digit of a least-significant-digit sort (shared atomics). The
//    blocks' counts of T
//    cross a barrier: each warp then knows how many of its keys equal to T
//    it takes (the first need of them in index order), all at T's digit.
//    The blocks' digit counts cross a barrier (digit_offsets: the offset
//    of each digit in each block and warp); then each warp walks its keys
//    again and writes each one it takes, packed with its index (key << 32
//    | index), at its place after the first stable pass: its digit's
//    offset plus the earlier keys of that digit in index order (a round's
//    ranks by __match_any_sync, independent of each other, the running
//    counts through shared memory), into the shared memory of the block
//    that owns the position.
// 3. Order: three more stable passes, by the key's other bytes. A block's
//    warps count the digits of contiguous parts of its keys (a ballot a
//    bit of the digit gives each key the lanes with its digit), the counts
//    cross a barrier, and each key goes to its digit's offset plus the
//    earlier warps' and lanes' keys of that digit, in the other buffer;
//    then a barrier. Stable because the keys arrive in index order, so
//    equal keys stay lowest index first. The last pass writes the indices
//    as int64, and its barrier keeps every block's shared memory alive
//    until no block reads it.
//
// The plan, a pure function of (B, N, n_out, SMs) chosen by the caller
// (ops/select_kernels.py::select_plan) and passed in:
// - staged: where the block's slice fits its shared memory beside the
//   rest, the first pass loads it once (float4 loads, 8 a lane in flight)
//   and keeps its keys there; every later pass reads shared memory. The
//   live row (3 MB) is 196,608 bytes a block over 16 blocks. (Loading it by
//   TMA bulk copies, building the histogram as each piece lands on its
//   mbarrier, measured slower on an H100 at every shape: PERF.md.)
// - streamed: each pass re-reads the slice from global memory (a 2^21 row
//   is 8 MB).
// The selected keys live in the blocks' shared memory (two buffers of kpb
// keys, one aliasing the histogram, the other the staged slice, both dead
// by then) where they fit, else in a global scratch of 2·B·n_out keys
// (n_out == N on a large row).
//
// What bounds a call, measured on an H100 (PERF.md): not the
// bytes. A cluster lies in one GPC, which reads the live row at about 0.2
// TB/s (the streamed form, which reads it in each of its 5 sweeps, takes
// about 0.15 ms), so its one read takes over 10 us; then 16 SMs' second
// sweep over 49,152 elements a block, and the dependent steps: 13 cluster
// barriers, DSMEM round trips, the sort's 4 passes. An unlaunchable plan
// (too much shared memory, or a cluster the card cannot place) returns an
// error; there is no other route.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SEL_THREADS = 512;
constexpr int SEL_WARPS = SEL_THREADS / 32;
constexpr int SUB = 4;              // rounds of 32 elements a warp takes at once
constexpr int VEC = 8;              // float4s a lane loads at once in the first pass
constexpr int MAX_SMEM = 232448;    // shared memory a block may use
constexpr int MAX_CLUSTER = 16;     // blocks a row at most (non-portable above 8)
constexpr int HIST_BINS = 2048;     // the widest digit: 11 bits
constexpr int BINS_PER_THREAD = HIST_BINS / SEL_THREADS;
constexpr unsigned NO_LIST = 0xffffffffu;  // a warp whose candidates did not fit its part
// the threshold's digits, from the top: (shift, bits) = (21, 11), (10, 11), (0, 10)
constexpr int SEL_PASSES = 3;
__host__ __device__ constexpr int sel_shift(int pass) {
  return pass == 0 ? 21 : pass == 1 ? 10 : 0;
}
__host__ __device__ constexpr int sel_bits(int pass) { return pass == 2 ? 10 : 11; }
// the radix sort of the selected keys
constexpr int RADIX_BITS = 8;
constexpr int RADIX = 1 << RADIX_BITS;
constexpr int SORT_PASSES = 32 / RADIX_BITS;
// shared memory, in this order: the fixed part; the cluster's bin sums of
// the three digit passes (C > 1: L = 2048 / C of them a block and pass);
// region 1 (the histogram, then key buffer A); the warps' digit counts;
// region 0 (the staged slice, then key buffer B). ops/select_kernels.py
// mirrors these sizes.
constexpr int STATIC_BYTES = 8192;
constexpr int HIST_BYTES = HIST_BINS * 4;
constexpr int CNT_BYTES = SEL_WARPS * RADIX * 4;

struct Fixed {
  unsigned tab[RADIX];                  // this block's keys of each digit, a sort pass
  unsigned base[RADIX];                 // each digit's first position in this block
  unsigned warp_sums[SEL_WARPS];
  unsigned warp_eq[SEL_WARPS];          // keys equal to T before each warp, in the row
  unsigned range_sum[SEL_PASSES];       // the cluster's keys in this block's bins, a pass
  unsigned prefix, rank;                // T's digits so far, the rank left
  unsigned range, range_before;         // the range that holds the rank
  unsigned eq;                          // this block's keys equal to T
  unsigned list_n[SEL_WARPS];           // each warp's candidates kept in its part, or NO_LIST
};
static_assert(sizeof(Fixed) <= STATIC_BYTES, "the fixed part outgrew its room");

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

struct Layout {
  size_t red, region1, cnt, region0, total;
};

// The shared memory of a plan: C blocks a row, chunk elements and kpb keys
// a block.
__host__ __device__ inline Layout layout(int C, int chunk, int kpb, int staged,
                                         int keys_shared) {
  Layout l;
  const size_t keys = keys_shared ? 8 * static_cast<size_t>(kpb) : 0;
  const size_t stage = staged ? 4 * (static_cast<size_t>(chunk) + 4) : 0;
  l.red = STATIC_BYTES;
  l.region1 = l.red + (C > 1 ? SEL_PASSES * 4 * static_cast<size_t>(HIST_BINS / C) : 0);
  l.cnt = l.region1 + align16(keys > HIST_BYTES ? keys : HIST_BYTES);
  l.region0 = l.cnt + CNT_BYTES;
  l.total = l.region0 + align16(stage > keys ? stage : keys);
  return l;
}

__device__ __forceinline__ unsigned order_key(float v) {
  unsigned u = __float_as_uint(v);
  if (v != v) return FULL;      // NaN: after +inf
  if ((u << 1) == 0) u = 0;     // -0.0 ties +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned lanemask_lt() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// The lanes of the warp whose BITS-bit digit d equals this lane's, among
// the lanes with valid set (a lane without gets the other invalid lanes):
// what __match_any_sync(FULL, d) gives, by one ballot a bit of the digit.
template <int BITS>
__device__ __forceinline__ unsigned same_digit_lanes(unsigned d, bool valid) {
  const unsigned v = __ballot_sync(FULL, valid);
  unsigned m = valid ? v : ~v;
#pragma unroll
  for (int b = 0; b < BITS; ++b) {
    const unsigned bit = __ballot_sync(FULL, (d >> b) & 1u);
    m &= (d >> b) & 1u ? bit : ~bit;
  }
  return m;
}

// Exclusive prefix sum of v over the block in thread order; *total gets
// the block's sum. Every thread of the block must call it.
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned v, unsigned* warp_sums,
                                                         unsigned* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned n = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += n;
  }
  if (lane == 31) warp_sums[w] = inc;
  __syncthreads();
  if (w == 0) {
    unsigned s = lane < SEL_WARPS ? warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned n = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += n;
    }
    if (lane < SEL_WARPS) warp_sums[lane] = s;
  }
  __syncthreads();
  const unsigned before = w ? warp_sums[w - 1] : 0u;
  *total = warp_sums[SEL_WARPS - 1];
  __syncthreads();  // warp_sums free for the next call
  return before + inc - v;
}

// Split cluster barrier: every thread of every block of the cluster
// arrives (release: its earlier writes, shared and global, are visible
// after the wait), then waits (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Adds a warp's NB elements a lane to the histogram h, where match holds:
// the lanes' elements in the warp's largest bin (the +inf run of a depth
// frame) with one atomic, the others one each. Every lane must call it.
template <int NB>
__device__ __forceinline__ void hist_add(unsigned* h, const unsigned (&bin)[NB],
                                         const bool (&match)[NB]) {
  unsigned top = 0;
  bool any = false;
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    any |= match[c];
    if (match[c]) top = max(top, bin[c]);
  }
  if (!__any_sync(FULL, any)) return;
  top = __reduce_max_sync(FULL, top);
  unsigned n = 0;
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    if (match[c] && bin[c] == top) ++n;
    else if (match[c]) atomicAdd(&h[bin[c]], 1u);
  }
  n = __reduce_add_sync(FULL, n);
  if ((threadIdx.x & 31) == 0) atomicAdd(&h[top], n);
}

// The keys of a block's slice: from shared memory (staged) or converted
// from the priorities in global memory (streamed).
template <bool STAGED>
struct SliceKeys {
  const float* g;     // the slice's first priority
  const unsigned* s;  // its first key in shared memory
  __device__ __forceinline__ unsigned operator()(int j) const {
    if (STAGED) return s[j];
    return order_key(__ldg(g + j));
  }
};

// A warp's elements after the second digit pass, in index order: its part
// [ws, ws + n) of the slice, or (list set) its candidates, key << 32 |
// index.
template <bool STAGED>
struct Sweep {
  SliceKeys<STAGED> keys;
  const unsigned long long* list;
  int lo, ws, n;
  __device__ __forceinline__ unsigned key(int i, unsigned* idx) const {
    if (list) {
      const unsigned long long e = list[i];
      *idx = static_cast<unsigned>(e);
      return static_cast<unsigned>(e >> 32);
    }
    *idx = static_cast<unsigned>(lo + ws + i);
    return keys(ws + i);
  }
};

// The staged slice's geometry: element j of the slice at s[mis + j], so
// that elements at 16-byte aligned global addresses land at 16-byte
// aligned words, as the float4 loads and stores need; the body [head,
// head + body) by float4s, the rest by plain loads.
struct Stage {
  int mis, head, body;
  __device__ Stage(const float* g, int len) {
    mis = static_cast<int>((reinterpret_cast<size_t>(g) >> 2) & 3);
    head = min(len, (4 - mis) & 3);
    body = (len - head) & ~3;
  }
};

// The first digit's histogram (bins by key >> shift) of the slice read
// from global memory as float4s, VEC a lane at once, each key stored at
// its place in shared memory where the slice is staged (s: its first
// key); the head and tail by plain loads.
template <bool STAGED>
__device__ void first_histogram(const float* g, int len, const Stage& st, unsigned* s,
                                unsigned* h, int shift) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (w == 0) {  // the head and tail: at most 3 elements each
    int j = -1;
    if (lane < st.head) j = lane;
    else if (lane >= 8 && lane - 8 < len - st.head - st.body) j = st.head + st.body + lane - 8;
    unsigned bin[1] = {0};
    bool match[1] = {j >= 0};
    if (j >= 0) {
      const unsigned key = order_key(g[j]);
      if (STAGED) s[j] = key;
      bin[0] = key >> shift;
    }
    hist_add(h, bin, match);
  }
  const int units = st.body / 4;
  const float4* g4 = reinterpret_cast<const float4*>(g + st.head);
  uint4* s4 = reinterpret_cast<uint4*>(s + st.head);
  for (int u0 = w * 32 * VEC; u0 < units; u0 += SEL_THREADS * VEC) {
    float4 x[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      const int u = u0 + 32 * c + lane;
      if (u < units) x[c] = __ldg(g4 + u);
    }
    unsigned bin[4 * VEC];
    bool match[4 * VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      const int u = u0 + 32 * c + lane;
      const uint4 k = make_uint4(order_key(x[c].x), order_key(x[c].y), order_key(x[c].z),
                                 order_key(x[c].w));
      if (STAGED && u < units) s4[u] = k;
      bin[4 * c] = k.x >> shift;
      bin[4 * c + 1] = k.y >> shift;
      bin[4 * c + 2] = k.z >> shift;
      bin[4 * c + 3] = k.w >> shift;
#pragma unroll
      for (int e = 0; e < 4; ++e) match[4 * c + e] = u < units;
    }
    hist_add(h, bin, match);
  }
}

// The second digit's histogram (bins by the key's bits 10..20, of the keys
// whose top 11 bits are d0) of a staged slice, each warp over its part
// [ws, we) in index order; and the candidates, the keys whose top 11 bits
// are at most d0 (the only ones the later passes need), packed with their
// indices into the warp's part itself, from its start, 8-byte aligned: an
// entry overwrites only elements the warp has already read. A warp whose
// candidates outgrow what it has read stops keeping them and puts back the
// keys it overwrote (from global memory): f.list_n[w] = NO_LIST, else the
// number it kept.
template <bool STAGED>
__device__ void candidates_histogram(SliceKeys<STAGED> keys, int lo, int ws, int we,
                                     unsigned* h, unsigned d0, Fixed& f) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned* part = const_cast<unsigned*>(keys.s) + ws;
  const int off = static_cast<int>((reinterpret_cast<size_t>(part) >> 2) & 1);
  unsigned long long* list = reinterpret_cast<unsigned long long*>(part + off);
  const int n = we - ws;
  unsigned kept = 0;
  bool full = false;
  for (int i0 = 0; i0 < n; i0 += 32 * SUB) {
    unsigned key[SUB], bin[SUB];
    bool match[SUB];
#pragma unroll
    for (int c = 0; c < SUB; ++c) {
      const int i = i0 + 32 * c + lane;
      key[c] = i < n ? keys(ws + i) : FULL;
      match[c] = i < n && (key[c] >> 21) == d0;
      bin[c] = (key[c] >> 10) & (HIST_BINS - 1);
    }
    hist_add(h, bin, match);
    const int read = min(i0 + 32 * SUB, n);  // elements read: all of this round's
#pragma unroll
    for (int c = 0; c < SUB; ++c) {
      const int i = i0 + 32 * c + lane;
      const bool cand = i < n && (key[c] >> 21) <= d0;
      const unsigned b = __ballot_sync(FULL, cand);
      if (full || !b) continue;
      if (off + 2 * static_cast<int>(kept + __popc(b)) > read) {
        full = true;
        continue;
      }
      if (cand) {
        list[kept + __popc(b & lanemask_lt())] =
            (static_cast<unsigned long long>(key[c]) << 32) | static_cast<unsigned>(lo + ws + i);
      }
      kept += __popc(b);
    }
  }
  if (full) {
    __syncwarp();
    for (int i = off + lane; i < off + 2 * static_cast<int>(kept); i += 32) {
      part[i] = order_key(__ldg(keys.g + ws + i));
    }
  }
  if (lane == 0) f.list_n[w] = full ? NO_LIST : kept;
}

// The histogram, by the digit at shift, of a warp's elements (Sweep) that
// match prefix under hi_mask.
template <bool STAGED>
__device__ void sweep_histogram(const Sweep<STAGED>& src, unsigned* h, unsigned prefix,
                                unsigned hi_mask, int shift, unsigned dmask) {
  const int lane = threadIdx.x & 31;
  for (int i0 = 0; i0 < src.n; i0 += 32 * SUB) {
    unsigned bin[SUB];
    bool match[SUB];
#pragma unroll
    for (int c = 0; c < SUB; ++c) {
      const int i = i0 + 32 * c + lane;
      unsigned idx;
      const unsigned key = i < src.n ? src.key(i, &idx) : 0u;
      match[c] = i < src.n && (key & hi_mask) == prefix;
      bin[c] = (key >> shift) & dmask;
    }
    hist_add(h, bin, match);
  }
}

// One digit of the threshold, once this block's histogram h is complete:
// the digit of the rank-th key among those that match f.prefix, into
// f.prefix and f.rank, the same in every block; on the last pass this
// block's keys at it, which are T, into f.eq. Where C > 1 the cluster's
// sums of bins [q * L, +L) are kept by block q in red (this pass's L
// words, cleared at the start): each block
// adds its nonzero bins into their owners' (DSMEM atomics), a cluster
// barrier, then every block reads the C range totals, finds the range of
// the rank and reads its owner's L sums.
__device__ void pick_digit(cg::cluster_group& cluster, Fixed& f, unsigned* h, unsigned* red,
                           int pass, unsigned dmask, bool last) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int C = static_cast<int>(cluster.num_blocks());
  const int L = HIST_BINS / C;
  const int shift = sel_shift(pass);
  const unsigned* sums = h;  // the range's sums: the whole histogram for C = 1
  unsigned before = 0;
  if (C > 1) {
    // bins [4t, 4t + 4) lie in one owner's range (L >= 128)
    unsigned v[BINS_PER_THREAD], s = 0;
#pragma unroll
    for (int e = 0; e < BINS_PER_THREAD; ++e) {
      v[e] = h[BINS_PER_THREAD * t + e];
      s += v[e];
    }
    if (s) {
      const int owner = BINS_PER_THREAD * t / L;
      unsigned* o = cluster.map_shared_rank(red, owner);
#pragma unroll
      for (int e = 0; e < BINS_PER_THREAD; ++e) {
        if (v[e]) atomicAdd(o + BINS_PER_THREAD * t + e - owner * L, v[e]);
      }
      atomicAdd(cluster.map_shared_rank(&f.range_sum[pass], owner), s);
    }
    cluster.sync();  // every block's bins are added
    if (w == 0) {    // the range that holds the rank
      const unsigned s = lane < C ? *cluster.map_shared_rank(&f.range_sum[pass], lane) : 0u;
      unsigned inc = s;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned n = __shfl_up_sync(FULL, inc, o);
        if (lane >= o) inc += n;
      }
      if (lane < C && inc - s < f.rank && f.rank <= inc) {
        f.range = lane;
        f.range_before = inc - s;
      }
    }
    __syncthreads();
    sums = cluster.map_shared_rank(red, static_cast<int>(f.range));
    before = f.range_before;
  }
  // the bin within the range: thread t holds sums [E t, E t + E)
  const int E = (L + SEL_THREADS - 1) / SEL_THREADS;
  unsigned c[BINS_PER_THREAD], s = 0;
#pragma unroll
  for (int e = 0; e < BINS_PER_THREAD; ++e) {
    const int i = E * t + e;
    c[e] = e < E && i < L ? sums[i] : 0u;
    s += c[e];
  }
  const unsigned rank = f.rank - before, prefix = f.prefix;
  unsigned total;
  const unsigned ex = block_exclusive_scan(s, f.warp_sums, &total);
  if (ex < rank && rank <= ex + s) {  // exactly one thread
    unsigned cum = ex;
    int e = 0;
    while (cum + c[e] < rank) cum += c[e++];
    const unsigned digit = static_cast<unsigned>((C > 1 ? f.range * L : 0) + E * t + e);
    f.prefix = prefix | (digit << shift);
    f.rank = rank - cum;
  }
  __syncthreads();
  if (last && t == 0) f.eq = h[(f.prefix >> shift) & dmask];
}

// A key's place in the buffer of the selected keys: block pos / kpb's
// shared memory, or the global buffer.
__device__ __forceinline__ unsigned long long* key_slot(cg::cluster_group& cluster,
                                                        unsigned long long* local,
                                                        unsigned long long* global, int pos,
                                                        int kpb) {
  if (global) return global + pos;
  return cluster.map_shared_rank(local, pos / kpb) + pos % kpb;
}

__device__ __forceinline__ unsigned sort_digit(unsigned long long key, int pass) {
  return static_cast<unsigned>(key >> (32 + RADIX_BITS * pass)) & (RADIX - 1);
}

// The positions of a sort pass's digits, once each warp's digit counts
// cnt[w][d] (the keys it takes, in order) are complete: f.tab gets this
// block's count of each digit, a cluster barrier, then f.base[d] the
// first position of digit d in this block (the keys of smaller digits in
// the cluster, and of digit d in the blocks before it), and cnt[w][d] the
// keys of digit d in the warps before w.
__device__ void digit_offsets(cg::cluster_group& cluster, Fixed& f, unsigned (*cnt)[RADIX]) {
  const int t = threadIdx.x;
  const int C = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  __syncthreads();
  if (t < RADIX) {
    unsigned s = 0;
#pragma unroll
    for (int v = 0; v < SEL_WARPS; ++v) s += cnt[v][t];
    f.tab[t] = s;
  }
  cluster.sync();  // every block's counts
  unsigned total = 0, run = 0;
  if (t < RADIX) {
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q) {  // the loads in flight together
      if (q < C) {
        const unsigned c = cluster.map_shared_rank(f.tab, q)[t];
        total += c;
        if (q < r) run += c;
      }
    }
  }
  unsigned all;
  run += block_exclusive_scan(total, f.warp_sums, &all);
  if (t < RADIX) {
    f.base[t] = run;
    unsigned before = 0;
#pragma unroll
    for (int v = 0; v < SEL_WARPS; ++v) {
      const unsigned c = cnt[v][t];
      cnt[v][t] = before;
      before += c;
    }
  }
  __syncthreads();
}

// A warp's round of keys in a sort: the position of each key with sel set,
// its digit d's place (f.base[d] + cnt[w][d]) plus its rank among the
// round's earlier keys of that digit, which it then adds to cnt[w][d].
__device__ __forceinline__ unsigned sort_position(Fixed& f, unsigned* cnt_w, unsigned d,
                                                  bool sel) {
  const unsigned peers = same_digit_lanes<RADIX_BITS>(d, sel);
  const unsigned pos = sel ? f.base[d] + cnt_w[d] + __popc(peers & lanemask_lt()) : 0u;
  __syncwarp();
  if (sel && __ffs(peers) - 1 == static_cast<int>(threadIdx.x & 31)) cnt_w[d] += __popc(peers);
  __syncwarp();
  return pos;
}

// A warp's round of keys counted at their digits.
__device__ __forceinline__ void count_digits(unsigned* cnt_w, unsigned d, bool sel) {
  const unsigned peers = same_digit_lanes<RADIX_BITS>(d, sel);
  if (sel && __ffs(peers) - 1 == static_cast<int>(threadIdx.x & 31)) cnt_w[d] += __popc(peers);
  __syncwarp();
}

template <bool STAGED>
__global__ void __launch_bounds__(SEL_THREADS, 1)
select_cluster_kernel(const float* __restrict__ priority, unsigned long long* gkeys,
                      long long* __restrict__ order, int B, int N, int n_out, int chunk,
                      int kpb, int keys_shared) {
  extern __shared__ __align__(16) unsigned char smem[];
  Fixed& f = *reinterpret_cast<Fixed*>(smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / C;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int lo = min(N, r * chunk);
  const int len = min(N, lo + chunk) - lo;
  const Layout l = layout(C, chunk, kpb, STAGED, keys_shared);
  unsigned* red = reinterpret_cast<unsigned*>(smem + l.red);
  unsigned* h = reinterpret_cast<unsigned*>(smem + l.region1);
  unsigned long long* keys_a = reinterpret_cast<unsigned long long*>(smem + l.region1);
  unsigned(*cnt)[RADIX] = reinterpret_cast<unsigned(*)[RADIX]>(smem + l.cnt);
  unsigned* staged = reinterpret_cast<unsigned*>(smem + l.region0);
  unsigned long long* keys_b = reinterpret_cast<unsigned long long*>(smem + l.region0);
  unsigned long long* g_a = keys_shared ? nullptr : gkeys + static_cast<size_t>(row) * n_out;
  unsigned long long* g_b =
      keys_shared ? nullptr : gkeys + (static_cast<size_t>(B) + row) * n_out;
  const float* g = priority + static_cast<size_t>(row) * N + lo;
  const int L = HIST_BINS / C;

  Stage st(g, len);
  for (int i = t; i < HIST_BINS; i += SEL_THREADS) h[i] = 0;
  if (C > 1) {
    for (int i = t; i < SEL_PASSES * L; i += SEL_THREADS) red[i] = 0;
  }
  for (int i = t; i < SEL_WARPS * RADIX; i += SEL_THREADS) (&cnt[0][0])[i] = 0;
  if (t < SEL_PASSES) f.range_sum[t] = 0;
  if (t == 0) {
    f.prefix = 0;
    f.rank = static_cast<unsigned>(n_out);
  }
  // every block of the cluster runs and has cleared what the others add
  // into before any DSMEM access
  cluster_arrive();
  __syncthreads();

  // 1. the threshold
  SliceKeys<STAGED> keys{g, staged + st.mis};
  // a warp's part of the slice, in index order, from the second digit on
  const int per_warp = ((len + SEL_WARPS - 1) / SEL_WARPS + 32 * SUB - 1) & ~(32 * SUB - 1);
  const int ws = min(len, w * per_warp), we = min(len, ws + per_warp);
  Sweep<STAGED> sweep{keys, nullptr, lo, ws, we - ws};
  unsigned hi_mask = 0;
  for (int pass = 0; pass < SEL_PASSES; ++pass) {
    const int shift = sel_shift(pass);
    const unsigned dmask = (1u << sel_bits(pass)) - 1u;
    if (pass > 0) {
      __syncthreads();  // the last pass's reads of h are done
      for (int i = t; i < HIST_BINS; i += SEL_THREADS) h[i] = 0;
      __syncthreads();
    }
    if (STAGED && pass == 1) {
      candidates_histogram(keys, lo, ws, we, h, f.prefix >> 21, f);
    } else if (pass > 0) {
      sweep_histogram(sweep, h, f.prefix, hi_mask, shift, dmask);
    } else {
      first_histogram<STAGED>(g, len, st, staged + st.mis, h, shift);
    }
    if (pass == 0) cluster_wait();
    __syncthreads();  // this block's histogram is complete
    pick_digit(cluster, f, h, red + pass * L, pass, dmask, pass == SEL_PASSES - 1);
    hi_mask |= dmask << shift;
    if (STAGED && pass == 1 && f.list_n[w] != NO_LIST) {  // the candidates from here on
      const int off = static_cast<int>((reinterpret_cast<size_t>(staged + st.mis + ws) >> 2) & 1);
      sweep.list = reinterpret_cast<const unsigned long long*>(staged + st.mis + ws + off);
      sweep.n = static_cast<int>(f.list_n[w]);
    }
  }
  const unsigned T = f.prefix, need = f.rank;
  __syncthreads();   // f.eq complete
  cluster_arrive();  // every block's f.eq, waited for after the count

  // 2. the selected keys: each key below T, and each key equal to it among
  // the first need of them, in index order; counted by warp and first sort
  // digit, then written at their places after the first sort pass
  const unsigned dT = T & (RADIX - 1);
  const int sn = sweep.n;
  {
    unsigned eq = 0;
    for (int i0 = 0; i0 < sn; i0 += 32 * SUB) {
      unsigned key[SUB];
#pragma unroll
      for (int c = 0; c < SUB; ++c) {
        const int i = i0 + 32 * c + lane;
        unsigned idx;
        key[c] = i < sn ? sweep.key(i, &idx) : FULL;
      }
#pragma unroll
      for (int c = 0; c < SUB; ++c) {
        const int i = i0 + 32 * c + lane;
        if (i < sn && key[c] < T) atomicAdd(&cnt[w][key[c] & (RADIX - 1)], 1u);
        eq += __popc(__ballot_sync(FULL, i < sn && key[c] == T));
      }
    }
    if (lane == 0) f.warp_sums[w] = eq;
  }
  cluster_wait();
  __syncthreads();
  if (w == 0) {
    // the keys equal to T in the earlier blocks, and in the earlier warps
    const unsigned e = lane < C ? cluster.map_shared_rank(&f.eq, lane)[0] : 0u;
    unsigned ie = e;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned n = __shfl_up_sync(FULL, ie, o);
      if (lane >= o) ie += n;
    }
    const unsigned eq_block = __shfl_sync(FULL, ie - e, r);
    const unsigned v = lane < SEL_WARPS ? f.warp_sums[lane] : 0u;
    unsigned inc = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned n = __shfl_up_sync(FULL, inc, o);
      if (lane >= o) inc += n;
    }
    if (lane < SEL_WARPS) {
      // the warp's keys equal to T before it in the row, and how many of
      // its own it takes: all at digit dT
      const unsigned eqb = eq_block + inc - v;
      f.warp_eq[lane] = eqb;
      cnt[lane][dT] += need > eqb ? min(need - eqb, v) : 0u;
    }
  }
  digit_offsets(cluster, f, cnt);
  {
    // a round's SUB rankings are independent; only the running counts
    // cnt[w][d] pass from one to the next
    unsigned eq_run = f.warp_eq[w];
    for (int i0 = 0; i0 < sn; i0 += 32 * SUB) {
      unsigned key[SUB], idx[SUB], bs[SUB], peers[SUB];
      bool sel[SUB];
#pragma unroll
      for (int c = 0; c < SUB; ++c) {
        const int i = i0 + 32 * c + lane;
        key[c] = i < sn ? sweep.key(i, &idx[c]) : FULL;
      }
      unsigned any = 0;
#pragma unroll
      for (int c = 0; c < SUB; ++c) {
        const int i = i0 + 32 * c + lane;
        const bool is_eq = i < sn && key[c] == T;
        const unsigned be = __ballot_sync(FULL, is_eq);
        sel[c] = (i < sn && key[c] < T) || (is_eq && eq_run + __popc(be & lanemask_lt()) < need);
        eq_run += __popc(be);
        bs[c] = __ballot_sync(FULL, sel[c]);
        any |= bs[c];
      }
      if (!any) continue;
#pragma unroll
      for (int c = 0; c < SUB; ++c) {
        peers[c] = sel[c] ? __match_any_sync(bs[c], key[c] & (RADIX - 1)) : 0u;
      }
#pragma unroll
      for (int c = 0; c < SUB; ++c) {
        if (!bs[c]) continue;
        const unsigned d = key[c] & (RADIX - 1);
        const unsigned pos =
            sel[c] ? f.base[d] + cnt[w][d] + __popc(peers[c] & lanemask_lt()) : 0u;
        __syncwarp();
        if (sel[c] && __ffs(peers[c]) - 1 == lane) cnt[w][d] += __popc(peers[c]);
        __syncwarp();
        if (sel[c]) {
          *key_slot(cluster, keys_a, g_a, static_cast<int>(pos), kpb) =
              (static_cast<unsigned long long>(key[c]) << 32) | idx[c];
        }
      }
    }
  }
  if (!keys_shared) __threadfence();
  cluster.sync();  // the keys, ordered by their first digit, are in place

  // 3. the other three sort passes over this block's keys
  const int k_lo = min(n_out, r * kpb);
  const int m = min(n_out, k_lo + kpb) - k_lo;
  const int kpw = ((m + SEL_WARPS - 1) / SEL_WARPS + 31) & ~31;
  const int ks = min(m, w * kpw), ke = min(m, ks + kpw);
  for (int pass = 1; pass < SORT_PASSES; ++pass) {
    const unsigned long long* src = (pass & 1) ? (g_a ? g_a + k_lo : keys_a)
                                               : (g_b ? g_b + k_lo : keys_b);
    unsigned long long* dst_local = (pass & 1) ? keys_b : keys_a;
    unsigned long long* dst_global = (pass & 1) ? g_b : g_a;
    for (int d = lane; d < RADIX; d += 32) cnt[w][d] = 0;
    __syncwarp();
    for (int i0 = ks; i0 < ke; i0 += 32) {
      const int i = i0 + lane;
      count_digits(cnt[w], i < ke ? sort_digit(src[i], pass) : 0u, i < ke);
    }
    digit_offsets(cluster, f, cnt);
    for (int i0 = ks; i0 < ke; i0 += 32) {
      const int i = i0 + lane;
      const bool valid = i < ke;
      const unsigned long long key = valid ? src[i] : 0ull;
      const unsigned pos = sort_position(f, cnt[w], sort_digit(key, pass), valid);
      if (!valid) continue;
      if (pass == SORT_PASSES - 1) {
        order[static_cast<size_t>(row) * n_out + pos] =
            static_cast<long long>(key & 0xffffffffull);
      } else {
        *key_slot(cluster, dst_local, dst_global, static_cast<int>(pos), kpb) = key;
      }
    }
    if (!keys_shared) __threadfence();
    cluster.sync();  // the next pass's keys are in place; at the end, no
                     // block reads another's shared memory any more
  }
}

bool valid_plan(int B, int N, int n_out, int cluster, int staged, int keys_shared) {
  return B >= 0 && N >= 1 && n_out >= 1 && n_out <= N && cluster >= 1 &&
         cluster <= MAX_CLUSTER && (cluster & (cluster - 1)) == 0 && (staged == 0 || staged == 1) &&
         (keys_shared == 0 || keys_shared == 1) &&
         static_cast<long long>(B) * cluster <= 0x7fffffffLL;
}

template <bool STAGED>
int launch(const float* priority, unsigned long long* gkeys, long long* order, int B, int N,
           int n_out, int cluster, int keys_shared, cudaStream_t stream) {
  const int chunk = ((N + cluster - 1) / cluster + 3) & ~3;
  const int kpb = (n_out + cluster - 1) / cluster;
  const Layout l = layout(cluster, chunk, kpb, STAGED, keys_shared);
  if (l.total > static_cast<size_t>(MAX_SMEM)) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(select_cluster_kernel<STAGED>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(select_cluster_kernel<STAGED>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(B) * cluster);
  config.blockDim = dim3(SEL_THREADS);
  config.dynamicSmemBytes = l.total;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  int clusters = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveClusters(&clusters, select_cluster_kernel<STAGED>, &config);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaLaunchKernelEx(&config, select_cluster_kernel<STAGED>, priority, gkeys, order, B, N,
                           n_out, chunk, kpb, keys_shared);
  return static_cast<int>(err);
}

}  // namespace

// priority (B, N) float32; scratch: null where the plan keeps the selected
// keys in shared memory (keys_shared = 1), else 2·B·n_out 8-byte keys;
// order (B, n_out) int64 out: each row's n_out smallest priorities'
// indices in ascending priority, ties to the lower index. The plan
// (ops/select_kernels.py::select_plan): cluster blocks a row (1 to 16, a
// power of two), staged (the slice loaded into shared memory once) or
// streamed, keys_shared. Returns a CUDA error for a plan it cannot launch,
// else cudaGetLastError().
extern "C" int r3d_select_smallest(const float* priority, void* scratch, long long* order,
                                   int B, int N, int n_out, int cluster, int staged,
                                   int keys_shared, void* stream) {
  if (!valid_plan(B, N, n_out, cluster, staged, keys_shared) ||
      (!keys_shared && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* gkeys = static_cast<unsigned long long*>(scratch);
  const int err = staged ? launch<true>(priority, gkeys, order, B, N, n_out, cluster,
                                        keys_shared, s)
                         : launch<false>(priority, gkeys, order, B, N, n_out, cluster,
                                         keys_shared, s);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
