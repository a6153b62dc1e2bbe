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
// element. What the design does about it: the streaming passes spread each
// row over many blocks (at the live shape B = 1, so one block a row would
// leave 131 of 132 SMs idle), and a row of 3 MB stays in the 50 MB L2
// between the passes, so only the first pass reads device memory. The
// rest is launches: 9 kernels, each a few microseconds at these sizes.
//
// 1. Threshold (3 launches of select_hist_kernel). The threshold key T is
//    the n_out-th smallest key, found by radix selection on its digits from
//    the top (11, 11 and 10 bits). Each block builds a histogram of the
//    keys that match the digits found so far in shared memory, adds it
//    into the row's global histogram, and the last block of the row to
//    finish (an atomic count
//    after a fence) reads the histogram, finds the bin that holds the
//    rank-th key, appends its digit and keeps the rank within it, and
//    clears the histogram for the next pass. Atomic counts are order-free:
//    the result is the same however blocks run. After the third pass T is
//    known, and need = the rank left: how many keys equal to T to take
//    (n_out - #(key < T), at least 1).
// 2. Compaction (select_count_kernel, select_scatter_kernel). Each block of
//    4,096 consecutive elements counts its keys below T and equal to T; the
//    last block turns the counts into exclusive prefixes over the blocks.
//    The scatter block then ranks its elements in index order (a block
//    scan a round) and writes each element with key < T, and each element
//    equal to T among the first need of them, as its packed key at
//    #(key < T before it) + min(#(key == T before it), need): the n_out
//    selected keys in index order.
// 3. Order (4 launches of select_sort_pass_kernel). A least-significant-
//    digit radix sort of the n_out selected keys by the 32-bit key, 8 bits
//    a pass. It is stable because the keys arrive in index order, so equal
//    keys stay lowest index first. A block takes a tile of 512 consecutive
//    keys (2,048 above 4,096 keys a row), each of its 8 warps an eighth of
//    them: the warp counts their digits
//    (a ballot a bit of the digit gives each key the lanes with its digit);
//    the tile's offset for each digit, from the scanned (digit, tile) counts,
//    and the counts of the earlier warps give each warp its offsets; the
//    warp writes its keys, in order, each at its digit's offset plus its
//    rank among the warp's earlier keys of that digit. Each key written is
//    counted (a global atomic) at its next digit and the tile it lands in,
//    and the last block of the row scans those counts for the next pass;
//    the compaction counts the first digit the same way. So a pass is one
//    launch, and every size of n_out takes this route over many blocks.
//    The last pass writes the indices as int64. (One block a row for the
//    live path's 16,384 keys, its 4 passes a barrier apart in one launch
//    and the keys in shared memory, took 0.063 ms on an H100: ranking
//    16,384 keys 4 times on one SM.)

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
// threshold and compaction blocks
constexpr int SEL_THREADS = 512;
constexpr int SEL_WARPS = SEL_THREADS / 32;
constexpr int HIST_BINS = 2048;  // the widest digit: 11 bits
constexpr int HIST_ITEMS = 4;    // elements a thread at least in a threshold pass
constexpr int CT_ROUNDS = 8;     // compaction: a block takes 8 rounds of 512 elements
constexpr int CTILE = SEL_THREADS * CT_ROUNDS;
// the radix sort of the selected keys
constexpr int RADIX_BITS = 8;
constexpr int RADIX = 1 << RADIX_BITS;
constexpr int SORT_PASSES = 32 / RADIX_BITS;
constexpr int SORT_WARPS = 8;
constexpr int SORT_THREADS = 32 * SORT_WARPS;  // = RADIX: a thread a digit
static_assert(SORT_THREADS == RADIX, "a sort block's thread d sets digit d's offsets");
// keys a lane of a sort block: 2 (tiles of 512 keys) up to SORT_SMALL
// selected keys a row, else 8 (tiles of 2,048). Smaller tiles put more
// blocks on a small row; larger ones make fewer counts to scan and to add
// atomically (benchmarks/launch_ab.py B8 times both at every size).
constexpr int SORT_SMALL = 4096;
int sort_rounds(int n_out) { return n_out <= SORT_SMALL ? 2 : 8; }
constexpr int SCAN_CHUNK = 8;  // counts a thread loads at once in a scan
// the threshold's digits, from the top: (shift, bits)
constexpr int SEL_PASSES = 3;
constexpr int SEL_SHIFT[SEL_PASSES] = {21, 10, 0};
constexpr int SEL_BITS[SEL_PASSES] = {11, 11, 10};

// Per row, in the scratch: the digits of T found so far, the rank of the
// sought key among the keys that match them (from 1), and the counters by
// which the last block of a launch knows itself.
struct RowState {
  unsigned prefix;
  unsigned rank;
  unsigned hist_done;
  unsigned count_done;
  unsigned scatter_done;
  unsigned sort_done;
  unsigned pad[2];
};

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

// Exclusive prefix sum of v over the block's THREADS threads in thread
// order; *total gets the block's sum. warp_sums holds THREADS / 32 values.
// Every thread of the block must call it.
template <int THREADS>
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned v, unsigned* warp_sums,
                                                         unsigned* total) {
  static_assert(THREADS % 32 == 0 && THREADS <= 1024, "a block of whole warps");
  constexpr int WARPS = THREADS / 32;
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
    unsigned s = lane < WARPS ? warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned n = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += n;
    }
    if (lane < WARPS) warp_sums[lane] = s;
  }
  __syncthreads();
  const unsigned before = w ? warp_sums[w - 1] : 0u;
  *total = warp_sums[WARPS - 1];
  __syncthreads();  // warp_sums free for the next call
  return before + inc - v;
}

// Whether this block is the last of its row's gridDim.x blocks to get
// here: every thread's global writes before the call are visible to that
// block. The counter is set back to 0 by the last block for the next
// launch that uses it.
__device__ __forceinline__ bool last_block(unsigned* done, bool* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(done, 1u) == gridDim.x - 1;
    if (last) *done = 0;
    *flag = last;
  }
  __syncthreads();
  if (*flag) __threadfence();
  return *flag;
}

// One digit of the threshold: blocks (bx, row) histogram the keys of
// [bx * chunk, +chunk) that match the row's prefix under hi_mask; the last
// block of the row picks the bin of the rank-th key. n_out: the rank on
// the first pass (whose prefix is empty); later passes read it from the
// row's state.
__global__ void __launch_bounds__(SEL_THREADS)
select_hist_kernel(const float* __restrict__ priority, RowState* state, unsigned* hist, int N,
                   int chunk, int shift, int bits, unsigned hi_mask, int n_out, int first) {
  __shared__ unsigned sh[HIST_BINS];
  __shared__ unsigned warp_sums[SEL_WARPS];
  __shared__ bool flag;
  const int row = blockIdx.y;
  const int t = threadIdx.x;
  RowState* st = state + row;
  unsigned* h = hist + static_cast<size_t>(row) * HIST_BINS;
  for (int i = t; i < HIST_BINS; i += SEL_THREADS) sh[i] = 0;
  const unsigned prefix = first ? 0u : st->prefix;
  __syncthreads();
  const float* p = priority + static_cast<long long>(row) * N;
  const int lo = blockIdx.x * chunk;
  const int hi = min(N, lo + chunk);
  const unsigned digit_mask = (1u << bits) - 1u;
  for (int i0 = lo; i0 < hi; i0 += SEL_THREADS) {
    const int i = i0 + t;
    if (i < hi) {
      const unsigned key = order_key(p[i]);
      if ((key & hi_mask) == prefix) atomicAdd(&sh[(key >> shift) & digit_mask], 1u);
    }
  }
  __syncthreads();
  for (int i = t; i < HIST_BINS; i += SEL_THREADS) {
    if (sh[i]) atomicAdd(&h[i], sh[i]);
  }
  if (!last_block(&st->hist_done, &flag)) return;
  // the row's histogram is complete: thread t holds bins [4t, 4t + 4)
  constexpr int PER = HIST_BINS / SEL_THREADS;
  unsigned c[PER], s = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    c[j] = __ldcg(&h[PER * t + j]);
    s += c[j];
    h[PER * t + j] = 0;  // clear for the next pass
  }
  const unsigned rank = first ? static_cast<unsigned>(n_out) : st->rank;
  unsigned total;
  const unsigned before = block_exclusive_scan<SEL_THREADS>(s, warp_sums, &total);
  // exactly one thread holds the rank-th key (total >= rank >= 1)
  if (before < rank && rank <= before + s) {
    unsigned cum = before;
    int j = 0;
    while (cum + c[j] < rank) cum += c[j++];
    st->prefix = prefix | (static_cast<unsigned>(PER * t + j) << shift);
    st->rank = rank - cum;
  }
}

// Compaction, first half: per block of CTILE elements the counts of keys
// below T and equal to T, into blk_lt / blk_eq (row-major, nblk a row); the
// last block of the row makes them exclusive prefixes over the blocks.
__global__ void __launch_bounds__(SEL_THREADS)
select_count_kernel(const float* __restrict__ priority, RowState* state, unsigned* blk_lt,
                    unsigned* blk_eq, int N) {
  __shared__ unsigned warp_sums[SEL_WARPS];
  __shared__ bool flag;
  const int row = blockIdx.y;
  const int t = threadIdx.x;
  const int nblk = gridDim.x;
  RowState* st = state + row;
  const unsigned T = st->prefix;
  const float* p = priority + static_cast<long long>(row) * N;
  const int lo = blockIdx.x * CTILE;
  const int hi = min(N, lo + CTILE);
  unsigned lt = 0, eq = 0;
  for (int i = lo + t; i < hi; i += SEL_THREADS) {
    const unsigned key = order_key(p[i]);
    lt += key < T;
    eq += key == T;
  }
  unsigned total_lt, total_eq;
  block_exclusive_scan<SEL_THREADS>(lt, warp_sums, &total_lt);
  block_exclusive_scan<SEL_THREADS>(eq, warp_sums, &total_eq);
  unsigned* row_lt = blk_lt + static_cast<size_t>(row) * nblk;
  unsigned* row_eq = blk_eq + static_cast<size_t>(row) * nblk;
  if (t == 0) {
    row_lt[blockIdx.x] = total_lt;
    row_eq[blockIdx.x] = total_eq;
  }
  if (!last_block(&st->count_done, &flag)) return;
  unsigned carry_lt = 0, carry_eq = 0;
  for (int b0 = 0; b0 < nblk; b0 += SEL_THREADS) {
    const int b = b0 + t;
    const unsigned a = b < nblk ? __ldcg(&row_lt[b]) : 0u;
    const unsigned e = b < nblk ? __ldcg(&row_eq[b]) : 0u;
    unsigned sum_lt, sum_eq;
    const unsigned ex_lt = block_exclusive_scan<SEL_THREADS>(a, warp_sums, &sum_lt);
    const unsigned ex_eq = block_exclusive_scan<SEL_THREADS>(e, warp_sums, &sum_eq);
    if (b < nblk) {
      row_lt[b] = carry_lt + ex_lt;
      row_eq[b] = carry_eq + ex_eq;
    }
    carry_lt += sum_lt;
    carry_eq += sum_eq;
  }
}

__device__ __forceinline__ unsigned sort_digit(unsigned long long key, int shift) {
  return static_cast<unsigned>(key >> shift) & (RADIX - 1);
}

// The last block of a row turns the row's RADIX * ntiles digit counts c,
// (digit, tile) order, into exclusive offsets: thread t takes a run of
// consecutive counts, loaded SCAN_CHUNK at a time (the loads of a chunk
// overlap).
template <int THREADS>
__device__ __forceinline__ void scan_digit_counts(unsigned* c, int ntiles, unsigned* warp_sums) {
  const int total_n = RADIX * ntiles;
  const int per = (total_n + THREADS - 1) / THREADS;
  const int a = min(total_n, static_cast<int>(threadIdx.x) * per);
  const int b = min(total_n, a + per);
  unsigned sum = 0;
  for (int i0 = a; i0 < b; i0 += SCAN_CHUNK) {
    unsigned v[SCAN_CHUNK];
#pragma unroll
    for (int j = 0; j < SCAN_CHUNK; ++j) v[j] = i0 + j < b ? __ldcg(&c[i0 + j]) : 0u;
#pragma unroll
    for (int j = 0; j < SCAN_CHUNK; ++j) sum += v[j];
  }
  unsigned total;
  unsigned run = block_exclusive_scan<THREADS>(sum, warp_sums, &total);
  for (int i0 = a; i0 < b; i0 += SCAN_CHUNK) {
    unsigned v[SCAN_CHUNK];
#pragma unroll
    for (int j = 0; j < SCAN_CHUNK; ++j) v[j] = i0 + j < b ? __ldcg(&c[i0 + j]) : 0u;
#pragma unroll
    for (int j = 0; j < SCAN_CHUNK; ++j) {
      if (i0 + j < b) c[i0 + j] = run;
      run += v[j];
    }
  }
}

// Compaction, second half: every selected element of the block's tile as
// its packed key (key << 32 | index) at its place in index order among
// the row's n_out selected elements; each counted in counts, at its first
// sort digit and the sort tile it lands in, and the last block of the row
// scans those counts for the first sort pass.
__global__ void __launch_bounds__(SEL_THREADS)
select_scatter_kernel(const float* __restrict__ priority, RowState* state,
                      const unsigned* blk_lt, const unsigned* blk_eq,
                      unsigned long long* keys, unsigned* counts, int N, int n_out, int ntiles,
                      int tile_keys) {
  __shared__ unsigned warp_sums[SEL_WARPS];
  __shared__ bool flag;
  const int row = blockIdx.y;
  const int t = threadIdx.x;
  const int nblk = gridDim.x;
  const unsigned T = state[row].prefix;
  const unsigned need = state[row].rank;
  const float* p = priority + static_cast<long long>(row) * N;
  unsigned long long* out = keys + static_cast<long long>(row) * n_out;
  unsigned* c = counts + static_cast<size_t>(row) * RADIX * ntiles;
  unsigned lt_base = blk_lt[static_cast<size_t>(row) * nblk + blockIdx.x];
  unsigned eq_base = blk_eq[static_cast<size_t>(row) * nblk + blockIdx.x];
  const int lo = blockIdx.x * CTILE;
  const int hi = min(N, lo + CTILE);
  // round r takes elements lo + r * SEL_THREADS + t: index order is (r, t)
  for (int r = 0; r < CT_ROUNDS; ++r) {
    const int i = lo + r * SEL_THREADS + t;
    unsigned key = 0;
    bool is_lt = false, is_eq = false;
    if (i < hi) {
      key = order_key(p[i]);
      is_lt = key < T;
      is_eq = key == T;
    }
    // both counts in one scan: below T in the low half, equal in the high
    unsigned total;
    const unsigned ex = block_exclusive_scan<SEL_THREADS>(
        static_cast<unsigned>(is_lt) | (static_cast<unsigned>(is_eq) << 16), warp_sums, &total);
    const unsigned lt_before = lt_base + (ex & 0xffffu);
    const unsigned eq_before = eq_base + (ex >> 16);
    if (is_lt || (is_eq && eq_before < need)) {
      const unsigned pos = lt_before + min(eq_before, need);
      const unsigned long long packed =
          (static_cast<unsigned long long>(key) << 32) | static_cast<unsigned>(i);
      out[pos] = packed;
      atomicAdd(&c[sort_digit(packed, 32) * ntiles + pos / tile_keys], 1u);
    }
    lt_base += total & 0xffffu;
    eq_base += total >> 16;
  }
  if (!last_block(&state[row].scatter_done, &flag)) return;
  scan_digit_counts<SEL_THREADS>(c, ntiles, warp_sums);
}

// One stable radix pass over the row's n selected keys, by the digit at
// shift: block j takes the TILE = SORT_THREADS * ROUNDS keys [j * TILE,
// +TILE) of src, warp w of it the 32 * ROUNDS consecutive keys from
// j * TILE + w * 32 * ROUNDS. Each warp counts its keys' digits;
// thread d of the block turns them into the warps' offsets, from the tile's
// offset for digit d in cur (the scanned (digit, tile) counts); each warp
// writes its keys, in order, at their digit's offset plus their rank among
// the warp's earlier keys of that digit. Each written key is counted in next
// at its next digit and the tile of dst it lands in, and the last block of
// the row scans those counts for the next pass. The last pass writes the
// indices as int64 instead.
template <int ROUNDS>
__global__ void __launch_bounds__(SORT_THREADS)
select_sort_pass_kernel(const unsigned long long* __restrict__ src, unsigned long long* dst,
                        long long* idx, const unsigned* cur, unsigned* next, RowState* state,
                        int n, int shift) {
  __shared__ unsigned cnt[SORT_WARPS][RADIX];  // counts, then offsets
  __shared__ unsigned warp_sums[SORT_WARPS];
  __shared__ bool flag;
  const int row = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int ntiles = gridDim.x;
  constexpr int TILE = SORT_THREADS * ROUNDS;
  const int base = blockIdx.x * TILE + w * 32 * ROUNDS;
  const long long row_keys = static_cast<long long>(row) * n;
  const size_t row_counts = static_cast<size_t>(row) * RADIX * ntiles;
  unsigned long long k[ROUNDS];
  unsigned peers[ROUNDS];
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int e = base + r * 32 + lane;
    k[r] = e < n ? src[row_keys + e] : 0ull;
  }
  for (int d = lane; d < RADIX; d += 32) cnt[w][d] = 0;
  __syncwarp();
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const bool valid = base + r * 32 + lane < n;
    const unsigned d = sort_digit(k[r], shift);
    peers[r] = same_digit_lanes<RADIX_BITS>(d, valid);
    if (valid && __ffs(peers[r]) - 1 == lane) cnt[w][d] += __popc(peers[r]);
    __syncwarp();
  }
  __syncthreads();
  {
    unsigned run = cur[row_counts + static_cast<size_t>(t) * ntiles + blockIdx.x];
#pragma unroll
    for (int v = 0; v < SORT_WARPS; ++v) {
      const unsigned c = cnt[v][t];
      cnt[v][t] = run;
      run += c;
    }
  }
  __syncthreads();
  const bool final_pass = idx != nullptr;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const bool valid = base + r * 32 + lane < n;
    const unsigned d = sort_digit(k[r], shift);
    unsigned pos = 0;
    if (valid) pos = cnt[w][d] + __popc(peers[r] & lanemask_lt());
    __syncwarp();
    if (valid && __ffs(peers[r]) - 1 == lane) cnt[w][d] += __popc(peers[r]);
    __syncwarp();
    if (valid) {
      if (final_pass) {
        idx[row_keys + pos] = static_cast<long long>(k[r] & 0xffffffffull);
      } else {
        dst[row_keys + pos] = k[r];
        atomicAdd(&next[row_counts + sort_digit(k[r], shift + RADIX_BITS) * ntiles +
                        pos / TILE], 1u);
      }
    }
  }
  if (final_pass) return;  // the same on every thread
  if (!last_block(&state[row].sort_done, &flag)) return;
  scan_digit_counts<SORT_THREADS>(next + row_counts, ntiles, warp_sums);
}

size_t align_up(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

struct Layout {
  size_t state, hist, counts, head, blk_lt, blk_eq, keys_a, keys_b, total;
  int nblk, ntiles;
};

Layout layout(int B, int N, int n_out) {
  Layout l;
  l.nblk = (N + CTILE - 1) / CTILE;
  const int tile_keys = SORT_THREADS * sort_rounds(n_out);
  l.ntiles = (n_out + tile_keys - 1) / tile_keys;
  size_t at = 0;
  l.state = at;
  at = align_up(at + sizeof(RowState) * B);
  l.hist = at;
  at = align_up(at + sizeof(unsigned) * HIST_BINS * B);
  l.counts = at;  // a (B, RADIX, ntiles) table of digit counts for each sort pass
  at = align_up(at + sizeof(unsigned) * SORT_PASSES * RADIX * static_cast<size_t>(l.ntiles) * B);
  l.head = at;  // set to 0 before each call: states, histograms, digit counts
  l.blk_lt = at;
  at = align_up(at + sizeof(unsigned) * static_cast<size_t>(l.nblk) * B);
  l.blk_eq = at;
  at = align_up(at + sizeof(unsigned) * static_cast<size_t>(l.nblk) * B);
  l.keys_a = at;
  at = align_up(at + sizeof(unsigned long long) * static_cast<size_t>(n_out) * B);
  l.keys_b = at;
  at = align_up(at + sizeof(unsigned long long) * static_cast<size_t>(n_out) * B);
  l.total = at;
  return l;
}

bool valid_shape(int B, int N, int n_out) {
  return B >= 0 && B <= 65535 && N >= 1 && n_out >= 1 && n_out <= N;
}

}  // namespace

// Bytes of scratch r3d_select_smallest needs for B rows of N priorities
// selecting n_out; -1 for a shape it refuses.
extern "C" long long r3d_select_scratch_bytes(int B, int N, int n_out) {
  if (!valid_shape(B, N, n_out)) return -1;
  return static_cast<long long>(layout(B, N, n_out).total);
}

// priority (B, N) float32; scratch of r3d_select_scratch_bytes(B, N, n_out)
// bytes, 256-byte aligned; order (B, n_out) int64 out: each row's n_out
// smallest priorities' indices in ascending priority, ties to the lower
// index. B <= 65,535, 1 <= n_out <= N. Returns cudaGetLastError().
extern "C" int r3d_select_smallest(const float* priority, void* scratch, long long* order,
                                   int B, int N, int n_out, void* stream) {
  if (!valid_shape(B, N, n_out)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout l = layout(B, N, n_out);
  char* base = static_cast<char*>(scratch);
  RowState* state = reinterpret_cast<RowState*>(base + l.state);
  unsigned* hist = reinterpret_cast<unsigned*>(base + l.hist);
  unsigned* blk_lt = reinterpret_cast<unsigned*>(base + l.blk_lt);
  unsigned* blk_eq = reinterpret_cast<unsigned*>(base + l.blk_eq);
  unsigned long long* keys_a = reinterpret_cast<unsigned long long*>(base + l.keys_a);
  unsigned long long* keys_b = reinterpret_cast<unsigned long long*>(base + l.keys_b);
  cudaError_t err = cudaMemsetAsync(base, 0, l.head, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  // 1. the threshold: blocks of at least HIST_ITEMS elements a thread,
  // about four blocks an SM over all rows
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int by_size = (N + SEL_THREADS * HIST_ITEMS - 1) / (SEL_THREADS * HIST_ITEMS);
  const int by_card = max(1, (4 * sms + B - 1) / B);
  int per_row = min(by_size, by_card);
  const int chunk = (N + per_row - 1) / per_row;
  per_row = (N + chunk - 1) / chunk;
  unsigned hi_mask = 0;
  for (int pass = 0; pass < SEL_PASSES; ++pass) {
    select_hist_kernel<<<dim3(per_row, B), SEL_THREADS, 0, s>>>(priority, state, hist, N, chunk, SEL_SHIFT[pass], SEL_BITS[pass], hi_mask, n_out, pass == 0);
    hi_mask |= ((1u << SEL_BITS[pass]) - 1u) << SEL_SHIFT[pass];
  }
  // 2. the selected keys, in index order, and their first digits' counts
  const size_t pass_counts = static_cast<size_t>(RADIX) * l.ntiles * B;
  unsigned* counts = reinterpret_cast<unsigned*>(base + l.counts);
  select_count_kernel<<<dim3(l.nblk, B), SEL_THREADS, 0, s>>>(priority, state, blk_lt, blk_eq, N);
  const int rounds = sort_rounds(n_out);
  select_scatter_kernel<<<dim3(l.nblk, B), SEL_THREADS, 0, s>>>(priority, state, blk_lt, blk_eq, keys_a, counts, N, n_out, l.ntiles, SORT_THREADS * rounds);
  // 3. their order: four stable passes over the 32-bit key
  unsigned long long* src = keys_a;
  unsigned long long* dst = keys_b;
  for (int pass = 0; pass < SORT_PASSES; ++pass) {
    const bool final_pass = pass == SORT_PASSES - 1;
    const unsigned* cur = counts + pass * pass_counts;
    unsigned* next = final_pass ? nullptr : counts + (pass + 1) * pass_counts;
    long long* idx = final_pass ? order : nullptr;
    const int shift = 32 + RADIX_BITS * pass;
    switch (rounds) {
      case 2:
        select_sort_pass_kernel<2><<<dim3(l.ntiles, B), SORT_THREADS, 0, s>>>(src, dst, idx, cur, next, state, n_out, shift);
        break;
      case 8:
        select_sort_pass_kernel<8><<<dim3(l.ntiles, B), SORT_THREADS, 0, s>>>(src, dst, idx, cur, next, state, n_out, shift);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    unsigned long long* t = src;
    src = dst;
    dst = t;
  }
  return static_cast<int>(cudaGetLastError());
}
