// Bitonic compare-exchange stages for Hopper (sm_90a), C ABI for ctypes.
//
// r3d_roll_stages replaces benchmarks/bench_roll_stages.py::_kernel, the
// micro-benchmark that asks whether a bitonic compare-exchange network can
// beat repeated min-extraction for the KNN selection. On every row of ts
// lanes (x is (rows, ts) float32, a payload starting as the lane index) it
// runs S stages; stage s uses d = [1, 2, 4, 8, 16, 32][:max(1, min(6, S))]
// [s % len] and kk = 32:
//   partner  = v[i ^ d]                  (the TPU kernel's two rolls + select)
//   keep_min = (1 - bit_d(i)) ^ bit_kk(i)
//   cmp      = v <= partner
//   v, p     = keep_min ? (cmp ? v : partner, cmp ? p : p_partner)
//                       : (cmp ? partner : v, cmp ? p_partner : p)
// and writes v + float(p) * 1e-12. On v == partner both lanes keep the
// min-lane's payload (cmp holds on both sides), so the payload is
// duplicated: the TPU kernel does that too, and this kernel reproduces it.
//
// Design. With one thread per lane, partners exchanged by __shfl_xor_sync
// (d <= 16) or through shared memory between two barriers (d = 32), the
// exchange, which the bound does not count, held the kernel at 5.5x its
// bound. Here each thread holds E consecutive elements of a row in
// registers, value and payload. At E = 64 (16 threads a 1,024-lane row)
// every partner i ^ d (d <= 32 < 64) is in the thread's own registers: no
// shuffle, no shared memory, no barrier. At E = 32 the d = 32 stage takes
// one shuffle of value and payload between the two threads of a 64-lane
// half, and the thread needs half the registers, so that more bytes are in
// flight: E = 32 is the faster where the stages are few and the loads and
// stores dominate, E = 64 where the stages are many (roll_elements picks
// by S; benchmarks/launch_ab.py times each E at every S against the
// choice). The six-stage cycle is unrolled at
// compile time (roll_cycle<n>: a loop of S / 6 full cycles, then the first
// S % 6 stages), so d, the register indices and the lane predicates
// (bit_d of the element's position, and at E = 64 bit_kk: the thread's
// elements start at a multiple of E) are constants: a stage is a compare
// and two selects an element. Loads and stores go through a shared-memory tile, so that global
// memory sees coalesced 16-byte vectors. The
// epilogue uses __fmul_rn / __fadd_rn so nvcc cannot contract it into an
// FMA: the output is bit-identical to the plain PyTorch version
// (ops/bitonic_kernels.py::roll_stages_plain).
//
// Bound on this card. The kernel reads and writes every element once:
// 2 * 4 bytes an element (536,870,912 bytes at (512, 128, 1024), 0.160 ms
// at 3.35 TB/s). Per element and stage the function needs a compare and
// two selects (value and payload): which side keeps the minimum depends on
// the element's position alone, not on the data. The epilogue adds 3 (a
// conversion, a multiply, an add). None is an FMA, so each is one lane
// instruction at 33.5 T/s (the 67 TFLOP/s float32 rate counts an FMA as
// two): at S = 45 that is 138 instructions an element, 0.277 ms, and the
// instructions bound it from S = 26 on. (An earlier count took 7 a stage,
// the TPU kernel's formula with its position tests evaluated per element;
// a kernel that resolves them at compile time does less, so that count is
// no bound.)

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_TS = 1024;
constexpr int ROLL_THREADS = 128;
constexpr int ROLL_E32_MAX_STAGES = 15;  // roll_elements: 32 elements a thread up to this S
// float32(1e-12), the value the JAX kernel's weakly typed 1e-12 takes
constexpr float PAYLOAD_SCALE = 0x1.197998p-40f;

// One stage at distance D on the thread's E elements; base is the position
// of its first element in the row (a multiple of E).
template <int D, int E>
__device__ __forceinline__ void roll_stage(float (&v)[E], int (&p)[E], int base) {
  constexpr int KK = 32;
  if constexpr (D < E) {
    // partners in the thread's registers: pairs (e, e + D), bit_d 0 and 1
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e & D) continue;
      const int f = e + D;
      // bit_kk of positions base + e and base + f; base is a multiple of
      // E, so at E >= 64 it is a constant
      const int pos_e = E >= 2 * KK ? e : base + e;
      const int pos_f = E >= 2 * KK ? f : base + f;
      const bool kk_e = (pos_e & KK) != 0, kk_f = (pos_f & KK) != 0;
      const bool min_e = !kk_e, min_f = kk_f;  // keep_min = (1 - bit_d) ^ bit_kk
      const float ve = v[e], vf = v[f];
      const int pe = p[e], pf = p[f];
      const bool ce = ve <= vf, cf = vf <= ve;
      v[e] = min_e == ce ? ve : vf;  // keep_min ? (cmp ? v : partner) : (cmp ? partner : v)
      p[e] = min_e == ce ? pe : pf;
      v[f] = min_f == cf ? vf : ve;
      p[f] = min_f == cf ? pf : pe;
    }
  } else {
    // partner at the same register of thread lane ^ (D / E)
    const bool keep_min = ((base & D) == 0) != ((base & KK) != 0);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float pv = __shfl_xor_sync(FULL, v[e], D / E);
      const int pp = __shfl_xor_sync(FULL, p[e], D / E);
      const bool c = v[e] <= pv;
      v[e] = keep_min == c ? v[e] : pv;
      p[e] = keep_min == c ? p[e] : pp;
    }
  }
}

// The first N of the six stages d = 1, 2, 4, 8, 16, 32.
template <int N, int E>
__device__ __forceinline__ void roll_cycle(float (&v)[E], int (&p)[E], int base) {
  if constexpr (N > 0) roll_stage<1>(v, p, base);
  if constexpr (N > 1) roll_stage<2>(v, p, base);
  if constexpr (N > 2) roll_stage<4>(v, p, base);
  if constexpr (N > 3) roll_stage<8>(v, p, base);
  if constexpr (N > 4) roll_stage<16>(v, p, base);
  if constexpr (N > 5) roll_stage<32>(v, p, base);
}

// Thread t holds elements [E * t, +E) of the flattened (rows, ts) array (ts
// a multiple of 64 >= E, so a thread's elements lie in one row).
// Stage s has d = [1, 2, 4, 8, 16, 32][:max(1, min(6, S))][s % len]: for
// S <= 6 that is the first S distances once, for S > 6 S / 6 full cycles
// and then the first S % 6. The block's elements pass through shared
// memory on the way in and out, so that global memory is read and written
// in coalesced 16-byte vectors (consecutive threads, consecutive vectors);
// vector u of thread t sits at t * VEC + (u ^ (t % VEC)), so that neither
// side's accesses conflict on banks.
template <int E>
__global__ void __launch_bounds__(ROLL_THREADS)
roll_stages_kernel(const float* __restrict__ x, float* __restrict__ out, long long n_elem,
                   int ts, int stages) {
  constexpr int VEC = E / 4;  // 16-byte vectors a thread
  __shared__ float4 tile[ROLL_THREADS * VEC];
  const int t = threadIdx.x;
  const long long block_first = static_cast<long long>(blockIdx.x) * ROLL_THREADS * E;
  const long long n_vec = (n_elem - block_first) / 4;  // vectors left from the block's first
  const float4* src = reinterpret_cast<const float4*>(x + block_first);
#pragma unroll
  for (int u = 0; u < VEC; ++u) {
    const int g = u * ROLL_THREADS + t;  // coalesced
    const int owner = g / VEC, w = g % VEC;
    if (g < n_vec) tile[owner * VEC + (w ^ (owner % VEC))] = src[g];
  }
  __syncthreads();
  const long long first = block_first + static_cast<long long>(t) * E;
  const int base = static_cast<int>(first % ts);
  float v[E];
  int p[E];
#pragma unroll
  for (int u = 0; u < VEC; ++u) {
    const float4 q = tile[t * VEC + (u ^ (t % VEC))];
    v[4 * u] = q.x;
    v[4 * u + 1] = q.y;
    v[4 * u + 2] = q.z;
    v[4 * u + 3] = q.w;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) p[e] = base + e;
  for (int c = 0; c < stages / 6; ++c) roll_cycle<6, E>(v, p, base);
  switch (stages % 6) {
    case 1: roll_cycle<1, E>(v, p, base); break;
    case 2: roll_cycle<2, E>(v, p, base); break;
    case 3: roll_cycle<3, E>(v, p, base); break;
    case 4: roll_cycle<4, E>(v, p, base); break;
    case 5: roll_cycle<5, E>(v, p, base); break;
    default: break;
  }
#pragma unroll
  for (int u = 0; u < VEC; ++u) {
    float r[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int e = 4 * u + w;
      r[w] = __fadd_rn(v[e], __fmul_rn(__int2float_rn(p[e]), PAYLOAD_SCALE));
    }
    tile[t * VEC + (u ^ (t % VEC))] = make_float4(r[0], r[1], r[2], r[3]);
  }
  __syncthreads();
  float4* dst = reinterpret_cast<float4*>(out + block_first);
#pragma unroll
  for (int u = 0; u < VEC; ++u) {
    const int g = u * ROLL_THREADS + t;
    const int owner = g / VEC, w = g % VEC;
    if (g < n_vec) dst[g] = tile[owner * VEC + (w ^ (owner % VEC))];
  }
}

template <int E>
void launch_roll(const float* x, float* out, long long n_elem, int ts, int stages,
                 cudaStream_t stream) {
  const long long per_block = static_cast<long long>(ROLL_THREADS) * E;
  const unsigned blocks = static_cast<unsigned>((n_elem + per_block - 1) / per_block);
  roll_stages_kernel<E><<<blocks, ROLL_THREADS, 0, stream>>>(x, out, n_elem, ts, stages);
}

// elements a thread holds: 32 while the stages are few, 64 beyond
inline int roll_elements(int stages) { return stages <= ROLL_E32_MAX_STAGES ? 32 : 64; }

}  // namespace

// x (rows, ts) float32 in, out (rows, ts) float32, both 16-byte aligned; ts
// a multiple of 64 and at most 1024, stages >= 0. Returns
// cudaGetLastError().
extern "C" int r3d_roll_stages(const float* x, float* out, int rows, int ts,
                               int stages, void* stream) {
  if (rows == 0) return 0;
  if (ts < 64 || ts > MAX_TS || ts % 64 != 0 || stages < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_elem = static_cast<long long>(rows) * ts;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (roll_elements(stages) == 32) {
    launch_roll<32>(x, out, n_elem, ts, stages, s);
  } else {
    launch_roll<64>(x, out, n_elem, ts, stages, s);
  }
  return static_cast<int>(cudaGetLastError());
}
