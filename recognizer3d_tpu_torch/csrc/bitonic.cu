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
// Design. One block per row, one thread per lane, value and payload in
// registers. The partner comes by __shfl_xor_sync for d <= 16, inside the
// warp; d = 32 crosses warps and goes through shared memory between two
// barriers. The lane predicates depend only on the lane and d. The
// epilogue uses __fmul_rn / __fadd_rn so nvcc cannot contract it into an
// FMA: the output is bit-identical to the plain PyTorch version
// (ops/bitonic_kernels.py::roll_stages_plain).
//
// Bound on this card. The kernel reads and writes every element once:
// 2 * 4 bytes an element (536,870,912 bytes at (512, 128, 1024), 0.160 ms
// at 3.35 TB/s). Per element and stage it does 7 operations on the data
// (one compare, four selects of min / max and their payloads, two selects
// by keep_min), and 3 in the epilogue. None is an FMA, so each is one lane
// instruction at 33.5 T/s (the 67 TFLOP/s float32 rate counts an FMA as
// two): at S = 45 that is 318 instructions an element, 0.64 ms, and the
// instructions bound it from S = 12 on. The partner exchange is data
// movement (shuffles, shared memory) and is not counted.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_TS = 1024;
// float32(1e-12), the value the JAX kernel's weakly typed 1e-12 takes
constexpr float PAYLOAD_SCALE = 0x1.197998p-40f;

__global__ void roll_stages_kernel(const float* __restrict__ x,
                                   float* __restrict__ out, int ts,
                                   int stages) {
  __shared__ float s_v[MAX_TS];
  __shared__ int s_p[MAX_TS];
  const int lane = threadIdx.x;
  const size_t at = static_cast<size_t>(blockIdx.x) * ts + lane;
  float v = x[at];
  int p = lane;
  const int n_d = max(1, min(6, stages));
  const int bit_kk = (lane >> 5) & 1;
  for (int s = 0; s < stages; ++s) {
    const int d = 1 << (s % n_d);
    float pv;
    int pp;
    if (d <= 16) {
      pv = __shfl_xor_sync(FULL, v, d);
      pp = __shfl_xor_sync(FULL, p, d);
    } else {
      __syncthreads();  // the previous exchange's reads are done
      s_v[lane] = v;
      s_p[lane] = p;
      __syncthreads();
      pv = s_v[lane ^ d];
      pp = s_p[lane ^ d];
    }
    const int bit_d = (lane & d) ? 1 : 0;
    const bool keep_min = ((1 - bit_d) ^ bit_kk) == 1;
    const bool cmp = v <= pv;
    const float mn = cmp ? v : pv;
    const float mx = cmp ? pv : v;
    const int pmn = cmp ? p : pp;
    const int pmx = cmp ? pp : p;
    v = keep_min ? mn : mx;
    p = keep_min ? pmn : pmx;
  }
  out[at] = __fadd_rn(v, __fmul_rn(__int2float_rn(p), PAYLOAD_SCALE));
}

}  // namespace

// x (rows, ts) float32 in, out (rows, ts) float32; ts a multiple of 64 and
// at most 1024, stages >= 0. Returns cudaGetLastError().
extern "C" int r3d_roll_stages(const float* x, float* out, int rows, int ts,
                               int stages, void* stream) {
  if (rows == 0) return 0;
  if (ts < 64 || ts > MAX_TS || ts % 64 != 0 || stages < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  roll_stages_kernel<<<rows, ts, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, ts, stages);
  return static_cast<int>(cudaGetLastError());
}
