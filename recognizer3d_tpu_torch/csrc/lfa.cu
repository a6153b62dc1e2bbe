// Fused eval-mode LFA (local feature aggregation) kernels for Hopper
// (sm_90a), C ABI for ctypes.
//
// r3d_lfa_round1 replaces recognizer3d_tpu/ops/lfa_pallas.py::_round1_kernel:
//   rpe    = relu(((g_rpe + center) + dist * w9) * s1 + o1)     per (k, c < h)
//   cat    = [rpe | g_feat]                                      (K, 2h)
//   w      = softmax_K(cat @ Ws)                                 (K, 2h)
//   pooled = relu(sum_K(w * cat) @ Wp + op)                      (h)
//   rpe2   = relu(rpe @ W2 + o2)                                 (K, h)
// r3d_lfa_pool2_res replaces ::_pool2_res_kernel:
//   cat    = [rpe2 | g2]                                         (K, 2h)
//   w      = softmax_K(cat @ Ws)
//   pooled = relu(sum_K(w * cat) @ Wp + op)                      (2h)
//   out    = leaky_relu(pooled @ Wm + f_in @ Wsh + off, 0.01)    (4h)
// r3d_lfa_pool2 replaces ::_pool2_kernel: the same kernel compiled without
// the residual (RES = false), out = pooled (2h).
// with every BatchNorm already folded into the constants by the Python
// wrapper (ops/lfa_kernels.py), exactly as the JAX wrappers fold them.
//
// Design. The TPU kernels flatten (K, 2h) into lanes and express each
// per-channel linear map as a block-diagonal (kron) matmul with lane rolls
// for the softmax: layout tricks for a 128-lane vector unit. Here a block
// owns one row (point) at a time and computes the same maths per
// (k, channel) directly: the row's (K, 2h) tile, its scores and all the
// small weight matrices (Ws up to 64x64, Wp, W2, Wm, Wsh) sit in shared
// memory, loaded once per block; blocks stride over rows.
//
// Bound on this card. Per row the kernels read K*2h floats (plus K
// distances and h centre terms, or F input features) and write K*h + h
// (round 1) or 4h floats (pool 2), against about 2*K*(2h)^2 flops of
// scores. At h=32 (level 1) that is ~260 kflop per 8 kB row: bound by
// operations at the float32 rate. At h=8 (level 0) it is ~16 kflop per
// 2 kB row, near the card's balance point. The small products run as
// scalar loops; tensor cores (TF32 would break the f32 parity contract)
// and more rows per block are later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int LFA_THREADS = 256;
constexpr int LFA_MAX_BLOCKS = 2048;

__host__ __device__ constexpr int round1_consts(int h) {
  // w9, s1, o1 (h each) | Ws (2h x 2h) | Wp (2h x h) | op (h) | W2 (h x h) | o2 (h)
  return 5 * h + 7 * h * h;
}

__host__ __device__ constexpr int pool2_head_consts(int h) {
  // Ws (2h x 2h) | Wp (2h x 2h) | op (2h): all that pool 2 alone reads
  return 8 * h * h + 2 * h;
}

__host__ __device__ constexpr int pool2_consts(int h, int f) {
  // the head | Wm (2h x 4h) | Wsh (F x 4h) | off (4h)
  return pool2_head_consts(h) + 8 * h * h + 4 * h + 4 * h * f;
}

// softmax over K per channel of sc (K, C2), then agg[j] = sum_k w * cat
__device__ __forceinline__ void softmax_pool(const float* sc, const float* cat,
                                             float* agg, int K, int C2) {
  for (int j = threadIdx.x; j < C2; j += blockDim.x) {
    float m = -CUDART_INF_F;
    for (int k = 0; k < K; ++k) m = fmaxf(m, sc[k * C2 + j]);
    float z = 0.f;
    for (int k = 0; k < K; ++k) z += expf(sc[k * C2 + j] - m);
    float a = 0.f;
    for (int k = 0; k < K; ++k) {
      a += (expf(sc[k * C2 + j] - m) / z) * cat[k * C2 + j];
    }
    agg[j] = a;
  }
}

// sc (K, C2) = cat (K, C2) @ ws (C2, C2)
__device__ __forceinline__ void scores(const float* cat, const float* ws,
                                       float* sc, int K, int C2) {
  for (int e = threadIdx.x; e < K * C2; e += blockDim.x) {
    const int k = e / C2, j = e % C2;
    const float* x = cat + k * C2;
    float acc = 0.f;
    for (int c = 0; c < C2; ++c) acc += x[c] * ws[c * C2 + j];
    sc[e] = acc;
  }
}

template <int H>
__global__ void lfa_round1_kernel(const float* __restrict__ g,
                                  const float* __restrict__ d2,
                                  const float* __restrict__ center,
                                  const float* __restrict__ consts,
                                  float* __restrict__ pooled_out,
                                  float* __restrict__ rpe2_out,
                                  int rows, int K) {
  constexpr int C2 = 2 * H;
  constexpr int NC = round1_consts(H);
  extern __shared__ float sm[];
  float* cst = sm;
  float* cat = cst + NC;       // K * C2
  float* sc = cat + K * C2;    // K * C2
  float* agg = sc + K * C2;    // C2
  const float* w9 = cst;
  const float* s1 = w9 + H;
  const float* o1 = s1 + H;
  const float* ws = o1 + H;
  const float* wp = ws + C2 * C2;
  const float* op = wp + C2 * H;
  const float* w2 = op + H;
  const float* o2 = w2 + H * H;

  for (int i = threadIdx.x; i < NC; i += blockDim.x) cst[i] = consts[i];
  __syncthreads();

  const int L = K * C2;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const float* grow = g + static_cast<size_t>(row) * L;
    for (int e = threadIdx.x; e < L; e += blockDim.x) {
      const int k = e / C2, c = e % C2;
      float v = grow[e];
      if (c < H) {
        const float dist = sqrtf(fmaxf(d2[static_cast<size_t>(row) * K + k], 0.f));
        const float pre = (v + center[static_cast<size_t>(row) * H + c]) + dist * w9[c];
        v = fmaxf(pre * s1[c] + o1[c], 0.f);
      }
      cat[e] = v;
    }
    __syncthreads();
    scores(cat, ws, sc, K, C2);
    __syncthreads();
    softmax_pool(sc, cat, agg, K, C2);
    __syncthreads();
    for (int i = threadIdx.x; i < H; i += blockDim.x) {
      float acc = 0.f;
      for (int j = 0; j < C2; ++j) acc += agg[j] * wp[j * H + i];
      pooled_out[static_cast<size_t>(row) * H + i] = fmaxf(acc + op[i], 0.f);
    }
    for (int e = threadIdx.x; e < K * H; e += blockDim.x) {
      const int k = e / H, i = e % H;
      const float* x = cat + k * C2;
      float acc = 0.f;
      for (int c = 0; c < H; ++c) acc += x[c] * w2[c * H + i];
      rpe2_out[static_cast<size_t>(row) * K * H + e] = fmaxf(acc + o2[i], 0.f);
    }
    __syncthreads();
  }
}

// RES = false: pool 2 alone (F = 0, f_in unused), out (rows, 2h).
template <int H, bool RES>
__global__ void lfa_pool2_res_kernel(const float* __restrict__ rpe2,
                                     const float* __restrict__ g2,
                                     const float* __restrict__ f_in,
                                     const float* __restrict__ consts,
                                     float* __restrict__ out,
                                     int rows, int K, int F) {
  constexpr int C2 = 2 * H;
  constexpr int C4 = 4 * H;
  const int NC = RES ? pool2_consts(H, F) : pool2_head_consts(H);
  extern __shared__ float sm[];
  float* cst = sm;
  float* cat = cst + NC;        // K * C2
  float* sc = cat + K * C2;     // K * C2
  float* agg = sc + K * C2;     // C2
  float* pooled = agg + C2;     // C2
  float* fin = pooled + C2;     // F
  const float* ws = cst;
  const float* wp = ws + C2 * C2;
  const float* op = wp + C2 * C2;
  const float* wm = op + C2;
  const float* wsh = wm + C2 * C4;
  const float* off = wsh + F * C4;

  for (int i = threadIdx.x; i < NC; i += blockDim.x) cst[i] = consts[i];
  __syncthreads();

  const int KH = K * H;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const float* r_row = rpe2 + static_cast<size_t>(row) * KH;
    const float* g_row = g2 + static_cast<size_t>(row) * KH;
    for (int e = threadIdx.x; e < K * C2; e += blockDim.x) {
      const int k = e / C2, c = e % C2;
      cat[e] = c < H ? r_row[k * H + c] : g_row[k * H + c - H];
    }
    for (int f = threadIdx.x; f < F; f += blockDim.x) {
      fin[f] = f_in[static_cast<size_t>(row) * F + f];
    }
    __syncthreads();
    scores(cat, ws, sc, K, C2);
    __syncthreads();
    softmax_pool(sc, cat, agg, K, C2);
    __syncthreads();
    for (int i = threadIdx.x; i < C2; i += blockDim.x) {
      float acc = 0.f;
      for (int j = 0; j < C2; ++j) acc += agg[j] * wp[j * C2 + i];
      const float p = fmaxf(acc + op[i], 0.f);
      if constexpr (RES) {
        pooled[i] = p;
      } else {
        out[static_cast<size_t>(row) * C2 + i] = p;
      }
    }
    __syncthreads();
    if constexpr (RES) {
      for (int o = threadIdx.x; o < C4; o += blockDim.x) {
        float a = 0.f;
        for (int i = 0; i < C2; ++i) a += pooled[i] * wm[i * C4 + o];
        float b = 0.f;
        for (int f = 0; f < F; ++f) b += fin[f] * wsh[f * C4 + o];
        const float res = (a + b) + off[o];
        out[static_cast<size_t>(row) * C4 + o] = res > 0.f ? res : 0.01f * res;
      }
      __syncthreads();
    }
  }
}

template <typename Kernel>
int launch_config(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// gathered (rows, K, 2h), d2 (rows, K), center (rows, h), consts as laid out
// in round1_consts; pooled (rows, h) and rpe2 (rows, K, h) out. h in {8, 32}.
extern "C" int r3d_lfa_round1(const float* g, const float* d2,
                              const float* center, const float* consts,
                              float* pooled, float* rpe2, int rows, int K,
                              int h, void* stream) {
  if (rows == 0) return 0;
  const size_t smem =
      (static_cast<size_t>(round1_consts(h)) + 4 * static_cast<size_t>(K) * h + 2 * h) *
      sizeof(float);
  const int grid = rows < LFA_MAX_BLOCKS ? rows : LFA_MAX_BLOCKS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (h) {
    case 8:
      if ((err = launch_config(lfa_round1_kernel<8>, smem))) return err;
      lfa_round1_kernel<8><<<grid, LFA_THREADS, smem, s>>>(g, d2, center, consts,
                                                           pooled, rpe2, rows, K);
      break;
    case 32:
      if ((err = launch_config(lfa_round1_kernel<32>, smem))) return err;
      lfa_round1_kernel<32><<<grid, LFA_THREADS, smem, s>>>(g, d2, center, consts,
                                                            pooled, rpe2, rows, K);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {

template <bool RES>
int launch_pool2(const float* rpe2, const float* g2, const float* f_in,
                 const float* consts, float* out, int rows, int K, int h,
                 int F, void* stream) {
  if (rows == 0) return 0;
  const int nc = RES ? pool2_consts(h, F) : pool2_head_consts(h);
  const size_t smem = (static_cast<size_t>(nc) +
                       4 * static_cast<size_t>(K) * h + 4 * h + F) *
                      sizeof(float);
  const int grid = rows < LFA_MAX_BLOCKS ? rows : LFA_MAX_BLOCKS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (h) {
    case 8:
      if ((err = launch_config(lfa_pool2_res_kernel<8, RES>, smem))) return err;
      lfa_pool2_res_kernel<8, RES><<<grid, LFA_THREADS, smem, s>>>(
          rpe2, g2, f_in, consts, out, rows, K, F);
      break;
    case 32:
      if ((err = launch_config(lfa_pool2_res_kernel<32, RES>, smem))) return err;
      lfa_pool2_res_kernel<32, RES><<<grid, LFA_THREADS, smem, s>>>(
          rpe2, g2, f_in, consts, out, rows, K, F);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rpe2 (rows, K, h), g2 (rows, K, h), f_in (rows, F), consts as laid out in
// pool2_consts; out (rows, 4h). h in {8, 32}.
extern "C" int r3d_lfa_pool2_res(const float* rpe2, const float* g2,
                                 const float* f_in, const float* consts,
                                 float* out, int rows, int K, int h, int F,
                                 void* stream) {
  return launch_pool2<true>(rpe2, g2, f_in, consts, out, rows, K, h, F, stream);
}

// rpe2 (rows, K, h), g2 (rows, K, h), consts as laid out in
// pool2_head_consts; out (rows, 2h). h in {8, 32}.
extern "C" int r3d_lfa_pool2(const float* rpe2, const float* g2,
                             const float* consts, float* out, int rows, int K,
                             int h, void* stream) {
  return launch_pool2<false>(rpe2, g2, nullptr, consts, out, rows, K, h, 0,
                             stream);
}
