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
// The TPU kernels flatten (K, 2h) into lanes and express each per-channel
// linear map as a block-diagonal (kron) matmul with lane rolls for the
// softmax: layout tricks for a 128-lane vector unit. Here the same maths
// runs per (k, channel) directly.
//
// Bound on this card. Per row the kernels read K*2h floats (plus K
// distances and h centre terms, or F input features) and write K*h + h
// (round 1) or 4h floats (pool 2), against about 2*K*(2h)^2 flops of
// scores. At h=32 (level 1) that is ~260 kflop per 8 kB row: bound by
// operations at the float32 rate. At h=8 (level 0) it is ~16 kflop per
// 2 kB row: bound by the bytes.
//
// Round 1 (lfa_round1_kernel): a block owns one row (point) at a time; the
// row's (K, 2h) tile, its scores and the small weight matrices sit in
// shared memory; blocks stride over rows. Most of its 256 threads idle in
// the softmax and the small products: its redesign is later work.
//
// Pool 2 (lfa_pool2_tile_kernel, with and without the residual). One row
// per block left most threads idle, paid 4-5 barriers a row, and read two
// shared-memory operands per FMA in the score product, which made it slower
// than its plain version at h=32. The design:
// - a persistent grid (as many blocks as fit on the SMs) walks tiles of
//   TR rows (4 at h=32, 16 at h=8); each block loads Ws, Wp and op into
//   shared memory once, and mlp2/shortcut weights are read through L1;
// - thread (row, channel j) keeps the row's K scores of channel j in
//   registers, so the score product reads one float4 of the row's tile (4
//   inner steps, a broadcast to the row's threads) per 4 FMAs, and the
//   softmax over K runs in registers: one expf a score, one division a
//   channel, online over chunks of 32 neighbours;
// - pool MLP, mlp2 and shortcut run over the tile's rows, 1 and 2 outputs
//   a thread, with 3 barriers a tile (2 without the residual);
// - the next tile's rpe2/g2 rows (16-byte cp.async) and f_in (4-byte)
//   load into the second of two buffers while the current tile computes.
// Plain float32 FFMA throughout (TF32 tensor cores would break the 1e-5
// contract against the plain version).

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

constexpr int POOL_THREADS = 256;
constexpr int POOL_TILE_BYTES = 72 * 1024;  // at most one row buffer
constexpr int POOL_ROW_PAD = 16;  // floats: rows of a tile on other banks

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Pool 2 over tiles of rows (see the design note at the top). Thread
// (r, j) of a tile owns channel j of row r; blockDim.x = TR * 2h. KC:
// neighbours per softmax chunk (K is a multiple of it). RES = false: pool 2
// alone (F = 0, f_in unused), out (rows, 2h). Dynamic shared memory: two
// row buffers of TR * (K*2h + pad) | Ws | Wp | op | agg (TR, 2h) | pooled
// (TR, 2h) | two f_in buffers of TR * F.
template <int H, int KC, bool RES>
__global__ void __launch_bounds__(POOL_THREADS)
lfa_pool2_tile_kernel(const float* __restrict__ rpe2, const float* __restrict__ g2,
                      const float* __restrict__ f_in, const float* __restrict__ consts,
                      float* __restrict__ out, int rows, int K, int F) {
  constexpr int C2 = 2 * H;
  constexpr int C4 = 4 * H;
  const int TR = blockDim.x / C2;
  const int RS = K * C2 + POOL_ROW_PAD;
  extern __shared__ __align__(16) float pool_sm[];
  float* tiles = pool_sm;
  float* ws = tiles + 2 * TR * RS;
  float* wp = ws + C2 * C2;
  float* op = wp + C2 * C2;
  float* agg = op + C2;
  float* pooled = agg + TR * C2;
  float* fin = pooled + TR * C2;
  // the residual's constants follow the head: Wm (2h x 4h) | Wsh (F x 4h) | off (4h)
  const float* wm = consts + pool2_head_consts(H);
  const float* wsh = wm + C2 * C4;
  const float* off = wsh + F * C4;

  for (int i = threadIdx.x; i < pool2_head_consts(H); i += blockDim.x) ws[i] = consts[i];

  const int KH = K * H;
  const int n_tiles = (rows + TR - 1) / TR;
  // rows [tile * TR, +TR) of rpe2 | g2 into cat (TR, K, 2h) of buffer buf
  auto load_tile = [&](int tile, int buf) {
    float* t = tiles + buf * TR * RS;
    const int row0 = tile * TR;
    const int nr = min(TR, rows - row0);
    const int chunks = KH / 4;
    for (int e = threadIdx.x; e < nr * chunks; e += blockDim.x) {
      const int rr = e / chunks, q = 4 * (e - rr * chunks);
      const int k = q / H, c = q - k * H;
      const size_t src = static_cast<size_t>(row0 + rr) * KH + q;
      float* dst = t + rr * RS + k * C2 + c;
      cp_async16(dst, rpe2 + src);
      cp_async16(dst + H, g2 + src);
    }
    if constexpr (RES) {
      for (int e = threadIdx.x; e < nr * F; e += blockDim.x) {
        cp_async4(fin + buf * TR * F + e, f_in + static_cast<size_t>(row0) * F + e);
      }
    }
    cp_async_commit();
  };

  const int r = threadIdx.x / C2, j = threadIdx.x - r * C2;
  int buf = 0;
  if (blockIdx.x < n_tiles) load_tile(blockIdx.x, 0);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile (and, first time, the constants) visible
    // every thread is past the previous tile: its buffer may be refilled
    if (tile + gridDim.x < n_tiles) load_tile(tile + gridDim.x, buf ^ 1);
    const int row = tile * TR + r;
    const float* cat = tiles + buf * TR * RS + r * RS;

    // scores[k] = cat[k, :] @ Ws[:, j], softmax over K online by chunks of
    // KC, a = sum_k e^(score - max) * cat[k, j], z = sum_k e^(score - max)
    float m = -CUDART_INF_F, z = 0.f, a = 0.f;
    for (int k0 = 0; k0 < K; k0 += KC) {
      float s[KC];
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) s[kk] = 0.f;
      const float* ck = cat + k0 * C2;
#pragma unroll 2
      for (int c = 0; c < C2; c += 4) {
        const float w0 = ws[c * C2 + j], w1 = ws[(c + 1) * C2 + j];
        const float w2 = ws[(c + 2) * C2 + j], w3 = ws[(c + 3) * C2 + j];
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
          const float4 x = *reinterpret_cast<const float4*>(ck + kk * C2 + c);
          s[kk] = fmaf(x.w, w3, fmaf(x.z, w2, fmaf(x.y, w1, fmaf(x.x, w0, s[kk]))));
        }
      }
      float mc = s[0];
#pragma unroll
      for (int kk = 1; kk < KC; ++kk) mc = fmaxf(mc, s[kk]);
      const float mn = fmaxf(m, mc);
      const float scale = expf(m - mn);  // 0 on the first chunk
      float zc = 0.f, ac = 0.f;
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const float e = expf(s[kk] - mn);
        zc += e;
        ac = fmaf(e, ck[kk * C2 + j], ac);
      }
      z = fmaf(z, scale, zc);
      a = fmaf(a, scale, ac);
      m = mn;
    }
    agg[r * C2 + j] = a / z;
    __syncthreads();

    // pool MLP + BN + relu: pooled (TR, 2h) = relu(agg @ Wp + op)
    float acc = 0.f;
#pragma unroll 8
    for (int i = 0; i < C2; ++i) acc = fmaf(agg[r * C2 + i], wp[i * C2 + j], acc);
    const float p = fmaxf(acc + op[j], 0.f);
    if constexpr (RES) {
      pooled[r * C2 + j] = p;
      __syncthreads();
      // mlp2 + shortcut + leaky relu: out (TR, 4h), channels j and j + 2h
      const float* fr = fin + buf * TR * F + r * F;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int o = j + t * C2;
        float pa = 0.f;
#pragma unroll 8
        for (int i = 0; i < C2; ++i) pa = fmaf(pooled[r * C2 + i], __ldg(wm + i * C4 + o), pa);
        float pb = 0.f;
        for (int f = 0; f < F; ++f) pb = fmaf(fr[f], __ldg(wsh + f * C4 + o), pb);
        const float res = (pa + pb) + __ldg(off + o);
        if (row < rows) {
          out[static_cast<size_t>(row) * C4 + o] = res > 0.f ? res : 0.01f * res;
        }
      }
    } else if (row < rows) {
      out[static_cast<size_t>(row) * C2 + j] = p;
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

// One launch of lfa_pool2_tile_kernel<H, KC, RES>: TR rows a tile, as many
// as fit POOL_THREADS threads and one POOL_TILE_BYTES buffer; a persistent
// grid of as many blocks as are resident on the card at once.
template <int H, int KC, bool RES>
int launch_pool2_tiles(const float* rpe2, const float* g2, const float* f_in,
                       const float* consts, float* out, int rows, int K, int F,
                       cudaStream_t stream) {
  const int rs = K * 2 * H + POOL_ROW_PAD;
  int tr = POOL_THREADS / (2 * H);
  while (tr > 1 && tr * rs * static_cast<int>(sizeof(float)) > POOL_TILE_BYTES) tr >>= 1;
  const int threads = tr * 2 * H;
  const size_t smem = (2 * static_cast<size_t>(tr) * rs + pool2_head_consts(H) +
                       4 * static_cast<size_t>(tr) * H +
                       (RES ? 2 * static_cast<size_t>(tr) * F : 0)) *
                      sizeof(float);
  const auto kernel = lfa_pool2_tile_kernel<H, KC, RES>;
  int err = launch_config(kernel, smem);
  if (err) return err;
  int per_sm = 0, device = 0, sms = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) ||
      (err = cudaGetDevice(&device)) ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device))) {
    return err;
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int n_tiles = (rows + tr - 1) / tr;
  const int grid = n_tiles < per_sm * sms ? n_tiles : per_sm * sms;
  kernel<<<grid, threads, smem, stream>>>(rpe2, g2, f_in, consts, out, rows, K, F);
  return 0;
}

// K in {8, 16} takes one chunk of K; larger powers of two chunks of 32.
template <int H, bool RES>
int launch_pool2_k(const float* rpe2, const float* g2, const float* f_in,
                   const float* consts, float* out, int rows, int K, int F,
                   cudaStream_t s) {
  switch (K) {
    case 8:
      return launch_pool2_tiles<H, 8, RES>(rpe2, g2, f_in, consts, out, rows, K, F, s);
    case 16:
      return launch_pool2_tiles<H, 16, RES>(rpe2, g2, f_in, consts, out, rows, K, F, s);
    default:
      if (K < 32 || K % 32) return static_cast<int>(cudaErrorInvalidValue);
      return launch_pool2_tiles<H, 32, RES>(rpe2, g2, f_in, consts, out, rows, K, F, s);
  }
}

template <bool RES>
int launch_pool2(const float* rpe2, const float* g2, const float* f_in,
                 const float* consts, float* out, int rows, int K, int h,
                 int F, void* stream) {
  if (rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (h) {
    case 8:
      err = launch_pool2_k<8, RES>(rpe2, g2, f_in, consts, out, rows, K, F, s);
      break;
    case 32:
      err = launch_pool2_k<32, RES>(rpe2, g2, f_in, consts, out, rows, K, F, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rpe2 (rows, K, h), g2 (rows, K, h), f_in (rows, F), consts = the head of
// pool2_head_consts | Wm (2h x 4h) | Wsh (F x 4h) | off (4h); out (rows, 4h).
// h in {8, 32}; K in {8, 16} or a multiple of 32.
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
