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
// Both kernels share one design (lfa_round1_tile_kernel and
// lfa_pool2_tile_kernel, with and without the residual). One row per block
// left most threads idle (round 1's softmax ran one thread a channel with
// three passes over K and two expf a score; its pool MLP kept h of 256
// threads busy), paid 4-5 barriers a row, and read two shared-memory
// operands per FMA in the score product. The design:
// - a persistent grid (as many blocks as fit on the SMs) walks tiles of
//   TR rows (4 at h=32; at h=8 16 for pool 2 and 8 for round 1; fewer
//   where K is large); each block loads the small constant matrices into
//   shared memory once (round 1 by cp.async with its first tile; pool 2's
//   mlp2/shortcut weights are read through L1);
// - thread (row, channel j < 2h) keeps the row's K scores of channel j in
//   registers, so the score product reads one float4 of the row's tile (4
//   inner steps, a broadcast to the row's threads) per 4 FMAs, and the
//   softmax over K runs in registers: one expf a score, one division a
//   channel, online over chunks of 32 neighbours (K = 8, 16: one chunk);
// - the next tile's rows (16-byte cp.async: the wrappers refuse gathered
//   rows that are not 16-byte aligned) and its small per-row inputs (d2
//   and centre term, or f_in) load into the second of two buffers while
//   the current tile computes;
// - round 1 applies the RPE transform in place to the tile's rpe lanes,
//   in the plain version's order of operations; its rpe2 product (K*h
//   outputs a row) is spread over the row's 2h threads, K/2 neighbours
//   each (channel j mod h, neighbour half j / h), so consecutive threads
//   store consecutive channels; pooled (h a row) takes the row's first h
//   threads. 3 barriers a tile;
// - pool 2's pool MLP, mlp2 and shortcut run over the tile's rows, 1 and 2
//   outputs a thread, with 3 barriers a tile (2 without the residual).
// Plain float32 FFMA throughout (TF32 tensor cores would break the 1e-5
// contract against the plain version).
//
// The bfloat16 forms (r3d_lfa_round1_bf16, r3d_lfa_pool2_res_bf16,
// r3d_lfa_pool2_bf16) replace the same three TPU kernels compiled with
// io = bfloat16 (lfa_pallas.py:322, :445, :509): the rows arrive and leave
// as bfloat16, and every dot reads bfloat16-rounded operands, summed in
// float32; the RPE, the BN affines and the softmax stay float32. They keep
// the float32 kernels' tile design and arithmetic on CUDA cores, fed by
// half the bytes (lfa_round1_bf16_tile_kernel, lfa_pool2_bf16_tile_kernel):
// - the next tile's bfloat16 rows are copied 16 bytes (8 values) at a time
//   by cp.async into a staging buffer of two, while the current tile
//   computes; each tile is then widened once into a float32 tile, so the
//   score product's inner loop is the float32 kernels' own;
// - the rounding points are the plain versions' (ops/lfa_kernels.py): the
//   RPE as (g + centre) + dist·w9 then one fused multiply-add for the BN
//   affine (which XLA makes of it too), kept unrounded for the weighted
//   sum and rounded to bfloat16 in the tile for the score and rpe2 dots;
//   the softmax normalised before each product w·x is rounded to bfloat16
//   (with several chunks of K, K > 32, each chunk's scores are computed
//   again against the final maximum); pool 2's pooled row rounded before
//   the mlp2 dot; every output rounded once (__float2bfloat16_rn);
// - the constants arrive float32, the matrices already rounded to
//   bfloat16 by the wrapper, so the products of the dots are exact.
// Bound: the bytes halve, so at h = 8 round 1 stays bound by them and pool
// 2 becomes bound by its operations, as both are at h = 32 (no tensor
// cores yet). Measured, they are slower than the float32 forms: the
// division, product and rounding per neighbour and channel and the
// widening pass cost more than the halved bytes save (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__host__ __device__ constexpr int round1_consts(int h) {
  // w9, s1, o1 (h each) | Ws (2h x 2h) | Wp (2h x h) | op (h) | W2 (h x h) | o2 (h)
  return 5 * h + 7 * h * h;
}

__host__ __device__ constexpr int pool2_head_consts(int h) {
  // Ws (2h x 2h) | Wp (2h x 2h) | op (2h): all that pool 2 alone reads
  return 8 * h * h + 2 * h;
}

constexpr int TILE_THREADS = 256;
constexpr int TILE_BUFFER_BYTES = 72 * 1024;  // at most one row buffer
constexpr int TILE_ROW_PAD = 16;  // floats: rows of a tile on other banks

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
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
__global__ void __launch_bounds__(TILE_THREADS)
lfa_pool2_tile_kernel(const float* __restrict__ rpe2, const float* __restrict__ g2,
                      const float* __restrict__ f_in, const float* __restrict__ consts,
                      float* __restrict__ out, int rows, int K, int F) {
  constexpr int C2 = 2 * H;
  constexpr int C4 = 4 * H;
  const int TR = blockDim.x / C2;
  const int RS = K * C2 + TILE_ROW_PAD;
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

// Round 1 over tiles of rows (see the design note at the top). Thread
// (r, j) of a tile owns channel j < 2h of row r; blockDim.x = TR * 2h. KC:
// neighbours per softmax chunk (K is a multiple of it); the rpe2 product
// runs in chunks of KC / 2 neighbours. Dynamic shared memory: two row buffers of TR * (K*2h + pad) |
// two d2 buffers of TR * K | two centre buffers of TR * h | the constants
// of round1_consts | agg (TR, 2h).
template <int H, int KC>
__global__ void __launch_bounds__(TILE_THREADS)
lfa_round1_tile_kernel(const float* __restrict__ g, const float* __restrict__ d2,
                       const float* __restrict__ center, const float* __restrict__ consts,
                       float* __restrict__ pooled_out, float* __restrict__ rpe2_out,
                       int rows, int K) {
  constexpr int C2 = 2 * H;
  constexpr int KR = KC / 2;
  const int TR = blockDim.x / C2;
  const int RS = K * C2 + TILE_ROW_PAD;
  extern __shared__ __align__(16) float r1_sm[];
  float* tiles = r1_sm;
  float* dbuf = tiles + 2 * TR * RS;
  float* cbuf = dbuf + 2 * TR * K;
  float* cst = cbuf + 2 * TR * H;
  float* agg = cst + round1_consts(H);
  const float* w9 = cst;
  const float* s1 = w9 + H;
  const float* o1 = s1 + H;
  const float* ws = o1 + H;
  const float* wp = ws + C2 * C2;
  const float* op = wp + C2 * H;
  const float* w2 = op + H;
  const float* o2 = w2 + H * H;

  // the constants arrive with the first tile (one cp.async group): a block
  // of one tile would otherwise wait for them load after load
  for (int i = threadIdx.x; i < round1_consts(H); i += blockDim.x) cp_async4(cst + i, consts + i);

  const int L = K * C2;
  const int n_tiles = (rows + TR - 1) / TR;
  // rows [tile * TR, +TR) of g, d2 and center into buffer buf
  auto load_tile = [&](int tile, int buf) {
    float* t = tiles + buf * TR * RS;
    const int row0 = tile * TR;
    const int nr = min(TR, rows - row0);
    const float* src = g + static_cast<size_t>(row0) * L;
    const int chunks = L / 4;
    for (int e = threadIdx.x; e < nr * chunks; e += blockDim.x) {
      const int rr = e / chunks, q = 4 * (e - rr * chunks);
      cp_async16(t + rr * RS + q, src + rr * L + q);
    }
    for (int e = threadIdx.x; e < nr * K; e += blockDim.x) {
      cp_async4(dbuf + buf * TR * K + e, d2 + static_cast<size_t>(row0) * K + e);
    }
    for (int e = threadIdx.x; e < nr * H; e += blockDim.x) {
      cp_async4(cbuf + buf * TR * H + e, center + static_cast<size_t>(row0) * H + e);
    }
    cp_async_commit();
  };

  const int r = threadIdx.x / C2, j = threadIdx.x - r * C2;
  const int ch = j % H, half = j / H;  // the rpe2 channel and neighbour half
  int buf = 0;
  if (blockIdx.x < n_tiles) load_tile(blockIdx.x, 0);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile (and, first time, the constants) visible
    // every thread is past the previous tile: its buffers may be refilled
    if (tile + gridDim.x < n_tiles) load_tile(tile + gridDim.x, buf ^ 1);
    float* tb = tiles + buf * TR * RS;
    const float* db = dbuf + buf * TR * K;
    const float* cb = cbuf + buf * TR * H;

    // rpe = relu(((g_rpe + center) + dist * w9) * s1 + o1), in place
    for (int e = threadIdx.x; e < TR * K * H; e += blockDim.x) {
      const int rk = e / H, c = e - rk * H;  // rk = rr * K + k
      const int rr = rk / K;
      float* v = tb + rr * RS + (rk - rr * K) * C2 + c;
      const float dist = sqrtf(fmaxf(db[rk], 0.f));
      const float pre = (*v + cb[rr * H + c]) + dist * w9[c];
      *v = fmaxf(pre * s1[c] + o1[c], 0.f);
    }
    __syncthreads();  // the rpe lanes of the tile transformed

    const int row = tile * TR + r;
    const float* cat = tb + r * RS;
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
        const float w2c = ws[(c + 2) * C2 + j], w3 = ws[(c + 3) * C2 + j];
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
          const float4 x = *reinterpret_cast<const float4*>(ck + kk * C2 + c);
          s[kk] = fmaf(x.w, w3, fmaf(x.z, w2c, fmaf(x.y, w1, fmaf(x.x, w0, s[kk]))));
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

    // rpe2[k, ch] = relu(rpe[k, :] @ W2[:, ch] + o2[ch]) for the K/2
    // neighbours of this thread's half, KR at a time
    for (int k0 = half * (K / 2); k0 < (half + 1) * (K / 2); k0 += KR) {
      float acc[KR];
#pragma unroll
      for (int kk = 0; kk < KR; ++kk) acc[kk] = 0.f;
      const float* ck = cat + k0 * C2;
#pragma unroll
      for (int c = 0; c < H; c += 4) {
        const float w0 = w2[c * H + ch], w1 = w2[(c + 1) * H + ch];
        const float w2c = w2[(c + 2) * H + ch], w3 = w2[(c + 3) * H + ch];
#pragma unroll
        for (int kk = 0; kk < KR; ++kk) {
          const float4 x = *reinterpret_cast<const float4*>(ck + kk * C2 + c);
          acc[kk] = fmaf(x.w, w3, fmaf(x.z, w2c, fmaf(x.y, w1, fmaf(x.x, w0, acc[kk]))));
        }
      }
      if (row < rows) {
        float* o = rpe2_out + static_cast<size_t>(row) * K * H + k0 * H + ch;
#pragma unroll
        for (int kk = 0; kk < KR; ++kk) o[kk * H] = fmaxf(acc[kk] + o2[ch], 0.f);
      }
    }
    __syncthreads();  // agg of the tile visible

    // pool MLP + BN + relu: pooled (TR, h) = relu(agg @ Wp + op)
    if (j < H) {
      float acc = 0.f;
#pragma unroll 8
      for (int i = 0; i < C2; ++i) acc = fmaf(agg[r * C2 + i], wp[i * H + j], acc);
      if (row < rows) pooled_out[static_cast<size_t>(row) * H + j] = fmaxf(acc + op[j], 0.f);
    }
  }
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// s[kk] = cat[kk, :] @ Ws[:, j] for the KC neighbours of one chunk (cat
// rows of C2 floats in shared memory, Ws (C2 x C2) in shared memory).
template <int KC, int C2>
__device__ __forceinline__ void score_chunk(const float* ws, const float* cat, int j,
                                            float (&s)[KC]) {
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) s[kk] = 0.f;
#pragma unroll 2
  for (int c = 0; c < C2; c += 4) {
    const float w0 = ws[c * C2 + j], w1 = ws[(c + 1) * C2 + j];
    const float w2 = ws[(c + 2) * C2 + j], w3 = ws[(c + 3) * C2 + j];
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const float4 x = *reinterpret_cast<const float4*>(cat + kk * C2 + c);
      s[kk] = fmaf(x.w, w3, fmaf(x.z, w2, fmaf(x.y, w1, fmaf(x.x, w0, s[kk]))));
    }
  }
}

// The bfloat16 forms' attentive pooling of channel j over K neighbours:
// sum_k bf16(w[k] * x[k]) with w = softmax_K(cat @ Ws[:, j]) normalised
// first (w = e / z), x[k] = xf[k * xs] the unrounded lane. The first pass
// takes the maximum and z online by chunks of KC; with one chunk (K = KC)
// its exponentials stay in registers, with several (MULTI) each chunk's
// scores are computed again against the final maximum.
template <int KC, int C2, bool MULTI>
__device__ __forceinline__ float pool_bf16(const float* ws, const float* cat, const float* xf,
                                           int xs, int j, int K) {
  float s[KC];
  float m = -CUDART_INF_F, z = 0.f;
  for (int k0 = 0; k0 < K; k0 += KC) {
    score_chunk<KC, C2>(ws, cat + k0 * C2, j, s);
    float mc = s[0];
#pragma unroll
    for (int kk = 1; kk < KC; ++kk) mc = fmaxf(mc, s[kk]);
    const float mn = fmaxf(m, mc);
    const float scale = expf(m - mn);  // 0 on the first chunk
    float zc = 0.f;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      s[kk] = expf(s[kk] - mn);
      zc += s[kk];
    }
    z = fmaf(z, scale, zc);
    m = mn;
  }
  float a = 0.f;
  for (int k0 = 0; k0 < K; k0 += KC) {
    if (MULTI) {
      score_chunk<KC, C2>(ws, cat + k0 * C2, j, s);
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) s[kk] = expf(s[kk] - m);
    }
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      a += bf16_round(__fmul_rn(__fdiv_rn(s[kk], z), xf[(k0 + kk) * xs]));
    }
  }
  return a;
}

// Round 1, bfloat16 form (see the note at the top). Thread (r, j) of a
// tile owns channel j < 2h of row r; blockDim.x = TR * 2h. Dynamic shared
// memory: two bfloat16 staging buffers of TR * K*2h | the float32 tile
// (TR, K*2h + pad): the concatenation rounded to bfloat16 | the unrounded
// rpe (TR, K, h) | two d2 buffers of TR * K | two centre buffers of TR * h
// | the constants of round1_consts | agg (TR, 2h).
template <int H, int KC, bool MULTI>
__global__ void __launch_bounds__(TILE_THREADS)
lfa_round1_bf16_tile_kernel(const __nv_bfloat16* __restrict__ g, const float* __restrict__ d2,
                            const float* __restrict__ center, const float* __restrict__ consts,
                            __nv_bfloat16* __restrict__ pooled_out,
                            __nv_bfloat16* __restrict__ rpe2_out, int rows, int K) {
  constexpr int C2 = 2 * H;
  constexpr int KR = KC / 2;
  const int TR = blockDim.x / C2;
  const int L = K * C2;
  const int RS = L + TILE_ROW_PAD;
  extern __shared__ __align__(16) float r1b_sm[];
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(r1b_sm);
  float* tile = r1b_sm + TR * L;  // after 2 * TR * L bfloat16
  float* rpef = tile + TR * RS;
  float* dbuf = rpef + TR * K * H;
  float* cbuf = dbuf + 2 * TR * K;
  float* cst = cbuf + 2 * TR * H;
  float* agg = cst + round1_consts(H);
  const float* w9 = cst;
  const float* s1 = w9 + H;
  const float* o1 = s1 + H;
  const float* ws = o1 + H;
  const float* wp = ws + C2 * C2;
  const float* op = wp + C2 * H;
  const float* w2 = op + H;
  const float* o2 = w2 + H * H;

  for (int i = threadIdx.x; i < round1_consts(H); i += blockDim.x) cp_async4(cst + i, consts + i);

  const int n_tiles = (rows + TR - 1) / TR;
  // rows [tile * TR, +TR) of g (contiguous), d2 and center into buffer buf
  auto load_tile = [&](int tile_i, int buf) {
    const int row0 = tile_i * TR;
    const int nr = min(TR, rows - row0);
    const __nv_bfloat16* src = g + static_cast<size_t>(row0) * L;
    __nv_bfloat16* dst = stage + buf * TR * L;
    for (int e = 8 * threadIdx.x; e < nr * L; e += 8 * blockDim.x) cp_async16(dst + e, src + e);
    for (int e = threadIdx.x; e < nr * K; e += blockDim.x) {
      cp_async4(dbuf + buf * TR * K + e, d2 + static_cast<size_t>(row0) * K + e);
    }
    for (int e = threadIdx.x; e < nr * H; e += blockDim.x) {
      cp_async4(cbuf + buf * TR * H + e, center + static_cast<size_t>(row0) * H + e);
    }
    cp_async_commit();
  };

  const int r = threadIdx.x / C2, j = threadIdx.x - r * C2;
  const int ch = j % H, half = j / H;  // the rpe2 channel and neighbour half
  int buf = 0;
  if (blockIdx.x < n_tiles) load_tile(blockIdx.x, 0);
  for (int tile_i = blockIdx.x; tile_i < n_tiles; tile_i += gridDim.x, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile (and, first time, the constants) visible;
    // every thread is past the previous tile
    if (tile_i + gridDim.x < n_tiles) load_tile(tile_i + gridDim.x, buf ^ 1);
    const __nv_bfloat16* sr = stage + buf * TR * L + r * L + j;
    float* cat_w = tile + r * RS + j;
    float* rp = rpef + r * K * H + j;
    if (j < H) {
      // rpe = relu(fma((g_rpe + center) + dist * w9, s1, o1))
      const float* db = dbuf + buf * TR * K + r * K;
      const float cj = cbuf[buf * TR * H + r * H + j];
      const float w9j = w9[j], s1j = s1[j], o1j = o1[j];
      for (int k = 0; k < K; ++k) {
        const float dist = sqrtf(fmaxf(db[k], 0.f));
        const float pre = __fadd_rn(__fadd_rn(__bfloat162float(sr[k * C2]), cj),
                                    __fmul_rn(dist, w9j));
        const float rpe = fmaxf(__fmaf_rn(pre, s1j, o1j), 0.f);
        rp[k * H] = rpe;
        cat_w[k * C2] = bf16_round(rpe);
      }
    } else {
      for (int k = 0; k < K; ++k) cat_w[k * C2] = __bfloat162float(sr[k * C2]);
    }
    __syncthreads();  // the tile widened, its rpe lanes transformed

    const int row = tile_i * TR + r;
    const float* cat = tile + r * RS;
    // the weighted sum reads lane j unrounded: the rpe lanes from rpef
    agg[r * C2 + j] =
        pool_bf16<KC, C2, MULTI>(ws, cat, j < H ? rp : cat + j, j < H ? H : C2, j, K);

    // rpe2[k, ch] = relu(bf16(rpe)[k, :] @ W2[:, ch] + o2[ch]) for the K/2
    // neighbours of this thread's half, KR at a time
    for (int k0 = half * (K / 2); k0 < (half + 1) * (K / 2); k0 += KR) {
      float acc[KR];
#pragma unroll
      for (int kk = 0; kk < KR; ++kk) acc[kk] = 0.f;
      const float* ck = cat + k0 * C2;
#pragma unroll
      for (int c = 0; c < H; c += 4) {
        const float w0 = w2[c * H + ch], w1 = w2[(c + 1) * H + ch];
        const float w2c = w2[(c + 2) * H + ch], w3 = w2[(c + 3) * H + ch];
#pragma unroll
        for (int kk = 0; kk < KR; ++kk) {
          const float4 x = *reinterpret_cast<const float4*>(ck + kk * C2 + c);
          acc[kk] = fmaf(x.w, w3, fmaf(x.z, w2c, fmaf(x.y, w1, fmaf(x.x, w0, acc[kk]))));
        }
      }
      if (row < rows) {
        __nv_bfloat16* o = rpe2_out + static_cast<size_t>(row) * K * H + k0 * H + ch;
#pragma unroll
        for (int kk = 0; kk < KR; ++kk) {
          o[kk * H] = __float2bfloat16_rn(fmaxf(acc[kk] + o2[ch], 0.f));
        }
      }
    }
    __syncthreads();  // agg of the tile visible

    // pool MLP + BN + relu: pooled (TR, h) = relu(agg @ Wp + op)
    if (j < H) {
      float acc = 0.f;
#pragma unroll 8
      for (int i = 0; i < C2; ++i) acc = fmaf(agg[r * C2 + i], wp[i * H + j], acc);
      if (row < rows) {
        pooled_out[static_cast<size_t>(row) * H + j] = __float2bfloat16_rn(fmaxf(acc + op[j], 0.f));
      }
    }
  }
}

// Pool 2 (RES: + the residual), bfloat16 form. Thread (r, j) owns channel
// j of row r; blockDim.x = TR * 2h. Dynamic shared memory: two bfloat16
// staging buffers of TR * K*h rows of rpe2, two of g2 | the float32 tile
// (TR, K*2h + pad) | Ws | Wp | op | agg (TR, 2h) | pooled (TR, 2h) | two
// bfloat16 f_in buffers of TR * F.
template <int H, int KC, bool RES, bool MULTI>
__global__ void __launch_bounds__(TILE_THREADS)
lfa_pool2_bf16_tile_kernel(const __nv_bfloat16* __restrict__ rpe2,
                           const __nv_bfloat16* __restrict__ g2,
                           const __nv_bfloat16* __restrict__ f_in,
                           const float* __restrict__ consts, __nv_bfloat16* __restrict__ out,
                           int rows, int K, int F) {
  constexpr int C2 = 2 * H;
  constexpr int C4 = 4 * H;
  const int TR = blockDim.x / C2;
  const int KH = K * H;
  const int RS = K * C2 + TILE_ROW_PAD;
  extern __shared__ __align__(16) float p2b_sm[];
  __nv_bfloat16* stage_r = reinterpret_cast<__nv_bfloat16*>(p2b_sm);
  __nv_bfloat16* stage_g = stage_r + 2 * TR * KH;
  float* tile = p2b_sm + 2 * TR * KH;  // after 4 * TR * KH bfloat16
  float* ws = tile + TR * RS;
  float* wp = ws + C2 * C2;
  float* op = wp + C2 * C2;
  float* agg = op + C2;
  float* pooled = agg + TR * C2;
  __nv_bfloat16* fin = reinterpret_cast<__nv_bfloat16*>(pooled + TR * C2);
  const float* wm = consts + pool2_head_consts(H);
  const float* wsh = wm + C2 * C4;
  const float* off = wsh + F * C4;

  for (int i = threadIdx.x; i < pool2_head_consts(H); i += blockDim.x) ws[i] = consts[i];

  const int n_tiles = (rows + TR - 1) / TR;
  auto load_tile = [&](int tile_i, int buf) {
    const int row0 = tile_i * TR;
    const int nr = min(TR, rows - row0);
    const size_t src = static_cast<size_t>(row0) * KH;
    for (int e = 8 * threadIdx.x; e < nr * KH; e += 8 * blockDim.x) {
      cp_async16(stage_r + buf * TR * KH + e, rpe2 + src + e);
      cp_async16(stage_g + buf * TR * KH + e, g2 + src + e);
    }
    if constexpr (RES) {  // F even: pairs of values, 4 bytes at a time
      for (int e = 2 * threadIdx.x; e < nr * F; e += 2 * blockDim.x) {
        cp_async4(fin + buf * TR * F + e, f_in + static_cast<size_t>(row0) * F + e);
      }
    }
    cp_async_commit();
  };

  const int r = threadIdx.x / C2, j = threadIdx.x - r * C2;
  int buf = 0;
  if (blockIdx.x < n_tiles) load_tile(blockIdx.x, 0);
  for (int tile_i = blockIdx.x; tile_i < n_tiles; tile_i += gridDim.x, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();
    if (tile_i + gridDim.x < n_tiles) load_tile(tile_i + gridDim.x, buf ^ 1);
    // cat = [rpe2 | g2] widened: channel j of each neighbour
    const __nv_bfloat16* sr = (j < H ? stage_r + j : stage_g + (j - H)) + buf * TR * KH + r * KH;
    float* cat_w = tile + r * RS + j;
    for (int k = 0; k < K; ++k) cat_w[k * C2] = __bfloat162float(sr[k * H]);
    __syncthreads();

    const int row = tile_i * TR + r;
    const float* cat = tile + r * RS;
    agg[r * C2 + j] = pool_bf16<KC, C2, MULTI>(ws, cat, cat + j, C2, j, K);
    __syncthreads();

    // pool MLP + BN + relu: relu(agg @ Wp + op)
    float acc = 0.f;
#pragma unroll 8
    for (int i = 0; i < C2; ++i) acc = fmaf(agg[r * C2 + i], wp[i * C2 + j], acc);
    const float p = fmaxf(acc + op[j], 0.f);
    if constexpr (RES) {
      pooled[r * C2 + j] = bf16_round(p);
      __syncthreads();
      // mlp2 + shortcut + leaky relu: out (TR, 4h), channels j and j + 2h
      const __nv_bfloat16* fr = fin + buf * TR * F + r * F;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int o = j + t * C2;
        float pa = 0.f;
#pragma unroll 8
        for (int i = 0; i < C2; ++i) pa = fmaf(pooled[r * C2 + i], __ldg(wm + i * C4 + o), pa);
        float pb = 0.f;
        for (int f = 0; f < F; ++f) pb = fmaf(__bfloat162float(fr[f]), __ldg(wsh + f * C4 + o), pb);
        const float res = (pa + pb) + __ldg(off + o);
        if (row < rows) {
          out[static_cast<size_t>(row) * C4 + o] =
              __float2bfloat16_rn(res > 0.f ? res : 0.01f * res);
        }
      }
    } else if (row < rows) {
      out[static_cast<size_t>(row) * C2 + j] = __float2bfloat16_rn(p);
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

// Rows a tile for half width h: as many as fit TILE_THREADS threads and one
// TILE_BUFFER_BYTES buffer of (K*2h + pad)-float rows.
int tile_rows(int K, int h) {
  const int rs = K * 2 * h + TILE_ROW_PAD;
  int tr = TILE_THREADS / (2 * h);
  while (tr > 1 && tr * rs * static_cast<int>(sizeof(float)) > TILE_BUFFER_BYTES) tr >>= 1;
  return tr;
}

// A persistent grid: as many blocks of the kernel as are resident on the
// card at once, at most one a tile.
template <typename Kernel>
int persistent_grid(Kernel kernel, int threads, size_t smem, int n_tiles, int* grid) {
  int err = launch_config(kernel, smem);
  if (err) return err;
  int per_sm = 0, device = 0, sms = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) ||
      (err = cudaGetDevice(&device)) ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device))) {
    return err;
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *grid = n_tiles < per_sm * sms ? n_tiles : per_sm * sms;
  return 0;
}

// One launch of lfa_round1_tile_kernel<H, KC> (BF16: of
// lfa_round1_bf16_tile_kernel<H, KC, MULTI>, MULTI = K > KC, the same rows
// a tile).
template <int H, int KC, bool BF16, bool MULTI>
int launch_round1_tiles(const void* g, const float* d2, const float* center,
                        const float* consts, void* pooled, void* rpe2, int rows,
                        int K, cudaStream_t stream) {
  // at h = 8, half the rows of pool 2's tile: 128-thread blocks, more of
  // them an SM (benchmarks/launch_ab.py times pool 2's tile as
  // r1_full_tile; on an H100 80GB HBM3 at 700 W: 0.0119 against 0.0099 ms
  // at 2,500 rows, 0.168 against 0.153 ms at 65,536)
  const int tr = H == 8 ? tile_rows(K, H) / 2 : tile_rows(K, H);
  const int threads = tr * 2 * H;
  const size_t L = static_cast<size_t>(K) * 2 * H;
  const size_t tile_floats = BF16 ? tr * L + tr * (L + TILE_ROW_PAD) + tr * L / 2
                                  : 2 * tr * (L + TILE_ROW_PAD);
  const size_t smem = (tile_floats + 2 * static_cast<size_t>(tr) * (K + H) + round1_consts(H) +
                       static_cast<size_t>(tr) * 2 * H) *
                      sizeof(float);
  int grid = 0;
  const int n_tiles = (rows + tr - 1) / tr;
  if constexpr (BF16) {
    const auto kernel = lfa_round1_bf16_tile_kernel<H, KC, MULTI>;
    const int err = persistent_grid(kernel, threads, smem, n_tiles, &grid);
    if (err) return err;
    kernel<<<grid, threads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(g), d2, center, consts,
        static_cast<__nv_bfloat16*>(pooled), static_cast<__nv_bfloat16*>(rpe2), rows, K);
  } else {
    const auto kernel = lfa_round1_tile_kernel<H, KC>;
    const int err = persistent_grid(kernel, threads, smem, n_tiles, &grid);
    if (err) return err;
    kernel<<<grid, threads, smem, stream>>>(
        static_cast<const float*>(g), d2, center, consts, static_cast<float*>(pooled),
        static_cast<float*>(rpe2), rows, K);
  }
  return 0;
}

// K in {8, 16, 32} takes one chunk of K; larger multiples of 32 chunks of 32.
template <int H, bool BF16>
int launch_round1_k(const void* g, const float* d2, const float* center,
                    const float* consts, void* pooled, void* rpe2, int rows, int K,
                    cudaStream_t s) {
  switch (K) {
    case 8:
      return launch_round1_tiles<H, 8, BF16, false>(g, d2, center, consts, pooled, rpe2, rows,
                                                    K, s);
    case 16:
      return launch_round1_tiles<H, 16, BF16, false>(g, d2, center, consts, pooled, rpe2, rows,
                                                     K, s);
    case 32:
      return launch_round1_tiles<H, 32, BF16, false>(g, d2, center, consts, pooled, rpe2, rows,
                                                     K, s);
    default:
      if (K < 32 || K % 32) return static_cast<int>(cudaErrorInvalidValue);
      return launch_round1_tiles<H, 32, BF16, true>(g, d2, center, consts, pooled, rpe2, rows,
                                                    K, s);
  }
}

template <bool BF16>
int launch_round1(const void* g, const float* d2, const float* center, const float* consts,
                  void* pooled, void* rpe2, int rows, int K, int h, void* stream) {
  if (rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (h) {
    case 8:
      err = launch_round1_k<8, BF16>(g, d2, center, consts, pooled, rpe2, rows, K, s);
      break;
    case 32:
      err = launch_round1_k<32, BF16>(g, d2, center, consts, pooled, rpe2, rows, K, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// One launch of lfa_pool2_tile_kernel<H, KC, RES> (BF16: of
// lfa_pool2_bf16_tile_kernel<H, KC, RES, MULTI>, MULTI = K > KC, the same
// rows a tile).
template <int H, int KC, bool RES, bool BF16, bool MULTI>
int launch_pool2_tiles(const void* rpe2, const void* g2, const void* f_in,
                       const float* consts, void* out, int rows, int K, int F,
                       cudaStream_t stream) {
  const int tr = tile_rows(K, H);
  const int threads = tr * 2 * H;
  const size_t L = static_cast<size_t>(K) * 2 * H;
  // BF16: the bfloat16 staging of rpe2 and g2 (2 buffers each) and f_in
  // (2 buffers) beside one float32 tile
  const size_t tile_floats = BF16 ? tr * L + tr * (L + TILE_ROW_PAD) : 2 * tr * (L + TILE_ROW_PAD);
  const size_t fin_floats = RES ? (BF16 ? static_cast<size_t>(tr) * F : 2 * static_cast<size_t>(tr) * F) : 0;
  const size_t smem = (tile_floats + pool2_head_consts(H) + 4 * static_cast<size_t>(tr) * H +
                       fin_floats) *
                      sizeof(float);
  int grid = 0;
  const int n_tiles = (rows + tr - 1) / tr;
  if constexpr (BF16) {
    const auto kernel = lfa_pool2_bf16_tile_kernel<H, KC, RES, MULTI>;
    const int err = persistent_grid(kernel, threads, smem, n_tiles, &grid);
    if (err) return err;
    kernel<<<grid, threads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(rpe2), static_cast<const __nv_bfloat16*>(g2),
        static_cast<const __nv_bfloat16*>(f_in), consts, static_cast<__nv_bfloat16*>(out),
        rows, K, F);
  } else {
    const auto kernel = lfa_pool2_tile_kernel<H, KC, RES>;
    const int err = persistent_grid(kernel, threads, smem, n_tiles, &grid);
    if (err) return err;
    kernel<<<grid, threads, smem, stream>>>(
        static_cast<const float*>(rpe2), static_cast<const float*>(g2),
        static_cast<const float*>(f_in), consts, static_cast<float*>(out), rows, K, F);
  }
  return 0;
}

// K in {8, 16, 32} takes one chunk of K; larger powers of two chunks of 32.
template <int H, bool RES, bool BF16>
int launch_pool2_k(const void* rpe2, const void* g2, const void* f_in,
                   const float* consts, void* out, int rows, int K, int F,
                   cudaStream_t s) {
  switch (K) {
    case 8:
      return launch_pool2_tiles<H, 8, RES, BF16, false>(rpe2, g2, f_in, consts, out, rows, K,
                                                        F, s);
    case 16:
      return launch_pool2_tiles<H, 16, RES, BF16, false>(rpe2, g2, f_in, consts, out, rows, K,
                                                         F, s);
    case 32:
      return launch_pool2_tiles<H, 32, RES, BF16, false>(rpe2, g2, f_in, consts, out, rows, K,
                                                         F, s);
    default:
      if (K < 32 || K % 32) return static_cast<int>(cudaErrorInvalidValue);
      return launch_pool2_tiles<H, 32, RES, BF16, true>(rpe2, g2, f_in, consts, out, rows, K,
                                                        F, s);
  }
}

template <bool RES, bool BF16>
int launch_pool2(const void* rpe2, const void* g2, const void* f_in,
                 const float* consts, void* out, int rows, int K, int h,
                 int F, void* stream) {
  if (rows == 0) return 0;
  if (BF16 && F % 2) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (h) {
    case 8:
      err = launch_pool2_k<8, RES, BF16>(rpe2, g2, f_in, consts, out, rows, K, F, s);
      break;
    case 32:
      err = launch_pool2_k<32, RES, BF16>(rpe2, g2, f_in, consts, out, rows, K, F, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// gathered (rows, K, 2h), d2 (rows, K), center (rows, h), consts as laid out
// in round1_consts; pooled (rows, h) and rpe2 (rows, K, h) out. h in {8, 32};
// K in {8, 16} or a multiple of 32.
extern "C" int r3d_lfa_round1(const float* g, const float* d2,
                              const float* center, const float* consts,
                              float* pooled, float* rpe2, int rows, int K,
                              int h, void* stream) {
  return launch_round1<false>(g, d2, center, consts, pooled, rpe2, rows, K, h, stream);
}

// The bfloat16 form: gathered, pooled and rpe2 bfloat16; d2, center and
// consts (its matrices rounded to bfloat16) float32.
extern "C" int r3d_lfa_round1_bf16(const __nv_bfloat16* g, const float* d2,
                                   const float* center, const float* consts,
                                   __nv_bfloat16* pooled, __nv_bfloat16* rpe2, int rows,
                                   int K, int h, void* stream) {
  return launch_round1<true>(g, d2, center, consts, pooled, rpe2, rows, K, h, stream);
}

// rpe2 (rows, K, h), g2 (rows, K, h), f_in (rows, F), consts = the head of
// pool2_head_consts | Wm (2h x 4h) | Wsh (F x 4h) | off (4h); out (rows, 4h).
// h in {8, 32}; K in {8, 16} or a multiple of 32.
extern "C" int r3d_lfa_pool2_res(const float* rpe2, const float* g2,
                                 const float* f_in, const float* consts,
                                 float* out, int rows, int K, int h, int F,
                                 void* stream) {
  return launch_pool2<true, false>(rpe2, g2, f_in, consts, out, rows, K, h, F, stream);
}

// The bfloat16 form: rpe2, g2, f_in (F even) and out bfloat16; consts
// float32, its matrices rounded to bfloat16.
extern "C" int r3d_lfa_pool2_res_bf16(const __nv_bfloat16* rpe2, const __nv_bfloat16* g2,
                                      const __nv_bfloat16* f_in, const float* consts,
                                      __nv_bfloat16* out, int rows, int K, int h, int F,
                                      void* stream) {
  return launch_pool2<true, true>(rpe2, g2, f_in, consts, out, rows, K, h, F, stream);
}

// rpe2 (rows, K, h), g2 (rows, K, h), consts as laid out in
// pool2_head_consts; out (rows, 2h). h in {8, 32}.
extern "C" int r3d_lfa_pool2(const float* rpe2, const float* g2,
                             const float* consts, float* out, int rows, int K,
                             int h, void* stream) {
  return launch_pool2<false, false>(rpe2, g2, nullptr, consts, out, rows, K, h, 0, stream);
}

// The bfloat16 form of r3d_lfa_pool2.
extern "C" int r3d_lfa_pool2_bf16(const __nv_bfloat16* rpe2, const __nv_bfloat16* g2,
                                  const float* consts, __nv_bfloat16* out, int rows, int K,
                                  int h, void* stream) {
  return launch_pool2<false, true>(rpe2, g2, nullptr, consts, out, rows, K, h, 0, stream);
}
