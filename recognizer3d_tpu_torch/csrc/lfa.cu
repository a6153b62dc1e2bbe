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
// The TPU kernels take the neighbour rows gathered, (rows, K, 2h) and
// (rows, K, h). Here every kernel reads them by index: round 1 from the
// level's table [support projection | mlp1 features] (B·N, 2h), pool 2 from
// round 1's pooled rows (B·N, h), each at the KNN's int32 indices into the
// row's own cloud (the kernel adds the cloud's first table row). The
// gathered tensors (a level's K rows a point, written and read back once)
// are never made; Morton-sorted neighbouring points share most of their
// neighbours, so a table row is read by the few blocks near it.
//
// The TPU kernels flatten (K, 2h) into lanes and express each per-channel
// linear map as a block-diagonal (kron) matmul with lane rolls for the
// softmax: layout tricks for a 128-lane vector unit. Here the same maths
// runs per (k, channel) directly.
//
// Bound on this card. Per row the kernels stage K*2h floats, read by index
// from a table of 2h (round 1) or h (pool 2) floats a point, plus K
// indices and K distances and h centre terms (or K*h rpe2 floats and F
// input features), and write K*h + h (round 1) or 4h floats (pool 2),
// against about 2*K*(2h)^2 flops of scores. At h=32 (level 1) that is
// ~260 kflop a row: bound by operations at the float32 rate. At h=8
// (level 0) it is ~16 kflop against ~1.4 kB of round 1's inputs and
// outputs a row: bound by the bytes, most of them rpe2's.
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
// - the next tile's neighbour rows (16-byte cp.async from the table at its
//   rows' indices: the wrappers refuse tables that are not 16-byte
//   aligned) and its small per-row inputs (d2 and centre term, or f_in)
//   load into the second of two buffers while the current tile computes;
//   the tile after it's indices load with them, so that no row copy waits
//   on a dependent load of its index;
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
// as bfloat16, every dot reads bfloat16-rounded operands and sums in
// float32 (the TPU kernel's MXU dots, lfa_pallas.py:181-190), and the RPE,
// the BN affines and the softmax stay float32. Bound: their bytes (1.7 kB a
// row at h = 8, 4 to 6 kB at h = 32): at the tensor cores' bfloat16 rate
// the dots take a few percent of the byte time, the softmax and the
// weighted sum over K about as much again on the CUDA cores. The design
// (lfa_round1_mma_kernel, lfa_pool2_mma_kernel) keeps the per-(neighbour,
// channel) work to the softmax and w·x:
// - a persistent grid of blocks of 4 (h = 8) or 8 (h = 32) warps; each
//   block transposes the constant matrices into bfloat16 in shared memory
//   once, then each warp walks its own rows, one at a time, staging the
//   next row by 16-byte cp.async (its neighbours' rows at indices staged
//   with the row before) into the second of two buffers while it
//   computes: no block barrier after the constants (but in pool 2 with
//   the residual, below);
// - the rows stay bfloat16 in shared memory (no widening), each padded by
//   16 bytes so that the eight rows an ldmatrix reads fall on distinct
//   banks;
// - the scores run transposed on the tensor cores, Sᵀ = Wsᵀ·bf16(cat)ᵀ
//   (mma.sync m16n8k16, f32 sums): each channel is an mma row and each
//   neighbour a column, so a lane holds two channels of 2 neighbours of
//   every 8, and the softmax over K and the weighted sum over K run in the
//   lane and its quad (two shuffles), as FlashAttention's row softmax.
//   The staged row-major [neighbour][channel] tile is the B operand in
//   column-major form (ldmatrix without .trans); Wsᵀ's fragments come by
//   ldmatrix from the block's copy;
// - round 1 computes bf16(rpe) in the B fragments' own layout from the
//   staged g, d2 and centre term (no rpe tile), and the unrounded rpe
//   again in the accumulators' layout for the weighted sum; its rpe2 dot
//   (neighbours as rows: m16n8k8 at h = 8, m16n8k16 at h = 32) takes its A
//   fragments from those same registers;
// - pool 2's mlp2 and shortcut dots run over the tile's 8 rows, transposed
//   (outᵀ = Wmᵀ·bf16(pooled)ᵀ + Wshᵀ·f_inᵀ, F padded to 16 with zeros),
//   the outputs staged in shared memory and stored 16 bytes at a time;
// - off the tensor cores: the pool MLP agg @ Wp (agg is a float32 sum with
//   no rounding point before the dot, as in the TPU kernel), the RPE, the
//   BN affines, the softmax and the division w = e / z, rounded as the
//   plain version's division rounds it but from one correctly rounded
//   reciprocal a channel and two fused corrections a quotient (div_rn);
// - pool 2 with the residual gives each of a block's 8 warps one row of the
//   block's 8-row tile, so that few rows (625 at app-bf16's level 1) still
//   spread over many warps, and splits the tile's mlp2 m-tiles among them.
// The rounding points are the plain versions' (ops/lfa_kernels.py): the
// RPE as (g + centre) + dist·w9 then one fused multiply-add for the BN
// affine (which XLA makes of it too), kept unrounded for the weighted sum
// and rounded to bfloat16 for the score and rpe2 dots; the softmax
// normalised before each product w·x is rounded to bfloat16 (with several
// chunks of K, K = 64 and 128 at h = 8, each chunk's scores are computed
// again against the final maximum); pool 2's pooled row rounded before the
// mlp2 dot; every output rounded once (__float2bfloat16_rn). A bfloat16
// product is exact in float32, so only the order of the f32 sums differs
// from the plain versions.

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
// alone (F = 0, f_in unused), out (rows, 2h). The g2 half of a row's
// neighbours is read by index from round 1's pooled rows (table, s rows a
// cloud of n query rows). Dynamic shared memory: two row buffers of
// TR * (K*2h + pad) | Ws | Wp | op | agg (TR, 2h) | pooled (TR, 2h) | two
// f_in buffers of TR * F | two index buffers of TR * K.
template <int H, int KC, bool RES>
__global__ void __launch_bounds__(TILE_THREADS)
lfa_pool2_tile_kernel(const float* __restrict__ rpe2, const float* __restrict__ table,
                      const int* __restrict__ nbr, const float* __restrict__ f_in,
                      const float* __restrict__ consts, float* __restrict__ out, int rows,
                      int K, int F, int n, int s) {
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
  int* ibuf = reinterpret_cast<int*>(fin + 2 * TR * F);
  // the residual's constants follow the head: Wm (2h x 4h) | Wsh (F x 4h) | off (4h)
  const float* wm = consts + pool2_head_consts(H);
  const float* wsh = wm + C2 * C4;
  const float* off = wsh + F * C4;

  for (int i = threadIdx.x; i < pool2_head_consts(H); i += blockDim.x) ws[i] = consts[i];

  const int KH = K * H;
  const int n_tiles = (rows + TR - 1) / TR;
  // the neighbour indices of rows [tile * TR, +TR) into index buffer buf
  auto load_indices = [&](int tile, int buf) {
    const int row0 = tile * TR;
    const int nr = min(TR, rows - row0);
    for (int e = threadIdx.x; e < nr * K; e += blockDim.x) {
      cp_async4(ibuf + buf * TR * K + e, nbr + static_cast<size_t>(row0) * K + e);
    }
  };
  // rows [tile * TR, +TR) of rpe2 | table[index] into cat (TR, K, 2h) of
  // buffer buf, by the indices of index buffer buf
  auto load_tile = [&](int tile, int buf) {
    float* t = tiles + buf * TR * RS;
    const int* ix = ibuf + buf * TR * K;
    const int row0 = tile * TR;
    const int nr = min(TR, rows - row0);
    const int chunks = KH / 4;
    for (int e = threadIdx.x; e < nr * chunks; e += blockDim.x) {
      const int rr = e / chunks, q = 4 * (e - rr * chunks);
      const int k = q / H, c = q - k * H;
      const int row = row0 + rr;
      const size_t nb = static_cast<size_t>(row / n) * s + ix[rr * K + k];
      float* dst = t + rr * RS + k * C2 + c;
      cp_async16(dst, rpe2 + static_cast<size_t>(row) * KH + q);
      cp_async16(dst + H, table + nb * H + c);
    }
    if constexpr (RES) {
      for (int e = threadIdx.x; e < nr * F; e += blockDim.x) {
        cp_async4(fin + buf * TR * F + e, f_in + static_cast<size_t>(row0) * F + e);
      }
    }
  };

  const int r = threadIdx.x / C2, j = threadIdx.x - r * C2;
  int buf = 0;
  // the first tile's indices, then its rows with the next tile's indices:
  // from here on a tile's indices arrive one tile ahead of its rows
  if (blockIdx.x < n_tiles) {
    load_indices(blockIdx.x, 0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    load_tile(blockIdx.x, 0);
    if (blockIdx.x + gridDim.x < n_tiles) load_indices(blockIdx.x + gridDim.x, 1);
    cp_async_commit();
  }
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile, the next one's indices (and, first time, the constants) visible
    // every thread is past the previous tile: its buffers may be refilled
    const int next = tile + gridDim.x;
    if (next < n_tiles) {
      load_tile(next, buf ^ 1);
      if (next + gridDim.x < n_tiles) load_indices(next + gridDim.x, buf);
      cp_async_commit();
    }
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
// runs in chunks of KC / 2 neighbours. A row's neighbours are read by index
// from the table (s rows a cloud of n query rows). Dynamic shared memory:
// two row buffers of TR * (K*2h + pad) | two d2 buffers of TR * K | two
// centre buffers of TR * h | the constants of round1_consts | agg (TR, 2h) |
// two index buffers of TR * K.
template <int H, int KC>
__global__ void __launch_bounds__(TILE_THREADS)
lfa_round1_tile_kernel(const float* __restrict__ table, const int* __restrict__ nbr,
                       const float* __restrict__ d2, const float* __restrict__ center,
                       const float* __restrict__ consts, float* __restrict__ pooled_out,
                       float* __restrict__ rpe2_out, int rows, int K, int n, int s) {
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
  int* ibuf = reinterpret_cast<int*>(agg + TR * C2);
  const float* w9 = cst;
  const float* s1 = w9 + H;
  const float* o1 = s1 + H;
  const float* ws = o1 + H;
  const float* wp = ws + C2 * C2;
  const float* op = wp + C2 * H;
  const float* w2 = op + H;
  const float* o2 = w2 + H * H;

  // the constants arrive with the first tile's indices (one cp.async group)
  for (int i = threadIdx.x; i < round1_consts(H); i += blockDim.x) cp_async4(cst + i, consts + i);

  const int n_tiles = (rows + TR - 1) / TR;
  // the neighbour indices of rows [tile * TR, +TR) into index buffer buf
  auto load_indices = [&](int tile, int buf) {
    const int row0 = tile * TR;
    const int nr = min(TR, rows - row0);
    for (int e = threadIdx.x; e < nr * K; e += blockDim.x) {
      cp_async4(ibuf + buf * TR * K + e, nbr + static_cast<size_t>(row0) * K + e);
    }
  };
  // rows [tile * TR, +TR) of table[index] (by the indices of index buffer
  // buf), d2 and center into buffer buf
  auto load_tile = [&](int tile, int buf) {
    float* t = tiles + buf * TR * RS;
    const int* ix = ibuf + buf * TR * K;
    const int row0 = tile * TR;
    const int nr = min(TR, rows - row0);
    constexpr int CHUNKS = C2 / 4;  // 16-byte copies a neighbour row
    for (int e = threadIdx.x; e < nr * K * CHUNKS; e += blockDim.x) {
      const int rk = e / CHUNKS, q = 4 * (e - rk * CHUNKS);  // rk = rr * K + k
      const int rr = rk / K;
      const size_t nb = static_cast<size_t>((row0 + rr) / n) * s + ix[rk];
      cp_async16(t + rr * RS + (rk - rr * K) * C2 + q, table + nb * C2 + q);
    }
    for (int e = threadIdx.x; e < nr * K; e += blockDim.x) {
      cp_async4(dbuf + buf * TR * K + e, d2 + static_cast<size_t>(row0) * K + e);
    }
    for (int e = threadIdx.x; e < nr * H; e += blockDim.x) {
      cp_async4(cbuf + buf * TR * H + e, center + static_cast<size_t>(row0) * H + e);
    }
  };

  const int r = threadIdx.x / C2, j = threadIdx.x - r * C2;
  const int ch = j % H, half = j / H;  // the rpe2 channel and neighbour half
  int buf = 0;
  // the first tile's indices, then its rows with the next tile's indices:
  // from here on a tile's indices arrive one tile ahead of its rows
  if (blockIdx.x < n_tiles) {
    load_indices(blockIdx.x, 0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    load_tile(blockIdx.x, 0);
    if (blockIdx.x + gridDim.x < n_tiles) load_indices(blockIdx.x + gridDim.x, 1);
    cp_async_commit();
  }
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile, the next one's indices (and, first time, the constants) visible
    // every thread is past the previous tile: its buffers may be refilled
    const int next = tile + gridDim.x;
    if (next < n_tiles) {
      load_tile(next, buf ^ 1);
      if (next + gridDim.x < n_tiles) load_indices(next + gridDim.x, buf);
      cp_async_commit();
    }
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

// --- the bfloat16 forms, on the tensor cores (see the note at the top) -------

constexpr unsigned FULL_MASK = 0xffffffffu;
// warps a block of the bfloat16 round-1 kernel and of pool 2 alone: the
// block stages the constant matrices once and each warp then walks its own
// rows (benchmarks/launch_ab.py times 8 at h = 8 as bf16_warps8, 4 at h = 32
// as bf16_warps4; on an H100 80GB HBM3 at 700 W, 4 at h = 32 took B2-bf16
// at 16,384 rows from 0.0862 to 0.0907 ms and 8 at h = 8 moved no kernel by
// more than 4%)
constexpr int BF_WARPS_H8 = 4;
constexpr int BF_WARPS_H32 = 8;
// rows of pool 2's residual tile, a multiple of 8 (the n of its mlp2 and
// shortcut products), one a warp: at h = 32 16 where shared memory holds
// them (F up to about 64), else 8 (launch_ab.py's bf16_tile8: B3-bf16 at
// 16,384 rows 0.1022 against 0.0843 ms; bf16_tile16 at h = 8 and 65,536
// rows 0.0763 against 0.0675)
constexpr int BF_TILE_ROWS_H8 = 8;
constexpr int BF_TILE_ROWS_H32 = 16;
// bfloat16 elements after each row of a staged tile or matrix: rows then lie
// an odd number of 16-byte units apart, so the eight rows an ldmatrix reads
// fall on distinct banks
constexpr int BF_PAD = 8;

__host__ __device__ constexpr int bf_warps(int h) { return h == 8 ? BF_WARPS_H8 : BF_WARPS_H32; }

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf16_at(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// two bfloat16 in one register, lo in the low half (the lower index of an
// mma fragment's pair)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ldmatrix (8x8 matrices of 16-bit elements, rows of 16 bytes): lane l
// gives the address of row l & 7 of matrix l >> 3, and receives the pair of
// elements 2(l & 3), +1 of row l >> 2 of each matrix
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(unsigned& r0, unsigned& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ unsigned ldsm_x1(const void* p) {
  unsigned r;
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];\n"
               : "=r"(r)
               : "r"(smem_addr(p))
               : "memory");
  return r;
}

// d += a·b on the tensor cores: bfloat16 operands, float32 sums. m16n8k16:
// a (16 x 16) row-major, b (16 x 8) column-major, d (16 x 8); lane (g, q) =
// (l >> 2, l & 3) holds a's rows g, g + 8 at columns 2q, 2q + 1 (and + 8),
// b's column g at rows 2q, 2q + 1 (and + 8), d's rows g, g + 8 at columns
// 2q, 2q + 1
__device__ __forceinline__ void mma_k16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                        unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// m16n8k8: the depth-8 form (the rpe2 dot at h = 8)
__device__ __forceinline__ void mma_k8(float (&d)[4], unsigned a0, unsigned a1, unsigned b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// e / z rounded to nearest, as __fdiv_rn, from y = __frcp_rn(z) (one a
// channel): q0 = e·y lies within 1.5 ulps of e / z, the first fused
// correction brings it within one, and the second, from a quotient within an
// ulp and a correctly rounded reciprocal, rounds it exactly (Markstein's
// theorem). e in [0, 1] and z in [1, K]: no overflow; a quotient below the
// normal range may round otherwise, where its bfloat16 product vanishes.
__device__ __forceinline__ float div_rn(float e, float z, float y) {
  float q = __fmul_rn(e, y);
  q = __fmaf_rn(__fmaf_rn(-q, z, e), y, q);
  return __fmaf_rn(__fmaf_rn(-q, z, e), y, q);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, 1));
  return fmaxf(v, __shfl_xor_sync(FULL_MASK, v, 2));
}

// the same sum on the quad's four lanes: (t0 + t1) + (t2 + t3)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL_MASK, v, 1);
  return v + __shfl_xor_sync(FULL_MASK, v, 2);
}

// The pool MLP of one row, float32 off the tensor cores: relu(agg @ Wp + op)
// for N outputs (Wp (2h, N) row-major), lane l < N/2 the output pair o = 2l,
// o + 1, its 2h inputs summed in order (as the plain version's matmul sums
// them on the CPU: spreading them over the idle lanes, in another order,
// left fewer outputs bit-identical). Returns whether lane l holds a pair,
// its bfloat16 pair in *out.
template <int C2, int N>
__device__ __forceinline__ bool pool_mlp(const float* agg, const float* wp, const float* op,
                                         int lane, unsigned* out) {
  if (lane >= N / 2) return false;
  const int o = 2 * lane;
  float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
  for (int c = 0; c < C2; ++c) {
    const float ag = agg[c];
    const float2 w = *reinterpret_cast<const float2*>(wp + c * N + o);
    a0 = fmaf(ag, w.x, a0);
    a1 = fmaf(ag, w.y, a1);
  }
  *out = pack_bf16(fmaxf(a0 + op[o], 0.f), fmaxf(a1 + op[o + 1], 0.f));
  return true;
}

// The score dot's B fragments of one staged row, bf16(cat) (K neighbours x
// 2h channels, row stride sp): bf[n][s] = neighbours 8n.., channels 16s..,
// as mma_k16's b (the row-major tile is b in column-major form: no .trans).
template <int H, int K>
__device__ __forceinline__ void load_cat_frags(unsigned (&bf)[K / 8][H / 8][2],
                                               const __nv_bfloat16* t, int sp, int lane) {
  constexpr int NT = K / 8;
  const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int p = 0; p < (NT + 1) / 2; ++p) {
    const int n = min(2 * p + (mi >> 1), NT - 1);  // K = 8: the second n-tile repeats
#pragma unroll
    for (int s = 0; s < H / 8; ++s) {
      unsigned r[4];
      ldsm_x4(r, t + (8 * n + rr) * sp + 16 * s + 8 * (mi & 1));
      bf[2 * p][s][0] = r[0];
      bf[2 * p][s][1] = r[1];
      if (2 * p + 1 < NT) {
        bf[2 * p + 1][s][0] = r[2];
        bf[2 * p + 1][s][1] = r[3];
      }
    }
  }
}

// s[t] = the scores of n-tile n0 + t for the m-tile whose Wsᵀ fragments are a
template <int H, int K, int NTC>
__device__ __forceinline__ void score_tiles(float (&s)[NTC][4], const unsigned (&a)[H / 8][4],
                                            const unsigned (&bf)[K / 8][H / 8][2], int n0) {
#pragma unroll
  for (int t = 0; t < NTC; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
  }
#pragma unroll
  for (int ks = 0; ks < H / 8; ++ks) {
#pragma unroll
    for (int t = 0; t < NTC; ++t) mma_k16(s[t], a[ks], bf[n0 + t][ks][0], bf[n0 + t][ks][1]);
  }
}

// Attentive pooling of one staged row: agg[j] = sum_k bf16(w[k, j]·x(k, j))
// with w = softmax_K(bf16(cat) @ Ws) normalised first (w = e / z) and x the
// unrounded lane. 16 channels (an m-tile) at a time, the scores transposed,
// Sᵀ = Wsᵀ·bf16(cat)ᵀ: lane (g, q) holds channels 16mt + g and + 8 of the
// neighbours 8n + 2q, + 1 of every n-tile n, so the softmax over K runs in
// the lane and its quad (two shuffles). K = 64, 128: chunks of 32
// neighbours, the maximum and z online, each chunk's scores computed again
// against the final maximum. x(k, j, rpe): rpe tells whether channel j is
// an rpe lane (known at compile time once the loops unroll).
template <int H, int K, typename X>
__device__ __forceinline__ void attentive_pool(const __nv_bfloat16* wst,
                                               const unsigned (&bf)[K / 8][H / 8][2], X x,
                                               float* agg, int lane) {
  constexpr int C2 = 2 * H, SP = C2 + BF_PAD, KS = H / 8, NT = K / 8;
  constexpr int NTC = NT < 4 ? NT : 4;
  constexpr int CH = NT / NTC;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mt = 0; mt < C2 / 16; ++mt) {
    unsigned a[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      ldsm_x4(a[ks], wst + (16 * mt + (lane & 7) + 8 * ((lane >> 3) & 1)) * SP + 16 * ks +
                         8 * (lane >> 4));
    }
    float s[NTC][4];
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, z[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < CH; ++c) {  // the maximum and z, online by chunks
      score_tiles<H, K, NTC>(s, a, bf, c * NTC);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mc = -CUDART_INF_F;
#pragma unroll
        for (int t = 0; t < NTC; ++t) mc = fmaxf(mc, fmaxf(s[t][2 * hh], s[t][2 * hh + 1]));
        const float mn = fmaxf(m[hh], quad_max(mc));
        const float scale = expf(m[hh] - mn);  // 0 on the first chunk
        float zc = 0.f;
#pragma unroll
        for (int t = 0; t < NTC; ++t) {
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            s[t][2 * hh + b] = expf(s[t][2 * hh + b] - mn);
            zc += s[t][2 * hh + b];
          }
        }
        z[hh] = fmaf(z[hh], scale, quad_sum(zc));
        m[hh] = mn;
      }
    }
    const float y[2] = {__frcp_rn(z[0]), __frcp_rn(z[1])};
    float acc[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (CH > 1) {  // one chunk: its exponentials are still in s
        score_tiles<H, K, NTC>(s, a, bf, c * NTC);
#pragma unroll
        for (int t = 0; t < NTC; ++t) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[t][e] = expf(s[t][e] - m[e >> 1]);
        }
      }
#pragma unroll
      for (int t = 0; t < NTC; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1, k = 8 * (c * NTC + t) + 2 * q + (e & 1);
          const float w = div_rn(s[t][e], z[hh], y[hh]);
          acc[hh] += bf16_round(__fmul_rn(w, x(k, 16 * mt + 8 * hh + g, 16 * mt + 8 * hh < H)));
        }
      }
    }
    acc[0] = quad_sum(acc[0]);
    acc[1] = quad_sum(acc[1]);
    if (q == 0) {
      agg[16 * mt + g] = acc[0];
      agg[16 * mt + 8 + g] = acc[1];
    }
  }
}

// Byte offsets of lfa_round1_mma_kernel's shared memory: the block's
// constants, then per warp two staging buffers, agg and two index buffers.
template <int H, int K>
struct Round1Layout {
  static constexpr int C2 = 2 * H, SP = C2 + BF_PAD, SP2 = H + BF_PAD;
  static constexpr int WST = 0;                       // Wsᵀ bf16 (2h, 2h + pad)
  static constexpr int W2T = WST + C2 * SP * 2;       // W2ᵀ bf16 (h, h + pad)
  static constexpr int WP = W2T + H * SP2 * 2;        // Wp f32 (2h, h)
  static constexpr int VEC = WP + C2 * H * 4;         // w9 | s1 | o1 | op | o2, f32 (h) each
  static constexpr int CONSTS = VEC + 5 * H * 4;
  static constexpr int STAGE_D = K * SP * 2;          // after the rows: d2 (K) | centre (h)
  static constexpr int STAGE_C = STAGE_D + K * 4;
  static constexpr int STAGE = STAGE_C + H * 4;
  static constexpr int AGG = 2 * STAGE;               // f32 (2h)
  static constexpr int IDX = AGG + C2 * 4;            // int32 2 x (K)
  static constexpr int WARP = IDX + 2 * K * 4;
  static constexpr size_t bytes() { return CONSTS + static_cast<size_t>(bf_warps(H)) * WARP; }
};

// Round 1, bfloat16 form. A persistent grid; each warp takes a row at a time
// (rows blockIdx.x * W + warp, + gridDim.x * W, ...) and stages the next one
// by cp.async while it computes, its neighbours read by index from the
// table (s rows a cloud of n query rows), the indices staged a row ahead.
// Per row: the distances; the score dot's B fragments by ldmatrix from the
// staged neighbour rows, their rpe lanes replaced by bf16(rpe) computed in
// the fragments' layout; the attentive pooling (x: the rpe lanes computed
// again, unrounded, in the accumulators' layout); rpe2 = relu(bf16(rpe) @
// W2 + o2) on the tensor cores, its A fragments those same registers;
// pooled = relu(agg @ Wp + op) in float32.
template <int H, int K>
__global__ void __launch_bounds__(32 * bf_warps(H))
lfa_round1_mma_kernel(const __nv_bfloat16* __restrict__ table, const int* __restrict__ nbr,
                      const float* __restrict__ d2, const float* __restrict__ center,
                      const float* __restrict__ consts, __nv_bfloat16* __restrict__ pooled_out,
                      __nv_bfloat16* __restrict__ rpe2_out, int rows, int n, int s) {
  using L = Round1Layout<H, K>;
  constexpr int C2 = 2 * H, SP = L::SP, SP2 = L::SP2, NT = K / 8, KS = H / 8;
  constexpr int W = bf_warps(H);
  extern __shared__ __align__(16) unsigned char r1m_sm[];
  __nv_bfloat16* wst = reinterpret_cast<__nv_bfloat16*>(r1m_sm + L::WST);
  __nv_bfloat16* w2t = reinterpret_cast<__nv_bfloat16*>(r1m_sm + L::W2T);
  float* wp = reinterpret_cast<float*>(r1m_sm + L::WP);
  float* w9 = reinterpret_cast<float*>(r1m_sm + L::VEC);
  float* s1 = w9 + H;
  float* o1 = s1 + H;
  float* op = o1 + H;
  float* o2 = op + H;

  // the constants (w9 | s1 | o1 | Ws | Wp | op | W2 | o2), the dots'
  // matrices transposed into bfloat16 (exact: the wrapper rounded them)
  const float* c_ws = consts + 3 * H;
  const float* c_wp = c_ws + C2 * C2;
  const float* c_w2 = c_wp + C2 * H + H;
  for (int i = threadIdx.x; i < C2 * C2; i += blockDim.x) {
    wst[(i % C2) * SP + i / C2] = __float2bfloat16_rn(c_ws[i]);
  }
  for (int i = threadIdx.x; i < H * H; i += blockDim.x) {
    w2t[(i % H) * SP2 + i / H] = __float2bfloat16_rn(c_w2[i]);
  }
  for (int i = threadIdx.x; i < C2 * H; i += blockDim.x) wp[i] = c_wp[i];
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    w9[i] = consts[i];
    s1[i] = consts[H + i];
    o1[i] = consts[2 * H + i];
    op[i] = c_wp[C2 * H + i];
    o2[i] = c_w2[H * H + i];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, q = lane & 3;
  unsigned char* wb = r1m_sm + L::CONSTS + warp * L::WARP;
  float* agg = reinterpret_cast<float*>(wb + L::AGG);
  int* ibuf = reinterpret_cast<int*>(wb + L::IDX);
  const int nw = gridDim.x * W;
  // row's K neighbour indices into index buffer buf
  auto issue_indices = [&](int row, int buf) {
    for (int e = lane; e < K; e += 32) {
      cp_async4(ibuf + buf * K + e, nbr + static_cast<size_t>(row) * K + e);
    }
  };
  // row into staging buffer buf: its neighbours' table rows (by the indices
  // of index buffer buf) into padded rows, 16 bytes a copy; d2 and the
  // centre term 4 bytes a copy
  auto issue = [&](int row, int buf) {
    unsigned char* st = wb + buf * L::STAGE;
    __nv_bfloat16* gt = reinterpret_cast<__nv_bfloat16*>(st);
    const int* ix = ibuf + buf * K;
    const __nv_bfloat16* src = table + static_cast<size_t>(row / n) * s * C2;
    for (int e = lane; e < K * H / 4; e += 32) {
      const int k = e / (H / 4), c = 8 * (e % (H / 4));
      cp_async16(gt + k * SP + c, src + static_cast<size_t>(ix[k]) * C2 + c);
    }
    float* db = reinterpret_cast<float*>(st + L::STAGE_D);
    for (int e = lane; e < K; e += 32) cp_async4(db + e, d2 + static_cast<size_t>(row) * K + e);
    float* cb = reinterpret_cast<float*>(st + L::STAGE_C);
    for (int e = lane; e < H; e += 32) {
      cp_async4(cb + e, center + static_cast<size_t>(row) * H + e);
    }
  };

  // the first row's indices, then its copies with the next row's indices:
  // from here on a row's indices arrive one row ahead of its copies
  int row = blockIdx.x * W + warp;
  if (row < rows) {
    issue_indices(row, 0);
    cp_async_commit();
    cp_async_wait_all();
    __syncwarp();
    issue(row, 0);
    if (row + nw < rows) issue_indices(row + nw, 1);
  }
  cp_async_commit();
  for (int buf = 0; row < rows; row += nw, buf ^= 1) {
    cp_async_wait_all();
    __syncwarp();  // this row's copies and the next row's indices, from every lane, visible
    if (row + nw < rows) {
      issue(row + nw, buf ^ 1);
      if (row + 2 * nw < rows) issue_indices(row + 2 * nw, buf);
    }
    cp_async_commit();
    unsigned char* st = wb + buf * L::STAGE;
    const __nv_bfloat16* gt = reinterpret_cast<const __nv_bfloat16*>(st);
    float* dist = reinterpret_cast<float*>(st + L::STAGE_D);
    const float* cen = reinterpret_cast<const float*>(st + L::STAGE_C);
    for (int k = lane; k < K; k += 32) dist[k] = sqrtf(fmaxf(dist[k], 0.f));
    __syncwarp();
    // rpe = relu(fma((g_rpe + centre) + dist·w9, s1, o1)), the plain
    // version's operations in its order
    auto rpe = [&](int k, int c) {
      const float pre =
          __fadd_rn(__fadd_rn(bf16_at(gt + k * SP + c), cen[c]), __fmul_rn(dist[k], w9[c]));
      return fmaxf(__fmaf_rn(pre, s1[c], o1[c]), 0.f);
    };

    unsigned bf[NT][KS][2];
    load_cat_frags<H, K>(bf, gt, SP, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int c = 16 * ks + 8 * hf + 2 * q;
          if (16 * ks + 8 * hf < H) bf[n][ks][hf] = pack_bf16(rpe(8 * n + gq, c), rpe(8 * n + gq, c + 1));
        }
      }
    }
    attentive_pool<H, K>(
        wst, bf,
        [&](int k, int j, bool is_rpe) { return is_rpe ? rpe(k, j) : bf16_at(gt + k * SP + j); },
        agg, lane);

    // rpe2 (K x h) = relu(bf16(rpe) @ W2 + o2): neighbours as the mma's
    // rows, its A fragments the rpe lanes of bf
    __nv_bfloat16* r2 = rpe2_out + static_cast<size_t>(row) * K * H;
#pragma unroll
    for (int mt = 0; mt < (K + 15) / 16; ++mt) {
      const int n0 = 2 * mt, n1 = min(2 * mt + 1, NT - 1);
#pragma unroll
      for (int nt = 0; nt < H / 8; ++nt) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (H == 8) {
          mma_k8(d, bf[n0][0][0], bf[n1][0][0], ldsm_x1(w2t + (lane & 7) * SP2));
        } else {
#pragma unroll
          for (int ks = 0; ks < H / 16; ++ks) {
            unsigned b0, b1;
            ldsm_x2(b0, b1, w2t + (8 * nt + (lane & 7)) * SP2 + 16 * ks + 8 * ((lane >> 3) & 1));
            const unsigned a[4] = {bf[n0][ks][0], bf[n1][ks][0], bf[n0][ks][1], bf[n1][ks][1]};
            mma_k16(d, a, b0, b1);
          }
        }
        const int ch = 8 * nt + 2 * q, k0 = 16 * mt + gq;
        *reinterpret_cast<unsigned*>(r2 + k0 * H + ch) =
            pack_bf16(fmaxf(d[0] + o2[ch], 0.f), fmaxf(d[1] + o2[ch + 1], 0.f));
        if (k0 + 8 < K) {
          *reinterpret_cast<unsigned*>(r2 + (k0 + 8) * H + ch) =
              pack_bf16(fmaxf(d[2] + o2[ch], 0.f), fmaxf(d[3] + o2[ch + 1], 0.f));
        }
      }
    }
    __syncwarp();  // agg of the row visible

    // pooled (h) = relu(agg @ Wp + op)
    unsigned p;
    if (pool_mlp<C2, H>(agg, wp, op, lane, &p)) {
      *reinterpret_cast<unsigned*>(pooled_out + static_cast<size_t>(row) * H + 2 * lane) = p;
    }
    __syncwarp();  // the staging buffer and agg free for the rows ahead
  }
}

// Warps a block of lfa_pool2_mma_kernel: with the residual one a row of the
// block's tile of tr rows, else bf_warps(h), each on its own rows.
__host__ __device__ constexpr int pool2_warps(int h, bool res, int tr) {
  return res ? tr : bf_warps(h);
}

// Byte offsets of lfa_pool2_mma_kernel's shared memory: the block's
// constants and, with the residual, its tile's pooled rows, two buffers of
// the tile's f_in rows (fp: F padded to 16 with zeros) and its output rows;
// then per warp two staging buffers (the concatenation [rpe2 | g2], padded
// rows), agg and two index buffers.
struct Pool2Layout {
  int wst, wp, op, wmt, wsht, off, pooled, fin, out, warps, stage, agg, idx, warp;
  __host__ __device__ Pool2Layout(int h, int k, bool res, int fp, int tile_rows) {
    const int c2 = 2 * h, c4 = 4 * h, sp = c2 + BF_PAD, spf = fp + BF_PAD, spo = c4 + BF_PAD;
    const int tr = res ? tile_rows : 0;
    wst = 0;                                  // Wsᵀ bf16 (2h, 2h + pad)
    wp = wst + c2 * sp * 2;                   // Wp f32 (2h, 2h)
    op = wp + c2 * c2 * 4;                    // op f32 (2h)
    wmt = op + c2 * 4;                        // Wmᵀ bf16 (4h, 2h + pad)
    wsht = wmt + (res ? c4 * sp * 2 : 0);     // Wshᵀ bf16 (4h, fp + pad)
    off = wsht + (res ? c4 * spf * 2 : 0);    // off f32 (4h)
    pooled = off + (res ? c4 * 4 : 0);        // bf16 (tr, 2h + pad)
    fin = pooled + tr * sp * 2;               // bf16 2 x (tr, fp + pad)
    out = fin + 2 * tr * spf * 2;             // bf16 (tr, 4h + pad)
    warps = out + tr * spo * 2;
    stage = k * sp * 2;
    agg = 2 * stage;                          // f32 (2h)
    idx = agg + c2 * 4;                       // int32 2 x (K)
    warp = idx + 2 * k * 4;
  }
  __host__ __device__ size_t bytes(int warps_a_block) const {
    return warps + static_cast<size_t>(warps_a_block) * warp;
  }
};

// Attentive pooling and the pool MLP of the row staged at t: pooled (2h) =
// relu(agg @ Wp + op), its bfloat16 pair of channels o, o + 1 handed to
// put(o, pair) by lane o / 2.
template <int H, int K, typename Put>
__device__ __forceinline__ void pool2_row(const __nv_bfloat16* t, const __nv_bfloat16* wst,
                                          const float* wp, const float* op, float* agg,
                                          int lane, Put put) {
  constexpr int C2 = 2 * H, SP = C2 + BF_PAD;
  unsigned bf[K / 8][H / 8][2];
  load_cat_frags<H, K>(bf, t, SP, lane);
  attentive_pool<H, K>(
      wst, bf, [&](int k, int j, bool) { return bf16_at(t + k * SP + j); }, agg, lane);
  __syncwarp();  // agg of the row visible
  unsigned p;
  if (pool_mlp<C2, C2>(agg, wp, op, lane, &p)) put(2 * lane, p);
}

// Pool 2 (RES: + the residual), bfloat16 form. A persistent grid. Without
// the residual each warp takes a row at a time (rows blockIdx.x * W + warp,
// + gridDim.x * W, ...); with it the block takes tiles of TR rows (tiles
// blockIdx.x, + gridDim.x, ...), warp w row w of each. A warp stages its
// next row by cp.async while it computes the current one, the g2 half read
// by index from round 1's pooled rows (table, s rows a cloud of n query
// rows), the indices staged a row ahead: the score dot's B
// fragments by ldmatrix from the staged [rpe2 | g2], the attentive pooling,
// pooled = relu(agg @ Wp + op) in float32. With the residual the tile then
// ends with out = leaky_relu((bf16(pooled) @ Wm + f_in @ Wsh) + off) on the
// tensor cores, transposed (outᵀ = Wmᵀ·pooledᵀ + Wshᵀ·f_inᵀ: the tile's
// rows are the mma's n), 16 output channels (an m-tile) a warp, staged in
// shared memory and stored 16 bytes at a time: two block barriers a tile.
template <int H, int K, bool RES, int TR>
__global__ void __launch_bounds__(32 * pool2_warps(H, RES, TR))
lfa_pool2_mma_kernel(const __nv_bfloat16* __restrict__ rpe2,
                     const __nv_bfloat16* __restrict__ table, const int* __restrict__ nbr,
                     const __nv_bfloat16* __restrict__ f_in, const float* __restrict__ consts,
                     __nv_bfloat16* __restrict__ out, int rows, int F, int n, int s) {
  constexpr int C2 = 2 * H, C4 = 4 * H, SP = C2 + BF_PAD, SPO = C4 + BF_PAD;
  constexpr int KS = H / 8, W = pool2_warps(H, RES, TR), NR = TR / 8;
  const int fp = (F + 15) & ~15, spf = fp + BF_PAD;
  const Pool2Layout L(H, K, RES, fp, TR);
  extern __shared__ __align__(16) unsigned char p2m_sm[];
  __nv_bfloat16* wst = reinterpret_cast<__nv_bfloat16*>(p2m_sm + L.wst);
  float* wp = reinterpret_cast<float*>(p2m_sm + L.wp);
  float* op = reinterpret_cast<float*>(p2m_sm + L.op);
  __nv_bfloat16* wmt = reinterpret_cast<__nv_bfloat16*>(p2m_sm + L.wmt);
  __nv_bfloat16* wsht = reinterpret_cast<__nv_bfloat16*>(p2m_sm + L.wsht);
  float* off = reinterpret_cast<float*>(p2m_sm + L.off);
  __nv_bfloat16* pooled = reinterpret_cast<__nv_bfloat16*>(p2m_sm + L.pooled);
  __nv_bfloat16* fin = reinterpret_cast<__nv_bfloat16*>(p2m_sm + L.fin);
  __nv_bfloat16* ot = reinterpret_cast<__nv_bfloat16*>(p2m_sm + L.out);

  // the constants (Ws | Wp | op [| Wm | Wsh | off]), the dots' matrices
  // transposed into bfloat16 (exact: the wrapper rounded them); Wshᵀ's
  // columns and the f_in rows' padding beyond F zero
  const float* c_wp = consts + C2 * C2;
  const float* c_op = c_wp + C2 * C2;
  for (int i = threadIdx.x; i < C2 * C2; i += blockDim.x) {
    wst[(i % C2) * SP + i / C2] = __float2bfloat16_rn(consts[i]);
    wp[i] = c_wp[i];
  }
  for (int i = threadIdx.x; i < C2; i += blockDim.x) op[i] = c_op[i];
  if constexpr (RES) {
    const float* c_wm = c_op + C2;
    const float* c_wsh = c_wm + C2 * C4;
    const float* c_off = c_wsh + F * C4;
    for (int i = threadIdx.x; i < C2 * C4; i += blockDim.x) {
      wmt[(i % C4) * SP + i / C4] = __float2bfloat16_rn(c_wm[i]);
    }
    for (int i = threadIdx.x; i < C4 * fp; i += blockDim.x) {
      const int o = i / fp, f = i % fp;
      wsht[o * spf + f] = __float2bfloat16_rn(f < F ? c_wsh[f * C4 + o] : 0.f);
    }
    for (int i = threadIdx.x; i < C4; i += blockDim.x) off[i] = c_off[i];
    for (int i = threadIdx.x; i < 2 * TR * fp; i += blockDim.x) {
      if (i % fp >= F) fin[(i / fp) * spf + i % fp] = __float2bfloat16_rn(0.f);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, q = lane & 3;
  unsigned char* wb = p2m_sm + L.warps + warp * L.warp;
  float* agg = reinterpret_cast<float*>(wb + L.agg);
  int* ibuf = reinterpret_cast<int*>(wb + L.idx);
  // row's K neighbour indices into index buffer buf
  auto issue_indices = [&](int row, int buf) {
    if (row >= rows) return;
    for (int e = lane; e < K; e += 32) {
      cp_async4(ibuf + buf * K + e, nbr + static_cast<size_t>(row) * K + e);
    }
  };
  // row into staging buffer buf: rpe2 and its neighbours' table rows (by
  // the indices of index buffer buf) side by side in padded rows, 16 bytes
  // a copy; with the residual its f_in into row `warp` of f_in buffer fb, 4
  // bytes a copy
  auto issue = [&](int row, int buf, int fb) {
    if (row >= rows) return;
    __nv_bfloat16* t = reinterpret_cast<__nv_bfloat16*>(wb + buf * L.stage);
    const int* ix = ibuf + buf * K;
    const size_t src = static_cast<size_t>(row) * K * H;
    const __nv_bfloat16* tb = table + static_cast<size_t>(row / n) * s * H;
    for (int e = lane; e < K * H / 8; e += 32) {
      const int k = e / (H / 8), c = 8 * (e % (H / 8));
      __nv_bfloat16* dst = t + k * SP + c;
      cp_async16(dst, rpe2 + src + 8 * e);
      cp_async16(dst + H, tb + static_cast<size_t>(ix[k]) * H + c);
    }
    if constexpr (RES) {
      __nv_bfloat16* fr = fin + (fb * TR + warp) * spf;
      for (int e = lane; e < F / 2; e += 32) {
        cp_async4(fr + 2 * e, f_in + static_cast<size_t>(row) * F + 2 * e);
      }
    }
  };
  auto stage_of = [&](int buf) {
    return reinterpret_cast<const __nv_bfloat16*>(wb + buf * L.stage);
  };

  // a row's first copies: its indices, then its rows with the next row's
  // indices; from here on a row's indices arrive one row ahead of its copies
  auto first = [&](int row, int next) {
    issue_indices(row, 0);
    cp_async_commit();
    cp_async_wait_all();
    __syncwarp();
    issue(row, 0, 0);
    issue_indices(next, 1);
    cp_async_commit();
  };

  if constexpr (!RES) {
    const int nw = gridDim.x * W;
    int row = blockIdx.x * W + warp;
    first(row, row + nw);
    for (int buf = 0; row < rows; row += nw, buf ^= 1) {
      cp_async_wait_all();
      __syncwarp();  // this row's copies and the next row's indices, from every lane, visible
      issue(row + nw, buf ^ 1, 0);
      issue_indices(row + 2 * nw, buf);
      cp_async_commit();
      pool2_row<H, K>(stage_of(buf), wst, wp, op, agg, lane, [&](int o, unsigned p) {
        *reinterpret_cast<unsigned*>(out + static_cast<size_t>(row) * C2 + o) = p;
      });
      __syncwarp();  // the staging buffer and agg free for the rows ahead
    }
  } else {
    const int n_tiles = (rows + TR - 1) / TR;
    const int stride = gridDim.x * TR;  // rows from a warp's row of one tile to the next
    if (blockIdx.x < n_tiles) first(blockIdx.x * TR + warp, blockIdx.x * TR + warp + stride);
    for (int tile = blockIdx.x, buf = 0; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
      const int row = tile * TR + warp;
      cp_async_wait_all();
      __syncwarp();  // this row's copies and the next row's indices, from every lane, visible
      if (tile + gridDim.x < n_tiles) {
        issue(row + stride, buf ^ 1, buf ^ 1);
        if (tile + 2 * gridDim.x < n_tiles) issue_indices(row + 2 * stride, buf);
      }
      cp_async_commit();
      if (row < rows) {
        pool2_row<H, K>(stage_of(buf), wst, wp, op, agg, lane, [&](int o, unsigned p) {
          *reinterpret_cast<unsigned*>(pooled + warp * SP + o) = p;
        });
      }
      __syncthreads();  // the tile's pooled and f_in rows visible
      // mlp2 + shortcut + leaky relu, output channels 16mo.. for mo = warp,
      // + W, ...
      const __nv_bfloat16* fr = fin + buf * TR * spf;
      const int arow = (lane & 7) + 8 * ((lane >> 3) & 1), acol = 8 * (lane >> 4);
      const int brow = lane & 7, bcol = 8 * ((lane >> 3) & 1);
      for (int mo = warp; mo < C4 / 16; mo += W) {
        float pa[NR][4] = {}, pb[NR][4] = {};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          unsigned a[4];
          ldsm_x4(a, wmt + (16 * mo + arow) * SP + 16 * ks + acol);
#pragma unroll
          for (int nr = 0; nr < NR; ++nr) {
            unsigned b0, b1;
            ldsm_x2(b0, b1, pooled + (8 * nr + brow) * SP + 16 * ks + bcol);
            mma_k16(pa[nr], a, b0, b1);
          }
        }
        for (int fs = 0; fs < fp / 16; ++fs) {
          unsigned a[4];
          ldsm_x4(a, wsht + (16 * mo + arow) * spf + 16 * fs + acol);
#pragma unroll
          for (int nr = 0; nr < NR; ++nr) {
            unsigned b0, b1;
            ldsm_x2(b0, b1, fr + (8 * nr + brow) * spf + 16 * fs + bcol);
            mma_k16(pb[nr], a, b0, b1);
          }
        }
#pragma unroll
        for (int nr = 0; nr < NR; ++nr) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // channel 16mo + g (+ 8), tile row 8nr + 2q (+ 1)
            const int o = 16 * mo + gq + 8 * (e >> 1), r = 8 * nr + 2 * q + (e & 1);
            const float res = (pa[nr][e] + pb[nr][e]) + off[o];
            ot[r * SPO + o] = __float2bfloat16_rn(res > 0.f ? res : 0.01f * res);
          }
        }
      }
      __syncthreads();  // the tile's output rows staged; pooled and f_in read
      for (int e = threadIdx.x; e < TR * (C4 / 8); e += blockDim.x) {
        const int r = e / (C4 / 8), cc = e % (C4 / 8);
        if (tile * TR + r < rows) {
          *reinterpret_cast<uint4*>(out + static_cast<size_t>(tile * TR + r) * C4 + 8 * cc) =
              *reinterpret_cast<const uint4*>(ot + r * SPO + 8 * cc);
        }
      }
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

// Where a kernel reads its rows' neighbours: row r's K indices at
// idx + r * K, each into the s table rows of r's cloud (table rows
// (r / n) * s, + s: n query rows a cloud).
struct Neighbours {
  const void* table;
  const int* idx;
  int n, s;
};

// One launch of lfa_round1_tile_kernel<H, KC>.
template <int H, int KC>
int launch_round1_tiles(Neighbours nb, const float* d2, const float* center,
                        const float* consts, float* pooled, float* rpe2, int rows, int K,
                        cudaStream_t stream) {
  // at h = 8, half the rows of pool 2's tile: 128-thread blocks, more of
  // them an SM (benchmarks/launch_ab.py times pool 2's tile as
  // r1_full_tile; on an H100 80GB HBM3 at 700 W: 0.0119 against 0.0099 ms
  // at 2,500 rows, 0.168 against 0.153 ms at 65,536)
  const int tr = H == 8 ? tile_rows(K, H) / 2 : tile_rows(K, H);
  const int threads = tr * 2 * H;
  const size_t L = static_cast<size_t>(K) * 2 * H;
  // row buffers | d2 and centre buffers | constants | agg | index buffers
  const size_t smem = (2 * tr * (L + TILE_ROW_PAD) + 2 * static_cast<size_t>(tr) * (K + H) +
                       round1_consts(H) + static_cast<size_t>(tr) * 2 * H +
                       2 * static_cast<size_t>(tr) * K) *
                      sizeof(float);
  const auto kernel = lfa_round1_tile_kernel<H, KC>;
  int grid = 0;
  const int err = persistent_grid(kernel, threads, smem, (rows + tr - 1) / tr, &grid);
  if (err) return err;
  kernel<<<grid, threads, smem, stream>>>(static_cast<const float*>(nb.table), nb.idx, d2,
                                          center, consts, pooled, rpe2, rows, K, nb.n, nb.s);
  return 0;
}

// K in {8, 16, 32} takes one chunk of K; larger multiples of 32 chunks of 32.
template <int H>
int launch_round1_k(Neighbours nb, const float* d2, const float* center, const float* consts,
                    float* pooled, float* rpe2, int rows, int K, cudaStream_t s) {
  switch (K) {
    case 8:
      return launch_round1_tiles<H, 8>(nb, d2, center, consts, pooled, rpe2, rows, K, s);
    case 16:
      return launch_round1_tiles<H, 16>(nb, d2, center, consts, pooled, rpe2, rows, K, s);
    default:
      if (K < 32 || K % 32) return static_cast<int>(cudaErrorInvalidValue);
      return launch_round1_tiles<H, 32>(nb, d2, center, consts, pooled, rpe2, rows, K, s);
  }
}

// One launch of lfa_round1_mma_kernel<H, K>: a persistent grid of
// bf_warps(H)-warp blocks, no more blocks than a warp a row fills.
template <int H, int K>
int launch_round1_mma(Neighbours nb, const float* d2, const float* center, const float* consts,
                      void* pooled, void* rpe2, int rows, cudaStream_t stream) {
  constexpr int W = bf_warps(H);
  const auto kernel = lfa_round1_mma_kernel<H, K>;
  const size_t smem = Round1Layout<H, K>::bytes();
  int grid = 0;
  const int err = persistent_grid(kernel, 32 * W, smem, (rows + W - 1) / W, &grid);
  if (err) return err;
  kernel<<<grid, 32 * W, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(nb.table), nb.idx, d2, center, consts,
      static_cast<__nv_bfloat16*>(pooled), static_cast<__nv_bfloat16*>(rpe2), rows, nb.n, nb.s);
  return 0;
}

// K in {8, 16, 32}, and at h = 8 also 64 and 128 (the lanes K·2h stay within
// the 2,048 of lfa_kernels.supports)
template <int H>
int launch_round1_mma_k(Neighbours nb, const float* d2, const float* center,
                        const float* consts, void* pooled, void* rpe2, int rows, int K,
                        cudaStream_t s) {
  switch (K) {
    case 8:
      return launch_round1_mma<H, 8>(nb, d2, center, consts, pooled, rpe2, rows, s);
    case 16:
      return launch_round1_mma<H, 16>(nb, d2, center, consts, pooled, rpe2, rows, s);
    case 32:
      return launch_round1_mma<H, 32>(nb, d2, center, consts, pooled, rpe2, rows, s);
    case 64:
      if constexpr (H == 8) {
        return launch_round1_mma<H, 64>(nb, d2, center, consts, pooled, rpe2, rows, s);
      }
      break;
    case 128:
      if constexpr (H == 8) {
        return launch_round1_mma<H, 128>(nb, d2, center, consts, pooled, rpe2, rows, s);
      }
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool BF16>
int launch_round1(Neighbours nb, const float* d2, const float* center, const float* consts,
                  void* pooled, void* rpe2, int rows, int K, int h, void* stream) {
  if (rows == 0) return 0;
  if (nb.n < 1 || nb.s < 1 || rows % nb.n) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto m = [](void* p) { return static_cast<float*>(p); };
  int err;
  switch (h) {
    case 8:
      err = BF16 ? launch_round1_mma_k<8>(nb, d2, center, consts, pooled, rpe2, rows, K, s)
                 : launch_round1_k<8>(nb, d2, center, consts, m(pooled), m(rpe2), rows, K, s);
      break;
    case 32:
      err = BF16 ? launch_round1_mma_k<32>(nb, d2, center, consts, pooled, rpe2, rows, K, s)
                 : launch_round1_k<32>(nb, d2, center, consts, m(pooled), m(rpe2), rows, K, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// One launch of lfa_pool2_tile_kernel<H, KC, RES>.
template <int H, int KC, bool RES>
int launch_pool2_tiles(const float* rpe2, Neighbours nb, const float* f_in,
                       const float* consts, float* out, int rows, int K, int F,
                       cudaStream_t stream) {
  const int tr = tile_rows(K, H);
  const int threads = tr * 2 * H;
  const size_t L = static_cast<size_t>(K) * 2 * H;
  const size_t fin_floats = RES ? 2 * static_cast<size_t>(tr) * F : 0;
  // row buffers | head constants | agg and pooled | f_in buffers | index buffers
  const size_t smem = (2 * tr * (L + TILE_ROW_PAD) + pool2_head_consts(H) +
                       4 * static_cast<size_t>(tr) * H + fin_floats +
                       2 * static_cast<size_t>(tr) * K) *
                      sizeof(float);
  const auto kernel = lfa_pool2_tile_kernel<H, KC, RES>;
  int grid = 0;
  const int err = persistent_grid(kernel, threads, smem, (rows + tr - 1) / tr, &grid);
  if (err) return err;
  kernel<<<grid, threads, smem, stream>>>(rpe2, static_cast<const float*>(nb.table), nb.idx,
                                          f_in, consts, out, rows, K, F, nb.n, nb.s);
  return 0;
}

// K in {8, 16, 32} takes one chunk of K; larger powers of two chunks of 32.
template <int H, bool RES>
int launch_pool2_k(const float* rpe2, Neighbours nb, const float* f_in, const float* consts,
                   float* out, int rows, int K, int F, cudaStream_t s) {
  switch (K) {
    case 8:
      return launch_pool2_tiles<H, 8, RES>(rpe2, nb, f_in, consts, out, rows, K, F, s);
    case 16:
      return launch_pool2_tiles<H, 16, RES>(rpe2, nb, f_in, consts, out, rows, K, F, s);
    default:
      if (K < 32 || K % 32) return static_cast<int>(cudaErrorInvalidValue);
      return launch_pool2_tiles<H, 32, RES>(rpe2, nb, f_in, consts, out, rows, K, F, s);
  }
}

// One launch of lfa_pool2_mma_kernel<H, K, RES, TR>: a persistent grid of
// pool2_warps(H, RES, TR)-warp blocks.
template <int H, int K, bool RES, int TR>
int launch_pool2_mma_tiles(const void* rpe2, Neighbours nb, const void* f_in,
                           const float* consts, void* out, int rows, int F,
                           cudaStream_t stream) {
  constexpr int W = pool2_warps(H, RES, TR);
  const auto kernel = lfa_pool2_mma_kernel<H, K, RES, TR>;
  const size_t smem = Pool2Layout(H, K, RES, (F + 15) & ~15, TR).bytes(W);
  // blocks: one a tile with the residual, else one a row a warp
  const int n_tiles = RES ? (rows + TR - 1) / TR : (rows + W - 1) / W;
  int grid = 0;
  const int err = persistent_grid(kernel, 32 * W, smem, n_tiles, &grid);
  if (err) return err;
  kernel<<<grid, 32 * W, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(rpe2), static_cast<const __nv_bfloat16*>(nb.table),
      nb.idx, static_cast<const __nv_bfloat16*>(f_in), consts,
      static_cast<__nv_bfloat16*>(out), rows, F, nb.n, nb.s);
  return 0;
}

// The residual's tile: BF_TILE_ROWS_H8 rows at h = 8; at h = 32
// BF_TILE_ROWS_H32 where a block of as many warps fits the card's shared
// memory, else 8 (one n-tile).
template <int H, int K, bool RES>
int launch_pool2_mma(const void* rpe2, Neighbours nb, const void* f_in, const float* consts,
                     void* out, int rows, int F, cudaStream_t stream) {
  if constexpr (RES && H == 8) {
    return launch_pool2_mma_tiles<H, K, RES, BF_TILE_ROWS_H8>(rpe2, nb, f_in, consts, out, rows,
                                                             F, stream);
  }
  if constexpr (RES && H == 32) {
    constexpr int TR = BF_TILE_ROWS_H32;
    int device = 0, optin = 0;
    int err = cudaGetDevice(&device);
    if (!err) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err) return err;
    if (Pool2Layout(H, K, RES, (F + 15) & ~15, TR).bytes(TR) <= static_cast<size_t>(optin)) {
      return launch_pool2_mma_tiles<H, K, RES, TR>(rpe2, nb, f_in, consts, out, rows, F, stream);
    }
  }
  return launch_pool2_mma_tiles<H, K, RES, 8>(rpe2, nb, f_in, consts, out, rows, F, stream);
}

// K as launch_round1_mma_k
template <int H, bool RES>
int launch_pool2_mma_k(const void* rpe2, Neighbours nb, const void* f_in, const float* consts,
                       void* out, int rows, int K, int F, cudaStream_t s) {
  switch (K) {
    case 8:
      return launch_pool2_mma<H, 8, RES>(rpe2, nb, f_in, consts, out, rows, F, s);
    case 16:
      return launch_pool2_mma<H, 16, RES>(rpe2, nb, f_in, consts, out, rows, F, s);
    case 32:
      return launch_pool2_mma<H, 32, RES>(rpe2, nb, f_in, consts, out, rows, F, s);
    case 64:
      if constexpr (H == 8) return launch_pool2_mma<H, 64, RES>(rpe2, nb, f_in, consts, out, rows, F, s);
      break;
    case 128:
      if constexpr (H == 8) return launch_pool2_mma<H, 128, RES>(rpe2, nb, f_in, consts, out, rows, F, s);
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool RES, bool BF16>
int launch_pool2(const void* rpe2, Neighbours nb, const void* f_in,
                 const float* consts, void* out, int rows, int K, int h,
                 int F, void* stream) {
  if (rows == 0) return 0;
  if (BF16 && F % 2) return static_cast<int>(cudaErrorInvalidValue);
  if (nb.n < 1 || nb.s < 1 || rows % nb.n) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  int err;
  switch (h) {
    case 8:
      err = BF16 ? launch_pool2_mma_k<8, RES>(rpe2, nb, f_in, consts, out, rows, K, F, s)
                 : launch_pool2_k<8, RES>(f(rpe2), nb, f(f_in), consts,
                                          static_cast<float*>(out), rows, K, F, s);
      break;
    case 32:
      err = BF16 ? launch_pool2_mma_k<32, RES>(rpe2, nb, f_in, consts, out, rows, K, F, s)
                 : launch_pool2_k<32, RES>(f(rpe2), nb, f(f_in), consts,
                                           static_cast<float*>(out), rows, K, F, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table (B·s, 2h) the rows the neighbours index, nbr (rows, K) int32 indices
// into each cloud's s table rows (n query rows a cloud, rows = B·n), d2
// (rows, K), center (rows, h), consts as laid out in round1_consts; pooled
// (rows, h) and rpe2 (rows, K, h) out. h in {8, 32}; K in {8, 16} or a
// multiple of 32.
extern "C" int r3d_lfa_round1(const float* table, const int* nbr, const float* d2,
                              const float* center, const float* consts,
                              float* pooled, float* rpe2, int rows, int K,
                              int h, int n, int s, void* stream) {
  return launch_round1<false>({table, nbr, n, s}, d2, center, consts, pooled, rpe2, rows, K, h,
                              stream);
}

// The bfloat16 form: table, pooled and rpe2 bfloat16; d2, center and
// consts (its matrices rounded to bfloat16) float32.
extern "C" int r3d_lfa_round1_bf16(const __nv_bfloat16* table, const int* nbr, const float* d2,
                                   const float* center, const float* consts,
                                   __nv_bfloat16* pooled, __nv_bfloat16* rpe2, int rows,
                                   int K, int h, int n, int s, void* stream) {
  return launch_round1<true>({table, nbr, n, s}, d2, center, consts, pooled, rpe2, rows, K, h,
                             stream);
}

// rpe2 (rows, K, h), table (B·s, h) round 1's pooled rows, nbr (rows, K)
// int32 indices into each cloud's s table rows (n query rows a cloud), f_in
// (rows, F), consts = the head of pool2_head_consts | Wm (2h x 4h) | Wsh
// (F x 4h) | off (4h); out (rows, 4h). h in {8, 32}; K in {8, 16} or a
// multiple of 32.
extern "C" int r3d_lfa_pool2_res(const float* rpe2, const float* table, const int* nbr,
                                 const float* f_in, const float* consts,
                                 float* out, int rows, int K, int h, int F, int n, int s,
                                 void* stream) {
  return launch_pool2<true, false>(rpe2, {table, nbr, n, s}, f_in, consts, out, rows, K, h, F,
                                   stream);
}

// The bfloat16 form: rpe2, table, f_in (F even) and out bfloat16; consts
// float32, its matrices rounded to bfloat16.
extern "C" int r3d_lfa_pool2_res_bf16(const __nv_bfloat16* rpe2, const __nv_bfloat16* table,
                                      const int* nbr, const __nv_bfloat16* f_in,
                                      const float* consts, __nv_bfloat16* out, int rows, int K,
                                      int h, int F, int n, int s, void* stream) {
  return launch_pool2<true, true>(rpe2, {table, nbr, n, s}, f_in, consts, out, rows, K, h, F,
                                  stream);
}

// rpe2 (rows, K, h), table and nbr as r3d_lfa_pool2_res, consts as laid out
// in pool2_head_consts; out (rows, 2h). h in {8, 32}.
extern "C" int r3d_lfa_pool2(const float* rpe2, const float* table, const int* nbr,
                             const float* consts, float* out, int rows, int K,
                             int h, int n, int s, void* stream) {
  return launch_pool2<false, false>(rpe2, {table, nbr, n, s}, nullptr, consts, out, rows, K, h,
                                    0, stream);
}

// The bfloat16 form of r3d_lfa_pool2.
extern "C" int r3d_lfa_pool2_bf16(const __nv_bfloat16* rpe2, const __nv_bfloat16* table,
                                  const int* nbr, const float* consts, __nv_bfloat16* out,
                                  int rows, int K, int h, int n, int s, void* stream) {
  return launch_pool2<false, true>(rpe2, {table, nbr, n, s}, nullptr, consts, out, rows, K, h,
                                   0, stream);
}
