// K5 on Hopper: the whole MLP half-layer of a DINOv2 encoder layer,
//
//     out = x + ls2 * (fc2(act(fc1(LN2(x)) + b1)) + b2)
//
// for x (B, T, D) bf16 taken as M = B*T independent rows, w1 (D, 4D) and
// w2 (4D, D) bf16 stored (in, out), LN scale/bias, biases and LayerScale as
// f32 rows, act one of gelu_tanh_f16, gelu_erf, gelu_tanh. The (M, 4D)
// hidden activation never exists in HBM.
//
// Replaces the Pallas TPU kernels dinov2_tpu/ops/fused_attention.py::
// _slab_mlp_kernel (per image) and _slab_mlp_flat_kernel (flattened rows),
// reached through slab_mlp_block. The half-layer is row-independent, so one
// kernel over the flattened rows covers both.
//
// What bounds it on an H100: at the main path's shape (B=64, T=257, D=768,
// DH=3072) one call is 4*M*D*DH = 155 GFLOP over 25 MB of x in, 25 MB out
// and 9.4 MB of weights: operations bind it, ~0.157 ms at 989 TFLOP/s bf16
// (the bytes take ~0.018 ms at 3.35 TB/s).
//
// Design of this first version: one block of 256 threads per 32 rows (514
// blocks at the main shape), one block per SM (the f32 output accumulator,
// 32 x D, lives in registers: 96 a thread at D=768, 128 at D=1024).
//   1. LN2: two-pass f32 statistics, one warp per row, the normalized rows
//      rounded once to bf16 into shared memory (32 x D), made once per block.
//   2. The hidden axis streams through in 64-wide chunks. Per chunk:
//        a. g = act(bf16(h @ w1[:, chunk]) + bf16(b1[chunk])) -> bf16 in
//           shared memory (32 x 64), the D-deep product in 64 x 64 weight
//           tiles;
//        b. acc += g @ w2[chunk, :], again in 64 x 64 weight tiles, g's
//           mma fragments held in registers.
//      All weight tiles, w1's and w2's alike, travel through one ring of
//      kStages shared-memory slots filled by cp.async, so the next tiles
//      load while the current one is multiplied (mma.sync m16n8k16, bf16 in,
//      f32 accumulate, every fragment fetched by one ldmatrix.x4). One
//      __syncthreads per tile. A deeper ring changes nothing: the loads are
//      not what a tile waits for.
//   3. Epilogue, fc2 accumulated in f32 over the whole hidden axis:
//      bf16(acc) + bf16(b2), * bf16(ls2), + x, each step rounded to bf16.
// Every block re-reads both weights from L2 (9.4 MB x 514 blocks = 4.8 GB a
// call at the main shape), which is what a 32-row tile costs; 64-row tiles
// on wgmma with the accumulator split across a cluster, and TMA loads, are
// left for later work.
//
// Numerics follow the JAX package's cast points (fused_attention.py:859-883):
// f32 LN statistics, LN affine in f32 then one bf16 cast; fc1 accumulated in
// f32, cast to bf16 before the bias add, the activation applied to that bf16
// value in f32 and rounded to bf16 (gelu_tanh_f16 through f16 on both sides,
// activation.cuh, shared with K7); fc2 accumulated in f32 over all of DH.
//
// Shared memory is dynamic (89 KB at D=768, 105 KB at D=1024) and needs the
// opt-in attribute, set before each launch. The entry point returns
// cudaGetLastError() after its launch.

#include "activation.cuh"
#include "gemm_core.cuh"

namespace {

using namespace dinov2;

constexpr int kMlpRows = 32;      // rows of x per block
constexpr int kMlpThreads = 256;  // eight warps: 2 (16-row halves) x 4 (16-column quarters of a tile)
constexpr int kStages = 4;        // weight-tile slots in the cp.async ring

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// four 8x8 b16 matrices from shared memory, one 16-byte row address a lane
// (lanes 8j..8j+7 give matrix j's rows); register j holds matrix j's
// elements (lane/4, 2*(lane%4)) and the next, or with .trans the elements
// (2*(lane%4), lane/4) and the one below: an mma A or B fragment
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

template <int D>
constexpr size_t mlp_shared_bytes() {
  return sizeof(bf16) * (kMlpRows * (D + 8) + kMlpRows * kLds + kStages * kTile * kLds);
}

// One block: rows row0..row0+31 of out. Weight tile i of the block's stream
// (i = 0 .. 2*(D/64)*(DH/64) - 1): for hidden chunk c = i / (2*KT), the KT
// tiles of w1[:, 64c:64c+64] top to bottom, then the KT tiles of
// w2[64c:64c+64, :] left to right, each 64 x 64, staged k-major (ws[k][n]).
template <int D>
__global__ void __launch_bounds__(kMlpThreads, 1)
    slab_mlp_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_scale,
                    const float* __restrict__ ln_bias, const bf16* __restrict__ w1,
                    const float* __restrict__ b1, const bf16* __restrict__ w2,
                    const float* __restrict__ b2, const float* __restrict__ ls2,
                    bf16* __restrict__ out, int m, int act, float eps) {
  constexpr int kDH = 4 * D;
  constexpr int kKT = D / kTile;        // weight tiles per phase of a chunk
  constexpr int kChunks = kDH / kTile;  // hidden chunks
  constexpr int kTiles = 2 * kKT * kChunks;
  constexpr int kHLds = D + 8;  // row stride of hs: conflict-free fragment loads, as kLds

  extern __shared__ __align__(16) unsigned char smem[];
  bf16(*hs)[kHLds] = reinterpret_cast<bf16(*)[kHLds]>(smem);
  bf16(*gs)[kLds] = reinterpret_cast<bf16(*)[kLds]>(hs + kMlpRows);
  bf16(*ring)[kTile][kLds] = reinterpret_cast<bf16(*)[kTile][kLds]>(gs + kMlpRows);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int warp_m = warp & 1, warp_n = warp >> 1;
  const int row0 = blockIdx.x * kMlpRows;

  // copy weight tile i into its ring slot: 512 pieces of 16 bytes, two a thread
  auto fetch_tile = [&](int i) {
    if (i < kTiles) {
      const int c = i / (2 * kKT), j = i % (2 * kKT);
      const bf16* src;
      size_t ld;
      if (j < kKT) {
        src = w1 + static_cast<size_t>(j) * kTile * kDH + c * kTile;
        ld = kDH;
      } else {
        src = w2 + static_cast<size_t>(c) * kTile * D + (j - kKT) * kTile;
        ld = D;
      }
      bf16(*slot)[kLds] = ring[i % kStages];
#pragma unroll
      for (int p = tid; p < kTile * kTile / 8; p += kMlpThreads) {
        const int r = p >> 3, col = (p & 7) * 8;
        cp_async_16(&slot[r][col], src + r * ld + col);
      }
    }
    cp_async_commit();  // one group per tile index, empty past the end
  };

  for (int s = 0; s < kStages - 1; ++s) fetch_tile(s);

  // LN2 of the block's rows, one warp per row: two-pass f32 statistics, the
  // affine in f32 without fused multiply-add, one bf16 cast. Rows past M
  // are zero and never written back.
  for (int r = warp; r < kMlpRows; r += kMlpThreads / 32) {
    const int row = row0 + r;
    if (row < m) {
      const bf16* src = x + static_cast<size_t>(row) * D;
      float s = 0.f;
      for (int c = lane; c < D; c += 32) s += __bfloat162float(src[c]);
      const float mu = warp_sum(s) / static_cast<float>(D);
      float v = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float dlt = __bfloat162float(src[c]) - mu;
        v += dlt * dlt;
      }
      const float rstd = 1.f / sqrtf(warp_sum(v) / static_cast<float>(D) + eps);
      for (int c = lane; c < D; c += 32) {
        const float h = __fmul_rn(__bfloat162float(src[c]) - mu, rstd);
        hs[r][c] = __float2bfloat16(__fadd_rn(__fmul_rn(h, ln_scale[c]), ln_bias[c]));
      }
    } else {
      for (int c = lane; c < D; c += 32) hs[r][c] = __float2bfloat16(0.f);
    }
  }

  // the fc2 accumulator: for each 64-column tile n of out, this warp's 16
  // rows x 16 columns as two mma n-tiles
  float acc[kKT][2][4];
#pragma unroll
  for (int n = 0; n < kKT; ++n)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[n][ni][j] = 0.f;

  int tile = 0;  // index of the weight tile consumed next
  // tile `tile` has landed and every warp is done with tile - 1, whose slot
  // takes the copy of tile + kStages - 1; returns the slot to read
  auto next_tile = [&]() -> bf16(*)[kLds] {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    fetch_tile(tile + kStages - 1);
    bf16(*slot)[kLds] = ring[tile % kStages];
    ++tile;
    return slot;
  };

  const int ar = warp_m * 16 + g;  // this thread's rows ar and ar + 8 of the block
  // ldmatrix row addresses of this lane: matrix lane/8, row lane%8 of it.
  // A (hs, gs; rows x k): matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7),
  // (rows 0-7, k 8-15), (rows 8-15, k 8-15) of the warp's 16 rows.
  // B (a weight tile, k x n): (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7,
  // n 8-15), (k 8-15, n 8-15) of the warp's 16 columns, transposed on load.
  const int lm_row = (lane & 7) + 8 * ((lane >> 3) & 1), lm_col = 8 * (lane >> 4);
  const int a_row = warp_m * 16 + lm_row;
  const int b_col = warp_n * 16 + lm_col;

  for (int c = 0; c < kChunks; ++c) {
    // a. a1 = h @ w1[:, chunk]: 16 rows x 16 columns per warp
    float a1[2][4];
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) a1[ni][j] = 0.f;
    for (int kt = 0; kt < kKT; ++kt) {
      bf16(*ws)[kLds] = next_tile();  // the first one also orders hs before its readers
#pragma unroll
      for (int kk = 0; kk < kTile; kk += 16) {
        uint32_t af[4], bf[4];
        ldmatrix_x4(af, &hs[a_row][kt * kTile + kk + lm_col]);
        ldmatrix_x4_trans(bf, &ws[kk + lm_row][b_col]);
        mma_16816(a1[0], af, bf[0], bf[1]);
        mma_16816(a1[1], af, bf[2], bf[3]);
      }
    }
    // g = act(bf16(a1) + bf16(b1)), rounded to bf16; the previous chunk's g
    // was read into registers before the kKT tiles above went by
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      const int col = warp_n * 16 + ni * 8 + 2 * tig;
      const float bias0 = round_bf16(b1[c * kTile + col]);
      const float bias1 = round_bf16(b1[c * kTile + col + 1]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float y0 = activate(round_bf16(round_bf16(a1[ni][2 * half]) + bias0), act);
        const float y1 = activate(round_bf16(round_bf16(a1[ni][2 * half + 1]) + bias1), act);
        *reinterpret_cast<uint32_t*>(&gs[ar + 8 * half][col]) = pack_floats(y0, y1);
      }
    }

    // b. acc += g @ w2[chunk, :]
    uint32_t gf[4][4];
#pragma unroll
    for (int n = 0; n < kKT; ++n) {
      bf16(*ws)[kLds] = next_tile();
      if (n == 0) {  // gs is complete after the barrier in next_tile
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) ldmatrix_x4(gf[ks], &gs[a_row][16 * ks + lm_col]);
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, &ws[16 * ks + lm_row][b_col]);
        mma_16816(acc[n][0], gf[ks], bf[0], bf[1]);
        mma_16816(acc[n][1], gf[ks], bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();  // only empty groups are left

  // out = x + bf16(bf16(bf16(acc) + bf16(b2)) * bf16(ls2))
  const ResidualEpilogue ep{b2, ls2, x, out, D};
#pragma unroll
  for (int n = 0; n < kKT; ++n) {
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      const int col = n * kTile + warp_n * 16 + ni * 8 + 2 * tig;
      const BiasPair bias = ep.column(col);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + ar + 8 * half;
        if (row < m) ep(row, col, bias, acc[n][ni][2 * half], acc[n][ni][2 * half + 1]);
      }
    }
  }
}

template <int D>
cudaError_t launch_slab_mlp(const bf16* x, const float* ln_scale, const float* ln_bias,
                            const bf16* w1, const float* b1, const bf16* w2, const float* b2,
                            const float* ls2, bf16* out, int m, int act, float eps,
                            cudaStream_t s) {
  constexpr size_t bytes = mlp_shared_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(slab_mlp_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  slab_mlp_kernel<D><<<(m + kMlpRows - 1) / kMlpRows, kMlpThreads, bytes, s>>>(
      x, ln_scale, ln_bias, w1, b1, w2, b2, ls2, out, m, act, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The whole MLP half-layer, one launch on `stream`: x and out (M, D) bf16,
// w1 (D, DH) and w2 (DH, D) bf16, the rest f32 rows; activation 1
// gelu_tanh_f16, 2 gelu_erf, 3 gelu_tanh. Requires D in {384, 768, 1024} and
// DH == 4 * D (anything else returns cudaErrorInvalidValue), 16-byte aligned
// pointers, and the tensors' device current on the calling thread.
int dinov2_slab_mlp_bf16(const void* x, const void* ln_scale, const void* ln_bias,
                         const void* w1, const void* b1, const void* w2, const void* b2,
                         const void* ls2, void* out, int m, int d, int dh, int activation,
                         float eps, void* stream) {
  if (dh != 4 * d || m <= 0) return cudaErrorInvalidValue;
  decltype(&launch_slab_mlp<768>) launch;
  switch (d) {
    case 384:
      launch = launch_slab_mlp<384>;
      break;
    case 768:
      launch = launch_slab_mlp<768>;
      break;
    case 1024:
      launch = launch_slab_mlp<1024>;
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return launch(static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),
                static_cast<const float*>(ln_bias), static_cast<const bf16*>(w1),
                static_cast<const float*>(b1), static_cast<const bf16*>(w2),
                static_cast<const float*>(b2), static_cast<const float*>(ls2),
                static_cast<bf16*>(out), m, activation, eps, static_cast<cudaStream_t>(stream));
}

const char* dinov2_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
