// The port's dense bf16 GEMM on Hopper: K1's QKV and proj launches
// (slab_layer.cu, through half_layer.cuh), K2's proj (slab_attention.cu),
// K5's fc1 and fc2 (slab_mlp.cu), K7's product on its dequantized weight
// (quant_matmul.cu) and K8's QKV and proj on its two (quant_layer.cu); and
// the layer norm in front of K1's, K5's and K8's,
//
//     h (M, K) = bf16(LN(x))                       layer_norm_rows_kernel
//     out (M, N) = ep(A @ W)                       wgmma_gemm_kernel
//
// for A (M, K) bf16 row-major and W bf16 either (K, N) row-major, the (in,
// out) layout of the dense weights, or (N, K) row-major (kKMajorWeight), the
// (out, in) layout of a dequantized QuantLinear; with gemm_core.cuh's
// epilogues (BiasEpilogue, ResidualEpilogue, ActEpilogue) and their rounding
// points. K % 64 == 0, any M >= 1; N % 64 == 0, or any N >= 1 for an
// (N, K) weight with ActEpilogue, which masks its columns.
//
// What bounds it on an H100: at K1's shape (M = 64*257 = 16448, K = 768) the
// QKV product is 58.2 GFLOP over 25 MB in, 76 MB out and 3.5 MB of weight,
// proj 19.4 GFLOP over 50 MB in and 25 MB out: operations bind both (0.059
// and 0.020 ms at 989 TFLOP/s bf16 against 0.031 and 0.024 ms for the bytes).
//
// Design. A block owns a 128 x kGemmCols output tile (256 columns: four
// warpgroups, two down and two across, 64 rows x 128 columns each): grid
// (ceil(N / kGemmCols), ceil(M / 128)), the column tiles of a row tile side
// by side so that they find the A rows in L2. 64-deep k-steps go through a
// ring of kGemmStages stages filled by cp.async, two steps ahead of the
// arithmetic; one __syncthreads a step hands a stage over. A stage holds the
// A tile as two 64-row 128-byte-swizzled tiles (wgmma_tiles.cuh), the k-major
// operand, and the 64 x kGemmCols weight tile as one such tile of 64 k-rows
// for each 64 columns. The weight is the mn-major B operand through the
// descriptor's transpose bit (as V is in the attention kernels): no
// transposed copy of W exists anywhere. A warpgroup's B operand is two of
// those 64-column swizzle atoms, and its descriptor's leading byte offset is
// the distance between them (8 KB), which an operand wider than one atom
// needs. An (N, K) weight is staged as the A tile is, kGemmCols k-major rows
// of 128 bytes (rows past N zero-filled), and read without the transpose bit
// (as K is in the attention kernels): a warpgroup's 128 rows are 16 groups
// of eight, 1024 bytes apart. One k-step is four wgmma m64n128k16 a
// warpgroup (m64n64k16 with both operands in shared memory would read 4 KB
// for 32 tensor clocks, the whole shared-memory rate). A step's products are committed and left
// running while the next step lands; a step waits only for the products of
// the step before it, whose stage the step after refills. No branch goes
// around a wgmma and the accumulators are touched by nothing else inside the
// loop, so ptxas keeps the products asynchronous (else it says C7510..C7515
// under -Xptxas -v and waits after each).
//
// Layer norm is a kernel of its own in front of the QKV product: a warp a
// row, f32 statistics in two passes, (x - mu) * rstd * scale + bias in f32
// without fused multiply-add and one bf16 cast (the JAX kernels' cast
// points), written once to a (M, K) bf16 buffer the caller gives.
// Normalizing the A tile in shared memory as it landed (statistics from a
// prologue kernel, each thread on the pieces its own cp.async brought in)
// gave the same bits but redid the work in each of the N / kGemmCols column
// tiles of a row tile, on the scheduler slots the products need:
// 0.182 + 0.013 ms against 0.123 + 0.022 ms at M = 16448, K = 768, N = 2304
// on an H100, for 50 MB more through L2 and HBM.
//
// Epilogue: a warp rounds its 16 x 128 piece of the tile with the bias (and
// LayerScale) into a padded strip of the ring, which every warpgroup is done
// with by then, and writes it out as whole 16-byte pieces of rows, 256
// contiguous bytes a row (the residual is read the same way): the
// accumulator's own layout would write 4 bytes a thread, 16 a row.
//
// The ragged edges are masked, never padded in memory: rows past M are
// zero-filled in shared memory and not written; 64-column atoms past N
// (N = 64 * odd) are zero-filled and not written, and inside the last atom
// an (N, K) weight's rows past N are zero and the epilogue drops their
// columns.

#pragma once

#include "gemm_core.cuh"
#include "wgmma_tiles.cuh"

namespace dinov2 {
namespace {

// Compiling with -DDINOV2_GEMM_COLUMNS=128 (two warpgroups, two blocks an
// SM) or =256 and -DDINOV2_GEMM_STAGES=3 or =4 takes another block shape and
// ring depth: how scripts/tune_flash_tiles.py times one against the other.
#ifndef DINOV2_GEMM_COLUMNS
#define DINOV2_GEMM_COLUMNS 256
#endif
#ifndef DINOV2_GEMM_STAGES
#define DINOV2_GEMM_STAGES (DINOV2_GEMM_COLUMNS == 256 ? 4 : 3)
#endif
constexpr int kGemmRows = 128;                  // output rows a block: 64 a warpgroup
constexpr int kGemmCols = DINOV2_GEMM_COLUMNS;  // output columns a block: 128 a warpgroup
constexpr int kGemmThreads = 128 * (kGemmRows / kTile) * (kGemmCols / 128);
constexpr int kGemmStages = DINOV2_GEMM_STAGES;
constexpr int kGemmStageBytes = (kGemmRows + kGemmCols) * kRowBytes;   // A, then W
constexpr int kGemmSharedBytes = kGemmStages * kGemmStageBytes + 1024;  // alignment slack
constexpr int kGemmBlocksPerSm = 227 * 1024 / kGemmSharedBytes;
constexpr int kLayerNormThreads = 256;  // layer_norm_rows_kernel: eight rows a block
// a warp's strip of the epilogue: 16 rows of 128 bf16, 16 bytes of padding a
// row so that the accumulator layout's 4-byte writes hit 32 banks
constexpr int kStripRowBytes = 128 * 2 + 16;
constexpr int kStripBytes = 16 * kStripRowBytes;
static_assert(kGemmCols == 128 || kGemmCols == 256, "one or two warpgroups across");
static_assert(kGemmStages >= 3 && kGemmBlocksPerSm >= 1, "a ring with a stage to fill");
static_assert(kGemmThreads / 32 * kStripBytes <= kGemmStages * kGemmStageBytes,
              "the strips fit in the ring");

// d (64 x 128 of this warpgroup) += A . B for one k16 step: A (64 x 16)
// k-major and B (16 x 128) mn-major (kTransposeB) or k-major, both in shared
// memory. d is float[64]: element 4*nt + j is row 16*w + g + 8*(j >> 1),
// column 8*nt + 2*tig + (j & 1) (the layout of wgmma_tiles.cuh, 16 n-tiles
// wide).
template <bool kTransposeB>
__device__ __forceinline__ void wgmma_64x128x16_ss(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " DINOV2_ACC64_LIST
      ", %64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : DINOV2_ACC64(d)
      : "l"(a), "l"(b), "r"(1), "n"(kTransposeB ? 1 : 0));
}

// The descriptor of an mn-major operand made of 64-column swizzled tiles
// kTileBytes apart: tile_descriptor with the leading byte offset set to that
// distance.
__device__ __forceinline__ uint64_t wide_tile_descriptor(uint32_t address) {
  return static_cast<uint64_t>((address & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(kTileBytes >> 4) << 16) | (64ull << 32) | (1ull << 62);
}

// h[row] = bf16(LN(x[row])) for x, h (M, K) bf16, one warp a row: f32
// statistics in two passes (lanes' sums, then a warp sum), then 16-byte
// pieces of the row normalized and written.
__global__ void __launch_bounds__(kLayerNormThreads)
    layer_norm_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_scale,
                           const float* __restrict__ ln_bias, bf16* __restrict__ h, int m, int k,
                           float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kLayerNormThreads / 32) + (threadIdx.x >> 5);
  if (row >= m) return;
  const bf16* src = x + static_cast<size_t>(row) * k;
  float s = 0.f;
  for (int c = lane; c < k; c += 32) s += __bfloat162float(src[c]);
  const float mu = warp_sum(s) / static_cast<float>(k);
  float v = 0.f;
  for (int c = lane; c < k; c += 32) {
    const float dlt = __bfloat162float(src[c]) - mu;
    v += dlt * dlt;
  }
  const float rstd = 1.f / sqrtf(warp_sum(v) / static_cast<float>(k) + eps);
  bf16* dst = h + static_cast<size_t>(row) * k;
  for (int c = lane * 8; c < k; c += 32 * 8) {
    uint4 piece = *reinterpret_cast<const uint4*>(src + c);
    bf16* e = reinterpret_cast<bf16*>(&piece);
    float sc[8], bi[8];
    *reinterpret_cast<float4*>(sc) = __ldg(reinterpret_cast<const float4*>(ln_scale + c));
    *reinterpret_cast<float4*>(sc + 4) = __ldg(reinterpret_cast<const float4*>(ln_scale + c + 4));
    *reinterpret_cast<float4*>(bi) = __ldg(reinterpret_cast<const float4*>(ln_bias + c));
    *reinterpret_cast<float4*>(bi + 4) = __ldg(reinterpret_cast<const float4*>(ln_bias + c + 4));
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      // (x - mu) * rstd * scale + bias in f32, no fused multiply-add, then
      // one bf16 cast
      const float t = __fmul_rn(__bfloat162float(e[q]) - mu, rstd);
      e[q] = __float2bfloat16(__fadd_rn(__fmul_rn(t, sc[q]), bi[q]));
    }
    *reinterpret_cast<uint4*>(dst + c) = piece;
  }
}

// One block's 128 x kGemmCols output tile of ep(A @ W), W (K, N) or, with
// kKMajorWeight, (N, K); see the note above.
template <class Epilogue, bool kKMajorWeight = false>
__global__ void __launch_bounds__(kGemmThreads, kGemmBlocksPerSm)
    wgmma_gemm_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w, Epilogue ep, int m,
                      int n, int k) {
  constexpr int kAtoms = kGemmCols / kTile;  // 64-column swizzle atoms of a weight tile
  extern __shared__ uint8_t shared_raw[];
  const uint32_t ring = (shared_address(shared_raw) + 1023u) & ~1023u;
  uint8_t* ring_ptr = shared_raw + (ring - shared_address(shared_raw));

  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, wg = threadIdx.x >> 7;
  const int wg_row = wg & 1, wg_col = wg >> 1;  // this warpgroup's 64 rows, 128 columns
  const int g = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.y * kGemmRows, col0 = blockIdx.x * kGemmCols;
  const int atoms = min(kAtoms, (n - col0 + kTile - 1) / kTile);  // those that N reaches
  const int steps = k / kTile;
  const size_t ld_w = static_cast<size_t>(kKMajorWeight ? k : n);

  // step j's A rows and its W rows, the atoms (rows) past N zero-filled
  auto load_step = [&](int stage, int j) {
    const uint32_t a_s = ring + stage * kGemmStageBytes, w_s = a_s + kGemmRows * kRowBytes;
    load_tile_async<kGemmRows, kGemmThreads>(a_s, a + j * kTile, static_cast<size_t>(k), row0, m);
    if constexpr (kKMajorWeight) {
      load_tile_async<kGemmCols, kGemmThreads>(w_s, w + j * kTile, ld_w, col0, n);
    } else {
      const bf16* w_j = w + static_cast<size_t>(j) * kTile * ld_w + col0;
#pragma unroll
      for (int atom = 0; atom < kAtoms; ++atom) {
        const bool has = atom < atoms;
        load_tile_async<kTile, kGemmThreads>(w_s + atom * kTileBytes,
                                             has ? w_j + atom * kTile : w_j, ld_w, 0,
                                             has ? kTile : 0);
      }
    }
  };

  // groups are committed even when empty, so that step j is always group j
#pragma unroll
  for (int s = 0; s < kGemmStages - 2; ++s) {
    if (s < steps) load_step(s, s);
    cp_async_commit();
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  int stage = 0, fill = kGemmStages - 2;  // the stage of step j, of step j + kGemmStages - 2
  for (int j = 0; j < steps; ++j) {
    cp_async_wait<kGemmStages - 3>();  // this thread's part of step j has landed
    const uint32_t a_s = ring + stage * kGemmStageBytes;
    fence_proxy_async();
    // everyone's part of step j has landed, and every warpgroup has waited
    // for its products of step j - 2, whose stage is the one to fill
    __syncthreads();
    if (j + kGemmStages - 2 < steps) load_step(fill, j + kGemmStages - 2);
    cp_async_commit();

    // this warpgroup's 128 weight columns: two atoms, or 128 k-major rows,
    // 16 KB in either case; a k16 step is 16 rows (2048 bytes) or 32 bytes on
    const uint32_t w_s = a_s + kGemmRows * kRowBytes + wg_col * 2 * kTileBytes;
    const uint64_t da = tile_descriptor(a_s + wg_row * kTileBytes);
    const uint64_t db = kKMajorWeight ? tile_descriptor(w_s) : wide_tile_descriptor(w_s);
    fence_registers(acc);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      wgmma_64x128x16_ss<!kKMajorWeight>(acc, da + 2 * kc, db + (kKMajorWeight ? 2 : 128) * kc);
    }
    wgmma_commit();
    wgmma_wait<1>();  // step j - 1's products
    stage = stage + 1 == kGemmStages ? 0 : stage + 1;
    fill = fill + 1 == kGemmStages ? 0 : fill + 1;
  }
  wgmma_wait<0>();
  fence_registers(acc);
  __syncthreads();  // every warpgroup is done with the ring: the strips go there

  // this warp's 16 rows x 128 columns: rounded into its strip in the
  // accumulator's layout, then written out 16 bytes a lane, two rows a pass
  uint8_t* strip = ring_ptr + (threadIdx.x >> 5) * kStripBytes;
  const int wg_col0 = col0 + wg_col * 128;
  const int wg_atoms = atoms - wg_col * 2;  // 64-column atoms of this warpgroup that N has
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    if (nt / 8 < wg_atoms) {
      const int c = wg_col0 + nt * 8 + 2 * tig;
      const auto col = ep.column(c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<uint32_t*>(strip + (g + 8 * h) * kStripRowBytes + (nt * 8 + 2 * tig) * 2) =
            ep.pair(c, col, acc[4 * nt + 2 * h], acc[4 * nt + 2 * h + 1]);
      }
    }
  }
  __syncwarp();
  const int strip_row0 = row0 + wg_row * kTile + warp * 16;
  const int piece = lane & 15;  // 8 columns
#pragma unroll
  for (int pass = 0; pass < 8; ++pass) {
    const int r = 2 * pass + (lane >> 4);
    if (strip_row0 + r < m && piece / 8 < wg_atoms) {
      ep.store8(strip_row0 + r, wg_col0 + piece * 8,
                *reinterpret_cast<const uint4*>(strip + r * kStripRowBytes + piece * 16));
    }
  }
}

// h (M, K) = bf16(LN(x)) on stream s.
inline cudaError_t launch_layer_norm_rows(const bf16* x, const float* ln_scale,
                                          const float* ln_bias, bf16* h, int m, int k,
                                          float eps, cudaStream_t s) {
  constexpr int kRowsPerBlock = kLayerNormThreads / 32;
  layer_norm_rows_kernel<<<(m + kRowsPerBlock - 1) / kRowsPerBlock, kLayerNormThreads, 0, s>>>(
      x, ln_scale, ln_bias, h, m, k, eps);
  return cudaGetLastError();
}

// ep(A @ W) on stream s, W (K, N) or, with kKMajorWeight, (N, K).
template <bool kKMajorWeight = false, class Epilogue>
cudaError_t launch_wgmma_gemm(const bf16* a, const bf16* w, Epilogue ep, int m, int n, int k,
                              cudaStream_t s) {
  auto kernel = wgmma_gemm_kernel<Epilogue, kKMajorWeight>;
  static SharedMemoryGrant grant;
  const cudaError_t err = grant(kernel, kGemmSharedBytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((n + kGemmCols - 1) / kGemmCols, (m + kGemmRows - 1) / kGemmRows), kGemmThreads,
           kGemmSharedBytes, s>>>(a, w, ep, m, n, k);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dinov2
