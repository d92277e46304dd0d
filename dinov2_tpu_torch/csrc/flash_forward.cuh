// The forward attention tile loop on Hopper, shared by K4 (flash_attention.cu)
// and, on the head views of a (B, T, 3D) qkv slab, by K3 and K2
// (slab_attention.cu), K1 (slab_layer.cu) and K8 (quant_layer.cu) through
// half_layer.cuh: one kernel behind all of them,
//
//     out[b, t, h, :] = sum_k softmax_k(scale * q[b, t, h] . k[b, k, h]) v[b, k, h]
//
// for bf16 q, k, v of head_dim 64 read through three base pointers that share
// a batch, a token and a head stride, and a contiguous (B, T, H, 64) bf16
// output. The design, the numerics and what ptxas asks of the loop are in
// flash_attention.cu's note; launch_forward_by_shape is the one way in.

#pragma once

#include "wgmma_tiles.cuh"

namespace dinov2 {
namespace {

constexpr int kForwardStages = 4;

template <int kWarpgroups>
constexpr int forward_shared_bytes() {
  return (kWarpgroups + 2 * kForwardStages) * kTileBytes + 1024;
}

// One tile of the online softmax on this thread's share of a 64 x 64 score
// accumulator: s holds raw scores of keys k0.. and becomes the unnormalized
// probabilities 2^((s - m) * scale_log2); m_run (of the raw scores) and l_run
// are updated; alpha is the factor the output accumulator owes the new
// maximum. A row lies in the four lanes of a quad (rows g and g + 8).
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2], int k0,
                                             int t, int tig, float scale_log2) {
  if (k0 + kTile > t) {  // the last tile: mask the keys past T
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = k0 + (i >> 2) * 8 + 2 * tig + (i & 1);
      if (key >= t) s[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float neg_m[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m_run[h], mx[h]);  // finite: key k0 < T is never masked
    alpha[h] = fast_exp2((m_run[h] - m_new) * scale_log2);
    m_run[h] = m_new;
    neg_m[h] = -m_new * scale_log2;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = fast_exp2(fmaf(s[i], scale_log2, neg_m[(i >> 1) & 1]));
    rs[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
    rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
    l_run[h] = l_run[h] * alpha[h] + rs[h];
  }
}

template <int kWarpgroups, bool kWithLse>
__global__ void __launch_bounds__(128 * kWarpgroups, kWarpgroups == 1 ? 4 : 2)
    flash_forward_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, long long batch_stride,
                         long long token_stride, long long head_stride, bf16* __restrict__ out,
                         float* __restrict__ lse, int t, int heads, float scale) {
  constexpr int kThreadsN = 128 * kWarpgroups, kQueryRows = kTile * kWarpgroups;
  constexpr int kStageBytes = 2 * kTileBytes;  // a K tile, then a V tile
  extern __shared__ uint8_t shared_raw[];
  const uint32_t q_s = (shared_address(shared_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + kQueryRows * kRowBytes;

  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, wg = threadIdx.x >> 7;
  const int g = lane >> 2, tig = lane & 3;
  const int img = blockIdx.x / heads, head = blockIdx.x % heads;
  const size_t in = static_cast<size_t>(img) * batch_stride +
                    static_cast<size_t>(head) * head_stride;
  const size_t ld = static_cast<size_t>(token_stride);
  q += in, k += in, v += in;
  const int q0 = blockIdx.y * kQueryRows;
  const int tiles = (t + kTile - 1) / kTile;

  // group 0 holds Q and tile 0; groups are committed even when empty, so
  // that tile j is always group j
  load_tile_async<kQueryRows, kThreadsN>(q_s, q, ld, q0, t);
#pragma unroll
  for (int s = 0; s < kForwardStages - 1; ++s) {
    if (s < tiles) {
      load_tile_async<kTile, kThreadsN>(kv_s + s * kStageBytes, k, ld, s * kTile, t);
      load_tile_async<kTile, kThreadsN>(kv_s + s * kStageBytes + kTileBytes, v, ld, s * kTile, t);
    }
    cp_async_commit();
  }

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // of the raw scores
  float l_run[2] = {0.f, 0.f};
  const float scale_log2 = scale * kLog2e;
  const uint32_t q_wg = q_s + wg * kTileBytes;

  // the first tile's scores and probabilities
  cp_async_wait<kForwardStages - 2>();  // this thread's part of Q and tile 0 has landed
  fence_proxy_async();
  __syncthreads();
  float s[32], alpha[2];
  uint32_t p[16];
  wgmma_fence();
  start_product_nt(s, q_wg, kv_s);
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(s);
  softmax_tile(s, m_run, l_run, alpha, 0, t, tig, scale_log2);  // o is 0: no rescale
  round_to_operand(p, s);

  // Tile j: its P.V runs with the next tile's q k^T queued before it, and
  // the next tile's softmax overlaps both on the CUDA cores. The last tile's
  // P.V stands alone after the loop: the loop's body has no branch around a
  // wgmma, which ptxas answers by serializing every wgmma of the loop.
  int stage = 0, fill = kForwardStages - 1;  // the stage of tile j, of tile j + kStages - 1
  for (int j = 0; j + 1 < tiles; ++j) {
    cp_async_wait<kForwardStages - 3>();  // this thread's part of tile j + 1 has landed
    fence_proxy_async();
    __syncthreads();  // everyone's has, and everyone is done with tile j - 1
    if (j + kForwardStages - 1 < tiles) {
      const int r0 = (j + kForwardStages - 1) * kTile;
      load_tile_async<kTile, kThreadsN>(kv_s + fill * kStageBytes, k, ld, r0, t);
      load_tile_async<kTile, kThreadsN>(kv_s + fill * kStageBytes + kTileBytes, v, ld, r0, t);
    }
    cp_async_commit();
    const uint32_t v_s = kv_s + stage * kStageBytes + kTileBytes;
    stage = stage + 1 == kForwardStages ? 0 : stage + 1;
    fill = fill + 1 == kForwardStages ? 0 : fill + 1;

    fence_registers(p);
    fence_registers(o);
    wgmma_fence();
    start_product_nt(s, q_wg, kv_s + stage * kStageBytes);  // the next tile's K
    wgmma_commit();
    start_product_nn(o, p, v_s);  // o += bf16(P) @ V
    wgmma_commit();
    wgmma_wait<1>();  // the next tile's scores
    fence_registers(s);
    softmax_tile(s, m_run, l_run, alpha, (j + 1) * kTile, t, tig, scale_log2);
    wgmma_wait<0>();  // this tile's P.V
    fence_registers(o);
    fence_registers(p);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
    round_to_operand(p, s);
  }
  fence_registers(p);
  fence_registers(o);
  wgmma_fence();
  start_product_nn(o, p, kv_s + stage * kStageBytes + kTileBytes);  // the last tile's P.V
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(o);
  fence_registers(p);

  const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
  const size_t out_ld = static_cast<size_t>(heads) * kHeadDim;
  store_accumulator(out + static_cast<size_t>(img) * t * out_ld + head * kHeadDim, out_ld,
                    q0 + wg * kTile, t, o, inv, warp, g, tig);
  if constexpr (kWithLse) {
    if (tig == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + wg * kTile + warp * 16 + g + 8 * h;
        if (row < t) {
          lse[static_cast<size_t>(blockIdx.x) * t + row] =
              m_run[h] * scale + logf(fmaxf(l_run[h], 1e-30f));
        }
      }
    }
  }
}

// Query rows a block. 128 halves the K/V re-reads from L2 and wins or ties
// wherever the grid fills the card: from two waves of two 128-row blocks an
// SM on (132 SMs). Below that 64-row blocks, three independent ones an SM,
// fill it better. A short ragged T (257 = 2*128 + 1: a third block for one
// row) wastes up to half of a 128-row block's rows, which only a grid of
// several waves wins back: there 128 is taken from four waves on. From the
// times of scripts/tune_flash_tiles.py on an H100 (ms, 64 against 128 rows;
// two runs where two are given): B=8, T=1370, H=16 (1408 blocks of 128)
// 0.2128 / 0.1770; B=8, T=1370, H=12 (1056) 0.1484 / 0.1298; B=1, T=4226,
// H=16 (544) 0.2296 / 0.2309; at T=257 B=8, H=12 (288) 0.0423 / 0.0484; B=16,
// H=12 (576) 0.0643 / 0.0633; B=32, H=12 (1152) 0.0474 / 0.0478 and 0.0808 /
// 0.0475; B=16, H=24 (1152, the ViT-g/14 slab) 0.0721 / 0.0667 and 0.0702 /
// 0.0471; B=64, H=12 (2304) 0.1103 / 0.0899.
// Compiling with -DDINOV2_FORWARD_QUERY_ROWS=64 or =128 takes that variant at
// every shape instead: how the script times one against the other.
inline int forward_query_rows(int b, int t, int heads) {
#ifdef DINOV2_FORWARD_QUERY_ROWS
  static_assert(DINOV2_FORWARD_QUERY_ROWS == 64 || DINOV2_FORWARD_QUERY_ROWS == 128,
                "one or two warpgroups a block");
  return DINOV2_FORWARD_QUERY_ROWS;
#else
  const long long blocks = static_cast<long long>(b) * heads * ((t + 127) / 128);
  const long long enough = t <= 512 ? 4 * 2 * 132 : 2 * 2 * 132;
  return blocks >= enough ? 128 : 64;
#endif
}

template <int kWarpgroups, bool kWithLse>
int launch_forward(const void* q, const void* k, const void* v, void* out, void* lse, int b,
                   int t, int heads, long long batch_stride, long long token_stride,
                   long long head_stride, float scale, void* stream) {
  auto kernel = flash_forward_kernel<kWarpgroups, kWithLse>;
  constexpr int kShared = forward_shared_bytes<kWarpgroups>();
  static SharedMemoryGrant grant;
  const cudaError_t err = grant(kernel, kShared);
  if (err != cudaSuccess) return err;
  constexpr int kRows = kTile * kWarpgroups;
  kernel<<<dim3(b * heads, (t + kRows - 1) / kRows), 128 * kWarpgroups, kShared,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      batch_stride, token_stride, head_stride, static_cast<bf16*>(out),
      static_cast<float*>(lse), t, heads, scale);
  return cudaGetLastError();
}

template <bool kWithLse>
int launch_forward_by_shape(const void* q, const void* k, const void* v, void* out, void* lse,
                            int b, int t, int heads, long long batch_stride,
                            long long token_stride, long long head_stride, float scale,
                            void* stream) {
  if (forward_query_rows(b, t, heads) == 128) {
    return launch_forward<2, kWithLse>(q, k, v, out, lse, b, t, heads, batch_stride,
                                       token_stride, head_stride, scale, stream);
  }
  return launch_forward<1, kWithLse>(q, k, v, out, lse, b, t, heads, batch_stride, token_stride,
                                     head_stride, scale, stream);
}

}  // namespace
}  // namespace dinov2
