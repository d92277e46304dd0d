// K4 on Hopper: flash attention, the attention core of feature mode and the
// training forward,
//
//     out[b, t, h, :] = sum_k softmax_k(scale * q[b, t, h] . k[b, k, h]) v[b, k, h]
//
// for bf16 q, k, v of head_dim 64 read through three base pointers that share
// a batch, a token and a head stride, and a contiguous (B, T, H, 64) bf16
// output (so the caller's reshape to (B, T, D) is free). The same entry
// serves flash_attention on (B, T, H, 64) tensors (token stride H*64) and
// flash_attention_slab on the views of a (B, T, 3D) qkv slab at column
// offsets 0, D and 2D (token stride 3D): no head transposes in HBM.
//
// Replaces the Pallas TPU kernels dinov2_tpu/ops/flash_attention.py::
// _attn_kernel_1kv (one KV block covers the sequence, reached through
// flash_attention at T=1370) and _attn_kernel (the multi-KV online softmax of
// flash_attention and flash_attention_slab, e.g. T=4226 at 896 px; with
// with_lse=True the training forward, reached from _flash_fwd). On Hopper one
// kernel covers them: it always streams 64-key tiles with the online softmax,
// which is exact, so the TPU kernels' CLS-shift core and its overflow rescue
// have no counterpart. The TPU's (b*h, tp, 8) replicated lse layout is a
// Mosaic tiling rule and does not carry over: lse is (B, H, T) f32.
//
// What bounds it on an H100: at the slice's shape (B=8, T=1370, H=16) one call
// is 4*B*H*T^2*64 = 61.5 GFLOP of tensor-core work over 90 MB of q/k/v/out in
// HBM, ~680 FLOP per byte: operations bind it (0.0622 ms at 989 TFLOP/s bf16
// against ~0.03 ms for the bytes at 3.35 TB/s). Beside the two products every
// score takes a mask, a max, an exp2 and a sum on the CUDA cores, and each
// query tile of a head re-reads the head's K and V from L2.
//
// Design. A block is kWarpgroups (1 or 2) warpgroups and owns 64 query rows a
// warpgroup of one (image, head): grid (B*H, ceil(T / rows)). Q stays in
// shared memory; K and V tiles of 64 keys stream through a ring of kStages
// stages filled by cp.async (16 bytes a thread) into 128-byte-swizzled tiles
// (wgmma_tiles.cuh), three tiles ahead of the arithmetic; one __syncthreads a
// tile hands a stage over. Both products are wgmma m64n64k16: s = q k^T with
// both operands in shared memory, then P, rounded to bf16 in registers, is
// the A operand of P.V with V read through the descriptor's transpose bit.
// The loop is software-pipelined: tile j's P.V is started with tile j + 1's
// q k^T queued before it, and tile j + 1's softmax runs on the CUDA cores
// while both run on the tensor cores; the accumulator is rescaled once P.V
// is done. The softmax statistics stay in registers, a row in the four lanes
// of a quad. Scores are scaled once by scale*log2(e) inside the exponent's
// FMA and the exponent is one ex2 (MUFU): the running max is kept on the raw
// scores (scale > 0). At head_dim 64 the exponentials (16 a clock an SM)
// cost as many clocks as the two products, so half the tensor rate is the
// most this kernel's arithmetic allows. 128-row blocks halve the K/V
// re-reads from L2; 64-row blocks waste fewer rows on a ragged T (257 =
// 4*64 + 1) and overlap better on a small grid: the C entry picks by shape
// (forward_query_rows). The ragged tail is masked, never padded in memory:
// rows past T are zero-filled in shared memory, keys past T get -inf,
// queries past T are not written.
//
// What ptxas asks of the loop (it says so with -Xptxas -v, C7514/C7515, and
// then waits after every wgmma): no wgmma group in flight across the back
// edge, and no branch around a wgmma inside it; hence the peeled last tile.
//
// Numerics: f32 scores, exact online softmax (running row max, f32 row sums),
// P rounded to bf16 for P.V with f32 accumulation, one reciprocal of the row
// sum at the end, bf16 out. The with_lse variant (kWithLse) also writes
// lse = scale * max + log(max(l, 1e-30)); its `out` is the other's bit for bit
// (one template, the same instructions up to the extra store).
//
// Shared memory is dynamic: (kWarpgroups + 2 * kStages) * 8 KB + 1 KB of
// alignment slack (81 KB for two warpgroups: two blocks an SM). 121 to 123
// registers a thread, no spills. Every entry point returns
// cudaGetLastError() after its launch.

#include "wgmma_tiles.cuh"

namespace {

using namespace dinov2;

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
// many waves wins back. From the times of scripts/tune_flash_tiles.py on an
// H100 (ms, 64 against 128 rows): B=8, T=1370, H=16 (1408 blocks of 128)
// 0.2110 / 0.1763; B=8, T=1370, H=12 (1056) 0.1468 / 0.1292; B=1, T=4226,
// H=16 (544) 0.2262 / 0.2298; B=32, T=257, H=12 (1152) 0.0437 / 0.0474; B=64,
// T=257, H=12 (2304) 0.1102 / 0.0900.
// Compiling with -DDINOV2_FORWARD_QUERY_ROWS=64 or =128 takes that variant at
// every shape instead: how the script times one against the other.
int forward_query_rows(int b, int t, int heads) {
#ifdef DINOV2_FORWARD_QUERY_ROWS
  static_assert(DINOV2_FORWARD_QUERY_ROWS == 64 || DINOV2_FORWARD_QUERY_ROWS == 128,
                "one or two warpgroups a block");
  return DINOV2_FORWARD_QUERY_ROWS;
#else
  const long long blocks = static_cast<long long>(b) * heads * ((t + 127) / 128);
  const long long enough = t <= 512 ? 2048 : 2 * 2 * 132;
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

extern "C" {

// One launch on `stream`: out (B, T, H, 64) contiguous bf16. q, k and v are
// bf16 with unit stride over head_dim and the given strides (in elements,
// multiples of 8) over batch, tokens and heads; pointers 16-byte aligned; the
// tensors' device current on the calling thread (the caller sets it).
int dinov2_flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                int b, int t, int heads, long long batch_stride,
                                long long token_stride, long long head_stride, float scale,
                                void* stream) {
  return launch_forward_by_shape<false>(q, k, v, out, nullptr, b, t, heads, batch_stride,
                                        token_stride, head_stride, scale, stream);
}

// The same launch with the row logsumexp: lse (B, H, T) contiguous f32,
// lse[b, h, i] = log sum_k exp(scale * q[b, i, h] . k[b, k, h]).
int dinov2_flash_attention_lse_bf16(const void* q, const void* k, const void* v, void* out,
                                    void* lse, int b, int t, int heads, long long batch_stride,
                                    long long token_stride, long long head_stride, float scale,
                                    void* stream) {
  return launch_forward_by_shape<true>(q, k, v, out, lse, b, t, heads, batch_stride,
                                       token_stride, head_stride, scale, stream);
}

// Query rows a block of the variant the two entries above take at this shape.
int dinov2_flash_attention_query_rows(int b, int t, int heads) {
  return forward_query_rows(b, t, heads);
}

const char* dinov2_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
