// K6 on Hopper: the flash attention backward (FlashAttention-2 structure),
//
//     p  = exp(scale * q k^T - lse)                 (recomputed, never stored)
//     dS = p * (dO v^T - delta) * scale,  delta = rowsum(dO * O)
//     dV = p^T dO      dK = dS^T q      dQ = dS k
//
// per (image, head), for bf16 q, k, v of head_dim 64 read through three base
// pointers that share a batch, a token and a head stride (as K4 reads them,
// so the head views of a (B, T, 3D) qkv slab need no transpose), contiguous
// (B, T, H, 64) bf16 O and dO, and the (B, H, T) f32 row logsumexp the
// training forward wrote (flash_attention.cu, kWithLse). dq, dk and dv are
// written through three pointers and shared strides too, so the slab route
// hands it the three column blocks of one (B, T, 3D) gradient slab.
//
// Replaces the Pallas TPU kernels dinov2_tpu/ops/flash_attention.py::
// _dkv_kernel and _dq_kernel (with their shared _bwd_p_ds), reached through
// _flash_backward. As there, two kernels keep the result deterministic with
// no atomics, the same bits run to run: dK/dV with one block per (image,
// head, key tile) looping over the query tiles, and dQ with one block per
// (image, head, query tile) looping over the key tiles; both recompute s and
// dO v^T per tile, so no (T, T) tensor ever reaches HBM. delta, plain XLA
// there, is a prologue kernel here (eight threads a row).
//
// Rounding contract. The TPU kernels multiply p and dS as f32. On tensor
// cores the operands are bf16: p and dS are computed in f32 (f32 scores from
// bf16 q, k; f32 dO v^T) and rounded to bf16 for the three products
// p^T dO, dS^T q and dS k, which accumulate in f32, as the forward rounds p
// for P.V. dS already carries `scale`; dQ and dK take no second one. Outputs
// are rounded to bf16 once. The plain version
// (ops/flash_attention.py::flash_backward_reference) rounds at the same
// points.
//
// What bounds it on an H100: the least work is five T x T x 64 products,
// 10*B*H*T^2*64 FLOP (154 GFLOP at B=8, T=1370, H=16: 0.1555 ms at 989
// TFLOP/s bf16) over eight (B, T, H, 64) bf16 tensors in HBM: operations
// bind it there. At the training shape (B=32, T=257, H=12) the eight 12.6 MB
// tensors bind it (0.0303 ms at 3.35 TB/s). The two deterministic kernels
// do seven products (s and dO v^T in both): the cost of bit-reproducible
// gradients without a (B, T, H, 64) f32 scratch and atomics.
//
// Design. A block is kWarpgroups (1 or 2) warpgroups; a warpgroup owns 64
// rows of the block's resident tiles. The dK/dV kernel keeps its K and V rows
// in shared memory and streams 64-query tiles of Q and dO with their lse and
// delta rows; it computes the transposed tiles s^T = K Q^T and dP^T = V dO^T
// (wgmma m64n64k16, both operands in shared memory), so that p^T and dS^T,
// rounded to bf16 in registers, are directly the A operands of p^T dO and
// dS^T q, whose B operands are the very dO and Q tiles read through the
// descriptor's transpose bit (wgmma_tiles.cuh): no transposed copies, no
// scalar shared loads. The dQ kernel keeps Q and dO rows (lse and delta in
// registers) and streams K and V tiles the same way; dS k reads K through
// the transpose bit. The streamed tiles go through a ring of kStages stages
// filled by cp.async, two tiles ahead of the arithmetic; one __syncthreads a
// tile hands a stage over. Inside a tile the products are committed as
// separate wgmma groups: p is computed while dO v^T runs and dS while p^T dO
// runs; the tile ends with every product done (a group left in flight across
// the loop's back edge makes ptxas serialize every wgmma of the loop, C7515
// under -Xptxas -v). exp is one ex2 on s * scale*log2(e) - lse*log2(e), and
// dS = p * (dP * scale - delta * scale) is one FMA and one product. 128-row
// blocks halve the re-reads of the streamed tiles from L2; 64-row blocks
// waste fewer rows on a short ragged T: the C entry takes 64 keys (the dK/dV
// kernel's registers allow two warpgroups an SM either way) and 128 queries
// (kBackwardKeyRows, kBackwardQueryRows). The ragged tail (257 = 4*64 + 1,
// 1370 = 21*64 + 26) is masked, never padded: rows past T are zero-filled in
// shared memory, their p is forced to 0, and they are not written.
//
// Shared memory is dynamic ((2 * kWarpgroups + 2 * kStages) * 8 KB, the
// dK/dV kernel's row statistics and 1 KB of alignment slack: 66.5 KB for its
// one-warpgroup block, 82.5 KB for the dQ kernel's two). 186 registers a
// thread in the dK/dV kernel (four 64 x 64 f32 accumulators: two blocks an
// SM), 122 in the dQ kernel (capped at 128: two blocks an SM), no spills.
// Every entry point returns cudaGetLastError() after its launches.

#include "f32_backward.cuh"
#include "wgmma_tiles.cuh"

namespace dinov2 {
namespace {

constexpr int kBackwardStages = 3;
constexpr int kAhead = kBackwardStages - 1;      // tiles in flight ahead of the arithmetic
constexpr int kStageBytes = 2 * kTileBytes;      // a streamed tile pair
constexpr int kStatsBytes = 2 * kTile * 4;       // lse and delta of 64 queries

template <int kWarpgroups>
constexpr int backward_shared_bytes() {
  return 2 * kWarpgroups * kTileBytes + kBackwardStages * (kStageBytes + kStatsBytes) + 1024;
}

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d] in f32; o and d_out
// contiguous (B, T, H, 64). Eight threads a row, 16 bytes of each tensor a
// thread, 16 rows a block: bytes bind it (two tensors read once).
constexpr int kDeltaRows = kThreads / 8;

__global__ void __launch_bounds__(kThreads)
    delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ d_out,
                 float* __restrict__ delta, int rows, int t, int heads) {
  const int row = blockIdx.x * kDeltaRows + (threadIdx.x >> 3);
  const bool valid = row < rows;
  const size_t at = static_cast<size_t>(valid ? row : 0) * kHeadDim + (threadIdx.x & 7) * 8;
  const uint4 a = *reinterpret_cast<const uint4*>(o + at);
  const uint4 b = *reinterpret_cast<const uint4*>(d_out + at);
  const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(a2[i]), y = __bfloat1622float2(b2[i]);
    sum = fmaf(x.x, y.x, fmaf(x.y, y.y, sum));
  }
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (valid && (threadIdx.x & 7) == 0) {
    const int head = row % heads, token = (row / heads) % t, img = row / (heads * t);
    delta[(static_cast<size_t>(img) * heads + head) * t + token] = sum;
  }
}

// dK and dV of kWarpgroups * 64 keys of one (image, head): grid
// (B*H, ceil(T / keys)).
template <int kWarpgroups>
__global__ void __launch_bounds__(128 * kWarpgroups, kWarpgroups == 1 ? 2 : 1)
    flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, long long batch_stride, long long token_stride,
                     long long head_stride, const bf16* __restrict__ d_out,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, long long out_batch_stride,
                     long long out_token_stride, long long out_head_stride, int t, int heads,
                     float scale) {
  constexpr int kThreadsN = 128 * kWarpgroups, kKeyRows = kTile * kWarpgroups;
  extern __shared__ uint8_t shared_raw[];
  const uint32_t k_s = (shared_address(shared_raw) + 1023u) & ~1023u;
  const uint32_t v_s = k_s + kKeyRows * kRowBytes;
  const uint32_t ring_s = v_s + kKeyRows * kRowBytes;  // stage: a Q tile, then a dO tile
  const uint32_t stats_s = ring_s + kBackwardStages * kStageBytes;
  const float* stats = reinterpret_cast<const float*>(
      shared_raw + (stats_s - shared_address(shared_raw)));  // stage: lse[64], delta[64]

  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, wg = threadIdx.x >> 7;
  const int g = lane >> 2, tig = lane & 3;
  const int img = blockIdx.x / heads, head = blockIdx.x % heads;
  const int k0 = blockIdx.y * kKeyRows;
  const size_t in = static_cast<size_t>(img) * batch_stride +
                    static_cast<size_t>(head) * head_stride;
  const size_t ld = static_cast<size_t>(token_stride);
  const size_t do_ld = static_cast<size_t>(heads) * kHeadDim;
  q += in, k += in, v += in;
  d_out += static_cast<size_t>(img) * t * do_ld + head * kHeadDim;
  lse += static_cast<size_t>(blockIdx.x) * t;
  delta += static_cast<size_t>(blockIdx.x) * t;
  const int tiles = (t + kTile - 1) / kTile;

  // query tile `tile` into ring stage `stage`: Q, dO, lse and delta rows
  auto load_stage = [&](int stage, int tile) {
    const int q0 = tile * kTile;
    load_tile_async<kTile, kThreadsN>(ring_s + stage * kStageBytes, q, ld, q0, t);
    load_tile_async<kTile, kThreadsN>(ring_s + stage * kStageBytes + kTileBytes, d_out, do_ld,
                                      q0, t);
    if (threadIdx.x < 2 * kTile) {
      const int i = threadIdx.x & (kTile - 1);
      const bool valid = q0 + i < t;
      const float* src = (threadIdx.x < kTile ? lse : delta) + (valid ? q0 + i : 0);
      cp_async_4(stats_s + stage * kStatsBytes + threadIdx.x * 4, src, valid);
    }
  };

  // group 0 holds K, V and query tile 0; groups are committed even when
  // empty, so that query tile j is always group j
  load_tile_async<kKeyRows, kThreadsN>(k_s, k, ld, k0, t);
  load_tile_async<kKeyRows, kThreadsN>(v_s, v, ld, k0, t);
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < tiles) load_stage(s, s);
    cp_async_commit();
  }

  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const float scale_log2 = scale * kLog2e;
  const uint32_t k_wg = k_s + wg * kTileBytes, v_wg = v_s + wg * kTileBytes;
  const int key_row = k0 + wg * kTile + warp * 16 + g;  // this thread's rows: key_row, + 8

  int stage = 0, fill = kAhead;  // the stage of tile j, of tile j + kAhead
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<kAhead - 1>();  // this thread's part of tile j has landed
    fence_proxy_async();
    __syncthreads();  // everyone's has, and everyone is done with tile j - 1
    if (j + kAhead < tiles) load_stage(fill, j + kAhead);
    cp_async_commit();
    const uint32_t q_t = ring_s + stage * kStageBytes, do_t = q_t + kTileBytes;
    const float* lse_t = stats + stage * (2 * kTile);
    const float* delta_t = lse_t + kTile;
    stage = stage + 1 == kBackwardStages ? 0 : stage + 1;
    fill = fill + 1 == kBackwardStages ? 0 : fill + 1;

    float st[32], dpt[32];  // s^T and dP^T: rows are keys, columns queries
    wgmma_fence();
    start_product_nt(st, k_wg, q_t);
    wgmma_commit();
    start_product_nt(dpt, v_wg, do_t);
    wgmma_commit();
    wgmma_wait<1>();  // s^T
    fence_registers(st);

    // st <- p^T = exp(s^T * scale - lse), 0 where the key or the query lies past T
    const int q0 = j * kTile;
    const bool ragged = q0 + kTile > t || k0 + kKeyRows > t;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 l = *reinterpret_cast<const float2*>(lse_t + nt * 8 + 2 * tig);
      const float neg_l[2] = {-l.x * kLog2e, -l.y * kLog2e};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = fast_exp2(fmaf(st[4 * nt + i], scale_log2, neg_l[i & 1]));
        if (ragged) {
          const int key = key_row + 8 * (i >> 1), query = q0 + nt * 8 + 2 * tig + (i & 1);
          if (key >= t || query >= t) p = 0.f;
        }
        st[4 * nt + i] = p;
      }
    }
    uint32_t p_op[16];
    round_to_operand(p_op, st);

    wgmma_wait<0>();  // dP^T
    fence_registers(dpt);
    fence_registers(p_op);
    fence_registers(dv_acc);
    wgmma_fence();
    start_product_nn(dv_acc, p_op, do_t);  // dV += p^T dO
    wgmma_commit();

    // dpt <- dS^T = p^T * (dP^T * scale - delta * scale)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 d = *reinterpret_cast<const float2*>(delta_t + nt * 8 + 2 * tig);
      const float neg_d[2] = {-d.x * scale, -d.y * scale};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dpt[4 * nt + i] = st[4 * nt + i] * fmaf(dpt[4 * nt + i], scale, neg_d[i & 1]);
      }
    }
    uint32_t ds_op[16];
    round_to_operand(ds_op, dpt);
    fence_registers(ds_op);
    fence_registers(dk_acc);
    wgmma_fence();
    start_product_nn(dk_acc, ds_op, q_t);  // dK += dS^T q
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers(p_op);
    fence_registers(ds_op);
    fence_registers(dv_acc);
    fence_registers(dk_acc);
  }

  const size_t out = static_cast<size_t>(img) * out_batch_stride +
                     static_cast<size_t>(head) * out_head_stride;
  const float one[2] = {1.f, 1.f};
  store_accumulator(dk + out, static_cast<size_t>(out_token_stride), k0 + wg * kTile, t, dk_acc,
                    one, warp, g, tig);
  store_accumulator(dv + out, static_cast<size_t>(out_token_stride), k0 + wg * kTile, t, dv_acc,
                    one, warp, g, tig);
}

// dQ of kWarpgroups * 64 queries of one (image, head): grid
// (B*H, ceil(T / queries)).
template <int kWarpgroups>
__global__ void __launch_bounds__(128 * kWarpgroups, kWarpgroups == 1 ? 3 : 2)
    flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, long long batch_stride, long long token_stride,
                    long long head_stride, const bf16* __restrict__ d_out,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, long long out_batch_stride,
                    long long out_token_stride, long long out_head_stride, int t, int heads,
                    float scale) {
  constexpr int kThreadsN = 128 * kWarpgroups, kQueryRows = kTile * kWarpgroups;
  extern __shared__ uint8_t shared_raw[];
  const uint32_t q_s = (shared_address(shared_raw) + 1023u) & ~1023u;
  const uint32_t do_s = q_s + kQueryRows * kRowBytes;
  const uint32_t ring_s = do_s + kQueryRows * kRowBytes;  // stage: a K tile, then a V tile

  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, wg = threadIdx.x >> 7;
  const int g = lane >> 2, tig = lane & 3;
  const int img = blockIdx.x / heads, head = blockIdx.x % heads;
  const int q0 = blockIdx.y * kQueryRows;
  const size_t in = static_cast<size_t>(img) * batch_stride +
                    static_cast<size_t>(head) * head_stride;
  const size_t ld = static_cast<size_t>(token_stride);
  const size_t do_ld = static_cast<size_t>(heads) * kHeadDim;
  q += in, k += in, v += in;
  d_out += static_cast<size_t>(img) * t * do_ld + head * kHeadDim;
  lse += static_cast<size_t>(blockIdx.x) * t;
  delta += static_cast<size_t>(blockIdx.x) * t;
  const int tiles = (t + kTile - 1) / kTile;

  auto load_stage = [&](int stage, int tile) {
    load_tile_async<kTile, kThreadsN>(ring_s + stage * kStageBytes, k, ld, tile * kTile, t);
    load_tile_async<kTile, kThreadsN>(ring_s + stage * kStageBytes + kTileBytes, v, ld,
                                      tile * kTile, t);
  };

  load_tile_async<kQueryRows, kThreadsN>(q_s, q, ld, q0, t);
  load_tile_async<kQueryRows, kThreadsN>(do_s, d_out, do_ld, q0, t);
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < tiles) load_stage(s, s);
    cp_async_commit();
  }

  // this thread's rows: query_row and query_row + 8
  const int query_row = q0 + wg * kTile + warp * 16 + g;
  float neg_l[2], d[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool valid = query_row + 8 * h < t;
    neg_l[h] = valid ? -lse[query_row + 8 * h] * kLog2e : 0.f;
    d[h] = valid ? -delta[query_row + 8 * h] * scale : 0.f;  // -delta * scale
  }

  float dq_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;
  const float scale_log2 = scale * kLog2e;
  const uint32_t q_wg = q_s + wg * kTileBytes, do_wg = do_s + wg * kTileBytes;

  int stage = 0, fill = kAhead;
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<kAhead - 1>();
    fence_proxy_async();
    __syncthreads();
    if (j + kAhead < tiles) load_stage(fill, j + kAhead);
    cp_async_commit();
    const uint32_t k_t = ring_s + stage * kStageBytes, v_t = k_t + kTileBytes;
    stage = stage + 1 == kBackwardStages ? 0 : stage + 1;
    fill = fill + 1 == kBackwardStages ? 0 : fill + 1;

    float s[32], dp[32];  // rows are queries, columns keys
    wgmma_fence();
    start_product_nt(s, q_wg, k_t);
    wgmma_commit();
    start_product_nt(dp, do_wg, v_t);
    wgmma_commit();
    wgmma_wait<1>();  // s
    fence_registers(s);

    const int k0 = j * kTile;
    const bool ragged = k0 + kTile > t || q0 + kQueryRows > t;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float p = fast_exp2(fmaf(s[i], scale_log2, neg_l[(i >> 1) & 1]));
      if (ragged) {
        const int query = query_row + 8 * ((i >> 1) & 1);
        const int key = k0 + (i >> 2) * 8 + 2 * tig + (i & 1);
        if (key >= t || query >= t) p = 0.f;
      }
      s[i] = p;
    }
    wgmma_wait<0>();  // dP
    fence_registers(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * fmaf(dp[i], scale, d[(i >> 1) & 1]);
    uint32_t ds_op[16];
    round_to_operand(ds_op, dp);
    fence_registers(ds_op);
    fence_registers(dq_acc);
    wgmma_fence();
    start_product_nn(dq_acc, ds_op, k_t);  // dQ += dS k
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers(ds_op);
    fence_registers(dq_acc);
  }

  const size_t out = static_cast<size_t>(img) * out_batch_stride +
                     static_cast<size_t>(head) * out_head_stride;
  const float one[2] = {1.f, 1.f};
  store_accumulator(dq + out, static_cast<size_t>(out_token_stride), q0 + wg * kTile, t, dq_acc,
                    one, warp, g, tig);
}

// Rows a block: 64 keys in the dK/dV kernel (186 registers a thread: two
// warpgroups an SM, as two blocks or as one), 128 queries in the dQ kernel
// (122 registers: two two-warpgroup blocks an SM, and half the K/V re-reads).
// From the times of scripts/tune_flash_tiles.py on an H100 (ms; keys/queries
// 64/128, 128/128, 64/64, 128/64): B=8, T=1370, H=16: 0.5411, 0.5489, 0.5653,
// 0.5858; B=32, T=257, H=12: 0.1376, 0.1556, 0.1348, 0.1528. No shape of the
// paths argues for another pair yet, so only this pair is compiled; the
// script builds the others with -DDINOV2_BACKWARD_KEY_ROWS= and
// -DDINOV2_BACKWARD_QUERY_ROWS=.
#ifndef DINOV2_BACKWARD_KEY_ROWS
#define DINOV2_BACKWARD_KEY_ROWS 64
#endif
#ifndef DINOV2_BACKWARD_QUERY_ROWS
#define DINOV2_BACKWARD_QUERY_ROWS 128
#endif
constexpr int kBackwardKeyRows = DINOV2_BACKWARD_KEY_ROWS;
constexpr int kBackwardQueryRows = DINOV2_BACKWARD_QUERY_ROWS;
static_assert((kBackwardKeyRows == 64 || kBackwardKeyRows == 128) &&
                  (kBackwardQueryRows == 64 || kBackwardQueryRows == 128),
              "one or two warpgroups a block");

struct BackwardArgs {
  const bf16 *q, *k, *v, *d_out;
  const float *lse, *delta;
  bf16 *dq, *dk, *dv;
  int b, t, heads;
  long long batch_stride, token_stride, head_stride;
  long long out_batch_stride, out_token_stride, out_head_stride;
  float scale;
  cudaStream_t stream;
};

template <int kWarpgroups>
int launch_dkv(const BackwardArgs& a) {
  auto kernel = flash_dkv_kernel<kWarpgroups>;
  constexpr int kShared = backward_shared_bytes<kWarpgroups>();
  static SharedMemoryGrant grant;
  const cudaError_t err = grant(kernel, kShared);
  if (err != cudaSuccess) return err;
  constexpr int kRows = kTile * kWarpgroups;
  kernel<<<dim3(a.b * a.heads, (a.t + kRows - 1) / kRows), 128 * kWarpgroups, kShared,
           a.stream>>>(a.q, a.k, a.v, a.batch_stride, a.token_stride, a.head_stride, a.d_out,
                       a.lse, a.delta, a.dk, a.dv, a.out_batch_stride, a.out_token_stride,
                       a.out_head_stride, a.t, a.heads, a.scale);
  return cudaGetLastError();
}

template <int kWarpgroups>
int launch_dq(const BackwardArgs& a) {
  auto kernel = flash_dq_kernel<kWarpgroups>;
  constexpr int kShared = backward_shared_bytes<kWarpgroups>();
  static SharedMemoryGrant grant;
  const cudaError_t err = grant(kernel, kShared);
  if (err != cudaSuccess) return err;
  constexpr int kRows = kTile * kWarpgroups;
  kernel<<<dim3(a.b * a.heads, (a.t + kRows - 1) / kRows), 128 * kWarpgroups, kShared,
           a.stream>>>(a.q, a.k, a.v, a.batch_stride, a.token_stride, a.head_stride, a.d_out,
                       a.lse, a.delta, a.dq, a.out_batch_stride, a.out_token_stride,
                       a.out_head_stride, a.t, a.heads, a.scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dinov2

using namespace dinov2;

extern "C" {

// Three launches on `stream` (delta, dK/dV, dQ). q, k, v: bf16, unit stride
// over head_dim 64, the given strides (in elements, multiples of 8) over
// batch, tokens and heads; dq, dk, dv likewise with the out strides; o and
// d_out contiguous (B, T, H, 64) bf16; lse (B, H, T) f32; delta_scratch
// (B, H, T) f32 the caller allocated. Pointers 16-byte aligned; the tensors'
// device current on the calling thread (the caller sets it).
int dinov2_flash_backward_bf16(const void* q, const void* k, const void* v, const void* o,
                               const void* d_out, const void* lse, void* delta_scratch,
                               void* dq, void* dk, void* dv, int b, int t, int heads,
                               long long batch_stride, long long token_stride,
                               long long head_stride, long long out_batch_stride,
                               long long out_token_stride, long long out_head_stride,
                               float scale, void* stream) {
  BackwardArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.d_out = static_cast<const bf16*>(d_out);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta_scratch);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.b = b, a.t = t, a.heads = heads;
  a.batch_stride = batch_stride, a.token_stride = token_stride, a.head_stride = head_stride;
  a.out_batch_stride = out_batch_stride, a.out_token_stride = out_token_stride;
  a.out_head_stride = out_head_stride;
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);

  const int rows = b * t * heads;
  delta_kernel<<<(rows + kDeltaRows - 1) / kDeltaRows, kThreads, 0, a.stream>>>(
      static_cast<const bf16*>(o), a.d_out, static_cast<float*>(delta_scratch), rows, t, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int code = launch_dkv<kBackwardKeyRows / kTile>(a);
  if (code != cudaSuccess) return code;
  return launch_dq<kBackwardQueryRows / kTile>(a);
}

// The f32 variant (f32_backward.cuh): q, k, v, o, d_out, dq, dk and dv f32,
// strides multiples of 4 elements; lse and delta_scratch as above.
int dinov2_flash_backward_f32(const void* q, const void* k, const void* v, const void* o,
                              const void* d_out, const void* lse, void* delta_scratch,
                              void* dq, void* dk, void* dv, int b, int t, int heads,
                              long long batch_stride, long long token_stride,
                              long long head_stride, long long out_batch_stride,
                              long long out_token_stride, long long out_head_stride,
                              float scale, void* stream) {
  return launch_f32_backward(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(o), static_cast<const float*>(d_out),
      static_cast<const float*>(lse), static_cast<float*>(delta_scratch),
      static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), b, t, heads,
      batch_stride, token_stride, head_stride, out_batch_stride, out_token_stride,
      out_head_stride, scale, static_cast<cudaStream_t>(stream));
}

// Rows a block of the variants the entry above takes: the dK/dV kernel's
// keys * 1000 + the dQ kernel's queries.
int dinov2_flash_backward_rows() { return kBackwardKeyRows * 1000 + kBackwardQueryRows; }

const char* dinov2_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
