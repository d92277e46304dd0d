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
// no atomics: dK/dV with one block per (image, head, 64-key tile) looping
// over the query tiles, and dQ with one block per (image, head, 64-query
// tile) looping over the key tiles; both recompute s and dO v^T per tile, so
// no (T, T) tensor ever reaches HBM. delta, plain XLA there, is a prologue
// kernel here (one warp per row).
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
// 10*B*H*T^2*64 FLOP (154 GFLOP at B=8, T=1370, H=16: ~0.155 ms at 989
// TFLOP/s bf16) over eight (B, T, H, 64) bf16 tensors in HBM (~0.05 ms):
// operations bind it. This version recomputes s and dO v^T in both kernels
// (seven products), a cost of the two-kernel design and not of the bound.
//
// Design of this first version: four warps a block. The dK/dV kernel keeps
// the block's K and V tiles in shared memory and computes the transposed
// tiles s^T = K Q^T and dP^T = V dO^T, so a warp owns 16 keys, the p^T and
// dS^T accumulator fragments are reused directly as the A operands of
// p^T dO and dS^T q (as the forward reuses p for P.V), and dK, dV stay in
// registers across the query loop. The dQ kernel keeps Q and dO and streams
// K and V the same way. Loads are not pipelined and the second products read
// their B operand through transposed scalar shared loads; ldmatrix, cp.async,
// wgmma and TMA are left for later work. The ragged tail (257 = 4*64 + 1,
// 1370 = 21*64 + 26) is masked, never padded: rows past T are zero-filled in
// shared memory, their p is forced to 0, and they are not written.
//
// Shared memory is static (37 KB per block). Every entry point returns
// cudaGetLastError() after its launches.

#include "attention_core.cuh"

namespace {

using namespace dinov2;

constexpr int kBackwardBlocksPerSm = 2;  // up to 255 registers a thread

typedef bf16 (*Tile)[kLds];

// Rows r0..r0+63 of a head's (T, 64) matrix -> a shared tile, 16 bytes a
// thread and step; rows past T are zero-filled.
__device__ __forceinline__ void load_tile(Tile dst, const bf16* __restrict__ src, size_t ld,
                                          int r0, int t) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < kTile * kHeadDim / 8; i += kThreads) {
    const int r = i >> 3, c = (i & 7) * 8;
    *reinterpret_cast<uint4*>(&dst[r][c]) =
        r0 + r < t ? *reinterpret_cast<const uint4*>(src + (r0 + r) * ld + c) : zero;
  }
}

// acc[nt] = sum over head_dim of a[row][.] * b[col][.] for this warp's 16
// rows (16*warp + g and + 8) and all 64 columns: the "q k^T" pattern.
__device__ __forceinline__ void product_nt(float (&acc)[8][4], Tile a, Tile b, int warp, int g,
                                           int tig) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;
  const int r = warp * 16 + g;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const uint32_t af[4] = {
        ld_pair(&a[r][16 * kc + 2 * tig]),
        ld_pair(&a[r + 8][16 * kc + 2 * tig]),
        ld_pair(&a[r][16 * kc + 8 + 2 * tig]),
        ld_pair(&a[r + 8][16 * kc + 8 + 2 * tig]),
    };
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const bf16* brow = &b[nt * 8 + g][16 * kc + 2 * tig];
      mma_16816(acc[nt], af, ld_pair(brow), ld_pair(brow + 8));
    }
  }
}

// acc[nt] += bf16(w) @ b for this warp's 16 rows of w (64 columns, in the
// accumulator layout) and b (64, 64) in shared memory: the "p v" pattern.
__device__ __forceinline__ void accumulate_pv(float (&acc)[8][4], const float (&w)[8][4], Tile b,
                                              int g, int tig) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const uint32_t wf[4] = {
        pack_floats(w[2 * kc][0], w[2 * kc][1]),
        pack_floats(w[2 * kc][2], w[2 * kc][3]),
        pack_floats(w[2 * kc + 1][0], w[2 * kc + 1][1]),
        pack_floats(w[2 * kc + 1][2], w[2 * kc + 1][3]),
    };
    const int kr = 16 * kc + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = nt * 8 + g;
      const uint32_t b0 = pack_pair(b[kr][c], b[kr + 1][c]);
      const uint32_t b1 = pack_pair(b[kr + 8][c], b[kr + 9][c]);
      mma_16816(acc[nt], wf, b0, b1);
    }
  }
}

// From s (this warp's rows x 64 columns of scores before the scale) and dp
// (dO v^T, same layout), in place: s <- p = exp(s * scale - lse), dp <- dS =
// p * (dp - delta) * scale, both 0 where the row or the column lies past T.
// kQueryIsRow says which axis the queries (and so lse and delta, given for
// the query tile in shared memory) run along; row0 and col0 are the tile's
// first row and column.
template <bool kQueryIsRow>
__device__ __forceinline__ void p_and_ds(float (&s)[8][4], float (&dp)[8][4],
                                         const float* __restrict__ lse_s,
                                         const float* __restrict__ delta_s, int row0, int col0,
                                         int t, float scale, int warp, int g, int tig) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = warp * 16 + g + 8 * (j >> 1), c = nt * 8 + 2 * tig + (j & 1);
      const int qi = kQueryIsRow ? r : c;
      const bool valid = row0 + r < t && col0 + c < t;
      const float p = valid ? expf(s[nt][j] * scale - lse_s[qi]) : 0.f;
      s[nt][j] = p;
      dp[nt][j] = p * (dp[nt][j] - delta_s[qi]) * scale;
    }
  }
}

// This warp's 16 rows of a (64, 64) f32 accumulator -> bf16 rows r0.. of a
// head's (T, 64) output; rows past T are skipped.
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, size_t ld, int r0, int t,
                                           const float (&acc)[8][4], int warp, int g, int tig) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + warp * 16 + g + 8 * h;
    if (row >= t) continue;
    bf16* p = dst + row * ld + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      *reinterpret_cast<uint32_t*>(p + nt * 8) = pack_floats(acc[nt][2 * h], acc[nt][2 * h + 1]);
    }
  }
}

// lse and delta of queries q0..q0+63 -> shared memory (0 past T).
__device__ __forceinline__ void load_row_stats(float* lse_s, float* delta_s,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta, int q0, int t) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const bool valid = q0 + i < t;
    lse_s[i] = valid ? lse[q0 + i] : 0.f;
    delta_s[i] = valid ? delta[q0 + i] : 0.f;
  }
}

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d] in f32; o and d_out
// contiguous (B, T, H, 64); one warp a row, four rows a block.
__global__ void __launch_bounds__(kThreads)
    delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ d_out,
                 float* __restrict__ delta, int rows, int t, int heads) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const size_t at = static_cast<size_t>(row) * kHeadDim + 2 * lane;
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(o + at);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(d_out + at);
  float sum = __bfloat162float(a.x) * __bfloat162float(b.x) +
              __bfloat162float(a.y) * __bfloat162float(b.y);
  sum = warp_sum(sum);
  if (lane == 0) {
    const int head = row % heads, token = (row / heads) % t, img = row / (heads * t);
    delta[(static_cast<size_t>(img) * heads + head) * t + token] = sum;
  }
}

// dK and dV of keys k0..k0+63 of one (image, head): grid (B*H, ceil(T/64)).
__global__ void __launch_bounds__(kThreads, kBackwardBlocksPerSm)
    flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, long long batch_stride, long long token_stride,
                     long long head_stride, const bf16* __restrict__ d_out,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, long long out_batch_stride,
                     long long out_token_stride, long long out_head_stride, int t, int heads,
                     float scale) {
  __shared__ __align__(16) bf16 ks[kTile][kLds];
  __shared__ __align__(16) bf16 vs[kTile][kLds];
  __shared__ __align__(16) bf16 qs[kTile][kLds];
  __shared__ __align__(16) bf16 dos[kTile][kLds];
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];

  const int img = blockIdx.x / heads, head = blockIdx.x % heads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int k0 = blockIdx.y * kTile;
  const size_t in = static_cast<size_t>(img) * batch_stride +
                    static_cast<size_t>(head) * head_stride;
  const size_t ld = static_cast<size_t>(token_stride);
  const size_t do_ld = static_cast<size_t>(heads) * kHeadDim;
  const bf16* d_out_head = d_out + static_cast<size_t>(img) * t * do_ld + head * kHeadDim;
  const float* lse_head = lse + static_cast<size_t>(blockIdx.x) * t;
  const float* delta_head = delta + static_cast<size_t>(blockIdx.x) * t;

  load_tile(ks, k + in, ld, k0, t);
  load_tile(vs, v + in, ld, k0, t);

  float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[nt][j] = dv_acc[nt][j] = 0.f;

  for (int q0 = 0; q0 < t; q0 += kTile) {
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile(qs, q + in, ld, q0, t);
    load_tile(dos, d_out_head, do_ld, q0, t);
    load_row_stats(lse_s, delta_s, lse_head, delta_head, q0, t);
    __syncthreads();

    float st[8][4], dpt[8][4];  // s^T and dP^T: rows are keys, columns queries
    product_nt(st, ks, qs, warp, g, tig);
    product_nt(dpt, vs, dos, warp, g, tig);
    p_and_ds<false>(st, dpt, lse_s, delta_s, k0, q0, t, scale, warp, g, tig);
    accumulate_pv(dv_acc, st, dos, g, tig);  // dV += p^T dO
    accumulate_pv(dk_acc, dpt, qs, g, tig);  // dK += dS^T q
  }

  const size_t out = static_cast<size_t>(img) * out_batch_stride +
                     static_cast<size_t>(head) * out_head_stride;
  store_rows(dk + out, static_cast<size_t>(out_token_stride), k0, t, dk_acc, warp, g, tig);
  store_rows(dv + out, static_cast<size_t>(out_token_stride), k0, t, dv_acc, warp, g, tig);
}

// dQ of queries q0..q0+63 of one (image, head): grid (B*H, ceil(T/64)).
__global__ void __launch_bounds__(kThreads, kBackwardBlocksPerSm)
    flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, long long batch_stride, long long token_stride,
                    long long head_stride, const bf16* __restrict__ d_out,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, long long out_batch_stride,
                    long long out_token_stride, long long out_head_stride, int t, int heads,
                    float scale) {
  __shared__ __align__(16) bf16 qs[kTile][kLds];
  __shared__ __align__(16) bf16 dos[kTile][kLds];
  __shared__ __align__(16) bf16 ks[kTile][kLds];
  __shared__ __align__(16) bf16 vs[kTile][kLds];
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];

  const int img = blockIdx.x / heads, head = blockIdx.x % heads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.y * kTile;
  const size_t in = static_cast<size_t>(img) * batch_stride +
                    static_cast<size_t>(head) * head_stride;
  const size_t ld = static_cast<size_t>(token_stride);
  const size_t do_ld = static_cast<size_t>(heads) * kHeadDim;

  load_tile(qs, q + in, ld, q0, t);
  load_tile(dos, d_out + static_cast<size_t>(img) * t * do_ld + head * kHeadDim, do_ld, q0, t);
  load_row_stats(lse_s, delta_s, lse + static_cast<size_t>(blockIdx.x) * t,
                 delta + static_cast<size_t>(blockIdx.x) * t, q0, t);

  float dq_acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) dq_acc[nt][j] = 0.f;

  for (int k0 = 0; k0 < t; k0 += kTile) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(ks, k + in, ld, k0, t);
    load_tile(vs, v + in, ld, k0, t);
    __syncthreads();

    float s[8][4], dp[8][4];  // rows are queries, columns keys
    product_nt(s, qs, ks, warp, g, tig);
    product_nt(dp, dos, vs, warp, g, tig);
    p_and_ds<true>(s, dp, lse_s, delta_s, q0, k0, t, scale, warp, g, tig);
    accumulate_pv(dq_acc, dp, ks, g, tig);  // dQ += dS k
  }

  const size_t out = static_cast<size_t>(img) * out_batch_stride +
                     static_cast<size_t>(head) * out_head_stride;
  store_rows(dq + out, static_cast<size_t>(out_token_stride), q0, t, dq_acc, warp, g, tig);
}

}  // namespace

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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(d_out);
  const float* lsep = static_cast<const float*>(lse);
  float* delta = static_cast<float*>(delta_scratch);
  const int rows = b * t * heads;
  const int rows_per_block = kThreads / 32;

  delta_kernel<<<(rows + rows_per_block - 1) / rows_per_block, kThreads, 0, s>>>(
      static_cast<const bf16*>(o), dop, delta, rows, t, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid(b * heads, (t + kTile - 1) / kTile);
  flash_dkv_kernel<<<grid, kThreads, 0, s>>>(
      qp, kp, vp, batch_stride, token_stride, head_stride, dop, lsep, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), out_batch_stride, out_token_stride,
      out_head_stride, t, heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  flash_dq_kernel<<<grid, kThreads, 0, s>>>(
      qp, kp, vp, batch_stride, token_stride, head_stride, dop, lsep, delta,
      static_cast<bf16*>(dq), out_batch_stride, out_token_stride, out_head_stride, t, heads,
      scale);
  return cudaGetLastError();
}

const char* dinov2_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
