// K6's f32 variant: the flash attention backward in full f32,
//
//     p  = exp(scale * q k^T - lse)                 (recomputed, never stored)
//     dS = p * (dO v^T - delta) * scale,  delta = rowsum(dO * O)
//     dV = p^T dO      dK = dS^T q      dQ = dS k
//
// per (image, head), for f32 q, k, v of head_dim 64 read through three base
// pointers that share a batch, a token and a head stride (multiples of 4
// elements), contiguous (B, T, H, 64) f32 O and dO, and the (B, H, T) f32 lse
// of the training forward (f32_attention.cuh, kWithLse); dq, dk and dv
// written through three pointers and shared strides, as the bf16 K6.
//
// Replaces, for f32 activations, the Pallas TPU kernels
// dinov2_tpu/ops/flash_attention.py::_dkv_kernel and _dq_kernel (with their
// shared _bwd_p_ds), which multiply p and dS as f32: here nothing is rounded
// between the steps, and every product runs as 3xTF32 on wgmma
// (tf32x3.cuh): f32-accurate, on the tensor cores.
//
// What bounds it on an H100: the least work is five T x T x 64 products,
// 10*B*H*T^2*64 FLOP: 154 GFLOP at B=8, T=1370, H=16 (0.93 ms at 3xTF32's
// 165 TFLOP/s; 2.29 ms at the 67 TFLOP/s of f32 FFMA) and 16.2 GFLOP at
// B=32, T=257, H=12 (0.098 ms; 0.24 ms): operations bind both (the eight
// (B, T, H, 64) f32 tensors in HBM, 359 MB and 202 MB, take 0.11 and 0.06 ms
// at 3.35 TB/s).
//
// Design, as the bf16 K6: two kernels keep the result deterministic with no
// atomics, the same bits run to run, dK/dV with one block per (image, head,
// key block) looping over the query tiles in order, dQ with one block per
// (image, head, query block) looping over the key tiles in order; both
// recompute s and dO v^T (seven products for the five), and a delta
// prologue (16 threads a row) reads O and dO once.
//
// wgmma takes .tf32 operands from shared memory K-major only (no transpose
// bit), so every operand read from there lies as K-major TF32 planes, hi and
// lo, in 128-byte-swizzled atoms of 32 floats a row, each split once where
// it is staged. A block is two warpgroups, each with 64 rows of its own
// (128 keys, or queries, a block), that share each streamed tile: the two
// split it together (one tensor each) into one set of planes, then each
// multiplies its own rows by it.
//   - the dK/dV kernel keeps each warpgroup's K and V (64 keys x 64 dims:
//     two atoms a plane) and streams 32-query tiles of Q and dO. A
//     warpgroup computes s^T = K Q^T and dP^T = V dO^T (wgmma m64n32k8, the
//     streamed tiles as they lie: 32 rows x 64 dims), makes p^T and dS^T in
//     registers, and takes dV += p^T dO and dK += dS^T q (m64n64k8) with
//     p^T and dS^T as the A operand from registers (tf32x3.cuh's
//     SplitFragments: the accumulator's registers are the fragment once each
//     group of eight k is taken in the order 0, 2, 4, 6, 1, 3, 5, 7), and dO
//     and Q transposed as B: each streamed tile is split into four planes,
//     hi and lo in both orientations, the transposed ones with their rows in
//     that order.
//   - the dQ kernel keeps each warpgroup's Q and dO and streams 32-key
//     tiles of K and V: s = Q K^T and dP = dO V^T, dS in registers, then
//     dQ += dS k on K transposed.
// A streamed tile's raw values land a tile ahead by cp.async (16 bytes a
// thread a row, a half-warp a 256-byte row), each thread the pieces it
// splits itself, so no barrier sits between the copy and the split; two
// barriers a tile hand the planes over. The transposed planes' stores are
// spread over the banks by a rotated order. On an H100 this ran faster than
// warpgroups with planes of their own taking the tiles in turn (each tile
// then split once per warpgroup, not once per block), and landing by
// cp.async faster than loading the raw tiles into registers a tile ahead,
// whose loads were not kept in flight across the loop.
// dV, dK and dQ sum over the whole of T: each tile's products go into a
// fresh chunk accumulator, added to the f32 sums with rounded adds
// (tf32x3.cuh's note). exp is one ex2 on s * scale*log2(e) -
// lse*log2(e), as in the FFMA kernel this replaces. The ragged tail is
// masked: rows past T are zero-filled in shared memory, p is forced to 0
// where the key or the query lies past T, and rows past T are not written.
//
// Shared memory is dynamic: the dK/dV kernel's K and V planes (128 KB for
// both warpgroups), the streamed Q, Q^T, dO and dO^T planes (64 KB), the
// landing buffers (16 KB) and lse and delta rows (209.5 KB with alignment
// slack: one block an SM); the dQ kernel's Q and dO planes (128 KB), the
// streamed K, K^T and V planes (48 KB) and landing buffers (16 KB): 193 KB.

#pragma once

#include "f32_attention.cuh"
#include "tf32x3.cuh"

namespace dinov2 {
namespace {

constexpr int kF32BwdWarpgroups = 2;
constexpr int kF32BwdThreads = 128 * kF32BwdWarpgroups;
constexpr int kF32BwdRows = kTile * kF32BwdWarpgroups;  // keys (queries) of a block
constexpr int kF32Stream = 32;                          // rows of a streamed tile
constexpr int kF32DeltaRows = kF32AttentionThreads / 16;
// planes: a resident 64 x 64 operand (two atoms of 64 rows), a streamed 32 x
// 64 one (two atoms of 32 rows) and a transposed streamed one (64 dims x 32
// rows, one atom, its rows permuted: SplitFragments); bytes of one plane
constexpr int kResidentAtom = kTile * 128;
constexpr int kResidentPlane = 2 * kResidentAtom;
constexpr int kStreamAtom = kF32Stream * 128;
constexpr int kStreamPlane = 2 * kStreamAtom;
constexpr int kStreamTPlane = kHeadDim * 128;
// the landing buffer for the raw values of one streamed tile of one tensor:
// each thread of a warpgroup its four 16-byte pieces, thread-major
constexpr int kRawBytes = 4 * 128 * 16;
// the dK/dV kernel: each warpgroup's K and V (hi, lo each); the streamed
// Q, Q^T, dO, dO^T (hi, lo each); raw Q and dO; lse and delta rows as the
// planes' tile has them, then as they land
constexpr int kDkvStreamBytes = 4 * kStreamPlane + 4 * kStreamTPlane;
constexpr int kDkvStatsBytes = 2 * kF32Stream * 4;
constexpr int kDkvShared = 1024 + kF32BwdWarpgroups * 4 * kResidentPlane + kDkvStreamBytes +
                           2 * kRawBytes + 2 * kDkvStatsBytes;
// the dQ kernel: each warpgroup's Q and dO; the streamed K, K^T, V; raw K, V
constexpr int kDqStreamBytes = 4 * kStreamPlane + 2 * kStreamTPlane;
constexpr int kDqShared =
    1024 + kF32BwdWarpgroups * 4 * kResidentPlane + kDqStreamBytes + 2 * kRawBytes;
static_assert(kDkvShared <= 232448 && kDqShared <= 232448, "a block's planes fit");
static_assert(kF32Stream * kHeadDim / 16 == 128, "a thread holds one 4 x 4 piece of a tile");

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]; o and d_out
// contiguous (B, T, H, 64) f32. Sixteen threads a row, 16 bytes of each
// tensor a thread: bytes bind it.
__global__ void __launch_bounds__(kF32AttentionThreads)
    f32_backward_delta_rows(const float* __restrict__ o, const float* __restrict__ d_out,
                            float* __restrict__ delta, int rows, int t, int heads) {
  const int row = blockIdx.x * kF32DeltaRows + (threadIdx.x >> 4);
  const bool valid = row < rows;
  const size_t at = static_cast<size_t>(valid ? row : 0) * kHeadDim + (threadIdx.x & 15) * 4;
  const float4 a = *reinterpret_cast<const float4*>(o + at);
  const float4 b = *reinterpret_cast<const float4*>(d_out + at);
  float sum = fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
  sum = row_sum16(sum);
  if (valid && (threadIdx.x & 15) == 0) {
    const int head = row % heads, token = (row / heads) % t, img = row / (heads * t);
    delta[(static_cast<size_t>(img) * heads + head) * t + token] = sum;
  }
}

// The rows of a 32-row tile that thread wt of a warpgroup holds: piece tb =
// wt / 16 is rows 8*(tb / 2) + (tb % 2) + 2*i, i = 0..3, dims 4*(wt % 16)..
// The rows of a piece are the k positions 4*tb.. of a transposed plane in
// SplitFragments' order (row 2*t + b of a group of eight at t + 4*b).
__device__ __forceinline__ int piece_row(int wt, int i) {
  const int tb = wt >> 4;
  return 8 * (tb >> 1) + (tb & 1) + 2 * i;
}

// A thread's piece of rows r0.. of a head's (T, 64) matrix (`ld` floats a
// row); zeros past T.
__device__ __forceinline__ void load_piece(float4 (&v)[4], const float* __restrict__ src,
                                           size_t ld, int r0, int t, int wt) {
  const int dim = 4 * (wt & 15);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + piece_row(wt, i);
    v[i] = row < t ? *reinterpret_cast<const float4*>(src + row * ld + dim)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The same piece, copied asynchronously (cp.async, 16 bytes a row, zeros
// past T) into this thread's slots of a landing buffer; the caller commits.
__device__ __forceinline__ void land_piece_async(uint8_t* raw, const float* __restrict__ src,
                                                 size_t ld, int r0, int t, int wt) {
  const int dim = 4 * (wt & 15);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + piece_row(wt, i);
    const bool valid = row < t;
    cp_async_16(shared_address(raw + (i * 128 + wt) * 16), src + (valid ? row : 0) * ld + dim,
                valid);
  }
}

// This thread's landed piece (its own copies: no barrier needed)
__device__ __forceinline__ void read_piece(float4 (&v)[4], const uint8_t* raw, int wt) {
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = reinterpret_cast<const float4*>(raw)[i * 128 + wt];
}

// The piece's hi and lo into K-major row planes (its rows, from row0, of two
// atoms `atom` bytes apart, dims in the rows): 16-byte stores.
__device__ __forceinline__ void store_rows(uint8_t* hi, uint8_t* lo, int atom, int row0,
                                           const float4 (&v)[4], int wt) {
  const int db = wt & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t at = (db >> 3) * atom + swizzled(row0 + piece_row(wt, i), db & 7);
    float4 h, l;
    split_tf32(v[i], h, l);
    *reinterpret_cast<float4*>(hi + at) = h;
    *reinterpret_cast<float4*>(lo + at) = l;
  }
}

// The piece's hi and lo into a transposed plane (64 dims x 32 k positions,
// one atom): dim d's row holds the piece's four rows at positions 4*tb..,
// one 16-byte store a dim. A thread takes its four dims in a rotated order
// (its e-th store is dim 4*db + (e + db / 2) % 4), so that a warp's 32
// stores of each pass fall on every 16-byte bank group four times.
__device__ __forceinline__ void store_columns(uint8_t* hi, uint8_t* lo, const float4 (&v)[4],
                                              int wt) {
  const int tb = wt >> 4, db = wt & 15;
#pragma unroll
  for (int pass = 0; pass < 4; ++pass) {
    const int e = (pass + (db >> 1)) & 3;
    const float4 col = e == 0   ? make_float4(v[0].x, v[1].x, v[2].x, v[3].x)
                       : e == 1 ? make_float4(v[0].y, v[1].y, v[2].y, v[3].y)
                       : e == 2 ? make_float4(v[0].z, v[1].z, v[2].z, v[3].z)
                                : make_float4(v[0].w, v[1].w, v[2].w, v[3].w);
    const uint32_t at = swizzled(4 * db + e, tb);
    float4 h, l;
    split_tf32(col, h, l);
    *reinterpret_cast<float4*>(hi + at) = h;
    *reinterpret_cast<float4*>(lo + at) = l;
  }
}

// A warpgroup's resident 64-row operand: rows r0.. of a head's (T, 64)
// matrix split into two-atom hi and lo planes, in two 32-row passes.
__device__ __forceinline__ void stage_resident(uint8_t* hi, uint8_t* lo,
                                               const float* __restrict__ src, size_t ld, int r0,
                                               int t, int wt) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float4 v[4];
    load_piece(v, src, ld, r0 + half * kF32Stream, t, wt);
    store_rows(hi, lo, kResidentAtom, half * kF32Stream, v, wt);
  }
}

// This warpgroup's 64 x 64 f32 sum (wgmma accumulator layout) -> rows row0..
// of a head's (T, 64) matrix (`ld` floats a row); rows past T are skipped.
__device__ __forceinline__ void store_sum(float* __restrict__ dst, size_t ld, int row0, int t,
                                          const float (&acc)[32], int wt) {
  const int warp = wt >> 5, g = (wt & 31) >> 2, tig = wt & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + warp * 16 + g + 8 * h;
    if (row >= t) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      *reinterpret_cast<float2*>(dst + row * ld + nt * 8 + 2 * tig) =
          make_float2(acc[4 * nt + 2 * h], acc[4 * nt + 2 * h + 1]);
    }
  }
}

// dK and dV of 128 keys of one (image, head), 64 a warpgroup: grid (B*H,
// ceil(T / 128)).
__global__ void __launch_bounds__(kF32BwdThreads, 1)
    tf32x3_backward_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, long long batch_stride,
                               long long token_stride, long long head_stride,
                               const float* __restrict__ d_out, const float* __restrict__ lse,
                               const float* __restrict__ delta, float* __restrict__ dk,
                               float* __restrict__ dv, long long out_batch_stride,
                               long long out_token_stride, long long out_head_stride, int t,
                               int heads, float scale) {
  extern __shared__ uint8_t f32_bwd_raw[];
  const uint32_t base_s = (shared_address(f32_bwd_raw) + 1023u) & ~1023u;
  uint8_t* base = f32_bwd_raw + (base_s - shared_address(f32_bwd_raw));
  // byte offsets from base: each warpgroup's K and V, the streamed planes,
  // the landing buffers, the rows of lse and delta; inside the streamed
  // planes Q, Q^T, dO, dO^T, each hi then lo
  constexpr int kStream = kF32BwdWarpgroups * 4 * kResidentPlane;
  constexpr int kRaw = kStream + kDkvStreamBytes, kStats = kRaw + 2 * kRawBytes;
  constexpr int kQ = 0, kQt = 2 * kStreamPlane, kDo = kQt + 2 * kStreamTPlane;
  constexpr int kDot = kDo + 2 * kStreamPlane;

  const int wg = threadIdx.x >> 7, wt = threadIdx.x & 127;
  const int warp = wt >> 5, g = (wt & 31) >> 2, tig = wt & 3;
  const int img = blockIdx.x / heads, head = blockIdx.x % heads;
  const int k0 = blockIdx.y * kF32BwdRows + wg * kTile;  // this warpgroup's keys
  const size_t in = static_cast<size_t>(img) * batch_stride +
                    static_cast<size_t>(head) * head_stride;
  const size_t ld = static_cast<size_t>(token_stride);
  const size_t do_ld = static_cast<size_t>(heads) * kHeadDim;
  q += in, k += in, v += in;
  d_out += static_cast<size_t>(img) * t * do_ld + head * kHeadDim;
  lse += static_cast<size_t>(blockIdx.x) * t;
  delta += static_cast<size_t>(blockIdx.x) * t;
  const int tiles = (t + kF32Stream - 1) / kF32Stream;
  const float scale_log2 = scale * kLog2e;
  uint8_t* own = base + wg * 4 * kResidentPlane;  // K hi, K lo, V hi, V lo
  const uint32_t own_s = base_s + wg * 4 * kResidentPlane;
  const uint32_t stream_s = base_s + kStream;
  float* stats = reinterpret_cast<float*>(base + kStats);
  float* stats_raw = stats + 2 * kF32Stream;
  // warpgroup 0 lands and splits Q (and lse, delta), warpgroup 1 dO
  uint8_t* raw = base + kRaw + wg * kRawBytes;
  uint8_t* rows = base + kStream + (wg ? kDo : kQ);
  uint8_t* columns = base + kStream + (wg ? kDot : kQt);

  // the next tile lands a tile ahead, each thread the piece it splits
  auto land_tile = [&](int tile) {
    const int q0 = tile * kF32Stream;
    land_piece_async(raw, wg ? d_out : q, wg ? do_ld : ld, q0, t, wt);
    if (wg == 0 && wt < 2 * kF32Stream) {
      const int i = q0 + (wt & (kF32Stream - 1));
      cp_async_4(shared_address(stats_raw + wt), (wt < kF32Stream ? lse : delta) + (i < t ? i : 0),
                 i < t);
    }
    cp_async_commit();
  };

  stage_resident(own, own + kResidentPlane, k, ld, k0, t, wt);
  stage_resident(own + 2 * kResidentPlane, own + 3 * kResidentPlane, v, ld, k0, t, wt);
  land_tile(0);

  float dk_acc[32], dv_acc[32], chunk[32], st[16], dpt[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = chunk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) st[i] = dpt[i] = 0.f;

  for (int j = 0; j < tiles; ++j) {
    // this tile's planes (every warpgroup is done with the last tile's),
    // from the values this thread landed; then the next tile's copies
    cp_async_wait<0>();
    {
      float4 piece[4];
      read_piece(piece, raw, wt);
      store_rows(rows, rows + kStreamPlane, kStreamAtom, 0, piece, wt);
      store_columns(columns, columns + kStreamTPlane, piece, wt);
      if (wg == 0 && wt < 2 * kF32Stream) stats[wt] = stats_raw[wt];
    }
    land_tile(j + 1);
    fence_proxy_async();
    __syncthreads();  // the tile's planes are whole (and, at j = 0, K's and V's)

    wgmma_fence();
    // s^T = K Q^T and dP^T = V dO^T over the 64 dims, two groups
    tf32x3_product<kF32Stream, kHeadDim / 8>(st, own_s, own_s + kResidentPlane, stream_s + kQ,
                                             stream_s + kQ + kStreamPlane, kResidentAtom,
                                             kStreamAtom, false);
    wgmma_commit();
    tf32x3_product<kF32Stream, kHeadDim / 8>(dpt, own_s + 2 * kResidentPlane,
                                             own_s + 3 * kResidentPlane, stream_s + kDo,
                                             stream_s + kDo + kStreamPlane, kResidentAtom,
                                             kStreamAtom, false);
    wgmma_commit();
    const int q0 = j * kF32Stream;
    wgmma_wait<1>();
    fence_registers(st);
    // p^T: rows keys 16*warp + g + 8h, columns queries 8*nt + 2*tig + c
#pragma unroll
    for (int nt = 0; nt < kF32Stream / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = nt * 8 + 2 * tig + c;
        const float neg_l = -stats[col] * kLog2e;
        const bool query_in = q0 + col < t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float p = fast_exp2(fmaf(st[4 * nt + 2 * h + c], scale_log2, neg_l));
          if (!query_in || k0 + warp * 16 + g + 8 * h >= t) p = 0.f;
          st[4 * nt + 2 * h + c] = p;
        }
      }
    }
    SplitFragments<kF32Stream> p_frag, ds_frag;
    p_frag.set(st);
    // dV += p^T dO over the tile's 32 queries, a chunk, while dS^T is made
    fence_registers(chunk);
    wgmma_fence();
    tf32x3_product_rs<kF32Stream>(chunk, p_frag, stream_s + kDot,
                                  stream_s + kDot + kStreamTPlane);
    wgmma_commit();
    wgmma_wait<1>();
    fence_registers(dpt);
    // dS^T = p^T (dP^T - delta) scale
#pragma unroll
    for (int nt = 0; nt < kF32Stream / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float d = stats[kF32Stream + nt * 8 + 2 * tig + c];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * nt + 2 * h + c;
          dpt[e] = st[e] * (dpt[e] - d) * scale;
        }
      }
    }
    ds_frag.set(dpt);
    wgmma_wait<0>();
    fence_registers(chunk);
    add_chunk(dv_acc, chunk);
    // dK += dS^T q, a chunk
    wgmma_fence();
    tf32x3_product_rs<kF32Stream>(chunk, ds_frag, stream_s + kQt,
                                  stream_s + kQt + kStreamTPlane);
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers(chunk);
    add_chunk(dk_acc, chunk);
    __syncthreads();  // every warpgroup's products are done with the planes
  }

  cp_async_wait<0>();  // the copies past the last tile (zeros) have landed
  const size_t out = static_cast<size_t>(img) * out_batch_stride +
                     static_cast<size_t>(head) * out_head_stride;
  store_sum(dk + out, static_cast<size_t>(out_token_stride), k0, t, dk_acc, wt);
  store_sum(dv + out, static_cast<size_t>(out_token_stride), k0, t, dv_acc, wt);
}

// dQ of 128 queries of one (image, head), 64 a warpgroup: grid (B*H,
// ceil(T / 128)).
__global__ void __launch_bounds__(kF32BwdThreads, 1)
    tf32x3_backward_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, long long batch_stride,
                              long long token_stride, long long head_stride,
                              const float* __restrict__ d_out, const float* __restrict__ lse,
                              const float* __restrict__ delta, float* __restrict__ dq,
                              long long out_batch_stride, long long out_token_stride,
                              long long out_head_stride, int t, int heads, float scale) {
  extern __shared__ uint8_t f32_bwd_raw[];
  const uint32_t base_s = (shared_address(f32_bwd_raw) + 1023u) & ~1023u;
  uint8_t* base = f32_bwd_raw + (base_s - shared_address(f32_bwd_raw));
  // byte offsets from base: each warpgroup's Q and dO, the streamed planes,
  // the landing buffers; inside the streamed planes K, K^T, V, each hi then
  // lo
  constexpr int kStream = kF32BwdWarpgroups * 4 * kResidentPlane;
  constexpr int kRaw = kStream + kDqStreamBytes;
  constexpr int kK = 0, kKt = 2 * kStreamPlane, kV = kKt + 2 * kStreamTPlane;

  const int wg = threadIdx.x >> 7, wt = threadIdx.x & 127;
  const int warp = wt >> 5, g = (wt & 31) >> 2, tig = wt & 3;
  const int img = blockIdx.x / heads, head = blockIdx.x % heads;
  const int q0 = blockIdx.y * kF32BwdRows + wg * kTile;  // this warpgroup's queries
  const size_t in = static_cast<size_t>(img) * batch_stride +
                    static_cast<size_t>(head) * head_stride;
  const size_t ld = static_cast<size_t>(token_stride);
  const size_t do_ld = static_cast<size_t>(heads) * kHeadDim;
  q += in, k += in, v += in;
  d_out += static_cast<size_t>(img) * t * do_ld + head * kHeadDim;
  lse += static_cast<size_t>(blockIdx.x) * t;
  delta += static_cast<size_t>(blockIdx.x) * t;
  const int tiles = (t + kF32Stream - 1) / kF32Stream;
  const float scale_log2 = scale * kLog2e;
  uint8_t* own = base + wg * 4 * kResidentPlane;  // Q hi, Q lo, dO hi, dO lo
  const uint32_t own_s = base_s + wg * 4 * kResidentPlane;
  uint8_t* stream = base + kStream;
  const uint32_t stream_s = base_s + kStream;
  // warpgroup 0 lands and splits K (both orientations), warpgroup 1 V
  uint8_t* raw = base + kRaw + wg * kRawBytes;

  auto land_tile = [&](int tile) {
    land_piece_async(raw, wg ? v : k, ld, tile * kF32Stream, t, wt);
    cp_async_commit();
  };

  stage_resident(own, own + kResidentPlane, q, ld, q0, t, wt);
  stage_resident(own + 2 * kResidentPlane, own + 3 * kResidentPlane, d_out, do_ld, q0, t, wt);
  land_tile(0);

  float neg_l[2], d[2];  // of this thread's rows q0 + 16*warp + g + 8h
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    neg_l[h] = row < t ? -lse[row] * kLog2e : 0.f;
    d[h] = row < t ? delta[row] : 0.f;
  }

  float dq_acc[32], chunk[32], s[16], dp[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq_acc[i] = chunk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;

  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<0>();
    {
      float4 piece[4];
      read_piece(piece, raw, wt);
      if (wg == 0) {
        store_rows(stream + kK, stream + kK + kStreamPlane, kStreamAtom, 0, piece, wt);
        store_columns(stream + kKt, stream + kKt + kStreamTPlane, piece, wt);
      } else {
        store_rows(stream + kV, stream + kV + kStreamPlane, kStreamAtom, 0, piece, wt);
      }
    }
    land_tile(j + 1);
    fence_proxy_async();
    __syncthreads();  // the tile's planes are whole (and, at j = 0, Q's and dO's)

    wgmma_fence();
    // s = Q K^T and dP = dO V^T over the 64 dims
    tf32x3_product<kF32Stream, kHeadDim / 8>(s, own_s, own_s + kResidentPlane, stream_s + kK,
                                             stream_s + kK + kStreamPlane, kResidentAtom,
                                             kStreamAtom, false);
    tf32x3_product<kF32Stream, kHeadDim / 8>(dp, own_s + 2 * kResidentPlane,
                                             own_s + 3 * kResidentPlane, stream_s + kV,
                                             stream_s + kV + kStreamPlane, kResidentAtom,
                                             kStreamAtom, false);
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers(s);
    fence_registers(dp);
    // dS: rows queries 16*warp + g + 8h, columns keys 8*nt + 2*tig + c
    const int k0 = j * kF32Stream;
#pragma unroll
    for (int nt = 0; nt < kF32Stream / 8; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool row_in = q0 + warp * 16 + g + 8 * h < t;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * nt + 2 * h + c;
          float p = fast_exp2(fmaf(s[e], scale_log2, neg_l[h]));
          if (!row_in || k0 + nt * 8 + 2 * tig + c >= t) p = 0.f;
          dp[e] = p * (dp[e] - d[h]) * scale;
        }
      }
    }
    SplitFragments<kF32Stream> frag;
    frag.set(dp);
    // dQ += dS k over the tile's 32 keys, a chunk
    fence_registers(chunk);
    wgmma_fence();
    tf32x3_product_rs<kF32Stream>(chunk, frag, stream_s + kKt, stream_s + kKt + kStreamTPlane);
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers(chunk);
    add_chunk(dq_acc, chunk);
    __syncthreads();  // every warpgroup's products are done with the planes
  }

  cp_async_wait<0>();  // the copies past the last tile (zeros) have landed
  const size_t out = static_cast<size_t>(img) * out_batch_stride +
                     static_cast<size_t>(head) * out_head_stride;
  store_sum(dq + out, static_cast<size_t>(out_token_stride), q0, t, dq_acc, wt);
}

// The three launches (delta, dK/dV, dQ) on `stream`; arguments as
// dinov2_flash_backward_f32 takes them.
inline int launch_f32_backward(const float* q, const float* k, const float* v, const float* o,
                               const float* d_out, const float* lse, float* delta, float* dq,
                               float* dk, float* dv, int b, int t, int heads,
                               long long batch_stride, long long token_stride,
                               long long head_stride, long long out_batch_stride,
                               long long out_token_stride, long long out_head_stride,
                               float scale, cudaStream_t stream) {
  const int rows = b * t * heads;
  f32_backward_delta_rows<<<(rows + kF32DeltaRows - 1) / kF32DeltaRows, kF32AttentionThreads,
                            0, stream>>>(o, d_out, delta, rows, t, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(b * heads, (t + kF32BwdRows - 1) / kF32BwdRows);
  static SharedMemoryGrant dkv_grant, dq_grant;
  err = dkv_grant(tf32x3_backward_dkv_kernel, kDkvShared);
  if (err != cudaSuccess) return err;
  tf32x3_backward_dkv_kernel<<<grid, kF32BwdThreads, kDkvShared, stream>>>(
      q, k, v, batch_stride, token_stride, head_stride, d_out, lse, delta, dk, dv,
      out_batch_stride, out_token_stride, out_head_stride, t, heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = dq_grant(tf32x3_backward_dq_kernel, kDqShared);
  if (err != cudaSuccess) return err;
  tf32x3_backward_dq_kernel<<<grid, kF32BwdThreads, kDqShared, stream>>>(
      q, k, v, batch_stride, token_stride, head_stride, d_out, lse, delta, dq, out_batch_stride,
      out_token_stride, out_head_stride, t, heads, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dinov2
