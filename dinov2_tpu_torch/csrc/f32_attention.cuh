// The f32 forward attention, K4's f32 variant, shared by flash_attention.cu
// (K4, with and without lse) and, on the head views of a (B, T, 3D) f32 qkv
// slab, by slab_attention.cu (K3, K2) and half_layer.cuh (K1, K8):
//
//     out[b, t, h, :] = sum_k softmax_k(scale * q[b, t, h] . k[b, k, h]) v[b, k, h]
//
// for f32 q, k, v of head_dim 64 read through three base pointers that share
// a batch, a token and a head stride (multiples of 4 elements), and a
// contiguous (B, T, H, 64) f32 output; with kWithLse also the (B, H, T) f32
// row logsumexp of the scaled scores, lse = scale * max + log(l), which K6
// f32 (f32_backward.cuh) reads.
//
// Replaces, for f32 activations, the Pallas TPU kernels of
// dinov2_tpu/ops/flash_attention.py (_attn_kernel_1kv, _attn_kernel) and the
// attention core of dinov2_tpu/ops/fused_attention.py (_slab_kernel,
// _head_softmax_pv), which are generic in dtype: f32 scores, an f32 softmax
// on the exact row max, and P kept in f32 for P.V (p.astype(v.dtype) is a
// no-op). The products must be f32-accurate (f32_gemm.cuh's note): both run
// as 3xTF32 on wgmma (tf32x3.cuh), on the tensor cores.
//
// What bounds it on an H100: 4*B*H*T^2*64 FLOP (61.5 GFLOP at B=8, T=1370,
// H=16: 0.373 ms at 3xTF32's 165 TFLOP/s, against 0.05 ms for the 180 MB of
// q/k/v/out at 3.35 TB/s): operations bind it. Beside the products every
// score takes a mask, a max, an ex2 and a sum on the CUDA cores (the ex2s
// alone, 16 a clock an SM, take ~0.06 ms at that shape).
//
// Design: K6 f32's dQ kernel with P in place of dS and V in place of K. A
// block is two warpgroups, each with 64 query rows of one (image, head): a
// 1-D grid of B*H*ceil(T / 128) blocks, the query blocks of one head
// adjacent, so that they stream its K and V from L2 together. Each
// warpgroup's Q lies in shared memory as K-major hi and lo TF32 planes
// (tf32x3.cuh's split, once, where it is staged), the A operand of s = Q K^T
// (wgmma m64n32k8 over the 64 dims, one chunk); it is read from there every
// tile and never carried in registers across the loop. 32-key tiles of K and
// V land by cp.async a tile ahead, each thread the pieces it splits itself
// (16 bytes a row): warpgroup 0 splits K into row planes, warpgroup 1 V into
// transposed planes (64 dims x 32 keys, keys in the order 0, 2, 4, 6, 1, 3,
// 5, 7 within each group of eight: SplitFragments' order), into a ring of
// two plane stages. Tile j + 1's split runs while the tensor cores take tile
// j's s; one barrier a tile hands the planes over. The online softmax runs on
// s's accumulator layout: a row's 32 scores lie in the four lanes of a quad,
// so its max is two shuffles. It keeps the exact running row max; exp is one
// ex2 of s * scale*log2(e) - m * scale*log2(e); each thread keeps its share of
// the row sum, added over the quad once at the end. P, made in s's registers
// within the iteration, is split by SplitFragments into the register A
// operand of P.V (m64n64k8) on V's transposed planes: a fresh chunk each
// tile, folded in as O = O * alpha + chunk with rounded f32 operations
// (tf32x3.cuh's note on truncation). The ragged tail is masked, never padded
// in memory: rows past T are zero-filled in shared memory, keys past T get
// -inf, queries past T are not written, and a warpgroup whose 64 rows all
// lie past T only splits its share of the tiles.
//
// Shared memory is dynamic: Q's planes (64 KB), two stages of K's and V^T's
// planes (64 KB) and the landing buffers (16 KB), 145 KB with alignment
// slack: one block an SM (199-201 registers a thread, no spill). Two other
// schedules ran slower on an H100 80GB HBM3 at 700 W (PERF.md): the split
// beside P.V instead of beside s (3-4%), and a three-stage ring that starts
// tile j + 1's s before tile j's softmax and splits beside both (2-8% in its
// forms that ptxas compiles without a C751x note).
//
// The plane helpers below (a thread's 4 x 4 piece of a 32-row tile, landed,
// split into row or transposed planes) are K6 f32's too.

#pragma once

#include "tf32x3.cuh"

namespace dinov2 {
namespace {

constexpr int kF32Stream = 32;  // rows of a streamed tile
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
static_assert(kF32Stream * kHeadDim / 16 == 128, "a thread holds one 4 x 4 piece of a tile");

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

constexpr int kF32FwdWarpgroups = 2;  // one lands and splits K, the other V
constexpr int kF32FwdThreads = 128 * kF32FwdWarpgroups;
constexpr int kF32FwdRows = kTile * kF32FwdWarpgroups;  // queries of a block
// a stage: K's row planes then V^T's transposed planes, hi then lo each
constexpr int kF32FwdVt = 2 * kStreamPlane;
constexpr int kF32FwdStage = kF32FwdVt + 2 * kStreamTPlane;
constexpr int kF32FwdShared =
    1024 + kF32FwdWarpgroups * 2 * kResidentPlane + 2 * kF32FwdStage + 2 * kRawBytes;
static_assert(kF32FwdShared <= 232448, "a block's planes fit");

template <bool kWithLse>
__global__ void __launch_bounds__(kF32FwdThreads, 1)
    tf32x3_attention_forward_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                    const float* __restrict__ v, long long batch_stride,
                                    long long token_stride, long long head_stride,
                                    float* __restrict__ out, float* __restrict__ lse, int t,
                                    int heads, float scale) {
  extern __shared__ uint8_t f32_fwd_raw[];
  const uint32_t base_s = (shared_address(f32_fwd_raw) + 1023u) & ~1023u;
  uint8_t* base = f32_fwd_raw + (base_s - shared_address(f32_fwd_raw));
  // byte offsets from base: each warpgroup's Q (hi, lo), the two stages, the
  // landing buffers of K and V
  constexpr int kStages = kF32FwdWarpgroups * 2 * kResidentPlane;
  constexpr int kRaw = kStages + 2 * kF32FwdStage;

  const int wg = threadIdx.x >> 7, wt = threadIdx.x & 127;
  const int warp = wt >> 5, g = (wt & 31) >> 2, tig = wt & 3;
  const int query_blocks = (t + kF32FwdRows - 1) / kF32FwdRows;
  const int head_row = blockIdx.x / query_blocks;  // img * heads + head
  const int img = head_row / heads, head = head_row % heads;
  const int q0 = (blockIdx.x % query_blocks) * kF32FwdRows + wg * kTile;  // this warpgroup's
  const size_t in = static_cast<size_t>(img) * batch_stride +
                    static_cast<size_t>(head) * head_stride;
  const size_t ld = static_cast<size_t>(token_stride);
  q += in, k += in, v += in;
  const int tiles = (t + kF32Stream - 1) / kF32Stream;
  const float scale_log2 = scale * kLog2e;
  uint8_t* own = base + wg * 2 * kResidentPlane;  // Q hi, Q lo
  const uint32_t own_s = base_s + wg * 2 * kResidentPlane;

  // warpgroup 0 lands K and splits it into row planes, warpgroup 1 lands V
  // and splits it into transposed planes, each thread the piece it lands
  uint8_t* raw = base + kRaw + wg * kRawBytes;
  auto land_tile = [&](int tile) {
    land_piece_async(raw, wg ? v : k, ld, tile * kF32Stream, t, wt);
    cp_async_commit();
  };
  // tile j + 1's planes from the values this thread landed (every warpgroup
  // is done with the stage they go to), then tile j + 2's copies
  auto next_tile = [&](int j) {
    cp_async_wait<0>();
    float4 piece[4];
    read_piece(piece, raw, wt);
    uint8_t* planes = base + kStages + ((j + 1) & 1) * kF32FwdStage;
    if (wg == 0) {
      store_rows(planes, planes + kStreamPlane, kStreamAtom, 0, piece, wt);
    } else {
      store_columns(planes + kF32FwdVt, planes + kF32FwdVt + kStreamTPlane, piece, wt);
    }
    land_tile(j + 2);
  };

  stage_resident(own, own + kResidentPlane, q, ld, q0, t, wt);
  land_tile(0);
  next_tile(-1);  // tile 0's planes, tile 1's copies
  fence_proxy_async();
  __syncthreads();  // Q's planes and tile 0's are whole

  if (q0 >= t) {  // this warpgroup's rows all lie past T: it only splits
    for (int j = 0; j < tiles; ++j) {
      next_tile(j);
      fence_proxy_async();
      __syncthreads();
    }
    cp_async_wait<0>();
    return;
  }

  // o: rows 16*warp + g + 8h (h = e / 2 % 2), dims 8*nt + 2*tig + e % 2
  float o[32], chunk[32], s[16], m_run[2], l_part[2];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = chunk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) m_run[h] = -INFINITY, l_part[h] = 0.f;

  for (int j = 0; j < tiles; ++j) {
    const uint32_t stage_s = base_s + kStages + (j & 1) * kF32FwdStage;
    wgmma_fence();
    // s = Q K^T over the 64 dims, a chunk
    tf32x3_product<kF32Stream, kHeadDim / 8>(s, own_s, own_s + kResidentPlane, stage_s,
                                             stage_s + kStreamPlane, kResidentAtom,
                                             kStreamAtom, false);
    wgmma_commit();
    next_tile(j);  // while the tensor cores take s
    wgmma_wait<0>();
    fence_registers(s);
    // s: rows queries 16*warp + g + 8h, columns keys 8*nt + 2*tig + c
    const int k0 = j * kF32Stream;
    if (k0 + kF32Stream > t) {  // the last tile: the keys past T get -inf
#pragma unroll
      for (int nt = 0; nt < kF32Stream / 8; ++nt) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (k0 + nt * 8 + 2 * tig + c >= t) s[4 * nt + c] = s[4 * nt + 2 + c] = -INFINITY;
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float top = s[2 * h];
#pragma unroll
      for (int nt = 0; nt < kF32Stream / 8; ++nt) {
        top = fmaxf(top, fmaxf(s[4 * nt + 2 * h], s[4 * nt + 2 * h + 1]));
      }
      top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 1));
      top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 2));
      // every tile holds a key below T, so the new maximum is finite
      const float m_new = fmaxf(m_run[h], top);
      alpha[h] = fast_exp2((m_run[h] - m_new) * scale_log2);
      const float neg_m = -m_new * scale_log2;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kF32Stream / 8; ++nt) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * nt + 2 * h + c;
          s[e] = fast_exp2(fmaf(s[e], scale_log2, neg_m));
          sum += s[e];
        }
      }
      l_part[h] = l_part[h] * alpha[h] + sum;
      m_run[h] = m_new;
    }
    SplitFragments<kF32Stream> frag;
    frag.set(s);
    // P V over the tile's 32 keys, a chunk
    fence_registers(chunk);
    wgmma_fence();
    tf32x3_product_rs<kF32Stream>(chunk, frag, stage_s + kF32FwdVt,
                                  stage_s + kF32FwdVt + kStreamTPlane);
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers(chunk);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = __fadd_rn(__fmul_rn(o[i], alpha[(i >> 1) & 1]), chunk[i]);
    fence_proxy_async();
    __syncthreads();  // the next tile's planes are whole; every warpgroup is done with these
  }
  cp_async_wait<0>();  // the copies past the last tile (zeros) have landed

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    float l = l_part[h] + __shfl_xor_sync(0xffffffffu, l_part[h], 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (row >= t) continue;
    const float inv = 1.f / l;
    float* dst = out + ((static_cast<size_t>(img) * t + row) * heads + head) * kHeadDim;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      *reinterpret_cast<float2*>(dst + nt * 8 + 2 * tig) =
          make_float2(o[4 * nt + 2 * h] * inv, o[4 * nt + 2 * h + 1] * inv);
    }
    if (kWithLse && tig == 0) {
      lse[static_cast<size_t>(head_row) * t + row] = m_run[h] * scale + logf(fmaxf(l, 1e-30f));
    }
  }
}

template <bool kWithLse>
int launch_f32_forward(const float* q, const float* k, const float* v, float* out, float* lse,
                       int b, int t, int heads, long long batch_stride, long long token_stride,
                       long long head_stride, float scale, cudaStream_t stream) {
  auto kernel = tf32x3_attention_forward_kernel<kWithLse>;
  static SharedMemoryGrant grant;
  const cudaError_t err = grant(kernel, kF32FwdShared);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(b) * heads * ((t + kF32FwdRows - 1) / kF32FwdRows);
  kernel<<<static_cast<unsigned>(blocks), kF32FwdThreads, kF32FwdShared, stream>>>(
      q, k, v, batch_stride, token_stride, head_stride, out, lse, t, heads, scale);
  return cudaGetLastError();
}

// The f32 attention output (B, T, D) of a (B, T, 3D) f32 qkv slab: the
// kernel above on the slab's head views, q, k and v at column offsets h*64,
// D + h*64 and 2D + h*64. One launch on s.
inline cudaError_t launch_f32_slab_attention(const float* qkv, float* out, int b, int t, int d,
                                             int heads, float scale, cudaStream_t s) {
  const long long token_stride = 3LL * d;
  return static_cast<cudaError_t>(launch_f32_forward<false>(
      qkv, qkv + d, qkv + 2 * d, out, nullptr, b, t, heads, t * token_stride, token_stride,
      kHeadDim, scale, s));
}

}  // namespace
}  // namespace dinov2
