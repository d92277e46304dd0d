// Shared pieces of the port's hand-written Hopper kernels: small helpers
// (wgmma_tiles.cuh, and through it K4 and K6, takes them too), mma.sync, and
// the attention core that K1, K2, K3 and K8 run (half_layer.cuh). K4
// (flash_attention.cu) has its own wgmma tile loop.
//
// attention_tile computes, for one (image, head) pair and a tile of 64
// queries, out = softmax(q k^T * scale) v with head_dim 64 and bf16 q/k/v
// read through pointers and a token stride, so the same code reads a
// (B, T, 3D) qkv slab (stride 3D, k and v at column offsets D and 2D) or
// (B, T, H, 64) tensors (stride H*64). Numerics are those of the JAX
// package's _attn_kernel: f32 scores times `scale`, exact online softmax with
// the running row max and f32 row sums, P rounded to bf16 for the P.V mma
// with f32 accumulation, one division by the row sum at the end, bf16 output.
// Keys past T are masked to -inf and their K/V rows zero-filled: the ragged
// tail is never padded in memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dinov2 {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;        // GEMM tile rows/cols/depth; attention query/key tile
constexpr int kLds = kTile + 8;  // shared row stride in elements (144 B): conflict-free fragment loads
constexpr int kThreads = 128;    // four warps
constexpr int kHeadDim = 64;
// minimum resident blocks per SM for a kernel that runs attention_tile:
// caps it at 128 registers a thread, so four 128-thread blocks fit in the
// SM's 64K registers (at 135 registers only three do)
constexpr int kAttentionBlocksPerSm = 4;

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two adjacent bf16 as one 32-bit register (lower address in the low half)
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_pair(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  return pack_pair(__float2bfloat16(lo), __float2bfloat16(hi));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Queries q0..q0+63 of one (image, head): q, k and v point at token 0 of that
// head, `ld` elements apart per token; out likewise with `out_ld`. Run by all
// kThreads threads of a block. Warp w owns queries 16w..16w+15 of the tile.
// Score and output fragments stay in registers (mma.sync accumulator layout:
// rows g and g+8, columns 2*tig and 2*tig+1 of each 8-wide n-tile); a score
// accumulator is reused directly as the A operand of the P.V product.
// Needs 16-byte aligned rows: ld, out_ld and the pointers' offsets are
// multiples of 8 elements.
// With kWithLse (the training forward) it also writes each row's logsumexp
// of the scaled scores, m + log(max(l, 1e-30)), to lse[row] (f32, token 0 of
// this head first). It is a compile-time variant: without it the code is the
// inference kernels', instruction for instruction.
template <bool kWithLse = false>
__device__ __forceinline__ void attention_tile(const bf16* __restrict__ q,
                                               const bf16* __restrict__ k,
                                               const bf16* __restrict__ v, size_t ld,
                                               bf16* __restrict__ out, size_t out_ld,
                                               int t, int q0, float scale,
                                               float* __restrict__ lse = nullptr) {
  __shared__ __align__(16) bf16 qs[kTile][kLds];
  __shared__ __align__(16) bf16 ks[kTile][kLds];
  __shared__ __align__(16) bf16 vs[kTile][kLds];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < kTile * kHeadDim / 8; i += kThreads) {
    const int r = i >> 3, c = (i & 7) * 8;
    *reinterpret_cast<uint4*>(&qs[r][c]) =
        q0 + r < t ? *reinterpret_cast<const uint4*>(q + (q0 + r) * ld + c) : zero;
  }
  __syncthreads();

  uint32_t qf[4][4];
  const int qr = warp * 16 + g;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    qf[kc][0] = ld_pair(&qs[qr][16 * kc + 2 * tig]);
    qf[kc][1] = ld_pair(&qs[qr + 8][16 * kc + 2 * tig]);
    qf[kc][2] = ld_pair(&qs[qr][16 * kc + 8 + 2 * tig]);
    qf[kc][3] = ld_pair(&qs[qr + 8][16 * kc + 8 + 2 * tig]);
  }

  float o[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[nt][j] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < t; k0 += kTile) {
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < kTile * kHeadDim / 8; i += kThreads) {
      const int r = i >> 3, c = (i & 7) * 8;
      uint4 kv = zero, vv = zero;
      if (k0 + r < t) {
        kv = *reinterpret_cast<const uint4*>(k + (k0 + r) * ld + c);
        vv = *reinterpret_cast<const uint4*>(v + (k0 + r) * ld + c);
      }
      *reinterpret_cast<uint4*>(&ks[r][c]) = kv;
      *reinterpret_cast<uint4*>(&vs[r][c]) = vv;
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = 0.f;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const bf16* krow = &ks[nt * 8 + g][16 * kc + 2 * tig];
        mma_16816(s[nt], qf[kc], ld_pair(krow), ld_pair(krow + 8));
      }
    }

    // scale, mask the keys past T, running row max (rows g and g+8)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + nt * 8 + 2 * tig + (j & 1);
        const float sv = key < t ? s[nt][j] * scale : -INFINITY;
        s[nt][j] = sv;
        mx[j >> 1] = fmaxf(mx[j >> 1], sv);
      }
    }
    float m_new[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      m_new[h] = fmaxf(m_run[h], mx[h]);  // finite: key k0 < T is never masked
      alpha[h] = expf(m_run[h] - m_new[h]);
      m_run[h] = m_new[h];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[nt][j] - m_new[j >> 1]);
        s[nt][j] = p;
        rs[j >> 1] += p;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
      l_run[h] = l_run[h] * alpha[h] + rs[h];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }

    // o += bf16(P) @ V; keys 16kc..16kc+15 are score n-tiles 2kc and 2kc+1
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t pf[4] = {
          pack_floats(s[2 * kc][0], s[2 * kc][1]),
          pack_floats(s[2 * kc][2], s[2 * kc][3]),
          pack_floats(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          pack_floats(s[2 * kc + 1][2], s[2 * kc + 1][3]),
      };
      const int kr = 16 * kc + 2 * tig;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = nt * 8 + g;
        const uint32_t b0 = pack_pair(vs[kr][c], vs[kr + 1][c]);
        const uint32_t b1 = pack_pair(vs[kr + 8][c], vs[kr + 9][c]);
        mma_16816(o[nt], pf, b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    if (row >= t) continue;
    bf16* dst = out + row * out_ld + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      *reinterpret_cast<uint32_t*>(dst + nt * 8) =
          pack_floats(o[nt][2 * h] / l_run[h], o[nt][2 * h + 1] / l_run[h]);
    }
    if constexpr (kWithLse) {
      if (tig == 0) lse[row] = m_run[h] + logf(fmaxf(l_run[h], 1e-30f));
    }
  }
}

}  // namespace dinov2
