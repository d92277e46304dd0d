// K1 on Hopper: the whole attention half-layer of a DINOv2 encoder layer,
//
//     out = x + ls1 * (proj(attention(qkv(LN1(x)))) + b_proj)
//
// for x (B, T, D) bf16, w_qkv (D, 3D) and w_proj (D, D) bf16 stored (in, out),
// LN scale/bias, biases and LayerScale as f32 rows, head_dim 64.
//
// Replaces the Pallas TPU kernel dinov2_tpu/ops/fused_attention.py::
// _slab_layer_kernel (softmax core _head_softmax_pv, head loop
// _attention_heads_sliced), reached through slab_layer_block.
//
// What bounds it on an H100: at the main path's shape (B=64, T=257, D=768,
// H=12) one call is ~91 GFLOP: 58 in the QKV GEMM, 19 in proj and 13 in
// attention. The whole 12-layer forward is ~2.9 TFLOP, 1.1 of it here. At
// 989 TFLOP/s bf16 the floor is ~0.09 ms per call; the weights (4.7 MB) and x
// (25 MB in, 25 MB out) are small next to that.
//
// Design of this first version: three launches on the caller's stream.
//   1. gemm_kernel<LN>: per 64-row tile, two-pass f32 LN statistics, then the
//      normalized bf16 rows are made tile by tile in shared memory and
//      multiplied by w_qkv with mma.sync m16n8k16 (bf16 in, f32 accumulate).
//      Epilogue: bf16(acc) + bf16(b_qkv) -> qkv slab (B, T, 3D) in HBM.
//   2. attention_kernel: grid (B*H, ceil(T/64)). Each block holds a 64-query
//      tile and streams 64-key K/V tiles straight out of the slab at column
//      offsets h*64, D+h*64 and 2D+h*64 (no head transposes). The ragged tail
//      (T=257 = 4*64+1) is masked, not padded. Exact online softmax with the
//      running row max: f32 scores and softmax, P rounded to bf16 for the P.V
//      mma with f32 accumulation, divided by the f32 row sum at the end.
//      Output bf16 into an attention slab (B, T, D) in HBM.
//   3. gemm_kernel<residual>: attn @ w_proj, epilogue
//      bf16(acc) + bf16(b_proj), * bf16(ls1), + x, each step rounded to bf16.
// The TPU kernel keeps the qkv slab and the attention output on chip; this
// version writes and re-reads both (76 MB of qkv and 25 MB of attention per
// call at the main-path shape). Keeping them on chip, wgmma and TMA, and
// pipelined tile loads are left for later work.
//
// Numerics follow the JAX package's cast points (fused_attention.py:600-626):
// f32 LN statistics, LN affine in f32 then one bf16 cast; f32-accumulated
// GEMMs cast to bf16 before the bias add; f32 scores and softmax; bf16 P.V
// with f32 accumulation. The 1/sqrt(64) = 1/8 scale multiplies the f32
// scores (exact: a power of two); the log2(e) fold into bf16 q that the TPU
// kernel makes is not copied.
//
// Shared memory is static (< 48 KB per block), so no opt-in attribute is
// needed. Every entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;        // GEMM tile rows/cols/depth; attention query/key tile
constexpr int kLds = kTile + 8;  // shared row stride in elements (144 B): conflict-free fragment loads
constexpr int kThreads = 128;    // four warps
constexpr int kHeadDim = 64;

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

// out (M, N) = epilogue(A' @ W) with A (M, K), W (K, N) row-major bf16 and
// A' = LN(A) when kLayerNorm. One 64x64 output tile per block; warp w owns
// rows 32*(w/2).. and cols 32*(w%2).. of it. K and N are multiples of 64.
// Epilogue: y = bf16(acc) + bf16(bias); with kResidual also
// out = resid + bf16(y * bf16(ls)).
template <bool kLayerNorm, bool kResidual>
__global__ void __launch_bounds__(kThreads)
    gemm_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                float eps, const float* __restrict__ bias, const float* __restrict__ ls,
                const bf16* __restrict__ resid, bf16* __restrict__ out, int m, int n,
                int k) {
  __shared__ __align__(16) bf16 as[kTile][kLds];
  __shared__ __align__(16) bf16 ws[kTile][kLds];
  __shared__ float row_mu[kTile];
  __shared__ float row_rstd[kTile];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int warp_m = warp >> 1, warp_n = warp & 1;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;

  if (kLayerNorm) {
    // two-pass f32 statistics of the tile's rows, one warp per row
    for (int r = warp; r < kTile; r += kThreads / 32) {
      const int row = row0 + r;
      float mu = 0.f, rstd = 0.f;
      if (row < m) {
        const bf16* src = a + static_cast<size_t>(row) * k;
        float s = 0.f;
        for (int c = lane; c < k; c += 32) s += __bfloat162float(src[c]);
        mu = warp_sum(s) / static_cast<float>(k);
        float v = 0.f;
        for (int c = lane; c < k; c += 32) {
          const float dlt = __bfloat162float(src[c]) - mu;
          v += dlt * dlt;
        }
        rstd = 1.f / sqrtf(warp_sum(v) / static_cast<float>(k) + eps);
      }
      if (lane == 0) {
        row_mu[r] = mu;
        row_rstd[r] = rstd;
      }
    }
    __syncthreads();
  }

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kTile) {
    // stage one 64x64 tile of A' and of W, 8 values (16 bytes) per load
    for (int i = tid; i < kTile * kTile / 8; i += kThreads) {
      const int r = i >> 3, c = (i & 7) * 8;
      const int row = row0 + r;
      uint4 va = make_uint4(0u, 0u, 0u, 0u);
      if (row < m) {
        va = *reinterpret_cast<const uint4*>(a + static_cast<size_t>(row) * k + k0 + c);
        if (kLayerNorm) {
          bf16* e = reinterpret_cast<bf16*>(&va);
          const float mu = row_mu[r], rstd = row_rstd[r];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            // (x - mu) * rstd * scale + bias in f32, no fused multiply-add,
            // then one bf16 cast
            const float h = __fmul_rn(__bfloat162float(e[j]) - mu, rstd);
            e[j] = __float2bfloat16(
                __fadd_rn(__fmul_rn(h, ln_scale[k0 + c + j]), ln_bias[k0 + c + j]));
          }
        }
      }
      *reinterpret_cast<uint4*>(&as[r][c]) = va;
      *reinterpret_cast<uint4*>(&ws[r][c]) = *reinterpret_cast<const uint4*>(
          w + static_cast<size_t>(k0 + r) * n + col0 + c);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kTile; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = warp_m * 32 + mi * 16 + g;
        af[mi][0] = ld_pair(&as[r][kk + 2 * tig]);
        af[mi][1] = ld_pair(&as[r + 8][kk + 2 * tig]);
        af[mi][2] = ld_pair(&as[r][kk + 8 + 2 * tig]);
        af[mi][3] = ld_pair(&as[r + 8][kk + 8 + 2 * tig]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = warp_n * 32 + ni * 8 + g;
        const uint32_t b0 = pack_pair(ws[kk + 2 * tig][c], ws[kk + 2 * tig + 1][c]);
        const uint32_t b1 = pack_pair(ws[kk + 8 + 2 * tig][c], ws[kk + 9 + 2 * tig][c]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_16816(acc[mi][ni], af[mi], b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = col0 + warp_n * 32 + ni * 8 + 2 * tig;
      const float bias0 = round_bf16(bias[c]), bias1 = round_bf16(bias[c + 1]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + warp_m * 32 + mi * 16 + g + 8 * half;
        if (row >= m) continue;
        float y0 = round_bf16(round_bf16(acc[mi][ni][2 * half]) + bias0);
        float y1 = round_bf16(round_bf16(acc[mi][ni][2 * half + 1]) + bias1);
        const size_t at = static_cast<size_t>(row) * n + c;
        if (kResidual) {
          y0 = __bfloat162float(resid[at]) + round_bf16(y0 * round_bf16(ls[c]));
          y1 = __bfloat162float(resid[at + 1]) + round_bf16(y1 * round_bf16(ls[c + 1]));
        }
        *reinterpret_cast<uint32_t*>(out + at) = pack_floats(y0, y1);
      }
    }
  }
}

// out[b, t, h*64:(h+1)*64] = softmax(q k^T * scale) v for one (image, head)
// pair and a tile of 64 queries; qkv is the (B, T, 3D) slab [q | k | v].
// Warp w owns queries 16w..16w+15 of the tile. Score and output fragments
// stay in registers (mma.sync accumulator layout: row g and g+8, columns
// 2*tig and 2*tig+1 of each 8-wide n-tile); a score accumulator is reused
// directly as the A operand of the P.V product.
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int t, int d,
                     int heads, float scale) {
  __shared__ __align__(16) bf16 qs[kTile][kLds];
  __shared__ __align__(16) bf16 ks[kTile][kLds];
  __shared__ __align__(16) bf16 vs[kTile][kLds];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int img = blockIdx.x / heads, head = blockIdx.x % heads;
  const int q0 = blockIdx.y * kTile;
  const size_t ld = 3 * static_cast<size_t>(d);
  const bf16* base = qkv + static_cast<size_t>(img) * t * ld + head * kHeadDim;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < kTile * kHeadDim / 8; i += kThreads) {
    const int r = i >> 3, c = (i & 7) * 8;
    *reinterpret_cast<uint4*>(&qs[r][c]) =
        q0 + r < t ? *reinterpret_cast<const uint4*>(base + (q0 + r) * ld + c) : zero;
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
        const bf16* src = base + (k0 + r) * ld + c;
        kv = *reinterpret_cast<const uint4*>(src + d);
        vv = *reinterpret_cast<const uint4*>(src + 2 * d);
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
        const float v = key < t ? s[nt][j] * scale : -INFINITY;
        s[nt][j] = v;
        mx[j >> 1] = fmaxf(mx[j >> 1], v);
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
    bf16* dst = out + (static_cast<size_t>(img) * t + row) * d + head * kHeadDim + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      *reinterpret_cast<uint32_t*>(dst + nt * 8) =
          pack_floats(o[nt][2 * h] / l_run[h], o[nt][2 * h + 1] / l_run[h]);
    }
  }
}

}  // namespace

extern "C" {

// The whole half-layer, three launches on `stream`. qkv_scratch (B, T, 3D)
// and attn_scratch (B, T, D) are bf16 buffers the caller allocated; out is
// (B, T, D). Requires D == 64 * heads, 16-byte aligned pointers, and the
// tensors' device current on the calling thread (the caller sets it).
int dinov2_slab_layer_bf16(const void* x, const void* ln_scale, const void* ln_bias,
                           const void* w_qkv, const void* b_qkv, const void* w_proj,
                           const void* b_proj, const void* ls1, void* qkv_scratch,
                           void* attn_scratch, void* out, int b, int t, int d, int heads,
                           float scale, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = b * t;
  const int row_tiles = (m + kTile - 1) / kTile;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* qkv = static_cast<bf16*>(qkv_scratch);
  bf16* attn = static_cast<bf16*>(attn_scratch);

  gemm_kernel<true, false><<<dim3(3 * d / kTile, row_tiles), kThreads, 0, s>>>(
      xb, static_cast<const bf16*>(w_qkv), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), eps, static_cast<const float*>(b_qkv), nullptr,
      nullptr, qkv, m, 3 * d, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  attention_kernel<<<dim3(b * heads, (t + kTile - 1) / kTile), kThreads, 0, s>>>(
      qkv, attn, t, d, heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  gemm_kernel<false, true><<<dim3(d / kTile, row_tiles), kThreads, 0, s>>>(
      attn, static_cast<const bf16*>(w_proj), nullptr, nullptr, 0.f,
      static_cast<const float*>(b_proj), static_cast<const float*>(ls1), xb,
      static_cast<bf16*>(out), m, d, d);
  return cudaGetLastError();
}

const char* dinov2_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
