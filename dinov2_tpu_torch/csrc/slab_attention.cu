// K3 and K2 on Hopper: the slab attention core, alone and with the output
// projection behind it,
//
//     K3  out = attention(qkv)                                  (B, T, D)
//     K2  out = x + ls1 * (attention(qkv) @ w_proj + b_proj)    (B, T, D)
//
// for a fused (B, T, 3D) bf16 qkv slab laid out [q | k | v] along features,
// head_dim 64, x (B, T, D) bf16, w_proj (D, D) bf16 stored (in, out), b_proj
// and ls1 as f32 rows. attention() is per head softmax(q k^T * scale) v.
//
// Replaces the Pallas TPU kernels dinov2_tpu/ops/fused_attention.py::
// _slab_kernel (K3, reached through slab_attention) and _slab_proj_kernel
// (K2, reached through slab_attention_block). Those hold one image's whole
// (T, 3D) slab on chip and loop over its heads; here the work is cut the
// other way, one block per (image, head, 64-query tile), and the blocks are
// independent.
//
// What bounds them on an H100, at ViT-g/14's classify shape (B=16, T=257,
// D=1536, H=24). K3: 4*B*H*T^2*64 = 6.5 GFLOP over 37.9 MB of slab in and
// 12.6 MB out: ~130 FLOP per byte, under the card's ~295, so bytes bind it
// (~0.015 ms at 3.35 TB/s). K2 adds the 19.4 GFLOP proj GEMM and the residual
// read: 25.9 GFLOP over 67.8 MB, and operations bind it (~0.026 ms at 989
// TFLOP/s bf16).
//
// Design: both are entry points on the code K1 already runs
// (half_layer.cuh), not a second core.
//   K3: one launch of slab_attention_kernel, grid (B*H, ceil(T/64)): a block
//       holds a 64-query tile in registers and streams 64-key K/V tiles out
//       of the slab at column offsets h*64, D+h*64 and 2D+h*64 (row stride
//       3D, no head transposes) with the exact online softmax
//       (attention_core.cuh::attention_tile); the ragged tail is masked. K/V
//       tiles are re-read from L2 by the ceil(T/64) query tiles of a head.
//   K2: that launch into an attention buffer (B, T, D) the caller allocated,
//       then gemm_core.cuh's GEMM on it with the residual epilogue, in the
//       JAX package's order: f32 accumulate -> bf16 -> + bf16(b_proj) ->
//       * bf16(ls1) -> + x. These are K1's second and third launches, so on
//       K1's own slab the output is K1's bit for bit. The TPU kernel keeps
//       the attention output on chip; this version writes and re-reads it
//       through HBM (12.6 MB at the shape above), as K1 does.
// Pipelined loads, wgmma and keeping the attention output on chip are left
// for later work.
//
// Shared memory is static (< 48 KB per block). Every entry point returns
// cudaGetLastError() after its launches.

#include "half_layer.cuh"

namespace {

using namespace dinov2;

cudaError_t launch_slab_attention(const bf16* qkv, bf16* out, int b, int t, int d, int heads,
                                  float scale, cudaStream_t s) {
  slab_attention_kernel<<<dim3(b * heads, (t + kTile - 1) / kTile), kThreads, 0, s>>>(
      qkv, out, t, d, heads, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K3, one launch on `stream`: qkv (B, T, 3D) -> out (B, T, D), both bf16 and
// contiguous. Requires D == 64 * heads, 16-byte aligned pointers, and the
// tensors' device current on the calling thread (the caller sets it).
int dinov2_slab_attention_bf16(const void* qkv, void* out, int b, int t, int d, int heads,
                               float scale, void* stream) {
  return launch_slab_attention(static_cast<const bf16*>(qkv), static_cast<bf16*>(out), b, t, d,
                               heads, scale, static_cast<cudaStream_t>(stream));
}

// K2, two launches on `stream`. attn_scratch (B, T, D) is a bf16 buffer the
// caller allocated; out is (B, T, D). Same requirements as K3.
int dinov2_slab_attention_block_bf16(const void* x, const void* qkv, const void* w_proj,
                                     const void* b_proj, const void* ls1, void* attn_scratch,
                                     void* out, int b, int t, int d, int heads, float scale,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* attn = static_cast<bf16*>(attn_scratch);
  cudaError_t err =
      launch_slab_attention(static_cast<const bf16*>(qkv), attn, b, t, d, heads, scale, s);
  if (err != cudaSuccess) return err;
  const int m = b * t;
  gemm_kernel<DenseWeightTile, ResidualEpilogue>
      <<<dim3(d / kTile, (m + kTile - 1) / kTile), kThreads, 0, s>>>(
          attn, DenseWeightTile{static_cast<const bf16*>(w_proj), d},
          ResidualEpilogue{static_cast<const float*>(b_proj), static_cast<const float*>(ls1),
                           static_cast<const bf16*>(x), static_cast<bf16*>(out), d},
          m, d);
  return cudaGetLastError();
}

const char* dinov2_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
