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
// other way, one block per (image, head, query tile), and the blocks are
// independent.
//
// What bounds them on an H100, at ViT-g/14's classify shape (B=16, T=257,
// D=1536, H=24). K3: 4*B*H*T^2*64 = 6.5 GFLOP over 37.9 MB of slab in and
// 12.6 MB out: ~130 FLOP per byte, under the card's ~295, so bytes bind it
// (~0.015 ms at 3.35 TB/s). K2 adds the 19.4 GFLOP proj GEMM and the residual
// read: 25.9 GFLOP over 67.8 MB, and operations bind it (~0.026 ms at 989
// TFLOP/s bf16).
//
// Design: both are entry points on the code K1 already runs, not a second
// core.
//   K3: half_layer.cuh::launch_slab_attention, one launch of K4's wgmma tile
//       loop (flash_forward.cuh) on the slab's head views: grid (B*H,
//       ceil(T / rows)), a block of one or two warpgroups holds 64 query
//       rows a warpgroup in shared memory and streams 64-key K and V tiles
//       out of the slab at column offsets h*64, D+h*64 and 2D+h*64 (token
//       stride 3D, no head transposes) through a cp.async ring of swizzled
//       tiles, with the exact online softmax; the ragged tail is masked. K/V
//       tiles are re-read from L2 by the query blocks of a head. It is the
//       kernel behind flash_attention_slab too, so the two give equal bits
//       on one slab.
//   K2: that launch into an attention buffer (B, T, D) the caller allocated,
//       then wgmma_gemm.cuh's GEMM on it with the residual epilogue, in the
//       JAX package's order: f32 accumulate -> bf16 -> + bf16(b_proj) ->
//       * bf16(ls1) -> + x. These are K1's attention and proj launches, so on
//       K1's own slab the output is K1's bit for bit. The TPU kernel keeps
//       the attention output on chip; this version writes and re-reads it
//       through HBM (12.6 MB at the shape above), as K1 does.
// At head_dim 64 the exponentials cost the MUFU what the two products cost
// the tensor cores (flash_attention.cu's note), so K3 does not come near its
// bound of bytes.
//
// The f32 entries run the same launches on f32 activations and weights,
// with the JAX package's f32 numerics: K3 f32 is f32_attention.cuh's tile
// loop; K2 f32 adds the TF32 planes of w_proj, split and transposed into a
// scratch the caller allocated, and the proj GEMM on tf32x3_gemm.cuh's
// 3xTF32 core with the residual epilogue, K1 f32's last two launches. At
// ViT-g/14's shape K3 in f32 is 6.5 GFLOP over 101 MB: 0.04 ms at 3xTF32's
// 165 TFLOP/s (f32_attention.cuh's 3xTF32 wgmma) against 0.03 ms for the
// bytes; K2 adds 19.4 GFLOP of proj, 0.12 ms: operations bind it.
//
// Every entry point returns cudaGetLastError() after its launches.

#include "f32_attention.cuh"
#include "f32_gemm.cuh"
#include "half_layer.cuh"
#include "wgmma_gemm.cuh"

extern "C" {

// K3, one launch on `stream`: qkv (B, T, 3D) -> out (B, T, D), both bf16 and
// contiguous. Requires D == 64 * heads, 16-byte aligned pointers, and the
// tensors' device current on the calling thread (the caller sets it).
int dinov2_slab_attention_bf16(const void* qkv, void* out, int b, int t, int d, int heads,
                               float scale, void* stream) {
  return dinov2::launch_slab_attention(static_cast<const dinov2::bf16*>(qkv),
                                       static_cast<dinov2::bf16*>(out), b, t, d, heads, scale,
                                       static_cast<cudaStream_t>(stream));
}

// K2, two launches on `stream`. attn_scratch (B, T, D) is a bf16 buffer the
// caller allocated; out is (B, T, D). Same requirements as K3.
int dinov2_slab_attention_block_bf16(const void* x, const void* qkv, const void* w_proj,
                                     const void* b_proj, const void* ls1, void* attn_scratch,
                                     void* out, int b, int t, int d, int heads, float scale,
                                     void* stream) {
  using namespace dinov2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* attn = static_cast<bf16*>(attn_scratch);
  const cudaError_t err =
      launch_slab_attention(static_cast<const bf16*>(qkv), attn, b, t, d, heads, scale, s);
  if (err != cudaSuccess) return err;
  return launch_wgmma_gemm(
      attn, static_cast<const bf16*>(w_proj),
      ResidualEpilogue{static_cast<const float*>(b_proj), static_cast<const float*>(ls1),
                       static_cast<const bf16*>(x), static_cast<bf16*>(out), d},
      b * t, d, d, s);
}

// K3 in f32: qkv (B, T, 3D) -> out (B, T, D), both f32 and contiguous.
int dinov2_slab_attention_f32(const void* qkv, void* out, int b, int t, int d, int heads,
                              float scale, void* stream) {
  return dinov2::launch_f32_slab_attention(static_cast<const float*>(qkv),
                                           static_cast<float*>(out), b, t, d, heads, scale,
                                           static_cast<cudaStream_t>(stream));
}

// K2 in f32: x, qkv, w_proj, attn_scratch and out f32; weight_scratch holds
// 2 D^2 floats (w_proj's TF32 planes). Three launches; same requirements.
int dinov2_slab_attention_block_f32(const void* x, const void* qkv, const void* w_proj,
                                    const void* b_proj, const void* ls1, void* attn_scratch,
                                    void* out, int b, int t, int d, int heads, float scale,
                                    void* stream, void* weight_scratch) {
  using namespace dinov2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* attn = static_cast<float*>(attn_scratch);
  const cudaError_t err =
      launch_f32_slab_attention(static_cast<const float*>(qkv), attn, b, t, d, heads, scale, s);
  if (err != cudaSuccess) return err;
  return launch_f32_linear(
      attn, static_cast<const float*>(w_proj), static_cast<float*>(weight_scratch),
      F32Residual{static_cast<const float*>(b_proj), static_cast<const float*>(ls1),
                  static_cast<const float*>(x), static_cast<float*>(out), d},
      b * t, d, d, s);
}

const char* dinov2_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
