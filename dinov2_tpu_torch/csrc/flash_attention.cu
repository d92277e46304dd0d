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
// Design (the kernel and its launchers live in flash_forward.cuh, which K3,
// K2, K1 and K8 run on a qkv slab through half_layer.cuh: one kernel behind
// all of them). A block is kWarpgroups (1 or 2) warpgroups and owns 64 query rows a
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

#include "f32_attention.cuh"
#include "flash_forward.cuh"

using namespace dinov2;

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

// The f32 variants (f32_attention.cuh): q, k, v and out f32, strides
// multiples of 4 elements; lse as above.
int dinov2_flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                               int b, int t, int heads, long long batch_stride,
                               long long token_stride, long long head_stride, float scale,
                               void* stream) {
  return launch_f32_forward<false>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), nullptr, b, t, heads, batch_stride, token_stride, head_stride,
      scale, static_cast<cudaStream_t>(stream));
}

int dinov2_flash_attention_lse_f32(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int b, int t, int heads, long long batch_stride,
                                   long long token_stride, long long head_stride, float scale,
                                   void* stream) {
  return launch_f32_forward<true>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(lse), b, t, heads, batch_stride,
      token_stride, head_stride, scale, static_cast<cudaStream_t>(stream));
}

// Query rows a block of the variant the two entries above take at this shape.
int dinov2_flash_attention_query_rows(int b, int t, int heads) {
  return forward_query_rows(b, t, heads);
}

const char* dinov2_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
