// K4 on Hopper: flash attention, the attention core of feature mode,
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
// flash_attention and flash_attention_slab, e.g. T=4226 at 896 px). On Hopper
// one kernel covers both: it always streams 64-key tiles with the online
// softmax, which is exact, so the TPU kernels' CLS-shift core and its
// overflow rescue have no counterpart.
//
// What bounds it on an H100: at the slice's shape (B=8, T=1370, H=16) one call
// is 4*B*H*T^2*64 = 61.5 GFLOP of mma work over 90 MB of q/k/v/out in HBM:
// ~680 FLOP per byte, so it is compute-bound (the floor at 989 TFLOP/s bf16
// is ~0.06 ms, against ~0.03 ms to move the bytes at 3.35 TB/s). Beside the
// two matrix products, every score takes a scale, a mask, a max, an exp and a
// sum on the CUDA cores.
//
// Design of this first version: grid (B*H, ceil(T/64)), four warps per block;
// each block holds one 64-query tile in registers and streams the K/V tiles
// of its (image, head) through shared memory with mma.sync m16n8k16
// (attention_core.cuh::attention_tile, the core K1 runs too). The ragged tail
// (1370 = 21*64 + 26) is masked, not padded. The loads are not pipelined
// (no cp.async or TMA) and K/V tiles are re-read from L2 by each of the
// ceil(T/64) query tiles of a head; wgmma, TMA and a deeper pipeline are left
// for later work.
//
// The training forward (_attn_kernel with with_lse=True, reached from
// _flash_fwd) is the kernel's compile-time variant kWithLse: it also writes
// the row logsumexp m + log(max(l, 1e-30)) of the scaled scores as f32,
// (B, H, T) contiguous; the TPU's (b*h, tp, 8) replicated layout is a Mosaic
// tiling rule and does not carry over.
//
// Shared memory is static (27 KB per block); 128 registers a thread
// (kAttentionBlocksPerSm), no spills. Every entry point returns
// cudaGetLastError() after its launch.

#include "attention_core.cuh"

namespace {

using namespace dinov2;

// kWithLse: the training forward, which also writes the (B, H, T) f32 row
// logsumexp that K6 (flash_backward.cu) reads; `out` is the same bit for bit.
template <bool kWithLse>
__global__ void __launch_bounds__(kThreads, kAttentionBlocksPerSm)
    flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, long long batch_stride,
                           long long token_stride, long long head_stride,
                           bf16* __restrict__ out, float* __restrict__ lse, int t, int heads,
                           float scale) {
  const int img = blockIdx.x / heads, head = blockIdx.x % heads;
  const size_t in = static_cast<size_t>(img) * batch_stride +
                    static_cast<size_t>(head) * head_stride;
  const size_t out_ld = static_cast<size_t>(heads) * kHeadDim;
  bf16* dst = out + static_cast<size_t>(img) * t * out_ld + head * kHeadDim;
  if constexpr (kWithLse) {
    attention_tile<true>(q + in, k + in, v + in, static_cast<size_t>(token_stride), dst,
                         out_ld, t, blockIdx.y * kTile, scale,
                         lse + static_cast<size_t>(blockIdx.x) * t);
  } else {
    attention_tile(q + in, k + in, v + in, static_cast<size_t>(token_stride), dst, out_ld, t,
                   blockIdx.y * kTile, scale);
  }
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
  flash_attention_kernel<false><<<dim3(b * heads, (t + kTile - 1) / kTile), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      batch_stride, token_stride, head_stride, static_cast<bf16*>(out), nullptr, t, heads,
      scale);
  return cudaGetLastError();
}

// The same launch with the row logsumexp: lse (B, H, T) contiguous f32,
// lse[b, h, i] = log sum_k exp(scale * q[b, i, h] . k[b, k, h]).
int dinov2_flash_attention_lse_bf16(const void* q, const void* k, const void* v, void* out,
                                    void* lse, int b, int t, int heads, long long batch_stride,
                                    long long token_stride, long long head_stride, float scale,
                                    void* stream) {
  flash_attention_kernel<true><<<dim3(b * heads, (t + kTile - 1) / kTile), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      batch_stride, token_stride, head_stride, static_cast<bf16*>(out),
      static_cast<float*>(lse), t, heads, scale);
  return cudaGetLastError();
}

const char* dinov2_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
