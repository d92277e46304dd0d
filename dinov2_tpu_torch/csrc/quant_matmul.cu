// K7 on Hopper: the dequant-matmul,
//
//     y (M, N) = act(x (M, K) @ dequant(W)^T + bias)
//
// for an (N, K) ggml-quantized weight W (models/params.py::QuantLinear),
// packed planes or int8 SoA, in any of q4_0, q4_1, q5_0, q5_1 and q8_0.
//
// Replaces the Pallas TPU kernels dinov2_tpu/ops/pallas_qmatmul.py::
// _make_kernel_sym, _make_kernel_affine and _make_packed_kernel, reached
// through quant_matmul_pallas.
//
// Two kernels, picked by x's type:
//   - bf16 x (fc1, fc2; qkv and proj on the flash route): gemm_core.cuh's
//     GEMM with the quant weight loader (dequant_tile.cuh). Each block
//     dequantizes the 64x64 weight tiles of its output tile as it stages
//     them (code -> f32, * d, + m, one bf16 cast: dequant_weight's order);
//     mma.sync bf16 with f32 accumulation. Epilogue, the TPU kernel's
//     _epilogue order: bf16(acc), + bf16(bias), then the activation in f32
//     on the bf16 value, rounded to bf16. gelu_tanh_f16 rounds its input and
//     its output to f16 (__float2half_rn) around PyTorch's tanh formula.
//   - f32 x (the classifier head on f32 features): a plain FMA kernel on
//     f32 tiles, the weight dequantized to f32, as dequant_weight(W, f32)
//     and an f32 matmul compute it; epilogue acc + bias, then the activation.
// M and N are masked at the edges (the head has N = 1000); K is a multiple
// of 64, and of 128 for packed weights (a k-step lies inside one plane).
//
// What bounds it on an H100: at the classify path's fc1 (M=16448, K=768,
// N=3072) a call is 78 GFLOP and reads 1.2 MB of q4_0 weight (4.7 MB in
// bf16), 25 MB of x and writes 101 MB of y: compute-bound, ~0.08 ms at the
// card's bf16 peak. This first version inherits K1's unpipelined GEMM
// (~130 TFLOP/s in K1's proj launch) and adds the dequant work, ~4 integer
// and 2 f32 operations per weight element per 64-row tile of x. The TPU
// kernel dequantizes each weight tile once and reuses it across all M;
// here every row tile repeats it, which keeps the blocks independent.

#include "activation.cuh"
#include "dequant_tile.cuh"

namespace {

using namespace dinov2;

// out (M, N) bf16 = act(bf16(acc) + bf16(bias)); bias may be null. Masks
// columns >= N; pairs are stored as one 32-bit word when N is even.
struct ActEpilogue {
  const float* bias;
  int act;
  bf16* out;
  int n;

  // bf16(bias) of the columns c and c + 1 that exist, else 0 (no bias add)
  __device__ __forceinline__ BiasPair column(int c) const {
    BiasPair col{0.f, 0.f};
    if (bias && c < n) col.b0 = round_bf16(bias[c]);
    if (bias && c + 1 < n) col.b1 = round_bf16(bias[c + 1]);
    return col;
  }

  __device__ __forceinline__ void operator()(int row, int c, const BiasPair& col, float a0,
                                             float a1) const {
    if (c >= n) return;
    float y0 = round_bf16(a0), y1 = round_bf16(a1);
    if (bias) {
      y0 = round_bf16(y0 + col.b0);
      y1 = round_bf16(y1 + col.b1);
    }
    y0 = activate(y0, act);
    y1 = activate(y1, act);
    bf16* dst = out + static_cast<size_t>(row) * n + c;
    if (c + 1 < n && (n & 1) == 0) {
      *reinterpret_cast<uint32_t*>(dst) = pack_floats(y0, y1);
    } else {
      dst[0] = __float2bfloat16(y0);
      if (c + 1 < n) dst[1] = __float2bfloat16(y1);
    }
  }
};

constexpr int kF32Threads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kF32TileK = 32;     // one ggml block of k per step
constexpr int kF32Lds = kTile + 4;

// out (M, N) f32 = act(x (M, K) f32 @ dequant(W)^T + bias), one 64x64 output
// tile per block; k-steps of 32 staged k-major in shared memory.
__global__ void __launch_bounds__(kF32Threads)
    quant_matmul_f32_kernel(const float* __restrict__ x, QuantWeight w,
                            const float* __restrict__ bias, int act, float* __restrict__ out,
                            int m) {
  __shared__ __align__(16) float xs[kF32TileK][kF32Lds];
  __shared__ __align__(16) float ws[kF32TileK][kF32Lds];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  // the piece this thread stages per k-step: tile row r, k offsets c..c+7
  const int r = tid >> 2, c = (tid & 3) * 8;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < w.k; k0 += kF32TileK) {
    float xv[8], wv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) xv[j] = wv[j] = 0.f;
    if (row0 + r < m) {
      const float4* src =
          reinterpret_cast<const float4*>(x + static_cast<size_t>(row0 + r) * w.k + k0 + c);
      const float4 lo = src[0], hi = src[1];
      xv[0] = lo.x, xv[1] = lo.y, xv[2] = lo.z, xv[3] = lo.w;
      xv[4] = hi.x, xv[5] = hi.y, xv[6] = hi.z, xv[7] = hi.w;
    }
    if (col0 + r < w.n) w.dequant8(col0 + r, k0 + c, wv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      xs[c + j][r] = xv[j];
      ws[c + j][r] = wv[j];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kF32TileK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      if (col >= w.n) continue;
      float y = acc[i][j];
      if (bias) y += bias[col];
      out[static_cast<size_t>(row) * w.n + col] = activate(y, act);
    }
  }
}

}  // namespace

extern "C" {

// y = act(x @ dequant(W)^T + bias), one launch on `stream`. x (M, K) is bf16
// (x_f32 == 0) or f32, y (M, N) the same type. W comes as codes, d, m (null
// for q4_0/q5_0/q8_0), qh_lo and qh_hi (null but for packed q5), its layout
// (packed) and zero point. bias (N,) f32 may be null; activation is 0 none,
// 1 gelu_tanh_f16, 2 gelu_erf, 3 gelu_tanh. Requires K % 64 == 0 (packed:
// K/2 % 64 == 0), 16-byte aligned pointers, and the tensors' device current
// on the calling thread.
int dinov2_quant_matmul(const void* x, int x_f32, const void* codes, const void* d,
                        const void* mins, const void* qh_lo, const void* qh_hi, int packed,
                        int zero, const void* bias, int activation, void* out, int m, int n,
                        int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const QuantWeight w = quant_weight(codes, d, mins, qh_lo, qh_hi, packed, zero, n, k);
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  if (x_f32) {
    quant_matmul_f32_kernel<<<grid, kF32Threads, 0, s>>>(
        static_cast<const float*>(x), w, static_cast<const float*>(bias), activation,
        static_cast<float*>(out), m);
  } else {
    gemm_kernel<QuantWeightTile, ActEpilogue><<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(x), QuantWeightTile{w},
        ActEpilogue{static_cast<const float*>(bias), activation, static_cast<bf16*>(out), n}, m,
        k);
  }
  return cudaGetLastError();
}

const char* dinov2_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
