// Fused implicit-GEMM convolution, NHWC activations and HWIO filters, in
// two instantiations: f32 operands with an f32 accumulator, and int32
// operands with an int32 accumulator (the quantized conv).
//
// Replaces the Pallas kernel repro/kernels/conv_fused.py::_conv_fused_kernel
// (launched by _conv_fused_call) on both of its instantiations:
//
//     y[b, oh, ow, n] = act(scale[n] * sum_k A[m, k] * W[k, n] + bias[n])
//
// with m = (b, oh, ow) over M = B*OH*OW output pixels, n over Cout, and
// k = (fi, fj, c) over K = FH*FW*C.  A[m, k] is the input pixel
// x[b, oh*stride - pad + fi, ow*stride - pad + fj, c], read on the fly:
// no im2col matrix and no padded copy of the input exist in device memory
// (taps that fall in the zero padding are masked to 0 in the tile load).
//
// What bounds it on an H100: operations.  A 3x3 conv does 2*K = 18*C
// flops per output for ~4 bytes of output, far above the card's f32
// ridge (67 TFLOP/s over 3.35 TB/s = 20 flop/byte).  This first version
// stays on the CUDA cores in IEEE f32 (fmaf, no TF32), so the reference's
// tolerance holds; its ceiling is the 67 TFLOP/s f32 FMA rate.
//
// Design: one 256-thread block computes a BM x BN = 64 x 64 output tile,
// looping over K in steps of BK = 16.  Each step stages the A tile
// (gathered from the input, transposed to k-major) and the W tile in
// shared memory; every thread then accumulates a 4 x 4 register tile.
// Threads that load A walk k fastest, which is the contiguous channel
// axis of NHWC, so loads coalesce whenever C >= 16.  The epilogue
// applies scale, bias and ReLU in registers before the one store.  Every
// output's sum runs over k in the same order whatever the tile position
// or batch size, so results are bitwise reproducible across batchings.
//
// Ragged shapes are masked, not padded: C = 3 (K = 27), Ow = 14 (a
// partial M tile), Cout not a multiple of 64, any stride and pad.
//
// The int32 instantiation (entry conv_fused_i32) takes the zero-point-
// shifted QASYMM8 operands, both in [-255, 255], and accumulates exactly
// in int32: |acc| <= K * 255 * 255, under 3.0e8 < 2^31 for the largest K
// of the six nets (3*3*512 = 4608).  Float 0 quantizes to exactly the
// activation zero point, so the shifted value of a padding tap is 0 and
// the masked-zero load equals the reference's zero-padded input.  Its
// flush is y = float(acc) * scale[n] + bias[n] with the merged requant
// scale, each step rounded on its own (__int2float_rn, __fmul_rn,
// __fadd_rn: no contraction into an FMA), so it is bitwise equal to the
// plain PyTorch version.  It is bound by operations at the CUDA cores'
// int32 multiply-add rate, half the f32 FMA rate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int NT = 256;
constexpr int APAD = 4;  // keeps 16-byte alignment, spreads the A-store banks

// Per-type pieces: the 4-wide shared-memory load, the multiply-add of the
// K loop, and the flush.
template <typename T> struct Ops;

template <> struct Ops<float> {
  using V4 = float4;
  static __device__ __forceinline__ float mac(float a, float b, float acc) {
    return fmaf(a, b, acc);
  }
  static __device__ __forceinline__ float flush(float acc, float s, float b) {
    return fmaf(acc, s, b);
  }
};

template <> struct Ops<int> {
  using V4 = int4;
  static __device__ __forceinline__ int mac(int a, int b, int acc) {
    return acc + a * b;
  }
  static __device__ __forceinline__ float flush(int acc, float s, float b) {
    return __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
  }
};

template <typename T>
__global__ void __launch_bounds__(NT)
conv_fused_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, float* __restrict__ y,
                  int B, int H, int W, int C, int FH, int FW, int Cout,
                  int stride, int pad, int OH, int OW, int relu) {
  using V4 = typename Ops<T>::V4;
  __shared__ __align__(16) T As[BK][BM + APAD];
  __shared__ __align__(16) T Bs[BK][BN];

  const int tid = threadIdx.x;
  const int M = B * OH * OW;
  const int K = FH * FW * C;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A-tile loader: column ak (fastest, contiguous channels), rows ar + 16*i.
  const int ak = tid % BK;
  const int ar = tid / BK;
  int row_b[4], row_h[4], row_w[4];
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ar + 16 * i;
    row_ok[i] = m < M;
    const int mm = row_ok[i] ? m : 0;
    const int b = mm / (OH * OW);
    const int rem = mm - b * (OH * OW);
    const int oh = rem / OW;
    const int ow = rem - oh * OW;
    row_b[i] = b;
    row_h[i] = oh * stride - pad;
    row_w[i] = ow * stride - pad;
  }
  // W-tile loader: column bn (contiguous Cout), rows bk + 4*i.
  const int bn = tid % BN;
  const int bk = tid / BN;

  // Compute mapping: a 4 x 4 register tile at rows ty*4.., cols tx*4..
  const int ty = tid / 16;
  const int tx = tid % 16;
  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int k = k0 + ak;
    const bool k_ok = k < K;
    int c = 0, fi = 0, fj = 0;
    if (k_ok) {
      c = k % C;
      const int t = k / C;
      fj = t % FW;
      fi = t / FW;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ih = row_h[i] + fi;
      const int iw = row_w[i] + fj;
      T v = T(0);
      if (k_ok && row_ok[i] && ih >= 0 && ih < H && iw >= 0 && iw < W) {
        v = x[((int64_t)(row_b[i] * H + ih) * W + iw) * C + c];
      }
      As[ak][ar + 16 * i] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = k0 + bk + 4 * i;
      const int n = n0 + bn;
      Bs[bk + 4 * i][bn] =
          (kk < K && n < Cout) ? w[(int64_t)kk * Cout + n] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const V4 a = *reinterpret_cast<const V4*>(&As[kk][ty * 4]);
      const V4 bv = *reinterpret_cast<const V4*>(&Bs[kk][tx * 4]);
      const T av[4] = {a.x, a.y, a.z, a.w};
      const T bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = Ops<T>::mac(av[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= Cout) continue;
      float v = Ops<T>::flush(acc[i][j], scale[n], bias[n]);
      if (relu) v = fmaxf(v, 0.0f);
      y[(int64_t)m * Cout + n] = v;
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* scale, const void* bias,
           void* y, int B, int H, int W, int C, int FH, int FW, int Cout,
           int stride, int pad, int OH, int OW, int relu, void* stream) {
  const int M = B * OH * OW;
  if (M <= 0 || Cout <= 0) return 0;
  dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  conv_fused_kernel<T><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(y), B, H, W, C, FH, FW, Cout, stride, pad, OH, OW,
      relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B,H,W,C], w [FH,FW,C,Cout], scale and bias [Cout], y [B,OH,OW,Cout];
// all f32, contiguous, on the device.  Launches on ``stream`` and returns
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int conv_fused_f32(const void* x, const void* w, const void* scale,
                              const void* bias, void* y, int B, int H, int W,
                              int C, int FH, int FW, int Cout, int stride,
                              int pad, int OH, int OW, int relu,
                              void* stream) {
  return launch<float>(x, w, scale, bias, y, B, H, W, C, FH, FW, Cout, stride,
                       pad, OH, OW, relu, stream);
}

// The same with x and w int32 (zero-point-shifted QASYMM8 values in
// [-255, 255]); scale (the merged requant scale), bias and y stay f32.
extern "C" int conv_fused_i32(const void* x, const void* w, const void* scale,
                              const void* bias, void* y, int B, int H, int W,
                              int C, int FH, int FW, int Cout, int stride,
                              int pad, int OH, int OW, int relu,
                              void* stream) {
  return launch<int>(x, w, scale, bias, y, B, H, W, C, FH, FW, Cout, stride,
                     pad, OH, OW, relu, stream);
}
