// Fused implicit-GEMM convolution on int32 operands: the quantized conv.
// NHWC activations, HWIO filters, an int32 accumulator.
//
// Replaces the int32 instantiation of the Pallas kernel
// repro/kernels/conv_fused.py::_conv_fused_kernel (launched by
// _conv_fused_call from qconv2d_fused):
//
//     y[b, oh, ow, n] = act(float(sum_k A[m, k] * W[k, n]) * scale[n] + bias[n])
//
// with m = (b, oh, ow) over M = B*OH*OW output pixels, n over Cout, and
// k = (fi, fj, c) over K = FH*FW*C.  A[m, k] is the input pixel
// x[b, oh*stride - pad + fi, ow*stride - pad + fj, c], read on the fly:
// no im2col matrix and no padded copy of the input exist in device memory
// (taps that fall in the zero padding are masked to 0 in the tile load).
// The f32 instantiation is csrc/gemm.cu's conv_fused_f32.
//
// The operands are the zero-point-shifted QASYMM8 values, both in
// [-255, 255], so the int32 sum is exact: |acc| <= K * 255 * 255, under
// 3.0e8 < 2^31 for the largest K of the six nets (3*3*512 = 4608).  Float
// 0 quantizes to exactly the activation zero point, so the shifted value
// of a padding tap is 0 and the masked-zero load equals the reference's
// zero-padded input.  The flush is y = float(acc) * scale[n] + bias[n]
// with the merged requant scale, each step rounded on its own
// (__int2float_rn, __fmul_rn, __fadd_rn: no contraction into an FMA), so
// it is bitwise equal to the plain PyTorch version.
//
// What bounds it on an H100: operations, at the CUDA cores' int32
// multiply-add rate, half the f32 FMA rate.  Design (a first version):
// one 256-thread block computes a BM x BN = 64 x 64 output tile, looping
// over K in steps of BK = 16.  Each step stages the A tile (gathered from
// the input, transposed to k-major) and the W tile in shared memory;
// every thread then accumulates a 4 x 4 register tile.  Threads that load
// A walk k fastest, which is the contiguous channel axis of NHWC, so
// loads coalesce whenever C >= 16.  Ragged shapes are masked, not padded:
// C = 3 (K = 27), Ow = 14 (a partial M tile), Cout not a multiple of 64,
// any stride and pad.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int NT = 256;
constexpr int APAD = 4;  // keeps 16-byte alignment, spreads the A-store banks

__global__ void __launch_bounds__(NT)
conv_fused_kernel(const int* __restrict__ x, const int* __restrict__ w,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, float* __restrict__ y,
                  int B, int H, int W, int C, int FH, int FW, int Cout,
                  int stride, int pad, int OH, int OW, int relu) {
  __shared__ __align__(16) int As[BK][BM + APAD];
  __shared__ __align__(16) int Bs[BK][BN];

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
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

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
      int v = 0;
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
          (kk < K && n < Cout) ? w[(int64_t)kk * Cout + n] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const int4 a = *reinterpret_cast<const int4*>(&As[kk][ty * 4]);
      const int4 bv = *reinterpret_cast<const int4*>(&Bs[kk][tx * 4]);
      const int av[4] = {a.x, a.y, a.z, a.w};
      const int bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = acc[i][j] + av[i] * bw[j];
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
      float v = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), scale[n]), bias[n]);
      if (relu) v = fmaxf(v, 0.0f);
      y[(int64_t)m * Cout + n] = v;
    }
  }
}

}  // namespace

// x [B,H,W,C] and w [FH,FW,C,Cout] int32 (zero-point-shifted QASYMM8
// values in [-255, 255]); scale (the merged requant scale) and bias
// [Cout] and y [B,OH,OW,Cout] f32; all contiguous, on the device.
// Launches on ``stream`` and returns cudaGetLastError() (0 on success);
// does not synchronise.
extern "C" int conv_fused_i32(const void* x, const void* w, const void* scale,
                              const void* bias, void* y, int B, int H, int W,
                              int C, int FH, int FW, int Cout, int stride,
                              int pad, int OH, int OW, int relu,
                              void* stream) {
  const int M = B * OH * OW;
  if (M <= 0 || Cout <= 0) return 0;
  dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  conv_fused_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<const int*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(y), B, H, W, C, FH, FW, Cout, stride, pad, OH, OW,
      relu);
  return static_cast<int>(cudaGetLastError());
}
