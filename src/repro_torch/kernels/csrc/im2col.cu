// im2col, f32: x [B,H,W,C] (NHWC) -> cols [B*OH*OW, FH*FW*C], features
// ordered (fh, fw, c) to match the HWIO filter reshaped to [FH*FW*C, Cout].
//
// Replaces the Pallas kernel repro/kernels/im2col.py::_im2col_kernel (entry
// point im2col, the ARM-CL Im2Col stage of conv-as-GEMM, paper Fig. 10),
// with the batch dimension written out instead of vmapped:
//
//     cols[(b, oh, ow), (fi, fj, c)] = x[b, oh*s - p + fi, ow*s - p + fj, c]
//
// and 0 where the tap falls in the zero padding.  It is a pure copy, so
// the result is bitwise the plain version's.
//
// What bounds it on an H100: bytes.  It does no arithmetic; it reads the
// input (from L2 mostly: each input element lands in up to FH*FW rows)
// and writes the patch matrix, FH*FW times the input's size for a
// stride-1 conv (462 MB at VGG-16's conv1_2 at batch 4).  The least time
// is the patch matrix's bytes over 3.35 TB/s.
//
// Design: one block per output row (b, oh, ow), decoded once; its threads
// walk the row's K = FH*FW*C features with consecutive threads on
// consecutive features, so both the stores and, within one tap, the loads
// are coalesced along c.  Offsets into cols are 64-bit: the matrix has
// 1.16e8 elements at conv1_2.  C = 3 (conv1_1, K = 27) leaves most of a
// block idle, on the smallest matrix of the net.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;

__global__ void __launch_bounds__(NT)
im2col_kernel(const float* __restrict__ x, float* __restrict__ cols, int H,
              int W, int C, int FW, int stride, int pad, int OH, int OW,
              int K) {
  const int64_t m = blockIdx.x;
  const int b = (int)(m / ((int64_t)OH * OW));
  const int rem = (int)(m - (int64_t)b * OH * OW);
  const int oh = rem / OW;
  const int ow = rem - oh * OW;
  const int h0 = oh * stride - pad;
  const int w0 = ow * stride - pad;
  const float* xb = x + (int64_t)b * H * W * C;
  float* row = cols + m * K;
  for (int k = threadIdx.x; k < K; k += NT) {
    const int c = k % C;
    const int t = k / C;
    const int fj = t % FW;
    const int fi = t / FW;
    const int ih = h0 + fi;
    const int iw = w0 + fj;
    float v = 0.0f;
    if (ih >= 0 && ih < H && iw >= 0 && iw < W) {
      v = __ldg(xb + ((int64_t)ih * W + iw) * C + c);
    }
    row[k] = v;
  }
}

}  // namespace

// x [B,H,W,C] and cols [B*OH*OW, FH*FW*C], f32, contiguous, on the
// device.  Launches on ``stream`` and returns cudaGetLastError() (0 on
// success); does not synchronise.
extern "C" int im2col_f32(const void* x, void* cols, int B, int H, int W,
                          int C, int FH, int FW, int stride, int pad, int OH,
                          int OW, void* stream) {
  const int64_t rows = (int64_t)B * OH * OW;
  const int K = FH * FW * C;
  if (rows <= 0 || K <= 0) return 0;
  if (rows > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  im2col_kernel<<<(unsigned)rows, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(cols), H, W, C, FW,
      stride, pad, OH, OW, K);
  return static_cast<int>(cudaGetLastError());
}
