// Fused dense layer, f32: out = act(scale * (a @ w) + bias).
//
// Replaces the Pallas kernel repro/kernels/conv_fused.py::_matmul_fused_kernel
// (entry point matmul_fused): a [M,K] x [K,N] product with f32 accumulation
// and the fc node's epilogue (bias, optional ReLU) in the flush.
//
// What bounds it on an H100: bytes.  On the serving path M is the
// micro-batch (4 for VGG-16), so each weight element read from device
// memory feeds only M multiply-adds; fc6 alone streams 411 MB of weights.
// The least time is the weight bytes over 3.35 TB/s.
//
// Design: read every weight element exactly once (for M <= 8), coalesced
// along N, with enough blocks and loads in flight to keep the memory
// system busy.  Pass 1 splits K into S slices (S depends only on N and
// K): a block owns 128 columns (32 lanes x float4) of one slice, its 8
// warps walk interleaved rows of the slice and keep all M rows of the
// activation in registers, and the warps' sums are reduced in shared
// memory in a fixed order into a partial [S, M, N].  Pass 2 adds the S
// partials in order and applies scale, bias and ReLU.  No atomics: every
// output is summed in the same order whatever M is, so results are
// bitwise reproducible across batchings.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 128;  // columns per block: 32 lanes x 4
constexpr int WARPS = 8;
constexpr int NT = 32 * WARPS;
constexpr int MT = 8;  // activation rows held in registers per pass

__global__ void __launch_bounds__(NT)
fc_partial_kernel(const float* __restrict__ a, const float* __restrict__ w,
                  float* __restrict__ part, int M, int K, int N,
                  int k_per_split, int vec4) {
  __shared__ float red[WARPS][MT][COLS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s = blockIdx.y;
  const int n = blockIdx.x * COLS + lane * 4;
  const int kb = s * k_per_split;
  const int ke = min(K, kb + k_per_split);

  for (int m0 = 0; m0 < M; m0 += MT) {
    const int mt = min(MT, M - m0);
    float acc[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

#pragma unroll 4
    for (int k = kb + warp; k < ke; k += WARPS) {
      const float* wr = w + (int64_t)k * N;
      float wv[4];
      if (vec4 && n < N) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(wr + n));
        wv[0] = t.x; wv[1] = t.y; wv[2] = t.z; wv[3] = t.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = (n + j < N) ? __ldg(wr + n + j) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i < mt) {
          const float av = __ldg(a + (int64_t)(m0 + i) * K + k);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, wv[j], acc[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[warp][i][lane * 4 + j] = acc[i][j];
    __syncthreads();
    for (int idx = threadIdx.x; idx < MT * COLS; idx += NT) {
      const int i = idx / COLS;
      const int col = idx - i * COLS;
      float sum = 0.0f;
#pragma unroll
      for (int wp = 0; wp < WARPS; ++wp) sum += red[wp][i][col];
      const int nn = blockIdx.x * COLS + col;
      if (i < mt && nn < N) part[((int64_t)s * M + m0 + i) * N + nn] = sum;
    }
    __syncthreads();
  }
}

__global__ void fc_finish_kernel(const float* __restrict__ part,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ bias,
                                 float* __restrict__ out, int M, int N, int S,
                                 int relu) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = (int64_t)M * N;
  if (idx >= total) return;
  const int n = (int)(idx % N);
  float sum = 0.0f;
  for (int s = 0; s < S; ++s) sum += part[(int64_t)s * total + idx];
  float v = fmaf(sum, scale[n], bias[n]);
  if (relu) v = fmaxf(v, 0.0f);
  out[idx] = v;
}

}  // namespace

// Number of K slices pass 1 uses: enough blocks for about two waves on a
// 132-SM card, at least 64 rows per slice.  Depends on (K, N) only.
extern "C" int matmul_fused_splits(int K, int N) {
  const int col_blocks = (N + COLS - 1) / COLS;
  int s = (264 + col_blocks - 1) / col_blocks;
  const int max_s = K / 64 > 1 ? K / 64 : 1;
  if (s > max_s) s = max_s;
  return s < 1 ? 1 : s;
}

// a [M,K], w [K,N], scale and bias [N], out [M,N], part [S,M,N] scratch with
// S = matmul_fused_splits(K, N); all f32, contiguous, on the device.
// Launches both passes on ``stream`` and returns cudaGetLastError().
extern "C" int matmul_fused_f32(const void* a, const void* w, const void* scale,
                                const void* bias, void* out, void* part, int M,
                                int K, int N, int relu, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int S = matmul_fused_splits(K, N);
  const int k_per_split = (K + S - 1) / S;
  // float4 weight loads need 16-byte aligned rows: N % 4 == 0 and an aligned base
  const int vec4 = (N % 4 == 0) && ((reinterpret_cast<uintptr_t>(w) & 15) == 0);
  dim3 grid1((N + COLS - 1) / COLS, S);
  fc_partial_kernel<<<grid1, NT, 0, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(w),
      static_cast<float*>(part), M, K, N, k_per_split, vec4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = (int64_t)M * N;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads);
  fc_finish_kernel<<<blocks, threads, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<float*>(out), M, N, S, relu);
  return static_cast<int>(cudaGetLastError());
}
