// Plain f32 GEMM, out[M,N] = a[M,K] @ b[K,N], row-major, no epilogue.
//
// Replaces the Pallas kernel repro/kernels/gemm.py::_gemm_kernel (entry
// point gemm): the tiled GEMM with f32 accumulation behind the unfused
// conv-as-GEMM route (the reference's "pallas" backend).  Here it takes
// the explicit patch matrix that csrc/im2col.cu writes, and the fc
// layers' activations; the bias add and the ReLU stay outside.
//
// What bounds it on an H100: operations for the conv GEMMs (2*K flops
// per output, K up to 4608) at the CUDA cores' 67 TFLOP/s f32 FMA rate,
// since this first version stays in IEEE f32 (fmaf, no TF32) to hold the
// reference's tolerance; bytes for the fc GEMMs, whose M is the serving
// micro-batch, so each weight element feeds only M multiply-adds.
//
// Every output is summed in one order, fixed by (K, N) alone, whatever M
// is and whichever of the two kernels below runs, so a row's result does
// not depend on the batch it rides in:  K is cut into S slices of L rows
// (gemm_slice_len); each slice is one fmaf chain over k ascending from 0;
// the slice sums are added in slice order to a total that starts at 0.
//
//   * gemm_tiled_kernel (M > MT): one 256-thread block per 64 x 64
//     output tile, K in steps of 16 staged in shared memory, a 4 x 4
//     register tile per thread (the design of csrc/conv_fused.cu with
//     the A tile read from the patch matrix).  It walks all of K itself
//     and folds its slice accumulator into the total at every slice
//     boundary, in registers: no partial sums leave the block.
//   * gemm_skinny_kernel + gemm_finish_kernel (M <= MT): the fc case.
//     One thread owns 4 columns (a float4 of each weight row, coalesced
//     along N) and all M rows, for one slice; S slices give enough
//     blocks to keep the memory system busy.  Each slice sum goes to a
//     partial [S, M, N]; the second pass adds the S partials in order.
//     No atomics.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int NT = 256;
constexpr int APAD = 4;

constexpr int MT = 8;              // largest M the skinny kernel takes
constexpr int SK_NT = 128;         // skinny threads per block
constexpr int SK_COLS = 4 * SK_NT; // columns per skinny block
constexpr int TARGET_BLOCKS = 4 * 132;  // four blocks per SM of an H100

__global__ void __launch_bounds__(NT)
gemm_tiled_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ out, int M, int K, int N, int L) {
  __shared__ __align__(16) float As[BK][BM + APAD];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ak = tid % BK;  // A loader: column ak, rows ar + 16*i
  const int ar = tid / BK;
  const int bn = tid % BN;  // B loader: column bn, rows bk + 4*i
  const int bk = tid / BN;
  const int ty = tid / 16;  // compute: rows ty*4.., cols tx*4..
  const int tx = tid % 16;

  float acc[4][4], tot[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = tot[i][j] = 0.0f;

  int fold_at = L;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const int k = k0 + ak;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ar + 16 * i;
      As[ak][ar + 16 * i] = (m < M && k < K) ? a[(int64_t)m * K + k] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = k0 + bk + 4 * i;
      const int n = n0 + bn;
      Bs[bk + 4 * i][bn] = (kk < K && n < N) ? b[(int64_t)kk * N + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {av4.x, av4.y, av4.z, av4.w};
      const float bw[4] = {bv4.x, bv4.y, bv4.z, bv4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
    __syncthreads();
    if (k0 + BK >= fold_at || k0 + BK >= K) {  // end of a slice (L % BK == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          tot[i][j] = tot[i][j] + acc[i][j];
          acc[i][j] = 0.0f;
        }
      fold_at += L;
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[(int64_t)m * N + n] = tot[i][j];
    }
  }
}

__global__ void __launch_bounds__(SK_NT)
gemm_skinny_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ part, int M, int K, int N, int L,
                   int vec4) {
  const int s = blockIdx.y;
  const int n = blockIdx.x * SK_COLS + threadIdx.x * 4;
  if (n >= N) return;
  const int kb = s * L;
  const int ke = min(K, kb + L);
  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

#pragma unroll 4
  for (int k = kb; k < ke; ++k) {
    const float* br = b + (int64_t)k * N;
    float bw[4];
    if (vec4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(br + n));
      bw[0] = t.x; bw[1] = t.y; bw[2] = t.z; bw[3] = t.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) bw[j] = (n + j < N) ? __ldg(br + n + j) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < M) {
        const float av = __ldg(a + (int64_t)i * K + k);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, bw[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n + j < N) part[((int64_t)s * M + i) * N + n + j] = acc[i][j];
  }
}

__global__ void gemm_finish_kernel(const float* __restrict__ part,
                                   float* __restrict__ out, int64_t total,
                                   int S) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float sum = 0.0f;
  for (int s = 0; s < S; ++s) sum = sum + part[(int64_t)s * total + idx];
  out[idx] = sum;
}

}  // namespace

// Rows per K slice, a multiple of 16; depends on (K, N) only.  Enough
// slices that the skinny kernel has about four blocks per SM, each slice
// at least 64 rows long.
extern "C" int gemm_slice_len(int K, int N) {
  const int col_blocks = (N + SK_COLS - 1) / SK_COLS;
  int s = (TARGET_BLOCKS + col_blocks - 1) / col_blocks;
  const int max_s = K / 64 > 1 ? K / 64 : 1;
  if (s > max_s) s = max_s;
  int L = (K + s - 1) / s;
  L = (L + BK - 1) / BK * BK;
  return L < BK ? BK : L;
}

// The largest M the skinny path takes; the wrapper sizes its partial
// buffer [ceil(K / L), M, N] for M up to this.
extern "C" int gemm_skinny_max_m() { return MT; }

// a [M,K], b [K,N], out [M,N], all f32, contiguous, on the device; part is
// scratch of ceil(K / gemm_slice_len(K, N)) * M * N floats when M <=
// gemm_skinny_max_m(), else unused (may be null).  Launches on ``stream``
// and returns cudaGetLastError() (0 on success); does not synchronise.
extern "C" int gemm_f32(const void* a, const void* b, void* out, void* part,
                        int M, int K, int N, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int L = gemm_slice_len(K, N);
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  float* O = static_cast<float*>(out);
  if (M > MT) {
    dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
    gemm_tiled_kernel<<<grid, NT, 0, st>>>(A, B, O, M, K, N, L);
    return static_cast<int>(cudaGetLastError());
  }
  const int S = K > 0 ? (K + L - 1) / L : 0;
  if (S == 0) {  // empty sum: zeros
    return static_cast<int>(
        cudaMemsetAsync(O, 0, sizeof(float) * (size_t)M * N, st));
  }
  // float4 weight loads need 16-byte aligned rows: N % 4 == 0 and an aligned base
  const int vec4 = (N % 4 == 0) && ((reinterpret_cast<uintptr_t>(b) & 15) == 0);
  float* P = static_cast<float*>(part);
  dim3 grid1((N + SK_COLS - 1) / SK_COLS, S);
  gemm_skinny_kernel<<<grid1, SK_NT, 0, st>>>(A, B, P, M, K, N, L, vec4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = (int64_t)M * N;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads);
  gemm_finish_kernel<<<blocks, threads, 0, st>>>(P, O, total, S);
  return static_cast<int>(cudaGetLastError());
}
