// SSD chunked selective scan (Mamba-2 dual form), one block per
// (sequence, head), a loop over chunks inside the block.
//
// Replaces the Pallas kernel repro/kernels/ssd.py::_ssd_kernel (entry point
// ssd), whose grid is (head, chunk) with the chunk axis sequential and the
// [N, P] state carried in VMEM scratch; the reference vmaps it over the
// batch.  Here the grid is (head, batch), the sequential chunk axis is a
// loop inside the block, and the state lives in shared memory for the
// whole sweep.  Per chunk of Q steps, with L = cumsum(log_a):
//
//   scores = causal(C B^T) * exp(min(L_t - L_s, 0))
//   y      = scores x + exp(L) * (C h)
//   h     <- exp(L_end) h + (B * exp(L_end - L))^T x
//
// and h is written out after the last chunk.  Inputs are read as f32
// (bf16 or f32 in memory), everything is computed in f32, y is written in
// x's type and h_final in f32.  B and C are read through strides, so a
// head stride of 0 (Hymba broadcasts one B and one C to every head) reads
// them once instead of materialising a copy per head.
//
// What bounds it on an H100: operations.  A chunk does about 0.6 MFLOP of
// f32 multiply-adds (the causal half of the Q x Q scores and of their
// product with x, plus the two N x P terms) on 2 Q (P + N) + Q values it
// reads and Q P it writes; the tensor cores would need TF32 or bf16,
// which would not hold the reference's f32 tolerance, so the bound is
// the CUDA cores' 67 TFLOP/s.
//
// Design: 256 threads.  A chunk's x, B, C and log_a are staged in shared
// memory as f32; thread 0 takes the cumulative sum in order; the scores
// are formed for s <= t only; the y and state products are register
// tiled four columns of P wide (float4 reads of x and h from shared
// memory, broadcast reads of the scores, B and C), and B's rows are
// padded to N + 1 floats and the scores' to Q + 1 so a warp's lanes hit
// distinct banks.  At Hymba's Q = 64, P = 64, N = 16 a block uses 46 KB
// of shared memory and 64 registers a thread, so up to four blocks share
// an SM and a prefill layer's 200 blocks are all resident at once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

struct Strides {  // element strides of a [B, S, H, *] operand (last dim contiguous)
  int64_t b, s, h;
};

size_t smem_floats(int Q, int P, int N) {
  return (size_t)Q * P + (size_t)N * P + (size_t)Q * (N + 1) + (size_t)Q * N +
         (size_t)Q * (Q + 1) + 4 * (size_t)Q;
}

// x [B,S,H,P], log_a [B,S,H], B/C [B,S,H,N] through strides; h0 [B,H,N,P]
// f32 or null (zeros); y [B,S,H,P] and h_out [B,H,N,P] contiguous.
template <typename T, typename TL>
__global__ void __launch_bounds__(NT)
ssd_kernel(const T* __restrict__ x, const TL* __restrict__ la,
           const T* __restrict__ Bm, const T* __restrict__ Cm,
           const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ h_out,
           int S, int H, int P, int N, int Q, Strides xs_, Strides las_, Strides bs_,
           Strides cs_) {
  extern __shared__ float4 smem4[];  // float4 so the x and h rows are 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem4);
  const int NP1 = N + 1, QP1 = Q + 1, P4 = P / 4;
  float* xs = smem;             // [Q][P]
  float* hs = xs + Q * P;       // [N][P]   the carried state
  float* Bs = hs + N * P;       // [Q][N+1]
  float* Cs = Bs + Q * NP1;     // [Q][N]
  float* sc = Cs + Q * N;       // [Q][Q+1] masked, decayed scores
  float* Ls = sc + Q * QP1;     // [Q] cumulative log-decay
  float* eL = Ls + Q;           // [Q] exp(L)
  float* wL = eL + Q;           // [Q] exp(L_end - L)
  float* las = wL + Q;          // [Q] this chunk's log_a

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const int64_t hbase = ((int64_t)b * H + h) * N * P;

  for (int i = tid; i < N * P; i += NT) hs[i] = h0 ? h0[hbase + i] : 0.0f;

  for (int s0 = 0; s0 < S; s0 += Q) {
    // stage the chunk in shared memory as f32
    for (int i = tid; i < Q * P; i += NT) {
      const int t = i / P, p = i % P;
      xs[i] = to_f(x[b * xs_.b + (int64_t)(s0 + t) * xs_.s + h * xs_.h + p]);
    }
    for (int i = tid; i < Q * N; i += NT) {
      const int t = i / N, n = i % N;
      Bs[t * NP1 + n] = to_f(Bm[b * bs_.b + (int64_t)(s0 + t) * bs_.s + h * bs_.h + n]);
      Cs[i] = to_f(Cm[b * cs_.b + (int64_t)(s0 + t) * cs_.s + h * cs_.h + n]);
    }
    for (int t = tid; t < Q; t += NT)
      las[t] = to_f(la[b * las_.b + (int64_t)(s0 + t) * las_.s + h * las_.h]);
    __syncthreads();
    if (tid == 0) {  // inclusive cumulative sum, in order
      float run = 0.0f;
      for (int t = 0; t < Q; ++t) {
        run += las[t];
        Ls[t] = run;
      }
    }
    __syncthreads();
    const float l_end = Ls[Q - 1];
    for (int t = tid; t < Q; t += NT) {
      eL[t] = expf(Ls[t]);
      wL[t] = expf(l_end - Ls[t]);
    }
    // scores[t][s] = (C_t . B_s) exp(min(L_t - L_s, 0)) for s <= t
    for (int i = tid; i < Q * Q; i += NT) {
      const int t = i / Q, s = i % Q;
      if (s <= t) {
        float dot = 0.0f;
        for (int n = 0; n < N; ++n) dot = fmaf(Cs[t * N + n], Bs[s * NP1 + n], dot);
        sc[t * QP1 + s] = dot * expf(fminf(Ls[t] - Ls[s], 0.0f));
      }
    }
    __syncthreads();

    // y[t, p..p+3] = sum_{s<=t} scores[t][s] x[s] + exp(L_t) (C_t . h)
    for (int i = tid; i < Q * P4; i += NT) {
      const int t = i / P4, p = (i % P4) * 4;
      float4 yi = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s = 0; s <= t; ++s) {
        const float w = sc[t * QP1 + s];
        const float4 xv = *reinterpret_cast<const float4*>(xs + s * P + p);
        yi.x = fmaf(w, xv.x, yi.x); yi.y = fmaf(w, xv.y, yi.y);
        yi.z = fmaf(w, xv.z, yi.z); yi.w = fmaf(w, xv.w, yi.w);
      }
      float4 ch = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int n = 0; n < N; ++n) {
        const float c = Cs[t * N + n];
        const float4 hv = *reinterpret_cast<const float4*>(hs + n * P + p);
        ch.x = fmaf(c, hv.x, ch.x); ch.y = fmaf(c, hv.y, ch.y);
        ch.z = fmaf(c, hv.z, ch.z); ch.w = fmaf(c, hv.w, ch.w);
      }
      const float e = eL[t];
      T* yo = y + (((int64_t)b * S + s0 + t) * H + h) * P + p;
      yo[0] = from_f<T>(yi.x + e * ch.x);
      yo[1] = from_f<T>(yi.y + e * ch.y);
      yo[2] = from_f<T>(yi.z + e * ch.z);
      yo[3] = from_f<T>(yi.w + e * ch.w);
    }
    __syncthreads();  // every thread has read h; now it is updated

    // h[n, p..p+3] = exp(L_end) h + sum_s (B_s[n] exp(L_end - L_s)) x[s]
    const float decay = expf(l_end);
    for (int i = tid; i < N * P4; i += NT) {
      const int n = i / P4, p = (i % P4) * 4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s = 0; s < Q; ++s) {
        const float bw = Bs[s * NP1 + n] * wL[s];
        const float4 xv = *reinterpret_cast<const float4*>(xs + s * P + p);
        acc.x = fmaf(bw, xv.x, acc.x); acc.y = fmaf(bw, xv.y, acc.y);
        acc.z = fmaf(bw, xv.z, acc.z); acc.w = fmaf(bw, xv.w, acc.w);
      }
      float4* hv = reinterpret_cast<float4*>(hs + n * P + p);
      const float4 old = *hv;
      *hv = make_float4(decay * old.x + acc.x, decay * old.y + acc.y,
                        decay * old.z + acc.z, decay * old.w + acc.w);
    }
    __syncthreads();  // the next chunk overwrites xs, Bs, Cs
  }

  for (int i = tid; i < N * P; i += NT) h_out[hbase + i] = hs[i];
}

template <typename T, typename TL>
int launch(const void* x, const void* la, const void* Bm, const void* Cm, const void* h0,
           void* y, void* h_out, int Bn, int S, int H, int P, int N, int Q, Strides xs,
           Strides las, Strides bs, Strides cs, cudaStream_t stream) {
  const size_t bytes = smem_floats(Q, P, N) * sizeof(float);
  auto kern = ssd_kernel<T, TL>;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(H, Bn), NT, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const TL*>(la), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(h_out), S, H, P, N, Q, xs, las, bs, cs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one block needs at chunk Q (the wrapper refuses more than
// the card's 227 KB).
extern "C" int ssd_smem_bytes(int Q, int P, int N) {
  return static_cast<int>(smem_floats(Q, P, N) * sizeof(float));
}

// x [B,S,H,P], log_a [B,S,H], B/C [B,S,H,N] given by element strides (the
// last dim contiguous; any stride may be 0), h0 [B,H,N,P] f32 contiguous
// or null for zeros; writes y [B,S,H,P] (x's type) and h_out [B,H,N,P]
// (f32), both contiguous.  x, B and C are all f32 (x_bf16 = 0) or all
// bf16 (1); log_a f32 (la_bf16 = 0) or bf16 (1).  S must be a multiple of
// Q and P of 4.  Launches on ``stream`` and returns cudaGetLastError()
// (0 on success); does not synchronise.
extern "C" int ssd_fwd(const void* x, const void* la, const void* Bm, const void* Cm,
                       const void* h0, void* y, void* h_out, int x_bf16, int la_bf16,
                       int Bn, int S, int H, int P, int N, int Q,
                       long long xs_b, long long xs_s, long long xs_h,
                       long long las_b, long long las_s, long long las_h,
                       long long bs_b, long long bs_s, long long bs_h,
                       long long cs_b, long long cs_s, long long cs_h, void* stream) {
  if (Bn < 1 || H < 1 || Q < 1 || S < Q || S % Q != 0 || P < 4 || P % 4 != 0 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides xs{xs_b, xs_s, xs_h}, las{las_b, las_s, las_h}, bs{bs_b, bs_s, bs_h},
      cs{cs_b, cs_s, cs_h};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (x_bf16 && la_bf16)
    return launch<bf, bf>(x, la, Bm, Cm, h0, y, h_out, Bn, S, H, P, N, Q, xs, las, bs, cs, st);
  if (x_bf16)
    return launch<bf, float>(x, la, Bm, Cm, h0, y, h_out, Bn, S, H, P, N, Q, xs, las, bs, cs, st);
  if (la_bf16)
    return launch<float, bf>(x, la, Bm, Cm, h0, y, h_out, Bn, S, H, P, N, Q, xs, las, bs, cs, st);
  return launch<float, float>(x, la, Bm, Cm, h0, y, h_out, Bn, S, H, P, N, Q, xs, las, bs, cs, st);
}
