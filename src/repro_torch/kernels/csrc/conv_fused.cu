// The quantized conv on the u8 tensor cores: an implicit-GEMM convolution
// of QASYMM8 operands, NHWC activations, filters k-major per output
// channel, an exact int32 sum, and the requant step in the epilogue.
//
// Replaces the int32 instantiation of the Pallas kernel
// repro/kernels/conv_fused.py::_conv_fused_kernel (launched by
// _conv_fused_call from qconv2d_fused):
//
//     y[m, n] = act(float(sum_k (qa[m, k] - za) (qw[k, n] - zw[n])) * (sa * scale[n]) + bias[n])
//
// with m = (b, oh, ow) over M = B*OH*OW output pixels, n over Cout, and
// k = (fi, fj, c) over K = FH*FW*C.  qa[m, k] is the u8 input pixel
// x[b, oh*stride - pad + fi, ow*stride - pad + fj, c], read on the fly;
// a tap in the spatial padding holds the activation zero point za (float
// 0 quantizes to it), so its shifted value is 0 as in the reference's
// zero-padded shifted input.  The f32 instantiation is csrc/gemm.cu's
// conv_fused_f32.
//
// The shifted operands are 9-bit values, which no tensor-core type
// holds, so the kernel multiplies the unshifted u8 values and corrects:
//
//     sum_k (qa - za)(qw - zw) = sum_k qa qw - zw sum_k qa - za sum_k qw + K za zw
//
// The products run on mma.sync.m16n8k32.u8.u8.s32 with int32 sums.  The
// row sums sum_k qa come from one more mma of each A fragment against an
// all-ones B fragment; the column sums sum_k qw are per layer (the
// wrapper's, exact in int32).  K in the identity is the real K: a k past
// K in the last k-step is 0 on both operands, so it adds to no sum.
// Every term is at most 4608 * 255 * 255 < 3.0e8 < 2^31 for the six nets'
// largest K, and so is the result; the int32 sums are exact in any order,
// so the output does not depend on the tiles.  The epilogue is
// y = float(acc) * (sa * scale[n]) + bias[n], each step rounded on its own
// (__int2float_rn, __fmul_rn, __fadd_rn: no contraction into an FMA), so
// the output is bitwise equal to the plain PyTorch version.
//
// What bounds it on an H100: bytes.  At VGG-16's convs the int8 tensor
// cores (1,979 TOPS dense) need 0.062 ms for the 13 layers at batch 4,
// the f32 outputs alone 0.065 ms of the 0.080 ms the bytes take.
//
// Design (a first tensor-core version).  A block computes a BM x BN
// output tile with 4 or 8 warps, each warp a 64 x 32 or 32 x 32 tile of
// m16n8k32 fragments.  K goes through a ring of three shared-memory stages
// of 64 bytes of k each, filled by cp.async while the previous stages
// compute; rows are padded to 80 bytes so the ldmatrix reads of 8 rows hit
// distinct banks.  The filter operand is the wrapper's transposed copy of
// qw ([Cout, Kp] u8, k contiguous, zero-padded to Kp = K rounded up to 16):
// the mma's B operand wants k contiguous per column, and ldmatrix.trans
// takes no 8-bit type.  The A operand: each block decomposes its output
// pixels once into a table in shared memory (a 64-bit base offset and the
// top-left input pixel); where C % 16 == 0 a 16-byte piece of a row lies
// inside one filter tap and is copied by cp.async, and a piece in the
// padding is written as 16 bytes of za by a plain store (the copy's zero
// fill would be wrong here); other C (the nets' first convs, C = 3, and
// one C = 24) gather byte by byte.  Ragged shapes are masked: C = 3 (K =
// 27), Ow = 14 (a partial M tile), Cout not a multiple of the tile, any
// stride and pad.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;          // bytes (k) a stage
constexpr int ROWB = BK + 16;   // a stage row's pitch: 80 bytes, 20 banks apart
constexpr int STAGES = 3;
constexpr int SMS = 132;        // SMs of an H100 SXM

struct Tap {
  int fi, fj;
  long long off;  // (fi * W + fj) * C + c
};

struct __align__(16) RowEntry {
  long long base;  // offset of x[b, ih0, iw0, 0] (negative where the window starts in the padding)
  int ih0, iw0;    // the input pixel under the window's top-left tap
};

template <int BM_, int BN_, int WARPS_M_, int WARPS_N_>
struct QTile {
  static constexpr int BM = BM_, BN = BN_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int NT = 32 * WARPS_M * WARPS_N;
  static constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;  // a warp's tile
  static constexpr int MI = WTM / 16, NI = WTN / 8;             // its m16 and n8 fragments
  static constexpr int STAGE_BYTES = (BM + BN) * ROWB;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE_BYTES + BM * sizeof(RowEntry);
  static_assert(NI % 2 == 0 && MI >= 1, "B fragments are loaded two n8 tiles at a time");
  static_assert(NT % BK == 0 && (BM * 4) % NT == 0, "copies split evenly");
};
// the variants, picked from (M, Cout) by qconv_variant
using QT0 = QTile<128, 128, 2, 4>;  // 256 threads, warp 64 x 32
using QT1 = QTile<128, 64, 2, 2>;   // 128 threads, warp 64 x 32
using QT2 = QTile<64, 64, 2, 2>;    // 128 threads, warp 32 x 32
constexpr int N_VARIANTS = 3;

struct QArgs {
  const uint8_t* x;     // [B, H, W, C] u8
  const uint8_t* wt;    // [Cout, Kp] u8, k contiguous, zero past K
  const int* colsum;    // [Cout] sum_k qw[k, n]
  const float* za;      // activation zero point (one value)
  const float* zw;      // [Cout] weight zero points
  const float* sa;      // activation scale (one value)
  const float* scale;   // [Cout] weight scales
  const float* bias;    // [Cout]
  float* y;             // [M, Cout] f32
  int H, W, C, FW, Cout, stride, pad, OH, OW, relu, M, K, Kp;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
// c += a (16 x 32, row) * b (32 x 8, col), u8 x u8 -> s32
__device__ __forceinline__ void mma_u8(int (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <class TL, bool VEC>
__global__ void __launch_bounds__(TL::NT) qconv_u8_kernel(const QArgs a) {
  constexpr int BM = TL::BM, BN = TL::BN, NT = TL::NT, MI = TL::MI, NI = TL::NI;
  extern __shared__ __align__(16) uint8_t smem[];
  RowEntry* rows = reinterpret_cast<RowEntry*>(smem + STAGES * TL::STAGE_BYTES);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / TL::WARPS_N, wn = warp % TL::WARPS_N;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int za = __float2int_rn(__ldg(a.za));
  const unsigned za4 = 0x01010101u * (unsigned)za;

  for (int r = tid; r < BM; r += NT) {
    const int m = m0 + r;
    RowEntry e{0, -(1 << 28), 0};  // rows past M fail every bounds check
    if (m < a.M) {
      const int b = m / (a.OH * a.OW);
      const int rem = m - b * (a.OH * a.OW);
      const int oh = rem / a.OW, ow = rem - oh * a.OW;
      e.ih0 = oh * a.stride - a.pad;
      e.iw0 = ow * a.stride - a.pad;
      e.base = (((long long)b * a.H + e.ih0) * a.W + e.iw0) * a.C;
    }
    rows[r] = e;
  }
  __syncthreads();

  // where k lies: its tap (fi, fj) and its offset from a row's base; a
  // k past K gets a tap that no bounds check needs
  auto tap_of = [&](int k) {
    Tap t{0, 0, 0};
    if (k < a.K) {
      const int tap = k / a.C, c = k - tap * a.C;
      t.fi = tap / a.FW;
      t.fj = tap - t.fi * a.FW;
      t.off = ((long long)t.fi * a.W + t.fj) * a.C + c;
    }
    return t;
  };
  auto load = [&](int step) {
    uint8_t* As = smem + (step % STAGES) * TL::STAGE_BYTES;
    uint8_t* Bs = As + BM * ROWB;
    const int k0 = step * BK;
    if constexpr (VEC) {  // 16-byte pieces inside one tap
      const int j = tid & 3, k = k0 + 16 * j;
      const bool k_ok = k < a.K;
      const Tap tp = tap_of(k);
#pragma unroll
      for (int i = 0; i < BM * 4 / NT; ++i) {
        const int r = (tid >> 2) + i * (NT / 4);
        uint8_t* dst = As + r * ROWB + 16 * j;
        const RowEntry e = rows[r];
        const int ih = e.ih0 + tp.fi, iw = e.iw0 + tp.fj;
        if (k_ok && (unsigned)ih < (unsigned)a.H && (unsigned)iw < (unsigned)a.W) {
          cp_async16(dst, a.x + e.base + tp.off, true);
        } else {  // past K: 0; a padding tap: za
          const unsigned v = k_ok ? za4 : 0u;
          *reinterpret_cast<uint4*>(dst) = make_uint4(v, v, v, v);
        }
      }
    } else {  // byte by byte: a thread's k fixed for the step, its rows in turn
      const int kl = tid % BK, k = k0 + kl;
      const bool k_ok = k < a.K;
      const Tap tp = tap_of(k);
      for (int r = tid / BK; r < BM; r += NT / BK) {
        const RowEntry e = rows[r];
        const int ih = e.ih0 + tp.fi, iw = e.iw0 + tp.fj;
        uint8_t v = 0;
        if (k_ok)
          v = ((unsigned)ih < (unsigned)a.H && (unsigned)iw < (unsigned)a.W) ? __ldg(a.x + e.base + tp.off)
                                                                             : (uint8_t)za;
        As[r * ROWB + kl] = v;
      }
    }
#pragma unroll
    for (int i = 0; i < BN * 4 / NT + (BN * 4 % NT != 0); ++i) {
      const int c = tid + i * NT;
      if (c < BN * 4) {
        const int r = c >> 2, j = c & 3, n = n0 + r, k = k0 + 16 * j;
        const bool ok = n < a.Cout && k < a.Kp;
        cp_async16(Bs + r * ROWB + 16 * j, ok ? a.wt + (long long)n * a.Kp + k : a.wt, ok);
      }
    }
  };

  int acc[MI][NI][4], rsum[MI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) rsum[i][q] = 0;
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;
  }
  const int n_steps = (a.K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_steps) load(s);
    cp_async_commit();
  }
  // ldmatrix rows: A fragment rows lane & 15 at byte (lane >> 4) * 16; a
  // pair of B fragments n rows ((lane >> 4) << 3) + (lane & 7) at byte
  // ((lane >> 3) & 1) * 16
  const int a_row = wm * TL::WTM + (lane & 15), a_col = (lane >> 4) * 16;
  const int b_row = wn * TL::WTN + ((lane >> 4) << 3) + (lane & 7), b_col = ((lane >> 3) & 1) * 16;
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage `step` has landed; every warp is done with step - 1's
    if (step + STAGES - 1 < n_steps) load(step + STAGES - 1);
    cp_async_commit();
    const uint8_t* As = smem + (step % STAGES) * TL::STAGE_BYTES;
    const uint8_t* Bs = As + BM * ROWB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned af[MI][4], bf[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) ldmatrix_x4(af[i], As + (a_row + i * 16) * ROWB + kk + a_col);
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        unsigned r[4];
        ldmatrix_x4(r, Bs + (b_row + j * 8) * ROWB + kk + b_col);
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        mma_u8(rsum[i], af[i], 0x01010101u, 0x01010101u);  // every column: the row's sum
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_u8(acc[i][j], af[i], bf[j][0], bf[j][1]);
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: the zero-point corrections, then the requant step
  const int g = lane >> 2, tig = lane & 3;
  const float sa = __ldg(a.sa);
  int zw[NI][2], corr[NI][2];
  float ms[NI][2], bias[NI][2];
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn * TL::WTN + j * 8 + tig * 2 + e;
      const bool ok = n < a.Cout;
      zw[j][e] = ok ? __float2int_rn(__ldg(a.zw + n)) : 0;
      corr[j][e] = ok ? a.K * za * zw[j][e] - za * __ldg(a.colsum + n) : 0;
      ms[j][e] = ok ? __fmul_rn(sa, __ldg(a.scale + n)) : 0.0f;
      bias[j][e] = ok ? __ldg(a.bias + n) : 0.0f;
    }
  const bool pairs = (a.Cout & 1) == 0;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * TL::WTM + i * 16 + g + half * 8;
      if (m >= a.M) continue;
      const int rs = rsum[i][half * 2];
      float* yrow = a.y + (long long)m * a.Cout;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int n = n0 + wn * TL::WTN + j * 8 + tig * 2;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int s = acc[i][j][half * 2 + e] - zw[j][e] * rs + corr[j][e];
          v[e] = __fadd_rn(__fmul_rn(__int2float_rn(s), ms[j][e]), bias[j][e]);
          if (a.relu) v[e] = fmaxf(v[e], 0.0f);
        }
        if (pairs && n + 1 < a.Cout) {
          *reinterpret_cast<float2*>(yrow + n) = make_float2(v[0], v[1]);
        } else {
          if (n < a.Cout) yrow[n] = v[0];
          if (n + 1 < a.Cout) yrow[n + 1] = v[1];
        }
      }
    }
}

template <class TL>
int launch_tile(const QArgs& a, bool vec, cudaStream_t stream) {
  const dim3 grid((a.M + TL::BM - 1) / TL::BM, (a.Cout + TL::BN - 1) / TL::BN);
  auto kern = vec ? qconv_u8_kernel<TL, true> : qconv_u8_kernel<TL, false>;
  static bool opted_in[2] = {false, false};  // above 48 KB, once per kernel
  if (TL::SMEM > 48 * 1024 && !opted_in[vec]) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)TL::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in[vec] = true;
  }
  kern<<<grid, TL::NT, TL::SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// the widest tile that still gives two blocks an SM
int qconv_variant(int M, int N) {
  if (N >= 128 && cdiv(M, QT0::BM) * cdiv(N, QT0::BN) >= 2 * SMS) return 0;
  if (cdiv(M, QT1::BM) * cdiv(N, QT1::BN) >= 2 * SMS) return 1;
  return 2;
}

}  // namespace

extern "C" int qconv_tile_variants() { return N_VARIANTS; }

// x [B,H,W,C] u8 (contiguous; vec = 1 when C % 16 == 0 and x is 16-byte
// aligned), wt [Cout, Kp] u8 (Kp a multiple of 16, zero past K = FH*FW*C,
// 16-byte aligned), colsum [Cout] int32, za and sa one f32 each, zw,
// scale and bias [Cout] f32, y [B,OH,OW,Cout] f32; all on the device.
// variant: 0 .. qconv_tile_variants() - 1, or -1 to pick from the shape.
// Launches on ``stream`` and returns cudaGetLastError() (0 on success);
// does not synchronise.
extern "C" int qconv_u8(const void* x, const void* wt, const void* colsum, const void* za,
                        const void* zw, const void* sa, const void* scale, const void* bias,
                        void* y, int B, int H, int W, int C, int FH, int FW, int Cout, int stride,
                        int pad, int OH, int OW, int relu, int Kp, int vec, int variant,
                        void* stream) {
  const int M = B * OH * OW, K = FH * FW * C;
  if (M <= 0 || Cout <= 0) return 0;
  if (Kp < K || Kp % 16 != 0 || (vec && C % 16 != 0) || variant >= N_VARIANTS)
    return static_cast<int>(cudaErrorInvalidValue);
  const QArgs a{static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(wt),
                static_cast<const int*>(colsum), static_cast<const float*>(za),
                static_cast<const float*>(zw), static_cast<const float*>(sa),
                static_cast<const float*>(scale), static_cast<const float*>(bias),
                static_cast<float*>(y), H, W, C, FW, Cout, stride, pad, OH, OW, relu, M, K, Kp};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant < 0 ? qconv_variant(M, Cout) : variant) {
    case 0: return launch_tile<QT0>(a, vec != 0, st);
    case 1: return launch_tile<QT1>(a, vec != 0, st);
    default: return launch_tile<QT2>(a, vec != 0, st);
  }
}
