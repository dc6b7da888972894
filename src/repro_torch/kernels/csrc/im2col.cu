// im2col, f32: x [B,H,W,C] (NHWC, any batch, row and pixel stride, unit
// channel stride) -> cols [B*OH*OW, FH*FW*C], features ordered (fh, fw, c)
// to match the HWIO filter reshaped to [FH*FW*C, Cout].
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
// is the patch matrix's bytes plus the input's over 3.35 TB/s.
//
// Design.  For one patch row (b, oh, ow) and one filter row fi, the FW*C
// features are the FW adjacent pixels x[b, oh*s - p + fi, ow*s - p + fj, :],
// fj = 0..FW-1: a "run", written to FW*C consecutive floats of cols,
// whatever the stride.  Only whole pixels of a run fall into the padding
// (a head and a tail), or the whole run does when its input row is out of
// range.  Runs are numbered r = row*FH + fi, which is their order in cols,
// so a span of consecutive runs is one contiguous piece of cols, and rows
// of different images follow each other in it.  A block copies one span:
// its first threads decode each run once (row, input row, source offset,
// valid pixels [lo, hi)) into a table in shared memory; then every thread
// walks the span's output linearly, each element finding its run and pixel
// by two multiply-shift divisions (no integer division per element).
//
// * 16-byte path (C % 4 == 0, base and the three strides multiples of 16
//   bytes): every load and store is a float4, U independent loads in
//   flight a thread before its stores, so an SM keeps U times the bytes of
//   a one-float copy waiting on memory.
// * Staged path (any other C, or a misaligned channel slice): 4-byte
//   loads, U in flight a thread, gathered into shared memory; the block
//   then writes its span out linearly with 16-byte stores.  A span starts
//   at a run index that is a multiple of 4, so at a 16-byte boundary.
//
// Stores are evict-first: the GEMM reads the matrix back once, and at 8 of
// VGG-16's 13 convs it is larger than the 50 MB L2.  Registers are capped
// at 40 (six blocks of 256 an SM); uncapped, the staged path takes 94 and
// runs two blocks an SM.
//
// Offsets into x and cols are 64-bit: cols has 1.16e8 elements at conv1_2.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int NT = 256;        // threads a block
constexpr int U = 4;           // loads in flight a thread before its stores
constexpr int SPAN4 = 1024;    // float4s a block copies on the 16-byte path (about)
constexpr int STAGE = 4096;    // floats a block stages at once on the staged path
constexpr int MAX_RUNS = 512;  // runs a block (its table in shared memory)
constexpr int MIN_BLOCKS = 4 * 132;  // spans shrink until the grid has this many blocks
constexpr int STREAMING = 1;   // 1: stores marked evict-first (st.global.cs)
constexpr int MINB = 6;        // blocks of NT an SM: registers capped at 40 a thread

// n / d as umulhi(n, m) >> s, exact for n < 2^31 (d == 1 is n itself)
struct FastDiv {
  unsigned d, m, s;
};

FastDiv make_div(unsigned d) {
  FastDiv f{d, 0u, 0u};
  if (d > 1) {
    unsigned l = 0;
    while ((1ull << l) < d) ++l;  // ceil(log2 d)
    const unsigned p = 31 + l;
    f.m = static_cast<unsigned>(((1ull << p) + d - 1) / d);
    f.s = p - 32;
  }
  return f;
}

__device__ __forceinline__ unsigned quot(unsigned n, const FastDiv& f) {
  return f.d == 1 ? n : __umulhi(n, f.m) >> f.s;
}

struct Geo {
  long long sB, sH, sW;  // input strides in floats: batch, row, pixel
  int runs;              // B*OH*OW*FH
  int H, W, FH, FW, stride, pad, OH, OW;
  int L;                 // the run's length: FW*C floats or FW*C/4 float4s
  int per_px;            // units a pixel: C or C/4
  int nr;                // runs a block
  FastDiv by_L, by_px, by_FH, by_OHW, by_OW;
};

// One run's source: the offset in floats of pixel fj = 0 (outside x when
// the run starts in the padding; only pixels lo <= fj < hi are read).
struct __align__(16) Run {
  long long src;
  int lo, hi;
};

__device__ __forceinline__ Run decode(const Geo& g, unsigned r) {
  const unsigned m = quot(r, g.by_FH);  // the patch row (b, oh, ow)
  const int fi = static_cast<int>(r - m * g.FH);
  const unsigned b = quot(m, g.by_OHW);
  const unsigned rem = m - b * g.by_OHW.d;
  const unsigned oh = quot(rem, g.by_OW);
  const int ih = static_cast<int>(oh) * g.stride - g.pad + fi;
  const int iw0 = static_cast<int>(rem - oh * g.OW) * g.stride - g.pad;
  Run run;
  run.src = b * g.sB + static_cast<long long>(ih) * g.sH + static_cast<long long>(iw0) * g.sW;
  run.lo = max(0, -iw0);
  run.hi = (ih < 0 || ih >= g.H) ? 0 : min(g.FW, g.W - iw0);
  return run;
}

// the span's run table; returns the number of runs in the span
__device__ __forceinline__ int load_table(const Geo& g, int r0, Run* tab) {
  const int nr = min(g.nr, g.runs - r0);
  for (int t = threadIdx.x; t < nr; t += NT) tab[t] = decode(g, static_cast<unsigned>(r0 + t));
  __syncthreads();
  return nr;
}

template <typename T>
__device__ __forceinline__ void put(T* p, const T& v) {
  if constexpr (STREAMING) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

__global__ void __launch_bounds__(NT, MINB)
im2col_wide(const float4* __restrict__ x, float4* __restrict__ cols, Geo g) {
  __shared__ Run tab[MAX_RUNS];
  const int r0 = static_cast<int>(blockIdx.x) * g.nr;
  const unsigned n = static_cast<unsigned>(load_table(g, r0, tab)) * g.L;
  float4* dst = cols + static_cast<long long>(r0) * g.L;
  const long long sw4 = g.sW >> 2;
  for (unsigned q0 = threadIdx.x; q0 < n; q0 += NT * U) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned q = q0 + u * NT;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q < n) {
        const unsigned t = quot(q, g.by_L);
        const unsigned j = q - t * g.L;
        const unsigned fj = quot(j, g.by_px);
        const Run run = tab[t];
        if (static_cast<int>(fj) >= run.lo && static_cast<int>(fj) < run.hi) {
          v[u] = __ldg(x + (run.src >> 2) + fj * sw4 + (j - fj * g.per_px));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned q = q0 + u * NT;
      if (q < n) put(dst + q, v[u]);
    }
  }
}

__global__ void __launch_bounds__(NT, MINB)
im2col_staged(const float* __restrict__ x, float* __restrict__ cols, Geo g) {
  __shared__ Run tab[MAX_RUNS];
  __shared__ float4 stage4[STAGE / 4];
  float* stage = reinterpret_cast<float*>(stage4);
  const int r0 = static_cast<int>(blockIdx.x) * g.nr;
  const unsigned n = static_cast<unsigned>(load_table(g, r0, tab)) * g.L;
  float* dst = cols + static_cast<long long>(r0) * g.L;  // 16-byte aligned: r0 % 4 == 0
  for (unsigned c0 = 0; c0 < n; c0 += STAGE) {  // STAGE floats at a time
    const unsigned len = min(n - c0, static_cast<unsigned>(STAGE));
    for (unsigned q0 = threadIdx.x; q0 < len; q0 += NT * U) {
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const unsigned q = q0 + u * NT;
        v[u] = 0.f;
        if (q < len) {
          const unsigned e = c0 + q;
          const unsigned t = quot(e, g.by_L);
          const unsigned j = e - t * g.L;
          const unsigned fj = quot(j, g.by_px);
          const Run run = tab[t];
          if (static_cast<int>(fj) >= run.lo && static_cast<int>(fj) < run.hi) {
            v[u] = __ldg(x + run.src + fj * g.sW + (j - fj * g.per_px));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const unsigned q = q0 + u * NT;
        if (q < len) stage[q] = v[u];
      }
    }
    __syncthreads();
    float4* out4 = reinterpret_cast<float4*>(dst + c0);  // c0 % 4 == 0
    const unsigned len4 = len >> 2;
    for (unsigned q = threadIdx.x; q < len4; q += NT) put(out4 + q, stage4[q]);
    for (unsigned q = (len4 << 2) + threadIdx.x; q < len; q += NT) put(dst + c0 + q, stage[q]);
    __syncthreads();
  }
}

}  // namespace

// x [B,H,W,C] f32 with strides (sB, sH, sW, 1) in floats, cols
// [B*OH*OW, FH*FW*C] f32 contiguous and 16-byte aligned, on the device.
// wide = 1 takes the 16-byte path and requires C % 4 == 0 and x and the
// three strides 16-byte multiples; wide = 0 takes the staged path, which
// takes any of them.  Launches on ``stream`` and returns
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int im2col_f32(const void* x, void* cols, int B, int H, int W,
                          int C, int FH, int FW, int stride, int pad, int OH,
                          int OW, long long sB, long long sH, long long sW,
                          int wide, void* stream) {
  const long long rows = static_cast<long long>(B) * OH * OW;
  const long long K = static_cast<long long>(FH) * FW * C;
  if (rows <= 0 || K <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(cols) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (wide && (C % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 || sB % 4 != 0 ||
               sH % 4 != 0 || sW % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // runs and a span's elements are counted in 32 bits
  if (rows * FH >= (1ll << 31) || static_cast<long long>(MAX_RUNS) * K >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geo g;
  g.sB = sB;
  g.sH = sH;
  g.sW = sW;
  g.runs = static_cast<int>(rows * FH);
  g.H = H;
  g.W = W;
  g.FH = FH;
  g.FW = FW;
  g.stride = stride;
  g.pad = pad;
  g.OH = OH;
  g.OW = OW;
  g.per_px = wide ? C / 4 : C;
  g.L = FW * g.per_px;
  long long nr = std::clamp<long long>((wide ? SPAN4 : STAGE) / g.L, 1, MAX_RUNS);
  nr = std::min(nr, std::max(1ll, (rows * FH + MIN_BLOCKS - 1) / MIN_BLOCKS));  // enough blocks
  if (!wide) nr = std::max(4ll, nr / 4 * 4);  // spans start on 16-byte boundaries
  g.nr = static_cast<int>(nr);
  g.by_L = make_div(static_cast<unsigned>(g.L));
  g.by_px = make_div(static_cast<unsigned>(g.per_px));
  g.by_FH = make_div(static_cast<unsigned>(FH));
  g.by_OHW = make_div(static_cast<unsigned>(OH * OW));
  g.by_OW = make_div(static_cast<unsigned>(OW));
  const long long grid = (rows * FH + nr - 1) / nr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) {
    im2col_wide<<<static_cast<unsigned>(grid), NT, 0, s>>>(
        static_cast<const float4*>(x), static_cast<float4*>(cols), g);
  } else {
    im2col_staged<<<static_cast<unsigned>(grid), NT, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(cols), g);
  }
  return static_cast<int>(cudaGetLastError());
}
