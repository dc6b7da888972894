// Decode attention: one new query token per sequence against its KV
// cache, split over the cache (split-KV) and combined in a second pass.
//
// Replaces the Pallas kernel repro/kernels/flash_decode.py::_flash_decode_kernel
// (entry point flash_decode), which handles one KV head (q [G, D], k/v
// [S, D], a valid prefix ``length``), walks the cache in blocks along a
// sequential grid carrying the running max m, normaliser l and
// accumulator acc in VMEM, and is vmapped over (batch, KV head).  The
// function is the same: operands read as f32 (bf16 or f32 in memory), the
// softmax weights kept in f32 for the PV product, the output acc / max(l,
// 1e-30) cast to q's type.  The scale, with log2 e for a base-2 softmax,
// is applied to q once instead of to every logit.
//
// What bounds it on an H100: bytes.  Each cache element is read once and
// feeds G multiply-adds (G = 5 for Hymba), far below the ~20 f32 FLOP a
// byte at which the CUDA cores would be the limit, so it stays on the
// CUDA cores in f32.  What it needs is enough bytes in flight with a
// small batch x KV heads (20 pairs at the served shape), so the cache is
// cut into splits of SPLIT slots, each split its own block.  A copy-only
// kernel with this access pattern moves decode_32k's cache in 0.22 ms on
// an H100 SXM (bound 0.20 ms); this one takes about 0.27 ms there, so
// the per-slot instructions (about 40 warp instructions for 16 slots of
// G = 5, D = 64: FMAs, the shuffle butterfly, the softmax), not the
// memory system, are what is left to cut.
//
// Pass 1 (fd_split_kernel), grid (Hkv x G-chunks, n_split, B), 2 warps
// (the heads of one split run side by side and read whole cache rows):
//   * each warp owns a contiguous half of the split's slots, and its own
//     ring of NSTAGE stages in shared memory, filled with cp.async
//     16-byte copies of K and V as stored (bf16 or f32); each lane copies
//     exactly the pieces it later reads, so a lane waits on its own
//     cp.async groups and the loop has no barrier;
//   * a lane owns one 16-byte piece of a row (8 bf16 or 4 f32 values), a
//     group of P2 lanes a row (fixed at compile time for P2 = 8 and 16),
//     so a warp takes 32 / P2 rows at once; the lane keeps its pieces of
//     the G-chunk's q rows (up to 8 rows, times the scale and log2 e) in
//     registers, and a logit is its lane's partial dot then a shuffle
//     butterfly over the P2 lanes of the row;
//   * each lane group is a stream of its own: online softmax (base 2,
//     weights by MUFU.EX2) and the PV accumulation over its rows in
//     registers, U rows per rescale, the masking only on a warp's last
//     step;
//   * at the end the block's streams are combined once, in stream order,
//     through shared memory, into one partial (m[G], l[G], acc[G][D]) in
//     f32 scratch that the wrapper allocates.
// Pass 2 (fd_combine_kernel), one block per (query row, KV head, batch),
// a thread per d: adds the partials in split order, M = max m_s, L = sum
// l_s 2^(m_s - M), out = sum acc_s 2^(m_s - M) / max(L, 1e-30), cast to
// q's type.
//
// SPLIT (flash_decode_split_len) depends on W and D alone, so the grid,
// the scratch size and every output's summation order are fixed by (W,
// D, G) whatever B and ``length`` are: a row's result is bitwise the same
// at any batch.  A split wholly past ``length`` returns at once and
// writes nothing: the combine stops at ceil(length / SPLIT).  Within a
// split, slots at or beyond ``length`` are never read.
//
// ``length`` comes from the host (an int argument) or from the device (a
// pointer to one int32, read by every block of both passes and clamped to
// [1, W]), so that a decode step captured in a CUDA graph reads the
// position it is replayed at.  Both passes compute the same split count
// from it either way, so the two give the same bits at the same length.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARPS = 2;
constexpr int NT = WARPS * 32;
constexpr int U = 4;              // rows a lane group takes per step
constexpr int NSTAGE = 3;         // ring stages per warp
constexpr int GMAX = 8;           // query rows a block holds in registers
constexpr int MAX_D = 128;
constexpr int MAX_GD = 2048;
constexpr int MIN_SPLIT = 64;
constexpr int MAX_SPLIT = 512;
constexpr int SPLIT_ELEMS = 512 * 64;  // largest SPLIT * D
constexpr int TARGET_SPLITS = 16;      // splits per (batch, KV head) aimed at
constexpr int MAX_SPLITS = 1024;       // most splits per (batch, KV head)
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// Elements of T in one 16-byte vector, and their conversion to f32.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& r, float* o) {
    o[0] = __uint_as_float(r.x); o[1] = __uint_as_float(r.y);
    o[2] = __uint_as_float(r.z); o[3] = __uint_as_float(r.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& r, float* o) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is a 16-bit shift, exact
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x in one instruction (MUFU.EX2, max error 2 ulp; results below 2^-126
// flush to 0), for the softmax weights, whose arguments are <= 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The valid prefix: the device value clamped to [1, W] where there is one,
// else the host's (checked by the caller).
__device__ __forceinline__ int valid_length(const int* length_dev, int length, int W) {
  if (length_dev == nullptr) return length;
  const int n = __ldg(length_dev);
  return n < 1 ? 1 : (n > W ? W : n);
}

__host__ __device__ inline int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

int split_len(int W, int D) {
  int cap = SPLIT_ELEMS / (D > 0 ? D : 1);
  if (cap > MAX_SPLIT) cap = MAX_SPLIT;
  int s = MIN_SPLIT;
  while (s < cap && s * TARGET_SPLITS < W) s <<= 1;
  const int least = ((W + MAX_SPLITS - 1) / MAX_SPLITS + MIN_SPLIT - 1) / MIN_SPLIT * MIN_SPLIT;
  return s > least ? s : least;
}

// Scratch layout, all f32: m [B][Hkv][n_split][G], then l of the same
// shape, then acc [B][Hkv][n_split][G][D].
struct Part {
  float* m;
  float* l;
  float* acc;
};

__host__ __device__ inline Part part_view(float* base, int B, int hkv, int n_split, int G) {
  const size_t n = (size_t)B * hkv * n_split * G;
  return {base, base + n, base + 2 * n};
}

// q [B, Hkv, G, D], k/v [B, W, Hkv, D], contiguous.  P2C > 0 fixes the
// lanes a row takes at compile time (the shuffle butterfly unrolled); 0
// takes it from D at run time.
template <typename T, int GC, int P2C>
__global__ void __launch_bounds__(NT)
fd_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                float* __restrict__ scratch, int B, int hkv, int G, int D, int W,
                const int* __restrict__ length_dev, int length_host, int split, int n_split,
                float scale2) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int VN = Vec<T>::N;
  const int length = valid_length(length_dev, length_host, W);
  const int s_idx = blockIdx.y;
  const int s0 = s_idx * split;
  if (s0 >= length) return;  // wholly past the prefix: the combine stops before it
  const int n_gc = (G + GC - 1) / GC;
  const int h = blockIdx.x / n_gc, g0 = (blockIdx.x % n_gc) * GC;
  const int b = blockIdx.z;
  const int gn = min(GC, G - g0);
  const int lpr = D / VN;          // 16-byte pieces in a cache row
  const int p2 = P2C > 0 ? P2C : pow2_at_least(lpr);  // lanes a row takes
  const int rpw = 32 / p2;         // rows a warp takes at once
  const int R = rpw * U;           // rows a warp takes per step
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = lane / p2, piece = lane % p2;
  const bool has_piece = piece < lpr;

  const int per_warp = split / WARPS;
  const int w0 = s0 + warp * per_warp;
  const int n_rows = max(0, min(w0 + per_warp, length) - w0);
  const int n_steps = (n_rows + R - 1) / R;

  const int64_t slot_stride = (int64_t)hkv * D;
  const int64_t base = ((int64_t)b * W * hkv + h) * D + piece * VN;  // slot 0 of (b, h), this piece
  const int stage_bytes = R * lpr * 16;  // one of K or V
  unsigned char* ring = smem + (size_t)warp * NSTAGE * 2 * stage_bytes;

  auto issue = [&](int step) {
    if (step < n_steps && has_piece) {
      unsigned char* sk = ring + (step % NSTAGE) * 2 * stage_bytes;
      unsigned char* sv = sk + stage_bytes;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = u * rpw + r;
        const int row = step * R + j;
        if (row < n_rows) {
          const int64_t off = base + (int64_t)(w0 + row) * slot_stride;
          cp_async16(sk + (j * lpr + piece) * 16, k + off);
          cp_async16(sv + (j * lpr + piece) * 16, v + off);
        }
      }
    }
    cp_async_commit();  // every step commits a group, empty or not
  };

#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) issue(i);

  // this lane's pieces of the chunk's query rows
  float qf[GC][VN];
  const T* qb = q + (((int64_t)b * hkv + h) * G + g0) * D + piece * VN;
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (g < gn && has_piece) {
      Vec<T>::unpack(*reinterpret_cast<const uint4*>(qb + (int64_t)g * D), qf[g]);
#pragma unroll
      for (int e = 0; e < VN; ++e) qf[g][e] *= scale2;
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) qf[g][e] = 0.0f;
    }
  }

  float m[GC], l[GC], acc[GC][VN];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = NEG;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < VN; ++e) acc[g][e] = 0.0f;
  }

  // one step: U rows per lane group; FULL when every row of it is valid
  auto run_step = [&](int step, auto full) {
    constexpr bool FULL = decltype(full)::value;
    cp_async_wait<NSTAGE - 2>();  // this lane's copies of ``step`` have landed
    const unsigned char* sk = ring + (step % NSTAGE) * 2 * stage_bytes;
    const unsigned char* sv = sk + stage_bytes;
    float sc[U][GC];  // logits (base 2), then softmax weights
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = u * rpw + r;
      valid[u] = FULL || step * R + j < n_rows;
      float kf[VN];
      if (valid[u] && has_piece) {
        Vec<T>::unpack(*reinterpret_cast<const uint4*>(sk + (j * lpr + piece) * 16), kf);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) kf[e] = 0.0f;
      }
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float part = 0.0f;
#pragma unroll
        for (int e = 0; e < VN; ++e) part = fmaf(qf[g][e], kf[e], part);
        sc[u][g] = part;
      }
#pragma unroll
      for (int o = p2 >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int g = 0; g < GC; ++g) sc[u][g] += __shfl_xor_sync(0xffffffffu, sc[u][g], o);
      }
    }
    // online softmax over this step's U rows, per query row
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (valid[u]) mx = fmaxf(mx, sc[u][g]);
      const float alpha = fast_exp2(m[g] - mx);
      l[g] *= alpha;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < VN; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sc[u][g] = valid[u] ? fast_exp2(sc[u][g] - mx) : 0.0f;
        l[g] += sc[u][g];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!valid[u] || !has_piece) continue;
      const int j = u * rpw + r;
      float vf[VN];
      Vec<T>::unpack(*reinterpret_cast<const uint4*>(sv + (j * lpr + piece) * 16), vf);
#pragma unroll
      for (int g = 0; g < GC; ++g)
#pragma unroll
        for (int e = 0; e < VN; ++e) acc[g][e] = fmaf(sc[u][g], vf[e], acc[g][e]);
    }
    issue(step + NSTAGE - 1);  // into the stage read one step ago
  };
  const int n_full = n_rows / R;
  for (int step = 0; step < n_full; ++step) run_step(step, std::true_type{});
  if (n_full < n_steps) run_step(n_full, std::false_type{});
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: reuse it for the combine

  // combine the block's streams (one per lane group) in stream order
  const int streams = WARPS * rpw;
  float* cm = reinterpret_cast<float*>(smem);  // [streams][GC]
  float* cl = cm + streams * GC;               // [streams][GC]
  float* ca = cl + streams * GC;               // [streams][GC][D]
  const int sid = warp * rpw + r;
  if (has_piece) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (piece == 0) {
        cm[sid * GC + g] = m[g];
        cl[sid * GC + g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) ca[(sid * GC + g) * D + piece * VN + e] = acc[g][e];
    }
  }
  __syncthreads();
  const Part P = part_view(scratch, B, hkv, n_split, G);
  const int64_t pbase = (((int64_t)b * hkv + h) * n_split + s_idx) * G + g0;
  for (int idx = tid; idx < gn * D; idx += NT) {
    const int g = idx / D, d = idx % D;
    float mx = NEG;
    for (int s = 0; s < streams; ++s) mx = fmaxf(mx, cm[s * GC + g]);
    float ls = 0.0f, as = 0.0f;
    for (int s = 0; s < streams; ++s) {
      const float w = fast_exp2(cm[s * GC + g] - mx);
      ls = fmaf(cl[s * GC + g], w, ls);
      as = fmaf(ca[(s * GC + g) * D + d], w, as);
    }
    if (d == 0) {
      P.m[pbase + g] = mx;
      P.l[pbase + g] = ls;
    }
    P.acc[(pbase + g) * D + d] = as;
  }
}

// One block per (query row, KV head, batch), a thread per d; the grid is
// fixed, and the splits it adds, ceil(length / split), come from the
// valid prefix.
template <typename T>
__global__ void __launch_bounds__(MAX_D)
fd_combine_kernel(const float* __restrict__ scratch, T* __restrict__ out, int B, int hkv,
                  int G, int D, int W, const int* __restrict__ length_dev, int length_host,
                  int split, int n_split) {
  __shared__ float sm[MAX_SPLITS], sl[MAX_SPLITS];
  const int n_used = (valid_length(length_dev, length_host, W) + split - 1) / split;
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const Part P = part_view(const_cast<float*>(scratch), B, hkv, n_split, G);
  const int64_t row0 = ((int64_t)b * hkv + h) * n_split * G + g;  // split 0 of (b, h, g)
  for (int s = d; s < n_used; s += blockDim.x) {
    sm[s] = P.m[row0 + (int64_t)s * G];
    sl[s] = P.l[row0 + (int64_t)s * G];
  }
  __syncthreads();
  if (d >= D) return;
  float mx = NEG;
  for (int s = 0; s < n_used; ++s) mx = fmaxf(mx, sm[s]);
  const float* pa = P.acc + row0 * D + d;
  float ls = 0.0f, as = 0.0f;
#pragma unroll 8
  for (int s = 0; s < n_used; ++s) {  // in split order
    const float w = fast_exp2(sm[s] - mx);
    ls = fmaf(sl[s], w, ls);
    as = fmaf(pa[(int64_t)s * G * D], w, as);
  }
  out[(((int64_t)b * hkv + h) * G + g) * D + d] = from_f<T>(as / fmaxf(ls, 1e-30f));
}

template <typename T, int GC, int P2C>
void launch_split(dim3 grid, size_t smem, cudaStream_t stream, const T* q, const T* k,
                  const T* v, float* part, int B, int hkv, int G, int D, int W,
                  const int* length_dev, int length, int split, int n_split, float scale2) {
  auto kern = fd_split_kernel<T, GC, P2C>;
  if (smem > 48 * 1024) {
    static size_t raised = 0;  // benign race: the attribute is idempotent
    if (smem > raised) {
      if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
          cudaSuccess)
        return;  // the launch below then fails and reports it
      raised = smem;
    }
  }
  kern<<<grid, NT, smem, stream>>>(q, k, v, part, B, hkv, G, D, W, length_dev, length, split,
                                   n_split, scale2);
}

template <typename T>
int launch(const void* qv, const void* kv, const void* vv, void* outv, void* partv, int B,
           int hkv, int G, int D, int W, const int* length_dev, int length, float scale,
           cudaStream_t stream) {
  const T* q = static_cast<const T*>(qv);
  const T* k = static_cast<const T*>(kv);
  const T* v = static_cast<const T*>(vv);
  float* part = static_cast<float*>(partv);
  const int split = split_len(W, D);
  const int n_split = (W + split - 1) / split;
  const int gc = G < GMAX ? G : GMAX;
  const int n_gc = (G + gc - 1) / gc;
  if (n_split > 65535 || B > 65535 || G > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int lpr = D / Vec<T>::N;
  const int p2 = pow2_at_least(lpr);
  const int rpw = 32 / p2;
  const size_t ring = (size_t)WARPS * NSTAGE * 2 * rpw * U * lpr * 16;
  const size_t comb = (size_t)WARPS * rpw * gc * (D + 2) * sizeof(float);
  const size_t smem = ring > comb ? ring : comb;
  const dim3 grid(hkv * n_gc, n_split, B);  // the heads of a split side by side
  const float scale2 = scale * LOG2E;
  // the common row widths (8 and 16 lanes: D = 64 and 128 in bf16, 32
  // and 64 in f32) with their butterfly unrolled, the others at run time
  switch (gc) {
#define FD_LAUNCH(N, P2C)                                                                       \
  launch_split<T, N, P2C>(grid, smem, stream, q, k, v, part, B, hkv, G, D, W, length_dev,    \
                          length, split, n_split, scale2)
#define FD_CASE(N)                                                  \
  case N:                                                           \
    if (p2 == 8) FD_LAUNCH(N, 8);                                   \
    else if (p2 == 16) FD_LAUNCH(N, 16);                            \
    else FD_LAUNCH(N, 0);                                           \
    break;
    FD_CASE(1) FD_CASE(2) FD_CASE(3) FD_CASE(4) FD_CASE(5) FD_CASE(6) FD_CASE(7) FD_CASE(8)
#undef FD_CASE
#undef FD_LAUNCH
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fd_combine_kernel<T><<<dim3(G, hkv, B), MAX_D, 0, stream>>>(
      part, static_cast<T*>(outv), B, hkv, G, D, W, length_dev, length, split, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Largest G * D and D the kernel takes (the wrapper checks before calling).
extern "C" int flash_decode_max_gd() { return MAX_GD; }
extern "C" int flash_decode_max_d() { return MAX_D; }

// Cache slots per split: a power of two in [64, min(512, 32768 / D)], the
// smallest that cuts W into at most 16 splits, or more where that would
// leave over 1024 splits.  Depends on W and D only.
extern "C" int flash_decode_split_len(int W, int D) { return split_len(W, D); }

// q [B, Hkv, G, D], k/v [B, W, Hkv, D], out [B, Hkv, G, D], contiguous and
// 16-byte aligned, all f32 (bf16 = 0) or all bf16 (bf16 = 1); ``part`` is
// f32 scratch of B * Hkv * ceil(W / split) * G * (D + 2) floats, split =
// flash_decode_split_len(W, D).  Attends over slots [0, length): with
// ``length_dev`` null, ``length`` (1 <= length <= W); else the int32 at
// ``length_dev`` on the device, clamped to [1, W], and ``length`` is
// ignored.  Launches both passes on ``stream`` and returns
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v, void* out,
                                void* part, const int* length_dev, int bf16, int B, int hkv,
                                int G, int D, int W, int length, float scale, void* stream) {
  const int vn = bf16 ? 8 : 4;
  if (B < 1 || hkv < 1 || G < 1 || D < vn || D % vn != 0 || D > MAX_D ||
      G * D > MAX_GD || (length_dev == nullptr && (length < 1 || length > W)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, out, part, B, hkv, G, D, W, length_dev, length,
                                 scale, s);
  return launch<float>(q, k, v, out, part, B, hkv, G, D, W, length_dev, length, scale, s);
}
