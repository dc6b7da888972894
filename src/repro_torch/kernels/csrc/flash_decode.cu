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
// The cache is in q's type, or int8 with one f32 scale per (batch, slot,
// KV head), as repro/models/blocks.py::_quantize_kv leaves it.  The
// reference dequantizes the whole int8 cache into q's type before its
// attention; here each lane dequantizes the values it reads, in the same
// arithmetic (bf16(float(x) * float(bf16(scale))) under bf16 q, float(x)
// * scale under f32 q), so the int8 route gives the same bits as this
// kernel on the dequantized cache, and reads a quarter (f32 q) or half
// (bf16 q) of that cache's bytes.
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
//     ring of NSTAGE stages in shared memory, filled with cp.async copies
//     of K and V as stored (16 bytes of bf16 or f32, 8 or 4 of int8); each
//     lane copies exactly the pieces it later reads, so a lane waits on
//     its own cp.async groups and the loop has no barrier;
//   * a lane owns a piece of a row: the values one 16-byte vector of q's
//     type holds (8 under bf16, 4 under f32), at the same d in q and in
//     the cache.  A group of P2 lanes takes a row (P2 = 8 and 16 fixed at
//     compile time, up to 32 at run time), so a warp takes 32 / P2 rows at
//     once; a row of more than 32 pieces (f32 at D = 256) gives each of
//     32 lanes NP = 2 pieces, ``piece`` and ``piece + 32``.  The lane keeps its pieces of the
//     G-chunk's q rows (up to 8 rows, times the scale and log2 e) in
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
constexpr int MAX_D = 256;
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

// x rounded to T and back: the value a tensor of T holds.
template <typename T> __device__ __forceinline__ float in_type(float x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) return __bfloat162float(__float2bfloat16(x));
  return x;
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

// One lane's piece of a cache row of Tc under q of Tq: the Vec<Tq>::N
// values at the d where the lane holds q, 16 bytes in q's type, 8 (bf16
// q) or 4 (f32 q) as int8.  ``s`` is the row's scale in q's type (int8
// only).  An int8 value times a bf16 scale has at most 7 + 8 significant
// bits, exact in f32, so under bf16 q the one rounding is the product's
// to bf16, as ``x.to(bfloat16) * scale.to(bfloat16)`` rounds it.
template <typename Tq, typename Tc> struct Piece {
  static constexpr int N = Vec<Tq>::N;
  static constexpr int BYTES = N * (int)sizeof(Tc);
  __device__ static void load(const unsigned char* p, float s, float* o) {
    if constexpr (std::is_same<Tc, Tq>::value) {
      Vec<Tq>::unpack(*reinterpret_cast<const uint4*>(p), o);
    } else {
      static_assert(std::is_same<Tc, int8_t>::value, "a cache in q's type or int8");
      uint32_t w[N / 4];
      if constexpr (N == 8) {
        const uint2 r = *reinterpret_cast<const uint2*>(p);
        w[0] = r.x;
        w[N / 4 - 1] = r.y;
      } else {
        w[0] = *reinterpret_cast<const uint32_t*>(p);
      }
#pragma unroll
      for (int e = 0; e < N; ++e) {  // byte e, sign-extended
        const int x = static_cast<int>(w[e >> 2] << (24 - 8 * (e & 3))) >> 24;
        o[e] = in_type<Tq>(__fmul_rn(__int2float_rn(x), s));
      }
    }
  }
};

template <int BYTES> __device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {  // .cg (L2 only) takes 16 bytes alone
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(BYTES)
                 : "memory");
  }
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

// q [B, Hkv, G, D] of Tq, k/v [B, W, Hkv, D] of Tc, contiguous; with an
// int8 cache, k_scale/v_scale [B, W, Hkv] f32.  GC is the most query rows
// a block holds (the chunk's own count, gn, may be smaller).  P2C > 0
// fixes the lanes a row takes at compile time (the shuffle butterfly
// unrolled); 0 takes it from D at run time.  NP is the pieces of a row a
// lane owns.
template <typename Tq, typename Tc, int GC, int P2C, int NP>
__global__ void __launch_bounds__(NT)
fd_split_kernel(const Tq* __restrict__ q, const Tc* __restrict__ k, const Tc* __restrict__ v,
                const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                float* __restrict__ scratch, int B, int hkv, int G, int D, int W,
                const int* __restrict__ length_dev, int length_host, int split, int n_split,
                float scale2) {
  extern __shared__ __align__(16) unsigned char smem[];
  using PC = Piece<Tq, Tc>;
  constexpr int VN = PC::N;
  constexpr int PB = PC::BYTES;
  constexpr bool QUANT = !std::is_same<Tc, Tq>::value;
  constexpr int NV = NP * VN;      // values of a row a lane owns
  const int length = valid_length(length_dev, length_host, W);
  const int s_idx = blockIdx.y;
  const int s0 = s_idx * split;
  if (s0 >= length) return;  // wholly past the prefix: the combine stops before it
  const int gc = min(G, GMAX);
  const int n_gc = (G + gc - 1) / gc;
  const int h = blockIdx.x / n_gc, g0 = (blockIdx.x % n_gc) * gc;
  const int b = blockIdx.z;
  const int gn = min(gc, G - g0);
  const int lpr = D / VN;          // pieces in a cache row
  const int p2 = P2C > 0 ? P2C : pow2_at_least(lpr);  // lanes a row takes
  const int rpw = 32 / p2;         // rows a warp takes at once
  const int R = rpw * U;           // rows a warp takes per step
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = lane / p2, piece = lane % p2;
  bool has_piece[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) has_piece[i] = piece + i * p2 < lpr;

  const int per_warp = split / WARPS;
  const int w0 = s0 + warp * per_warp;
  const int n_rows = max(0, min(w0 + per_warp, length) - w0);
  const int n_steps = (n_rows + R - 1) / R;

  const int64_t slot_stride = (int64_t)hkv * D;
  const int64_t base = ((int64_t)b * W * hkv + h) * D + piece * VN;  // slot 0 of (b, h), this piece
  const int stage_bytes = R * lpr * PB;  // one of K or V
  unsigned char* ring = smem + (size_t)warp * NSTAGE * 2 * stage_bytes;

  auto issue = [&](int step) {
    if (step < n_steps) {
      unsigned char* sk = ring + (step % NSTAGE) * 2 * stage_bytes;
      unsigned char* sv = sk + stage_bytes;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = u * rpw + r;
        const int row = step * R + j;
        if (row < n_rows) {
          const int64_t off = base + (int64_t)(w0 + row) * slot_stride;
#pragma unroll
          for (int i = 0; i < NP; ++i) {
            if (!has_piece[i]) continue;
            const int at = (j * lpr + piece + i * p2) * PB;
            cp_async<PB>(sk + at, k + off + i * p2 * VN);
            cp_async<PB>(sv + at, v + off + i * p2 * VN);
          }
        }
      }
    }
    cp_async_commit();  // every step commits a group, empty or not
  };

#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) issue(i);

  // this lane's pieces of the chunk's query rows
  float qf[GC][NV];
  const Tq* qb = q + (((int64_t)b * hkv + h) * G + g0) * D + piece * VN;
#pragma unroll
  for (int g = 0; g < GC; ++g) {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      float* o = qf[g] + i * VN;
      if (g < gn && has_piece[i]) {
        Vec<Tq>::unpack(*reinterpret_cast<const uint4*>(qb + (int64_t)g * D + i * p2 * VN), o);
#pragma unroll
        for (int e = 0; e < VN; ++e) o[e] *= scale2;
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) o[e] = 0.0f;
      }
    }
  }

  float m[GC], l[GC], acc[GC][NV];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = NEG;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < NV; ++e) acc[g][e] = 0.0f;
  }

  // one step: U rows per lane group; FULL when every row of it is valid
  auto run_step = [&](int step, auto full) {
    constexpr bool FULL = decltype(full)::value;
    // an int8 cache's row scales, in q's type; loaded before the wait
    float ks[U], vs[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ks[u] = vs[u] = 0.0f;
      if constexpr (QUANT) {
        const int row = step * R + u * rpw + r;
        if (FULL || row < n_rows) {
          const int64_t at = ((int64_t)b * W + w0 + row) * hkv + h;
          ks[u] = in_type<Tq>(__ldg(k_scale + at));
          vs[u] = in_type<Tq>(__ldg(v_scale + at));
        }
      }
    }
    cp_async_wait<NSTAGE - 2>();  // this lane's copies of ``step`` have landed
    const unsigned char* sk = ring + (step % NSTAGE) * 2 * stage_bytes;
    const unsigned char* sv = sk + stage_bytes;
    float sc[U][GC];  // logits (base 2), then softmax weights
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = u * rpw + r;
      valid[u] = FULL || step * R + j < n_rows;
      float kf[NV];
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        if (valid[u] && has_piece[i]) {
          PC::load(sk + (j * lpr + piece + i * p2) * PB, ks[u], kf + i * VN);
        } else {
#pragma unroll
          for (int e = 0; e < VN; ++e) kf[i * VN + e] = 0.0f;
        }
      }
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float part = 0.0f;
#pragma unroll
        for (int e = 0; e < NV; ++e) part = fmaf(qf[g][e], kf[e], part);
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
      for (int e = 0; e < NV; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sc[u][g] = valid[u] ? fast_exp2(sc[u][g] - mx) : 0.0f;
        l[g] += sc[u][g];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!valid[u]) continue;
      const int j = u * rpw + r;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        if (!has_piece[i]) continue;
        float vf[VN];
        PC::load(sv + (j * lpr + piece + i * p2) * PB, vs[u], vf);
#pragma unroll
        for (int g = 0; g < GC; ++g)
#pragma unroll
          for (int e = 0; e < VN; ++e)
            acc[g][i * VN + e] = fmaf(sc[u][g], vf[e], acc[g][i * VN + e]);
      }
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
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (piece == 0) {
      cm[sid * GC + g] = m[g];
      cl[sid * GC + g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (!has_piece[i]) continue;
#pragma unroll
      for (int e = 0; e < VN; ++e)
        ca[(sid * GC + g) * D + (piece + i * p2) * VN + e] = acc[g][i * VN + e];
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

// The arguments of one call, as the entry point takes them.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  void* out;
  float* part;
  int B, hkv, G, D, W;
  const int* length_dev;
  int length;
  int split, n_split;
  float scale2;
};

template <typename Tq, typename Tc, int GC, int P2C, int NP>
void launch_split(const Args& a, dim3 grid, size_t smem, cudaStream_t stream) {
  auto kern = fd_split_kernel<Tq, Tc, GC, P2C, NP>;
  if (smem > 48 * 1024) {
    static size_t raised = 0;  // benign race: the attribute is idempotent
    if (smem > raised) {
      if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
          cudaSuccess)
        return;  // the launch below then fails and reports it
      raised = smem;
    }
  }
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const Tq*>(a.q), static_cast<const Tc*>(a.k), static_cast<const Tc*>(a.v),
      a.k_scale, a.v_scale, a.part, a.B, a.hkv, a.G, a.D, a.W, a.length_dev, a.length, a.split,
      a.n_split, a.scale2);
}

// The row widths with their butterfly unrolled (8 and 16 lanes: D = 64
// and 128 in bf16, 32 and 64 in f32; 32 lanes with two pieces each: D =
// 256 in f32), the others (up to 32 lanes of one piece) at run time.
template <typename Tq, typename Tc, int GC>
void launch_rows(const Args& a, int p2, int lpr, dim3 grid, size_t smem, cudaStream_t stream) {
  if (p2 == 8) {
    launch_split<Tq, Tc, GC, 8, 1>(a, grid, smem, stream);
  } else if (p2 == 16) {
    launch_split<Tq, Tc, GC, 16, 1>(a, grid, smem, stream);
  } else if (lpr > 32) {
    if constexpr (Vec<Tq>::N == 4) launch_split<Tq, Tc, GC, 32, 2>(a, grid, smem, stream);
  } else {
    launch_split<Tq, Tc, GC, 0, 1>(a, grid, smem, stream);
  }
}

template <typename Tq, typename Tc>
int launch(Args a, cudaStream_t stream) {
  constexpr int PB = Piece<Tq, Tc>::BYTES;
  a.split = split_len(a.W, a.D);
  a.n_split = (a.W + a.split - 1) / a.split;
  const int gc = a.G < GMAX ? a.G : GMAX;
  const int n_gc = (a.G + gc - 1) / gc;
  if (a.n_split > 65535 || a.B > 65535 || a.G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int lpr = a.D / Vec<Tq>::N;
  const int p2 = lpr > 32 ? 32 : pow2_at_least(lpr);
  const int rpw = 32 / p2;
  // the rows of registers a block is compiled for: gc for a cache in
  // q's type, gc rounded up to 1, 2, 4 or 8 for an int8 cache (the
  // chunk's own rows are gc either way, so the grid and the bits do not
  // change)
  constexpr bool QUANT = !std::is_same<Tq, Tc>::value;
  const int gct = !QUANT || gc == 1 || gc == 2 ? gc : (gc <= 4 ? 4 : 8);
  const size_t ring = (size_t)WARPS * NSTAGE * 2 * rpw * U * lpr * PB;
  const size_t comb = (size_t)WARPS * rpw * gct * (a.D + 2) * sizeof(float);
  const size_t smem = ring > comb ? ring : comb;
  const dim3 grid(a.hkv * n_gc, a.n_split, a.B);  // the heads of a split side by side
  if constexpr (!QUANT) {
    switch (gc) {
#define FD_CASE(N) \
  case N:          \
    launch_rows<Tq, Tc, N>(a, p2, lpr, grid, smem, stream); \
    break;
      FD_CASE(1) FD_CASE(2) FD_CASE(3) FD_CASE(4) FD_CASE(5) FD_CASE(6) FD_CASE(7) FD_CASE(8)
#undef FD_CASE
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    if (gct == 1) launch_rows<Tq, Tc, 1>(a, p2, lpr, grid, smem, stream);
    else if (gct == 2) launch_rows<Tq, Tc, 2>(a, p2, lpr, grid, smem, stream);
    else if (gct == 4) launch_rows<Tq, Tc, 4>(a, p2, lpr, grid, smem, stream);
    else launch_rows<Tq, Tc, 8>(a, p2, lpr, grid, smem, stream);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fd_combine_kernel<Tq><<<dim3(a.G, a.hkv, a.B), MAX_D, 0, stream>>>(
      a.part, static_cast<Tq*>(a.out), a.B, a.hkv, a.G, a.D, a.W, a.length_dev, a.length,
      a.split, a.n_split);
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

// q [B, Hkv, G, D], out [B, Hkv, G, D], k/v [B, W, Hkv, D], contiguous;
// q and out f32 (bf16 = 0) or bf16 (bf16 = 1), 16-byte aligned.  With
// ``k_scale`` and ``v_scale`` null, k and v are of q's type and 16-byte
// aligned; else they are int8, aligned to D's pieces (8 bytes under bf16
// q, 4 under f32), and k_scale/v_scale [B, W, Hkv] f32 hold each row's
// scale.  ``part`` is f32 scratch of B * Hkv * ceil(W / split) * G * (D
// + 2) floats, split = flash_decode_split_len(W, D).  Attends over slots
// [0, length): with ``length_dev`` null, ``length`` (1 <= length <= W);
// else the int32 at ``length_dev`` on the device, clamped to [1, W], and
// ``length`` is ignored.  Launches both passes on ``stream`` and returns
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v, void* out,
                                void* part, const int* length_dev, const float* k_scale,
                                const float* v_scale, int bf16, int B, int hkv, int G, int D,
                                int W, int length, float scale, void* stream) {
  const int vn = bf16 ? 8 : 4;
  const bool quant = k_scale != nullptr;
  if (B < 1 || hkv < 1 || G < 1 || D < vn || D % vn != 0 || D > MAX_D ||
      G * D > MAX_GD || (v_scale != nullptr) != quant ||
      (length_dev == nullptr && (length < 1 || length > W)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, k_scale, v_scale, out, static_cast<float*>(part), B, hkv, G, D, W,
               length_dev, length, 0, 0, scale * LOG2E};
  if (bf16)
    return quant ? launch<__nv_bfloat16, int8_t>(a, s) : launch<__nv_bfloat16, __nv_bfloat16>(a, s);
  return quant ? launch<float, int8_t>(a, s) : launch<float, float>(a, s);
}
