// SSD chunked selective scan (Mamba-2 dual form), parallel over chunks.
//
// Replaces the Pallas kernel repro/kernels/ssd.py::_ssd_kernel (entry point
// ssd), whose grid is (head, chunk) with the chunk axis sequential and the
// [N, P] state carried in VMEM scratch; the reference vmaps it over the
// batch.  Per chunk of Q steps, with L = cumsum(log_a):
//
//   scores = causal(C B^T) * exp(min(L_t - L_s, 0))
//   y      = scores x + exp(L) * (C h)
//   h     <- exp(L_end) h + H_c,   H_c = sum_s exp(L_end - L_s) B_s x_s^T
//
// Only the state h passes from one chunk to the next, and all a chunk
// needs to pass it on is its own H_c and exp(L_end): one multiply-add per
// state element.  So every chunk is a block of its own, and the blocks of
// one sequence hand the state down an ordered chain:
//
//   1. stage the chunk's x, B, C and log_a in shared memory as f32; L by a
//      warp scan; H_c, which needs no state;
//   2. wait until the previous chunk of the same (batch, head) has
//      published the state this chunk starts from (h0 or 0 for the first);
//   3. publish exp(L_end) h + H_c for the next chunk (h_final for the
//      last), then compute the scores and y = exp(L) (C h) + scores x,
//      written once in x's type.
//
// Step 2 cannot deadlock: a block takes a ticket (an atomic counter) when
// it starts, tickets are dealt chunk-major (every (batch, head) of chunk 0,
// then of chunk 1, ...), and a block waits only on the block whose ticket
// is H * B smaller, which started before it and waits on nothing later
// than itself.  The producer writes the state, fences and then sets its
// flag; the consumer polls the flag, fences and reads the state from L2.
// A block that has polled for about a second gives up and writes NaN into
// y, so a fault shows as a failed check and not as a hung card.  The
// counter and the flags are set to 0 by one memset before each launch.
//
// Inputs are read as f32 (bf16 or f32 in memory), everything is computed
// in f32 on the CUDA cores, y is written in x's type and h_final in f32.
// (This is the first form; the wide form, for a large state and the
// normalizer channel, is further down with its own note.)
// B and C are read through strides, so a head stride of 0 (Hymba
// broadcasts one B and one C to every head) reads them once instead of
// materialising a copy per head.
//
// What bounds it on an H100: operations.  A chunk does about 0.6 MFLOP of
// f32 multiply-adds (the causal half of the Q x Q scores and of their
// product with x, plus the two N x P terms) on 2 Q (P + N) + Q values it
// reads and Q P it writes; the tensor cores would need TF32 or bf16,
// which belong to a labelled route with its own bar, so the bound is the
// CUDA cores' 67 TFLOP/s.  The first version ran one block per (batch,
// head) with the chunks a loop inside it: 200 blocks at Hymba's prefill,
// each waiting on its own loads and on one thread's cumulative sum.  A
// three-pass form (chunk summaries, a state pass, outputs) staged every
// chunk twice and moved the summaries through device memory three times,
// and ran slower than this form on an H100.
//
// Design.  2800 blocks at Hymba's prefill (batch 4, 14 chunks of 64, 50
// heads) of 256 threads, capped at 64 registers so four share an SM.  A
// chunk is staged by 16-byte loads where the operands' strides allow (8
// bf16 or 4 f32 a load), every load of a thread issued before any store,
// so a chunk waits about one memory latency for its operands; the
// co-resident blocks hide it.  The cumulative sum is a warp scan
// (Kogge-Stone by shuffles over 32 steps, the segment totals added in
// order).  The products are register-tiled 4 x 4 (two float4 reads of
// shared memory feed 16 FMAs): H_c as 4 n x 4 p tiles with the weights
// exp(L_end - L_s) applied as each step of B is read, each tile summed by
// up to four groups of threads over runs of the steps and the partials
// added in order; the scores as 4 t x 4 s tiles of the lower triangle only
// (one expf a score, s <= t); y as 4 t x 4 p tiles, exp(L_t) (C_t . h)
// first and then the causal product over s <= t.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;         // threads a block
constexpr int MINB = 4;         // blocks an SM the registers must allow (64 registers a thread)
constexpr int POLLS = 1 << 24;  // polls of a flag (64 ns apart at least) before a block gives up
// Phase clocks: a build with CLOCK_TICKETS > 0 (benchmarks/
// port_kernel_variants.py makes one) has thread 0 of each of the first
// CLOCK_TICKETS chunks record clock64() at the end of each phase:
// started, staged, scanned, weights, H_c and waited, state loaded,
// published, scores, y.
constexpr int CLOCK_TICKETS = 0;
constexpr int CLOCK_MARKS = 9;
__device__ long long phase_clock[CLOCK_TICKETS > 0 ? CLOCK_TICKETS * CLOCK_MARKS : 1];

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  // round to nearest even, as torch's .to(bfloat16)
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 v;
  v.x = *reinterpret_cast<unsigned*>(&lo);
  v.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}

// 16 bytes of T as f32: 4 floats or 8 bf16
__device__ __forceinline__ void unpack(const uint4& u, float* f, const float*) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f, const __nv_bfloat16*) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

struct Strides {  // element strides of a [B, S, H, *] operand (last dim contiguous)
  int64_t b, s, h;
};

// Stage rows t < Q of a [B, S, H, width] operand at (b, s0 + t, h) into
// shared memory as f32: dst[t * pitch + j] (TRANS false) or dst[j * pitch
// + t] (TRANS true).  vec: the rows start on 16-byte boundaries and width
// is a whole number of 16-byte pieces, so each thread loads 16 bytes at a
// time (8 bf16 or 4 f32); else one element at a time.
template <bool TRANS, typename T>
__device__ __forceinline__ void stage(float* dst, int pitch, const T* __restrict__ src,
                                      const Strides& st, int b, int s0, int h, int Q, int width,
                                      bool vec, int tid) {
  const T* base = src + b * st.b + (int64_t)s0 * st.s + h * st.h;
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int pr = width / E;
    for (int i = tid; i < Q * pr; i += NT) {
      const int t = i / pr, j = (i - t * pr) * E;
      float f[E];
      unpack(__ldg(reinterpret_cast<const uint4*>(base + t * st.s + j)), f, base);
      if constexpr (TRANS) {
#pragma unroll
        for (int e = 0; e < E; ++e) dst[(j + e) * pitch + t] = f[e];
      } else {
#pragma unroll
        for (int e = 0; e < E; e += 4) store4(dst + t * pitch + j + e, f[e], f[e + 1], f[e + 2], f[e + 3]);
      }
    }
  } else {
    for (int i = tid; i < Q * width; i += NT) {
      const int t = i / width, j = i - t * width;
      const float v = to_f(base[t * st.s + j]);
      if constexpr (TRANS) dst[j * pitch + t] = v;
      else dst[t * pitch + j] = v;
    }
  }
}

// The cumulative sum of a chunk's log_a, in two steps.  Here, a warp whose
// lanes hold the values at t = 32 seg + lane (0 past Q) scans them
// Kogge-Stone (step o adds the value o lanes down) into seg_sum[t], and
// lane 31 leaves the segment's total in tot[seg]; after a barrier,
// L[t] = seg_sum[t] + (tot[0] + ... + tot[seg - 1]), added in order
// (cumsum_finish).
__device__ __forceinline__ void segment_scan(float v, int t, float* seg_sum, float* tot, int Q) {
  const int lane = t & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (t < Q) seg_sum[t] = v;
  if (lane == 31) tot[t >> 5] = v;
}

__device__ __forceinline__ float cumsum_finish(const float* seg_sum, const float* tot, int t) {
  float off = 0.0f;
  for (int j = 0; j < (t >> 5); ++j) off += tot[j];
  return seg_sum[t] + off;
}

// Stage a chunk whose x, B and C rows are all whole 16-byte pieces: each
// thread issues its loads of a round (two pieces of x, one of B, one of
// C, one log_a) before it stores any of them, so the chunk waits about
// one memory latency a round instead of one for each load.  B goes to
// both wb (row-major) and bt (transposed), C to ct (transposed); log_a is
// scanned in its segments from the registers (segment_scan, into las and
// tot; Q <= NT).
template <typename T, typename TL>
__device__ __forceinline__ void stage_wide(float* xs, float* wb, float* bt, float* ct, float* las,
                                           float* tot,
                                           const T* __restrict__ x, const TL* __restrict__ la,
                                           const T* __restrict__ Bm, const T* __restrict__ Cm,
                                           const Strides& xs_, const Strides& las_,
                                           const Strides& bs_, const Strides& cs_, int b, int s0,
                                           int h, int Q, int P, int N, int N4, int QP, int tid) {
  constexpr int E = 16 / sizeof(T);
  const int px = P / E, pn = N / E, nx = Q * px, nb = Q * pn;
  const T* xb = x + b * xs_.b + (int64_t)s0 * xs_.s + h * xs_.h;
  const T* bb = Bm + b * bs_.b + (int64_t)s0 * bs_.s + h * bs_.h;
  const T* cb = Cm + b * cs_.b + (int64_t)s0 * cs_.s + h * cs_.h;
  const TL* lb = la + b * las_.b + (int64_t)s0 * las_.s + h * las_.h;
  for (int r = 0; r < nx || r < 2 * nb || r < 2 * Q; r += 2 * NT) {
    uint4 vx[2], vb, vc;
    float vl = 0.0f;
    const int ix0 = r + tid, ix1 = r + NT + tid, ib = r / 2 + tid, il = r / 2 + tid;
    if (ix0 < nx) vx[0] = __ldg(reinterpret_cast<const uint4*>(xb + (ix0 / px) * xs_.s + (ix0 % px) * E));
    if (ix1 < nx) vx[1] = __ldg(reinterpret_cast<const uint4*>(xb + (ix1 / px) * xs_.s + (ix1 % px) * E));
    if (ib < nb) {
      vb = __ldg(reinterpret_cast<const uint4*>(bb + (ib / pn) * bs_.s + (ib % pn) * E));
      vc = __ldg(reinterpret_cast<const uint4*>(cb + (ib / pn) * cs_.s + (ib % pn) * E));
    }
    if (il < Q) vl = to_f(lb[il * las_.s]);
    if (r == 0 && tid < ((Q + 31) & ~31)) segment_scan(vl, tid, las, tot, Q);  // whole warps
    float f[E];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int ix = u ? ix1 : ix0;
      if (ix >= nx) continue;
      unpack(vx[u], f, xb);
      float* row = xs + (ix / px) * P + (ix % px) * E;
#pragma unroll
      for (int e = 0; e < E; e += 4) store4(row + e, f[e], f[e + 1], f[e + 2], f[e + 3]);
    }
    if (ib < nb) {
      const int t = ib / pn, j = (ib % pn) * E;
      unpack(vb, f, bb);
#pragma unroll
      for (int e = 0; e < E; e += 4) store4(wb + t * N4 + j + e, f[e], f[e + 1], f[e + 2], f[e + 3]);
#pragma unroll
      for (int e = 0; e < E; ++e) bt[(j + e) * QP + t] = f[e];
      unpack(vc, f, cb);
#pragma unroll
      for (int e = 0; e < E; ++e) ct[(j + e) * QP + t] = f[e];
    }
  }
}

// acc[i][j] += A[k][i0 + i] * Bm[k][j0 + j] over k in [k_begin, k_end),
// one float4 of each a step
__device__ __forceinline__ void outer_sum(float (&acc)[4][4], const float* A, int apitch, int i0,
                                          const float* Bm, int bpitch, int j0, int k_begin, int k_end) {
  for (int k = k_begin; k < k_end; ++k) {
    const float4 u = *reinterpret_cast<const float4*>(A + k * apitch + i0);
    const float4 v = *reinterpret_cast<const float4*>(Bm + k * bpitch + j0);
    const float a4[4] = {u.x, u.y, u.z, u.w}, b4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a4[i], b4[j], acc[i][j]);
  }
}

__host__ __device__ inline int up4(int v) { return (v + 3) & ~3; }
__host__ __device__ inline int up8(int v) { return (v + 7) & ~7; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// H_c's groups of steps: where H_c has fewer 4 x 4 tiles than the block has
// threads, up to 4 groups each sum a run of s, added in order after.  The
// kernel takes at most NT tiles (N rounded up to 4 times P at most 4 NT).
__host__ __device__ inline int state_groups(int P, int N) {
  const int g = NT / ((up4(N) / 4) * (P / 4));
  return g < 4 ? g : 4;
}

// The shared-memory layout, in floats; t is padded to QP = Q rounded up
// to 8 (columns of B^T, C^T and the scores past Q hold 0).  One region
// serves twice: H_c's partial sums and B times H_c's weights, then the
// scores.
struct Layout {
  int xs, hs, bt, ct, part, wb, sc, las, Ls, eL, wts, tot, total;
  __host__ __device__ Layout(int Q, int P, int N) {
    const int QP = up8(Q), N4 = up4(N), parts = (state_groups(P, N) - 1) * N4 * P;
    int o = 0;
    xs = o; o += Q * P;                                  // [Q][P]   x
    hs = o; o += N * P;                                  // [N][P]   the state before the chunk
    bt = o; o += N * QP;                                 // [N][QP]  B^T
    ct = o; o += N * QP;                                 // [N][QP]  C^T, then (exp(L) C)^T
    part = sc = o; wb = o + parts;                       // [G-1][N4][P] and [Q][N4], then
    o += imax(QP * QP, parts + Q * N4);                  // [QP][QP] scores^T
    las = o; o += QP;                                    // log_a, then its segment sums
    Ls = o; o += QP;                                     // L
    eL = o; o += QP;                                     // exp(L)
    wts = o; o += QP;                                    // exp(L_end - L), H_c's weights
    tot = o; o += up4((Q + 31) / 32);
    total = o;
  }
};

template <typename T, typename TL>
__global__ void __launch_bounds__(NT, MINB)
ssd_chunk_kernel(const T* __restrict__ x, const TL* __restrict__ la, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, const float* __restrict__ h0, T* __restrict__ y,
                 float* __restrict__ h_out, float* states, int* sync, int Bn, int S, int H, int P,
                 int N, int Q, Strides xs_, Strides las_, Strides bs_, Strides cs_, int vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout lay(Q, P, N);
  const int QP = up8(Q), N4 = up4(N), P4 = P / 4, QT = QP / 4;
  float *xs = smem + lay.xs, *hs = smem + lay.hs, *bt = smem + lay.bt, *ct = smem + lay.ct,
        *part = smem + lay.part, *wb = smem + lay.wb, *sc = smem + lay.sc, *las = smem + lay.las,
        *Ls = smem + lay.Ls, *eL = smem + lay.eL, *wts = smem + lay.wts, *tot = smem + lay.tot;
  __shared__ int ticket_s;
  const int tid = threadIdx.x;
  const int NC = S / Q, HB = H * Bn;
  int* flags = sync + 1;  // [NC][B][H]; sync[0] is the ticket counter

  // ------------------------------------------- 1. this block's chunk
  if (tid == 0) ticket_s = atomicAdd(sync, 1);
  if (QP != Q)  // B^T and C^T: t >= Q reads as 0
    for (int i = tid; i < 2 * N * QP; i += NT) bt[i] = 0.0f;  // ct follows bt
  if (N4 != N)  // B for H_c: n >= N reads as 0
    for (int i = tid; i < Q * N4; i += NT) wb[i] = 0.0f;
  __syncthreads();
  const int ticket = ticket_s;
  const int c = ticket / HB, b = (ticket - c * HB) / H, h = ticket - c * HB - b * H;
  const int s0 = c * Q;
  auto clock_mark = [&](int k) {
    if (CLOCK_TICKETS > 0 && tid == 0 && ticket < CLOCK_TICKETS)
      phase_clock[ticket * CLOCK_MARKS + k] = clock64();
  };
  clock_mark(0);
  if (vec == 7 && Q <= NT) {  // log_a is scanned in its segments on the way
    stage_wide(xs, wb, bt, ct, las, tot, x, la, Bm, Cm, xs_, las_, bs_, cs_, b, s0, h, Q, P, N, N4,
               QP, tid);
    __syncthreads();
    clock_mark(1);
  } else {
    stage<false>(xs, P, x, xs_, b, s0, h, Q, P, vec & 1, tid);
    stage<false>(wb, N4, Bm, bs_, b, s0, h, Q, N, vec & 2, tid);
    stage<true>(bt, QP, Bm, bs_, b, s0, h, Q, N, vec & 2, tid);
    stage<true>(ct, QP, Cm, cs_, b, s0, h, Q, N, vec & 4, tid);
    for (int t = tid; t < Q; t += NT)
      las[t] = to_f(la[b * las_.b + (int64_t)(s0 + t) * las_.s + h * las_.h]);
    __syncthreads();
    clock_mark(1);
    for (int t = tid; t < ((Q + 31) & ~31); t += NT) segment_scan(t < Q ? las[t] : 0.0f, t, las, tot, Q);
    __syncthreads();
  }
  clock_mark(2);
  const float l_end = cumsum_finish(las, tot, Q - 1);
  for (int t = tid; t < Q; t += NT) {
    const float L = cumsum_finish(las, tot, t);
    Ls[t] = L;
    eL[t] = expf(L);
    wts[t] = expf(l_end - L);
  }
  __syncthreads();
  clock_mark(3);

  // H_c = sum_s (B_s exp(L_end - L_s)) x_s^T as 4 n x 4 p tiles, one a
  // thread of group 0: group g sums s in [g * run, (g + 1) * run), and
  // group 0 adds the others' sums in order when it passes the state on
  const int tiles = (N4 / 4) * P4, G = state_groups(P, N), run = (Q + G - 1) / G;
  const int g = tid / tiles, tile = tid - g * tiles;
  const int n0 = (tile / P4) * 4, p0 = (tile % P4) * 4;
  float hc[4][4] = {};
  if (g < G)
    for (int k = min(Q, g * run); k < min(Q, (g + 1) * run); ++k) {
      const float w = wts[k];
      const float4 u = *reinterpret_cast<const float4*>(wb + k * N4 + n0);
      const float4 v = *reinterpret_cast<const float4*>(xs + k * P + p0);
      const float a4[4] = {u.x * w, u.y * w, u.z * w, u.w * w}, b4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) hc[i][j] = fmaf(a4[i], b4[j], hc[i][j]);
    }
  if (g > 0 && g < G)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      store4(part + ((g - 1) * N4 + n0 + i) * P + p0, hc[i][0], hc[i][1], hc[i][2], hc[i][3]);

  // ------------------------------------------- 2. the state before this chunk
  const int64_t slot = ((int64_t)c * Bn + b) * H + h;  // this chunk's flag
  const int64_t np = (int64_t)N * P;
  bool fault = false;
  if (c > 0 && tid == 0) {
    const volatile int* flag = flags + slot - HB;
    int polls = 0;
    while (*flag == 0 && ++polls < POLLS) __nanosleep(64);
    fault = polls >= POLLS;
    __threadfence();
  }
  fault = __syncthreads_or(fault);  // also: every group's sum is in part
  clock_mark(4);
  if (c == 0) {
    for (int i = tid; i < N * P; i += NT) hs[i] = h0 ? h0[((int64_t)b * H + h) * np + i] : 0.0f;
  } else {  // states[c - 1] holds the state chunk c starts from
    const float4* src = reinterpret_cast<const float4*>(states + (slot - HB) * np);
    for (int i = tid; i < N * P4; i += NT) reinterpret_cast<float4*>(hs)[i] = __ldcg(src + i);
  }
  __syncthreads();
  clock_mark(5);

  // ------------------------------------------- 3. pass the state on
  if (g == 0) {  // H_c, then exp(L_end) h + H_c, each step rounded
    for (int q = 0; q < G - 1; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(part + (q * N4 + n0 + i) * P + p0);
        hc[i][0] += v.x; hc[i][1] += v.y; hc[i][2] += v.z; hc[i][3] += v.w;
      }
    const float a_end = expf(l_end);
    float* dst = c + 1 < NC ? states + slot * np : h_out + ((int64_t)b * H + h) * np;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (n0 + i >= N) break;
      const float4 hv = *reinterpret_cast<const float4*>(hs + (n0 + i) * P + p0);
      store4(dst + (n0 + i) * P + p0, __fadd_rn(__fmul_rn(a_end, hv.x), hc[i][0]),
             __fadd_rn(__fmul_rn(a_end, hv.y), hc[i][1]), __fadd_rn(__fmul_rn(a_end, hv.z), hc[i][2]),
             __fadd_rn(__fmul_rn(a_end, hv.w), hc[i][3]));
    }
  }
  __syncthreads();  // the state is written; part and wb are read
  clock_mark(6);
  if (c + 1 < NC && tid == 0) {
    __threadfence();  // cumulative: orders the block's writes above before the flag
    atomicExch(flags + slot, 1);
  }

  // ------------------------------------------- 4. y
  // scores, 4 t x 4 s tiles of the lower triangle (ti >= si)
  for (int k = tid; k < QT * (QT + 1) / 2; k += NT) {
    int ti = (int)((sqrtf(8.0f * k + 1.0f) - 1.0f) * 0.5f);
    while (ti * (ti + 1) / 2 > k) --ti;
    while ((ti + 1) * (ti + 2) / 2 <= k) ++ti;
    const int t0 = ti * 4, si0 = (k - ti * (ti + 1) / 2) * 4;
    float acc[4][4] = {};
    outer_sum(acc, ct, QP, t0, bt, QP, si0, 0, N);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = si0 + j;
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + i;
        v[i] = (s <= t && t < Q) ? acc[i][j] * expf(fminf(Ls[t] - Ls[s], 0.0f)) : 0.0f;
      }
      store4(sc + s * QP + t0, v[0], v[1], v[2], v[3]);
    }
  }
  __syncthreads();
  clock_mark(7);
  // 4 t x 4 p tiles: exp(L_t) (C_t . h), then the causal product over s <= t
  const float nan = __int_as_float(0x7fc00000);
  for (int yt = tid; yt < QT * P4; yt += NT) {
    const int t0 = (yt / P4) * 4, q0 = (yt % P4) * 4;
    float acc[4][4] = {};
    outer_sum(acc, ct, QP, t0, hs, P, q0, 0, N);
    const float4 e = *reinterpret_cast<const float4*>(eL + t0);
    const float e4[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= e4[i];
    outer_sum(acc, sc, QP, t0, xs, P, q0, 0, min(t0 + 4, Q));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + i;
      if (t >= Q) break;
      store4(y + (((int64_t)b * S + s0 + t) * H + h) * P + q0, fault ? nan : acc[i][0],
             fault ? nan : acc[i][1], fault ? nan : acc[i][2], fault ? nan : acc[i][3]);
    }
  }
  if (CLOCK_TICKETS > 0) {
    __syncthreads();
    clock_mark(8);
  }
}

template <typename T, typename TL>
int launch(const void* x, const void* la, const void* Bm, const void* Cm, const void* h0,
           void* y, void* h_out, void* states, void* sync, int vec, int Bn, int S, int H, int P,
           int N, int Q, Strides xs, Strides las, Strides bs, Strides cs, cudaStream_t stream) {
  const int64_t blocks = (int64_t)(S / Q) * Bn * H;
  const size_t bytes = (size_t)Layout(Q, P, N).total * sizeof(float);
  auto kern = ssd_chunk_kernel<T, TL>;
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const cudaError_t e = cudaMemsetAsync(sync, 0, (size_t)(1 + blocks) * sizeof(int), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<(unsigned)blocks, NT, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const TL*>(la), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(h_out), static_cast<float*>(states), static_cast<int*>(sync), Bn, S, H,
      P, N, Q, xs, las, bs, cs, vec);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The wide form: B6 with a large state and the normalizer channel, the
// counterpart of repro/models/ssm.py::ssd_scan(normalizer=True) as
// xLSTM's mLSTM calls it (N = P = dh = 512, Q = 128: a 1 MB f32 state a
// (batch, head) and [Q, N] operands of 128 KB in bf16).
//
// Grid.  A column of P is a sequence of its own (h[:, p] needs x[:, p]
// and nothing else of x), so a block takes one P-tile of 64 columns, and
// the P/64 P-tiles of a (chunk, batch, head) run as one thread block
// cluster (cudaLaunchKernelEx, cudaLaunchAttributeClusterDimension): 8
// blocks at P = 512, 2 at 128, 1 at 64.  Where P/64 exceeds 8 the cluster
// is its largest divisor up to 8, and each of the P/64/cluster clusters
// of a chunk computes the scores (no served model has P > 512).
//
// The scores once per (chunk, batch, head).  C B^T is the same for every
// P-tile, so each block of a cluster computes a share of its 16 x 16
// lower-triangle tiles (tile k on block k mod cluster) in its pass over
// N, decays and masks them, and after a cluster barrier writes them into
// every block's shared memory (distributed shared memory,
// cluster.map_shared_rank); a second barrier, and each block has them all.
//
// The products on the bf16 tensor cores (mma.sync m16n8k16, f32 sums),
// without loss.  x, B and C are bf16 in memory and are staged as they
// are; a product of two bf16 values is exact in f32, so the scores C B^T
// lose nothing.  The other three products each have an f32 operand --
// w x (w = exp(L_end - L_s), for H_c = B^T (w x)), the carried state h
// (for C h) and the decayed scores (for scores x) -- and an f32 value v
// splits exactly into three bf16 terms, hi = bf16(v), mid = bf16(v - hi),
// lo = bf16(v - hi - mid) (8 significant bits each; only a term below
// bf16's normal range, where |v| < 2^-110, loses bits).  With the f32
// operand split so, each product is exact again, at three tensor-core
// products for one.  What stays in f32 on the CUDA cores is what the
// first form does there: the cumulative sum, the exps, the decay of the
// scores, the normalizer's sums and the state's hand down exp(L_end) h +
// H_c, each step rounded (__fmul_rn, __fadd_rn).  f32 inputs (the f32
// bars, 6i's f32 gate) take the same structure with the four products on
// the CUDA cores instead (warp_fma: chains of fmaf in k order, in the
// fragments' layout, nothing split): the tensor cores' f32 sums, six
// term products a step, left about 1e-3 on outputs that cancel from
// terms of size 20, which an elementwise 2e-4 bar refuses.
//
// Per block, after its chunk's x and log_a are staged and L, exp(L) and
// the weights w are known (and w x split into its three terms):
//   1. wait until the previous chunk's block of the same P-tile has
//      published the state this chunk starts from: the ordered chain of
//      the first form, one ticket a cluster, dealt chunk-major, so a
//      cluster waits only on the cluster H B P/64/cluster tickets before
//      it, which started earlier with all its blocks since a cluster is
//      scheduled whole; NaN in y after about a second of polling;
//   2. one pass over N in slices of NS rows (64 for bf16, 32 for f32):
//      the slice's [Q, NS] of B and of C and its [NS, 64] of h come in by
//      the tensor memory accelerator (TMA: one tensor-map box each, one
//      slice ahead, on an mbarrier, 128-byte swizzled so that ldmatrix
//      reads them without bank conflicts), off the load/store pipe that
//      the products' shared-memory reads use; per slice the share of the
//      scores, the slice's rows of H_c over the whole chunk, exp(L_end) h
//      + H_c written over h in shared memory and stored by the
//      accelerator for the next chunk, and y's C h summed;
//   3. publish the state; share the decayed scores; y = exp(L) (C h) +
//      scores x, written in x's type.
// Operands whose rows a tensor map cannot describe (a stride of 0 or not
// a multiple of 16 bytes) come in by the threads (cp.async, or one
// element at a time) into the same swizzled layout.
//
// The normalizer is the state of a virtual column of ones in x, carried
// on the CUDA cores by the first cluster of each (chunk, batch, head):
// slice i's rows of n on block i mod cluster, which computes N_c =
// sum_s w_s B_s and hands down exp(L_end) n + N_c for them, and its part
// of C_t . n; the first block adds the parts in rank order for den_t =
// exp(L_t) (C_t . n) + sum_{s <= t} scores[t, s], written in f32.  Every
// sum runs in a fixed order without atomics, so a call gives the same
// bits every time.
//
// What bounds it on an H100.  At xLSTM-1.3B's served prefill (B 4, S 768,
// H 4, N = P = 512, Q 128) repro_torch.roofline.analysis.ssd_cost counts
// 14.5 GFLOP, 0.2165 ms at the f32 CUDA-core rate of 67 TFLOP/s (the
// bound of the kernel this one replaced, which B6's xLSTM row prints as
// f32_cuda_core_bound_ms).  The row's bound is this route's own: the
// multiply-adds this kernel issues to the tensor cores, which are
// ssd_cost's four terms a chunk with the split factors:
// the scores x 1 (in whole 16 x 16 tiles: 36 x 256 against Q (Q + 1) / 2,
// over N), scores x x 3 (in 32-row strips: 20 x 32 x 32 against Q (Q +
// 1) / 2, over P), H_c x 3 (Q N P) and C h x 3 (Q N P, none in a chunk
// that starts from a zero state): 39.4 GFLOP a call, 0.040 ms at 989
// TFLOP/s, above its bytes' 0.020 ms (kernels/ssd.py::
// wide_tensor_core_macs counts them).  204 KB of shared memory keep one
// block on an SM, so 15 clusters of 8 fit at once and the 96 clusters of
// that shape run in about six waves of one chunk each; the chain costs
// no wave.
constexpr int WPT = 64;     // columns of P a block (its P-tile)
constexpr int WNS = 32;     // N must be a multiple of this
constexpr int WQ = 128;     // the longest chunk the wide form takes
constexpr int WCS = 8;      // blocks a cluster at most (the portable size)
constexpr int WTRI = 5;     // score tiles a warp holds: 36 16 x 16 tiles over 8 warps
constexpr int XB = 72;      // pitch (bf16) of a bf16 [*][64] array: 144-byte rows, ldmatrix free of bank conflicts
constexpr int XF = 68;      // pitch (f32) of an f32 [*][64] array

// the tile constants by input type: rows of N a slice (a slice of B or C
// is [Q][NS], 128 bytes a row), the pitch of the staged x ([Q][64])
template <typename T> struct WideTile;
template <> struct WideTile<__nv_bfloat16> { static constexpr int NS = 64, XP = XB; };
template <> struct WideTile<float> { static constexpr int NS = 32, XP = XF; };

__host__ __device__ inline int up32(int v) { return (v + 31) & ~31; }
__host__ __device__ inline int a16(int v) { return (v + 15) & ~15; }

// Shared memory of the wide form, in bytes from a 1024-byte boundary; t
// padded to QP = Q rounded up to 32 (rows past Q hold 0).  The ring holds
// two slices: B's and C's [QP][NS] as in memory, 128-byte rows whose
// 16-byte pieces are swizzled (piece c of row r at c ^ (r % 8), as the
// tensor memory accelerator's 128-byte swizzle writes them), h's [NS][64]
// f32 as two such arrays of 32 columns, and the normalizer state's rows; after the pass over N the scores^T
// [QP][QP + 4] f32 take its place.
__host__ __device__ inline int a1024(int v) { return (v + 1023) & ~1023; }
struct WideLayout {
  int xs, wx, ht, ring, stage, braw, craw, hraw, nps, sc, las, Ls, eL, wts, dparts, tot, total;
  __host__ __device__ WideLayout(int Q, int tsize) {
    const int QP = up32(Q), f32 = tsize == 4;
    const int NS = f32 ? 32 : 64, XP = f32 ? XF : XB;
    int o = 0;
    braw = 0;                                    // a stage of the ring, from its start
    craw = QP * 128;
    hraw = craw + QP * 128;
    nps = hraw + 2 * NS * 128;
    stage = a1024(nps + NS * 4);
    ring = o; o += 2 * stage;
    sc = ring;                                   // [QP][QP + 4] the scores (f32), after the pass
    if (ring + QP * (QP + 4) * 4 > o) o = ring + QP * (QP + 4) * 4;
    xs = o; o += a16(QP * XP * tsize);           // [QP][XP]   x, this block's columns, as in memory
    wx = o; o += 3 * QP * XB * 2;                // 3 x [QP][XB] w x, split (bf16)
    ht = o; o += 3 * NS * XB * 2;                // 3 x [NS][XB] the slice of h, split (bf16)
    las = o; o += QP * 4;                        // log_a, then its segment sums
    Ls = o; o += QP * 4;                         // L
    eL = o; o += QP * 4;                         // exp(L)
    wts = o; o += QP * 4;                        // exp(L_end - L)
    dparts = o; o += WCS * QP * 4;               // each block's part of C_t . n (the first block's)
    tot = o; o += 16;
    total = o + 1024;                            // and the way to a 1024-byte boundary
  }
};

// element (r, c) of a swizzled array of 128-byte rows
template <typename T>
__device__ __forceinline__ const T* swz(const T* p, int r, int c) {
  const int byte = c * (int)sizeof(T);
  return reinterpret_cast<const T*>(reinterpret_cast<const char*>(p) + r * 128 + ((((byte >> 4) ^ (r & 7)) << 4) | (byte & 15)));
}

// blocks a cluster for P: the largest divisor of P / 64 up to 8
__host__ __device__ inline int wide_cluster(int P) {
  const int npt = P / WPT;
  int cs = npt < WCS ? npt : WCS;
  while (npt % cs) --cs;
  return cs;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, bypassing L1 (the state comes from other SMs)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
__device__ __forceinline__ void zero16(void* p) { *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u); }
// mbarriers and the bulk copy global -> shared (sm_90)
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar), "r"(parity) : "memory");
}
// a box of a 3-d tensor map global -> shared, completing on an mbarrier
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
      "[%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}
// a box shared -> global (rows past the tensor's edge are not written), in
// the issuing thread's bulk group
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0, int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];\n" ::"l"(
                   reinterpret_cast<unsigned long long>(map)),
               "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(src))
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }
// order this thread's shared (global) accesses with the accelerator's
__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
__device__ __forceinline__ void fence_async_global() { asm volatile("fence.proxy.async.global;\n" ::: "memory"); }
// a box of a 4-d tensor map global -> shared, completing on an mbarrier
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                            unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)) : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)) : "memory");
}
// d += a (16 x 16, row) b (16 x 8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned bf2_bits(__nv_bfloat162 v) { return *reinterpret_cast<unsigned*>(&v); }
// v0 and v1 each as hi + mid + lo, three bf16 terms, packed in pairs (v0
// in the low half): hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi -
// mid), each difference exact in f32
__device__ __forceinline__ void split3(float v0, float v1, unsigned& hi, unsigned& mid, unsigned& lo) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v0, v1);
  const float2 fa = __bfloat1622float2(a);
  const float r0 = __fsub_rn(v0, fa.x), r1 = __fsub_rn(v1, fa.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 fm = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(__fsub_rn(r0, fm.x), __fsub_rn(r1, fm.y));
  hi = bf2_bits(a);
  mid = bf2_bits(m);
  lo = bf2_bits(l);
}

// Fragments of mma.m16n8k16 from shared memory, g = lane / 4, q = 2 (lane
// % 4).  A: the 16 x 16 tile at (m0, k0) of a logical [m][k] matrix,
// stored [m][k] (KM false) or [k][m] (KM true); registers (g, q), (g + 8,
// q), (g, q + 8), (g + 8, q + 8), each two k.  B: the 16 x 8 tile at (k0,
// n0) of a logical [k][n] matrix, stored [n][k] (NK true) or [k][n];
// registers (q, g), (q + 8, g), each two k.  bf16 storage: one term, by
// ldmatrix; f32 storage (A only): three terms, split as read.
// SW: the storage is a swizzled array of 128-byte rows (pitch unused)
template <bool SW>
__device__ __forceinline__ const __nv_bfloat16* at(const __nv_bfloat16* p, int pitch, int r, int c) {
  return SW ? swz(p, r, c) : p + r * pitch + c;
}
template <bool KM, bool SW>
__device__ __forceinline__ void frag_a(unsigned (&a)[1][4], const __nv_bfloat16* p, int pitch, int m0, int k0,
                                       int lane) {
  if constexpr (KM)
    ldsm_x4<true>(a[0], at<SW>(p, pitch, k0 + (lane & 7) + ((lane >> 4) << 3), m0 + (((lane >> 3) & 1) << 3)));
  else
    ldsm_x4<false>(a[0], at<SW>(p, pitch, m0 + (lane & 15), k0 + ((lane >> 4) << 3)));
}
template <bool SW>
__device__ __forceinline__ float f32_at(const float* p, int pitch, int r, int c) {
  return SW ? *swz(p, r, c) : p[r * pitch + c];
}
template <bool KM, bool SW>
__device__ __forceinline__ void frag_a(unsigned (&a)[3][4], const float* p, int pitch, int m0, int k0, int lane) {
  const int g = lane >> 2, q = (lane & 3) * 2;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + g + (r & 1) * 8, k = k0 + q + (r >> 1) * 8;
    const float v0 = KM ? f32_at<SW>(p, pitch, k, m) : f32_at<SW>(p, pitch, m, k);
    const float v1 = KM ? f32_at<SW>(p, pitch, k + 1, m) : f32_at<SW>(p, pitch, m, k + 1);
    split3(v0, v1, a[0][r], a[1][r], a[2][r]);
  }
}
// Two B tiles (n0 and n0 + 8) of one bf16 term by one ldmatrix.x4
template <bool NK, bool SW>
__device__ __forceinline__ void frag_b2(unsigned (&b0)[2], unsigned (&b1)[2], const __nv_bfloat16* p, int pitch,
                                        int n0, int k0, int lane) {
  unsigned r[4];
  if constexpr (NK)
    ldsm_x4<false>(r, at<SW>(p, pitch, n0 + (lane & 7) + ((lane >> 4) << 3), k0 + (((lane >> 3) & 1) << 3)));
  else
    ldsm_x4<true>(r, at<SW>(p, pitch, k0 + (lane & 15), n0 + ((lane >> 4) << 3)));
  b0[0] = r[0];
  b0[1] = r[1];
  b1[0] = r[2];
  b1[1] = r[3];
}
// NT8 B tiles from n0 (NT8 even), KB bf16 terms ``tstride`` elements apart
template <bool NK, bool SW, int NT8, int KB>
__device__ __forceinline__ void frag_bs(unsigned (&b)[NT8][KB][2], const __nv_bfloat16* p, int pitch, int tstride,
                                        int n0, int k0, int lane) {
#pragma unroll
  for (int u = 0; u < KB; ++u)
#pragma unroll
    for (int j = 0; j < NT8; j += 2)
      frag_b2<NK, SW>(b[j][u], b[j + 1][u], p + u * tstride, pitch, n0 + 8 * j, k0, lane);
}
// MT A tiles from m0 (16 rows apart), KA terms
template <bool KM, bool SW, int MT, int KA, typename TA>
__device__ __forceinline__ void frag_as(unsigned (&a)[MT][KA][4], const TA* p, int pitch, int m0, int k0, int lane) {
#pragma unroll
  for (int i = 0; i < MT; ++i) frag_a<KM, SW>(a[i], p, pitch, m0 + 16 * i, k0, lane);
}

// A warp's MT x NT8 tiles of 16 x 8: acc += A B over k in [k0, k1) (steps
// of 16), A given as KA terms and B as KB by the loaders fa(a, k) and
// fb(b, k); the term products whose orders add to 3 or more (each below
// 2^-24 of the product) are left out.
template <int MT, int NT8, int KA, int KB, class FA, class FB>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT8][4], int k0, int k1, FA fa, FB fb) {
#pragma unroll 2
  for (int k = k0; k < k1; k += 16) {
    unsigned a[MT][KA][4], b[NT8][KB][2];
    fa(a, k);
    fb(b, k);
#pragma unroll
    for (int u = 0; u < KA; ++u)
#pragma unroll
      for (int v = 0; v < KB; ++v)
        if (u + v < 3)
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NT8; ++j) mma_bf16(acc[i][j], a[i][u], b[j][v]);
  }
}

// The f32 inputs' products on the CUDA cores, in the same layout as
// warp_mma's: a thread's rows g and g + 8 of each 16-row tile and columns
// 2q and 2q + 1 of each 8-column tile; acc += A B over k in [k0, k1), each
// sum a chain of fmaf in k order.  fa(m, k) reads A at a row of the warp's
// tile, fb(k, n) two neighbouring columns of B.
template <int MT, int NT8, class FA, class FB>
__device__ __forceinline__ void warp_fma(float (&acc)[MT][NT8][4], int k0, int k1, int lane, FA fa, FB fb) {
  const int g = lane >> 2, q = (lane & 3) * 2;
  for (int k = k0; k < k1; ++k) {
    float a[MT][2];
    float2 b[NT8];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      a[i][0] = fa(16 * i + g, k);
      a[i][1] = fa(16 * i + g + 8, k);
    }
#pragma unroll
    for (int j = 0; j < NT8; ++j) b[j] = fb(k, 8 * j + q);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        acc[i][j][0] = fmaf(a[i][0], b[j].x, acc[i][j][0]);
        acc[i][j][1] = fmaf(a[i][0], b[j].y, acc[i][j][1]);
        acc[i][j][2] = fmaf(a[i][1], b[j].x, acc[i][j][2]);
        acc[i][j][3] = fmaf(a[i][1], b[j].y, acc[i][j][3]);
      }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T, typename TL>
__global__ void __launch_bounds__(NT, 1)
ssd_wide_kernel(const T* __restrict__ x, const TL* __restrict__ la, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ h0, const float* __restrict__ n0,
                T* __restrict__ y, float* __restrict__ h_out, float* __restrict__ den,
                float* __restrict__ n_out, float* states, float* nstates, int* sync, int Bn, int S,
                int H, int P, int N, int Q, Strides xs_, Strides las_, Strides bs_, Strides cs_,
                int vec, const __grid_constant__ CUtensorMap tmB, const __grid_constant__ CUtensorMap tmC,
                const __grid_constant__ CUtensorMap tmH0, const __grid_constant__ CUtensorMap tmSt,
                const __grid_constant__ CUtensorMap tmHo) {
  using WT = WideTile<T>;
  constexpr int NS = WT::NS, XP = WT::XP, HM = NS / 32;
  constexpr bool F32 = sizeof(T) == 4;  // f32 inputs: the products on the CUDA cores
  using bf = __nv_bfloat16;
  // bf16 operands for the tensor cores (the branches f32 inputs never take still compile for them)
  auto bfp = [](const T* p) { return reinterpret_cast<const bf*>(p); };
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  sm += (1024 - (smem_u32(sm) & 1023)) & 1023;  // the swizzled rows repeat every 1024 bytes
  const WideLayout lay(Q, sizeof(T));
  const int QP = up32(Q), QS = QP + 4;
  T* xs = reinterpret_cast<T*>(sm + lay.xs);
  bf* wx = reinterpret_cast<bf*>(sm + lay.wx);
  bf* ht = reinterpret_cast<bf*>(sm + lay.ht);
  float *sc = reinterpret_cast<float*>(sm + lay.sc), *las = reinterpret_cast<float*>(sm + lay.las),
        *Ls = reinterpret_cast<float*>(sm + lay.Ls), *eL = reinterpret_cast<float*>(sm + lay.eL),
        *wts = reinterpret_cast<float*>(sm + lay.wts), *dparts = reinterpret_cast<float*>(sm + lay.dparts),
        *tot = reinterpret_cast<float*>(sm + lay.tot);
  auto braw = [&](int s) { return reinterpret_cast<T*>(sm + lay.ring + s * lay.stage + lay.braw); };
  auto craw = [&](int s) { return reinterpret_cast<T*>(sm + lay.ring + s * lay.stage + lay.craw); };
  auto hraw = [&](int s) { return reinterpret_cast<float*>(sm + lay.ring + s * lay.stage + lay.hraw); };
  auto nps = [&](int s) { return reinterpret_cast<float*>(sm + lay.ring + s * lay.stage + lay.nps); };

  cg::cluster_group cluster = cg::this_cluster();
  const int CS = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the thread that issues the accelerator's copies: in the last warp, which
  // holds no score tile at 8 blocks a cluster
  const bool tma = tid == NT - 32;
  const int NPT = P / WPT, G = NPT / CS, NC = S / Q, HBG = H * Bn * G;
  int* flags = sync + 1;  // [NC][B][H][P-tile]; sync[0] is the ticket counter
  __shared__ int ticket_s;
  __shared__ alignas(8) unsigned long long wbar[2];  // a stage's slice is in

  // ------------------------------------------- 1. this cluster's chunk, this block's columns
  if (rank == 0 && tid == 0) ticket_s = atomicAdd(sync, 1);
  if (tma) {
    mbar_init(smem_u32(&wbar[0]), 1);
    mbar_init(smem_u32(&wbar[1]), 1);
  }
  cluster.sync();
  const int ticket = *cluster.map_shared_rank(&ticket_s, 0);
  const int c = ticket / HBG;
  int rest = ticket - c * HBG;
  const int b = rest / (H * G);
  rest -= b * H * G;
  const int h = rest / G, gq = rest - h * G;
  const int s0 = c * Q, p0 = (gq * CS + rank) * WPT;
  const bool norm = den != nullptr && gq == 0;  // the cluster that carries the normalizer
  const int64_t bh = (int64_t)b * H + h, np = (int64_t)N * P;
  const int64_t slot = (int64_t)ticket * CS + rank;  // this block's flag: ((c B + b) H + h) P/64 + P-tile

  // the state and normalizer state this chunk starts from (null: zero)
  const float* prev = c == 0 ? (h0 ? h0 + bh * np : nullptr) : states + ((int64_t)(c - 1) * Bn * H + bh) * np;
  const float* nprev = !norm ? nullptr
                       : c == 0 ? (n0 ? n0 + bh * N : nullptr)
                                : nstates + ((int64_t)(c - 1) * Bn * H + bh) * N;
  // the tensor maps and planes ([N][P] each) of that state and of the one handed down
  const CUtensorMap* prev_map = c == 0 ? &tmH0 : &tmSt;
  const CUtensorMap* dst_map = c + 1 < NC ? &tmSt : &tmHo;
  const int prev_plane = c == 0 ? (int)bh : (c - 1) * Bn * H + (int)bh;
  const int dst_plane = c + 1 < NC ? c * Bn * H + (int)bh : (int)bh;
  float* ndst = !norm ? nullptr : c + 1 < NC ? nstates + ((int64_t)c * Bn * H + bh) * N : n_out + bh * N;
  const int nsl = (N + NS - 1) / NS;
  // bring slice i of B and C (what & 1) and of h and n (what & 2) into
  // stage s.  B's and C's [Q][NS] boxes each by one copy of the tensor
  // memory accelerator (vec bit 3: the wrapper's tensor maps take them;
  // columns past N read as 0), completing on the stage's mbarrier, else by
  // the threads (cp.async where rows are whole 16-byte pieces), waited for
  // at the top of the pass's next step; h's slice always by the
  // accelerator, n's rows by the threads.  The issuing thread arrives on
  // the mbarrier once a slice.
  auto issue = [&](int i, int s, int what) {
    const int n0s = i * NS, nv = min(NS, N - n0s);
    const unsigned bar = smem_u32(&wbar[s]);
    if (what & 1) {
      T *bd = braw(s), *cd = craw(s);
      if (vec & 8) {
        if (tma) {
          mbar_expect_tx(bar, 2u * Q * 128u);
          tma_load_4d(bd, &tmB, n0s, h, s0, b, bar);
          tma_load_4d(cd, &tmC, n0s, h, s0, b, bar);
        }
      } else {
        constexpr int E = 16 / sizeof(T);
        const T* bsrc = Bm + b * bs_.b + (int64_t)s0 * bs_.s + h * bs_.h + n0s;
        const T* csrc = Cm + b * cs_.b + (int64_t)s0 * cs_.s + h * cs_.h + n0s;
        for (int e = tid; e < Q * 8; e += NT) {  // 8 pieces of 16 bytes a row
          const int t = e >> 3, j = (e & 7) * E;
          T *db = const_cast<T*>(swz(bd, t, j)), *dc = const_cast<T*>(swz(cd, t, j));
          if (j >= nv) {
            zero16(db);
            zero16(dc);
            continue;
          }
          if (vec & 2) cp_async16(db, bsrc + t * bs_.s + j);
          else
#pragma unroll
            for (int u = 0; u < E; ++u) db[u] = bsrc[t * bs_.s + j + u];
          if (vec & 4) cp_async16(dc, csrc + t * cs_.s + j);
          else
#pragma unroll
            for (int u = 0; u < E; ++u) dc[u] = csrc[t * cs_.s + j + u];
        }
      }
    }
    if (what & 2) {
      if (prev != nullptr && tma) {  // h's [NS][64] in two boxes of 32 columns (rows past N: 0)
        mbar_expect_tx(bar, 2u * NS * 128u);
        tma_load_3d(hraw(s), prev_map, p0, n0s, prev_plane, bar);
        tma_load_3d(hraw(s) + NS * 32, prev_map, p0 + 32, n0s, prev_plane, bar);
      }
      if (norm && i % CS == rank)
        for (int n = tid; n < NS; n += NT) nps(s)[n] = (n < nv && nprev != nullptr) ? __ldcg(nprev + n0s + n) : 0.0f;
      cp_async_commit();
      if (tma) mbar_arrive(bar);
    }
  };
  {  // x's columns [p0, p0 + 64) as in memory; rows past Q are 0
    constexpr int E = 16 / sizeof(T), PR = WPT / E;
    const T* xb = x + b * xs_.b + (int64_t)s0 * xs_.s + h * xs_.h + p0;
    for (int i = tid; i < QP * PR; i += NT) {
      const int t = i / PR, j = (i - t * PR) * E;
      T* d = xs + t * XP + j;
      if (t >= Q) zero16(d);
      else if (vec & 1) cp_async16(d, xb + t * xs_.s + j);
      else
#pragma unroll
        for (int e = 0; e < E; ++e) d[e] = xb[t * xs_.s + j + e];
    }
  }
  issue(0, 0, 1);  // B and C need no state
  for (int t = tid; t < Q; t += NT) las[t] = to_f(la[b * las_.b + (int64_t)(s0 + t) * las_.s + h * las_.h]);
  cp_async_wait_all();
  // B's and C's rows past Q are 0 in both stages of the ring
  for (int s = 0; s < 2; ++s)
    for (int i = tid; i < (QP - Q) * 8; i += NT) {
      zero16(reinterpret_cast<char*>(braw(s)) + Q * 128 + i * 16);
      zero16(reinterpret_cast<char*>(craw(s)) + Q * 128 + i * 16);
    }
  __syncthreads();
  for (int t = tid; t < QP; t += NT) segment_scan(t < Q ? las[t] : 0.0f, t, las, tot, Q);
  __syncthreads();
  const float l_end = cumsum_finish(las, tot, Q - 1), a_end = expf(l_end);
  for (int t = tid; t < QP; t += NT) {
    const float L = t < Q ? cumsum_finish(las, tot, t) : 0.0f;
    Ls[t] = L;
    eL[t] = t < Q ? expf(L) : 0.0f;
    wts[t] = t < Q ? expf(l_end - L) : 0.0f;
  }
  __syncthreads();
  float* wxf = reinterpret_cast<float*>(wx);  // f32 inputs: w x as it is, [QP][XF]
  for (int i = tid; i < QP * (WPT / 2); i += NT) {  // w x, split into three terms (f32 inputs: as it is)
    const int s = i / (WPT / 2), pc = (i - s * (WPT / 2)) * 2;
    const float w = wts[s], v0 = __fmul_rn(w, to_f(xs[s * XP + pc])), v1 = __fmul_rn(w, to_f(xs[s * XP + pc + 1]));
    if constexpr (F32) {
      store2(wxf + s * XF + pc, v0, v1);
    } else {
      unsigned t0, t1, t2;
      split3(v0, v1, t0, t1, t2);
      unsigned* d = reinterpret_cast<unsigned*>(wx + s * XB + pc);
      d[0] = t0;
      d[QP * XB / 2] = t1;
      d[QP * XB] = t2;
    }
  }

  // ------------------------------------------- 2. the state before this chunk
  bool fault = false;
  if (c > 0 && tid == 0) {
    const volatile int* flag = flags + slot - (int64_t)HBG * CS;
    int polls = 0;
    while (*flag == 0 && ++polls < POLLS) __nanosleep(64);
    fault = polls >= POLLS;
    __threadfence();
  }
  fault = __syncthreads_or(fault);
  if (tma) fence_async_global();  // the accelerator reads the state after the flag
  issue(0, 0, 2);

  // ------------------------------------------- 3. one pass over N
  // this warp's score tiles: tile k (t-tile ti >= s-tile si) on block k
  // mod CS, warp (k / CS) mod 8
  const int QT = QP / 16, ntri = QT * (QT + 1) / 2;
  int tri_t[WTRI], tri_s[WTRI];
#pragma unroll
  for (int r = 0; r < WTRI; ++r) {
    const int k = rank + CS * (warp + 8 * r);
    int ti = (int)((sqrtf(8.0f * k + 1.0f) - 1.0f) * 0.5f);
    while (ti * (ti + 1) / 2 > k) --ti;
    while ((ti + 1) * (ti + 2) / 2 <= k) ++ti;
    tri_t[r] = k < ntri ? ti * 16 : -1;
    tri_s[r] = (k - ti * (ti + 1) / 2) * 16;
  }
  float sacc[WTRI][1][2][4] = {};
  float yacc[2][4][4] = {};  // y: rows 32 wm, columns 32 wn
  const int wm = warp & 3, wn = warp >> 2, hm = warp & 1, hn = warp >> 1;
  const bool ywarp = 32 * wm < QP;
  float dacc = 0.0f;  // this block's part of C_t . n, t = tid
  for (int i = 0; i < nsl; ++i) {
    const int s = i & 1, n0s = i * NS, nv = min(NS, N - n0s);
    cp_async_wait_all();
    __syncthreads();  // slice i is in stage s but for the accelerator's boxes; slice i - 1 is read
    if (i > 0 && tma) {  // slice i - 1's handed-down state goes out from its stage
      tma_store_3d(dst_map, hraw(s ^ 1), p0, n0s - NS, dst_plane);
      tma_store_3d(dst_map, hraw(s ^ 1) + NS * 32, p0 + 32, n0s - NS, dst_plane);
    }
    mbar_wait(smem_u32(&wbar[s]), (i >> 1) & 1);  // and its boxes
    const T *bsl = braw(s), *csl = craw(s);
    float* hr = hraw(s);
    if (!F32 && prev != nullptr)  // h's slice, split into three terms
      for (int e = tid; e < NS * (WPT / 2); e += NT) {
        const int n = e / (WPT / 2), pc = (e - n * (WPT / 2)) * 2;
        const float2 v = *reinterpret_cast<const float2*>(swz(hr + (pc >> 5) * NS * 32, n, pc & 31));
        unsigned t0, t1, t2;
        split3(v.x, v.y, t0, t1, t2);
        unsigned* d = reinterpret_cast<unsigned*>(ht + n * XB + pc);
        d[0] = t0;
        d[NS * XB / 2] = t1;
        d[NS * XB] = t2;
      }
    // the share of the scores: C B^T over the slice
#pragma unroll
    for (int r = 0; r < WTRI; ++r) {
      if (tri_t[r] < 0) continue;
      if constexpr (F32)
        warp_fma<1, 2>(
            sacc[r], 0, NS, lane, [&](int m, int k) { return to_f(*swz(csl, tri_t[r] + m, k)); },
            [&](int k, int n) { return make_float2(to_f(*swz(bsl, tri_s[r] + n, k)), to_f(*swz(bsl, tri_s[r] + n + 1, k))); });
      else
        warp_mma<1, 2, 1, 1>(
            sacc[r], 0, NS,
            [&](unsigned (&a)[1][1][4], int k) { frag_as<false, true>(a, bfp(csl), 0, tri_t[r], k, lane); },
            [&](unsigned (&bb)[2][1][2], int k) { frag_bs<true, true>(bb, bfp(bsl), 0, 0, tri_s[r], k, lane); });
    }
    {  // the slice's rows of H_c = B^T (w x); exp(L_end) h + H_c handed down
      float hacc[HM][2][4] = {};
      const int m0 = hm * (NS / 2);
      if constexpr (F32) {
        warp_fma<HM, 2>(
            hacc, 0, QP, lane, [&](int m, int k) { return to_f(*swz(bsl, k, m0 + m)); },
            [&](int k, int n) { return *reinterpret_cast<const float2*>(wxf + k * XF + 16 * hn + n); });
        if (prev != nullptr && ywarp)  // y += C h over the slice, before h's slice is overwritten
          warp_fma<2, 4>(
              yacc, 0, NS, lane, [&](int m, int k) { return to_f(*swz(csl, 32 * wm + m, k)); },
              [&](int k, int n) {
                const int col = 32 * wn + n;
                return *reinterpret_cast<const float2*>(swz(hr + (col >> 5) * NS * 32, k, col & 31));
              });
      } else {
        warp_mma<HM, 2, 1, 3>(
            hacc, 0, QP, [&](unsigned (&a)[HM][1][4], int k) { frag_as<true, true>(a, bfp(bsl), 0, m0, k, lane); },
            [&](unsigned (&bb)[2][3][2], int k) { frag_bs<false, false>(bb, wx, XB, QP * XB, 16 * hn, k, lane); });
      }
      __syncthreads();  // h's terms are in, and h's slice is read where the new state goes
      if (i + 1 < nsl) {  // slice i + 1 into the other stage, once the state has left it
        if (tma) bulk_wait_read();
        issue(i + 1, s ^ 1, 3);
      }
      const int g = lane >> 2, q = (lane & 3) * 2;
#pragma unroll
      for (int ii = 0; ii < HM; ++ii)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = m0 + 16 * ii + g + 8 * half, col = 16 * hn + 8 * j + q;
            float* hp = const_cast<float*>(swz(hr + (col >> 5) * NS * 32, m, col & 31));
            const float2 hv = prev != nullptr ? *reinterpret_cast<const float2*>(hp) : make_float2(0.0f, 0.0f);
            store2(hp, __fadd_rn(__fmul_rn(a_end, hv.x), hacc[ii][j][2 * half]),
                   __fadd_rn(__fmul_rn(a_end, hv.y), hacc[ii][j][2 * half + 1]));
          }
      fence_async_shared();  // the accelerator stores the slice from here
    }
    if (!F32 && prev != nullptr && ywarp)  // y += C h over the slice
      warp_mma<2, 4, 1, 3>(
          yacc, 0, NS, [&](unsigned (&a)[2][1][4], int k) { frag_as<false, true>(a, bfp(csl), 0, 32 * wm, k, lane); },
          [&](unsigned (&bb)[4][3][2], int k) { frag_bs<false, false>(bb, ht, XB, NS * XB, 32 * wn, k, lane); });
    if (norm && i % CS == rank) {  // the normalizer's rows of this slice
      const float* nv_s = nps(s);
      if (tid < Q) {  // four running sums over j mod 4, added in order
        float part[4] = {};
        for (int j = 0; j < nv; j += 4)
#pragma unroll
          for (int u = 0; u < 4; ++u) part[u] = fmaf(to_f(*swz(csl, tid, j + u)), nv_s[j + u], part[u]);
        dacc += (part[0] + part[1]) + (part[2] + part[3]);
      }
      const int n = tid - (NT - NS);
      if (n >= 0 && n < nv) {  // N_c = sum_s w_s B_s (s < QP: rows past Q are 0); exp(L_end) n + N_c handed down
        float part[4] = {};
        for (int k = 0; k < QP; k += 4)
#pragma unroll
          for (int u = 0; u < 4; ++u) part[u] = fmaf(wts[k + u], to_f(*swz(bsl, k + u, n)), part[u]);
        ndst[n0s + n] = __fadd_rn(__fmul_rn(a_end, nv_s[n]), (part[0] + part[1]) + (part[2] + part[3]));
      }
    }
  }
  __syncthreads();  // the last slice's state is in its stage; the ring is read
  if (tma) {
    const int last = nsl - 1;
    tma_store_3d(dst_map, hraw(last & 1), p0, last * NS, dst_plane);
    tma_store_3d(dst_map, hraw(last & 1) + NS * 32, p0 + 32, last * NS, dst_plane);
    bulk_wait();  // every slice's state is in global memory
    if (c + 1 < NC) {
      fence_async_global();
      __threadfence();  // cumulative: orders the block's writes above before the flag
      atomicExch(flags + slot, 1);
    }
  }

  // ------------------------------------------- 4. the scores, shared; y
  cluster.sync();  // every block's pass is done: the ring, where the scores go, is free in each
  {  // this block's share, decayed and masked to s <= t, into every block's sc [t][s], 16 bytes a store
    const int g = lane >> 2, q = (lane & 3) * 2, odd = lane & 1;
#pragma unroll
    for (int r = 0; r < WTRI; ++r) {
      if (tri_t[r] < 0) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float v[2][2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = tri_t[r] + g + 8 * half, s = tri_s[r] + 8 * j + q;
          v[half][0] = s <= t ? sacc[r][0][j][2 * half] * expf(fminf(Ls[t] - Ls[s], 0.0f)) : 0.0f;
          v[half][1] = s + 1 <= t ? sacc[r][0][j][2 * half + 1] * expf(fminf(Ls[t] - Ls[s + 1], 0.0f)) : 0.0f;
        }
        // an even lane keeps row g and takes its odd neighbour's pair of it;
        // an odd lane keeps row g + 8 and takes the even one's
        const float o0 = __shfl_xor_sync(0xffffffffu, v[odd ^ 1][0], 1);
        const float o1 = __shfl_xor_sync(0xffffffffu, v[odd ^ 1][1], 1);
        const int t = tri_t[r] + g + 8 * odd, s = tri_s[r] + 8 * j + (q & ~3);
        const float4 w = odd ? make_float4(o0, o1, v[1][0], v[1][1]) : make_float4(v[0][0], v[0][1], o0, o1);
        for (int dst_rank = 0; dst_rank < CS; ++dst_rank)
          *reinterpret_cast<float4*>(cluster.map_shared_rank(sc + t * QS + s, dst_rank)) = w;
      }
    }
  }
  // the tiles above the diagonal that y's 32-row strips read: 0
  for (int e = tid; e < (QT / 2) * 64; e += NT) {
    const int ti = 2 * (e >> 6), w4 = e & 63;
    zero16(sc + (16 * ti + (w4 >> 2)) * QS + 16 * (ti + 1) + (w4 & 3) * 4);
  }
  if (norm && tid < QP) *cluster.map_shared_rank(dparts + rank * QP + tid, 0) = dacc;
  cluster.sync();  // every share is in every block; nothing is read across blocks after this
  const float nan = __int_as_float(0x7fc00000);
  if (ywarp) {  // y = exp(L) (C h) + scores x
    const int g = lane >> 2, q = (lane & 3) * 2;
#pragma unroll
    for (int ii = 0; ii < 2; ++ii)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float e = eL[32 * wm + 16 * ii + g + 8 * half];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          yacc[ii][j][2 * half] *= e;
          yacc[ii][j][2 * half + 1] *= e;
        }
      }
    if constexpr (F32)
      warp_fma<2, 4>(
          yacc, 0, 32 * wm + 32, lane, [&](int m, int k) { return sc[(32 * wm + m) * QS + k]; },
          [&](int k, int n) { return make_float2(to_f(xs[k * XP + 32 * wn + n]), to_f(xs[k * XP + 32 * wn + n + 1])); });
    else
      warp_mma<2, 4, 3, 1>(
          yacc, 0, 32 * wm + 32, [&](unsigned (&a)[2][3][4], int k) { frag_as<false, false>(a, sc, QS, 32 * wm, k, lane); },
          [&](unsigned (&bb)[4][1][2], int k) { frag_bs<false, false>(bb, bfp(xs), XP, 0, 32 * wn, k, lane); });
#pragma unroll
    for (int ii = 0; ii < 2; ++ii)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = 32 * wm + 16 * ii + g + 8 * half;
        if (t >= Q) continue;
        T* yr = y + (((int64_t)b * S + s0 + t) * H + h) * P + p0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          store2(yr + 32 * wn + 8 * j + q, fault ? nan : yacc[ii][j][2 * half],
                 fault ? nan : yacc[ii][j][2 * half + 1]);
      }
  }
  if (norm && rank == 0)  // den_t = exp(L_t) (C_t . n) + sum_{s <= t} scores[t, s]
    for (int t = tid; t < Q; t += NT) {  // eight running sums over s mod 8 (0 past t), added in order
      float part[8] = {}, inter = 0.0f;
      for (int s = 0; s <= t; s += 8)
#pragma unroll
        for (int u = 0; u < 8; ++u) part[u] += sc[t * QS + s + u];
      for (int r = 0; r < CS; ++r) inter += dparts[r * QP + t];
      const float intra = ((part[0] + part[1]) + (part[2] + part[3])) + ((part[4] + part[5]) + (part[6] + part[7]));
      den[((int64_t)b * S + s0 + t) * H + h] = fault ? nan : eL[t] * inter + intra;
    }
}

// cuTensorMapEncodeTiled, from the driver at run time (no link to libcuda)
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  static bool tried = false;
  if (!tried) {
    tried = true;
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// The tensor map of a [B, S, H, N] operand (element strides st, N
// contiguous) whose box is a slice [Q][128 bytes of N], written to shared
// memory with the 128-byte swizzle; false where the accelerator cannot
// take it (a stride of 0 or not a multiple of 16 bytes, say)
template <typename T>
bool encode_slice_map(CUtensorMap* map, const void* base, const Strides& st, int Bn, int S, int H, int N, int Q) {
  const PFN_cuTensorMapEncodeTiled_v12000 enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  const int64_t e = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)N, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)Bn};
  // a dimension of size 1 is only ever read at 0: its stride is any multiple of 16
  const cuuint64_t strides[3] = {(cuuint64_t)(H > 1 ? st.h * e : 16), (cuuint64_t)(st.s * e),
                                 (cuuint64_t)(Bn > 1 ? st.b * e : 16)};
  for (int i = 0; i < 3; ++i)
    if (strides[i] == 0 || strides[i] % 16 != 0 || strides[i] >= (1ull << 40)) return false;
  const cuuint32_t box[4] = {(cuuint32_t)(128 / e), 1, (cuuint32_t)Q, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, e == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
             const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor map of f32 states [planes][N][P] whose box is [NS][32
// columns], written to and read from shared memory with the 128-byte
// swizzle
bool encode_state_map(CUtensorMap* map, const void* base, int planes, int N, int P, int NS) {
  const PFN_cuTensorMapEncodeTiled_v12000 enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)P, (cuuint64_t)N, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)P * 4, (cuuint64_t)N * P * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)NS, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, typename TL>
int launch_wide(const void* x, const void* la, const void* Bm, const void* Cm, const void* h0,
                const void* n0, void* y, void* h_out, void* den, void* n_out, void* states,
                void* nstates, void* sync, int vec, int Bn, int S, int H, int P, int N, int Q,
                Strides xs, Strides las, Strides bs, Strides cs, cudaStream_t stream) {
  const int64_t blocks = (int64_t)(S / Q) * Bn * H * (P / WPT);
  const int bytes = WideLayout(Q, sizeof(T)).total;
  auto kern = ssd_wide_kernel<T, TL>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemsetAsync(sync, 0, (size_t)(1 + blocks) * sizeof(int), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = wide_cluster(P);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  CUtensorMap tmB, tmC;
  memset(&tmB, 0, sizeof(tmB));
  memset(&tmC, 0, sizeof(tmC));
  if ((vec & 6) == 6 && encode_slice_map<T>(&tmB, Bm, bs, Bn, S, H, N, Q) &&
      encode_slice_map<T>(&tmC, Cm, cs, Bn, S, H, N, Q))
    vec |= 8;
  // the states go in and out by the accelerator: h0, the chunks' states, h_final
  const int NS = WideTile<T>::NS, NC = S / Q;
  CUtensorMap tmH0, tmSt, tmHo;
  memset(&tmH0, 0, sizeof(tmH0));
  memset(&tmSt, 0, sizeof(tmSt));
  memset(&tmHo, 0, sizeof(tmHo));
  if ((h0 != nullptr && !encode_state_map(&tmH0, h0, Bn * H, N, P, NS)) ||
      (NC > 1 && !encode_state_map(&tmSt, states, (NC - 1) * Bn * H, N, P, NS)) ||
      !encode_state_map(&tmHo, h_out, Bn * H, N, P, NS))
    return static_cast<int>(cudaErrorNotSupported);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(x), static_cast<const TL*>(la),
                         static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const float*>(h0),
                         static_cast<const float*>(n0), static_cast<T*>(y), static_cast<float*>(h_out),
                         static_cast<float*>(den), static_cast<float*>(n_out), static_cast<float*>(states),
                         static_cast<float*>(nstates), static_cast<int*>(sync), Bn, S, H, P, N, Q, xs, las, bs,
                         cs, vec, tmB, tmC, tmH0, tmSt, tmHo);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// cluster size, clusters resident at once, registers a thread, local
// memory bytes a thread (stack and spills), shared bytes a block, for one
// shape's launch
template <typename T, typename TL>
int wide_info(int Q, int P, int* out) {
  auto kern = ssd_wide_kernel<T, TL>;
  const int bytes = WideLayout(Q, sizeof(T)).total;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int cs = wide_cluster(P);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(P / WPT));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = cs;
  out[1] = clusters;
  out[2] = fa.numRegs;
  out[3] = static_cast<int>(fa.localSizeBytes);
  out[4] = bytes;
  return 0;
}

}  // namespace

// Shared memory one block needs at chunk Q (the wrapper refuses more than
// the card's 227 KB).
extern "C" int ssd_smem_bytes(int Q, int P, int N) {
  return static_cast<int>(Layout(Q, P, N).total * sizeof(float));
}

// The phase clocks of the last launch's first n chunks, n * CLOCK_MARKS
// values (a build with CLOCK_TICKETS > 0 only; else returns an error).
extern "C" int ssd_phase_clocks(long long* out, int n) {
  if (CLOCK_TICKETS == 0 || n > CLOCK_TICKETS) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, phase_clock, (size_t)n * CLOCK_MARKS * sizeof(long long)));
}

// x [B,S,H,P], log_a [B,S,H], B/C [B,S,H,N] given by element strides (the
// last dim contiguous; any stride may be 0), h0 [B,H,N,P] f32 contiguous
// or null for zeros; writes y [B,S,H,P] (x's type) and h_out [B,H,N,P]
// (f32), both contiguous.  Scratch: states [S/Q - 1, B, H, N, P] f32 (the
// state each chunk but the first starts from; unused when S == Q) and
// sync [1 + S/Q * B * H] int32 (set to 0 here).  x, B and C are all f32
// (x_bf16 = 0) or all bf16 (1); log_a f32 (la_bf16 = 0) or bf16 (1).
// vec bit 0, 1, 2: x, B, C rows start on 16-byte boundaries and are a
// whole number of 16-byte pieces.  S must be a multiple of Q and P of 4.
// A memset and one launch on ``stream``; returns the first error, else 0;
// does not synchronise.
extern "C" int ssd_fwd(const void* x, const void* la, const void* Bm, const void* Cm,
                       const void* h0, void* y, void* h_out, void* states, void* sync, int x_bf16,
                       int la_bf16, int vec, int Bn, int S, int H, int P, int N, int Q,
                       long long xs_b, long long xs_s, long long xs_h,
                       long long las_b, long long las_s, long long las_h,
                       long long bs_b, long long bs_s, long long bs_h,
                       long long cs_b, long long cs_s, long long cs_h, void* stream) {
  if (Bn < 1 || H < 1 || Q < 1 || S < Q || S % Q != 0 || P < 4 || P % 4 != 0 || N < 1 ||
      (up4(N) / 4) * (P / 4) > NT || (int64_t)(S / Q) * Bn * H >= (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides xs{xs_b, xs_s, xs_h}, las{las_b, las_s, las_h}, bs{bs_b, bs_s, bs_h},
      cs{cs_b, cs_s, cs_h};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
#define SSD_ARGS x, la, Bm, Cm, h0, y, h_out, states, sync, vec, Bn, S, H, P, N, Q, xs, las, bs, cs, st
  if (x_bf16 && la_bf16) return launch<bf, bf>(SSD_ARGS);
  if (x_bf16) return launch<bf, float>(SSD_ARGS);
  if (la_bf16) return launch<float, bf>(SSD_ARGS);
  return launch<float, float>(SSD_ARGS);
#undef SSD_ARGS
}

// Shared memory one block of the wide form needs at chunk Q, for bf16
// (x_bf16 = 1) or f32 x, B and C (the wrapper refuses more than the
// card's 227 KB).
extern "C" int ssd_wide_smem_bytes(int Q, int x_bf16) {
  return WideLayout(Q, x_bf16 ? 2 : 4).total;
}

// The wide form's launch at chunk Q and P columns, for the operand types
// as in ssd_wide_fwd: out[0] blocks a cluster, out[1] clusters resident
// at once (cudaOccupancyMaxActiveClusters), out[2] registers a thread,
// out[3] local memory bytes a thread (stack and spills), out[4] shared
// bytes a block.
extern "C" int ssd_wide_info(int Q, int P, int x_bf16, int la_bf16, int* out) {
  if (Q < 1 || Q > WQ || P < WPT || P % WPT != 0) return static_cast<int>(cudaErrorInvalidValue);
  using bf = __nv_bfloat16;
  if (x_bf16 && la_bf16) return wide_info<bf, bf>(Q, P, out);
  if (x_bf16) return wide_info<bf, float>(Q, P, out);
  if (la_bf16) return wide_info<float, bf>(Q, P, out);
  return wide_info<float, float>(Q, P, out);
}

// The wide form (a large state, the normalizer channel): the operands as
// for ssd_fwd, and besides them n0 [B,H,N] f32 contiguous or null for
// zeros, den [B,S,H] f32 and n_out [B,H,N] f32 (both null: no
// normalizer), nstates [S/Q - 1, B, H, N] f32 (the normalizer state each
// chunk but the first starts from).  sync holds 1 + S/Q * B * H * P/64
// int32.  Q at most 128, P a multiple of 64 and N of 32; h0, states and
// h_out 16-byte aligned (the accelerator's tensor maps, encoded here at
// each call, read and write them; cudaErrorNotSupported where the
// driver's encoder is missing or refuses them).
extern "C" int ssd_wide_fwd(const void* x, const void* la, const void* Bm, const void* Cm,
                            const void* h0, const void* n0, void* y, void* h_out, void* den,
                            void* n_out, void* states, void* nstates, void* sync, int x_bf16,
                            int la_bf16, int vec, int Bn, int S, int H, int P, int N, int Q,
                            long long xs_b, long long xs_s, long long xs_h,
                            long long las_b, long long las_s, long long las_h,
                            long long bs_b, long long bs_s, long long bs_h,
                            long long cs_b, long long cs_s, long long cs_h, void* stream) {
  if (Bn < 1 || H < 1 || Q < 1 || Q > WQ || S < Q || S % Q != 0 || P < WPT || P % WPT != 0 ||
      N < WNS || N % WNS != 0 || (den == nullptr) != (n_out == nullptr) ||
      (int64_t)(S / Q) * Bn * H * (P / WPT) >= (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides xs{xs_b, xs_s, xs_h}, las{las_b, las_s, las_h}, bs{bs_b, bs_s, bs_h},
      cs{cs_b, cs_s, cs_h};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
#define SSD_ARGS x, la, Bm, Cm, h0, n0, y, h_out, den, n_out, states, nstates, sync, vec, Bn, S, H, \
                 P, N, Q, xs, las, bs, cs, st
  if (x_bf16 && la_bf16) return launch_wide<bf, bf>(SSD_ARGS);
  if (x_bf16) return launch_wide<bf, float>(SSD_ARGS);
  if (la_bf16) return launch_wide<float, bf>(SSD_ARGS);
  return launch_wide<float, float>(SSD_ARGS);
#undef SSD_ARGS
}
