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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// The wide form: a large state and the normalizer channel (xLSTM's mLSTM).
//
// The mLSTM runs the same scan with N = P = dh = 512 at Q = 128: a 1 MB
// f32 state per (batch, head), and a [Q, N] operand of 256 KB, more than
// a block's shared memory.  Two things make it fit:
//
//   * a column of P is a sequence of its own (h[:, p] needs x[:, p] and
//     nothing else of x), so the grid gains a P-tile axis: one block per
//     (chunk, batch, head, P-tile of WPT columns), each with its own
//     ordered handoff of its [N, WPT] slice of the state, tickets dealt
//     chunk-major over all four as above;
//   * B and C are streamed through shared memory in slices of WNS rows of
//     N.  The first pass over the slices sums the scores C B^T in
//     registers and writes H_c's [N, WPT] into shared memory; after the
//     handoff the second pass streams C and the state before the chunk
//     (read back from L2 in slices) for exp(L) (C h).
//
// The scores are the same for every P-tile of a (batch, head, chunk), and
// each P-tile recomputes them: at xLSTM's shape they are a sixth of the
// block's multiply-adds (the two N x WPT products are the rest).
//
// The normalizer is the state of a virtual column of ones in x: it rides
// the same scores and decay, never exists in memory, and is carried by
// the first P-tile of each (batch, head): N_c = sum_s exp(L_end - L_s)
// B_s, n <- exp(L_end) n + N_c handed down with that tile's state, and
// den_t = exp(L_t) (C_t . n) + sum_{s <= t} scores[t, s], written in f32.
//
// One block per SM (227 KB of shared memory at N = 512, Q = 128); 768
// blocks at xLSTM's served prefill (batch 4, 4 heads, 6 chunks, 8
// P-tiles).  Bounded by operations, as the first form.
constexpr int WPT = 64;   // columns of P a block (its P-tile)
constexpr int WNS = 32;   // rows of N staged at a time (a slice)
constexpr int WQ = 128;   // the longest chunk the wide form takes (3 score tiles a thread)
constexpr int WTRI = 3;   // lower-triangle 4 x 4 score tiles a thread holds (QT (QT + 1) / 2 <= 3 NT)
constexpr int WY = 2;     // 4 x 4 y tiles a thread holds (QT * WPT / 4 <= 2 NT)

// Shared memory of the wide form, in floats (every region a whole number
// of float4s).  ``big`` holds H_c's [N][WPT] until the state is passed
// on, then the scores^T [QP][QP]; ``hs`` (the state's slice in the second
// pass) reuses B^T's slice.
struct WideLayout {
  int xs, big, bt, hs, ct, wb, part, las, Ls, eL, wts, tot, nc, nprev, total;
  __host__ __device__ WideLayout(int Q, int N) {
    const int QP = up8(Q);
    int o = 0;
    xs = o; o += Q * WPT;                   // [Q][WPT]  x, this block's columns
    big = o; o += imax(N * WPT, QP * QP);   // [N][WPT]  H_c, then [QP][QP] the scores^T
    bt = hs = o; o += WNS * imax(QP, WPT);  // [WNS][QP] a slice of B^T; then [WNS][WPT] of h
    ct = o; o += WNS * QP;                  // [WNS][QP] a slice of C^T
    wb = o; o += Q * WNS;                   // [Q][WNS]  the slice of B, row-major (H_c)
    part = o; o += WNS * WPT;               // [WNS][WPT] the second group's partial H_c
    las = o; o += QP;
    Ls = o; o += QP;
    eL = o; o += QP;
    wts = o; o += QP;
    tot = o; o += up4((Q + 31) / 32);
    nc = o; o += up4(N);                    // the normalizer's chunk summary N_c
    nprev = o; o += up4(N);                 // the normalizer state before the chunk
    total = o;
  }
};

template <typename T, typename TL>
__global__ void __launch_bounds__(NT, 1)
ssd_wide_kernel(const T* __restrict__ x, const TL* __restrict__ la, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ h0, const float* __restrict__ n0,
                T* __restrict__ y, float* __restrict__ h_out, float* __restrict__ den,
                float* __restrict__ n_out, float* states, float* nstates, int* sync, int Bn, int S,
                int H, int P, int N, int Q, Strides xs_, Strides las_, Strides bs_, Strides cs_,
                int vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const WideLayout lay(Q, N);
  const int QP = up8(Q), QT = QP / 4, PT4 = WPT / 4, NPT = P / WPT;
  float *xs = smem + lay.xs, *big = smem + lay.big, *bt = smem + lay.bt, *hs = smem + lay.hs,
        *ct = smem + lay.ct, *wb = smem + lay.wb, *part = smem + lay.part, *las = smem + lay.las,
        *Ls = smem + lay.Ls, *eL = smem + lay.eL, *wts = smem + lay.wts, *tot = smem + lay.tot,
        *nc = smem + lay.nc, *nprev = smem + lay.nprev;
  __shared__ int ticket_s;
  const int tid = threadIdx.x;
  const int NC = S / Q, HBP = H * Bn * NPT;
  int* flags = sync + 1;  // [NC][B][H][P-tile]; sync[0] is the ticket counter

  // ------------------------------------------- 1. this block's chunk and columns
  if (tid == 0) ticket_s = atomicAdd(sync, 1);
  if (QP != Q) {  // B^T and C^T: t >= Q reads as 0
    for (int i = tid; i < WNS * QP; i += NT) bt[i] = 0.0f;
    for (int i = tid; i < WNS * QP; i += NT) ct[i] = 0.0f;
  }
  __syncthreads();
  const int ticket = ticket_s;
  const int c = ticket / HBP;
  int rest = ticket - c * HBP;
  const int b = rest / (H * NPT);
  rest -= b * H * NPT;
  const int h = rest / NPT, pt = rest - h * NPT;
  const int s0 = c * Q, p0 = pt * WPT;
  const bool norm = den != nullptr && pt == 0;  // the P-tile that carries the normalizer
  const int64_t bh = (int64_t)b * H + h, np = (int64_t)N * P;

  stage<false>(xs, WPT, x + p0, xs_, b, s0, h, Q, WPT, vec & 1, tid);
  for (int t = tid; t < Q; t += NT)
    las[t] = to_f(la[b * las_.b + (int64_t)(s0 + t) * las_.s + h * las_.h]);
  __syncthreads();
  for (int t = tid; t < ((Q + 31) & ~31); t += NT) segment_scan(t < Q ? las[t] : 0.0f, t, las, tot, Q);
  __syncthreads();
  const float l_end = cumsum_finish(las, tot, Q - 1);
  for (int t = tid; t < QP; t += NT) {
    const float L = t < Q ? cumsum_finish(las, tot, t) : 0.0f;
    Ls[t] = L;
    eL[t] = t < Q ? expf(L) : 0.0f;
    wts[t] = t < Q ? expf(l_end - L) : 0.0f;
  }
  __syncthreads();

  // ------------------------------------------- 2. first pass over N: scores, H_c, N_c
  // this thread's lower-triangle score tiles (ti >= si), summed over the slices
  const int ntri = QT * (QT + 1) / 2;
  int st0[WTRI], ss0[WTRI];
#pragma unroll
  for (int r = 0; r < WTRI; ++r) {
    const int k = tid + r * NT;
    int ti = (int)((sqrtf(8.0f * k + 1.0f) - 1.0f) * 0.5f);
    while (ti * (ti + 1) / 2 > k) --ti;
    while ((ti + 1) * (ti + 2) / 2 <= k) ++ti;
    st0[r] = ti * 4;
    ss0[r] = (k - ti * (ti + 1) / 2) * 4;
  }
  float sacc[WTRI][4][4] = {};
  // H_c's slice [WNS][WPT] as 4 n x 4 p tiles: 128 tiles, two groups of
  // threads each summing half of the steps, group 1's sum added in order
  const int g = tid >> 7, tile = tid & 127;
  const int nn0 = (tile / PT4) * 4, pp0 = (tile % PT4) * 4;
  const int run = (Q + 1) / 2, k_lo = min(Q, g * run), k_hi = min(Q, (g + 1) * run);
  for (int n0s = 0; n0s < N; n0s += WNS) {
    stage<true>(bt, QP, Bm + n0s, bs_, b, s0, h, Q, WNS, (vec >> 1) & 1, tid);
    stage<true>(ct, QP, Cm + n0s, cs_, b, s0, h, Q, WNS, (vec >> 2) & 1, tid);
    stage<false>(wb, WNS, Bm + n0s, bs_, b, s0, h, Q, WNS, (vec >> 1) & 1, tid);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < WTRI; ++r)
      if (tid + r * NT < ntri) outer_sum(sacc[r], ct, QP, st0[r], bt, QP, ss0[r], 0, WNS);
    float hc[4][4] = {};
    for (int k = k_lo; k < k_hi; ++k) {
      const float w = wts[k];
      const float4 u = *reinterpret_cast<const float4*>(wb + k * WNS + nn0);
      const float4 v = *reinterpret_cast<const float4*>(xs + k * WPT + pp0);
      const float a4[4] = {u.x * w, u.y * w, u.z * w, u.w * w}, b4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) hc[i][j] = fmaf(a4[i], b4[j], hc[i][j]);
    }
    if (g == 1)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        store4(part + (nn0 + i) * WPT + pp0, hc[i][0], hc[i][1], hc[i][2], hc[i][3]);
    if (norm && tid < WNS) {  // N_c of this slice's rows
      float acc = 0.0f;
      for (int k = 0; k < Q; ++k) acc = fmaf(wts[k], wb[k * WNS + tid], acc);
      nc[n0s + tid] = acc;
    }
    __syncthreads();  // the slice is read; part is written
    if (g == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(part + (nn0 + i) * WPT + pp0);
        store4(big + (n0s + nn0 + i) * WPT + pp0, hc[i][0] + v.x, hc[i][1] + v.y, hc[i][2] + v.z,
               hc[i][3] + v.w);
      }
  }

  // ------------------------------------------- 3. the state before this chunk, passed on
  const int64_t slot = (((int64_t)c * Bn + b) * H + h) * NPT + pt;  // this block's flag
  bool fault = false;
  if (c > 0 && tid == 0) {
    const volatile int* flag = flags + slot - HBP;
    int polls = 0;
    while (*flag == 0 && ++polls < POLLS) __nanosleep(64);
    fault = polls >= POLLS;
    __threadfence();
  }
  fault = __syncthreads_or(fault);  // also: H_c is whole in big
  const float* prev = c == 0 ? (h0 ? h0 + bh * np : nullptr) : states + ((int64_t)(c - 1) * Bn * H + bh) * np;
  const float* nprev_g = !norm ? nullptr
                         : c == 0 ? (n0 ? n0 + bh * N : nullptr)
                                  : nstates + ((int64_t)(c - 1) * Bn * H + bh) * N;
  const float a_end = expf(l_end);
  {
    float* dst = c + 1 < NC ? states + ((int64_t)c * Bn * H + bh) * np : h_out + bh * np;
    for (int i = tid; i < N * PT4; i += NT) {  // exp(L_end) h + H_c, each step rounded
      const int n = i / PT4, q = (i - n * PT4) * 4;
      const float4 hv = prev ? __ldcg(reinterpret_cast<const float4*>(prev + n * (int64_t)P + p0 + q))
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float4 hc = *reinterpret_cast<const float4*>(big + n * WPT + q);
      store4(dst + n * (int64_t)P + p0 + q, __fadd_rn(__fmul_rn(a_end, hv.x), hc.x),
             __fadd_rn(__fmul_rn(a_end, hv.y), hc.y), __fadd_rn(__fmul_rn(a_end, hv.z), hc.z),
             __fadd_rn(__fmul_rn(a_end, hv.w), hc.w));
    }
    if (norm) {
      float* ndst = c + 1 < NC ? nstates + ((int64_t)c * Bn * H + bh) * N : n_out + bh * N;
      for (int n = tid; n < N; n += NT) {
        const float v = nprev_g ? __ldcg(nprev_g + n) : 0.0f;
        nprev[n] = v;
        ndst[n] = __fadd_rn(__fmul_rn(a_end, v), nc[n]);
      }
    }
  }
  __syncthreads();  // the state is written; H_c is read
  if (c + 1 < NC && tid == 0) {
    __threadfence();  // cumulative: orders the block's writes above before the flag
    atomicExch(flags + slot, 1);
  }
  // the scores^T into big, scaled by the decay and masked to s <= t
#pragma unroll
  for (int r = 0; r < WTRI; ++r) {
    if (tid + r * NT >= ntri) continue;
    const int t0 = st0[r], si0 = ss0[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = si0 + j;
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + i;
        v[i] = (s <= t && t < Q) ? sacc[r][i][j] * expf(fminf(Ls[t] - Ls[s], 0.0f)) : 0.0f;
      }
      store4(big + s * QP + t0, v[0], v[1], v[2], v[3]);
    }
  }

  // ------------------------------------------- 4. second pass over N: exp(L) (C h), den
  float yacc[WY][4][4] = {};
  float dacc = 0.0f;  // C_t . n for t = tid (the normalizer's tile)
  if (prev != nullptr || nprev_g != nullptr) {
    for (int n0s = 0; n0s < N; n0s += WNS) {
      stage<true>(ct, QP, Cm + n0s, cs_, b, s0, h, Q, WNS, (vec >> 2) & 1, tid);
      for (int i = tid; i < WNS * PT4; i += NT) {
        const int n = i / PT4, q = (i - n * PT4) * 4;
        *reinterpret_cast<float4*>(hs + n * WPT + q) =
            prev ? __ldcg(reinterpret_cast<const float4*>(prev + (n0s + n) * (int64_t)P + p0 + q))
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < WY; ++r) {
        const int yt = tid + r * NT;
        if (yt < QT * PT4) outer_sum(yacc[r], ct, QP, (yt / PT4) * 4, hs, WPT, (yt % PT4) * 4, 0, WNS);
      }
      if (norm && tid < Q)
        for (int j = 0; j < WNS; ++j) dacc = fmaf(ct[j * QP + tid], nprev[n0s + j], dacc);
      __syncthreads();  // the slice is read
    }
  } else {
    __syncthreads();  // the scores are in big
  }

  // ------------------------------------------- 5. y = exp(L) (C h) + scores x, and den
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int r = 0; r < WY; ++r) {
    const int yt = tid + r * NT;
    if (yt >= QT * PT4) continue;
    const int t0 = (yt / PT4) * 4, q0 = (yt % PT4) * 4;
    const float4 e = *reinterpret_cast<const float4*>(eL + t0);
    const float e4[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) yacc[r][i][j] *= e4[i];
    outer_sum(yacc[r], big, QP, t0, xs, WPT, q0, 0, min(t0 + 4, Q));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + i;
      if (t >= Q) break;
      store4(y + (((int64_t)b * S + s0 + t) * H + h) * P + p0 + q0, fault ? nan : yacc[r][i][0],
             fault ? nan : yacc[r][i][1], fault ? nan : yacc[r][i][2], fault ? nan : yacc[r][i][3]);
    }
  }
  if (norm && tid < Q) {  // den_t = exp(L_t) (C_t . n) + sum_{s <= t} scores[t, s]
    float intra = 0.0f;
    for (int s = 0; s <= tid; ++s) intra += big[s * QP + tid];
    den[((int64_t)b * S + s0 + tid) * H + h] = fault ? nan : eL[tid] * dacc + intra;
  }
}

template <typename T, typename TL>
int launch_wide(const void* x, const void* la, const void* Bm, const void* Cm, const void* h0,
                const void* n0, void* y, void* h_out, void* den, void* n_out, void* states,
                void* nstates, void* sync, int vec, int Bn, int S, int H, int P, int N, int Q,
                Strides xs, Strides las, Strides bs, Strides cs, cudaStream_t stream) {
  const int64_t blocks = (int64_t)(S / Q) * Bn * H * (P / WPT);
  const size_t bytes = (size_t)WideLayout(Q, N).total * sizeof(float);
  auto kern = ssd_wide_kernel<T, TL>;
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const cudaError_t e = cudaMemsetAsync(sync, 0, (size_t)(1 + blocks) * sizeof(int), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<(unsigned)blocks, NT, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const TL*>(la), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(h0), static_cast<const float*>(n0),
      static_cast<T*>(y), static_cast<float*>(h_out), static_cast<float*>(den),
      static_cast<float*>(n_out), static_cast<float*>(states), static_cast<float*>(nstates),
      static_cast<int*>(sync), Bn, S, H, P, N, Q, xs, las, bs, cs, vec);
  return static_cast<int>(cudaGetLastError());
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

// Shared memory one block of the wide form needs at chunk Q and state
// rows N (the wrapper refuses more than the card's 227 KB).
extern "C" int ssd_wide_smem_bytes(int Q, int N) {
  return static_cast<int>(WideLayout(Q, N).total * sizeof(float));
}

// The wide form (a large state, the normalizer channel): the operands as
// for ssd_fwd, and besides them n0 [B,H,N] f32 contiguous or null for
// zeros, den [B,S,H] f32 and n_out [B,H,N] f32 (both null: no
// normalizer), nstates [S/Q - 1, B, H, N] f32 (the normalizer state each
// chunk but the first starts from).  sync holds 1 + S/Q * B * H * P/64
// int32.  Q at most 128, P a multiple of 64 and N of 32.
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
