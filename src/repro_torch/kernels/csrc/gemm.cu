// f32 GEMMs of the CNN path, out[M,N] = epi(A[M,K] @ B[K,N]), row-major,
// in three entries that share one tile machinery and one summation order:
//
//   * gemm_f32: the plain GEMM, no epilogue.  Replaces the Pallas kernel
//     repro/kernels/gemm.py::_gemm_kernel (entry point gemm), the tiled
//     GEMM behind the unfused conv-as-GEMM route (the reference's
//     "pallas" backend).  A is the explicit patch matrix csrc/im2col.cu
//     writes, or the fc layers' activations; bias and ReLU stay outside.
//   * matmul_fused_f32: the fc GEMM with its epilogue, relu(sum + bias).
//     Replaces repro/kernels/conv_fused.py::_matmul_fused_kernel (entry
//     point matmul_fused).
//   * conv_fused_f32: the implicit-GEMM conv, NHWC input, HWIO filters,
//     with the same epilogue.  Replaces the f32 instantiation of
//     repro/kernels/conv_fused.py::_conv_fused_kernel (launched by
//     _conv_fused_call).  A[m, k] = x[b, oh*s - p + fi, ow*s - p + fj, c]
//     with m = (b, oh, ow) and k = (fi, fj, c), B4's patch-matrix order,
//     gathered from the unpadded input on the fly: no patch matrix and no
//     padded copy exist in device memory.  (csrc/conv_fused.cu keeps the
//     int32 instantiation, the quantized conv.)
//
// What bounds them on an H100: operations for the convs and the conv
// GEMMs (2*K flops per output, K up to 4608), bytes for the fc GEMMs,
// whose M is the serving micro-batch, so each weight element feeds only M
// multiply-adds.  The operations stay at f32 accuracy to hold the
// reference's tolerance: on the CUDA cores in IEEE fmaf (67 TFLOP/s), or
// on the TF32 tensor cores with each operand split into two TF32 terms
// and three term products kept (495 / 3 = 165 TFLOP/s of f32 work).
//
// The shared order.  Every output is summed in one order, fixed by (K, N)
// alone (gemm_order), whatever M is, whichever entry and whichever kernel
// below runs: K is cut into S slices of L rows (gemm_slice_len); the
// slice sums are added in slice order to a total that starts at 0.  So a
// row's result does not depend on the batch it rides in, and since the
// epilogue adds the bias to that total with one rounded add (fmaf(t, 1,
// b) == t + b), conv_fused_f32 and matmul_fused_f32 give the bits of
// gemm_f32 followed by "+ bias" and ReLU: the fused route equals the
// unfused one bitwise.  Inside a slice, one of two orders:
//   * order 0, the CUDA cores (K not a multiple of 16, or under 64: conv1_1's
//     K = 27, AlexNet's conv1, ResNet-50's 7x7 stem, small fcs): one fmaf
//     chain over k ascending from 0.
//   * order 1, the tensor cores (every other K; slices a multiple of 32
//     and at least 128 long): the slice is summed in steps of 32 k (the
//     last may run past K on zeros), each step starting from 0 on the
//     tensor cores (wgmma m64nNk8, TF32 in, f32 sums, N the rows of A a
//     block takes) from split terms, hi = tf32(v) and lo = tf32(v - hi)
//     (split_tf32: 22 significant bits of v; the dropped lo(a) lo(b) is
//     below 2^-22 of the product): first the small products lo(b) hi(a)
//     and hi(b) lo(a) of its four 8-deep steps in order, then the large
//     hi(b) hi(a) of each.  Each step's sum is then folded into the slice
//     sum by one IEEE add on the CUDA cores, so the hardware's f32 sums
//     never run over more than 96 products, and the small terms are summed
//     before the large ones join them.  The tensor cores' result for an
//     output depends only on its own row of A and column of B, so the
//     tiled and skinny kernels, with any tile and any rows beside, give
//     the same bits (tests/test_torch_gpu.py holds them so).
//
//   * gemm_tiled_kernel (M > MT, and every conv): one block per BM x BN
//     output tile, a TM x TN register tile per thread (8 x 8: 4 FMAs per
//     float read from shared memory; 8 x 4: 2.7), K in steps of BK
//     through a ring of STAGES stages in shared memory filled by
//     cp.async, so the next tiles load while this one computes (one
//     barrier a step).  A is stored k-major (As[k][m], rows padded to BM
//     + 4 floats), each float copied on its own (4-byte cp.async: this
//     transposes it, and takes any K, as conv1_1's K = 27); B row-major
//     with 16-byte copies where N % 4 == 0 and the base is aligned, 4-byte
//     ones otherwise.  Ragged edges and padding taps are zero-filled by
//     the copies (source size 0, a valid base pointer).  Two policies
//     make it serve all three entries:
//       - the A loader: PatchA reads a row-major A (gemm, the fc GEMM);
//         ImplicitA gathers the conv's A from x.  Its rows' (b, oh, ow)
//         are decomposed once per block into a table in shared memory
//         (a 64-bit base offset and the top-left input pixel), and k once
//         per k-step: where C % BK == 0 (every VGG-16 conv but conv1_1) a
//         k-step lies inside one filter tap, walked without a division;
//         any other C, stride and pad take the generic form, which
//         divides each thread's k by C and FW.
//       - the epilogue: NoEpi (gemm) or BiasRelu (the fused entries).
//     Four tile variants (tiled_shape picks one from M, K, N): 128 x 64
//     with 8 x 8 for large grids with N <= 64; 64 x 128 with 8 x 8 and its
//     slice totals in shared memory for grids with N > 64; 64 x 64 and 32
//     x 64 with 8 x 4 for smaller grids.  All have 128 threads but 32 x 64
//     (64).  The conv takes 64 x 128 where tiled_shape does and 64 x 64
//     elsewhere (conv_shape).  Registers (ptxas): 233 / 167 / 167 / 219
//     for the four variants under PatchA; 205 / 167 / 161 / 201 under
//     ImplicitA's one-tap walk.  The block walks all of K itself and
//     folds its slice accumulator into the total at every slice
//     boundary: no partial sums leave the block.
//   * gemm_skinny_kernel + gemm_finish_kernel (M <= MT, gemm and the fc
//     GEMM).  One thread owns 4 columns (a float4 of each weight row,
//     coalesced along N) and all M rows, for one slice, with SK_U weight
//     rows' loads in flight at once; S slices give enough blocks to keep
//     the memory system busy.  Each slice sum goes to a partial [S, M, N];
//     the second pass adds the S partials in order and applies the
//     epilogue.  No atomics.
//   The kernels above sum in order 0; two more sum in order 1, as the
//   transposed product out^T = B^T A^T: a warpgroup's 64 columns of B are
//   the tensor cores' a operand, in registers, and the block's rows of A
//   their b operand, in shared memory.
//   * gemm_tc_kernel (M > MT, and every conv): the same ring of stages
//     (BK = 32; A stored row by row, rows of 36 floats, B as it lies,
//     rows of BN + 8; 16-byte cp.async where the loader allows, 4-byte
//     copies elsewhere; the same A loaders and epilogues).  Once a stage
//     has landed, the block splits its A into hi and lo core matrices
//     (8 rows x 16 bytes, the layout wgmma reads without a swizzle), into
//     one of two buffers, while the tensor cores run the stage before on
//     the other; each thread splits its fragments of B in registers.
//     Four tile variants (tc_shape, rows x columns): 128 x 128 (two
//     warpgroups, totals in shared memory), 64 x 128 (two), 64 x 64 and
//     32 x 64 (one).
//   * gemm_skinny_tc_kernel + gemm_finish_kernel (M <= MT): one warpgroup
//     a 64 columns of one slice, its fragments of B read straight from
//     device memory a step ahead, the M rows of A (and zero rows to 8)
//     split into core matrices a step at a time (wgmma m64n8k8); the slice
//     sum goes to the partial as in order 0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SLICE_STEP = 16;     // K slices are multiples of this
constexpr int APAD = 4;            // As rows of BM + 4 floats: BM + 4 = 4 (mod 32) banks

constexpr int MT = 8;              // largest M the skinny kernel takes
constexpr int SK_NT = 128;         // skinny threads per block
constexpr int SK_COLS = 4 * SK_NT; // columns per skinny block
constexpr int SK_U = 8;            // weight rows a skinny thread loads at once
constexpr int SMS = 132;           // SMs of an H100 SXM
constexpr int TARGET_BLOCKS = 4 * SMS;  // four skinny blocks per SM

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A tile variant: BM x BN outputs a block, TM x TN a thread, K in steps
// of BK (16 or 32) through a ring of STAGES stages.  TS keeps the slice
// totals in shared memory (laid out [TM*TN][threads], so a warp's
// accesses hit 32 banks) instead of a second set of TM x TN registers:
// fewer registers, so three 128-thread blocks an SM instead of two.
// MINB is the blocks an SM the registers must allow (0: no bound).
template <int BM_, int BN_, int TM_, int TN_, int BK_, int STAGES_, bool TS_ = false,
          int MINB_ = 0>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, BK = BK_, STAGES = STAGES_;
  static constexpr bool TS = TS_;
  static constexpr int NT = (BM / TM) * (BN / TN);
  static constexpr int AS = BM + APAD;
  static constexpr int STAGE_FLOATS = BK * (AS + BN);
  static constexpr size_t SMEM =
      ((size_t)STAGES * STAGE_FLOATS + (TS ? (size_t)BM * BN : 0)) * sizeof(float);
  static constexpr int MINB = MINB_;
  static_assert(BK % SLICE_STEP == 0 && NT % 8 == 0 && (BM * 8) % NT == 0 &&
                    (BK * BN / 4) % NT == 0,
                "copies split evenly");
  static_assert(BN / TN >= 8 && TM % 4 == 0 && TN % 4 == 0, "quarter warps share a row of A");
  static_assert((BM + APAD) % 32 == 4, "A copies hit 32 distinct banks");
};

// ------------------------------------------------------------ A loaders
// A loader tells the tile where A[m0 + m, k0 + k] lies.  Per block it may
// build a row table (ROW_BYTES a row, in shared memory); per k-step it
// carries a Walk, advanced once per step in order; per k it makes a Kq and
// per row a Row, and src() joins them into a source address and a flag
// (false: the copy writes 0).  BY_ROW picks the copy loop's form: by row
// (a thread's k decomposed once a step, each of its rows read once from
// the table) for ImplicitA; copy by copy for PatchA, where the by-row
// form left B3 fewer registers and up to 1.8x slower at VGG-16's conv5
// on an H100 (benchmarks/port_kernel_variants.py).

// A row-major [M, K] matrix: the patch matrix, or the fc activations.
struct PatchA {
  const float* __restrict__ a;
  int M, K;
  static constexpr size_t ROW_BYTES = 0;
  static constexpr bool BY_ROW = false;
  struct Walk {
    __device__ void next(const PatchA&, int) {}
  };
  struct Kq { int k; };
  struct Row { int m; };
  __device__ Kq k_at(const Walk&, int k0, int kl) const { return {k0 + kl}; }
  __device__ Row row(const void*, int m0, int m) const { return {m0 + m}; }
  __device__ const float* src(const Row& r, const Kq& q, bool& ok) const {
    ok = r.m < M && q.k < K;
    return ok ? a + (int64_t)r.m * K + q.k : a;
  }
};

// One output pixel's row of the implicit A: its first element's offset in
// x (64-bit, negative where the window starts in the padding) and the
// input pixel under the window's top-left tap.
struct __align__(16) RowEntry {
  long long base;
  int ih0, iw0;
};

// The conv's A gathered from x [B, H, W, C] (NHWC, unpadded).  FAST
// (C % BK == 0): a k-step of BK lies inside one tap (fi, fj) at channels
// c0 .. c0 + BK - 1, walked from (0, 0, 0) without a division.  Generic:
// each k is split into (fi, fj, c) by division.
template <bool FAST>
struct ImplicitA {
  const float* __restrict__ x;
  int H, W, C, FW, stride, pad, OH, OW, M, K;
  static constexpr size_t ROW_BYTES = sizeof(RowEntry);
  static constexpr bool BY_ROW = true;
  struct Walk {
    int fi = 0, fj = 0, c0 = 0;  // FAST: the tap and first channel of the next k-step
    __device__ void next(const ImplicitA& A, int bk) {
      if constexpr (FAST) {
        c0 += bk;
        if (c0 == A.C) {
          c0 = 0;
          if (++fj == A.FW) {
            fj = 0;
            ++fi;
          }
        }
      }
    }
  };
  struct Kq { int fi, fj; long long off; bool ok; };  // off = (fi*W + fj)*C + c
  using Row = RowEntry;

  __device__ void build_rows(void* tab, int m0, int bm, int tid, int nt) const {
    RowEntry* t = static_cast<RowEntry*>(tab);
    for (int r = tid; r < bm; r += nt) {
      const int m = m0 + r;
      RowEntry e{0, -(1 << 28), 0};  // rows past M fail every bounds check
      if (m < M) {
        const int b = m / (OH * OW);
        const int rem = m - b * (OH * OW);
        const int oh = rem / OW;
        const int ow = rem - oh * OW;
        e.ih0 = oh * stride - pad;
        e.iw0 = ow * stride - pad;
        e.base = (((long long)b * H + e.ih0) * W + e.iw0) * C;
      }
      t[r] = e;
    }
  }
  // k0 + kl: the k of this thread's copy; w: the walk of its k-step (k0)
  __device__ Kq k_at(const Walk& w, int k0, int kl) const {
    if constexpr (FAST) {
      return {w.fi, w.fj, ((long long)w.fi * W + w.fj) * C + w.c0 + kl, true};
    } else {
      const int k = k0 + kl;
      const bool ok = k < K;
      const int kc = ok ? k : 0;
      const int tap = kc / C, c = kc - tap * C;
      const int fi = tap / FW, fj = tap - fi * FW;
      return {fi, fj, ((long long)fi * W + fj) * C + c, ok};
    }
  }
  __device__ Row row(const void* tab, int, int m) const {
    return static_cast<const RowEntry*>(tab)[m];
  }
  __device__ const float* src(const Row& r, const Kq& q, bool& ok) const {
    const int ih = r.ih0 + q.fi, iw = r.iw0 + q.fj;
    ok = q.ok && (unsigned)ih < (unsigned)H && (unsigned)iw < (unsigned)W;
    return ok ? x + r.base + q.off : x;
  }
};

// ------------------------------------------------------------ epilogues
struct NoEpi {
  __device__ float operator()(float v, int) const { return v; }
};
// relu(v + bias[n]): one rounded add, as "gemm(...) + b" then relu
struct BiasRelu {
  const float* __restrict__ bias;
  int relu;
  __device__ float operator()(float v, int n) const {
    v = __fadd_rn(v, __ldg(bias + n));
    return relu ? fmaxf(v, 0.0f) : v;
  }
};

// Thread (ty, tx) owns TM/4 runs of 4 rows, ty*4 + {0..3} in each BM/(TM/4)
// rows, and TN/4 runs of 4 columns likewise: each quarter warp reads 8
// consecutive float4s of a B row, conflict-free, and broadcasts A.
template <class TL, class AL, class EP>
__device__ __forceinline__ void gemm_tile(const AL& A, const float* __restrict__ b,
                                          float* __restrict__ out, int M, int K, int N, int L,
                                          int b_vec, const EP& ep) {
  constexpr int BM = TL::BM, BN = TL::BN, TM = TL::TM, TN = TL::TN, BK = TL::BK;
  constexpr int NT = TL::NT, AS = TL::AS, STAGES = TL::STAGES;
  constexpr int PM = TM / 4, PN = TN / 4;  // runs of 4 per thread
  constexpr int G = BM * 8 / NT;           // rows of A a thread copies
  constexpr int OCT = BK / 8;              // octets of k a thread copies, one k each
  extern __shared__ __align__(16) float smem[];
  float* ts = smem + STAGES * TL::STAGE_FLOATS;  // slice totals, when TL::TS
  void* rows = ts + (TL::TS ? BM * BN : 0);     // the A loader's row table
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int n_tiles = (K + BK - 1) / BK;

  if constexpr (AL::ROW_BYTES > 0) {
    A.build_rows(rows, m0, BM, tid, NT);
    __syncthreads();
  }
  typename AL::Walk walk;
  auto load_tile = [&](int t) {
    float* As = smem + (t % STAGES) * TL::STAGE_FLOATS;
    float* Bs = As + BK * AS;
    const int k0 = t * BK;
    // A: a warp copies 8 consecutive k of 4 rows (one 32-byte sector a
    // row) into As[k][m], 32 distinct banks
    if constexpr (!AL::BY_ROW) {  // each copy finds its own row and k
#pragma unroll
      for (int i = 0; i < BM * BK / NT; ++i) {
        const int e = tid + i * NT;
        const int oct = e / (BM * 8), rem = e % (BM * 8);
        const int m = rem / 8, k = oct * 8 + rem % 8;
        bool ok;
        const float* src = A.src(A.row(rows, m0, m), A.k_at(walk, k0, k), ok);
        cp_async4(&As[k * AS + m], src, ok);
      }
    } else {  // a thread's k once a step, then its rows one by one
      typename AL::Kq kq[OCT];
#pragma unroll
      for (int o = 0; o < OCT; ++o) kq[o] = A.k_at(walk, k0, o * 8 + tid % 8);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int m = tid / 8 + g * (NT / 8);
        const typename AL::Row r = A.row(rows, m0, m);
#pragma unroll
        for (int o = 0; o < OCT; ++o) {
          bool ok;
          const float* src = A.src(r, kq[o], ok);
          cp_async4(&As[(o * 8 + tid % 8) * AS + m], src, ok);
        }
      }
    }
    walk.next(A, BK);
    if (b_vec) {
#pragma unroll
      for (int i = 0; i < BK * BN / 4 / NT; ++i) {
        const int c = tid + i * NT;
        const int k = c / (BN / 4), n = (c % (BN / 4)) * 4;
        const bool ok = (k0 + k < K) && (n0 + n < N);
        cp_async16(&Bs[k * BN + n], ok ? b + (int64_t)(k0 + k) * N + n0 + n : b, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BK * BN / NT; ++i) {
        const int e = tid + i * NT;
        const int k = e / BN, n = e % BN;
        const bool ok = (k0 + k < K) && (n0 + n < N);
        cp_async4(&Bs[k * BN + n], ok ? b + (int64_t)(k0 + k) * N + n0 + n : b, ok);
      }
    }
  };

  float acc[TM][TN], tot[TL::TS ? 1 : TM][TL::TS ? 1 : TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc[i][j] = 0.0f;
      if constexpr (TL::TS) ts[(i * TN + j) * NT + tid] = 0.0f;
      else tot[i][j] = 0.0f;
    }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    cp_async_commit();
  }
  int fold_at = L;
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();  // tile t has landed (this thread's copies)
    __syncthreads();              // ... everyone's; and tile t - 1 is read
    if (t + STAGES - 1 < n_tiles) load_tile(t + STAGES - 1);
    cp_async_commit();
    const float* As = smem + (t % STAGES) * TL::STAGE_FLOATS;
    const float* Bs = As + BK * AS;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bw[TN];
#pragma unroll
      for (int p = 0; p < PM; ++p) {
        const float4 x = *reinterpret_cast<const float4*>(&As[kk * AS + p * (BM / PM) + ty * 4]);
        av[4 * p] = x.x; av[4 * p + 1] = x.y; av[4 * p + 2] = x.z; av[4 * p + 3] = x.w;
      }
#pragma unroll
      for (int p = 0; p < PN; ++p) {
        const float4 x = *reinterpret_cast<const float4*>(&Bs[kk * BN + p * (BN / PN) + tx * 4]);
        bw[4 * p] = x.x; bw[4 * p + 1] = x.y; bw[4 * p + 2] = x.z; bw[4 * p + 3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
      const int k_end = t * BK + kk + 1;
      if ((kk + 1) % SLICE_STEP == 0 && k_end - SLICE_STEP < K &&
          (k_end >= fold_at || k_end >= K)) {
        // end of a slice (L % SLICE_STEP == 0): fold it into the total
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            if constexpr (TL::TS) {
              float& x = ts[(i * TN + j) * NT + tid];
              x = x + acc[i][j];
            } else {
              tot[i][j] = tot[i][j] + acc[i][j];
            }
            acc[i][j] = 0.0f;
          }
        fold_at += L;
      }
    }
  }
  cp_async_wait<0>();

  const bool vec_out = (N % 4) == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i / 4) * (BM / PM) + ty * 4 + i % 4;
    if (m >= M) continue;
#pragma unroll
    for (int p = 0; p < PN; ++p) {
      const int n = n0 + p * (BN / PN) + tx * 4;
      float r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (TL::TS) r[j] = ts[(i * TN + 4 * p + j) * NT + tid];
        else r[j] = tot[i][4 * p + j];
        if (n + j < N) r[j] = ep(r[j], n + j);
      }
      float* o = out + (int64_t)m * N + n;
      if (vec_out && n + 3 < N) {
        *reinterpret_cast<float4*>(o) = make_float4(r[0], r[1], r[2], r[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) o[j] = r[j];
      }
    }
  }
}

// __launch_bounds__ with a minimum of 1 block allocates registers
// differently from none at all (more of them, for the 64 x 64 tile), so
// the bound is given only where a tile asks for one.
template <class TL, class AL, class EP>
__global__ void __launch_bounds__(TL::NT) gemm_tiled_kernel(const AL A,
                                                            const float* __restrict__ b,
                                                            float* __restrict__ out, int M, int K,
                                                            int N, int L, int b_vec, const EP ep) {
  gemm_tile<TL>(A, b, out, M, K, N, L, b_vec, ep);
}
template <class TL, class AL, class EP>
__global__ void __launch_bounds__(TL::NT, TL::MINB > 0 ? TL::MINB : 1)
gemm_tiled_kernel_bounded(const AL A, const float* __restrict__ b, float* __restrict__ out,
                          int M, int K, int N, int L, int b_vec, const EP ep) {
  gemm_tile<TL>(A, b, out, M, K, N, L, b_vec, ep);
}

template <class TL, class AL, class EP>
int launch_tiled(const AL& A, const float* B, float* O, int M, int K, int N, int L, int b_vec,
                 const EP& ep, cudaStream_t st) {
  auto kern = [] {
    if constexpr (TL::MINB > 0) return gemm_tiled_kernel_bounded<TL, AL, EP>;
    else return gemm_tiled_kernel<TL, AL, EP>;
  }();
  constexpr size_t smem = TL::SMEM + TL::BM * AL::ROW_BYTES;
  if (smem > 48 * 1024) {
    static bool raised = false;  // benign race: the attribute is idempotent
    if (!raised) {
      cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      raised = true;
    }
  }
  dim3 grid((M + TL::BM - 1) / TL::BM, (N + TL::BN - 1) / TL::BN);
  kern<<<grid, TL::NT, smem, st>>>(A, B, O, M, K, N, L, b_vec, ep);
  return static_cast<int>(cudaGetLastError());
}

// The tile variants, largest first (Tile3 has 64 threads, the rest 128).
using Tile0 = Tile<128, 64, 8, 8, 16, 3>;
using Tile1 = Tile<64, 128, 8, 8, 16, 3, true, 3>;
using Tile2 = Tile<64, 64, 8, 4, 32, 3, false, 3>;
using Tile3 = Tile<32, 64, 8, 4, 32, 3>;
constexpr int N_TILES = 4;

int64_t tiles(int M, int N, int bm, int bn) {
  return (int64_t)((M + bm - 1) / bm) * ((N + bn - 1) / bn);
}

// 8 x 8 tiles where K is long enough to pay for them: 128 x 64 where N
// <= 64 and the grid is at least four blocks an SM; 64 x 128, totals in
// shared memory, where N > 64 and the grid is at least two blocks an SM
// (three fit on an SM).  Else 64 x 64 where that grid is at least two
// blocks an SM, else 32 x 64.
int tiled_shape(int M, int K, int N) {
  if (K >= 256 && N <= 64 && tiles(M, N, 128, 64) >= 4 * SMS) return 0;
  if (K >= 256 && N > 64 && tiles(M, N, 64, 128) >= 2 * SMS) return 1;
  if (tiles(M, N, 64, 64) >= 2 * SMS) return 2;
  return 3;
}

template <class AL, class EP>
int launch_shape(int shape, const AL& A, const float* B, float* O, int M, int K, int N, int L,
                 int b_vec, const EP& ep, cudaStream_t st) {
  switch (shape) {
    case 0: return launch_tiled<Tile0>(A, B, O, M, K, N, L, b_vec, ep, st);
    case 1: return launch_tiled<Tile1>(A, B, O, M, K, N, L, b_vec, ep, st);
    case 2: return launch_tiled<Tile2>(A, B, O, M, K, N, L, b_vec, ep, st);
    case 3: return launch_tiled<Tile3>(A, B, O, M, K, N, L, b_vec, ep, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The conv's tile variant: 64 x 128 where tiled_shape picks it, else 64 x
// 64, which beats 128 x 64 and 32 x 64 under the implicit loader at every
// VGG-16 conv (benchmarks/port_kernel_variants.py).
int conv_shape(int M, int K, int N) {
  return tiled_shape(M, K, N) == 1 ? 1 : 2;
}

// The conv on tile variant TL: the fast walk where a k-step of TL::BK
// lies inside one filter tap.
template <class TL>
int launch_conv(const ImplicitA<false>& A, const float* B, float* O, int N, int L, int b_vec,
                const BiasRelu& ep, cudaStream_t st) {
  if (A.C % TL::BK == 0) {
    const ImplicitA<true> F{A.x, A.H, A.W, A.C, A.FW, A.stride, A.pad, A.OH, A.OW, A.M, A.K};
    return launch_tiled<TL>(F, B, O, A.M, A.K, N, L, b_vec, ep, st);
  }
  return launch_tiled<TL>(A, B, O, A.M, A.K, N, L, b_vec, ep, st);
}

// ------------------------------------------------------------ order 1
constexpr int TC_K = 16, TC_MIN_K = 64;  // order 1 takes K % TC_K == 0 and K >= TC_MIN_K
constexpr int TC_BK = 32;           // k a ring stage, summed on the tensor cores between two folds
constexpr int TC_MIN_L = 128;       // slices of order 1 are at least this long, and multiples of TC_BK
constexpr int TC_KC = TC_BK / 4;    // 16-byte core-matrix columns a stage
constexpr int TC_XP = TC_BK + 4;    // raw A rows of 144 bytes: a quarter warp's 16-byte reads on 32 banks

bool tc_order(int K) { return K % TC_K == 0 && K >= TC_MIN_K; }

// hi = tf32(v), lo = tf32(v - hi), both rounded to nearest with ties away
// from zero (cvt.rna.tf32.f32 on finite values: half the dropped unit
// added to the magnitude's bit pattern, the 13 dropped bits cleared); v -
// hi is exact in f32, so v - hi - lo is below 2^-22 |v|
constexpr unsigned TF32_HALF = 1u << 12, TF32_KEEP = ~((1u << 13) - 1);
__device__ __forceinline__ unsigned tf32_rn(unsigned bits) { return (bits + TF32_HALF) & TF32_KEEP; }
__device__ __forceinline__ void split_tf32(float v, unsigned& hi, unsigned& lo) {
  hi = tf32_rn(__float_as_uint(v));
  lo = tf32_rn(__float_as_uint(__fsub_rn(v, __uint_as_float(hi))));
}

// wgmma.mma_async m64nNk8, TF32 in, f32 sums: d (+)= a b with a, 64 rows
// x 8 k, in registers (warp w of the warpgroup holds rows 16w .. 16w +
// 15: (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4), g = lane / 4, q =
// lane % 4) and b, 8 k x N, in shared memory (desc); scale_d 0 ignores d.
// d: for each 8 columns i, (16w + g, 8i + 2q), (16w + g, 8i + 2q + 1),
// (16w + g + 8, 8i + 2q), (16w + g + 8, 8i + 2q + 1).
template <int N> struct Wgmma;
template <> struct Wgmma<8> {
  __device__ __forceinline__ static void mma(float (&d)[4], const unsigned (&a)[4], uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};
template <> struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], const unsigned (&a)[4], uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};
template <> struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], const unsigned (&a)[4], uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};
template <> struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], const unsigned (&a)[4], uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// keep the compiler from moving the accumulators, or reusing the a
// operand's registers, while an asynchronous product runs
template <int N> __device__ __forceinline__ void wg_hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int E> __device__ __forceinline__ void wg_hold(unsigned (&a)[E][4]) {
#pragma unroll
  for (int e = 0; e < E; ++e)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[e][i])::"memory");
}
// the threads' shared-memory writes, before the tensor cores read them
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// The b operand's layout: core matrices of 8 rows x 4 k (8 x 16 bytes,
// 128 bytes each), for rows 8r .. 8r + 7 and k 4c .. 4c + 3 at float
// offset (r * kcols + c) * 32; a descriptor with no swizzle, the next
// core matrix in k 128 bytes on (LBO) and in rows kcols * 128 (SBO).
__device__ __forceinline__ int core_at(int row, int k, int kcols) {
  return ((row >> 3) * kcols + (k >> 2)) * 32 + (row & 7) * 4 + (k & 3);
}
__device__ __forceinline__ uint64_t wg_desc(const float* p, int kcols) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)((kcols * 128) >> 4) << 32);
}

// One stage of order 1 on the tensor cores: c = the small products lo(w)
// hi(x), hi(w) lo(x) of its four 8-deep steps e in order, the first
// ignoring c, then the large hi(w) hi(x) of each; w the fragments of the
// weights split in registers, xh and xl the split rows of A (core matrices
// of kcols columns).
template <int N>
__device__ __forceinline__ void tc_issue(float (&c)[N / 2], const unsigned (&wh)[TC_BK / 8][4],
                                         const unsigned (&wl)[TC_BK / 8][4], const float* xh, const float* xl,
                                         int kcols) {
  wg_hold(c);
  wg_fence();
#pragma unroll
  for (int e = 0; e < TC_BK / 8; ++e) {
    Wgmma<N>::mma(c, wl[e], wg_desc(xh + 2 * e * 32, kcols), e);
    Wgmma<N>::mma(c, wh[e], wg_desc(xl + 2 * e * 32, kcols), 1);
  }
#pragma unroll
  for (int e = 0; e < TC_BK / 8; ++e) Wgmma<N>::mma(c, wh[e], wg_desc(xh + 2 * e * 32, kcols), 1);
  wg_commit();
}
// tc_issue, then its wait
template <int N>
__device__ __forceinline__ void tc_stage(float (&c)[N / 2], unsigned (&wh)[TC_BK / 8][4], unsigned (&wl)[TC_BK / 8][4],
                                         const float* xh, const float* xl, int kcols) {
  tc_issue<N>(c, wh, wl, xh, xl, kcols);
  wg_wait();
  wg_hold(c);
  wg_hold(wh);
  wg_hold(wl);
}

// An order-1 tile variant: PX rows of A (output pixels) x CH columns of B
// (output channels) a block, one warpgroup a 64 columns, a ring of STAGES
// stages of TC_BK k; TS keeps the totals in shared memory (laid out
// [ACC][NT]) instead of registers; MINB blocks an SM.
template <int CH_, int PX_, int STAGES_, bool TS_, int MINB_>
struct TcTile {
  static constexpr int CH = CH_, PX = PX_, STAGES = STAGES_, MINB = MINB_;
  static constexpr bool TS = TS_;
  static constexpr int NT = 2 * CH;                         // a warpgroup a 64 columns
  static constexpr int WP = CH + 8;                         // raw B rows: (8q + g) over a fragment's reads, 32 banks
  static constexpr int STAGE_FLOATS = PX * TC_XP + TC_BK * WP;
  static constexpr int ACC = PX / 2;                        // f32 sums a thread
  static constexpr size_t SMEM =
      ((size_t)STAGES * STAGE_FLOATS + 4 * PX * TC_BK + (TS ? (size_t)ACC * NT : 0)) * sizeof(float);
  static_assert(CH % 64 == 0 && PX % 8 == 0 && NT % PX == 0, "whole warpgroups, 8-row core matrices");
  static_assert(NT % (TC_BK / 4) == 0 && (PX * TC_BK / 4) % NT == 0 && NT % (CH / 4) == 0 &&
                    (TC_BK * CH / 4) % NT == 0, "copies split evenly");
};
using Tc0 = TcTile<128, 128, 2, true, 1>;
using Tc1 = TcTile<128, 64, 2, false, 1>;
using Tc2 = TcTile<64, 64, 3, false, 2>;
using Tc3 = TcTile<64, 32, 3, false, 2>;

// The tiled kernel of order 1: A (PX rows) and B (CH columns) through a
// ring of cp.async stages as the CUDA-core tile does (the same A loaders;
// 16-byte copies where VEC, 4-byte ones elsewhere); a stage's A split once
// into hi and lo core matrices in shared memory for the tensor cores' b
// operand, B's fragments split in registers for their a operand: the
// product is out^T = B^T A^T, a warpgroup's 64 columns of B by PX rows of A.
template <class TL, class AL, bool VEC, class EP>
__device__ __forceinline__ void tc_tile(const AL& A, const float* __restrict__ b, float* __restrict__ out,
                                        int M, int K, int N, int L, int b_vec, const EP& ep) {
  constexpr int CH = TL::CH, PX = TL::PX, WP = TL::WP, NT = TL::NT, STAGES = TL::STAGES, ACC = TL::ACC;
  extern __shared__ __align__(128) float smem[];
  float* xs = smem + STAGES * TL::STAGE_FLOATS;  // two stages' A split: [stage parity][hi, lo][core matrices]
  float* ts = xs + 4 * PX * TC_BK;               // the totals, when TL::TS
  void* rows = ts + (TL::TS ? ACC * NT : 0);    // the A loader's row table
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int m0 = blockIdx.x * PX, n0 = blockIdx.y * CH;
  const int cw = 16 * warp + g;                  // this thread's columns cw, cw + 8 of the block's
  const int n_tiles = (K + TC_BK - 1) / TC_BK;

  if constexpr (AL::ROW_BYTES > 0) {
    A.build_rows(rows, m0, PX, tid, NT);
    __syncthreads();
  }
  // Each thread's copies, fixed for the block: A's rows tid / AV + i (NT /
  // AV) at k kl .. kl + 3 of every stage; B's rows tid / BV + i (NT / BV)
  // at columns n0 + bn .. + 3, from a pointer moved TC_BK rows a stage.
  constexpr int AV = TC_BK / 4, RA = PX * AV / NT;
  constexpr int BV = CH / 4, RB = TC_BK * BV / NT;
  typename AL::Walk walk;
  const int kl = (tid % AV) * 4;
  typename AL::Row arow[RA];
#pragma unroll
  for (int i = 0; i < RA; ++i) arow[i] = A.row(rows, m0, tid / AV + i * (NT / AV));
  const int bn = (tid % BV) * 4, bk = tid / BV;
  const bool bn_ok = n0 + bn < N;
  const float* bsrc = b + (int64_t)bk * N + n0 + bn;
  auto load_tile = [&](int t) {
    float* As = smem + (t % STAGES) * TL::STAGE_FLOATS;
    float* Bs = As + PX * TC_XP;
    const int k0 = t * TC_BK;
    if constexpr (VEC) {
      const typename AL::Kq kq = A.k_at(walk, k0, kl);
#pragma unroll
      for (int i = 0; i < RA; ++i) {
        bool ok;
        const float* src = A.src(arow[i], kq, ok);
        cp_async16(&As[(tid / AV + i * (NT / AV)) * TC_XP + kl], src, ok);
      }
    } else {
      typename AL::Kq kq[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) kq[u] = A.k_at(walk, k0, kl + u);
#pragma unroll
      for (int i = 0; i < RA; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          bool ok;
          const float* src = A.src(arow[i], kq[u], ok);
          cp_async4(&As[(tid / AV + i * (NT / AV)) * TC_XP + kl + u], src, ok);
        }
    }
    walk.next(A, TC_BK);
    if (b_vec) {
      const float* bt = bsrc + (int64_t)k0 * N;
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int k = bk + i * (NT / BV);
        const bool ok = bn_ok && k0 + k < K;
        cp_async16(&Bs[k * WP + bn], ok ? bt + (int64_t)i * (NT / BV) * N : b, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < TC_BK * CH / NT; ++i) {
        const int e = tid + i * NT;
        const int k = e / CH, n = e % CH;
        const bool ok = (k0 + k < K) && (n0 + n < N);
        cp_async4(&Bs[k * WP + n], ok ? b + (int64_t)(k0 + k) * N + n0 + n : b, ok);
      }
    }
  };

  float c[ACC], s[ACC], tot[TL::TS ? 1 : ACC];  // a step's sums, the slice sum, the total
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    c[i] = s[i] = 0.0f;
    if constexpr (TL::TS) ts[i * NT + tid] = 0.0f;
    else tot[i] = 0.0f;
  }
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) load_tile(st);
    cp_async_commit();
  }
  // Where K % 32 == 16 the last stage's second half multiplies the
  // copies' zeros, as the skinny kernel does.  Slices end at stage ends (L
  // % TC_BK == 0) and at K.
  // A stage's 16-byte runs of A split into core matrices (a quarter warp
  // takes 8 rows of one column), into the buffer of the stage's parity
  auto split_stage = [&](int t) {
    const float* As = smem + (t % STAGES) * TL::STAGE_FLOATS;
    float* xh = xs + (t & 1) * 2 * PX * TC_BK;
#pragma unroll
    for (int i = 0; i < PX * TC_KC / NT; ++i) {
      const int j = tid + i * NT, r = j % PX, kc = j / PX;
      const float4 v = *reinterpret_cast<const float4*>(&As[r * TC_XP + 4 * kc]);
      uint4 h, l;
      split_tf32(v.x, h.x, l.x);
      split_tf32(v.y, h.y, l.y);
      split_tf32(v.z, h.z, l.z);
      split_tf32(v.w, h.w, l.w);
      *reinterpret_cast<uint4*>(&xh[core_at(r, 4 * kc, TC_KC)]) = h;
      *reinterpret_cast<uint4*>(&xh[PX * TC_BK + core_at(r, 4 * kc, TC_KC)]) = l;
    }
    fence_async_smem();
  };
  // Stage t's products run on the tensor cores while the threads split
  // stage t + 1's A; then their sums are folded.
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  split_stage(0);
  int fold_at = L;
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();  // stage t's split is in; every warp is done with stage t - 1 and its products
    if (t + STAGES - 1 < n_tiles) load_tile(t + STAGES - 1);
    cp_async_commit();
    const float* Bs = smem + (t % STAGES) * TL::STAGE_FLOATS + PX * TC_XP;
    const float* xh = xs + (t & 1) * 2 * PX * TC_BK;
    unsigned wh[TC_BK / 8][4], wl[TC_BK / 8][4];
#pragma unroll
    for (int e = 0; e < TC_BK / 8; ++e) {
      const float* p = Bs + (8 * e + q) * WP + cw;
      split_tf32(p[0], wh[e][0], wl[e][0]);
      split_tf32(p[8], wh[e][1], wl[e][1]);
      split_tf32(p[4 * WP], wh[e][2], wl[e][2]);
      split_tf32(p[4 * WP + 8], wh[e][3], wl[e][3]);
    }
    tc_issue<PX>(c, wh, wl, xh, xh + PX * TC_BK, TC_KC);
    if (t + 1 < n_tiles) {
      cp_async_wait<STAGES - 2>();  // stage t + 1 has landed (this thread's copies)
      __syncthreads();              // ... everyone's
      split_stage(t + 1);
    }
    wg_wait();
    wg_hold(c);
    wg_hold(wh);
    wg_hold(wl);
#pragma unroll
    for (int i = 0; i < ACC; ++i) s[i] = __fadd_rn(s[i], c[i]);
    if ((t + 1) * TC_BK >= fold_at || t == n_tiles - 1) {  // the end of a slice: fold s into the total
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        if constexpr (TL::TS) {
          float& x = ts[i * NT + tid];
          x = __fadd_rn(x, s[i]);
        } else {
          tot[i] = __fadd_rn(tot[i], s[i]);
        }
        s[i] = 0.0f;
      }
      fold_at += L;
    }
  }
  cp_async_wait<0>();

  // sum i of the thread: column cw + 8 ((i / 2) % 2), row 8 (i / 4) + 2q + i % 2
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int m = m0 + 8 * (i / 4) + 2 * q + (i & 1), n = n0 + cw + 8 * ((i >> 1) & 1);
    if (m < M && n < N) out[(int64_t)m * N + n] = ep(TL::TS ? ts[i * NT + tid] : tot[TL::TS ? 0 : i], n);
  }
}

template <class TL, class AL, bool VEC, class EP>
__global__ void __launch_bounds__(TL::NT, TL::MINB)
gemm_tc_kernel(const AL A, const float* __restrict__ b, float* __restrict__ out, int M, int K, int N,
               int L, int b_vec, const EP ep) {
  tc_tile<TL, AL, VEC>(A, b, out, M, K, N, L, b_vec, ep);
}

template <class TL, class AL, bool VEC, class EP>
int launch_tc(const AL& A, const float* B, float* O, int M, int K, int N, int L, int b_vec, const EP& ep,
              cudaStream_t st) {
  auto kern = gemm_tc_kernel<TL, AL, VEC, EP>;
  constexpr size_t smem = TL::SMEM + TL::PX * AL::ROW_BYTES;
  if (smem > 48 * 1024) {
    static bool raised = false;  // benign race: the attribute is idempotent
    if (!raised) {
      cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      raised = true;
    }
  }
  dim3 grid((M + TL::PX - 1) / TL::PX, (N + TL::CH - 1) / TL::CH);
  kern<<<grid, TL::NT, smem, st>>>(A, B, O, M, K, N, L, b_vec, ep);
  return static_cast<int>(cudaGetLastError());
}

// Order 1's tile variant (rows x columns): 128 x 128 where N > 64 and
// that grid is at least four blocks an SM (one fits), 64 x 128 where N >
// 64 and its grid fills the SMs once; else 64 x 64 where that grid is at
// least two blocks an SM, else 32 x 64.
int tc_shape(int M, int N) {
  if (N > 64 && tiles(M, N, 128, 128) >= 4 * SMS) return 0;
  if (N > 64 && tiles(M, N, 64, 128) >= SMS) return 1;
  if (tiles(M, N, 64, 64) >= 2 * SMS) return 2;
  return 3;
}

template <class AL, bool VEC, class EP>
int launch_tc_shape(int shape, const AL& A, const float* B, float* O, int M, int K, int N, int L, int b_vec,
                    const EP& ep, cudaStream_t st) {
  switch (shape) {
    case 0: return launch_tc<Tc0, AL, VEC>(A, B, O, M, K, N, L, b_vec, ep, st);
    case 1: return launch_tc<Tc1, AL, VEC>(A, B, O, M, K, N, L, b_vec, ep, st);
    case 2: return launch_tc<Tc2, AL, VEC>(A, B, O, M, K, N, L, b_vec, ep, st);
    case 3: return launch_tc<Tc3, AL, VEC>(A, B, O, M, K, N, L, b_vec, ep, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The conv in order 1: the fast walk where a stage's 32 k lie inside one
// filter tap, 16-byte copies where C % 4 == 0 and x is 16-byte aligned
int launch_conv_tc(int shape, const ImplicitA<false>& A, int x_vec, const float* B, float* O, int N, int L,
                   int b_vec, const BiasRelu& ep, cudaStream_t st) {
  if (x_vec && A.C % TC_BK == 0) {
    const ImplicitA<true> F{A.x, A.H, A.W, A.C, A.FW, A.stride, A.pad, A.OH, A.OW, A.M, A.K};
    return launch_tc_shape<ImplicitA<true>, true>(shape, F, B, O, A.M, A.K, N, L, b_vec, ep, st);
  }
  if (x_vec) return launch_tc_shape<ImplicitA<false>, true>(shape, A, B, O, A.M, A.K, N, L, b_vec, ep, st);
  return launch_tc_shape<ImplicitA<false>, false>(shape, A, B, O, A.M, A.K, N, L, b_vec, ep, st);
}

// A row-major A in order 1: 16-byte copies where A is 16-byte aligned (K
// % 16 == 0 keeps every row so)
template <class EP>
int launch_patch_tc(int shape, const float* A, int a_vec, const float* B, float* O, int M, int K, int N,
                    int L, int b_vec, const EP& ep, cudaStream_t st) {
  const PatchA P{A, M, K};
  if (a_vec) return launch_tc_shape<PatchA, true>(shape, P, B, O, M, K, N, L, b_vec, ep, st);
  return launch_tc_shape<PatchA, false>(shape, P, B, O, M, K, N, L, b_vec, ep, st);
}

__global__ void __launch_bounds__(SK_NT)
gemm_skinny_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ part, int M, int K, int N, int L,
                   int vec4, int a_vec4) {
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

  auto load_row = [&](int k, float* bw) {
    const float* br = b + (int64_t)k * N;
    if (vec4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(br + n));
      bw[0] = t.x; bw[1] = t.y; bw[2] = t.z; bw[3] = t.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) bw[j] = (n + j < N) ? __ldg(br + n + j) : 0.0f;
    }
  };
  auto fma_row = [&](int i, float av, const float* bw) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, bw[j], acc[i][j]);
  };

  int k = kb;
  for (; k + SK_U <= ke; k += SK_U) {  // SK_U independent weight loads, then their FMAs
    float bw[SK_U][4];
#pragma unroll
    for (int u = 0; u < SK_U; ++u) load_row(k + u, bw[u]);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i >= M) continue;
      float av[SK_U];
      const float* ar = a + (int64_t)i * K + k;
      if (a_vec4) {  // k and K are multiples of 4: aligned float4s of the row
#pragma unroll
        for (int u = 0; u < SK_U; u += 4) {
          const float4 t = __ldg(reinterpret_cast<const float4*>(ar + u));
          av[u] = t.x; av[u + 1] = t.y; av[u + 2] = t.z; av[u + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int u = 0; u < SK_U; ++u) av[u] = __ldg(ar + u);
      }
#pragma unroll
      for (int u = 0; u < SK_U; ++u) fma_row(i, av[u], bw[u]);
    }
  }
  for (; k < ke; ++k) {
    float bw[4];
    load_row(k, bw);
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if (i < M) fma_row(i, __ldg(a + (int64_t)i * K + k), bw);
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n + j < N) part[((int64_t)s * M + i) * N + n + j] = acc[i][j];
  }
}

// Order 1 at M <= MT: one warpgroup a 64 columns of one slice; the
// slice's A rows (M of 8, the rest zeros) split a chunk of TC_BK k at a
// time into core matrices in shared memory (two buffers), B's fragments
// read straight from device memory a chunk ahead and split in registers;
// the products those of the tiled kernel with 8 rows (m64n8k8).  The
// slice sum of its M rows goes to the partial.
constexpr int SKT_CH = 64;  // columns a block

__global__ void __launch_bounds__(128)
gemm_skinny_tc_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ part,
                      int M, int K, int N, int L) {
  __shared__ __align__(128) float xs[2][2][8 * TC_BK];  // [chunk parity][hi, lo][core matrices]
  const int s = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int c0 = blockIdx.x * SKT_CH + 16 * warp + g;  // this thread's columns c0, c0 + 8
  const bool c0_ok = c0 < N, c1_ok = c0 + 8 < N;
  const int kb = s * L, ke = min(K, kb + L);
  const int xr = tid >> 4, xk = (tid & 15) * 2;  // the thread's two values of each chunk of A
  const bool xr_ok = xr < M;
  const float* xa = a + (int64_t)(xr_ok ? xr : 0) * K + xk;
  const float* bw = b + (int64_t)q * N + c0;
  float wv[TC_BK / 8][4], xv[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int e = 0; e < TC_BK / 8; ++e) {
      const bool ok = k0 + 8 * e < ke;
      const float* p = bw + (int64_t)(k0 + 8 * e) * N;
      wv[e][0] = ok && c0_ok ? __ldg(p) : 0.0f;
      wv[e][1] = ok && c1_ok ? __ldg(p + 8) : 0.0f;
      wv[e][2] = ok && c0_ok ? __ldg(p + 4 * (int64_t)N) : 0.0f;
      wv[e][3] = ok && c1_ok ? __ldg(p + 4 * (int64_t)N + 8) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) xv[u] = xr_ok && k0 + xk + u < ke ? __ldg(xa + k0 + u) : 0.0f;
  };
  float c[4] = {0.0f, 0.0f, 0.0f, 0.0f}, sl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  fetch(kb);
  for (int k0 = kb, ch = 0; k0 < ke; k0 += TC_BK, ++ch) {
    float* xh = xs[ch & 1][0];
    float* xl = xs[ch & 1][1];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      unsigned h, l;
      split_tf32(xv[u], h, l);
      xh[core_at(xr, xk + u, TC_KC)] = __uint_as_float(h);
      xl[core_at(xr, xk + u, TC_KC)] = __uint_as_float(l);
    }
    unsigned wh[TC_BK / 8][4], wl[TC_BK / 8][4];
#pragma unroll
    for (int e = 0; e < TC_BK / 8; ++e)
#pragma unroll
      for (int r = 0; r < 4; ++r) split_tf32(wv[e][r], wh[e][r], wl[e][r]);
    if (k0 + TC_BK < ke) fetch(k0 + TC_BK);
    fence_async_smem();
    __syncthreads();
    tc_stage<8>(c, wh, wl, xh, xl, TC_KC);  // a chunk past ke multiplies zeros, as the tiled kernel does
#pragma unroll
    for (int i = 0; i < 4; ++i) sl[i] = __fadd_rn(sl[i], c[i]);
  }
  // sum i: column c0 + 8 (i / 2), row 2q + i % 2
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = 2 * q + (i & 1), n = c0 + 8 * (i >> 1);
    if (m < M && n < N) part[((int64_t)s * M + m) * N + n] = sl[i];
  }
}

// out = epi(sum of the S partials in slice order); S = 0 gives epi(0)
template <class EP>
__global__ void gemm_finish_kernel(const float* __restrict__ part, float* __restrict__ out,
                                   int64_t total, int N, int S, const EP ep) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float sum = 0.0f;
  for (int s = 0; s < S; ++s) sum = sum + part[(int64_t)s * total + idx];
  out[idx] = ep(sum, (int)(idx % N));
}

int aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// M <= MT: split-K partials (order 1 where ``tc``), then the ordered second
// pass with the epilogue
template <class EP>
int launch_skinny(bool tc, const float* A, const float* B, float* O, float* P, int M, int K, int N,
                  int L, const EP& ep, cudaStream_t st) {
  const int S = K > 0 ? (K + L - 1) / L : 0;
  if (S > 0 && tc) {
    dim3 grid1((N + SKT_CH - 1) / SKT_CH, S);
    gemm_skinny_tc_kernel<<<grid1, 128, 0, st>>>(A, B, P, M, K, N, L);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  } else if (S > 0) {
    // float4 weight loads need 16-byte aligned rows: N % 4 == 0 and an aligned base;
    // float4 activation loads K % 4 == 0 (slices start at multiples of 16)
    const int vec4 = (N % 4 == 0) && aligned16(B);
    const int a_vec4 = (K % 4 == 0) && aligned16(A);
    dim3 grid1((N + SK_COLS - 1) / SK_COLS, S);
    gemm_skinny_kernel<<<grid1, SK_NT, 0, st>>>(A, B, P, M, K, N, L, vec4, a_vec4);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t total = (int64_t)M * N;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads);
  gemm_finish_kernel<<<blocks, threads, 0, st>>>(P, O, total, N, S, ep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rows per K slice, a multiple of 16 (of 32 in order 1, so that a slice
// ends where a stage of the tiled kernel does); depends on (K, N) only.
// Enough slices that the skinny kernel has about four blocks per SM, each
// slice at least 64 rows long (128 in order 1).
extern "C" int gemm_slice_len(int K, int N) {
  const int col_blocks = (N + SK_COLS - 1) / SK_COLS;
  int s = (TARGET_BLOCKS + col_blocks - 1) / col_blocks;
  const int min_l = tc_order(K) ? TC_MIN_L : 64;
  const int max_s = K / min_l > 1 ? K / min_l : 1;
  if (s > max_s) s = max_s;
  const int step = tc_order(K) ? TC_BK : SLICE_STEP;
  int L = (K + s - 1) / s;
  L = (L + step - 1) / step * step;
  return L < step ? step : L;
}

// The largest M the skinny path takes; the wrapper sizes its partial
// buffer [ceil(K / L), M, N] for M up to this.
extern "C" int gemm_skinny_max_m() { return MT; }

// How many tile variants the tiled kernels have (the ``shape`` arguments
// below run 0 .. gemm_tile_variants() - 1), in each order.  Each variant
// sums every output in its order, so all give the same bits (chip_smoke.py
// holds them to each other).
extern "C" int gemm_tile_variants() { return N_TILES; }

// The order every output of a [*, K] @ [K, N] product is summed in: 0 on
// the CUDA cores, 1 on the tensor cores (K % 16 == 0 and K >= 64; N does
// not enter).  Every entry below, at every M, takes it.
extern "C" int gemm_order(int K, int N) {
  (void)N;
  return tc_order(K) ? 1 : 0;
}

// split_tf32 on the device, x [n] -> hi [n], lo [n] (as f32 bit
// patterns): for checks that the kernels' split is the one gemm.py's
// plain version states.
__global__ void split_tf32_kernel(const float* __restrict__ x, float* __restrict__ hi,
                                  float* __restrict__ lo, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  unsigned h, l;
  split_tf32(x[i], h, l);
  hi[i] = __uint_as_float(h);
  lo[i] = __uint_as_float(l);
}
extern "C" int gemm_split_tf32(const void* x, void* hi, void* lo, int n, void* stream) {
  if (n <= 0) return 0;
  split_tf32_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(hi), static_cast<float*>(lo), n);
  return static_cast<int>(cudaGetLastError());
}

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
  const int b_vec = (N % 4 == 0) && aligned16(b);
  const bool tc = tc_order(K);
  if (M > MT && tc) {
    return launch_patch_tc(tc_shape(M, N), A, aligned16(a), B, O, M, K, N, L, b_vec, NoEpi{}, st);
  }
  if (M > MT) return launch_shape(tiled_shape(M, K, N), PatchA{A, M, K}, B, O, M, K, N, L, b_vec, NoEpi{}, st);
  return launch_skinny(tc, A, B, O, static_cast<float*>(part), M, K, N, L, NoEpi{}, st);
}

// The tiled path forced onto tile variant ``shape``, any M >= 1.
extern "C" int gemm_f32_tiled(const void* a, const void* b, void* out, int M, int K, int N,
                              int shape, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  float* O = static_cast<float*>(out);
  const int L = gemm_slice_len(K, N), b_vec = (N % 4 == 0) && aligned16(b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc_order(K)) return launch_patch_tc(shape, A, aligned16(a), B, O, M, K, N, L, b_vec, NoEpi{}, st);
  return launch_shape(shape, PatchA{A, M, K}, B, O, M, K, N, L, b_vec, NoEpi{}, st);
}

// The fc GEMM with its epilogue: out = relu?(a @ w + bias).  a [M,K], w
// [K,N], bias [N], out [M,N], part as for gemm_f32; all f32, contiguous,
// on the device.  The same paths and bits as gemm_f32, then "+ bias".
extern "C" int matmul_fused_f32(const void* a, const void* w, const void* bias, void* out,
                                void* part, int M, int K, int N, int relu, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int L = gemm_slice_len(K, N);
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(w);
  float* O = static_cast<float*>(out);
  const BiasRelu ep{static_cast<const float*>(bias), relu};
  const int b_vec = (N % 4 == 0) && aligned16(w);
  const bool tc = tc_order(K);
  if (M > MT && tc) return launch_patch_tc(tc_shape(M, N), A, aligned16(a), B, O, M, K, N, L, b_vec, ep, st);
  if (M > MT) return launch_shape(tiled_shape(M, K, N), PatchA{A, M, K}, B, O, M, K, N, L, b_vec, ep, st);
  return launch_skinny(tc, A, B, O, static_cast<float*>(part), M, K, N, L, ep, st);
}

// The fused conv: y = relu?(conv(x, w) + bias), x [B,H,W,C], w
// [FH,FW,C,Cout], bias [Cout], y [B,OH,OW,Cout]; all f32, contiguous, on
// the device.  ``shape`` < 0 picks the tile variant from (M, K, N) =
// (B*OH*OW, FH*FW*C, Cout) (conv_shape in order 0, tc_shape in order 1);
// 0 .. gemm_tile_variants() - 1 forces one (checks).  The bits of
// gemm_f32 on B4's patch matrix, then "+ bias".  Launches on ``stream``
// and returns cudaGetLastError().
extern "C" int conv_fused_f32(const void* x, const void* w, const void* bias, void* y, int B,
                              int H, int W, int C, int FH, int FW, int Cout, int stride,
                              int pad, int OH, int OW, int relu, int shape, void* stream) {
  const int64_t M64 = (int64_t)B * OH * OW;
  if (M64 <= 0 || Cout <= 0) return 0;
  if (M64 > INT32_MAX || (int64_t)FH * FW * C > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int M = static_cast<int>(M64), K = FH * FW * C, N = Cout;
  const ImplicitA<false> A{static_cast<const float*>(x), H, W, C, FW, stride, pad, OH, OW, M, K};
  const float* Wt = static_cast<const float*>(w);
  float* Y = static_cast<float*>(y);
  const BiasRelu ep{static_cast<const float*>(bias), relu};
  const int L = gemm_slice_len(K, N);
  const int b_vec = (N % 4 == 0) && aligned16(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc_order(K)) {
    return launch_conv_tc(shape < 0 ? tc_shape(M, N) : shape, A, (C % 4 == 0) && aligned16(x), Wt, Y, N, L,
                          b_vec, ep, st);
  }
  switch (shape < 0 ? conv_shape(M, K, N) : shape) {
    case 0: return launch_conv<Tile0>(A, Wt, Y, N, L, b_vec, ep, st);
    case 1: return launch_conv<Tile1>(A, Wt, Y, N, L, b_vec, ep, st);
    case 2: return launch_conv<Tile2>(A, Wt, Y, N, L, b_vec, ep, st);
    case 3: return launch_conv<Tile3>(A, Wt, Y, N, L, b_vec, ep, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
