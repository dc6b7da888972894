// Decode attention: one new query token per sequence against its KV
// cache, with an online softmax over tiles of cache slots.
//
// Replaces the Pallas kernel repro/kernels/flash_decode.py::_flash_decode_kernel
// (entry point flash_decode), which handles one KV head (q [G, D], k/v
// [S, D], a valid prefix ``length``) and is vmapped over (batch, KV head).
// Here (batch, KV head) are the grid: one block per pair, one launch per
// layer per decode step.  The block walks the valid prefix in tiles of
// TILE slots and carries the running max m, normaliser l and accumulator
// acc across tiles, as the TPU kernel carries them in VMEM scratch across
// its sequential grid.  Operands are read as f32 (bf16 or f32 in memory),
// the scale is applied after the dot, the softmax weights stay f32 for the
// PV product, and the output is acc / max(l, 1e-30) cast to q's type.
// Slots at or beyond ``length`` would get -1e30 and weigh exp(-1e30 - m)
// = 0, so the block does not read them at all.
//
// What bounds it on an H100: bytes.  Each cache element is read once and
// feeds G multiply-adds (G = 5 for Hymba), far below the ~20 f32 FLOP a
// byte at which the CUDA cores would be the limit.  At the served shape
// (batch 4, 5 KV heads) the grid is only 20 blocks on 132 SMs, so this
// one-pass version is bound by the latency of each block's tile loop, not
// by the card's bandwidth: splitting the prefix over more blocks
// (split-KV) is the later fix.
//
// Design: 256 threads per block.  A tile of K and V rows is loaded with
// 16-byte vector loads (coalesced along D: consecutive threads read
// consecutive pieces of a row) into registers, stored to shared memory as
// f32, and the next tile's loads are issued before this tile's arithmetic
// so their latency overlaps it.  Logits: one (g, slot) pair per thread
// step, the K tile padded to D + 1 floats a row so a warp's lanes read 32
// rows without bank conflicts.  Softmax: one warp per query row, shuffles
// for the max and sum.  PV: one (g, d) pair per thread step, accumulators
// in registers for the whole sweep.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int WARPS = NT / 32;
constexpr int TILE = 64;           // cache slots per tile
constexpr int MAX_D = 128;         // head_dim the prefetch registers hold
constexpr int MAX_GD = 2048;       // G * D: accumulators held in registers
constexpr int ACC = MAX_GD / NT;   // accumulators per thread
constexpr int PF = TILE * MAX_D / 4 / NT;  // 16-byte vectors per thread per tile (f32 worst case)
constexpr float NEG = -1e30f;
static_assert(TILE == 64, "the softmax step gives each lane two slots of a tile");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// q [B, Hkv, G, D], k/v [B, W, Hkv, D], out [B, Hkv, G, D], all contiguous.
template <typename T>
__global__ void __launch_bounds__(NT)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out, int hkv,
                    int G, int D, int W, int length, float scale) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* qs = smem;              // [G][D]
  float* ks = qs + G * D;        // [TILE][D + 1]
  float* vs = ks + TILE * DP;    // [TILE][D]
  float* ps = vs + TILE * D;     // [G][TILE] logits, then weights
  float* ms = ps + G * TILE;     // [G] running max
  float* ls = ms + G;            // [G] running normaliser
  float* al = ls + G;            // [G] this tile's rescale exp(m_prev - m_new)

  constexpr int VN = Vec<T>::N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  const int64_t slot_stride = (int64_t)hkv * D;
  const int64_t base = ((int64_t)b * W * hkv + h) * D;  // slot 0 of (b, h)
  const T* qb = q + ((int64_t)b * hkv + h) * G * D;
  T* ob = out + ((int64_t)b * hkv + h) * G * D;
  const int vrow = D / VN;  // vectors per cache row

  for (int i = tid; i < G * D; i += NT) qs[i] = to_f(qb[i]);
  for (int g = tid; g < G; g += NT) {
    ms[g] = NEG;
    ls[g] = 0.0f;
  }
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.0f;

  uint4 kr[PF], vr[PF];
  auto load_tile = [&](int s0) {
    const int n_vec = min(TILE, length - s0) * vrow;
#pragma unroll
    for (int j = 0; j < PF; ++j) {
      const int idx = tid + j * NT;
      if (idx < n_vec) {
        const int64_t off = base + (int64_t)(s0 + idx / vrow) * slot_stride + (idx % vrow) * VN;
        kr[j] = __ldg(reinterpret_cast<const uint4*>(k + off));
        vr[j] = __ldg(reinterpret_cast<const uint4*>(v + off));
      }
    }
  };

  load_tile(0);
  for (int s0 = 0; s0 < length; s0 += TILE) {
    const int n = min(TILE, length - s0);
    // registers -> shared memory as f32
#pragma unroll
    for (int j = 0; j < PF; ++j) {
      const int idx = tid + j * NT;
      if (idx < n * vrow) {
        const int r = idx / vrow, c = (idx % vrow) * VN;
        float f[VN];
        Vec<T>::unpack(kr[j], f);
#pragma unroll
        for (int e = 0; e < VN; ++e) ks[r * DP + c + e] = f[e];
        Vec<T>::unpack(vr[j], f);
#pragma unroll
        for (int e = 0; e < VN; ++e) vs[r * D + c + e] = f[e];
      }
    }
    __syncthreads();
    if (s0 + TILE < length) load_tile(s0 + TILE);  // in flight during this tile

    // logits [G, TILE] = (q . k) * scale, -1e30 past the valid prefix
    for (int idx = tid; idx < G * TILE; idx += NT) {
      const int g = idx / TILE, j = idx % TILE;
      float lg = NEG;
      if (j < n) {
        const float* qr = qs + g * D;
        const float* kr_s = ks + j * DP;
        float dot = 0.0f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr_s[d], dot);
        lg = dot * scale;
      }
      ps[idx] = lg;
    }
    __syncthreads();

    // online softmax, one warp per query row
    for (int g = warp; g < G; g += WARPS) {
      float* pr = ps + g * TILE;
      const float x0 = pr[lane], x1 = pr[lane + 32];
      const float m_prev = ms[g];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      const float tile_sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        ls[g] = ls[g] * alpha + tile_sum;
        ms[g] = m_new;
        al[g] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int idx = tid + i * NT;
      if (idx < G * D) {
        const int g = idx / D, d = idx % D;
        const float* pr = ps + g * TILE;
        float pv = 0.0f;
        for (int j = 0; j < n; ++j) pv = fmaf(pr[j], vs[j * D + d], pv);
        acc[i] = acc[i] * al[g] + pv;
      }
    }
    __syncthreads();  // the next tile overwrites ks, vs and ps
  }

#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int idx = tid + i * NT;
    if (idx < G * D) ob[idx] = from_f<T>(acc[i] / fmaxf(ls[idx / D], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int hkv,
           int G, int D, int W, int length, float scale, cudaStream_t stream) {
  const size_t floats = (size_t)G * D + (size_t)TILE * (D + 1) + (size_t)TILE * D +
                        (size_t)G * TILE + 3 * (size_t)G;
  const size_t bytes = floats * sizeof(float);
  auto kern = flash_decode_kernel<T>;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(hkv, B), NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), hkv, G, D, W, length, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Largest G * D and D the kernel takes (the wrapper checks before calling).
extern "C" int flash_decode_max_gd() { return MAX_GD; }
extern "C" int flash_decode_max_d() { return MAX_D; }

// q [B, Hkv, G, D], k/v [B, W, Hkv, D], out [B, Hkv, G, D], contiguous and
// 16-byte aligned, all f32 (bf16 = 0) or all bf16 (bf16 = 1).  Attends over
// slots [0, length), 1 <= length <= W.  Launches on ``stream`` and returns
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v, void* out,
                                int bf16, int B, int hkv, int G, int D, int W,
                                int length, float scale, void* stream) {
  const int vn = bf16 ? 8 : 4;
  if (B < 1 || hkv < 1 || G < 1 || D < vn || D % vn != 0 || D > MAX_D ||
      G * D > MAX_GD || length < 1 || length > W)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, out, B, hkv, G, D, W, length, scale, s);
  return launch<float>(q, k, v, out, B, hkv, G, D, W, length, scale, s);
}
