// flash_decode: one-token GQA attention over a KV cache under an int32
// validity mask, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py
// (flash_decode / _decode_kernel). Semantics are those of
// src/repro/kernels/ref.py::decode_ref: scores scaled by 1/sqrt(hd), an
// invalid slot scores the finite -1e30 (so a row with no valid slot
// returns the mean of v, never NaN), output divided by max(l, 1e-30).
//
// Bound on the card: bytes. Every K and V row of the cache is read once
// (2*B*W*Kh*hd elements) against ~4*B*H*W*hd flops, about one flop per
// byte, far below the H100's ~295 flop/byte ridge.
//
// Design: split-K, the GPU shape the TPU kernel dropped (its KV split is
// a sequential grid dimension carrying (acc, m, l) in VMEM). A decode
// step has only B*Kh (batch row, KV head) pairs, 24 at batch 8 for
// smollm, far fewer than the 132 SMs, so the cache is cut along W into
// TILE-key splits and every (pair, split) gets its own block:
//   1. decode_partial: one block per (b, kv head, split) serves the g
//      query heads of that KV head, so each K/V row crosses from device
//      memory once. The split's K/V rows are staged in shared memory as
//      f32 with 16-byte vector loads; each thread scores (head, key)
//      pairs; warp w owns query heads w, w+4, ... and writes their
//      split-local softmax state (max m, sum l, unnormalised acc).
//   2. decode_merge: one block per (b, query head) merges the splits'
//      states with the log-sum-exp rule into the output.
// Any W works: keys past W score -inf and weigh nothing, while in-range
// invalid keys keep the reference's -1e30, so a split (or a whole row)
// with no valid key merges to exactly the reference's uniform weights.
// K and V are read through element strides (last dim contiguous): the
// model's (B, W, Kh, hd) cache goes in as a permuted view, never copied.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;      // keys per split (one shared-memory tile)
constexpr int THREADS = 128;  // 4 warps
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_G = 16;     // query heads per KV head
constexpr int HEADS_PER_WARP = (MAX_G + NWARPS - 1) / NWARPS;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* valid;
  void* out;
  float* part_ml;    // [B*Kh*nsplit][g][2]: split-local max, sum
  float* part_acc;   // [B*Kh*nsplit][g][hd]: split-local unnormalised P.V
  int Kh, W, g, nsplit;
  long long qsb, qsh, ksb, ksh, ksw, vsb, vsh, vsw, valsb, osb, osh;
  float sm_scale;
};

// Stage rows [w0, w0 + n) of one K or V head into shared memory as f32.
template <typename T, int HD, bool VEC>
__device__ __forceinline__ void stage(float* dst, int dst_stride,
                                      const T* src, long long sw, int n) {
  if constexpr (VEC) {
    constexpr int PER = 16 / sizeof(T);       // elements per 16-byte load
    constexpr int CHUNKS = HD / PER;
    for (int e = threadIdx.x; e < TILE * CHUNKS; e += THREADS) {
      const int j = e / CHUNKS, c = e % CHUNKS;
      float* d = dst + j * dst_stride + c * PER;
      if (j < n) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src + j * sw + c * PER);
        const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < PER; ++i) d[i] = to_f32(x[i]);
      } else {
#pragma unroll
        for (int i = 0; i < PER; ++i) d[i] = 0.f;
      }
    }
  } else {
    for (int e = threadIdx.x; e < TILE * HD; e += THREADS) {
      const int j = e / HD, d = e % HD;
      dst[j * dst_stride + d] = j < n ? to_f32(src[j * sw + d]) : 0.f;
    }
  }
}

template <typename T, int HD, bool VEC>
__global__ void __launch_bounds__(THREADS) decode_partial(Args a) {
  constexpr int KST = HD + 1;                // padded K row: no bank conflicts
  constexpr int DPL = (HD + 31) / 32;        // output dims per lane
  extern __shared__ float smem[];
  const int g = a.g;
  float* q_s = smem;                         // [g][HD]
  float* k_s = q_s + g * HD;                 // [TILE][HD + 1]
  float* v_s = k_s + TILE * KST;             // [TILE][HD]
  float* p_s = v_s + TILE * HD;              // [g][TILE]

  const int pair = blockIdx.x;               // b * Kh + kh
  const int split = blockIdx.y;
  const int b = pair / a.Kh, kh = pair % a.Kh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int w0 = split * TILE;
  const int n = min(TILE, a.W - w0);

  const T* q = static_cast<const T*>(a.q) + b * a.qsb;
  for (int e = tid; e < g * HD; e += THREADS)
    q_s[e] = to_f32(q[(kh * g + e / HD) * a.qsh + e % HD]);
  stage<T, HD, VEC>(k_s, KST, static_cast<const T*>(a.k) + b * a.ksb + kh * a.ksh
                    + w0 * a.ksw, a.ksw, n);
  stage<T, HD, VEC>(v_s, HD, static_cast<const T*>(a.v) + b * a.vsb + kh * a.vsh
                    + w0 * a.vsw, a.vsw, n);
  __syncthreads();

  const int* valid = a.valid + b * a.valsb + w0;
  for (int e = tid; e < g * TILE; e += THREADS) {
    const int h = e / TILE, j = e % TILE;
    float s = -INFINITY;                      // past W: weighs nothing
    if (j < n) {
      const float* qr = q_s + h * HD;
      const float* kr = k_s + j * KST;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
      s = valid[j] > 0 ? dot * a.sm_scale : NEG_INF;
    }
    p_s[h * TILE + j] = s;
  }
  __syncthreads();

  const long long base = (long long)pair * a.nsplit + split;
#pragma unroll
  for (int i = 0; i < HEADS_PER_WARP; ++i) {
    const int h = warp + i * NWARPS;
    if (h >= g) break;
    float* pr = p_s + h * TILE;
    float m = -INFINITY;
    for (int j = lane; j < TILE; j += 32) m = fmaxf(m, pr[j]);
    m = warp_max(m);                          // finite: n >= 1 in-range key
    float l = 0.f;
    for (int j = lane; j < TILE; j += 32) {
      const float p = expf(pr[j] - m);
      pr[j] = p;
      l += p;
    }
    l = warp_sum(l);
    __syncwarp();
    float* acc = a.part_acc + (base * g + h) * HD;
#pragma unroll
    for (int jj = 0; jj < DPL; ++jj) {
      const int d = lane + 32 * jj;
      if (d < HD) {
        float o = 0.f;
        for (int j = 0; j < n; ++j) o = fmaf(pr[j], v_s[j * HD + d], o);
        acc[d] = o;
      }
    }
    if (lane == 0) {
      a.part_ml[(base * g + h) * 2] = m;
      a.part_ml[(base * g + h) * 2 + 1] = l;
    }
  }
}

template <typename T, int HD>
__global__ void decode_merge(Args a) {
  const int H = a.Kh * a.g;
  const int b = blockIdx.x / H, hq = blockIdx.x % H;
  const int kh = hq / a.g, h = hq % a.g;
  const int d = threadIdx.x;
  const long long base = (long long)(b * a.Kh + kh) * a.nsplit;
  float M = -INFINITY;
  for (int s = 0; s < a.nsplit; ++s)
    M = fmaxf(M, a.part_ml[((base + s) * a.g + h) * 2]);
  float L = 0.f, O = 0.f;
  for (int s = 0; s < a.nsplit; ++s) {
    const long long idx = (base + s) * a.g + h;
    const float w = expf(a.part_ml[idx * 2] - M);
    L = fmaf(a.part_ml[idx * 2 + 1], w, L);
    O = fmaf(a.part_acc[idx * HD + d], w, O);
  }
  from_f32(static_cast<T*>(a.out) + b * a.osb + hq * a.osh + d,
           O / fmaxf(L, 1e-30f));
}

template <typename T, int HD>
int launch_hd(Args a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (size_t)(a.g * HD + TILE * (HD + 1) + TILE * HD + a.g * TILE);
  constexpr long long PER = 16 / sizeof(T);
  const bool vec = HD % PER == 0 && a.ksw % PER == 0 && a.ksb % PER == 0 &&
                   a.ksh % PER == 0 && a.vsw % PER == 0 && a.vsb % PER == 0 &&
                   a.vsh % PER == 0 && reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.v) % 16 == 0;
  auto kernel = vec ? decode_partial<T, HD, true> : decode_partial<T, HD, false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(B * a.Kh, a.nsplit), THREADS, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_merge<T, HD><<<B * a.Kh * a.g, HD, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(Args a, int B, int H, int hd, cudaStream_t stream) {
  if (B <= 0 || a.Kh <= 0 || H % a.Kh != 0 || H / a.Kh > MAX_G || a.W <= 0 ||
      a.nsplit != (a.W + TILE - 1) / TILE)
    return (int)cudaErrorInvalidValue;
  a.g = H / a.Kh;
  switch (hd) {
    case 16: return launch_hd<T, 16>(a, B, stream);
    case 32: return launch_hd<T, 32>(a, B, stream);
    case 64: return launch_hd<T, 64>(a, B, stream);
    case 128: return launch_hd<T, 128>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_decode_splits(int W) { return (W + TILE - 1) / TILE; }

// part_ml: B*Kh*splits*g*2 floats, part_acc: B*Kh*splits*g*hd floats
// (splits = flash_decode_splits(W)), scratch the caller allocates.
#define DECODE_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const void* q, const void* k, const void* v,            \
                      const int* valid, void* out, float* part_ml,            \
                      float* part_acc, int B, int H, int Kh, int W, int hd,   \
                      long long qsb, long long qsh, long long ksb,            \
                      long long ksh, long long ksw, long long vsb,            \
                      long long vsh, long long vsw, long long valsb,          \
                      long long osb, long long osh, float sm_scale,           \
                      void* stream) {                                         \
    Args a{q, k, v, valid, out, part_ml, part_acc, Kh, W, 0,                  \
           flash_decode_splits(W), qsb, qsh, ksb, ksh, ksw, vsb, vsh, vsw,    \
           valsb, osb, osh, sm_scale};                                        \
    return launch<T>(a, B, H, hd, (cudaStream_t)stream);                      \
  }

DECODE_ENTRY(flash_decode_f32, float)
DECODE_ENTRY(flash_decode_bf16, __nv_bfloat16)
