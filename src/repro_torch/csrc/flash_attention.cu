// flash_attention (forward): blockwise causal GQA attention with online
// softmax, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _attn_kernel), which the reference model reaches
// through its pure-jnp mirror models/attention.py::_flash_mha.
// Semantics: sm_scale = 1/sqrt(hd); head h reads KV head h / (H/Kh);
// causal and sliding-window masks on indices (kpos <= qpos,
// qpos - kpos < window) with the finite -1e30; output divided by
// max(l, 1e-30).
//
// Bound on the card: at the prefill shapes of the serving path
// (S <= 1024, hd = 64) the work is ~2*B*H*S^2*hd flops against
// ~2*B*S*(H+2*Kh)*hd*bytes of q, k, v and o: well above the ridge, so
// operations bound it. This first version computes on the CUDA cores in
// f32 (no mma.sync / wgmma / TMA yet) and so runs far below the tensor
// core peak; its time stands in PERF.md beside that bound.
//
// Design: one block of 128 threads per (q tile of 64 rows, head, batch
// row). The TPU kernel's sequential KV grid dimension becomes a loop
// inside the block over 64-key tiles staged in shared memory as f32
// (padded rows, no bank conflicts). Each thread owns a 4 x 8 patch of
// the 64 x 64 score tile and the same 4 rows of the output accumulator,
// so the online-softmax row statistics (m, l) are reduced with three
// shuffles inside a group of 8 lanes and never leave registers. KV tiles
// that the causal mask (or the sliding window) hides from every row of
// the q tile are skipped; this is exact, since each row keeps its
// diagonal key. Ragged tails are masked, not asserted: a key past Sk
// scores -inf (weighs nothing), a query row past Sq is never stored,
// so Sq = 1, 7 or 100 work. q, k, v and o are addressed through element
// strides of their three outer dims (last dim contiguous), so the
// model's (B, S, H, hd) projections go in as transposed views, uncopied.
// For training, the kernel also writes each row's log-sum-exp
// m + log(l) (f32, (B, H, Sq) contiguous) beside the output, which
// flash_attention_bwd.cu reads to recompute P without the (Sq, Sk)
// matrix; the serving path passes a null pointer and writes none.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;   // 16 row groups x 8 lanes
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Strides {
  long long b, h, s;
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ out,
            float* __restrict__ lse, int H, int Kh,
            int Sq, int Sk, Strides qs, Strides ks, Strides vs, Strides os,
            float sm_scale, int causal, int window) {
  constexpr int QST = HD + 1;     // padded rows of Qs / Ks
  constexpr int PST = BK + 1;     // padded rows of Ps
  constexpr int DJ = HD / 8;      // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;               // [BQ][HD + 1]
  float* Ks = Qs + BQ * QST;      // [BK][HD + 1]
  float* Vs = Ks + BK * QST;      // [BK][HD]
  float* Ps = Vs + BK * HD;       // [BQ][BK + 1]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / Kh);
  const int tid = threadIdx.x;
  const int ty = tid / 8;         // rows ty*4 .. ty*4+3
  const int tx = tid % 8;         // score columns tx + 8j, output dims tx + 8jj

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;

  for (int e = tid; e < BQ * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    Qs[r * QST + d] = q0 + r < Sq ? to_f32(qb[(long long)(q0 + r) * qs.s + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  }

  // KV tiles that can hold a visible key for some row of this q tile
  int kt_end = (Sk + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, (min(q0 + BQ, Sq) - 1) / BK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();              // previous tile consumed, Qs written
    for (int e = tid; e < BK * HD; e += THREADS) {
      const int j = e / HD, d = e % HD;
      float kx = 0.f, vx = 0.f;
      if (k0 + j < Sk) {
        kx = to_f32(kb[(long long)(k0 + j) * ks.s + d]);
        vx = to_f32(vb[(long long)(k0 + j) * vs.s + d]);
      }
      Ks[j * QST + d] = kx;
      Vs[j * HD + d] = vx;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[4], bb[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * QST + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) bb[j] = Ks[(tx + 8 * j) * QST + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + tx + 8 * j;
        float x;
        if (kpos >= Sk) {
          x = -INFINITY;            // ragged tail: not a key at all
        } else {
          bool ok = !causal || kpos <= qpos;
          if (window > 0) ok = ok && (qpos - kpos < window);
          x = ok ? s[i][j] * sm_scale : NEG_INF;
        }
        s[i][j] = x;
        tmax = fmaxf(tmax, x);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 4));
      const float m_new = fmaxf(m[i], tmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * PST + tx + 8 * j] = p;
        rsum += p;
      }
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 4);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncwarp();                 // a row's P is written by its own 8 lanes

    const int kn = min(BK, Sk - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float vv[DJ];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) vv[jj] = Vs[kk * HD + tx + 8 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty * 4 + i) * PST + kk];
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = fmaf(p, vv[jj], acc[i][jj]);
      }
    }
  }

  T* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      from_f32(ob + (long long)r * os.s + tx + 8 * jj, acc[i][jj] * inv);
    if (lse != nullptr && tx == 0)
      lse[((long long)b * H + h) * Sq + r] = m[i] + logf(l[i]);
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out,
              float* lse, int B,
              int H, int Kh, int Sq, int Sk, Strides qs, Strides ks,
              Strides vs, Strides os, float sm_scale, int causal, int window,
              cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t)(BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  attn_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, H, Kh, Sq, Sk, qs, ks,
      vs, os, sm_scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B,
           int H, int Kh, int Sq, int Sk, int hd, const long long* st,
           float sm_scale, int causal, int window, cudaStream_t stream) {
  if (B <= 0 || Kh <= 0 || H % Kh != 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  switch (hd) {
    case 16:
      return launch_hd<T, 16>(q, k, v, out, lse, B, H, Kh, Sq, Sk, qs, ks, vs, os, sm_scale, causal, window, stream);
    case 32:
      return launch_hd<T, 32>(q, k, v, out, lse, B, H, Kh, Sq, Sk, qs, ks, vs, os, sm_scale, causal, window, stream);
    case 64:
      return launch_hd<T, 64>(q, k, v, out, lse, B, H, Kh, Sq, Sk, qs, ks, vs, os, sm_scale, causal, window, stream);
    case 128:
      return launch_hd<T, 128>(q, k, v, out, lse, B, H, Kh, Sq, Sk, qs, ks, vs, os, sm_scale, causal, window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 int64 element strides, (batch, head, seq) for q, k, v, out;
// lse: (B, H, Sq) f32 contiguous, or null
#define ATTN_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* out, \
                      float* lse, int B, int H, int Kh, int Sq, int Sk,       \
                      int hd, const long long* strides, float sm_scale,       \
                      int causal, int window, void* stream) {                 \
    return launch<T>(q, k, v, out, lse, B, H, Kh, Sq, Sk, hd, strides,        \
                     sm_scale, causal, window, (cudaStream_t)stream);         \
  }

ATTN_ENTRY(flash_attention_f32, float)
ATTN_ENTRY(flash_attention_bf16, __nv_bfloat16)
