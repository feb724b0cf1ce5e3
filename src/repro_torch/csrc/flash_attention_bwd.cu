// flash_attention_bwd: the gradient of causal GQA flash attention
// (dq, dk, dv), for Hopper (sm_90a).
//
// Replaces no Pallas kernel one for one: the TPU kernel
// src/repro/kernels/flash_attention.py (_attn_kernel) is forward-only,
// and the reference differentiates its pure-jnp mirror
// models/attention.py::_flash_mha, whose checkpointed chunk body
// (attention.py:133-137) recomputes each (Sq, chunk) score tile in the
// backward instead of storing the (Sq, Sk) matrix. This kernel keeps
// that property: P = exp(s * sm_scale - lse) is recomputed tile by tile
// from the forward kernel's saved per-row log-sum-exp, never stored.
// Semantics follow the forward: head h reads KV head h / (H/Kh); causal
// and sliding-window masks on indices with the finite -1e30 for a
// masked in-range key (its P is exp(-1e30 - lse) = 0), keys past Sk and
// query rows past Sq weigh nothing, so ragged Sq/Sk work; the forward's
// division by max(l, 1e-30) is folded into lse (l >= 1 for any row with
// a visible key, which every causal row has: its diagonal).
//
// Bound on the card: the backward does five (S x S x hd) products where
// the forward does two (S = Q K^T and dP = dO V^T recomputed, then
// dV = P^T dO, dK = dS^T Q, dQ = dS K): about 2.5x the forward's causal
// flops against q, k, v, o, dO read once and dq, dk, dv written once,
// far above the ridge, so operations bound it (989 TFLOP/s bf16). This
// first version runs f32 on the CUDA cores, as the forward does, and so
// sits far above that bound; mma.sync / wgmma is later work.
//
// Design: three launches, no atomics, deterministic.
//  1. bwd_dot: D = rowsum(dO * O), one warp per (b, h, row).
//  2. bwd_dkdv: one block per (b, KV head, 64-key tile). It loops over
//     the g query heads of its group and over the q tiles that can see
//     the key tile (causal: q tiles at or after it; window: those within
//     window of its last key), accumulating dK and dV in f32 registers,
//     so GQA's sum over the group's heads needs no atomics.
//  3. bwd_dq: one block per (b, head, 64-query tile), looping over the
//     key tiles the forward visits, accumulating dQ in registers.
// 256 threads; each owns a 4 x 4 patch of the 64 x 64 score tile (rows
// ty*4.., columns tx + 16j) and 4 rows x hd/16 columns of its output
// accumulator. Tiles are staged in shared memory as f32 with padded rows
// (no bank conflicts on the column walks). q, k, v, o, dO, dq, dk, dv are
// addressed through element strides of their three outer dims (last dim
// contiguous), so the model's transposed (B, S, H, hd) views go in and
// the gradients come out in the layout of the inputs, uncopied.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;   // 16 row groups x 16 lanes
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

struct Args {
  int B, H, Kh, Sq, Sk;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  float sm_scale;
  int causal, window;
};

// D[(b*H + h)*Sq + i] = sum_d dO[b,h,i,d] * O[b,h,i,d]; one warp per row
template <typename T>
__global__ void bwd_dot(const T* __restrict__ o, const T* __restrict__ dout,
                        float* __restrict__ D, int hd, Args a) {
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)a.B * a.H * a.Sq) return;     // warp-uniform
  const int i = (int)(row % a.Sq);
  const int h = (int)((row / a.Sq) % a.H);
  const int b = (int)(row / ((long long)a.Sq * a.H));
  const T* op = o + b * a.os.b + h * a.os.h + (long long)i * a.os.s;
  const T* dp = dout + b * a.dos.b + h * a.dos.h + (long long)i * a.dos.s;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc += to_f32(op[d]) * to_f32(dp[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) D[row] = acc;
}

// rows [r0, r0 + 64) of a (seq, hd) slice into a padded f32 tile; rows
// past n are zero
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int r0, int n) {
  for (int e = threadIdx.x; e < 64 * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    dst[r * (HD + 1) + d] =
        r0 + r < n ? to_f32(src[(long long)(r0 + r) * stride + d]) : 0.f;
  }
}

// For the thread's 4 q rows x 4 key columns of the (q0, k0) tile pair:
// P = exp(s * scale - lse) (0 where masked or out of range) and
// dS = P * (dP - D). Qs/dOs are [BQ][HD+1], Ks/Vs [BK][HD+1].
template <int HD>
__device__ __forceinline__ void tile_p_ds(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* Ls, const float* Ds, int q0, int k0, const Args& a,
    int ty, int tx, float p[4][4], float ds[4][4]) {
  constexpr int ST = HD + 1;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float aq[4], ad[4], bk[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      aq[i] = Qs[(ty * 4 + i) * ST + d];
      ad[i] = dOs[(ty * 4 + i) * ST + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bk[j] = Ks[(tx + 16 * j) * ST + d];
      bv[j] = Vs[(tx + 16 * j) * ST + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(aq[i], bk[j], s[i][j]);
        dp[i][j] = fmaf(ad[i], bv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int qpos = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k0 + tx + 16 * j;
      float pv = 0.f;
      if (qpos < a.Sq && kpos < a.Sk) {
        bool ok = !a.causal || kpos <= qpos;
        if (a.window > 0) ok = ok && (qpos - kpos < a.window);
        const float x = ok ? s[i][j] * a.sm_scale : NEG_INF;
        pv = expf(x - Ls[r]);
      }
      p[i][j] = pv;
      ds[i][j] = pv * (dp[i][j] - Ds[r]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ D,
         T* __restrict__ dk, T* __restrict__ dv, Args a) {
  constexpr int ST = HD + 1;
  constexpr int PST = BK + 1;
  constexpr int DJ = HD / 16;
  extern __shared__ float smem[];
  float* Ks = smem;               // [BK][HD+1]
  float* Vs = Ks + BK * ST;       // [BK][HD+1]
  float* Qs = Vs + BK * ST;       // [BQ][HD+1]
  float* dOs = Qs + BQ * ST;      // [BQ][HD+1]
  float* Ps = dOs + BQ * ST;      // [BQ][BK+1]
  float* dSs = Ps + BQ * PST;     // [BQ][BK+1]
  float* Ls = dSs + BQ * PST;     // [BQ]
  float* Ds = Ls + BQ;            // [BQ]

  const int k0 = blockIdx.x * BK;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int g = a.H / a.Kh;
  const int tid = threadIdx.x;
  const int ty = tid / 16;        // key rows ty*4 .. ty*4+3 of dK/dV
  const int tx = tid % 16;        // dims tx + 16*jj

  load_tile<T, HD>(Ks, k + b * a.ks.b + kh * a.ks.h, a.ks.s, k0, a.Sk);
  load_tile<T, HD>(Vs, v + b * a.vs.b + kh * a.vs.h, a.vs.s, k0, a.Sk);

  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dk_acc[i][jj] = dv_acc[i][jj] = 0.f;

  // q tiles holding a row that sees some key of this tile
  const int kmax = min(k0 + BK, a.Sk) - 1;
  int qt_begin = 0, qt_end = (a.Sq + BQ - 1) / BQ;
  if (a.causal) qt_begin = k0 / BQ;
  if (a.window > 0) qt_end = min(qt_end, (kmax + a.window - 1) / BQ + 1);

  for (int hh = 0; hh < g; ++hh) {
    const int h = kh * g + hh;
    const long long lrow = ((long long)b * a.H + h) * a.Sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();            // previous tile consumed (K/V written)
      load_tile<T, HD>(Qs, q + b * a.qs.b + h * a.qs.h, a.qs.s, q0, a.Sq);
      load_tile<T, HD>(dOs, dout + b * a.dos.b + h * a.dos.h, a.dos.s, q0,
                       a.Sq);
      if (tid < BQ) {
        const bool in = q0 + tid < a.Sq;
        Ls[tid] = in ? lse[lrow + q0 + tid] : 0.f;
        Ds[tid] = in ? D[lrow + q0 + tid] : 0.f;
      }
      __syncthreads();
      float p[4][4], ds[4][4];
      tile_p_ds<HD>(Qs, dOs, Ks, Vs, Ls, Ds, q0, k0, a, ty, tx, p, ds);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          Ps[(ty * 4 + i) * PST + tx + 16 * j] = p[i][j];
          dSs[(ty * 4 + i) * PST + tx + 16 * j] = ds[i][j];
        }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q over the tile's 64 q rows
      for (int qq = 0; qq < BQ; ++qq) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[qq * PST + ty * 4 + i];
          dsv[i] = dSs[qq * PST + ty * 4 + i];
        }
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          const float od = dOs[qq * ST + tx + 16 * jj];
          const float qd = Qs[qq * ST + tx + 16 * jj];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][jj] = fmaf(pv[i], od, dv_acc[i][jj]);
            dk_acc[i][jj] = fmaf(dsv[i], qd, dk_acc[i][jj]);
          }
        }
      }
    }
  }

  T* dkb = dk + b * a.dks.b + kh * a.dks.h;
  T* dvb = dv + b * a.dvs.b + kh * a.dvs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty * 4 + i;
    if (r >= a.Sk) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      from_f32(dkb + (long long)r * a.dks.s + tx + 16 * jj,
               dk_acc[i][jj] * a.sm_scale);
      from_f32(dvb + (long long)r * a.dvs.s + tx + 16 * jj, dv_acc[i][jj]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const T* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ D,
       T* __restrict__ dq, Args a) {
  constexpr int ST = HD + 1;
  constexpr int PST = BK + 1;
  constexpr int DJ = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;               // [BQ][HD+1]
  float* dOs = Qs + BQ * ST;      // [BQ][HD+1]
  float* Ks = dOs + BQ * ST;      // [BK][HD+1]
  float* Vs = Ks + BK * ST;       // [BK][HD+1]
  float* dSs = Vs + BK * ST;      // [BQ][BK+1]
  float* Ls = dSs + BQ * PST;     // [BQ]
  float* Ds = Ls + BQ;            // [BQ]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (a.H / a.Kh);
  const int tid = threadIdx.x;
  const int ty = tid / 16;        // q rows ty*4 .. ty*4+3
  const int tx = tid % 16;
  const long long lrow = ((long long)b * a.H + h) * a.Sq;

  load_tile<T, HD>(Qs, q + b * a.qs.b + h * a.qs.h, a.qs.s, q0, a.Sq);
  load_tile<T, HD>(dOs, dout + b * a.dos.b + h * a.dos.h, a.dos.s, q0, a.Sq);
  if (tid < BQ) {
    const bool in = q0 + tid < a.Sq;
    Ls[tid] = in ? lse[lrow + q0 + tid] : 0.f;
    Ds[tid] = in ? D[lrow + q0 + tid] : 0.f;
  }

  float dq_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dq_acc[i][jj] = 0.f;

  // the forward's key-tile range for this q tile
  int kt_end = (a.Sk + BK - 1) / BK;
  if (a.causal) kt_end = min(kt_end, (min(q0 + BQ, a.Sq) - 1) / BK + 1);
  int kt_begin = 0;
  if (a.window > 0 && q0 - a.window + 1 > 0)
    kt_begin = (q0 - a.window + 1) / BK;

  const T* kb = k + b * a.ks.b + kh * a.ks.h;
  const T* vb = v + b * a.vs.b + kh * a.vs.h;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();              // previous dS consumed, Qs/Ls written
    load_tile<T, HD>(Ks, kb, a.ks.s, k0, a.Sk);
    load_tile<T, HD>(Vs, vb, a.vs.s, k0, a.Sk);
    __syncthreads();
    float p[4][4], ds[4][4];
    tile_p_ds<HD>(Qs, dOs, Ks, Vs, Ls, Ds, q0, k0, a, ty, tx, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dSs[(ty * 4 + i) * PST + tx + 16 * j] = ds[i][j];
    __syncthreads();
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty * 4 + i) * PST + kk];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const float kd = Ks[kk * ST + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dq_acc[i][jj] = fmaf(dsv[i], kd, dq_acc[i][jj]);
      }
    }
  }

  T* dqb = dq + b * a.dqs.b + h * a.dqs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= a.Sq) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      from_f32(dqb + (long long)r * a.dqs.s + tx + 16 * jj,
               dq_acc[i][jj] * a.sm_scale);
  }
}

template <typename Kern>
int set_smem(Kern kern, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* D, void* dq,
              void* dk, void* dv, const Args& a, cudaStream_t stream) {
  const long long rows = (long long)a.B * a.H * a.Sq;
  bwd_dot<T><<<(unsigned)((rows * 32 + 255) / 256), 256, 0, stream>>>(
      (const T*)o, (const T*)dout, D, HD, a);
  int err = (int)cudaGetLastError();
  if (err) return err;

  const size_t tile = sizeof(float) * (size_t)64 * (HD + 1);
  const size_t pt = sizeof(float) * (size_t)BQ * (BK + 1);
  const size_t smem_kv = 4 * tile + 2 * pt + 2 * sizeof(float) * BQ;
  if ((err = set_smem(bwd_dkdv<T, HD>, smem_kv))) return err;
  dim3 grid_kv((a.Sk + BK - 1) / BK, a.Kh, a.B);
  bwd_dkdv<T, HD><<<grid_kv, THREADS, smem_kv, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, D, (T*)dk,
      (T*)dv, a);
  if ((err = (int)cudaGetLastError())) return err;

  const size_t smem_q = 4 * tile + pt + 2 * sizeof(float) * BQ;
  if ((err = set_smem(bwd_dq<T, HD>, smem_q))) return err;
  dim3 grid_q((a.Sq + BQ - 1) / BQ, a.H, a.B);
  bwd_dq<T, HD><<<grid_q, THREADS, smem_q, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, D, (T*)dq,
      a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* D, void* dq, void* dk,
           void* dv, int B, int H, int Kh, int Sq, int Sk, int hd,
           const long long* st, float sm_scale, int causal, int window,
           cudaStream_t stream) {
  if (B <= 0 || Kh <= 0 || H % Kh != 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.B = B; a.H = H; a.Kh = Kh; a.Sq = Sq; a.Sk = Sk;
  Strides* all[8] = {&a.qs, &a.ks, &a.vs, &a.os, &a.dos, &a.dqs, &a.dks,
                     &a.dvs};
  for (int i = 0; i < 8; ++i) *all[i] = Strides{st[3 * i], st[3 * i + 1],
                                                st[3 * i + 2]};
  a.sm_scale = sm_scale; a.causal = causal; a.window = window;
  switch (hd) {
    case 16:
      return launch_hd<T, 16>(q, k, v, o, dout, lse, D, dq, dk, dv, a, stream);
    case 32:
      return launch_hd<T, 32>(q, k, v, o, dout, lse, D, dq, dk, dv, a, stream);
    case 64:
      return launch_hd<T, 64>(q, k, v, o, dout, lse, D, dq, dk, dv, a, stream);
    case 112:
      return launch_hd<T, 112>(q, k, v, o, dout, lse, D, dq, dk, dv, a, stream);
    case 128:
      return launch_hd<T, 128>(q, k, v, o, dout, lse, D, dq, dk, dv, a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 24 int64 element strides, (batch, head, seq) for q, k, v, o,
// dout, dq, dk, dv; lse and D (scratch): (B, H, Sq) f32 contiguous
#define BWD_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(const void* q, const void* k, const void* v,           \
                      const void* o, const void* dout, const float* lse,     \
                      float* D, void* dq, void* dk, void* dv, int B, int H,  \
                      int Kh, int Sq, int Sk, int hd,                        \
                      const long long* strides, float sm_scale, int causal,  \
                      int window, void* stream) {                            \
    return launch<T>(q, k, v, o, dout, lse, D, dq, dk, dv, B, H, Kh, Sq, Sk, \
                     hd, strides, sm_scale, causal, window,                  \
                     (cudaStream_t)stream);                                  \
  }

BWD_ENTRY(flash_attention_bwd_f32, float)
BWD_ENTRY(flash_attention_bwd_bf16, __nv_bfloat16)
