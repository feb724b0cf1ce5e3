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
// and sliding-window masks on indices, a masked key's P is 0; keys past
// Sk and query rows past Sq weigh nothing, so ragged Sq/Sk work; the
// forward's division by max(l, 1e-30) is folded into lse (l >= 1 for any
// row with a visible key, which every causal row has: its diagonal).
//
// Bound on the card: five (S x S x hd) products where the forward does
// two (S = Q K^T and dP = dO V^T recomputed, then dV = P^T dO,
// dK = dS^T Q, dQ = dS K), against q, k, v, o, dO read once and dq, dk,
// dv written once: far above the ridge, so the tensor cores bound it
// (989 TFLOP/s bf16).
//
// Three launches, no atomics, deterministic (two runs are bitwise
// equal):
//  1. bwd_dot: D = rowsum(dO * O), one warp per (b, h, row).
//  2. dK / dV: one CTA per (key tile, KV head, batch row), key tiles
//     heaviest first (under the causal mask the first key tile sees every
//     q tile). It loops over the g query heads of its group and over the
//     q tiles that can see the key tile, accumulating dK and dV in f32
//     registers, so GQA's sum over the group's heads needs no atomics.
//  3. dQ: one CTA per (64-query tile, head, batch row), heaviest first,
//     looping over the key tiles the forward visits.
// The second pass recomputes S and dP, so the backward executes 7
// products where the bound counts 5: the price of staying atomic-free.
//
// bf16 (the training path): products on the tensor cores (wgmma), tiles
// of 64 rows brought by TMA, in the 128-byte-swizzled layout of
// hopper.cuh. The grids are 1-D with the tile index slowest and the
// heaviest tiles first. Every pass takes the products with M = 64 rows of
// its own tile: S^T = K Q^T and dP^T = V dO^T (A = K or V, B = Q or dO,
// K-major); P^T = exp(S^T * scale - LSE) and dS^T = P^T o (dP^T - D) in
// registers, LSE and D read by column (a q row); dV += P^T dO and dK +=
// dS^T Q with P^T and dS^T rounded to bf16 as the register-A operand and
// dO or Q the MN-major B operand.
//  - dK / dV at HDP 128 (hd 112 and 128: zamba2's shared block on the
//    hybrid train path, B=1, H=Kh=32, S=4096 a rank): fa_dkdv_wide, one
//    CTA per 128-key tile, 256 threads, two consumer warpgroups and no
//    producer warp. Warpgroup w keeps the whole 64 x 128 dK and dV of key
//    rows 64 w .. 64 w + 63 in registers; both take every (head, q tile)
//    pair from one ring stage, so each Q and dO tile streamed from L2
//    serves 128 key rows. That stream bounds the pass: a 64-key tile's
//    feed alone (TMA and the ring, no arithmetic) took 0.6 ms of the
//    train shape's pass, and halving it moved the pass from 1.4-1.6 ms
//    to 0.83 (tools/attn_variants.py). Eight warps leave a thread 255
//    registers: ptxas gives the kernel 218, no spill. At nine or twelve
//    warps (a producer warp or warpgroup beside the consumers) a quarter
//    of the register file holds three warps, which caps a thread at 168,
//    and ptxas does not allocate past that for code after setmaxnreg:
//    the register split of the forward (a producer warpgroup at
//    setmaxnreg 24, consumers at 240) spilled 2572 bytes here, and the
//    64-key fa_dkdv_wgmma at 288 threads 964. Thread 0 issues the TMA
//    loads, a ring of 4 (Q, dO) stages: stage (n - 1) % 4, once both
//    warpgroups freed it (full / empty mbarriers), takes pair n + 3. Each
//    warpgroup stages its pairs' LSE and D through shared memory, loaded
//    a pair ahead into a register (one named barrier a pair). Warpgroup 1
//    starts once warpgroup 0 has issued its first products, which keeps
//    their exp and dS phases apart (and, with the fourth stage, took
//    ~7% off the pass). Shared memory: K and V of 128 rows (64 KB) and
//    the ring (128 KB). tools/attn_variants.py builds the routes that
//    lost from this source: fa_dkdv_wgmma at 384 threads with the
//    register split, and fa_dkdv_split (tools/fa_dkdv_split.cuh), which
//    splits each pair by columns instead: warpgroup 0 P^T, warpgroup 1
//    dS^T, handed over as bf16 tiles in shared memory, each warpgroup dK
//    and dV of one 64-column panel (158 registers, no spill, but every
//    second product reads both operands from shared memory and the
//    warpgroups wait on each other a pair).
//  - dK / dV at HDP 64 (hd 16 to 64): fa_dkdv_wgmma, one CTA per 64-key
//    tile, 288 threads. A producer warp loads K and V once, then streams
//    the pairs of Q and dO through a 4-stage ring with full / empty
//    mbarriers, and writes each pair's 64 LSE and D values beside them
//    in shared memory (produce_pairs). Two consumer warpgroups take
//    alternate pairs, both for the tile's 64 key rows, and sum their dK
//    and dV through shared memory at the end, in a fixed order. 168
//    registers, no spill: LSE and D come from shared memory, not
//    registers.
//  - dQ pass: fa_dq_wgmma, 160 threads, one consumer warpgroup and a
//    producer warp that loads Q and dO once and streams K and V through a
//    2-stage ring; S = Q K^T, dP = dO V^T, dS in registers, dQ += dS K
//    with K the MN-major B operand. 133 registers (hd <= 64) and 165
//    (hd 112 / 128), no spill; two CTAs an SM. (A 128-query form
//    mirroring fa_dkdv_wide, each K and V tile serving two warpgroups,
//    measured no faster at the train shape: this pass is not bound by
//    its feed.)
//  - hd 112 is loaded as 128 and hd 16 / 32 as 64 (TMA fills the extra
//    columns with zeros); the extra output columns are not stored.
//  - P and dS are rounded to bf16 before the second products, where the
//    f32 kernel keeps them in f32; the tolerances are the f32 kernel's.
//  - TMA needs a 16-byte-aligned base and every outer stride a multiple
//    of 16 bytes; the wrapper checks q, k, v and dO and raises otherwise.
//
// f32 (the reference phases and card tests only): bwd_dkdv<float> and
// bwd_dq<float>, the CUDA-core kernels of the first port, unchanged:
// those checks hold the gradient to 1e-4 of the plain version, which
// TF32 or bf16 products cannot meet. 256 threads, each a 4 x 4 patch of
// the 64 x 64 score tile and 4 rows x hd/16 columns of its output
// accumulator, tiles staged as f32 with padded rows. The dispatch is by
// dtype only.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

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

// ------------------------------------------------ bf16: the tensor cores
using hopper::desc;

constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Bwd {
  static constexpr int HDP = HD <= 64 ? 64 : 128;   // head dim as loaded
  static constexpr int PANELS = HDP / 64;           // 128-byte panels
  static constexpr int TILE = 64 * HDP * 2;         // bytes of a 64-row tile
  // dK / dV pass: K, V, then a ring of 4 stages of (Q, dO), two for each
  // consumer warpgroup; 2 consumer warpgroups + the producer's
  static constexpr int KV_STAGES = 4;
  static constexpr int KV_TILES = 2 * TILE + KV_STAGES * 2 * TILE;
  static constexpr int KV_ROWS = KV_STAGES * 128 * 4;   // LSE and D a stage
  static constexpr int KV_SMEM = KV_TILES + KV_ROWS + 128 + 1024;
  static constexpr int KV_THREADS = 288;
  // dQ pass: Q, dO, then a ring of 2 stages of (K, V); 1 consumer
  // warpgroup + a producer warp
  static constexpr int Q_TILES = 6 * TILE;
  static constexpr int Q_SMEM = Q_TILES + 64 + 1024;
  static constexpr int Q_THREADS = 160;
};

// one 64-row tile (all panels) of a map at sequence row r0, head h
template <int PANELS>
__device__ __forceinline__ void load_rows(uint8_t* dst, const CUtensorMap* map,
                                          int h, int r0, int b,
                                          uint64_t* bar) {
#pragma unroll
  for (int p = 0; p < PANELS; ++p)
    hopper::tma_load(dst + p * 64 * 128, map, 64 * p, h, r0, b, bar);
}

// acc(64 x 64) = A(64 rows x HDP) B(64 rows x HDP)^T, both tiles K-major
template <int HDP>
__device__ __forceinline__ void tile_nt(float (&acc)[32], const uint8_t* a,
                                        const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk)   // panel kk / 4, 32 B a step
    hopper::wgmma_ss(acc, desc(a + (kk / 4) * 64 * 128 + (kk % 4) * 32, 16,
                               1024),
                     desc(b + (kk / 4) * 64 * 128 + (kk % 4) * 32, 16, 1024),
                     kk > 0);
}

// acc(64 x HDP) += A(64 x 64, bf16 fragments) B(64 rows x HDP), B MN-major
template <int N>
__device__ __forceinline__ void tile_nn(float (&acc)[N],
                                        const uint32_t (&a)[4][4],
                                        const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hopper::wgmma_rs(acc, a[kk], desc(b + kk * 16 * 128, 64 * 128, 1024));
}

__device__ __forceinline__ bool visible(int qpos, int kpos, const Args& a) {
  return qpos < a.Sq && kpos < a.Sk && (!a.causal || kpos <= qpos) &&
         (a.window <= 0 || qpos - kpos < a.window);
}

// The 64-key dK / dV passes' producer warp: for each (head in group, q
// tile) pair n, the TMA of its Q and dO tiles (PANELS panels each) into
// ring stage n % ST once the consumers freed it, and its 64 LSE (log2
// units) and D values into rows[stage][128] beside them, so the consumers
// hold no copy in registers.
template <int PANELS, int ST>
__device__ __forceinline__ void produce_pairs(
    uint8_t* ring, int tile, float* rows, uint64_t* full, uint64_t* empty,
    const CUtensorMap* qmap, const CUtensorMap* dmap, const float* lse,
    const float* D, const Args& a, int b, int kh, int qt_begin, int nq,
    int lane) {
  const int g = a.H / a.Kh;
  for (int n = 0; n < g * nq; ++n) {
    const int s = n % ST;
    const int h = kh * g + n / nq;
    const int q0 = (qt_begin + n % nq) * 64;
    hopper::mbar_wait(&empty[s], ((n / ST) & 1) ^ 1);
    if (lane == 0) {
      hopper::mbar_expect_tx(&full[s], 2 * tile);
      uint8_t* qd = ring + s * 2 * tile;
      load_rows<PANELS>(qd, qmap, h, q0, b, &full[s]);
      load_rows<PANELS>(qd + tile, dmap, h, q0, b, &full[s]);
    }
    const long long lrow = ((long long)b * a.H + h) * a.Sq;
    for (int r = lane; r < 64; r += 32) {
      const bool in = q0 + r < a.Sq;
      rows[s * 128 + r] = in ? lse[lrow + q0 + r] * LOG2E : 0.f;
      rows[s * 128 + 64 + r] = in ? D[lrow + q0 + r] : 0.f;
    }
    hopper::mbar_arrive(&full[s]);
  }
}

template <int HD>
__global__ void __launch_bounds__(Bwd<HD>::KV_THREADS, 1)
fa_dkdv_wgmma(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ CUtensorMap dmap,
              const float* __restrict__ lse, const float* __restrict__ D,
              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
              Args a) {
  using C = Bwd<HD>;
  constexpr int HDP = C::HDP, ST = C::KV_STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Ks = sm;
  uint8_t* Vs = sm + C::TILE;
  uint8_t* ring = sm + 2 * C::TILE;        // stage s: Q, then dO
  // stage s: the 64 q rows' LSE (log2 units), then their D
  float* rows = reinterpret_cast<float*>(sm + C::KV_TILES);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + C::KV_TILES + C::KV_ROWS);
  uint64_t* kvbar = bar;
  uint64_t* full = bar + 1;                // [ST]
  uint64_t* empty = bar + 1 + ST;          // [ST]

  // a 1-D grid, key tile slowest and first first: under the causal mask
  // the first key tiles see the most q tiles, and start in the first wave
  const int per_tile = (int)gridDim.x / ((a.Sk + 63) / 64);   // Kh * B
  const int k0 = (int)blockIdx.x / per_tile * 64;
  const int kh = (int)blockIdx.x % per_tile % a.Kh;
  const int b = (int)blockIdx.x % per_tile / a.Kh;
  const int g = a.H / a.Kh;
  // q tiles holding a row that sees some key of this tile
  const int kmax = min(k0 + 64, a.Sk) - 1;
  int qt_begin = 0, qt_end = (a.Sq + 63) / 64;
  if (a.causal) qt_begin = k0 / 64;
  if (a.window > 0) qt_end = min(qt_end, (kmax + a.window - 1) / 64 + 1);
  const int nq = max(0, qt_end - qt_begin);
  const int npairs = g * nq;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    hopper::mbar_init(kvbar, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1 + 32);  // TMA + the producer's lanes
      hopper::mbar_init(&empty[s], 4);     // the consuming warpgroup's warps
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {                         // producer
    if (lane == 0) {
      hopper::mbar_expect_tx(kvbar, 2 * C::TILE);
      load_rows<C::PANELS>(Ks, &kmap, kh, k0, b, kvbar);
      load_rows<C::PANELS>(Vs, &vmap, kh, k0, b, kvbar);
    }
    produce_pairs<C::PANELS, ST>(ring, C::TILE, rows, full, empty, &qmap,
                                 &dmap, lse, D, a, b, kh, qt_begin, nq,
                                 lane);
  } else {
    // consumer warpgroups: wg takes the pairs n = wg, wg + 2, ...; both own
    // the tile's 64 key rows: rows kr and kr + 8 of the accumulators,
    // columns (q rows) 8i + 2t, 8i + 2t + 1
    const int wg = warp / 4;
    const int t = lane % 4;
    const int kr = k0 + (warp % 4) * 16 + lane / 4;
    const float sl2 = a.sm_scale * LOG2E;
    float dk_acc[HDP / 2], dv_acc[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    hopper::mbar_wait(kvbar, 0);
    for (int n = wg; n < npairs; n += 2) {
      const int s = n % ST;
      const int q0 = (qt_begin + n % nq) * 64;
      const uint8_t* qd = ring + s * 2 * C::TILE;
      const uint8_t* dod = qd + C::TILE;
      hopper::mbar_wait(&full[s], (n / ST) & 1);

      float st[32], dpt[32];
      hopper::wgmma_fence();
      tile_nt<HDP>(st, Ks, qd);              // S^T = K Q^T
      tile_nt<HDP>(dpt, Vs, dod);            // dP^T = V dO^T
      hopper::wgmma_commit();
      const float* lc = rows + s * 128;      // by column (q row)
      const float* dc = lc + 64;
      hopper::wgmma_wait();
      hopper::fence_regs(st);
      hopper::fence_regs(dpt);

      const bool edge = q0 + 64 > a.Sq || k0 + 64 > a.Sk ||
                        (a.causal && k0 + 63 > q0) ||
                        (a.window > 0 && q0 + 63 - k0 >= a.window);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 8 * i + 2 * t + (j & 1);
          float p = exp2f(st[4 * i + j] * sl2 - lc[c]);
          if (edge && !visible(q0 + c, kr + (j >> 1) * 8, a)) p = 0.f;
          st[4 * i + j] = p;
          dpt[4 * i + j] = p * (dpt[4 * i + j] - dc[c]);
        }
      uint32_t pf[4][4], df[4][4];
      hopper::to_a_frags<64>(st, pf);
      hopper::to_a_frags<64>(dpt, df);
      hopper::wgmma_fence();
      tile_nn(dv_acc, pf, dod);              // dV += P^T dO
      tile_nn(dk_acc, df, qd);               // dK += dS^T Q
      hopper::wgmma_commit();
      hopper::wgmma_wait();
      hopper::fence_regs(dv_acc);
      hopper::fence_regs(dk_acc);
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    // warpgroup 1 hands its sums to warpgroup 0 through the ring, free once
    // both are done: a fixed order, so the result is deterministic
    float* red = reinterpret_cast<float*>(ring);
    const int tid = threadIdx.x % 128;
    hopper::bar_sync(1, 256);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) {
        red[i * 128 + tid] = dk_acc[i];
        red[(HDP / 2 + i) * 128 + tid] = dv_acc[i];
      }
    }
    hopper::bar_sync(1, 256);
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) {
        dk_acc[i] += red[i * 128 + tid];
        dv_acc[i] += red[(HDP / 2 + i) * 128 + tid];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kpos = kr + 8 * r;
        if (kpos >= a.Sk) continue;
        __nv_bfloat16* dkr = dk + b * a.dks.b + kh * a.dks.h +
                             (long long)kpos * a.dks.s;
        __nv_bfloat16* dvr = dv + b * a.dvs.b + kh * a.dvs.h +
                             (long long)kpos * a.dvs.s;
#pragma unroll
        for (int i = 0; i < HD / 8; ++i) {
          *reinterpret_cast<__nv_bfloat162*>(dkr + 8 * i + 2 * t) =
              __floats2bfloat162_rn(dk_acc[4 * i + 2 * r] * a.sm_scale,
                                    dk_acc[4 * i + 2 * r + 1] * a.sm_scale);
          *reinterpret_cast<__nv_bfloat162*>(dvr + 8 * i + 2 * t) =
              __floats2bfloat162_rn(dv_acc[4 * i + 2 * r],
                                    dv_acc[4 * i + 2 * r + 1]);
        }
      }
    }
  }
}

// dK / dV at HDP 128 over 128-key tiles: 256 threads, two warpgroups
// and no producer warp. Warpgroup w owns key rows 64 w .. 64 w + 63 of the
// tile and keeps their whole 64 x 128 dK and dV in f32 registers (128 a
// thread); both take every (head, q tile) pair from the same ring stage,
// so each Q and dO tile streamed from L2 serves 128 key rows, not 64.
// Eight warps leave a thread 255 registers (at nine or twelve the
// register file's four quarters cap it at 168, which spills these
// accumulators). Thread 0 issues the TMA loads, a stage ahead of its
// consumers: stage (n - 1) % ST, once both warpgroups freed it, gets pair
// n + ST - 1. Each warpgroup stages its pairs' LSE and D through shared
// memory itself, loaded a pair ahead (one named barrier a pair).
struct Wide {
  static constexpr int TILE = 64 * 128 * 2;          // 64 rows at HDP 128
  static constexpr int STAGES = 4;
  static constexpr int RING = STAGES * 2 * TILE;     // (Q, dO) stages
  static constexpr int TILES = 4 * TILE + RING;      // K, V: 128 rows each
  static constexpr int ROWS = 2 * 2 * 128 * 4;       // [wg][buffer][LSE, D]
  static constexpr int SMEM = TILES + ROWS + 128 + 1024;
  static constexpr int THREADS = 256;
};

template <int HD>
__global__ void __launch_bounds__(256, 1)
fa_dkdv_wide(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             const __grid_constant__ CUtensorMap dmap,
             const float* __restrict__ lse, const float* __restrict__ D,
             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
             Args a) {
  using C = Wide;
  constexpr int ST = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = hopper::align1024(smem_raw);
  uint8_t* Ks = sm;                        // warpgroup w's rows at w * TILE
  uint8_t* Vs = sm + 2 * C::TILE;
  uint8_t* ring = sm + 4 * C::TILE;        // stage s: Q, then dO
  float* rowbuf = reinterpret_cast<float*>(sm + C::TILES);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + C::TILES + C::ROWS);
  uint64_t* kvbar = bar;
  uint64_t* full = bar + 1;                // [ST]
  uint64_t* empty = bar + 1 + ST;          // [ST]

  // a 1-D grid, key tile slowest and first first: under the causal mask
  // the first key tiles see the most q tiles, and start in the first wave
  const int per_tile = (int)gridDim.x / ((a.Sk + 127) / 128);  // Kh * B
  const int k0 = (int)blockIdx.x / per_tile * 128;
  const int kh = (int)blockIdx.x % per_tile % a.Kh;
  const int b = (int)blockIdx.x % per_tile / a.Kh;
  const int g = a.H / a.Kh;
  // q tiles holding a row that sees some key of this tile
  const int kmax = min(k0 + 128, a.Sk) - 1;
  int qt_begin = 0, qt_end = (a.Sq + 63) / 64;
  if (a.causal) qt_begin = k0 / 64;
  if (a.window > 0) qt_end = min(qt_end, (kmax + a.window - 1) / 64 + 1);
  const int nq = max(0, qt_end - qt_begin);
  const int npairs = g * nq;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    hopper::mbar_init(kvbar, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);     // both warpgroups' warps
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  auto pair_q0 = [&](int n) { return (qt_begin + n % nq) * 64; };
  auto pair_h = [&](int n) { return kh * g + n / nq; };
  // pair n's Q and dO into its stage (thread 0)
  auto load_pair = [&](int n) {
    const int s = n % ST;
    hopper::mbar_expect_tx(&full[s], 2 * C::TILE);
    uint8_t* qd = ring + s * 2 * C::TILE;
    load_rows<2>(qd, &qmap, pair_h(n), pair_q0(n), b, &full[s]);
    load_rows<2>(qd + C::TILE, &dmap, pair_h(n), pair_q0(n), b, &full[s]);
  };
  if (threadIdx.x == 0) {
    hopper::mbar_expect_tx(kvbar, 4 * C::TILE);
    for (int w = 0; w < 2; ++w) {
      load_rows<2>(Ks + w * C::TILE, &kmap, kh, k0 + 64 * w, b, kvbar);
      load_rows<2>(Vs + w * C::TILE, &vmap, kh, k0 + 64 * w, b, kvbar);
    }
    for (int n = 0; n < min(ST - 1, npairs); ++n) load_pair(n);
  }
  // this warpgroup's copy of pair n's LSE (log2 units; threads 0-63) or
  // D (64-127), fetched a pair ahead into a register
  auto fetch = [&](int n) {
    const int q = pair_q0(n) + tid % 64;
    const long long row = ((long long)b * a.H + pair_h(n)) * a.Sq + q;
    return q >= a.Sq ? 0.f : tid < 64 ? lse[row] * LOG2E : D[row];
  };
  float* rows_w = rowbuf + wg * 2 * 128;   // [buffer][LSE, D]
  float ahead = npairs > 0 ? fetch(0) : 0.f;

  // rows kr and kr + 8 (key rows) of the accumulators, columns 8i + 2t
  // (+1): q rows in S^T / dP^T, head dims in dK / dV
  const int t = lane % 4;
  const int kr = k0 + 64 * wg + (warp % 4) * 16 + lane / 4;
  const int kw0 = k0 + 64 * wg;            // this warpgroup's first key
  const uint8_t* Kw = Ks + wg * C::TILE;
  const uint8_t* Vw = Vs + wg * C::TILE;
  const float sl2 = a.sm_scale * LOG2E;
  float dk_acc[64], dv_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  hopper::mbar_wait(kvbar, 0);
  // warpgroup 1 starts once warpgroup 0 has issued its first products,
  // so that each one's exp and dS fall between the other's products
  if (wg == 1 && npairs > 0) hopper::bar_sync(3, 256);
  for (int n = 0; n < npairs; ++n) {
    const int s = n % ST;
    const int q0 = pair_q0(n);
    // pair n + ST - 1 into the stage pair n - 1 used, once both freed it
    if (threadIdx.x == 0 && n + ST - 1 < npairs) {
      if (n >= 1) hopper::mbar_wait(&empty[(n - 1) % ST], ((n - 1) / ST) & 1);
      load_pair(n + ST - 1);
    }
    rows_w[(n & 1) * 128 + tid] = ahead;
    if (n + 1 < npairs) ahead = fetch(n + 1);
    hopper::bar_sync(1 + wg, 128);         // pair n's LSE and D visible
    const uint8_t* qd = ring + s * 2 * C::TILE;
    const uint8_t* dod = qd + C::TILE;
    hopper::mbar_wait(&full[s], (n / ST) & 1);

    float st[32], dpt[32];
    hopper::wgmma_fence();
    tile_nt<128>(st, Kw, qd);              // S^T = K Q^T
    tile_nt<128>(dpt, Vw, dod);            // dP^T = V dO^T
    hopper::wgmma_commit();
    if (wg == 0 && n == 0) hopper::bar_arrive(3, 256);
    const float* lc = rows_w + (n & 1) * 128;   // by column (q row)
    const float* dc = lc + 64;
    hopper::wgmma_wait();
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);

    const bool edge = q0 + 64 > a.Sq || kw0 + 64 > a.Sk ||
                      (a.causal && kw0 + 63 > q0) ||
                      (a.window > 0 && q0 + 63 - kw0 >= a.window);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 8 * i + 2 * t + (j & 1);
        float p = exp2f(st[4 * i + j] * sl2 - lc[c]);
        if (edge && !visible(q0 + c, kr + (j >> 1) * 8, a)) p = 0.f;
        st[4 * i + j] = p;
        dpt[4 * i + j] = p * (dpt[4 * i + j] - dc[c]);
      }
    uint32_t pf[4][4], df[4][4];
    hopper::to_a_frags<64>(st, pf);
    hopper::to_a_frags<64>(dpt, df);
    hopper::wgmma_fence();
    tile_nn(dv_acc, pf, dod);              // dV += P^T dO
    tile_nn(dk_acc, df, qd);               // dK += dS^T Q
    hopper::wgmma_commit();
    hopper::wgmma_wait();
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = kr + 8 * r;
    if (kpos >= a.Sk) continue;
    __nv_bfloat16* dkr = dk + b * a.dks.b + kh * a.dks.h +
                         (long long)kpos * a.dks.s;
    __nv_bfloat16* dvr = dv + b * a.dvs.b + kh * a.dvs.h +
                         (long long)kpos * a.dvs.s;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(dkr + 8 * i + 2 * t) =
          __floats2bfloat162_rn(dk_acc[4 * i + 2 * r] * a.sm_scale,
                                dk_acc[4 * i + 2 * r + 1] * a.sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(dvr + 8 * i + 2 * t) =
          __floats2bfloat162_rn(dv_acc[4 * i + 2 * r],
                                dv_acc[4 * i + 2 * r + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(160, 2)
fa_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
            const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap,
            const __grid_constant__ CUtensorMap dmap,
            const float* __restrict__ lse, const float* __restrict__ D,
            __nv_bfloat16* __restrict__ dq, Args a) {
  using C = Bwd<HD>;
  constexpr int HDP = C::HDP;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = sm;
  uint8_t* dOs = sm + C::TILE;
  uint8_t* ring = sm + 2 * C::TILE;        // stage s: K, then V
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + C::Q_TILES);
  uint64_t* qbar = bar;
  uint64_t* full = bar + 1;                // [2]
  uint64_t* empty = bar + 3;               // [2]

  // a 1-D grid, q tile slowest and last first (the causally longest)
  const int nqt = (a.Sq + 63) / 64;
  const int per_tile = (int)gridDim.x / nqt;                   // H * B
  const int q0 = (nqt - 1 - (int)blockIdx.x / per_tile) * 64;
  const int h = (int)blockIdx.x % per_tile % a.H;
  const int b = (int)blockIdx.x % per_tile / a.H;
  const int kh = h / (a.H / a.Kh);
  // the forward's key-tile range for this q tile
  int kt_end = (a.Sk + 63) / 64;
  if (a.causal) kt_end = min(kt_end, (min(q0 + 64, a.Sq) - 1) / 64 + 1);
  int kt_begin = 0;
  if (a.window > 0 && q0 - a.window + 1 > 0)
    kt_begin = (q0 - a.window + 1) / 64;
  const int ntiles = kt_end - kt_begin;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    hopper::mbar_init(qbar, 1);
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {                         // producer
    if (lane == 0) {
      hopper::mbar_expect_tx(qbar, 2 * C::TILE);
      load_rows<C::PANELS>(Qs, &qmap, h, q0, b, qbar);
      load_rows<C::PANELS>(dOs, &dmap, h, q0, b, qbar);
      for (int n = 0; n < ntiles; ++n) {
        const int s = n & 1;
        hopper::mbar_wait(&empty[s], ((n >> 1) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], 2 * C::TILE);
        uint8_t* kd = ring + s * 2 * C::TILE;
        const int k0 = (kt_begin + n) * 64;
        load_rows<C::PANELS>(kd, &kmap, kh, k0, b, &full[s]);
        load_rows<C::PANELS>(kd + C::TILE, &vmap, kh, k0, b, &full[s]);
      }
    }
    return;
  }

  // consumer warpgroup: q rows qr and qr + 8, key columns 8i + 2t (+1)
  const int t = lane % 4;
  const int qr = q0 + warp * 16 + lane / 4;
  const float sl2 = a.sm_scale * LOG2E;
  const long long lrow = ((long long)b * a.H + h) * a.Sq;
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = qr + 8 * r < a.Sq;
    lr[r] = in ? lse[lrow + qr + 8 * r] * LOG2E : 0.f;
    dr[r] = in ? D[lrow + qr + 8 * r] : 0.f;
  }
  float dq_acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) dq_acc[i] = 0.f;

  hopper::mbar_wait(qbar, 0);
  for (int n = 0; n < ntiles; ++n) {
    const int s = n & 1;
    const int k0 = (kt_begin + n) * 64;
    const uint8_t* kd = ring + s * 2 * C::TILE;
    const uint8_t* vd = kd + C::TILE;
    hopper::mbar_wait(&full[s], (n >> 1) & 1);

    float sc[32], dp[32];
    hopper::wgmma_fence();
    tile_nt<HDP>(sc, Qs, kd);              // S = Q K^T
    tile_nt<HDP>(dp, dOs, vd);             // dP = dO V^T
    hopper::wgmma_commit();
    hopper::wgmma_wait();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);

    const bool edge = q0 + 64 > a.Sq || k0 + 64 > a.Sk ||
                      (a.causal && k0 + 63 > q0) ||
                      (a.window > 0 && q0 + 63 - k0 >= a.window);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = exp2f(sc[4 * i + j] * sl2 - lr[j >> 1]);
        if (edge && !visible(qr + (j >> 1) * 8, k0 + 8 * i + 2 * t + (j & 1),
                             a))
          p = 0.f;
        sc[4 * i + j] = p * (dp[4 * i + j] - dr[j >> 1]);   // dS
      }
    uint32_t df[4][4];
    hopper::to_a_frags<64>(sc, df);
    hopper::wgmma_fence();
    tile_nn(dq_acc, df, kd);               // dQ += dS K
    hopper::wgmma_commit();
    hopper::wgmma_wait();
    hopper::fence_regs(dq_acc);
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qr + 8 * r;
    if (qpos >= a.Sq) continue;
    __nv_bfloat16* dqr = dq + b * a.dqs.b + h * a.dqs.h +
                         (long long)qpos * a.dqs.s;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(dqr + 8 * i + 2 * t) =
          __floats2bfloat162_rn(dq_acc[4 * i + 2 * r] * a.sm_scale,
                                dq_acc[4 * i + 2 * r + 1] * a.sm_scale);
  }
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* D, void* dq,
                 void* dk, void* dv, const Args& a, cudaStream_t stream) {
  using C = Bwd<HD>;
  const long long rows = (long long)a.B * a.H * a.Sq;
  bwd_dot<__nv_bfloat16><<<(unsigned)((rows * 32 + 255) / 256), 256, 0,
                           stream>>>((const __nv_bfloat16*)o,
                                     (const __nv_bfloat16*)dout, D, HD, a);
  int err = (int)cudaGetLastError();
  if (err) return err;

  CUtensorMap qm, km, vm, dm;
  if ((err = hopper::make_map(&qm, q, a.B, a.H, a.Sq, HD, a.qs.b, a.qs.h,
                              a.qs.s, 64)) ||
      (err = hopper::make_map(&km, k, a.B, a.Kh, a.Sk, HD, a.ks.b, a.ks.h,
                              a.ks.s, 64)) ||
      (err = hopper::make_map(&vm, v, a.B, a.Kh, a.Sk, HD, a.vs.b, a.vs.h,
                              a.vs.s, 64)) ||
      (err = hopper::make_map(&dm, dout, a.B, a.H, a.Sq, HD, a.dos.b,
                              a.dos.h, a.dos.s, 64)))
    return err;

  if constexpr (C::HDP == 128) {
    if ((err = set_smem(fa_dkdv_wide<HD>, Wide::SMEM))) return err;
    const unsigned grid_wide = (unsigned)((a.Sk + 127) / 128) * a.Kh * a.B;
    fa_dkdv_wide<HD><<<grid_wide, Wide::THREADS, Wide::SMEM, stream>>>(
        qm, km, vm, dm, lse, D, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, a);
  } else {
    if ((err = set_smem(fa_dkdv_wgmma<HD>, C::KV_SMEM))) return err;
    const unsigned grid_kv = (unsigned)((a.Sk + 63) / 64) * a.Kh * a.B;
    fa_dkdv_wgmma<HD><<<grid_kv, C::KV_THREADS, C::KV_SMEM, stream>>>(
        qm, km, vm, dm, lse, D, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, a);
  }
  if ((err = (int)cudaGetLastError())) return err;

  if ((err = set_smem(fa_dq_wgmma<HD>, C::Q_SMEM))) return err;
  const unsigned grid_q = (unsigned)((a.Sq + 63) / 64) * a.H * a.B;
  fa_dq_wgmma<HD><<<grid_q, C::Q_THREADS, C::Q_SMEM, stream>>>(
      qm, km, vm, dm, lse, D, (__nv_bfloat16*)dq, a);
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

int launch_bf16(const void* q, const void* k, const void* v, const void* o,
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
      return launch_wgmma<16>(q, k, v, o, dout, lse, D, dq, dk, dv, a, stream);
    case 32:
      return launch_wgmma<32>(q, k, v, o, dout, lse, D, dq, dk, dv, a, stream);
    case 64:
      return launch_wgmma<64>(q, k, v, o, dout, lse, D, dq, dk, dv, a, stream);
    case 112:
      return launch_wgmma<112>(q, k, v, o, dout, lse, D, dq, dk, dv, a, stream);
    case 128:
      return launch_wgmma<128>(q, k, v, o, dout, lse, D, dq, dk, dv, a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 24 int64 element strides, (batch, head, seq) for q, k, v, o,
// dout, dq, dk, dv; lse and D (scratch): (B, H, Sq) f32 contiguous
#define BWD_ENTRY(NAME, LAUNCH)                                               \
  extern "C" int NAME(const void* q, const void* k, const void* v,           \
                      const void* o, const void* dout, const float* lse,     \
                      float* D, void* dq, void* dk, void* dv, int B, int H,  \
                      int Kh, int Sq, int Sk, int hd,                        \
                      const long long* strides, float sm_scale, int causal,  \
                      int window, void* stream) {                            \
    return LAUNCH(q, k, v, o, dout, lse, D, dq, dk, dv, B, H, Kh, Sq, Sk,    \
                  hd, strides, sm_scale, causal, window,                     \
                  (cudaStream_t)stream);                                     \
  }

BWD_ENTRY(flash_attention_bwd_f32, launch<float>)
BWD_ENTRY(flash_attention_bwd_bf16, launch_bf16)
