// mlstm_chunkwise: the chunkwise xLSTM mLSTM, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mlstm_kernel.py
// (mlstm_chunkwise / _mlstm_kernel), which the reference model reaches
// through its pure-jnp mirror models/xlstm.py::mlstm_apply. Per batch row
// and head it computes the matrix-memory recurrence with exponential
// gates, C_t = f_t C_{t-1} + i_t k_t v_t^T, n_t = f_t n_{t-1} + i_t k_t,
// y_t = q_t C_t / max(|q_t n_t|, 1), in the chunked form, stabilised in
// log space. Within a chunk: lf = cumsum(logf); logD = lf_t - lf_s + logi_s
// for s <= t (-1e30 above the diagonal); m = max(rowmax logD, lf);
// W = (q k^T) o exp(logD - m); num = W v + exp(lf - m) (q C);
// den = rowsum W + exp(lf - m) (q n); y = num / max(|den|, exp(-m)). Then
// the carry, in the absolute (m = 0) frame:
// C <- exp(lf_end) C + (k o exp(lf_end - lf + logi))^T v, and n likewise.
// Every exp(-m) cancels, so the chunk length changes only the rounding.
//
// Layout as the JAX kernel's: q, k, v (B, NH, S, hd) in the input type;
// logi, logf (B, NH, S) f32; y (B, NH, S, hd) in the output type (f32 on
// the model's path, where the reference keeps it through the norm). Every
// input is read through element strides of its outer dims (last dim
// contiguous), so the model passes its (B, S, NH, hd) projections as
// views, uncopied, and receives a (B, NH, S, hd) view of a (B, S, NH, hd)
// buffer.
//
// Bound on the card: bytes. At the xlstm-125m prefill shape (B=8, NH=4,
// S=2048, hd=384) the call reads q, k, v in bf16 (151 MB) and logi, logf
// (0.5 MB) and writes y in f32 (101 MB): about 252 MB, 0.075 ms at
// 3.35 TB/s. Its products at 64-row chunks (q k^T, W v, q C and the state
// update) are 4.5e10 flops, 0.046 ms at the bf16 tensor-core peak. This
// first version does them on the CUDA cores in f32 and so sits well above
// either bound.
//
// Design: the TPU kernel keeps C (hd x hd f32) in VMEM across its
// sequential chunk grid dimension; at hd 384 that is 576 KB, more than a
// Hopper block's 227 KB of shared memory. So the state is split by value
// columns: one block per (tile of 64 value columns, head, batch row) loops
// over the chunks with its C[:, tile] (384 x 64 f32, 97.5 KB padded) and
// its own copy of n (hd floats) resident in shared memory. Each block
// recomputes the chunk's q k^T, m, W and den, which the tiles of one head
// share (at hd 384 six times the 2 c^2 hd flops of q k^T, about a seventh
// of the work). A chunk is 64 rows; q and k are staged 64 key dims at a
// time (two 64 x 64 tiles), and each slice's rows of C are read for q C
// and then updated in place, so the whole of q never has to be resident:
// about 170 KB of shared memory at hd 384. Per chunk, 256 threads: stage
// the gates and the v tile; one warp takes the prefix sum of logf (two
// rows a lane); a thread per row takes m by the reference's own max over
// logD, exp(lf - m) and the decay to the chunk's end; then per key slice
// q k^T and q C (each thread 4 rows x 4 columns) and q n, and the slice's
// state update (4 key rows x 4 value columns a thread); then W, den and
// y = (W v + exp(lf - m) q C) / den. Rows past S are staged as zeros with
// logi = logf = 0: they add nothing and are never written, so any S works
// (no divisibility assert). No atomics: repeated runs are bitwise equal.
//
// Later work: the products belong on the tensor cores (mma.sync / wgmma)
// with the tiles in bf16 and TMA loads; the tiles of one head could share
// q k^T through a cluster's distributed shared memory.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int CH = 64;         // rows per chunk
constexpr int THREADS = 256;   // 16 row groups x 16 lanes

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* li;
  const float* lf;
  void* y;
  int NH, S;
  // element strides (b, h, s) of q, k, v, logi, logf, y
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, isb, ish, iss, fsb,
      fsh, fss, ysb, ysh, yss;
};

template <int HD>
constexpr size_t smem_floats() {
  constexpr int VT = HD < 64 ? HD : 64;
  constexpr int KS = HD < 64 ? HD : 64;
  return (size_t)2 * CH * (KS + 1) + CH * (VT + 1) + HD * (VT + 1) +
         CH * (CH + 1) + HD + 6 * CH;
}

template <typename TI, typename TO, int HD>
__global__ void __launch_bounds__(THREADS) mlstm_kernel(Args g) {
  constexpr int VT = HD < 64 ? HD : 64;   // value columns per block
  constexpr int KS = HD < 64 ? HD : 64;   // key dims per staged slice
  constexpr int NSL = HD / KS;            // key slices
  constexpr int QST = KS + 1;             // padded rows of Qs, Ks
  constexpr int VST = VT + 1;             // padded rows of Vs, Cs
  constexpr int WST = CH + 1;             // padded rows of Ws
  constexpr int VJ = VT / 16;             // value columns per thread
  constexpr int KJ = KS / 16;             // key rows per thread (update)
  extern __shared__ float smem[];
  float* Qs = smem;                 // [CH][KS+1]  q, one key slice
  float* Ks = Qs + CH * QST;        // [CH][KS+1]  k, one key slice
  float* Vs = Ks + CH * QST;        // [CH][VT+1]  v, this block's columns
  float* Cs = Vs + CH * VST;        // [HD][VT+1]  the carried C[:, tile]
  float* Ws = Cs + HD * VST;        // [CH][CH+1]  W
  float* ns = Ws + CH * WST;        // [HD]        the carried n
  float* lfs = ns + HD;             // [CH] logf, then its prefix sum lf
  float* lis = lfs + CH;            // [CH] logi
  float* ms = lis + CH;             // [CH] m
  float* wl = ms + CH;              // [CH] exp(lf - m)
  float* dec = wl + CH;             // [CH] exp(lf_end - lf + logi)
  float* dens = dec + CH;           // [CH] max(|den|, exp(-m))

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  const TI* qb = static_cast<const TI*>(g.q) + b * g.qsb + h * g.qsh;
  const TI* kb = static_cast<const TI*>(g.k) + b * g.ksb + h * g.ksh;
  const TI* vb =
      static_cast<const TI*>(g.v) + b * g.vsb + h * g.vsh + tile * VT;
  const float* ib = g.li + b * g.isb + h * g.ish;
  const float* fb = g.lf + b * g.fsb + h * g.fsh;
  TO* yb = static_cast<TO*>(g.y) + b * g.ysb + h * g.ysh + tile * VT;

  for (int e = tid; e < HD * VST; e += THREADS) Cs[e] = 0.f;
  for (int e = tid; e < HD; e += THREADS) ns[e] = 0.f;

  for (int s0 = 0; s0 < g.S; s0 += CH) {
    const int nr = min(CH, g.S - s0);
    __syncthreads();             // the last chunk's reads of Vs, Ws are done
    // 1. stage the gates and the v tile as f32; rows past S are zeros
    if (tid < CH) {
      const bool ok = tid < nr;
      lis[tid] = ok ? ib[(s0 + tid) * g.iss] : 0.f;
      lfs[tid] = ok ? fb[(s0 + tid) * g.fss] : 0.f;
    }
    for (int e = tid; e < CH * VT; e += THREADS) {
      const int r = e / VT, c = e % VT;
      Vs[r * VST + c] = r < nr ? to_f32(vb[(s0 + r) * g.vss + c]) : 0.f;
    }
    __syncthreads();

    // 2. warp 0: lf = cumsum(logf), two rows a lane
    if (tid < 32) {
      const float v0 = lfs[2 * tid], v1 = lfs[2 * tid + 1];
      float incl = v0 + v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += t;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      lfs[2 * tid] = excl + v0;
      lfs[2 * tid + 1] = excl + v0 + v1;
    }
    __syncthreads();

    // 3. a thread per row: m = max(max_{s<=t} logD, lf), exp(lf - m) and
    //    the decay of the row's contribution to the chunk's end
    if (tid < CH) {
      const float lft = lfs[tid];
      float mi = -1e30f;
      for (int s = 0; s <= tid; ++s) mi = fmaxf(mi, lft - lfs[s] + lis[s]);
      const float m = fmaxf(mi, lft);
      ms[tid] = m;
      wl[tid] = expf(lft - m);
      dec[tid] = expf(lfs[CH - 1] - lft + lis[tid]);
    }

    // 4. per key slice: q k^T and q C (rows ty*4.., columns tx + 16j),
    //    q n (a thread per row), then the slice's rows of C and n updated
    float qk[4][4], inter[4][VJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) qk[i][j] = 0.f;
#pragma unroll
      for (int c = 0; c < VJ; ++c) inter[i][c] = 0.f;
    }
    float qn = 0.f;
    const float eend = expf(lfs[CH - 1]);
    for (int sl = 0; sl < NSL; ++sl) {
      const int k0 = sl * KS;
      __syncthreads();           // the last slice's update has read Ks
      for (int e = tid; e < CH * KS; e += THREADS) {
        const int r = e / KS, c = e % KS;
        const bool ok = r < nr;
        Qs[r * QST + c] = ok ? to_f32(qb[(s0 + r) * g.qss + k0 + c]) : 0.f;
        Ks[r * QST + c] = ok ? to_f32(kb[(s0 + r) * g.kss + k0 + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KS; ++kk) {
        float qv[4], kv[4], cv[VJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * QST + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * QST + kk];
#pragma unroll
        for (int c = 0; c < VJ; ++c) cv[c] = Cs[(k0 + kk) * VST + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) qk[i][j] = fmaf(qv[i], kv[j], qk[i][j]);
#pragma unroll
          for (int c = 0; c < VJ; ++c)
            inter[i][c] = fmaf(qv[i], cv[c], inter[i][c]);
        }
      }
      if (tid < CH) {
        for (int kk = 0; kk < KS; ++kk)
          qn = fmaf(Qs[tid * QST + kk], ns[k0 + kk], qn);
      }
      __syncthreads();           // every thread has read this slice's C, n
      // C[k0 + ty + 16a, tx + 16c] = e^{lf_end} C + sum_r k_r dec_r v_r
      {
        float acc[KJ][VJ];
#pragma unroll
        for (int a = 0; a < KJ; ++a)
#pragma unroll
          for (int c = 0; c < VJ; ++c) acc[a][c] = 0.f;
        for (int r = 0; r < nr; ++r) {
          const float d = dec[r];
          float kv[KJ], vv[VJ];
#pragma unroll
          for (int a = 0; a < KJ; ++a) kv[a] = Ks[r * QST + ty + 16 * a] * d;
#pragma unroll
          for (int c = 0; c < VJ; ++c) vv[c] = Vs[r * VST + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < KJ; ++a)
#pragma unroll
            for (int c = 0; c < VJ; ++c) acc[a][c] = fmaf(kv[a], vv[c], acc[a][c]);
        }
#pragma unroll
        for (int a = 0; a < KJ; ++a)
#pragma unroll
          for (int c = 0; c < VJ; ++c) {
            float* cp = Cs + (k0 + ty + 16 * a) * VST + tx + 16 * c;
            *cp = eend * *cp + acc[a][c];
          }
        if (tid < KS) {
          float s = 0.f;
          for (int r = 0; r < nr; ++r) s = fmaf(Ks[r * QST + tid], dec[r], s);
          ns[k0 + tid] = eend * ns[k0 + tid] + s;
        }
      }
    }

    // 5. W = (q k^T) o exp(logD - m) on the lower triangle, 0 above it
    //    (the reference's exp(-1e30 - m))
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = tx + 16 * j;
        Ws[r * WST + s] =
            s <= r ? qk[i][j] * expf(lfs[r] - lfs[s] + lis[s] - ms[r]) : 0.f;
      }
    }
    __syncthreads();
    // 6. den = rowsum W + exp(lf - m) (q n), clamped at exp(-m)
    if (tid < CH) {
      float s = 0.f;
      for (int j = 0; j <= tid; ++j) s += Ws[tid * WST + j];
      const float den = s + wl[tid] * qn;
      dens[tid] = fmaxf(fabsf(den), expf(-ms[tid]));
    }
    __syncthreads();
    // 7. y = (W v + exp(lf - m) q C) / den; rows ty*4.., columns tx + 16c
    {
      float acc[4][VJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < VJ; ++c) acc[i][c] = 0.f;
      const int jend = min(ty * 4 + 4, nr);   // W is 0 past the last row
      for (int j = 0; j < jend; ++j) {
        float w[4], vv[VJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = Ws[(ty * 4 + i) * WST + j];
#pragma unroll
        for (int c = 0; c < VJ; ++c) vv[c] = Vs[j * VST + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < VJ; ++c) acc[i][c] = fmaf(w[i], vv[c], acc[i][c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        if (r >= nr) continue;
        const float w = wl[r], dn = dens[r];
        TO* yr = yb + (s0 + r) * g.yss;
#pragma unroll
        for (int c = 0; c < VJ; ++c)
          from_f32(yr + tx + 16 * c, (acc[i][c] + w * inter[i][c]) / dn);
      }
    }
  }
}

template <typename TI, typename TO, int HD>
int launch_hd(const Args& g, int B, cudaStream_t stream) {
  constexpr int VT = HD < 64 ? HD : 64;
  const size_t smem = sizeof(float) * smem_floats<HD>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mlstm_kernel<TI, TO, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mlstm_kernel<TI, TO, HD>
      <<<dim3(HD / VT, g.NH, B), THREADS, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

template <typename TI, typename TO>
int launch(const Args& g, int B, int HD, cudaStream_t stream) {
  if (B <= 0 || g.NH <= 0 || g.S <= 0 || B > 65535 || g.NH > 65535)
    return (int)cudaErrorInvalidValue;
  switch (HD) {
    case 32: return launch_hd<TI, TO, 32>(g, B, stream);
    case 64: return launch_hd<TI, TO, 64>(g, B, stream);
    case 384: return launch_hd<TI, TO, 384>(g, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 18 int64 element strides (b, h, s) of q, k, v, logi, logf, y;
// the last dim of q, k, v and y is contiguous
#define MLSTM_ENTRY(NAME, TI, TO)                                             \
  extern "C" int NAME(const void* q, const void* k, const void* v,           \
                      const float* li, const float* lf, void* y, int B,      \
                      int NH, int S, int HD, const long long* st,            \
                      void* stream) {                                        \
    const Args g{q, k, v, li, lf, y, NH, S,                                  \
                 st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],     \
                 st[8], st[9], st[10], st[11], st[12], st[13], st[14],       \
                 st[15], st[16], st[17]};                                    \
    return launch<TI, TO>(g, B, HD, (cudaStream_t)stream);                   \
  }

MLSTM_ENTRY(mlstm_chunkwise_f32_f32, float, float)
MLSTM_ENTRY(mlstm_chunkwise_f32_bf16, float, __nv_bfloat16)
MLSTM_ENTRY(mlstm_chunkwise_bf16_f32, __nv_bfloat16, float)
MLSTM_ENTRY(mlstm_chunkwise_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
