// mlstm_chunkwise_bwd: the gradient of the chunkwise xLSTM mLSTM, for
// Hopper (sm_90a).
//
// The TPU kernel src/repro/kernels/mlstm_kernel.py (mlstm_chunkwise /
// _mlstm_kernel) has no backward: the reference differentiates its jnp
// mirror models/xlstm.py::mlstm_apply. This kernel differentiates the
// forward kernel csrc/mlstm_chunkwise.cu (64-row chunks) by the reverse
// chunked recurrence of kernels/mlstm_kernel.py's docstring, which also
// proves that the stabiliser m carries no gradient (y = num_abs /
// max(|den_abs|, 1) whatever m is): m is recomputed from logi and logf,
// as the forward computes it, and treated as a constant. Per chunk, with
// d = max(|den|, exp(-m)), delta_t = sum_j dy_tj y_tj, g = exp(lf - m),
// r = exp(lf_end - lf + logi), E = exp(logD - m) and the dC, dn carried
// back from the next chunk:
//   dnum = dy / d, dden = -sign(den) [|den| > exp(-m)] delta / d
//   dW = dnum v^T + dden (lower triangle), dS = dW o E, M = dW o W
//   dq = dS k + g o (dnum C0^T + dden n0)
//   dk = dS^T q + r o (v dC^T + dn),   dv = W^T dnum + r o (k dC)
//   dlogi = colsum M + r dr, dlf = rowsum M - colsum M + g dg - r dr
//     (+ on the last row sum r dr + exp(lf_end)(<dC, C0> + <dn, n0>)),
//     reverse-cumsummed into dlogf
//   dC0 = exp(lf_end) dC + (g o q)^T dnum, dn0 = exp(lf_end) dn + (g dden)^T q
//
// Layout as the forward's: q, k, v (B, NH, S, hd) in the input type;
// logi, logf (B, NH, S) f32; y and dy (B, NH, S, hd) f32 (the model's y
// is f32; the wrapper converts another); dq, dk, dv in the input type and
// dlogi, dlogf f32, each through element strides of its outer dims (last
// dim contiguous), so each gradient takes its input's layout. Rows past S
// are zeros with logi = logf = 0: they add nothing and are never written.
//
// Three launches, f32 on the CUDA cores (inputs converted at load):
//  1. mlstm_delta: delta_t = sum_j dy_tj y_tj, a warp a row (delta needs
//     the whole row, which no block of 2. holds: FlashAttention-2's
//     rowsum(dO o O));
//  2. mlstm_bwd_kernel: one block per (64 value columns, head, batch
//     row), as the forward's. A forward sweep stores the block's columns
//     of C and its own copy of n at each chunk start in the scratch cbuf
//     (B, NH, chunks, hd, hd) and nbuf (B, NH, column blocks, chunks,
//     hd); then the reverse sweep with the block's dC columns (hd x 64
//     f32, 96 KB at hd 384) and dn in shared memory. Per chunk: q k^T, q
//     C0 and q n over 64-key slices (q, k and C0 slices staged), W, den,
//     d and dden (den needs only q k^T and n: every block has it whole),
//     dnum, dW over the block's value columns, M's row sums by shuffles
//     and column sums by per-row-group partials, dv (complete in the
//     block: its columns of dnum and dC), dr, then per key slice dq, dk,
//     <dC, C0> and the slice's dC update, and the gates' gradients with
//     one warp's reverse cumsum. dW, and so dq, dk, dlogi and dlogf, are
//     sums over the column blocks: each block writes its part (the dden
//     and n terms in block 0's alone, dn carried by every block) to the
//     f32 scratch dqp, dkp (B, NH, blocks, S, hd) and dip, dfp (B, NH,
//     blocks, S);
//  3. mlstm_bwd_reduce sums the parts in block order. No atomics:
//     repeated runs are bitwise equal.
// Shared memory at hd 384: dC's columns (99.8 KB padded), the q, k and C0
// slices, v, dnum and W / dS tiles (16.6 KB each) and the vectors: 206
// KB, one block an SM. Registers: the 4 x 4 patches of q k^T and dS and
// 4 x 16 of q C0, dv and the slice products, no state.
//
// Bytes: the inputs, y, dy and the gradients once each are about 505 MB
// at the xlstm prefill's shape (B=8, NH=4, S=2048, hd=384, q/k/v bf16),
// 0.151 ms at 3.35 TB/s. This design also writes and reads the chunk-start
// C (604 MB each way there), writes and reads the six blocks' parts of dq
// and dk (604 MB each way each), and reads q and k three times in each
// block (six blocks a head): about 10x those bytes. Tensor cores and no
// scratch round trip are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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

// sum over the 16 lanes of a row group (lanes tid % 16 of one ty), in a
// fixed order
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* li;
  const float* lf;
  const float* dy;
  const float* delta;          // (B, NH, S)
  float* cbuf;                 // (B, NH, nch, HD, HD) chunk-start C
  float* nbuf;                 // (B, NH, NCB, nch, HD) chunk-start n
  float* dqp;                  // (B, NH, NCB, S, HD) parts of dq
  float* dkp;                  // (B, NH, NCB, S, HD) parts of dk
  float* dip;                  // (B, NH, NCB, S) parts of dlogi
  float* dfp;                  // (B, NH, NCB, S) parts of dlogf
  void* dv;
  int NH, S, nch;
  // element strides (b, h, s): q, k, v, logi, logf, dy, dv
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, isb, ish, iss, fsb,
      fsh, fss, ysb, ysh, yss, gvsb, gvsh, gvss;
};

// delta = rowsum(dy o y), a warp a row
__global__ void mlstm_delta(const float* y, const float* dy, float* delta,
                            int B, int NH, int S, int HD, long long ysb,
                            long long ysh, long long yss, long long dsb,
                            long long dsh, long long dss) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)B * NH * S) return;
  const int s = row % S;
  const int h = (row / S) % NH;
  const int b = row / ((long long)S * NH);
  const float* yr = y + b * ysb + h * ysh + s * yss;
  const float* dr = dy + b * dsb + h * dsh + s * dss;
  float acc = 0.f;
  for (int j = lane; j < HD; j += 32) acc = fmaf(yr[j], dr[j], acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) delta[row] = acc;
}

template <int HD>
constexpr size_t smem_floats() {
  constexpr int VT = HD < 64 ? HD : 64;
  constexpr int KS = HD < 64 ? HD : 64;
  return (size_t)HD * (VT + 1) + 2 * CH * (KS + 1) + KS * (VT + 1) +
         2 * CH * (VT + 1) + CH * (CH + 1) + 16 * CH + 2 * HD + 15 * CH + 8;
}

template <typename TI, int HD>
__global__ void __launch_bounds__(THREADS) mlstm_bwd_kernel(Args g) {
  constexpr int VT = HD < 64 ? HD : 64;   // value columns per block
  constexpr int KS = HD < 64 ? HD : 64;   // key dims per staged slice
  constexpr int NSL = HD / KS;            // key slices
  constexpr int NCB = HD / VT;            // column blocks of a head
  constexpr int QST = KS + 1;             // padded rows of Qs, Ks
  constexpr int VST = VT + 1;             // padded rows of Vs, DNs, C0s, dCs
  constexpr int WST = CH + 1;             // padded rows of Ws
  constexpr int VJ = VT / 16;             // value columns per thread
  constexpr int KJ = KS / 16;             // key columns (rows) per thread
  extern __shared__ float smem[];
  float* dCs = smem;                // [HD][VT+1] C (sweep 1), then dC (2)
  float* Qs = dCs + HD * VST;       // [CH][KS+1] q, one key slice
  float* Ks = Qs + CH * QST;        // [CH][KS+1] k, one key slice
  float* C0s = Ks + CH * QST;       // [KS][VT+1] the chunk-start C's slice
  float* Vs = C0s + KS * VST;       // [CH][VT+1] v, this block's columns
  float* DNs = Vs + CH * VST;       // [CH][VT+1] dy, then dnum
  float* Ws = DNs + CH * VST;       // [CH][CH+1] W, then dS
  float* colp = Ws + CH * WST;      // [16][CH]   M's column sums per row group
  float* ns = colp + 16 * CH;       // [HD] n (sweep 1), the chunk-start n (2)
  float* dns = ns + HD;             // [HD] dn, carried back
  float* lfs = dns + HD;            // [CH] logf, then lf
  float* lis = lfs + CH;            // [CH] logi
  float* ms = lis + CH;             // [CH] m
  float* wl = ms + CH;              // [CH] g = exp(lf - m)
  float* dec = wl + CH;             // [CH] r = exp(lf_end - lf + logi)
  float* emn = dec + CH;            // [CH] exp(-m)
  float* dd = emn + CH;             // [CH] d = max(|den|, exp(-m))
  float* ddn = dd + CH;             // [CH] dden
  float* dlt = ddn + CH;            // [CH] delta
  float* dgv = dlt + CH;            // [CH] dg (this block's part)
  float* drv = dgv + CH;            // [CH] dr (this block's part, no dn term)
  float* rowM = drv + CH;           // [CH]
  float* colM = rowM + CH;          // [CH]
  float* qns = colM + CH;           // [CH] q . n0
  float* kdn = qns + CH;            // [CH] k . dn1
  float* red = kdn + CH;            // [8] a block reduction's warp sums

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int j0 = tile * VT;
  const bool lead = tile == 0;      // adds the dden and n terms
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int lane = tid % 32, warp = tid / 32;

  const TI* qb = static_cast<const TI*>(g.q) + b * g.qsb + h * g.qsh;
  const TI* kb = static_cast<const TI*>(g.k) + b * g.ksb + h * g.ksh;
  const TI* vb = static_cast<const TI*>(g.v) + b * g.vsb + h * g.vsh + j0;
  const float* ib = g.li + b * g.isb + h * g.ish;
  const float* fb = g.lf + b * g.fsb + h * g.fsh;
  const float* yb = g.dy + b * g.ysb + h * g.ysh + j0;
  const float* deb = g.delta + ((size_t)b * g.NH + h) * g.S;
  const size_t bh = (size_t)b * g.NH + h;
  float* cbb = g.cbuf + bh * g.nch * HD * HD;
  float* nbb = g.nbuf + (bh * NCB + tile) * g.nch * HD;
  float* dqb = g.dqp + (bh * NCB + tile) * g.S * HD;
  float* dkb = g.dkp + (bh * NCB + tile) * g.S * HD;
  float* dib = g.dip + (bh * NCB + tile) * g.S;
  float* dfb = g.dfp + (bh * NCB + tile) * g.S;
  TI* dvb = static_cast<TI*>(g.dv) + b * g.gvsb + h * g.gvsh + j0;

  // a chunk's gates: lf = cumsum(logf) (warp 0), then a thread per row m
  // (as the forward kernel takes it), g, r and exp(-m)
  auto gates = [&](int s0, int nr) {
    if (tid < CH) {
      const bool ok = tid < nr;
      lis[tid] = ok ? ib[(s0 + tid) * g.iss] : 0.f;
      lfs[tid] = ok ? fb[(s0 + tid) * g.fss] : 0.f;
    }
    __syncthreads();
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
    if (tid < CH) {
      const float lft = lfs[tid];
      float mi = -1e30f;
      for (int s = 0; s <= tid; ++s) mi = fmaxf(mi, lft - lfs[s] + lis[s]);
      const float m = fmaxf(mi, lft);
      ms[tid] = m;
      wl[tid] = expf(lft - m);
      dec[tid] = expf(lfs[CH - 1] - lft + lis[tid]);
      emn[tid] = expf(-m);
    }
    __syncthreads();
  };

  auto load_slice = [&](float* dst, const TI* src, long long ss, int s0,
                        int nr, int k0) {
    for (int e = tid; e < CH * KS; e += THREADS) {
      const int r = e / KS, c = e % KS;
      dst[r * QST + c] = r < nr ? to_f32(src[(s0 + r) * ss + k0 + c]) : 0.f;
    }
  };

  // ---------------------------------------------- 1. the forward sweep
  for (int e = tid; e < HD * VST; e += THREADS) dCs[e] = 0.f;
  for (int e = tid; e < HD; e += THREADS) ns[e] = 0.f;
  for (int c = 0; c < g.nch; ++c) {
    const int s0 = c * CH, nr = min(CH, g.S - s0);
    __syncthreads();             // the last chunk's update is done
    float* cc = cbb + (size_t)c * HD * HD;
    for (int e = tid; e < HD * VT; e += THREADS) {
      const int kk = e / VT, j = e % VT;
      cc[(size_t)kk * HD + j0 + j] = dCs[kk * VST + j];
    }
    for (int e = tid; e < HD; e += THREADS) nbb[(size_t)c * HD + e] = ns[e];
    for (int e = tid; e < CH * VT; e += THREADS) {
      const int r = e / VT, j = e % VT;
      Vs[r * VST + j] = r < nr ? to_f32(vb[(s0 + r) * g.vss + j]) : 0.f;
    }
    gates(s0, nr);
    const float eend = expf(lfs[CH - 1]);
    for (int sl = 0; sl < NSL; ++sl) {
      const int k0 = sl * KS;
      __syncthreads();           // the last slice's update has read Ks
      load_slice(Ks, kb, g.kss, s0, nr, k0);
      __syncthreads();
      float acc[KJ][VJ];
#pragma unroll
      for (int a = 0; a < KJ; ++a)
#pragma unroll
        for (int cc2 = 0; cc2 < VJ; ++cc2) acc[a][cc2] = 0.f;
      for (int r = 0; r < nr; ++r) {
        const float d = dec[r];
        float kv[KJ], vv[VJ];
#pragma unroll
        for (int a = 0; a < KJ; ++a) kv[a] = Ks[r * QST + ty + 16 * a] * d;
#pragma unroll
        for (int cc2 = 0; cc2 < VJ; ++cc2) vv[cc2] = Vs[r * VST + tx + 16 * cc2];
#pragma unroll
        for (int a = 0; a < KJ; ++a)
#pragma unroll
          for (int cc2 = 0; cc2 < VJ; ++cc2)
            acc[a][cc2] = fmaf(kv[a], vv[cc2], acc[a][cc2]);
      }
#pragma unroll
      for (int a = 0; a < KJ; ++a)
#pragma unroll
        for (int cc2 = 0; cc2 < VJ; ++cc2) {
          float* cp = dCs + (k0 + ty + 16 * a) * VST + tx + 16 * cc2;
          *cp = eend * *cp + acc[a][cc2];
        }
      if (tid < KS) {
        float s = 0.f;
        for (int r = 0; r < nr; ++r) s = fmaf(Ks[r * QST + tid], dec[r], s);
        ns[k0 + tid] = eend * ns[k0 + tid] + s;
      }
    }
  }

  // ---------------------------------------------- 2. the reverse sweep
  __syncthreads();
  for (int e = tid; e < HD * VST; e += THREADS) dCs[e] = 0.f;
  for (int e = tid; e < HD; e += THREADS) dns[e] = 0.f;
  for (int c = g.nch - 1; c >= 0; --c) {
    const int s0 = c * CH, nr = min(CH, g.S - s0);
    __syncthreads();             // the last chunk's reads and updates are done
    const float* cc = cbb + (size_t)c * HD * HD;
    for (int e = tid; e < CH * VT; e += THREADS) {
      const int r = e / VT, j = e % VT;
      const bool ok = r < nr;
      Vs[r * VST + j] = ok ? to_f32(vb[(s0 + r) * g.vss + j]) : 0.f;
      DNs[r * VST + j] = ok ? yb[(s0 + r) * g.yss + j] : 0.f;
    }
    for (int e = tid; e < HD; e += THREADS) ns[e] = nbb[(size_t)c * HD + e];
    if (tid < CH) dlt[tid] = tid < nr ? deb[s0 + tid] : 0.f;
    gates(s0, nr);
    const float eend = expf(lfs[CH - 1]);

    // 2a. q k^T (rows ty*4.., columns tx + 16j), q C0 (columns tx + 16c)
    //     and q n (a thread per row), over the key slices
    float qk[4][4], inter[4][VJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) qk[i][j] = 0.f;
#pragma unroll
      for (int cc2 = 0; cc2 < VJ; ++cc2) inter[i][cc2] = 0.f;
    }
    float qn = 0.f;
    for (int sl = 0; sl < NSL; ++sl) {
      const int k0 = sl * KS;
      __syncthreads();
      load_slice(Qs, qb, g.qss, s0, nr, k0);
      load_slice(Ks, kb, g.kss, s0, nr, k0);
      for (int e = tid; e < KS * VT; e += THREADS) {
        const int kk = e / VT, j = e % VT;
        C0s[kk * VST + j] = cc[(size_t)(k0 + kk) * HD + j0 + j];
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
        for (int cc2 = 0; cc2 < VJ; ++cc2) cv[cc2] = C0s[kk * VST + tx + 16 * cc2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) qk[i][j] = fmaf(qv[i], kv[j], qk[i][j]);
#pragma unroll
          for (int cc2 = 0; cc2 < VJ; ++cc2)
            inter[i][cc2] = fmaf(qv[i], cv[cc2], inter[i][cc2]);
        }
      }
      if (tid < CH) {
        for (int kk = 0; kk < KS; ++kk)
          qn = fmaf(Qs[tid * QST + kk], ns[k0 + kk], qn);
      }
    }

    // 2b. W = (q k^T) o exp(logD - m) on the lower triangle
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
    if (tid < CH) qns[tid] = qn;
    __syncthreads();
    // 2c. den, d and dden, the branch on the forward's stabilised values
    if (tid < CH) {
      float s = 0.f;
      for (int j = 0; j <= tid; ++j) s += Ws[tid * WST + j];
      const float den = s + wl[tid] * qn;
      const float d = fmaxf(fabsf(den), emn[tid]);
      dd[tid] = d;
      ddn[tid] = fabsf(den) > emn[tid] ? -copysignf(1.f, den) * dlt[tid] / d
                                       : 0.f;
    }
    __syncthreads();
    // 2d. dnum = dy / d in place; dg's part = dnum . (q C0) (+ dden q.n0)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const float inv = dd[r];
      float dg = 0.f;
#pragma unroll
      for (int cc2 = 0; cc2 < VJ; ++cc2) {
        float* p = DNs + r * VST + tx + 16 * cc2;
        const float v = *p / inv;
        *p = v;
        dg = fmaf(v, inter[i][cc2], dg);
      }
      dg = sum16(dg);
      if (tx == 0) dgv[r] = dg + (lead ? ddn[r] * qns[r] : 0.f);
    }
    __syncthreads();
    // 2e. dW over this block's columns (+ dden in block 0), M = dW o W and
    //     dS = dW o E, the row sums of M by shuffles, its column sums'
    //     parts per row group
    float dS[4][4];
    {
      float dW[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dW[i][j] = 0.f;
#pragma unroll 4
      for (int jj = 0; jj < VT; ++jj) {
        float dn[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) dn[i] = DNs[(ty * 4 + i) * VST + jj];
#pragma unroll
        for (int j = 0; j < 4; ++j) vv[j] = Vs[(tx + 16 * j) * VST + jj];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dW[i][j] = fmaf(dn[i], vv[j], dW[i][j]);
      }
      float csum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const float dr = lead ? ddn[r] : 0.f;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tx + 16 * j;
          float m = 0.f, ds = 0.f;
          if (s <= r) {
            const float E = expf(lfs[r] - lfs[s] + lis[s] - ms[r]);
            const float dw = dW[i][j] + dr;
            m = dw * (qk[i][j] * E);
            ds = dw * E;
          }
          dS[i][j] = ds;
          rs += m;
          csum[j] += m;
        }
        rs = sum16(rs);
        if (tx == 0) rowM[r] = rs;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) colp[ty * CH + tx + 16 * j] = csum[j];
    }
    // 2f. dv's intra-chunk term W^T dnum; rows s = ty*4.., columns tx + 16c
    float dva[4][VJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int cc2 = 0; cc2 < VJ; ++cc2) dva[i][cc2] = 0.f;
    for (int t = ty * 4; t < nr; ++t) {  // W[t][s] is 0 for t < s
      float w[4], dn[VJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = Ws[t * WST + ty * 4 + i];
#pragma unroll
      for (int cc2 = 0; cc2 < VJ; ++cc2) dn[cc2] = DNs[t * VST + tx + 16 * cc2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc2 = 0; cc2 < VJ; ++cc2) dva[i][cc2] = fmaf(w[i], dn[cc2], dva[i][cc2]);
    }
    __syncthreads();             // every read of W is done
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ws[(ty * 4 + i) * WST + tx + 16 * j] = dS[i][j];
    if (tid < CH) {
      float s = 0.f;
      for (int r = 0; r < 16; ++r) s += colp[r * CH + tid];
      colM[tid] = s;
    }

    // 2g. k dC (this block's columns) over the key slices: dv = W^T dnum +
    //     r o (k dC), written; dr's part = v . (k dC); k . dn1
    float kdc[4][VJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int cc2 = 0; cc2 < VJ; ++cc2) kdc[i][cc2] = 0.f;
    float kd = 0.f;
    for (int sl = 0; sl < NSL; ++sl) {
      const int k0 = sl * KS;
      __syncthreads();
      load_slice(Ks, kb, g.kss, s0, nr, k0);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KS; ++kk) {
        float kv[4], dc[VJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) kv[i] = Ks[(ty * 4 + i) * QST + kk];
#pragma unroll
        for (int cc2 = 0; cc2 < VJ; ++cc2) dc[cc2] = dCs[(k0 + kk) * VST + tx + 16 * cc2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int cc2 = 0; cc2 < VJ; ++cc2) kdc[i][cc2] = fmaf(kv[i], dc[cc2], kdc[i][cc2]);
      }
      if (tid < CH) {
        for (int kk = 0; kk < KS; ++kk)
          kd = fmaf(Ks[tid * QST + kk], dns[k0 + kk], kd);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = ty * 4 + i;
      float dr = 0.f;
      TI* dvr = dvb + (s0 + s) * g.gvss;
#pragma unroll
      for (int cc2 = 0; cc2 < VJ; ++cc2) {
        const int j = tx + 16 * cc2;
        if (s < nr) from_f32(dvr + j, dva[i][cc2] + dec[s] * kdc[i][cc2]);
        dr = fmaf(Vs[s * VST + j], kdc[i][cc2], dr);
      }
      dr = sum16(dr);
      if (tx == 0) drv[s] = dr;
    }
    if (tid < CH) kdn[tid] = kd;

    // 2h. per key slice: dq = dS k + g o (dnum C0^T + dden n0), dk = dS^T q
    //     + r o (v dC^T + dn), <dC, C0> and <dn, n0>, then the slice's dC
    //     and dn updated; dq rows t = ty*4.., dk rows s = ty*4.., key
    //     columns tx + 16a
    float cpart = 0.f;
    for (int sl = 0; sl < NSL; ++sl) {
      const int k0 = sl * KS;
      __syncthreads();
      load_slice(Qs, qb, g.qss, s0, nr, k0);
      load_slice(Ks, kb, g.kss, s0, nr, k0);
      for (int e = tid; e < KS * VT; e += THREADS) {
        const int kk = e / VT, j = e % VT;
        C0s[kk * VST + j] = cc[(size_t)(k0 + kk) * HD + j0 + j];
      }
      __syncthreads();
      {
        float aq[4][KJ], ak[4][KJ];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int a = 0; a < KJ; ++a) aq[i][a] = ak[i][a] = 0.f;
        const int send = min(ty * 4 + 4, nr);  // dS[t][s] is 0 for s > t
        for (int s = 0; s < send; ++s) {
          float ds[4], kv[KJ];
#pragma unroll
          for (int i = 0; i < 4; ++i) ds[i] = Ws[(ty * 4 + i) * WST + s];
#pragma unroll
          for (int a = 0; a < KJ; ++a) kv[a] = Ks[s * QST + tx + 16 * a];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int a = 0; a < KJ; ++a) aq[i][a] = fmaf(ds[i], kv[a], aq[i][a]);
        }
        for (int t = ty * 4; t < nr; ++t) {    // dS[t][s] is 0 for t < s
          float ds[4], qv[KJ];
#pragma unroll
          for (int i = 0; i < 4; ++i) ds[i] = Ws[t * WST + ty * 4 + i];
#pragma unroll
          for (int a = 0; a < KJ; ++a) qv[a] = Qs[t * QST + tx + 16 * a];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int a = 0; a < KJ; ++a) ak[i][a] = fmaf(ds[i], qv[a], ak[i][a]);
        }
        float sq[4][KJ], sk[4][KJ];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int a = 0; a < KJ; ++a) sq[i][a] = sk[i][a] = 0.f;
#pragma unroll 4
        for (int j = 0; j < VT; ++j) {
          float dn[4], vv[4], c0[KJ], dc[KJ];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dn[i] = DNs[(ty * 4 + i) * VST + j];
            vv[i] = Vs[(ty * 4 + i) * VST + j];
          }
#pragma unroll
          for (int a = 0; a < KJ; ++a) {
            c0[a] = C0s[(tx + 16 * a) * VST + j];
            dc[a] = dCs[(k0 + tx + 16 * a) * VST + j];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int a = 0; a < KJ; ++a) {
              sq[i][a] = fmaf(dn[i], c0[a], sq[i][a]);
              sk[i][a] = fmaf(vv[i], dc[a], sk[i][a]);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty * 4 + i;
          if (r >= nr) continue;
          float* qo = dqb + (size_t)(s0 + r) * HD + k0;
          float* ko = dkb + (size_t)(s0 + r) * HD + k0;
#pragma unroll
          for (int a = 0; a < KJ; ++a) {
            const int kk = tx + 16 * a;
            const float nq = lead ? ddn[r] * ns[k0 + kk] : 0.f;
            const float nk = lead ? dns[k0 + kk] : 0.f;
            qo[kk] = aq[i][a] + wl[r] * (sq[i][a] + nq);
            ko[kk] = ak[i][a] + dec[r] * (sk[i][a] + nk);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < KJ; ++a)
#pragma unroll
        for (int cc2 = 0; cc2 < VJ; ++cc2) {
          const int kk = ty + 16 * a, j = tx + 16 * cc2;
          cpart = fmaf(dCs[(k0 + kk) * VST + j], C0s[kk * VST + j], cpart);
        }
      if (lead && tid < KS) cpart = fmaf(dns[k0 + tid], ns[k0 + tid], cpart);
      __syncthreads();           // every read of this slice's dC, dn is done
      {
        float acc[KJ][VJ];
#pragma unroll
        for (int a = 0; a < KJ; ++a)
#pragma unroll
          for (int cc2 = 0; cc2 < VJ; ++cc2) acc[a][cc2] = 0.f;
        for (int t = 0; t < nr; ++t) {
          const float gt = wl[t];
          float qv[KJ], dn[VJ];
#pragma unroll
          for (int a = 0; a < KJ; ++a) qv[a] = Qs[t * QST + ty + 16 * a] * gt;
#pragma unroll
          for (int cc2 = 0; cc2 < VJ; ++cc2) dn[cc2] = DNs[t * VST + tx + 16 * cc2];
#pragma unroll
          for (int a = 0; a < KJ; ++a)
#pragma unroll
            for (int cc2 = 0; cc2 < VJ; ++cc2) acc[a][cc2] = fmaf(qv[a], dn[cc2], acc[a][cc2]);
        }
#pragma unroll
        for (int a = 0; a < KJ; ++a)
#pragma unroll
          for (int cc2 = 0; cc2 < VJ; ++cc2) {
            float* p = dCs + (k0 + ty + 16 * a) * VST + tx + 16 * cc2;
            *p = eend * *p + acc[a][cc2];
          }
        if (tid < KS) {
          float s = 0.f;
          for (int t = 0; t < nr; ++t)
            s = fmaf(Qs[t * QST + tid], wl[t] * ddn[t], s);
          dns[k0 + tid] = eend * dns[k0 + tid] + s;
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      cpart += __shfl_xor_sync(0xffffffffu, cpart, o);
    if (lane == 0) red[warp] = cpart;
    __syncthreads();

    // 2i. warp 0: the gates' gradients (this block's parts), dlf's reverse
    //     cumsum over the chunk (two rows a lane)
    if (tid < 32) {
      float end = 0.f;
      if (tid == 31) {
        float cs = 0.f;
        for (int w = 0; w < THREADS / 32; ++w) cs += red[w];
        float rs = 0.f;
        for (int s = 0; s < CH; ++s)
          rs = fmaf(dec[s], drv[s] + (lead ? kdn[s] : 0.f), rs);
        end = eend * cs + rs;
      }
      float f[2], di[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = 2 * tid + u;
        const float rdr = dec[r] * (drv[r] + (lead ? kdn[r] : 0.f));
        f[u] = rowM[r] - colM[r] + wl[r] * dgv[r] - rdr;
        di[u] = colM[r] + rdr;
      }
      f[1] += end;
      float incl = f[0] + f[1];  // suffix sums over the lanes
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_down_sync(0xffffffffu, incl, o);
        if (tid + o < 32) incl += t;
      }
      float excl = __shfl_down_sync(0xffffffffu, incl, 1);
      if (tid == 31) excl = 0.f;
      const float l1 = excl + f[1];
      const float l0 = l1 + f[0];
      const int r0 = 2 * tid, r1 = r0 + 1;
      if (r0 < nr) {
        dfb[s0 + r0] = l0;
        dib[s0 + r0] = di[0];
      }
      if (r1 < nr) {
        dfb[s0 + r1] = l1;
        dib[s0 + r1] = di[1];
      }
    }
  }
}

// dq, dk, dlogi, dlogf: the column blocks' parts summed in block order,
// a thread per (b, h, s, key dim)
template <typename TI>
__global__ void mlstm_bwd_reduce(const float* dqp, const float* dkp,
                                 const float* dip, const float* dfp, TI* dq,
                                 TI* dk, float* dli, float* dlf, int B,
                                 int NH, int S, int HD, int NCB,
                                 long long qsb, long long qsh, long long qss,
                                 long long ksb, long long ksh, long long kss,
                                 long long isb, long long ish, long long iss,
                                 long long fsb, long long fsh,
                                 long long fss) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * NH * S * HD) return;
  const int kk = idx % HD;
  const int s = (idx / HD) % S;
  const int h = (idx / ((long long)HD * S)) % NH;
  const int b = idx / ((long long)HD * S * NH);
  const size_t bh = (size_t)b * NH + h;
  const size_t part = (size_t)S * HD;
  const size_t base = bh * NCB * part + (size_t)s * HD + kk;
  float sq = 0.f, sk = 0.f;
  for (int t = 0; t < NCB; ++t) {
    sq += dqp[base + t * part];
    sk += dkp[base + t * part];
  }
  from_f32(dq + b * qsb + h * qsh + s * qss + kk, sq);
  from_f32(dk + b * ksb + h * ksh + s * kss + kk, sk);
  if (kk == 0) {
    const size_t gb = bh * NCB * S + s;
    float si = 0.f, sf = 0.f;
    for (int t = 0; t < NCB; ++t) {
      si += dip[gb + (size_t)t * S];
      sf += dfp[gb + (size_t)t * S];
    }
    dli[b * isb + h * ish + s * iss] = si;
    dlf[b * fsb + h * fsh + s * fss] = sf;
  }
}

template <typename TI, int HD>
int launch_hd(const Args& g, int B, cudaStream_t stream) {
  constexpr int NCB = HD < 64 ? 1 : HD / 64;
  const size_t smem = sizeof(float) * smem_floats<HD>();
  static bool granted = false;
  if (!granted) {
    cudaError_t err = cudaFuncSetAttribute(
        mlstm_bwd_kernel<TI, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    granted = true;
  }
  mlstm_bwd_kernel<TI, HD><<<dim3(NCB, g.NH, B), THREADS, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 36 int64 element strides (b, h, s) of q, k, v, logi, logf, y,
// dy, dq, dk, dv, dlogi, dlogf; the last dim of q, k, v, y, dy, dq, dk and
// dv is contiguous. delta (B, NH, S), cbuf (B, NH, ceil(S/64), hd, hd),
// nbuf (B, NH, hd/64 or 1, ceil(S/64), hd), dqp and dkp (B, NH, hd/64 or
// 1, S, hd), dip and dfp (B, NH, hd/64 or 1, S): f32 scratch, contiguous.
#define MLSTM_BWD_ENTRY(NAME, TI)                                             \
  extern "C" int NAME(const void* q, const void* k, const void* v,           \
                      const float* li, const float* lf, const float* y,      \
                      const float* dy, float* delta, float* cbuf,            \
                      float* nbuf, float* dqp, float* dkp, float* dip,       \
                      float* dfp, void* dq, void* dk, void* dv, float* dli,  \
                      float* dlf, int B, int NH, int S, int HD,              \
                      const long long* st, void* stream) {                   \
    if (B <= 0 || NH <= 0 || S <= 0 || B > 65535 || NH > 65535)              \
      return (int)cudaErrorInvalidValue;                                     \
    cudaStream_t cs = (cudaStream_t)stream;                                  \
    const long long rows = (long long)B * NH * S;                            \
    mlstm_delta<<<(unsigned)((rows + 7) / 8), 256, 0, cs>>>(                 \
        y, dy, delta, B, NH, S, HD, st[15], st[16], st[17], st[18], st[19],  \
        st[20]);                                                             \
    int rc = (int)cudaGetLastError();                                        \
    if (rc != 0) return rc;                                                  \
    const Args g{q, k, v, li, lf, dy, delta, cbuf, nbuf, dqp, dkp, dip,      \
                 dfp, dv, NH, S, (S + CH - 1) / CH,                          \
                 st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],     \
                 st[8], st[9], st[10], st[11], st[12], st[13], st[14],       \
                 st[18], st[19], st[20], st[27], st[28], st[29]};            \
    switch (HD) {                                                            \
      case 32: rc = launch_hd<TI, 32>(g, B, cs); break;                      \
      case 64: rc = launch_hd<TI, 64>(g, B, cs); break;                      \
      case 384: rc = launch_hd<TI, 384>(g, B, cs); break;                    \
      default: return (int)cudaErrorInvalidValue;                            \
    }                                                                        \
    if (rc != 0) return rc;                                                  \
    const int ncb = HD < 64 ? 1 : HD / 64;                                   \
    const long long total = rows * HD;                                       \
    mlstm_bwd_reduce<TI><<<(unsigned)((total + 255) / 256), 256, 0, cs>>>(   \
        dqp, dkp, dip, dfp, static_cast<TI*>(dq), static_cast<TI*>(dk), dli, \
        dlf, B, NH, S, HD, ncb, st[21], st[22], st[23], st[24],     \
        st[25], st[26], st[30], st[31], st[32], st[33], st[34], st[35]);     \
    return (int)cudaGetLastError();                                          \
  }

MLSTM_BWD_ENTRY(mlstm_chunkwise_bwd_f32, float)
MLSTM_BWD_ENTRY(mlstm_chunkwise_bwd_bf16, __nv_bfloat16)
