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
// Bound on the card: bytes. At the xlstm prefill's shape (B=8, NH=4,
// S=2048, hd=384, q/k/v bf16) the inputs, y, dy and the gradients once
// each are about 505 MB, 0.151 ms at 3.35 TB/s; at the xLSTM train path's
// (B=2, NH=4, S=1024) 63 MB, 0.019 ms. mlstm_bwd_cost counts 1.241e11
// flops at the first shape (0.125 ms at the bf16 peak).
//
// bf16 q, k, v at hd 384 (the model's training path): the tensor-core
// route, five launches. A chunkwise linear recurrence has one serial part,
// the state at each chunk boundary; every other term is local to a chunk
// once the chunk's start state (C0, n0) and end gradient (dC, dn) are
// known. So: a forward state pass, the chunk-local terms, a reverse state
// pass, and the gradients chunk by chunk. Every product runs on wgmma
// (bf16 operands from 128-byte-swizzled tiles, f32 accumulators, 64-row
// tiles; hopper.cuh), one bf16 operand each: q, k and v are exact, and
// the f32 operands (r o k, g o q, C0, dC, dnum, dS, W) are rounded to
// bf16 once. A CPU emulation of these rounding points
// (tests/test_torch_recurrent_bwd.py) puts every gradient about 5e-3 of
// its largest value off the plain backward, inside the card's 2e-2;
// keeping the forward's hi/lo pairs for all of them only brings that to
// about 3e-3 (the bf16 gradients' own rounding), so no lo product is
// kept. Each launch's blocks are one warpgroup (128 threads); tiles arrive
// by 16-byte cp.async a stage ahead; no atomics (repeated runs are
// bitwise equal).
//  1. mlstm_bwd_fstate: one block per (64 key dims x 64 value columns of
//     C, head, batch row), 36 x NH x B blocks (1152 at the prefill's
//     shape, 288 at the train path's), walking the chunks with its C tile
//     in the accumulators: store it (bf16) as the chunk's C0, then C =
//     e^{lf_end} C + (r o k)^T v, A built in registers from the k tile,
//     v the MN-major B tile; the blocks of value tile 0 carry n in f32 on
//     the CUDA cores. 77 registers, 35,328 bytes of shared memory.
//  2. mlstm_bwd_local: one block per (chunk, head, batch row), nch x NH x
//     B (1024; 128): S = q k^T, W = S o E, den from W's row sums and q .
//     n0, d, delta = rowsum(dy o y) (the forward's saved y), dden, dnum =
//     dy / d (bf16, kept for the later launches), dW = dnum v^T + dden,
//     dS = dW o E, M = dW o W and its row and column sums; dS, dS^T and
//     W^T as bf16 tiles. 130 registers, 104,448 bytes.
//  3. mlstm_bwd_rstate: as 1, in reverse: dC stored at each chunk's end,
//     then dC = e^{lf_end} dC + (g o q)^T dnum; dn beside it. 78
//     registers.
//  4. mlstm_bwd_dqdk: one block per (chunk, head, batch row), the six
//     64-key panels in turn: dq = g o (dnum C0^T) + dS k + g dden n0 and
//     dk = r o (v dC^T) + dS^T q + r dn, the C0 and dC tiles streamed
//     through a three-stage ring, dnum and v resident; q . (dnum C0^T)
//     (dg's part) and <dC, C0> on the way. 128 registers, 201,504 bytes.
//  5. mlstm_bwd_dv: one block per (chunk, head, batch row), the six
//     64-column panels of dv in turn: dv = r o (k dC) + W^T dnum (k
//     resident, dC streamed), dr = v . (k dC) + k . dn, then the gates'
//     gradients of the chunk (one warp's reverse cumsum). 61 registers,
//     112,672 bytes.
// ptxas reports no spills (chiprun_out/ptxas.txt). Scratch, allocated by
// the wrapper (bytes at the prefill's / the train path's shape): C0 and
// dC (B, NH, nch, 384, 384) bf16, 302.0 / 37.7 MB each; n0 and dn (B, NH,
// nch, 384) f32, 1.6 / 0.2 MB each; dnum (B, NH, S, 384) bf16, 50.3 / 6.3
// MB; the dS, dS^T and W^T tiles (B, NH, nch, 3, 64, 64) bf16, 25.2 / 3.1
// MB; six f32 vectors a row (1.6 / 0.2 MB) and two a chunk: 684 / 86 MB
// in all, against the CUDA-core route's 1.82 GB / 227 MB. C0 and dC
// written and read dominate the bytes the route moves.
//
// f32 inputs (the reduced reference phases and the f32 checks at 1e-3),
// and bf16 at hd 32 and 64 (no main path): the CUDA-core kernel of the
// first port, unchanged, three launches, f32 on the CUDA cores (inputs
// converted at load):
//  1. mlstm_delta: delta_t = sum_j dy_tj y_tj, a warp a row (delta needs
//     the whole row, which no block of 2. holds: FlashAttention-2's
//     rowsum(dO o O));
//  2. mlstm_bwd_kernel: one block per (64 value columns, head, batch
//     row), as the forward's. A forward sweep stores the block's columns
//     of C and its own copy of n at each chunk start in the scratch cbuf
//     (B, NH, chunks, hd, hd) and nbuf (B, NH, column blocks, chunks,
//     hd); then the reverse sweep with the block's dC columns in shared
//     memory. Per chunk: q k^T, q C0 and q n over 64-key slices, W, den,
//     d and dden, dnum, dW over the block's value columns, M's row and
//     column sums, dv (complete in the block), dr, then per key slice dq,
//     dk, <dC, C0> and the slice's dC update, and the gates' gradients
//     with one warp's reverse cumsum. dW, and so dq, dk, dlogi and dlogf,
//     are sums over the column blocks: each block writes its part (the
//     dden and n terms in block 0's alone, dn carried by every block) to
//     the f32 scratch dqp, dkp (B, NH, blocks, S, hd) and dip, dfp (B,
//     NH, blocks, S);
//  3. mlstm_bwd_reduce sums the parts in block order.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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

// ------------------------------------------------------ tensor cores
// bf16 q, k, v at hd 384 (the model's training path): five launches, the
// products on wgmma, one bf16 operand each (the note at the top).
namespace tcb {

using bf16 = __nv_bfloat16;
using hopper::acc_col;
using hopper::acc_row;
using hopper::align1024;
using hopper::swz;
using hopper::TILE64;

constexpr int HD = 384;
constexpr int NP = HD / 64;           // 64-column panels of a row
constexpr int NT = 128;               // one warpgroup a block
constexpr int NST_DQDK = 3;           // stages of mlstm_bwd_dqdk's stream
constexpr int NST_DV = 2;             // stages of mlstm_bwd_dv's stream
// per-row vectors rv (B, NH, S, RVN) f32
constexpr int RV_G = 0;               // g = exp(lf - m)
constexpr int RV_R = 1;               // r = exp(lf_end - lf + logi)
constexpr int RV_GD = 2;              // g dden
constexpr int RV_A1 = 3;              // rowsum M - colsum M + g dden (q . n0)
constexpr int RV_CM = 4;              // colsum M
constexpr int RV_DGQ = 5;             // q . (dnum C0^T)
constexpr int RVN = 6;
// per-chunk scalars cv (B, NH, nch, 2) f32: exp(lf_end), <dC, C0>

// a chunk's gates by one warp from its logi and logf, rows 2 lane and 2
// lane + 1 (0 at or past S): lf = cumsum(logf), m = lf + max(0, max_{s <=
// t}(logi_s - lf_s)) (= max(max_s logD, lf), the forward's stabiliser),
// lf_end
__device__ __forceinline__ void chunk_gates(const float (&li)[2],
                                            const float (&gf)[2], int lane,
                                            float (&lf)[2], float (&m)[2],
                                            float& lend) {
  float incl = gf[0] + gf[1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  lf[0] = excl + gf[0];
  lf[1] = lf[0] + gf[1];
  const float p0 = li[0] - lf[0], p1 = fmaxf(p0, li[1] - lf[1]);
  float mx = p1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, mx, o);
    if (lane >= o) mx = fmaxf(mx, t);
  }
  float ex = __shfl_up_sync(0xffffffffu, mx, 1);
  if (lane == 0) ex = -1e30f;
  m[0] = lf[0] + fmaxf(0.f, fmaxf(ex, p0));
  m[1] = lf[1] + fmaxf(0.f, fmaxf(ex, p1));
  lend = __shfl_sync(0xffffffffu, lf[1], 31);
}

// ------------------------------------------------ 1, 3: the state passes
struct StateArgs {
  const bf16* x;        // A's rows: k (forward) or q (reverse)
  const bf16* y;        // B: v (forward) or dnum (reverse)
  long long xsb, xsh, xss, ysb, ysh, yss;
  const float* li;
  const float* lf;
  long long isb, ish, iss, fsb, fsh, fss;
  const float* rv;      // reverse: g dden
  bf16* st;             // (B, NH, nch, HD, HD) C0 / dC, rows key dims
  float* vst;           // (B, NH, nch, HD) n0 / dn
  int NH, S, nch;
};

constexpr int SJ = 1;                 // 64-column value tiles a block
constexpr int SMEM_STATE = 2 * (1 + SJ) * TILE64 + 6 * 64 * 4 + 1024;

// One block per (64 key dims x SJ * 64 value columns of the state, head,
// batch row), walking the chunks in order (forward: C, n) or in reverse
// (dC, dn). Per chunk it stores the state (bf16), then D = e^{lf_end} D +
// (sc o x)^T y with sc = r (forward) or g (reverse): A = (sc o x)^T built
// in registers from the x tile (the register-A operand of wgmma), y's SJ
// tiles the MN-major B operands. Every warp takes the chunk's gates
// itself (no barrier for them). Blocks of value block 0 carry the vector
// (n or dn) for their 64 key dims on the CUDA cores, in f32: vec =
// e^{lf_end} vec + sum_s sc2_s x_s with sc2 = r or g dden. The next
// chunk's tiles and gate rows load while this one computes.
template <bool REV>
__device__ __forceinline__ void state_pass(const StateArgs& g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* X = sm;                          // [2] x tiles
  uint8_t* Y = sm + 2 * TILE64;             // [2][SJ] y tiles
  float* gin = reinterpret_cast<float*>(Y + 2 * SJ * TILE64);  // [2][3][64]
  const int kb = blockIdx.x / (NP / SJ), jb = blockIdx.x % (NP / SJ);
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3, i0 = 16 * warp;
  const bf16* xb = g.x + b * g.xsb + h * g.xsh + kb * 64;
  const bf16* yb = g.y + b * g.ysb + h * g.ysh + jb * SJ * 64;
  const float* ib = g.li + b * g.isb + h * g.ish;
  const float* fb = g.lf + b * g.fsb + h * g.fsh;
  const size_t bh = (size_t)b * g.NH + h;
  const bool vec = jb == 0 && tid < 64;     // warps 0 and 1 whole
  auto chunk_of = [&](int i) { return REV ? g.nch - 1 - i : i; };
  auto load = [&](int i) {
    if (i < g.nch) {
      const int s0 = chunk_of(i) * 64, nr = min(64, g.S - s0);
      hopper::load_tile64(X + (i & 1) * TILE64, xb + s0 * g.xss, g.xss, nr,
                          tid, NT);
      for (int j = 0; j < SJ; ++j)
        hopper::load_tile64(Y + ((i & 1) * SJ + j) * TILE64,
                            yb + s0 * g.yss + 64 * j, g.yss, nr, tid, NT);
      // the chunk's logi, logf (and g dden in reverse); 0 past S
      if (tid < 64) {
        float* d = gin + (i & 1) * 3 * 64 + tid;
        const bool ok = tid < nr;
        const long long r = s0 + (ok ? tid : 0);
        hopper::cp_async4(d, ib + r * g.iss, ok ? 4 : 0);
        hopper::cp_async4(d + 64, fb + r * g.fss, ok ? 4 : 0);
        if (REV)
          hopper::cp_async4(d + 128, g.rv + (bh * g.S + r) * RVN + RV_GD,
                            ok ? 4 : 0);
      }
    }
    hopper::cp_async_commit();
  };
  float acc[SJ][32];
#pragma unroll
  for (int j = 0; j < SJ; ++j)
#pragma unroll
    for (int ix = 0; ix < 32; ++ix) acc[j][ix] = 0.f;
  float nv = 0.f;
  load(0);
  for (int i = 0; i < g.nch; ++i) {
    const int c = chunk_of(i);
    load(i + 1);
    bf16* so = g.st + ((bh * g.nch + c) * HD + kb * 64) * HD + jb * SJ * 64;
#pragma unroll
    for (int j = 0; j < SJ; ++j)
#pragma unroll
      for (int ix = 0; ix < 32; ix += 2)
        *reinterpret_cast<__nv_bfloat162*>(
            so + (size_t)acc_row(i0, gq, ix) * HD + 64 * j + acc_col(tq, ix)) =
            __floats2bfloat162_rn(acc[j][ix], acc[j][ix + 1]);
    if (vec) g.vst[(bh * g.nch + c) * HD + kb * 64 + tid] = nv;
    hopper::cp_async_wait<1>();
    hopper::fence_proxy_async();
    __syncthreads();             // this chunk's tiles and gate rows are in
    // the gates, in every warp: sc (and sc2) of rows 2 lane, 2 lane + 1
    const float* gi = gin + (i & 1) * 3 * 64;
    float sc[2], sc2[2], eend;
    {
      const float li[2] = {gi[2 * lane], gi[2 * lane + 1]};
      const float gf[2] = {gi[64 + 2 * lane], gi[65 + 2 * lane]};
      float lf[2], m[2], lend;
      chunk_gates(li, gf, lane, lf, m, lend);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        sc[u] = REV ? expf(lf[u] - m[u]) : expf(lend - lf[u] + li[u]);
        sc2[u] = REV ? gi[128 + 2 * lane + u] : sc[u];
      }
      eend = expf(lend);
    }
    // A = (sc o x)^T as register fragments: element (row, k) is x's (k,
    // row) scaled by sc_k; rows i0 + gq (+8), k = 16 kk + 2 tq (+1, +8)
    const uint8_t* Xc = X + (i & 1) * TILE64;
    uint32_t af[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int src = 8 * kk + tq + 4 * hh;       // the lane of rows k, k+1
        const float s0v = __shfl_sync(0xffffffffu, sc[0], src);
        const float s1v = __shfl_sync(0xffffffffu, sc[1], src);
        const int k = 2 * src;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int row = i0 + gq + 8 * u;
          af[kk][2 * hh + u] = hopper::pack_bf16(hopper::tile_f32(Xc, k, row) * s0v,
                                                 hopper::tile_f32(Xc, k + 1, row) * s1v);
        }
      }
#pragma unroll
    for (int j = 0; j < SJ; ++j)
#pragma unroll
      for (int ix = 0; ix < 32; ++ix) acc[j][ix] *= eend;
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < SJ; ++j)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_rs(acc[j], af[kk],
                         hopper::desc(Y + ((i & 1) * SJ + j) * TILE64 +
                                          kk * 16 * 128,
                                      TILE64, 1024));
    hopper::wgmma_commit();
    if (jb == 0 && warp < 2) {
      float s = 0.f;
      for (int r = 0; r < 64; r += 2) {
        const float a0 = __shfl_sync(0xffffffffu, sc2[0], r >> 1);
        const float a1 = __shfl_sync(0xffffffffu, sc2[1], r >> 1);
        s = fmaf(a0, hopper::tile_f32(Xc, r, tid), fmaf(a1, hopper::tile_f32(Xc, r + 1, tid), s));
      }
      nv = eend * nv + s;
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < SJ; ++j) hopper::fence_regs(acc[j]);
    __syncthreads();             // every read of this chunk's tiles is done
  }
}

__global__ void __launch_bounds__(NT) mlstm_bwd_fstate(StateArgs g) {
  state_pass<false>(g);
}

__global__ void __launch_bounds__(NT) mlstm_bwd_rstate(StateArgs g) {
  state_pass<true>(g);
}

// ------------------------------------------ 2: the chunk-local terms
struct LocArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss;
  const float* li;
  const float* lf;
  long long isb, ish, iss, fsb, fsh, fss;
  const float* y;
  const float* dy;
  long long ysb, ysh, yss, dsb, dsh, dss;
  const float* n0;      // (B, NH, nch, HD)
  bf16* dnum;           // (B, NH, S, HD)
  bf16* tiles;          // (B, NH, nch, 3, 64, 64): dS, dS^T, W^T
  float* rv;
  float* cv;
  int NH, S, nch;
};

constexpr int LOC_VEC = HD + 14 * 64;        // floats after the tiles
constexpr int SMEM_LOCAL = 2 * NP * TILE64 + LOC_VEC * 4 + 1024;

// One block per (chunk, head, batch row). S = q k^T over the six panels;
// W = S o E with E = exp(lf_t - m_t + logi_s - lf_s) on the lower
// triangle; den = rowsum W + g (q . n0), d = max(|den|, e^{-m}), delta =
// rowsum(dy o y), dden; dnum = dy / d (bf16, stored for the later
// launches); dW = dnum v^T + dden on the triangle, dS = dW o E, M = dW o
// W and M's row and column sums. Stores dS, dS^T and W^T (bf16 tiles)
// and the row vectors.
__global__ void __launch_bounds__(NT) mlstm_bwd_local(LocArgs g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* Q = sm;                          // q, then dnum
  uint8_t* K = sm + NP * TILE64;            // k, then v
  float* n0s = reinterpret_cast<float*>(sm + 2 * NP * TILE64);
  float* fa = n0s + HD;                     // lf - m
  float* fbv = fa + 64;                     // logi - lf
  float* gg = fbv + 64;                     // g
  float* rr = gg + 64;                      // r
  float* em = rr + 64;                      // exp(-m)
  float* qn = em + 64;                      // q . n0
  float* dlt = qn + 64;                     // delta
  float* dd = dlt + 64;                     // d
  float* ddn = dd + 64;                     // dden
  float* rowm = ddn + 64;                   // rowsum M
  float* colp = rowm + 64;                  // [4][64] colsum M by warp
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int s0 = c * 64, nr = min(64, g.S - s0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3, i0 = 16 * warp;
  const size_t bh = (size_t)b * g.NH + h;
  const bf16* qb = g.q + b * g.qsb + h * g.qsh + s0 * g.qss;
  const bf16* kb = g.k + b * g.ksb + h * g.ksh + s0 * g.kss;
  const bf16* vb = g.v + b * g.vsb + h * g.vsh + s0 * g.vss;
  for (int p = 0; p < NP; ++p) {
    hopper::load_tile64(Q + p * TILE64, qb + 64 * p, g.qss, nr, tid, NT);
    hopper::load_tile64(K + p * TILE64, kb + 64 * p, g.kss, nr, tid, NT);
  }
  hopper::cp_async_commit();
  for (int e = tid; e < HD; e += NT)
    n0s[e] = g.n0[(bh * g.nch + c) * HD + e];
  if (warp == 0) {
    float lf[2], li[2], gf[2], m[2], lend;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = 2 * lane + u;
      li[u] = r < nr ? g.li[b * g.isb + h * g.ish + (s0 + r) * g.iss] : 0.f;
      gf[u] = r < nr ? g.lf[b * g.fsb + h * g.fsh + (s0 + r) * g.fss] : 0.f;
    }
    chunk_gates(li, gf, lane, lf, m, lend);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = 2 * lane + u;
      fa[r] = lf[u] - m[u];
      fbv[r] = li[u] - lf[u];
      gg[r] = expf(lf[u] - m[u]);
      rr[r] = expf(lend - lf[u] + li[u]);
      em[r] = expf(-m[u]);
    }
    if (lane == 0) g.cv[(bh * g.nch + c) * 2] = expf(lend);
  }
  // delta = rowsum(dy o y), a warp a row (four rows' loads in flight)
#pragma unroll 4
  for (int r = i0; r < i0 + 16; ++r) {
    float s = 0.f;
    if (r < nr) {
      const float* yr = g.y + b * g.ysb + h * g.ysh + (s0 + r) * g.yss;
      const float* dr = g.dy + b * g.dsb + h * g.dsh + (s0 + r) * g.dss;
#pragma unroll
      for (int j = lane; j < HD; j += 32) s = fmaf(yr[j], dr[j], s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) dlt[r] = s;
  }
  hopper::cp_async_wait<0>();
  hopper::fence_proxy_async();
  __syncthreads();
  float sacc[32];
  hopper::wgmma_fence();
  for (int p = 0; p < NP; ++p)
    hopper::mma64_kk(sacc, Q + p * TILE64, K + p * TILE64, p > 0);
  hopper::wgmma_commit();
  {  // q . n0, two threads a row
    const int r = tid >> 1, k0 = (tid & 1) * (HD / 2);
    float s = 0.f;
    for (int kk = k0; kk < k0 + HD / 2; ++kk)
      s = fmaf(hopper::tile_f32(Q + (kk >> 6) * TILE64, r, kk & 63), n0s[kk], s);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if ((tid & 1) == 0) qn[r] = s;
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(sacc);
  __syncthreads();               // q and k are free; q . n0 is in
  for (int p = 0; p < NP; ++p)
    hopper::load_tile64(K + p * TILE64, vb + 64 * p, g.vss, nr, tid, NT);
  hopper::cp_async_commit();
  // W in place; den, d and dden from its row sums
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int ix = 0; ix < 32; ++ix) {
    const int t = acc_row(i0, gq, ix), s = acc_col(tq, ix);
    sacc[ix] = s <= t ? sacc[ix] * expf(fa[t] + fbv[s]) : 0.f;
    rs[(ix >> 1) & 1] += sacc[ix];
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    rs[u] += __shfl_xor_sync(0xffffffffu, rs[u], 1);
    rs[u] += __shfl_xor_sync(0xffffffffu, rs[u], 2);
    const int t = i0 + gq + 8 * u;
    if (tq == 0) {
      const float den = rs[u] + gg[t] * qn[t];
      const float d = fmaxf(fabsf(den), em[t]);
      dd[t] = d;
      ddn[t] = fabsf(den) > em[t] ? -copysignf(1.f, den) * dlt[t] / d : 0.f;
    }
  }
  __syncthreads();
  // dnum = dy / d: bf16 into the q tiles (the A operand of dnum v^T) and
  // into the dnum scratch, a warp a row
#pragma unroll 4
  for (int r = i0; r < i0 + 16; ++r) {
    const bool ok = r < nr;
    const float d = dd[r];
    const float* dr = g.dy + b * g.dsb + h * g.dsh + (s0 + (ok ? r : 0)) * g.dss;
    bf16* go = g.dnum + (bh * g.S + s0 + r) * HD;
#pragma unroll
    for (int u = 0; u < NP; ++u) {
      const int col = 64 * u + 2 * lane;
      const float2 x = ok ? *reinterpret_cast<const float2*>(dr + col)
                          : make_float2(0.f, 0.f);
      const __nv_bfloat162 v2 = __floats2bfloat162_rn(x.x / d, x.y / d);
      *reinterpret_cast<__nv_bfloat162*>(Q + u * TILE64 + swz(r, 2 * lane)) =
          v2;
      if (ok) *reinterpret_cast<__nv_bfloat162*>(go + col) = v2;
    }
  }
  hopper::cp_async_wait<0>();
  hopper::fence_proxy_async();
  __syncthreads();
  float dacc[32];
  hopper::wgmma_fence();
  for (int p = 0; p < NP; ++p)
    hopper::mma64_kk(dacc, Q + p * TILE64, K + p * TILE64, p > 0);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(dacc);
  // dW, dS and M; the tiles; M's sums
  bf16* tb = g.tiles + (bh * g.nch + c) * 3 * 4096;
  float rm[2] = {0.f, 0.f}, cm[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) cm[j] = 0.f;
#pragma unroll
  for (int ix = 0; ix < 32; ix += 2) {
    float ds[2], mm[2];
    const int t = acc_row(i0, gq, ix);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int s = acc_col(tq, ix + e);
      if (s <= t) {
        const float dw = dacc[ix + e] + ddn[t];
        ds[e] = dw * expf(fa[t] + fbv[s]);
        mm[e] = dw * sacc[ix + e];
      } else {
        ds[e] = mm[e] = 0.f;
      }
      rm[(ix >> 1) & 1] += mm[e];
      cm[2 * (ix >> 2) + e] += mm[e];
      tb[4096 + s * 64 + t] = __float2bfloat16(ds[e]);
      tb[8192 + s * 64 + t] = __float2bfloat16(sacc[ix + e]);
    }
    *reinterpret_cast<__nv_bfloat162*>(tb + t * 64 + acc_col(tq, ix)) =
        __floats2bfloat162_rn(ds[0], ds[1]);
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    rm[u] += __shfl_xor_sync(0xffffffffu, rm[u], 1);
    rm[u] += __shfl_xor_sync(0xffffffffu, rm[u], 2);
    if (tq == 0) rowm[i0 + gq + 8 * u] = rm[u];
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float v = cm[j];
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    if (gq == 0) colp[warp * 64 + 8 * (j >> 1) + 2 * tq + (j & 1)] = v;
  }
  __syncthreads();
  if (tid < nr) {
    const int t = tid;
    const float cmt = colp[t] + colp[64 + t] + colp[128 + t] + colp[192 + t];
    float* o = g.rv + (bh * g.S + s0 + t) * RVN;
    const float gd = gg[t] * ddn[t];
    o[RV_G] = gg[t];
    o[RV_R] = rr[t];
    o[RV_GD] = gd;
    o[RV_A1] = rowm[t] - cmt + gd * qn[t];
    o[RV_CM] = cmt;
  }
}

// ---------------------------------- 4, 5: the chunk-parallel gradients
struct GradArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss;
  const bf16* dnum;
  const bf16* tiles;
  const bf16* c0;
  const bf16* dc;
  const float* n0;
  const float* dn;
  float* rv;
  float* cv;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  long long gqsb, gqsh, gqss, gksb, gksh, gkss, gvsb, gvsh, gvss;
  float* dli;
  float* dlf;
  long long isb, ish, iss, fsb, fsh, fss;
  int NH, S, nch;
};

constexpr int SMEM_DQDK =
    (2 * NP + 2 + 4 + 2 * NST_DQDK) * TILE64 + (2 * HD + 3 * 64 + 8) * 4 + 1024;

// One block per (chunk, head, batch row), the six 64-key panels kp in
// turn: dq = g o (dnum C0^T) + dS k + g dden n0 and dk = r o (v dC^T) +
// dS^T q + r dn, the C0 and dC tiles (kp, jt) streamed through a ring,
// dnum and v resident. Also q . (dnum C0^T) (dg's part) and <dC, C0>.
__global__ void __launch_bounds__(NT) mlstm_bwd_dqdk(GradArgs g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* DN = sm;                         // dnum, six panels
  uint8_t* V = DN + NP * TILE64;            // v, six panels
  uint8_t* DS = V + NP * TILE64;            // dS [t][s]
  uint8_t* DST = DS + TILE64;               // dS^T [s][t]
  uint8_t* QP = DST + TILE64;               // [2] q's panel kp
  uint8_t* KP = QP + 2 * TILE64;            // [2] k's panel kp
  uint8_t* RING = KP + 2 * TILE64;          // [NST] C0 tile, dC tile
  float* n0s = reinterpret_cast<float*>(RING + 2 * NST_DQDK * TILE64);
  float* dns = n0s + HD;
  float* gg = dns + HD;
  float* rr = gg + 64;
  float* gd = rr + 64;
  float* red = gd + 64;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int s0 = c * 64, nr = min(64, g.S - s0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3, i0 = 16 * warp;
  const size_t bh = (size_t)b * g.NH + h;
  const bf16* qb = g.q + b * g.qsb + h * g.qsh + s0 * g.qss;
  const bf16* kb = g.k + b * g.ksb + h * g.ksh + s0 * g.kss;
  const bf16* vb = g.v + b * g.vsb + h * g.vsh + s0 * g.vss;
  const bf16* dnb = g.dnum + (bh * g.S + s0) * HD;
  const bf16* tb = g.tiles + (bh * g.nch + c) * 3 * 4096;
  const size_t so = (bh * g.nch + c) * HD * HD;
  for (int p = 0; p < NP; ++p) {
    hopper::load_tile64(DN + p * TILE64, dnb + 64 * p, HD, nr, tid, NT);
    hopper::load_tile64(V + p * TILE64, vb + 64 * p, g.vss, nr, tid, NT);
  }
  hopper::load_tile64(DS, tb, 64, 64, tid, NT);
  hopper::load_tile64(DST, tb + 4096, 64, 64, tid, NT);
  hopper::cp_async_commit();
  constexpr int STEPS = NP * NP;
  auto issue = [&](int u) {
    if (u < STEPS) {
      const int kp = u / NP, jt = u % NP;
      uint8_t* st = RING + (u % NST_DQDK) * 2 * TILE64;
      const size_t off = so + (size_t)(64 * kp) * HD + 64 * jt;
      hopper::load_tile64(st, g.c0 + off, HD, 64, tid, NT);
      hopper::load_tile64(st + TILE64, g.dc + off, HD, 64, tid, NT);
      if (jt == 0) {
        hopper::load_tile64(QP + (kp & 1) * TILE64, qb + 64 * kp, g.qss, nr,
                            tid, NT);
        hopper::load_tile64(KP + (kp & 1) * TILE64, kb + 64 * kp, g.kss, nr,
                            tid, NT);
      }
    }
    hopper::cp_async_commit();
  };
  for (int u = 0; u < NST_DQDK - 1; ++u) issue(u);
  for (int e = tid; e < HD; e += NT) {
    n0s[e] = g.n0[(bh * g.nch + c) * HD + e];
    dns[e] = g.dn[(bh * g.nch + c) * HD + e];
  }
  if (tid < 64) {
    const bool ok = tid < nr;
    const float* o = g.rv + (bh * g.S + s0 + (ok ? tid : 0)) * RVN;
    gg[tid] = ok ? o[RV_G] : 0.f;
    rr[tid] = ok ? o[RV_R] : 0.f;
    gd[tid] = ok ? o[RV_GD] : 0.f;
  }
  float aq[32], ak[32], dgq[2] = {0.f, 0.f}, dot = 0.f;
  bf16* dqb = g.dq + b * g.gqsb + h * g.gqsh + s0 * g.gqss;
  bf16* dkb = g.dk + b * g.gksb + h * g.gksh + s0 * g.gkss;
  for (int u = 0; u < STEPS; ++u) {
    const int kp = u / NP, jt = u % NP;
    issue(u + NST_DQDK - 1);
    hopper::cp_async_wait<NST_DQDK - 1>();
    hopper::fence_proxy_async();
    __syncthreads();
    const uint8_t* C0t = RING + (u % NST_DQDK) * 2 * TILE64;
    const uint8_t* DCt = C0t + TILE64;
    hopper::wgmma_fence();
    hopper::mma64_kk(aq, DN + jt * TILE64, C0t, jt > 0);
    hopper::mma64_kk(ak, V + jt * TILE64, DCt, jt > 0);
    hopper::wgmma_commit();
    for (int e = tid; e < 2048; e += NT) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(C0t + 4 * e));
      const float2 y = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(DCt + 4 * e));
      dot = fmaf(x.x, y.x, fmaf(x.y, y.y, dot));
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(aq);
    hopper::fence_regs(ak);
    if (jt == NP - 1) {
      const uint8_t* QPc = QP + (kp & 1) * TILE64;
      const uint8_t* KPc = KP + (kp & 1) * TILE64;
#pragma unroll
      for (int ix = 0; ix < 32; ++ix) {
        const int t = acc_row(i0, gq, ix);
        dgq[(ix >> 1) & 1] =
            fmaf(hopper::tile_f32(QPc, t, acc_col(tq, ix)), aq[ix], dgq[(ix >> 1) & 1]);
        aq[ix] *= gg[t];
        ak[ix] *= rr[t];
      }
      hopper::wgmma_fence();
      hopper::mma64_kn(aq, DS, KPc, true);
      hopper::mma64_kn(ak, DST, QPc, true);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(aq);
      hopper::fence_regs(ak);
#pragma unroll
      for (int ix = 0; ix < 32; ix += 2) {
        const int t = acc_row(i0, gq, ix), col = 64 * kp + acc_col(tq, ix);
        if (t < nr) {
          *reinterpret_cast<__nv_bfloat162*>(dqb + t * g.gqss + col) =
              __floats2bfloat162_rn(aq[ix] + gd[t] * n0s[col],
                                    aq[ix + 1] + gd[t] * n0s[col + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dkb + t * g.gkss + col) =
              __floats2bfloat162_rn(ak[ix] + rr[t] * dns[col],
                                    ak[ix + 1] + rr[t] * dns[col + 1]);
        }
      }
    }
    __syncthreads();             // the stage and the panels may be refilled
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    dgq[u] += __shfl_xor_sync(0xffffffffu, dgq[u], 1);
    dgq[u] += __shfl_xor_sync(0xffffffffu, dgq[u], 2);
    const int t = i0 + gq + 8 * u;
    if (tq == 0 && t < nr) g.rv[(bh * g.S + s0 + t) * RVN + RV_DGQ] = dgq[u];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
  if (lane == 0) red[warp] = dot;
  __syncthreads();
  if (tid == 0)
    g.cv[(bh * g.nch + c) * 2 + 1] = red[0] + red[1] + red[2] + red[3];
}

constexpr int SMEM_DV =
    (NP + 1 + 4 + NST_DV) * TILE64 + (2 * HD + 8 * 64 + 8) * 4 + 1024;

// One block per (chunk, head, batch row), the six 64-column panels jp of
// dv in turn: dv = r o (k dC) + W^T dnum, the dC tiles (kt, jp) streamed,
// k resident; then dr = v . (k dC) + k . dn and the gates' gradients of
// the chunk: dlf = rowsum M - colsum M + g dg - r dr, plus on its last
// row sum r dr + e^{lf_end}(<dC, C0> + <dn, n0>), reverse-cumsummed into
// dlogf; dlogi = colsum M + r dr.
__global__ void __launch_bounds__(NT) mlstm_bwd_dv(GradArgs g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* KT = sm;                         // k, six panels
  uint8_t* WT = KT + NP * TILE64;           // W^T [s][t]
  uint8_t* VP = WT + TILE64;                // [2] v's panel jp
  uint8_t* DNP = VP + 2 * TILE64;           // [2] dnum's panel jp
  uint8_t* RING = DNP + 2 * TILE64;         // [NST] dC tiles
  float* n0s = reinterpret_cast<float*>(RING + NST_DV * TILE64);
  float* dns = n0s + HD;
  float* rr = dns + HD;
  float* gg = rr + 64;
  float* a1 = gg + 64;
  float* cmv = a1 + 64;
  float* dgv = cmv + 64;
  float* kdn = dgv + 64;
  float* drs = kdn + 64;
  float* red = drs + 64;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int s0 = c * 64, nr = min(64, g.S - s0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3, i0 = 16 * warp;
  const size_t bh = (size_t)b * g.NH + h;
  const bf16* kb = g.k + b * g.ksb + h * g.ksh + s0 * g.kss;
  const bf16* vb = g.v + b * g.vsb + h * g.vsh + s0 * g.vss;
  const bf16* dnb = g.dnum + (bh * g.S + s0) * HD;
  const bf16* tb = g.tiles + (bh * g.nch + c) * 3 * 4096;
  const size_t so = (bh * g.nch + c) * HD * HD;
  for (int p = 0; p < NP; ++p)
    hopper::load_tile64(KT + p * TILE64, kb + 64 * p, g.kss, nr, tid, NT);
  hopper::load_tile64(WT, tb + 8192, 64, 64, tid, NT);
  hopper::cp_async_commit();
  constexpr int STEPS = NP * NP;
  auto issue = [&](int u) {
    if (u < STEPS) {
      const int jp = u / NP, kt = u % NP;
      hopper::load_tile64(RING + (u % NST_DV) * TILE64,
                          g.dc + so + (size_t)(64 * kt) * HD + 64 * jp, HD, 64,
                          tid, NT);
      if (kt == 0) {
        hopper::load_tile64(VP + (jp & 1) * TILE64, vb + 64 * jp, g.vss, nr,
                            tid, NT);
        hopper::load_tile64(DNP + (jp & 1) * TILE64, dnb + 64 * jp, HD, nr,
                            tid, NT);
      }
    }
    hopper::cp_async_commit();
  };
  for (int u = 0; u < NST_DV - 1; ++u) issue(u);
  for (int e = tid; e < HD; e += NT) {
    n0s[e] = g.n0[(bh * g.nch + c) * HD + e];
    dns[e] = g.dn[(bh * g.nch + c) * HD + e];
  }
  if (tid < 64) {
    const bool ok = tid < nr;
    const float* o = g.rv + (bh * g.S + s0 + (ok ? tid : 0)) * RVN;
    rr[tid] = ok ? o[RV_R] : 0.f;
    gg[tid] = ok ? o[RV_G] : 0.f;
    a1[tid] = ok ? o[RV_A1] : 0.f;
    cmv[tid] = ok ? o[RV_CM] : 0.f;
    dgv[tid] = ok ? o[RV_DGQ] : 0.f;
  }
  float av[32], dr[2] = {0.f, 0.f};
  bf16* dvb = g.dv + b * g.gvsb + h * g.gvsh + s0 * g.gvss;
  for (int u = 0; u < STEPS; ++u) {
    const int jp = u / NP, kt = u % NP;
    issue(u + NST_DV - 1);
    hopper::cp_async_wait<NST_DV - 1>();
    hopper::fence_proxy_async();
    __syncthreads();
    hopper::wgmma_fence();
    hopper::mma64_kn(av, KT + kt * TILE64, RING + (u % NST_DV) * TILE64,
                     kt > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(av);
    if (kt == NP - 1) {
      const uint8_t* VPc = VP + (jp & 1) * TILE64;
#pragma unroll
      for (int ix = 0; ix < 32; ++ix) {
        const int s = acc_row(i0, gq, ix);
        dr[(ix >> 1) & 1] =
            fmaf(hopper::tile_f32(VPc, s, acc_col(tq, ix)), av[ix], dr[(ix >> 1) & 1]);
        av[ix] *= rr[s];
      }
      hopper::wgmma_fence();
      hopper::mma64_kn(av, WT, DNP + (jp & 1) * TILE64, true);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(av);
#pragma unroll
      for (int ix = 0; ix < 32; ix += 2) {
        const int s = acc_row(i0, gq, ix), col = 64 * jp + acc_col(tq, ix);
        if (s < nr)
          *reinterpret_cast<__nv_bfloat162*>(dvb + s * g.gvss + col) =
              __floats2bfloat162_rn(av[ix], av[ix + 1]);
      }
    }
    __syncthreads();
  }
  {  // k . dn, two threads a row; <dn, n0>
    const int r = tid >> 1, k0 = (tid & 1) * (HD / 2);
    float s = 0.f;
    for (int kk = k0; kk < k0 + HD / 2; ++kk)
      s = fmaf(hopper::tile_f32(KT + (kk >> 6) * TILE64, r, kk & 63), dns[kk], s);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if ((tid & 1) == 0) kdn[r] = s;
    float nn = 0.f;
    for (int e = tid; e < HD; e += NT) nn = fmaf(dns[e], n0s[e], nn);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) nn += __shfl_xor_sync(0xffffffffu, nn, o);
    if (lane == 0) red[warp] = nn;
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    dr[u] += __shfl_xor_sync(0xffffffffu, dr[u], 1);
    dr[u] += __shfl_xor_sync(0xffffffffu, dr[u], 2);
    if (tq == 0) drs[i0 + gq + 8 * u] = dr[u];
  }
  __syncthreads();
  if (warp == 0) {
    const float* cvc = g.cv + (bh * g.nch + c) * 2;
    const float eend = cvc[0];
    const float dotn = cvc[1] + red[0] + red[1] + red[2] + red[3];
    float f[2], di[2], rdr = 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = 2 * lane + u;
      const float rd = rr[r] * (drs[r] + kdn[r]);
      f[u] = a1[r] + gg[r] * dgv[r] - rd;
      di[u] = cmv[r] + rd;
      rdr += rd;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) rdr += __shfl_xor_sync(0xffffffffu, rdr, o);
    if (lane == 31) f[1] += rdr + eend * dotn;
    float incl = f[0] + f[1];    // suffix sums over the lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_down_sync(0xffffffffu, incl, o);
      if (lane + o < 32) incl += t;
    }
    float excl = __shfl_down_sync(0xffffffffu, incl, 1);
    if (lane == 31) excl = 0.f;
    const float l1 = excl + f[1];
    const float l0 = l1 + f[0];
    float* fo = g.dlf + b * g.fsb + h * g.fsh;
    float* io = g.dli + b * g.isb + h * g.ish;
    const int r0 = 2 * lane;
    if (r0 < nr) {
      fo[(s0 + r0) * g.fss] = l0;
      io[(s0 + r0) * g.iss] = di[0];
    }
    if (r0 + 1 < nr) {
      fo[(s0 + r0 + 1) * g.fss] = l1;
      io[(s0 + r0 + 1) * g.iss] = di[1];
    }
  }
}

}  // namespace tcb

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

// bf16 q, k, v at hd 384: the tensor-core route's five launches. Strides
// as mlstm_chunkwise_bwd_f32's. Scratch, contiguous: c0 and dc (B, NH,
// ceil(S/64), 384, 384) bf16; n0 and dn (B, NH, ceil(S/64), 384) f32;
// dnum (B, NH, S, 384) bf16; tiles (B, NH, ceil(S/64), 3, 64, 64) bf16;
// rv (B, NH, S, 6) f32; cv (B, NH, ceil(S/64), 2) f32.
extern "C" int mlstm_chunkwise_bwd_tc(
    const void* q, const void* k, const void* v, const float* li,
    const float* lf, const float* y, const float* dy, void* c0, void* dc,
    float* n0, float* dn, void* dnum, void* tiles, float* rv, float* cv,
    void* dq, void* dk, void* dv, float* dli, float* dlf, int B, int NH,
    int S, int HD, const long long* st, void* stream) {
  namespace t = tcb;
  using t::bf16;
  if (HD != t::HD || B <= 0 || NH <= 0 || S <= 0 || B > 65535 || NH > 65535)
    return (int)cudaErrorInvalidValue;
  static bool granted = false;
  if (!granted) {
    int rc = hopper::grant_smem(t::mlstm_bwd_fstate, t::SMEM_STATE);
    if (!rc) rc = hopper::grant_smem(t::mlstm_bwd_rstate, t::SMEM_STATE);
    if (!rc) rc = hopper::grant_smem(t::mlstm_bwd_local, t::SMEM_LOCAL);
    if (!rc) rc = hopper::grant_smem(t::mlstm_bwd_dqdk, t::SMEM_DQDK);
    if (!rc) rc = hopper::grant_smem(t::mlstm_bwd_dv, t::SMEM_DV);
    if (rc) return rc;
    granted = true;
  }
  const int nch = (S + 63) / 64;
  cudaStream_t cs = (cudaStream_t)stream;
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  const t::StateArgs fw{kk, vv, st[3], st[4], st[5], st[6], st[7], st[8],
                        li, lf, st[9], st[10], st[11], st[12], st[13],
                        st[14], rv, static_cast<bf16*>(c0), n0, NH, S, nch};
  t::mlstm_bwd_fstate<<<dim3(t::NP * (t::NP / t::SJ), NH, B), t::NT, t::SMEM_STATE,
                        cs>>>(fw);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const t::LocArgs lo{qq, kk, vv, st[0], st[1], st[2], st[3], st[4], st[5],
                      st[6], st[7], st[8], li, lf, st[9], st[10], st[11],
                      st[12], st[13], st[14], y, dy, st[15], st[16], st[17],
                      st[18], st[19], st[20], n0, static_cast<bf16*>(dnum),
                      static_cast<bf16*>(tiles), rv, cv, NH, S, nch};
  t::mlstm_bwd_local<<<dim3(nch, NH, B), t::NT, t::SMEM_LOCAL, cs>>>(lo);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const t::StateArgs rev{qq, static_cast<const bf16*>(dnum), st[0], st[1],
                         st[2], (long long)NH * S * t::HD,
                         (long long)S * t::HD, t::HD, li, lf, st[9], st[10],
                         st[11], st[12], st[13], st[14], rv,
                         static_cast<bf16*>(dc), dn, NH, S, nch};
  t::mlstm_bwd_rstate<<<dim3(t::NP * (t::NP / t::SJ), NH, B), t::NT, t::SMEM_STATE,
                        cs>>>(rev);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const t::GradArgs gr{
      qq, kk, vv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], static_cast<const bf16*>(dnum), static_cast<const bf16*>(tiles),
      static_cast<const bf16*>(c0), static_cast<const bf16*>(dc), n0, dn, rv,
      cv, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), st[21], st[22], st[23], st[24], st[25], st[26],
      st[27], st[28], st[29], dli, dlf, st[30], st[31], st[32], st[33],
      st[34], st[35], NH, S, nch};
  t::mlstm_bwd_dqdk<<<dim3(nch, NH, B), t::NT, t::SMEM_DQDK, cs>>>(gr);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  t::mlstm_bwd_dv<<<dim3(nch, NH, B), t::NT, t::SMEM_DV, cs>>>(gr);
  return (int)cudaGetLastError();
}
