// mamba2_scan_bwd: the gradient of the chunked SSD (Mamba2) scan, for
// Hopper (sm_90a).
//
// The TPU kernel src/repro/kernels/mamba2_scan.py (mamba2_scan /
// _ssd_kernel) has no backward: the reference differentiates its jnp
// mirror models/ssm.py::ssm_apply. This kernel differentiates the
// forward kernel csrc/mamba2_scan.cu (64-row chunks) by the reverse
// chunked recurrence of kernels/mamba2_scan.py's docstring. Per chunk
// (la = cumsum log(a + 1e-20), L = exp(la_t - la_s) on the lower
// triangle, the -1e30 mask applied in log space so that no 0 * inf
// appears, W = (C B^T) o L, xdt = x dt) and given dy and the dh1 carried
// back from the next chunk:
//   dxdt = W^T dy + dec o (B dh1^T)        dec = exp(la_end - la)
//   dW = dy xdt^T (lower triangle), dG = dW o L, M = dW o W
//   dC = dG B + exp(la) o (dy h0)          (per head; summed below)
//   dB = dG^T C + dec o (xdt dh1)
//   dla = rowsum M - colsum M + sum_n C dC_state - Q,
//         Q_s = sum_n B_s dB_state_s; the end row adds sum Q and
//         exp(la_end) <dh1, h0>
//   d log(a + 1e-20) = reverse cumsum dla; da = that / (a + 1e-20)
//   ddt = sum_p dxdt x, dx = dxdt dt
//   dh0 = exp(la_end) dh1 + (dy o exp(la))^T C
//
// Layout as the forward's: x (B, NH, S, P) and Bm, Cm (B, S, N) in the
// input type, a, dt (B, NH, S) f32, dy (B, NH, S, P) f32 (the model's y
// is f32); dx, dBm, dCm in the input type and da, ddt in f32, every one
// through element strides of its outer dims (last dim contiguous), so
// each gradient takes its input's layout. Rows past S are zeros with
// log a = 0: they add nothing and are never written.
//
// Bound on the card: bytes. At the hybrid prefill's shape (B=2, NH=112,
// S=2048, P=N=64, x bf16) the inputs, dy and the gradients once each are
// about 244 MB, 0.073 ms at 3.35 TB/s; the hybrid train path's rank (B=1,
// S=4096) is the same size. scan_bwd_flops counts 3.758e10 flops there.
//
// bf16 x, B, C at P = N = 64 (the model's training path): the
// tensor-core route, three launches. The recurrence's one serial part is
// the state at each chunk boundary, so two state passes come first and
// every other term is computed chunk by chunk from them. Every product
// runs on wgmma (bf16 operands from 128-byte-swizzled tiles, f32
// accumulators, 64-row tiles; hopper.cuh), one bf16 operand each: x, B
// and C are exact, and the f32 operands (x o dt o dec, dy o e^la, h0, dh,
// dy, dG, W) are rounded to bf16 once. A CPU emulation of these rounding
// points (tests/test_torch_recurrent_bwd.py) puts every gradient about
// 4e-3 of its largest value off the plain backward, inside the card's
// 2e-2; keeping the forward's hi/lo pairs for all of them only brings
// that to about 3e-3 (the bf16 gradients' own rounding), so no lo
// product is kept. Each block is one warpgroup (128 threads); tiles
// arrive by 16-byte cp.async; no atomics (repeated runs are bitwise
// equal).
//  1. ssd_bwd_state: one block per (head, batch row, direction), NH x B x
//     2 (448 at the prefill's shape, 224 at the train path's), walking the
//     chunks with the 64 x 64 state in the accumulators: forward, h stored
//     (bf16) at each chunk's start, then h = e^{la_end} h + (x o dt o
//     dec)^T B; reverse, dh stored at each chunk's end, then dh =
//     e^{la_end} dh + (dy o e^la)^T C; A built in registers from the x or
//     dy tile, B or C the MN-major B tile; the next chunk's tiles and gate
//     rows load a chunk ahead. 108 registers, 53,248 bytes of shared
//     memory.
//  2. ssd_bwd_chunk: one block per (chunk, group of G = 4 heads, batch
//     row), nch x NH/4 x B (1792 at both shapes). C B^T once for the
//     group; per head dW = (dy x^T) o dt on the lower triangle, W, dG and
//     M; dxdt = dec o (B dh^T) + W^T dy, so dx and ddt; dC += e^la o (dy
//     h0) + dG B and dB += (dt dec) o (x dh) + dG^T C in the accumulators,
//     in head order; the dla terms, <dh, h0>, the reverse cumsum (one
//     warp) and da. 251 registers, 95,264 bytes.
//  3. ssd_bwd_reduce sums the groups' dB and dC in group order.
// ptxas reports no spills (chiprun_out/ptxas.txt). Scratch, allocated by
// the wrapper (at both shapes): h and dh (B, NH, nch, 64, 64) bf16, 58.7
// MB each; the groups' dB and dC (B, NH/4, S, 64) f32, 29.4 MB each: 176
// MB, against the CUDA-core route's 352 MB.
//
// f32 inputs (the reduced reference phases and the f32 checks at 1e-3),
// and bf16 at the other P, N of DIMS (no main path): the CUDA-core kernel
// of the first port, unchanged. ssd_bwd_kernel, one block per (head,
// batch row), 256 threads, f32 on the CUDA cores (inputs converted at
// load):
//  1. a forward sweep recomputes h at each chunk start, as the forward
//     kernel's state update does, into the scratch hbuf (B, NH, chunks,
//     P, N) f32;
//  2. the reverse sweep stages a chunk (x, dy, B, C, h0 from hbuf as
//     padded f32 tiles; dh, the carried P x N gradient, stays in shared
//     memory for the whole sequence), then W and dG (each thread a 4 x 4
//     patch of the 64 x 64 tiles), M's row sums by quarter-warp shuffles
//     and its column sums by per-row-group partials summed in a fixed
//     order, dxdt / dC / dB (each thread 4 rows x P/16 or N/16 columns),
//     the dla terms by shuffles, <dh1, h0> by a fixed-order block
//     reduction, the reverse cumsum of dla by one warp, and the dh
//     update last.
// dC and dB of each head go to the scratch dbp / dcp (B, NH, S, N) f32;
// ssd_bwd_reduce sums them over the heads in head order (Bmat and Cmat
// are shared by the NH heads of a batch row). No atomics: repeated runs
// are bitwise equal.
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
  const void* x;
  const void* bm;
  const void* cm;
  const float* a;
  const float* dt;
  const float* dy;
  float* hbuf;                 // (B, NH, nch, P, N) chunk-start states
  float* dbp;                  // (B, NH, S, N) per-head dB
  float* dcp;                  // (B, NH, S, N) per-head dC
  void* dx;
  float* da;
  float* ddt;
  int NH, S, nch;
  // element strides: x (b, h, s), Bm (b, s), Cm (b, s), a (b, h, s),
  // dt (b, h, s), dy (b, h, s), dx (b, h, s), da (b, h, s), ddt (b, h, s)
  long long xsb, xsh, xss, bsb, bss, csb, css, asb, ash, ass, dsb, dsh, dss,
      ysb, ysh, yss, gxsb, gxsh, gxss, gasb, gash, gass, gdsb, gdsh, gdss;
};

template <int P, int N>
constexpr size_t smem_floats() {
  return (size_t)2 * CH * (P + 1) + 2 * CH * (N + 1) + 2 * P * (N + 1) +
         2 * CH * (CH + 1) + 16 * CH + 10 * CH + 8;
}

template <typename TI, int P, int N>
__global__ void __launch_bounds__(THREADS) ssd_bwd_kernel(Args g) {
  constexpr int XST = P + 1;     // padded rows of Xs, Ys
  constexpr int NST = N + 1;     // padded rows of Bs, Cs, H0, DH
  constexpr int WST = CH + 1;    // padded rows of Ws, Gs
  constexpr int PJ = P / 16;     // columns of p per thread
  constexpr int NJ = N / 16;     // columns of n per thread
  extern __shared__ float smem[];
  float* Xs = smem;              // [CH][P+1]  x
  float* Ys = Xs + CH * XST;     // [CH][P+1]  dy
  float* Bs = Ys + CH * XST;     // [CH][N+1]
  float* Cs = Bs + CH * NST;     // [CH][N+1]
  float* H0 = Cs + CH * NST;     // [P][N+1]   h: carried (sweep 1), chunk start (2)
  float* DH = H0 + P * NST;      // [P][N+1]   dh, carried back
  float* Ws = DH + P * NST;      // [CH][CH+1] W
  float* Gs = Ws + CH * WST;     // [CH][CH+1] dG = dW o L
  float* colp = Gs + CH * WST;   // [16][CH]   M's column sums per row group
  float* lg = colp + 16 * CH;    // [CH] log(a + 1e-20), then la
  float* ela = lg + CH;          // [CH] exp(la)
  float* dec = ela + CH;         // [CH] exp(la_end - la)
  float* dts = dec + CH;         // [CH] dt
  float* av = dts + CH;          // [CH] a + 1e-20
  float* rowM = av + CH;         // [CH]
  float* colM = rowM + CH;       // [CH]
  float* yin = colM + CH;        // [CH] sum_n C dC_state
  float* qv = yin + CH;          // [CH] Q
  float* ddv = qv + CH;          // [CH] ddt
  float* red = ddv + CH;         // [8] a block reduction's warp sums

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int lane = tid % 32, warp = tid / 32;

  const TI* xb = static_cast<const TI*>(g.x) + b * g.xsb + h * g.xsh;
  const TI* bb = static_cast<const TI*>(g.bm) + b * g.bsb;
  const TI* cb = static_cast<const TI*>(g.cm) + b * g.csb;
  const float* ab = g.a + b * g.asb + h * g.ash;
  const float* db = g.dt + b * g.dsb + h * g.dsh;
  const float* yb = g.dy + b * g.ysb + h * g.ysh;
  float* hb = g.hbuf + ((size_t)b * g.NH + h) * g.nch * P * N;
  float* dbb = g.dbp + ((size_t)b * g.NH + h) * g.S * N;
  float* dcb = g.dcp + ((size_t)b * g.NH + h) * g.S * N;
  TI* gxb = static_cast<TI*>(g.dx) + b * g.gxsb + h * g.gxsh;
  float* gab = g.da + b * g.gasb + h * g.gash;
  float* gdb = g.ddt + b * g.gdsb + h * g.gdsh;

  // stage a chunk's a, dt (rows past S: log a = 0, dt = 0) and x, B (and
  // C, dy when asked), then warp 0's prefix sum of log(a + 1e-20)
  auto stage = [&](int s0, int n, bool all) {
    if (tid < CH) {
      const bool ok = tid < n;
      const float aa = ok ? ab[(s0 + tid) * g.ass] : 1.f;
      av[tid] = aa + 1e-20f;
      lg[tid] = ok ? logf(aa + 1e-20f) : 0.f;
      dts[tid] = ok ? db[(s0 + tid) * g.dss] : 0.f;
    }
    for (int e = tid; e < CH * P; e += THREADS) {
      const int r = e / P, p = e % P;
      const bool ok = r < n;
      Xs[r * XST + p] = ok ? to_f32(xb[(s0 + r) * g.xss + p]) : 0.f;
      if (all) Ys[r * XST + p] = ok ? yb[(s0 + r) * g.yss + p] : 0.f;
    }
    for (int e = tid; e < CH * N; e += THREADS) {
      const int r = e / N, k = e % N;
      const bool ok = r < n;
      Bs[r * NST + k] = ok ? to_f32(bb[(s0 + r) * g.bss + k]) : 0.f;
      if (all) Cs[r * NST + k] = ok ? to_f32(cb[(s0 + r) * g.css + k]) : 0.f;
    }
    __syncthreads();
    if (tid < 32) {
      const float v0 = lg[2 * tid], v1 = lg[2 * tid + 1];
      float incl = v0 + v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += t;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      const float l0 = excl + v0;
      const float l1 = l0 + v1;
      const float lend = __shfl_sync(0xffffffffu, l1, 31);
      lg[2 * tid] = l0;
      lg[2 * tid + 1] = l1;
      ela[2 * tid] = expf(l0);
      ela[2 * tid + 1] = expf(l1);
      dec[2 * tid] = expf(lend - l0);
      dec[2 * tid + 1] = expf(lend - l1);
    }
    __syncthreads();
  };

  // ---------------------------------------------- 1. the forward sweep
  for (int e = tid; e < P * NST; e += THREADS) H0[e] = 0.f;
  for (int c = 0; c < g.nch; ++c) {
    const int s0 = c * CH, n = min(CH, g.S - s0);
    __syncthreads();             // the last chunk's update is done
    float* hc = hb + (size_t)c * P * N;
    for (int e = tid; e < P * N; e += THREADS)
      hc[e] = H0[(e / N) * NST + e % N];
    stage(s0, n, false);
    // h = exp(la_end) h + sum_j (x dt)_j exp(la_end - la_j) B_j^T
    float acc[PJ][NJ];
#pragma unroll
    for (int cc = 0; cc < PJ; ++cc)
#pragma unroll
      for (int d = 0; d < NJ; ++d) acc[cc][d] = 0.f;
    for (int j = 0; j < n; ++j) {
      const float dj = dec[j], tj = dts[j];
      float xv[PJ], bv[NJ];
#pragma unroll
      for (int cc = 0; cc < PJ; ++cc) xv[cc] = Xs[j * XST + ty + 16 * cc] * tj * dj;
#pragma unroll
      for (int d = 0; d < NJ; ++d) bv[d] = Bs[j * NST + tx + 16 * d];
#pragma unroll
      for (int cc = 0; cc < PJ; ++cc)
#pragma unroll
        for (int d = 0; d < NJ; ++d) acc[cc][d] = fmaf(xv[cc], bv[d], acc[cc][d]);
    }
    const float eend = expf(lg[CH - 1]);
#pragma unroll
    for (int cc = 0; cc < PJ; ++cc)
#pragma unroll
      for (int d = 0; d < NJ; ++d) {
        float* hp = H0 + (ty + 16 * cc) * NST + tx + 16 * d;
        *hp = eend * *hp + acc[cc][d];
      }
  }

  // ---------------------------------------------- 2. the reverse sweep
  for (int e = tid; e < P * NST; e += THREADS) DH[e] = 0.f;
  for (int c = g.nch - 1; c >= 0; --c) {
    const int s0 = c * CH, n = min(CH, g.S - s0);
    __syncthreads();             // the last chunk's dh update is done
    const float* hc = hb + (size_t)c * P * N;
    for (int e = tid; e < P * N; e += THREADS)
      H0[(e / N) * NST + e % N] = hc[e];
    stage(s0, n, true);
    const float eend = expf(lg[CH - 1]);

    // 2a. W = (C B^T) o L, dW = dy xdt^T, dG = dW o L, M = dW o W on the
    //     lower triangle; thread: rows ty*4.., columns tx + 16j
    {
      float G[4][4], dW[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) G[i][j] = dW[i][j] = 0.f;
#pragma unroll 4
      for (int k = 0; k < N; ++k) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty * 4 + i) * NST + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * NST + k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) G[i][j] = fmaf(cv[i], bv[j], G[i][j]);
      }
#pragma unroll 4
      for (int p = 0; p < P; ++p) {
        float yv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) yv[i] = Ys[(ty * 4 + i) * XST + p];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = Xs[(tx + 16 * j) * XST + p];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dW[i][j] = fmaf(yv[i], xv[j], dW[i][j]);
      }
      float csum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tx + 16 * j;
          float w = 0.f, dg = 0.f, m = 0.f;
          if (s <= r) {
            const float L = expf(lg[r] - lg[s]);
            const float dw = dW[i][j] * dts[s];
            w = G[i][j] * L;
            dg = dw * L;
            m = dw * w;
          }
          Ws[r * WST + s] = w;
          Gs[r * WST + s] = dg;
          rs += m;
          csum[j] += m;
        }
        rs = sum16(rs);
        if (tx == 0) rowM[r] = rs;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) colp[ty * CH + tx + 16 * j] = csum[j];
    }
    __syncthreads();
    if (tid < CH) {
      float s = 0.f;
      for (int r = 0; r < 16; ++r) s += colp[r * CH + tid];
      colM[tid] = s;
    }

    // 2b. dxdt = W^T dy + dec o (B dh1^T): dx = dxdt dt, ddt = dxdt . x;
    //     thread: rows s = ty*4.., columns p = tx + 16c
    {
      float acc[4][PJ], st[4][PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < PJ; ++cc) acc[i][cc] = st[i][cc] = 0.f;
      for (int t = ty * 4; t < n; ++t) {   // W[t][s] is 0 for t < s
        float w[4], yv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = Ws[t * WST + ty * 4 + i];
#pragma unroll
        for (int cc = 0; cc < PJ; ++cc) yv[cc] = Ys[t * XST + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int cc = 0; cc < PJ; ++cc) acc[i][cc] = fmaf(w[i], yv[cc], acc[i][cc]);
      }
#pragma unroll 4
      for (int k = 0; k < N; ++k) {
        float bv[4], hv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) bv[i] = Bs[(ty * 4 + i) * NST + k];
#pragma unroll
        for (int cc = 0; cc < PJ; ++cc) hv[cc] = DH[(tx + 16 * cc) * NST + k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int cc = 0; cc < PJ; ++cc) st[i][cc] = fmaf(bv[i], hv[cc], st[i][cc]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = ty * 4 + i;
        float dd = 0.f;
        TI* gx = gxb + (s0 + s) * g.gxss;
#pragma unroll
        for (int cc = 0; cc < PJ; ++cc) {
          const float v = acc[i][cc] + dec[s] * st[i][cc];
          dd = fmaf(v, Xs[s * XST + tx + 16 * cc], dd);
          if (s < n) from_f32(gx + tx + 16 * cc, v * dts[s]);
        }
        dd = sum16(dd);
        if (tx == 0) ddv[s] = dd;
      }
    }

    // 2c. dC = dG B + exp(la) o (dy h0), and sum_n C dC_state;
    //     thread: rows t = ty*4.., columns n = tx + 16d
    {
      float acc[4][NJ], st[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int d = 0; d < NJ; ++d) acc[i][d] = st[i][d] = 0.f;
      const int send = min(ty * 4 + 4, n);  // dG[t][s] is 0 for s > t
      for (int s = 0; s < send; ++s) {
        float gv[4], bv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) gv[i] = Gs[(ty * 4 + i) * WST + s];
#pragma unroll
        for (int d = 0; d < NJ; ++d) bv[d] = Bs[s * NST + tx + 16 * d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int d = 0; d < NJ; ++d) acc[i][d] = fmaf(gv[i], bv[d], acc[i][d]);
      }
#pragma unroll 4
      for (int p = 0; p < P; ++p) {
        float yv[4], hv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) yv[i] = Ys[(ty * 4 + i) * XST + p];
#pragma unroll
        for (int d = 0; d < NJ; ++d) hv[d] = H0[p * NST + tx + 16 * d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int d = 0; d < NJ; ++d) st[i][d] = fmaf(yv[i], hv[d], st[i][d]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty * 4 + i;
        float yi = 0.f;
        float* dc = dcb + (size_t)(s0 + t) * N;
#pragma unroll
        for (int d = 0; d < NJ; ++d) {
          const float sv = ela[t] * st[i][d];
          yi = fmaf(Cs[t * NST + tx + 16 * d], sv, yi);
          if (t < n) dc[tx + 16 * d] = acc[i][d] + sv;
        }
        yi = sum16(yi);
        if (tx == 0) yin[t] = yi;
      }
    }

    // 2d. dB = dG^T C + dec o (xdt dh1), and Q = sum_n B dB_state;
    //     thread: rows s = ty*4.., columns n = tx + 16d
    {
      float acc[4][NJ], st[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int d = 0; d < NJ; ++d) acc[i][d] = st[i][d] = 0.f;
      for (int t = ty * 4; t < n; ++t) {   // dG[t][s] is 0 for t < s
        float gv[4], cv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) gv[i] = Gs[t * WST + ty * 4 + i];
#pragma unroll
        for (int d = 0; d < NJ; ++d) cv[d] = Cs[t * NST + tx + 16 * d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int d = 0; d < NJ; ++d) acc[i][d] = fmaf(gv[i], cv[d], acc[i][d]);
      }
#pragma unroll 4
      for (int p = 0; p < P; ++p) {
        float xv[4], hv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = Xs[(ty * 4 + i) * XST + p];
#pragma unroll
        for (int d = 0; d < NJ; ++d) hv[d] = DH[p * NST + tx + 16 * d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int d = 0; d < NJ; ++d) st[i][d] = fmaf(xv[i], hv[d], st[i][d]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = ty * 4 + i;
        float q = 0.f;
        float* dbr = dbb + (size_t)(s0 + s) * N;
        const float f = dec[s] * dts[s];
#pragma unroll
        for (int d = 0; d < NJ; ++d) {
          const float sv = f * st[i][d];
          q = fmaf(Bs[s * NST + tx + 16 * d], sv, q);
          if (s < n) dbr[tx + 16 * d] = acc[i][d] + sv;
        }
        q = sum16(q);
        if (tx == 0) qv[s] = q;
      }
    }

    // 2e. <dh1, h0>: each thread its p = ty + 16c, n = tx + 16d, then the
    //     warps' sums in a fixed order
    {
      float part = 0.f;
#pragma unroll
      for (int cc = 0; cc < PJ; ++cc)
#pragma unroll
        for (int d = 0; d < NJ; ++d) {
          const int e = (ty + 16 * cc) * NST + tx + 16 * d;
          part = fmaf(DH[e], H0[e], part);
        }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) red[warp] = part;
    }
    __syncthreads();             // every read of dh1 is done

    // 2f. dh0 = exp(la_end) dh1 + (dy o exp(la))^T C
    {
      float acc[PJ][NJ];
#pragma unroll
      for (int cc = 0; cc < PJ; ++cc)
#pragma unroll
        for (int d = 0; d < NJ; ++d) acc[cc][d] = 0.f;
      for (int t = 0; t < n; ++t) {
        const float et = ela[t];
        float yv[PJ], cv[NJ];
#pragma unroll
        for (int cc = 0; cc < PJ; ++cc) yv[cc] = Ys[t * XST + ty + 16 * cc] * et;
#pragma unroll
        for (int d = 0; d < NJ; ++d) cv[d] = Cs[t * NST + tx + 16 * d];
#pragma unroll
        for (int cc = 0; cc < PJ; ++cc)
#pragma unroll
          for (int d = 0; d < NJ; ++d) acc[cc][d] = fmaf(yv[cc], cv[d], acc[cc][d]);
      }
#pragma unroll
      for (int cc = 0; cc < PJ; ++cc)
#pragma unroll
        for (int d = 0; d < NJ; ++d) {
          float* dp = DH + (ty + 16 * cc) * NST + tx + 16 * d;
          *dp = eend * *dp + acc[cc][d];
        }
    }

    // 2g. warp 0: dla, its reverse cumsum (two rows a lane), da and ddt
    if (tid < 32) {
      float hh = 0.f, qs = 0.f;
      if (tid == 31) {
        for (int w = 0; w < THREADS / 32; ++w) hh += red[w];
        for (int s = 0; s < CH; ++s) qs += qv[s];
      }
      float d0, d1;
      {
        const int r0 = 2 * tid, r1 = 2 * tid + 1;
        d0 = rowM[r0] - colM[r0] + yin[r0] - qv[r0];
        d1 = rowM[r1] - colM[r1] + yin[r1] - qv[r1];
        if (tid == 31) d1 += eend * hh + qs;
      }
      float incl = d0 + d1;      // suffix sums over the lanes
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_down_sync(0xffffffffu, incl, o);
        if (tid + o < 32) incl += t;
      }
      float excl = __shfl_down_sync(0xffffffffu, incl, 1);
      if (tid == 31) excl = 0.f;
      const float l1 = excl + d1;
      const float l0 = l1 + d0;
      const int r0 = 2 * tid, r1 = 2 * tid + 1;
      if (r0 < n) {
        gab[(s0 + r0) * g.gass] = l0 / av[r0];
        gdb[(s0 + r0) * g.gdss] = ddv[r0];
      }
      if (r1 < n) {
        gab[(s0 + r1) * g.gass] = l1 / av[r1];
        gdb[(s0 + r1) * g.gdss] = ddv[r1];
      }
    }
  }
}

// dB, dC: the per-head partials summed over the heads in head order, a
// thread per (b, s, n)
template <typename TI>
__global__ void ssd_bwd_reduce(const float* dbp, const float* dcp, TI* dbm,
                               TI* dcm, int B, int NH, int S, int N,
                               long long bsb, long long bss, long long csb,
                               long long css) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * S * N) return;
  const int n = idx % N;
  const int s = (idx / N) % S;
  const int b = idx / ((long long)S * N);
  const size_t hs = (size_t)S * N;
  const size_t base = (size_t)b * NH * hs + (size_t)s * N + n;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < NH; ++h) {
    sb += dbp[base + h * hs];
    sc += dcp[base + h * hs];
  }
  from_f32(dbm + b * bsb + s * bss + n, sb);
  from_f32(dcm + b * csb + s * css + n, sc);
}

template <typename TI, int P, int N>
int launch_pn(const Args& g, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<P, N>();
  static bool granted = false;
  if (!granted) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_bwd_kernel<TI, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    granted = true;
  }
  ssd_bwd_kernel<TI, P, N><<<dim3(g.NH, B), THREADS, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

template <typename TI, int P>
int launch_p(const Args& g, int B, int N, cudaStream_t stream) {
  switch (N) {
    case 16: return launch_pn<TI, P, 16>(g, B, stream);
    case 32: return launch_pn<TI, P, 32>(g, B, stream);
    case 64: return launch_pn<TI, P, 64>(g, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TI>
int launch(const Args& g, int B, int P, int N, TI* dbm, TI* dcm,
           const long long* st, cudaStream_t stream) {
  if (B <= 0 || g.NH <= 0 || g.S <= 0 || B > 65535 || g.NH > 65535)
    return (int)cudaErrorInvalidValue;
  int rc;
  switch (P) {
    case 16: rc = launch_p<TI, 16>(g, B, N, stream); break;
    case 32: rc = launch_p<TI, 32>(g, B, N, stream); break;
    case 64: rc = launch_p<TI, 64>(g, B, N, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  const long long total = (long long)B * g.S * N;
  ssd_bwd_reduce<TI><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      g.dbp, g.dcp, dbm, dcm, B, g.NH, g.S, N, st[0], st[1], st[2], st[3]);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ tensor cores
// bf16 x, B, C at P = N = 64 (the model's training path): three launches,
// the products on wgmma, one bf16 operand each (the note at the top).
namespace tcb {

using bf16 = __nv_bfloat16;
using hopper::acc_col;
using hopper::acc_row;
using hopper::align1024;
using hopper::swz;
using hopper::TILE64;

constexpr int NT = 128;               // one warpgroup a block
constexpr int G = 4;                  // heads a block of ssd_bwd_chunk
constexpr int FST = 68;               // padded row of an f32 dy tile
constexpr int SRCB = 64 * FST * 4;    // bytes of an x or f32 dy stage

// la = cumsum log(a + 1e-20) over a chunk by one warp from its a, rows 2
// lane and 2 lane + 1 (a = 1 at or past S, so la stays flat there); la_end
__device__ __forceinline__ void scan_gates(const float (&av)[2], int lane,
                                           float (&la)[2], float& lend) {
  const float l[2] = {logf(av[0] + 1e-20f), logf(av[1] + 1e-20f)};
  float incl = l[0] + l[1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  la[0] = excl + l[0];
  la[1] = la[0] + l[1];
  lend = __shfl_sync(0xffffffffu, la[1], 31);
}

// cp.async of 64 rows x 64 f32 (row stride `ld` elements, 16-byte aligned
// rows) into rows of FST floats; rows at or past nr are zeros
__device__ __forceinline__ void load_f32(float* dst, const float* src,
                                         long long ld, int nr, int t) {
  for (int e = t; e < 1024; e += NT) {
    const int r = e >> 4, c = e & 15;
    const bool ok = r < nr;
    hopper::cp_async16(dst + r * FST + 4 * c, src + (ok ? r * ld + 4 * c : 0),
                       ok ? 16 : 0);
  }
}

struct Args {
  const bf16* x;
  const bf16* bm;
  const bf16* cm;
  const float* a;
  const float* dt;
  const float* dy;
  bf16* hbuf;           // (B, NH, nch, 64, 64) h at each chunk's start
  bf16* dhbuf;          // (B, NH, nch, 64, 64) dh at each chunk's end
  float* dbp;           // (B, groups, S, 64) dB summed over a group
  float* dcp;           // (B, groups, S, 64) dC likewise
  bf16* dx;
  float* da;
  float* ddt;
  long long xsb, xsh, xss, bsb, bss, csb, css, asb, ash, ass, tsb, tsh, tss,
      ysb, ysh, yss, gxsb, gxsh, gxss, gasb, gash, gass, gtsb, gtsh, gtss;
  int NH, S, nch, ngroup;
};

constexpr int SMEM_STATE = 2 * (SRCB + TILE64) + 4 * 64 * 4 + 1024;

// One block per (head, batch row, direction), walking the chunks: forward
// (z = 0) h, stored bf16 at each chunk's start, then h = e^{la_end} h +
// (x o dt o dec)^T B; reverse (z = 1) dh, stored at each chunk's end, then
// dh = e^{la_end} dh + (dy o e^la)^T C. A is built in registers from the
// x (bf16) or dy (f32) tile, scaled (the register-A operand of wgmma); B
// or C is the MN-major B tile. Every warp takes the chunk's gates itself.
// The next chunk's tiles and gate rows load while this one computes.
__global__ void __launch_bounds__(NT) ssd_bwd_state(Args g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* SRC = sm;                        // [2] x (bf16) or dy (f32)
  uint8_t* MAT = sm + 2 * SRCB;             // [2] B or C
  float* gin = reinterpret_cast<float*>(MAT + 2 * TILE64);  // [2][a, dt][64]
  const int h = blockIdx.x, b = blockIdx.y;
  const bool rev = blockIdx.z == 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3, i0 = 16 * warp;
  const size_t bh = (size_t)b * g.NH + h;
  const bf16* xb = g.x + b * g.xsb + h * g.xsh;
  const float* yb = g.dy + b * g.ysb + h * g.ysh;
  const bf16* mb = rev ? g.cm + b * g.csb : g.bm + b * g.bsb;
  const long long mss = rev ? g.css : g.bss;
  const float* ab = g.a + b * g.asb + h * g.ash;
  const float* tb = g.dt + b * g.tsb + h * g.tsh;
  bf16* out = rev ? g.dhbuf : g.hbuf;
  auto chunk_of = [&](int i) { return rev ? g.nch - 1 - i : i; };
  auto load = [&](int i) {
    if (i < g.nch) {
      const int s0 = chunk_of(i) * 64, nr = min(64, g.S - s0);
      if (rev)
        load_f32(reinterpret_cast<float*>(SRC + (i & 1) * SRCB),
                 yb + s0 * g.yss, g.yss, nr, tid);
      else
        hopper::load_tile64(SRC + (i & 1) * SRCB, xb + s0 * g.xss, g.xss, nr,
                            tid, NT);
      hopper::load_tile64(MAT + (i & 1) * TILE64, mb + s0 * mss, mss, nr, tid,
                          NT);
      if (tid < 64) {            // the chunk's a and dt; 0 past S
        const bool ok = tid < nr;
        const long long r = s0 + (ok ? tid : 0);
        float* d = gin + (i & 1) * 128 + tid;
        hopper::cp_async4(d, ab + r * g.ass, ok ? 4 : 0);
        hopper::cp_async4(d + 64, tb + r * g.tss, ok ? 4 : 0);
      }
    }
    hopper::cp_async_commit();
  };
  float acc[32];
#pragma unroll
  for (int ix = 0; ix < 32; ++ix) acc[ix] = 0.f;
  load(0);
  for (int i = 0; i < g.nch; ++i) {
    const int c = chunk_of(i), s0 = c * 64, nr = min(64, g.S - s0);
    load(i + 1);
    bf16* so = out + (bh * g.nch + c) * 4096;
#pragma unroll
    for (int ix = 0; ix < 32; ix += 2)
      *reinterpret_cast<__nv_bfloat162*>(so + acc_row(i0, gq, ix) * 64 +
                                         acc_col(tq, ix)) =
          __floats2bfloat162_rn(acc[ix], acc[ix + 1]);
    hopper::cp_async_wait<1>();
    hopper::fence_proxy_async();
    __syncthreads();             // this chunk's tiles and gate rows are in
    // the gates, in every warp: the scales of rows 2 lane, 2 lane + 1
    const float* gi = gin + (i & 1) * 128;
    float sc[2], eend;
    {
      const float av[2] = {2 * lane < nr ? gi[2 * lane] : 1.f,
                           2 * lane + 1 < nr ? gi[2 * lane + 1] : 1.f};
      float la[2], lend;
      scan_gates(av, lane, la, lend);
#pragma unroll
      for (int u = 0; u < 2; ++u)
        sc[u] = rev ? expf(la[u]) : gi[64 + 2 * lane + u] * expf(lend - la[u]);
      eend = expf(lend);
    }
    // A = (sc o src)^T as register fragments: element (row, k) is the
    // source's (k, row) scaled by sc_k; rows i0 + gq (+8), k = 16 kk + 2 tq
    // (+1, +8)
    const uint8_t* src = SRC + (i & 1) * SRCB;
    const float* fs = reinterpret_cast<const float*>(src);
    uint32_t af[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int sl = 8 * kk + tq + 4 * hh;        // the lane of rows k, k+1
        const float s0v = __shfl_sync(0xffffffffu, sc[0], sl);
        const float s1v = __shfl_sync(0xffffffffu, sc[1], sl);
        const int k = 2 * sl;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int row = i0 + gq + 8 * u;
          const float v0 = rev ? fs[k * FST + row] : hopper::tile_f32(src, k, row);
          const float v1 = rev ? fs[(k + 1) * FST + row] : hopper::tile_f32(src, k + 1, row);
          af[kk][2 * hh + u] = hopper::pack_bf16(v0 * s0v, v1 * s1v);
        }
      }
#pragma unroll
    for (int ix = 0; ix < 32; ++ix) acc[ix] *= eend;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_rs(acc, af[kk],
                       hopper::desc(MAT + (i & 1) * TILE64 + kk * 16 * 128,
                                    TILE64, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    __syncthreads();
  }
}

constexpr int SMEM_CHUNK = 9 * TILE64 + 64 * FST * 4 + (12 * 64 + 8) * 4 + 1024;

// One block per (chunk, group of G heads, batch row). S = C B^T once for
// the group; per head: dW = (dy x^T) o dt_s on the lower triangle, W = S
// o L, dG = dW o L, M = dW o W; dxdt = dec o (B dh^T) + W^T dy, dx and
// ddt; dC += e^la o (dy h0) + dG B and dB += (dt dec) o (x dh) + dG^T C in
// registers, in head order; the dla terms, <dh, h0>, the reverse cumsum
// and da. The group's dB and dC go to dbp, dcp.
__global__ void __launch_bounds__(NT) ssd_bwd_chunk(Args g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* Bt = sm;                         // B [s][n]
  uint8_t* Ct = Bt + TILE64;                // C [t][n]
  uint8_t* X = Ct + TILE64;                 // x [s][p]
  uint8_t* DY = X + TILE64;                 // dy [t][p], bf16
  uint8_t* H0 = DY + TILE64;                // h0 [p][n]
  uint8_t* DH = H0 + TILE64;                // dh [p][n]
  uint8_t* DG = DH + TILE64;                // dG [t][s]
  uint8_t* DGT = DG + TILE64;               // dG^T [s][t]
  uint8_t* WT = DGT + TILE64;               // W^T [s][t]
  float* DYF = reinterpret_cast<float*>(WT + TILE64);   // dy, f32
  float* la = DYF + 64 * FST;
  float* av = la + 64;
  float* dtv = av + 64;
  float* dec = dtv + 64;
  float* ela = dec + 64;
  float* rowm = ela + 64;
  float* cst = rowm + 64;
  float* qv = cst + 64;
  float* colp = qv + 64;                    // [4][64]
  float* red = colp + 256;                  // [8]
  const int c = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int s0 = c * 64, nr = min(64, g.S - s0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3, i0 = 16 * warp;
  hopper::load_tile64(Bt, g.bm + b * g.bsb + s0 * g.bss, g.bss, nr, tid, NT);
  hopper::load_tile64(Ct, g.cm + b * g.csb + s0 * g.css, g.css, nr, tid, NT);
  hopper::cp_async_commit();
  float sacc[32], dbs[32], dcs[32];
#pragma unroll
  for (int ix = 0; ix < 32; ++ix) dbs[ix] = dcs[ix] = 0.f;
  const int h1 = min(g.NH, (grp + 1) * G);
  for (int h = grp * G; h < h1; ++h) {
    const size_t bh = (size_t)b * g.NH + h;
    hopper::load_tile64(X, g.x + b * g.xsb + h * g.xsh + s0 * g.xss, g.xss, nr,
                        tid, NT);
    load_f32(DYF, g.dy + b * g.ysb + h * g.ysh + s0 * g.yss, g.yss, nr, tid);
    hopper::load_tile64(H0, g.hbuf + (bh * g.nch + c) * 4096, 64, 64, tid, NT);
    hopper::load_tile64(DH, g.dhbuf + (bh * g.nch + c) * 4096, 64, 64, tid, NT);
    hopper::cp_async_commit();
    float eend = 0.f;
    if (warp == 0) {
      const float* ab = g.a + b * g.asb + h * g.ash;
      const float a2[2] = {2 * lane < nr ? ab[(s0 + 2 * lane) * g.ass] : 1.f,
                           2 * lane + 1 < nr ? ab[(s0 + 2 * lane + 1) * g.ass]
                                             : 1.f};
      float l[2], lend;
      scan_gates(a2, lane, l, lend);
      const float* tb = g.dt + b * g.tsb + h * g.tsh;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = 2 * lane + u;
        la[r] = l[u];
        av[r] = a2[u];
        dtv[r] = r < nr ? tb[(s0 + r) * g.tss] : 0.f;
        dec[r] = expf(lend - l[u]);
        ela[r] = expf(l[u]);
      }
      eend = expf(lend);
    }
    hopper::cp_async_wait<0>();
    __syncthreads();
    // dy as bf16 [t][p]
    for (int e = tid; e < 2048; e += NT) {
      const int r = e >> 5, k = 2 * (e & 31);
      *reinterpret_cast<__nv_bfloat162*>(DY + swz(r, k)) =
          __floats2bfloat162_rn(DYF[r * FST + k], DYF[r * FST + k + 1]);
    }
    hopper::fence_proxy_async();
    __syncthreads();
    float dw[32];
    hopper::wgmma_fence();
    if (h == grp * G) hopper::mma64_kk(sacc, Ct, Bt, false);
    hopper::mma64_kk(dw, DY, X, false);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sacc);
    hopper::fence_regs(dw);
    // W, dG, M; the tiles; M's row and column sums
    float rm[2] = {0.f, 0.f}, cm[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) cm[j] = 0.f;
#pragma unroll
    for (int ix = 0; ix < 32; ix += 2) {
      const int t = acc_row(i0, gq, ix);
      float dgv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s = acc_col(tq, ix + e);
        float w = 0.f, dg = 0.f, m = 0.f;
        if (s <= t) {
          const float L = expf(la[t] - la[s]);
          const float dwv = dw[ix + e] * dtv[s];
          w = sacc[ix + e] * L;
          dg = dwv * L;
          m = dwv * w;
        }
        dgv[e] = dg;
        rm[(ix >> 1) & 1] += m;
        cm[2 * (ix >> 2) + e] += m;
        *reinterpret_cast<bf16*>(DGT + swz(s, t)) = __float2bfloat16(dg);
        *reinterpret_cast<bf16*>(WT + swz(s, t)) = __float2bfloat16(w);
      }
      *reinterpret_cast<__nv_bfloat162*>(DG + swz(t, acc_col(tq, ix))) =
          __floats2bfloat162_rn(dgv[0], dgv[1]);
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
    hopper::fence_proxy_async();
    __syncthreads();
    // dxdt = dec o (B dh^T) + W^T dy: dx and ddt
    float acc[32];
    hopper::wgmma_fence();
    hopper::mma64_kk(acc, Bt, DH, false);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
#pragma unroll
    for (int ix = 0; ix < 32; ++ix) acc[ix] *= dec[acc_row(i0, gq, ix)];
    hopper::wgmma_fence();
    hopper::mma64_kn(acc, WT, DY, true);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    {
      bf16* dxb = g.dx + b * g.gxsb + h * g.gxsh + s0 * g.gxss;
      float dd[2] = {0.f, 0.f};
#pragma unroll
      for (int ix = 0; ix < 32; ix += 2) {
        const int s = acc_row(i0, gq, ix), p = acc_col(tq, ix);
        dd[(ix >> 1) & 1] += acc[ix] * hopper::tile_f32(X, s, p) +
                             acc[ix + 1] * hopper::tile_f32(X, s, p + 1);
        if (s < nr)
          *reinterpret_cast<__nv_bfloat162*>(dxb + s * g.gxss + p) =
              __floats2bfloat162_rn(acc[ix] * dtv[s], acc[ix + 1] * dtv[s]);
      }
      float* tdb = g.ddt + b * g.gtsb + h * g.gtsh;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        dd[u] += __shfl_xor_sync(0xffffffffu, dd[u], 1);
        dd[u] += __shfl_xor_sync(0xffffffffu, dd[u], 2);
        const int s = i0 + gq + 8 * u;
        if (tq == 0 && s < nr) tdb[(s0 + s) * g.gtss] = dd[u];
      }
    }
    // the states' terms: e^la o (dy h0) and (dt dec) o (x dh)
    float tc[32], tb2[32];
    hopper::wgmma_fence();
    hopper::mma64_kn(tc, DY, H0, false);
    hopper::mma64_kn(tb2, X, DH, false);
    hopper::wgmma_commit();
    float hd = 0.f;              // <dh, h0>
    for (int e = tid; e < 2048; e += NT) {
      const float2 u = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(DH + 4 * e));
      const float2 w = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(H0 + 4 * e));
      hd = fmaf(u.x, w.x, fmaf(u.y, w.y, hd));
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(tc);
    hopper::fence_regs(tb2);
    float cs[2] = {0.f, 0.f}, qs[2] = {0.f, 0.f};
#pragma unroll
    for (int ix = 0; ix < 32; ++ix) {
      const int t = acc_row(i0, gq, ix), n = acc_col(tq, ix);
      tc[ix] *= ela[t];
      tb2[ix] *= dtv[t] * dec[t];
      cs[(ix >> 1) & 1] += hopper::tile_f32(Ct, t, n) * tc[ix];
      qs[(ix >> 1) & 1] += hopper::tile_f32(Bt, t, n) * tb2[ix];
      dcs[ix] += tc[ix];
      dbs[ix] += tb2[ix];
    }
    hopper::wgmma_fence();
    hopper::mma64_kn(dcs, DG, Bt, true);
    hopper::mma64_kn(dbs, DGT, Ct, true);
    hopper::wgmma_commit();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      cs[u] += __shfl_xor_sync(0xffffffffu, cs[u], 1);
      cs[u] += __shfl_xor_sync(0xffffffffu, cs[u], 2);
      qs[u] += __shfl_xor_sync(0xffffffffu, qs[u], 1);
      qs[u] += __shfl_xor_sync(0xffffffffu, qs[u], 2);
      if (tq == 0) {
        cst[i0 + gq + 8 * u] = cs[u];
        qv[i0 + gq + 8 * u] = qs[u];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) hd += __shfl_xor_sync(0xffffffffu, hd, o);
    if (lane == 0) red[warp] = hd;
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dcs);
    hopper::fence_regs(dbs);
    __syncthreads();
    // warp 0: dla, its reverse cumsum, da
    if (warp == 0) {
      float d[2], qsum = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = 2 * lane + u;
        const float cmr = colp[r] + colp[64 + r] + colp[128 + r] + colp[192 + r];
        d[u] = rowm[r] - cmr + cst[r] - qv[r];
        qsum += qv[r];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        qsum += __shfl_xor_sync(0xffffffffu, qsum, o);
      if (lane == 31)
        d[1] += eend * (red[0] + red[1] + red[2] + red[3]) + qsum;
      float incl = d[0] + d[1];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += t;
      }
      float excl = __shfl_down_sync(0xffffffffu, incl, 1);
      if (lane == 31) excl = 0.f;
      const float l1 = excl + d[1];
      const float l0 = l1 + d[0];
      float* dab = g.da + b * g.gasb + h * g.gash;
      const int r0 = 2 * lane;
      if (r0 < nr) dab[(s0 + r0) * g.gass] = l0 / (av[r0] + 1e-20f);
      if (r0 + 1 < nr) dab[(s0 + r0 + 1) * g.gass] = l1 / (av[r0 + 1] + 1e-20f);
    }
    __syncthreads();             // this head's tiles and vectors are read
  }
  float* dbo = g.dbp + ((size_t)b * g.ngroup + grp) * g.S * 64;
  float* dco = g.dcp + ((size_t)b * g.ngroup + grp) * g.S * 64;
#pragma unroll
  for (int ix = 0; ix < 32; ix += 2) {
    const int s = acc_row(i0, gq, ix), n = acc_col(tq, ix);
    if (s < nr) {
      *reinterpret_cast<float2*>(dbo + (size_t)(s0 + s) * 64 + n) =
          make_float2(dbs[ix], dbs[ix + 1]);
      *reinterpret_cast<float2*>(dco + (size_t)(s0 + s) * 64 + n) =
          make_float2(dcs[ix], dcs[ix + 1]);
    }
  }
}

}  // namespace tcb

}  // namespace

// strides: 29 int64 element strides, x (b, h, s), Bm (b, s), Cm (b, s),
// a (b, h, s), dt (b, h, s), dy (b, h, s), dx (b, h, s), dBm (b, s),
// dCm (b, s), da (b, h, s), ddt (b, h, s); the last dim of x, Bm, Cm, dy,
// dx, dBm and dCm is contiguous. hbuf (B, NH, ceil(S/64), P, N), dbp and
// dcp (B, NH, S, N): f32 scratch, contiguous.
#define SSD_BWD_ENTRY(NAME, TI)                                               \
  extern "C" int NAME(const void* x, const void* bm, const void* cm,         \
                      const float* a, const float* dt, const float* dy,      \
                      float* hbuf, float* dbp, float* dcp, void* dx,         \
                      void* dbm, void* dcm, float* da, float* ddt, int B,    \
                      int NH, int S, int P, int N, const long long* st,      \
                      void* stream) {                                        \
    const Args g{x, bm, cm, a, dt, dy, hbuf, dbp, dcp, dx, da, ddt, NH, S,   \
                 (S + CH - 1) / CH,                                          \
                 st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],     \
                 st[8], st[9], st[10], st[11], st[12], st[13], st[14],       \
                 st[15], st[16], st[17], st[18], st[23], st[24], st[25],     \
                 st[26], st[27], st[28]};                                    \
    const long long rs[4] = {st[19], st[20], st[21], st[22]};                \
    return launch<TI>(g, B, P, N, static_cast<TI*>(dbm),                     \
                      static_cast<TI*>(dcm), rs, (cudaStream_t)stream);      \
  }

SSD_BWD_ENTRY(mamba2_scan_bwd_f32, float)
SSD_BWD_ENTRY(mamba2_scan_bwd_bf16, __nv_bfloat16)

// bf16 x, B, C at P = N = 64: the tensor-core route's three launches.
// Strides as mamba2_scan_bwd_f32's. Scratch, contiguous: hbuf and dhbuf
// (B, NH, ceil(S/64), 64, 64) bf16; dbp and dcp (B, ceil(NH/4), S, 64)
// f32.
extern "C" int mamba2_scan_bwd_tc(const void* x, const void* bm,
                                  const void* cm, const float* a,
                                  const float* dt, const float* dy,
                                  void* hbuf, void* dhbuf, float* dbp,
                                  float* dcp, void* dx, void* dbm, void* dcm,
                                  float* da, float* ddt, int B, int NH, int S,
                                  int P, int N, const long long* st,
                                  void* stream) {
  namespace t = tcb;
  using t::bf16;
  if (P != 64 || N != 64 || B <= 0 || NH <= 0 || S <= 0 || B > 65535 ||
      NH > 65535)
    return (int)cudaErrorInvalidValue;
  static bool granted = false;
  if (!granted) {
    int rc = hopper::grant_smem(t::ssd_bwd_state, t::SMEM_STATE);
    if (!rc) rc = hopper::grant_smem(t::ssd_bwd_chunk, t::SMEM_CHUNK);
    if (rc) return rc;
    granted = true;
  }
  const int nch = (S + 63) / 64, ngroup = (NH + t::G - 1) / t::G;
  cudaStream_t cs = (cudaStream_t)stream;
  const t::Args g{static_cast<const bf16*>(x), static_cast<const bf16*>(bm),
                  static_cast<const bf16*>(cm), a, dt, dy,
                  static_cast<bf16*>(hbuf), static_cast<bf16*>(dhbuf), dbp,
                  dcp, static_cast<bf16*>(dx), da, ddt,
                  st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                  st[8], st[9], st[10], st[11], st[12], st[13], st[14],
                  st[15], st[16], st[17], st[18], st[23], st[24], st[25],
                  st[26], st[27], st[28], NH, S, nch, ngroup};
  t::ssd_bwd_state<<<dim3(NH, B, 2), t::NT, t::SMEM_STATE, cs>>>(g);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  t::ssd_bwd_chunk<<<dim3(nch, ngroup, B), t::NT, t::SMEM_CHUNK, cs>>>(g);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const long long total = (long long)B * S * 64;
  ssd_bwd_reduce<bf16><<<(unsigned)((total + 255) / 256), 256, 0, cs>>>(
      dbp, dcp, static_cast<bf16*>(dbm), static_cast<bf16*>(dcm), B, ngroup,
      S, 64, st[19], st[20], st[21], st[22]);
  return (int)cudaGetLastError();
}
