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
// ssd_bwd_kernel, one block per (head, batch row), 256 threads, f32 on
// the CUDA cores (inputs converted at load):
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
//
// Bytes: the inputs, dy and the gradients once each are about 244 MB at
// the hybrid prefill's shape (B=2, NH=112, S=2048, P=N=64, x bf16),
// 0.073 ms at 3.35 TB/s. This simple design also writes and reads the
// chunk-start states (117 MB each way there) and the per-head dB, dC
// partials (117 MB each, written and read), and reads x, B and C twice
// (both sweeps): about 5x those bytes. Its products, about 10 c^2 (P + N)
// flops a chunk row-block, run on the CUDA cores at f32; the tensor
// cores and keeping h0 on chip are later work.
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
