// mamba2_scan: the chunked SSD (Mamba2) scan, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba2_scan.py
// (mamba2_scan / _ssd_kernel), which the reference model reaches through
// its pure-jnp mirror models/ssm.py::ssm_apply. It computes the exact
// recurrence h_t = a_t h_{t-1} + dt_t x_t B_t^T, y_t = C_t h_t (per batch
// row and head; h is P x N) in the chunked form the TPU kernel uses:
// within a chunk y = ((C B^T) o exp(segsum log(a + 1e-20))) (x dt), the
// upper triangle masked in log space with the finite -1e30 before the
// exp; across chunks the term (C o exp(cumlog a)) h^T; the state h carried
// in f32 from chunk to chunk. The chunk length changes only the rounding,
// not the function.
//
// Layout as the JAX kernel's: x (B, NH, S, P); Bm, Cm (B, S, N), shared by
// the heads of a batch row; a, dt (B, NH, S) f32; y (B, NH, S, P) in the
// output type (f32 on the model's path, where the reference keeps the
// scan's result in f32 through the D-skip and the gated norm). Every
// input is read through element strides of its outer dims (last dim
// contiguous), so the model passes the causal conv's output as views,
// uncopied, and receives a (B, NH, S, P) view of a (B, S, NH, P) buffer.
//
// Bound on the card: bytes. At the zamba2-7b prefill shape (B=2, NH=112,
// S=2048, P=N=64) the call moves x in bf16 (58.7 MB), y out in f32
// (117.4 MB), a and dt in f32 (3.7 MB) and B, C (1.0 MB): about 181 MB,
// 0.054 ms at 3.35 TB/s. Its products at the reference's 256-row chunk
// are 3.8e10 flops, 0.038 ms at the bf16 tensor-core peak, so the memory
// bounds it. This first version does the four small products on the CUDA
// cores in f32 and so sits well above that bound.
//
// Design: the TPU's sequential chunk grid dimension becomes a loop inside
// one block per (head, batch row), with h (P x N f32, 16 KB at 64 x 64)
// resident in shared memory for the whole sequence. A chunk is 64 rows
// (the TPU's 256-row chunk keeps a 256 x 256 f32 tile, 256 KB, more than
// a block's 227 KB): the x, B, C, W and h tiles fit in about 85 KB. Per
// chunk, 256 threads: stage the tiles as f32 (padded rows, no bank
// conflicts); one warp takes the prefix sum of log(a + 1e-20) (two rows a
// lane); W = (C B^T) o exp(la_i - la_j) on the lower triangle; y = W (x dt)
// + exp(la) (C h^T), each thread 4 rows x P/16 columns; then
// h = exp(la_end) h + sum_j (x dt)_j exp(la_end - la_j) B_j^T. Rows past S
// are staged as zeros with log a = 0: they add nothing and are never
// written, so any S works (no divisibility assert). No atomics: repeated
// runs are bitwise equal.
//
// Later work: C B^T does not depend on the head, so a block could serve
// several heads of one batch row and share it; the products belong on the
// tensor cores (mma.sync / wgmma) with the tiles in bf16.
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
  const void* x;
  const void* bm;
  const void* cm;
  const float* a;
  const float* dt;
  void* y;
  int NH, S;
  // element strides: x (b, h, s), Bm (b, s), Cm (b, s), a (b, h, s),
  // dt (b, h, s), y (b, h, s)
  long long xsb, xsh, xss, bsb, bss, csb, css, asb, ash, ass, dsb, dsh, dss,
      ysb, ysh, yss;
};

template <typename TI, typename TO, int P, int N>
__global__ void __launch_bounds__(THREADS) ssd_kernel(Args g) {
  constexpr int XST = P + 1;     // padded rows of Xs
  constexpr int NST = N + 1;     // padded rows of Bs, Cs, Hs
  constexpr int WST = CH + 1;    // padded rows of Ws
  constexpr int PJ = P / 16;     // columns of p per thread
  constexpr int NJ = N / 16;     // columns of n per thread
  extern __shared__ float smem[];
  float* Xs = smem;              // [CH][P+1]  x, then x * dt
  float* Bs = Xs + CH * XST;     // [CH][N+1]
  float* Cs = Bs + CH * NST;     // [CH][N+1]
  float* Hs = Cs + CH * NST;     // [P][N+1]   the carried state
  float* Ws = Hs + P * NST;      // [CH][CH+1]
  float* la = Ws + CH * WST;     // [CH] log(a + 1e-20), then its prefix sum
  float* ela = la + CH;          // [CH] exp(la)
  float* dec = ela + CH;         // [CH] exp(la_end - la)
  float* dts = dec + CH;         // [CH] dt

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  const TI* xb = static_cast<const TI*>(g.x) + b * g.xsb + h * g.xsh;
  const TI* bb = static_cast<const TI*>(g.bm) + b * g.bsb;
  const TI* cb = static_cast<const TI*>(g.cm) + b * g.csb;
  const float* ab = g.a + b * g.asb + h * g.ash;
  const float* db = g.dt + b * g.dsb + h * g.dsh;
  TO* yb = static_cast<TO*>(g.y) + b * g.ysb + h * g.ysh;

  for (int e = tid; e < P * NST; e += THREADS) Hs[e] = 0.f;

  for (int s0 = 0; s0 < g.S; s0 += CH) {
    const int n = min(CH, g.S - s0);
    __syncthreads();             // the last chunk's state update is done
    // 1. stage the chunk as f32; rows past S are zeros with log a = 0
    if (tid < CH) {
      const bool ok = tid < n;
      la[tid] = ok ? logf(ab[(s0 + tid) * g.ass] + 1e-20f) : 0.f;
      dts[tid] = ok ? db[(s0 + tid) * g.dss] : 0.f;
    }
    for (int e = tid; e < CH * P; e += THREADS) {
      const int r = e / P, p = e % P;
      Xs[r * XST + p] = r < n ? to_f32(xb[(s0 + r) * g.xss + p]) : 0.f;
    }
    for (int e = tid; e < CH * N; e += THREADS) {
      const int r = e / N, k = e % N;
      Bs[r * NST + k] = r < n ? to_f32(bb[(s0 + r) * g.bss + k]) : 0.f;
      Cs[r * NST + k] = r < n ? to_f32(cb[(s0 + r) * g.css + k]) : 0.f;
    }
    __syncthreads();

    // 2. warp 0: la = cumsum(log(a + 1e-20)), two rows a lane; all: x * dt
    if (tid < 32) {
      const float v0 = la[2 * tid], v1 = la[2 * tid + 1];
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
      la[2 * tid] = l0;
      la[2 * tid + 1] = l1;
      ela[2 * tid] = expf(l0);
      ela[2 * tid + 1] = expf(l1);
      dec[2 * tid] = expf(lend - l0);
      dec[2 * tid + 1] = expf(lend - l1);
    }
    for (int e = tid; e < CH * P; e += THREADS) {
      const int r = e / P, p = e % P;
      Xs[r * XST + p] *= dts[r];
    }
    __syncthreads();

    // 3. W = (C B^T) o exp(la_i - la_j) for j <= i, 0 above the diagonal
    //    (the reference's exp(-1e30)); thread: rows ty*4.., cols tx + 16j
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
      for (int k = 0; k < N; ++k) {
        float c[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) c[i] = Cs[(ty * 4 + i) * NST + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * NST + k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(c[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          Ws[r * WST + col] = col <= r ? acc[i][j] * expf(la[r] - la[col]) : 0.f;
        }
      }
    }
    __syncthreads();

    // 4. y = W (x dt) + exp(la) (C h^T); thread: rows ty*4.., cols tx + 16c
    {
      float acc[4][PJ], inter[4][PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < PJ; ++c) acc[i][c] = inter[i][c] = 0.f;
      const int jend = min(ty * 4 + 4, n);   // W is 0 past the last row
      for (int j = 0; j < jend; ++j) {
        float w[4], xv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = Ws[(ty * 4 + i) * WST + j];
#pragma unroll
        for (int c = 0; c < PJ; ++c) xv[c] = Xs[j * XST + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < PJ; ++c) acc[i][c] = fmaf(w[i], xv[c], acc[i][c]);
      }
#pragma unroll 8
      for (int k = 0; k < N; ++k) {
        float cv[4], hv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty * 4 + i) * NST + k];
#pragma unroll
        for (int c = 0; c < PJ; ++c) hv[c] = Hs[(tx + 16 * c) * NST + k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < PJ; ++c)
            inter[i][c] = fmaf(cv[i], hv[c], inter[i][c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        if (r >= n) continue;
        TO* yr = yb + (s0 + r) * g.yss;
#pragma unroll
        for (int c = 0; c < PJ; ++c)
          from_f32(yr + tx + 16 * c, acc[i][c] + ela[r] * inter[i][c]);
      }
    }
    __syncthreads();             // every thread has read h

    // 5. h = exp(la_end) h + sum_j (x dt)_j exp(la_end - la_j) B_j^T;
    //    thread: p = ty + 16c, n = tx + 16d
    {
      float acc[PJ][NJ];
#pragma unroll
      for (int c = 0; c < PJ; ++c)
#pragma unroll
        for (int d = 0; d < NJ; ++d) acc[c][d] = 0.f;
      for (int j = 0; j < n; ++j) {
        const float dj = dec[j];
        float xv[PJ], bv[NJ];
#pragma unroll
        for (int c = 0; c < PJ; ++c) xv[c] = Xs[j * XST + ty + 16 * c] * dj;
#pragma unroll
        for (int d = 0; d < NJ; ++d) bv[d] = Bs[j * NST + tx + 16 * d];
#pragma unroll
        for (int c = 0; c < PJ; ++c)
#pragma unroll
          for (int d = 0; d < NJ; ++d) acc[c][d] = fmaf(xv[c], bv[d], acc[c][d]);
      }
      const float eend = expf(la[CH - 1]);
#pragma unroll
      for (int c = 0; c < PJ; ++c)
#pragma unroll
        for (int d = 0; d < NJ; ++d) {
          float* hp = Hs + (ty + 16 * c) * NST + tx + 16 * d;
          *hp = eend * *hp + acc[c][d];
        }
    }
  }
}

template <typename TI, typename TO, int P, int N>
int launch_pn(const Args& g, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(CH * (P + 1) + 2 * CH * (N + 1) +
                                               P * (N + 1) + CH * (CH + 1) + 4 * CH);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<TI, TO, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ssd_kernel<TI, TO, P, N><<<dim3(g.NH, B), THREADS, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

template <typename TI, typename TO, int P>
int launch_p(const Args& g, int B, int N, cudaStream_t stream) {
  switch (N) {
    case 16: return launch_pn<TI, TO, P, 16>(g, B, stream);
    case 32: return launch_pn<TI, TO, P, 32>(g, B, stream);
    case 64: return launch_pn<TI, TO, P, 64>(g, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TI, typename TO>
int launch(const Args& g, int B, int P, int N, cudaStream_t stream) {
  if (B <= 0 || g.NH <= 0 || g.S <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  switch (P) {
    case 16: return launch_p<TI, TO, 16>(g, B, N, stream);
    case 32: return launch_p<TI, TO, 32>(g, B, N, stream);
    case 64: return launch_p<TI, TO, 64>(g, B, N, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 16 int64 element strides, x (b, h, s), Bm (b, s), Cm (b, s),
// a (b, h, s), dt (b, h, s), y (b, h, s); the last dim of x, Bm, Cm and y
// is contiguous
#define SSD_ENTRY(NAME, TI, TO)                                               \
  extern "C" int NAME(const void* x, const void* bm, const void* cm,         \
                      const float* a, const float* dt, void* y, int B,       \
                      int NH, int S, int P, int N, const long long* st,      \
                      void* stream) {                                        \
    const Args g{x, bm, cm, a, dt, y, NH, S,                                 \
                 st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],     \
                 st[8], st[9], st[10], st[11], st[12], st[13], st[14],       \
                 st[15]};                                                    \
    return launch<TI, TO>(g, B, P, N, (cudaStream_t)stream);                 \
  }

SSD_ENTRY(mamba2_scan_f32_f32, float, float)
SSD_ENTRY(mamba2_scan_f32_bf16, float, __nv_bfloat16)
SSD_ENTRY(mamba2_scan_bf16_f32, __nv_bfloat16, float)
SSD_ENTRY(mamba2_scan_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
