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
// are 3.8e10 flops, 0.038 ms at the bf16 tensor-core peak; at 64-row
// chunks about 1.5e10 executed flops, 0.224 ms even at the f32 CUDA-core
// peak, so the products must run on the tensor cores to get near the
// byte bound.
//
// Both kernels keep the TPU's sequential chunk grid dimension as a loop
// inside one block per (head, batch row), with h (P x N) resident for the
// whole sequence and 64-row chunks (the TPU's 256-row chunk keeps a
// 256 x 256 f32 tile, more than a block's shared memory). Nothing but y
// goes to device memory: per-chunk states written out would double the
// bytes the call moves. Rows past S are zero-filled with log a = 0 and
// dt = 0: they add nothing and are never written, so any S works and no
// row past S is read. No atomics: repeated runs, and any two layouts of
// the same inputs, are bitwise equal.
//
// bf16 inputs (the model's prefill): ssd_tc_kernel, the products on the
// tensor cores (wgmma m64n64k16, bf16 operands, f32 accumulators). A
// 64-row chunk is one warpgroup's M.
//  - Tiles: each chunk's x, B and C as 64 x 64 bf16 in the 128-byte-
//    swizzled layout wgmma reads from shared memory (hopper.cuh),
//    brought by cp.async (16 bytes a thread) two chunks ahead through a
//    3-slot ring, a and dt (strided f32) by 4-byte cp.async beside them;
//    columns past P or N are zero-filled, so P, N in {16, 32, 64} run
//    the same 64-wide products. TMA would need a tensor map per call and
//    still another path for a and dt (its boxes are at least 16 bytes
//    wide). Views whose rows are not 16-byte aligned take a scalar copy
//    (the layout decides).
//  - 256 threads in two warpgroups with their own loops, meeting at one
//    barrier a chunk. Warpgroup 0 runs the chain through h, which stays
//    in its f32 accumulators for the whole sequence: C h^T from a bf16
//    copy of h of chunk c-1 (both operands K-major), scaled by exp(la_i)
//    and handed to warpgroup 1 through shared memory; then h =
//    exp(la_end) h + A^T B, A = x^T (ldmatrix.trans) with column j
//    scaled by dt_j exp(la_end - la_j) in registers, B the MN-major B
//    tile; then the copy of h for the next chunk; and warp 0 the prefix
//    sum of the next chunk's log(a + 1e-20). Warpgroup 1 runs what does
//    not depend on h: S = C B^T, W = S o exp(la_i - la_j) o dt_j (0 above
//    the diagonal) formed in the accumulator registers and repacked as
//    A fragments in place (dt folded into W's columns, so x is never
//    rescaled), W x with x the MN-major B operand, then y = the handed
//    term + W x, stored.
//  - Why two warpgroups: one warpgroup doing all of it was bound by the
//    latency of its own instruction chains, not by a unit of the SM: one
//    block an SM ran nearly as long as two, and no single part (stores,
//    loads, the lo products, the prefix) took more than a sixth of the
//    time (tools/decode_scan_variants.py's diagnostic variants). Two
//    chains of about half the length, at two warps a scheduler, run
//    faster. Sharing the stores between the warpgroups, or moving W's
//    exp factors to warpgroup 0, ran slower: the longer chain then moved
//    to warpgroup 0. Only warpgroup 0 issues the loads and writes what
//    wgmma reads, so only it executes the proxy fence each chunk; with
//    warpgroup 1, which stores y, fencing too, the call ran slower. The
//    y stores, f32 rows 28 KB apart in the (B, S, NH, P) buffer, are now
//    the largest part (the no_store diagnostic).
//  - Precision: W, the scaled x and the copy of h are f32 values that
//    a bf16 operand would round to 8 bits. Rounded once, W alone puts
//    y 3.1% of (1 + |y|) off the f32 scan at S = 2048, past the 3%
//    tolerance (the CPU test's emulation of these rounding points). So
//    each goes in as two bf16 operands, hi = bf16(v) and lo = bf16(v -
//    hi), and its product runs twice: about 16 bits, 6e-5 of (1 + |y|)
//    in the same emulation, for 1.8x the products; the card checks hold
//    it to 1e-3, which a missing lo product fails. x, B and C are bf16
//    inputs and exact as operands.
//  - Shared memory: the 3-slot ring (72 KB), the hi/lo copy of h (16
//    KB), the handed term (16 KB, f32) and the chunk's vectors: 108.5
//    KB, and 128 registers a thread (no spill), so 2 blocks an SM and the
//    prefill's 224-block grid is resident in one wave. C B^T is still
//    computed per head (a block serves one head): sharing it among a
//    block's heads would leave fewer blocks than SMs at the prefill's
//    224 (head, row) pairs, to save about a tenth of the products.
//
// f32 inputs (the reference phases and the card tests at 1e-3):
// ssd_kernel, the CUDA-core kernel of the first port, unchanged: bf16
// products cannot meet f32's tolerance. 256 threads stage the chunk as
// padded f32 tiles; one warp takes the prefix sum of log(a + 1e-20); the
// four products are f32 FMAs, each thread a 4-row patch. The dispatch is
// by the input dtype only.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int CH = 64;         // rows per chunk
constexpr int THREADS = 256;   // 16 row groups x 16 lanes

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

// f32 inputs only: bf16 inputs run ssd_tc_kernel
template <typename TO, int P, int N>
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

  const float* xb = static_cast<const float*>(g.x) + b * g.xsb + h * g.xsh;
  const float* bb = static_cast<const float*>(g.bm) + b * g.bsb;
  const float* cb = static_cast<const float*>(g.cm) + b * g.csb;
  const float* ab = g.a + b * g.asb + h * g.ash;
  const float* db = g.dt + b * g.dsb + h * g.dsh;
  TO* yb = static_cast<TO*>(g.y) + b * g.ysb + h * g.ysh;

  for (int e = tid; e < P * NST; e += THREADS) Hs[e] = 0.f;

  for (int s0 = 0; s0 < g.S; s0 += CH) {
    const int n = min(CH, g.S - s0);
    __syncthreads();             // the last chunk's state update is done
    // 1. stage the chunk; rows past S are zeros with log a = 0
    if (tid < CH) {
      const bool ok = tid < n;
      la[tid] = ok ? logf(ab[(s0 + tid) * g.ass] + 1e-20f) : 0.f;
      dts[tid] = ok ? db[(s0 + tid) * g.dss] : 0.f;
    }
    for (int e = tid; e < CH * P; e += THREADS) {
      const int r = e / P, p = e % P;
      Xs[r * XST + p] = r < n ? xb[(s0 + r) * g.xss + p] : 0.f;
    }
    for (int e = tid; e < CH * N; e += THREADS) {
      const int r = e / N, k = e % N;
      Bs[r * NST + k] = r < n ? bb[(s0 + r) * g.bss + k] : 0.f;
      Cs[r * NST + k] = r < n ? cb[(s0 + r) * g.css + k] : 0.f;
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

// ------------------------------------------------------ tensor cores
constexpr int TC_THREADS = 256;       // two warpgroups; warp 4 wg + w: rows 16w..
constexpr int TILE_BYTES = CH * 128;  // 64 rows of 64 bf16, swizzled
using bf16 = __nv_bfloat16;
using hopper::desc;

constexpr int TC_STAGES = 3;          // chunks of x, B, C tiles in flight
// shared memory of ssd_tc_kernel: the ring of x, B, C tiles, the hi/lo
// copy of h, exp(la_i) (C h^T) handed from warpgroup 0 to 1 (f32), two
// buffers of the chunk's vectors, the ring of a and dt; 1 KB to align
constexpr size_t TC_SMEM = (size_t)(TC_STAGES * 3 + 2 + 2) * TILE_BYTES +
                           sizeof(float) * (2 * 4 + TC_STAGES * 2) * CH + 1024;

using hopper::swz;

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_u32(p)));
}

// two f32 as two bf16 pairs, hi = bf16(v) and lo = bf16(v - hi): hi + lo
// keeps about 16 bits of v, so a product over hi and lo loses next to
// nothing to the rounding
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = hopper::pack_bf16(x - __low2float(h), y - __high2float(h));
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <typename TO, int P, int N>
__global__ void __launch_bounds__(TC_THREADS, 2) ssd_tc_kernel(Args g, int vec) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* tiles = sm;                          // [TC_STAGES][x, B, C]
  uint8_t* Hs = sm + 3 * TC_STAGES * TILE_BYTES;  // [hi, lo] h's copy
  float* Ys = reinterpret_cast<float*>(Hs + 2 * TILE_BYTES);  // [32][128]
  // [2][la, ela, dts, dec][CH]: the prefix sum of log(a + 1e-20), its
  // exp, dt, and dt exp(la_end - la) of a chunk
  float* vecs = Ys + 32 * 128;
  float* adring = vecs + 2 * 4 * CH;            // [TC_STAGES][a, dt][CH]

  const int head = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, t = tid & 127;      // warpgroup, its thread
  const int gq = lane >> 2, tq = lane & 3;
  const int i0 = 16 * (warp & 3);               // rows of this warp

  const bf16* xb = static_cast<const bf16*>(g.x) + b * g.xsb + head * g.xsh;
  const bf16* bb = static_cast<const bf16*>(g.bm) + b * g.bsb;
  const bf16* cb = static_cast<const bf16*>(g.cm) + b * g.csb;
  const float* ab = g.a + b * g.asb + head * g.ash;
  const float* db = g.dt + b * g.dsb + head * g.dsh;
  TO* yb = static_cast<TO*>(g.y) + b * g.ysb + head * g.ysh;

  // warpgroup 0: chunk c's x, B and C rows into ring slot `buf`, 64
  // columns a row (those past P or N zero) in the swizzled layout, and
  // (warp 0) its a and dt; rows past S are zeros. Only warpgroup 0
  // writes what wgmma reads, so only it needs the proxy fence: warpgroup
  // 1's threads, which store y, never wait on one
  auto load = [&](int c, int buf) {
    const int s0 = c * CH, n = min(CH, g.S - s0);
    if (warp == 0) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = lane + 32 * u;
        const bool ok = r < n;
        const long long row = ok ? s0 + r : 0;
        hopper::cp_async4(adring + (2 * buf) * CH + r, ab + row * g.ass,
                          ok ? 4 : 0);
        hopper::cp_async4(adring + (2 * buf + 1) * CH + r, db + row * g.dss,
                          ok ? 4 : 0);
      }
    }
    uint8_t* X = tiles + 3 * buf * TILE_BYTES;
    uint8_t* Bt = X + TILE_BYTES;
    uint8_t* Ct = Bt + TILE_BYTES;
    if (vec) {
      for (int e = t; e < CH * 8; e += 128) {
        const int r = e >> 3, k = 8 * (e & 7), off = swz(r, k);
        const bool okx = r < n && k < P, okb = r < n && k < N;
        hopper::cp_async16(X + off, xb + (okx ? (s0 + r) * g.xss + k : 0),
                           okx ? 16 : 0);
        hopper::cp_async16(Bt + off, bb + (okb ? (s0 + r) * g.bss + k : 0),
                           okb ? 16 : 0);
        hopper::cp_async16(Ct + off, cb + (okb ? (s0 + r) * g.css + k : 0),
                           okb ? 16 : 0);
      }
    } else {
      const bf16 zero = __float2bfloat16(0.f);
      for (int e = t; e < CH * 64; e += 128) {
        const int r = e >> 6, k = e & 63, off = swz(r, k);
        const bool okx = r < n && k < P, okb = r < n && k < N;
        *reinterpret_cast<bf16*>(X + off) = okx ? xb[(s0 + r) * g.xss + k] : zero;
        *reinterpret_cast<bf16*>(Bt + off) = okb ? bb[(s0 + r) * g.bss + k] : zero;
        *reinterpret_cast<bf16*>(Ct + off) = okb ? cb[(s0 + r) * g.css + k] : zero;
      }
    }
  };
  // warp 0, once chunk c's a and dt are in: its vectors into buffer v,
  // rows 2 lane and 2 lane + 1; log a = 0 past S
  auto prefix = [&](int c, float* v) {
    const int n = min(CH, g.S - c * CH);
    const int r0 = 2 * lane, r1 = r0 + 1;
    const float* ar = adring + 2 * (c % TC_STAGES) * CH;
    const float ad[4] = {ar[r0], ar[r1], ar[CH + r0], ar[CH + r1]};
    const float v0 = r0 < n ? logf(ad[0] + 1e-20f) : 0.f;
    const float v1 = r1 < n ? logf(ad[1] + 1e-20f) : 0.f;
    float incl = v0 + v1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float s = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += s;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    const float l0 = excl + v0, l1 = l0 + v1;
    const float lend = __shfl_sync(0xffffffffu, l1, 31);
    v[r0] = l0;
    v[r1] = l1;
    v[CH + r0] = expf(l0);
    v[CH + r1] = expf(l1);
    v[2 * CH + r0] = ad[2];
    v[2 * CH + r1] = ad[3];
    v[3 * CH + r0] = ad[2] * expf(lend - l0);
    v[3 * CH + r1] = ad[3] * expf(lend - l1);
  };

  const int nchunk = (g.S + CH - 1) / CH;
  if (wg == 0) {
    for (int e = t; e < 2 * TILE_BYTES / 16; e += 128)
      reinterpret_cast<uint4*>(Hs)[e] = make_uint4(0u, 0u, 0u, 0u);  // h = 0
    // chunk c's tiles land in slot c % TC_STAGES, two chunks ahead of use
    for (int c = 0; c < TC_STAGES - 1; ++c) {
      if (c < nchunk) load(c, c);
      hopper::cp_async_commit();
    }
    if (warp == 0) {
      hopper::cp_async_wait<TC_STAGES - 2>();   // chunk 0's a and dt
      __syncwarp();
      prefix(0, vecs);
    }
  }
  // The start of chunk c in both warpgroups' loops: its tiles and vectors
  // are in and chunk c-1 is done everywhere (named barrier 2, as the two
  // loops reach it from different code); then warpgroup 0 sends chunk
  // c+2's loads out.
  auto start = [&](int c) {
    if (wg == 0) {
      hopper::cp_async_wait<TC_STAGES - 2>();
      hopper::fence_proxy_async();
    }
    hopper::bar_sync(2, TC_THREADS);
    if (wg == 0) {
      if (c + TC_STAGES - 1 < nchunk)
        load(c + TC_STAGES - 1, (c + TC_STAGES - 1) % TC_STAGES);
      hopper::cp_async_commit();
    }
  };
  auto tile = [&](int c, int which) {
    return tiles + (3 * (c % TC_STAGES) + which) * TILE_BYTES;
  };

  if (wg == 0) {
    // warpgroup 0, the chain through h, with h (64 x 64, f32) resident in
    // its accumulators: rows i0 + gq (+8), columns 8 i + 2 tq (+1) (the
    // layout in hopper.cuh). Per chunk: exp(la_i) (C h^T) from h's copy
    // of chunk c-1 (hi and lo, K-major), handed to warpgroup 1 in Ys;
    // and h = exp(la_end) h + A^T B (B MN-major), A = x^T (rows p = i0..,
    // K = j) with column j scaled by dt_j exp(la_end - la_j), hi and lo
    float hacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) hacc[i] = 0.f;
    for (int c = 0; c < nchunk; ++c) {
      start(c);
      const uint8_t *X = tile(c, 0), *Bt = tile(c, 1), *Ct = tile(c, 2);
      const float* la = vecs + (c & 1) * 4 * CH;
      const float* ela = la + CH;
      const float* dec = la + 3 * CH;
      float iacc[32];
      hopper::wgmma_fence();
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_ss(iacc, desc(Ct + kk * 32, 16, 1024),
                           desc(Hs + part * TILE_BYTES + kk * 32, 16, 1024),
                           part > 0 || kk > 0);
      hopper::wgmma_commit();
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t xr[4];
        ldsm_x4_t(xr, X + swz(16 * kk + (lane & 7) + 8 * (lane >> 4),
                              i0 + 8 * ((lane >> 3) & 1)));
        const int j = 16 * kk + 2 * tq;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const __nv_bfloat162 xv =
              *reinterpret_cast<const __nv_bfloat162*>(&xr[r]);
          const int jr = j + (r < 2 ? 0 : 8);
          split_bf16(__low2float(xv) * dec[jr],
                     __high2float(xv) * dec[jr + 1], ah[kk][r], al[kk][r]);
        }
      }
      const float eend = expf(la[CH - 1]);
#pragma unroll
      for (int i = 0; i < 32; ++i) hacc[i] *= eend;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bd = desc(Bt + kk * 16 * 128, TILE_BYTES, 1024);
        hopper::wgmma_rs(hacc, ah[kk], bd);
        hopper::wgmma_rs(hacc, al[kk], bd);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();   // C h^T is in
      hopper::fence_regs(iacc);
      const float e0 = ela[i0 + gq], e1 = ela[i0 + gq + 8];
#pragma unroll
      for (int i = 0; i < 32; ++i)
        Ys[i * 128 + t] = iacc[i] * ((i & 2) ? e1 : e0);
      hopper::bar_arrive(1, TC_THREADS);         // Ys is in
      hopper::wgmma_wait<0>();   // h is in; no product reads the copy now
      hopper::fence_regs(hacc);
      // h's bf16 copy, hi and lo, for the next chunk's C h^T
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int off = swz(i0 + gq + 8 * u, 8 * i + 2 * tq);
          split_bf16(hacc[4 * i + 2 * u], hacc[4 * i + 2 * u + 1],
                     *reinterpret_cast<uint32_t*>(Hs + off),
                     *reinterpret_cast<uint32_t*>(Hs + TILE_BYTES + off));
        }
      // warp 0: the next chunk's vectors, ready at the next start
      if (warp == 0 && c + 1 < nchunk) {
        hopper::cp_async_wait<TC_STAGES - 2>();   // chunk c+1's a and dt
        __syncwarp();
        prefix(c + 1, vecs + ((c + 1) & 1) * 4 * CH);
      }
    }
  } else {
    // warpgroup 1, what does not depend on h. Per chunk: S = C B^T
    // (K-major); W = S o exp(la_i - la_j) o dt_j for j <= i (else 0) as
    // the hi and lo bf16 A fragments of W x (column pair (2kk, 2kk + 1)
    // of the accumulator is the A fragment of k16 step kk); W x (x the
    // MN-major B operand); then y = Ys + W x
    for (int c = 0; c < nchunk; ++c) {
      start(c);
      const int s0 = c * CH, n = min(CH, g.S - s0);
      const uint8_t *X = tile(c, 0), *Bt = tile(c, 1), *Ct = tile(c, 2);
      const float* la = vecs + (c & 1) * 4 * CH;
      const float* dts = la + 2 * CH;
      float sacc[32], yacc[32];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_ss(sacc, desc(Ct + kk * 32, 16, 1024),
                         desc(Bt + kk * 32, 16, 1024), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sacc);
      uint32_t wa[4][4], wl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float w[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 8 * kk + 2 * q + e;    // accumulator element
            const int i = i0 + gq + 8 * ((idx >> 1) & 1);
            const int j = 8 * (idx >> 2) + 2 * tq + (idx & 1);
            w[e] = j <= i ? sacc[idx] * __expf(la[i] - la[j]) * dts[j] : 0.f;
          }
          split_bf16(w[0], w[1], wa[kk][q], wl[kk][q]);
        }
#pragma unroll
      for (int i = 0; i < 32; ++i) yacc[i] = 0.f;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t xd = desc(X + kk * 16 * 128, TILE_BYTES, 1024);
        hopper::wgmma_rs(yacc, wa[kk], xd);
        hopper::wgmma_rs(yacc, wl[kk], xd);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(yacc);
      hopper::bar_sync(1, TC_THREADS);           // Ys is in
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = i0 + gq + 8 * u;
        if (i < n) {
          TO* yr = yb + (s0 + i) * g.yss + 2 * tq;
#pragma unroll
          for (int k = 0; k < P / 8; ++k) {
            const int a0 = 4 * k + 2 * u;
            store2(yr + 8 * k, Ys[a0 * 128 + t] + yacc[a0],
                   Ys[(a0 + 1) * 128 + t] + yacc[a0 + 1]);
          }
        }
      }
    }
  }
}

template <typename TO, int P, int N>
int launch_tc(const Args& g, int B, cudaStream_t stream) {
  // 16-byte copies need 16-byte aligned rows; the layout decides
  const int vec =
      g.xsb % 8 == 0 && g.xsh % 8 == 0 && g.xss % 8 == 0 && g.bsb % 8 == 0 &&
      g.bss % 8 == 0 && g.csb % 8 == 0 && g.css % 8 == 0 &&
      reinterpret_cast<uintptr_t>(g.x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(g.bm) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(g.cm) % 16 == 0;
  static bool granted = false;
  if (!granted) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_tc_kernel<TO, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)TC_SMEM);
    if (err != cudaSuccess) return (int)err;
    granted = true;
  }
  ssd_tc_kernel<TO, P, N><<<dim3(g.NH, B), TC_THREADS, TC_SMEM, stream>>>(
      g, vec);
  return (int)cudaGetLastError();
}

template <typename TI, typename TO, int P, int N>
int launch_pn(const Args& g, int B, cudaStream_t stream) {
  if constexpr (sizeof(TI) == 2) {
    return launch_tc<TO, P, N>(g, B, stream);      // bf16: tensor cores
  } else {
    const size_t smem = sizeof(float) * (size_t)(CH * (P + 1) + 2 * CH * (N + 1) +
                                                 P * (N + 1) + CH * (CH + 1) + 4 * CH);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          ssd_kernel<TO, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    ssd_kernel<TO, P, N><<<dim3(g.NH, B), THREADS, smem, stream>>>(g);
    return (int)cudaGetLastError();
  }
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
