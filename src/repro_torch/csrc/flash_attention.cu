// flash_attention (forward): blockwise causal GQA attention with online
// softmax, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _attn_kernel), which the reference model reaches
// through its pure-jnp mirror models/attention.py::_flash_mha.
// Semantics: sm_scale = 1/sqrt(hd); head h reads KV head h / (H/Kh);
// causal and sliding-window masks on indices (kpos <= qpos,
// qpos - kpos < window) with the finite -1e30; output divided by
// max(l, 1e-30). Ragged tails are masked, not asserted: a key past Sk
// weighs nothing, a query row past Sq is never stored, so any Sq and Sk
// work. q, k, v and o are addressed through element strides of their
// three outer dims (last dim contiguous), so the model's (B, S, H, hd)
// projections go in as transposed views, uncopied. For training the
// kernel also writes each row's log-sum-exp m + log(l) (natural log,
// f32, (B, H, Sq) contiguous), which flash_attention_bwd.cu reads to
// recompute P; the serving path passes a null pointer and writes none.
//
// Bound on the card: ~2*B*H*S^2*hd causal flops against
// ~2*B*S*(H+2*Kh)*hd*bytes of q, k, v and o, far above the ridge at the
// main path's shapes (S = 1024 and 2048), so the tensor cores bound it
// (989 TFLOP/s bf16).
//
// bf16 (every main path): fa_fwd_wgmma, products on the tensor cores.
//  - One CTA per (128-query tile, head, batch row), 384 threads: two
//    consumer warpgroups own 64 query rows each; one warp of the third
//    (producer) warpgroup issues the TMA loads. A 1-D grid with the q
//    tile slowest, last tile first: the causally longest tiles of every
//    head start in the first wave.
//  - Q is loaded once by TMA; K and V stream in tiles of 128 keys (hd
//    16-64) or 64 keys (hd 112, 128) through a 3-stage ring in shared
//    memory with full / empty mbarriers.
//  - S = Q K^T is wgmma m64nBKk16 with Q and K read from 128-byte
//    swizzled shared memory (hopper.cuh). The online softmax runs in
//    registers on the accumulator fragments: a row lives in the four
//    threads of a quad, so two shuffles reduce it; exp2 with log2(e)
//    folded into the scale; the LSE written stays natural-log.
//  - P is rounded to bf16 in registers and is the register-A operand of
//    O += P V (wgmma m64n{64,128}k16, V the MN-major B operand), so P
//    never goes through shared memory.
//  - Software pipeline: tile n's S is issued with tile n-1's P V, and
//    the softmax of tile n runs while P V finishes; the two consumer
//    warpgroups take turns to issue (named barriers), so one's products
//    run while the other computes its softmax.
//  - KV tiles hidden by the causal mask or the window from the whole q
//    tile are skipped; the mask is evaluated only on tiles that straddle
//    the diagonal, the window's edge or Sk. A key past Sk is masked to
//    -inf explicitly: TMA fills rows past the end with zeros, which would
//    score 0.
//  - hd 112 is loaded as 128 (two 64-column swizzle panels) and hd 16 /
//    32 as 64: TMA fills the columns past hd with zeros, which add
//    nothing to Q K^T, and P V's extra output columns are not stored.
//    hd 112 thus executes 128/112 of the flops; hd 16 and 32 (no main
//    path) 4x and 2x.
//  - Registers: ptxas gives every thread of the CTA 168 registers, at
//    384 threads as at 288. The producer warpgroup hands registers to
//    the consumers (setmaxnreg 24 / 240); ptxas still reports 168, yet
//    the form with it runs faster: hd 112 in 0.2269 ms against 0.2717
//    for 288 threads without it, hd 64 in 0.0644 against 0.0767 (one
//    H100 at 700 W, tools/attn_variants.py). 128-key tiles at hd 128
//    spill 248 bytes and ran hd 112 in 0.2849 ms; 64-key tiles spill
//    nothing at any head dim.
//  - TMA needs a 16-byte-aligned base and every outer stride a multiple
//    of 16 bytes; the wrapper checks both and raises otherwise.
// A call builds its three tensor maps on the host
// (cuTensorMapEncodeTiled, looked up through the CUDA runtime): host
// time that PERF.md reports beside the kernel's.
//
// f32 (the reference phases and card tests only): attn_kernel<float>,
// the CUDA-core kernel of the first port, unchanged: those checks hold
// the kernel to 1e-4 of the plain version, which TF32 or bf16 products
// cannot meet. One block of 128 threads per (64-row q tile, head, batch
// row), 64-key tiles staged in shared memory as f32, each thread a 4 x 8
// patch of the score tile with its row statistics reduced over 8 lanes.
// The dispatch is by dtype only.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;   // 16 row groups x 8 lanes
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }

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
  constexpr int DJ = HD / 8;      // output columns per thread (HD % 8 == 0)
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
    case 112:   // zamba2-7b's shared attention (3584 / 32 heads)
      return launch_hd<T, 112>(q, k, v, out, lse, B, H, Kh, Sq, Sk, qs, ks, vs, os, sm_scale, causal, window, stream);
    case 128:
      return launch_hd<T, 128>(q, k, v, out, lse, B, H, Kh, Sq, Sk, qs, ks, vs, os, sm_scale, causal, window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}


// ------------------------------------------------ bf16: the tensor cores
using hopper::desc;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int HD>
struct Fwd {
  static constexpr int HDP = HD <= 64 ? 64 : 128;   // head dim as loaded
  static constexpr int PANELS = HDP / 64;           // 128-byte panels
  static constexpr int BQ = 128;                    // 2 warpgroups x 64
  static constexpr int BKV = HDP == 64 ? 128 : 64;  // keys a tile
  static constexpr int STAGES = 3;
  static constexpr int Q_BYTES = BQ * HDP * 2;
  static constexpr int KV_BYTES = BKV * HDP * 2;    // one of K, V
  static constexpr int TILES = Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = TILES + 64 + 1024;    // barriers, alignment
  static constexpr int THREADS = 384;               // + 1 producer wg
};

template <int HD>
__global__ void __launch_bounds__(384, 1)
fa_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
             int H, int Kh, int Sq, int Sk, Strides os, float sm_scale,
             int causal, int window) {
  using C = Fwd<HD>;
  constexpr int HDP = C::HDP, BQ = C::BQ, BKV = C::BKV, ST = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = sm;                        // panel p at p * BQ * 128
  uint8_t* KVs = sm + C::Q_BYTES;          // stage s: K, then V
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + C::TILES);
  uint64_t* qbar = bar;
  uint64_t* full = bar + 1;                // [ST]
  uint64_t* empty = bar + 1 + ST;          // [ST]

  // a 1-D grid, q tile slowest and last first: the causally longest
  // tiles of every (head, batch row) start in the first wave
  const int nqt = (Sq + BQ - 1) / BQ;
  const int per_tile = (int)gridDim.x / nqt;          // H * B
  const int q0 = (nqt - 1 - (int)blockIdx.x / per_tile) * BQ;
  const int h = (int)blockIdx.x % per_tile % H;
  const int b = (int)blockIdx.x % per_tile / H;
  const int kh = h / (H / Kh);
  // KV tiles that can hold a visible key for some row of this q tile
  int kt_end = (Sk + BKV - 1) / BKV;
  if (causal) kt_end = min(kt_end, (min(q0 + BQ, Sq) - 1) / BKV + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BKV;
  const int ntiles = kt_end - kt_begin;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    hopper::mbar_init(qbar, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);     // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {                         // producer warpgroup
    hopper::regs_dec<24>();                // its registers to the consumers
    if (warp == 8 && lane == 0) {
      hopper::mbar_expect_tx(qbar, C::Q_BYTES);
      for (int p = 0; p < C::PANELS; ++p)
        hopper::tma_load(Qs + p * BQ * 128, &qmap, 64 * p, h, q0, b, qbar);
      for (int n = 0; n < ntiles; ++n) {
        const int s = n % ST;
        hopper::mbar_wait(&empty[s], ((n / ST) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
        uint8_t* kd = KVs + s * 2 * C::KV_BYTES;
        const int k0 = (kt_begin + n) * BKV;
        for (int p = 0; p < C::PANELS; ++p) {
          hopper::tma_load(kd + p * BKV * 128, &kmap, 64 * p, kh, k0, b,
                           &full[s]);
          hopper::tma_load(kd + C::KV_BYTES + p * BKV * 128, &vmap, 64 * p,
                           kh, k0, b, &full[s]);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns q rows wg*64 .. wg*64+63; this thread
    // rows r0 and r0 + 8 of the accumulators (layout in hopper.cuh)
    hopper::regs_inc<240>();
    const int wg = warp / 4;
    const int t = lane % 4;
    const int r0 = q0 + wg * 64 + (warp % 4) * 16 + lane / 4;
    const float sl2 = sm_scale * LOG2E;
    constexpr float MASKED = NEG_INF * LOG2E;   // -1e30 in log2 units
    float o[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
    float m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f}, alpha[2];
    float sc[BKV / 2];
    uint32_t pa[BKV / 16][4];
    const uint8_t* qa = Qs + wg * 64 * 128;

    // S = Q K^T of tile n, issued and committed (not waited for)
    auto issue_s = [&](int n) {
      const uint8_t* kd = KVs + (n % ST) * 2 * C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk)   // panel kk / 4, 32 B a step
        hopper::wgmma_ss(sc, desc(qa + (kk / 4) * BQ * 128 + (kk % 4) * 32,
                                  16, 1024),
                         desc(kd + (kk / 4) * BKV * 128 + (kk % 4) * 32, 16,
                              1024),
                         kk > 0);
      hopper::wgmma_commit();
    };
    // O += P V of tile n, issued and committed
    auto issue_pv = [&](int n) {
      const uint8_t* vd = KVs + (n % ST) * 2 * C::KV_BYTES + C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        hopper::wgmma_rs(o, pa[kk], desc(vd + kk * 16 * 128, BKV * 128, 1024));
      hopper::wgmma_commit();
    };
    // tile n's scores -> P (in sc), the running max m, the rescale alpha
    // and the per-thread partial row sums l; masks only where the tile
    // straddles an edge
    auto softmax = [&](int n) {
      const int k0 = (kt_begin + n) * BKV;
      const bool edge = k0 + BKV > Sk || (causal && k0 + BKV - 1 > q0) ||
                        (window > 0 && q0 + BQ - 1 - k0 >= window);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = sc[4 * i + j] * sl2;
          if (edge) {
            const int kpos = k0 + 8 * i + 2 * t + (j & 1);
            const int qpos = r0 + (j >> 1) * 8;
            if (kpos >= Sk)
              x = -INFINITY;            // not a key at all
            else if ((causal && kpos > qpos) ||
                     (window > 0 && qpos - kpos >= window))
              x = MASKED;
          }
          sc[4 * i + j] = x;
          mx[j >> 1] = fmaxf(mx[j >> 1], x);
        }
      float rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = exp2f(sc[4 * i + j] - m[j >> 1]);
          sc[4 * i + j] = p;
          rsum[j >> 1] += p;
        }
      // l stays a per-thread partial sum until the end (linear in alpha)
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rsum[r];
    };

    // Software pipeline: tile n's S = Q K^T is issued together with tile
    // n - 1's O += P V, so the softmax of tile n runs on the CUDA cores
    // while the tensor cores finish P V; O is rescaled once P V is in.
    // The two warpgroups take turns to issue (named barriers 1 and 2), so
    // one's products run while the other computes its softmax.
    auto my_turn = [&]() { hopper::bar_sync(1 + wg, 256); };
    auto your_turn = [&](int n) {
      if (wg == 0 || n + 1 < ntiles) hopper::bar_arrive(2 - wg, 256);
    };
    if (wg == 1 && ntiles > 0) hopper::bar_arrive(1, 256);   // 0 goes first
    hopper::mbar_wait(qbar, 0);
    if (ntiles > 0) {
      hopper::mbar_wait(&full[0], 0);
      my_turn();
      hopper::wgmma_fence();
      issue_s(0);
      your_turn(0);
      hopper::wgmma_wait();
      hopper::fence_regs(sc);
      softmax(0);
      hopper::to_a_frags<BKV>(sc, pa);
    }
    for (int n = 1; n < ntiles; ++n) {
      hopper::mbar_wait(&full[n % ST], (n / ST) & 1);
      my_turn();
      hopper::wgmma_fence();
      issue_s(n);
      issue_pv(n - 1);
      your_turn(n);
      hopper::wgmma_wait<1>();                 // S of tile n is in
      hopper::fence_regs(sc);
      softmax(n);
      hopper::wgmma_wait();                    // P V of tile n - 1 is in
      hopper::fence_regs(o);
      if (lane == 0) hopper::mbar_arrive(&empty[(n - 1) % ST]);
#pragma unroll
      for (int i = 0; i < HDP / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[4 * i + j] *= alpha[j >> 1];
      hopper::to_a_frags<BKV>(sc, pa);
    }
    if (ntiles > 0) {
      hopper::wgmma_fence();
      issue_pv(ntiles - 1);
      hopper::wgmma_wait();
      hopper::fence_regs(o);
      if (lane == 0) hopper::mbar_arrive(&empty[(ntiles - 1) % ST]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = r0 + 8 * r;
      if (qpos >= Sq) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow = out + b * os.b + h * os.h + (long long)qpos * os.s;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i + 2 * t) =
            __floats2bfloat162_rn(o[4 * i + 2 * r] * inv,
                                  o[4 * i + 2 * r + 1] * inv);
      if (lse != nullptr && t == 0)
        lse[((long long)b * H + h) * Sq + qpos] = m[r] * LN2 + logf(l[r]);
    }
  }
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 float* lse, int B, int H, int Kh, int Sq, int Sk,
                 const long long* st, float sm_scale, int causal,
                 int window, cudaStream_t stream) {
  using C = Fwd<HD>;
  CUtensorMap qm, km, vm;
  int err;
  if ((err = hopper::make_map(&qm, q, B, H, Sq, HD, st[0], st[1], st[2],
                              C::BQ)) ||
      (err = hopper::make_map(&km, k, B, Kh, Sk, HD, st[3], st[4], st[5],
                              C::BKV)) ||
      (err = hopper::make_map(&vm, v, B, Kh, Sk, HD, st[6], st[7], st[8],
                              C::BKV)))
    return err;
  err = (int)cudaFuncSetAttribute(fa_fwd_wgmma<HD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  C::SMEM);
  if (err) return err;
  const Strides os{st[9], st[10], st[11]};
  const unsigned grid = (unsigned)((Sq + C::BQ - 1) / C::BQ) * H * B;
  fa_fwd_wgmma<HD><<<grid, C::THREADS, C::SMEM, stream>>>(
      qm, km, vm, (__nv_bfloat16*)out, lse, H, Kh, Sq, Sk, os, sm_scale,
      causal, window);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int H, int Kh, int Sq, int Sk, int hd,
                const long long* st, float sm_scale, int causal, int window,
                cudaStream_t stream) {
  if (B <= 0 || Kh <= 0 || H % Kh != 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16:
      return launch_wgmma<16>(q, k, v, out, lse, B, H, Kh, Sq, Sk, st, sm_scale, causal, window, stream);
    case 32:
      return launch_wgmma<32>(q, k, v, out, lse, B, H, Kh, Sq, Sk, st, sm_scale, causal, window, stream);
    case 64:
      return launch_wgmma<64>(q, k, v, out, lse, B, H, Kh, Sq, Sk, st, sm_scale, causal, window, stream);
    case 112:   // zamba2-7b's shared attention (3584 / 32 heads)
      return launch_wgmma<112>(q, k, v, out, lse, B, H, Kh, Sq, Sk, st, sm_scale, causal, window, stream);
    case 128:
      return launch_wgmma<128>(q, k, v, out, lse, B, H, Kh, Sq, Sk, st, sm_scale, causal, window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 int64 element strides, (batch, head, seq) for q, k, v, out;
// lse: (B, H, Sq) f32 contiguous, or null
// (the same signature for both dtypes)
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   int B, int H, int Kh, int Sq, int Sk,
                                   int hd, const long long* strides,
                                   float sm_scale, int causal, int window,
                                   void* stream) {
  return launch<float>(q, k, v, out, lse, B, H, Kh, Sq, Sk, hd, strides,
                       sm_scale, causal, window, (cudaStream_t)stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, float* lse,
                                    int B, int H, int Kh, int Sq, int Sk,
                                    int hd, const long long* strides,
                                    float sm_scale, int causal, int window,
                                    void* stream) {
  return launch_bf16(q, k, v, out, lse, B, H, Kh, Sq, Sk, hd, strides,
                     sm_scale, causal, window, (cudaStream_t)stream);
}
