// flash_decode: one-token GQA attention over a KV cache under an int32
// validity mask, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py
// (flash_decode / _decode_kernel). Semantics are those of
// src/repro/kernels/ref.py::decode_ref: scores scaled by 1/sqrt(hd), an
// invalid slot scores the finite -1e30 (so a row with no valid slot
// returns the mean of v, never NaN), output divided by max(l, 1e-30).
//
// Bound on the card: bytes. Each valid slot's K and V rows are read once
// (2*Kh*hd elements a slot) against ~4*H*hd flops a slot, about one flop
// per byte, far below the H100's ~295 flop/byte ridge. So the design
// moves as few bytes as it can and keeps enough of them in flight.
//
// Design: one launch, split-K over the cache with the merge inside it,
// by one of two CUDA functions. bf16 groups of 4 to 16 query heads a KV
// head (mixtral 4, llama4 5, llava 7, the qwen2s 8, granite 4 at hd 64)
// take the tensor-core kernel flash_decode_kernel_mma where TMA can read
// the cache views; f32, bf16 groups of 1 to 3 (zamba2, whisper, smollm)
// and a view TMA cannot read (the layout decides, never a failure) take
// the CUDA-core kernel flash_decode_kernel.
//
// flash_decode_kernel_mma (namespace tc):
//  - The group's heads are the M rows of mma.sync m16n8k16, padded with
//    zero rows to 16: S = q K^T over a warp's 16 keys and O += P V on the
//    tensor cores, q and K exact bf16 operands, f32 accumulators. The
//    online softmax (m, l) runs per row in registers, in log2 units; P is
//    rounded to bf16, the operand of P V and what l sums.
//  - 160 threads: a producer warp issues the TMA loads of 64-key K and V
//    tiles (one 128-byte-swizzled panel per 64 head dims, read through
//    ldmatrix) into a ring of 4 (K, V) stages on full / empty mbarriers;
//    4 consumer warps take 16 keys of each tile with their own (m, l, O).
//  - Grid (splits, B * Kh), a cluster of `splits` blocks per (batch row,
//    KV head), splits a power of two, at most 8, the most that keep the
//    grid to 66 blocks (half the SMs: more blocks, or more stages, kept
//    more bytes in flight and ran slower, tools/decode_scan_variants.py):
//    2 splits of 32 tiles at mixtral's ring (B=4, Kh=8, W=4096), 4 of
//    4-5 tiles at llava's cache (B=2, Kh=8, W=1152).
//  - Before any load the block reads its range of the validity mask
//    into shared memory as one word of bits a 32-key group (a warp
//    ballot each): a tile with no valid key is not read, the consumers
//    mask from the bits, and a row with no valid key anywhere reads every
//    tile and scores -1e30, the mean of v as the reference.
//  - The warps' states merge in shared memory in warp order, then the
//    cluster's blocks through distributed shared memory in rank order,
//    as the CUDA-core kernel's do (merge_store).
//  - ptxas (sm_90a): 148 registers at hd 128, no spill; shared memory
//    4 x 32 KB of ring at hd 128 (4 x 16 KB at hd 64), the block's state
//    and the mask bits, 137 KB at mixtral's shape: one block an SM.
//
// flash_decode_kernel (the CUDA-core kernel):
//  - The grid is (splits, B * Kh): one thread-block cluster of `splits`
//    blocks per (batch row, KV head), each block a contiguous range
//    of 64-key tiles. Splits are a power of two, at most 8 (the portable
//    cluster size) and at most the tile count, chosen so that at least
//    132 blocks (one an SM) run where W allows: smollm's 24 pairs at W
//    1024 take 8 splits, zamba2's 128 pairs at W 256 take 2, two tiles
//    each. (More splits, 264 blocks and more, ran slower at zamba2's
//    shape: more merging for the same bytes; so did 128-key tiles over 8
//    warps, which at f32 and hd 112 would also need 237 KB of shared
//    memory; tools/decode_scan_variants.py.)
//  - Each block first reads the row's whole validity mask (W ints, from
//    L2, in the same round trip as q) and flags which 32-key groups of
//    its tiles hold a valid key (a warp ballot each); a tile with no
//    valid key is not read, as above. (Also zero-filling, rather than
//    reading, the empty 32-key half of a tile that is read measured the
//    same at both main path shapes: tools/decode_scan_variants.py.)
//  - The tiles stream into bf16 (or f32) shared memory through cp.async,
//    16 bytes a thread, through a ring of two (K, V) tile pairs: the next
//    tile to read is in flight while one is used (a block with one tile
//    issues no second load). Nothing is widened to f32 in shared memory.
//    Views whose rows are not 16-byte aligned take a scalar copy instead.
//  - Keys, not heads, are split across the 4 warps: each warp takes 16
//    keys of a tile and keeps its own online softmax (m, l, acc), so no
//    block barrier sits inside the softmax. A pair of lanes scores one
//    key, half of hd each, in f32 on the CUDA cores, for every query head
//    of the group (one K row read serves g heads); P V gives each lane 1-4
//    output dims of every head. Heads are bucketed (g = 1, g <= 3, and
//    g <= 16, which only f32 and an unaligned bf16 view reach) and a
//    bucket's spare heads are computed on zeros rather than branched
//    around.
//  - The four warps' states merge in shared memory in warp order; then
//    every block of the cluster merges the blocks' states through
//    distributed shared memory in rank order, each block writing a share
//    of the outputs.
//  - ptxas (sm_90a): bf16 hd 64 at g 3 (smollm) 89 registers, hd 112 at
//    g 1 (zamba2) 90, no spill; the 16-head bucket 254 at hd 128, no
//    spill. chip_smoke.py writes every instantiation's report to
//    chiprun_out/ptxas.txt.
// No scratch tensor, no atomics: two runs are bitwise equal, and so are
// any two layouts of the same cache. Any W works: keys past W score -inf
// and their rows are zero-filled. K and V are read through element
// strides (last dim contiguous): the model's (B, W, Kh, hd) cache goes in
// as a permuted view, never copied.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TILE = 64;          // keys a tile
constexpr int THREADS = 128;      // 4 warps
constexpr int QUARTERS = TILE / 32;  // 32-key groups a tile
constexpr int NWARPS = THREADS / 32;
constexpr int KPW = TILE / NWARPS;  // keys a warp takes of each tile
constexpr int MAX_G = 16;         // query heads per KV head
constexpr int MAX_SPLIT = 8;      // blocks in a cluster (portable limit)
constexpr int MIN_BLOCKS = 132;   // a block on each of 132 SMs
constexpr float NEG_BIG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// N consecutive elements at p (aligned to their size) as f32
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float (&f)[N]) {
  if constexpr (sizeof(T) * N == 16) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const T* x = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f32(x[i]);
  } else if constexpr (sizeof(T) * N == 8) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    const T* x = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f32(x[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f32(p[i]);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* valid;
  void* out;
  int Kh, W, g, nsplit, vec;
  long long qsb, qsh, ksb, ksh, ksw, vsb, vsh, vsw, valsb, osb, osh;
  float sm_scale;
};

// Shared memory of one block, in this order: q as f32 [G][HD]; each
// warp's weights [NWARPS][G][KPW]; a flag for each 32-key group of the
// block's tiles (any valid key); the ring of two (K, V) tile pairs,
// reused after the loop for the warps' states [NWARPS][G][m, l,
// acc[HD]]; the block's state [G][m, l, acc[HD]], which the cluster
// reads.
template <typename T, int HD, int G>
struct Smem {
  static constexpr int VE = 16 / sizeof(T);   // elements a 16-byte chunk
  static constexpr int KST = HD + VE;         // padded tile row
  static constexpr size_t HEAD = sizeof(float) * (G * HD + NWARPS * G * KPW);
  static constexpr size_t WPART = sizeof(float) * NWARPS * G * (HD + 2);
  static constexpr size_t BPART = sizeof(float) * G * (HD + 2);
  __host__ __device__ static size_t flags(int tps) {
    return 16 * (size_t)((QUARTERS * tps + 3) / 4);
  }
  static constexpr size_t RING = sizeof(T) * 2 * 2 * TILE * KST > WPART
                                     ? sizeof(T) * 2 * 2 * TILE * KST
                                     : WPART;
  __host__ __device__ static size_t total(int tps) {
    return HEAD + flags(tps) + RING + BPART;
  }
};

// The per-warp softmax states wpart[nw][G][m, l, acc[HD]] (m in natural
// log units, visible to every thread), merged in warp order into the
// block's state bpart[G][m, l, acc[HD]]; then the cluster's blocks,
// merged in rank order through distributed shared memory, this block
// writing every nsplit-th group of NT outputs. A fixed order, no atomics:
// two runs are bitwise equal.
template <typename T, int HD, int G, int NW, int NT, int MS>
__device__ __forceinline__ void merge_store(const float* wpart, float* bpart,
                                            const Args& a, int rank, int b,
                                            int kh, int tid) {
  cg::cluster_group cluster = cg::this_cluster();
  const int g = a.g;
  for (int e = tid; e < g * HD; e += NT) {
    const int h = e / HD, d = e % HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      M = fmaxf(M, wpart[(w * G + h) * (HD + 2)]);
    float Ls = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float* r = wpart + (w * G + h) * (HD + 2);
      const float wt = r[0] == -INFINITY ? 0.f : __expf(r[0] - M);
      Ls = fmaf(r[1], wt, Ls);
      O = fmaf(r[2 + d], wt, O);
    }
    float* bp = bpart + h * (HD + 2);
    bp[2 + d] = O;
    if (d == 0) {
      bp[0] = M;
      bp[1] = Ls;
    }
  }
  cluster.sync();
  T* ob = static_cast<T*>(a.out) + b * a.osb + kh * g * a.osh;
  for (int e = rank * NT + tid; e < g * HD; e += a.nsplit * NT) {
    const int h = e / HD, d = e % HD;
    // every rank's (m, l, acc[d]) read at once: the remote loads overlap
    float mr[MS], lr[MS], orr[MS];
#pragma unroll
    for (int r = 0; r < MS; ++r) {
      mr[r] = -INFINITY;
      lr[r] = orr[r] = 0.f;
      if (r < a.nsplit) {
        const float* bp = cluster.map_shared_rank(bpart, r) + h * (HD + 2);
        mr[r] = bp[0];
        lr[r] = bp[1];
        orr[r] = bp[2 + d];
      }
    }
    float M = -INFINITY;
#pragma unroll
    for (int r = 0; r < MS; ++r) M = fmaxf(M, mr[r]);
    float Ls = 0.f, O = 0.f;
#pragma unroll
    for (int r = 0; r < MS; ++r) {
      const float wt = mr[r] == -INFINITY ? 0.f : __expf(mr[r] - M);
      Ls = fmaf(lr[r], wt, Ls);
      O = fmaf(orr[r], wt, O);
    }
    ob[h * a.osh + d] = from_f32<T>(O / fmaxf(Ls, 1e-30f));
  }
  cluster.sync();                 // keep this block's state until read
}

template <typename T, int HD, int G>
__global__ void __launch_bounds__(THREADS) flash_decode_kernel(Args a) {
  using L = Smem<T, HD, G>;
  constexpr int VE = L::VE, KST = L::KST;
  constexpr int HALF = HD / 2;                    // dims a lane of a pair
  constexpr int DPL = HD <= 32 ? 1 : HD <= 64 ? 2 : 4;  // out dims a lane
  extern __shared__ __align__(16) unsigned char smem[];

  const int g = a.g;
  const int rank = blockIdx.x;                    // the cluster spans x
  const int pair = blockIdx.y;
  const int b = pair / a.Kh, kh = pair % a.Kh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ntiles = (a.W + TILE - 1) / TILE;
  const int tps = (ntiles + a.nsplit - 1) / a.nsplit;
  const int t0 = rank * ntiles / a.nsplit;
  const int t1 = (rank + 1) * ntiles / a.nsplit;

  float* q_s = reinterpret_cast<float*>(smem);
  float* p_s = q_s + G * HD;
  int* qflag = reinterpret_cast<int*>(smem + L::HEAD);
  unsigned char* ring = smem + L::HEAD + L::flags(tps);
  float* bpart = reinterpret_cast<float*>(ring + L::RING);

  const T* qb = static_cast<const T*>(a.q) + b * a.qsb + kh * g * a.qsh;
  const T* kb = static_cast<const T*>(a.k) + b * a.ksb + kh * a.ksh;
  const T* vb = static_cast<const T*>(a.v) + b * a.vsb + kh * a.vsh;
  const int* valid = a.valid + b * a.valsb;

  // q and the row's mask in one round trip: every load is issued before
  // any result is used. The mask says whether the row has a valid key at
  // all, and (a warp ballot for each 32 keys) which of this block's
  // 32-key groups hold one. q is zero for the bucket's heads past g.
  constexpr int QPT = (G * HD + THREADS - 1) / THREADS;
  constexpr int VPT = 8;                          // mask loads in flight
  float qv[QPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int e = tid + i * THREADS, h = e / HD;
    qv[i] = e < G * HD && h < g ? to_f32(qb[h * a.qsh + e % HD]) : 0.f;
  }
  int any = 0;
  for (int base = 0; base < ntiles * TILE; base += VPT * THREADS) {
    int v[VPT];
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int w = base + i * THREADS + tid;
      v[i] = w < a.W ? __ldg(valid + w) : 0;
    }
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      any |= v[i] > 0;
      const int grp = (base + i * THREADS) / 32 + warp;   // warp-uniform
      if (grp >= QUARTERS * t0 && grp < QUARTERS * t1) {
        const unsigned ballot = __ballot_sync(FULL, v[i] > 0);
        if (lane == 0) qflag[grp - QUARTERS * t0] = ballot != 0u;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < QPT; ++i)
    if (tid + i * THREADS < G * HD) q_s[tid + i * THREADS] = qv[i];
  const int row_any = __syncthreads_or(any);
  // a 32-key group wanted: every group of a row with no valid key, else
  // those holding one; the block's tiles to read are those with a group
  // wanted, in order (every thread walks the flags)
  auto wanted = [&](int grp) { return !row_any || qflag[grp]; };
  const int ntl = t1 - t0;
  auto next_tile = [&](int tl) {
    for (; tl < ntl; ++tl)
      for (int q = 0; q < QUARTERS; ++q)
        if (wanted(QUARTERS * tl + q)) return tl;
    return tl;
  };

  // rows [w0, w0 + 64) of K and V, local tile tl, into ring stage `st`;
  // rows past W are zero-filled, which reads nothing from device memory
  auto load = [&](int tl, int st) {
    T* ks = reinterpret_cast<T*>(ring) + (size_t)st * 2 * TILE * KST;
    T* vs = ks + TILE * KST;
    const int w0 = (t0 + tl) * TILE, n = min(TILE, a.W - w0);
    if (a.vec) {
      constexpr int CH = HD / VE;
      for (int e = tid; e < TILE * CH; e += THREADS) {
        const int j = e / CH, c = e % CH;
        const bool ok = j < n;
        const long long row = ok ? w0 + j : 0;
        hopper::cp_async16(ks + j * KST + c * VE, kb + row * a.ksw + c * VE,
                   ok ? 16 : 0);
        hopper::cp_async16(vs + j * KST + c * VE, vb + row * a.vsw + c * VE,
                   ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < TILE * HD; e += THREADS) {
        const int j = e / HD, d = e % HD;
        const bool ok = j < n;
        const long long row = w0 + j;
        ks[j * KST + d] = ok ? kb[row * a.ksw + d] : from_f32<T>(0.f);
        vs[j * KST + d] = ok ? vb[row * a.vsw + d] : from_f32<T>(0.f);
      }
    }
  };

  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[h][e] = 0.f;
  }
  const int jl = lane >> 1, half = lane & 1;
  const int d0 = lane * DPL;
  float* pw = p_s + warp * G * KPW;

  int cur = next_tile(0);
  int nxt = cur < ntl ? next_tile(cur + 1) : ntl;
  if (cur < ntl) load(cur, 0);
  hopper::cp_async_commit();
  for (int i = 0; cur < ntl; ++i) {
    const int st = i & 1;
    if (nxt < ntl) load(nxt, st ^ 1);   // none past the last: an empty group
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();         // the current tile is in
    __syncthreads();
    const T* ks = reinterpret_cast<const T*>(ring) + (size_t)st * 2 * TILE * KST;
    const T* vs = ks + TILE * KST;

    // scores: lanes (2j, 2j+1) hold key j of this warp's 16, half of hd
    // each, for every head of the group
    const int j = warp * KPW + jl;
    const int kidx = (t0 + cur) * TILE + j;
    float s[G];
#pragma unroll
    for (int h = 0; h < G; ++h) s[h] = 0.f;
    const T* kr = ks + j * KST + half * HALF;
    const float* qh = q_s + half * HALF;
#pragma unroll
    for (int c = 0; c < HALF; c += VE) {
      float kf[VE];
      load_f32<T, VE>(kr + c, kf);
#pragma unroll
      for (int h = 0; h < G; ++h)
#pragma unroll
        for (int e = 0; e < VE; e += 4) {
          const float4 qq = *reinterpret_cast<const float4*>(qh + h * HD + c + e);
          s[h] = fmaf(qq.x, kf[e], s[h]);
          s[h] = fmaf(qq.y, kf[e + 1], s[h]);
          s[h] = fmaf(qq.z, kf[e + 2], s[h]);
          s[h] = fmaf(qq.w, kf[e + 3], s[h]);
        }
    }
    const bool in_range = kidx < a.W;
    const bool ok = in_range && __ldg(valid + kidx) > 0;
    const float masked = in_range && !row_any ? NEG_BIG : -INFINITY;

    // this warp's online softmax over its 16 keys, every head of the
    // bucket at once (no branch: a head past g scores 0 and is unused)
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const float x = s[h] + __shfl_xor_sync(FULL, s[h], 1);
      const float sc = ok ? x * a.sm_scale : masked;
      float mt = sc;
#pragma unroll
      for (int o = 16; o >= 2; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, o));
      const float mn = fmaxf(m[h], mt);         // -inf: no key yet
      const float alpha = m[h] == -INFINITY ? 0.f : __expf(m[h] - mn);
      const float p = sc == -INFINITY ? 0.f : __expf(sc - mn);
      float ps = half == 0 ? p : 0.f;
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1)
        ps += __shfl_xor_sync(FULL, ps, o);
      l[h] = fmaf(l[h], alpha, ps);
      m[h] = mn;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[h][e] *= alpha;
      if (half == 0) pw[h * KPW + jl] = p;
    }
    __syncwarp();
    // P V: each lane DPL dims of every head over the warp's 16 keys
    if (d0 < HD) {
#pragma unroll
      for (int j4 = 0; j4 < KPW; j4 += 4) {
        float4 pv[G];               // the weights of 4 keys, every head
#pragma unroll
        for (int h = 0; h < G; ++h)
          pv[h] = *reinterpret_cast<const float4*>(pw + h * KPW + j4);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float vf[DPL];
          load_f32<T, DPL>(vs + (warp * KPW + j4 + jj) * KST + d0, vf);
#pragma unroll
          for (int h = 0; h < G; ++h) {
            const float p = jj == 0 ? pv[h].x : jj == 1 ? pv[h].y
                          : jj == 2 ? pv[h].z : pv[h].w;
#pragma unroll
            for (int e = 0; e < DPL; ++e) acc[h][e] = fmaf(p, vf[e], acc[h][e]);
          }
        }
      }
    }
    __syncthreads();              // the stage and pw are free again
    cur = nxt;
    nxt = cur < ntl ? next_tile(cur + 1) : ntl;
  }

  // the warps' states, merged in warp order into the block's
  float* wpart = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int h = 0; h < G; ++h) {
    if (h < g) {
      float* r = wpart + (warp * G + h) * (HD + 2);
      if (lane == 0) {
        r[0] = m[h];
        r[1] = l[h];
      }
      if (d0 < HD) {
#pragma unroll
        for (int e = 0; e < DPL; ++e) r[2 + d0 + e] = acc[h][e];
      }
    }
  }
  __syncthreads();
  merge_store<T, HD, G, NWARPS, THREADS, MAX_SPLIT>(wpart, bpart, a, rank,
                                                    b, kh, tid);
}

template <typename T, int HD, int G>
int launch_g(Args a, int B, cudaStream_t stream) {
  const int pairs = B * a.Kh;
  const int ntiles = (a.W + TILE - 1) / TILE;
  if (pairs > 65535) return (int)cudaErrorInvalidValue;
  int ns = 1;
  while (ns < MAX_SPLIT && ns * pairs < MIN_BLOCKS) ns *= 2;
  while (ns > ntiles) ns /= 2;
  const int tps = (ntiles + ns - 1) / ns;
  a.nsplit = ns;
  const size_t smem = Smem<T, HD, G>::total(tps);
  auto kernel = flash_decode_kernel<T, HD, G>;
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    granted = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ns, pairs);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ns;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ------------------------------------------ bf16, g >= 4: tensor cores
namespace tc {

constexpr int CONSUMERS = 4;                    // warps, 16 keys of a tile each
constexpr int THREADS = 32 * (CONSUMERS + 1);   // + one producer warp
constexpr int STAGES = 4;                       // (K, V) tile pairs in flight
constexpr int MAX_SPLIT = 8;                    // blocks in a cluster
constexpr int MAX_BLOCKS = 66;                  // half the SMs, one wave
constexpr int ROWS = 16;                        // the group's heads, padded: M
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shared memory from a 1024-byte boundary: the ring of STAGES (K, V) tile
// pairs, each tile PANELS x (64 keys x 128 bytes) in TMA's 128-byte
// swizzle, reused after the loop for the warps' states
// [CONSUMERS][ROWS][m, l, acc[HD]]; the block's state [ROWS][m, l,
// acc[HD]], which the cluster reads; the full / empty mbarriers; a flag
// for each 32-key group of the block's tiles.
template <int HD>
struct Smem {
  static constexpr int PANELS = (HD + 63) / 64;
  static constexpr int TILE_BYTES = PANELS * TILE * 128;
  static constexpr int STAGE = 2 * TILE_BYTES;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int WPART = sizeof(float) * CONSUMERS * ROWS * (HD + 2);
  static constexpr int BODY = RING > WPART ? RING : WPART;
  static constexpr int BPART = sizeof(float) * ROWS * (HD + 2);
  static constexpr int BARS = 8 * 2 * STAGES;
  static size_t total(int tps) {
    return 1024 + BODY + BPART + BARS + 16 * (size_t)((QUARTERS * tps + 3) / 4);
  }
};

// four 8 x 8 b16 matrices from shared memory, lanes 8i .. 8i + 7 giving
// the row addresses of matrix i (transposed: .trans)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_u32(p)) : "memory");
}

// D(16 x 8, f32) += A(16 x 16, bf16, rows) B(16 x 8, bf16, columns): lane
// 4 gq + tq holds d[0..1] at row gq, columns 2 tq, 2 tq + 1 and d[2..3] at
// row gq + 8; a[0..3] the A elements (gq, 2 tq..), (gq + 8, 2 tq..),
// (gq, 2 tq + 8..), (gq + 8, 2 tq + 8..); b0, b1 the B elements (2 tq..,
// gq) and (2 tq + 8.., gq)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3},"
      " {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte offset of the 16-byte chunk c (over all panels) of row r of a tile
__device__ __forceinline__ int chunk(int r, int c) {
  return (c >> 3) * TILE * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_decode_kernel_mma(const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, Args a) {
  using L = Smem<HD>;
  constexpr int KS = HD / 16;          // k16 steps of q K^T
  constexpr int NT = HD / 8;           // n8 tiles of P V
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = hopper::align1024(smem_raw);
  float* bpart = reinterpret_cast<float*>(ring + L::BODY);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L::BODY + L::BPART);
  uint64_t* empty = full + STAGES;
  unsigned* qbits =
      reinterpret_cast<unsigned*>(ring + L::BODY + L::BPART + L::BARS);

  const int g = a.g;
  const int rank = blockIdx.x;                    // the cluster spans x
  const int pair = blockIdx.y;
  const int b = pair / a.Kh, kh = pair % a.Kh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ntiles = (a.W + TILE - 1) / TILE;
  const int t0 = rank * ntiles / a.nsplit;
  const int t1 = (rank + 1) * ntiles / a.nsplit;
  const int ntl = t1 - t0;
  const int* valid = a.valid + b * a.valsb;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS);
    }
    hopper::fence_barrier_init();
  }
  // q, exact bf16, as the A operand of the consumer warps (heads past g
  // are zero rows), its loads in flight with the mask's
  const int gq = lane >> 2, tq = lane & 3;
  uint32_t qa[KS][4];
  if (warp < CONSUMERS) {
    const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) +
                              b * a.qsb + (long long)kh * g * a.qsh;
    auto qpair = [&](int h, int d) -> uint32_t {
      if (h >= g) return 0u;
      __nv_bfloat162 x;
      x.x = qb[h * a.qsh + d];
      x.y = qb[h * a.qsh + d + 1];
      return *reinterpret_cast<uint32_t*>(&x);
    };
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qa[kk][0] = qpair(gq, 16 * kk + 2 * tq);
      qa[kk][1] = qpair(gq + 8, 16 * kk + 2 * tq);
      qa[kk][2] = qpair(gq, 16 * kk + 2 * tq + 8);
      qa[kk][3] = qpair(gq + 8, 16 * kk + 2 * tq + 8);
    }
  }
  // the block's mask as one word of bits for each 32-key group (a warp
  // ballot each); every mask load of the round is issued before any is
  // used
  const int k_lo = t0 * TILE, k_hi = min(t1 * TILE, a.W);
  int any = 0;
  for (int base = k_lo; base < t1 * TILE; base += 8 * THREADS) {
    int v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int w = base + i * THREADS + tid;
      v[i] = w < k_hi ? __ldg(valid + w) : 0;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      any |= v[i] > 0;
      const int grp = (base - k_lo + i * THREADS) / 32 + warp;  // warp-uniform
      if (grp < QUARTERS * ntl) {
        const unsigned ballot = __ballot_sync(FULL, v[i] > 0);
        if (lane == 0) qbits[grp] = ballot;
      }
    }
  }
  int row_any = __syncthreads_or(any);
  if (!row_any) {           // none here: has the row a valid key elsewhere?
    for (int w = tid; w < a.W; w += THREADS)
      if (w < k_lo || w >= k_hi) any |= __ldg(valid + w) > 0;
    row_any = __syncthreads_or(any);
  }
  // a 32-key group wanted: every group of a row with no valid key, else
  // those holding one; the tiles to read are those with a group wanted
  auto next_tile = [&](int tl) {
    for (; tl < ntl; ++tl)
      for (int q = 0; q < QUARTERS; ++q)
        if (!row_any || qbits[QUARTERS * tl + q]) return tl;
    return tl;
  };

  if (warp == CONSUMERS) {                        // producer
    if (lane == 0) {
      int i = 0;
      for (int tl = next_tile(0); tl < ntl; tl = next_tile(tl + 1), ++i) {
        const int s = i % STAGES;
        hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], L::STAGE);
        uint8_t* kd = ring + s * L::STAGE;
        const int w0 = (t0 + tl) * TILE;          // rows past W land as zeros
        for (int p = 0; p < L::PANELS; ++p) {
          hopper::tma_load(kd + p * TILE * 128, &kmap, 64 * p, kh, w0, b,
                           &full[s]);
          hopper::tma_load(kd + L::TILE_BYTES + p * TILE * 128, &vmap, 64 * p,
                           kh, w0, b, &full[s]);
        }
      }
    }
  }

  // consumers: warp w scores keys 16 w .. 16 w + 15 of each tile for the
  // group's heads (rows gq and gq + 8 of the products), with its own
  // online softmax (m, l in log2 units, acc)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  if (warp < CONSUMERS) {
    const float sl2 = a.sm_scale * LOG2E;
    const int kw = warp * 16;
    const int mi = lane >> 3, r8 = lane & 7;
    int i = 0;
    for (int tl = next_tile(0); tl < ntl; tl = next_tile(tl + 1), ++i) {
      const int s = i % STAGES;
      hopper::mbar_wait(&full[s], (i / STAGES) & 1);
      const uint8_t* ks = ring + s * L::STAGE;
      const uint8_t* vs = ks + L::TILE_BYTES;

      // S = q K^T over this warp's 16 keys: two n8 tiles (keys kw..kw+7,
      // kw+8..kw+15); ldmatrix matrix mi = key half mi / 2, dim half mi % 2
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t kb[4];
        ldsm_x4(kb, ks + chunk(kw + (mi >> 1) * 8 + r8, 2 * kk + (mi & 1)));
        mma16816(sc[0], qa[kk], kb[0], kb[1]);
        mma16816(sc[1], qa[kk], kb[2], kb[3]);
      }
      // this lane's keys kw + 8 j + 2 tq + e: a key past W scores -inf, an
      // invalid one -inf, or -1e30 in a row with no valid key at all
      const int w0 = (t0 + tl) * TILE + kw;
      const int kb0 = w0 - k_lo;                  // the mask bits of the
      const unsigned bits = qbits[kb0 >> 5] >> (kb0 & 31);   // warp's keys
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = w0 + 8 * j + 2 * tq + e;
          const bool in_range = key < a.W;
          const bool ok = (bits >> (8 * j + 2 * tq + e)) & 1u;
          const float masked = in_range && !row_any ? NEG_BIG : -INFINITY;
          sc[j][e] = ok ? sc[j][e] * sl2 : masked;
          sc[j][2 + e] = ok ? sc[j][2 + e] * sl2 : masked;
          mx[0] = fmaxf(mx[0], sc[j][e]);
          mx[1] = fmaxf(mx[1], sc[j][2 + e]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {         // a row lives in a lane quad
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
        const float mn = fmaxf(m[r], mx[r]);
        const float alpha = m[r] == -INFINITY ? 0.f : exp2f(m[r] - mn);
        m[r] = mn;
        l[r] *= alpha;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          o[n][2 * r] *= alpha;
          o[n][2 * r + 1] *= alpha;
        }
      }
      // P rounded to bf16: the A operand of P V, and what l sums
      uint32_t pa[4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float x0 = sc[j][2 * r], x1 = sc[j][2 * r + 1];
          const __nv_bfloat162 p = __floats2bfloat162_rn(
              x0 == -INFINITY ? 0.f : exp2f(x0 - m[r]),
              x1 == -INFINITY ? 0.f : exp2f(x1 - m[r]));
          l[r] += __low2float(p) + __high2float(p);
          pa[2 * j + r] = *reinterpret_cast<const uint32_t*>(&p);
        }
      // O += P V: matrix mi = key half mi % 2, dim chunk 2 dn + mi / 2
#pragma unroll
      for (int dn = 0; dn < NT / 2; ++dn) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vs + chunk(kw + (mi & 1) * 8 + r8, 2 * dn + (mi >> 1)));
        mma16816(o[2 * dn], pa, vb[0], vb[1]);
        mma16816(o[2 * dn + 1], pa, vb[2], vb[3]);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(FULL, l[r], 1);
      l[r] += __shfl_xor_sync(FULL, l[r], 2);
    }
  }
  __syncthreads();                // every tile consumed: the ring is free

  // the warps' states (m in natural log units), merged as the CUDA-core
  // kernel's are
  float* wpart = reinterpret_cast<float*>(ring);
  if (warp < CONSUMERS) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int h = gq + 8 * r;
      if (h < g) {
        float* row = wpart + (warp * ROWS + h) * (HD + 2);
        if (tq == 0) {
          row[0] = m[r] * LN2;
          row[1] = l[r];
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          row[2 + 8 * n + 2 * tq] = o[n][2 * r];
          row[3 + 8 * n + 2 * tq] = o[n][2 * r + 1];
        }
      }
    }
  }
  __syncthreads();
  merge_store<__nv_bfloat16, HD, ROWS, CONSUMERS, THREADS, MAX_SPLIT>(
      wpart, bpart, a, rank, b, kh, tid);
}

// the K and V views as TMA reads them: a 16-byte-aligned base and every
// outer stride (of a dimension longer than 1) a multiple of 16 bytes
inline bool tma_ok(const Args& a, int B) {
  auto ok = [&](const void* p, long long sb, long long sh, long long sw) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
           (B == 1 || sb % 8 == 0) && (a.Kh == 1 || sh % 8 == 0) &&
           (a.W == 1 || sw % 8 == 0);
  };
  return ok(a.k, a.ksb, a.ksh, a.ksw) && ok(a.v, a.vsb, a.vsh, a.vsw);
}

template <int HD>
int launch(Args a, int B, cudaStream_t stream) {
  const int pairs = B * a.Kh;
  const int ntiles = (a.W + TILE - 1) / TILE;
  if (pairs > 65535) return (int)cudaErrorInvalidValue;
  int ns = 1;
  while (2 * ns <= MAX_SPLIT && 2 * ns * pairs <= MAX_BLOCKS) ns *= 2;
  while (ns > ntiles) ns /= 2;
  a.nsplit = ns;
  CUtensorMap km, vm;
  int err;
  if ((err = hopper::make_map(&km, a.k, B, a.Kh, a.W, HD, a.ksb, a.ksh,
                              a.ksw, TILE)) ||
      (err = hopper::make_map(&vm, a.v, B, a.Kh, a.W, HD, a.vsb, a.vsh,
                              a.vsw, TILE)))
    return err;
  const size_t smem = Smem<HD>::total((ntiles + ns - 1) / ns);
  auto kernel = flash_decode_kernel_mma<HD>;
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    if ((err = hopper::grant_smem(kernel, (int)smem))) return err;
    granted = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ns, pairs);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ns;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((err = (int)cudaLaunchKernelEx(&cfg, kernel, km, vm, a))) return err;
  return (int)cudaGetLastError();
}

}  // namespace tc

template <typename T, int HD>
int launch_hd(Args a, int B, cudaStream_t stream) {
  // bf16 groups past smollm's 3 on the tensor cores, where TMA can read
  // the views (the layout decides; the CUDA-core kernel takes the rest)
  if constexpr (sizeof(T) == 2)
    if (a.g > 3 && tc::tma_ok(a, B)) return tc::launch<HD>(a, B, stream);
  if (a.g == 1) return launch_g<T, HD, 1>(a, B, stream);
  if (a.g <= 3) return launch_g<T, HD, 3>(a, B, stream);    // smollm: 3
  return launch_g<T, HD, MAX_G>(a, B, stream);
}

template <typename T>
int launch(Args a, int B, int H, int hd, cudaStream_t stream) {
  if (B <= 0 || a.Kh <= 0 || H % a.Kh != 0 || H / a.Kh > MAX_G || a.W <= 0)
    return (int)cudaErrorInvalidValue;
  a.g = H / a.Kh;
  // 16-byte copies need 16-byte aligned rows; the layout decides
  constexpr long long VE = 16 / sizeof(T);
  a.vec = a.ksw % VE == 0 && a.ksb % VE == 0 && a.ksh % VE == 0 &&
          a.vsw % VE == 0 && a.vsb % VE == 0 && a.vsh % VE == 0 &&
          reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(a.v) % 16 == 0;
  switch (hd) {
    case 16: return launch_hd<T, 16>(a, B, stream);
    case 32: return launch_hd<T, 32>(a, B, stream);
    case 64: return launch_hd<T, 64>(a, B, stream);
    case 112: return launch_hd<T, 112>(a, B, stream);   // zamba2-7b
    case 128: return launch_hd<T, 128>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

#define DECODE_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const void* q, const void* k, const void* v,            \
                      const int* valid, void* out, int B, int H, int Kh,      \
                      int W, int hd, long long qsb, long long qsh,            \
                      long long ksb, long long ksh, long long ksw,             \
                      long long vsb, long long vsh, long long vsw,            \
                      long long valsb, long long osb, long long osh,          \
                      float sm_scale, void* stream) {                         \
    Args a{q, k, v, valid, out, Kh, W, 0, 0, 0, qsb, qsh, ksb, ksh, ksw,     \
           vsb, vsh, vsw, valsb, osb, osh, sm_scale};                         \
    return launch<T>(a, B, H, hd, (cudaStream_t)stream);                      \
  }

DECODE_ENTRY(flash_decode_f32, float)
DECODE_ENTRY(flash_decode_bf16, __nv_bfloat16)
