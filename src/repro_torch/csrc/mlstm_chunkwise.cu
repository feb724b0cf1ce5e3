// mlstm_chunkwise: the chunkwise xLSTM mLSTM, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mlstm_kernel.py:77
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
// buffer. Rows past S are zeros with logi = logf = 0: they add nothing
// and are never written, so any S works and no row past S is read. No
// atomics on data: repeated runs are bitwise equal.
//
// Bound on the card: bytes. At the xlstm-125m prefill shape (B=8, NH=4,
// S=2048, hd=384) the call reads q, k, v in bf16 (151 MB) and logi, logf
// (0.5 MB) and writes y in f32 (101 MB): 252.2 MB, 0.0753 ms at
// 3.35 TB/s. Its products at 64-row chunks (q k^T, W v, q C and the state
// update) are 4.5e10 flops, 0.046 ms at the bf16 tensor-core peak.
//
// bf16 inputs at hd 384 (the model's prefill): mlstm_tc_kernel, the
// products on the tensor cores (wgmma, bf16 operands, f32 accumulators).
// One block per (64 value columns, head, batch row): 6 x 4 x 8 = 192 at
// the prefill. What the design does about what held the first version
// (mlstm_kernel below) back:
//  1. Products on the tensor cores, precision first. q, k and v arrive in
//     bf16 and are exact operands, so q k^T is one wgmma chain. Each other
//     product has one f32 operand: W in W v, C in q C, dec o v in the
//     state update, n in q n. Each goes in as two bf16 operands, hi =
//     bf16(x) and lo = bf16(x - hi), and its product runs twice. A CPU
//     emulation of these rounding points (tests/test_torch_xlstm.py) puts
//     y 1e-4 off the f32 version at S = 2048, within the 2e-4 of max(1,
//     max|y|) the card holds it to (4.3e-3 there); dropping any one of the
//     W, C and dec o v lo products puts it 8-12x past that limit, so all
//     stay (q n's costs next to nothing: n is two rows of an 8-row tile).
//  2. The chain through C apart from the rest. 384 threads, three
//     warpgroups with their own loops. Warpgroups 1 and 2 carry C^T for
//     this block's 64 value columns, key dims 0-191 and 192-383, as f32
//     wgmma accumulators (96 registers a thread) for the whole sequence.
//     Per chunk each computes its half of (q C)^T = C^T q^T with C^T as
//     the register-A operand (hi and lo split in registers, two k16 steps
//     a batch; the accumulator's column pairs are the A fragments) and q
//     the K-major B operand, hands it to warpgroup 0 through shared
//     memory, then updates C^T = exp(lf_end) C^T + (dec o v)^T k (A from
//     the v tile by ldmatrix.trans, scaled and split in registers; k the
//     MN-major B operand, all 192 key dims in one m64n192k16 a step), and
//     then n for the same key dims on the CUDA cores, written as the hi
//     and lo rows of the next chunk's n tile. No copy of C goes to shared
//     memory. Each one's lead warp takes the chunk's prefix sum of logf
//     itself (dec, exp(lf_end)); warpgroup 1's also writes warpgroup 0's
//     vectors: m as a prefix max of logi - lf (a warp's shuffles, no
//     thread looping over a row), lf - m, logi - lf, exp(lf - m),
//     exp(-m). Warpgroup 0 does what does not depend on C: q k^T and q n
//     (one commit group), W formed in the accumulator registers (8-column
//     blocks above its warp's rows skipped) and repacked as the hi/lo A
//     fragments of W v, den (quad shuffles), and at the start of the next
//     chunk's step y = (W v + exp(lf - m) (q C)) / den, stored after the
//     handed buffer goes back. The n update and the vectors sit in the C
//     warpgroups because warpgroup 0's chain is the longer one
//     (tools/mlstm_variants.py's diagnostics; PERF.md).
//  3. Tiles fed by TMA. The 64 x 384 q and k tiles (six 128-byte-swizzled
//     panels) and the 64 x 64 v tile land by TMA on mbarriers: k and v in
//     two slots (the next chunk's while this one computes), q in one
//     (the next chunk's lands while the C warpgroups run the update; it
//     has to, at 48 KB a slot). The third warpgroup to finish with a slot
//     refills it (a counter in shared memory), so no thread waits to
//     issue a load. The gates (strided f32) come by 4-byte cp.async a
//     chunk ahead. mbarriers hand the partials, the n tiles and the
//     vectors between the warpgroups (two of each tile and vector
//     buffer, one read while the next is written).
//  4. Waves and registers. Registers bound residency: C's tile is 96 KB
//     of registers a block, and the 384 threads take the whole register
//     file (168 each at launch; setmaxnreg then gives warpgroup 0 120 and
//     the C warpgroups 192, without which ptxas serializes every wgmma
//     for want of registers: the variant regs_168). So one block
//     an SM, and the 192 blocks run in two waves (1.45 waves of work).
//     Two blocks an SM would need 192 KB of the 256 KB register file for
//     C alone; a grid of at most 132 blocks needs a block to carry more
//     than one SM's registers of C, or C split across a cluster with its
//     q C reduced through distributed shared memory (ROADMAP). Shared
//     memory: q 48 KB, two slots of k and v 112 KB, the n tiles 12 KB,
//     the handed partials 34 KB, n, its partial sums and the vectors:
//     221,848 bytes. ptxas: 168 registers, no spill
//     (chiprun_out/ptxas.txt, PERF.md).
// TMA needs a 16-byte-aligned base and every outer stride a multiple of
// 16 bytes; the wrapper checks both and raises otherwise.
//
// f32 inputs (the reference phases and the f32 card checks at 2e-4),
// and bf16 at hd 32 and 64 (no main path): mlstm_kernel, the CUDA-core
// kernel of the first port, unchanged. One block per (tile of 64 value
// columns, head, batch row) loops over the chunks with its C[:, tile]
// (hd x 64 f32) and its own copy of n resident in shared memory, and
// recomputes the chunk's q k^T, m, W and den, which the tiles of one
// head share. Per chunk, 256 threads: stage the gates and the v tile as
// f32; one warp takes the prefix sum of logf; a thread per row takes m,
// exp(lf - m) and the decay to the chunk's end; then per 64-key slice
// q k^T and q C (each thread 4 rows x 4 columns) and q n, and the
// slice's state update; then W, den and y. The dispatch is by input
// dtype and head dim only.
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

// ------------------------------------------------------ tensor cores
namespace tc {

using bf16 = __nv_bfloat16;
using hopper::desc;

constexpr int HD = 384;                    // the one head dim this route takes
constexpr int PANELS = HD / 64;            // 64-column panels of q and k
constexpr int HALF = PANELS / 2;           // panels of C^T a C warpgroup holds
constexpr int TILE = CH * 128;             // 64 rows of 64 bf16, swizzled
constexpr int QK_BYTES = PANELS * TILE;    // a q or k tile: 48 KB
constexpr int KV_BYTES = QK_BYTES + TILE;  // a k/v slot: k's panels, then v's
constexpr int PST = 68;                    // padded rows of a handed partial
constexpr int KB = 2;                      // k16 steps a batch of q C
constexpr int THREADS = 384;               // three warpgroups
// registers a thread of warpgroup 0 and of the C warpgroups keep after
// setmaxnreg (168 each at launch: 384 threads share the register file)
constexpr int REGS_REST = 120;
constexpr int REGS_CHAIN = 192;
// shared memory, from a 1024-byte boundary: q, two k/v slots, two tiles
// of n (rows 0 and 1 its hi and lo, 2-7 zero: the B operand of q n, one
// read while the next is written), the two handed partials (q C)^T, n in
// f32, the n update's quarter sums, warpgroup 0's vectors of two chunks
// (lf - m, logi - lf, exp(lf - m), exp(-m)), the C warpgroups' (dec,
// exp(lf_end)), the gate rings of their lead warps, mbarriers, slot
// counters
constexpr int N_BYTES = PANELS * 1024;    // n's hi/lo rows as a K-major B
constexpr int OFF_KV = QK_BYTES;
constexpr int OFF_NT = OFF_KV + 2 * KV_BYTES;
constexpr int OFF_P = OFF_NT + 2 * N_BYTES;
constexpr int OFF_N = OFF_P + 2 * CH * PST * 4;
constexpr int OFF_NSCR = OFF_N + HD * 4;
constexpr int V0ST = 4 * CH;              // floats of one chunk's vectors
constexpr int OFF_V0 = OFF_NSCR + 3 * HD * 4;
constexpr int OFF_VC = OFF_V0 + 2 * V0ST * 4;
constexpr int VCST = CH + 8;               // floats a C warpgroup's vectors
constexpr int OFF_GATES = OFF_VC + 2 * VCST * 4;   // [2 warps][2][2][CH]
constexpr int OFF_BAR = OFF_GATES + 2 * 4 * CH * 4;
constexpr int OFF_CNT = OFF_BAR + 9 * 8;
constexpr int SMEM = OFF_CNT + 16 + 1024;  // + alignment

using hopper::swz;

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_u32(p)));
}

// two f32 as two bf16 pairs, hi = bf16(v) and lo = bf16(v - hi): hi + lo
// keeps about 16 bits of v
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

// the two bf16 of a 32-bit word as f32 (low half first)
__device__ __forceinline__ float lo_f32(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f32(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

struct TcArgs {
  const float* li;
  const float* lf;
  void* y;
  int NH, S;
  long long isb, ish, iss, fsb, fsh, fss, ysb, ysh, yss;
};

template <typename TO>
__global__ void __launch_bounds__(THREADS, 1)
mlstm_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, TcArgs g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = sm;                                  // panel p at p * TILE
  uint8_t* KVs = sm + OFF_KV;                        // slot s: k, then v
  uint8_t* Nt = sm + OFF_NT;                         // [2] n's hi/lo tiles
  float* Ps = reinterpret_cast<float*>(sm + OFF_P);  // [2][CH][PST]
  float* ns = reinterpret_cast<float*>(sm + OFF_N);  // [HD] the carried n
  float* nscr = reinterpret_cast<float*>(sm + OFF_NSCR);
  float* v0 = reinterpret_cast<float*>(sm + OFF_V0);
  float* vcs = reinterpret_cast<float*>(sm + OFF_VC);
  // a C warpgroup's lead warp's gate ring: [chunk & 1][logi, logf][CH]
  float* ring = reinterpret_cast<float*>(sm + OFF_GATES) +
                ((threadIdx.x >> 7) & 1) * 4 * CH;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + OFF_BAR);
  uint64_t* full_q = bar;        // q of a chunk has landed
  uint64_t* full_kv = bar + 1;   // [2] k and v of a chunk have landed
  uint64_t* p_full = bar + 3;    // both halves of (q C)^T are handed
  uint64_t* p_empty = bar + 4;   // warpgroup 0 has read them
  uint64_t* n_full = bar + 5;    // [2] a tile of n is written (both halves)
  uint64_t* vec_full = bar + 7;  // [2] warpgroup 0's vectors are written
  int* cnt = reinterpret_cast<int*>(sm + OFF_CNT);   // q, kv[2] releases

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, t = tid & 127;       // warpgroup, its thread
  const int gq = lane >> 2, tq = lane & 3;
  const int i0 = 16 * (warp & 3);                // accumulator rows of a warp
  const int nchunk = (g.S + CH - 1) / CH;

  const float* ib = g.li + b * g.isb + h * g.ish;
  const float* fb = g.lf + b * g.fsb + h * g.fsh;

  auto load_q = [&](int c) {
    hopper::mbar_expect_tx(full_q, QK_BYTES);
    for (int p = 0; p < PANELS; ++p)
      hopper::tma_load(Qs + p * TILE, &qmap, 64 * p, h, c * CH, b, full_q);
  };
  auto load_kv = [&](int c) {
    const int s = c & 1;
    uint8_t* d = KVs + s * KV_BYTES;
    hopper::mbar_expect_tx(&full_kv[s], KV_BYTES);
    for (int p = 0; p < PANELS; ++p)
      hopper::tma_load(d + p * TILE, &kmap, 64 * p, h, c * CH, b, &full_kv[s]);
    hopper::tma_load(d + QK_BYTES, &vmap, 64 * tile, h, c * CH, b,
                     &full_kv[s]);
  };
  // one thread of a warpgroup whose every thread is done with a slot (a
  // named barrier just before: every read of it has returned; q: which =
  // 0, the k/v slot of chunk c: 1 + (c & 1)): the third of the three
  // warpgroups to do so loads the slot's next chunk. No memory fence
  // (it would wait on the thread's outstanding y stores): the barrier
  // orders the reads, the proxy fence the async writes after them
  auto release = [&](int which, int c) {
    if (atomicAdd(&cnt[which], 1) % 3 == 2) {
      hopper::fence_proxy_async();
      const int next = which == 0 ? c + 1 : c + 2;
      if (next < nchunk) {
        if (which == 0) load_q(next);
        else load_kv(next);
      }
    }
  };
  // a warp's gates of chunk c into ring slot c & 1 by cp.async, rows
  // 2 lane and 2 lane + 1 (zeros past S), one commit group a chunk
  auto gates_load = [&](int c) {
    float* d = ring + (c & 1) * 2 * CH;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = 2 * lane + u;
      const bool ok = c < nchunk && c * CH + r < g.S;
      const long long row = ok ? c * CH + r : 0;
      hopper::cp_async4(d + r, ib + row * g.iss, ok ? 4 : 0);
      hopper::cp_async4(d + CH + r, fb + row * g.fss, ok ? 4 : 0);
    }
    hopper::cp_async_commit();
  };
  // chunk c's gates, once in; the next chunk's sent out meanwhile
  auto gates = [&](int c, float (&gi)[2], float (&gf)[2]) {
    gates_load(c + 1);
    hopper::cp_async_wait<1>();
    __syncwarp();
    const float* d = ring + (c & 1) * 2 * CH;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      gi[u] = d[2 * lane + u];
      gf[u] = d[CH + 2 * lane + u];
    }
  };
  // the inclusive prefix sum lf of logf over a warp, two rows a lane
  auto prefix = [&](const float (&gf)[2], float& l0, float& l1) {
    float incl = gf[0] + gf[1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float s = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += s;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    l0 = excl + gf[0];
    l1 = l0 + gf[1];
  };

  if (tid == 0) {
    hopper::mbar_init(full_q, 1);
    hopper::mbar_init(&full_kv[0], 1);
    hopper::mbar_init(&full_kv[1], 1);
    hopper::mbar_init(p_full, 256);    // every thread of the C warpgroups
    hopper::mbar_init(p_empty, 1);
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&n_full[i], 2);    // one thread of each C warpgroup
      hopper::mbar_init(&vec_full[i], 32); // the lanes of warpgroup 1's lead
    }
    cnt[0] = cnt[1] = cnt[2] = 0;
    hopper::fence_barrier_init();
  }
  for (int e = tid; e < HD; e += THREADS) ns[e] = 0.f;
  for (int e = tid; e < 2 * N_BYTES / 16; e += THREADS)
    reinterpret_cast<uint4*>(Nt)[e] = make_uint4(0u, 0u, 0u, 0u);
  hopper::fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    load_q(0);
    load_kv(0);
    if (nchunk > 1) load_kv(1);
  }

  if (wg == 0) {
    // ------------------------------------------- warpgroup 0: the rest
    if constexpr (REGS_REST < 168) hopper::regs_dec<REGS_REST>();
    TO* yb = static_cast<TO*>(g.y) + b * g.ysb + h * g.ysh + tile * 64;
    // chunk c's y = (W v + exp(lf - m) (q C)) / den from its W v (in y),
    // exp(lf - m) and 1 / den of rows i0 + gq (+8), and the two halves of
    // (q C)^T as handed; the buffer goes back before the stores, so the
    // arrival's release waits on none of them
    auto combine = [&](int c, float (&y)[32], const float (&w)[2],
                       const float (&inv)[2]) {
      hopper::mbar_wait(p_full, c & 1);
      const float* P1 = Ps;
      const float* P2 = Ps + CH * PST;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + gq + 8 * r;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int a0 = 4 * k + 2 * r, col = 8 * k + 2 * tq;
          const float2 x1 =
              *reinterpret_cast<const float2*>(P1 + i * PST + col);
          const float2 x2 =
              *reinterpret_cast<const float2*>(P2 + i * PST + col);
          y[a0] += w[r] * (x1.x + x2.x);
          y[a0 + 1] += w[r] * (x1.y + x2.y);
        }
      }
      hopper::bar_sync(1, 128);       // the partials are read
      if (t == 0) hopper::mbar_arrive(p_empty);
      const int s0 = c * CH, nr = min(CH, g.S - s0);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + gq + 8 * r;
        if (i < nr) {
          TO* yr = yb + (s0 + i) * g.yss + 2 * tq;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int a0 = 4 * k + 2 * r;
            store2(yr + 8 * k, y[a0] * inv[r], y[a0 + 1] * inv[r]);
          }
        }
      }
    };
    // the last chunk's, combined at the start of this one's step
    float yprev[32], wprev[2], iprev[2];
    for (int c = 0; c < nchunk; ++c) {
      const int s = c & 1;
      if (c > 0) combine(c - 1, yprev, wprev, iprev);
      const float* va = v0 + s * V0ST;     // lf - m
      const float* vb = va + CH;           // logi - lf
      const float* vwl = va + 2 * CH;      // exp(lf - m)
      const float* venm = va + 3 * CH;     // exp(-m)
      hopper::mbar_wait(full_q, c & 1);
      hopper::mbar_wait(&full_kv[s], (c >> 1) & 1);
      const uint8_t* Kt = KVs + s * KV_BYTES;
      const uint8_t* Vt = Kt + QK_BYTES;
      // q k^T, then q n (n of the chunks before as the hi and lo rows of
      // an 8-row tile, once the C warpgroups have written it), all
      // K-major, one commit group
      float sacc[32], qacc[4];
      const uint8_t* nt = Nt + s * N_BYTES;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * PANELS; ++kk)
        hopper::wgmma_ss(
            sacc, desc(Qs + (kk >> 2) * TILE + (kk & 3) * 32, 16, 1024),
            desc(Kt + (kk >> 2) * TILE + (kk & 3) * 32, 16, 1024), kk > 0);
      // (chunk 0 waits for parity 1: the phase before the first, done)
      hopper::mbar_wait(&n_full[s], ((c - 1) >> 1) & 1);
#pragma unroll
      for (int kk = 0; kk < 4 * PANELS; ++kk)
        hopper::wgmma_ss(
            qacc, desc(Qs + (kk >> 2) * TILE + (kk & 3) * 32, 16, 1024),
            desc(nt + (kk >> 2) * 1024 + (kk & 3) * 32, 16, 1024), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sacc);
      hopper::fence_regs(qacc);
      hopper::bar_sync(1, 128);       // warpgroup 0 is done with q
      if (t == 0) release(0, c);
      hopper::mbar_wait(&vec_full[s], (c >> 1) & 1);   // the vectors
      // q n of rows i0 + gq (+8): columns 0 (hi) and 1 (lo) of the n8
      // accumulator, held by the quad's thread tq = 0
      float qn[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        qn[r] = __shfl_sync(0xffffffffu, qacc[2 * r] + qacc[2 * r + 1],
                            lane & ~3);
      // W = (q k^T) o exp(lf_i - m_i + logi_j - lf_j) for j <= i (else 0),
      // as the hi and lo A fragments of W v (column pair (2kk, 2kk + 1) of
      // the accumulator is the A fragment of k16 step kk); its row sums
      // (an 8-column block wholly above this warp's rows is 0: no exp)
      uint32_t wa[4][4], wo[4][4];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float w[2] = {0.f, 0.f};
          if (8 * (2 * kk + (q >> 1)) <= i0 + 15) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int idx = 8 * kk + 2 * q + e;  // accumulator element
              const int i = i0 + gq + 8 * ((idx >> 1) & 1);
              const int j = 8 * (idx >> 2) + 2 * tq + (idx & 1);
              w[e] = j <= i ? sacc[idx] * __expf(va[i] + vb[j]) : 0.f;
              rs[(idx >> 1) & 1] += w[e];
            }
          }
          split_bf16(w[0], w[1], wa[kk][q], wo[kk][q]);
        }
      float yacc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) yacc[i] = 0.f;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t vd = desc(Vt + kk * 16 * 128, TILE, 1024);
        hopper::wgmma_rs(yacc, wa[kk], vd);
        hopper::wgmma_rs(yacc, wo[kk], vd);
      }
      hopper::wgmma_commit();
      float den[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        const int i = i0 + gq + 8 * r;
        den[r] = fmaxf(fabsf(rs[r] + vwl[i] * qn[r]), venm[i]);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(yacc);
      hopper::bar_sync(1, 128);       // warpgroup 0 is done with k and v
      if (t == 0) release(1 + s, c);
#pragma unroll
      for (int i = 0; i < 32; ++i) yprev[i] = yacc[i];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        wprev[r] = vwl[i0 + gq + 8 * r];
        iprev[r] = 1.f / den[r];
      }
    }
    combine(nchunk - 1, yprev, wprev, iprev);
  } else {
    // ------------------------- warpgroups 1 and 2: the chain through C
    // C^T (value column i0 + gq (+8), key dim 192 half + 64 p + 8 i + 2 tq
    // (+1)) in f32 accumulators, the layout in hopper.cuh
    if constexpr (REGS_CHAIN > 168) hopper::regs_inc<REGS_CHAIN>();
    const int half = wg - 1;
    float* vd = vcs + half * VCST;       // dec[CH], exp(lf_end)
    float* Pw = Ps + half * CH * PST;    // (q C)^T over this half, [t][col]
    float st[32 * HALF];     // panel p of this half: st[32 p ..]
#pragma unroll
    for (int i = 0; i < 32 * HALF; ++i) st[i] = 0.f;
    const bool lead = (warp & 3) == 0;
    if (lead) gates_load(0);
    for (int c = 0; c < nchunk; ++c) {
      const int s = c & 1;
      if (lead) {
        float gi[2], gf[2], l0, l1;
        gates(c, gi, gf);
        prefix(gf, l0, l1);
        const float lend = __shfl_sync(0xffffffffu, l1, 31);
        vd[2 * lane] = expf(lend - l0 + gi[0]);
        vd[2 * lane + 1] = expf(lend - l1 + gi[1]);
        if (lane == 0) vd[CH] = expf(lend);
        if (half == 0) {
          // warpgroup 0's vectors of chunk c into buffer c & 1 of v0:
          // lf - m, logi - lf, exp(lf - m), exp(-m), where
          // m = max(max_{s<=t} (lf_t - lf_s + logi_s), lf_t)
          //   = max(lf_t + max_{s<=t} (logi_s - lf_s), lf_t)
          const float b0 = gi[0] - l0, b1 = gi[1] - l1;
          float mx = fmaxf(b0, b1);
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const float x = __shfl_up_sync(0xffffffffu, mx, o);
            if (lane >= o) mx = fmaxf(mx, x);
          }
          float ex = __shfl_up_sync(0xffffffffu, mx, 1);
          if (lane == 0) ex = -1e30f;
          const float m0 = fmaxf(l0 + fmaxf(ex, b0), l0);
          const float m1 = fmaxf(l1 + mx, l1);
          float* v = v0 + s * V0ST;
          const int r0 = 2 * lane, r1 = r0 + 1;
          v[r0] = l0 - m0;
          v[r1] = l1 - m1;
          v[CH + r0] = b0;
          v[CH + r1] = b1;
          v[2 * CH + r0] = expf(l0 - m0);
          v[2 * CH + r1] = expf(l1 - m1);
          v[3 * CH + r0] = expf(-m0);
          v[3 * CH + r1] = expf(-m1);
          hopper::mbar_arrive(&vec_full[s]);
        }
      }
      hopper::mbar_wait(full_q, c & 1);
      // (q C)^T over this half = C^T q^T: A = C^T from the accumulators,
      // split hi/lo, KB k16 steps a batch; B = q, K-major
      float yacc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) yacc[i] = 0.f;
#pragma unroll
      for (int p = 0; p < HALF; ++p) {
        const uint8_t* qp = Qs + (HALF * half + p) * TILE;
#pragma unroll
        for (int k0 = 0; k0 < 4; k0 += KB) {
          uint32_t fh[KB][4], fl[KB][4];
#pragma unroll
          for (int u = 0; u < KB; ++u)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              split_bf16(st[32 * p + 8 * (k0 + u) + 2 * q],
                         st[32 * p + 8 * (k0 + u) + 2 * q + 1], fh[u][q],
                         fl[u][q]);
          hopper::wgmma_fence();
#pragma unroll
          for (int u = 0; u < KB; ++u) {
            const uint64_t qd = desc(qp + (k0 + u) * 32, 16, 1024);
            hopper::wgmma_rs_kmajor(yacc, fh[u], qd);
            hopper::wgmma_rs_kmajor(yacc, fl[u], qd);
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
        }
      }
      hopper::fence_regs(yacc);
      hopper::bar_sync(2 + half, 128);   // this warpgroup is done with q
      if (t == 0) release(0, c);
      // hand it over once warpgroup 0 has read the last chunk's
      if (c > 0) hopper::mbar_wait(p_empty, (c - 1) & 1);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int col = i0 + gq + 8 * u, row = 8 * i + 2 * tq;
          Pw[row * PST + col] = yacc[4 * i + 2 * u];
          Pw[(row + 1) * PST + col] = yacc[4 * i + 2 * u + 1];
        }
      hopper::mbar_arrive(p_full);
      // C^T = exp(lf_end) C^T + (dec o v)^T k: A = v^T (ldmatrix.trans,
      // rows value columns, K the chunk's rows) with column j scaled by
      // dec_j, hi and lo; B = k, MN-major
      hopper::mbar_wait(&full_kv[s], (c >> 1) & 1);
      const uint8_t* Kt = KVs + s * KV_BYTES;
      const uint8_t* Vt = Kt + QK_BYTES;
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t xr[4];
        ldsm_x4_t(xr, Vt + swz(16 * kk + (lane & 7) + 8 * (lane >> 4),
                               i0 + 8 * ((lane >> 3) & 1)));
        const int j = 16 * kk + 2 * tq;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const __nv_bfloat162 xv =
              *reinterpret_cast<const __nv_bfloat162*>(&xr[r]);
          const int jr = j + (r < 2 ? 0 : 8);
          split_bf16(__low2float(xv) * vd[jr], __high2float(xv) * vd[jr + 1],
                     ah[kk][r], al[kk][r]);
        }
      }
      const float eend = vd[CH];
#pragma unroll
      for (int i = 0; i < 32 * HALF; ++i) st[i] *= eend;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // N = this half's 192 key dims: three panels, TILE apart
        const uint64_t kd =
            desc(Kt + HALF * half * TILE + kk * 16 * 128, TILE, 1024);
        hopper::wgmma_rs(st, ah[kk], kd);
        hopper::wgmma_rs(st, al[kk], kd);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(st);
      // n = exp(lf_end) n + sum_r dec_r k_r over this half's key dims, for
      // warpgroup 0's next q n: threads 0-95 each one 16-byte chunk of 8
      // key dims over 16 rows, the other quarters' sums handed through
      // nscr; then n in f32 and as rows 0 (hi) and 1 (lo) of its tile
      if (t < 96) {
        const int cg = t % 24, qr = t / 24;
        const int p = HALF * half + (cg >> 3), cc = cg & 7;
        const int kd = 64 * p + 8 * cc;
        float nacc[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) nacc[u] = 0.f;
#pragma unroll 4
        for (int r = 16 * qr; r < 16 * qr + 16; ++r) {
          const uint4 k4 = *reinterpret_cast<const uint4*>(
              Kt + p * TILE + r * 128 + ((cc ^ (r & 7)) << 4));
          const float d = vd[r];
          nacc[0] = fmaf(d, lo_f32(k4.x), nacc[0]);
          nacc[1] = fmaf(d, hi_f32(k4.x), nacc[1]);
          nacc[2] = fmaf(d, lo_f32(k4.y), nacc[2]);
          nacc[3] = fmaf(d, hi_f32(k4.y), nacc[3]);
          nacc[4] = fmaf(d, lo_f32(k4.z), nacc[4]);
          nacc[5] = fmaf(d, hi_f32(k4.z), nacc[5]);
          nacc[6] = fmaf(d, lo_f32(k4.w), nacc[6]);
          nacc[7] = fmaf(d, hi_f32(k4.w), nacc[7]);
        }
        if (qr > 0) {
#pragma unroll
          for (int u = 0; u < 8; ++u) nscr[(qr - 1) * HD + kd + u] = nacc[u];
        }
        hopper::bar_sync(4 + half, 96);  // the quarters' sums are in
        if (qr == 0) {
          float nn[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            nn[u] = eend * ns[kd + u] +
                    (((nacc[u] + nscr[kd + u]) + nscr[HD + kd + u]) +
                     nscr[2 * HD + kd + u]);
            ns[kd + u] = nn[u];
          }
          // 16-byte chunk cc of panel p, swizzled by row
          uint4 hi, lo;
          split_bf16(nn[0], nn[1], hi.x, lo.x);
          split_bf16(nn[2], nn[3], hi.y, lo.y);
          split_bf16(nn[4], nn[5], hi.z, lo.z);
          split_bf16(nn[6], nn[7], hi.w, lo.w);
          uint8_t* np = Nt + ((c + 1) & 1) * N_BYTES + p * 1024;
          *reinterpret_cast<uint4*>(np + (cc << 4)) = hi;
          *reinterpret_cast<uint4*>(np + 128 + ((cc ^ 1) << 4)) = lo;
          hopper::fence_proxy_async();   // for warpgroup 0's wgmma
        }
      }
      hopper::bar_sync(2 + half, 128);   // done with k, v, the vectors, n
      if (t == 0) {
        hopper::mbar_arrive(&n_full[(c + 1) & 1]);
        release(1 + s, c);
      }
    }
  }
}

template <typename TO>
int launch(const Args& a, int B, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int err;
  if ((err = hopper::make_map(&qm, a.q, B, a.NH, a.S, HD, a.qsb, a.qsh, a.qss,
                              CH)) ||
      (err = hopper::make_map(&km, a.k, B, a.NH, a.S, HD, a.ksb, a.ksh, a.kss,
                              CH)) ||
      (err = hopper::make_map(&vm, a.v, B, a.NH, a.S, HD, a.vsb, a.vsh, a.vss,
                              CH)))
    return err;
  static bool granted = false;
  if (!granted) {
    err = (int)cudaFuncSetAttribute(mlstm_tc_kernel<TO>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    SMEM);
    if (err) return err;
    granted = true;
  }
  const TcArgs g{a.li, a.lf, a.y, a.NH, a.S, a.isb, a.ish, a.iss,
                 a.fsb, a.fsh, a.fss, a.ysb, a.ysh, a.yss};
  mlstm_tc_kernel<TO><<<dim3(HD / 64, a.NH, B), THREADS, SMEM, stream>>>(
      qm, km, vm, g);
  return (int)cudaGetLastError();
}

}  // namespace tc

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
    case 384:
      if constexpr (sizeof(TI) == 2)
        return tc::launch<TO>(g, B, stream);   // bf16: the tensor cores
      else
        return launch_hd<TI, TO, 384>(g, B, stream);
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
