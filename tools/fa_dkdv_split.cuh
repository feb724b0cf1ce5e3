// The dK / dV pass at HDP 128 split by columns, a losing route of the
// backward's A/B: both consumer warpgroups take every (head, q tile)
// pair; warpgroup 0 computes S^T -> P^T, warpgroup 1 dP^T -> dS^T from
// warpgroup 0's f32 P^T, and the two hand P^T and dS^T over as bf16
// tiles in shared memory, the A operand of the second products;
// warpgroup w then accumulates dV and dK for head-dim panel w only (64
// columns: 64 accumulator registers, not 128), so no setmaxnreg and no
// final reduction. The exchange tiles are double-buffered by pair.
//
// Not compiled on its own: tools/attn_variants.py (variant "cols")
// splices this text into src/repro_torch/csrc/flash_attention_bwd.cu
// before launch_wgmma, whose helpers (load_rows, tile_nt, produce_pairs,
// visible) it uses, and launches fa_dkdv_split there in place of
// fa_dkdv_wide.

struct Split {
  static constexpr int TILE = 64 * 128 * 2;          // 64 rows at HDP 128
  static constexpr int STAGES = 3;
  static constexpr int RING = STAGES * 2 * TILE;     // (Q, dO) stages
  static constexpr int XB = hopper::TILE64;          // a 64 x 64 bf16 tile
  static constexpr int XBUF = 2 * XB + 64 * 64 * 4;  // P^T, dS^T; P^T in f32
  static constexpr int TILES = 2 * TILE + RING + 2 * XBUF;
  static constexpr int ROWS = STAGES * 128 * 4;      // LSE and D a stage
  static constexpr int SMEM = TILES + ROWS + 128 + 1024;
  static constexpr int THREADS = 288;
};

// a warpgroup's 64 x 64 accumulator as a bf16 tile in the 128-byte
// swizzle (rows the accumulator's rows), for wgmma's shared-memory A
__device__ __forceinline__ void store_tile64(uint8_t* tile,
                                             const float (&d)[32], int warp,
                                             int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(tile + hopper::swz(16 * warp + g + 8 * r,
                                                      8 * i + 2 * t)) =
          hopper::pack_bf16(d[4 * i + 2 * r], d[4 * i + 2 * r + 1]);
}

template <int HD>
__global__ void __launch_bounds__(288, 1)
fa_dkdv_split(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ CUtensorMap dmap,
              const float* __restrict__ lse, const float* __restrict__ D,
              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
              Args a) {
  using C = Split;
  constexpr int ST = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = hopper::align1024(smem_raw);
  uint8_t* Ks = sm;
  uint8_t* Vs = sm + C::TILE;
  uint8_t* ring = sm + 2 * C::TILE;        // stage s: Q, then dO
  uint8_t* xch = ring + C::RING;           // buffer x: P^T, dS^T, P^T f32
  float* rows = reinterpret_cast<float*>(sm + C::TILES);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + C::TILES + C::ROWS);
  uint64_t* kvbar = bar;
  uint64_t* full = bar + 1;                // [ST]
  uint64_t* empty = bar + 1 + ST;          // [ST]

  const int per_tile = (int)gridDim.x / ((a.Sk + 63) / 64);   // Kh * B
  const int k0 = (int)blockIdx.x / per_tile * 64;
  const int kh = (int)blockIdx.x % per_tile % a.Kh;
  const int b = (int)blockIdx.x % per_tile / a.Kh;
  const int g = a.H / a.Kh;
  const int kmax = min(k0 + 64, a.Sk) - 1;
  int qt_begin = 0, qt_end = (a.Sq + 63) / 64;
  if (a.causal) qt_begin = k0 / 64;
  if (a.window > 0) qt_end = min(qt_end, (kmax + a.window - 1) / 64 + 1);
  const int nq = max(0, qt_end - qt_begin);
  const int npairs = g * nq;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    hopper::mbar_init(kvbar, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1 + 32);  // TMA + the producer's lanes
      hopper::mbar_init(&empty[s], 8);     // both warpgroups' warps
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {                         // producer
    if (lane == 0) {
      hopper::mbar_expect_tx(kvbar, 2 * C::TILE);
      load_rows<2>(Ks, &kmap, kh, k0, b, kvbar);
      load_rows<2>(Vs, &vmap, kh, k0, b, kvbar);
    }
    produce_pairs<2, ST>(ring, C::TILE, rows, full, empty, &qmap, &dmap,
                         lse, D, a, b, kh, qt_begin, nq, lane);
    return;
  }

  // warpgroup wg: rows kr and kr + 8 (key rows) of its accumulators,
  // columns 8i + 2t (+1): q rows in S^T / dP^T, head dims 64 wg + ... in
  // dK and dV
  const int wg = warp / 4;
  const int t = lane % 4;
  const int tid = threadIdx.x % 128;
  const int kr = k0 + (warp % 4) * 16 + lane / 4;
  const float sl2 = a.sm_scale * LOG2E;
  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  hopper::mbar_wait(kvbar, 0);
  for (int n = 0; n < npairs; ++n) {
    const int s = n % ST;
    const int q0 = (qt_begin + n % nq) * 64;
    const uint8_t* qd = ring + s * 2 * C::TILE;
    const uint8_t* dod = qd + C::TILE;
    uint8_t* Pt = xch + (n & 1) * C::XBUF;
    uint8_t* dSt = Pt + C::XB;
    float* Pf = reinterpret_cast<float*>(Pt + 2 * C::XB);
    hopper::mbar_wait(&full[s], (n / ST) & 1);

    float acc[32];
    hopper::wgmma_fence();
    tile_nt<128>(acc, wg == 0 ? Ks : Vs, wg == 0 ? qd : dod);  // S^T, dP^T
    hopper::wgmma_commit();
    const float* lc = rows + s * 128;      // by column (q row)
    const float* dc = lc + 64;
    hopper::wgmma_wait();
    hopper::fence_regs(acc);
    if (wg == 0) {
      const bool edge = q0 + 64 > a.Sq || k0 + 64 > a.Sk ||
                        (a.causal && k0 + 63 > q0) ||
                        (a.window > 0 && q0 + 63 - k0 >= a.window);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 8 * i + 2 * t + (j & 1);
          float p = exp2f(acc[4 * i + j] * sl2 - lc[c]);
          if (edge && !visible(q0 + c, kr + (j >> 1) * 8, a)) p = 0.f;
          acc[4 * i + j] = p;
          Pf[(4 * i + j) * 128 + tid] = p;
        }
      store_tile64(Pt, acc, warp % 4, lane);
      hopper::fence_proxy_async();
      hopper::bar_arrive(2, 256);          // P^T ready for warpgroup 1
    } else {
      hopper::bar_sync(2, 256);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 8 * i + 2 * t + (j & 1);
          acc[4 * i + j] = Pf[(4 * i + j) * 128 + tid] *
                           (acc[4 * i + j] - dc[c]);
        }
      store_tile64(dSt, acc, warp % 4, lane);
      hopper::fence_proxy_async();
    }
    hopper::bar_sync(3, 256);              // both bf16 tiles written
    hopper::wgmma_fence();
    hopper::mma64_kn(dv_acc, Pt, dod + wg * hopper::TILE64, true);
    hopper::mma64_kn(dk_acc, dSt, qd + wg * hopper::TILE64, true);
    hopper::wgmma_commit();
    hopper::wgmma_wait();
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = kr + 8 * r;
    if (kpos >= a.Sk) continue;
    __nv_bfloat16* dkr = dk + b * a.dks.b + kh * a.dks.h +
                         (long long)kpos * a.dks.s + 64 * wg;
    __nv_bfloat16* dvr = dv + b * a.dvs.b + kh * a.dvs.h +
                         (long long)kpos * a.dvs.s + 64 * wg;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (64 * wg + 8 * i >= HD) continue;
      *reinterpret_cast<__nv_bfloat162*>(dkr + 8 * i + 2 * t) =
          __floats2bfloat162_rn(dk_acc[4 * i + 2 * r] * a.sm_scale,
                                dk_acc[4 * i + 2 * r + 1] * a.sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(dvr + 8 * i + 2 * t) =
          __floats2bfloat162_rn(dv_acc[4 * i + 2 * r],
                                dv_acc[4 * i + 2 * r + 1]);
    }
  }
}
