// bucket_combine: one schedule round's local reduce over the bucketed
// f32 gradient buffer, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bucket_combine.py
// (bucket_combine / _combine_kernel). Per element, with g the round's
// gate of the element's rank ("this rank receives this round"):
//   add:  out = acc + (g ? y : 0)      (the reference's acc + where(g, y, 0))
//   copy: out = g ? y : acc
// The same arithmetic in the same order as the plain version, so the
// kernel is bitwise equal to it.
//
// The TPU kernel runs once per rank inside shard_map with the gate a
// scalar in SMEM. Here the team is the leading dim of one tensor on one
// card (the port's RankStack), so one launch covers every rank of the
// round: acc, y and out are (n, rows, bucket_elems) with rows x
// bucket_elems contiguous per rank and any rank stride (a readiness
// group's slice of the whole buffer is a strided view), and the gate is
// an (n,) int32 vector ON THE DEVICE: no host sync per round, and a
// whole sync can later be captured in one CUDA graph.
//
// Bound on the card: an elementwise pass, bytes bound: 3 x 4 bytes per
// element (acc and y read, out written) at 3.35 TB/s. Design: a grid of
// (blocks, n ranks); each block walks its rank's elements grid-stride
// with 16-byte (float4) loads and stores where every base and stride is
// 16-byte aligned (bucket rows are multiples of 128 elements, so the
// buffers the engine passes always are), and scalar ones otherwise.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <bool ADD>
__global__ void __launch_bounds__(THREADS)
combine_vec4(const float4* __restrict__ acc, const float4* __restrict__ y,
             const int* __restrict__ gate, float4* __restrict__ out,
             long long n4, long long acc_rs, long long y_rs,
             long long out_rs) {
  const int r = blockIdx.y;
  const bool g = gate[r] != 0;
  const float4* a = acc + r * acc_rs;
  const float4* b = y + r * y_rs;
  float4* o = out + r * out_rs;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n4;
       i += (long long)gridDim.x * THREADS) {
    const float4 av = a[i];
    const float4 bv = b[i];
    float4 ov;
    if (ADD) {
      ov.x = av.x + (g ? bv.x : 0.f);
      ov.y = av.y + (g ? bv.y : 0.f);
      ov.z = av.z + (g ? bv.z : 0.f);
      ov.w = av.w + (g ? bv.w : 0.f);
    } else {
      ov = g ? bv : av;
    }
    o[i] = ov;
  }
}

template <bool ADD>
__global__ void __launch_bounds__(THREADS)
combine_scalar(const float* __restrict__ acc, const float* __restrict__ y,
               const int* __restrict__ gate, float* __restrict__ out,
               long long n1, long long acc_rs, long long y_rs,
               long long out_rs) {
  const int r = blockIdx.y;
  const bool g = gate[r] != 0;
  const float* a = acc + r * acc_rs;
  const float* b = y + r * y_rs;
  float* o = out + r * out_rs;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n1;
       i += (long long)gridDim.x * THREADS) {
    o[i] = ADD ? a[i] + (g ? b[i] : 0.f) : (g ? b[i] : a[i]);
  }
}

bool aligned16(const void* p) { return ((unsigned long long)p & 15) == 0; }

template <bool ADD>
int launch(const float* acc, const float* y, const int* gate, float* out,
           int n, long long per_rank, long long acc_rs, long long y_rs,
           long long out_rs, cudaStream_t stream) {
  const bool vec = per_rank % 4 == 0 && acc_rs % 4 == 0 && y_rs % 4 == 0 &&
                   out_rs % 4 == 0 && aligned16(acc) && aligned16(y) &&
                   aligned16(out);
  const long long units = vec ? per_rank / 4 : per_rank;
  long long blocks = (units + THREADS - 1) / THREADS;
  const long long cap = 2048 / n + 1;     // enough blocks to fill 132 SMs
  if (blocks > cap) blocks = cap;
  dim3 grid((unsigned)blocks, (unsigned)n);
  if (vec)
    combine_vec4<ADD><<<grid, THREADS, 0, stream>>>(
        (const float4*)acc, (const float4*)y, gate, (float4*)out, units,
        acc_rs / 4, y_rs / 4, out_rs / 4);
  else
    combine_scalar<ADD><<<grid, THREADS, 0, stream>>>(
        acc, y, gate, out, units, acc_rs, y_rs, out_rs);
  return (int)cudaGetLastError();
}

}  // namespace

// acc, y, out: n ranks of per_rank contiguous f32 elements each, rank r
// at base + r * *_rs (element strides); gate: (n,) int32 on the device;
// add: 1 for op "add", 0 for "copy"
extern "C" int bucket_combine_f32(const float* acc, const float* y,
                                  const int* gate, float* out, int n,
                                  long long per_rank, long long acc_rs,
                                  long long y_rs, long long out_rs, int add,
                                  void* stream) {
  if (n <= 0 || n > 65535 || per_rank <= 0) return (int)cudaErrorInvalidValue;
  return add ? launch<true>(acc, y, gate, out, n, per_rank, acc_rs, y_rs,
                            out_rs, (cudaStream_t)stream)
             : launch<false>(acc, y, gate, out, n, per_rank, acc_rs, y_rs,
                             out_rs, (cudaStream_t)stream);
}
