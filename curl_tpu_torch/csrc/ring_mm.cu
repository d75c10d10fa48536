// Exact ring matmul mod 2^64 for Hopper (sm_90a): out[g] = sum_p A_p[g] @ B_p[g].
//
// Replaces the JAX package's two Pallas TPU kernels in
// curl_tpu/ops/pallas_ring_mm.py: `_kernel` (:149, one product, reached via
// ring.matmul) and `_acc_kernel` (:324, the multi-pair Beaver reconstruction
// sum, reached via ring.matmul_acc). The TPU has no 64-bit multiplier in
// its matrix unit, so it splits each operand into 8 balanced int8 limbs and
// runs 36 of the 64 limb-plane products on the MXU. Hopper has native
// 64-bit integer multiply-add that wraps mod 2^64, so this first design
// multiplies the int64 values directly: the result is exact for any K and
// needs no limb split (ring.MAX_EXACT_K concerns the plain limb path only).
//
// Design: 64x64 output tile per block of 256 threads, each thread a 4x4
// register micro-tile of unsigned 64-bit accumulators. A and B tiles of
// depth 16 are staged through shared memory; the block loops over K (and
// over the pairs, sharing one accumulator) itself, which replaces the TPU's
// sequential K grid axis: blocks on Hopper run in no order.
//
// Operands are addressed with explicit strides. The batch index g =
// g0 * b1 + g1 reaches an operand at ptr + g0 * s0 + g1 * s1, so a 2-D
// operand shared across the party and batch grid has s0 = s1 = 0 and is
// read from the same memory by every batch slice (the JAX wrapper's
// _operand_spec), never copied per slice.
//
// What bounds it: a 64-bit multiply-add is several 32-bit integer
// instructions on the CUDA cores, so at the path's shapes this kernel is
// bound by integer instruction issue, far above the memory bound. The
// planned redesign (ROADMAP) moves the contraction onto the int8 tensor
// cores with wgmma: balanced int8 limbs, the 36-plane triangle trim of the
// TPU kernel, TMA-fed shared-memory rings, int32 accumulators recombined by
// shifts of 8(i + j).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxPairs = 4;
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256

}  // namespace

struct Operand {
  const long long* ptr;
  long long s0;  // stride of the outer batch index (party axis)
  long long s1;  // stride of the flattened inner batch index
  long long sr;  // row stride
  long long sc;  // column stride
};

struct MMArgs {
  Operand a[kMaxPairs];
  Operand b[kMaxPairs];
  long long k[kMaxPairs];
  int n_pairs;
};

__global__ void __launch_bounds__(kThreads)
ring_mm_kernel(unsigned long long* __restrict__ out, int b1, int M, int N, MMArgs args) {
  __shared__ unsigned long long As[BK][BM + 1];
  __shared__ unsigned long long Bs[BK][BN];

  const int g = blockIdx.z;
  const int g0 = g / b1;
  const int g1 = g - g0 * b1;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);

  unsigned long long acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0ull;

  for (int p = 0; p < args.n_pairs; ++p) {
    const Operand A = args.a[p];
    const Operand B = args.b[p];
    const long long K = args.k[p];
    const long long* Ap = A.ptr + g0 * A.s0 + g1 * A.s1;
    const long long* Bp = B.ptr + g0 * B.s0 + g1 * B.s1;
    for (long long k0 = 0; k0 < K; k0 += BK) {
      for (int i = threadIdx.x; i < BM * BK; i += kThreads) {
        const int m = i / BK, k = i % BK;
        const long long gm = m0 + m, gk = k0 + k;
        As[k][m] = (gm < M && gk < K)
                       ? static_cast<unsigned long long>(Ap[gm * A.sr + gk * A.sc])
                       : 0ull;
      }
      for (int i = threadIdx.x; i < BK * BN; i += kThreads) {
        const int k = i / BN, n = i % BN;
        const long long gk = k0 + k, gn = n0 + n;
        Bs[k][n] = (gk < K && gn < N)
                       ? static_cast<unsigned long long>(Bp[gk * B.sr + gn * B.sc])
                       : 0ull;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        unsigned long long a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[k][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[k][tx + (BN / TN) * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + (BN / TN) * j;
      if (n < N) out[(static_cast<long long>(g) * M + m) * N + n] = acc[i][j];
    }
  }
}

// out: (b0 * b1, M, N) int64, contiguous. Returns cudaGetLastError().
extern "C" int ring_mm_launch(long long* out, int b0, int b1, int M, int N,
                              const MMArgs* args, void* stream) {
  if (args->n_pairs < 1 || args->n_pairs > kMaxPairs) return cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, b0 * b1);
  ring_mm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<unsigned long long*>(out), b1, M, N, *args);
  return static_cast<int>(cudaGetLastError());
}
