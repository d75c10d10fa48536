// Seed expansion of seed-compressed 2-party shares for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel `_get_batched_draw`
// (curl_tpu/ops/pallas_rng.py:43, its pallas_call at :83) where it generates
// party 1's share of every seed-compressed parameter
// (curl_tpu/mpc/primitives/compressed.py:38-52): a seed-compressed sharing of
// an encoding w is (share0 = w - r, r) with r = stream(key), and only share0
// is resident; r is regenerated at every use. The TPU kernel draws r from the
// chip's hardware PRNG, reseeded per 512-row tile from the tensor's seed words
// (pallas_rng.py:57-76). Here stream(key) is element i of kernels/philox.py's
// Philox4x32-10 stream of the tensor's 64-bit key at counter 0: one Philox
// call at counter (j_lo, j_hi, 0, 0) gives elements 2j and 2j + 1, so every
// value is a pure function of (key, i), whatever the launch geometry. The
// counter is fixed at 0 because the per-tensor key is the whole stream
// identity, as with the JAX package's `rbg` expansion (compressed.py:47-51).
//
// Modes, each one pass over the n elements (in and out int64, contiguous):
//   0 compress   out[i] = in[i] - stream(key)[i]          (encrypt: share0)
//   1 expand     out[0][i] = in[i], out[1][i] = stream(key)[i]
//                                  (the (2, n) share of both parties)
//   2 expand1    out[i] = in[i] + stream(key)[i]          (one party: the encoding)
// Nothing but the output reaches memory.
//
// What bounds it: bytes. compress reads 8n and writes 8n bytes, expand reads
// 8n and writes 16n; a Philox call is about a hundred 32-bit integer
// operations for two elements, under the time the card takes to move the
// elements' 24 bytes (expand) at its memory rate. One thread per element
// pair, a grid-stride loop, no shared memory.

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

}  // namespace

template <int MODE>
__global__ void __launch_bounds__(kThreads)
seed_expand_kernel(unsigned long long* __restrict__ out,
                   const unsigned long long* __restrict__ in, long long n,
                   unsigned long long key) {
  const long long pairs = (n + 1) >> 1;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const uint2 k = make_uint2(static_cast<unsigned>(key), static_cast<unsigned>(key >> 32));
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; j < pairs;
       j += stride) {
    const uint4 o = philox4x32_10(
        make_uint4(static_cast<unsigned>(j), static_cast<unsigned>(j >> 32), 0u, 0u), k);
    const unsigned long long r0 = o.x | (static_cast<unsigned long long>(o.y) << 32);
    const unsigned long long r1 = o.z | (static_cast<unsigned long long>(o.w) << 32);
    const long long i0 = 2 * j;
    const bool has1 = i0 + 1 < n;
    const unsigned long long a0 = in[i0];
    const unsigned long long a1 = has1 ? in[i0 + 1] : 0ull;
    if (MODE == 1) {
      out[i0] = a0;
      out[n + i0] = r0;
      if (has1) {
        out[i0 + 1] = a1;
        out[n + i0 + 1] = r1;
      }
    } else {
      out[i0] = MODE == 0 ? a0 - r0 : a0 + r0;
      if (has1) out[i0 + 1] = MODE == 0 ? a1 - r1 : a1 + r1;
    }
  }
}

// out: n int64 (modes 0 and 2) or (2, n) int64 (mode 1); in: n int64.
// Returns cudaGetLastError().
extern "C" int seed_expand_launch(long long* out, const long long* in, long long n,
                                  unsigned long long key, int mode, void* stream) {
  if (n < 0 || mode < 0 || mode > 2) return cudaErrorInvalidValue;
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const long long pairs = (n + 1) >> 1;
  long long blocks = (pairs + kThreads - 1) / kThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* o = reinterpret_cast<unsigned long long*>(out);
  auto* a = reinterpret_cast<const unsigned long long*>(in);
  switch (mode) {
    case 0: seed_expand_kernel<0><<<blocks, kThreads, 0, st>>>(o, a, n, key); break;
    case 1: seed_expand_kernel<1><<<blocks, kThreads, 0, st>>>(o, a, n, key); break;
    default: seed_expand_kernel<2><<<blocks, kThreads, 0, st>>>(o, a, n, key); break;
  }
  return static_cast<int>(cudaGetLastError());
}
