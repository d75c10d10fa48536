// Counter-based Philox4x32-10 streams and fused PRZS / dealer sharing for
// Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels in curl_tpu/ops/pallas_przs.py,
// `_build` (:60, flat) and `_build2d` (:218, 2-D tiled), and serves the
// function of `_get_batched_draw` in curl_tpu/ops/pallas_rng.py (:43): bulk
// random bits from per-stream seeds. The TPU kernels draw from the chip's
// hardware PRNG; here the generator is Philox4x32-10 with the constants of
// PyTorch's PhiloxRNGEngine.h, keyed by a stream's two 32-bit seed words.
// The 128-bit counter is (pair index j as two words, draw counter as two
// words), so every value is a pure function of (seed, draw, index),
// whatever the launch geometry. One Philox call yields the two 64-bit
// elements 2j and 2j + 1.
//
// Modes (out is (rows, n) int64, written once; nothing else reaches memory):
//   0 draw        out[s] = bits(key_s) >> shift      (rows = streams)
//   1 przs        out[p] = bits(ring_{p-1}) - bits(ring_p)   (rows = parties)
//   2 share       przs + [p == src] * plain[i]       (plain shared by parties)
//   3 share_lane  przs + [p == src] * plain[src, i]  (plain per party)
// Party p's "prev" stream is ring key p - 1 and its "next" stream ring key
// p, so the PRZS rows telescope to zero over the parties; each ring stream
// is generated once per element and used by both parties that hold it.
//
// The Philox rounds are csrc/philox.cuh's device function, which the fused
// protocol kernels share.
//
// What bounds it: the bytes written (8 per output element, at most 8 rows);
// the 10 Philox rounds per stream are a few dozen integer instructions per
// element, well under the write time at the card's memory rate.

#include "philox.cuh"

namespace {

constexpr int kMaxRows = 8;
constexpr int kThreads = 256;

}  // namespace

struct PhiloxKeys {
  unsigned long long k[kMaxRows];
};

template <int MODE>
__global__ void __launch_bounds__(kThreads)
philox_kernel(unsigned long long* __restrict__ out, long long n, int rows, PhiloxKeys keys,
              unsigned long long counter, const unsigned long long* __restrict__ plain,
              int src, int shift) {
  const long long pairs = (n + 1) >> 1;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; j < pairs;
       j += stride) {
    const uint4 ctr = make_uint4(static_cast<unsigned>(j), static_cast<unsigned>(j >> 32),
                                 static_cast<unsigned>(counter),
                                 static_cast<unsigned>(counter >> 32));
    unsigned long long r0[kMaxRows], r1[kMaxRows];
#pragma unroll
    for (int s = 0; s < kMaxRows; ++s) {
      if (s < rows) {
        const uint2 key = make_uint2(static_cast<unsigned>(keys.k[s]),
                                     static_cast<unsigned>(keys.k[s] >> 32));
        const uint4 o = philox4x32_10(ctr, key);
        r0[s] = o.x | (static_cast<unsigned long long>(o.y) << 32);
        r1[s] = o.z | (static_cast<unsigned long long>(o.w) << 32);
      }
    }
    const long long i0 = 2 * j;
    const bool has1 = i0 + 1 < n;
    unsigned long long prev0 = 0ull, prev1 = 0ull;  // ring stream p - 1
#pragma unroll
    for (int s = 0; s < kMaxRows; ++s) {
      if (s == rows - 1) {
        prev0 = r0[s];
        prev1 = r1[s];
      }
    }
#pragma unroll
    for (int p = 0; p < kMaxRows; ++p) {
      if (p < rows) {
        unsigned long long v0, v1;
        if (MODE == 0) {
          v0 = r0[p] >> shift;
          v1 = r1[p] >> shift;
        } else {
          v0 = prev0 - r0[p];
          v1 = prev1 - r1[p];
          prev0 = r0[p];
          prev1 = r1[p];
          if (MODE >= 2 && p == src) {
            const unsigned long long* pl = plain + (MODE == 3 ? static_cast<long long>(src) * n : 0);
            v0 += pl[i0];
            if (has1) v1 += pl[i0 + 1];
          }
        }
        unsigned long long* row = out + static_cast<long long>(p) * n;
        row[i0] = v0;
        if (has1) row[i0 + 1] = v1;
      }
    }
  }
}

// keys: host array of `rows` 64-bit seeds (low word = Philox key word 0).
// Returns cudaGetLastError().
extern "C" int philox_launch(long long* out, long long n, int rows, int mode,
                             const unsigned long long* keys, unsigned long long counter,
                             const long long* plain, int src, int kbits, void* stream) {
  if (rows < 1 || rows > kMaxRows || kbits < 1 || kbits > 64 || n < 0) return cudaErrorInvalidValue;
  if (n == 0) return static_cast<int>(cudaGetLastError());
  PhiloxKeys k = {};
  for (int s = 0; s < rows; ++s) k.k[s] = keys[s];
  const long long pairs = (n + 1) >> 1;
  long long blocks = (pairs + kThreads - 1) / kThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* o = reinterpret_cast<unsigned long long*>(out);
  auto* pl = reinterpret_cast<const unsigned long long*>(plain);
  const int shift = 64 - kbits;
  switch (mode) {
    case 0: philox_kernel<0><<<blocks, kThreads, 0, st>>>(o, n, rows, k, counter, pl, src, shift); break;
    case 1: philox_kernel<1><<<blocks, kThreads, 0, st>>>(o, n, rows, k, counter, pl, src, shift); break;
    case 2: philox_kernel<2><<<blocks, kThreads, 0, st>>>(o, n, rows, k, counter, pl, src, shift); break;
    case 3: philox_kernel<3><<<blocks, kThreads, 0, st>>>(o, n, rows, k, counter, pl, src, shift); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
