// Philox4x32-10 as a device function, shared by the kernels of this
// directory that draw randomness in-kernel (philox.cu, fused_mul.cu,
// max_step.cu). The constants are those of PyTorch's PhiloxRNGEngine.h: one
// round multiplies two counter words, then the key is bumped; ten rounds.
//
// Element i of the 64-bit stream of kernels/philox.py's `stream(key,
// counter, n)` comes from the Philox call at counter (j_lo, j_hi,
// counter_lo, counter_hi) with j = i / 2: elements 2j and 2j + 1 are its
// words (x | y << 32) and (z | w << 32). Every value is a pure function of
// (key, counter, i).

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned lo0 = 0xD2511F53u * c.x;
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo1 = 0xCD9E8D57u * c.z;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The Philox call that holds elements 2j and 2j + 1 of draw `slot` of a
// fused protocol kernel's call with draw count `count` (count < 2^48; the
// slot sits in the counter's top 16 bits: kernels/philox.py's
// slot_counter), and the word of element 2j + odd. The fused kernels make
// one call for a pair of elements and keep both words.
__device__ __forceinline__ uint4 philox_slot_pair(unsigned long long key, unsigned long long count,
                                                 int slot, unsigned long long j) {
  const unsigned long long ctr = count | (static_cast<unsigned long long>(slot) << 48);
  return philox4x32_10(
      make_uint4(static_cast<unsigned>(j), static_cast<unsigned>(j >> 32),
                 static_cast<unsigned>(ctr), static_cast<unsigned>(ctr >> 32)),
      make_uint2(static_cast<unsigned>(key), static_cast<unsigned>(key >> 32)));
}

__device__ __forceinline__ unsigned long long philox_word(uint4 o, bool odd) {
  return odd ? (o.z | (static_cast<unsigned long long>(o.w) << 32))
             : (o.x | (static_cast<unsigned long long>(o.y) << 32));
}
