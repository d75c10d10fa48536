// Philox4x32-10 as a device function, shared by the kernels of this
// directory that draw randomness in-kernel (philox.cu, fused_mul.cu,
// max_step.cu). The constants are those of PyTorch's PhiloxRNGEngine.h: one
// round multiplies two counter words, then the key is bumped; ten rounds.
//
// philox_elem(key, ctr_hi, i) is element i of the 64-bit stream of
// kernels/philox.py's `stream(key, counter, n)`, where ctr_hi is the 64-bit
// counter: the Philox counter is (j_lo, j_hi, counter_lo, counter_hi) with
// j = i / 2, and elements 2j and 2j + 1 are its words (x | y << 32) and
// (z | w << 32). Every value is a pure function of (key, counter, i).

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

__device__ __forceinline__ unsigned long long philox_elem(unsigned long long key,
                                                          unsigned long long counter,
                                                          unsigned long long i) {
  const unsigned long long j = i >> 1;
  const uint4 o = philox4x32_10(
      make_uint4(static_cast<unsigned>(j), static_cast<unsigned>(j >> 32),
                 static_cast<unsigned>(counter), static_cast<unsigned>(counter >> 32)),
      make_uint2(static_cast<unsigned>(key), static_cast<unsigned>(key >> 32)));
  return (i & 1) ? (o.z | (static_cast<unsigned long long>(o.w) << 32))
                 : (o.x | (static_cast<unsigned long long>(o.y) << 32));
}

// Draw `slot` of a fused protocol kernel's call with draw count `count`
// (count < 2^48) at index i: kernels/philox.py's slot_counter layout.
__device__ __forceinline__ unsigned long long philox_slot(unsigned long long key,
                                                          unsigned long long count, int slot,
                                                          unsigned long long i) {
  return philox_elem(key, count | (static_cast<unsigned long long>(slot) << 48), i);
}
