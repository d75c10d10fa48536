// Counter-based Philox4x32-10 streams and the TFP dealer's sharing, grouped:
// one launch writes every draw and share of one dealer call, for Hopper
// (sm_90a).
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
// Segments. A launch carries up to kMaxSegments segments, each with its own
// output (rows, n) int64, n, keys, counters and bits. A segment is
//   draw        out[s] = stream(key_s, c) >> (64 - kbits)     (rows = streams)
// or a sharing over the parties (rows = parties; keys are the ring seeds,
// party p's "prev" stream ring key p - 1 and its "next" ring key p) of
//   zero        v = 0                                         (PRZS)
//   plain       v = plain[i]          (party-invariant plaintext)
//   plain_lane  v = plain[src, i]     (a plaintext per party)
//   fresh       v = stream(dealer, c_draw) >> (64 - draw_kbits), drawn in
//               the thread that shares it; with `emit` also written to its
//               own (n,) output (the dealer's plaintext for c = op(a, b), r^2)
//   ttp_plain   as plain, and ttp_fresh as fresh, but shared by the trusted
//               third party (below)
// shared either additively,
//   out[p] = stream(ring_{p-1}, c) - stream(ring_p, c) + [p == src] v,
// or by XOR,
//   out[p] = (stream(ring_{p-1}, c) ^ stream(ring_p, c)) >> (64 - kbits)
//            ^ [p == src] v.
// The PRZS rows telescope to zero over the parties. A TTP segment's keys are
// the parties' own `ttp` seeds instead: parties p >= 1 take their stream,
// party 0 the rest,
//   out[p] = stream(ttp_p, c)   (p >= 1),
//   out[0] = v - sum_{p>=1} out[p]   (or v ^ XOR_{p>=1} out[p]),
// the reference's TTP dealer (curl_tpu/mpc/provider/ttp_provider.py:41-66),
// made in one thread an element pair, with party 0's row accumulated in
// registers while the others are written. With two parties each
// ring stream is generated once per element and serves both parties that
// hold it (a specialized path); with more, the last ring stream is drawn
// twice, as party 0's prev and the last party's cur, so that a thread keeps
// only two streams live.
//
// Blocks. The wrapper (kernels/philox.py: plan) gives segment s the blocks
// [block0_s, block0_s + blocks_s): enough for kPairs pairs a thread, at
// most a wave of the card (SMs x resident blocks an SM). A block finds its
// segment from the table of first blocks (one cache line, no dependent
// loads) and strides over the segment's pairs; each thread keeps kPairs
// pairs in flight, so that independent Philox calls hide each other's ten
// dependent rounds. The segment table travels in the kernel's parameters
// (__grid_constant__, at most 1.6 KB): no host-to-device copy a launch.
//
// Keys. A segment names its rows' keys (and a fresh draw's dealer key) by
// slots of a key table, a small int64 tensor on the device that the host
// writes in place (kernels/keys.py). Thread r < rows of each block loads
// row r's key, and thread kMaxRows the dealer's, into shared memory once;
// every draw of the block reads them there. So a launch captured in a CUDA
// graph draws from whatever keys the table holds when the graph is
// replayed, and one captured forward serves every seed.
//
// What bounds it: the bytes written (8 per output element, plus 8 per
// plaintext element read) and the Philox rounds, one call per pair and per
// stream. A call is 40.5 SASS instructions with its output's fold
// (chip_smoke.py counts them in philox_rate_kernel with cuobjdump -sass),
// and the CUDA cores retire 64 32-bit integer instructions a clock per SM
// (16.7 T/s on an H100 at 1,980 MHz). A two-party sharing of a fresh draw
// with its plaintext row writes 24 bytes an element (7.2 ps at 3.35 TB/s)
// and makes 1.5 calls (3.6 ps): bytes bound it, with the rounds half as
// long, so both are kept at full rate: kPairs pairs in flight a thread,
// round keys recomputed per step rather than held in registers (56
// registers, four blocks an SM), 16-byte streaming stores (ulonglong2)
// where a row is 16-byte aligned and 8-byte ones only at an odd row start
// or end, 32-bit pair indices (a row holds at most 2^32 - 1 elements), and
// a grid sized from the SM count.
//
// The fixed cost of a launch (a few us for any kernel, a one-element torch
// op as well: chip_smoke.py's "launch floor" line, plus the host's
// dispatch) is paid once per dealer call instead of once per tensor: the
// TFP provider hands a whole call's segments to one launch.

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kMaxRows = 8;
constexpr int kMaxSegments = 16;
constexpr int kThreads = 256;
constexpr int kPairs = 2;      // pairs in flight a thread
constexpr int kMinBlocks = 4;  // resident blocks an SM (__launch_bounds__)
constexpr long long kMaxN = (1ll << 32) - 1;  // elements a row: pair indices fit 31 bits
constexpr int kRateCalls = 16;  // Philox calls a thread of philox_rate_kernel

enum What { kDraw = 0, kZero = 1, kPlain = 2, kPlainLane = 3, kFresh = 4, kTtpPlain = 5, kTtpFresh = 6 };

}  // namespace

// One segment, as kernels/philox.py's _SegmentArgs lays it out.
struct Segment {
  unsigned long long* out;           // (rows, n)
  unsigned long long* value;         // emit: (n,), v itself
  const unsigned long long* plain;   // kPlain, kTtpPlain: (n,); kPlainLane: (rows, n)
  long long n;
  unsigned long long counter;        // the draw's, or the sharing streams'
  unsigned long long draw_counter;   // kFresh, kTtpFresh: the dealer draw's counter
  int block0;                        // first block of the segment
  int blocks;
  int rows;
  int what;
  int xor_share;
  int kbits;                         // bits of a draw's rows or of an XOR sharing
  int draw_kbits;                    // kFresh: bits of v
  int src;
  int emit;
  int slot;                          // table slot of row 0's key (rows consecutive)
  int dealer_slot;                   // kFresh, kTtpFresh: table slot of the dealer's key
};

// A launch's segment table, at most N segments: the kernel is instantiated
// for N = 1, 2, 8 and 16, so that a small group's launch carries a small
// parameter block (0.2 KB for two segments, 1.6 KB for sixteen).
template <int N>
struct Group {
  const unsigned long long* table;  // the key table the slots index
  int block0[N];  // first block of each segment, for the search
  int count;
  Segment seg[N];
};

namespace {

// elements 2j and 2j + 1 of stream (key, counter); j < 2^31, so the
// counter's second word is 0
__device__ __forceinline__ ulonglong2 stream_pair(unsigned long long key,
                                                  unsigned long long counter, unsigned j) {
  const uint4 o = philox4x32_10(
      make_uint4(j, 0u, static_cast<unsigned>(counter), static_cast<unsigned>(counter >> 32)),
      make_uint2(static_cast<unsigned>(key), static_cast<unsigned>(key >> 32)));
  return make_ulonglong2(o.x | (static_cast<unsigned long long>(o.y) << 32),
                         o.z | (static_cast<unsigned long long>(o.w) << 32));
}

// A key the compiler must take as new each step, so that it does not hoist
// the key's ten round keys out of the loop into registers: the kPairs calls
// of a step share them, and the registers go to more resident blocks.
__device__ __forceinline__ unsigned long long step_key(unsigned long long k) {
  asm volatile("" : "+l"(k));
  return k;
}

__device__ __forceinline__ ulonglong2 shr(ulonglong2 v, int shift) {
  return make_ulonglong2(v.x >> shift, v.y >> shift);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The kPairs pairs a thread holds in one step: pair u covers elements 2 j[u]
// and 2 j[u] + 1 (`full`: both exist; `ok`: the pair exists).
struct Step {
  unsigned j[kPairs];
  bool ok[kPairs];
  bool full[kPairs];
};

// Elements 2j and 2j + 1 of a row (2j + 1 only where full): one 16-byte
// streaming store (written once, not read again here) where the row is
// 16-byte aligned, else 8-byte ones.
__device__ __forceinline__ void store_pair(unsigned long long* row, bool vec, unsigned j,
                                           bool full, ulonglong2 v) {
  if (full && vec) {
    __stcs(reinterpret_cast<ulonglong2*>(row + 2u * j), v);
  } else {
    row[2u * j] = v.x;
    if (full) row[2u * j + 1] = v.y;
  }
}

__device__ __forceinline__ void store_row(unsigned long long* row, const Step& st,
                                          const ulonglong2 (&v)[kPairs]) {
  const bool vec = aligned16(row);
#pragma unroll
  for (int u = 0; u < kPairs; ++u)
    if (st.ok[u]) store_pair(row, vec, st.j[u], st.full[u], v[u]);
}

// party p's share from its prev and cur ring streams and the value v it
// adds (or XORs) if it is party src
__device__ __forceinline__ ulonglong2 share_of(ulonglong2 prev, ulonglong2 cur, ulonglong2 v,
                                               bool mine, bool xs, int shift) {
  if (xs) {
    const ulonglong2 o = shr(make_ulonglong2(prev.x ^ cur.x, prev.y ^ cur.y), shift);
    return mine ? make_ulonglong2(o.x ^ v.x, o.y ^ v.y) : o;
  }
  const ulonglong2 o = make_ulonglong2(prev.x - cur.x, prev.y - cur.y);
  return mine ? make_ulonglong2(o.x + v.x, o.y + v.y) : o;
}

// The sharing of one step over ROWS parties (0: sg.rows, at run time).
// Two parties draw their two ring streams once each; more draw the last
// ring stream twice (as party 0's prev and as the last party's cur), so
// that only prev and cur stay live.
template <int ROWS>
__device__ __forceinline__ void share_step(const Segment& sg, const unsigned long long* keys,
                                           const Step& st, const ulonglong2 (&v)[kPairs]) {
  const long long n = sg.n;
  const bool xs = sg.xor_share;
  const int shift = 64 - sg.kbits;
  const int rows = ROWS ? ROWS : sg.rows;
  ulonglong2 prev[kPairs];
  const unsigned long long last = step_key(keys[rows - 1]);
#pragma unroll
  for (int u = 0; u < kPairs; ++u) prev[u] = stream_pair(last, sg.counter, st.j[u]);
  if (ROWS == 2) {
    ulonglong2 cur[kPairs], o[kPairs];
    const unsigned long long first = step_key(keys[0]);
#pragma unroll
    for (int u = 0; u < kPairs; ++u) {
      cur[u] = stream_pair(first, sg.counter, st.j[u]);
      o[u] = share_of(prev[u], cur[u], v[u], sg.src == 0, xs, shift);
    }
    store_row(sg.out, st, o);
#pragma unroll
    for (int u = 0; u < kPairs; ++u) o[u] = share_of(cur[u], prev[u], v[u], sg.src == 1, xs, shift);
    store_row(sg.out + n, st, o);
    return;
  }
#pragma unroll 1
  for (int p = 0; p < rows; ++p) {
    ulonglong2 o[kPairs];
    const unsigned long long key = step_key(keys[p]);
#pragma unroll
    for (int u = 0; u < kPairs; ++u) {
      const ulonglong2 cur = stream_pair(key, sg.counter, st.j[u]);
      o[u] = share_of(prev[u], cur, v[u], p == sg.src, xs, shift);
      prev[u] = cur;
    }
    store_row(sg.out + p * n, st, o);
  }
}

// The TTP sharing of one step: parties 1 .. rows - 1 write their own ttp
// stream, and party 0 gets v minus (or XOR) their sum, kept in v.
__device__ __forceinline__ void ttp_step(const Segment& sg, const unsigned long long* keys,
                                         const Step& st, ulonglong2 (&v)[kPairs]) {
  const long long n = sg.n;
  const bool xs = sg.xor_share;
#pragma unroll 1
  for (int p = 1; p < sg.rows; ++p) {
    ulonglong2 w[kPairs];
    const unsigned long long key = step_key(keys[p]);
#pragma unroll
    for (int u = 0; u < kPairs; ++u) {
      w[u] = stream_pair(key, sg.counter, st.j[u]);
      v[u] = xs ? make_ulonglong2(v[u].x ^ w[u].x, v[u].y ^ w[u].y)
                : make_ulonglong2(v[u].x - w[u].x, v[u].y - w[u].y);
    }
    store_row(sg.out + p * n, st, w);
  }
  store_row(sg.out, st, v);
}

}  // namespace

template <int N>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
philox_group_kernel(const __grid_constant__ Group<N> g) {
  // the segment: the last whose first block is at or before this one
  int s = 0;
#pragma unroll
  for (int i = 1; i < N; ++i)
    s += (i < g.count) & (static_cast<int>(blockIdx.x) >= g.block0[i]);
  const Segment& sg = g.seg[s];
  const long long n = sg.n;
  const unsigned n32 = static_cast<unsigned>(n);
  const unsigned pairs = static_cast<unsigned>((n + 1) >> 1);
  const unsigned stride = static_cast<unsigned>(sg.blocks) * kThreads;

  // the rows' keys, then a fresh draw's dealer key, from the table
  __shared__ unsigned long long keys[kMaxRows + 1];
  const int t = static_cast<int>(threadIdx.x);
  if (t < sg.rows)
    keys[t] = g.table[sg.slot + t];
  else if (t == kMaxRows && (sg.what == kFresh || sg.what == kTtpFresh))
    keys[kMaxRows] = g.table[sg.dealer_slot];
  __syncthreads();

  for (unsigned j0 = (blockIdx.x - g.block0[s]) * kThreads + threadIdx.x; j0 < pairs;
       j0 += kPairs * stride) {
    Step st;
#pragma unroll
    for (int u = 0; u < kPairs; ++u) {
      st.j[u] = j0 + u * stride;
      st.ok[u] = st.j[u] < pairs;
      st.full[u] = 2u * st.j[u] + 1 < n32;
    }

    if (sg.what == kDraw) {
      const int shift = 64 - sg.kbits;
#pragma unroll 1
      for (int r = 0; r < sg.rows; ++r) {
        ulonglong2 v[kPairs];
        const unsigned long long key = step_key(keys[r]);
#pragma unroll
        for (int u = 0; u < kPairs; ++u) v[u] = shr(stream_pair(key, sg.counter, st.j[u]), shift);
        store_row(sg.out + r * n, st, v);
      }
      continue;
    }

    // v: the value party src adds (or XORs) to its share of zero
    ulonglong2 v[kPairs];
#pragma unroll
    for (int u = 0; u < kPairs; ++u) v[u] = make_ulonglong2(0ull, 0ull);
    if (sg.what == kFresh || sg.what == kTtpFresh) {
      const int dshift = 64 - sg.draw_kbits;
      const unsigned long long dealer = step_key(keys[kMaxRows]);
#pragma unroll
      for (int u = 0; u < kPairs; ++u)
        v[u] = shr(stream_pair(dealer, sg.draw_counter, st.j[u]), dshift);
      if (sg.emit) store_row(sg.value, st, v);
    } else if (sg.what == kPlain || sg.what == kPlainLane || sg.what == kTtpPlain) {
      const unsigned long long* row = sg.plain + (sg.what == kPlainLane ? sg.src * n : 0);
      const bool vec = aligned16(row);
#pragma unroll
      for (int u = 0; u < kPairs; ++u) {
        if (!st.ok[u]) continue;
        const unsigned i0 = 2u * st.j[u];
        if (st.full[u] && vec) {
          v[u] = *reinterpret_cast<const ulonglong2*>(row + i0);
        } else {
          v[u].x = row[i0];
          if (st.full[u]) v[u].y = row[i0 + 1];
        }
      }
    }
    if (sg.what >= kTtpPlain)
      ttp_step(sg, keys, st, v);
    else if (sg.rows == 2)
      share_step<2>(sg, keys, st, v);
    else
      share_step<0>(sg, keys, st, v);
  }
}

// Philox calls alone: kRateCalls calls a thread on counters (t * kRateCalls
// + i, hi, c2, c3), XOR-folded into one 32-bit store a thread. chip_smoke.py
// times it against the bound by operations and counts its SASS
// instructions per call (cuobjdump -sass) for that bound.
template <int CALLS>
__global__ void __launch_bounds__(kThreads)
philox_rate_kernel(unsigned* __restrict__ out, uint2 key, unsigned hi, unsigned c2, unsigned c3) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned acc = 0;
#pragma unroll
  for (int i = 0; i < CALLS; ++i) {
    const uint4 o = philox4x32_10(make_uint4(t * CALLS + i, hi, c2, c3), key);
    acc ^= o.x ^ o.y ^ o.z ^ o.w;
  }
  out[t] = acc;
}

namespace {

template <int N>
int launch_group(const Segment* segs, int count, int grid, const unsigned long long* table,
                 cudaStream_t stream) {
  Group<N> g = {};
  g.table = table;
  for (int s = 0; s < count; ++s) {
    g.block0[s] = segs[s].block0;
    g.seg[s] = segs[s];
  }
  g.count = count;
  philox_group_kernel<N><<<grid, kThreads, 0, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// segs: `count` segments with block0 and blocks set (kernels/philox.py's
// plan); grid = the sum of their blocks; table: the key table the slots
// index. Returns cudaGetLastError().
extern "C" int philox_group_launch(const Segment* segs, int count, int grid,
                                   const unsigned long long* table, void* stream) {
  if (count < 1 || count > kMaxSegments || grid < 1 || table == nullptr)
    return cudaErrorInvalidValue;
  int next = 0;
  for (int s = 0; s < count; ++s) {
    const Segment& sg = segs[s];
    const bool share = sg.what != kDraw;
    const bool fresh = sg.what == kFresh || sg.what == kTtpFresh;
    if (sg.rows < 1 || sg.rows > kMaxRows || sg.n < 0 || sg.n > kMaxN || sg.what < kDraw ||
        sg.what > kTtpFresh || (sg.what >= kTtpPlain && sg.src != 0) ||
        sg.kbits < 1 || sg.kbits > 64 || sg.draw_kbits < 1 || sg.draw_kbits > 64 ||
        sg.block0 != next || sg.blocks < 0 || (sg.n > 0) != (sg.blocks > 0) ||
        (share && (sg.src < 0 || sg.src >= sg.rows)) ||
        (sg.emit && (!fresh || (sg.n > 0 && sg.value == nullptr))) ||
        ((sg.what == kPlain || sg.what == kPlainLane || sg.what == kTtpPlain) &&
         sg.plain == nullptr) ||
        (sg.n > 0 && sg.out == nullptr) || sg.slot < 0 || sg.dealer_slot < 0)
      return cudaErrorInvalidValue;
    next += sg.blocks;
  }
  if (next != grid) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (count <= 1) return launch_group<1>(segs, count, grid, table, st);
  if (count <= 2) return launch_group<2>(segs, count, grid, table, st);
  if (count <= 8) return launch_group<8>(segs, count, grid, table, st);
  return launch_group<kMaxSegments>(segs, count, grid, table, st);
}

// Resident blocks of philox_group_kernel an SM (plan's blocks_per_sm): the
// fewest of its instantiations.
extern "C" int philox_blocks_per_sm(int* blocks) {
  int fewest = 1 << 30, b = 0;
  cudaError_t e = cudaSuccess;
  const void* kernels[] = {reinterpret_cast<const void*>(philox_group_kernel<1>),
                           reinterpret_cast<const void*>(philox_group_kernel<2>),
                           reinterpret_cast<const void*>(philox_group_kernel<8>),
                           reinterpret_cast<const void*>(philox_group_kernel<kMaxSegments>)};
  for (const void* k : kernels) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, k, kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    fewest = b < fewest ? b : fewest;
  }
  *blocks = fewest;
  return 0;
}

// threads x kRateCalls (or 2 kRateCalls, the SASS count's second point)
// Philox calls.
extern "C" int philox_rate_launch(unsigned* out, long long threads, int twice,
                                  unsigned long long key, void* stream) {
  if (threads < kThreads || threads % kThreads != 0) return cudaErrorInvalidValue;
  const long long blocks = threads / kThreads;
  const uint2 k = make_uint2(static_cast<unsigned>(key), static_cast<unsigned>(key >> 32));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (twice)
    philox_rate_kernel<2 * kRateCalls><<<blocks, kThreads, 0, st>>>(out, k, 0u, 77u, 0u);
  else
    philox_rate_kernel<kRateCalls><<<blocks, kThreads, 0, st>>>(out, k, 0u, 77u, 0u);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int philox_rate_calls() { return kRateCalls; }
