// Parts shared by the boundary state machines that read K2's or K5's
// planes: K3 (fsm_decode.cu, 8 or 16 states) and K6 (fsm32.cu, 32 states).
//
// The planes hold, for payload byte j and bit offset b, ls8[b, r*P + j] =
// sym | len << 8 of the code starting at bit 8j+b. A byte's eight entries
// become a Byte (gather4 takes one byte of four entries); its E table is
// the state machine's step (byte_e); a tile's symbol count reaches the later
// tiles of its row through a decoupled look-back (look_back).
#pragma once

#include "common.cuh"

namespace shafa_fsm {

using u64 = unsigned long long;

// A payload byte's eight codes, one per bit offset b (byte b of a word
// pair: offsets 0-3 in lo, 4-7 in hi): lengths, clipped by the caller's
// rule, and symbols.
struct Byte {
  uint32_t len_lo, len_hi;
  uint32_t sym_lo, sym_hi;
};

// Byte b (in [0, 8)) of the pair (lo, hi).
__device__ __forceinline__ uint32_t byte_at(uint32_t lo, uint32_t hi, int b) {
  return __byte_perm(lo, hi, (uint32_t)b) & 0xFFu;
}

// Bytes 1 (sel 0x0051) or 0 (sel 0x0040) of four plane entries, in order.
__device__ __forceinline__ uint32_t gather4(int a, int b, int c, int d,
                                            uint32_t sel) {
  return __byte_perm(__byte_perm(a, b, sel), __byte_perm(c, d, sel), 0x5410);
}

// E of one byte (byte b of (lo, hi): E[b]), the state at the byte's end
// after the chain of codes that starts at bit b; its transition function
// maps q < 8 to E[q] and q >= 8 to q - 8.
__device__ __forceinline__ void byte_e(const Byte& by, uint32_t& lo,
                                       uint32_t& hi) {
  lo = hi = 0;
#pragma unroll
  for (int bit = 7; bit >= 0; --bit) {
    const int nb =
        bit + (int)(((bit < 4 ? by.len_lo : by.len_hi) >> (8 * (bit & 3)))
                    & 0xFFu);
    const uint32_t x = nb >= 8 ? (uint32_t)(nb - 8) : byte_at(lo, hi, nb);
    if (bit < 4)
      lo |= x << (8 * bit);
    else
      hi |= x << (8 * (bit - 4));
  }
}

// Status word of a tile in the look-back: a flag in the top two bits, a
// symbol count below; 0 until the tile publishes.
constexpr u64 STATUS_AGGREGATE = 1ull << 62;  // the tile's own count
constexpr u64 STATUS_PREFIX = 2ull << 62;     // its row's count up to it
constexpr u64 STATUS_VALUE = STATUS_AGGREGATE - 1;

__device__ __forceinline__ u64 load_status(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_status(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// Decoupled look-back, run by one warp: publish tile k's symbol count, sum
// the counts of the row's earlier tiles 32 at a time back to the nearest
// one that has published its prefix, publish tile k's prefix. Returns the
// symbols of the row before tile k. A word holds its flag and its count,
// so one 64-bit access reads or writes both. Tiles take row-major ids from
// a ticket, so a tile waits only on tiles already running; a tile past its
// row's payload publishes nothing, since no tile of the row waits on it.
__device__ __forceinline__ long long look_back(u64* status, int k,
                                               long long count) {
  const int lane = threadIdx.x & 31;
  if (k == 0) {
    if (lane == 0) store_status(status, STATUS_PREFIX | (u64)count);
    return 0;
  }
  if (lane == 0) store_status(status + k, STATUS_AGGREGATE | (u64)count);
  long long before = 0;
  for (int end = k;; end -= 32) {
    const int t = end - 1 - lane;  // lane 0: the nearest tile
    u64 w;
    do {
      w = t >= 0 ? load_status(status + t) : STATUS_PREFIX;
    } while (__any_sync(0xFFFFFFFFu, (w >> 62) == 0));
    const unsigned prefix = __ballot_sync(0xFFFFFFFFu, (w >> 62) == 2);
    const int last = prefix ? __ffs(prefix) - 1 : 31;  // lanes summed
    long long v = lane <= last ? (long long)(w & STATUS_VALUE) : 0;
#pragma unroll
    for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
    before += v;
    if (prefix) break;
  }
  if (lane == 0)
    store_status(status + k, STATUS_PREFIX | (u64)(before + count));
  return before;
}

}  // namespace shafa_fsm
