// K1: variable-rate bit emission (RLE-encode output and module-C bit-pack).
//
// Replaces shafa_tpu/kernels/emit_pallas.py::_emit_kernel (pallas_call at
// emit_pallas.py:328). Each input lane carries a left-aligned payload of
// 0-32 bits, either given (val, bitlen) or looked up by byte value in the
// row's 256-entry code table (the LUT variant, module C). Row r's payloads
// are concatenated MSB-first into the u32 words out[woff[r]:], byte-swapped
// so that the little-endian byte view of the words is the file's bytes.
// Words outside the rows' payloads stay as the caller zeroed them; nothing
// is written at or past out_words.
//
// Bound on the H100: device-memory bytes (8 B read per lane in the bits
// variant, 1 B in the LUT variant; the payload bits written once).
//
// Design: the TPU kernel walks each row's tiles in order and carries the
// running bit offset in SMEM. Here one pass does it: persistent blocks take
// tiles from a ticket, the rows' tiles interleaved (a tile past its row's
// length is skipped), read each lane once into registers (int4 loads: 4
// lanes of val and of bitlen, or 16 symbols), sum the tile's bits by warp
// scans and take the tile's bit offset in its row from a decoupled
// look-back over the row's earlier tiles (shafa_fsm::look_back, as K3 and
// K6). A thread's group of consecutive lanes folds its bits into whole
// words in a 64-bit accumulator, stores the words inside its span in the
// tile's zeroed shared word buffer and ORs in its two edge words (fold).
// The tile then stores its inner words coalesced (int4 where 16-byte
// aligned, streamed) and atomicOrs its two edge words, which it may share
// with the neighbouring tiles, into the zeroed output. The bits of different lanes
// never overlap, so the result does not depend on the order of the
// atomics.
#include <algorithm>

#include "fsm_common.cuh"

namespace {

using shafa_fsm::u64;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

constexpr int TILE = 4096;  // lanes per tile, both variants
// The tile's words: at most 32 bits a lane, starting up to 127 bits into
// the first 16-byte aligned quad of words.
constexpr int BUF_QUADS = TILE / 4 + 2;

// Lanes of a thread's group and groups per thread: 4 lanes (one int4 of val
// and one of bitlen) four times, or 16 symbols (one int4) once.
template <bool LUT>
struct Shape {
  static constexpr int LANES = LUT ? 16 : 4;
  static constexpr int GROUPS = LUT ? 1 : 4;
  static_assert(LANES * GROUPS * THREADS == TILE);
  // blocks an SM the registers must allow: left to the compiler, both take
  // 64-86 registers, 2-3 blocks an SM, and run slower
  static constexpr int MIN_BLOCKS = LUT ? 5 : 4;
};

struct Args {
  const int* val;       // (B, P) u32 payload bits, left-aligned (bits variant)
  const int* bitlen;    // (B, P) payload lengths (bits variant)
  const uint8_t* x;     // (B, P) symbols (LUT variant)
  const int* lut_len;   // (B, 256) code lengths (LUT variant)
  const int* lut_val;   // (B, 256) left-aligned code bits (LUT variant)
  const int* row_lens;  // (B,) valid lanes per row
  const int* woff;      // (B,) first output word per row
  long long p;          // lanes per row of the (B, P) inputs
  int b;                // rows
  int n_tiles;          // tiles per row of P lanes
  int total;            // B * n_tiles
  uint32_t* out;        // (out_words,), zeroed
  long long out_words;
  u64* status;          // (total,) look-back words, zeroed
  int* ticket;          // zeroed
};

// Top len bits of v, len clipped to [0, 32] (len 0: no bits).
__device__ __forceinline__ uint32_t top_bits(uint32_t v, int& len) {
  len = min(max(len, 0), 32);
  return v & (uint32_t)(0xFFFFFFFF00000000ull >> len);
}

// The next tile, or a value >= total when none is left. Ticket t is tile
// t / B of row t % B: the tiles running at once spread over the rows, so
// each row's look-back walks past fewer tiles that have not published
// their prefix yet. Once the ticket passes the longest row (max_len lanes)
// no tile is left.
__device__ int next_tile(const Args& a, long long max_len) {
  const int t = atomicAdd(a.ticket, 1);
  if (t < a.total && (long long)(t / a.b) * TILE >= max_len) {
    atomicMax(a.ticket, a.total);
    return a.total;
  }
  return t;
}

// A group's lanes as read from device memory: 4 lanes of val and of bitlen,
// or 16 symbols.
template <bool LUT>
struct Raw {
  int4 val, len;
};
template <>
struct Raw<true> {
  int4 sym;
};

__device__ __forceinline__ int4 ldcs_or_zero(const void* p, bool in) {
  return in ? __ldcs(reinterpret_cast<const int4*>(p)) : make_int4(0, 0, 0, 0);
}

// Issue the loads of a group's LANES lanes from row lane lane0 on (zero at
// or past P); nothing waits for them here.
template <bool LUT, bool VEC>
__device__ __forceinline__ void load_raw(const Args& a, int row,
                                         long long lane0, Raw<LUT>& r) {
  constexpr int L = Shape<LUT>::LANES;
  const long long idx = row * a.p + lane0;
  if constexpr (LUT) {
    if (VEC) {
      r.sym = ldcs_or_zero(a.x + idx, lane0 < a.p);
    } else {
      uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int i = 0; i < L; ++i)
        if (lane0 + i < a.p) w[i / 4] |= (uint32_t)a.x[idx + i] << (8 * (i % 4));
      r.sym = make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
    }
  } else {
    if (VEC) {
      r.val = ldcs_or_zero(a.val + idx, lane0 < a.p);
      r.len = ldcs_or_zero(a.bitlen + idx, lane0 < a.p);
    } else {
      int vv[L] = {}, ll[L] = {};
#pragma unroll
      for (int i = 0; i < L; ++i) {
        if (lane0 + i < a.p) {
          vv[i] = a.val[idx + i];
          ll[i] = a.bitlen[idx + i];
        }
      }
      r.val = make_int4(vv[0], vv[1], vv[2], vv[3]);
      r.len = make_int4(ll[0], ll[1], ll[2], ll[3]);
    }
  }
}

// A group's payload bits and lengths from its raw lanes, zero at or past
// row_len (the LUT variant looks its symbols up in s_tab).
template <bool LUT>
__device__ __forceinline__ void decode(const Raw<LUT>& r, long long lane0,
                                       long long row_len, const uint2* s_tab,
                                       uint32_t (&v)[Shape<LUT>::LANES],
                                       int (&len)[Shape<LUT>::LANES]) {
  constexpr int L = Shape<LUT>::LANES;
  if constexpr (LUT) {
    const uint32_t w[4] = {(uint32_t)r.sym.x, (uint32_t)r.sym.y,
                           (uint32_t)r.sym.z, (uint32_t)r.sym.w};
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const uint2 e = s_tab[(w[i / 4] >> (8 * (i % 4))) & 0xFFu];
      const bool in = lane0 + i < row_len;
      len[i] = in ? (int)e.x : 0;
      v[i] = in ? e.y : 0u;
    }
  } else {
    const int vv[4] = {r.val.x, r.val.y, r.val.z, r.val.w};
    const int ll[4] = {r.len.x, r.len.y, r.len.z, r.len.w};
#pragma unroll
    for (int i = 0; i < L; ++i) {
      len[i] = lane0 + i < row_len ? ll[i] : 0;
      v[i] = top_bits((uint32_t)vv[i], len[i]);
    }
  }
}

// A group's payloads placed from bit pos of the tile's zeroed word buffer
// on, built in a 64-bit accumulator: the words inside the group's span are
// stored, its first and last (shared with the neighbouring groups) OR-ed
// in.
template <int L>
__device__ __forceinline__ void fold(uint32_t* words, uint32_t pos,
                                     const uint32_t (&v)[L],
                                     const int (&len)[L]) {
  uint32_t* w = words + (pos >> 5);
  int nb = (int)(pos & 31);  // bits held in acc, from its top down
  u64 acc = 0;
  bool first = true;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    acc |= ((u64)v[i] << 32) >> nb;
    nb += len[i];
    if (nb >= 32) {
      const uint32_t word = (uint32_t)(acc >> 32);
      if (first)
        atomicOr(w, word);
      else
        *w = word;
      first = false;
      ++w;
      acc <<= 32;
      nb -= 32;
    }
  }
  if (acc) atomicOr(w, (uint32_t)(acc >> 32));
}

__device__ __forceinline__ uint32_t warp_incl_sum(uint32_t x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

template <bool LUT, bool VEC>
__global__ void __launch_bounds__(THREADS, Shape<LUT>::MIN_BLOCKS)
    emit_tiles(Args a) {
  constexpr int L = Shape<LUT>::LANES;
  constexpr int G = Shape<LUT>::GROUPS;
  static_assert(!LUT || THREADS == 256, "a thread loads one table entry");
  __shared__ int4 s_buf[BUF_QUADS];
  __shared__ uint2 s_tab[LUT ? 256 : 1];  // (len, masked code) by symbol
  __shared__ uint32_t s_wsum[G][WARPS];
  __shared__ int s_tile;
  __shared__ long long s_before;
  __shared__ long long s_max_len;  // the longest row's lanes
  uint32_t* words = reinterpret_cast<uint32_t*>(s_buf);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int tab_row = -1;  // the row whose table s_tab holds
  if (threadIdx.x == 0) s_max_len = 0;
  __syncthreads();
  long long mine = 0;
  for (int r = threadIdx.x; r < a.b; r += THREADS)
    mine = max(mine, min((long long)a.row_lens[r], a.p));
  atomicMax(&s_max_len, mine);
  for (;;) {
    __syncthreads();  // the last tile is done with shared memory
    if (threadIdx.x == 0) s_tile = next_tile(a, s_max_len);
    __syncthreads();
    const int t = s_tile;
    if (t >= a.total) return;
    const int row = t % a.b;
    const int k = t / a.b;
    const long long tile0 = (long long)k * TILE;
    // every load of the tile at once: its lanes, its row's length and first
    // word, and on a new row (LUT variant) this thread's table entry
    Raw<LUT> raw[G];
#pragma unroll
    for (int g = 0; g < G; ++g)
      load_raw<LUT, VEC>(a, row, tile0 + L * (threadIdx.x + THREADS * g),
                         raw[g]);
    const long long row_len = min((long long)a.row_lens[row], a.p);
    const long long woff = a.woff[row];
    const bool new_tab = LUT && row != tab_row;
    int tab_len = 0, tab_val = 0;
    if (new_tab) {
      tab_len = a.lut_len[row * 256 + threadIdx.x];
      tab_val = a.lut_val[row * 256 + threadIdx.x];
    }
    if (tile0 >= row_len) continue;  // past a row shorter than the longest
    if (new_tab) {
      const uint32_t cv = top_bits((uint32_t)tab_val, tab_len);
      s_tab[threadIdx.x] = make_uint2((uint32_t)tab_len, cv);
      tab_row = row;
      __syncthreads();
    }

    uint32_t v[G][L];
    int len[G][L];
    uint32_t bits[G], excl[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      decode<LUT>(raw[g], tile0 + L * (threadIdx.x + THREADS * g), row_len,
                  s_tab, v[g], len[g]);
      bits[g] = 0;
#pragma unroll
      for (int i = 0; i < L; ++i) bits[g] += (uint32_t)len[g][i];
      const uint32_t incl = warp_incl_sum(bits[g]);
      excl[g] = incl - bits[g];
      if (lane == 31) s_wsum[g][warp] = incl;
    }
    __syncthreads();
    // group g of this thread follows chunks 0..g-1 and the warps before it
    uint32_t tile_bits = 0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      uint32_t before_warp = 0, chunk = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const uint32_t s = s_wsum[g][w];
        chunk += s;
        before_warp += w < warp ? s : 0u;
      }
      excl[g] += tile_bits + before_warp;
      tile_bits += chunk;
    }
    if (warp == 0) {
      const long long before = shafa_fsm::look_back(
          a.status + (long long)row * a.n_tiles, k, (long long)tile_bits);
      if (lane == 0) s_before = before;
    } else {
      // the words the groups may OR into: up to 127 + 31 bits of offset
      const int quads = (int)((tile_bits + 158) / 128) + 1;
      for (int i = threadIdx.x - 32; i < quads; i += THREADS - 32)
        s_buf[i] = make_int4(0, 0, 0, 0);
    }
    __syncthreads();

    // the tile's words start at global word gbase, bit (before & 31);
    // the buffer starts at the aligned quad g0 <= gbase
    const long long before = s_before;
    const long long gbase = woff + (before >> 5);
    const int first = (int)(gbase & 3);
    const long long g0 = gbase - first;
    const uint32_t bit0 = 32u * first + (uint32_t)(before & 31);
#pragma unroll
    for (int g = 0; g < G; ++g) fold<L>(words, bit0 + excl[g], v[g], len[g]);
    __syncthreads();
    if (!tile_bits) continue;
    const int last = (int)((bit0 + tile_bits - 1) >> 5);
    for (int q = threadIdx.x; 4 * q <= last; q += THREADS) {
      const long long gw = g0 + 4 * q;
      if (4 * q > first && 4 * q + 3 < last && gw + 4 <= a.out_words) {
        const int4 s = s_buf[q];
        __stcs(reinterpret_cast<int4*>(a.out + gw),
               make_int4((int)shafa_bswap32(s.x), (int)shafa_bswap32(s.y),
                         (int)shafa_bswap32(s.z), (int)shafa_bswap32(s.w)));
        continue;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int wi = 4 * q + i;
        if (wi < first || wi > last || gw + i >= a.out_words) continue;
        const uint32_t u = shafa_bswap32(words[wi]);
        if (wi == first || wi == last) {
          if (u) atomicOr(a.out + gw + i, u);  // may be a neighbour's too
        } else {
          a.out[gw + i] = u;
        }
      }
    }
  }
}

// Persistent blocks: as many as fit on the card at once, at most one a tile.
// The look-back's words and the ticket start at 0.
template <bool LUT, bool VEC>
int launch(Args a, cudaStream_t stream) {
  static int per_sm = 0, sms = 0;
  if (!per_sm) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                  emit_tiles<LUT, VEC>,
                                                  THREADS, 0);
    SHAFA_RETURN_IF_LAUNCH_FAILED();
  }
  a.n_tiles = (int)((a.p + TILE - 1) / TILE);
  a.total = a.b * a.n_tiles;
  a.ticket = reinterpret_cast<int*>(a.status + a.total);
  const cudaError_t err =
      cudaMemsetAsync(a.status, 0, (a.total + 1) * sizeof(u64), stream);
  if (err != cudaSuccess) return (int)err;
  const int blocks = std::max(1, std::min(a.total, per_sm * sms));
  emit_tiles<LUT, VEC><<<blocks, THREADS, 0, stream>>>(a);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

extern "C" {

// Lanes per tile: the wrapper sizes the look-back scratch with it.
int shafa_emit_tile_lanes() { return TILE; }

// out: zeroed (out_words,) u32, nothing is written at or past out_words;
// status: B * ceil(P / TILE) + 1 u64 scratch (the look-back's words, then
// the ticket). lut != 0 selects the LUT variant (x, lut_len, lut_val),
// else the bits variant (val, bitlen). Lanes are read as int4 where P and
// the pointers allow it, one at a time otherwise.
int shafa_emit(const int* val, const int* bitlen, const uint8_t* x,
               const int* lut_len, const int* lut_val, int lut,
               const int* row_lens, const int* woff, int b, long long p,
               u64* status, int* out, long long out_words,
               cudaStream_t stream) {
  if (b <= 0 || p <= 0) return 0;
  const Args a{val, bitlen, x, lut_len, lut_val, row_lens, woff, p, b, 0, 0,
               reinterpret_cast<uint32_t*>(out), out_words, status, nullptr};
  if (lut)
    return p % 16 == 0 && aligned16(x) ? launch<true, true>(a, stream)
                                       : launch<true, false>(a, stream);
  return p % 4 == 0 && aligned16(val) && aligned16(bitlen)
             ? launch<false, true>(a, stream)
             : launch<false, false>(a, stream);
}

}  // extern "C"
