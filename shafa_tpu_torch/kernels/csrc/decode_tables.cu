// K9: a decode batch's tables, built on the card from its code tables.
//
// Replaces no TPU kernel: the JAX package builds these tables on the host
// (shafa_tpu/kernels/decode.py::decode_tables_batch, rank_tables,
// rank_tables32), and so did the port, in NumPy (kernels/decode.py::
// decode_tables_batch, rank_tables(32), rank_lut12(_32), which stay as this
// kernel's plain version), while the card sat idle: on 64 rows of 17-20-bit
// codes the 4096-entry tables alone took tens of milliseconds a batch.
//
// For each row, from its code lengths (0: absent) and the high 32 bits of
// its left-aligned codes (every code has at most 32 bits), it writes what
// K2 (rank.cu) or K5 (rank32.cu) reads: the codes in rank order (ascending
// by (code, symbol), the host's stable argsort), their sym | len << 8, the
// row's code count, and the 4096-entry table indexed by a window's top 12
// bits (rank_lut12: an entry is sym | len << 8 where those bits decide the
// code, 0 where no code lies below, else 0x8000 | depth << 8 | lo, the rank
// range lo .. lo + 2^depth - 1 that the window's low bits decide).
//
// The narrow route (codes of at most 16 bits, K2) takes the 16-bit prefixes,
// 0x10000 past the row's codes; the wide route (17-32 bits, K5) the u32
// codes, zero past them, and the count. One table serves both: a 16-bit
// prefix c lies at or below the 16-bit window w exactly where c << 16 lies
// at or below any 32-bit window whose top 16 bits are w, so the table is
// built on the u32 codes with 20 low bits on either route.
//
// Bound on the H100: launch latency. A row reads 1,280 bytes and writes
// about 10 KB (a 64-row batch about 650 KB, 0.2 us at 3.35 TB/s); its
// work is 256 x 256 key compares and 4096 x 2 binary searches of 9 steps
// in shared memory.
//
// Design: one block of 256 threads a row, one thread a symbol. Each thread
// puts its symbol's key (code << 8 | symbol, all ones if absent) in shared
// memory, the block counts the present symbols (__syncthreads_count), and
// each present symbol's rank is the number of keys below its own; it
// scatters its code and sym | len << 8 to that rank. Then each table entry
// takes two branch-free upper bounds over the sorted codes, at its first
// and its last window. Thread i writes entries 8i..8i+7 and 2048 + 8i ..
// 2048 + 8i + 7 as two int4 stores, so each store of a warp covers 512
// contiguous bytes.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;         // one a symbol
constexpr int LUT = 4096;            // table entries per row
constexpr int HALF = LUT / 2;        // where a thread's second 8 entries start
constexpr int LOW_BITS = 20;         // a window's bits below its top 12
constexpr int NO_CODE = 0x10000;     // pc16 past a row's codes
constexpr int LUT_RANGE = 0x8000;

// How many of the sorted codes s_pc[0..nc) lie at or below w (unsigned).
__device__ __forceinline__ int upper_bound(const uint32_t* __restrict__ s_pc,
                                           int nc, uint32_t w) {
  int c = 0;
#pragma unroll
  for (int step = 256; step; step >>= 1)
    if (c + step <= nc && s_pc[c + step - 1] <= w) c += step;
  return c;
}

// Table entry t of a row (rank_lut12): the ranks of the largest codes at or
// below the entry's first and last windows decide it.
__device__ __forceinline__ uint32_t entry(uint32_t t,
                                          const uint32_t* __restrict__ s_pc,
                                          const int* __restrict__ s_ls,
                                          int nc) {
  const uint32_t first = t << LOW_BITS;
  const int r_lo = upper_bound(s_pc, nc, first) - 1;
  const int r_hi = upper_bound(s_pc, nc, first | ((1u << LOW_BITS) - 1)) - 1;
  if (r_lo == r_hi) return r_hi >= 0 ? (uint32_t)s_ls[r_hi] : 0u;
  const int lo = max(r_lo, 0);
  const int depth = 32 - __clz(r_hi - lo);  // bit length, at most 8
  return (uint32_t)(LUT_RANGE | depth << 8 | lo);
}

__global__ void __launch_bounds__(THREADS)
decode_tables(const uint8_t* __restrict__ lens,
              const uint32_t* __restrict__ codes, int wide,
              int* __restrict__ pc_out, int* __restrict__ ls_out,
              int* __restrict__ ncodes_out, int16_t* __restrict__ lut) {
  __shared__ unsigned long long s_key[THREADS];
  __shared__ uint32_t s_pc[THREADS];
  __shared__ int s_ls[THREADS];
  const long long row = blockIdx.x;
  const int sym = threadIdx.x;
  const int len = lens[row * THREADS + sym];
  const uint32_t code = codes[row * THREADS + sym];
  const unsigned long long key =
      len > 0 ? (unsigned long long)code << 8 | sym : ~0ull;
  s_key[sym] = key;
  const int nc = __syncthreads_count(len > 0);
  if (len > 0) {
    int rank = 0;
#pragma unroll 16
    for (int t = 0; t < THREADS; ++t) rank += s_key[t] < key;
    s_pc[rank] = code;
    s_ls[rank] = sym | len << 8;
  }
  __syncthreads();

  const int i = threadIdx.x;  // now a rank
  const bool in = i < nc;
  pc_out[row * THREADS + i] =
      wide ? (in ? (int)s_pc[i] : 0) : (in ? (int)(s_pc[i] >> 16) : NO_CODE);
  ls_out[row * THREADS + i] = in ? s_ls[i] : 0;
  if (ncodes_out && i == 0) ncodes_out[row] = nc;

  int4* dst = reinterpret_cast<int4*>(lut + row * LUT);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint32_t t0 = half * HALF + 8 * i;
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = (entry(t0 + 2 * k, s_pc, s_ls, nc) & 0xFFFF)
             | entry(t0 + 2 * k + 1, s_pc, s_ls, nc) << 16;
    dst[t0 / 8] = make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
  }
}

}  // namespace

extern "C" {

// lens: (n, 256) u8 code lengths, 0 where a symbol is absent, at most 32;
// codes: (n, 256) the high 32 bits of the left-aligned codes; every row has
// at least one code. wide 0: pc_out (n, 256) the sorted 16-bit prefixes,
// 0x10000 past the row's codes (K2's pc16; codes of at most 16 bits);
// wide 1: the sorted u32 codes, 0 past them (K5's pc32). ls_out: (n, 256)
// sym | len << 8 in rank order, 0 past the codes; ncodes_out: (n,) the
// codes a row holds, or null; lut: (n, 4096) i16, 16-byte aligned.
int shafa_decode_tables(const uint8_t* lens, const int* codes, int n,
                        int wide, int* pc_out, int* ls_out, int* ncodes_out,
                        int16_t* lut, cudaStream_t stream) {
  if (n <= 0) return 0;
  decode_tables<<<n, THREADS, 0, stream>>>(
      lens, reinterpret_cast<const uint32_t*>(codes), wide, pc_out, ls_out,
      ncodes_out, lut);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

}  // extern "C"
