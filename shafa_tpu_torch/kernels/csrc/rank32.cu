// K5: code rank at every bit position, for codes of 17-32 bits.
//
// Replaces shafa_tpu/kernels/decode.py::_rank_kernel32 (pallas_call at
// decode.py:569) together with the windows its caller builds first
// (decode.py::windows32_bytes): it reads the payload bytes. For payload
// byte j and bit offset s in 0-7, the 32-bit window starting at bit 8j+s
// (bytes j..j+4; bytes past the row's width P read as zero) decodes as the
// code with the largest left-aligned 32-bit value <= the window, among the
// row's n_codes codes (the code set is complete and listed in rank order).
// Output plane s, lane r*P + j holds sym | len << 8: K2's layout, with 6
// bits of length. Only the lanes below the row's payload length, rounded up
// to a multiple of 4, are written.
//
// The TPU kernel takes the window's low s bits from byte j+1
// (decode.py:509), which decodes codes longer than 32 - s bits wrongly;
// here they come from byte j+4.
//
// Bound on the H100: device-memory bytes (1 B read and 32 B written per
// payload byte) and shared-memory lookups (one per window, and a short
// search where the window's top 12 bits leave the code open).
//
// Design: K2's (rank.cu). A 4096-entry table per row, built on the host
// (kernels/decode.py::rank_lut12_32), indexed by a window's top 12 bits:
// an entry holds sym | len << 8 where those 12 bits determine the code, or
// the rank range that the low 20 bits decide, searched in the row's sorted
// codes as unsigned 32-bit values and bounded by the row's code count (no
// 32-bit sentinel lies above every window). The table, the codes and their
// sym | len << 8 sit in shared memory; each block copies its slice of the
// row and a 16-byte halo (zero past P) into shared memory with int4 loads.
// A thread takes 4 consecutive bytes at a time: their eight big-endian
// bytes give each window with one funnel shift, and their 4 entries of a
// plane leave as one int4 streaming store. The TPU's biased signed
// compares, byte-quarter fetch matmul and two i8 planes only stood in for
// this lookup.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int GROUPS = 8;                     // 4-byte groups per thread
constexpr int TILE = 4 * THREADS * GROUPS;    // payload bytes per block
constexpr int LUT_BITS = 12;
constexpr int LUT = 1 << LUT_BITS;            // table entries per row

// The code of window w whose table entry e is a rank range (an entry below
// 0): ranks lo (bits 0-7) on, 2^depth of them (depth in bits 8-11) at
// most, searched in the sorted codes below the row's count nc; ranks past
// the range hold codes above the window.
__device__ __forceinline__ int search(int e, uint32_t w,
                                      const uint32_t* __restrict__ s_pc,
                                      const int* __restrict__ s_ls, int nc) {
  const int lo = e & 255;
  int r = lo;
  for (int step = (1 << ((e >> 8) & 15)) >> 1; step; step >>= 1)
    if (r + step < nc && s_pc[r + step] <= w) r += step;
  return s_pc[lo] <= w ? s_ls[r] : 0;  // 0: no code <= the window
}

__global__ void __launch_bounds__(THREADS)
rank32_lut_planes(const uint8_t* __restrict__ payload,
                  const int* __restrict__ plens,
                  const int16_t* __restrict__ lut,
                  const int* __restrict__ pc32, const int* __restrict__ ls_tab,
                  const int* __restrict__ ncodes, long long p, long long n,
                  int* __restrict__ out) {
  __shared__ int4 s_lut[LUT * 2 / 16];
  __shared__ uint32_t s_pc[256];
  __shared__ int s_ls[256];
  __shared__ int4 s_by[TILE / 16 + 1];  // the tile's bytes, then the halo
  const int row = blockIdx.y;
  const long long tile0 = (long long)blockIdx.x * TILE;
  const long long lim = min((long long)plens[row], p) - tile0;
  if (lim <= 0) return;  // no payload byte in this tile
  const int4* lsrc = reinterpret_cast<const int4*>(lut + (long long)row * LUT);
  for (int i = threadIdx.x; i < LUT * 2 / 16; i += THREADS)
    s_lut[i] = __ldg(lsrc + i);
  s_pc[threadIdx.x] = (uint32_t)pc32[row * 256 + threadIdx.x];
  s_ls[threadIdx.x] = ls_tab[row * 256 + threadIdx.x];
  const int nc = ncodes[row];
  const int4* src =
      reinterpret_cast<const int4*>(payload + row * p + tile0);
  const long long avail = p - tile0;  // a multiple of 16
  // a group below lim reads bytes up to 4 past its own four
  for (int i = threadIdx.x; i < TILE / 16 + 1; i += THREADS)
    s_by[i] = 16 * i < avail && 16 * i < lim + 8 ? __ldcs(src + i)
                                                  : make_int4(0, 0, 0, 0);
  __syncthreads();
  const int16_t* t_lut = reinterpret_cast<const int16_t*>(s_lut);
  const uint32_t* t_by = reinterpret_cast<const uint32_t*>(s_by);
#pragma unroll 2
  for (int k = 0; k < GROUPS; ++k) {
    const int g = threadIdx.x + THREADS * k;  // bytes 4g..4g+3 of the tile
    if (4ll * g >= lim) break;
    // bytes 4g..4g+3 and 4g+4..4g+7, big-endian
    const uint32_t w0 = shafa_bswap32(t_by[g]);
    const uint32_t w1 = shafa_bswap32(t_by[g + 1]);
    int* dst = out + row * p + tile0 + 4ll * g;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      int v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // the window at bit 8(4g + i) + s: bytes 4g+i..4g+i+4
        const uint32_t w = __funnelshift_l(w1, w0, 8 * i + s);
        const int e = t_lut[w >> (32 - LUT_BITS)];
        v[i] = e >= 0 ? e : search(e, w, s_pc, s_ls, nc);
      }
      // streamed: K6 reads the planes after the card's L2 has turned over
      __stcs(reinterpret_cast<int4*>(dst + s * n),
             make_int4(v[0], v[1], v[2], v[3]));
    }
  }
}

}  // namespace

extern "C" {

// Payload bytes per tile: the tests end rows on its edges.
int shafa_rank32_tile_bytes() { return TILE; }

// payload: (B, P) u8, P a multiple of 16, 16-byte aligned; plens: (B,)
// payload bytes per row; lut: (B, 4096) i16 (kernels/decode.py::
// rank_lut12_32), 16-byte aligned; pc32: (B, 256) sorted left-aligned codes
// as u32 bits; ls_tab: (B, 256) sym | len << 8 in the same order; ncodes:
// (B,) codes per row; out: (8, B*P), written at lanes below each row's
// payload length rounded up to a multiple of 4.
int shafa_rank_planes32(const uint8_t* payload, const int* plens,
                        const int16_t* lut, const int* pc32,
                        const int* ls_tab, const int* ncodes, int b,
                        long long p, int* out, cudaStream_t stream) {
  if (b <= 0 || p <= 0) return 0;
  if (p % 16) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((p + TILE - 1) / TILE), b);
  rank32_lut_planes<<<grid, THREADS, 0, stream>>>(
      payload, plens, lut, pc32, ls_tab, ncodes, p, (long long)b * p, out);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

}  // extern "C"
