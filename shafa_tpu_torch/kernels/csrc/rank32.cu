// K5: code rank at every bit position, for codes of 17-32 bits.
//
// Replaces shafa_tpu/kernels/decode.py::_rank_kernel32 (pallas_call at
// decode.py:569). For payload byte j and bit offset s in 0-7, the 32-bit
// window starting at bit 8j+s decodes as the code with the largest
// left-aligned 32-bit value <= the window, among the row's n_codes codes
// (the code set is complete and listed in rank order). Output plane s, lane
// r*P + j holds sym | len << 8: K2's layout, with 6 bits of length.
//
// The window at bit 8j+s spans bytes j..j+4. The TPU kernel takes its low s
// bits from byte j+1 (decode.py:509), which decodes codes longer than 32 - s
// bits wrongly; here they come from byte j+4, the low byte of the next
// lane's window (zero past the row).
//
// Bound on the H100: device-memory bytes (4 B read and 32 B written per
// payload byte) and shared-memory lookups (8 binary-search steps per window).
//
// Design: as K2 (rank.cu). The row's codes, as unsigned 32-bit values, and
// their sym | len << 8 sit in shared memory; the search is bounded by the
// row's code count, since no 32-bit sentinel lies above every window. The
// TPU's biased signed compares, byte-quarter fetch matmul and two i8 planes
// only stood in for this lookup.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;
constexpr int TILE = THREADS * ITEMS;  // payload bytes per block

__global__ void __launch_bounds__(THREADS)
rank_planes32_kernel(const int* __restrict__ w32, const int* __restrict__ pc32,
                     const int* __restrict__ ls_tab,
                     const int* __restrict__ ncodes, long long p, long long n,
                     int* __restrict__ out) {
  __shared__ uint32_t s_pc[256];
  __shared__ int s_ls[256];
  const int row = blockIdx.y;
  for (int i = threadIdx.x; i < 256; i += THREADS) {
    s_pc[i] = (uint32_t)pc32[row * 256 + i];
    s_ls[i] = ls_tab[row * 256 + i];
  }
  const int nc = ncodes[row];
  __syncthreads();
  for (int k = 0; k < ITEMS; ++k) {
    const long long j = (long long)blockIdx.x * TILE + k * THREADS + threadIdx.x;
    if (j >= p) return;
    const long long lane = row * p + j;
    // bytes j..j+4, big-endian, in the low 40 bits
    const uint64_t w40 =
        ((uint64_t)(uint32_t)w32[lane] << 8) |
        (j + 1 < p ? (uint32_t)w32[lane + 1] & 0xFFu : 0u);
    for (int s = 0; s < 8; ++s) {
      const uint32_t w = (uint32_t)(w40 >> (8 - s));
      int ls = 0;  // no code <= the window: only for incomplete tables
      if (nc > 0 && s_pc[0] <= w) {
        int r = 0;
        for (int step = 128; step > 0; step >>= 1)
          if (r + step < nc && s_pc[r + step] <= w) r += step;
        ls = s_ls[r];
      }
      out[s * n + lane] = ls;
    }
  }
}

}  // namespace

extern "C" {

// w32: (B, P) big-endian byte windows; pc32: (B, 256) sorted left-aligned
// codes as u32 bits; ls_tab: (B, 256) sym | len << 8 in the same order;
// ncodes: (B,) codes per row; out: (8, B*P).
int shafa_rank_planes32(const int* w32, const int* pc32, const int* ls_tab,
                        const int* ncodes, int b, long long p, int* out,
                        cudaStream_t stream) {
  if (b <= 0 || p <= 0) return 0;
  const dim3 grid((unsigned)((p + TILE - 1) / TILE), b);
  rank_planes32_kernel<<<grid, THREADS, 0, stream>>>(w32, pc32, ls_tab, ncodes,
                                                     p, (long long)b * p, out);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

}  // extern "C"
