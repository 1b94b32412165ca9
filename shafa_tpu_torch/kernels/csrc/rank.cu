// K2: code rank at every bit position, for codes of at most 16 bits.
//
// Replaces shafa_tpu/kernels/decode.py::_rank_kernel (pallas_call at
// decode.py:442) together with the windows its caller builds first
// (decode.py::windows32_bytes): it reads the payload bytes. For payload
// byte j and bit offset s in 0-7, the 16-bit window starting at bit 8j+s
// (bytes past the row's width P read as zero) decodes as the code with the
// largest left-aligned 16-bit prefix <= the window (the code set is
// complete and listed in rank order). Output plane s, lane r*P + j holds
// sym | len << 8.
//
// Bound on the H100: device-memory bytes (1 B read and 32 B written per
// payload byte) and shared-memory lookups (one per window).
//
// Design: a 4096-entry table per row, built on the host
// (kernels/decode.py::rank_lut12), indexed by a window's top 12 bits: an
// entry holds sym | len << 8 where those 12 bits determine the code (every
// code of at most 12 bits), or the rank range that the window's low 4 bits
// decide, searched in the row's sorted prefixes. The table, the prefixes
// and their sym | len << 8 sit in shared memory; each block copies its
// slice of the row and a 16-byte halo (zero past P) into shared memory with
// int4 loads, and each thread takes 4 consecutive bytes at a time, so its 4
// entries of a plane leave as one int4 store (one plane at a time, which
// keeps few registers live) and a warp's stores cover 512 contiguous
// bytes. The TPU's one-hot MXU fetch and its bf16 byte quarters
// (decode.py:391-410) only stood in for this lookup.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int GROUPS = 8;                     // 4-byte groups per thread
constexpr int TILE = 4 * THREADS * GROUPS;    // payload bytes per block
constexpr int LUT_BITS = 12;
constexpr int LUT = 1 << LUT_BITS;            // table entries per row

// The code of window w16 whose table entry e is a rank range (an entry
// below 0, its flag 0x8000 the sign of the int16): ranks lo
// (bits 0-7) on, 2^depth of them (depth in bits 8-11) at most, searched
// in the sorted prefixes; ranks past the range hold prefixes above the
// window, and 0x10000 follows the row's last code.
__device__ __forceinline__ int search(int e, int w16,
                                      const int* __restrict__ s_pc,
                                      const int* __restrict__ s_ls) {
  const int lo = e & 255;
  int r = lo;
  for (int step = (1 << ((e >> 8) & 15)) >> 1; step; step >>= 1)
    if (r + step < 256 && s_pc[r + step] <= w16) r += step;
  return s_pc[lo] <= w16 ? s_ls[r] : 0;  // 0: no code <= the window
}

__global__ void __launch_bounds__(THREADS)
rank_lut_planes(const uint8_t* __restrict__ payload,
                const int16_t* __restrict__ lut, const int* __restrict__ pc16,
                const int* __restrict__ ls_tab, long long p, long long n,
                int* __restrict__ out) {
  __shared__ int4 s_lut[LUT * 2 / 16];
  __shared__ int s_pc[256];
  __shared__ int s_ls[256];
  __shared__ int4 s_by[TILE / 16 + 1];  // the tile's bytes, then the halo
  const int row = blockIdx.y;
  const long long tile0 = (long long)blockIdx.x * TILE;
  const int4* lsrc = reinterpret_cast<const int4*>(lut + (long long)row * LUT);
  for (int i = threadIdx.x; i < LUT * 2 / 16; i += THREADS)
    s_lut[i] = __ldg(lsrc + i);
  s_pc[threadIdx.x] = pc16[row * 256 + threadIdx.x];
  s_ls[threadIdx.x] = ls_tab[row * 256 + threadIdx.x];
  const int4* src =
      reinterpret_cast<const int4*>(payload + row * p + tile0);
  const long long avail = p - tile0;  // a multiple of 16
  for (int i = threadIdx.x; i < TILE / 16 + 1; i += THREADS)
    s_by[i] = 16 * i < avail ? __ldg(src + i) : make_int4(0, 0, 0, 0);
  __syncthreads();
  const int16_t* t_lut = reinterpret_cast<const int16_t*>(s_lut);
  const uint32_t* t_by = reinterpret_cast<const uint32_t*>(s_by);
#pragma unroll 2
  for (int k = 0; k < GROUPS; ++k) {
    const int g = threadIdx.x + THREADS * k;  // bytes 4g..4g+3 of the tile
    if (4ll * g >= avail) break;
    // bytes 4g..4g+3 and 4g+4..4g+7, big-endian
    const uint32_t w0 = shafa_bswap32(t_by[g]);
    const uint32_t w1 = shafa_bswap32(t_by[g + 1]);
    uint32_t win[4];  // the 32-bit windows from bytes 4g..4g+3 on
#pragma unroll
    for (int i = 0; i < 4; ++i) win[i] = __funnelshift_l(w1, w0, 8 * i);
    int* dst = out + row * p + tile0 + 4ll * g;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      int v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int w16 = (int)((win[i] << s) >> 16);
        const int e = t_lut[w16 >> (16 - LUT_BITS)];
        v[i] = e >= 0 ? e : search(e, w16, s_pc, s_ls);
      }
      // streamed: K3 reads the planes after the card's L2 has turned over
      __stcs(reinterpret_cast<int4*>(dst + s * n),
             make_int4(v[0], v[1], v[2], v[3]));
    }
  }
}

}  // namespace

extern "C" {

// Entries of K2's per-row table: the wrapper checks the table's shape.
int shafa_rank_lut_entries() { return LUT; }

// payload: (B, P) u8, P a multiple of 16, 16-byte aligned; lut: (B, 4096)
// i16 (kernels/decode.py::rank_lut12), 16-byte aligned; pc16: (B, 256)
// sorted 16-bit code prefixes, 0x10000 past the row's codes; ls_tab: (B,
// 256) sym | len << 8 in the same order; out: (8, B*P).
int shafa_rank_planes(const uint8_t* payload, const int16_t* lut,
                      const int* pc16, const int* ls_tab, int b, long long p,
                      int* out, cudaStream_t stream) {
  if (b <= 0 || p <= 0) return 0;
  if (p % 16) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((p + TILE - 1) / TILE), b);
  rank_lut_planes<<<grid, THREADS, 0, stream>>>(payload, lut, pc16, ls_tab, p,
                                                (long long)b * p, out);
  SHAFA_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

}  // extern "C"
