// 12-count pileup with its 4-channel epilogue, for Hopper (sm_90a).
//
// Replaces two TPU kernels of methyldackel_tpu/ops/pileup_pallas.py, one
// template instantiation each:
//   kQual = false: _kernel_nq (launched by _pileup_tiles_nq): pre-gated
//     4-bit base codes, two to a byte, as
//     methyldackel_tpu/parallel/device.py:_fused_window_pregated uploads them
//     (--minOppositeDepth > 0);
//   kQual = true: _kernel (launched by _pileup_tiles): one code per byte
//     and a qual array, with the phred gate qual >= min_phred in the kernel
//     (the MDTPU_FUSED=v2 window program, _fused_fast_window).
// Fused with the XLA code around them: the nibble unpack and the barrel
// shift, counts_to_channels (extract.c:420-441), the candidate compaction
// and the narrowing cast with its overflow flag.
//
// Inputs:
//   codes [Nb, row_bytes] u8  nq: code 2j in the low nibble of byte j,
//                         2j+1 in the high one (Lc = 2 * row_bytes codes);
//                         qual: one code per byte (Lc = row_bytes).
//                         Codes A=1 C=2 G=4 T=8 N=15; 0 never counts (a
//                         gated base, or no base: the fast path holds no '=')
//   qual  [Nb, row_bytes] u8  qual mode only (null in nq mode)
//   shp   [Nb] u8         low 7 bits: the row's phase pos % 128; bit 7: parity
//   srtk, cntk [ntiles*K] i32  first row and row count of offset group k of
//                         tile t; every row of the group starts at window
//                         column t*T - LP + 128*k + phase
//   isc, isg [W/8] u8     np.packbits (MSB first) bitmaps: column is a
//                         reference C / G (after the window/reference shift)
//   dst   [W] i32         optional compaction map: output slot of a column,
//                         or -1 to drop it (null = dense output)
// Output: [nch, out_stride] of u8, u16 or u32: meth, unmeth, opposite-strand
// depth, opposite-strand variants (the first nch); overflow is set to 1 when
// a narrowed value did not fit (the stored value is then clamped).
//
// Design. The TPU kernel phase-aligned every row into a [Nb, LP2] array in
// HBM, summed 12 per-parity base counts per column into a VMEM accumulator
// tile by tile, and left the reference-dependent channel math to XLA. Here
// one block owns one tile of T = 512 output columns, one thread per column,
// as in pileup2.cu: each thread reads code (x + LP - 128k - phase) of each
// row of the K groups that reach its tile straight from the unshifted
// arrays, so no shifted array exists. A thread knows its column's reference
// class (C, G or neither) before the row loop, so the 12 counts collapse to
// the 4 channels it stores, kept in registers: a base on the calling strand
// of a C/G column feeds meth/unmeth, any other base feeds the opposite depth
// and, unless it is N or the calling strand's methylated base, the variant
// count. No block shares a column with another (no atomics), and there is no
// GMAX cap: a group of any size is one loop.
//
// What bounds it: memory. There is no tensor-core work; every row is read by
// about (T + LP2) / T tiles and by all warps of its tile (through L1).
// Staging a group's rows in shared memory is the next step for speed.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 512;
constexpr int kA = 1, kC = 2, kG = 4, kTh = 8, kN = 15;

template <bool kQual, typename OutT>
__global__ void __launch_bounds__(kT) pileup4_kernel(
    const uint8_t* __restrict__ codes, const uint8_t* __restrict__ qual,
    const uint8_t* __restrict__ shp, const int32_t* __restrict__ srtk,
    const int32_t* __restrict__ cntk, const uint8_t* __restrict__ isc,
    const uint8_t* __restrict__ isg, const int32_t* __restrict__ dst,
    OutT* __restrict__ out, int32_t* __restrict__ overflow, int K, int LP,
    int Lc, int row_bytes, int W, int out_stride, int nch, int min_phred,
    uint32_t cap) {
  const int t = blockIdx.x;
  const int x = threadIdx.x;
  const int col = t * kT + x;
  int cls = 2;  // 0: reference C, 1: reference G, 2: neither
  if (col < W) {
    const int bit = 7 - (col & 7);
    if ((isc[col >> 3] >> bit) & 1) {
      cls = 0;
    } else if ((isg[col >> 3] >> bit) & 1) {
      cls = 1;
    }
  }
  uint32_t meth = 0, unmeth = 0, opp = 0, var = 0;
  for (int k = 0; k < K; ++k) {
    const int g = t * K + k;
    const int r0 = srtk[g];
    const int r1 = r0 + cntk[g];
    const int rel = x + LP - 128 * k;  // code index = rel - phase
    for (int r = r0; r < r1; ++r) {
      const int s = shp[r];
      const int idx = rel - (s & 127);
      if (static_cast<unsigned>(idx) >= static_cast<unsigned>(Lc)) continue;
      const size_t row = static_cast<size_t>(r) * row_bytes;
      int code;
      if (kQual) {
        code = codes[row + idx] & 15;
        if (code == 0 || qual[row + idx] < min_phred) continue;
      } else {
        code = (codes[row + (idx >> 1)] >> ((idx & 1) * 4)) & 15;
        if (code == 0) continue;
      }
      const bool odd = (s & 128) != 0;
      if (cls == 0 && odd) {
        meth += code == kC;
        unmeth += code == kTh;
      } else if (cls == 1 && !odd) {
        meth += code == kG;
        unmeth += code == kA;
      } else {
        opp += 1;
        var += code != kN && code != (odd ? kG : kC);
      }
    }
  }
  if (col >= W) return;
  int slot = col;
  if (dst != nullptr) {
    slot = dst[col];
    if (slot < 0) return;
  }
  uint32_t v[4] = {meth, unmeth, opp, var};
  bool over = false;
  for (int c = 0; c < nch; ++c) {
    if (v[c] > cap) {
      over = true;
      v[c] = cap;
    }
    out[static_cast<size_t>(c) * out_stride + slot] = static_cast<OutT>(v[c]);
  }
  if (over) atomicOr(overflow, 1);
}

template <bool kQual, typename OutT>
void launch(const void* codes, const void* qual, const void* shp,
            const void* srtk, const void* cntk, const void* isc,
            const void* isg, const void* dst, void* out, void* overflow,
            int ntiles, int K, int LP, int Lc, int row_bytes, int W,
            int out_stride, int nch, int min_phred, uint32_t cap,
            cudaStream_t s) {
  pileup4_kernel<kQual, OutT><<<dim3(ntiles), dim3(kT), 0, s>>>(
      static_cast<const uint8_t*>(codes), static_cast<const uint8_t*>(qual),
      static_cast<const uint8_t*>(shp), static_cast<const int32_t*>(srtk),
      static_cast<const int32_t*>(cntk), static_cast<const uint8_t*>(isc),
      static_cast<const uint8_t*>(isg), static_cast<const int32_t*>(dst),
      static_cast<OutT*>(out), static_cast<int32_t*>(overflow), K, LP, Lc,
      row_bytes, W, out_stride, nch, min_phred, cap);
}

template <bool kQual>
int launch_width(const void* codes, const void* qual, const void* shp,
                 const void* srtk, const void* cntk, const void* isc,
                 const void* isg, const void* dst, void* out, void* overflow,
                 int ntiles, int K, int LP, int Lc, int row_bytes, int W,
                 int out_stride, int nch, int min_phred, int sat_bits,
                 cudaStream_t s) {
  switch (sat_bits) {
    case 8:
      launch<kQual, uint8_t>(codes, qual, shp, srtk, cntk, isc, isg, dst, out,
                             overflow, ntiles, K, LP, Lc, row_bytes, W,
                             out_stride, nch, min_phred, 0xFFu, s);
      return 0;
    case 16:
      launch<kQual, uint16_t>(codes, qual, shp, srtk, cntk, isc, isg, dst,
                              out, overflow, ntiles, K, LP, Lc, row_bytes, W,
                              out_stride, nch, min_phred, 0xFFFFu, s);
      return 0;
    case 32:
      launch<kQual, uint32_t>(codes, qual, shp, srtk, cntk, isc, isg, dst,
                              out, overflow, ntiles, K, LP, Lc, row_bytes, W,
                              out_stride, nch, min_phred, 0xFFFFFFFFu, s);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched). A null
// `qual` selects the nq layout.
extern "C" int mdtpu_pileup4(const void* codes, const void* qual,
                             const void* shp, const void* srtk,
                             const void* cntk, const void* isc,
                             const void* isg, const void* dst, void* out,
                             void* overflow, int ntiles, int K, int LP,
                             int Lc, int row_bytes, int W, int out_stride,
                             int nch, int min_phred, int sat_bits,
                             void* stream) {
  if (nch < 1 || nch > 4) return static_cast<int>(cudaErrorInvalidValue);
  if (ntiles <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc =
      qual == nullptr
          ? launch_width<false>(codes, qual, shp, srtk, cntk, isc, isg, dst,
                                out, overflow, ntiles, K, LP, Lc, row_bytes,
                                W, out_stride, nch, min_phred, sat_bits, s)
          : launch_width<true>(codes, qual, shp, srtk, cntk, isc, isg, dst,
                               out, overflow, ntiles, K, LP, Lc, row_bytes, W,
                               out_stride, nch, min_phred, sat_bits, s);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
