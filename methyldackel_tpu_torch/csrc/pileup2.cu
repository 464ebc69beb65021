// 2-bit semantic pileup with its channel epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel methyldackel_tpu/ops/pileup_pallas.py:_kernel_nq2
// (launched by _pileup_tiles_nq2) together with the XLA code around it in
// methyldackel_tpu/parallel/device.py:_v32_core and _fused_window_pregated2:
// the 2-bit unpack, the 7-step barrel shift, the channels_nch2 select, the
// candidate compaction and the narrowing cast with its overflow flag.
//
// Inputs are the host-packed arrays of the reference, unchanged:
//   seqpack [Nb, Lq] u8   4 semantic codes per byte, code j of a byte in bits
//                         2*(j&3): 1 = the strand's methylated base,
//                         2 = the unmethylated base, 0 = anything else
//   shp     [Nb] u8       low 7 bits: the row's phase pos % 128; bit 7: parity
//   srtk, cntk [ntiles*K] i32  first row and row count of offset group k of
//                         tile t; every row of the group starts at the
//                         aligned window column t*T - LP + 128*k
//   isc, isg [W/8] u8     np.packbits (MSB first) bitmaps: column is a
//                         reference C / G
//   dst     [W] i32       optional compaction map: output slot of a column,
//                         or -1 to drop it (null = dense output)
// Output: [2, out_stride] of u8, u16 or u32 (meth, unmeth); overflow is set
// to 1 when a narrowed value did not fit (the stored value is then clamped).
//
// Design. The TPU kernel phase-aligned every row into a [Nb, LP2] array in
// HBM and reduced a VMEM accumulator tile by tile in grid order. Here one
// block owns one tile of T = 512 output columns, one thread per column: each
// thread walks the K groups that can reach its tile and reads code
// (x + LP - 128k - phase) of each row straight from the packed bytes, so the
// shifted array never exists. The four counters live in registers, no block
// shares a column with another (no atomics, no carry between blocks), and
// the channel select, compaction and narrowing are fused into the store.
// There is no GMAX cap: a group of any size is one loop.
//
// What bounds it: memory. There is no tensor-core work; every row is read
// by about (T + LP2) / T tiles and by all warps of its tile (through L1).
// Staging a group's rows in shared memory (cp.async or TMA) is the next
// step for speed.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 512;

template <typename OutT>
__global__ void __launch_bounds__(kT) pileup2_kernel(
    const uint8_t* __restrict__ seqpack, const uint8_t* __restrict__ shp,
    const int32_t* __restrict__ srtk, const int32_t* __restrict__ cntk,
    const uint8_t* __restrict__ isc, const uint8_t* __restrict__ isg,
    const int32_t* __restrict__ dst, OutT* __restrict__ out,
    int32_t* __restrict__ overflow, int K, int LP, int L4, int Lq, int W,
    int out_stride, uint32_t cap) {
  const int t = blockIdx.x;
  const int x = threadIdx.x;
  const int col = t * kT + x;
  int odd_meth = 0, odd_unmeth = 0, even_meth = 0, even_unmeth = 0;
  for (int k = 0; k < K; ++k) {
    const int g = t * K + k;
    const int r0 = srtk[g];
    const int r1 = r0 + cntk[g];
    const int rel = x + LP - 128 * k;  // code index = rel - phase
    for (int r = r0; r < r1; ++r) {
      const int s = shp[r];
      const int idx = rel - (s & 127);
      if (static_cast<unsigned>(idx) < static_cast<unsigned>(L4)) {
        const int code =
            (seqpack[static_cast<size_t>(r) * Lq + (idx >> 2)] >> ((idx & 3) * 2)) & 3;
        const int meth = code == 1;
        const int unmeth = code == 2;
        if (s & 128) {
          odd_meth += meth;
          odd_unmeth += unmeth;
        } else {
          even_meth += meth;
          even_unmeth += unmeth;
        }
      }
    }
  }
  if (col >= W) return;
  int slot = col;
  if (dst != nullptr) {
    slot = dst[col];
    if (slot < 0) return;
  }
  const int bit = 7 - (col & 7);
  const bool is_c = (isc[col >> 3] >> bit) & 1;
  const bool is_g = (isg[col >> 3] >> bit) & 1;
  uint32_t m = is_c ? odd_meth : (is_g ? even_meth : 0);
  uint32_t u = is_c ? odd_unmeth : (is_g ? even_unmeth : 0);
  if (m > cap || u > cap) {
    atomicOr(overflow, 1);
    m = m > cap ? cap : m;
    u = u > cap ? cap : u;
  }
  out[slot] = static_cast<OutT>(m);
  out[static_cast<size_t>(out_stride) + slot] = static_cast<OutT>(u);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int mdtpu_pileup2(const void* seqpack, const void* shp,
                             const void* srtk, const void* cntk,
                             const void* isc, const void* isg,
                             const void* dst, void* out, void* overflow,
                             int ntiles, int K, int LP, int L4, int Lq, int W,
                             int out_stride, int sat_bits, void* stream) {
  if (ntiles <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(ntiles), block(kT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* sp = static_cast<const uint8_t*>(seqpack);
  const auto* sh = static_cast<const uint8_t*>(shp);
  const auto* st = static_cast<const int32_t*>(srtk);
  const auto* ct = static_cast<const int32_t*>(cntk);
  const auto* bc = static_cast<const uint8_t*>(isc);
  const auto* bg = static_cast<const uint8_t*>(isg);
  const auto* d = static_cast<const int32_t*>(dst);
  auto* of = static_cast<int32_t*>(overflow);
  switch (sat_bits) {
    case 8:
      pileup2_kernel<uint8_t><<<grid, block, 0, s>>>(
          sp, sh, st, ct, bc, bg, d, static_cast<uint8_t*>(out), of, K, LP,
          L4, Lq, W, out_stride, 0xFFu);
      break;
    case 16:
      pileup2_kernel<uint16_t><<<grid, block, 0, s>>>(
          sp, sh, st, ct, bc, bg, d, static_cast<uint16_t*>(out), of, K, LP,
          L4, Lq, W, out_stride, 0xFFFFu);
      break;
    case 32:
      pileup2_kernel<uint32_t><<<grid, block, 0, s>>>(
          sp, sh, st, ct, bc, bg, d, static_cast<uint32_t*>(out), of, K, LP,
          L4, Lq, W, out_stride, 0xFFFFFFFFu);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
