// Mate-overlap quality arbitration, for Hopper (sm_90a).
//
// Replaces the TPU kernel methyldackel_tpu/ops/arbitrate_pallas.py:_arb_kernel
// (launched by arbitrate_pallas) together with the XLA code around it in
// methyldackel_tpu/parallel/device.py:_fused_fast_window: the row gather of
// the mates into the phase-aligned split-mate layout, and the final_src take
// that routed the arbitrated quals back to their rows.
//
// Inputs (the v2 window program's rows, position-sorted, unshifted):
//   seq  [Nb, L] u8       base codes (A=1 C=2 G=4 T=8 N=15; 0 = no base)
//   qual [Nb, L] u8       rewritten in place
//   shp  [Nb] u8          low 7 bits: the row's phase pos % 128
//   pa, pb [P] i32        the mates of pair p, a with the smaller aligned start
//   code [P] u8           (aligned start of b - that of a) / 128, 0-2;
//                         3 = ineligible pair (strand parity differs, or
//                         shift out of range), left alone
//
// Rules at every position both mates cover with a base (overlaps.c:54-119):
// same base: the higher qual (b on a tie) gets q + q/5 (through a u8 store),
// the other 0; different bases: the higher qual, unless its base is N, keeps
// the difference and the other gets 0, else both get 0.
//
// Design. The TPU kernel evaluated the rules for each of the three block
// shifts over whole [PB, LP2] tiles and chose per pair by mask. Here one
// thread owns one (pair, base i of a): base i of a faces base
// j = i - (pos_b - pos_a) of b, with pos_b - pos_a = 128 * code + phase_b -
// phase_a, so the shifted layout is not needed. A read is in at most one
// pair, so each qual byte belongs to exactly one thread: the update is in
// place, with no atomics, in the array the qual-gated pileup then reads.
//
// What bounds it: memory (two reads and two writes of a byte per shared
// position; no arithmetic to speak of).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kN = 15;

__device__ __forceinline__ int boost(int q) { return (q + q / 5) & 0xFF; }

__global__ void __launch_bounds__(kBlock) arbitrate_kernel(
    const uint8_t* __restrict__ seq, uint8_t* __restrict__ qual,
    const uint8_t* __restrict__ shp, const int32_t* __restrict__ pa,
    const int32_t* __restrict__ pb, const uint8_t* __restrict__ code,
    int64_t total, int L) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (e >= total) return;
  const int p = static_cast<int>(e / L);
  const int i = static_cast<int>(e - static_cast<int64_t>(p) * L);
  const int c = code[p];
  if (c > 2) return;
  const int a = pa[p];
  const int b = pb[p];
  const int d = 128 * c + (shp[b] & 127) - (shp[a] & 127);
  const int j = i - d;
  if (static_cast<unsigned>(j) >= static_cast<unsigned>(L)) return;
  const size_t ia = static_cast<size_t>(a) * L + i;
  const size_t ib = static_cast<size_t>(b) * L + j;
  const int ba = seq[ia] & 15;
  const int bb = seq[ib] & 15;
  if (ba == 0 || bb == 0) return;
  const int qa = qual[ia];
  const int qb = qual[ib];
  int na, nb;
  if (ba != bb) {
    if (qa > qb && ba != kN) {
      na = qa - qb;
      nb = 0;
    } else if (qb > qa && bb != kN) {
      na = 0;
      nb = qb - qa;
    } else {
      na = 0;
      nb = 0;
    }
  } else if (qa > qb) {
    na = boost(qa);
    nb = 0;
  } else {
    na = 0;
    nb = boost(qb);
  }
  qual[ia] = static_cast<uint8_t>(na);
  qual[ib] = static_cast<uint8_t>(nb);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int mdtpu_arbitrate(const void* seq, void* qual, const void* shp,
                               const void* pa, const void* pb,
                               const void* code, int P, int L, void* stream) {
  const int64_t total = static_cast<int64_t>(P) * L;
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t blocks = (total + kBlock - 1) / kBlock;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  arbitrate_kernel<<<dim3(static_cast<unsigned>(blocks)), dim3(kBlock), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq), static_cast<uint8_t*>(qual),
      static_cast<const uint8_t*>(shp), static_cast<const int32_t*>(pa),
      static_cast<const int32_t*>(pb), static_cast<const uint8_t*>(code),
      total, L);
  return static_cast<int>(cudaGetLastError());
}
