// Mate-overlap quality arbitration, for Hopper (sm_90a).
//
// Replaces the TPU kernel methyldackel_tpu/ops/arbitrate_pallas.py:_arb_kernel
// (launched by arbitrate_pallas) together with the XLA code around it in
// methyldackel_tpu/parallel/device.py:_fused_fast_window: the row gather of
// the mates into the phase-aligned split-mate layout, and the final_src take
// that routed the arbitrated quals back to their rows.
//
// Inputs (the v2 window program's rows, unshifted; the TPU layout's phase
// byte and block-shift code are gone from the interface: rows carry their
// start, and the host lists only the pairs to arbitrate):
//   seq  [Nb, L] u8       base codes (A=1 C=2 G=4 T=8 N=15; 0 = no base)
//   qual [Nb, L] u8       rewritten in place
//   spos [Nb] i32         2 * start + parity of each row (the table the
//                         qual-gated pileup reads next)
//   pa, pb [P] i32        the mates of pair p. The roles are the host's
//                         (host_prep.v2_pair_tables) and are not re-derived
//                         from the starts: b wins a qual tie on the same
//                         base, and start_b < start_a does occur.
//
// Rules at every position both mates cover with a base (overlaps.c:54-119):
// same base: the higher qual (b on a tie) gets q + q/5 (through a u8 store),
// the other 0; different bases: the higher qual, unless its base is N, keeps
// the difference and the other gets 0, else both get 0.
//
// Design. The TPU kernel evaluated the rules for each of the three block
// shifts over whole [PB, LP2] tiles and chose per pair by mask. Here a group
// of kLanes = 16 lanes owns one pair: every lane reads the pair's two row
// indices and two starts (one broadcast load each, no division, no shuffle),
// d = start_b - start_a, and the group walks only the overlap, bases
// [max(0, d), min(L, L + d)) of a facing bases i - d of b, a byte a lane: the
// group's loads and stores of a step are 16 adjacent bytes of each row. A read
// is in at most one pair and a lane touches only bytes of its pair's overlap,
// so each qual byte belongs to exactly one lane: the update is in place, with
// no atomics, in the array the qual-gated pileup then reads; a byte without a
// base on both sides is not written. (Tried on the same card and slower, 0.048
// against 0.043 ms: aligned 4-byte words of a's quals with the facing bytes
// assembled from two words each; and 8 or 32 lanes a pair.)
//
// What bounds it: bytes (per pair two table words, two starts, and over the
// overlap two code and two qual bytes read and the changed quals written; no
// arithmetic to speak of). What is left above the bound is the latency of
// the dependent loads pair index -> start -> bytes, and 32-byte sectors of
// which an overlap uses only a part.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kLanes = 16;  // lanes that share a pair
constexpr int kN = 15;

__device__ __forceinline__ int boost(int q) { return (q + q / 5) & 0xFF; }

// The new quals of a position both mates cover with a base.
__device__ __forceinline__ void rule(int ba, int bb, int qa, int qb, int& na,
                                     int& nb) {
  na = 0;
  nb = 0;
  if (ba != bb) {
    if (qa > qb && ba != kN) {
      na = qa - qb;
    } else if (qb > qa && bb != kN) {
      nb = qb - qa;
    }
  } else if (qa > qb) {
    na = boost(qa);
  } else {
    nb = boost(qb);
  }
}

__device__ __forceinline__ void one_byte(const uint8_t* sa, const uint8_t* sb,
                                         uint8_t* qa, uint8_t* qb, int o) {
  const int ba = sa[o] & 15;
  const int bb = sb[o] & 15;
  if (ba == 0 || bb == 0) return;
  int na, nb;
  rule(ba, bb, qa[o], qb[o], na, nb);
  qa[o] = static_cast<uint8_t>(na);
  qb[o] = static_cast<uint8_t>(nb);
}

__global__ void __launch_bounds__(kBlock) arbitrate_kernel(
    const uint8_t* __restrict__ seq, uint8_t* qual,
    const int32_t* __restrict__ spos, const int32_t* __restrict__ pa,
    const int32_t* __restrict__ pb, int P, int L) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const int p = static_cast<int>(tid / kLanes);
  if (p >= P) return;
  const int a = pa[p];
  const int b = pb[p];
  const int d = (spos[b] >> 1) - (spos[a] >> 1);
  const int i0 = max(0, d);
  const int n = min(L, L + d) - i0;  // bases of the overlap
  const size_t ra = static_cast<size_t>(a) * L + i0;
  const size_t rb = static_cast<size_t>(b) * L + (i0 - d);
  for (int o = threadIdx.x & (kLanes - 1); o < n; o += kLanes) {
    one_byte(seq + ra, seq + rb, qual + ra, qual + rb, o);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int mdtpu_arbitrate(const void* seq, void* qual, const void* spos,
                               const void* pa, const void* pb, int P, int L,
                               void* stream) {
  if (P <= 0 || L <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t blocks =
      (static_cast<int64_t>(P) * kLanes + kBlock - 1) / kBlock;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  arbitrate_kernel<<<dim3(static_cast<unsigned>(blocks)), dim3(kBlock), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq), static_cast<uint8_t*>(qual),
      static_cast<const int32_t*>(spos), static_cast<const int32_t*>(pa),
      static_cast<const int32_t*>(pb), P, L);
  return static_cast<int>(cudaGetLastError());
}
