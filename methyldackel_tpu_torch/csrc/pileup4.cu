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
// Inputs (the TPU layout's phase byte, 128-column offset groups and K are
// gone from the interface: rows carry their start column):
//   codes [Nb, row_bytes] u8  nq: code 2j in the low nibble of byte j,
//                         2j+1 in the high one (Lc = 2 * row_bytes codes);
//                         qual: one code per byte (Lc = row_bytes).
//                         Codes A=1 C=2 G=4 T=8 N=15; 0 never counts (a
//                         gated base, or no base: the fast path holds no '=')
//   qual  [Nb, row_bytes] u8  qual mode only (null in nq mode)
//   spos  [Nb] i32        2 * start + parity: the window column of the row's
//                         first code (may be negative) and its strand parity.
//                         PRECONDITION, checked by the host code that builds
//                         the tables (host_prep.tile_rows): starts do not
//                         decrease with the row index.
//   tlo, thi [ntiles] i32 rows [tlo[t], thi[t]) are the rows that can reach
//                         tile t: t*T - Lc < start < (t+1)*T. Consecutive
//                         because of the precondition, so their bytes in
//                         codes, qual and spos are one contiguous range.
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
// one block owns one tile of T = 512 output columns, one thread per column
// (no block shares a column with another: no atomics, bit-exact).
//   1. Stage, then count. The block copies its tile's row range of codes
//      (and qual) and spos into shared memory with cp.async in 16-byte
//      pieces spread over all 512 threads, in chunks of `chunk_rows` rows and
//      two buffers: the copy of chunk i+1 is in flight while chunk i is
//      counted. A range starts at any byte, so the copy takes the 16-byte
//      aligned superset and keeps the offset; pieces that would cross either
//      end of the array are copied byte by byte instead (staging.cuh, shared
//      with pileup2.cu). There is no row
//      cap: a range of any size is a loop over chunks, and a tile without
//      rows copies nothing and still writes its zeros.
//   2. Only the rows that reach the column. Starts do not decrease, so the
//      rows of a chunk that cover column x (x - Lc < start <= x) are one run;
//      each thread finds it by two binary searches over the staged spos and
//      loops over that run alone. A warp's 32 columns read nearly the same
//      spos words and 16 (nq) or 32 (qual) consecutive bytes of a staged
//      row. (Tried and slower on the same card, 0.078 against 0.055 ms in
//      the nq layout: one run per warp walked in step, each lane skipping
//      the rows that miss its column.)
//   3. A thread knows its column's reference class (C, G or neither) before
//      the row loop, so the 12 counts collapse to the 4 channels it stores:
//      a base on the calling strand of a C/G column feeds meth/unmeth, any
//      other base feeds the opposite depth and, unless it is N or the
//      calling strand's methylated base, the variant count. Which of the
//      four a base feeds is a 4-bit entry of a table indexed by its code,
//      one 64-bit word per (class, parity) from constant memory, held in
//      registers; the four flags are spread to the four bytes of one
//      packed accumulator with a multiply and a mask, and the bytes are
//      added to the four 32-bit counts after every chunk (a chunk has at
//      most 248 rows, so no byte passes 255).
//
// What bounds it: bytes by the roofline (integer byte work, no tensor-core
// product; every input byte once and every output byte once is 7 µs (nq) or
// 23 µs (qual) at the 1 Mb window shape), but the time, 55 µs and about
// 80 µs there on an NVIDIA H100 80GB HBM3 at its 700 W limit (chip_smoke.py),
// goes to the instruction rate of the count loop: about
// two dozen instructions per covered base (the spos word, the code byte and
// in the qual layout the qual byte from shared memory, the nibble and table
// shifts, the spread and the add) on all four schedulers of every SM, with
// 4 blocks of 512 threads resident (32 registers a thread, 2 x 20 KB (nq) or
// 2 x 24 KB (qual) of shared memory a block). Each row is staged by about
// (T + Lc) / T = 1.3 tiles, and 1,954 tiles fill the card's 528 block slots
// 3.7 times, so the last wave runs part empty.
#include <cstdint>
#include <cuda_runtime.h>

#include "staging.cuh"

namespace {

using namespace staging;

constexpr int kT = 512;
constexpr int kA = 1, kC = 2, kG = 4, kTh = 8, kN = 15;
// default shared-memory budget of one staging buffer (two per block)
constexpr int kBufBudget = 24 * 1024;
constexpr int kMaxSmem = 227 * 1024;
// most rows of a staging chunk: the per-chunk counts are bytes of one word
constexpr int kMaxChunk = 248;

// What one base adds, as bits: 1 meth, 2 unmeth, 4 opposite-strand depth,
// 8 opposite-strand variant. cls: 0 reference C (odd rows call), 1 reference
// G (even rows call), 2 neither.
constexpr uint32_t base_flags(int cls, int odd, int code) {
  if (code == 0) return 0;
  const bool call = (cls == 0 && odd) || (cls == 1 && !odd);
  if (call) {
    return (code == (odd ? kC : kG) ? 1u : 0u) |
           (code == (odd ? kTh : kA) ? 2u : 0u);
  }
  return 4u | ((code != kN && code != (odd ? kG : kC)) ? 8u : 0u);
}

// The flags of all 16 codes, four bits each, code 0 in the low nibble.
constexpr uint64_t flag_table(int cls, int odd) {
  uint64_t t = 0;
  for (int code = 0; code < 16; ++code) {
    t |= static_cast<uint64_t>(base_flags(cls, odd, code)) << (4 * code);
  }
  return t;
}

__constant__ uint64_t kFlagTable[3][2] = {
    {flag_table(0, 0), flag_table(0, 1)},
    {flag_table(1, 0), flag_table(1, 1)},
    {flag_table(2, 0), flag_table(2, 1)}};

template <bool kQual, typename OutT>
__global__ void __launch_bounds__(kT, 4) pileup4_kernel(
    const uint8_t* __restrict__ codes, const uint8_t* __restrict__ qual,
    const int32_t* __restrict__ spos, const int32_t* __restrict__ tlo,
    const int32_t* __restrict__ thi, const uint8_t* __restrict__ isc,
    const uint8_t* __restrict__ isg, const int32_t* __restrict__ dst,
    OutT* __restrict__ out, int32_t* __restrict__ overflow, int Nb, int Lc,
    int row_bytes, int chunk_rows, int code_cap, int spos_cap, int W,
    int out_stride, int nch, int min_phred, uint32_t cap) {
  extern __shared__ __align__(16) uint8_t smem[];
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
  const uint64_t tab_even = kFlagTable[cls][0];
  const uint64_t tab_odd = kFlagTable[cls][1];

  const int r0 = tlo[t];
  const int r1 = thi[t];
  const int nchunk = (r1 - r0 + chunk_rows - 1) / chunk_rows;
  const int buf_bytes = code_cap * (kQual ? 2 : 1) + spos_cap;
  const size_t code_total = static_cast<size_t>(Nb) * row_bytes;
  const uint8_t* spos_b = reinterpret_cast<const uint8_t*>(spos);

  auto stage_chunk = [&](int c) {
    const int ra = r0 + c * chunk_rows;
    const int rb = min(ra + chunk_rows, r1);
    uint8_t* buf = smem + (c & 1) * buf_bytes;
    const size_t b0 = static_cast<size_t>(ra) * row_bytes;
    const size_t b1 = static_cast<size_t>(rb) * row_bytes;
    stage(buf, codes, code_total, b0, b1, kT);
    if (kQual) stage(buf + code_cap, qual, code_total, b0, b1, kT);
    stage(buf + code_cap * (kQual ? 2 : 1), spos_b,
          static_cast<size_t>(Nb) * 4, static_cast<size_t>(ra) * 4,
          static_cast<size_t>(rb) * 4, kT);
    cp_async_commit();
  };

  uint32_t meth = 0, unmeth = 0, opp = 0, var = 0;
  if (nchunk > 0) stage_chunk(0);
  for (int c = 0; c < nchunk; ++c) {
    if (c + 1 < nchunk) {
      stage_chunk(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c, by every thread's copies, is in its buffer
    const int ra = r0 + c * chunk_rows;
    const int n = min(chunk_rows, r1 - ra);
    const uint8_t* buf = smem + (c & 1) * buf_bytes;
    const size_t b0 = static_cast<size_t>(ra) * row_bytes;
    const uint8_t* cbuf = buf + stage_offset(codes + b0);
    const uint8_t* qbuf = kQual ? buf + code_cap + stage_offset(qual + b0)
                                : nullptr;
    const int32_t* st = reinterpret_cast<const int32_t*>(
        buf + code_cap * (kQual ? 2 : 1) + stage_offset(spos_b + 4 * ra));
    if (col < W) {
      // rows with col - Lc < start <= col; spos = 2 * start + parity
      const int ja = first_above(st, n, 2 * (col - Lc) + 1);
      const int jb = ja + first_above(st + ja, n - ja, 2 * col + 1);
      uint32_t acc = 0;  // four byte counts: meth, unmeth, opp, var
#pragma unroll 4
      for (int j = ja; j < jb; ++j) {
        const int s = st[j];
        const int idx = col - (s >> 1);
        uint32_t code;
        if (kQual) {
          const int at = j * row_bytes + idx;
          code = cbuf[at] & 15u;
          if (qbuf[at] < min_phred) code = 0;
        } else {
          code = (cbuf[j * row_bytes + (idx >> 1)] >> ((idx & 1) * 4)) & 15u;
        }
        const uint64_t tab = (s & 1) ? tab_odd : tab_even;
        const uint32_t flags = static_cast<uint32_t>(tab >> (4 * code)) & 15u;
        // bit i of flags to bit 8 * i
        acc += (flags * 0x204081u) & 0x01010101u;
      }
      meth += acc & 255u;
      unmeth += (acc >> 8) & 255u;
      opp += (acc >> 16) & 255u;
      var += acc >> 24;
    }
    __syncthreads();  // the buffer is free for the copy of chunk c + 2
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

struct Args {
  const void *codes, *qual, *spos, *tlo, *thi, *isc, *isg, *dst;
  void *out, *overflow;
  int ntiles, Nb, Lc, row_bytes, chunk_rows, W, out_stride, nch, min_phred;
};

template <bool kQual, typename OutT>
int launch(const Args& a, uint32_t cap, cudaStream_t s) {
  const int code_cap = region_bytes(a.chunk_rows * a.row_bytes);
  const int spos_cap = region_bytes(a.chunk_rows * 4);
  const int smem = 2 * (code_cap * (kQual ? 2 : 1) + spos_cap);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = pileup4_kernel<kQual, OutT>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  kernel<<<dim3(a.ntiles), dim3(kT), smem, s>>>(
      static_cast<const uint8_t*>(a.codes),
      static_cast<const uint8_t*>(a.qual),
      static_cast<const int32_t*>(a.spos), static_cast<const int32_t*>(a.tlo),
      static_cast<const int32_t*>(a.thi), static_cast<const uint8_t*>(a.isc),
      static_cast<const uint8_t*>(a.isg), static_cast<const int32_t*>(a.dst),
      static_cast<OutT*>(a.out), static_cast<int32_t*>(a.overflow), a.Nb, a.Lc,
      a.row_bytes, a.chunk_rows, code_cap, spos_cap, a.W, a.out_stride, a.nch,
      a.min_phred, cap);
  return static_cast<int>(cudaGetLastError());
}

template <bool kQual>
int launch_width(const Args& a, int sat_bits, cudaStream_t s) {
  switch (sat_bits) {
    case 8:
      return launch<kQual, uint8_t>(a, 0xFFu, s);
    case 16:
      return launch<kQual, uint16_t>(a, 0xFFFFu, s);
    case 32:
      return launch<kQual, uint32_t>(a, 0xFFFFFFFFu, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream` and returns the CUDA error of the launch (0 =
// launched). A null `qual` selects the nq layout. chunk_rows <= 0 picks the
// staging chunk from the row width (two buffers of about 24 KB a block); no
// chunk is longer than 248 rows.
extern "C" int mdtpu_pileup4(const void* codes, const void* qual,
                             const void* spos, const void* tlo,
                             const void* thi, const void* isc,
                             const void* isg, const void* dst, void* out,
                             void* overflow, int ntiles, int Nb, int Lc,
                             int row_bytes, int chunk_rows, int W,
                             int out_stride, int nch, int min_phred,
                             int sat_bits, void* stream) {
  if (nch < 1 || nch > 4 || row_bytes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ntiles <= 0) return static_cast<int>(cudaGetLastError());
  if (chunk_rows <= 0) {
    const int per_row = row_bytes * (qual == nullptr ? 1 : 2) + 4;
    chunk_rows = (kBufBudget / per_row) & ~7;
    chunk_rows = chunk_rows < 8 ? 8 : chunk_rows;
  }
  if (chunk_rows > kMaxChunk) chunk_rows = kMaxChunk;
  const Args a{codes, qual, spos,   tlo,        thi,        isc,
               isg,   dst,  out,    overflow,   ntiles,     Nb,
               Lc,    row_bytes,    chunk_rows, W,          out_stride,
               nch,   min_phred};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return qual == nullptr ? launch_width<false>(a, sat_bits, s)
                         : launch_width<true>(a, sat_bits, s);
}
