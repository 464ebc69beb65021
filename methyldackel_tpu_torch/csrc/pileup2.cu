// 2-bit semantic pileup with its channel epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel methyldackel_tpu/ops/pileup_pallas.py:_kernel_nq2
// (launched by _pileup_tiles_nq2) together with the XLA code around it in
// methyldackel_tpu/parallel/device.py:_v32_core and _fused_window_pregated2:
// the 2-bit unpack, the 7-step barrel shift, the channels_nch2 select, the
// candidate compaction and the narrowing cast with its overflow flag.
//
// Inputs (the TPU layout's phase byte, 128-column offset groups, K and LP are
// gone from the interface: rows carry their start column):
//   seqpack [Nb, Lq] u8   4 semantic codes per byte, code j of a byte in bits
//                         2*(j&3): 1 = the strand's methylated base,
//                         2 = the unmethylated base, 0 or 3 = not counted
//                         (Lc = 4 * Lq codes a row)
//   spos  [Nb] i32        2 * start + parity: the column of the row's first
//                         code (may be negative) and its strand parity.
//                         PRECONDITION, checked by the host code that builds
//                         the tables (host_prep.tile_rows): starts do not
//                         decrease with the row index.
//   tlo, thi [ntiles] i32 rows [tlo[t], thi[t]) are the rows that can reach
//                         tile t of T = 512 columns: t*T - Lc < start <
//                         (t+1)*T. Consecutive because of the precondition.
//   isc, isg [W/8] u8     np.packbits (MSB first) bitmaps: column is a
//                         reference C / G
//   dst   [W] i32         optional compaction map: output slot of a column,
//                         or -1 to drop it (null = dense output)
// Output: [2, out_stride] of u8, u16 or u32 (meth, unmeth), ZEROED BY THE
// CALLER: a column that is neither C nor G, or has no slot, is not written.
// overflow is set to 1 when a narrowed value did not fit (the stored value
// is then clamped).
//
// Design. The TPU kernel phase-aligned every row into a [Nb, LP2] array in
// HBM and reduced a VMEM accumulator tile by tile in grid order. Here a block
// owns one tile and no block shares a column with another (no atomics,
// bit-exact).
//   1. Stage, then count. The block copies its tile's contiguous row range of
//      seqpack and spos into shared memory with 16-byte cp.async (staging.cuh,
//      shared with pileup4.cu: aligned superset, byte-wise ends). One buffer a
//      block: at the default sizes a block's rows are one chunk, so a second
//      buffer would only halve the blocks an SM holds, and it is the other
//      blocks of the SM that hide a block's copy. A longer range (a coverage
//      spike) is a loop over chunks; there is no row cap, and a block without
//      rows copies nothing.
//   2. Only the rows that reach a thread's columns: starts do not decrease, so
//      those rows are one run of the chunk, found by two binary searches over
//      the staged spos.
//   3. The column's class before the loop. isc/isg say whether a column is a
//      reference C (odd rows count), G (even rows count) or neither (nothing
//      to count, nothing to store), so a thread keeps two counts a column, not
//      four, and a thread whose columns are all neither, or without a slot,
//      runs no loop.
//   4. Sixteen columns a thread. Two-bit codes make a row's codes for sixteen
//      adjacent columns one 32-bit window of the staged row: two aligned
//      shared-memory words and a funnel shift. Codes before the row's start
//      and past its end are shifted or masked out, code 3 is cleared, the
//      parity selects the C or the G columns' mask, and what is left (01 =
//      methylated, 10 = unmethylated per column) is added into four words of
//      nibble counters, flushed to the 32 32-bit counts every 15 rows. That
//      is about 30 instructions a row for 16 columns where one column a
//      thread spends about a dozen per row and column.
//   5. A few lanes share the sixteen columns. Sixteen columns a thread leaves
//      32 threads a tile and a block, too few warps to hide the loop's latency, so
//      `split` adjacent lanes take every split-th row of the run and add
//      their counts with shuffles at the end; the first lane stores.
//
// What bounds it: bytes by the roofline (every input byte once and every
// output byte once; integer bit work, no tensor-core product). What is left
// above the bound is latency: the copy of a block's rows before its first
// count, the two searches, and a dependent loop per thread with few warps
// to hide it. At the default extract's group shape (960,000 rows of 16
// bytes over 1,468 tiles) it takes 0.029 ms against a byte bound of 6.2 us
// on an NVIDIA H100 80GB HBM3 at its 700 W limit (chip_smoke.py).
#include <cstdint>
#include <cuda_runtime.h>

#include "staging.cuh"

namespace {

using namespace staging;

constexpr int kT = 512;  // columns of one tile of the tlo/thi tables
constexpr int kMaxSmem = 227 * 1024;
// defaults from the mean row density (rows / columns): a lane's share of the
// rows that reach sixteen columns, and the staging chunk over the rows that
// reach a tile
constexpr int kRowsPerLane = 20;
constexpr float kChunkSlack = 1.5f;
constexpr int kMaxSplit = 16;  // 32 column groups a tile: 512 threads

struct Params {
  const uint8_t* seqpack;
  const int32_t *spos, *tlo, *thi;
  const uint8_t *isc, *isg;
  const int32_t* dst;
  void* out;
  int32_t* overflow;
  int ntiles, Nb, Lq, chunk_rows, code_cap, spos_cap, W, out_stride;
  int split, vec_store, vec_dst;
  uint32_t cap;
};

// The bits of sixteen columns from col0 (a multiple of 16) of an MSB-first
// bitmap, spread to 11 in bits 2k, 2k+1 for column col0 + k.
__device__ __forceinline__ uint32_t column_mask(const uint8_t* bits, int col0) {
  const uint32_t b = bits[col0 >> 3] | (bits[(col0 >> 3) + 1] << 8);
  uint32_t m = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    m |= ((b >> (8 * (k >> 3) + 7 - (k & 7))) & 1u) * (3u << (2 * k));
  }
  return m;
}

// The staged chunks of one block: rows [r0, r1) in chunks of p.chunk_rows,
// one after the other through one buffer (codes, then starts).
struct Chunks {
  const Params& p;
  uint8_t* smem;
  int r0, r1, nthreads;

  __device__ __forceinline__ int count() const {
    return (r1 - r0 + p.chunk_rows - 1) / p.chunk_rows;
  }
  __device__ __forceinline__ int rows(int c) const {
    return min(p.chunk_rows, r1 - (r0 + c * p.chunk_rows));
  }
  // the aligned staging region of chunk c's codes and the byte offset of
  // its first row in it
  __device__ __forceinline__ int code_offset(int c) const {
    const size_t b0 = static_cast<size_t>(r0 + c * p.chunk_rows) * p.Lq;
    return stage_offset(p.seqpack + b0);
  }
  __device__ __forceinline__ const int32_t* starts(int c) const {
    const uint8_t* sb = reinterpret_cast<const uint8_t*>(p.spos);
    return reinterpret_cast<const int32_t*>(
        smem + p.code_cap +
        stage_offset(sb + 4 * static_cast<size_t>(r0 + c * p.chunk_rows)));
  }
  __device__ __forceinline__ void stage_chunk(int c) const {
    const int ra = r0 + c * p.chunk_rows;
    const int rb = min(ra + p.chunk_rows, r1);
    stage(smem, p.seqpack, static_cast<size_t>(p.Nb) * p.Lq,
          static_cast<size_t>(ra) * p.Lq, static_cast<size_t>(rb) * p.Lq,
          nthreads);
    stage(smem + p.code_cap, reinterpret_cast<const uint8_t*>(p.spos),
          static_cast<size_t>(p.Nb) * 4, static_cast<size_t>(ra) * 4,
          static_cast<size_t>(rb) * 4, nthreads);
    cp_async_commit();
  }
};

__device__ __forceinline__ uint32_t clamp_flag(uint32_t v, uint32_t cap,
                                               bool& over) {
  if (v > cap) {
    over = true;
    return cap;
  }
  return v;
}

constexpr int kCols = 16;  // columns a thread

// Sixteen narrowed values to sixteen adjacent slots, as 16-byte stores.
template <typename OutT>
__device__ __forceinline__ void store16(OutT* at, const uint32_t (&v)[kCols]) {
  uint4* q = reinterpret_cast<uint4*>(at);
  if (sizeof(OutT) == 1) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = v[4 * i] | (v[4 * i + 1] << 8) | (v[4 * i + 2] << 16) |
             (v[4 * i + 3] << 24);
    }
    q[0] = make_uint4(w[0], w[1], w[2], w[3]);
  } else if (sizeof(OutT) == 2) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      q[i] = make_uint4(v[8 * i] | (v[8 * i + 1] << 16),
                        v[8 * i + 2] | (v[8 * i + 3] << 16),
                        v[8 * i + 4] | (v[8 * i + 5] << 16),
                        v[8 * i + 6] | (v[8 * i + 7] << 16));
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      q[i] = make_uint4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    }
  }
}

template <typename OutT>
__global__ void __launch_bounds__(32 * kMaxSplit)
    pileup2_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int t = blockIdx.x;
  const int Lc = 4 * p.Lq;
  // `split` adjacent lanes share sixteen columns and take every split-th
  // row of their run
  const int part = threadIdx.x & (p.split - 1);
  const int col0 = t * kT + (threadIdx.x / p.split) * kCols;
  const bool active = col0 + kCols <= p.W;

  // 11 at the thread's kept C columns / kept G columns, column k in bits
  // 2k, 2k+1
  uint32_t cmask = 0, gmask = 0;
  if (active) {
    cmask = column_mask(p.isc, col0);
    gmask = column_mask(p.isg, col0) & ~cmask;  // a C column is not a G one
    if (p.dst != nullptr && (cmask | gmask) != 0) {
      uint32_t slotted = 0;  // 11 where the column has an output slot
      if (p.vec_dst) {
        const int4* d4 = reinterpret_cast<const int4*>(p.dst + col0);
#pragma unroll
        for (int q = 0; q < kCols / 4; ++q) {
          const int4 d = d4[q];
          slotted |= (d.x >= 0 ? 3u : 0u) << (8 * q);
          slotted |= (d.y >= 0 ? 3u : 0u) << (8 * q + 2);
          slotted |= (d.z >= 0 ? 3u : 0u) << (8 * q + 4);
          slotted |= (d.w >= 0 ? 3u : 0u) << (8 * q + 6);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          slotted |= (p.dst[col0 + k] >= 0 ? 3u : 0u) << (2 * k);
        }
      }
      cmask &= slotted;
      gmask &= slotted;
    }
  }
  const bool counts = (cmask | gmask) != 0;

  uint32_t cm[kCols], cu[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) cm[k] = cu[k] = 0;

  const Chunks ch{p, smem, p.tlo[t], p.thi[t], static_cast<int>(blockDim.x)};
  const int nchunk = ch.count();
  for (int c = 0; c < nchunk; ++c) {
    ch.stage_chunk(c);
    cp_async_wait<0>();
    __syncthreads();  // chunk c, by every thread's copies, is in the buffer
    if (counts) {
      const int n = ch.rows(c);
      const uint8_t* buf = smem;
      const int coff = ch.code_offset(c);
      const int32_t* st = ch.starts(c);
      // rows with col0 - Lc < start <= col0 + 15
      const int ja = first_above(st, n, 2 * (col0 - Lc) + 1);
      const int jb =
          ja + first_above(st + ja, n - ja, 2 * (col0 + kCols - 1) + 1);
      for (int j0 = ja + part; j0 < jb; j0 += 15 * p.split) {
        // nibble counters: meth / unmeth of the even columns, of the odd ones
        uint32_t a0 = 0, a1 = 0, a2 = 0, a3 = 0;
        const int j1 = min(j0 + 15 * p.split, jb);
        for (int j = j0; j < j1; j += p.split) {
          const int s = st[j];
          const int off = col0 - (s >> 1);  // the row's code under col0
          const int lo = max(off, 0);
          const int at = coff + j * p.Lq + (lo >> 2);
          const uint32_t* wp =
              reinterpret_cast<const uint32_t*>(buf + (at & ~3));
          // codes lo .. lo+15 of the row, code lo in bits 0-1
          uint32_t w =
              __funnelshift_r(wp[0], wp[1], 8 * (at & 3) + 2 * (lo & 3));
          const int left = Lc - lo;  // codes of the row from lo on
          if (left < kCols) w &= (1u << (2 * left)) - 1u;
          w <<= 2 * (lo - off);  // a row that starts inside the 16 columns
          w &= (s & 1) ? cmask : gmask;
          const uint32_t three = w & (w >> 1) & 0x55555555u;
          w ^= three | (three << 1);  // code 3 counts nowhere
          a0 += w & 0x11111111u;
          a1 += (w >> 1) & 0x11111111u;
          a2 += (w >> 2) & 0x11111111u;
          a3 += (w >> 3) & 0x11111111u;
        }
#pragma unroll
        for (int k = 0; k < kCols / 2; ++k) {
          cm[2 * k] += (a0 >> (4 * k)) & 15u;
          cu[2 * k] += (a1 >> (4 * k)) & 15u;
          cm[2 * k + 1] += (a2 >> (4 * k)) & 15u;
          cu[2 * k + 1] += (a3 >> (4 * k)) & 15u;
        }
      }
    }
    __syncthreads();  // the buffer is free for the copy of chunk c + 1
  }
  // the sums of the lanes that share the columns (every lane of the warp
  // takes part), stored by the first of them
  for (int m = 1; m < p.split; m <<= 1) {
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      cm[k] += __shfl_xor_sync(0xFFFFFFFFu, cm[k], m);
      cu[k] += __shfl_xor_sync(0xFFFFFFFFu, cu[k], m);
    }
  }
  if (!counts || part != 0) return;  // nothing kept: the zeros stand
  bool over = false;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    cm[k] = clamp_flag(cm[k], p.cap, over);
    cu[k] = clamp_flag(cu[k], p.cap, over);
  }
  if (over) atomicOr(p.overflow, 1);
  OutT* out = static_cast<OutT*>(p.out);
  if (p.dst == nullptr && p.vec_store) {
    store16(out + col0, cm);
    store16(out + static_cast<size_t>(p.out_stride) + col0, cu);
    return;
  }
  const uint32_t kept = cmask | gmask;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    if ((kept >> (2 * k)) & 1u) {
      const int slot = p.dst == nullptr ? col0 + k : p.dst[col0 + k];
      out[slot] = static_cast<OutT>(cm[k]);
      out[static_cast<size_t>(p.out_stride) + slot] = static_cast<OutT>(cu[k]);
    }
  }
}

template <typename OutT>
int launch(Params p, uint32_t cap, cudaStream_t s) {
  p.cap = cap;
  p.code_cap = region_bytes(p.chunk_rows * p.Lq);
  p.spos_cap = region_bytes(p.chunk_rows * 4);
  const int smem = p.code_cap + p.spos_cap;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = pileup2_kernel<OutT>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const size_t row = static_cast<size_t>(p.out_stride) * sizeof(OutT);
  p.vec_store = reinterpret_cast<uintptr_t>(p.out) % 16 == 0 && row % 16 == 0;
  p.vec_dst = reinterpret_cast<uintptr_t>(p.dst) % 16 == 0;
  kernel<<<dim3(p.ntiles), dim3(kT / kCols * p.split), smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns the CUDA error of the launch (0 =
// launched). `out` must be zeroed. split (lanes that share sixteen columns:
// 1, 2, 4, 8 or 16) and chunk_rows (rows staged at a time) <= 0 pick the
// defaults from the mean row density Nb / W: the split that leaves a lane
// about 20 rows of a run, and a chunk of 1.5 times the rows that reach a
// tile (at least 64). The kernel is right for any choice; the defaults only
// size it for even coverage.
extern "C" int mdtpu_pileup2(const void* seqpack, const void* spos,
                             const void* tlo, const void* thi,
                             const void* isc, const void* isg,
                             const void* dst, void* out, void* overflow,
                             int ntiles, int Nb, int Lq, int chunk_rows,
                             int W, int out_stride, int sat_bits, int split,
                             void* stream) {
  if (Lq < 1 || split > kMaxSplit || (split > 0 && (split & (split - 1)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ntiles <= 0) return static_cast<int>(cudaGetLastError());
  const float density = static_cast<float>(Nb) / static_cast<float>(W);
  if (split <= 0) {
    // the largest power of two that leaves a lane about kRowsPerLane rows
    const float per_group = density * static_cast<float>(4 * Lq + kCols - 1);
    split = 1;
    while (split < 8 && per_group >= 1.5f * split * kRowsPerLane) split *= 2;
  }
  if (chunk_rows <= 0) {
    const float per_tile = density * static_cast<float>(kT + 4 * Lq);
    chunk_rows = (static_cast<int>(kChunkSlack * per_tile) + 7) & ~7;
    chunk_rows = chunk_rows < 64 ? 64 : chunk_rows;
  }
  // the buffer's two regions must fit a block's shared memory
  const int fit = (kMaxSmem - 96) / (Lq + 4);
  if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (chunk_rows > fit) chunk_rows = fit;
  Params p{};
  p.seqpack = static_cast<const uint8_t*>(seqpack);
  p.spos = static_cast<const int32_t*>(spos);
  p.tlo = static_cast<const int32_t*>(tlo);
  p.thi = static_cast<const int32_t*>(thi);
  p.isc = static_cast<const uint8_t*>(isc);
  p.isg = static_cast<const uint8_t*>(isg);
  p.dst = static_cast<const int32_t*>(dst);
  p.out = out;
  p.overflow = static_cast<int32_t*>(overflow);
  p.ntiles = ntiles;
  p.Nb = Nb;
  p.Lq = Lq;
  p.chunk_rows = chunk_rows;
  p.W = W;
  p.out_stride = out_stride;
  p.split = split;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sat_bits) {
    case 8:
      return launch<uint8_t>(p, 0xFFu, s);
    case 16:
      return launch<uint16_t>(p, 0xFFFFu, s);
    case 32:
      return launch<uint32_t>(p, 0xFFFFFFFFu, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
