// Device helpers shared by the pileup kernels (pileup2.cu, pileup4.cu): the
// cp.async staging of a contiguous byte range into shared memory, and the
// search over staged, ascending row starts.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace staging {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Offset in a staging region of the byte at global address a.
__device__ __forceinline__ int stage_offset(const uint8_t* a) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(a) & 15);
}

// Stage bytes [begin, end) of the array base[0, total) into the 16-byte
// aligned region dst, byte `begin` landing at dst[stage_offset(base+begin)]:
// the `nthreads` threads of the block share the 16-byte cp.async pieces of
// the aligned superset; a piece that is not wholly inside the array is copied
// byte by byte (only the wanted bytes), so nothing outside the array is read.
__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* base,
                                      size_t total, size_t begin, size_t end,
                                      int nthreads) {
  const uintptr_t lo = reinterpret_cast<uintptr_t>(base);
  const uintptr_t hi = lo + total;
  const uintptr_t a = lo + begin;
  const uintptr_t e = lo + end;
  const uintptr_t a0 = a & ~static_cast<uintptr_t>(15);
  const int pieces = static_cast<int>((e - a0 + 15) >> 4);
  for (int i = threadIdx.x; i < pieces; i += nthreads) {
    const uintptr_t g = a0 + 16 * static_cast<uintptr_t>(i);
    if (g >= lo && g + 16 <= hi) {
      cp_async16(dst + 16 * i, reinterpret_cast<const void*>(g));
    } else {
      for (int b = 0; b < 16; ++b) {
        if (g + b >= a && g + b < e) {
          dst[16 * i + b] = *reinterpret_cast<const uint8_t*>(g + b);
        }
      }
    }
  }
}

// First j in [0, n) with st[j] > v (n when there is none); st ascending.
__device__ __forceinline__ int first_above(const int32_t* st, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (st[mid] > v) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// Bytes of a staging region for n_bytes of rows: the rows, up to 15 bytes of
// offset in front and up to 15 of the last piece behind.
inline int region_bytes(int n_bytes) { return ((n_bytes + 15) & ~15) + 32; }

}  // namespace staging
