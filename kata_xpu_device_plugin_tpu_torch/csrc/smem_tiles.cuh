// Shared-memory tiles for the warpgroup products of csrc/flash_fwd.cu and
// csrc/flash_bwd.cu (sm_90a): the 16-byte cp.async copies that fill a ring
// of tiles, the 128-byte-swizzled tile layout that wgmma's descriptors
// read, the descriptors themselves, and the step from a product's fp32
// accumulators to the bf16 A fragments of the next product.
//
// Tile layout: a [ROWS, D] bf16 tile is D / 64 column blocks of ROWS x 128
// bytes (64 bf16 a row); 16-byte chunk c of row r is stored at chunk
// c ^ (r % 8) of its 128-byte row, the layout wgmma's 128-byte swizzle
// reads (and TMA's would write), so neither the copies nor the products
// meet bank conflicts. A tile's base is 1 KB aligned (the swizzle's
// period).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tiles {

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's completed copies visible to the products, which read
// shared memory through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk c of row r in a swizzled tile of ROWS rows.
template <int ROWS>
__device__ __forceinline__ uint32_t chunk_offset(int r, int c) {
  return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// Rows row0 .. row0+ROWS-1 of a strided [S, D] slice into a [ROWS, D] tile
// at `dst` (1 KB aligned), in the swizzled layout above; rows at or past
// `limit` are zeros. NT threads copy.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* base,
                                          long long row_stride, int row0,
                                          int limit, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int j = 0; j < ROWS * CH / NT; ++j) {
    const int i = tid + j * NT;
    const int r = i / CH, c = i % CH;
    const bool in = row0 + r < limit;
    const __nv_bfloat16* src =
        base + static_cast<long long>(in ? row0 + r : 0) * row_stride + c * 8;
    cp_async16(dst + chunk_offset<ROWS>(r, c), src, in ? 16 : 0);
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(sbo) << 32) | (1ull << 62);
}

// K-major operand: the rows of a tile of ROWS rows, columns 16 kk .. 16 kk
// + 15 (8 rows of 128 bytes 1 KB apart; a step inside the 128-byte row
// moves the start by 32 bytes, and the hardware applies the swizzle).
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return make_desc(tile + (kk >> 2) * (ROWS * 128) + (kk & 3) * 32, 1, 64);
}

// MN-major operand: rows 16 kk .. 16 kk + 15 of a tile of ROWS rows as the
// K dimension, all D columns as N (column blocks ROWS x 128 bytes apart,
// 8-row groups 1 KB apart).
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return make_desc(tile + kk * 2048, ROWS * 8, 64);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments of a [64, 16 KS] product's accumulators, rounded to bf16:
// k-step ks covers columns 16 ks .. 16 ks + 15, i.e. n8 blocks 2 ks, 2 ks + 1.
template <int KS>
__device__ __forceinline__ void to_frags(const float (&x)[8 * KS],
                                         uint32_t (&f)[KS][4]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    f[ks][0] = pack_f32(x[8 * ks + 0], x[8 * ks + 1]);
    f[ks][1] = pack_f32(x[8 * ks + 2], x[8 * ks + 3]);
    f[ks][2] = pack_f32(x[8 * ks + 4], x[8 * ks + 5]);
    f[ks][3] = pack_f32(x[8 * ks + 6], x[8 * ks + 7]);
  }
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

}  // namespace tiles
