// Building blocks shared by the flash-attention kernels (forward and backward)
// for Hopper (sm_90a): bf16 tiles of 64 rows x D = 64 in padded shared memory,
// cp.async tile loads, ldmatrix fragment loads and mma.sync.m16n8k16 products
// with fp32 accumulators. One CTA is 4 warps; a warp owns 16 rows of a tile.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16): a0 (row g, cols 2t..2t+1), a1 (row g+8, same cols),
//                a2 (row g, cols 2t+8..2t+9), a3 (row g+8, same cols)
//   C (16 x 8):  c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same cols)
// so two neighbouring C tiles, rounded to bf16, are one A fragment: a product's
// result feeds the next product without leaving registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 64;
constexpr int TILE = 64;  // rows of a shared-memory tile (queries or keys)
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int SROW = D + 8;  // padded shared-memory row, in bf16: ldmatrix reads are free of bank conflicts
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  // src_bytes = 0 fills the 16 destination bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col); bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2, `lo` in the low half (the lower column index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + TILE) of a (nrows, D) matrix into a padded shared tile;
// rows >= nrows are zero-filled
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int row0, int nrows) {
#pragma unroll
  for (int c = threadIdx.x; c < TILE * (D / 8); c += NTHREADS) {
    const int r = c / (D / 8), ch = c % (D / 8);
    const int gr = row0 + r;
    const bool ok = gr < nrows;
    const bf16* src = g + (size_t)(ok ? gr : 0) * D + ch * 8;
    cp_async_16(smem_u32(s + r * SROW + ch * 8), src, ok ? 16 : 0);
  }
}

// A fragments of rows r0 (= base + g) and r1 (= r0 + 8) of a (nrows, D) matrix
// in device memory, each value times `mul` in fp32 and rounded to bf16; rows
// >= nrows read as zero. f[kk] covers columns 16kk..16kk+15.
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[D / 16][4], const bf16* m, int r0, int r1, int nrows,
                                             int t, float mul) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = (i & 1) ? r1 : r0;
      const int col = kk * 16 + (i >> 1) * 8 + 2 * t;
      float2 v = make_float2(0.f, 0.f);
      if (row < nrows) v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(m + (size_t)row * D + col));
      f[kk][i] = pack_bf16(v.x * mul, v.y * mul);
    }
  }
}

// acc (16 x TILE; column = row of the tile) += A (16 x D) * tile^T
__device__ __forceinline__ void mma_a_bt(float (&acc)[TILE / 8][4], const uint32_t (&a)[D / 16][4],
                                         const bf16* tile, int lane) {
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix index, row within it
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < TILE / 16; ++np) {
      uint32_t b0, b1, b2, b3;
      const int row = np * 16 + (mi >> 1) * 8 + mr;
      const int col = kk * 16 + (mi & 1) * 8;
      ldmatrix_x4(smem_u32(tile + row * SROW + col), b0, b1, b2, b3);
      mma_bf16(acc[2 * np], a[kk], b0, b1);
      mma_bf16(acc[2 * np + 1], a[kk], b2, b3);
    }
  }
}

// acc (16 x D) += bf16(P) (16 x TILE in accumulator layout; column = row of the
// tile) * tile (TILE x D): P's accumulator layout re-packs into A fragments
__device__ __forceinline__ void mma_p_b(float (&acc)[D / 8][4], const float (&p)[TILE / 8][4], const bf16* tile,
                                        int lane) {
  const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]), pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b0, b1, b2, b3;
      const int row = kk * 16 + (mi & 1) * 8 + mr;
      const int col = dp * 16 + (mi >> 1) * 8;
      ldmatrix_x4_trans(smem_u32(tile + row * SROW + col), b0, b1, b2, b3);
      mma_bf16(acc[2 * dp], a, b0, b1);
      mma_bf16(acc[2 * dp + 1], a, b2, b3);
    }
  }
}

// rows r0 and r1 of a 16 x D accumulator, times `mul`, to a (nrows, D) bf16 matrix
__device__ __forceinline__ void store_rows(bf16* m, const float (&acc)[D / 8][4], int r0, int r1, int nrows, int t,
                                           float mul) {
  if (r0 < nrows) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(m + (size_t)r0 * D + 2 * t);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) dst[nt * 4] = pack_bf16(acc[nt][0] * mul, acc[nt][1] * mul);
  }
  if (r1 < nrows) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(m + (size_t)r1 * D + 2 * t);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) dst[nt * 4] = pack_bf16(acc[nt][2] * mul, acc[nt][3] * mul);
  }
}

}  // namespace
