// Hopper (sm_90a) building blocks of the flash-attention forward and dK/dV
// kernels: TMA tensor maps of (rows, D) bf16 matrices read in 64-column chunks,
// mbarrier waits and arrivals, TMA tile loads, 4-byte cp.async copies that
// arrive on an mbarrier, wgmma descriptors of 128-byte-swizzled tiles and the
// three wgmma shapes the kernels issue, fences, named barriers and setmaxnreg.
//
// Tiles in shared memory are rows of 64 bf16 = 128 bytes, written by TMA under
// CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte chunk c of row r sits at chunk
// c ^ (r % 8), and eight rows make one 1,024-byte swizzle atom. Every tile
// starts on a 1,024-byte boundary. A wgmma descriptor of such a tile has
// layout type 1 (128-byte swizzle) and 1,024 bytes between 8-row groups;
// a 16-wide step along the 128-byte row (K-major operand) adds 32 bytes to the
// start address, a 16-row step (MN-major operand, transpose bit set) 2,048.
// A head dim D > 64 is held as ceil(D / 64) such tiles, one per 64-column
// chunk: chunk c holds columns [64 c, 64 c + 64) and is loaded by a box at
// column coordinate 64 c.
//
// Tensor maps are built on the host with cuTensorMapEncodeTiled, found
// through cudaGetDriverEntryPoint, so the libraries need no -lcuda. They are
// 3-D (D, rows, matrices): a box that runs past one matrix's last row reads
// zeros, never the next matrix's rows, and a box that runs past column D
// reads zeros, never the next row's first columns. Zero columns add nothing to
// q . k, and the kernels store no output column >= D, so a chunk that is
// partly past D is exact. TMA takes a global row stride that is a multiple of
// 16 bytes: D must be a multiple of 8 (ops/attention.py pads other D).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace hopper {

typedef __nv_bfloat16 bf16;

constexpr int ROW_BYTES = 128;  // one row of a tile in shared memory: 64 bf16
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------- host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// `matrices` (rows, cols) bf16 matrices one after another from `base`, read in
// boxes of box_rows x 64 (cols a multiple of 8, 64 by default); returns a
// cudaError_t value (0 on success)
static int make_row_map(CUtensorMap* map, const void* base, int rows, int matrices, int box_rows, int cols = 64) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return static_cast<int>(cudaErrorNotSupported);
  if (cols < 1 || cols % 8) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(cols) * sizeof(bf16);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(matrices)};
  const cuuint64_t strides[2] = {row_bytes, static_cast<cuuint64_t>(rows) * row_bytes};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
                        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// lets `kernel` take `bytes` (> 48 KB) of dynamic shared memory on the current
// device; the attribute holds for the process, so each device (a bit of
// `devices`) sets it once; returns a cudaError_t value (0 on success)
template <typename Kernel>
static int allow_dynamic_smem(Kernel kernel, int bytes, std::atomic<uint32_t>& devices) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint32_t bit = 1u << (dev % 32);
  if (devices.load(std::memory_order_acquire) & bit) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) devices.fetch_or(bit, std::memory_order_release);
  return static_cast<int>(err);
}

// the one-dimensional grid of ceil(rows / tile) tiles for each of `heads` heads (B*H folded into grid.x,
// the tile index fastest, so there is no 65,535 limit of grid.y); 0 if it exceeds grid.x's 2^31 - 1
static unsigned grid_1d(int rows, int tile, int heads) {
  const long long n = static_cast<long long>((rows + tile - 1) / tile) * heads;
  return n >= 1 && n <= 0x7fffffffLL ? static_cast<unsigned>(n) : 0u;
}

// -------------------------------------------------------------- device side

// blockIdx.x read afresh: a value the compiler may not keep live across a kernel's main loop (an epilogue
// that needs its CTA's place recomputes it from here instead of holding registers that would spill)
__device__ __forceinline__ unsigned ctaid_x() {
  unsigned r;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1,024-byte boundary at or after p (dynamic shared memory is asked for 1,024 bytes more)
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// makes the initialised barriers visible to the other threads and to the TMA unit
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// waits until the phase of parity `parity` has completed; a wait that outlasts
// 2^28 polls (tens of seconds at least) can only be a deadlock and traps, so a
// fault ends the launch with an error instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also tells the barrier to wait for `bytes` from TMA copies
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// columns [col, col + 64) of rows [row, row + box_rows) of matrix `matrix` of a row map into `dst`;
// completes the box's bytes on `bar` (zeros included)
__device__ __forceinline__ void tma_load_box(void* dst, const CUtensorMap* map, uint64_t* bar, int col, int row,
                                             int matrix) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(matrix)
      : "memory");
}

// the first 64 columns of rows [row, row + box_rows) of matrix `matrix`
__device__ __forceinline__ void tma_load_rows(void* dst, const CUtensorMap* map, uint64_t* bar, int row, int matrix) {
  tma_load_box(dst, map, bar, 0, row, matrix);
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// 4 bytes global -> shared; src_bytes = 0 writes a zero
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

// one arrival on `bar` once this thread's earlier cp.async copies have landed
// (noinc: the barrier's expected count includes it)
__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> bf16x2, `lo` in the low half (the lower column index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// descriptor of a 128-byte-swizzled tile at shared address `addr` (1,024-aligned
// or advanced from such a base along the row); both byte offsets 1,024: the
// stride between 8-row groups, and for an MN-major operand of 64 columns the
// unused stride between swizzle atoms along MN
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  const uint32_t addr = smem_u32(tile);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}
// descriptor offsets, in 16-byte units: a 16-column step along a row, a 16-row step
constexpr uint64_t DESC_K16_COLS = 32 >> 4;
constexpr uint64_t DESC_K16_ROWS = (16 * ROW_BYTES) >> 4;

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of registers a wgmma writes across its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Accumulator layout of m64nNk16 (fp32, thread t of the warpgroup, warp w = t / 32,
// g = (t % 32) / 4, c = t % 4): d[4i + e] holds row 16w + g + 8 * (e / 2) and
// column 8i + 2c + (e % 2). A operand from registers (m64nNk16, bf16): a[0..3] as
// the A fragment of mma.m16n8k16 for the warp's 16 rows, so two neighbouring n8
// blocks of an accumulator, rounded to bf16, are one A operand.

#define HOPPER_ACC8(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
    "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128) (+)= A (64 x 16, shared, K-major) * B (16 x 128, shared, K-major)
__device__ __forceinline__ void wgmma_m64n128_ss(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_ACC8(d, 0), HOPPER_ACC8(d, 8), HOPPER_ACC8(d, 16), HOPPER_ACC8(d, 24), HOPPER_ACC8(d, 32),
        HOPPER_ACC8(d, 40), HOPPER_ACC8(d, 48), HOPPER_ACC8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64) (+)= A (64 x 16, shared, K-major) * B (16 x 64, shared, K-major)
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_ACC8(d, 0), HOPPER_ACC8(d, 8), HOPPER_ACC8(d, 16), HOPPER_ACC8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64) (+)= A (64 x 16, registers) * B (16 x 64, shared, MN-major: the
// transpose bit is set, B's rows are the 16 reduction rows)
__device__ __forceinline__ void wgmma_m64n64_rs_bt(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_ACC8(d, 0), HOPPER_ACC8(d, 8), HOPPER_ACC8(d, 16), HOPPER_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

#undef HOPPER_ACC8

// the A operands of a product over 16 * K columns of an fp32 accumulator, rounded to bf16
template <int K>
__device__ __forceinline__ void pack_a(uint32_t (&a)[K][4], const float (&d)[K * 8]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    a[kk][0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
    a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// rows g and g + 8 of a warp's 16 rows of a 64 x 64 accumulator, times `mul`, as bf16 into rows row0 and
// row0 + 8 of columns [col0, col0 + 64) of a (nrows, pitch) matrix; with EDGE, columns >= ncols (a multiple of 8)
// are not stored
template <bool EDGE>
__device__ __forceinline__ void store_acc_chunk(bf16* m, const float (&d)[32], int row0, int nrows, int c, float mul,
                                                int pitch, int col0, int ncols) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row < nrows) {
      uint32_t* dst = reinterpret_cast<uint32_t*>(m + static_cast<size_t>(row) * pitch + col0 + 2 * c);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (!EDGE || col0 + 8 * i < ncols) dst[4 * i] = pack_bf16(d[4 * i + 2 * h] * mul, d[4 * i + 2 * h + 1] * mul);
    }
  }
}

// the same into a (nrows, 64) matrix
__device__ __forceinline__ void store_acc_rows(bf16* m, const float (&d)[32], int row0, int nrows, int c, float mul) {
  store_acc_chunk<false>(m, d, row0, nrows, c, mul, 64, 0, 64);
}

}  // namespace hopper
