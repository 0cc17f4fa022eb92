// Attention forward in fp32 for Hopper (sm_90a): the fp32 instance of the
// Pallas TPU kernel `_flash_kernel` (recondet3d/ops/attention.py:54), which the
// JAX package runs in fp32 for the camera encoder's trunk (CameraEnc: 16 heads
// of dim_out / 16, so D = 24, 48, 64 or 96 from da3-small to da3-giant).
//
// Computes, per (batch*head) and query row, softmax(q k^T * scale) v and the
// row logsumexp in fp32, as ops/attention.py attention_plain does:
//   s   = (q . k) * scale        fp32 products and sums (no tensor cores, no TF32)
//   s   = -1e30 for keys >= kv_len[b]
//   out = sum(exp(s - m) v) / sum(exp(s - m)),   lse = m + log(sum(exp(s - m)))
// with an online softmax over key tiles (expf, as the plain version has it).
//
// What bounds it on an H100: at the CameraEnc shapes (B, 16, 6, D) it is a few
// thousand operations a head, far below one microsecond of the card's fp32
// rate or of its memory rate: the launch is the cost. At long sequences it
// does 4*N*M*D fp32 operations on the CUDA cores (67 TFLOP/s). The design is
// the simple one:
//   - one CTA of 8 warps per (b*h, 8 query rows), one warp a row (at the
//     camera encoder's 6 views a CTA of 64 rows would score 58 rows of
//     padding one after another); the CTA's q rows sit in shared memory;
//   - K and V come through shared memory in tiles of 64 keys (rows padded to
//     D + 1 floats, so that 32 lanes reading 32 keys' column d hit 32 banks);
//   - lane j scores keys j and j + 32 of the tile with four partial sums (a
//     single chain of D dependent FMAs was the kernel's latency), the warp
//     reduces the tile's maximum and sum with shuffles, and lane j
//     accumulates output columns j, j + 32, j + 64, j + 96.
// D is any multiple of 8 up to 128; N and M are any length >= 1.
//
// C interface for ctypes: returns a cudaError_t value (0 on success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int NWARPS = 8;
constexpr int BLOCK_M = NWARPS;  // query rows per CTA: one a warp
constexpr int BLOCK_N = 64;      // keys per shared-memory tile
constexpr int NTHREADS = 32 * NWARPS;
constexpr int MAX_D = 128;
constexpr int COLS = MAX_D / 32;  // output columns a lane owns
constexpr float MASKED = -1e30f;  // attention_plain's logit of a key >= kv_len

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(NTHREADS)
    attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                    const int* __restrict__ kv_len, float* __restrict__ out, float* __restrict__ lse, int H, int N,
                    int M, int D, float scale) {
  extern __shared__ float smem[];
  const int DP = D + 1;  // padded row of K and V
  float* qs = smem;                  // BLOCK_M x D
  float* ks = qs + BLOCK_M * D;      // BLOCK_N x DP
  float* vs = ks + BLOCK_N * DP;     // BLOCK_N x DP

  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * BLOCK_M;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kv_lim = kv_len ? min(M, max(kv_len[bh / H], 0)) : M;
  // with no key left every logit is -1e30, and the plain softmax is uniform over all M keys
  const int n_keys = kv_lim > 0 ? kv_lim : M;
  const float* q_bh = q + static_cast<size_t>(bh) * N * D;
  const float* k_bh = k + static_cast<size_t>(bh) * M * D;
  const float* v_bh = v + static_cast<size_t>(bh) * M * D;

  for (int i = threadIdx.x; i < BLOCK_M * D; i += NTHREADS) {
    const int r = m0 + i / D;
    qs[i] = r < N ? q_bh[static_cast<size_t>(r) * D + i % D] : 0.f;
  }

  const float* qrow = qs + warp * D;
  float m_r = -INFINITY, l_r = 0.f, acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.f;

  for (int kb = 0; kb < n_keys; kb += BLOCK_N) {
    __syncthreads();  // the previous tile is no longer read (and, at kb = 0, q is written)
    // only the keys that count are staged: the scores of the rows past them are discarded below (-inf)
    const int kend = min(BLOCK_N, n_keys - kb);  // keys of this tile that count
    for (int i = threadIdx.x; i < kend * D; i += NTHREADS) {
      const int j = i / D, d = i % D;
      const size_t at = static_cast<size_t>(kb + j) * D + d;
      ks[j * DP + d] = k_bh[at];
      vs[j * DP + d] = v_bh[at];
    }
    __syncthreads();
    float s[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
      const float* krow = ks + j * DP;
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      for (int d = 0; d < D; d += 4) {  // D is a multiple of 8; q rows are 16-byte aligned
        const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
        part[0] = fmaf(qv.x, krow[d], part[0]);
        part[1] = fmaf(qv.y, krow[d + 1], part[1]);
        part[2] = fmaf(qv.z, krow[d + 2], part[2]);
        part[3] = fmaf(qv.w, krow[d + 3], part[3]);
      }
      const float dot = (part[0] + part[1]) + (part[2] + part[3]);
      s[h] = j >= kend ? -INFINITY : (kb + j < kv_lim ? dot * scale : MASKED);
    }
    const float m_new = fmaxf(m_r, warp_max(fmaxf(s[0], s[1])));
    const float alpha = expf(m_r - m_new);  // 0 on the first tile (m_r = -inf)
    const float p0 = expf(s[0] - m_new), p1 = expf(s[1] - m_new);
    l_r = l_r * alpha + warp_sum(p0 + p1);
    m_r = m_new;
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[c] *= alpha;
    for (int j = 0; j < kend; ++j) {
      const float p = __shfl_sync(0xffffffffu, j < 32 ? p0 : p1, j % 32);
      const float* vrow = vs + j * DP;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int d = lane + 32 * c;
        if (d < D) acc[c] = fmaf(p, vrow[d], acc[c]);
      }
    }
  }

  const int row = m0 + warp;
  if (row >= N) return;
  const float inv = 1.f / l_r;
  float* orow = out + (static_cast<size_t>(bh) * N + row) * D;
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int d = lane + 32 * c;
    if (d < D) orow[d] = acc[c] * inv;
  }
  if (lane == 0) lse[static_cast<size_t>(bh) * N + row] = m_r + logf(l_r);
}

}  // namespace

// q (B*H, N, D), k and v (B*H, M, D): contiguous fp32; kv_len (B,) int32 or null;
// out (B*H, N, D) fp32, lse (B*H, N) fp32; scale multiplies q . k
extern "C" int attn_fwd_f32(const void* q, const void* k, const void* v, const void* kv_len, void* out, void* lse,
                            int B, int H, int N, int M, int D, float scale, void* stream) {
  if (D < 8 || D > MAX_D || D % 8 || N < 1 || M < 1 || B * H < 1 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(float)) * (BLOCK_M * D + 2 * BLOCK_N * (D + 1));
  static std::atomic<uint32_t> smem_allowed{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint32_t bit = 1u << (dev % 32);
  if (!(smem_allowed.load(std::memory_order_acquire) & bit)) {
    const int most = static_cast<int>(sizeof(float)) * (BLOCK_M * MAX_D + 2 * BLOCK_N * (MAX_D + 1));
    err = cudaFuncSetAttribute(attn_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed.fetch_or(bit, std::memory_order_release);
  }
  const dim3 grid((N + BLOCK_M - 1) / BLOCK_M, B * H);
  attn_f32_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(kv_len), static_cast<float*>(out), static_cast<float*>(lse), H, N, M, D, scale);
  return static_cast<int>(cudaGetLastError());
}
