// Flash-attention forward for Hopper (sm_90a), bf16 in / bf16 out, D = 64.
//
// Replaces the Pallas TPU kernel `_flash_kernel` (recondet3d/ops/attention.py:54).
// Computes, per (batch*head) and query row, online-softmax attention over all
// keys (or the first kv_len[b] keys), plus the row logsumexp:
//   qs  = bf16(q * scale)                      (scale folded into q in fp32)
//   s   = qs k^T                               (bf16 x bf16 -> fp32)
//   p   = exp(s - m), l = sum(p) in fp32
//   out = bf16( (bf16(p) v) / l ),  lse = m + log(l)
//
// Bound on an H100: 4*N*M*D operations over ~2*(N+M)*D*2 bytes per head is
// hundreds of operations per byte at N = 721 / 4326, so the tensor cores bound
// it. The (N, M) scores never reach device memory: one CTA (4 warps) owns 64
// query rows, each warp 16 rows whose Q fragments stay in registers; 64-key K/V
// tiles stream through double-buffered shared memory (cp.async, the next tile in
// flight while the current one is used); both products run on
// mma.sync.m16n8k16 with fp32 accumulators; the S accumulator is re-packed in
// registers as the A operand of PV. Rows beyond N and keys beyond M or kv_len
// are masked here; the host pads nothing. Shared rows are padded to 72 bf16
// (144 B) so ldmatrix reads are free of bank conflicts.
//
// C interface for ctypes: returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 64;
constexpr int BLOCK_M = 64;  // query rows per CTA, 16 per warp
constexpr int BLOCK_N = 64;  // keys per K/V tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int SROW = D + 8;  // padded shared-memory row, in bf16
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  // src_bytes = 0 fills the 16 destination bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
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

// rows [row0, row0 + BLOCK_N) of a (rows, D) matrix into a padded shared tile;
// rows >= nrows are zero-filled
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int row0, int nrows) {
#pragma unroll
  for (int c = threadIdx.x; c < BLOCK_N * (D / 8); c += NTHREADS) {
    const int r = c / (D / 8), ch = c % (D / 8);
    const int gr = row0 + r;
    const bool ok = gr < nrows;
    const bf16* src = g + (size_t)(ok ? gr : 0) * D + ch * 8;
    cp_async_16(smem_u32(s + r * SROW + ch * 8), src, ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                     const int* __restrict__ kv_len, bf16* __restrict__ out, float* __restrict__ lse, int H,
                     int N, int M, float scale) {
  __shared__ __align__(128) bf16 Ks[2][BLOCK_N * SROW];
  __shared__ __align__(128) bf16 Vs[2][BLOCK_N * SROW];

  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * BLOCK_M;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qo = (size_t)bh * N * D;
  const size_t ko = (size_t)bh * M * D;
  const int kv_lim = kv_len ? min(M, max(kv_len[bh / H], 0)) : M;
  const int n_blocks = (kv_lim + BLOCK_N - 1) / BLOCK_N;

  // first K/V tile in flight while Q is read
  if (n_blocks > 0) {
    load_tile(Ks[0], k + ko, 0, M);
    load_tile(Vs[0], v + ko, 0, M);
  }
  cp_async_commit();

  // Q A-fragments for this warp's 16 rows, pre-scaled and rounded to bf16:
  // qf[kk] covers head dims 16kk..16kk+15; a0/a2 row g, a1/a3 row g+8
  const int r0 = m0 + warp * 16 + g, r1 = r0 + 8;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = (i & 1) ? r1 : r0;
      const int col = kk * 16 + (i >> 1) * 8 + 2 * t;
      float2 f = make_float2(0.f, 0.f);
      if (row < N) f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(q + qo + (size_t)row * D + col));
      qf[kk][i] = pack_bf16(f.x * scale, f.y * scale);
    }
  }

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};  // per-thread partial row sums, reduced at the end

  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix index, row within it

  for (int j = 0; j < n_blocks; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_blocks) {
      load_tile(Ks[buf ^ 1], k + ko, (j + 1) * BLOCK_N, M);
      load_tile(Vs[buf ^ 1], v + ko, (j + 1) * BLOCK_N, M);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Qs K^T: 16 rows x 64 keys per warp, as 8 n-tiles of 8 keys
    float s[BLOCK_N / 8][4];
#pragma unroll
    for (int i = 0; i < BLOCK_N / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    const bf16* kb = Ks[buf];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < BLOCK_N / 16; ++np) {
        uint32_t b0, b1, b2, b3;
        const int key = np * 16 + (mi >> 1) * 8 + mr;
        const int col = kk * 16 + (mi & 1) * 8;
        ldmatrix_x4(smem_u32(kb + key * SROW + col), b0, b1, b2, b3);
        mma_bf16(s[2 * np], qf[kk], b0, b1);
        mma_bf16(s[2 * np + 1], qf[kk], b2, b3);
      }
    }

    const int kbase = j * BLOCK_N;
    if (kbase + BLOCK_N > kv_lim) {
#pragma unroll
      for (int nt = 0; nt < BLOCK_N / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kbase + nt * 8 + 2 * t + (e & 1) >= kv_lim) s[nt][e] = NEG_INF;
    }

    // online softmax; the 4 threads of a quad share rows g and g+8
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = __expf(m_r[i] - mx[i]);
      m_r[i] = mx[i];
    }
#pragma unroll
    for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
      s[nt][0] = __expf(s[nt][0] - m_r[0]);
      s[nt][1] = __expf(s[nt][1] - m_r[0]);
      s[nt][2] = __expf(s[nt][2] - m_r[1]);
      s[nt][3] = __expf(s[nt][3] - m_r[1]);
      rs[0] += s[nt][0] + s[nt][1];
      rs[1] += s[nt][2] + s[nt][3];
    }
    l_r[0] = l_r[0] * alpha[0] + rs[0];
    l_r[1] = l_r[1] * alpha[1] + rs[1];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }

    // O += bf16(P) V: P's accumulator layout is the A-fragment layout
    const bf16* vb = Vs[buf];
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                       pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                       pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b0, b1, b2, b3;
        const int key = kk * 16 + (mi & 1) * 8 + mr;
        const int col = dp * 16 + (mi >> 1) * 8;
        ldmatrix_x4_trans(smem_u32(vb + key * SROW + col), b0, b1, b2, b3);
        mma_bf16(o[2 * dp], a, b0, b1);
        mma_bf16(o[2 * dp + 1], a, b2, b3);
      }
    }
    __syncthreads();  // buffer `buf` is refilled at iteration j + 1
  }

  float inv[2], lse_v[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    const float l = fmaxf(l_r[i], 1e-30f);
    inv[i] = 1.f / l;
    lse_v[i] = m_r[i] + logf(l);
  }
  if (r0 < N) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + qo + (size_t)r0 * D + 2 * t);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) dst[nt * 4] = pack_bf16(o[nt][0] * inv[0], o[nt][1] * inv[0]);
    if (t == 0) lse[(size_t)bh * N + r0] = lse_v[0];
  }
  if (r1 < N) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + qo + (size_t)r1 * D + 2 * t);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) dst[nt * 4] = pack_bf16(o[nt][2] * inv[1], o[nt][3] * inv[1]);
    if (t == 0) lse[(size_t)bh * N + r1] = lse_v[1];
  }
}

}  // namespace

extern "C" int flash_attn_fwd_bf16_d64(const void* q, const void* k, const void* v, const void* kv_len, void* out,
                                       void* lse, int B, int H, int N, int M, float scale, void* stream) {
  const dim3 grid((N + BLOCK_M - 1) / BLOCK_M, B * H);
  flash_fwd_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(kv_len), static_cast<bf16*>(out), static_cast<float*>(lse), H, N, M, scale);
  return static_cast<int>(cudaGetLastError());
}
