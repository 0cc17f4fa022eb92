// Flash-attention backward for Hopper (sm_90a), bf16 in / bf16 out, D = 64.
//
// Replaces the Pallas TPU kernels `_flash_bwd_dq_kernel`
// (recondet3d/ops/attention.py:185) and `_flash_bwd_dkv_kernel` (:231). With
//   qs = bf16(q * scale), s = qs k^T, p = exp(s - lse) (0 for keys >= kv_len),
//   dp = dO v^T, ds = p * (dp - delta), delta = rowsum(dO * O)  (fp32, given)
// the two kernels compute
//   dq = scale * (bf16(ds) k)                      one CTA per 64 query rows
//   dv = bf16(p)^T dO,  dk = scale * (bf16(ds)^T q) one CTA per 64 key rows
// with every product in bf16 on mma.sync.m16n8k16 and fp32 accumulators. P and
// dS are recomputed tile by tile from lse and never reach device memory.
//
// Bound on an H100: 6*N*M*D (dq) and 8*N*M*D (dk, dv) operations over a few
// (N+M)*D*2 bytes per head: hundreds of operations per byte at N = 721 / 4326,
// so the tensor cores bound both. No atomics: the dq kernel owns its query rows
// and loops over 64-key K/V tiles, the dk/dv kernel owns its key rows and loops
// over 64-query Q/dO tiles, so results are the same from run to run. Tiles
// stream through double-buffered shared memory with cp.async.
//
// Transposed operands without a transpose: the dk/dv kernel computes
// S^T = k qs^T and dP^T = v dO^T (the warp's 16 keys as the A operand held in
// registers, the Q and dO tiles as B), which leaves P^T and dS^T in the
// accumulator layout that re-packs in registers into the A operand of
// P^T dO and dS^T q; the tiles then feed as B through ldmatrix.trans.
// In the dq kernel dS is the A operand and the K tile the transposed B.
//
// Ragged edges are masked here and the host pads nothing: a key column >= kv_len
// (or >= M) gets p = 0 by a select, so exp(s - lse) of a padded column is never
// used whatever lse is; query rows >= N are zero-filled, masked in the dk/dv
// kernel and not stored by the dq kernel.
//
// C interface for ctypes: each function returns cudaGetLastError() after its launch.

#include "flash_attn_common.cuh"

namespace {

__device__ __forceinline__ void zero(float (&a)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.f;
}

__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                        const bf16* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, const int* __restrict__ kv_len, bf16* __restrict__ dq,
                        int H, int N, int M, float scale) {
  __shared__ __align__(128) bf16 Ks[2][TILE * SROW];
  __shared__ __align__(128) bf16 Vs[2][TILE * SROW];

  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qo = (size_t)bh * N * D;
  const size_t ko = (size_t)bh * M * D;
  const int kv_lim = kv_len ? min(M, max(kv_len[bh / H], 0)) : M;
  const int n_blocks = (kv_lim + TILE - 1) / TILE;

  if (n_blocks > 0) {
    load_tile(Ks[0], k + ko, 0, M);
    load_tile(Vs[0], v + ko, 0, M);
  }
  cp_async_commit();

  // this warp's 16 query rows: Qs and dO as A fragments, lse and delta per row
  const int r0 = m0 + warp * 16 + g, r1 = r0 + 8;
  uint32_t qf[D / 16][4], dof[D / 16][4];
  load_a_frags(qf, q + qo, r0, r1, N, t, scale);
  load_a_frags(dof, dout + qo, r0, r1, N, t, 1.f);
  const float lse_r[2] = {r0 < N ? lse[(size_t)bh * N + r0] : 0.f, r1 < N ? lse[(size_t)bh * N + r1] : 0.f};
  const float dl_r[2] = {r0 < N ? delta[(size_t)bh * N + r0] : 0.f, r1 < N ? delta[(size_t)bh * N + r1] : 0.f};

  float acc[D / 8][4];
  zero(acc);

  for (int j = 0; j < n_blocks; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_blocks) {
      load_tile(Ks[buf ^ 1], k + ko, (j + 1) * TILE, M);
      load_tile(Vs[buf ^ 1], v + ko, (j + 1) * TILE, M);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[TILE / 8][4], dp[TILE / 8][4];
    zero(s);
    zero(dp);
    mma_a_bt(s, qf, Ks[buf], lane);    // S = Qs K^T
    mma_a_bt(dp, dof, Vs[buf], lane);  // dP = dO V^T

    const int kbase = j * TILE;
    const bool edge = kbase + TILE > kv_lim;
#pragma unroll
    for (int nt = 0; nt < TILE / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const bool keep = !edge || (kbase + nt * 8 + 2 * t + (e & 1) < kv_lim);
        const float p = keep ? __expf(s[nt][e] - lse_r[i]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - dl_r[i]);  // dS
      }
    }
    mma_p_b(acc, s, Ks[buf], lane);  // dQ += bf16(dS) K
    __syncthreads();                 // buffer `buf` is refilled at iteration j + 1
  }
  store_rows(dq + qo, acc, r0, r1, N, t, scale);
}

__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                         const bf16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, const int* __restrict__ kv_len, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int H, int N, int M, float scale) {
  __shared__ __align__(128) bf16 Qs[2][TILE * SROW];   // q as stored: the B operand of dS^T q
  __shared__ __align__(128) bf16 dOs[2][TILE * SROW];
  __shared__ __align__(128) bf16 Qsc[TILE * SROW];     // bf16(q * scale): the B operand of S^T
  __shared__ __align__(16) float lse_s[2][TILE];
  __shared__ __align__(16) float dl_s[2][TILE];

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qo = (size_t)bh * N * D;
  const size_t ko = (size_t)bh * M * D;
  const size_t so = (size_t)bh * N;
  const int kv_lim = kv_len ? min(M, max(kv_len[bh / H], 0)) : M;

  if (k0 >= kv_lim) {
    // no query attends to these keys: their gradients are zero
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int c = threadIdx.x; c < TILE * (D / 8); c += NTHREADS) {
      const int r = k0 + c / (D / 8), ch = c % (D / 8);
      if (r < M) {
        *reinterpret_cast<uint4*>(dk + ko + (size_t)r * D + ch * 8) = z;
        *reinterpret_cast<uint4*>(dv + ko + (size_t)r * D + ch * 8) = z;
      }
    }
    return;
  }

  const int n_blocks = (N + TILE - 1) / TILE;
  // a Q/dO tile with its lse and delta: threads 0..63 fetch lse, 64..127 delta
  auto load_q_tile = [&](int buf, int q0) {
    load_tile(Qs[buf], q + qo, q0, N);
    load_tile(dOs[buf], dout + qo, q0, N);
    const int i = threadIdx.x & (TILE - 1);
    const bool ok = q0 + i < N;
    const float* src = (threadIdx.x < TILE ? lse : delta) + so + (ok ? q0 + i : 0);
    float* dst = threadIdx.x < TILE ? &lse_s[buf][i] : &dl_s[buf][i];
    cp_async_4(smem_u32(dst), src, ok ? 4 : 0);
  };
  load_q_tile(0, 0);
  cp_async_commit();

  // this warp's 16 keys: K and V as A fragments
  const int r0 = k0 + warp * 16 + g, r1 = r0 + 8;
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a_frags(kf, k + ko, r0, r1, M, t, 1.f);
  load_a_frags(vf, v + ko, r0, r1, M, t, 1.f);
  const bool key_ok[2] = {r0 < kv_lim, r1 < kv_lim};

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int j = 0; j < n_blocks; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_blocks) {
      load_q_tile(buf ^ 1, (j + 1) * TILE);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // the scale goes into q in fp32 and is rounded to bf16, as in the forward
    for (int c = threadIdx.x; c < TILE * (D / 8); c += NTHREADS) {
      const int off = (c / (D / 8)) * SROW + (c % (D / 8)) * 8;
      const uint4 raw = *reinterpret_cast<const uint4*>(Qs[buf] + off);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
      uint32_t o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        o[i] = pack_bf16(f.x * scale, f.y * scale);
      }
      *reinterpret_cast<uint4*>(Qsc + off) = make_uint4(o[0], o[1], o[2], o[3]);
    }
    __syncthreads();

    float st[TILE / 8][4], dpt[TILE / 8][4];
    zero(st);
    zero(dpt);
    mma_a_bt(st, kf, Qsc, lane);        // S^T = K Qs^T: 16 keys x 64 queries
    mma_a_bt(dpt, vf, dOs[buf], lane);  // dP^T = V dO^T

    const int q0 = j * TILE;
    const bool edge = q0 + TILE > N;
#pragma unroll
    for (int nt = 0; nt < TILE / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + 2 * t + (e & 1);
        const bool keep = key_ok[e >> 1] && (!edge || q0 + qc < N);
        st[nt][e] = keep ? __expf(st[nt][e] - lse_s[buf][qc]) : 0.f;  // P^T
      }
    }
    mma_p_b(dv_acc, st, dOs[buf], lane);  // dV += bf16(P^T) dO
#pragma unroll
    for (int nt = 0; nt < TILE / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + 2 * t + (e & 1);
        st[nt][e] *= dpt[nt][e] - dl_s[buf][qc];  // dS^T
      }
    }
    mma_p_b(dk_acc, st, Qs[buf], lane);  // dK += bf16(dS^T) Q
    __syncthreads();                     // buffer `buf` and Qsc are rewritten at iteration j + 1
  }
  store_rows(dk + ko, dk_acc, r0, r1, M, t, scale);
  store_rows(dv + ko, dv_acc, r0, r1, M, t, 1.f);
}

}  // namespace

extern "C" int flash_attn_bwd_dq_bf16_d64(const void* q, const void* k, const void* v, const void* dout,
                                          const void* lse, const void* delta, const void* kv_len, void* dq, int B,
                                          int H, int N, int M, float scale, void* stream) {
  const dim3 grid((N + TILE - 1) / TILE, B * H);
  flash_bwd_dq_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<bf16*>(dq), H, N, M, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_attn_bwd_dkv_bf16_d64(const void* q, const void* k, const void* v, const void* dout,
                                           const void* lse, const void* delta, const void* kv_len, void* dk,
                                           void* dv, int B, int H, int N, int M, float scale, void* stream) {
  const dim3 grid((M + TILE - 1) / TILE, B * H);
  flash_bwd_dkv_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, N, M, scale);
  return static_cast<int>(cudaGetLastError());
}
