// Flash-attention backward for Hopper (sm_90a), bf16 in / bf16 out, D = 64.
//
// Replaces the Pallas TPU kernels `_flash_bwd_dq_kernel`
// (recondet3d/ops/attention.py:185) and `_flash_bwd_dkv_kernel` (:231). With
//   qs = bf16(q * scale), s = qs k^T, p = exp(s - lse) (0 for keys >= kv_len),
//   dp = dO v^T, ds = p * (dp - delta), delta = rowsum(dO * O)  (fp32, given)
// the two kernels compute
//   dq = scale * (bf16(ds) k)                      one CTA per 64 * CONSUMERS query rows (128)
//   dv = bf16(p)^T dO,  dk = scale * (bf16(ds)^T q) one CTA per 64 * CONSUMERS key rows (128)
// with every product in bf16 and fp32 accumulators. P and dS are recomputed
// tile by tile from lse and never reach device memory. No atomics: the dq
// kernel owns its query rows, the dk/dv kernel its key rows, so results are
// the same bits from run to run.
//
// What bounds them on an H100: 6*N*M*D (dq) and 8*N*M*D (dk, dv) tensor-core
// operations over a few (N+M)*D*2 bytes per head, hundreds of operations per
// byte at N = 721 / 4326, and one ex2 per score on the MUFU (16 a clock per SM).
//
// dq kernel (Hopper design, building blocks in hopper_common.cuh; it follows
// the forward, with two score-like products per key tile):
//   - one CTA = one producer warpgroup + CONSUMERS warpgroups of 64 query
//     rows; the producer gives up its registers (setmaxnreg) and one of its
//     threads issues every TMA copy: each consumer's Q (the score operand) and
//     dO tiles once, then 64-key K and V tiles through a ring of STAGES (4)
//     stages with full/empty mbarriers, on the 3-D tensor maps of the forward;
//   - S = Q K^T and dP = dO V^T on wgmma m64n64k16 with both operands in
//     shared memory; P = 2^(S * mul * log2(e) - lse * log2(e)) and
//     dS = P (dP - delta) in registers (lse and delta of a thread's two rows
//     are loaded once: their rows are not 16-byte aligned at N = 721, so TMA
//     cannot carry them); dQ += bf16(dS) K on wgmma m64n64k16 with dS from
//     registers and the K tile as the transposed B operand, as the forward
//     feeds V to PV;
//   - inside a warpgroup, S and dP of tile j are issued with dQ of tile j - 1,
//     so dS of tile j is formed while that product runs; across warpgroups,
//     named barriers pass the turn to issue products, so one warpgroup's
//     exponentials run under the other's products;
//   - a power-of-two scale is applied to S in fp32 (`mul`) on raw q; another
//     scale comes as bf16(q * scale) with mul = 1. dQ takes its trailing scale
//     in fp32.
// 64-key tiles and four stages measured fastest on an H100 without a spill:
// 128-key tiles hold S and dP in 128 registers a thread and spill ~1 KB; two
// stages stall the producer behind the dQ product of the previous tile (1.4-1.6x
// slower); three stages spill 12 bytes and ran 3-5 % behind four.
//
// dk/dv kernel (Hopper design, building blocks in hopper_common.cuh):
//   - one CTA = one producer warpgroup + CONSUMERS warpgroups of 64 keys; the
//     producer gives up its registers (setmaxnreg); the CTA's K and V rows
//     arrive once by TMA and stay in shared memory, 128-byte swizzled;
//   - one producer warp streams 64-query tiles of Q and dO (and of bf16(q *
//     scale) when the scale is no power of two) by TMA through a ring of STAGES
//     stages, and their lse and delta with 4-byte cp.async copies that arrive
//     on the stage's mbarrier (cp.async.mbarrier.arrive.noinc): those rows are
//     not 16-byte aligned at N = 721, so TMA cannot carry them;
//   - S^T = K Qs^T and dP^T = V dO^T on wgmma m64n64k16 with both operands in
//     shared memory (K-major, no transpose); P^T and dS^T then sit in the
//     accumulator layout that re-packs in registers into the A operand of
//     dV += bf16(P^T) dO and dK += bf16(dS^T) Q, whose B operands are the dO and
//     raw Q tiles read MN-major (transpose bit);
//   - when the scale is a power of two the kernel applies it to S^T in fp32
//     (`mul`), which equals bf16(q * scale) k^T exactly, so the raw Q tile
//     serves both products.
// Two consumer warpgroups (128 keys a CTA) and two stages measured fastest on
// an H100: one warpgroup of 64 keys with two CTAs an SM leaves 216 registers a
// consumer thread and spills, a third stage gains nothing, and
// issuing tile j+1's S^T and dP^T behind tile j's dV and dK inside a
// warpgroup ran slower than letting the two warpgroups interleave.
// Tensor maps are 3-D (64, rows, B*H): Q/dO rows >= N read as zeros and are
// masked with p = 0 by a select, as are keys >= kv_len (so exp(s - lse) of a
// padded column never counts whatever lse is). Key tiles wholly past kv_len
// write zeros and exit. dK takes its trailing scale in fp32.
//
// C interface for ctypes: each function returns a cudaError_t value after its launch.

#include "hopper_common.cuh"

namespace dq {

using hopper::bf16;
using hopper::desc_sw128;
using hopper::DESC_K16_COLS;
using hopper::DESC_K16_ROWS;
using hopper::ex2;
using hopper::fence_regs;
using hopper::LOG2E;
using hopper::mbar_arrive;
using hopper::mbar_arrive_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::named_arrive;
using hopper::named_sync;
using hopper::pack_a;
using hopper::ROW_BYTES;
using hopper::tma_load_rows;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_m64n64_rs_bt;
using hopper::wgmma_m64n64_ss;
using hopper::wgmma_wait;

constexpr int CONSUMERS = 2;             // consumer warpgroups of 64 query rows
constexpr int STAGES = 4;                // K/V ring depth
constexpr int BLOCK_M = 64 * CONSUMERS;  // query rows per CTA
constexpr int BLOCK_N = 64;              // keys per K/V tile
constexpr int KC = BLOCK_N / 16;         // 16-key chunks of a tile: the A operands of dS K
constexpr int NTHREADS = 128 * (CONSUMERS + 1);
// registers per thread after setmaxnreg, within the 64K of one CTA per SM
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr uint32_t Q_BYTES = 64 * ROW_BYTES;
constexpr uint32_t KV_BYTES = BLOCK_N * ROW_BYTES;

struct alignas(1024) Smem {
  bf16 q[CONSUMERS][64 * 64];     // the score operand (raw q, or bf16(q * scale))
  bf16 dout[CONSUMERS][64 * 64];
  bf16 k[STAGES][BLOCK_N * 64];
  bf16 v[STAGES][BLOCK_N * 64];
  uint64_t q_full;
  uint64_t k_full[STAGES], k_empty[STAGES];
  uint64_t v_full[STAGES], v_empty[STAGES];
};

constexpr int SMEM_BYTES = sizeof(Smem) + 1024;

// d (64 x 64) = A (64 x 64, shared, K-major) * B (64 x 64 rows, shared, K-major)^T
__device__ __forceinline__ void product_t(float (&d)[32], uint64_t a_desc, uint64_t b_desc) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n64_ss(d, a_desc + kk * DESC_K16_COLS, b_desc + kk * DESC_K16_COLS, kk);
}

__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ kv_len, bf16* __restrict__ dq, int H, int N, int M, float mul,
                        float scale) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(hopper::align_1024(smem_raw));
  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * BLOCK_M;
  const int kv_lim = kv_len ? min(M, max(kv_len[bh / H], 0)) : M;
  const int n_tiles = (kv_lim + BLOCK_N - 1) / BLOCK_N;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], 4 * CONSUMERS);  // one arrival per consumer warp
      mbar_init(&sm.v_empty[s], 4 * CONSUMERS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: one thread issues every copy, the other 127 leave
    hopper::regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS * 128) {
      hopper::prefetch_map(&tm_q);
      hopper::prefetch_map(&tm_do);
      hopper::prefetch_map(&tm_k);
      hopper::prefetch_map(&tm_v);
      mbar_arrive_expect_tx(&sm.q_full, 2 * CONSUMERS * Q_BYTES);
      for (int w = 0; w < CONSUMERS; ++w) {
        tma_load_rows(sm.q[w], &tm_q, &sm.q_full, m0 + 64 * w, bh);
        tma_load_rows(sm.dout[w], &tm_do, &sm.q_full, m0 + 64 * w, bh);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const uint32_t parity = ((j / STAGES) & 1) ^ 1;  // round 0 passes: the ring starts empty
        mbar_wait(&sm.k_empty[s], parity);
        mbar_arrive_expect_tx(&sm.k_full[s], KV_BYTES);
        tma_load_rows(sm.k[s], &tm_k, &sm.k_full[s], j * BLOCK_N, bh);
        mbar_wait(&sm.v_empty[s], parity);
        mbar_arrive_expect_tx(&sm.v_full[s], KV_BYTES);
        tma_load_rows(sm.v[s], &tm_v, &sm.v_full[s], j * BLOCK_N, bh);
      }
    }
  } else {
    hopper::regs_alloc<CONSUMER_REGS>();
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int c = lane % 4;
    const int row0 = m0 + 64 * wg + 16 * warp + lane / 4;  // this thread's rows: row0 and row0 + 8
    const float k_log2 = mul * LOG2E;
    float nl[2], dl[2];  // -lse * log2(e) and delta of the two rows, loaded once
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      const size_t at = static_cast<size_t>(bh) * N + row;
      nl[h] = row < N ? -lse[at] * LOG2E : 0.f;
      dl[h] = row < N ? delta[at] : 0.f;
    }

    // turns to issue products pass from warpgroup wg to wg + 1 (named barriers 1..CONSUMERS), as in the forward
    const int my_turn = 1 + wg, next_turn = 1 + (wg + 1) % CONSUMERS;
    if (wg == CONSUMERS - 1 && n_tiles > 0) named_arrive(1, 256);

    const uint64_t q_desc = desc_sw128(sm.q[wg]), do_desc = desc_sw128(sm.dout[wg]);
    float s[BLOCK_N / 2], dp[BLOCK_N / 2], acc[32];
    uint32_t da[KC][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;

    auto issue_s_dp = [&](int j) {
      product_t(s, q_desc, desc_sw128(sm.k[j % STAGES]));
      product_t(dp, do_desc, desc_sw128(sm.v[j % STAGES]));
      wgmma_commit();
    };
    auto issue_dq = [&](int j) {
      const uint64_t k_desc = desc_sw128(sm.k[j % STAGES]);
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) wgmma_m64n64_rs_bt(acc, da[kk], k_desc + kk * DESC_K16_ROWS, 1);
      wgmma_commit();
    };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // dS of tile j into s: p = 2^(s * mul * log2(e) - lse * log2(e)), 0 for keys >= kv_len (or M)
    auto grad_scores = [&](int j) {
      const int kbase = j * BLOCK_N;
      const bool edge = kbase + BLOCK_N > kv_lim;
#pragma unroll
      for (int e = 0; e < BLOCK_N / 2; ++e) {
        const int h = (e / 2) % 2;
        const bool keep = !edge || kbase + 8 * (e / 4) + 2 * c + (e % 2) < kv_lim;
        const float p = keep ? ex2(fmaf(s[e], k_log2, nl[h])) : 0.f;
        s[e] = p * (dp[e] - dl[h]);
      }
    };

    mbar_wait(&sm.q_full, 0);
    if (n_tiles > 0) {
      // turn 0: S and dP of tile 0
      mbar_wait(&sm.k_full[0], 0);
      mbar_wait(&sm.v_full[0], 0);
      named_sync(my_turn, 256);
      wgmma_fence();
      issue_s_dp(0);
      named_arrive(next_turn, 256);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      release(&sm.v_empty[0]);
      grad_scores(0);
      pack_a<KC>(da, s);

      // turns 1 .. n_tiles - 1: S and dP of tile j with dQ += dS K of tile j - 1
      for (int j = 1; j < n_tiles; ++j) {
        const int sj = j % STAGES, sp = (j - 1) % STAGES;
        mbar_wait(&sm.k_full[sj], (j / STAGES) & 1);
        mbar_wait(&sm.v_full[sj], (j / STAGES) & 1);
        named_sync(my_turn, 256);
        wgmma_fence();
        issue_s_dp(j);
        issue_dq(j - 1);
        named_arrive(next_turn, 256);
        wgmma_wait<1>();
        fence_regs(s);
        fence_regs(dp);
        release(&sm.v_empty[sj]);
        grad_scores(j);
        wgmma_wait<0>();
        fence_regs(acc);
        release(&sm.k_empty[sp]);
        pack_a<KC>(da, s);
      }

      // last turn: dQ += dS K of the last tile
      const int sl = (n_tiles - 1) % STAGES;
      named_sync(my_turn, 256);
      wgmma_fence();
      issue_dq(n_tiles - 1);
      if (wg != CONSUMERS - 1) named_arrive(next_turn, 256);
      wgmma_wait<0>();
      fence_regs(acc);
      release(&sm.k_empty[sl]);
    }
    hopper::store_acc_rows(dq + static_cast<size_t>(bh) * N * 64, acc, row0, N, c, scale);
  }
}

int launch_dq(const void* qk, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
              const void* kv_len, void* dq, int B, int H, int N, int M, float mul, float scale, void* stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int err = hopper::make_row_map(&tm_q, qk, N, B * H, 64);
  if (!err) err = hopper::make_row_map(&tm_do, dout, N, B * H, 64);
  if (!err) err = hopper::make_row_map(&tm_k, k, M, B * H, BLOCK_N);
  if (!err) err = hopper::make_row_map(&tm_v, v, M, B * H, BLOCK_N);
  if (err) return err;
  static std::atomic<uint32_t> smem_allowed{0};
  err = hopper::allow_dynamic_smem(flash_bwd_dq_kernel, SMEM_BYTES, smem_allowed);
  if (err) return err;
  const dim3 grid((N + BLOCK_M - 1) / BLOCK_M, B * H);
  flash_bwd_dq_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<bf16*>(dq), H, N, M, mul, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dq

// qk: the score operand (raw q when mul is the scale, else bf16(q * scale)), dout, dq: (B*H, N, 64) bf16;
// k, v: (B*H, M, 64) bf16; lse, delta: (B*H, N) fp32; kv_len (B,) int32 or null; mul: the fp32 multiplier of
// qk k^T; scale: dq's trailing scale
extern "C" int flash_attn_bwd_dq_bf16_d64(const void* qk, const void* k, const void* v, const void* dout,
                                          const void* lse, const void* delta, const void* kv_len, void* dq, int B,
                                          int H, int N, int M, float mul, float scale, void* stream) {
  return dq::launch_dq(qk, k, v, dout, lse, delta, kv_len, dq, B, H, N, M, mul, scale, stream);
}


namespace dkv {

using hopper::bf16;
using hopper::desc_sw128;
using hopper::DESC_K16_COLS;
using hopper::DESC_K16_ROWS;
using hopper::ex2;
using hopper::fence_regs;
using hopper::LOG2E;
using hopper::mbar_arrive;
using hopper::mbar_arrive_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::pack_a;
using hopper::ROW_BYTES;
using hopper::tma_load_rows;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_m64n64_rs_bt;
using hopper::wgmma_m64n64_ss;
using hopper::wgmma_wait;

constexpr int CONSUMERS = 2;             // consumer warpgroups of 64 keys
constexpr int STAGES = 2;                // Q/dO ring depth
constexpr int BLOCK_K = 64 * CONSUMERS;  // key rows per CTA
constexpr int BLOCK_Q = 64;              // queries per Q/dO tile
constexpr int NTHREADS = 128 * (CONSUMERS + 1);
// registers per thread after setmaxnreg, within the 64K of one CTA per SM
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr uint32_t TILE_BYTES = 64 * ROW_BYTES;

struct alignas(1024) Smem {
  bf16 k[CONSUMERS][64 * 64];
  bf16 v[CONSUMERS][64 * 64];
  bf16 q[STAGES][BLOCK_Q * 64];
  bf16 dout[STAGES][BLOCK_Q * 64];
  bf16 qs[STAGES][BLOCK_Q * 64];  // bf16(q * scale); loaded only when the scale is no power of two
  float lse[STAGES][BLOCK_Q];
  float delta[STAGES][BLOCK_Q];
  uint64_t kv_full;
  uint64_t full[STAGES], empty[STAGES];
};
constexpr int SMEM_BYTES = sizeof(Smem) + 1024;

__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_qs,
                         const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                         const float* __restrict__ delta, const int* __restrict__ kv_len, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int H, int N, int M, float mul, float scale, int separate_qs) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(hopper::align_1024(smem_raw));
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BLOCK_K;
  const size_t ko = static_cast<size_t>(bh) * M * 64;
  const int kv_lim = kv_len ? min(M, max(kv_len[bh / H], 0)) : M;

  if (k0 >= kv_lim) {
    // no query attends to these keys: their gradients are zero
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int idx = threadIdx.x; idx < BLOCK_K * 8; idx += NTHREADS) {
      const int r = k0 + idx / 8, ch = idx % 8;
      if (r < M) {
        *reinterpret_cast<uint4*>(dk + ko + static_cast<size_t>(r) * 64 + ch * 8) = z;
        *reinterpret_cast<uint4*>(dv + ko + static_cast<size_t>(r) * 64 + ch * 8) = z;
      }
    }
    return;
  }

  const int n_tiles = (N + BLOCK_Q - 1) / BLOCK_Q;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1 + 32);            // the TMA arrival + one cp.async arrival per producer lane
      mbar_init(&sm.empty[s], 4 * CONSUMERS);    // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: its first warp streams the query tiles, the other three leave
    hopper::regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x / 32 == 4 * CONSUMERS) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        hopper::prefetch_map(&tm_q);
        hopper::prefetch_map(&tm_do);
        mbar_arrive_expect_tx(&sm.kv_full, 2 * CONSUMERS * TILE_BYTES);
        for (int w = 0; w < CONSUMERS; ++w) {
          tma_load_rows(sm.k[w], &tm_k, &sm.kv_full, k0 + 64 * w, bh);
          tma_load_rows(sm.v[w], &tm_v, &sm.kv_full, k0 + 64 * w, bh);
        }
      }
      const float* lse_bh = lse + static_cast<size_t>(bh) * N;
      const float* delta_bh = delta + static_cast<size_t>(bh) * N;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES, q0 = j * BLOCK_Q;
        mbar_wait(&sm.empty[s], ((j / STAGES) & 1) ^ 1);  // round 0 passes: the ring starts empty
        for (int i = lane; i < BLOCK_Q; i += 32) {
          const bool ok = q0 + i < N;
          hopper::cp_async_4(&sm.lse[s][i], lse_bh + (ok ? q0 + i : 0), ok ? 4 : 0);
          hopper::cp_async_4(&sm.delta[s][i], delta_bh + (ok ? q0 + i : 0), ok ? 4 : 0);
        }
        hopper::cp_async_arrive_noinc(&sm.full[s]);
        if (lane == 0) {
          mbar_arrive_expect_tx(&sm.full[s], (separate_qs ? 3 : 2) * TILE_BYTES);
          tma_load_rows(sm.q[s], &tm_q, &sm.full[s], q0, bh);
          tma_load_rows(sm.dout[s], &tm_do, &sm.full[s], q0, bh);
          if (separate_qs) tma_load_rows(sm.qs[s], &tm_qs, &sm.full[s], q0, bh);
        }
      }
    }
  } else {
    hopper::regs_alloc<CONSUMER_REGS>();
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int g = lane / 4, c = lane % 4;
    const int key0 = k0 + 64 * wg + 16 * warp + g;  // this thread's keys: key0 and key0 + 8
    const bool key_ok[2] = {key0 < kv_lim, key0 + 8 < kv_lim};
    const float k_log2 = mul * LOG2E;
    const uint64_t k_desc = desc_sw128(sm.k[wg]), v_desc = desc_sw128(sm.v[wg]);

    float st[32], dpt[32], dk_acc[32], dv_acc[32];
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(&sm.kv_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES, q0 = j * BLOCK_Q;
      mbar_wait(&sm.full[s], (j / STAGES) & 1);
      const uint64_t q_desc = desc_sw128(sm.q[s]);
      const uint64_t qk_desc = separate_qs ? desc_sw128(sm.qs[s]) : q_desc;
      const uint64_t do_desc = desc_sw128(sm.dout[s]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // S^T = K Qs^T: 64 keys x 64 queries
        wgmma_m64n64_ss(st, k_desc + kk * DESC_K16_COLS, qk_desc + kk * DESC_K16_COLS, kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dP^T = V dO^T
        wgmma_m64n64_ss(dpt, v_desc + kk * DESC_K16_COLS, do_desc + kk * DESC_K16_COLS, kk);
      wgmma_commit();

      const bool edge = q0 + BLOCK_Q > N;
      wgmma_wait<1>();
      fence_regs(st);
#pragma unroll
      for (int i = 0; i < 8; ++i) {  // P^T; this thread's query columns are 8i + 2c + {0, 1}
        const float2 l2 = *reinterpret_cast<const float2*>(&sm.lse[s][8 * i + 2 * c]);
        const float nl[2] = {-l2.x * LOG2E, -l2.y * LOG2E};
#pragma unroll
        for (int e = 4 * i; e < 4 * i + 4; ++e) {
          const bool keep = key_ok[(e / 2) % 2] && (!edge || q0 + 8 * i + 2 * c + (e % 2) < N);
          st[e] = keep ? ex2(fmaf(st[e], k_log2, nl[e % 2])) : 0.f;
        }
      }
      pack_a<4>(pa, st);
      wgmma_wait<0>();
      fence_regs(dpt);
#pragma unroll
      for (int i = 0; i < 8; ++i) {  // dS^T
        const float2 d2 = *reinterpret_cast<const float2*>(&sm.delta[s][8 * i + 2 * c]);
        const float dl[2] = {d2.x, d2.y};
#pragma unroll
        for (int e = 4 * i; e < 4 * i + 4; ++e) st[e] *= dpt[e] - dl[e % 2];
      }
      pack_a<4>(da, st);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_m64n64_rs_bt(dv_acc, pa[kk], do_desc + kk * DESC_K16_ROWS, 1);  // dV += P^T dO
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_m64n64_rs_bt(dk_acc, da[kk], q_desc + kk * DESC_K16_ROWS, 1);  // dK += dS^T Q
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[s]);
    }
    hopper::store_acc_rows(dk + ko, dk_acc, key0, M, c, scale);
    hopper::store_acc_rows(dv + ko, dv_acc, key0, M, c, 1.f);
  }
}

}  // namespace dkv

// q (and qs = bf16(q * scale) when it is a separate tensor), dout: (B*H, N, 64)
// bf16; k, v, dk, dv: (B*H, M, 64) bf16; lse, delta: (B*H, N) fp32; kv_len (B,)
// int32 or null; mul: the fp32 multiplier of qs k^T; scale: dk's trailing scale
extern "C" int flash_attn_bwd_dkv_bf16_d64(const void* q, const void* qs, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta, const void* kv_len,
                                           void* dk, void* dv, int B, int H, int N, int M, float mul, float scale,
                                           void* stream) {
  CUtensorMap tm_q, tm_qs, tm_k, tm_v, tm_do;
  const int separate_qs = qs != q;
  int err = hopper::make_row_map(&tm_q, q, N, B * H, dkv::BLOCK_Q);
  if (!err && separate_qs) err = hopper::make_row_map(&tm_qs, qs, N, B * H, dkv::BLOCK_Q);
  if (!separate_qs) tm_qs = tm_q;  // never read by the kernel
  if (!err) err = hopper::make_row_map(&tm_k, k, M, B * H, 64);
  if (!err) err = hopper::make_row_map(&tm_v, v, M, B * H, 64);
  if (!err) err = hopper::make_row_map(&tm_do, dout, N, B * H, dkv::BLOCK_Q);
  if (err) return err;
  static std::atomic<uint32_t> smem_allowed{0};
  err = hopper::allow_dynamic_smem(dkv::flash_bwd_dkv_kernel, dkv::SMEM_BYTES, smem_allowed);
  if (err) return err;
  const dim3 grid((M + dkv::BLOCK_K - 1) / dkv::BLOCK_K, B * H);
  dkv::flash_bwd_dkv_kernel<<<grid, dkv::NTHREADS, dkv::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_qs, tm_k, tm_v, tm_do, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<hopper::bf16*>(dk), static_cast<hopper::bf16*>(dv), H, N, M, mul, scale,
      separate_qs);
  return static_cast<int>(cudaGetLastError());
}

