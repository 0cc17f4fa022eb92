// Flash-attention backward for Hopper (sm_90a), bf16 in / bf16 out: dq at
// D = 64, dk/dv at any D from 8 to 128 that is a multiple of 8
// (ops/attention.py pads other D with zero columns and slices the outputs).
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
// D > 64 (DC = ceil(D / 64) = 2 chunks of 64 columns, hopper_common.cuh): K
// and V stay resident as DC tiles each, Q, dO and Qs stream as DC tiles a
// stage, S^T and dP^T sum over the chunks (four k16 steps each), and dV_c +=
// P^T dO_c, dK_c += dS^T Q_c keep one pair of 64 x 64 accumulators a chunk:
// 2 DC 32 registers a thread, 128 at DC = 2. ptxas allocates under the cap of
// the launch bounds (168 a thread for 384 threads, whatever setmaxnreg gives
// later), so DC = 2 runs one consumer warpgroup of 64 keys in a CTA of 256
// threads (a cap of 255), and forms P^T and dS^T together once both products
// are in (S^T and dP^T die as they are packed) rather than P^T under dP^T's
// product, which holds S^T, dP^T, P^T and the accumulators at once. DC = 3
// and 4 would hold 192 and 256 accumulator registers a thread, with S^T and
// dP^T 256 and 320, past the 255 a thread can have: D > 128 stays on
// csrc/attn_cuda_core.cu. Without EDGE (D = 64 DC) the row pitch is a
// constant and the DC = 1 instance is the D = 64 kernel as it was; EDGE
// instances store only the columns < D.
// Tensor maps are 3-D (D, rows, B*H): Q/dO rows >= N read as zeros and are
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
  const int tiles = (N + BLOCK_M - 1) / BLOCK_M;  // B*H folded into grid.x with the row tiles
  const int bh = blockIdx.x / tiles;
  const int m0 = (blockIdx.x % tiles) * BLOCK_M;
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
    const int rofs = 64 * wg + 16 * warp + lane / 4;  // this thread's rows in the CTA: rofs and rofs + 8
    const int row0 = m0 + rofs;
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
    // the CTA's head and rows afresh from blockIdx.x: held across the loop, bh and row0 spill 8 bytes
    const unsigned cta = hopper::ctaid_x();
    hopper::store_acc_rows(dq + static_cast<size_t>(cta / tiles) * N * 64, acc,
                           static_cast<int>(cta % tiles) * BLOCK_M + rofs, N, c, scale);
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
  const unsigned grid = hopper::grid_1d(N, BLOCK_M, B * H);
  if (!grid) return static_cast<int>(cudaErrorInvalidValue);
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
using hopper::pack_bf16;
using hopper::ROW_BYTES;
using hopper::tma_load_box;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_m64n64_rs_bt;
using hopper::wgmma_m64n64_ss;
using hopper::wgmma_wait;

constexpr int STAGES = 2;                // Q/dO ring depth
constexpr int BLOCK_Q = 64;              // queries per Q/dO tile
// registers per thread after setmaxnreg (two consumers), within the 64K of one CTA per SM
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr uint32_t TILE_BYTES = 64 * ROW_BYTES;  // one 64-column chunk of 64 rows
constexpr uint64_t TILE_DESC = TILE_BYTES >> 4;  // descriptor step from chunk to chunk
constexpr int MAX_DC = 2;                        // D <= 128
constexpr int MAX_SMEM = 232448;                 // an H100 block's dynamic shared memory

// consumer warpgroups of 64 keys for DC 64-column chunks: two at DC = 1; one at DC = 2, in a CTA of 256 threads,
// whose launch bounds let ptxas allocate the 128 accumulator registers and S^T and dP^T beside them (under the 168
// of 384 threads it spilled 1,000 bytes)
template <int DC>
struct DkvCfg {
  static constexpr int CONSUMERS = DC == 1 ? 2 : 1;
  static constexpr int BLOCK_K = 64 * CONSUMERS;  // key rows per CTA
  static constexpr int NTHREADS = 128 * (CONSUMERS + 1);
};

template <int DC>
struct alignas(1024) Smem {
  static constexpr int CONSUMERS = DkvCfg<DC>::CONSUMERS;
  bf16 k[CONSUMERS][DC][64 * 64];
  bf16 v[CONSUMERS][DC][64 * 64];
  bf16 q[STAGES][DC][BLOCK_Q * 64];
  bf16 dout[STAGES][DC][BLOCK_Q * 64];
  bf16 qs[STAGES][DC][BLOCK_Q * 64];  // bf16(q * scale); loaded only when the scale is no power of two
  float lse[STAGES][BLOCK_Q];
  float delta[STAGES][BLOCK_Q];
  uint64_t kv_full;
  uint64_t full[STAGES], empty[STAGES];
};
template <int DC>
constexpr int smem_bytes() {
  return sizeof(Smem<DC>) + 1024;
}
static_assert(smem_bytes<1>() <= MAX_SMEM && smem_bytes<MAX_DC>() <= MAX_SMEM,
              "a dk/dv instance asks for more shared memory than an H100 block has");

// DC: 64-column chunks of the head dim (1 or 2); EDGE: D < 64 * DC (the last chunk partly zeros)
template <int DC, bool EDGE>
__global__ void __launch_bounds__(DkvCfg<DC>::NTHREADS, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_qs,
                         const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                         const float* __restrict__ delta, const int* __restrict__ kv_len, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int H, int N, int M, int D, float mul, float scale, int separate_qs) {
  constexpr int CONSUMERS = DkvCfg<DC>::CONSUMERS, BLOCK_K = DkvCfg<DC>::BLOCK_K, NTHREADS = DkvCfg<DC>::NTHREADS;
  extern __shared__ uint8_t smem_raw[];
  Smem<DC>& sm = *reinterpret_cast<Smem<DC>*>(hopper::align_1024(smem_raw));
  const int pitch = EDGE ? D : 64 * DC;  // a constant without EDGE
  const int tiles = (M + BLOCK_K - 1) / BLOCK_K;  // B*H folded into grid.x with the key tiles
  const int bh = blockIdx.x / tiles;
  const int k0 = (blockIdx.x % tiles) * BLOCK_K;
  const size_t ko = static_cast<size_t>(bh) * M * pitch;
  const int kv_lim = kv_len ? min(M, max(kv_len[bh / H], 0)) : M;

  if (k0 >= kv_lim) {
    // no query attends to these keys: their gradients are zero
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    const int row16 = pitch / 8;  // 16-byte pieces of a row
    for (int idx = threadIdx.x; idx < BLOCK_K * row16; idx += NTHREADS) {
      const int r = k0 + idx / row16, ch = idx % row16;
      if (r < M) {
        *reinterpret_cast<uint4*>(dk + ko + static_cast<size_t>(r) * pitch + ch * 8) = z;
        *reinterpret_cast<uint4*>(dv + ko + static_cast<size_t>(r) * pitch + ch * 8) = z;
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
    if constexpr (CONSUMERS > 1) hopper::regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x / 32 == 4 * CONSUMERS) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        hopper::prefetch_map(&tm_q);
        hopper::prefetch_map(&tm_do);
        mbar_arrive_expect_tx(&sm.kv_full, 2 * CONSUMERS * DC * TILE_BYTES);
        for (int w = 0; w < CONSUMERS; ++w) {
#pragma unroll
          for (int ch = 0; ch < DC; ++ch) {
            tma_load_box(sm.k[w][ch], &tm_k, &sm.kv_full, 64 * ch, k0 + 64 * w, bh);
            tma_load_box(sm.v[w][ch], &tm_v, &sm.kv_full, 64 * ch, k0 + 64 * w, bh);
          }
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
          mbar_arrive_expect_tx(&sm.full[s], (separate_qs ? 3 : 2) * DC * TILE_BYTES);
#pragma unroll
          for (int ch = 0; ch < DC; ++ch) {
            tma_load_box(sm.q[s][ch], &tm_q, &sm.full[s], 64 * ch, q0, bh);
            tma_load_box(sm.dout[s][ch], &tm_do, &sm.full[s], 64 * ch, q0, bh);
            if (separate_qs) tma_load_box(sm.qs[s][ch], &tm_qs, &sm.full[s], 64 * ch, q0, bh);
          }
        }
      }
    }
  } else {
    if constexpr (CONSUMERS > 1) hopper::regs_alloc<CONSUMER_REGS>();
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int g = lane / 4, c = lane % 4;
    const int key0 = k0 + 64 * wg + 16 * warp + g;  // this thread's keys: key0 and key0 + 8
    const bool key_ok[2] = {key0 < kv_lim, key0 + 8 < kv_lim};
    const float k_log2 = mul * LOG2E;
    const uint64_t k_desc = desc_sw128(sm.k[wg][0]), v_desc = desc_sw128(sm.v[wg][0]);

    float st[32], dpt[32], dk_acc[DC][32], dv_acc[DC][32];
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int ch = 0; ch < DC; ++ch)
#pragma unroll
      for (int i = 0; i < 32; ++i) dk_acc[ch][i] = dv_acc[ch][i] = 0.f;

    mbar_wait(&sm.kv_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES, q0 = j * BLOCK_Q;
      mbar_wait(&sm.full[s], (j / STAGES) & 1);
      const uint64_t q_desc = desc_sw128(sm.q[s][0]);
      const uint64_t qk_desc = separate_qs ? desc_sw128(sm.qs[s][0]) : q_desc;
      const uint64_t do_desc = desc_sw128(sm.dout[s][0]);
      wgmma_fence();
#pragma unroll
      for (int ch = 0; ch < DC; ++ch)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // S^T = K Qs^T: 64 keys x 64 queries, summed over the chunks
          wgmma_m64n64_ss(st, k_desc + ch * TILE_DESC + kk * DESC_K16_COLS,
                          qk_desc + ch * TILE_DESC + kk * DESC_K16_COLS, 4 * ch + kk);
      wgmma_commit();
#pragma unroll
      for (int ch = 0; ch < DC; ++ch)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // dP^T = V dO^T
          wgmma_m64n64_ss(dpt, v_desc + ch * TILE_DESC + kk * DESC_K16_COLS,
                          do_desc + ch * TILE_DESC + kk * DESC_K16_COLS, 4 * ch + kk);
      wgmma_commit();

      const bool edge = q0 + BLOCK_Q > N;
      if constexpr (DC == 1) {
        // P^T while dP^T is in flight, then dS^T
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
      } else {
        // 64 more accumulator registers a chunk: P^T and dS^T are formed together once both products are in,
        // each pair of scores packed as soon as it is made, so S^T and dP^T die as P^T and dS^T grow
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
#pragma unroll
        for (int i = 0; i < 8; ++i) {  // this thread's query columns are 8i + 2c + {0, 1}
          const float2 l2 = *reinterpret_cast<const float2*>(&sm.lse[s][8 * i + 2 * c]);
          const float2 d2 = *reinterpret_cast<const float2*>(&sm.delta[s][8 * i + 2 * c]);
          const float nl[2] = {-l2.x * LOG2E, -l2.y * LOG2E}, dl[2] = {d2.x, d2.y};
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool keep = key_ok[(e / 2) % 2] && (!edge || q0 + 8 * i + 2 * c + (e % 2) < N);
            p[e] = keep ? ex2(fmaf(st[4 * i + e], k_log2, nl[e % 2])) : 0.f;
            ds[e] = p[e] * (dpt[4 * i + e] - dl[e % 2]);
          }
          pa[i / 2][2 * (i % 2)] = pack_bf16(p[0], p[1]);
          pa[i / 2][2 * (i % 2) + 1] = pack_bf16(p[2], p[3]);
          da[i / 2][2 * (i % 2)] = pack_bf16(ds[0], ds[1]);
          da[i / 2][2 * (i % 2) + 1] = pack_bf16(ds[2], ds[3]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int ch = 0; ch < DC; ++ch)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // dV_c += P^T dO_c
          wgmma_m64n64_rs_bt(dv_acc[ch], pa[kk], do_desc + ch * TILE_DESC + kk * DESC_K16_ROWS, 1);
#pragma unroll
      for (int ch = 0; ch < DC; ++ch)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // dK_c += dS^T Q_c
          wgmma_m64n64_rs_bt(dk_acc[ch], da[kk], q_desc + ch * TILE_DESC + kk * DESC_K16_ROWS, 1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int ch = 0; ch < DC; ++ch) {
        fence_regs(dk_acc[ch]);
        fence_regs(dv_acc[ch]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[s]);
    }
#pragma unroll
    for (int ch = 0; ch < DC; ++ch) {
      hopper::store_acc_chunk<EDGE>(dk + ko, dk_acc[ch], key0, M, c, scale, pitch, 64 * ch, D);
      hopper::store_acc_chunk<EDGE>(dv + ko, dv_acc[ch], key0, M, c, 1.f, pitch, 64 * ch, D);
    }
  }
}

template <int DC, bool EDGE>
int launch_dkv(const void* q, const void* qs, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* kv_len, void* dk, void* dv, int B, int H, int N, int M, int D, float mul,
               float scale, cudaStream_t stream) {
  constexpr int SMEM_BYTES = smem_bytes<DC>(), BLOCK_K = DkvCfg<DC>::BLOCK_K, NTHREADS = DkvCfg<DC>::NTHREADS;
  CUtensorMap tm_q, tm_qs, tm_k, tm_v, tm_do;
  const int separate_qs = qs != q;
  int err = hopper::make_row_map(&tm_q, q, N, B * H, BLOCK_Q, D);
  if (!err && separate_qs) err = hopper::make_row_map(&tm_qs, qs, N, B * H, BLOCK_Q, D);
  if (!separate_qs) tm_qs = tm_q;  // never read by the kernel
  if (!err) err = hopper::make_row_map(&tm_k, k, M, B * H, 64, D);
  if (!err) err = hopper::make_row_map(&tm_v, v, M, B * H, 64, D);
  if (!err) err = hopper::make_row_map(&tm_do, dout, N, B * H, BLOCK_Q, D);
  if (err) return err;
  static std::atomic<uint32_t> smem_allowed{0};
  err = hopper::allow_dynamic_smem(flash_bwd_dkv_kernel<DC, EDGE>, SMEM_BYTES, smem_allowed);
  if (err) return err;
  const unsigned grid = hopper::grid_1d(M, BLOCK_K, B * H);
  if (!grid) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_dkv_kernel<DC, EDGE><<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      tm_q, tm_qs, tm_k, tm_v, tm_do, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, N, M, D, mul, scale,
      separate_qs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dkv

// q (and qs = bf16(q * scale) when it is a separate tensor), dout: (B*H, N, D) bf16; k, v, dk, dv: (B*H, M, D)
// bf16, D a multiple of 8 from 8 to 128; lse, delta: (B*H, N) fp32; kv_len (B,) int32 or null; mul: the fp32
// multiplier of qs k^T; scale: dk's trailing scale
extern "C" int flash_attn_bwd_dkv_bf16(const void* q, const void* qs, const void* k, const void* v, const void* dout,
                                       const void* lse, const void* delta, const void* kv_len, void* dk, void* dv,
                                       int B, int H, int N, int M, int D, float mul, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return dkv::launch_dkv<1, false>(q, qs, k, v, dout, lse, delta, kv_len, dk, dv, B, H, N, M, D, mul, scale, s);
  if (D == 128)
    return dkv::launch_dkv<2, false>(q, qs, k, v, dout, lse, delta, kv_len, dk, dv, B, H, N, M, D, mul, scale, s);
  if (D < 8 || D > 64 * dkv::MAX_DC || D % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (D < 64)
    return dkv::launch_dkv<1, true>(q, qs, k, v, dout, lse, delta, kv_len, dk, dv, B, H, N, M, D, mul, scale, s);
  return dkv::launch_dkv<2, true>(q, qs, k, v, dout, lse, delta, kv_len, dk, dv, B, H, N, M, D, mul, scale, s);
}
