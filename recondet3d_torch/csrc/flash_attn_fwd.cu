// Flash-attention forward for Hopper (sm_90a), bf16 in / bf16 out, any head
// dim D from 8 to 256 that is a multiple of 8 (ops/attention.py pads other D
// with zero columns to the next multiple of 8 and slices the output).
//
// Replaces the Pallas TPU kernel `_flash_kernel` (recondet3d/ops/attention.py:54).
// Computes, per (batch*head) and query row, online-softmax attention over all
// keys (or the first kv_len[b] keys), plus the row logsumexp:
//   s   = (q k^T) * mul                (bf16 x bf16 -> fp32; mul in fp32)
//   p   = exp(s - m), l = sum(p) in fp32
//   out = bf16( (bf16(p) v) / l ),  lse = m + log(l)
// The caller passes q and mul so that s equals bf16(q * scale) k^T: raw q and
// mul = scale when scale is a power of two (then both are the same fp32
// numbers), else bf16(q * scale) and mul = 1 (ops/attention.py score_operand).
//
// What bounds it on an H100: 4*N*M*D tensor-core operations (hundreds per byte
// moved at N = 721 / 4326), and at D = 64 also the exponentials: one ex2 per
// score against 256 operations per score, and the MUFU gives 16 results per
// clock per SM, so the ex2 floor is about the tensor-core floor (at D = 128
// it is half of it). Hence the design:
//   - one CTA = one producer warpgroup + CONSUMERS warpgroups of 64 query rows
//     each (BLOCK_M = 64 * CONSUMERS); with two consumers the producer gives
//     up its registers (setmaxnreg); one of its threads issues every TMA copy;
//   - Q (once) and BLOCK_N-key K and V tiles arrive by TMA, 128-byte swizzled,
//     into a ring of STAGES stages in dynamic shared memory, each stage with
//     its own full/empty mbarriers for K and for V; 3-D tensor maps
//     (D, rows, B*H) read zeros past a head's last row and past column D;
//   - the kernel is a template on DC = ceil(D / 64): Q, K and V are held as
//     DC tiles of 64 columns each (hopper_common.cuh), S = sum_c Q_c K_c^T
//     (four k16 steps a chunk) on wgmma m64n128k16 (m64n64k16 for 64-key
//     tiles) with both operands in shared memory, and O as DC accumulators
//     of 64 x 64, O_c += bf16(P) V_c on wgmma m64n64k16 with the one P from
//     registers (the S accumulator re-packed) and V_c as the transposed B
//     operand;
//   - inside a warpgroup, S of tile j is issued together with PV of tile j-1,
//     so the softmax of tile j waits only on its own product; across
//     warpgroups, named barriers pass the turn to issue products from one
//     warpgroup to the next, so one warpgroup's softmax runs under the
//     others' products;
//   - p = ex2(s * mul*log2(e) - m*mul*log2(e)), one FFMA and one ex2 a score.
// Tiles per DC (FwdCfg), all in 3 stages. ptxas allocates a kernel's
// registers under the cap of its launch bounds, 168 a thread for 384 threads,
// whatever setmaxnreg hands a warpgroup later (tools/ptxas_spills.py: a
// smaller CONSUMER_REGS leaves every instance's registers and spills as they
// are), so a consumer thread's accumulators, S and P have to fit in 168 with
// the rest:
//   - DC = 1 (D <= 64): two consumers, 128-key tiles (O 32 + S 64 + P 32
//     registers), the design measured fastest at D = 64 on an H100;
//   - DC = 2: two consumers, 64-key tiles (O 64 + S 32 + P 16; 128-key tiles
//     spilled 240 bytes);
//   - DC = 3 and 4: one consumer warpgroup a CTA (256 threads: a cap of 255
//     registers, no setmaxnreg, no turns), 64-key tiles: O 96 or 128 + S 32 +
//     P 16 are past 168 with the rest (ptxas gives them 193-202).
// Without EDGE (D = 64 DC) the row pitch is a constant and the DC = 1
// instance is the D = 64 kernel as it was; EDGE instances store only the
// output columns < D.
// Keys >= kv_len (or >= M) get -inf by a select on the edge tile; rows >= N are
// computed on zeros and not stored; lse goes out by plain stores (its rows are
// not 16-byte aligned at N = 721, so TMA cannot address them).
//
// C interface for ctypes: returns a cudaError_t value (0 on success).

#include "hopper_common.cuh"

namespace {

using namespace hopper;

// registers per thread after setmaxnreg (two consumers): producer + consumers stay within the 64K of one CTA per SM
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr uint32_t Q_BYTES = 64 * ROW_BYTES;  // one 64-column chunk of a consumer's 64 query rows
constexpr int STAGES = 3;                     // K/V ring depth
constexpr int MAX_SMEM = 232448;              // an H100 block's dynamic shared memory

// consumer warpgroups of 64 query rows and keys per K/V tile for DC 64-column chunks
template <int DC>
struct FwdCfg {
  static constexpr int CONSUMERS = DC <= 2 ? 2 : 1;
  static constexpr int BLOCK_N = DC == 1 ? 128 : 64;
  static constexpr int BLOCK_M = 64 * CONSUMERS;  // query rows per CTA
  static constexpr int NTHREADS = 128 * (CONSUMERS + 1);
};

template <int DC>
struct alignas(1024) Smem {
  static constexpr int CONSUMERS = FwdCfg<DC>::CONSUMERS, BLOCK_N = FwdCfg<DC>::BLOCK_N;
  bf16 q[CONSUMERS][DC][64 * 64];
  bf16 k[STAGES][DC][BLOCK_N * 64];
  bf16 v[STAGES][DC][BLOCK_N * 64];
  uint64_t q_full;
  uint64_t k_full[STAGES], k_empty[STAGES];
  uint64_t v_full[STAGES], v_empty[STAGES];
};
template <int DC>
constexpr int smem_bytes() {
  return sizeof(Smem<DC>) + 1024;
}
static_assert(smem_bytes<1>() <= MAX_SMEM && smem_bytes<2>() <= MAX_SMEM && smem_bytes<3>() <= MAX_SMEM &&
                  smem_bytes<4>() <= MAX_SMEM,
              "a forward instance asks for more shared memory than an H100 block has");

// S (64 x BLOCK_N) (+)= A (64 x 16, shared) * B (BLOCK_N x 16 rows, shared)^T
template <int BLOCK_N>
__device__ __forceinline__ void score_step(float (&s)[BLOCK_N / 2], uint64_t da, uint64_t db, int accumulate) {
  if constexpr (BLOCK_N == 128)
    wgmma_m64n128_ss(s, da, db, accumulate);
  else
    wgmma_m64n64_ss(s, da, db, accumulate);
}

// DC: 64-column chunks of the head dim; EDGE: D < 64 * DC (the last chunk partly zeros)
template <int DC, bool EDGE>
__global__ void __launch_bounds__(FwdCfg<DC>::NTHREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ kv_len,
                     bf16* __restrict__ out, float* __restrict__ lse, int H, int N, int M, int D, float mul) {
  constexpr int CONSUMERS = FwdCfg<DC>::CONSUMERS, BLOCK_N = FwdCfg<DC>::BLOCK_N, BLOCK_M = FwdCfg<DC>::BLOCK_M;
  constexpr uint32_t KV_BYTES = BLOCK_N * ROW_BYTES;  // one chunk of a K or V tile
  constexpr uint64_t Q_TILE = Q_BYTES >> 4, KV_TILE = KV_BYTES >> 4;  // descriptor steps from chunk to chunk
  extern __shared__ uint8_t smem_raw[];
  Smem<DC>& sm = *reinterpret_cast<Smem<DC>*>(align_1024(smem_raw));
  // B*H is folded into grid.x with the row tiles (row tile fastest), so it has no 65,535 limit of grid.y
  const int tiles = (N + BLOCK_M - 1) / BLOCK_M;
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
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: one thread issues every copy, the other 127 leave
    if constexpr (CONSUMERS > 1) regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS * 128) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      mbar_arrive_expect_tx(&sm.q_full, CONSUMERS * DC * Q_BYTES);
      for (int w = 0; w < CONSUMERS; ++w)
#pragma unroll
        for (int ch = 0; ch < DC; ++ch) tma_load_box(sm.q[w][ch], &tm_q, &sm.q_full, 64 * ch, m0 + 64 * w, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const uint32_t parity = ((j / STAGES) & 1) ^ 1;  // round 0 passes: the ring starts empty
        mbar_wait(&sm.k_empty[s], parity);
        mbar_arrive_expect_tx(&sm.k_full[s], DC * KV_BYTES);
#pragma unroll
        for (int ch = 0; ch < DC; ++ch) tma_load_box(sm.k[s][ch], &tm_k, &sm.k_full[s], 64 * ch, j * BLOCK_N, bh);
        mbar_wait(&sm.v_empty[s], parity);
        mbar_arrive_expect_tx(&sm.v_full[s], DC * KV_BYTES);
#pragma unroll
        for (int ch = 0; ch < DC; ++ch) tma_load_box(sm.v[s][ch], &tm_v, &sm.v_full[s], 64 * ch, j * BLOCK_N, bh);
      }
    }
  } else {
    if constexpr (CONSUMERS > 1) regs_alloc<CONSUMER_REGS>();
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int g = lane / 4, c = lane % 4;
    const int row0 = m0 + 64 * wg + 16 * warp + g;  // this thread's rows: row0 and row0 + 8
    const float k_log2 = mul * LOG2E;

    // turns to issue products pass from warpgroup wg to wg + 1 (named barriers 1..CONSUMERS);
    // each warpgroup has n_tiles + 1 turns, the last warpgroup starts the round and does
    // not pass on its last turn, so every barrier sees as many arrivals as waits (one consumer: no turns)
    const int my_turn = 1 + wg, next_turn = 1 + (wg + 1) % CONSUMERS;
    auto take_turn = [&]() {
      if constexpr (CONSUMERS > 1) named_sync(my_turn, 128 * CONSUMERS);
    };
    auto pass_turn = [&]() {
      if constexpr (CONSUMERS > 1) named_arrive(next_turn, 128 * CONSUMERS);
    };
    if (CONSUMERS > 1 && wg == CONSUMERS - 1 && n_tiles > 0) named_arrive(1, 128 * CONSUMERS);

    const uint64_t q_desc = desc_sw128(sm.q[wg][0]);
    float s[BLOCK_N / 2], o[DC][32];
    uint32_t pa[BLOCK_N / 16][4];
#pragma unroll
    for (int ch = 0; ch < DC; ++ch)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[ch][i] = 0.f;
    float m_r[2] = {-INFINITY, -INFINITY};  // running row maxima, times mul * log2(e)
    float l_r[2] = {0.f, 0.f};              // per-thread partial row sums, reduced at the end

    auto issue_s = [&](int j) {
      const uint64_t k_desc = desc_sw128(sm.k[j % STAGES][0]);
#pragma unroll
      for (int ch = 0; ch < DC; ++ch)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          score_step<BLOCK_N>(s, q_desc + ch * Q_TILE + kk * DESC_K16_COLS, k_desc + ch * KV_TILE + kk * DESC_K16_COLS,
                              4 * ch + kk);
      wgmma_commit();
    };
    auto issue_pv = [&](int j) {
      const uint64_t v_desc = desc_sw128(sm.v[j % STAGES][0]);
#pragma unroll
      for (int ch = 0; ch < DC; ++ch)
#pragma unroll
        for (int kk = 0; kk < BLOCK_N / 16; ++kk)
          wgmma_m64n64_rs_bt(o[ch], pa[kk], v_desc + ch * KV_TILE + kk * DESC_K16_ROWS, 1);
      wgmma_commit();
    };
    auto fence_o = [&]() {
#pragma unroll
      for (int ch = 0; ch < DC; ++ch) fence_regs(o[ch]);
    };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // online softmax of tile j in s: returns the rescale factor of the rows' earlier sums
    auto softmax = [&](int j, float (&alpha)[2]) {
      const int kbase = j * BLOCK_N;
      if (kbase + BLOCK_N > kv_lim) {
#pragma unroll
        for (int e = 0; e < BLOCK_N / 2; ++e)
          if (kbase + 8 * (e / 4) + 2 * c + (e % 2) >= kv_lim) s[e] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BLOCK_N / 8; ++i) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * i], s[4 * i + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * i + 2], s[4 * i + 3]));
      }
      float neg[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_r[h], mx[h] == -INFINITY ? -INFINITY : mx[h] * k_log2);
        alpha[h] = m_new == -INFINITY ? 1.f : ex2(m_r[h] - m_new);
        m_r[h] = m_new;
        neg[h] = m_new == -INFINITY ? 0.f : -m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < BLOCK_N / 2; ++e) {
        const int h = (e / 2) % 2;
        s[e] = ex2(fmaf(s[e], k_log2, neg[h]));
        rs[h] += s[e];
      }
      l_r[0] = l_r[0] * alpha[0] + rs[0];
      l_r[1] = l_r[1] * alpha[1] + rs[1];
    };

    mbar_wait(&sm.q_full, 0);
    if (n_tiles > 0) {
      float alpha[2];
      // turn 0: S of tile 0
      mbar_wait(&sm.k_full[0], 0);
      take_turn();
      wgmma_fence();
      issue_s(0);
      pass_turn();
      wgmma_wait<0>();
      fence_regs(s);
      release(&sm.k_empty[0]);
      softmax(0, alpha);
      pack_a<BLOCK_N / 16>(pa, s);

      // turns 1 .. n_tiles - 1: S of tile j with PV of tile j - 1
      for (int j = 1; j < n_tiles; ++j) {
        const int sj = j % STAGES, sp = (j - 1) % STAGES;
        mbar_wait(&sm.k_full[sj], (j / STAGES) & 1);
        mbar_wait(&sm.v_full[sp], ((j - 1) / STAGES) & 1);
        take_turn();
        wgmma_fence();
        issue_s(j);
        issue_pv(j - 1);
        pass_turn();
        wgmma_wait<1>();
        fence_regs(s);
        release(&sm.k_empty[sj]);
        softmax(j, alpha);
        wgmma_wait<0>();
        fence_o();
        release(&sm.v_empty[sp]);
#pragma unroll
        for (int ch = 0; ch < DC; ++ch)
#pragma unroll
          for (int i = 0; i < 32; ++i) o[ch][i] *= alpha[(i / 2) % 2];
        pack_a<BLOCK_N / 16>(pa, s);
      }

      // last turn: PV of the last tile
      const int sl = (n_tiles - 1) % STAGES;
      mbar_wait(&sm.v_full[sl], ((n_tiles - 1) / STAGES) & 1);
      take_turn();
      wgmma_fence();
      issue_pv(n_tiles - 1);
      if (wg != CONSUMERS - 1) pass_turn();
      wgmma_wait<0>();
      fence_o();
      release(&sm.v_empty[sl]);
    }

    float inv[2], lse_v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_r[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[h] = l > 0.f ? 1.f / l : 0.f;
      lse_v[h] = l > 0.f ? m_r[h] * LN2 + logf(l) : -INFINITY;
    }
    const int pitch = EDGE ? D : 64 * DC;  // a constant without EDGE
    bf16* out_bh = out + static_cast<size_t>(bh) * N * pitch;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row < N) {
#pragma unroll
        for (int ch = 0; ch < DC; ++ch) {
          uint32_t* dst = reinterpret_cast<uint32_t*>(out_bh + static_cast<size_t>(row) * pitch + 64 * ch + 2 * c);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (!EDGE || 64 * ch + 8 * i < D)
              dst[4 * i] = pack_bf16(o[ch][4 * i + 2 * h] * inv[h], o[ch][4 * i + 2 * h + 1] * inv[h]);
        }
        if (c == 0) lse[static_cast<size_t>(bh) * N + row] = lse_v[h];
      }
    }
  }
}

template <int DC, bool EDGE>
int launch_fwd(const void* q, const void* k, const void* v, const void* kv_len, void* out, void* lse, int B, int H,
               int N, int M, int D, float mul, cudaStream_t stream) {
  constexpr int BLOCK_N = FwdCfg<DC>::BLOCK_N, SMEM_BYTES = smem_bytes<DC>();
  constexpr int BLOCK_M = FwdCfg<DC>::BLOCK_M, NTHREADS = FwdCfg<DC>::NTHREADS;
  CUtensorMap tm_q, tm_k, tm_v;
  int err = make_row_map(&tm_q, q, N, B * H, 64, D);
  if (!err) err = make_row_map(&tm_k, k, M, B * H, BLOCK_N, D);
  if (!err) err = make_row_map(&tm_v, v, M, B * H, BLOCK_N, D);
  if (err) return err;
  static std::atomic<uint32_t> smem_allowed{0};
  err = allow_dynamic_smem(flash_fwd_kernel<DC, EDGE>, SMEM_BYTES, smem_allowed);
  if (err) return err;
  const unsigned grid = hopper::grid_1d(N, BLOCK_M, B * H);
  if (!grid) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_kernel<DC, EDGE><<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      tm_q, tm_k, tm_v, static_cast<const int*>(kv_len), static_cast<bf16*>(out), static_cast<float*>(lse), H, N, M,
      D, mul);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: contiguous (B*H, N or M, D) bf16, 16-byte aligned, D a multiple of 8 from 8 to 256; kv_len: (B,) int32
// or null; out (B*H, N, D) bf16, lse (B*H, N) fp32; mul: the fp32 multiplier of q k^T
extern "C" int flash_attn_fwd_bf16(const void* q, const void* k, const void* v, const void* kv_len, void* out,
                                   void* lse, int B, int H, int N, int M, int D, float mul, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {  // D = 64 DC: the instances without an edge chunk
    case 64: return launch_fwd<1, false>(q, k, v, kv_len, out, lse, B, H, N, M, D, mul, s);
    case 128: return launch_fwd<2, false>(q, k, v, kv_len, out, lse, B, H, N, M, D, mul, s);
    case 192: return launch_fwd<3, false>(q, k, v, kv_len, out, lse, B, H, N, M, D, mul, s);
    case 256: return launch_fwd<4, false>(q, k, v, kv_len, out, lse, B, H, N, M, D, mul, s);
  }
  if (D < 8 || D > 256 || D % 8) return static_cast<int>(cudaErrorInvalidValue);
  switch ((D + 63) / 64) {
    case 1: return launch_fwd<1, true>(q, k, v, kv_len, out, lse, B, H, N, M, D, mul, s);
    case 2: return launch_fwd<2, true>(q, k, v, kv_len, out, lse, B, H, N, M, D, mul, s);
    case 3: return launch_fwd<3, true>(q, k, v, kv_len, out, lse, B, H, N, M, D, mul, s);
    default: return launch_fwd<4, true>(q, k, v, kv_len, out, lse, B, H, N, M, D, mul, s);
  }
}
