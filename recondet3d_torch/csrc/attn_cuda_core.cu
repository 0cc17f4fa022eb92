// Attention on the CUDA cores for Hopper (sm_90a), forward and backward: the
// fp32 instances of the Pallas TPU kernels `_flash_kernel`,
// `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel`
// (recondet3d/ops/attention.py:54, 185, 231), at any head dim (the camera
// encoder's trunk, CameraEnc: 16 heads of dim_out / 16, D = 24 to 96, one
// token a view). Calls are routed here for fp32 only: the wgmma kernels
// (csrc/flash_attn_fwd.cu, flash_attn_bwd.cu) take bf16 at every D. Two
// designs:
//   - short sequences (N, M <= 32: every CameraEnc up to the CLI's 32 views):
//     cc_short_fwd_kernel, the forward in one pass, and cc_short_bwd_kernel,
//     dq, dk and dv in one launch (ops/attention.py attention_fwd_short,
//     attention_bwd_short). fp32 only.
//   - any length: the tiled cc_fwd_kernel, cc_bwd_dq_kernel and
//     cc_bwd_dkv_kernel, templated on fp32 / bf16. fp32 past N or M = 32 is
//     routed to them; their bf16 instances and their fp32 ones at short
//     lengths stay callable (attention_fwd_cuda_core,
//     attention_bwd_dq_cuda_core, attention_bwd_dkv_cuda_core) as the
//     CUDA-core times the other kernels are held against.
// D runs from 1 to 256, N and M from 1 up, B*H up to the 2^31 - 1 CTAs of a
// one-dimensional grid (the heads are folded into grid.x).
//
// What each computes, per (batch*head), with q' and mul from
// ops/attention.py _cc_score_operand (bf16: q' k^T * mul equals qs k^T, qs =
// q * scale rounded to bf16; fp32: raw q and the scale, the same scores to
// fp32 rounding) and R() rounding to the input type (a no-op for fp32), as
// attention_plain / attention_bwd_plain have it:
//   forward  s = (q' . k) * mul, -1e30 for keys >= kv_len[b]
//            out = sum(R(exp(s - m)) v) / sum(exp(s - m)),  lse = m + log(sum(exp(s - m)))
//   dq       p = exp((q' . k) * mul - lse) (0 for keys >= kv_len[b]), dp = dO . v,
//            dS = R(p * (dp - delta)),  dq = scale * sum_k dS k
//   dk, dv   dv = sum_q R(p) dO,  dk = scale * sum_q dS q    (q raw, as the plain version has it)
// with fp32 products and sums (no tensor cores, no TF32) and delta = rowsum(dO * O): from the caller for the
// tiled kernels (a PyTorch expression, as in the JAX package), in the kernel for the short one.
//
// What bounds them on an H100: at the camera encoder's shapes (B, 16, 6, D) a
// call is a few thousand operations a head, far below a microsecond of the
// card's fp32 rate or of its memory rate: the launch and the round trips to
// memory are the cost. The short kernels therefore make one launch a call
// (the backward's three kernels and delta's expression become one), copy a
// head's inputs into shared memory by cp.async, every copy in flight at once
// (16 bytes a thread where D % 4 == 0; no register holds them), read q, k,
// v, O and dO through any B, H and row strides (the qkv split's views: no
// copy before the call) and write the forward's output as (B, N, H, D), the
// layout the output projection reads (no copy after it):
//   - forward: one CTA a head at up to 8 query rows (8 / N heads a CTA below
//     5 rows, so that a CTA keeps at least 5 warps), and a head of more rows
//     over ceil(N / 8) CTAs of 8 rows each, which stage the head's keys and
//     values each (on an H100, one CTA a head of 32 rows left 100 SMs idle
//     and ran 1.7x slower than the tiled kernel); one warp a query row, one key a lane: an
//     exact softmax, the max and the sum over shuffles, no rescale and no
//     tile loop; lane l accumulates output columns l, l + 32, ...;
//   - backward: one CTA a head (or G = 8 / max(N, M)), max(N, M) warps; the
//     head's q, k, v, O, dO and lse in shared memory; warp i computes row i
//     of P and dS (lane j: p_ij, dp_ij = dO_i . v_j, delta_i = dO_i . O_i)
//     into shared memory; after a barrier warp i sums dq_i and warp j dk_j
//     and dv_j, lane l over columns l, l + 32, ...
// At long sequences the tiled kernels do 4, 6 and 8 * N * M * D fp32
// operations on the CUDA cores (67 TFLOP/s), against 989 TFLOP/s of bf16
// tensor cores for the wgmma kernels: they are for shapes no DA3 trunk gives
// (every trunk has D = 64), and are simple rather than fast:
//   - one CTA of 8 warps per (b*h, 8 rows), one warp a row: query rows in the
//     forward and dq, key rows in dk/dv. The CTA's own rows sit in shared
//     memory;
//   - the other side streams through shared memory in tiles (64 keys in the
//     forward, 32 keys or queries in the backward), rows padded to D + 1
//     floats so that 32 lanes reading 32 rows' column d hit 32 banks;
//   - lane j scores the tile's row j (and j + 32 in the forward) with four
//     partial sums (a single chain of D dependent FMAs was the forward's
//     latency), the warp reduces with shuffles, and lane j accumulates output
//     columns j, j + 32, ... (COLS = ceil(D / 32) of them in registers).
// No atomics: every output element is summed by one lane in a fixed order, so
// results are the same bits from run to run.
//
// C interface for ctypes: each entry returns a cudaError_t value (0 on success).

#include <string.h>

#include "hopper_common.cuh"  // host helpers: grid_1d, allow_dynamic_smem

namespace {

constexpr int NWARPS = 8;
constexpr int ROWS = NWARPS;  // a CTA's own rows: one a warp
constexpr int NTHREADS = 32 * NWARPS;
constexpr int FWD_TILE = 64;  // keys a forward tile: two a lane
constexpr int BWD_TILE = 32;  // keys (dq) or queries (dk/dv) a backward tile: one a lane
constexpr int MAX_D = 256;
constexpr float MASKED = -1e30f;  // attention_plain's logit of a key >= kv_len

enum Dtype { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }
// x rounded to T and back (round to nearest even, as torch's .to(bfloat16))
template <typename T>
__device__ __forceinline__ float round_t(float x) { return to_f(from_f<T>(x)); }

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

// a . b over D floats, four partial sums; ``a`` is a row every lane reads (the same address: a broadcast),
// read 16 bytes at a time where D is a multiple of 4 (rows of D floats from a 16-byte aligned base); UNROLL steps
// of the vector loop are issued together (the same sums in the same order)
template <int UNROLL = 1>
__device__ __forceinline__ float dot(const float* a, const float* b, int D) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  int d = 0;
  if (D % 4 == 0) {
#pragma unroll UNROLL
    for (; d < D; d += 4) {
      const float4 av = *reinterpret_cast<const float4*>(a + d);
      part[0] = fmaf(av.x, b[d], part[0]);
      part[1] = fmaf(av.y, b[d + 1], part[1]);
      part[2] = fmaf(av.z, b[d + 2], part[2]);
      part[3] = fmaf(av.w, b[d + 3], part[3]);
    }
  }
  for (; d + 4 <= D; d += 4) {
    part[0] = fmaf(a[d], b[d], part[0]);
    part[1] = fmaf(a[d + 1], b[d + 1], part[1]);
    part[2] = fmaf(a[d + 2], b[d + 2], part[2]);
    part[3] = fmaf(a[d + 3], b[d + 3], part[3]);
  }
  for (; d < D; ++d) part[d % 4] = fmaf(a[d], b[d], part[d % 4]);
  return (part[0] + part[1]) + (part[2] + part[3]);
}

// rows [r0, r0 + n) of a (rows, D) matrix of T into `dst` as fp32 with row pitch `pitch`; rows past `rows` as 0
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0, int n, int rows, int D, int pitch) {
  for (int i = threadIdx.x; i < n * D; i += NTHREADS) {
    const int r = r0 + i / D, d = i % D;
    dst[(i / D) * pitch + d] = r < rows ? to_f(src[static_cast<size_t>(r) * D + d]) : 0.f;
  }
}

// `stage` for two (rows, D) matrices over the same rows, in one pass: both loads of an element are in flight
// together (at the camera encoder's six rows a pass is one round trip to memory)
template <typename T>
__device__ __forceinline__ void stage2(float* da, float* db, const T* a, const T* b, int r0, int n, int rows, int D,
                                       int pitch) {
  for (int i = threadIdx.x; i < n * D; i += NTHREADS) {
    const int r = r0 + i / D, d = i % D;
    const size_t at = static_cast<size_t>(r) * D + d;
    const bool in = r < rows;
    da[(i / D) * pitch + d] = in ? to_f(a[at]) : 0.f;
    db[(i / D) * pitch + d] = in ? to_f(b[at]) : 0.f;
  }
}

template <typename T, int COLS>
__global__ void __launch_bounds__(NTHREADS)
    cc_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const int* __restrict__ kv_len, T* __restrict__ out, float* __restrict__ lse, int H, int N, int M,
                  int D, float mul) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* qs = smem;                  // ROWS x D
  float* ks = qs + ROWS * D;         // FWD_TILE x DP
  float* vs = ks + FWD_TILE * DP;    // FWD_TILE x DP

  const int tiles = (N + ROWS - 1) / ROWS;
  const int bh = blockIdx.x / tiles, m0 = (blockIdx.x % tiles) * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kv_lim = kv_len ? min(M, max(kv_len[bh / H], 0)) : M;
  // with no key left every logit is -1e30, and the plain softmax is uniform over all M keys
  const int n_keys = kv_lim > 0 ? kv_lim : M;
  const T* k_bh = k + static_cast<size_t>(bh) * M * D;
  const T* v_bh = v + static_cast<size_t>(bh) * M * D;
  stage(qs, q + static_cast<size_t>(bh) * N * D, m0, ROWS, N, D, D);

  const float* qrow = qs + warp * D;
  float m_r = -INFINITY, l_r = 0.f, acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.f;

  for (int kb = 0; kb < n_keys; kb += FWD_TILE) {
    __syncthreads();  // the previous tile is no longer read (and, at kb = 0, q is written)
    // only the keys that count are staged: the scores of the rows past them are discarded below (-inf)
    const int kend = min(FWD_TILE, n_keys - kb);
    stage2(ks, vs, k_bh, v_bh, kb, kend, M, D, DP);
    __syncthreads();
    float s[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
      const float sc = j < kend ? dot(qrow, ks + j * DP, D) * mul : 0.f;
      s[h] = j >= kend ? -INFINITY : (kb + j < kv_lim ? sc : MASKED);
    }
    const float m_new = fmaxf(m_r, warp_max(fmaxf(s[0], s[1])));
    const float alpha = expf(m_r - m_new);  // 0 on the first tile (m_r = -inf)
    const float p0 = expf(s[0] - m_new), p1 = expf(s[1] - m_new);
    l_r = l_r * alpha + warp_sum(p0 + p1);
    m_r = m_new;
    // P is rounded to the input type before P V, as the TPU kernel has it
    const float r0 = round_t<T>(p0), r1 = round_t<T>(p1);
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[c] *= alpha;
    for (int j = 0; j < kend; ++j) {
      const float p = __shfl_sync(0xffffffffu, j < 32 ? r0 : r1, j % 32);
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
  T* orow = out + (static_cast<size_t>(bh) * N + row) * D;
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int d = lane + 32 * c;
    if (d < D) orow[d] = from_f<T>(acc[c] * inv);
  }
  if (lane == 0) lse[static_cast<size_t>(bh) * N + row] = m_r + logf(l_r);
}

// dq: one warp a query row, looping over tiles of 32 keys
template <typename T, int COLS>
__global__ void __launch_bounds__(NTHREADS)
    cc_bwd_dq_kernel(const T* __restrict__ qk, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ kv_len, T* __restrict__ dq, int H, int N, int M, int D, float mul,
                     float scale) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* qs = smem;                  // ROWS x D: q'
  float* gs = qs + ROWS * D;         // ROWS x D: dO
  float* ks = gs + ROWS * D;         // BWD_TILE x DP
  float* vs = ks + BWD_TILE * DP;    // BWD_TILE x DP

  const int tiles = (N + ROWS - 1) / ROWS;
  const int bh = blockIdx.x / tiles, m0 = (blockIdx.x % tiles) * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = m0 + warp;
  const int kv_lim = kv_len ? min(M, max(kv_len[bh / H], 0)) : M;  // keys past it get p = 0
  const T* k_bh = k + static_cast<size_t>(bh) * M * D;
  const T* v_bh = v + static_cast<size_t>(bh) * M * D;
  stage2(qs, gs, qk + static_cast<size_t>(bh) * N * D, dout + static_cast<size_t>(bh) * N * D, m0, ROWS, N, D, D);
  const size_t at = static_cast<size_t>(bh) * N + min(row, N - 1);
  const float lse_r = lse[at], delta_r = delta[at];

  const float* qrow = qs + warp * D;
  const float* grow = gs + warp * D;
  float acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.f;

  for (int kb = 0; kb < kv_lim; kb += BWD_TILE) {
    __syncthreads();
    const int kend = min(BWD_TILE, kv_lim - kb);
    stage2(ks, vs, k_bh, v_bh, kb, kend, M, D, DP);
    __syncthreads();
    float ds = 0.f;
    if (lane < kend) {
      const float p = expf(dot(qrow, ks + lane * DP, D) * mul - lse_r);
      ds = round_t<T>(p * (dot(grow, vs + lane * DP, D) - delta_r));
    }
    for (int j = 0; j < kend; ++j) {
      const float dsj = __shfl_sync(0xffffffffu, ds, j);
      const float* krow = ks + j * DP;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int d = lane + 32 * c;
        if (d < D) acc[c] = fmaf(dsj, krow[d], acc[c]);
      }
    }
  }

  if (row >= N) return;
  T* orow = dq + (static_cast<size_t>(bh) * N + row) * D;
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int d = lane + 32 * c;
    if (d < D) orow[d] = from_f<T>(acc[c] * scale);
  }
}

// dk, dv: one warp a key row, looping over tiles of 32 queries
template <typename T, int COLS>
__global__ void __launch_bounds__(NTHREADS)
    cc_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ qk, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, const int* __restrict__ kv_len, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int N, int M, int D, float mul, float scale) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* ks = smem;                   // ROWS x D
  float* vs = ks + ROWS * D;          // ROWS x D
  float* qks = vs + ROWS * D;         // BWD_TILE x DP: q'
  float* qs = qks + BWD_TILE * DP;    // BWD_TILE x DP: q
  float* gs = qs + BWD_TILE * DP;     // BWD_TILE x DP: dO
  float* ls = gs + BWD_TILE * DP;     // BWD_TILE: lse
  float* es = ls + BWD_TILE;          // BWD_TILE: delta

  const int tiles = (M + ROWS - 1) / ROWS;
  const int bh = blockIdx.x / tiles, k0 = (blockIdx.x % tiles) * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int key = k0 + warp;
  const int kv_lim = kv_len ? min(M, max(kv_len[bh / H], 0)) : M;
  const bool live = key < kv_lim;  // a key past kv_len gets p = 0 for every query: zero gradients
  const bool any_live = k0 < kv_lim;
  const size_t qo = static_cast<size_t>(bh) * N * D;
  stage2(ks, vs, k + static_cast<size_t>(bh) * M * D, v + static_cast<size_t>(bh) * M * D, k0, ROWS, M, D, D);

  const float* krow = ks + warp * D;
  const float* vrow = vs + warp * D;
  float adk[COLS], adv[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) adk[c] = adv[c] = 0.f;

  for (int qb = 0; any_live && qb < N; qb += BWD_TILE) {
    __syncthreads();
    const int qend = min(BWD_TILE, N - qb);
    stage2(qks, gs, qk + qo, dout + qo, qb, qend, N, D, DP);
    if (q != qk) stage(qs, q + qo, qb, qend, N, D, DP);
    for (int i = threadIdx.x; i < qend; i += NTHREADS) {
      ls[i] = lse[static_cast<size_t>(bh) * N + qb + i];
      es[i] = delta[static_cast<size_t>(bh) * N + qb + i];
    }
    __syncthreads();
    const float* qraw = q != qk ? qs : qks;
    float pr = 0.f, ds = 0.f;
    if (live && lane < qend) {
      const float p = expf(dot(krow, qks + lane * DP, D) * mul - ls[lane]);
      pr = round_t<T>(p);
      ds = round_t<T>(p * (dot(vrow, gs + lane * DP, D) - es[lane]));
    }
    if (!live) continue;
    for (int i = 0; i < qend; ++i) {
      const float pi = __shfl_sync(0xffffffffu, pr, i);
      const float dsi = __shfl_sync(0xffffffffu, ds, i);
      const float* g = gs + i * DP;
      const float* qi = qraw + i * DP;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int d = lane + 32 * c;
        if (d < D) {
          adv[c] = fmaf(pi, g[d], adv[c]);
          adk[c] = fmaf(dsi, qi[d], adk[c]);
        }
      }
    }
  }

  if (key >= M) return;
  const size_t ko = (static_cast<size_t>(bh) * M + key) * D;
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int d = lane + 32 * c;
    if (d < D) {
      dk[ko + d] = from_f<T>(adk[c] * scale);
      dv[ko + d] = from_f<T>(adv[c]);
    }
  }
}

// ------------------------------------------------------------------ short sequences: N, M <= 32, fp32

constexpr int SHORT_ROWS = 32;         // the most query or key rows of a head: one a warp, one key a lane
constexpr int SHORT_THREADS = 1024;    // 32 warps: N (forward) or max(N, M) (backward) a head
constexpr int SHORT_WARPS_PACKED = 8;  // heads of fewer than 5 warps are packed 8 / warps to a CTA
constexpr int STAGED_MAX = 5;          // q, dO, O, k, v
constexpr int SHORT_FWD_ROWS = 8;      // query rows a forward CTA: a head of more spreads over ceil(N / 8) CTAs

// odd row pitch of the rows a lane reads whole (keys, values in the backward): lane j reading column d of row j
// hits bank (j * pitch + d) % 32, a different one for each of 32 lanes
__host__ __device__ __forceinline__ int odd_pitch(int D) { return D | 1; }

// the (B, H, rows, D) fp32 views a CTA stages, each with a unit stride along D and any B, H and row strides (in
// elements), and where each head's rows go in shared memory: floats from `off`, `rows * pitch` of them a head
struct Staged {
  const float* src[STAGED_MAX];
  long long sb[STAGED_MAX], sh[STAGED_MAX], sr[STAGED_MAX];
  int rows[STAGED_MAX], pitch[STAGED_MAX], off[STAGED_MAX];
  int n;
};

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(hopper::smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Every row of `st` for heads [bh0, bh0 + G) into shared memory by cp.async, view by view, a thread a chunk of 16
// bytes (VEC: D % 4 == 0 and 16-byte aligned rows; 4 bytes otherwise) in turn: no thread waits for a copy before it
// has issued all of its own, so a head's inputs arrive in about one round trip to memory, and no register holds
// them on the way. A chunk bound for a row of odd pitch goes as four 4-byte copies. Heads at or past BH are
// skipped. The first view's rows start at source row `row0` (a forward CTA's tile of query rows), and none at or
// past `limit0` is read. The caller's __syncthreads() makes the copies visible to the CTA.
template <bool VEC>
__device__ __forceinline__ void stage_short(float* smem, const Staged& st, int bh0, int G, int BH, int H, int D,
                                            int row0 = 0, int limit0 = 0x7fffffff) {
  constexpr int W = VEC ? 4 : 1;
  const int C = D / W;
#pragma unroll
  for (int t = 0; t < STAGED_MAX; ++t) {  // constant indices into the parameter: no local copy
    if (t >= st.n) break;
    const int per_head = st.rows[t] * C;
    const bool wide = VEC && st.pitch[t] % 4 == 0 && st.off[t] % 4 == 0;
    for (int i = threadIdx.x; i < G * per_head; i += blockDim.x) {
      const int g = i / per_head, rem = i - g * per_head, r = rem / C, c = (rem - r * C) * W, bh = bh0 + g;
      if (bh >= BH) break;  // the heads past BH come last
      const int row = t == 0 ? row0 + r : r;
      if (t == 0 && row >= limit0) continue;
      const float* src = st.src[t] + (bh / H) * st.sb[t] + (bh % H) * st.sh[t] + row * st.sr[t] + c;
      float* dst = smem + st.off[t] + (g * st.rows[t] + r) * st.pitch[t] + c;
      if (wide) {
        cp_async_16(dst, src);
      } else {
#pragma unroll
        for (int e = 0; e < W; ++e) hopper::cp_async_4(dst + e, src + e, 4);
      }
    }
  }
  cp_async_wait_all();
}

// forward: st = {q (R = min(N, 8) rows of the CTA's tile, pitch D), k (M, odd pitch), v (M, pitch D)}; out (B, N,
// H, D), lse (B*H, N). CTA x serves query rows [tile * R, tile * R + R) of heads [hg * G, hg * G + G), tile = x % T
// and hg = x / T with T = ceil(N / R) tiles a head (TILES: N > 8; else R = N, one tile, and none of its arithmetic)
template <int COLS, bool VEC, bool TILES>
__global__ void __launch_bounds__(SHORT_THREADS)
    cc_short_fwd_kernel(const Staged st, const int* __restrict__ kv_len, float* __restrict__ out,
                        float* __restrict__ lse, int BH, int H, int N, int M, int D, int G, float mul) {
  extern __shared__ __align__(16) float smem[];
  const int R = TILES ? SHORT_FWD_ROWS : N, T = TILES ? (N + R - 1) / R : 1;
  const int tile = TILES ? blockIdx.x % T : 0, bh0 = (TILES ? blockIdx.x / T : blockIdx.x) * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = warp / R, i = tile * R + warp % R;
  const int bh = bh0 + g, b = min(bh, BH - 1) / H;
  const int kv_lim = kv_len ? min(M, max(kv_len[b], 0)) : M;  // read while the copies fly
  if (TILES) stage_short<VEC>(smem, st, bh0, G, BH, H, D, tile * R, N);
  else stage_short<VEC>(smem, st, bh0, G, BH, H, D);
  __syncthreads();
  if (bh >= BH || (TILES && i >= N)) return;

  const int KP = odd_pitch(D);
  const float* qrow = smem + st.off[0] + (g * R + warp % R) * D;
  const float* kh = smem + st.off[1] + g * M * KP;
  const float* vh = smem + st.off[2] + g * M * D;
  // with no key left every logit is -1e30, and the plain softmax is uniform over all M keys
  float s = -INFINITY;
  if (lane < M) s = lane < kv_lim ? dot<4>(qrow, kh + lane * KP, D) * mul : MASKED;
  const float m = warp_max(s);
  const float p = expf(s - m);  // 0 on lanes past M
  const float l = warp_sum(p);
  float acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.f;
#pragma unroll 4
  for (int j = 0; j < M; ++j) {
    const float pj = __shfl_sync(0xffffffffu, p, j);
    const float* vrow = vh + j * D;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int d = lane + 32 * c;
      if (d < D) acc[c] = fmaf(pj, vrow[d], acc[c]);
    }
  }
  const float inv = 1.f / l;
  float* orow = out + ((static_cast<size_t>(b) * N + i) * H + bh % H) * D;
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int d = lane + 32 * c;
    if (d < D) orow[d] = acc[c] * inv;
  }
  if (lane == 0) lse[static_cast<size_t>(bh) * N + i] = m + logf(l);
}

// backward: st = {q (N rows, pitch D), dO (N, pitch D), O (N, pitch D), k (M, odd pitch), v (M, odd pitch)}; after
// them in shared memory lse (N a head), P and dS (N x M a head); dq (B*H, N, D), dk and dv (B*H, M, D)
template <int COLS, bool VEC>
__global__ void __launch_bounds__(SHORT_THREADS)
    cc_short_bwd_kernel(const Staged st, const float* __restrict__ lse, const int* __restrict__ kv_len,
                        float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv, int BH, int H, int N,
                        int M, int D, int G, float mul, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int KP = odd_pitch(D);
  float* ls = smem + st.off[4] + G * M * KP;  // G x N
  float* ps = ls + G * N;                      // G x N x M: P
  float* dss = ps + G * N * M;                 // G x N x M: dS
  const int W = max(N, M);
  const int bh0 = blockIdx.x * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = warp / W, w = warp - g * W;
  const int bh = bh0 + g, b = min(bh, BH - 1) / H;
  const int kv_lim = kv_len ? min(M, max(kv_len[b], 0)) : M;  // keys past it get p = 0
  for (int i = threadIdx.x; i < G * N; i += blockDim.x)
    ls[i] = bh0 + i / N < BH ? __ldg(lse + static_cast<size_t>(bh0) * N + i) : 0.f;
  stage_short<VEC>(smem, st, bh0, G, BH, H, D);
  __syncthreads();
  const bool live = bh < BH;
  const float* qh = smem + st.off[0] + g * N * D;
  const float* gh = smem + st.off[1] + g * N * D;
  const float* oh = smem + st.off[2] + g * N * D;
  const float* kh = smem + st.off[3] + g * M * KP;
  const float* vh = smem + st.off[4] + g * M * KP;
  float* ph = ps + g * N * M;
  float* dsh = dss + g * N * M;

  if (live && w < N) {  // row w of P and dS: lane j the key
    const float* grow = gh + w * D;
    const float* orow = oh + w * D;
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int d = lane + 32 * c;
      if (d < D) part = fmaf(grow[d], orow[d], part);
    }
    const float delta = warp_sum(part);
    if (lane < M) {
      const float p = lane < kv_lim ? expf(dot<4>(qh + w * D, kh + lane * KP, D) * mul - ls[g * N + w]) : 0.f;
      ph[w * M + lane] = p;
      dsh[w * M + lane] = p * (dot<4>(grow, vh + lane * KP, D) - delta);
    }
  }
  __syncthreads();
  if (!live) return;

  if (w < N) {  // dq_w = scale * sum_j dS_wj k_j
    float acc[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[c] = 0.f;
    for (int j = 0; j < M; ++j) {
      const float dsj = dsh[w * M + j];
      const float* krow = kh + j * KP;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int d = lane + 32 * c;
        if (d < D) acc[c] = fmaf(dsj, krow[d], acc[c]);
      }
    }
    float* row = dq + (static_cast<size_t>(bh) * N + w) * D;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int d = lane + 32 * c;
      if (d < D) row[d] = acc[c] * scale;
    }
  }
  if (w < M) {  // dk_w = scale * sum_i dS_iw q_i, dv_w = sum_i P_iw dO_i
    float adk[COLS], adv[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) adk[c] = adv[c] = 0.f;
    for (int i = 0; i < N; ++i) {
      const float pi = ph[i * M + w], dsi = dsh[i * M + w];
      const float* qi = qh + i * D;
      const float* gi = gh + i * D;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int d = lane + 32 * c;
        if (d < D) {
          adk[c] = fmaf(dsi, qi[d], adk[c]);
          adv[c] = fmaf(pi, gi[d], adv[c]);
        }
      }
    }
    const size_t at = (static_cast<size_t>(bh) * M + w) * D;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        dk[at + d] = adk[c] * scale;
        dv[at + d] = adv[c];
      }
    }
  }
}

// heads a CTA serves: 8 / warps when a head has fewer than 5 warps, else 1; never more than there are heads
int short_heads(int warps, long long BH) {
  const int g = warps < 5 ? SHORT_WARPS_PACKED / warps : 1;
  return static_cast<int>(g < BH ? g : BH);
}

// shared memory of the forward: q (R = min(N, 8) rows x D), k (M x odd pitch), v (M x D) a head
int short_fwd_smem(int G, int N, int M, int D) {
  const int R = N < SHORT_FWD_ROWS ? N : SHORT_FWD_ROWS;
  return static_cast<int>(sizeof(float)) * G * (R * D + M * odd_pitch(D) + M * D);
}

// shared memory of the backward: q, dO, O (N x D each), k, v (M x odd pitch each), lse (N), P and dS (N x M each)
// a head. At N = M = 32 and D = 256: 4 * (3 * 8,192 + 2 * 8,224 + 32 + 2 * 1,024) = 172,416 bytes of the 232,448 a
// CTA may have; heads are packed only at fewer than 5 warps, where G heads take less than that
int short_bwd_smem(int G, int N, int M, int D) {
  return static_cast<int>(sizeof(float)) * G * (3 * N * D + 2 * M * odd_pitch(D) + N + 2 * N * M);
}

// 16-byte loads where D is a multiple of 4 and every row of every view starts on a 16-byte boundary
bool short_vec(const Staged& st, int D) {
  if (D % 4) return false;
  for (int t = 0; t < st.n; ++t)
    if ((reinterpret_cast<uintptr_t>(st.src[t]) % 16) || st.sb[t] % 4 || st.sh[t] % 4 || st.sr[t] % 4) return false;
  return true;
}

void stage_view(Staged& st, const void* src, const long long* strides, int rows, int pitch, int& off) {
  const int t = st.n++;
  st.src[t] = static_cast<const float*>(src);
  st.sb[t] = strides[0], st.sh[t] = strides[1], st.sr[t] = strides[2];
  st.rows[t] = rows, st.pitch[t] = pitch, st.off[t] = off;
  off += rows * pitch;  // times G below
}

template <int COLS, bool VEC, bool TILES>
int short_fwd_launch(const Staged& st, const void* kv_len, void* out, void* lse, int BH, int H, int N, int M, int D,
                     int G, float mul, cudaStream_t stream) {
  static std::atomic<uint32_t> allowed{0};
  auto kern = cc_short_fwd_kernel<COLS, VEC, TILES>;
  const int R = N < SHORT_FWD_ROWS ? N : SHORT_FWD_ROWS;
  const unsigned grid = hopper::grid_1d(BH, G, 1, (N + R - 1) / R);
  if (!grid) return static_cast<int>(cudaErrorInvalidValue);
  if (int err = hopper::allow_dynamic_smem(kern, short_fwd_smem(1, SHORT_ROWS, SHORT_ROWS, 32 * COLS), allowed))
    return err;
  kern<<<grid, 32 * G * R, short_fwd_smem(G, N, M, D), stream>>>(
      st, static_cast<const int*>(kv_len), static_cast<float*>(out), static_cast<float*>(lse), BH, H, N, M, D, G, mul);
  return static_cast<int>(cudaGetLastError());
}

template <int COLS>
int short_fwd(const Staged& st, const void* kv_len, void* out, void* lse, int BH, int H, int N, int M, int D, int G,
              float mul, cudaStream_t stream) {
  const bool vec = short_vec(st, D);
  if (N > SHORT_FWD_ROWS)
    return vec ? short_fwd_launch<COLS, true, true>(st, kv_len, out, lse, BH, H, N, M, D, G, mul, stream)
               : short_fwd_launch<COLS, false, true>(st, kv_len, out, lse, BH, H, N, M, D, G, mul, stream);
  return vec ? short_fwd_launch<COLS, true, false>(st, kv_len, out, lse, BH, H, N, M, D, G, mul, stream)
             : short_fwd_launch<COLS, false, false>(st, kv_len, out, lse, BH, H, N, M, D, G, mul, stream);
}

template <int COLS, bool VEC>
int short_bwd_launch(const Staged& st, const void* lse, const void* kv_len, void* dq, void* dk, void* dv, int BH,
                     int H, int N, int M, int D, int G, float mul, float scale, cudaStream_t stream) {
  static std::atomic<uint32_t> allowed{0};
  auto kern = cc_short_bwd_kernel<COLS, VEC>;
  const unsigned grid = hopper::grid_1d(BH, G, 1);
  if (!grid) return static_cast<int>(cudaErrorInvalidValue);
  if (int err = hopper::allow_dynamic_smem(kern, short_bwd_smem(1, SHORT_ROWS, SHORT_ROWS, 32 * COLS), allowed))
    return err;
  kern<<<grid, 32 * G * (N > M ? N : M), short_bwd_smem(G, N, M, D), stream>>>(
      st, static_cast<const float*>(lse), static_cast<const int*>(kv_len), static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), BH, H, N, M, D, G, mul, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int COLS>
int short_bwd(const Staged& st, const void* lse, const void* kv_len, void* dq, void* dk, void* dv, int BH, int H,
              int N, int M, int D, int G, float mul, float scale, cudaStream_t stream) {
  return short_vec(st, D)
             ? short_bwd_launch<COLS, true>(st, lse, kv_len, dq, dk, dv, BH, H, N, M, D, G, mul, scale, stream)
             : short_bwd_launch<COLS, false>(st, lse, kv_len, dq, dk, dv, BH, H, N, M, D, G, mul, scale, stream);
}

// returns FN<COLS>(args...) for the least COLS in {1, 2, 4, 8} with 32 * COLS >= D
#define SHORT_DISPATCH(FN, ...)                                  \
  switch (D <= 32 ? 1 : D <= 64 ? 2 : D <= 128 ? 4 : 8) {        \
    case 1: return FN<1>(__VA_ARGS__);                           \
    case 2: return FN<2>(__VA_ARGS__);                           \
    case 4: return FN<4>(__VA_ARGS__);                           \
    default: return FN<8>(__VA_ARGS__);                          \
  }

int fwd_smem(int D) { return static_cast<int>(sizeof(float)) * (ROWS * D + 2 * FWD_TILE * (D + 1)); }
int dq_smem(int D) { return static_cast<int>(sizeof(float)) * (2 * ROWS * D + 2 * BWD_TILE * (D + 1)); }
int dkv_smem(int D) { return static_cast<int>(sizeof(float)) * (2 * ROWS * D + 3 * BWD_TILE * (D + 1) + 2 * BWD_TILE); }

bool shape_ok(int B, int H, int N, int M, int D) {
  return B >= 1 && H >= 1 && N >= 1 && M >= 1 && D >= 1 && D <= MAX_D;
}

template <typename T, int COLS>
int fwd(const void* q, const void* k, const void* v, const void* kv_len, void* out, void* lse, int B, int H, int N,
        int M, int D, float mul, cudaStream_t stream) {
  static std::atomic<uint32_t> allowed{0};
  auto kern = cc_fwd_kernel<T, COLS>;
  const int smem = fwd_smem(D);
  const unsigned grid = hopper::grid_1d(N, ROWS, B * H);
  if (!grid) return static_cast<int>(cudaErrorInvalidValue);
  if (int err = hopper::allow_dynamic_smem(kern, fwd_smem(32 * COLS), allowed)) return err;
  kern<<<grid, NTHREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), static_cast<const int*>(kv_len),
                                         static_cast<T*>(out), static_cast<float*>(lse), H, N, M, D, mul);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int COLS>
int bwd_dq(const void* qk, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
           const void* kv_len, void* dq, int B, int H, int N, int M, int D, float mul, float scale,
           cudaStream_t stream) {
  static std::atomic<uint32_t> allowed{0};
  auto kern = cc_bwd_dq_kernel<T, COLS>;
  const unsigned grid = hopper::grid_1d(N, ROWS, B * H);
  if (!grid) return static_cast<int>(cudaErrorInvalidValue);
  if (int err = hopper::allow_dynamic_smem(kern, dq_smem(32 * COLS), allowed)) return err;
  kern<<<grid, NTHREADS, dq_smem(D), stream>>>(
      static_cast<const T*>(qk), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<const int*>(kv_len),
      static_cast<T*>(dq), H, N, M, D, mul, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int COLS>
int bwd_dkv(const void* q, const void* qk, const void* k, const void* v, const void* dout, const void* lse,
            const void* delta, const void* kv_len, void* dk, void* dv, int B, int H, int N, int M, int D, float mul,
            float scale, cudaStream_t stream) {
  static std::atomic<uint32_t> allowed{0};
  auto kern = cc_bwd_dkv_kernel<T, COLS>;
  const unsigned grid = hopper::grid_1d(M, ROWS, B * H);
  if (!grid) return static_cast<int>(cudaErrorInvalidValue);
  if (int err = hopper::allow_dynamic_smem(kern, dkv_smem(32 * COLS), allowed)) return err;
  kern<<<grid, NTHREADS, dkv_smem(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(qk), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<T*>(dk), static_cast<T*>(dv), H, N, M, D, mul, scale);
  return static_cast<int>(cudaGetLastError());
}

// returns FN<T, COLS>(args...) for the element type and the least COLS in {1, 2, 4, 8} with 32 * COLS >= D
#define CC_DISPATCH(FN, ...)                                       \
  const int cols = D <= 32 ? 1 : D <= 64 ? 2 : D <= 128 ? 4 : 8;   \
  if (dtype == F32) {                                              \
    switch (cols) {                                                \
      case 1: return FN<float, 1>(__VA_ARGS__);                    \
      case 2: return FN<float, 2>(__VA_ARGS__);                    \
      case 4: return FN<float, 4>(__VA_ARGS__);                    \
      default: return FN<float, 8>(__VA_ARGS__);                   \
    }                                                              \
  }                                                                \
  switch (cols) {                                                  \
    case 1: return FN<__nv_bfloat16, 1>(__VA_ARGS__);              \
    case 2: return FN<__nv_bfloat16, 2>(__VA_ARGS__);              \
    case 4: return FN<__nv_bfloat16, 4>(__VA_ARGS__);              \
    default: return FN<__nv_bfloat16, 8>(__VA_ARGS__);             \
  }

}  // namespace

// dtype: 0 fp32, 1 bf16. q' (the score operand), k, v: contiguous (B*H, N or M, D); kv_len (B,) int32 or null;
// out (B*H, N, D) in the input type, lse (B*H, N) fp32; mul multiplies q' . k
extern "C" int attn_cc_fwd(const void* q, const void* k, const void* v, const void* kv_len, void* out, void* lse,
                           int dtype, int B, int H, int N, int M, int D, float mul, void* stream) {
  if (!shape_ok(B, H, N, M, D) || (dtype != F32 && dtype != BF16)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  CC_DISPATCH(fwd, q, k, v, kv_len, out, lse, B, H, N, M, D, mul, s);
}

// qk = q' and dout (B*H, N, D), k, v (B*H, M, D) in the input type; lse, delta (B*H, N) fp32;
// dq (B*H, N, D) in the input type; scale is the trailing factor of dq
extern "C" int attn_cc_bwd_dq(const void* qk, const void* k, const void* v, const void* dout, const void* lse,
                              const void* delta, const void* kv_len, void* dq, int dtype, int B, int H, int N, int M,
                              int D, float mul, float scale, void* stream) {
  if (!shape_ok(B, H, N, M, D) || (dtype != F32 && dtype != BF16)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  CC_DISPATCH(bwd_dq, qk, k, v, dout, lse, delta, kv_len, dq, B, H, N, M, D, mul, scale, s);
}

// q (raw) and qk = q' (the same pointer when they are equal); dk, dv (B*H, M, D) in the input type
extern "C" int attn_cc_bwd_dkv(const void* q, const void* qk, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, const void* kv_len, void* dk, void* dv, int dtype,
                               int B, int H, int N, int M, int D, float mul, float scale, void* stream) {
  if (!shape_ok(B, H, N, M, D) || (dtype != F32 && dtype != BF16)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  CC_DISPATCH(bwd_dkv, q, qk, k, v, dout, lse, delta, kv_len, dk, dv, B, H, N, M, D, mul, scale, s);
}

// The short kernels' C entries take one packed argument (ops/attention.py packs it with struct): a ctypes call's
// host time grows with its arguments, and the forward's are 22.
struct ShortFwdArgs {
  uint64_t q, k, v, kv_len, out, lse, stream;
  long long B, H, N, M, D;
  long long qs[3], ks[3], vs[3];  // B, H and row strides of q, k, v in elements
  double mul;
};
struct ShortBwdArgs {
  uint64_t q, k, v, o, dout, lse, kv_len, dq, dk, dv, stream;
  long long B, H, N, M, D;
  long long qs[3], ks[3], vs[3], os[3], gs[3];
  double mul, scale;
};
static_assert(sizeof(ShortFwdArgs) == 22 * 8 && sizeof(ShortBwdArgs) == 33 * 8, "packed layouts of ops/attention.py");

bool short_dims(long long B, long long H, long long N, long long M, long long D) {
  return B >= 1 && H >= 1 && B * H <= 0x7fffffffLL && N >= 1 && N <= SHORT_ROWS && M >= 1 && M <= SHORT_ROWS &&
         D >= 1 && D <= MAX_D;
}

// fp32 short sequences (N, M <= 32): q (B, H, N, D), k, v (B, H, M, D) with any B, H and row strides, a unit stride
// along D; kv_len (B,) int32 or null; out (B, N, H, D) and lse (B*H, N) fp32, contiguous; mul multiplies q . k
extern "C" int attn_cc_short_fwd(const void* packed) {
  ShortFwdArgs a;
  memcpy(&a, packed, sizeof a);
  if (!short_dims(a.B, a.H, a.N, a.M, a.D)) return static_cast<int>(cudaErrorInvalidValue);
  const int H = static_cast<int>(a.H), N = static_cast<int>(a.N), M = static_cast<int>(a.M), D = static_cast<int>(a.D);
  const int BH = static_cast<int>(a.B * a.H), R = N < SHORT_FWD_ROWS ? N : SHORT_FWD_ROWS;
  const int G = N > R ? 1 : short_heads(N, BH);  // a head of more than 8 rows spreads over CTAs instead
  Staged st{};
  int off = 0;
  stage_view(st, reinterpret_cast<const void*>(a.q), a.qs, R, D, off);
  stage_view(st, reinterpret_cast<const void*>(a.k), a.ks, M, odd_pitch(D), off);
  stage_view(st, reinterpret_cast<const void*>(a.v), a.vs, M, D, off);
  for (int t = 0; t < st.n; ++t) st.off[t] *= G;  // each view's block holds G heads
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(a.stream);
  const void* kv_len = reinterpret_cast<const void*>(a.kv_len);
  void* out = reinterpret_cast<void*>(a.out);
  void* lse = reinterpret_cast<void*>(a.lse);
  const float mul = static_cast<float>(a.mul);
  SHORT_DISPATCH(short_fwd, st, kv_len, out, lse, BH, H, N, M, D, G, mul, s);
}

// fp32 short sequences: q, k, v, o (the forward's out) and dout with any B, H and row strides, unit stride along D;
// lse (B*H, N) fp32 contiguous; dq (B*H, N, D), dk and dv (B*H, M, D) contiguous; mul multiplies q . k, scale is
// the trailing factor of dq and dk
extern "C" int attn_cc_short_bwd(const void* packed) {
  ShortBwdArgs a;
  memcpy(&a, packed, sizeof a);
  if (!short_dims(a.B, a.H, a.N, a.M, a.D)) return static_cast<int>(cudaErrorInvalidValue);
  const int H = static_cast<int>(a.H), N = static_cast<int>(a.N), M = static_cast<int>(a.M), D = static_cast<int>(a.D);
  const int BH = static_cast<int>(a.B * a.H), G = short_heads(N > M ? N : M, BH);
  Staged st{};
  int off = 0;
  stage_view(st, reinterpret_cast<const void*>(a.q), a.qs, N, D, off);
  stage_view(st, reinterpret_cast<const void*>(a.dout), a.gs, N, D, off);
  stage_view(st, reinterpret_cast<const void*>(a.o), a.os, N, D, off);
  stage_view(st, reinterpret_cast<const void*>(a.k), a.ks, M, odd_pitch(D), off);
  stage_view(st, reinterpret_cast<const void*>(a.v), a.vs, M, odd_pitch(D), off);
  for (int t = 0; t < st.n; ++t) st.off[t] *= G;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(a.stream);
  const void* lse = reinterpret_cast<const void*>(a.lse);
  const void* kv_len = reinterpret_cast<const void*>(a.kv_len);
  void* dq = reinterpret_cast<void*>(a.dq);
  void* dk = reinterpret_cast<void*>(a.dk);
  void* dv = reinterpret_cast<void*>(a.dv);
  const float mul = static_cast<float>(a.mul), scale = static_cast<float>(a.scale);
  SHORT_DISPATCH(short_bwd, st, lse, kv_len, dq, dk, dv, BH, H, N, M, D, G, mul, scale, s);
}

// the launch floor chip_smoke.py reads the short kernels against: an empty kernel, launched as they are (from the
// host through this library, on the caller's stream)
__global__ void cc_empty_kernel() {}

extern "C" int attn_cc_empty(void* stream) {
  cc_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
