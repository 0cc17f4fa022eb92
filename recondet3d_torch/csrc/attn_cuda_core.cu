// Attention on the CUDA cores for Hopper (sm_90a), forward and backward: the
// fp32 instances of the Pallas TPU kernels `_flash_kernel`,
// `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel`
// (recondet3d/ops/attention.py:54, 185, 231), at any head dim (the camera
// encoder's trunk, CameraEnc: 16 heads of dim_out / 16, D = 24 to 96). Calls
// are routed here for fp32 only: the wgmma kernels (csrc/flash_attn_fwd.cu,
// flash_attn_bwd.cu) take bf16 at every D. The bf16 instances stay callable
// (ops/attention.py attention_fwd_cuda_core, attention_bwd_dq_cuda_core,
// attention_bwd_dkv_cuda_core) as the CUDA-core time the wgmma kernels are
// held against; no routed call reaches them.
// D runs from 1 to 256, N and M from 1 up, B*H up to the 2^31 - 1 CTAs of a
// one-dimensional grid (the heads are folded into grid.x with the row tiles).
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
// with fp32 products and sums (no tensor cores, no TF32) and delta = rowsum(dO * O)
// from the caller (a PyTorch expression, as in the JAX package).
//
// What bounds them on an H100: at the camera encoder's shapes (B, 16, 6, D) a
// call is a few thousand operations a head, far below a microsecond of the
// card's fp32 rate or of its memory rate: the launch is the cost. At long
// sequences they do 4, 6 and 8 * N * M * D fp32 operations on the CUDA cores
// (67 TFLOP/s), against 989 TFLOP/s of bf16 tensor cores for the wgmma
// kernels: these kernels are for the shapes no DA3 trunk gives (every trunk
// has D = 64), and are simple rather than fast:
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
// read 16 bytes at a time where D is a multiple of 4 (rows of D floats from a 16-byte aligned base)
__device__ __forceinline__ float dot(const float* a, const float* b, int D) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  int d = 0;
  if (D % 4 == 0) {
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
