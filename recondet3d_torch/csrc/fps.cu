// Furthest-point sampling for Hopper (sm_90a): K strictly sequential
// selections in ONE launch of thread-block clusters.
//
// Replaces the Pallas TPU kernel `_fps_kernel` (recondet3d/ops/fps_pallas.py:54,
// launched by `furthest_point_sample_pallas`): exact FPS over (N, 3) fp32
// points with a validity mask, K int32 indices out.
//
// What bounds it on this card: not bytes (13 B a point, read once) and not
// the K * n_valid distance updates (9 fp32 operations each: 0.26 ms for 25,000
// selections over 77,645 points at 67 TFLOP/s), but K dependent steps: every
// selection needs the argmax over ALL valid points before the next can start.
// The latency of one step's exchange is the floor of this design, so the
// design keeps that exchange on the shortest path the card has:
//
//  - a cluster of CLUSTER = 16 CTAs (non-portable size; all CTAs of a
//    cluster sit on one GPC) shares the valid points, so a step's exchange
//    is a message through distributed shared memory, not through L2: each
//    CTA reduces its share to ONE 20-byte record {distance key, ~index, x, y,
//    z} and warp 0's lane p writes it into CTA p's shared memory with
//    `st.async`, which completes on CTA p's mbarrier for the step; a CTA
//    waits only on its own mbarrier (16 records), and every warp reduces the
//    16 records itself. The winner's coordinates travel in the record, so no
//    load from device memory sits on the critical path. Records and
//    mbarriers are double-buffered by step parity;
//  - a CTA's share stays in registers: thread t holds points t, t + 512, ...
//    of the share (REG_SLOTS = 10 of them, in x, y, z and min-distance
//    registers: 5,120 a CTA), so the update reads no memory at the main
//    path's sizes (77,645 valid points = 4,853 a CTA); 10 slots measured
//    faster there than 12, and 512 threads faster than 1,024 with 5 slots. What does not fit in registers stays in shared
//    memory at 20 B a point (a float4 {x, y, z, index} per point and its
//    min-distance); the float4s of all points stay there too, so that the
//    CTA's winner's record is read from shared memory;
//  - larger clouds: when the valid points do not fit in one cluster, C
//    clusters share them and a step takes a second level after the cluster
//    exchange: the first CTA of each cluster publishes the cluster's winner
//    as four self-tagged 64-bit words to its slot in device memory (a
//    64-bit store is single-copy atomic, so a word is whole or absent), and
//    warp 0 of every CTA polls the C slots. C is decided in the kernel from
//    the valid count (no read-back to the host): the launch has as many
//    clusters as N could need, and the clusters that this cloud does not
//    need exit after the load;
//  - clouds beyond the shared memory of the clusters an H100 runs at once (7
//    at a CTA's full shared memory): the launch has 7 clusters, and a CTA's
//    share may run past what it holds on chip. The points past that stay in
//    the staging buffer, their min-distances beside them in device memory
//    (`odist`), and each selection streams them after the on-chip share. Their
//    positions follow the on-chip ones, so the lowest position is still the
//    lowest index. This path is compiled apart (kOverflow), so a cloud that
//    fits on chip runs the kernel it ran before;
//  - the load: every CTA counts the valid rows of an equal slice of the N
//    rows, the counts meet in device memory (one grid-wide arrival counter),
//    each CTA writes its valid rows in order to a staging buffer at their
//    rank among all valid rows, and after a second arrival counter the CTAs
//    in use take equal runs of ranks. Ranks follow row order, so within a
//    CTA, a thread and the whole cloud a lower rank is a lower index;
//  - co-residency: the launch is cooperative as well as clustered (the two
//    attributes combine on an H100), so all clusters run at once or the
//    launch fails; every wait on a peer still traps after 2^28 polls, so a
//    fault ends the launch instead of holding the card.
//
// Rounding and ties are those of the plain PyTorch version
// (ops/sampling.py furthest_point_sample_plain), so the index sequences are
// identical: d = (dx*dx + dy*dy) + dz*dz with every product and sum rounded
// separately (__fmul_rn / __fadd_rn keep nvcc from contracting them into
// FMAs), min-distance starts at 1e10 for valid points, invalid points never
// enter a share and count as the origin when they are the start, with no
// valid point at all every later pick is index 0, and the maximum goes to
// the LOWEST index (torch.argmax's rule).
//
// Plain C interface (no PyTorch headers): the wrapper in ops/fps.py plans
// the launch (clusters, per-CTA capacity, shared memory), allocates the
// scratch and passes raw pointers and the current stream.

#include <math_constants.h>

#include "hopper_common.cuh"

namespace {

using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;

constexpr int CLUSTER = 16;                         // CTAs a cluster
constexpr int THREADS = 512;                        // threads a CTA
constexpr int WARPS = THREADS / 32;
constexpr int REG_SLOTS = 10;                       // points a thread keeps in registers
constexpr int REG_POINTS = REG_SLOTS * THREADS;     // points a CTA keeps in registers
constexpr int MAX_CLUSTERS = 7;                     // clusters an H100 runs at once at full shared memory
constexpr int SMEM_FIXED = 2048;                    // bytes of dynamic shared memory before the points
constexpr int SMEM_LIMIT = 232448;                  // a CTA's shared memory on an H100
constexpr uint32_t REC_BYTES = 20;                  // one record: {key, ~index, x, y} + z
constexpr int IDX_BITS = 23;                        // N < 2^23 - 1
constexpr int TAG_BITS = 9;                         // {key 32, index 23, tag 9} in a 64-bit word
constexpr unsigned TAG_MASK = (1u << TAG_BITS) - 1; // step tag of the second level's words
constexpr int CTRL_HEAD = 4;                        // ctrl: [arrivals 1, arrivals 2, cluster size, clusters used, counts...]
constexpr uint32_t MAX_POLLS = 1u << 28;

struct alignas(16) Rec {
  uint4 a;     // {key, ~index, x bits, y bits}
  uint32_t z;  // z bits
  uint32_t pad[3];
};

struct Fixed {
  Rec rec[2][CLUSTER];      // records of the step, by parity and sender rank
  uint64_t bar[2];          // one mbarrier a parity: 16 records' bytes complete it
  uint32_t wkey[WARPS];     // warp winners: key and local rank
  uint32_t wpos[WARPS];
  float4 best;              // the second level's winner, shared by warp 0
  uint32_t best_idx;
  int scan[WARPS];
  int n_valid, offset;
};
static_assert(sizeof(Fixed) <= SMEM_FIXED, "fixed shared memory");

// A min-distance is -inf (no point) or >= +0, so this key orders like it: -inf -> 0, d -> bits(d) + 1.
__device__ __forceinline__ uint32_t dist_key(float d) { return d >= 0.f ? __float_as_uint(d) + 1u : 0u; }

__device__ __forceinline__ float sq_dist(float x, float y, float z, float px, float py, float pz) {
  const float dx = x - px, dy = y - py, dz = z - pz;
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the shared::cluster address of `local` in the CTA of rank `rank`
__device__ __forceinline__ uint32_t peer_addr(const void* local, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(local)), "r"(rank));
  return r;
}

// 20 bytes into a peer's record slot; the copy completes its bytes on the peer's mbarrier
__device__ __forceinline__ void send_record(uint32_t dst, uint32_t bar, uint4 a, uint32_t z) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(
                   dst),
               "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(bar)
               : "memory");
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(dst + 16), "r"(z),
               "r"(bar)
               : "memory");
}

__device__ __forceinline__ void arm(uint64_t* bar) { hopper::mbar_arrive_expect_tx(bar, CLUSTER * REC_BYTES); }

__device__ __forceinline__ unsigned long long poll_word(const unsigned long long* p, unsigned tag) {
  unsigned long long w;
  uint32_t polls = 0;
  do {
    w = *reinterpret_cast<const volatile unsigned long long*>(p);
    if (++polls == MAX_POLLS) __trap();
  } while ((static_cast<unsigned>(w) & TAG_MASK) != tag);
  return w;
}

// every CTA of the grid adds one to *counter, then waits until all have
__device__ __forceinline__ void grid_arrive_wait(unsigned* counter) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    uint32_t polls = 0;
    while (*reinterpret_cast<volatile unsigned*>(counter) < gridDim.x)
      if (++polls == MAX_POLLS) __trap();
    __threadfence();
  }
  __syncthreads();
}

// kWork = false compiles the points out: what is left is the exchange of
// `clusters` clusters alone (probe: K - 1 steps, every record empty), timed
// as the latency floor of one selection. kOverflow: a CTA's share may exceed
// the `cta_cap` points it holds on chip (up to `share_cap`); the rest stream
// from the staging buffer and `odist` on every selection.
template <bool kWork, bool kOverflow>
__global__ void __launch_bounds__(THREADS, 1)
    fps_kernel(const float* __restrict__ pts,      // (N, 3)
               const uint8_t* __restrict__ valid,  // (N,)
               const int* __restrict__ start,      // (1,) first selected index
               int N, int K, int cta_cap, int share_cap, int smem_points,
               float4* __restrict__ staging,       // (N,) {x, y, z, index}: the valid rows in order
               float* __restrict__ odist,          // (N,) min-distances of the points past the chip (kOverflow)
               unsigned* ctrl,                     // (CTRL_HEAD + gridDim.x,), zeroed by the caller
               unsigned long long* slots,          // (2, MAX_CLUSTERS, 4), zeroed by the caller
               int* __restrict__ out,              // (K,)
               int probe_clusters) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  Fixed& fx = *reinterpret_cast<Fixed*>(smem_raw);
  float4* sp = reinterpret_cast<float4*>(smem_raw + SMEM_FIXED);  // the share: cta_cap points
  float* sd = reinterpret_cast<float*>(sp + cta_cap);              // min-distances beyond the registers

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const uint32_t rank = cluster_rank(), cid = cluster_id();

  // ---- load: count, rank and stage the valid rows; decide the clusters in use
  int n_valid = 0;
  if (kWork) {
    const int G = gridDim.x, g = blockIdx.x;
    const int rows = (N + G - 1) / G, r0 = min(N, g * rows), r1 = min(N, r0 + rows);
    int cnt = 0;
    for (int r = r0 + tid; r < r1; r += THREADS) cnt += valid[r] != 0;
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (lane == 0) fx.scan[warp] = cnt;
    __syncthreads();
    if (tid == 0) {
      int s = 0;
      for (int w = 0; w < WARPS; ++w) s += fx.scan[w];
      ctrl[CTRL_HEAD + g] = s;
    }
    grid_arrive_wait(&ctrl[0]);
    if (warp == 0) {
      int before = 0, total = 0;
      for (int i = lane; i < G; i += 32) {
        const int c = static_cast<int>(__ldcg(&ctrl[CTRL_HEAD + i]));
        total += c;
        before += i < g ? c : 0;
      }
      before = __reduce_add_sync(0xffffffffu, before);
      total = __reduce_add_sync(0xffffffffu, total);
      if (lane == 0) {
        fx.offset = before;
        fx.n_valid = total;
      }
    }
    __syncthreads();
    int base = fx.offset;
    for (int r = r0; r < r1; r += THREADS) {  // in row order, THREADS rows a pass
      const int row = r + tid;
      const bool ok = row < r1 && valid[row] != 0;
      const unsigned mask = __ballot_sync(0xffffffffu, ok);
      if (lane == 0) fx.scan[warp] = __popc(mask);
      __syncthreads();
      int at = base + __popc(mask & ((1u << lane) - 1u)), pass = 0;
      for (int w = 0; w < WARPS; ++w) {
        at += w < warp ? fx.scan[w] : 0;
        pass += fx.scan[w];
      }
      if (ok) staging[at] = make_float4(pts[3 * row], pts[3 * row + 1], pts[3 * row + 2], __int_as_float(row));
      base += pass;
      __syncthreads();
    }
    grid_arrive_wait(&ctrl[1]);
    n_valid = fx.n_valid;
  }
  // the clusters this cloud needs to hold its valid points on chip, at most the clusters launched (beyond: overflow)
  const int launched = static_cast<int>(gridDim.x) / CLUSTER;
  const int clusters =
      kWork ? min(launched, max(1, (n_valid + CLUSTER * cta_cap - 1) / (CLUSTER * cta_cap))) : probe_clusters;
  if (blockIdx.x == 0 && tid == 0) {
    ctrl[2] = cluster_size();
    ctrl[3] = clusters;
  }
  if (static_cast<int>(cid) >= clusters) return;  // the whole cluster leaves: this cloud does not need it

  // this CTA's share: a run of `per` ranks
  const int per = (max(n_valid, 1) + clusters * CLUSTER - 1) / (clusters * CLUSTER);
  const int lo = min(n_valid, static_cast<int>(cid * CLUSTER + rank) * per);
  const int n_mine = min(per, n_valid - lo);
  const int n_chip = kOverflow ? min(n_mine, cta_cap) : n_mine;  // per <= cta_cap without overflow
  float x[REG_SLOTS], y[REG_SLOTS], z[REG_SLOTS], d[REG_SLOTS];
#pragma unroll
  for (int j = 0; j < REG_SLOTS; ++j) {
    x[j] = y[j] = z[j] = 0.f;
    d[j] = -CUDART_INF_F;
  }
  if (kWork) {
    for (int p = tid; p < n_chip; p += THREADS) sp[p] = __ldcg(&staging[lo + p]);
#pragma unroll
    for (int j = 0; j < REG_SLOTS; ++j) {
      const int p = j * THREADS + tid;
      if (p < n_chip) {
        const float4 q = __ldcg(&staging[lo + p]);
        x[j] = q.x;
        y[j] = q.y;
        z[j] = q.z;
        d[j] = 1e10f;
      }
    }
    for (int p = REG_POINTS + tid; p < n_chip; p += THREADS) sd[p - REG_POINTS] = 1e10f;
    if (kOverflow)
      for (int p = cta_cap + tid; p < n_mine; p += THREADS) odist[lo + p] = 1e10f;
  }

  if (tid == 0) {
    mbar_init(&fx.bar[0], 1);
    mbar_init(&fx.bar[1], 1);
    hopper::fence_barrier_init();
    arm(&fx.bar[0]);
    arm(&fx.bar[1]);
  }
  cluster_sync();  // every peer's mbarriers exist before the first record is sent

  float px = 0.f, py = 0.f, pz = 0.f;  // the last selected point; an invalid start counts as the origin
  if (kWork) {
    const int first = start[0];
    if (valid[first] != 0) {
      px = pts[3 * first];
      py = pts[3 * first + 1];
      pz = pts[3 * first + 2];
    }
    if (cid == 0 && rank == 0 && tid == 0) out[0] = first;
  }

  for (int k = 1; k < K; ++k) {
    const int par = k & 1;
    // update this thread's points; the best (first on ties: positions ascend with the index)
    float bv = -CUDART_INF_F;
    int bp = 0;
    if (kWork) {
      // every slot, used or not (an empty one holds -inf and never wins): no branch keeps the updates
      // independent, which measured faster than skipping the empty slots
#pragma unroll
      for (int j = 0; j < REG_SLOTS; ++j) {
        d[j] = fminf(d[j], sq_dist(x[j], y[j], z[j], px, py, pz));
        if (d[j] > bv) {
          bv = d[j];
          bp = j * THREADS + tid;
        }
      }
      for (int p = REG_POINTS + tid; p < n_chip; p += THREADS) {
        const float4 q = sp[p];
        const float dn = fminf(sd[p - REG_POINTS], sq_dist(q.x, q.y, q.z, px, py, pz));
        sd[p - REG_POINTS] = dn;
        if (dn > bv) {
          bv = dn;
          bp = p;
        }
      }
      if (kOverflow) {
        // the share past the chip: read from the staging buffer, its min-distances (this thread's own) in odist
        for (int p = cta_cap + tid; p < n_mine; p += THREADS) {
          const float4 q = __ldcg(&staging[lo + p]);
          const float dn = fminf(odist[lo + p], sq_dist(q.x, q.y, q.z, px, py, pz));
          odist[lo + p] = dn;
          if (dn > bv) {
            bv = dn;
            bp = p;
          }
        }
      }
    }
    // the CTA's winner: max key, lowest position
    uint32_t key = dist_key(bv);
    uint32_t kmax = __reduce_max_sync(0xffffffffu, key);
    uint32_t pmin = __reduce_min_sync(0xffffffffu, key == kmax ? static_cast<uint32_t>(bp) : 0xffffffffu);
    if (lane == 0) {
      fx.wkey[warp] = kmax;
      fx.wpos[warp] = pmin;
    }
    __syncthreads();
    if (warp == 0) {
      key = lane < WARPS ? fx.wkey[lane] : 0u;
      kmax = __reduce_max_sync(0xffffffffu, key);
      pmin = __reduce_min_sync(0xffffffffu, (lane < WARPS && key == kmax) ? fx.wpos[lane] : 0xffffffffu);
      float4 q = make_float4(0.f, 0.f, 0.f, __int_as_float(0));  // no point: index 0 at the origin
      if (kmax != 0u) q = kOverflow && static_cast<int>(pmin) >= cta_cap ? __ldcg(&staging[lo + pmin]) : sp[pmin];
      if (lane < CLUSTER) {
        const uint4 a = make_uint4(kmax, ~static_cast<uint32_t>(__float_as_int(q.w)), __float_as_uint(q.x),
                                   __float_as_uint(q.y));
        send_record(peer_addr(&fx.rec[par][rank], lane), peer_addr(&fx.bar[par], lane), a, __float_as_uint(q.z));
      }
    }
    // the cluster's winner, reduced by every warp from the 16 records of the step
    mbar_wait(&fx.bar[par], ((k - 1) >> 1) & 1);
    uint4 a = make_uint4(0u, 0u, 0u, 0u);
    uint32_t rz = 0u;
    if (lane < CLUSTER) {
      a = fx.rec[par][lane].a;
      rz = fx.rec[par][lane].z;
    }
    kmax = __reduce_max_sync(0xffffffffu, a.x);
    const uint32_t nmax = __reduce_max_sync(0xffffffffu, a.x == kmax ? a.y : 0u);
    const int src = __ffs(__ballot_sync(0xffffffffu, a.x == kmax && a.y == nmax)) - 1;
    float bx = __shfl_sync(0xffffffffu, __uint_as_float(a.z), src);
    float by = __shfl_sync(0xffffffffu, __uint_as_float(a.w), src);
    float bz = __shfl_sync(0xffffffffu, __uint_as_float(rz), src);
    uint32_t idx = ~nmax;
    if (tid == 0) arm(&fx.bar[par]);  // for step k + 2; its records come after every CTA has finished step k + 1

    if (clusters > 1) {
      // second level: one tagged record a cluster in device memory, polled by warp 0
      if (warp == 0) {
        const unsigned tag = static_cast<unsigned>(k) & TAG_MASK;
        unsigned long long* step = slots + static_cast<size_t>(par) * MAX_CLUSTERS * 4;
        if (rank == 0 && lane == 0) {
          unsigned long long* mine = step + 4 * cid;
          volatile unsigned long long* v = mine;
          v[1] = (static_cast<unsigned long long>(__float_as_uint(bx)) << 32) | tag;
          v[2] = (static_cast<unsigned long long>(__float_as_uint(by)) << 32) | tag;
          v[3] = (static_cast<unsigned long long>(__float_as_uint(bz)) << 32) | tag;
          v[0] = (static_cast<unsigned long long>(kmax) << 32) |
                 (static_cast<unsigned long long>(idx & ((1u << IDX_BITS) - 1u)) << TAG_BITS) | tag;
        }
        unsigned long long w = 0ull;
        if (lane < 4 * clusters) w = poll_word(step + lane, tag);
        const bool head = lane < 4 * clusters && lane % 4 == 0;
        const uint32_t ck = head ? static_cast<uint32_t>(w >> 32) : 0u;
        const uint32_t ci = head ? static_cast<uint32_t>(w >> TAG_BITS) & ((1u << IDX_BITS) - 1u) : 0xffffffffu;
        const uint32_t gk = __reduce_max_sync(0xffffffffu, ck);
        const uint32_t gi = __reduce_min_sync(0xffffffffu, (head && ck == gk) ? ci : 0xffffffffu);
        const int c4 = __ffs(__ballot_sync(0xffffffffu, head && ck == gk && ci == gi)) - 1;
        const uint32_t hi = static_cast<uint32_t>(w >> 32);
        const float gx = __uint_as_float(__shfl_sync(0xffffffffu, hi, c4 + 1));
        const float gy = __uint_as_float(__shfl_sync(0xffffffffu, hi, c4 + 2));
        const float gz = __uint_as_float(__shfl_sync(0xffffffffu, hi, c4 + 3));
        if (lane == 0) {
          fx.best = make_float4(gx, gy, gz, 0.f);
          fx.best_idx = gk != 0u ? gi : 0u;
        }
      }
      __syncthreads();
      bx = fx.best.x;
      by = fx.best.y;
      bz = fx.best.z;
      idx = fx.best_idx;
    }
    px = bx;
    py = by;
    pz = bz;
    if (kWork && cid == 0 && rank == 0 && tid == 0) out[k] = static_cast<int>(idx);
  }
  // no peer writes into this CTA's shared memory after the last step's records, which it has waited for
}

template <bool kWork, bool kOverflow>
int launch(const float* pts, const uint8_t* valid, const int* start, int N, int K, int clusters, int cta_cap,
           int share_cap, int smem_points, float4* staging, float* odist, unsigned* ctrl, unsigned long long* slots,
           int* out, cudaStream_t stream) {
  if (K < 1 || clusters < 1 || clusters > MAX_CLUSTERS || cta_cap < 1 || share_cap < cta_cap || smem_points < 0 ||
      N < (kWork ? 1 : 0) || N >= (1 << IDX_BITS) - 1 ||
      (kWork && static_cast<long long>(share_cap) * CLUSTER * clusters < N) || (kOverflow && !odist))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = SMEM_FIXED + 16 * static_cast<size_t>(cta_cap) + 4 * static_cast<size_t>(smem_points);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = fps_kernel<kWork, kOverflow>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER * clusters);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = CLUSTER;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;  // all clusters co-resident, or the launch fails
  attrs[1].val.cooperative = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kern, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (active < clusters) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  err = cudaLaunchKernelEx(&cfg, kern, pts, valid, start, N, K, cta_cap, share_cap, smem_points, staging, odist, ctrl,
                           slots, out, clusters);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pts (N, 3) fp32, valid (N,) bytes, start (1,) int32, out (K,) int32;
// staging (N,) float4 scratch; odist (N,) fp32 scratch (null unless
// share_cap > cta_cap); ctrl (4 + 16 * clusters,) uint32 and slots
// (2 * 7 * 4,) uint64 set to zero; clusters, cta_cap (points a CTA holds on
// chip), share_cap (points a CTA may own, >= cta_cap) and smem_points (of the
// on-chip points, those beyond the registers) as ops/fps.py launch_plan gives
// them. After the launch ctrl[2] holds the cluster size the kernel ran with
// and ctrl[3] the clusters it used. Returns a cudaError_t (0 = launched).
extern "C" int fps_f32(const float* pts, const uint8_t* valid, const int* start, int N, int K, int clusters,
                       int cta_cap, int share_cap, int smem_points, void* staging, void* odist, unsigned* ctrl,
                       unsigned long long* slots, int* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* st = static_cast<float4*>(staging);
  float* od = static_cast<float*>(odist);
  if (share_cap > cta_cap)
    return launch<true, true>(pts, valid, start, N, K, clusters, cta_cap, share_cap, smem_points, st, od, ctrl, slots,
                              out, s);
  return launch<true, false>(pts, valid, start, N, K, clusters, cta_cap, share_cap, smem_points, st, od, ctrl, slots,
                             out, s);
}

// The same launch with the points compiled out: K - 1 steps of the exchange of
// `clusters` clusters (1: the cluster exchange alone; more: with the second
// level) and nothing else. ctrl, slots and out as above (out is scratch).
extern "C" int fps_exchange_probe(int K, int clusters, unsigned* ctrl, unsigned long long* slots, int* out,
                                  void* stream) {
  return launch<false, false>(nullptr, nullptr, nullptr, 0, K, clusters, 1, 1, 0, nullptr, nullptr, ctrl, slots, out,
                              static_cast<cudaStream_t>(stream));
}
