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
// The design keeps the points of a cloud on the fewest CTAs that hold them and
// makes the exchange between those CTAs rare:
//
//  - a cluster of CLUSTER = 16 CTAs (non-portable size; all CTAs of a
//    cluster sit on one GPC) shares the valid points, so an exchange is a
//    message through distributed shared memory, not through L2: records are
//    written into every peer's shared memory with `st.async`, which completes
//    on the peer's mbarrier, and a CTA waits only on its own mbarrier;
//  - one cluster: a shared candidate list with an exact bound. At an
//    exchange every CTA sends every peer its TOP largest min-distance records
//    {key, ~index, x, y, z} (largest key, then lowest index) and its bound, the (TOP + 1)-th largest key (the empty key when it
//    holds TOP points or fewer). Each CTA's leader warp then holds the same
//    records: their largest is the step's winner, and B, the largest of the 16
//    bounds, bounds every point outside them, since min-distances only fall.
//    Between exchanges the leader updates the records with each pick (rounding
//    as the points do) and takes their argmax; a key strictly above B is the
//    exact next pick, which every CTA's leader reaches from the same bits, so
//    the CTAs do not meet. A key at B or below starts the next exchange. The
//    leader publishes its picks in batches through a ring in shared memory
//    (two halves, an mbarrier each way), and the 15 point warps apply each
//    batch to all their points while it computes the next: every point is
//    still updated with every pick, but reads of it wait for an exchange, and
//    the point work runs beside the leader's dependent chain instead of after
//    it. The receive buffer is single: a cluster barrier, arrived at once the
//    records are read and waited on before the next records are sent, keeps a
//    fast CTA from overwriting them, and is passed long before that in the
//    usual case;
//  - a CTA's share stays in registers: 5,120 points a CTA, in x, y, z and
//    min-distance registers (stepping: thread t holds points t, t + 512, ...,
//    10 of them; the candidate list: point thread t holds t, t + 480, ..., 10
//    or 11 of them, the warps that share the leader's scheduler fewer), so the
//    update reads no memory at the main path's sizes (77,645 valid points =
//    4,853 a CTA). What does not fit in
//    registers stays in shared memory at 20 B a point (a float4 {x, y, z,
//    index} per point and its min-distance); the float4s of all points stay
//    there too, so that a record's coordinates and index are read from shared
//    memory;
//  - larger clouds: when the valid points do not fit in one cluster, C
//    clusters share them and every step is an exchange, in two levels: each
//    CTA reduces its points to its one best record and warp 0 sends it to every
//    peer of its cluster (double-buffered by step parity), then the first CTA
//    of each cluster publishes the cluster's winner as four self-tagged 64-bit
//    words to its slot in device memory (a 64-bit store is single-copy atomic,
//    so a word is whole or absent), and warp 0 of every CTA polls the C slots.
//    C is decided
//    in the kernel from the valid count (no read-back to the host): the launch
//    has as many clusters as N could need, and the clusters that this cloud
//    does not need exit after the load. A single cluster whose CTAs hold their
//    shares to the last byte of shared memory, with no room for the candidate
//    records, and any cloud of the overflow instance below step the same way;
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
//    in use take equal runs of ranks (stepping) or every 16th rank (the
//    candidate list). Ranks follow row order, so within a
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
// the LOWEST index (torch.argmax's rule). Once a pick's min-distance is 0
// (every valid point picked, or none valid), every later pick is that index,
// and the kernel writes them without further steps.
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
constexpr int REG_POINTS = 5120;                    // points a CTA keeps in registers (ops/fps.py REG_POINTS)
// Two layouts of a CTA's share. Stepping: thread t keeps positions t, t + 512, ... (STEP_SLOTS of them) in
// registers. The candidate list: warp LEAD keeps no points; point thread t < PT keeps t, t + 480, ... (SLOTS_ALL),
// and the threads of 10 of the 12 warps that do not share the leader's scheduler (warp % 4 != 3; warps 0-2, 4-6,
// 8-10 and 12) one more, so each scheduler updates 43-44 slots a pick (the leader's 30, besides the leader).
// Stepping keeps all 16 warps on points: with the list's layout it measured 1-9 % slower past one cluster.
constexpr int STEP_SLOTS = REG_POINTS / THREADS;
constexpr int PT = THREADS - 32;                    // point threads of the candidate list: warps 0-14
constexpr int LEAD = PT / 32;                       // its leader warp, 15
constexpr int REG_SLOTS = 11;
constexpr int SLOTS_ALL = 10;
constexpr int PT_WIDE = 320;                        // point threads with REG_SLOTS slots
static_assert(SLOTS_ALL * PT + (REG_SLOTS - SLOTS_ALL) * PT_WIDE == REG_POINTS && STEP_SLOTS * THREADS == REG_POINTS,
              "both layouts keep REG_POINTS in registers");
constexpr int MAX_CLUSTERS = 7;                     // clusters an H100 runs at once at full shared memory
constexpr int SMEM_FIXED = 2048;                    // bytes of dynamic shared memory before the points
constexpr int SMEM_LIMIT = 232448;                  // a CTA's shared memory on an H100
constexpr uint32_t REC_BYTES = 20;                  // one record: {key, ~index, x, y} + z
constexpr int IDX_BITS = 23;                        // N < 2^23 - 1
constexpr int TAG_BITS = 9;                         // {key 32, index 23, tag 9} in a 64-bit word
constexpr unsigned TAG_MASK = (1u << TAG_BITS) - 1; // step tag of the second level's words
// ctrl: [arrivals 1, arrivals 2, cluster size, clusters used, exchanges, counts...]
constexpr int CTRL_HEAD = 5;
constexpr uint32_t MAX_POLLS = 1u << 28;
constexpr int TOP = 8;  // records a CTA sends at an exchange of the candidate list (measured against 2, 4 and 6)
constexpr int CANDS = CLUSTER * TOP;                // records a CTA receives
constexpr int CAND_SLOTS = CANDS / 32;              // of them, a lane's
constexpr uint32_t LIST_SEND_BYTES = 20 * TOP + 4;  // TOP records and the bound, to each peer
static_assert(CANDS % 32 == 0, "a lane's share of the records");
constexpr int BATCH = 8;  // picks the leader warp publishes at a time (4 and 12 measured no better)
// what follows a batch of picks: more batches, an exchange, or no further pick
constexpr uint32_t THEN_NEXT = 0, THEN_EXCHANGE = 1, THEN_END = 2;

struct alignas(16) Rec {
  uint4 a;     // {key, ~index, x bits, y bits}
  uint32_t z;  // z bits
  uint32_t pad[3];
};

// the candidate records of an exchange, sender s's r-th at s * TOP + r; after the points in dynamic shared memory
struct alignas(16) ListIn {
  uint4 a[CANDS];             // {key, ~index, x bits, y bits}
  uint32_t z[CANDS];          // z bits
  uint32_t bound[CLUSTER];    // each sender's (TOP + 1)-th largest key
};

struct Fixed {
  union {
    Rec rec[2][CLUSTER];  // stepping: records of the step, by parity and sender rank
    struct {              // the candidate list: each warp's TOP + 1 largest {key, position}, at an exchange
      uint32_t key[WARPS][TOP + 1];
      uint32_t pos[WARPS][TOP + 1];
    } top;
  };
  uint64_t bar[2];          // one mbarrier a parity: 16 records' bytes complete it (the list: bar[0], every exchange)
  uint32_t wkey[WARPS];     // warp winners: key and local rank
  uint32_t wpos[WARPS];
  float4 best;              // the second level's winner, shared by warp 0
  uint32_t best_idx;
  float4 ring[2][BATCH];    // the candidate list's picks {x, y, z}, by batch parity
  uint32_t batch[2];        // and each batch's count | what follows (THEN_*) << 8
  uint64_t full[2], empty[2];  // a half published (by the leader) / taken (by the 15 point warps)
  int scan[WARPS];
  int n_valid, offset;
};
static_assert(sizeof(Fixed) <= SMEM_FIXED, "fixed shared memory");

// whether point thread tid keeps REG_SLOTS points in registers (or SLOTS_ALL)
__device__ __forceinline__ bool wide(int tid) { return (tid / 32) % 4 != 3 && tid / 32 <= 12; }

// the position in the CTA's share of point thread tid's register slot j: ascending with j, and each position of
// [0, REG_POINTS) once
__device__ __forceinline__ int slot_pos(int j, int tid) {
  if (j < SLOTS_ALL) return j * PT + tid;
  const int w = tid / 32;
  return SLOTS_ALL * PT + (j - SLOTS_ALL) * PT_WIDE + (w - w / 4) * 32 + tid % 32;
}

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

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// a thread's three largest {key, position}, largest key then lowest position first; offered in ascending position
struct Top3 {
  uint32_t k[3] = {0u, 0u, 0u};
  uint32_t p[3] = {0xffffffffu, 0xffffffffu, 0xffffffffu};
  __device__ __forceinline__ void insert(uint32_t key, uint32_t pos) {
    const bool a0 = key > k[0], a1 = key > k[1], a2 = key > k[2];
    k[2] = a1 ? k[1] : (a2 ? key : k[2]);
    p[2] = a1 ? p[1] : (a2 ? pos : p[2]);
    k[1] = a0 ? k[0] : (a1 ? key : k[1]);
    p[1] = a0 ? p[0] : (a1 ? pos : p[1]);
    k[0] = a0 ? key : k[0];
    p[0] = a0 ? pos : p[0];
  }
  // the three largest of this thread's points strictly after (tk, tp): registers d (positions slot_pos), then
  // shared memory sd (positions REG_POINTS + tid, + PT, ...), so in ascending position; an empty slot holds -inf
  __device__ __forceinline__ void fill(const float (&d)[REG_SLOTS], const float* sd, int tid, int n_chip, uint32_t tk,
                                       uint32_t tp) {
    *this = Top3();
    if (tid >= PT) return;
#pragma unroll
    for (int j = 0; j < REG_SLOTS; ++j) {
      const uint32_t key = dist_key(d[j]), p = static_cast<uint32_t>(slot_pos(j, tid));
      if (key < tk || (key == tk && p > tp)) insert(key, p);
    }
    for (int p = REG_POINTS + tid; p < n_chip; p += PT) {
      const uint32_t key = dist_key(sd[p - REG_POINTS]);
      if (key < tk || (key == tk && static_cast<uint32_t>(p) > tp)) insert(key, static_cast<uint32_t>(p));
    }
  }
  __device__ __forceinline__ void pop() {
    k[0] = k[1];
    p[0] = p[1];
    k[1] = k[2];
    p[1] = p[2];
    k[2] = 0u;
    p[2] = 0xffffffffu;
  }
};

// the warp's largest {key, position} (largest key, then lowest position) and the lane that holds it
__device__ __forceinline__ int warp_argmax(uint32_t key, uint32_t pos, uint32_t& wk, uint32_t& wp) {
  wk = __reduce_max_sync(0xffffffffu, key);
  uint32_t mask = __ballot_sync(0xffffffffu, key == wk);
  if (__popc(mask) > 1) {
    wp = __reduce_min_sync(0xffffffffu, key == wk ? pos : 0xffffffffu);
    mask = __ballot_sync(0xffffffffu, key == wk && pos == wp);
  }
  const int src = __ffs(mask) - 1;
  wp = __shfl_sync(0xffffffffu, pos, src);
  return src;
}

// the min-distance a record's key stands for
__device__ __forceinline__ float key_dist(uint32_t key) { return key ? __uint_as_float(key - 1u) : -CUDART_INF_F; }

// the shared::cluster address of `local` in the CTA of rank `rank`
__device__ __forceinline__ uint32_t peer_addr(const void* local, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(local)), "r"(rank));
  return r;
}

// 16 or 4 bytes into a peer's shared memory; the copy completes its bytes on the peer's mbarrier
__device__ __forceinline__ void st_async_v4(uint32_t dst, uint32_t bar, uint4 a) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(
                   dst),
               "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void st_async_b32(uint32_t dst, uint32_t bar, uint32_t v) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(dst), "r"(v),
               "r"(bar)
               : "memory");
}

// 20 bytes into a peer's record slot
__device__ __forceinline__ void send_record(uint32_t dst, uint32_t bar, uint4 a, uint32_t z) {
  st_async_v4(dst, bar, a);
  st_async_b32(dst + 16, bar, z);
}

__device__ __forceinline__ void arm(uint64_t* bar) { hopper::mbar_arrive_expect_tx(bar, CLUSTER * REC_BYTES); }

__device__ __forceinline__ void arm_list(uint64_t* bar) {
  hopper::mbar_arrive_expect_tx(bar, CLUSTER * LIST_SEND_BYTES);
}

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
// `clusters` clusters (probe: K - 1 steps, every record empty), timed as the
// latency of one exchange: of the candidate list on one cluster (where it has
// room), of one record a CTA and the second level on more. kOverflow: a CTA's
// share may exceed the `cta_cap` points it holds on chip (up to `share_cap`);
// the rest stream from the staging buffer and `odist` on every selection.
// list_room: the dynamic shared memory holds a ListIn after the points.
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
               unsigned long long* totals,         // (2,): selections and exchanges, added to
               int* __restrict__ out,              // (K,)
               int probe_clusters, int list_room) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  Fixed& fx = *reinterpret_cast<Fixed*>(smem_raw);
  float4* sp = reinterpret_cast<float4*>(smem_raw + SMEM_FIXED);  // the share: cta_cap points
  float* sd = reinterpret_cast<float*>(sp + cta_cap);              // min-distances beyond the registers
  ListIn* li = reinterpret_cast<ListIn*>(smem_raw + ((SMEM_FIXED + 16 * cta_cap + 4 * smem_points + 15) & ~15));

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

  // one cluster, every share on chip and room for the records: the candidate list (the same in every CTA); the
  // overflow instance keeps to stepping, so a cloud that needs it runs what it ran before
  const bool use_list = !kOverflow && clusters == 1 && list_room != 0;
  // this CTA's share, position p holding rank lo + p * gap: stepping, a run of `per` ranks; the candidate list,
  // every CLUSTER-th rank, so that each share samples the whole cloud and its largest min-distances spread over the
  // CTAs (a cloud in cell order, in runs, left most of them to one CTA: ~8 selections an exchange, 2,048 of 40,000)
  const int per = (max(n_valid, 1) + clusters * CLUSTER - 1) / (clusters * CLUSTER);
  const int gap = use_list ? CLUSTER : 1;
  const int lo = use_list ? static_cast<int>(rank) : min(n_valid, static_cast<int>(cid * CLUSTER + rank) * per);
  const int n_mine = use_list ? max(0, (n_valid - lo + CLUSTER - 1) / CLUSTER) : min(per, n_valid - lo);
  const int n_chip = kOverflow ? min(n_mine, cta_cap) : n_mine;  // per <= cta_cap without overflow
  float x[REG_SLOTS], y[REG_SLOTS], z[REG_SLOTS], d[REG_SLOTS];
#pragma unroll
  for (int j = 0; j < REG_SLOTS; ++j) {
    x[j] = y[j] = z[j] = 0.f;
    d[j] = -CUDART_INF_F;
  }
  if (kWork) {
    for (int p = tid; p < n_chip; p += THREADS) sp[p] = __ldcg(&staging[lo + p * gap]);
#pragma unroll
    for (int j = 0; j < REG_SLOTS; ++j) {
      const int p = use_list ? slot_pos(j, tid) : j * THREADS + tid;
      const bool held = use_list ? tid < PT && (j < SLOTS_ALL || wide(tid)) : j < STEP_SLOTS;
      if (held && p < n_chip) {
        const float4 q = __ldcg(&staging[lo + p * gap]);
        x[j] = q.x;
        y[j] = q.y;
        z[j] = q.z;
        d[j] = 1e10f;
      }
    }
    const int stride = use_list ? PT : THREADS;  // shared memory: positions REG_POINTS + t, + stride, ...
    for (int p = REG_POINTS + tid; tid < stride && p < n_chip; p += stride) sd[p - REG_POINTS] = 1e10f;
    if (kOverflow)
      for (int p = cta_cap + tid; p < n_mine; p += THREADS) odist[lo + p] = 1e10f;
  }

  if (tid == 0) {
    mbar_init(&fx.bar[0], 1);
    mbar_init(&fx.bar[1], 1);
    hopper::fence_barrier_init();
    if (use_list) {
      mbar_init(&fx.full[0], 1);
      mbar_init(&fx.full[1], 1);
      mbar_init(&fx.empty[0], PT / 32);
      mbar_init(&fx.empty[1], PT / 32);
      hopper::fence_barrier_init();
      arm_list(&fx.bar[0]);
    } else {
      arm(&fx.bar[0]);
      arm(&fx.bar[1]);
    }
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

  if (use_list) {
    // The candidate list. The leader warp (LEAD, no points) keeps the records and takes the steps: it publishes
    // the picks in batches of up to BATCH through a ring of two halves (fx.ring; mbarriers full / empty by half),
    // and each point warp applies a batch's picks to its points while the leader computes the next ones. The
    // points are read only at an exchange, which a batch's flag starts: the point warps apply its picks first.
    bool arrived = false;  // this thread has arrived at the cluster barrier since it last waited on it
    int batch = 0;         // batches published (the leader) or taken (a point warp)
    // an exchange, the part every warp takes: this warp's TOP + 1 largest {key, position} into fx.top (lanes
    // offer their largest in turn, from their three largest), then the wait for the peers' reads
    auto exchange_top = [&]() {
      Top3 t;
      t.fill(d, sd, tid, n_chip, 0xffffffffu, 0xffffffffu);
      int taken = 0;
#pragma unroll
      for (int r = 0; r <= TOP; ++r) {
        uint32_t rk, rp;
        const int src = warp_argmax(t.k[0], t.p[0], rk, rp);
        if (lane == 0) {
          fx.top.key[warp][r] = rk;
          fx.top.pos[warp][r] = rp;
        }
        if (lane == src && rk != 0u) {  // the lane whose point it was moves on
          t.pop();
          if (++taken % 3 == 0) t.fill(d, sd, tid, n_chip, rk, rp);
        }
      }
      if (arrived) cluster_wait();  // every peer has read the last exchange's records
      __syncthreads();
    };

    if (warp == LEAD) {
      // lane l's slot i holds record CAND_SLOTS l + i
      float cd[CAND_SLOTS], cx[CAND_SLOTS], cy[CAND_SLOTS], cz[CAND_SLOTS];
      uint32_t ci[CAND_SLOTS];
#pragma unroll
      for (int i = 0; i < CAND_SLOTS; ++i) {
        cd[i] = -CUDART_INF_F;
        cx[i] = cy[i] = cz[i] = 0.f;
        ci[i] = 0u;
      }
      uint32_t bound = 0xffffffffu;  // no records yet: the first step exchanges
      uint32_t phase = 0u;
      int exchanges = 0;
      int done = K;         // the steps taken; the picks from here on repeat the last one
      uint32_t last = 0u;   // the last pick's index
      int n = 0;            // picks in the batch being filled
      // the half of the ring the batch being filled goes to is free once the point warps took its last batch
      auto claim = [&]() {
        if (n == 0 && batch >= 2) mbar_wait(&fx.empty[batch & 1], ((batch >> 1) - 1) & 1);
      };
      auto put = [&](float qx, float qy, float qz) {
        claim();
        if (lane == 0) fx.ring[batch & 1][n] = make_float4(qx, qy, qz, 0.f);
        ++n;
      };
      auto publish = [&](uint32_t then) {
        claim();
        __syncwarp();
        if (lane == 0) {
          fx.batch[batch & 1] = static_cast<uint32_t>(n) | (then << 8);
          hopper::mbar_arrive(&fx.full[batch & 1]);
        }
        ++batch;
        n = 0;
      };
      put(px, py, pz);  // the start: the points take it first
      for (int k = 1; k < K; ++k) {
        // the records with the last pick, and their argmax (largest min-distance, then lowest index)
        float bd = -CUDART_INF_F, tx = 0.f, ty = 0.f, tz = 0.f;
        uint32_t bi = 0xffffffffu;
#pragma unroll
        for (int i = 0; i < CAND_SLOTS; ++i) {
          cd[i] = fminf(cd[i], sq_dist(cx[i], cy[i], cz[i], px, py, pz));
          const bool better = cd[i] > bd || (cd[i] == bd && ci[i] < bi);
          bd = better ? cd[i] : bd;
          bi = better ? ci[i] : bi;
          tx = better ? cx[i] : tx;
          ty = better ? cy[i] : ty;
          tz = better ? cz[i] : tz;
        }
        uint32_t key = dist_key(bd);
        uint32_t wk = __reduce_max_sync(0xffffffffu, key);
        if (__builtin_expect(!kWork || wk <= bound, 0)) {
          // ---- an exchange: the CTA's TOP + 1 largest, TOP records and the bound to every peer
          publish(THEN_EXCHANGE);
          exchange_top();
          // the 16 point warps' lists merged (this warp's is empty): lane w < WARPS walks warp w's
          int h = 0;
          uint32_t hk = lane < WARPS ? fx.top.key[lane][0] : 0u, hp = lane < WARPS ? fx.top.pos[lane][0] : 0xffffffffu;
          uint32_t rk[TOP + 1], rp[TOP + 1];
#pragma unroll
          for (int r = 0; r <= TOP; ++r) {
            const int src = warp_argmax(hk, hp, rk[r], rp[r]);
            if (lane == src && rk[r] != 0u) {
              ++h;
              hk = h <= TOP ? fx.top.key[lane][h] : 0u;
              hp = h <= TOP ? fx.top.pos[lane][h] : 0xffffffffu;
            }
          }
          // lane l sends peer l % 16 the records of its half (l / 16) of the TOP, and the first half the bound
          const uint32_t peer = lane % CLUSTER, half = lane / CLUSTER;
          const uint32_t bar = peer_addr(&fx.bar[0], peer);
#pragma unroll
          for (int r = 0; r < TOP; ++r) {
            if ((r & 1) == static_cast<int>(half)) {
              float4 q = make_float4(0.f, 0.f, 0.f, __int_as_float(0));  // no point: index 0 at the origin
              if (rk[r] != 0u) q = sp[rp[r]];
              const int slot = static_cast<int>(rank) * TOP + r;
              st_async_v4(peer_addr(&li->a[slot], peer), bar,
                          make_uint4(rk[r], ~static_cast<uint32_t>(__float_as_int(q.w)), __float_as_uint(q.x),
                                     __float_as_uint(q.y)));
              st_async_b32(peer_addr(&li->z[slot], peer), bar, __float_as_uint(q.z));
            }
          }
          if (half == 0) st_async_b32(peer_addr(&li->bound[rank], peer), bar, rk[TOP]);
          // the records, their bound, and the step's winner among them
          mbar_wait(&fx.bar[0], phase);
          phase ^= 1u;
          bound = __reduce_max_sync(0xffffffffu, lane < CLUSTER ? li->bound[lane] : 0u);
          bd = -CUDART_INF_F;
          bi = 0xffffffffu;
#pragma unroll
          for (int i = 0; i < CAND_SLOTS; ++i) {
            const int c = lane * CAND_SLOTS + i;
            const uint4 a = li->a[c];
            cd[i] = key_dist(a.x);
            ci[i] = ~a.y;
            cx[i] = __uint_as_float(a.z);
            cy[i] = __uint_as_float(a.w);
            cz[i] = __uint_as_float(li->z[c]);
            const bool better = cd[i] > bd || (cd[i] == bd && ci[i] < bi);
            bd = better ? cd[i] : bd;
            bi = better ? ci[i] : bi;
            tx = better ? cx[i] : tx;
            ty = better ? cy[i] : ty;
            tz = better ? cz[i] : tz;
          }
          if (lane == 0) arm_list(&fx.bar[0]);  // for the next exchange, whose records come after every CTA arrives
          __syncwarp();
          cluster_arrive();  // this CTA has read the records
          arrived = true;
          ++exchanges;
          key = dist_key(bd);
          wk = __reduce_max_sync(0xffffffffu, key);
        }
        // the winner: the largest key, then the lowest index
        uint32_t wmask = __ballot_sync(0xffffffffu, key == wk);
        if (__builtin_expect(__popc(wmask) > 1, 0)) {
          const uint32_t wi = __reduce_min_sync(0xffffffffu, key == wk ? bi : 0xffffffffu);
          wmask = __ballot_sync(0xffffffffu, key == wk && bi == wi);
        }
        const int src = __ffs(wmask) - 1;
        last = wk != 0u ? __shfl_sync(0xffffffffu, bi, src) : 0u;  // no point at all: index 0
        px = __shfl_sync(0xffffffffu, tx, src);
        py = __shfl_sync(0xffffffffu, ty, src);
        pz = __shfl_sync(0xffffffffu, tz, src);
        if (kWork && cid == 0 && rank == 0 && lane == 0) out[k] = static_cast<int>(last);
        if (kWork && wk <= 1u) {  // min-distance 0 (or no point): every later pick is this one
          done = k + 1;
          break;
        }
        if (k + 1 < K) {
          put(px, py, pz);
          if (n == BATCH) publish(THEN_NEXT);
        }
      }
      publish(THEN_END);
      if (kWork && cid == 0 && rank == 0) {
        for (int k = done + lane; k < K; k += 32) out[k] = static_cast<int>(last);
        if (lane == 0) {
          ctrl[4] = static_cast<unsigned>(exchanges);
          atomicAdd(&totals[0], static_cast<unsigned long long>(K - 1));
          atomicAdd(&totals[1], static_cast<unsigned long long>(exchanges));
        }
      }
    } else {
      // a point warp: each batch's picks into its points, then what the batch's flag says
      for (;;) {
        mbar_wait(&fx.full[batch & 1], (batch >> 1) & 1);
        const uint32_t b = fx.batch[batch & 1];
        float4 q[BATCH];
#pragma unroll
        for (int i = 0; i < BATCH; ++i) q[i] = fx.ring[batch & 1][i];
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&fx.empty[batch & 1]);
        ++batch;
        const int n = static_cast<int>(b & 0xffu);
        const uint32_t then = b >> 8;
        if (then == THEN_END) break;
        if (kWork) {
          const bool w = wide(tid);
#pragma unroll
          for (int i = 0; i < BATCH; ++i) {
            if (i < n) {
#pragma unroll
              for (int j = 0; j < SLOTS_ALL; ++j) d[j] = fminf(d[j], sq_dist(x[j], y[j], z[j], q[i].x, q[i].y, q[i].z));
              if (w) {
#pragma unroll
                for (int j = SLOTS_ALL; j < REG_SLOTS; ++j)
                  d[j] = fminf(d[j], sq_dist(x[j], y[j], z[j], q[i].x, q[i].y, q[i].z));
              }
            }
          }
          for (int p = REG_POINTS + tid; p < n_chip; p += PT) {
            const float4 s = sp[p];
            float dd = sd[p - REG_POINTS];
#pragma unroll
            for (int i = 0; i < BATCH; ++i)
              if (i < n) dd = fminf(dd, sq_dist(s.x, s.y, s.z, q[i].x, q[i].y, q[i].z));
            sd[p - REG_POINTS] = dd;
          }
        }
        if (then == THEN_EXCHANGE) {
          exchange_top();
          cluster_arrive();  // this warp reads none of the records
          arrived = true;
        }
      }
    }
  } else {
    const bool writer = kWork && cid == 0 && rank == 0 && tid == 0;
    for (int k = 1; k < K; ++k) {
      const int par = k & 1;
      // update this thread's points; the best (first on ties: positions ascend with the index)
      float bv = -CUDART_INF_F;
      int bp = 0;
      if (kWork) {
        // every slot, used or not (an empty one holds -inf and never wins): no branch keeps the updates
        // independent, which measured faster than skipping the empty slots
#pragma unroll
        for (int j = 0; j < STEP_SLOTS; ++j) {
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
      if (writer) out[k] = static_cast<int>(idx);
    }
    if (writer) {  // every selection was an exchange
      ctrl[4] = static_cast<unsigned>(K - 1);
      atomicAdd(&totals[0], static_cast<unsigned long long>(K - 1));
      atomicAdd(&totals[1], static_cast<unsigned long long>(K - 1));
    }
  }
  // no peer writes into this CTA's shared memory after the last exchange's records, which it has waited for
}

template <bool kWork, bool kOverflow>
int launch(const float* pts, const uint8_t* valid, const int* start, int N, int K, int clusters, int cta_cap,
           int share_cap, int smem_points, float4* staging, float* odist, unsigned* ctrl, unsigned long long* slots,
           unsigned long long* totals, int* out, cudaStream_t stream) {
  if (K < 1 || clusters < 1 || clusters > MAX_CLUSTERS || cta_cap < 1 || share_cap < cta_cap || smem_points < 0 ||
      N < (kWork ? 1 : 0) || N >= (1 << IDX_BITS) - 1 ||
      (kWork && static_cast<long long>(share_cap) * CLUSTER * clusters < N) || (kOverflow && !odist) ||
      (kWork && !totals))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = SMEM_FIXED + 16 * static_cast<size_t>(cta_cap) + 4 * static_cast<size_t>(smem_points);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  // the candidate records after the points, where the CTA's shared memory has room for them
  const size_t list_at = (smem + 15) & ~static_cast<size_t>(15);
  const int list_room = list_at + sizeof(ListIn) <= SMEM_LIMIT ? 1 : 0;
  if (list_room) smem = list_at + sizeof(ListIn);
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
                           slots, totals, out, clusters, list_room);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pts (N, 3) fp32, valid (N,) bytes, start (1,) int32, out (K,) int32;
// staging (N,) float4 scratch; odist (N,) fp32 scratch (null unless
// share_cap > cta_cap); ctrl (5 + 16 * clusters,) uint32 and slots
// (2 * 7 * 4,) uint64 set to zero; totals (2,) uint64, to which the launch
// adds its selections (K - 1) and its exchanges; clusters, cta_cap (points a
// CTA holds on chip), share_cap (points a CTA may own, >= cta_cap) and
// smem_points (of the on-chip points, those beyond the registers) as
// ops/fps.py launch_plan gives them. After the launch ctrl[2] holds the
// cluster size the kernel ran with, ctrl[3] the clusters it used and ctrl[4]
// its exchanges. Returns a cudaError_t (0 = launched).
extern "C" int fps_f32(const float* pts, const uint8_t* valid, const int* start, int N, int K, int clusters,
                       int cta_cap, int share_cap, int smem_points, void* staging, void* odist, unsigned* ctrl,
                       unsigned long long* slots, unsigned long long* totals, int* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* st = static_cast<float4*>(staging);
  float* od = static_cast<float*>(odist);
  if (share_cap > cta_cap)
    return launch<true, true>(pts, valid, start, N, K, clusters, cta_cap, share_cap, smem_points, st, od, ctrl, slots,
                              totals, out, s);
  return launch<true, false>(pts, valid, start, N, K, clusters, cta_cap, share_cap, smem_points, st, od, ctrl, slots,
                             totals, out, s);
}

// The same launch with the points compiled out: K - 1 exchanges of
// `clusters` clusters (1: the candidate list's exchange, TOP records a CTA and
// the bound; more: one record a CTA and the second level) and nothing else.
// ctrl, slots and out as above (out is scratch).
extern "C" int fps_exchange_probe(int K, int clusters, unsigned* ctrl, unsigned long long* slots, int* out,
                                  void* stream) {
  return launch<false, false>(nullptr, nullptr, nullptr, 0, K, clusters, 1, 1, 0, nullptr, nullptr, ctrl, slots,
                              nullptr, out, static_cast<cudaStream_t>(stream));
}
