// Furthest-point sampling for Hopper (sm_90a): K strictly sequential
// selections in ONE cooperative launch.
//
// Replaces the Pallas TPU kernel `_fps_kernel` (recondet3d/ops/fps_pallas.py:54,
// launched by `furthest_point_sample_pallas`): exact FPS over (N, 3) fp32
// points with a validity mask, K int32 indices out.
//
// What bounds it on this card: not bytes (13 B a point, read from device
// memory once) and not the K*N distance updates (fp32 FMA
// rate), but K dependent steps: every selection needs the argmax over ALL
// points before the next can start, i.e. one grid-wide exchange per
// selection. The design keeps everything else off that critical path:
//
//  - a few dozen persistent blocks, at most one per SM (cooperative launch,
//    so all are co-resident): fewer blocks make the exchange cheaper, more
//    blocks make a block's share smaller, and the sweep in
//    tools/fps_sweep.py found the balance;
//  - a block keeps its share of the VALID points (32-point chunks dealt
//    round-robin, compacted at load: an invalid point can only be picked
//    when no valid one exists, and then the answer is index 0), with their
//    indices and running min-distances, in shared memory for the whole
//    launch (20 B a point);
//  - per selection each block updates its share four points at a time,
//    reduces (max distance, lowest index) with the hardware warp reductions
//    (`redux.sync` on an order-preserving integer key), and publishes ONE
//    64-bit word {distance key, index, 10-bit step tag} to its slot in
//    device memory;
//  - the grid-wide exchange is that word itself: every block polls the G
//    slots of the step (volatile loads served by L2) until each carries the
//    step's tag, and reduces them redundantly; each polling lane fetches its
//    candidate's coordinates before that reduction, so the load's latency
//    hides behind it. A 64-bit aligned store is single-copy atomic, so no
//    fence, no atomic counter and no second round trip are needed. Slots
//    are double-buffered by step parity: a block can run at most one step
//    ahead of the slowest reader.
//
// Rounding and ties are those of the plain PyTorch version
// (ops/sampling.py furthest_point_sample_plain), so the index sequences are
// identical: d = (dx*dx + dy*dy) + dz*dz with every product and sum rounded
// separately (__fmul_rn / __fadd_rn keep nvcc from contracting them into
// FMAs), min-distance starts at 1e10 for valid and -inf for invalid points,
// invalid points' coordinates count as 0, and the maximum goes to the LOWEST
// index (torch.argmax's rule).
//
// Plain C interface (no PyTorch headers): the wrapper in ops/fps.py passes
// raw pointers and the current stream.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kIdxBits = 22;                       // N < 2^22 - 1
constexpr int kIdxMask = (1 << kIdxBits) - 1;
constexpr int kTagBits = 10;
constexpr unsigned kTagMask = (1u << kTagBits) - 1;
constexpr int kNoIndex = 0x7fffffff;
constexpr size_t kMaxSmem = 232448 - 1024;         // a block's shared memory, less the static part
constexpr int kDefaultBlocks = 44;                 // tools/fps_sweep.py: the fastest at the pipeline's sizes

// A min-distance is -inf (invalid point) or >= +0, so this unsigned key
// orders like the float: -inf -> 0, d -> bits(d) + 1.
__device__ __forceinline__ unsigned dist_key(float d) {
    return d == -CUDART_INF_F ? 0u : __float_as_uint(d) + 1u;
}

// every lane ends with the warp's (max key, lowest index holding it)
__device__ __forceinline__ void warp_best(unsigned& key, int& idx) {
    const unsigned m = __reduce_max_sync(0xffffffffu, key);
    idx = (int)__reduce_min_sync(0xffffffffu, key == m ? (unsigned)idx : (unsigned)kNoIndex);
    key = m;
}

// kWork = false compiles the distance update out: what is left is the
// grid-wide exchange alone, timed as the latency floor of one selection.
template <bool kWork>
__global__ void __launch_bounds__(1024, 1)
fps_kernel(const float* __restrict__ pts,      // (N, 3)
           const uint8_t* __restrict__ valid,  // (N,)
           const int* __restrict__ start,      // (1,) first selected index
           int N, int K, int cap,
           int* __restrict__ out,              // (K,)
           unsigned long long* slots)          // (2 * gridDim.x,), zeroed by the caller
{
    extern __shared__ float smem[];
    float* sx = smem;
    float* sy = sx + cap;
    float* sz = sy + cap;
    float* sd = sz + cap;
    int* si = reinterpret_cast<int*>(sd + cap);
    __shared__ unsigned wk[32], gk[32];
    __shared__ int wi[32], gi[32];
    __shared__ float gx[32], gy[32], gz[32];
    __shared__ int s_count;

    const int tid = threadIdx.x, T = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
    const int G = gridDim.x;
    const int poll_warps = min(nwarps, (G + 31) >> 5);

    // load: chunk c (points 32c .. 32c+31) belongs to block c % G; each warp
    // compacts its chunk's valid points into the block's arrays
    if (tid == 0) s_count = 0;
    __syncthreads();
    if (kWork) {
        const int n_chunks = (N + 31) >> 5;
        for (int c = blockIdx.x + warp * G; c < n_chunks; c += nwarps * G) {
            const int g = c * 32 + lane;
            const bool ok = g < N && valid[g] != 0;
            const unsigned mask = __ballot_sync(0xffffffffu, ok);
            int at = 0;
            if (lane == 0 && mask) at = atomicAdd(&s_count, __popc(mask));
            at = __shfl_sync(0xffffffffu, at, 0) + __popc(mask & ((1u << lane) - 1u));
            if (ok) {
                sx[at] = pts[3 * g + 0];
                sy[at] = pts[3 * g + 1];
                sz[at] = pts[3 * g + 2];
                sd[at] = 1e10f;
                si[at] = g;
            }
        }
    }
    float px = 0.f, py = 0.f, pz = 0.f;  // the last selected point; an invalid one counts as the origin
    if (kWork) {
        const int first = start[0];
        if (valid[first] != 0) { px = pts[3 * first + 0]; py = pts[3 * first + 1]; pz = pts[3 * first + 2]; }
        if (blockIdx.x == 0 && tid == 0) out[0] = first;
    }
    __syncthreads();
    const int n_local = s_count;

    for (int k = 1; k < K; ++k) {
        float bv = -CUDART_INF_F;
        int bi = kNoIndex;
        if (kWork) {
            // the compacted rows are in no particular order, so ties compare indices
            int j = tid;
            for (; j + 3 * T < n_local; j += 4 * T) {
                float d[4];
                int idx[4];
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int r = j + u * T;
                    const float dx = sx[r] - px, dy = sy[r] - py, dz = sz[r] - pz;
                    d[u] = fminf(sd[r], __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));
                    idx[u] = si[r];
                }
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    sd[j + u * T] = d[u];
                    if (d[u] > bv || (d[u] == bv && idx[u] < bi)) { bv = d[u]; bi = idx[u]; }
                }
            }
            for (; j < n_local; j += T) {
                const float dx = sx[j] - px, dy = sy[j] - py, dz = sz[j] - pz;
                const float d = fminf(sd[j], __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));
                const int idx = si[j];
                sd[j] = d;
                if (d > bv || (d == bv && idx < bi)) { bv = d; bi = idx; }
            }
            // with no valid point anywhere every key is 0, and the answer is index 0 (argmax of all -inf)
            if (blockIdx.x == 0 && tid == 0 && bi == kNoIndex) bi = 0;
        }
        // block argmax -> one 64-bit word in this block's slot of the step
        unsigned bk = dist_key(bv);
        warp_best(bk, bi);
        if (lane == 0) { wk[warp] = bk; wi[warp] = bi; }
        __syncthreads();
        const unsigned tag = (unsigned)k & kTagMask;
        unsigned long long* step_slots = slots + (size_t)(k & 1) * G;
        if (warp == 0) {
            unsigned key = lane < nwarps ? wk[lane] : 0u;
            int i = lane < nwarps ? wi[lane] : kNoIndex;
            warp_best(key, i);
            if (lane == 0) {
                const unsigned long long w = ((unsigned long long)key << 32)
                    | ((unsigned long long)(unsigned)min(i, kIdxMask) << kTagBits) | tag;
                *((volatile unsigned long long*)(step_slots + blockIdx.x)) = w;
            }
            __syncwarp();
        }
        // grid-wide exchange: wait for every block's word of this step
        if (warp < poll_warps) {
            unsigned ck = 0u;
            int ci = kNoIndex;
            for (int j = tid; j < G; j += T) {
                const volatile unsigned long long* s = step_slots + j;
                unsigned long long w;
                do { w = *s; } while (((unsigned)w & kTagMask) != tag);
                const unsigned key = (unsigned)(w >> 32);
                const int i = (int)((w >> kTagBits) & kIdxMask);
                if (key > ck || (key == ck && i < ci)) { ck = key; ci = i; }
            }
            // fetch this lane's candidate before the reduction, so that the
            // load's latency overlaps it; a key of 0 is an invalid point
            float cx = 0.f, cy = 0.f, cz = 0.f;
            if (kWork && ck != 0u) { cx = __ldg(pts + 3 * ci + 0); cy = __ldg(pts + 3 * ci + 1); cz = __ldg(pts + 3 * ci + 2); }
            const int mine = ci;
            warp_best(ck, ci);
            const int src = __ffs(__ballot_sync(0xffffffffu, mine == ci)) - 1;
            cx = __shfl_sync(0xffffffffu, cx, src);
            cy = __shfl_sync(0xffffffffu, cy, src);
            cz = __shfl_sync(0xffffffffu, cz, src);
            if (lane == 0) { gk[warp] = ck; gi[warp] = ci; gx[warp] = cx; gy[warp] = cy; gz[warp] = cz; }
        }
        __syncthreads();
        int best = 0;
        for (int w = 1; w < poll_warps; ++w)
            if (gk[w] > gk[best] || (gk[w] == gk[best] && gi[w] < gi[best])) best = w;
        px = gx[best]; py = gy[best]; pz = gz[best];
        if (blockIdx.x == 0 && tid == 0) out[k] = gi[best];
    }
}

template <bool kWork>
int launch(const float* pts, const uint8_t* valid, const int* start, int N, int K, int threads, int blocks,
           int* out, unsigned long long* slots, int slots_len, cudaStream_t stream)
{
    int dev = 0, sms = 0, coop = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (!coop) return (int)cudaErrorNotSupported;
    if (threads < 32 || threads > 1024 || (threads & 31) || K < 1 || N < (kWork ? 1 : 0) || N >= kIdxMask)
        return (int)cudaErrorInvalidValue;

    // at most one block per SM (cooperative launch: all co-resident); never
    // fewer blocks than it takes to hold a share's 20 bytes a point in shared
    // memory. A block gets at most ceil(chunks / G) chunks of 32 points.
    const int n_chunks = (N + 31) / 32;
    const int max_chunks = (int)(kMaxSmem / (32 * 20));  // chunks one block can keep resident
    const int need = (n_chunks + max_chunks - 1) / max_chunks;
    const int wanted = need > kDefaultBlocks ? need : kDefaultBlocks;
    const int G = blocks > 0 ? blocks : (wanted < sms ? wanted : sms);
    if (G > sms || G < need || G < 1 || 2 * G > slots_len) return (int)cudaErrorInvalidValue;
    int cap = ((n_chunks + G - 1) / G) * 32;
    size_t smem = 5 * sizeof(float) * (size_t)cap;
    auto kern = fps_kernel<kWork>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;

    void* args[] = {&pts, &valid, &start, &N, &K, &cap, &out, &slots};
    err = cudaLaunchCooperativeKernel((void*)kern, dim3(G), dim3(threads), args, smem, stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // namespace

// pts (N, 3) fp32, valid (N,) bytes, start (1,) int32, out (K,) int32, slots
// (slots_len >= 2 * blocks) 64-bit words set to zero, all on the current
// device. blocks = 0 takes the default (kDefaultBlocks, more where shared
// memory needs it). Returns a cudaError_t (0 = launched).
extern "C" int fps_f32(const float* pts, const uint8_t* valid, const int* start, int N, int K, int threads,
                       int blocks, int* out, unsigned long long* slots, int slots_len, void* stream)
{
    return launch<true>(pts, valid, start, N, K, threads, blocks, out, slots, slots_len, (cudaStream_t)stream);
}

// The same launch with the distance update compiled out: K - 1 rounds of the
// grid-wide exchange and nothing else. out (K,) is scratch.
extern "C" int fps_exchange_probe(int K, int threads, int blocks, int* out, unsigned long long* slots,
                                  int slots_len, void* stream)
{
    return launch<false>(nullptr, nullptr, nullptr, 0, K, threads, blocks, out, slots, slots_len,
                         (cudaStream_t)stream);
}
