// K5: the stratified proportional PER draw of the device replay.
//
//   total     = sum_i p[i]                                      (p: [N] f32, p >= 0)
//   cdf       = inclusive cumulative sum of p
//   u[g, k]   = (k + U[g, k]) / B * total                       (U: [G, B] uniforms in [0, 1))
//   idx[g, k] = min(#{i : cdf[i] <= u[g, k]}, N - 1)            (searchsorted side="right", clipped)
//
// Replaces DeviceReplay.draw (rainbow_iqn_apex_tpu/replay/device.py:207-220)
// and the G vmapped draws of sample_grouped (:309-310), XLA-fused on the TPU.
// As there, a slot with p = 0 has the cdf of its left neighbour, so a right
// search never lands on it, and a u that reaches the last cdf value is
// clipped onto slot N - 1.  The total stays on the device (K8 and K5f read
// it).
//
// Bound on the H100: the one read of p, 4 MB at N = 1,000,000 (~1.2 us at
// 3.35 TB/s); the G*B searches read a few KB each.
//
// The cdf is a nest of levels, each value an offset plus the value within
// its group, each next offset the previous offset plus the group's last
// value (so exactly the group's last value at that level):
//   - a tile of 1024 values, four consecutive values a thread of 256: r, the
//     thread's running sum; a = L + r, L chained over the lanes of the warp;
//     b = W + a, W chained over the 8 warps (tile_scan);
//   - the chunks of 1024 slots are one such level each (b, the chunk-local
//     cdf), and their last values, the chunk sums, are scanned by tile_scan
//     again, in tiles of 1024 chunks chained by T;
//   - cdf[i] = T + (W' + (L' + (R' + b[i]))), where R', L' and W' are the
//     chunk's offsets in the chunk-level scan (R' the thread's running sum
//     before the chunk).
// Every level adds a non-negative value to the offset it starts from, and
// rounding is monotone, so the cdf is non-decreasing in fp32 as in exact
// arithmetic, and a slot with p = 0 repeats its left neighbour's value
// exactly, at every level's boundary too.  On dyadic priorities every sum is
// exact.  Each chain is a fold from 0 that every thread of the group repeats
// over the values before its own (31 adds at most, from shared memory): no
// single thread walks a long chain, and no sum depends on which block
// finishes first.  A path from a slot to the total is at most ~90 rounded
// adds, which bounds the cdf's error against an fp64 one.
//
// Two launches on one stream, no atomics:
//   1. one block per chunk writes the chunk's sum;
//   2. one block per draw scans the chunk sums (every block the same way),
//      takes the total and u, counts the chunks whose last cdf value is <= u
//      (monotone: that count is the chunk holding u), rebuilds that chunk's
//      cdf and counts its slots <= u.  Block 0 writes the total; with no
//      draws one block computes the total only.
// What holds it back: two launches and the latency of each block's chain of
// L2 reads and barriers, not bandwidth.
//
// The queue mode (port_replay_draw_queue, K5f's only): K6f folded into launch
// 1.  The sample frontier queues its mirror updates in program order
// (writeback.cuh: MirrorQueue, staged segments and write-back batches) and
// hands them to its next draw.  Each chunk block finds, from one pass over
// the queue's entries (thread t takes entry t of 8 segments at a time, their
// ids loaded together and with the chunk, the descriptors read at
// compile-time indices; entries past the block's 256 in a second pass),
// which segments touch its chunk,
// and lists those entries (the hits) in shared memory; a block with none
// sums as before.  A block with some copies its chunk into shared memory,
// applies those segments there in order (each write-back batch fenced on
// the values from before the batch, its last entry of a slot written),
// writes each changed slot to p, then sums the chunk: from its hits alone
// where it has at most 128 (apply_hits), else through apply_segment
// (writeback.cuh).  The applies are calls of their own and the kernel is
// held to 32 registers, so that 8 blocks fit an SM and the 977 chunks of a
// 1,000,000-slot mirror run in one wave (at 48 registers, 5 blocks an SM, they
// would take two).  A
// slot lies in one chunk, so the entries of a slot keep their order and
// every fence reads what the segments before it left: the mirror equals the
// one the segments give applied one by one (kernels/frontier_writeback.py:
// frontier_apply_plain), and the draw reads it.
#include "common.cuh"
#include "writeback.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;
constexpr int CHUNK = THREADS * PER_THREAD;
constexpr int WARPS = THREADS / 32;

struct Shared {
    float lane_last[WARPS][32];  // each thread's running sum r[3]
    float warp_last[WARPS];      // each warp's last lane-level value
    float bcast[4];
    int count[WARPS];
};

// The four values of thread t of tile `tile` of x [n] (0 past n); x is
// 16-byte aligned (the wrappers check p; the chunk sums are torch's).
__device__ __forceinline__ void load4(const float* __restrict__ x, long n, long tile,
                                      float (&v)[PER_THREAD]) {
    const long base = tile * CHUNK + (long)threadIdx.x * PER_THREAD;
    if (base + PER_THREAD <= n) {
        const float4 q = *reinterpret_cast<const float4*>(x + base);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
        for (int i = 0; i < PER_THREAD; ++i) v[i] = base + i < n ? x[base + i] : 0.f;
    }
}

// The levels of one tile.  In: v, the thread's four values.  Out: v[i] =
// r[i], the thread's running sums, and L, W, so that the tile-local value of
// slot i is W + (L + r[i]).  Ends with a block barrier.
__device__ __forceinline__ void tile_scan(float (&v)[PER_THREAD], float& L, float& W,
                                          Shared& sh) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int i = 1; i < PER_THREAD; ++i) v[i] = v[i - 1] + v[i];
    sh.lane_last[warp][lane] = v[PER_THREAD - 1];
    __syncwarp();
    float off = 0.f;  // the lanes before this one, chained in lane order
#pragma unroll
    for (int j = 0; j < 31; ++j) {
        const float s = sh.lane_last[warp][j];
        off = j < lane ? off + s : off;
    }
    L = off;
    if (lane == 31) sh.warp_last[warp] = off + v[PER_THREAD - 1];
    __syncthreads();
    float woff = 0.f;  // the warps before this one, chained in warp order
#pragma unroll
    for (int j = 0; j < WARPS - 1; ++j) {
        const float s = sh.warp_last[j];
        woff = j < warp ? woff + s : woff;
    }
    W = woff;
    __syncthreads();  // lane_last and warp_last may be written again
}

__device__ __forceinline__ int block_count(int x, Shared& sh) {
    for (int d = 16; d > 0; d >>= 1) x += __shfl_down_sync(0xffffffffu, x, d);
    if ((threadIdx.x & 31) == 0) sh.count[threadIdx.x >> 5] = x;
    __syncthreads();
    int s = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += sh.count[w];
    __syncthreads();
    return s;
}

__global__ void __launch_bounds__(THREADS) chunk_sum_kernel(const float* __restrict__ p, int n,
                                                            float* __restrict__ partial) {
    __shared__ Shared sh;
    float v[PER_THREAD], L, W;
    load4(p, n, blockIdx.x, v);
    tile_scan(v, L, W, sh);
    if (threadIdx.x == THREADS - 1) partial[blockIdx.x] = W + (L + v[PER_THREAD - 1]);
}

// A chunk of the mirror held in shared memory; a write goes to p too.
struct ChunkSlots {
    float* p;
    float* chunk;
    int lo, hi;
    __device__ bool inside(int s) const { return s >= lo && s < hi; }
    __device__ float load(int s) const { return chunk[s - lo]; }
    __device__ void store(int s, float v) const {
        chunk[s - lo] = v;
        p[s] = v;
    }
};

// The segments in `segs` into the block's chunk [lo, hi) held in shared
// memory (and p), in order.
__device__ __noinline__ void apply_touched(float* p, float* chunk, int lo, int hi,
                                           const port::QueueSegment* seg, int segments,
                                           float eps, float omega, unsigned segs) {
    const ChunkSlots slots{p, chunk, lo, hi};
    for (int s = 0; s < segments; ++s)
        if (segs >> s & 1u) port::apply_segment(seg[s], eps, omega, slots);
}

constexpr int SCAN_SEGMENTS = 8;  // segments whose ids a thread loads at once
constexpr int HITS = 128;         // a chunk's queued entries applied from shared memory

// The hits (segment | kind << 16, entry, slot, value bits) of a chunk, each
// held by one thread, applied to the chunk in shared memory (and p), the
// touched segments in order: a staged entry sets its slot; in a write-back batch the
// last entry of a slot is found by an atomic maximum of (segment, entry) in
// owner (each segment's keys above the earlier ones', so nothing is reset),
// every entry reads its fence before the batch writes, and the last one
// writes.  No device-memory load on the way (the general path,
// apply_touched, reads each segment's ids and values again: ~2,000 cycles
// a batch, measured).
__device__ __noinline__ void apply_hits(float* p, float* chunk, int* owner, const int4* hits,
                                        int nhits, int lo, int segments, float eps, float omega,
                                        unsigned segs, unsigned staged) {
    const int4 hit = (int)threadIdx.x < nhits ? hits[threadIdx.x] : make_int4(-1, 0, 0, 0);
    const int local = hit.z - lo;
    for (int s = 0; s < segments; ++s) {
        if (!(segs >> s & 1u)) continue;
        const bool mine = (hit.x & 0xffff) == s;
        if (staged >> s & 1u) {
            if (mine) {
                chunk[local] = __int_as_float(hit.w);
                p[hit.z] = __int_as_float(hit.w);
            }
            __syncthreads();
            continue;
        }
        const int key = (s << 16) | hit.y;
        float cur = 0.f;
        if (mine) {
            atomicMax(owner + local, key);
            cur = chunk[local];  // the fence: the slot before this batch
        }
        __syncthreads();
        if (mine && owner[local] == key) {
            const float w = cur > 0.f ? port::priority_of(fabsf(__int_as_float(hit.w)) + eps, omega)
                                      : 0.f;
            chunk[local] = w;
            p[hit.z] = w;
        }
        __syncthreads();
    }
}

// Launch 1 with the queue applied first (see the head of this file).
__global__ void __launch_bounds__(THREADS, 8) chunk_sum_queue_kernel(
    float* __restrict__ p, int n, float* __restrict__ partial,
    const __grid_constant__ port::MirrorQueue q) {
    __shared__ Shared sh;
    __shared__ float chunk[CHUNK];
    __shared__ unsigned touched, staged;
    __shared__ port::QueueSegment seg[port::kQueueSegments];  // apply_touched's
    __shared__ int hit_n;
    __shared__ int4 hits[HITS];
    __shared__ int owner[CHUNK];  // apply_hits: a slot's last (segment, entry)
    float v[PER_THREAD], L, W;
    load4(p, n, blockIdx.x, v);
    const int lo = blockIdx.x * CHUNK, hi = min(lo + CHUNK, n);
    if (threadIdx.x == 0) touched = 0u, staged = 0u, hit_n = 0;
    __syncthreads();  // touched and hit_n are zeroed
    // the segments with an entry in this chunk, and those entries (the hits);
    // every descriptor read at a compile-time index (writeback.cuh: copy_segments)
    const int segments = q.segments, t = threadIdx.x;
    unsigned mine = 0u, mine_staged = 0u;
    const auto hit = [&](int s, int kind, const float* vals, int k, int slot) {
        mine |= 1u << s;
        mine_staged |= (kind == port::kStaged ? 1u : 0u) << s;
        const int at = atomicAdd(&hit_n, 1);
        if (at < HITS) hits[at] = make_int4(s | kind << 16, k, slot, __float_as_int(vals[k]));
    };
#pragma unroll
    for (int s0 = 0; s0 < port::kQueueSegments; s0 += SCAN_SEGMENTS) {
        if (s0 >= segments) break;
        int sl[SCAN_SEGMENTS];
#pragma unroll
        for (int i = 0; i < SCAN_SEGMENTS; ++i) {
            const port::QueueSegment& g = q.seg[s0 + i];
            sl[i] = -1;
            if (s0 + i < segments && t < g.n) sl[i] = g.ids[t];
        }
#pragma unroll
        for (int i = 0; i < SCAN_SEGMENTS; ++i)
            if (sl[i] >= lo && sl[i] < hi)
                hit(s0 + i, q.seg[s0 + i].kind, q.seg[s0 + i].vals, t, sl[i]);
    }
    if (q.longest > THREADS) {  // entries past the block's first pass
        for (int s = 0; s < segments; ++s)
            for (int k = t + THREADS; k < q.seg[s].n; k += THREADS) {
                const int slot = q.seg[s].ids[k];
                if (slot >= lo && slot < hi) hit(s, q.seg[s].kind, q.seg[s].vals, k, slot);
            }
    }
    if (mine) {
        atomicOr(&touched, mine);
        atomicOr(&staged, mine_staged);
    }
    __syncthreads();
    const unsigned segs = touched;
    if (segs) {
#pragma unroll
        for (int i = 0; i < PER_THREAD; ++i) {
            chunk[threadIdx.x * PER_THREAD + i] = v[i];
            owner[threadIdx.x * PER_THREAD + i] = -1;
        }
        __syncthreads();
        if (hit_n <= HITS) {
            apply_hits(p, chunk, owner, hits, hit_n, lo, segments, q.eps, q.omega, segs, staged);
        } else {
            port::copy_segments(q, seg);
            __syncthreads();
            apply_touched(p, chunk, lo, hi, seg, segments, q.eps, q.omega, segs);
        }
#pragma unroll
        for (int i = 0; i < PER_THREAD; ++i) v[i] = chunk[threadIdx.x * PER_THREAD + i];
    }
    tile_scan(v, L, W, sh);
    if (threadIdx.x == THREADS - 1) partial[blockIdx.x] = W + (L + v[PER_THREAD - 1]);
}

__global__ void __launch_bounds__(THREADS) search_kernel(
    const float* __restrict__ p, int n, const float* __restrict__ partial, int nchunks,
    const float* __restrict__ uniforms, int draws, int B, int* __restrict__ idx,
    float* __restrict__ total_out) {
    __shared__ Shared sh;
    const int tiles = (nchunks + CHUNK - 1) / CHUNK;
    // The chunk-level scan, tile by tile of chunk sums, T chained over tiles.
    // r[j], L and W of the last tile stay in registers for the search.
    float r[PER_THREAD], L = 0.f, W = 0.f, T = 0.f, T_next = 0.f;
    for (int t = 0; t < tiles; ++t) {
        T = T_next;
        load4(partial, nchunks, t, r);
        tile_scan(r, L, W, sh);
        if (threadIdx.x == THREADS - 1) sh.bcast[0] = T + (W + (L + r[PER_THREAD - 1]));
        __syncthreads();
        T_next = sh.bcast[0];
        __syncthreads();
    }
    const float total = T_next;  // the last chunk's last cdf value
    if (blockIdx.x == 0 && threadIdx.x == 0) *total_out = total;
    const int b = blockIdx.x;
    if (b >= draws) return;
    const float u = ((float)(b % B) + uniforms[b]) / (float)B * total;

    // the chunk holding u: #{chunks whose last cdf value is <= u}
    int c = nchunks;
    T_next = 0.f;
    for (int t = 0; t < tiles; ++t) {
        if (tiles > 1) {  // one tile is still in registers
            T = T_next;
            load4(partial, nchunks, t, r);
            tile_scan(r, L, W, sh);
        }
        int below = 0;
#pragma unroll
        for (int i = 0; i < PER_THREAD; ++i) below += T + (W + (L + r[i])) <= u ? 1 : 0;
        const int k = block_count(below, sh);
        const int in_tile = min(CHUNK, nchunks - t * CHUNK);
        if (k < in_tile) {  // chunk t * CHUNK + k: its thread hands over its offsets
            if (threadIdx.x == k / PER_THREAD) {
                const int j = k % PER_THREAD;
                float prev = 0.f;  // the thread's running sum before chunk k
#pragma unroll
                for (int i = 0; i < PER_THREAD - 1; ++i) prev = i < j ? r[i] : prev;
                sh.bcast[0] = T;
                sh.bcast[1] = W;
                sh.bcast[2] = L;
                sh.bcast[3] = prev;
            }
            c = t * CHUNK + k;
            break;
        }
        if (threadIdx.x == THREADS - 1) sh.bcast[0] = T + (W + (L + r[PER_THREAD - 1]));
        __syncthreads();
        T_next = sh.bcast[0];
        __syncthreads();
    }
    if (c >= nchunks) {  // u >= the last cdf value: searchsorted gives N, clipped
        if (threadIdx.x == 0) idx[b] = n - 1;
        return;
    }
    __syncthreads();
    const float cT = sh.bcast[0], cW = sh.bcast[1], cL = sh.bcast[2], cR = sh.bcast[3];
    // the chunk's own levels, then its offsets in the chunk-level scan
    float v[PER_THREAD], lL, lW;
    load4(p, n, c, v);
    tile_scan(v, lL, lW, sh);
    int count = 0;
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
        const float local = lW + (lL + v[i]);
        count += cT + (cW + (cL + (cR + local))) <= u ? 1 : 0;
    }
    const int k = block_count(count, sh);
    if (threadIdx.x == 0) idx[b] = min(c * CHUNK + k, n - 1);
}

}  // namespace

// p [n] f32, uniforms [draws] f32 (draws = G * B, B = batch), partial
// [nchunks] f32 scratch (the chunk sums), idx [draws] int32, total [] f32;
// queue: null, or a host MirrorQueue applied to p before the sums.  draws
// == 0 computes the total only.
PORT_API int port_replay_draw_queue(void* p, const void* uniforms, void* partial, void* idx,
                                    void* total, int n, int draws, int B, const void* queue,
                                    void* stream) {
    if (n <= 0 || draws < 0 || (draws > 0 && B < 1)) return (int)cudaErrorInvalidValue;
    const port::MirrorQueue* q = static_cast<const port::MirrorQueue*>(queue);
    if (q != nullptr && (q->segments < 1 || q->segments > port::kQueueSegments))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int nchunks = (n + CHUNK - 1) / CHUNK;
    if (q == nullptr)
        chunk_sum_kernel<<<nchunks, THREADS, 0, s>>>(static_cast<const float*>(p), n,
                                                     static_cast<float*>(partial));
    else
        chunk_sum_queue_kernel<<<nchunks, THREADS, 0, s>>>(static_cast<float*>(p), n,
                                                           static_cast<float*>(partial), *q);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    search_kernel<<<draws > 0 ? draws : 1, THREADS, 0, s>>>(
        static_cast<const float*>(p), n, static_cast<const float*>(partial), nchunks,
        static_cast<const float*>(uniforms), draws, B, static_cast<int*>(idx),
        static_cast<float*>(total));
    return (int)cudaGetLastError();
}

// K5: the device ring's draw, no queue.
PORT_API int port_replay_draw(const void* p, const void* uniforms, void* partial, void* idx,
                              void* total, int n, int draws, int B, void* stream) {
    return port_replay_draw_queue(const_cast<void*>(p), uniforms, partial, idx, total, n, draws,
                                  B, nullptr, stream);
}
