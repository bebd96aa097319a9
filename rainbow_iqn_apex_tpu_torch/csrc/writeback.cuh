// The fenced priority write-back, in one place for every kernel that runs it:
// K6 (csrc/replay_writeback.cu) and its fold into K1's weighted launch
// (csrc/quantile_huber.cu), and K6f's queue of mirror updates, applied by
// K6f's own launch (csrc/frontier_writeback.cu) or by K5f's chunk blocks
// before they sum (csrc/replay_draw.cu).
//
// The contract (rainbow_iqn_apex_tpu/replay/device.py:321-346, frontier.py:145-151):
// a group of draws reads each slot's value from before the group (the fence),
// writes its priority where that value is > 0 and 0 elsewhere (a slot is never
// resurrected), and where a slot repeats in the group its last occurrence is
// written.  An id outside the slots is dropped, as XLA drops an out-of-bounds
// scatter update.  Groups apply in order: each fence reads what the groups
// before it left.
#pragma once

#include <math.h>

namespace port {

// The maximum, NaN if either is NaN (jnp.maximum's and torch.maximum's rule).
__device__ __forceinline__ float nan_max(float a, float b) {
    return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}

// x^omega; omega == 0.5 takes sqrtf, as XLA rewrites a constant power of 0.5
// and torch a scalar one.
__device__ __forceinline__ float priority_of(float x, float omega) {
    return omega == 0.5f ? sqrtf(x) : powf(x, omega);
}

// nan_max of every thread's m over the block, handed to every thread.
// scratch: 33 floats of shared memory.  Ends with a block barrier.
__device__ __forceinline__ float block_nan_max(float m, float* scratch) {
    for (int d = 16; d > 0; d >>= 1) m = nan_max(m, __shfl_down_sync(0xffffffffu, m, d));
    if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
        float all = scratch[0];
        for (int w = 1; w < (int)(blockDim.x >> 5); ++w) all = nan_max(all, scratch[w]);
        scratch[32] = all;
    }
    __syncthreads();
    return scratch[32];
}

// One group of a fenced write-back by the block's threads.  Thread t holds
// draws k = t + r * blockDim.x (r < R) of the group's ids[0, n): its slot,
// whether the slot lies in the caller's range (false for k >= n), its
// priority and the fence value cur, the slot's value before the group (read
// by the caller, so that it can be read early).  A draw writes where no
// later draw of the group holds its slot: pri where cur > 0 (or where fence
// is off: K6s), else 0.  A group of at most 32 draws (the learner's B 32) is
// held by warp 0, whose lanes compare their slots with the later lanes' by
// 31 independent shuffles (~100 cycles; __match_any_sync took 430, measured,
// and a scan of ids in device memory a load each); a larger group scans
// ids, which the caller keeps in shared memory where it can.  Barriers (sync: every thread that holds a
// draw, the block's by default) between the group's reads and its writes,
// and after the writes, so that the next group's reads see them.
struct BlockSync {
    __device__ void operator()() const { __syncthreads(); }
};

template <int R, class Store, class Sync = BlockSync>
__device__ __forceinline__ void scatter_group(const int* ids, int n, const int (&slot)[R],
                                              const bool (&inside)[R], const float (&pri)[R],
                                              const float (&cur)[R], bool fence, Store store,
                                              Sync sync = Sync()) {
    bool last[R];
    float write[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int k = threadIdx.x + r * blockDim.x;
        bool l = inside[r];
        if (n <= 32) {  // the lanes of warp 0 hold the draws (r 0)
            if (r == 0 && threadIdx.x < 32) {
                // a lane past n takes a key no slot in range can equal
                const int key = k < n ? slot[0] : -1 - k;
#pragma unroll
                for (int d = 1; d < 32; ++d) {
                    const int later = __shfl_down_sync(0xffffffffu, key, d);
                    l &= k + d >= 32 || later != key;
                }
            }
        } else if (l) {
#pragma unroll 8
            for (int j = k + 1; j < n; ++j) l &= ids[j] != slot[r];
        }
        last[r] = l;
        write[r] = !fence || cur[r] > 0.f ? pri[r] : 0.f;
    }
    sync();  // every fence read of the group before its writes
#pragma unroll
    for (int r = 0; r < R; ++r)
        if (last[r]) store(slot[r], write[r]);
    sync();  // the writes before the next group's reads
}

// ---------------------------------------------------------------- K6f's queue
// The sample frontier's mirror updates in program order, not yet applied
// (replay/frontier.py): staged segments, plain sets of host-append leaves at
// distinct slots, and write-back batches, one learn step's fenced write of
// (|td| + eps)^omega.  A kernel takes the queue by value (__grid_constant__).
constexpr int kQueueSegments = 32;  // kernels/frontier_writeback.py: QUEUE_SEGMENTS
constexpr int kSegmentRows = 4;     // draws a thread: a batch <= 1024 in a 256-thread block
enum : int { kStaged = 0, kWriteback = 1 };

struct QueueSegment {
    const int* ids;     // [n] int32 slots
    const float* vals;  // [n] f32: the leaf (staged) or td (write-back)
    int n;
    int kind;
};

struct MirrorQueue {
    QueueSegment seg[kQueueSegments];
    int segments;
    int longest;  // the largest n
    float eps;
    float omega;
};

// The queue's segment descriptors into shared memory, by thread 0: each
// index a compile-time constant, so each field is one broadcast constant
// load, where a loop over the segments would read the kernel's parameters
// at run-time indices, once a segment.  The caller synchronises before the
// copies are read.
__device__ __forceinline__ void copy_segments(const MirrorQueue& q, QueueSegment* out) {
    if (threadIdx.x != 0) return;
#pragma unroll
    for (int s = 0; s < kQueueSegments; ++s)
        if (s < q.segments) out[s] = q.seg[s];
}


// Slots [lo, hi) of the mirror, read and written in place.
struct MirrorSlots {
    float* p;
    int lo, hi;
    __device__ bool inside(int s) const { return s >= lo && s < hi; }
    __device__ float load(int s) const { return p[s]; }
    __device__ void store(int s, float v) const { p[s] = v; }
};

// Apply one segment to the slots the accessor holds, by the whole block (a
// write-back batch of at most kSegmentRows * blockDim.x draws); ends with a
// block barrier.
template <class Slots>
__device__ __forceinline__ void apply_segment(const QueueSegment& s, float eps, float omega,
                                              const Slots& slots) {
    if (s.kind == kStaged) {
        for (int k = threadIdx.x; k < s.n; k += blockDim.x) {
            const int slot = s.ids[k];
            if (slots.inside(slot)) slots.store(slot, s.vals[k]);
        }
        __syncthreads();
        return;
    }
    int slot[kSegmentRows];
    bool inside[kSegmentRows];
    float pri[kSegmentRows], cur[kSegmentRows];
#pragma unroll
    for (int r = 0; r < kSegmentRows; ++r) {
        const int k = threadIdx.x + r * blockDim.x;
        slot[r] = k < s.n ? s.ids[k] : -1;
        inside[r] = k < s.n && slots.inside(slot[r]);
        pri[r] = inside[r] ? priority_of(fabsf(s.vals[k]) + eps, omega) : 0.f;
        cur[r] = inside[r] ? slots.load(slot[r]) : 0.f;
    }
    scatter_group<kSegmentRows>(s.ids, s.n, slot, inside, pri, cur, true,
                                [&](int sl, float v) { slots.store(sl, v); });
}

}  // namespace port
