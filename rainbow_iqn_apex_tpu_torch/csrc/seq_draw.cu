// K5s: the stratified proportional draw of R2D2's sequence replay, over the
// effective priorities.
//
//   p_eff     = p                             if sum(p) > 0
//             = 1 on slots [0, F), 0 after    otherwise (F = max(filled, 1): the cold-ring guard)
//   total     = sum p_eff,  cdf = inclusive cumulative sum of p_eff
//   u[g, b]   = (b + U[g, b]) / B * total     (U: [G, B] uniforms in [0, 1))
//   idx[g, b] = min(#{i : cdf[i] <= u[g, b]}, C - 1)   (searchsorted side="right", clipped)
//
// Replaces DeviceSequenceReplay._effective_priority and draw
// (rainbow_iqn_apex_tpu/replay/device_sequence.py:208-232) and the G vmapped
// draws of sample_grouped (:264-276), XLA-fused on the TPU.  The choice
// between p and the uniform fallback is made here, on the device: no host
// read of the sum.  meta[0] = total and meta[1] = 1 when the fallback is on
// go to K8s, which needs both for prob.
//
// Bound on the H100: one read of p (33 KB at C = 8,333) and a few hundred
// searches: launch-bound.  Design: one block of 1,024 threads.  It walks p in
// tiles of 4,096, four consecutive slots per thread, and writes the cdf to a
// scratch vector; then each draw is a binary search over it.  The cdf is built
// in levels (thread, warp, block, tile), each value an offset plus the value
// within its group, and each next offset is the previous offset plus the last
// value within the group: exactly the group's last cdf value.  Every rounding
// step is monotone, so the cdf is monotone in fp32, as in exact arithmetic,
// and a right search never lands on a slot with p = 0 (its cdf equals its
// left neighbour's).  With the fallback the cdf is min(i + 1, F), exact in
// fp32, and the search is a floor.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int PER_THREAD = 4;
constexpr int TILE = THREADS * PER_THREAD;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS) seq_draw_kernel(
    const float* __restrict__ p, int C, int F, const float* __restrict__ uniforms, int draws,
    int B, float* __restrict__ cdf, int* __restrict__ idx, float* __restrict__ meta) {
    __shared__ float warp_total[WARPS];
    __shared__ float tile_prefix;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (threadIdx.x == 0) tile_prefix = 0.f;
    __syncthreads();
    for (int base = 0; base < C; base += TILE) {
        // within the thread: a running sum from 0 over its four slots
        const int first = base + threadIdx.x * PER_THREAD;
        float v[PER_THREAD];
        float run = 0.f;
#pragma unroll
        for (int i = 0; i < PER_THREAD; ++i) {
            run += first + i < C ? p[first + i] : 0.f;
            v[i] = run;
        }
        // within the warp: offset[l + 1] = offset[l] + (lane l's last value)
        float lane_off = 0.f, chain = 0.f;
        for (int l = 0; l < 32; ++l) {
            const float s = __shfl_sync(0xffffffffu, v[PER_THREAD - 1], l);
            if (l == lane) lane_off = chain;
            chain += s;
        }
#pragma unroll
        for (int i = 0; i < PER_THREAD; ++i) v[i] = lane_off + v[i];
        if (lane == 31) warp_total[warp] = v[PER_THREAD - 1];
        __syncthreads();
        // within the block: offset[w + 1] = offset[w] + (warp w's last value)
        float warp_off = 0.f;
        for (int w = 0; w < warp; ++w) warp_off += warp_total[w];
        const float prefix = tile_prefix;
#pragma unroll
        for (int i = 0; i < PER_THREAD; ++i) {
            v[i] = prefix + (warp_off + v[i]);
            if (first + i < C) cdf[first + i] = v[i];
        }
        __syncthreads();  // every thread has read tile_prefix and warp_total
        if (threadIdx.x == THREADS - 1) tile_prefix = v[PER_THREAD - 1];
        __syncthreads();
    }
    const float raw_total = tile_prefix;  // the tile chain's last value: cdf[C - 1]
    const bool fallback = !(raw_total > 0.f);
    const float total = fallback ? (float)F : raw_total;
    if (threadIdx.x == 0) {
        meta[0] = total;
        meta[1] = fallback ? 1.f : 0.f;
    }
    for (int d = threadIdx.x; d < draws; d += THREADS) {
        const float u = ((float)(d % B) + uniforms[d]) / (float)B * total;
        int count;
        if (fallback) {
            count = u >= (float)F ? C : (int)floorf(u);
        } else {  // #{i : cdf[i] <= u} over the monotone cdf
            int lo = 0, hi = C;
            while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                if (cdf[mid] <= u) lo = mid + 1; else hi = mid;
            }
            count = lo;
        }
        idx[d] = min(count, C - 1);
    }
}

}  // namespace

// p [C] f32, uniforms [draws] f32 (draws = G * B), cdf [C] f32 scratch, idx
// [draws] int32, meta [2] f32 (total, fallback flag); F = max(filled, 1).
// draws == 0 computes meta only.
PORT_API int port_seq_draw(const void* p, const void* uniforms, void* cdf, void* idx, void* meta,
                           int C, int F, int draws, int B, void* stream) {
    if (C < 1 || F < 1 || F > C || (draws > 0 && B < 1)) return (int)cudaErrorInvalidValue;
    seq_draw_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(p), C, F, static_cast<const float*>(uniforms), draws, B,
        static_cast<float*>(cdf), static_cast<int*>(idx), static_cast<float*>(meta));
    return (int)cudaGetLastError();
}
