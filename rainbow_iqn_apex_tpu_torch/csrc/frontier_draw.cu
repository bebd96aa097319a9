// K5f: the device sample frontier's stratified proportional draw with IS weights.
//
//   idx[g, k]    = K5 over the mirror p [N] with uniforms U [G, B]   (csrc/replay_draw.cu)
//   prob[g, k]   = max(p[idx[g, k]] / max(total, 1e-12), 1e-12)
//   w[g, k]      = (max(n_items, 1) * prob[g, k])^(-beta)
//   weight[g, k] = w[g, k] / max_k w[g, k]                          (per batch row)
//
// Replaces DeviceSampleFrontier's _draw (rainbow_iqn_apex_tpu/replay/frontier.py:125-143),
// one XLA-fused graph on the TPU.  The draw itself is K5's entry point
// (port_replay_draw: one block per chunk of 1,024 slots writes the chunk's
// sum, then one block per draw scans the chunk sums in nested levels and
// searches its chunk; see replay_draw.cu), so a slot with p = 0 is never drawn
// and a u that reaches the total is clipped onto slot N - 1, as in JAX.  This
// file adds the epilogue: one block per batch row of B draws, each thread
// gathers its slot's priority and computes prob and w, and a block reduction
// takes the row maximum.  The maxima propagate NaN, as jnp.maximum and jnp.max
// do.  total is K5's nested sum, not a separate reduction as in JAX
// (mirror.sum()), so prob and weight agree with the JAX graph's to about 1e-6
// relative, not bit for bit.
//
// Bound on the H100: the one read of the mirror, 4 MB at N = 1,000,000
// (~1.2 us at 3.35 TB/s), plus 3 * G * B * 4 bytes out.  The epilogue is G
// blocks of B threads and a few hundred bytes: launch-bound.
//
// The frontier's queued mirror updates (K6f: its staged appends and learner
// write-backs since the last draw, writeback.cuh's MirrorQueue) ride along:
// K5's first launch applies them to the mirror before it sums each chunk
// (replay_draw.cu, the queue mode), so they cost no launch of their own.
#include <math.h>

#include "common.cuh"

PORT_API int port_replay_draw_queue(void* p, const void* uniforms, void* partial, void* idx,
                                    void* total, int n, int draws, int B, const void* queue,
                                    void* stream);

namespace {

constexpr int MAX_B = 1024;

__device__ __forceinline__ float nan_max(float a, float b) {
    return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}

__global__ void __launch_bounds__(MAX_B) weights_kernel(
    const float* __restrict__ p, const int* __restrict__ idx, const float* __restrict__ total,
    float* __restrict__ prob, float* __restrict__ weight, int B, float beta, float n_items) {
    __shared__ float warp_max[MAX_B / 32];
    __shared__ float row_max;
    const int k = threadIdx.x;
    const int i = blockIdx.x * B + k;
    float pr = 0.f;
    float w = -INFINITY;
    if (k < B) {
        pr = nan_max(p[idx[i]] / nan_max(*total, 1e-12f), 1e-12f);
        w = powf(nan_max(n_items, 1.f) * pr, -beta);
    }
    float m = w;
    for (int d = 16; d > 0; d >>= 1) m = nan_max(m, __shfl_down_sync(0xffffffffu, m, d));
    if ((k & 31) == 0) warp_max[k >> 5] = m;
    __syncthreads();
    if (k == 0) {
        float all = warp_max[0];
        for (int wi = 1; wi < (int)(blockDim.x >> 5); ++wi) all = nan_max(all, warp_max[wi]);
        row_max = all;
    }
    __syncthreads();
    if (k < B) {
        prob[i] = pr;
        weight[i] = w / row_max;
    }
}

}  // namespace

// p [n] f32 (16-byte aligned; the queue, null or a host MirrorQueue, is
// applied to it first), uniforms [G * B] f32, partial [nchunks] f32 scratch
// (as port_replay_draw), idx [G * B] int32, total [] f32, prob and weight
// [G * B] f32.
PORT_API int port_frontier_draw(void* p, const void* uniforms, void* partial, void* idx,
                                void* total, void* prob, void* weight, int n, int G, int B,
                                float beta, float n_items, const void* queue, void* stream) {
    if (G < 1 || B < 1 || B > MAX_B) return (int)cudaErrorInvalidValue;
    const int err =
        port_replay_draw_queue(p, uniforms, partial, idx, total, n, G * B, B, queue, stream);
    if (err != 0) return err;
    const int threads = ((B + 31) / 32) * 32;
    weights_kernel<<<G, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(p), static_cast<const int*>(idx),
        static_cast<const float*>(total), static_cast<float*>(prob), static_cast<float*>(weight),
        B, beta, n_items);
    return (int)cudaGetLastError();
}
