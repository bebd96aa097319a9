// K7: one lockstep append tick of every lane into the device replay ring.
//
// For each lane l (ring slot base = l * S, write cursor pos, n = n_step, h = history):
//   frames[l, pos] = frame[l]; actions, rewards, terminals[l, pos] = ...; cuts[l, pos] = term | trunc
//   p[base + pos]                 = 0                        (the fresh slot)
//   p[base + (pos + 1 + k) % S]   = 0 for k < h               (the cursor's dead zone)
//   p[base + (pos - n) % S]       = pri                       (the slot n back becomes eligible)
//     pri = max_priority, or (actor_pri[l] + eps)^omega when the actor gives one;
//           0 when the first cut in the window [pos - n, pos) is a truncation;
//           its own old value while filled < n
//   max_priority = max(max_priority, max_l (actor_pri[l] + eps)^omega)  (actor priorities, filled >= n)
//
// Replaces DeviceReplay.append (rainbow_iqn_apex_tpu/replay/device.py:109-179),
// XLA-fused on the TPU.  The three priority groups are written in the JAX
// order (fresh, dead zone, ready; S > h + n keeps them disjoint), the window
// is read after this tick's cut and terminal are written, and the maximum
// takes the actor priorities before the truncation rule, as there.  pos and
// filled are host counters passed by value; the caller advances them.
//
// Bound on the H100: the L [H, W] uint8 frames in and out, 225 KB at L = 16
// and 84 x 84 (~0.07 us): the kernel is launch-bound.  Design: one block, one
// warp per lane (lanes beyond 32 loop over the warps), the frame copied in
// 16-byte stores, lane 0 of the warp doing the lane's few scalar writes in
// the JAX order, and the maximum a block reduction.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ float nan_max(float a, float b) {
    return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}

__global__ void __launch_bounds__(1024) append_kernel(
    uint8_t* __restrict__ ring_frames, int* __restrict__ ring_actions,
    float* __restrict__ ring_rewards, uint8_t* __restrict__ ring_terms,
    uint8_t* __restrict__ ring_cuts, float* __restrict__ p, float* __restrict__ max_priority,
    const uint8_t* __restrict__ frame, const int* __restrict__ action,
    const float* __restrict__ reward, const uint8_t* __restrict__ term,
    const uint8_t* __restrict__ trunc, const float* __restrict__ actor_pri, int L, int S,
    int hw, int pos, int filled, int h, int n, float eps, float omega) {
    __shared__ float warp_max[32];
    const int lane_id = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
    const float old_max = *max_priority;  // read by all before thread 0 writes it
    float m = -INFINITY;
    for (int l = warp; l < L; l += warps) {
        uint8_t* dst = ring_frames + ((size_t)l * S + pos) * hw;
        const uint8_t* src = frame + (size_t)l * hw;
        if ((hw & 15) == 0 && ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
            const uint4* s4 = reinterpret_cast<const uint4*>(src);
            uint4* d4 = reinterpret_cast<uint4*>(dst);
            for (int i = lane_id; i < hw / 16; i += 32) d4[i] = s4[i];
        } else {
            for (int i = lane_id; i < hw; i += 32) dst[i] = src[i];
        }
        if (lane_id == 0) {
            const size_t base = (size_t)l * S;
            const uint8_t t = term[l] != 0, cut = t | (trunc[l] != 0);
            ring_actions[base + pos] = action[l];
            ring_rewards[base + pos] = reward[l];
            ring_terms[base + pos] = t;
            ring_cuts[base + pos] = cut;
            const int new_pos = (pos + 1) % S;
            const int ready_col = ((pos - n) % S + S) % S;
            const float old_ready = p[base + ready_col];
            float pri = old_max;
            if (actor_pri != nullptr) {
                const float x = actor_pri[l] + eps;
                pri = omega == 0.5f ? sqrtf(x) : powf(x, omega);
                m = nan_max(m, pri);
            }
            // the unbiased time-limit rule: a window whose first cut is a
            // truncation can never bootstrap correctly
            for (int k = 0; k < n; ++k) {
                const size_t c = base + (ready_col + k) % S;
                if (ring_cuts[c]) {
                    if (!ring_terms[c]) pri = 0.f;
                    break;
                }
            }
            if (filled < n) pri = old_ready;  // no complete future yet
            p[base + pos] = 0.f;
            for (int k = 0; k < h; ++k) p[base + (new_pos + k) % S] = 0.f;
            p[base + ready_col] = pri;
        }
    }
    if (lane_id == 0) warp_max[warp] = m;
    __syncthreads();
    if (threadIdx.x == 0 && actor_pri != nullptr && filled >= n) {
        float all = old_max;
        for (int w = 0; w < warps; ++w) all = nan_max(all, warp_max[w]);
        *max_priority = all;
    }
}

}  // namespace

// The ring's tensors in place ([L, S, H, W] uint8 frames; [L, S] int32
// actions, f32 rewards, bool terminals and cuts; [L * S] f32 priorities; []
// f32 max_priority), one tick's [L, H, W] uint8 frames, [L] int32 actions,
// f32 rewards, bool terminals and truncations, and [L] f32 actor |TD| or null.
PORT_API int port_replay_append(void* frames, void* actions, void* rewards, void* terms,
                                void* cuts, void* p, void* max_priority, const void* frame,
                                const void* action, const void* reward, const void* term,
                                const void* trunc, const void* actor_pri, int L, int S, int hw,
                                int pos, int filled, int h, int n, float eps, float omega,
                                void* stream) {
    const int threads = 32 * (L < 32 ? L : 32);
    append_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint8_t*>(frames), static_cast<int*>(actions), static_cast<float*>(rewards),
        static_cast<uint8_t*>(terms), static_cast<uint8_t*>(cuts), static_cast<float*>(p),
        static_cast<float*>(max_priority), static_cast<const uint8_t*>(frame),
        static_cast<const int*>(action), static_cast<const float*>(reward),
        static_cast<const uint8_t*>(term), static_cast<const uint8_t*>(trunc),
        static_cast<const float*>(actor_pri), L, S, hw, pos, filled, h, n, eps, omega);
    return (int)cudaGetLastError();
}
