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
// [pos - n, pos) holds none of this tick's writes, and the maximum takes the
// actor priorities before the truncation rule, as there.  pos and filled are
// host counters passed by value; the caller advances them.
//
// Bound on the H100: the L [H, W] uint8 frames in and out, 225 KB at L = 16
// and 84 x 84 (~0.07 us): the kernel is launch-bound, so its design counts
// round trips.  One launch of two kinds of block:
// - block 0, the scalar block, whose first warp alone reads and writes the
//   ring's small fields, p and max_priority (no other block can race
//   max_priority's read before its write): lane l takes ring lane l (then
//   l + 32, ...), issues every load at once (the action, reward, flags,
//   actor priority, p[ready] and the n window bytes of cuts and terminals),
//   finds the first cut from those values, writes the fields and the three
//   priority groups, and the maximum is a NaN-propagating shuffle reduction
//   that lane 0 writes; no block barrier.
// - copy blocks: the L frames as 16-byte vectors, `per_thread` a thread,
//   every load before any store (kernels/replay_append.py:append_plan);
//   frames that are not whole 16-byte rows take a byte path.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 256;
constexpr int PER_THREAD_MAX = 4;  // 16-byte vectors a thread of a copy block
constexpr int N_BATCH = 8;         // window bytes loaded at once
constexpr unsigned FULL = 0xffffffffu;

// NaN-propagating max that returns the NaN it was given (as torch's maximum and amax do)
__device__ __forceinline__ float nan_max(float a, float b) {
    return isnan(a) ? a : isnan(b) ? b : fmaxf(a, b);
}

struct Args {
    uint8_t* ring_frames;
    int* ring_actions;
    float* ring_rewards;
    uint8_t* ring_terms;
    uint8_t* ring_cuts;
    float* p;
    float* max_priority;
    const uint8_t* frame;
    const int* action;
    const float* reward;
    const uint8_t* term;
    const uint8_t* trunc;
    const float* actor_pri;
    int L, S, hw, pos, filled, h, n;
    float eps, omega;
    int per_thread, vec;
};

// Warp 0 of block 0: every scalar read and write of the tick.
__device__ void append_scalars(const Args& a) {
    const int lane = threadIdx.x;
    const float old_max = *a.max_priority;
    const int new_pos = (a.pos + 1) % a.S;
    const int ready_col = ((a.pos - a.n) % a.S + a.S) % a.S;
    float m = -INFINITY;
    for (int l = lane; l < a.L; l += 32) {
        const size_t base = (size_t)l * a.S;
        const int action = a.action[l];
        const float reward = a.reward[l];
        const uint8_t term = a.term[l] != 0;
        const uint8_t trunc = a.trunc[l] != 0;
        const float actor = a.actor_pri != nullptr ? a.actor_pri[l] : 0.f;
        const float old_ready = a.p[base + ready_col];
        // the unbiased time-limit rule: a window whose first cut is a
        // truncation can never bootstrap correctly
        bool found = false, trunc_first = false;
        for (int k0 = 0; k0 < a.n; k0 += N_BATCH) {
            uint8_t cut[N_BATCH], dead[N_BATCH];
#pragma unroll
            for (int u = 0; u < N_BATCH; ++u) {
                if (k0 + u < a.n) {
                    const size_t c = base + (ready_col + k0 + u) % a.S;
                    cut[u] = a.ring_cuts[c];
                    dead[u] = a.ring_terms[c];
                }
            }
#pragma unroll
            for (int u = 0; u < N_BATCH; ++u) {
                if (k0 + u < a.n && !found && cut[u]) {
                    found = true;
                    trunc_first = !dead[u];
                }
            }
        }
        float pri = old_max;
        if (a.actor_pri != nullptr) {
            const float x = actor + a.eps;
            pri = a.omega == 0.5f ? sqrtf(x) : powf(x, a.omega);
            m = nan_max(m, pri);
        }
        if (trunc_first) pri = 0.f;
        if (a.filled < a.n) pri = old_ready;  // no complete future yet
        a.ring_actions[base + a.pos] = action;
        a.ring_rewards[base + a.pos] = reward;
        a.ring_terms[base + a.pos] = term;
        a.ring_cuts[base + a.pos] = term | trunc;
        a.p[base + a.pos] = 0.f;
        for (int k = 0; k < a.h; ++k) a.p[base + (new_pos + k) % a.S] = 0.f;
        a.p[base + ready_col] = pri;
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) m = nan_max(m, __shfl_xor_sync(FULL, m, s));
    if (lane == 0 && a.actor_pri != nullptr && a.filled >= a.n)
        *a.max_priority = nan_max(old_max, m);
}

// Copy block b >= 1: 16-byte vectors (b - 1) * threads * per_thread + t + i * threads.
__device__ void copy_frames(const Args& a) {
    const int per_frame = (a.hw + 15) / 16;
    const int units = a.L * per_frame;
    const int u0 = (blockIdx.x - 1) * blockDim.x * a.per_thread + threadIdx.x;
    if (a.vec) {
        uint4 v[PER_THREAD_MAX];
#pragma unroll
        for (int i = 0; i < PER_THREAD_MAX; ++i) {
            const int u = u0 + i * blockDim.x;
            if (i < a.per_thread && u < units)
                v[i] = __ldg(reinterpret_cast<const uint4*>(a.frame) + u);
        }
#pragma unroll
        for (int i = 0; i < PER_THREAD_MAX; ++i) {
            const int u = u0 + i * blockDim.x;
            if (i < a.per_thread && u < units) {
                const int l = u / per_frame;
                uint8_t* row = a.ring_frames + ((size_t)l * a.S + a.pos) * a.hw;
                reinterpret_cast<uint4*>(row)[u - l * per_frame] = v[i];
            }
        }
        return;
    }
    for (int i = 0; i < a.per_thread; ++i) {
        const int u = u0 + i * blockDim.x;
        if (u >= units) break;
        const int l = u / per_frame, q = u - l * per_frame;
        uint8_t* dst = a.ring_frames + ((size_t)l * a.S + a.pos) * a.hw;
        const uint8_t* src = a.frame + (size_t)l * a.hw;
        for (int x = 16 * q; x < min(16 * q + 16, a.hw); ++x) dst[x] = src[x];
    }
}

__global__ void __launch_bounds__(MAX_THREADS) append_kernel(Args a) {
    if (blockIdx.x == 0) {
        if (threadIdx.x < 32) append_scalars(a);
        return;
    }
    copy_frames(a);
}

}  // namespace

// The ring's tensors in place ([L, S, H, W] uint8 frames; [L, S] int32
// actions, f32 rewards, bool terminals and cuts; [L * S] f32 priorities; []
// f32 max_priority), one tick's [L, H, W] uint8 frames, [L] int32 actions,
// f32 rewards, bool terminals and truncations, and [L] f32 actor |TD| or null.
// copy_blocks, threads and per_thread are append_plan's: they cover the L
// frames' ceil(hw / 16) 16-byte vectors each.
PORT_API int port_replay_append(void* frames, void* actions, void* rewards, void* terms,
                                void* cuts, void* p, void* max_priority, const void* frame,
                                const void* action, const void* reward, const void* term,
                                const void* trunc, const void* actor_pri, int L, int S, int hw,
                                int pos, int filled, int h, int n, float eps, float omega,
                                int copy_blocks, int threads, int per_thread, void* stream) {
    if (L < 1 || S < 1 || threads < 32 || threads > MAX_THREADS || threads % 32 != 0 ||
        per_thread < 1 || per_thread > PER_THREAD_MAX ||
        (long)copy_blocks * threads * per_thread < (long)L * ((hw + 15) / 16))
        return (int)cudaErrorInvalidValue;
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(frames) | reinterpret_cast<uintptr_t>(frame)) & 15) == 0;
    Args a{static_cast<uint8_t*>(frames), static_cast<int*>(actions),
           static_cast<float*>(rewards), static_cast<uint8_t*>(terms),
           static_cast<uint8_t*>(cuts), static_cast<float*>(p),
           static_cast<float*>(max_priority), static_cast<const uint8_t*>(frame),
           static_cast<const int*>(action), static_cast<const float*>(reward),
           static_cast<const uint8_t*>(term), static_cast<const uint8_t*>(trunc),
           static_cast<const float*>(actor_pri), L, S, hw, pos, filled, h, n, eps, omega,
           per_thread, hw % 16 == 0 && aligned};
    append_kernel<<<1 + copy_blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
    return (int)cudaGetLastError();
}
