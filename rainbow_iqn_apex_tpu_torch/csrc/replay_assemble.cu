// K8: n-step assembly, frame-stack gathers and IS weights at given slot ids.
//
// For each draw m (slot idx[m] = lane * S + off; n = n_step, h = history):
//   reward[m]   = sum_k gamma^k r[off + k] * alive_k, alive_k = prod_{j<k} (1 - term[off + j])
//   discount[m] = 0 if a terminal lies in [off, off + n) else gamma^n
//   action[m]   = actions[lane, off]
//   obs[m]      = [H, W, h] stack of frames off - h + 1 .. off, next_obs the same at (off + n) % S;
//                 frame j of a stack is zeroed if a cut lies at a window position in [j, h - 1)
//                 (at or after it, the newest frame excluded), or, while filled < S, if
//                 it is older than the written history (window offset < 0)
//   prob[m]     = max(p[idx] / max(total, 1e-12), 1e-12)
//   weight[m]   = (filled * L * prob)^-beta / its max over m's group of B draws (1 when off)
//
// Replaces DeviceReplay.assemble and _gather_stacks
// (rainbow_iqn_apex_tpu/replay/device.py:182-205, :222-273) and
// sample_grouped's per-group weights (:314-317), XLA-fused on the TPU.
// An id outside [0, L * S) is clamped into it (XLA clamps an out-of-bounds
// gather), so the kernel never reads outside the ring.  `total` is K5's
// on-device sum of p.  The return sums its n terms left to
// right, as XLA reduces a short row, each product and sum rounded on its own
// (no FMA contraction), as the twin's separate torch ops round them.
//
// Bound on the H100: the gathered frames in and the stacks out, ~3.4 MB at
// B = 32, 84 x 84, h = 4, n = 3 (~1 us).  Design: one block per (draw, obs or
// next_obs); the block's first thread works out the stack's frame offsets and
// validity mask into shared memory, then each thread gathers 4 pixels of the
// h frames as 4-byte row loads (coalesced along the frame rows) and, at
// h = 4, writes the transposed [4 pixels, 4 frames] as one 16-byte store.
// The obs block of each draw also writes the scalars and recomputes its
// group's weight maximum from the group's B priorities (B powf), so no block
// waits on another.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_HISTORY = 32;

__device__ __forceinline__ int clamp_slot(int slot, int n) { return min(max(slot, 0), n - 1); }

__device__ __forceinline__ float prob_of(const float* p, int slot, float total) {
    return fmaxf(p[slot] / fmaxf(total, 1e-12f), 1e-12f);
}

__global__ void __launch_bounds__(THREADS) assemble_kernel(
    const uint8_t* __restrict__ frames, const int* __restrict__ actions,
    const float* __restrict__ rewards, const uint8_t* __restrict__ terms,
    const uint8_t* __restrict__ cuts, const float* __restrict__ p,
    const float* __restrict__ total_p, const int* __restrict__ idx,
    const float* __restrict__ gammas, uint8_t* __restrict__ obs, uint8_t* __restrict__ next_obs,
    int* __restrict__ action_out, float* __restrict__ reward_out,
    float* __restrict__ discount_out, float* __restrict__ weight_out,
    float* __restrict__ prob_out, int S, int hw, int h, int n, int filled, int lanes, int B,
    float beta, int with_weight) {
    __shared__ long frame_at[MAX_HISTORY];  // element offset of each stack frame, -1 if zeroed
    const int m = blockIdx.x;
    const bool next = blockIdx.y == 1;
    const int slot = clamp_slot(idx[m], lanes * S);
    const int lane = slot / S;
    const int off0 = slot % S;
    const int off = next ? (off0 + n) % S : off0;
    const size_t base = (size_t)lane * S;
    if (threadIdx.x == 0) {
        bool dead = false;  // any cut at or after window position j (j < h - 1)
        for (int j = h - 1; j >= 0; --j) {
            const int col = ((off + j - (h - 1)) % S + S) % S;
            if (j < h - 1) dead = dead || cuts[base + col] != 0;
            bool valid = !dead;
            if (filled < S && off + j - (h - 1) < 0) valid = false;
            frame_at[j] = valid ? (long)((base + col) * (size_t)hw) : -1;
        }
    }
    __syncthreads();
    uint8_t* out = (next ? next_obs : obs) + (size_t)m * hw * h;
    if (h == 4 && (hw & 3) == 0) {
        for (int q = threadIdx.x; q < hw / 4; q += THREADS) {
            uint32_t f[4];
            for (int j = 0; j < 4; ++j)
                f[j] = frame_at[j] < 0 ? 0u
                                       : *reinterpret_cast<const uint32_t*>(frames + frame_at[j] + 4 * q);
            // pixel x of the 4 gets bytes (f0.x, f1.x, f2.x, f3.x)
            uint4 o;
            uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
            for (int x = 0; x < 4; ++x) {
                const int s = 8 * x;
                ow[x] = ((f[0] >> s) & 0xffu) | (((f[1] >> s) & 0xffu) << 8) |
                        (((f[2] >> s) & 0xffu) << 16) | (((f[3] >> s) & 0xffu) << 24);
            }
            *reinterpret_cast<uint4*>(out + 16 * (size_t)q) = o;
        }
    } else {
        for (int px = threadIdx.x; px < hw; px += THREADS)
            for (int j = 0; j < h; ++j)
                out[(size_t)px * h + j] = frame_at[j] < 0 ? 0 : frames[frame_at[j] + px];
    }
    if (next || threadIdx.x != 0) return;

    float ret = 0.f, alive = 1.f;
    bool done = false;
    for (int k = 0; k < n; ++k) {
        const size_t c = base + (off0 + k) % S;
        // rounded products and sums: no FMA contraction, the twin's arithmetic
        ret = __fadd_rn(ret, __fmul_rn(__fmul_rn(rewards[c], alive), gammas[k]));
        const bool d = terms[c] != 0;
        done = done || d;
        alive = __fmul_rn(alive, 1.f - (d ? 1.f : 0.f));
    }
    const float total = *total_p;
    action_out[m] = actions[base + off0];
    reward_out[m] = ret;
    discount_out[m] = done ? 0.f : gammas[n];
    const float prob = prob_of(p, slot, total);
    prob_out[m] = prob;
    float weight = 1.f;
    if (with_weight) {
        const float n_stored = (float)((long)filled * lanes);
        const int g0 = (m / B) * B;
        float w_max = -INFINITY;
        for (int j = 0; j < B; ++j)
            w_max = fmaxf(w_max, powf(n_stored * prob_of(p, clamp_slot(idx[g0 + j], lanes * S),
                                                          total), -beta));
        weight = powf(n_stored * prob, -beta) / w_max;
    }
    weight_out[m] = weight;
}

}  // namespace

// Ring tensors as K7 takes them, total [] f32 (K5), idx [M] int32, gammas
// [n + 1] f32; out obs and next_obs [M, H, W, h] uint8, action [M] int32,
// reward, discount, weight and prob [M] f32.  Weights are normalised over
// groups of B consecutive draws (M a multiple of B).
PORT_API int port_replay_assemble(const void* frames, const void* actions, const void* rewards,
                                  const void* terms, const void* cuts, const void* p,
                                  const void* total, const void* idx, const void* gammas,
                                  void* obs, void* next_obs, void* action, void* reward,
                                  void* discount, void* weight, void* prob, int M, int S, int hw,
                                  int h, int n, int filled, int lanes, int B, float beta,
                                  int with_weight, void* stream) {
    if (h < 1 || h > MAX_HISTORY || B < 1 || M % B != 0) return (int)cudaErrorInvalidValue;
    if (M == 0) return 0;
    dim3 grid(M, 2);
    assemble_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(frames), static_cast<const int*>(actions),
        static_cast<const float*>(rewards), static_cast<const uint8_t*>(terms),
        static_cast<const uint8_t*>(cuts), static_cast<const float*>(p),
        static_cast<const float*>(total), static_cast<const int*>(idx),
        static_cast<const float*>(gammas), static_cast<uint8_t*>(obs),
        static_cast<uint8_t*>(next_obs), static_cast<int*>(action), static_cast<float*>(reward),
        static_cast<float*>(discount), static_cast<float*>(weight), static_cast<float*>(prob), S,
        hw, h, n, filled, lanes, B, beta, with_weight);
    return (int)cudaGetLastError();
}
