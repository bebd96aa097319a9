// K8s: the gather and IS weights of R2D2's sequence replay at given slot ids.
//
//   obs[m], action[m], reward[m], done[m], valid[m]  = ring rows at idx[m]      ([L, hw] u8, [L] ...)
//   init_c[m], init_h[m]                             = the rows' stored (c, h)  ([lstm] f32)
//   prob[m]    = max(p_eff[idx[m]] / max(total, 1e-12), 1e-12)
//   weight[m]  = (F * prob[m])^-beta / its max over m's group of B draws  (1 when off)
//
// with p_eff and total from K5s (meta = [total, fallback]): p_eff is p, or 1
// on slots [0, F) when the ring's priorities sum to 0; F = max(filled, 1).
// Replaces DeviceSequenceReplay.assemble (rainbow_iqn_apex_tpu/replay/device_sequence.py:234-262)
// and sample_grouped's per-group weights (:277-281), XLA-fused on the TPU.
// Slot ids are clamped into [0, C - 1]: K5s never gives another.
//
// Bound on the H100: bytes, the read and write of B sequences of frames
// (32 x 120 x 7,056 B = 27.1 MB each way at the learner's shapes, ~16 us).
// Design: grid (frame chunks + 1, M).  Each frame chunk block copies 16 KB of
// its row's frames, 16 bytes a thread.  The last block of each row copies
// the row's small fields; that of a group's first row also computes the
// group's prob and weights, with the group's weight maximum as one block
// reduction (not recomputed per draw).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC_PER_THREAD = 4;
constexpr int CHUNK = THREADS * VEC_PER_THREAD;  // 16-byte vectors per frame block

__device__ __forceinline__ int clamp_slot(int s, int C) { return s < 0 ? 0 : (s >= C ? C - 1 : s); }

__device__ __forceinline__ float prob_of(const float* p, int slot, const float* meta, int F) {
    const float pe = meta[1] != 0.f ? (slot < F ? 1.f : 0.f) : p[slot];
    return fmaxf(pe / fmaxf(meta[0], 1e-12f), 1e-12f);
}

template <typename V>
__global__ void __launch_bounds__(THREADS) seq_assemble_kernel(
    const V* __restrict__ frames, const int* __restrict__ actions,
    const float* __restrict__ rewards, const bool* __restrict__ dones,
    const bool* __restrict__ valids, const float* __restrict__ init_c,
    const float* __restrict__ init_h, const float* __restrict__ p, const float* __restrict__ meta,
    const int* __restrict__ idx, V* __restrict__ obs_out, int* __restrict__ action_out,
    float* __restrict__ reward_out, bool* __restrict__ done_out, bool* __restrict__ valid_out,
    float* __restrict__ c_out, float* __restrict__ h_out, float* __restrict__ weight_out,
    float* __restrict__ prob_out, int C, int L, long row_vecs, int m, int F, int B, float beta,
    int with_weight, int frame_blocks) {
    __shared__ float red[THREADS / 32];
    const int row = blockIdx.y;
    const int slot = clamp_slot(idx[row], C);
    if ((int)blockIdx.x < frame_blocks) {
        const V* src = frames + (long)slot * row_vecs;
        V* dst = obs_out + (long)row * row_vecs;
        const long v0 = (long)blockIdx.x * CHUNK + threadIdx.x;
        V v[VEC_PER_THREAD];
#pragma unroll
        for (int i = 0; i < VEC_PER_THREAD; ++i) {
            const long j = v0 + (long)i * THREADS;
            if (j < row_vecs) v[i] = src[j];
        }
#pragma unroll
        for (int i = 0; i < VEC_PER_THREAD; ++i) {
            const long j = v0 + (long)i * THREADS;
            if (j < row_vecs) dst[j] = v[i];
        }
        return;
    }
    for (int j = threadIdx.x; j < L; j += THREADS) {
        const long s = (long)slot * L + j, d = (long)row * L + j;
        action_out[d] = actions[s];
        reward_out[d] = rewards[s];
        done_out[d] = dones[s];
        valid_out[d] = valids[s];
    }
    for (int j = threadIdx.x; j < m; j += THREADS) {
        c_out[(long)row * m + j] = init_c[(long)slot * m + j];
        h_out[(long)row * m + j] = init_h[(long)slot * m + j];
    }
    if (row % B != 0) return;
    // the group's first row: prob and weights of its B draws
    const int g0 = row;
    float w_max = -INFINITY;
    for (int b = threadIdx.x; b < B; b += THREADS) {
        const float prob = prob_of(p, clamp_slot(idx[g0 + b], C), meta, F);
        prob_out[g0 + b] = prob;
        if (with_weight) w_max = fmaxf(w_max, powf((float)F * prob, -beta));
    }
    if (!with_weight) {
        for (int b = threadIdx.x; b < B; b += THREADS) weight_out[g0 + b] = 1.f;
        return;
    }
    for (int d = 16; d > 0; d >>= 1) w_max = fmaxf(w_max, __shfl_down_sync(0xffffffffu, w_max, d));
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = w_max;
    __syncthreads();
    float all = -INFINITY;
    for (int w = 0; w < THREADS / 32; ++w) all = fmaxf(all, red[w]);
    for (int b = threadIdx.x; b < B; b += THREADS) {
        const float prob = prob_of(p, clamp_slot(idx[g0 + b], C), meta, F);
        weight_out[g0 + b] = powf((float)F * prob, -beta) / all;
    }
}

}  // namespace

// Ring frames [C+1, L, hw] u8, actions [C+1, L] i32, rewards [C+1, L] f32,
// dones / valids [C+1, L] bool, init_c / init_h [C+1, m] f32; p [C] f32;
// meta [2] f32 from K5s; idx [M] i32 (M a multiple of B).  Outputs obs [M, L,
// hw] u8, action [M, L] i32, reward [M, L] f32, done / valid [M, L] bool,
// c / h [M, m] f32, weight / prob [M] f32.  `vec16`: L * hw is a multiple of
// 16 and the frame pointers are 16-byte aligned.
PORT_API int port_seq_assemble(const void* frames, const void* actions, const void* rewards,
                               const void* dones, const void* valids, const void* init_c,
                               const void* init_h, const void* p, const void* meta,
                               const void* idx, void* obs, void* action, void* reward,
                               void* done, void* valid, void* c, void* h, void* weight,
                               void* prob, int M, int C, int L, int hw, int m, int F, int B,
                               float beta, int with_weight, int vec16, void* stream) {
    if (M < 1 || B < 1 || M % B != 0 || C < 1 || F < 1 || M > 65535)
        return (int)cudaErrorInvalidValue;
    const long row_bytes = (long)L * hw;
    const long row_vecs = vec16 ? row_bytes / 16 : row_bytes;
    const int frame_blocks = (int)((row_vecs + CHUNK - 1) / CHUNK);
    const dim3 grid(frame_blocks + 1, M);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PORT_SEQ_ASSEMBLE_ARGS(V)                                                                  \
    static_cast<const V*>(frames), static_cast<const int*>(actions),                              \
        static_cast<const float*>(rewards), static_cast<const bool*>(dones),                      \
        static_cast<const bool*>(valids), static_cast<const float*>(init_c),                      \
        static_cast<const float*>(init_h), static_cast<const float*>(p),                          \
        static_cast<const float*>(meta), static_cast<const int*>(idx), static_cast<V*>(obs),       \
        static_cast<int*>(action), static_cast<float*>(reward), static_cast<bool*>(done),         \
        static_cast<bool*>(valid), static_cast<float*>(c), static_cast<float*>(h),                \
        static_cast<float*>(weight), static_cast<float*>(prob), C, L, row_vecs, m, F, B, beta,    \
        with_weight, frame_blocks
    if (vec16) {
        seq_assemble_kernel<uint4><<<grid, THREADS, 0, s>>>(PORT_SEQ_ASSEMBLE_ARGS(uint4));
    } else {
        seq_assemble_kernel<unsigned char><<<grid, THREADS, 0, s>>>(
            PORT_SEQ_ASSEMBLE_ARGS(unsigned char));
    }
#undef PORT_SEQ_ASSEMBLE_ARGS
    return (int)cudaGetLastError();
}
