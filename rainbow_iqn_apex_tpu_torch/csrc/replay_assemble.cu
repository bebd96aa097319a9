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
// B = 32, 84 x 84, h = 4, n = 3 (~1 us); below a few us every step of the
// kernel is a latency, so the design counts round trips.  One launch of two
// kinds of block:
// - copy blocks: each of the 2M stacks (obs, next_obs of a draw, side by
//   side) is cut into `chunks` runs of `per_chunk` 16-pixel vectors
//   (kernels/replay_assemble.py:assemble_plan, at least two blocks an SM at
//   B 32).  Every warp works out its stack itself: lane j loads window
//   position j's cut byte and a ballot gives the cut and age masks, with no
//   block barrier.  The h frames' 16-byte loads (read-only path) are issued
//   before that ballot, all of a thread's vectors at once, and at h = 4 each
//   16 pixels x 4 frames are transposed in registers (__byte_perm) into four
//   16-byte stores: idx, then cuts and frames, then stores.  Other h, or
//   frames that are not whole 16-byte rows, take a byte path.
// - scalar blocks, first in the grid: a warp a group of B draws, lane i
//   taking draws i, i + 32, ...: the id, its n rewards, terminals and gammas,
//   p[slot] and the action as independent loads, the return, discount, prob
//   and powf(filled * L * prob, -beta); the group maximum by shuffles, then
//   each lane writes its own draws' weights.
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int MAX_HISTORY = 32;
constexpr int MAX_THREADS = 256;
constexpr int VEC_MAX = 4;  // 16-pixel vectors a thread of the 16-byte path
constexpr int N_BATCH = 8;  // n-step terms loaded at once
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int clamp_slot(int slot, int n) { return min(max(slot, 0), n - 1); }

__device__ __forceinline__ int wrap(int x, int S) { return (x % S + S) % S; }

__device__ __forceinline__ float prob_of(float p, float total) {
    return fmaxf(p / fmaxf(total, 1e-12f), 1e-12f);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int x) {
    return x == 0 ? v.x : x == 1 ? v.y : x == 2 ? v.z : v.w;
}

struct Args {
    const uint8_t* frames;
    const int* actions;
    const float* rewards;
    const uint8_t* terms;
    const uint8_t* cuts;
    const float* p;
    const float* total;
    const int* idx;
    const float* gammas;
    uint8_t* obs;
    uint8_t* next_obs;
    int* action_out;
    float* reward_out;
    float* discount_out;
    float* weight_out;
    float* prob_out;
    int S, hw, h, n, filled, lanes, B, groups;
    float beta;
    int with_weight;
    int chunks, per_chunk, vectors, scalar_blocks, vec;
};

// One warp: the scalars of group g's B draws, lane i taking draws i, i + 32, ...
__device__ void group_scalars(const Args& a, int g) {
    const int lane = threadIdx.x & 31;
    const int LS = a.lanes * a.S;
    const float total = __ldg(a.total);
    const float n_stored = (float)((long)a.filled * a.lanes);
    float w_max = -INFINITY, w_own = 1.f;
    for (int i = lane; i < a.B; i += 32) {
        const int m = g * a.B + i;
        const int slot = clamp_slot(__ldg(a.idx + m), LS);
        const int off0 = slot % a.S;
        const size_t base = (size_t)(slot - off0);
        const float pv = __ldg(a.p + slot);
        const int action = __ldg(a.actions + slot);
        float ret = 0.f, alive = 1.f;
        bool done = false;
        for (int k0 = 0; k0 < a.n; k0 += N_BATCH) {
            float r[N_BATCH], gk[N_BATCH];
            uint8_t d[N_BATCH];
#pragma unroll
            for (int u = 0; u < N_BATCH; ++u) {
                if (k0 + u < a.n) {
                    const size_t c = base + (off0 + k0 + u) % a.S;
                    r[u] = __ldg(a.rewards + c);
                    d[u] = __ldg(a.terms + c);
                    gk[u] = __ldg(a.gammas + k0 + u);
                }
            }
#pragma unroll
            for (int u = 0; u < N_BATCH; ++u) {
                if (k0 + u < a.n) {
                    // rounded products and sums: no FMA contraction, the twin's arithmetic
                    ret = __fadd_rn(ret, __fmul_rn(__fmul_rn(r[u], alive), gk[u]));
                    const bool dead = d[u] != 0;
                    done = done || dead;
                    alive = __fmul_rn(alive, 1.f - (dead ? 1.f : 0.f));
                }
            }
        }
        a.action_out[m] = action;
        a.reward_out[m] = ret;
        a.discount_out[m] = done ? 0.f : __ldg(a.gammas + a.n);
        const float prob = prob_of(pv, total);
        a.prob_out[m] = prob;
        if (a.with_weight) {
            const float w = powf(n_stored * prob, -a.beta);
            w_max = fmaxf(w_max, w);
            if (i == lane) w_own = w;
        } else {
            a.weight_out[m] = 1.f;
        }
    }
    if (!a.with_weight) return;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) w_max = fmaxf(w_max, __shfl_xor_sync(FULL, w_max, s));
    for (int i = lane; i < a.B; i += 32) {
        float w = w_own;
        if (i != lane) {  // groups past 32 draws: the same powf again
            const int slot = clamp_slot(__ldg(a.idx + g * a.B + i), LS);
            w = powf(n_stored * prob_of(__ldg(a.p + slot), total), -a.beta);
        }
        a.weight_out[g * a.B + i] = w / w_max;
    }
}

// One block: chunk `chunk` of stack `stack` (draw stack / 2; obs, or next_obs when odd).
__device__ void copy_chunk(const Args& a, int stack, int chunk) {
    const int LS = a.lanes * a.S;
    const int m = stack >> 1;
    const int slot = clamp_slot(__ldg(a.idx + m), LS);
    const int off0 = slot % a.S;
    const int off = (stack & 1) ? (off0 + a.n) % a.S : off0;
    const size_t base = (size_t)(slot - off0);
    // lane j: window position j (frame j of the stack), its cut byte and its age
    const int j = threadIdx.x & 31;
    const int raw = off + j - (a.h - 1);
    const bool cut = j < a.h - 1 && __ldg(a.cuts + base + wrap(raw, a.S)) != 0;
    const int v0 = chunk * a.per_chunk;
    const int v_end = min(v0 + a.per_chunk, a.vectors);
    uint8_t* out = ((stack & 1) ? a.next_obs : a.obs) + (size_t)m * a.hw * a.h;

    if (a.vec) {  // h == 4, whole 16-byte rows
        const uint4* src[4];
#pragma unroll
        for (int f = 0; f < 4; ++f)
            src[f] = reinterpret_cast<const uint4*>(a.frames +
                                                    (base + wrap(off + f - 3, a.S)) * a.hw);
        uint4 px[VEC_MAX][4];
#pragma unroll
        for (int t = 0; t < VEC_MAX; ++t) {
            const int q = v0 + threadIdx.x + t * blockDim.x;
            if (q < v_end) {
#pragma unroll
                for (int f = 0; f < 4; ++f) px[t][f] = __ldg(src[f] + q);
            }
        }
        // frame f is zeroed by a cut at or after it, or by its age
        const unsigned cuts = __ballot_sync(FULL, cut);
        const unsigned old = __ballot_sync(FULL, j < 4 && a.filled < a.S && raw < 0);
        uint4* out4 = reinterpret_cast<uint4*>(out);
#pragma unroll
        for (int t = 0; t < VEC_MAX; ++t) {
            const int q = v0 + threadIdx.x + t * blockDim.x;
            if (q >= v_end) continue;
#pragma unroll
            for (int f = 0; f < 4; ++f)
                if ((cuts >> f) != 0 || ((old >> f) & 1u)) px[t][f] = make_uint4(0, 0, 0, 0);
#pragma unroll
            for (int x = 0; x < 4; ++x) {
                // pixels 4x .. 4x + 3 of the 16: byte k of frame f's word -> byte f of pixel k
                const uint32_t lo = __byte_perm(word(px[t][0], x), word(px[t][1], x), 0x5140);
                const uint32_t hi = __byte_perm(word(px[t][0], x), word(px[t][1], x), 0x7362);
                const uint32_t lo2 = __byte_perm(word(px[t][2], x), word(px[t][3], x), 0x5140);
                const uint32_t hi2 = __byte_perm(word(px[t][2], x), word(px[t][3], x), 0x7362);
                out4[4 * (size_t)q + x] =
                    make_uint4(__byte_perm(lo, lo2, 0x5410), __byte_perm(lo, lo2, 0x7632),
                               __byte_perm(hi, hi2, 0x5410), __byte_perm(hi, hi2, 0x7632));
            }
        }
        return;
    }
    const unsigned cuts = __ballot_sync(FULL, cut);
    const unsigned old = __ballot_sync(FULL, j < a.h && a.filled < a.S && raw < 0);
    for (int q = v0 + threadIdx.x; q < v_end; q += blockDim.x)
        for (int x = 16 * q; x < min(16 * q + 16, a.hw); ++x)
            for (int f = 0; f < a.h; ++f) {
                const bool zero = (cuts >> f) != 0 || ((old >> f) & 1u);
                out[(size_t)x * a.h + f] =
                    zero ? 0 : a.frames[(base + wrap(off + f - (a.h - 1), a.S)) * a.hw + x];
            }
}

__global__ void __launch_bounds__(MAX_THREADS) assemble_kernel(Args a) {
    if ((int)blockIdx.x < a.scalar_blocks) {
        const int g = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
        if (g < a.groups) group_scalars(a, g);
        return;
    }
    const int k = blockIdx.x - a.scalar_blocks;
    copy_chunk(a, k / a.chunks, k % a.chunks);
}

}  // namespace

// Ring tensors as K7 takes them, total [] f32 (K5), idx [M] int32, gammas
// [n + 1] f32; out obs and next_obs [M, H, W, h] uint8, action [M] int32,
// reward, discount, weight and prob [M] f32.  Weights are normalised over
// groups of B consecutive draws (M a multiple of B).  chunks, per_chunk and
// threads are assemble_plan's: chunks * per_chunk covers the ceil(hw / 16)
// vectors of a stack, per_chunk <= 4 * threads.
PORT_API int port_replay_assemble(const void* frames, const void* actions, const void* rewards,
                                  const void* terms, const void* cuts, const void* p,
                                  const void* total, const void* idx, const void* gammas,
                                  void* obs, void* next_obs, void* action, void* reward,
                                  void* discount, void* weight, void* prob, int M, int S, int hw,
                                  int h, int n, int filled, int lanes, int B, float beta,
                                  int with_weight, int chunks, int per_chunk, int threads,
                                  void* stream) {
    if (h < 1 || h > MAX_HISTORY || B < 1 || M % B != 0 || S < 1 || n < 0)
        return (int)cudaErrorInvalidValue;
    if (M == 0) return 0;
    const int vectors = (hw + 15) / 16;
    if (threads < 32 || threads > MAX_THREADS || threads % 32 != 0 || chunks < 1 ||
        per_chunk < 1 || (long)chunks * per_chunk < vectors || per_chunk > VEC_MAX * threads)
        return (int)cudaErrorInvalidValue;
    const int groups = M / B;
    const int scalar_blocks = (groups + threads / 32 - 1) / (threads / 32);
    const long blocks = scalar_blocks + 2L * M * chunks;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(frames) | reinterpret_cast<uintptr_t>(obs) |
          reinterpret_cast<uintptr_t>(next_obs)) & 15) == 0;
    Args a{static_cast<const uint8_t*>(frames), static_cast<const int*>(actions),
           static_cast<const float*>(rewards), static_cast<const uint8_t*>(terms),
           static_cast<const uint8_t*>(cuts), static_cast<const float*>(p),
           static_cast<const float*>(total), static_cast<const int*>(idx),
           static_cast<const float*>(gammas), static_cast<uint8_t*>(obs),
           static_cast<uint8_t*>(next_obs), static_cast<int*>(action),
           static_cast<float*>(reward), static_cast<float*>(discount),
           static_cast<float*>(weight), static_cast<float*>(prob), S, hw, h, n, filled, lanes, B,
           groups, beta, with_weight, chunks, per_chunk, vectors, scalar_blocks,
           h == 4 && hw % 16 == 0 && aligned};
    assemble_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
    return (int)cudaGetLastError();
}
