// K4: dueling combine, tau-mean and greedy argmax for one dispatch.
//
//   quantiles[b, t, a] = (v[b, t] + adv[b, t, a]) - mean_a adv[b, t, :]   (dueling)
//                      = adv[b, t, a]                                       (v == null)
//   q[b, a]            = mean_t quantiles[b, t, a]
//   action[b]          = argmax_a q[b, a], the first index on ties
//
// Gather mode (the learner, given actions[b]): z[b, t] = quantiles[b, t, actions[b]]
// and q; neither quantiles nor the argmax is written.  This is the
// take_along_axis of rainbow_iqn_apex_tpu/ops/learn.py (:140, :152) fused
// into the combine; its backward is csrc/dueling_head_bwd.cu.
//
// K4m, the per-game action mask (multi-game runs): with game [B] int32 and
// mask [G, A] uint8, q[b, a] = MASK_FILL (-1e9) wherever mask[game[b], a] is
// 0, before the argmax; q is returned masked, the quantiles are not.  This is
// masked_q_values / masked_greedy_action of rainbow_iqn_apex_tpu/multitask/
// model.py (:134-149).  Null game and mask pointers are the single-game K4,
// bit for bit.
//
// K4l, the log-softmax at the taken action (replay reuse's ratio, from
// make_policy_logp, rainbow_iqn_apex_tpu/ops/learn.py:172-195, and its masked
// form, multitask/ops.py:180-193): given take[b], logp[b] = (q[b, take[b]] -
// max_a q[b, a]) - log(sum_a exp(q[b, a] - max_a q[b, a])) over the
// (masked) q, as jax.nn.log_softmax forms it.  The sum runs in a fixed order
// (each lane's actions in turn, then a butterfly over the warp's lanes), so
// two calls on the same inputs agree bit for bit: a reuse pass at zero
// parameter drift gives a ratio of exactly 1.  Both logp calls of the reuse
// step are detached, so K4l has no backward.
//
// The heads mode (port_dueling_learn): the learner's three heads in one
// launch, the whole of rainbow_iqn_apex_tpu/ops/learn.py:125-152 after the
// forwards: a* = argmax of the select head's tau-mean at K taus (masked as
// K4m when a mask is given), z_next = the target head's quantiles at a* over
// N' taus, td_target = reward + discount * z_next (the product and the sum
// rounded apart, as torch's two ops are: no FMA), z_online = the online
// head's quantiles at the taken action over N taus, and the online tau-mean.
// Only z_online carries a gradient (K4-bwd).
//
// Replaces the dueling combine of rainbow_iqn_apex_tpu/models/iqn.py
// (:94-101) and q_values / greedy_action (:105-111), XLA-fused on the TPU.
// Everything is fp32, as in the JAX model.  The argmax keeps the first
// maximal index, as jnp.argmax does, and treats NaN as maximal, as jnp.argmax
// and torch.argmax do.  An action out of range gathers NaN, as jnp's fill
// mode does.
//
// Bound on the H100: ~0.3 MB moved at bucket 64 (T = 32, A = 18), ~0.1 us of
// bytes, so every mode is bound by the launch and by the chain of dependent
// steps inside one row, not by bytes or operations.  Design: a warp per
// [T, A] tile, several rows a block.  The warp copies its tile into shared
// memory in 16-byte loads (the tile is contiguous), lane t forms tau row t's
// dueling quantiles in order over a, lane a sums action a over t in order,
// and the argmax and the log-sum-exp are butterflies of warp shuffles over a
// fixed lane assignment: no block barrier, no atomics, the same bits on every
// run.  The heads mode gives a row's three tiles to three warps of one block:
// the select warp finds a* while the target warp forms its quantiles and the
// online warp gathers, and one barrier hands a* to the target warp.  That
// takes the learn step's three K4 launches and td_target's two elementwise
// launches down to one.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float MASK_FILL = -1e9f;  // multitask/model.py:43
constexpr int MAX_ROWS = 4;         // rows (warps) a block in the row modes
constexpr int VEC_MAX = 12;         // 16-byte loads a lane holds in flight: tiles to 1,536 floats

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

// the tile's floats rounded up to 16 bytes, so every warp's region stays aligned
__host__ __device__ __forceinline__ int tile_floats(int T, int A) { return (T * A + 3) & ~3; }
__host__ __device__ __forceinline__ int means_floats(int A) { return (A + 3) & ~3; }

// One row's [T, A] tile into shared memory, its dueling quantiles formed in
// place.  Every global load of the row is issued before any is used: the
// value of each of this lane's tau rows (t = lane, lane + 32, ...), then the
// tile in 16-byte loads where the row starts on 16 bytes, each lane's all at
// once (a loop that stored each load before the next was issued waited for
// every one in turn).  Lane t sums its tau row over a in order.  The loops
// over a tile are unrolled, so that their shared-memory loads go out
// together (one fp32 chain each, in order: four interleaved chains over t
// measured slower).
__device__ __forceinline__ void warp_combine(float* __restrict__ s,
                                             const float* __restrict__ adv,
                                             const float* __restrict__ value, int T, int A,
                                             int lane) {
    float v0 = 0.f, v1 = 0.f;
    if (value != nullptr) {
        if (lane < T) v0 = __ldg(value + lane);
        if (lane + 32 < T) v1 = __ldg(value + lane + 32);
    }
    const int n = T * A;
    if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(adv) & 15) == 0 && n / 4 <= 32 * VEC_MAX) {
        // all of this lane's 16-byte loads in flight before the first store
        const float4* src = reinterpret_cast<const float4*>(adv);
        float4* dst = reinterpret_cast<float4*>(s);
        float4 buf[VEC_MAX];
#pragma unroll
        for (int k = 0; k < VEC_MAX; ++k)
            if (lane + 32 * k < n / 4) buf[k] = __ldg(src + lane + 32 * k);
#pragma unroll
        for (int k = 0; k < VEC_MAX; ++k)
            if (lane + 32 * k < n / 4) dst[lane + 32 * k] = buf[k];
    } else {
#pragma unroll 8
        for (int i = lane; i < n; i += 32) s[i] = __ldg(adv + i);
    }
    __syncwarp();
    if (value != nullptr) {
        for (int t = lane, k = 0; t < T; t += 32, ++k) {
            float* r = s + t * A;
            float sum = 0.f;
#pragma unroll 6
            for (int a = 0; a < A; ++a) sum += r[a];
            const float mean = sum / (float)A;
            const float v = k == 0 ? v0 : (k == 1 ? v1 : __ldg(value + t));
#pragma unroll 6
            for (int a = 0; a < A; ++a) r[a] = (v + r[a]) - mean;
        }
        __syncwarp();
    }
}

// this lane's entries of a row's action mask (actions lane, lane + 32; 1 past A)
struct MaskBits {
    unsigned char m0 = 1, m1 = 1;
};

__device__ __forceinline__ MaskBits load_mask(const unsigned char* __restrict__ row_mask, int A,
                                              int lane) {
    MaskBits m;
    if (row_mask != nullptr) {
        if (lane < A) m.m0 = __ldg(row_mask + lane);
        if (lane + 32 < A) m.m1 = __ldg(row_mask + lane + 32);
    }
    return m;
}

// q[a] = mean over t of the tile's column a (masked), into qm[A]; lane a
// sums its column in order over t
__device__ __forceinline__ void warp_tau_mean(const float* __restrict__ s,
                                              float* __restrict__ qm, int T, int A,
                                              const unsigned char* __restrict__ row_mask,
                                              MaskBits m, int lane) {
    for (int a = lane, k = 0; a < A; a += 32, ++k) {
        float sum = 0.f;
#pragma unroll 8
        for (int t = 0; t < T; ++t) sum += s[t * A + a];
        float mean = sum / (float)T;
        if (row_mask != nullptr && (k == 0 ? m.m0 : (k == 1 ? m.m1 : row_mask[a])) == 0)
            mean = MASK_FILL;
        qm[a] = mean;
    }
    __syncwarp();
}

// (value, index) candidates of the argmax: NaN beats any number, a larger
// value beats a smaller, and the lower index wins a tie: a total order, so
// the butterfly's result does not depend on the order of its steps
__device__ __forceinline__ bool beats(float v, int i, float w, int j) {
    const bool vn = isnan(v), wn = isnan(w);
    if (vn != wn) return vn;
    if (!vn && v != w) return v > w;
    return i < j;
}

__device__ __forceinline__ int warp_argmax(const float* __restrict__ qm, int A, int lane) {
    float best = -INFINITY;
    int best_i = 0x7fffffff;  // a lane without an action never wins
    for (int a = lane; a < A; a += 32) {
        const float v = qm[a];
        if (beats(v, a, best, best_i)) {
            best = v;
            best_i = a;
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float v = __shfl_xor_sync(0xffffffffu, best, off);
        const int i = __shfl_xor_sync(0xffffffffu, best_i, off);
        if (beats(v, i, best, best_i)) {
            best = v;
            best_i = i;
        }
    }
    return best_i;
}

// log-softmax of qm at a_t: every lane returns the same bits
__device__ __forceinline__ float warp_logp(const float* __restrict__ qm, int A, int a_t,
                                           int lane) {
    float mx = -INFINITY;
    for (int a = lane; a < A; a += 32) mx = fmaxf(mx, qm[a]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int a = lane; a < A; a += 32) sum += expf(qm[a] - mx);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    return (a_t >= 0 && a_t < A) ? (qm[a_t] - mx) - logf(sum) : qnan();
}

// greedy, gather, K4m and K4l: a warp per batch row, MAX_ROWS rows a block
__global__ void __launch_bounds__(32 * MAX_ROWS) dueling_head_kernel(
    const float* __restrict__ value,  // [B*T] or null
    const float* __restrict__ adv,    // [B*T, A]
    float* __restrict__ quantiles,    // [B*T, A] or null
    float* __restrict__ q,            // [B, A]
    int* __restrict__ action,         // [B] or null
    const int* __restrict__ take,     // [B] or null
    float* __restrict__ z,            // [B*T] (gather) or null
    const int* __restrict__ game,     // [B] or null (K4m, K4l)
    const unsigned char* __restrict__ mask,  // [G, A] or null
    float* __restrict__ logp,         // [B] (K4l) or null
    int B, int T, int A, int rows) {
    extern __shared__ __align__(16) float smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int b = blockIdx.x * rows + warp;
    if (b >= B) return;  // no block barrier below: a warp without a row leaves
    float* s = smem + warp * (tile_floats(T, A) + means_floats(A));
    float* qm = s + tile_floats(T, A);
    const size_t row0 = (size_t)b * T;
    // the row's small inputs first: their loads fly with the tile's
    const int a_take = take == nullptr ? 0 : __ldg(take + b);
    const unsigned char* row_mask = mask == nullptr ? nullptr : mask + (size_t)__ldg(game + b) * A;
    warp_combine(s, adv + row0 * A, value == nullptr ? nullptr : value + row0, T, A, lane);
    const MaskBits m = load_mask(row_mask, A, lane);
    if (quantiles != nullptr) {  // the whole tile back out, 16 bytes a store where aligned
        float* out = quantiles + row0 * A;
        const int n = T * A;
        if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
#pragma unroll 4
            for (int i = lane; i < n / 4; i += 32)
                reinterpret_cast<float4*>(out)[i] = reinterpret_cast<const float4*>(s)[i];
        } else {
            for (int i = lane; i < n; i += 32) out[i] = s[i];
        }
    }
    if (z != nullptr) {
        const bool ok = a_take >= 0 && a_take < A;
        for (int t = lane; t < T; t += 32) z[row0 + t] = ok ? s[t * A + a_take] : qnan();
    }
    warp_tau_mean(s, qm, T, A, row_mask, m, lane);
    for (int a = lane; a < A; a += 32) q[(size_t)b * A + a] = qm[a];
    if (logp != nullptr) {
        const float lp = warp_logp(qm, A, a_take, lane);
        if (lane == 0) logp[b] = lp;
    }
    if (action != nullptr) {
        const int best = warp_argmax(qm, A, lane);
        if (lane == 0) action[b] = best;
    }
}

// the heads mode: one block of three warps per batch row (select, target, online)
__global__ void __launch_bounds__(96) dueling_learn_kernel(
    const float* __restrict__ sel_value, const float* __restrict__ sel_adv,  // [B*K(, A)]
    const float* __restrict__ tgt_value, const float* __restrict__ tgt_adv,  // [B*N'(, A)]
    const float* __restrict__ on_value, const float* __restrict__ on_adv,    // [B*N(, A)]
    const float* __restrict__ reward, const float* __restrict__ discount,  // [B]
    const int* __restrict__ take,                                           // [B]
    const int* __restrict__ game, const unsigned char* __restrict__ mask,  // [B], [G, A] or null
    int* __restrict__ a_star,          // [B]
    float* __restrict__ z_next,        // [B, N']
    float* __restrict__ td_target,     // [B, N']
    float* __restrict__ z_online,      // [B, N]
    float* __restrict__ on_q,          // [B, A]
    int K, int Np, int N, int A) {
    extern __shared__ __align__(16) float smem[];
    __shared__ int a_sel;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int b = blockIdx.x;
    const int mf = means_floats(A);
    float* s_sel = smem;
    float* s_tgt = s_sel + tile_floats(K, A) + mf;
    float* s_on = s_tgt + tile_floats(Np, A);
    float r = 0.f, d = 0.f;  // the target warp's reward and discount
    if (warp == 0) {  // select: a* over the (masked) K-tau mean
        const size_t row0 = (size_t)b * K;
        const unsigned char* row_mask =
            mask == nullptr ? nullptr : mask + (size_t)__ldg(game + b) * A;
        warp_combine(s_sel, sel_adv + row0 * A, sel_value == nullptr ? nullptr : sel_value + row0,
                     K, A, lane);
        float* qm = s_sel + tile_floats(K, A);
        warp_tau_mean(s_sel, qm, K, A, row_mask, load_mask(row_mask, A, lane), lane);
        const int best = warp_argmax(qm, A, lane);
        if (lane == 0) {
            a_sel = best;
            a_star[b] = best;
        }
    } else if (warp == 1) {  // target: its quantiles while the select warp works
        const size_t row0 = (size_t)b * Np;
        r = __ldg(reward + b);
        d = __ldg(discount + b);
        warp_combine(s_tgt, tgt_adv + row0 * A, tgt_value == nullptr ? nullptr : tgt_value + row0,
                     Np, A, lane);
    } else {  // online: the gather at the taken action and the tau-mean
        const size_t row0 = (size_t)b * N;
        const int a = __ldg(take + b);
        warp_combine(s_on, on_adv + row0 * A, on_value == nullptr ? nullptr : on_value + row0, N,
                     A, lane);
        const bool ok = a >= 0 && a < A;
        for (int t = lane; t < N; t += 32) z_online[row0 + t] = ok ? s_on[t * A + a] : qnan();
        float* qm = s_on + tile_floats(N, A);
        warp_tau_mean(s_on, qm, N, A, nullptr, MaskBits{}, lane);
        for (int c = lane; c < A; c += 32) on_q[(size_t)b * A + c] = qm[c];
    }
    __syncthreads();
    if (warp == 1) {
        const int a = a_sel;  // in range: an argmax
        const size_t row0 = (size_t)b * Np;
        for (int t = lane; t < Np; t += 32) {
            const float zt = s_tgt[t * A + a];
            z_next[row0 + t] = zt;
            td_target[row0 + t] = __fadd_rn(r, __fmul_rn(d, zt));
        }
    }
}

}  // namespace

PORT_API int port_dueling_head(const void* value, const void* adv, void* quantiles, void* q,
                               void* action, const void* take, void* z, const void* game,
                               const void* mask, void* logp, int B, int T, int A, int rows,
                               void* stream) {
    if (B <= 0 || T <= 0 || A <= 0 || rows <= 0 || rows > MAX_ROWS)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)rows * (tile_floats(T, A) + means_floats(A)) * sizeof(float);
    dueling_head_kernel<<<(B + rows - 1) / rows, 32 * rows, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(value), static_cast<const float*>(adv),
        static_cast<float*>(quantiles), static_cast<float*>(q), static_cast<int*>(action),
        static_cast<const int*>(take), static_cast<float*>(z), static_cast<const int*>(game),
        static_cast<const unsigned char*>(mask), static_cast<float*>(logp), B, T, A, rows);
    return (int)cudaGetLastError();
}

PORT_API int port_dueling_learn(const void* sel_value, const void* sel_adv, const void* tgt_value,
                                const void* tgt_adv, const void* on_value, const void* on_adv,
                                const void* reward, const void* discount, const void* take,
                                const void* game, const void* mask, void* a_star, void* z_next,
                                void* td_target, void* z_online, void* on_q, int B, int K,
                                int Np, int N, int A, void* stream) {
    if (B <= 0 || K <= 0 || Np <= 0 || N <= 0 || A <= 0) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)(tile_floats(K, A) + tile_floats(Np, A) + tile_floats(N, A) +
                                 2 * means_floats(A)) * sizeof(float);
    dueling_learn_kernel<<<B, 96, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(sel_value), static_cast<const float*>(sel_adv),
        static_cast<const float*>(tgt_value), static_cast<const float*>(tgt_adv),
        static_cast<const float*>(on_value), static_cast<const float*>(on_adv),
        static_cast<const float*>(reward), static_cast<const float*>(discount),
        static_cast<const int*>(take), static_cast<const int*>(game),
        static_cast<const unsigned char*>(mask), static_cast<int*>(a_star),
        static_cast<float*>(z_next), static_cast<float*>(td_target), static_cast<float*>(z_online),
        static_cast<float*>(on_q), K, Np, N, A);
    return (int)cudaGetLastError();
}
