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
// (masked) q, as jax.nn.log_softmax forms it.  One thread sums in a fixed
// order (a = 0 .. A-1) in fp32, so two calls on the same inputs agree bit for
// bit: a reuse pass at zero parameter drift gives a ratio of exactly 1.
// Both logp calls of the reuse step are detached, so K4l has no backward.
//
// Replaces the dueling combine of rainbow_iqn_apex_tpu/models/iqn.py
// (:94-101) and q_values / greedy_action (:105-111), XLA-fused on the TPU.
// Everything is fp32, as in the JAX model.  The argmax keeps the first
// maximal index, as jnp.argmax does, and treats NaN as maximal, as jnp.argmax
// and torch.argmax do.
//
// Bound on the H100: ~0.3 MB moved at bucket 64 (T = 32, A = 18), well under a
// microsecond, so the kernel is launch-bound in every mode.  Design: one block
// per batch row.  One thread per tau row forms that row's dueling quantiles
// (the row's T x A tile stays in shared memory), one thread per action sums
// over tau in order (and applies the mask), and one thread scans the A means
// for the argmax or the log-softmax: three short phases, no atomics, the same
// result on every run.
#include "common.cuh"

namespace {

constexpr float MASK_FILL = -1e9f;  // multitask/model.py:43

__global__ void dueling_head_kernel(const float* __restrict__ value,  // [B*T] or null
                                    const float* __restrict__ adv,    // [B*T, A]
                                    float* __restrict__ quantiles,    // [B*T, A]
                                    float* __restrict__ q,            // [B, A]
                                    int* __restrict__ action,         // [B] or null
                                    const int* __restrict__ take,     // [B] or null
                                    float* __restrict__ z,            // [B*T] (gather) or null
                                    const int* __restrict__ game,     // [B] or null (K4m, K4l)
                                    const unsigned char* __restrict__ mask,  // [G, A] or null
                                    float* __restrict__ logp,         // [B] (K4l) or null
                                    int T, int A) {
    extern __shared__ float smem[];  // [T*A] quantiles of this row, then [A] means
    float* qs = smem;
    float* qm = smem + T * A;
    const int b = blockIdx.x;
    const size_t row0 = (size_t)b * T;

    for (int t = threadIdx.x; t < T; t += blockDim.x) {
        const float* ar = adv + (row0 + t) * A;
        float* out = quantiles == nullptr ? nullptr : quantiles + (row0 + t) * A;
        if (value != nullptr) {
            float s = 0.f;
            for (int a = 0; a < A; ++a) s += ar[a];
            const float mean = s / (float)A;
            const float v = value[row0 + t];
            for (int a = 0; a < A; ++a) {
                const float zq = (v + ar[a]) - mean;
                qs[t * A + a] = zq;
                if (out != nullptr) out[a] = zq;
            }
        } else {
            for (int a = 0; a < A; ++a) {
                qs[t * A + a] = ar[a];
                if (out != nullptr) out[a] = ar[a];
            }
        }
        if (z != nullptr) {  // an action out of range gathers NaN, as jnp's fill mode does
            const int a = take[b];
            z[row0 + t] = (a >= 0 && a < A) ? qs[t * A + a] : __int_as_float(0x7fc00000);
        }
    }
    __syncthreads();
    const unsigned char* row_mask = mask == nullptr ? nullptr : mask + (size_t)game[b] * A;
    for (int a = threadIdx.x; a < A; a += blockDim.x) {
        float s = 0.f;
        for (int t = 0; t < T; ++t) s += qs[t * A + a];
        float mean = s / (float)T;
        if (row_mask != nullptr && row_mask[a] == 0) mean = MASK_FILL;
        qm[a] = mean;
        q[(size_t)b * A + a] = mean;
    }
    __syncthreads();
    if (threadIdx.x == 0 && logp != nullptr) {
        const int a_t = take[b];
        float mx = qm[0];
        for (int a = 1; a < A; ++a) mx = fmaxf(mx, qm[a]);
        float s = 0.f;
        for (int a = 0; a < A; ++a) s += expf(qm[a] - mx);
        logp[b] = (a_t >= 0 && a_t < A) ? (qm[a_t] - mx) - logf(s) : __int_as_float(0x7fc00000);
    }
    if (threadIdx.x == 0 && action != nullptr) {
        int best = 0;
        float best_v = qm[0];
        for (int a = 1; a < A; ++a) {
            const float v = qm[a];
            if (!isnan(best_v) && (isnan(v) || v > best_v)) {
                best = a;
                best_v = v;
            }
        }
        action[b] = best;
    }
}

}  // namespace

PORT_API int port_dueling_head(const void* value, const void* adv, void* quantiles, void* q,
                               void* action, const void* take, void* z, const void* game,
                               const void* mask, void* logp, int B, int T, int A,
                               void* stream) {
    int threads = T > A ? T : A;
    threads = ((threads + 31) / 32) * 32;
    if (threads > 256) threads = 256;
    const size_t smem = (size_t)(T * A + A) * sizeof(float);
    dueling_head_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(value), static_cast<const float*>(adv),
        static_cast<float*>(quantiles), static_cast<float*>(q), static_cast<int*>(action),
        static_cast<const int*>(take), static_cast<float*>(z), static_cast<const int*>(game),
        static_cast<const unsigned char*>(mask), static_cast<float*>(logp), T, A);
    return (int)cudaGetLastError();
}
