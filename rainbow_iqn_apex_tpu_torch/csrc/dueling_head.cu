// K4: dueling combine, tau-mean and greedy argmax for one dispatch.
//
//   quantiles[b, t, a] = (v[b, t] + adv[b, t, a]) - mean_a adv[b, t, :]   (dueling)
//                      = adv[b, t, a]                                       (v == null)
//   q[b, a]            = mean_t quantiles[b, t, a]
//   action[b]          = argmax_a q[b, a], the first index on ties
//
// Replaces the dueling combine of rainbow_iqn_apex_tpu/models/iqn.py
// (:94-101) and q_values / greedy_action (:105-111), XLA-fused on the TPU.
// Everything is fp32, as in the JAX model.  The argmax keeps the first
// maximal index, as jnp.argmax does, and treats NaN as maximal, as jnp.argmax
// and torch.argmax do.
//
// Bound on the H100: ~0.3 MB moved at bucket 64 (T = 32, A = 18), well under a
// microsecond, so the kernel is launch-bound.  Design: one block per batch
// row.  One thread per tau row forms that row's dueling quantiles (the row's
// T x A tile stays in shared memory), one thread per action sums over tau in
// order, and one thread scans the A means for the argmax: three short phases,
// no atomics, the same result on every run.
#include "common.cuh"

namespace {

__global__ void dueling_head_kernel(const float* __restrict__ value,  // [B*T] or null
                                    const float* __restrict__ adv,    // [B*T, A]
                                    float* __restrict__ quantiles,    // [B*T, A]
                                    float* __restrict__ q,            // [B, A]
                                    int* __restrict__ action,         // [B]
                                    int T, int A) {
    extern __shared__ float smem[];  // [T*A] quantiles of this row, then [A] means
    float* qs = smem;
    float* qm = smem + T * A;
    const int b = blockIdx.x;
    const size_t row0 = (size_t)b * T;

    for (int t = threadIdx.x; t < T; t += blockDim.x) {
        const float* ar = adv + (row0 + t) * A;
        float* out = quantiles + (row0 + t) * A;
        if (value != nullptr) {
            float s = 0.f;
            for (int a = 0; a < A; ++a) s += ar[a];
            const float mean = s / (float)A;
            const float v = value[row0 + t];
            for (int a = 0; a < A; ++a) {
                const float z = (v + ar[a]) - mean;
                qs[t * A + a] = z;
                out[a] = z;
            }
        } else {
            for (int a = 0; a < A; ++a) {
                qs[t * A + a] = ar[a];
                out[a] = ar[a];
            }
        }
    }
    __syncthreads();
    for (int a = threadIdx.x; a < A; a += blockDim.x) {
        float s = 0.f;
        for (int t = 0; t < T; ++t) s += qs[t * A + a];
        const float mean = s / (float)T;
        qm[a] = mean;
        q[(size_t)b * A + a] = mean;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
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
                               void* action, int B, int T, int A, void* stream) {
    int threads = T > A ? T : A;
    threads = ((threads + 31) / 32) * 32;
    if (threads > 256) threads = 256;
    const size_t smem = (size_t)(T * A + A) * sizeof(float);
    dueling_head_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(value), static_cast<const float*>(adv),
        static_cast<float*>(quantiles), static_cast<float*>(q), static_cast<int*>(action), T, A);
    return (int)cudaGetLastError();
}
