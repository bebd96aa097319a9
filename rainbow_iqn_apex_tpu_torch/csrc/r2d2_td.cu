// K11: the R2D2 TD and priority epilogue, loss and gradient in one launch.
//
// Replaces the loss_fn of rainbow_iqn_apex_tpu/ops/r2d2.py:build_r2d2_learn_step
// (:196-260) with value_rescale / value_unrescale (:33-43), which XLA fuses
// on the TPU.  Per sequence b over its train slice of T steps and A actions:
//
//   a*[t]     = argmax_a q_sel[b, t, a]             (first index on ties, NaN maximal)
//   q_boot[t] = h^-1(q_tgt[b, t, a*[t]])
//   for t < T - n:
//     R       = sum_k gamma^k r[t+k] * prod_{m<k} (1 - d[t+m])
//     done_w  = min(sum_k d[t+k], 1)
//     y       = h(R + gamma^n (1 - done_w) q_boot[t+n])
//     mask    = v[t] * min(done_w + v[t+n], 1)
//     td      = (y - q_taken[b, t]) * mask
//   per_seq   = sum_t huber(td) / max(sum_t mask, 1)
//   priority  = eta max_t |td| + (1 - eta) sum_t |td| / max(sum_t mask, 1)
//               (1 - eta, like gamma^n, rounded from double as JAX does)
//   loss      = mean_b weight[b] per_seq[b]
//   q_mean    = sum_{b,t} q_taken v / max(sum v, 1)      (over the whole slice)
//   dq_taken  = -(weight[b] / B) huber'(td) mask / max(sum_t mask, 1)
//
// h(x) = sign(x)(sqrt(|x| + 1) - 1) + eps x and its closed-form inverse.
//
// Bound on the H100: ~0.4 MB at B 32, T 80, A 18, a fraction of a
// microsecond of memory time, so the launch is the cost.  Design: one block
// per sequence; the argmax and the rescale run one thread per step, the
// per-sequence sums one thread in step order (T is small), and the last
// block to finish (a ticket counter) sums the batch in sequence order, so
// the result does not depend on which block ran first.
#include "common.cuh"

namespace {

__device__ __forceinline__ float sign_f(float x) {
    return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// The constants 4 eps and 2 eps arrive rounded from double, as JAX folds the
// source's Python-float products before it casts them to fp32.
struct Rescale {
    float eps, eps4, eps2;
    __device__ __forceinline__ float h(float x) const {
        return sign_f(x) * (sqrtf(fabsf(x) + 1.f) - 1.f) + eps * x;
    }
    __device__ __forceinline__ float h_inv(float x) const {
        const float inner = sqrtf(1.f + eps4 * (fabsf(x) + 1.f + eps)) - 1.f;
        const float r = inner / eps2;
        return sign_f(x) * (r * r - 1.f);
    }
};

__global__ void r2d2_td_kernel(const float* __restrict__ q_taken,  // [B, T]
                               const float* __restrict__ q_sel,    // [B, T, A]
                               const float* __restrict__ q_tgt,    // [B, T, A]
                               const float* __restrict__ reward,   // [B, T]
                               const unsigned char* __restrict__ done,   // [B, T]
                               const unsigned char* __restrict__ valid,  // [B, T]
                               const float* __restrict__ weight,   // [B]
                               float* __restrict__ loss,           // [1]
                               float* __restrict__ priorities,     // [B]
                               float* __restrict__ q_mean,         // [1]
                               float* __restrict__ dq,             // [B, T]
                               float* __restrict__ partial,        // [3B] scratch
                               unsigned int* __restrict__ ticket,  // [1] zeroed
                               int T, int A, int n, float gamma, float gamma_n, float eta,
                               float eta_c, Rescale hr) {
    extern __shared__ float smem[];
    float* qboot = smem;        // [T]
    float* td = qboot + T;      // [T] masked td
    float* mask = td + T;       // [T]
    __shared__ float s_cnt;
    __shared__ bool s_last;
    const int b = blockIdx.x, B = gridDim.x;
    const size_t row = (size_t)b * T;
    const int Tn = T - n;

    for (int t = threadIdx.x; t < T; t += blockDim.x) {
        const float* qs = q_sel + (row + t) * A;
        int best = 0;
        float best_v = qs[0];
        for (int a = 1; a < A; ++a) {
            const float v = qs[a];
            if (!isnan(best_v) && (isnan(v) || v > best_v)) {
                best = a;
                best_v = v;
            }
        }
        qboot[t] = hr.h_inv(q_tgt[(row + t) * A + best]);
    }
    __syncthreads();
    for (int t = threadIdx.x; t < Tn; t += blockDim.x) {
        float rn = 0.f, alive = 1.f, gk = 1.f, dsum = 0.f;
        for (int k = 0; k < n; ++k) {
            const float d = (float)done[row + t + k];
            rn += reward[row + t + k] * alive * gk;
            alive *= 1.f - d;
            gk *= gamma;
            dsum += d;
        }
        const float done_w = fminf(fmaxf(dsum, 0.f), 1.f);
        const float y = hr.h(rn + gamma_n * (1.f - done_w) * qboot[t + n]);
        const float ok = fminf(fmaxf(done_w + (float)valid[row + t + n], 0.f), 1.f);
        const float m = (float)valid[row + t] * ok;
        td[t] = (y - q_taken[row + t]) * m;
        mask[t] = m;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        float cnt = 0.f, hub = 0.f, mx = 0.f, sabs = 0.f, qs = 0.f, vs = 0.f;
        for (int t = 0; t < Tn; ++t) {
            const float u = td[t], au = fabsf(u);
            cnt += mask[t];
            hub += au <= 1.f ? 0.5f * (u * u) : au - 0.5f;
            mx = fmaxf(mx, au);
            sabs += au;
        }
        for (int t = 0; t < T; ++t) {
            const float v = (float)valid[row + t];
            qs += q_taken[row + t] * v;
            vs += v;
        }
        const float denom = fmaxf(cnt, 1.f);
        priorities[b] = eta * mx + eta_c * (sabs / denom);
        partial[b] = weight[b] * (hub / denom);
        partial[B + b] = qs;
        partial[2 * B + b] = vs;
        s_cnt = denom;
    }
    __syncthreads();
    const float scale = -(weight[b] / (float)B) / s_cnt;
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
        float g = 0.f;
        if (t < Tn) g = scale * fminf(fmaxf(td[t], -1.f), 1.f) * mask[t];
        dq[row + t] = g;
    }
    // the last block sums the batch in sequence order
    if (threadIdx.x == 0) {
        __threadfence();
        s_last = atomicAdd(ticket, 1u) == (unsigned int)(B - 1);
    }
    __syncthreads();
    if (s_last && threadIdx.x == 0) {
        __threadfence();
        float l = 0.f, qs = 0.f, vs = 0.f;
        for (int i = 0; i < B; ++i) {
            l += __ldcg(partial + i);
            qs += __ldcg(partial + B + i);
            vs += __ldcg(partial + 2 * B + i);
        }
        loss[0] = l / (float)B;
        q_mean[0] = qs / fmaxf(vs, 1.f);
        *ticket = 0u;
    }
}

}  // namespace

PORT_API int port_r2d2_td(const void* q_taken, const void* q_sel, const void* q_tgt,
                          const void* reward, const void* done, const void* valid,
                          const void* weight, void* loss, void* priorities, void* q_mean, void* dq,
                          void* partial, void* ticket, int B, int T, int A, int n, float gamma,
                          float gamma_n, float eta, float eta_c, float eps, float eps4, float eps2,
                          void* stream) {
    if (B < 1 || T <= n || n < 1 || A < 1) return (int)cudaErrorInvalidValue;
    const int threads = T >= 128 ? 128 : ((T + 31) / 32) * 32;
    const size_t smem = (size_t)3 * T * sizeof(float);
    r2d2_td_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q_taken), static_cast<const float*>(q_sel),
        static_cast<const float*>(q_tgt), static_cast<const float*>(reward),
        static_cast<const unsigned char*>(done), static_cast<const unsigned char*>(valid),
        static_cast<const float*>(weight), static_cast<float*>(loss),
        static_cast<float*>(priorities), static_cast<float*>(q_mean), static_cast<float*>(dq),
        static_cast<float*>(partial), static_cast<unsigned int*>(ticket), T, A, n, gamma, gamma_n,
        eta, eta_c, Rescale{eps, eps4, eps2});
    return (int)cudaGetLastError();
}
