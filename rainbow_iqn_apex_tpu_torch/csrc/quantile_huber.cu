// K1: the pairwise quantile-Huber loss of IQN with its gradient, forward only.
//
//   u[b, i, j]  = target[b, j] - online[b, i]
//   rho         = |tau[b, i] - 1{u < 0}| * Huber_k(u) / k
//   loss[b]     = sum_i mean_j rho
//   td_abs[b]   = mean_ij |u|
//   grad[b, i]  = d loss[b] / d online[b, i] = -(1/N') sum_j |tau_i - 1{u<0}| * clip(u, -k, k) / k
//
// Replaces the Pallas kernel that rainbow_iqn_apex_tpu once had for this loss
// (quantile_huber.py, _qh_kernel and its custom VJP; deleted, the live
// reference is ops/losses.py:31 quantile_huber_loss).  As in the Pallas
// kernel the forward also emits d loss / d online, so the autograd backward
// is one elementwise scale by the upstream cotangent.  Huber takes the
// quadratic branch at |u| == k, as jnp.where(|u| <= k, ...) does; its
// derivative is then clip(u, -k, k) everywhere.  Everything is fp32.
//
// Bound on the H100: at B = 32, N = N' = 64 the inputs are ~24 KB and the
// pair tile is 131072 pairs of a dozen flops: far below a microsecond either
// way, so the kernel is launch-bound.  Design: one block per sample; the N'
// targets sit in shared memory, one thread per online quantile walks them,
// so nothing of the [B, N, N'] pair tensor reaches device memory.  The per-row
// partial sums are reduced by one thread in row order: the same result on
// every run.
#include "common.cuh"

namespace {

__global__ void quantile_huber_kernel(const float* __restrict__ online,  // [B, N]
                                      const float* __restrict__ taus,    // [B, N]
                                      const float* __restrict__ target,  // [B, NT]
                                      float* __restrict__ loss,          // [B]
                                      float* __restrict__ td_abs,        // [B]
                                      float* __restrict__ grad,          // [B, N]
                                      int N, int NT, float kappa) {
    extern __shared__ float smem[];  // [NT] targets, [N] row losses, [N] row |u| sums
    float* tgt = smem;
    float* row_loss = smem + NT;
    float* row_abs = row_loss + N;
    const int b = blockIdx.x;
    for (int j = threadIdx.x; j < NT; j += blockDim.x) tgt[j] = target[(size_t)b * NT + j];
    __syncthreads();

    const float inv_k = 1.f / kappa;
    const float inv_nt = 1.f / (float)NT;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
        const float o = online[(size_t)b * N + i];
        const float tau = taus[(size_t)b * N + i];
        float s_rho = 0.f, s_abs = 0.f, s_grad = 0.f;
        for (int j = 0; j < NT; ++j) {
            const float u = tgt[j] - o;
            const float au = fabsf(u);
            const float w = fabsf(tau - (u < 0.f ? 1.f : 0.f));
            const float h = au <= kappa ? 0.5f * u * u : kappa * (au - 0.5f * kappa);
            s_rho += w * h * inv_k;
            s_abs += au;
            s_grad += w * fminf(fmaxf(u, -kappa), kappa) * inv_k;
        }
        row_loss[i] = s_rho * inv_nt;
        row_abs[i] = s_abs;
        grad[(size_t)b * N + i] = -s_grad * inv_nt;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        float l = 0.f, a = 0.f;
        for (int i = 0; i < N; ++i) {
            l += row_loss[i];
            a += row_abs[i];
        }
        loss[b] = l;
        td_abs[b] = a / ((float)N * (float)NT);
    }
}

}  // namespace

PORT_API int port_quantile_huber(const void* online, const void* taus, const void* target,
                                 void* loss, void* td_abs, void* grad, int B, int N, int NT,
                                 float kappa, void* stream) {
    int threads = ((N + 31) / 32) * 32;
    if (threads > 256) threads = 256;
    const size_t smem = (size_t)(NT + 2 * N) * sizeof(float);
    quantile_huber_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(online), static_cast<const float*>(taus),
        static_cast<const float*>(target), static_cast<float*>(loss),
        static_cast<float*>(td_abs), static_cast<float*>(grad), N, NT, kappa);
    return (int)cudaGetLastError();
}
