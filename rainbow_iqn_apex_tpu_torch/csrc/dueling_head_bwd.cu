// K4-bwd: the backward of K4's gather mode, z[b, t] = quantiles[b, t, take[b]].
//
//   dvalue[b*T + t]    = dz[b, t]                                   (dueling)
//   dadv[b*T + t, a]   = dz[b, t] * (1{a == take[b]} - 1/A)        (dueling)
//                      = dz[b, t] * 1{a == take[b]}                 (v == null)
//
// Replaces the backward that jax.grad derives for the dueling combine of
// rainbow_iqn_apex_tpu/models/iqn.py (:97) and the take_along_axis of
// ops/learn.py (:152): the gather's transpose scatters dz into one action,
// the mean's transpose spreads minus its 1/A share over all actions.  fp32,
// as in the JAX model; dz / A is formed as (sum_a dq_a) / A is there.
//
// Bound on the H100: at B = 32, T = 64, A = 18 it reads 8 KB and writes
// ~155 KB: well under a microsecond, so the kernel is launch-bound.  Design:
// one block per sample, one thread per (tau, action) element, no reduction.
#include "common.cuh"

namespace {

__global__ void dueling_head_bwd_kernel(const float* __restrict__ dz,  // [B*T]
                                        const int* __restrict__ take,  // [B]
                                        float* __restrict__ dvalue,    // [B*T] or null
                                        float* __restrict__ dadv,      // [B*T, A]
                                        int T, int A) {
    const int b = blockIdx.x;
    const size_t row0 = (size_t)b * T;
    const int a_b = take[b];
    const bool dueling = dvalue != nullptr;
    for (int i = threadIdx.x; i < T * A; i += blockDim.x) {
        const int t = i / A;
        const int a = i % A;
        const float g = dz[row0 + t];
        const float hit = a == a_b ? g : 0.f;
        dadv[(row0 + t) * A + a] = dueling ? hit - g / (float)A : hit;
        if (dueling && a == 0) dvalue[row0 + t] = g;
    }
}

}  // namespace

PORT_API int port_dueling_head_bwd(const void* dz, const void* take, void* dvalue, void* dadv,
                                   int B, int T, int A, void* stream) {
    int threads = ((T * A + 31) / 32) * 32;
    if (threads > 512) threads = 512;
    dueling_head_bwd_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(dz), static_cast<const int*>(take),
        static_cast<float*>(dvalue), static_cast<float*>(dadv), T, A);
    return (int)cudaGetLastError();
}
