// K4-bwd: the backward of K4's gathers, z[b, t] = quantiles[b, t, take[b]],
// in two modes of one kernel.
//
//   dvalue[b*T + t]    = dz[b, t]                                   (dueling)
//   dadv[b*T + t, a]   = hit - dz[b, t] / A,  hit = dz[b, t] * 1{a == take[b]}   (dueling)
//                      = hit                                        (v == null)
//
// dz mode (R2D2's DuelingGatherFn): dz is given.  Loss mode (the IQN learn
// step's): dz is the cotangent of the learn step's loss, mean_b(w[b] *
// loss[b]), carried through that mean and K1's saved gradient,
//
//   dz[b, t] = ((g / B) * w[b]) * grad[b, t],   w = weight (* scale, formed first)
//
// with g the loss's upstream cotangent, read from the device: the rounding
// order of torch's MeanBackward, MulBackward and the elementwise scale that
// the learn step ran before it, in one launch.
//
// Replaces the backward that jax.grad derives for the dueling combine of
// rainbow_iqn_apex_tpu/models/iqn.py (:97) and the take_along_axis of
// ops/learn.py (:152) (and, in the loss mode, of the weighted mean,
// ops/learn.py:158-162): the gather's transpose scatters dz into one
// action, the mean's transpose spreads minus its 1/A share over all
// actions.  fp32, as in the JAX model; dz / A is formed as (sum_a dq_a) / A
// is there.
//
// Bound on the H100: at B = 32, T = 64, A = 18 it reads ~9 KB and writes
// ~155 KB: well under a microsecond, so the launch is the cost and the
// kernel's own latency is what a design can cut.  Design: one block a
// sample, so its action, weight and the cotangent are loaded at entry, with
// nothing to compute first; each thread forms four elements of the
// sample's [T, A] block of dadv and stores them in one 16-byte store (where
// T * A % 4 == 0, as at every IQN shape; else element by element), the
// block's last threads write its T dvalue floats.
#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;

__global__ void __launch_bounds__(kMaxThreads) dueling_head_bwd_kernel(
    const float* __restrict__ dz,      // [B*T]: dz mode, null in the loss mode
    const float* __restrict__ d_loss,  // []: the loss's cotangent (loss mode)
    const float* __restrict__ weight,  // [B] (loss mode)
    const float* __restrict__ scale,   // [B] or null (loss mode)
    const float* __restrict__ grad,    // [B*T]: K1's d loss[b] / d z (loss mode)
    const int* __restrict__ take,      // [B]
    float* __restrict__ dvalue,        // [B*T] or null
    float* __restrict__ dadv,          // [B*T, A]
    int B, int T, int A) {
    const int b = blockIdx.x;
    const int a_b = take[b];
    const float* src = (dz != nullptr ? dz : grad) + (size_t)b * T;
    float coef = 1.f;  // loss mode: dz = ((g / B) * w[b]) * grad
    if (dz == nullptr) {
        const float w = scale != nullptr ? __fmul_rn(weight[b], scale[b]) : weight[b];
        coef = __fmul_rn(__fdiv_rn(*d_loss, (float)B), w);
    }
    auto row_dz = [&](int t) -> float {
        return dz != nullptr ? src[t] : __fmul_rn(coef, src[t]);
    };
    auto element = [&](int t, int a) -> float {
        const float g = row_dz(t);
        const float hit = a == a_b ? g : 0.f;
        return dvalue != nullptr ? hit - g / (float)A : hit;
    };
    const int n = T * A;
    float* out = dadv + (size_t)b * n;
    const bool vec = n % 4 == 0;
    const int items = vec ? n / 4 : n;
    for (int i = threadIdx.x; i < items + T; i += blockDim.x) {
        if (i >= items) {
            if (dvalue != nullptr) dvalue[(size_t)b * T + (i - items)] = row_dz(i - items);
            continue;
        }
        if (!vec) {
            out[i] = element(i / A, i % A);
            continue;
        }
        int t = 4 * i / A, a = 4 * i - t * A;
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            v[k] = element(t, a);
            if (++a == A) {
                a = 0;
                ++t;
            }
        }
        reinterpret_cast<float4*>(out)[i] = make_float4(v[0], v[1], v[2], v[3]);
    }
}

}  // namespace

// K4-bwd over B samples of T rows of A actions: dz given (dz mode), or null
// and (d_loss, weight, scale, grad) given (loss mode).  dvalue null: no
// dueling.
PORT_API int port_dueling_head_bwd(const void* dz, const void* d_loss, const void* weight,
                                   const void* scale, const void* grad, const void* take,
                                   void* dvalue, void* dadv, int B, int T, int A, void* stream) {
    if (B < 1 || T < 1 || A < 1 || (long long)T * A + T > INT_MAX ||
        (dz == nullptr && (d_loss == nullptr || weight == nullptr || grad == nullptr)))
        return (int)cudaErrorInvalidValue;
    const int n = T * A;
    const int items = (n % 4 == 0 ? n / 4 : n) + T;
    const int threads = std::min(kMaxThreads, (items + 31) / 32 * 32);
    dueling_head_bwd_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(dz), static_cast<const float*>(d_loss),
        static_cast<const float*>(weight), static_cast<const float*>(scale),
        static_cast<const float*>(grad), static_cast<const int*>(take),
        static_cast<float*>(dvalue), static_cast<float*>(dadv), B, T, A);
    return (int)cudaGetLastError();
}
