// K9 and K9-bwd: the resettable fp32 LSTM recurrence of R2D2, forward and
// backward through time, each in one cooperative launch.
//
// Replaces rainbow_iqn_apex_tpu/models/r2d2.py:_ResettableLSTMStep (:39-47),
// scanned by R2D2Net.__call__ (:89-96) and driven by ops/r2d2.py:_unroll
// (:136-167) and build_r2d2_act_step (:316-335); its backward is what
// jax.grad makes of that scan.  Per step t, in flax OptimizedLSTMCell's
// order (gates i, f, g, o; columns g*H + j of the [H, 4H] recurrent kernel):
//
//   keep   = 1 - reset[b, t]
//   c, h   = c * keep, h * keep
//   pre    = (h . W_h + b) + xw[b, t]          xw = phi . W_i, a plain product
//   i, f, o = sigmoid(pre_i, pre_f, pre_o);  g = tanh(pre_g)
//   c      = f * c + i * g;   h = o * tanh(c)
//
// The input projection xw does not depend on h, so it stays one large matrix
// product outside (as do dW_h, db, dW_i and dphi in the backward); the
// kernels own the recurrence: h . W_h on every step, the gates and the cell.
//
// Bound on the H100: the recurrence is serial in t.  At the learner's
// [32, 80, 512] each step is 67 MFLOP of fp32 (about 1 us at 67 TFLOP/s) and
// the kernel moves xw, h_seq and the saved gates once (the byte bound is
// ~40 us for the whole unroll), so the chain of T dependent steps, each one
// product, a cell update and a grid-wide barrier, is what bounds it.
//
// Design: one launch per unroll.  Block k owns J hidden units j (all four of
// their gates) and keeps its slice of W_h in shared memory for the whole
// unroll: [H, 4J] forward, [J, 4H] (the rows) backward.  Per step a warp
// takes one batch row: its lanes split the reduction axis, read the shared h
// (or dpre) row once from L2 and accumulate all 4J (or J) sums in registers,
// then reduce them with shuffles in a fixed order.  The cell update of the
// block's (b, j) pairs follows, c stays in shared memory, and a grid-wide
// barrier (an atomic counter; the launch is cooperative, so every block is
// resident) publishes h_t (dpre_t) to the other blocks.  Rows written by
// other blocks are read with __ldcg, past the SM's L1.  No atomics touch
// the numbers, so a run repeats bit for bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// All blocks wait until every block has arrived; `target` is the count the
// counter reaches at this barrier (it only grows within a launch).
__device__ __forceinline__ void grid_barrier(unsigned int* counter, unsigned int target) {
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        atomicAdd(counter, 1u);
        while (*(volatile unsigned int*)counter < target) {
        }
        __threadfence();
    }
    __syncthreads();
}

template <int J>
__global__ void __launch_bounds__(kThreads)
lstm_fwd_kernel(const float* __restrict__ xw,        // [B, T, 4H]
                const float* __restrict__ w_h,       // [H, 4H]
                const float* __restrict__ bias,      // [4H]
                const unsigned char* __restrict__ reset,  // [B, T] bool
                const float* __restrict__ c0,        // [B, H]
                const float* __restrict__ h0,        // [B, H]
                float* __restrict__ h_seq,           // [B, T, H]
                float* __restrict__ c_last,          // [B, H]
                float* __restrict__ h_last,          // [B, H]
                float* __restrict__ gates,           // [B, T, 4H] activations, or null
                float* __restrict__ c_seq,           // [B, T, H], or null
                unsigned int* __restrict__ counter,  // zeroed
                int B, int T, int H) {
    constexpr int G = 4 * J;        // gate columns of this block
    constexpr int S = 4 * J + 1;    // odd row stride: lanes on different k hit different banks
    extern __shared__ float smem[];
    float* ws = smem;               // [H][S]   W_h[k, g*H + j0 + jj] at k*S + g*J + jj
    float* pre_s = ws + H * S;      // [B][G]
    float* c_s = pre_s + B * G;     // [B][J]
    const int j0 = blockIdx.x * J;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const size_t G4 = (size_t)4 * H;

    for (int e = threadIdx.x; e < H * G; e += blockDim.x) {
        const int k = e / G, col = e % G, g = col / J, jj = col % J;
        const int j = j0 + jj;
        ws[k * S + col] = j < H ? w_h[(size_t)k * G4 + (size_t)g * H + j] : 0.f;
    }
    for (int p = threadIdx.x; p < B * J; p += blockDim.x) {
        const int b = p / J, j = j0 + p % J;
        c_s[p] = j < H ? c0[(size_t)b * H + j] : 0.f;
    }
    __syncthreads();

    for (int t = 0; t < T; ++t) {
        // pre[b, :] for this block's 4J columns: one warp per batch row
        for (int b = warp; b < B; b += kWarps) {
            const float keep = 1.f - (float)reset[(size_t)b * T + t];
            const float* hrow = t == 0 ? h0 + (size_t)b * H : h_seq + ((size_t)b * T + t - 1) * H;
            float acc[G];
#pragma unroll
            for (int c = 0; c < G; ++c) acc[c] = 0.f;
            for (int k = lane; k < H; k += 32) {
                const float hv = __ldcg(hrow + k) * keep;
                const float* wr = ws + k * S;
#pragma unroll
                for (int c = 0; c < G; ++c) acc[c] = fmaf(hv, wr[c], acc[c]);
            }
            float mine = 0.f;
#pragma unroll
            for (int c = 0; c < G; ++c) {
                const float s = warp_sum(acc[c]);
                if (lane == c) mine = s;
            }
            if (lane < G) {
                const int g = lane / J, j = j0 + lane % J;
                if (j < H) {
                    const size_t col = (size_t)g * H + j;
                    pre_s[b * G + lane] = (mine + bias[col]) + xw[((size_t)b * T + t) * G4 + col];
                }
            }
        }
        __syncthreads();
        // the cell of this block's (b, j) pairs
        for (int p = threadIdx.x; p < B * J; p += blockDim.x) {
            const int b = p / J, jj = p % J, j = j0 + jj;
            if (j >= H) continue;
            const float keep = 1.f - (float)reset[(size_t)b * T + t];
            const float* pr = pre_s + b * G;
            const float ig = sigmoid_f(pr[0 * J + jj]);
            const float fg = sigmoid_f(pr[1 * J + jj]);
            const float gg = tanhf(pr[2 * J + jj]);
            const float og = sigmoid_f(pr[3 * J + jj]);
            const float c = fg * (c_s[p] * keep) + ig * gg;
            const float h = og * tanhf(c);
            c_s[p] = c;
            const size_t bt = (size_t)b * T + t;
            h_seq[bt * H + j] = h;
            if (gates != nullptr) {
                float* gr = gates + bt * G4 + j;
                gr[0] = ig;
                gr[(size_t)H] = fg;
                gr[(size_t)2 * H] = gg;
                gr[(size_t)3 * H] = og;
            }
            if (c_seq != nullptr) c_seq[bt * H + j] = c;
            if (t == T - 1) {
                c_last[(size_t)b * H + j] = c;
                h_last[(size_t)b * H + j] = h;
            }
        }
        if (t + 1 < T) grid_barrier(counter, (unsigned int)(t + 1) * gridDim.x);
    }
}

template <int J>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_kernel(const float* __restrict__ dh_seq,    // [B, T, H]
                const float* __restrict__ dh_last,   // [B, H] or null
                const float* __restrict__ dc_last,   // [B, H] or null
                const float* __restrict__ w_h,       // [H, 4H]
                const unsigned char* __restrict__ reset,  // [B, T]
                const float* __restrict__ gates,     // [B, T, 4H] activations
                const float* __restrict__ c_seq,     // [B, T, H]
                const float* __restrict__ c0,        // [B, H]
                float* __restrict__ dpre,            // [B, T, 4H] out: d loss / d pre
                unsigned int* __restrict__ counter,  // zeroed
                int B, int T, int H) {
    extern __shared__ float smem[];
    const int H4 = 4 * H;
    float* wr = smem;               // [J][4H]: rows j0 + jj of W_h
    float* dhr_s = wr + J * H4;     // [B][J] dh arriving through the recurrence
    float* dc_s = dhr_s + B * J;    // [B][J] dc carried to the previous step
    const int j0 = blockIdx.x * J;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

    for (int e = threadIdx.x; e < J * H4; e += blockDim.x) {
        const int jj = e / H4, col = e % H4, j = j0 + jj;
        wr[e] = j < H ? w_h[(size_t)j * H4 + col] : 0.f;
    }
    for (int p = threadIdx.x; p < B * J; p += blockDim.x) {
        const int b = p / J, j = j0 + p % J;
        dc_s[p] = (dc_last != nullptr && j < H) ? dc_last[(size_t)b * H + j] : 0.f;
    }
    __syncthreads();

    unsigned int phase = 0;
    for (int t = T - 1; t >= 0; --t) {
        // dh_t from step t+1: (dpre_{t+1} . W_h^T) * keep_{t+1}
        for (int b = warp; b < B; b += kWarps) {
            float acc[J];
#pragma unroll
            for (int jj = 0; jj < J; ++jj) acc[jj] = 0.f;
            float keep = 0.f;
            if (t + 1 < T) {
                keep = 1.f - (float)reset[(size_t)b * T + t + 1];
                const float* drow = dpre + ((size_t)b * T + t + 1) * H4;
                for (int col = lane; col < H4; col += 32) {
                    const float d = __ldcg(drow + col);
#pragma unroll
                    for (int jj = 0; jj < J; ++jj) acc[jj] = fmaf(d, wr[jj * H4 + col], acc[jj]);
                }
            }
            float mine = 0.f;
#pragma unroll
            for (int jj = 0; jj < J; ++jj) {
                const float s = warp_sum(acc[jj]);
                if (lane == jj) mine = s;
            }
            if (lane < J) dhr_s[b * J + lane] = mine * keep;
        }
        __syncthreads();
        for (int p = threadIdx.x; p < B * J; p += blockDim.x) {
            const int b = p / J, jj = p % J, j = j0 + jj;
            if (j >= H) continue;
            const size_t bt = (size_t)b * T + t;
            float dh = dh_seq[bt * H + j] + dhr_s[p];
            if (t == T - 1 && dh_last != nullptr) dh += dh_last[(size_t)b * H + j];
            const float* gr = gates + bt * H4 + j;
            const float ig = gr[0], fg = gr[(size_t)H], gg = gr[(size_t)2 * H],
                        og = gr[(size_t)3 * H];
            const float c = c_seq[bt * H + j];
            const float tc = tanhf(c);
            const float keep = 1.f - (float)reset[bt];
            const float c_prev = (t == 0 ? c0[(size_t)b * H + j] : c_seq[(bt - 1) * H + j]) * keep;
            const float dc = dc_s[p] + dh * og * (1.f - tc * tc);
            float* dr = dpre + bt * H4 + j;
            dr[0] = dc * gg * ig * (1.f - ig);
            dr[(size_t)H] = dc * c_prev * fg * (1.f - fg);
            dr[(size_t)2 * H] = dc * ig * (1.f - gg * gg);
            dr[(size_t)3 * H] = dh * tc * og * (1.f - og);
            dc_s[p] = dc * fg * keep;
        }
        if (t > 0) grid_barrier(counter, ++phase * gridDim.x);
    }
}

// The smallest J (units per block) whose grid fits the card's SMs at one
// block each; 0 if none of 1, 2, 4, 8 does.
int pick_units(int H, int sms) {
    for (int J = 1; J <= 8; J *= 2)
        if ((H + J - 1) / J <= sms) return J;
    return 0;
}

int sm_count() {
    constexpr int kMaxDevices = 64;
    static int cached[kMaxDevices] = {};
    int device = 0;
    cudaGetDevice(&device);
    if (device >= kMaxDevices) device = kMaxDevices - 1;
    if (cached[device] == 0) cudaDeviceGetAttribute(&cached[device], cudaDevAttrMultiProcessorCount, device);
    return cached[device];
}

// Raises the kernel's dynamic shared memory limit as far as this launch
// needs (once per size and device) and checks that every block can be
// resident at once, which a grid-wide barrier requires.
template <typename Kernel>
int cooperative_launch(Kernel kernel, int blocks, size_t smem, void** args, cudaStream_t stream) {
    static int on_device = -1;
    static size_t smem_set = 0;
    static size_t smem_checked = 0;
    static int per_sm = 0;
    int device = 0;
    cudaGetDevice(&device);
    if (device != on_device) {
        on_device = device;
        smem_set = smem_checked = 0;
    }
    if (smem > smem_set) {
        cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return (int)err;
        smem_set = smem;
    }
    if (smem != smem_checked) {
        cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                                        smem);
        if (err != cudaSuccess) return (int)err;
        smem_checked = smem;
    }
    if (per_sm * sm_count() < blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
    cudaError_t err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                                  dim3(kThreads), args, smem, stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // namespace

PORT_API int port_lstm_fwd(const void* xw, const void* w_h, const void* bias, const void* reset,
                           const void* c0, const void* h0, void* h_seq, void* c_last,
                           void* h_last, void* gates, void* c_seq, void* counter, int B, int T,
                           int H, void* stream) {
    const int J = pick_units(H, sm_count());
    if (J == 0 || B < 1 || T < 1) return (int)cudaErrorInvalidValue;
    const int blocks = (H + J - 1) / J;
    const size_t smem = ((size_t)H * (4 * J + 1) + (size_t)B * 4 * J + (size_t)B * J) * sizeof(float);
    void* args[] = {&xw, &w_h, &bias, &reset, &c0, &h0, &h_seq, &c_last, &h_last, &gates,
                    &c_seq, &counter, &B, &T, &H};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (J) {
        case 1: return cooperative_launch(lstm_fwd_kernel<1>, blocks, smem, args, s);
        case 2: return cooperative_launch(lstm_fwd_kernel<2>, blocks, smem, args, s);
        case 4: return cooperative_launch(lstm_fwd_kernel<4>, blocks, smem, args, s);
        default: return cooperative_launch(lstm_fwd_kernel<8>, blocks, smem, args, s);
    }
}

PORT_API int port_lstm_bwd(const void* dh_seq, const void* dh_last, const void* dc_last,
                           const void* w_h, const void* reset, const void* gates,
                           const void* c_seq, const void* c0, void* dpre, void* counter, int B,
                           int T, int H, void* stream) {
    const int J = pick_units(H, sm_count());
    if (J == 0 || B < 1 || T < 1) return (int)cudaErrorInvalidValue;
    const int blocks = (H + J - 1) / J;
    const size_t smem = ((size_t)J * 4 * H + 2 * (size_t)B * J) * sizeof(float);
    void* args[] = {&dh_seq, &dh_last, &dc_last, &w_h, &reset, &gates, &c_seq, &c0, &dpre,
                    &counter, &B, &T, &H};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (J) {
        case 1: return cooperative_launch(lstm_bwd_kernel<1>, blocks, smem, args, s);
        case 2: return cooperative_launch(lstm_bwd_kernel<2>, blocks, smem, args, s);
        case 4: return cooperative_launch(lstm_bwd_kernel<4>, blocks, smem, args, s);
        default: return cooperative_launch(lstm_bwd_kernel<8>, blocks, smem, args, s);
    }
}
