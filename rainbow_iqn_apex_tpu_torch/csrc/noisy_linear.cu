// K3: factorised-noise NoisyLinear as one GEMM with a fused epilogue.
//
//   greedy: y = x @ W_mu^T + b_mu
//   noisy:  y = x @ W_mu^T + ((x * f_in) @ W_sigma^T) * f_out + (b_mu + b_sigma * f_out)
//   then ReLU when asked.
//
// Replaces rainbow_iqn_apex_tpu/models/layers.py NoisyLinear.__call__
// (:48-91) and the hidden ReLU of models/iqn.py (:85), XLA-fused on the TPU.
// x, W_mu and W_sigma are bf16 operands with fp32 accumulation, f_in/f_out
// are the squashed noise vectors f(eps) = sign(eps) sqrt|eps| in fp32, the
// bias is fp32, y is fp32: the JAX layer's precision.  x * f_in rounds to bf16
// as the JAX layer's bf16 product does.  Weights are [N, K] (torch's Linear
// layout), so both operand tiles are contiguous along K.
//
// Bound on the H100: the serving hidden layers (M = 2048, K = 3136, N = 512)
// are 6.6 GFLOP each, ~7 us of bf16 tensor-core time, against ~16 MB of
// operands (~5 us): compute-bound.  The *_out layers (N = 1, 18) are tiny and
// launch-bound.  Design: one block of 4 warps owns a 128 x 64 output tile
// (128 blocks for the hidden layers: one wave on 132 SMs); each warp runs a
// 64 x 32 sub-tile of 16x16x16 bf16 tensor-core MMAs (nvcuda::wmma).  Operand
// tiles stream through a 3-stage cp.async ring in shared memory, so the
// loads of tile k+2 overlap the MMAs of tile k.  In noisy mode each x tile is
// loaded once and feeds both products: the x * f_in tile is formed in shared
// memory from the x tile already there, and the [N, K] noise matrix is never
// formed.  The epilogue stages the accumulators through shared memory and
// applies the noise scale, the bias and the ReLU in fp32 before the single
// store.  Not yet wgmma/TMA: that is the next step toward the bound.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int STAGES = 3;
constexpr int LDS = BK + 8;  // bf16 row stride of the operand tiles (80 bytes)
constexpr int LDC = BN + 4;  // fp32 row stride of the epilogue tiles
constexpr int THREADS = 128;
constexpr int A_TILE = BM * LDS;             // elements
constexpr int B_TILE = BN * LDS;             // elements
constexpr int STAGE = A_TILE + 2 * B_TILE;   // x | W_mu | W_sigma
constexpr int PIPE_BYTES = (STAGES * STAGE + A_TILE) * (int)sizeof(__nv_bfloat16);
constexpr int EPI_BYTES = 2 * BM * LDC * (int)sizeof(float);
constexpr int SMEM_BYTES = PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// 16-byte global -> shared copy that bypasses registers; zero-fills when
// !pred (src-size 0 reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int n = pred ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Queue the copy of a ROWS x BK bf16 tile (row stride K in device memory)
// into shared memory.  K % 8 == 0, so each 16-byte chunk is wholly inside or
// outside the matrix.
template <int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int rows, int k0, int K) {
    for (int i = threadIdx.x; i < ROWS * BK / 8; i += THREADS) {
        const int r = i / (BK / 8);
        const int c = (i % (BK / 8)) * 8;
        const bool in = row0 + r < rows && k0 + c < K;
        const __nv_bfloat16* g = in ? src + (size_t)(row0 + r) * K + k0 + c : src;
        cp_async16(dst + r * LDS + c, g, in);
    }
}

__global__ void __launch_bounds__(THREADS) noisy_linear_kernel(
    const __nv_bfloat16* __restrict__ x,        // [M, K]
    const __nv_bfloat16* __restrict__ w_mu,     // [N, K]
    const __nv_bfloat16* __restrict__ w_sigma,  // [N, K] or null (greedy)
    const float* __restrict__ b_mu,             // [N]
    const float* __restrict__ b_sigma,          // [N] (noisy)
    const float* __restrict__ f_in,             // [K] (noisy)
    const float* __restrict__ f_out,            // [N] (noisy)
    float* __restrict__ y,                      // [M, N]
    int M, int N, int K, int relu) {
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* pipe = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* xes = pipe + STAGES * STAGE;  // x * f_in of the current tile
    float* c_mu = reinterpret_cast<float*>(smem);
    float* c_sg = c_mu + BM * LDC;

    const bool noisy = w_sigma != nullptr;
    const int m0 = blockIdx.x * BM;
    const int n0 = blockIdx.y * BN;
    const int warp = threadIdx.x / 32;
    const int wm = (warp / 2) * 64;
    const int wn = (warp % 2) * 32;
    const int ktiles = (K + BK - 1) / BK;

    FragC acc_mu[4][2], acc_sg[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            wmma::fill_fragment(acc_mu[i][j], 0.f);
            wmma::fill_fragment(acc_sg[i][j], 0.f);
        }

    auto issue = [&](int kt) {
        __nv_bfloat16* st = pipe + (kt % STAGES) * STAGE;
        load_tile<BM>(st, x, m0, M, kt * BK, K);
        load_tile<BN>(st + A_TILE, w_mu, n0, N, kt * BK, K);
        if (noisy) load_tile<BN>(st + A_TILE + B_TILE, w_sigma, n0, N, kt * BK, K);
    };

    // one commit group per k-tile, empty ones included, so wait_group
    // STAGES-2 always means "tile kt has landed"
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < ktiles) issue(s);
        cp_async_commit();
    }

    for (int kt = 0; kt < ktiles; ++kt) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();  // tile kt visible to all; stage (kt-1) % STAGES free
        if (kt + STAGES - 1 < ktiles) issue(kt + STAGES - 1);
        cp_async_commit();

        const __nv_bfloat16* xs = pipe + (kt % STAGES) * STAGE;
        const __nv_bfloat16* ws = xs + A_TILE;
        const __nv_bfloat16* wss = ws + B_TILE;
        if (noisy) {  // x * f_in, 8 elements (one 16-byte chunk) per step
            const int k0 = kt * BK;
            for (int i = threadIdx.x; i < BM * BK / 8; i += THREADS) {
                const int r = i / (BK / 8);
                const int c = (i % (BK / 8)) * 8;
                const uint4 raw = *reinterpret_cast<const uint4*>(xs + r * LDS + c);
                const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&raw);
                uint4 prod = make_uint4(0, 0, 0, 0);
                __nv_bfloat16* pv = reinterpret_cast<__nv_bfloat16*>(&prod);
                if (k0 + c < K) {
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        pv[j] = __float2bfloat16(port::to_float(xv[j]) *
                                                 port::bf16_round(f_in[k0 + c + j]));
                }
                *reinterpret_cast<uint4*>(xes + r * LDS + c) = prod;
            }
            __syncthreads();
        }
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            FragA a[4];
            FragB b[2];
#pragma unroll
            for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(a[i], xs + (wm + 16 * i) * LDS + kk, LDS);
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], ws + (wn + 16 * j) * LDS + kk, LDS);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) wmma::mma_sync(acc_mu[i][j], a[i], b[j], acc_mu[i][j]);
            if (noisy) {
#pragma unroll
                for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(a[i], xes + (wm + 16 * i) * LDS + kk, LDS);
#pragma unroll
                for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], wss + (wn + 16 * j) * LDS + kk, LDS);
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 2; ++j) wmma::mma_sync(acc_sg[i][j], a[i], b[j], acc_sg[i][j]);
            }
        }
    }
    cp_async_wait<0>();
    __syncthreads();  // all MMAs done before the epilogue reuses the ring

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int off = (wm + 16 * i) * LDC + wn + 16 * j;
            wmma::store_matrix_sync(c_mu + off, acc_mu[i][j], LDC, wmma::mem_row_major);
            if (noisy) wmma::store_matrix_sync(c_sg + off, acc_sg[i][j], LDC, wmma::mem_row_major);
        }
    __syncthreads();

    for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
        const int r = i / BN;
        const int c = i % BN;
        const int m = m0 + r;
        const int n = n0 + c;
        if (m >= M || n >= N) continue;
        float v = c_mu[r * LDC + c];
        float b = b_mu[n];
        if (noisy) {
            const float fo = f_out[n];
            v = v + c_sg[r * LDC + c] * fo;
            b = b + b_sigma[n] * fo;
        }
        v = v + b;
        if (relu) v = fmaxf(v, 0.f);
        y[(size_t)m * N + n] = v;
    }
}

}  // namespace

PORT_API int port_noisy_linear(const void* x, const void* w_mu, const void* w_sigma,
                               const void* b_mu, const void* b_sigma, const void* f_in,
                               const void* f_out, void* y, int M, int N, int K, int relu,
                               void* stream) {
    static bool smem_opted_in = false;  // once, before any graph capture
    if (!smem_opted_in) {
        const cudaError_t err = cudaFuncSetAttribute(
            noisy_linear_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
        if (err != cudaSuccess) return (int)err;
        smem_opted_in = true;
    }
    const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
    noisy_linear_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w_mu),
        static_cast<const __nv_bfloat16*>(w_sigma), static_cast<const float*>(b_mu),
        static_cast<const float*>(b_sigma), static_cast<const float*>(f_in),
        static_cast<const float*>(f_out), static_cast<float*>(y), M, N, K, relu);
    return (int)cudaGetLastError();
}
