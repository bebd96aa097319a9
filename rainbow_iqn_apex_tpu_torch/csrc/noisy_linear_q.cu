// K10g: the weight-only quantized NoisyLinear GEMM, int8 and e4m3 weights.
//
//   W = bf16(fp32(q_W) * s_W[n])        per output row n (one s in fp8 mode)
//   b = fp32(q_b) * s_b                 one scale per bias
//   greedy: y = x @ W_mu^T + b_mu
//   noisy:  y = x @ W_mu^T + ((x * f_in) @ W_sigma^T) * f_out + (b_mu + b_sigma * f_out)
//   then ReLU when asked.
//
// Replaces the quantized act path of rainbow_iqn_apex_tpu/utils/quantize.py
// (dequantize_tree_jax :219-236 under wrap_act_quantized :239-247) fused
// into models/layers.py NoisyLinear.__call__ (:71-91), which XLA compiles
// into one executable: the weights the JAX dot sees are bf16(fp32(q) * s),
// so this kernel forms exactly that value as it loads each weight tile, and
// then computes what K3 (noisy_linear.cu) computes.  The activations stay
// bf16 (an fp8 x fp8 product would quantize them too, another function).
//
// Bound on the H100: the same products as K3 (6.6 GFLOP per serving hidden
// layer, ~7 us of bf16 tensor-core time) with a quarter of the weight bytes:
// compute-bound at serving's M = 2048, launch-bound for the *_out layers.
// Design: K3's tiles (a block of 4 warps per 128 x 64 output tile, 16x16x16
// bf16 wmma, a 3-stage cp.async ring) with the weight tiles streamed raw
// (one byte a weight) and converted in shared memory once per k-tile: each
// thread turns 8 bytes into 8 bf16 products with their row's scale.  The
// converted tiles are single-buffered behind the barrier that opens each
// k-tile, as K3's x * f_in tile is.  The bias is dequantized in the
// epilogue.
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int STAGES = 3;
constexpr int LDS = BK + 8;   // bf16 row stride of the operand tiles (80 bytes)
constexpr int LDR = BK + 16;  // byte row stride of the raw weight tiles (48 bytes)
constexpr int LDC = BN + 4;   // fp32 row stride of the epilogue tiles
constexpr int THREADS = 128;
constexpr int A_BYTES = BM * LDS * 2;
constexpr int R_BYTES = BN * LDR;
constexpr int C_BYTES = BN * LDS * 2;
constexpr int STAGE_BYTES = A_BYTES + 2 * R_BYTES;  // x | raw W_mu | raw W_sigma
constexpr int PIPE_BYTES = STAGES * STAGE_BYTES + 2 * C_BYTES + A_BYTES;
constexpr int EPI_BYTES = 2 * BM * LDC * (int)sizeof(float);
constexpr int SMEM_BYTES = PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int n = pred ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// x tile: ROWS x BK bf16 (K % 8 == 0: a 16-byte chunk is wholly in or out)
__device__ __forceinline__ void load_x(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                       int row0, int rows, int k0, int K) {
    for (int i = threadIdx.x; i < BM * BK / 8; i += THREADS) {
        const int r = i / (BK / 8);
        const int c = (i % (BK / 8)) * 8;
        const bool in = row0 + r < rows && k0 + c < K;
        cp_async16(dst + r * LDS + c, in ? src + (size_t)(row0 + r) * K + k0 + c : src, in);
    }
}

// raw weight tile: BN x BK bytes (K % 16 == 0)
__device__ __forceinline__ void load_raw(uint8_t* dst, const uint8_t* src, int row0, int rows,
                                         int k0, int K) {
    for (int i = threadIdx.x; i < BN * BK / 16; i += THREADS) {
        const int r = i / (BK / 16);
        const int c = (i % (BK / 16)) * 16;
        const bool in = row0 + r < rows && k0 + c < K;
        cp_async16(dst + r * LDR + c, in ? src + (size_t)(row0 + r) * K + k0 + c : src, in);
    }
}

template <bool FP8>
__device__ __forceinline__ float decode(uint8_t b) {
    if (FP8) return __half2float(__half(__nv_cvt_fp8_to_halfraw(b, __NV_E4M3)));
    return (float)(int8_t)b;
}

// raw -> bf16(fp32(q) * s[row]), 8 weights (8 bytes in, 16 bytes out) a step
template <bool FP8>
__device__ __forceinline__ void convert(__nv_bfloat16* dst, const uint8_t* raw,
                                        const float* __restrict__ scale, int s_stride,
                                        int n0, int N) {
    for (int i = threadIdx.x; i < BN * BK / 8; i += THREADS) {
        const int r = i / (BK / 8);
        const int c = (i % (BK / 8)) * 8;
        const int n = n0 + r;
        const float s = n < N ? scale[(size_t)n * s_stride] : 0.f;
        const uint2 bytes = *reinterpret_cast<const uint2*>(raw + r * LDR + c);
        const uint8_t* bv = reinterpret_cast<const uint8_t*>(&bytes);
        uint4 out;
        __nv_bfloat16* ov = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
        for (int j = 0; j < 8; ++j) ov[j] = __float2bfloat16_rn(__fmul_rn(decode<FP8>(bv[j]), s));
        *reinterpret_cast<uint4*>(dst + r * LDS + c) = out;
    }
}

template <bool FP8>
__device__ __forceinline__ float bias(const uint8_t* q, const float* s, int n) {
    return __fmul_rn(decode<FP8>(q[n]), s[0]);
}

template <bool FP8>
__global__ void __launch_bounds__(THREADS) noisy_linear_q_kernel(
    const __nv_bfloat16* __restrict__ x,  // [M, K]
    const uint8_t* __restrict__ qw_mu,    // [N, K]
    const float* __restrict__ sw_mu,      // [N] (s_stride 1) or [1] (s_stride 0)
    const uint8_t* __restrict__ qb_mu,    // [N]
    const float* __restrict__ sb_mu,      // [1]
    const uint8_t* __restrict__ qw_sg,    // [N, K] or null (greedy)
    const float* __restrict__ sw_sg,
    const uint8_t* __restrict__ qb_sg,
    const float* __restrict__ sb_sg,
    const float* __restrict__ f_in,   // [K] (noisy)
    const float* __restrict__ f_out,  // [N] (noisy)
    float* __restrict__ y,            // [M, N]
    int M, int N, int K, int relu, int s_stride) {
    extern __shared__ __align__(128) unsigned char smem[];
    unsigned char* pipe = smem;
    __nv_bfloat16* wc_mu = reinterpret_cast<__nv_bfloat16*>(smem + STAGES * STAGE_BYTES);
    __nv_bfloat16* wc_sg = wc_mu + BN * LDS;
    __nv_bfloat16* xes = wc_sg + BN * LDS;  // x * f_in of the current tile
    float* c_mu = reinterpret_cast<float*>(smem);
    float* c_sg = c_mu + BM * LDC;

    const bool noisy = qw_sg != nullptr;
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
        unsigned char* st = pipe + (kt % STAGES) * STAGE_BYTES;
        load_x(reinterpret_cast<__nv_bfloat16*>(st), x, m0, M, kt * BK, K);
        load_raw(st + A_BYTES, qw_mu, n0, N, kt * BK, K);
        if (noisy) load_raw(st + A_BYTES + R_BYTES, qw_sg, n0, N, kt * BK, K);
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
        __syncthreads();  // tile kt visible; stage (kt-1) % STAGES and the converted tiles free
        if (kt + STAGES - 1 < ktiles) issue(kt + STAGES - 1);
        cp_async_commit();

        const unsigned char* st = pipe + (kt % STAGES) * STAGE_BYTES;
        const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st);
        convert<FP8>(wc_mu, st + A_BYTES, sw_mu, s_stride, n0, N);
        if (noisy) {
            convert<FP8>(wc_sg, st + A_BYTES + R_BYTES, sw_sg, s_stride, n0, N);
            const int k0 = kt * BK;  // x * f_in, 8 elements a step, as K3
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
        }
        __syncthreads();  // converted tiles visible
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            FragA a[4];
            FragB b[2];
#pragma unroll
            for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(a[i], xs + (wm + 16 * i) * LDS + kk, LDS);
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], wc_mu + (wn + 16 * j) * LDS + kk, LDS);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) wmma::mma_sync(acc_mu[i][j], a[i], b[j], acc_mu[i][j]);
            if (noisy) {
#pragma unroll
                for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(a[i], xes + (wm + 16 * i) * LDS + kk, LDS);
#pragma unroll
                for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], wc_sg + (wn + 16 * j) * LDS + kk, LDS);
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
        float b = bias<FP8>(qb_mu, sb_mu, n);
        if (noisy) {
            const float fo = f_out[n];
            v = v + c_sg[r * LDC + c] * fo;
            b = b + bias<FP8>(qb_sg, sb_sg, n) * fo;
        }
        v = v + b;
        if (relu) v = fmaxf(v, 0.f);
        y[(size_t)m * N + n] = v;
    }
}

template <bool FP8>
int launch(const void* x, const void* qw_mu, const void* sw_mu, const void* qb_mu,
           const void* sb_mu, const void* qw_sg, const void* sw_sg, const void* qb_sg,
           const void* sb_sg, const void* f_in, const void* f_out, void* y, int M, int N, int K,
           int relu, int s_stride, cudaStream_t stream) {
    static bool smem_opted_in = false;  // once, before any graph capture
    if (!smem_opted_in) {
        const cudaError_t err = cudaFuncSetAttribute(
            noisy_linear_q_kernel<FP8>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
        if (err != cudaSuccess) return (int)err;
        smem_opted_in = true;
    }
    const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
    noisy_linear_q_kernel<FP8><<<grid, THREADS, SMEM_BYTES, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(qw_mu),
        static_cast<const float*>(sw_mu), static_cast<const uint8_t*>(qb_mu),
        static_cast<const float*>(sb_mu), static_cast<const uint8_t*>(qw_sg),
        static_cast<const float*>(sw_sg), static_cast<const uint8_t*>(qb_sg),
        static_cast<const float*>(sb_sg), static_cast<const float*>(f_in),
        static_cast<const float*>(f_out), static_cast<float*>(y), M, N, K, relu, s_stride);
    return (int)cudaGetLastError();
}

}  // namespace

PORT_API int port_noisy_linear_q(const void* x, const void* qw_mu, const void* sw_mu,
                                 const void* qb_mu, const void* sb_mu, const void* qw_sg,
                                 const void* sw_sg, const void* qb_sg, const void* sb_sg,
                                 const void* f_in, const void* f_out, void* y, int M, int N,
                                 int K, int relu, int s_stride, int fp8, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (fp8)
        return launch<true>(x, qw_mu, sw_mu, qb_mu, sb_mu, qw_sg, sw_sg, qb_sg, sb_sg, f_in,
                            f_out, y, M, N, K, relu, s_stride, st);
    return launch<false>(x, qw_mu, sw_mu, qb_mu, sb_mu, qw_sg, sw_sg, qb_sg, sb_sg, f_in,
                         f_out, y, M, N, K, relu, s_stride, st);
}
