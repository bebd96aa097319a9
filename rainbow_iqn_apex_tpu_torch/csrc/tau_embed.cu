// K2: IQN cosine-tau embedding fused with the Hadamard merge.
//
//   h[m, f] = bf16( ReLU( bf16(bf16(cos(pi*i*tau_m)) . W_e[f, :]) + bf16(b_e[f]) )
//                   * phi[m / taus_per_row, f] )          i = 1..C
//
// Replaces rainbow_iqn_apex_tpu/models/layers.py CosineTauEmbedding.__call__
// (:105-114) plus the merge in models/iqn.py (:74-75), which XLA fuses on the
// TPU.  The bf16 rounding points are the JAX model's: cos features, the Dense
// output, the bias add and the product with phi each round to bf16.
//
// Bound on the H100: the [M, F] bf16 output (12.8 MB at M = 2048, F = 3136)
// is nearly all the bytes, so the kernel is memory-bound at ~4 us; the
// 2*M*F*C products are < 1 us of tensor-core time.  Design: a GEMM whose A
// operand never touches device memory.  One block owns 64 rows x 128
// features: its prologue computes the 64 x C cos features straight into
// shared memory as bf16 and copies the 128 x C slice of W_e beside them; four
// warps run the depth-C product on tensor cores (16x16x16 bf16 wmma, fp32
// accumulation); the epilogue stages the accumulators through shared memory
// and applies the bias, the ReLU and the phi product, writing 8 outputs per
// 16-byte store, so each output element is written once.
//
// K2g, the game embedding of multi-game runs (rainbow_iqn_apex_tpu/multitask/
// model.py:80-90, phi + E[game] before the merge): with game [B] int32 and
// E [G, F] fp32, the epilogue's phi becomes
//   phi_g[b, f] = bf16( phi[b, f] + bf16(E[game[b], f]) )
// (the rounding of multitask/model.py:89), read beside phi, so the embedding
// adds G*F*4 + B*4 bytes to the read side and no pass of its own.  Null
// game and E pointers are the single-game K2.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 64;    // (batch, tau) rows per block
constexpr int BN = 128;   // output features per block
constexpr int THREADS = 128;
constexpr int LDC = BN + 4;  // fp32 row stride of the epilogue tile
constexpr float PI_F = 3.14159265358979323846f;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__global__ void __launch_bounds__(THREADS) tau_embed_kernel(
    const float* __restrict__ taus,          // [M]
    const __nv_bfloat16* __restrict__ w,     // [F, C]
    const float* __restrict__ bias,          // [F]
    const __nv_bfloat16* __restrict__ phi,   // [M / taus_per_row, F]
    __nv_bfloat16* __restrict__ out,         // [M, F]
    const int* __restrict__ game,            // [M / taus_per_row] or null (K2g)
    const float* __restrict__ emb,           // [G, F] or null (K2g)
    int M, int F, int C, int taus_per_row) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int lda = C + 8;  // bf16 row stride of both operand tiles
    __nv_bfloat16* cos_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [BM][lda]
    __nv_bfloat16* w_s = cos_s + BM * lda;                         // [BN][lda]
    float* c_s = reinterpret_cast<float*>(smem);                    // [BM][LDC], after the MMAs

    const int m0 = blockIdx.x * BM;
    const int f0 = blockIdx.y * BN;

    for (int i = threadIdx.x; i < BM * C; i += THREADS) {
        const int r = i / C;
        const int c = i % C;
        const int m = m0 + r;
        const float v = m < M ? cosf((PI_F * taus[m]) * (float)(c + 1)) : 0.f;
        cos_s[r * lda + c] = __float2bfloat16(v);
    }
    for (int i = threadIdx.x; i < BN * C / 8; i += THREADS) {
        const int r = i / (C / 8);
        const int c = (i % (C / 8)) * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (f0 + r < F) v = *reinterpret_cast<const uint4*>(w + (size_t)(f0 + r) * C + c);
        *reinterpret_cast<uint4*>(w_s + r * lda + c) = v;
    }
    __syncthreads();

    // 2 x 2 warps, each 32 rows x 64 features
    const int warp = threadIdx.x / 32;
    const int wm = (warp / 2) * 32;
    const int wn = (warp % 2) * 64;
    FragC acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int kk = 0; kk < C; kk += 16) {
        FragA a[2];
        FragB b[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], cos_s + (wm + 16 * i) * lda + kk, lda);
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::load_matrix_sync(b[j], w_s + (wn + 16 * j) * lda + kk, lda);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the operand tiles are dead; reuse their memory
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            wmma::store_matrix_sync(c_s + (wm + 16 * i) * LDC + wn + 16 * j, acc[i][j], LDC,
                                    wmma::mem_row_major);
    __syncthreads();

    // epilogue: 8 consecutive features per thread step; F % 8 == 0
    for (int i = threadIdx.x; i < BM * BN / 8; i += THREADS) {
        const int r = i / (BN / 8);
        const int c = (i % (BN / 8)) * 8;
        const int m = m0 + r;
        const int f = f0 + c;
        if (m >= M || f >= F) continue;
        const int row = m / taus_per_row;
        const uint4 praw = *reinterpret_cast<const uint4*>(phi + (size_t)row * F + f);
        const __nv_bfloat16* p = reinterpret_cast<const __nv_bfloat16*>(&praw);
        const float* e = emb == nullptr ? nullptr : emb + (size_t)game[row] * F + f;
        uint4 oraw;
        __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&oraw);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const float dense = port::bf16_round(c_s[r * LDC + c + j]);
            const float psi = fmaxf(port::bf16_round(dense + port::bf16_round(bias[f + j])), 0.f);
            float pj = port::to_float(p[j]);
            if (e != nullptr) pj = port::bf16_round(pj + port::bf16_round(e[j]));
            o[j] = __float2bfloat16(psi * pj);
        }
        *reinterpret_cast<uint4*>(out + (size_t)m * F + f) = oraw;
    }
}

}  // namespace

PORT_API int port_tau_embed(const void* taus, const void* w, const void* bias,
                            const void* phi, void* out, const void* game, const void* emb,
                            int M, int F, int C, int taus_per_row, void* stream) {
    const dim3 grid((M + BM - 1) / BM, (F + BN - 1) / BN);
    const size_t operands = (size_t)(BM + BN) * (C + 8) * sizeof(__nv_bfloat16);
    const size_t epilogue = (size_t)BM * LDC * sizeof(float);
    const size_t smem = operands > epilogue ? operands : epilogue;
    tau_embed_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(taus), static_cast<const __nv_bfloat16*>(w),
        static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(phi),
        static_cast<__nv_bfloat16*>(out), static_cast<const int*>(game),
        static_cast<const float*>(emb), M, F, C, taus_per_row);
    return (int)cudaGetLastError();
}

PORT_API const char* port_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
