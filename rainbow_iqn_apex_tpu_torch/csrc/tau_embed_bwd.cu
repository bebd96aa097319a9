// K2-bwd: the backward of K2, the cosine-tau embedding merged with phi.
//
// Forward (K2), row m = b*N + n:  pre = bf16(bf16(cos_m . W_e[f, :]) + bf16(b_e[f]))
//                                 psi = ReLU(pre),  h[m, f] = bf16(phi[b, f] * psi)
// Given dh = dL/dh (bf16 [B*N, F]):
//
//   dphi[b, f] = bf16( sum_n bf16(dh[m, f] * psi[m, f]) )
//   dpre[m, f] = bf16(dh[m, f] * phi[b, f]) * 1{pre > 0}
//   dW_e[f, c] = bf16( sum_m dpre[m, f] * cos_b[m, c] )
//   db_e[f]    = bf16( sum_m dpre[m, f] )          (stored as fp32)
//
// Replaces the backward that jax.grad derives for rainbow_iqn_apex_tpu/models/
// layers.py CosineTauEmbedding (:105-114) and the merge of models/iqn.py
// (:74-75).  The products round to bf16 where the jaxpr's bf16 products do.
// The jaxpr sums dphi and db_e as bf16 tensors; XLA on the CPU carries those
// partial sums rounded to bf16, this kernel carries them in fp32 and rounds
// once, so the two differ by a few bf16 ulps of the sum (tests state it).
//
// Bound on the H100: dh (12.8 MB at M = 2048, F = 3136) is nearly all the
// bytes: ~4 us at 3.35 TB/s; the two depth-64 products are 1.6 GFLOP, < 2 us
// of tensor-core time.  Design: psi is recomputed, not saved (saving it would
// add a 12.8 MB write and read), with K2's own tile product so the mask is
// K2's.  One block owns 32 features and walks every sample in turn, N rows
// (one sample) at a time:
//   1. the N x C cos features of the sample go to shared memory as bf16
//      (rows padded with zeros to a multiple of 16, the MMA tile);
//   2. N x 32 pre-activations by tensor cores (16x16x16 bf16 wmma), as in K2;
//   3. an elementwise pass reads dh and phi, forms dpre (kept in shared memory
//      as the next product's operand) and the dphi and db sums in fp32;
//   4. dW_e += dpre^T . cos on tensor cores, the accumulators living in
//      registers across all samples.
// dphi of a sample is that block's sum over its N rows, and dW_e and db_e
// sum over all M rows inside one block, so there is no cross-block reduction
// and no atomic: the same result on every run.  The grid is F / 32 = 98
// blocks for F = 3136, under one wave of 132 SMs.
//
// K2g-bwd (multi-game runs, game [B] int32 and E [G, F] fp32): the merge's
// phi is phi_g = bf16(phi + bf16(E[game[b]])), as K2g forms it, and the
// embedding's gradient is the transpose of the gather after the fp32 -> bf16
// cast,
//   dE[g, f] = sum over the rows b with game[b] == g of fp32(dphi[b, f])
// (dphi is also dphi_g: the add passes it through).  The same launch forms
// it after the sample loop: each block reads back its 32 features of the
// bf16 dphi it wrote and sums them per game, rows in order, in fp32.  No
// atomics: the same result on every run.  dE adds G*F*4 bytes written.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int FT = 32;  // features per block
constexpr int THREADS = 128;
constexpr int MAX_ROWS = 128;  // N, the rows of one sample
constexpr int MAX_C = 128;
constexpr float PI_F = 3.14159265358979323846f;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragARow;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> FragACol;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> FragBCol;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragBRow;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__global__ void __launch_bounds__(THREADS) tau_embed_bwd_kernel(
    const float* __restrict__ taus,         // [B*N]
    const __nv_bfloat16* __restrict__ w,    // [F, C]
    const float* __restrict__ bias,         // [F]
    const __nv_bfloat16* __restrict__ phi,  // [B, F]
    const __nv_bfloat16* __restrict__ dh,   // [B*N, F]
    __nv_bfloat16* __restrict__ dphi,       // [B, F]
    __nv_bfloat16* __restrict__ dw,         // [F, C]
    float* __restrict__ db,                 // [F]
    const int* __restrict__ game,           // [B] or null (K2g-bwd)
    const float* __restrict__ emb,          // [G, F] or null (K2g-bwd)
    float* __restrict__ demb,               // [G, F] or null (K2g-bwd)
    int B, int N, int F, int C, int G) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int ldc = C + 8;   // bf16 stride of cos and w tiles
    const int ldp = FT + 8;  // bf16 stride of the dpre tile
    const int lde = FT + 4;  // fp32 stride of the pre-activation tile
    __nv_bfloat16* cos_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [N][ldc]
    __nv_bfloat16* w_s = cos_s + MAX_ROWS * ldc;                     // [FT][ldc]
    __nv_bfloat16* dpre_s = w_s + FT * ldc;                          // [N][ldp]
    float* pre_s = reinterpret_cast<float*>(dpre_s + MAX_ROWS * ldp);  // [N][lde]
    float* part = pre_s + MAX_ROWS * lde;                             // [4][FT] dphi partials

    const int f0 = blockIdx.x * FT;
    const int warp = threadIdx.x / 32;
    const int lane_f = threadIdx.x % FT;       // elementwise: this thread's feature
    const int row_grp = threadIdx.x / FT;      // and its row group (rows row_grp, +4, ...)
    const int f = f0 + lane_f;
    const bool f_in = f < F;
    const float bias_b = f_in ? port::bf16_round(bias[f]) : 0.f;

    for (int i = threadIdx.x; i < FT * C / 8; i += THREADS) {
        const int r = i / (C / 8);
        const int c = (i % (C / 8)) * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (f0 + r < F) v = *reinterpret_cast<const uint4*>(w + (size_t)(f0 + r) * C + c);
        *reinterpret_cast<uint4*>(w_s + r * ldc + c) = v;
    }

    // dW_e accumulators: FT x C = 2 x (C/16) fragments spread over the 4 warps
    const int dw_frags = 2 * (C / 16);
    FragC acc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wmma::fill_fragment(acc[i], 0.f);
    float db_acc = 0.f;
    const int n16 = (N + 15) / 16 * 16;  // rows padded to the MMA tile; pad rows are zero
    const int pre_frags = (n16 / 16) * 2;

    for (int b = 0; b < B; ++b) {
        const size_t m0 = (size_t)b * N;
        __syncthreads();  // previous sample's tiles are dead
        for (int i = threadIdx.x; i < n16 * C; i += THREADS) {
            const int r = i / C;
            const int c = i % C;
            const float v = r < N ? cosf((PI_F * taus[m0 + r]) * (float)(c + 1)) : 0.f;
            cos_s[r * ldc + c] = __float2bfloat16(v);
        }
        __syncthreads();
        // 2. pre-activations [N x FT] = cos [N x C] . w_s^T, one 16x16 tile at a time
        for (int t = warp; t < pre_frags; t += 4) {
            const int tr = (t / 2) * 16;
            const int tc = (t % 2) * 16;
            FragC d;
            wmma::fill_fragment(d, 0.f);
            for (int kk = 0; kk < C; kk += 16) {
                FragARow a;
                FragBCol bw;
                wmma::load_matrix_sync(a, cos_s + tr * ldc + kk, ldc);
                wmma::load_matrix_sync(bw, w_s + tc * ldc + kk, ldc);
                wmma::mma_sync(d, a, bw, d);
            }
            wmma::store_matrix_sync(pre_s + tr * lde + tc, d, lde, wmma::mem_row_major);
        }
        __syncthreads();
        // 3. elementwise: dpre, and this thread's share of dphi and db
        const __nv_bfloat16 zero = __float2bfloat16(0.f);
        float phi_v = f_in ? port::to_float(phi[(size_t)b * F + f]) : 0.f;
        if (emb != nullptr && f_in)
            phi_v = port::bf16_round(phi_v + port::bf16_round(emb[(size_t)game[b] * F + f]));
        float dphi_acc = 0.f;
        for (int r = row_grp; r < n16; r += THREADS / FT) {
            __nv_bfloat16 dp = zero;
            if (f_in && r < N) {
                const float pre = port::bf16_round(port::bf16_round(pre_s[r * lde + lane_f]) + bias_b);
                const float psi = fmaxf(pre, 0.f);
                const float g = port::to_float(dh[(m0 + r) * F + f]);
                dphi_acc += port::bf16_round(g * psi);
                if (pre > 0.f) {
                    dp = __float2bfloat16(g * phi_v);
                    db_acc += port::to_float(dp);
                }
            }
            dpre_s[r * ldp + lane_f] = dp;
        }
        part[row_grp * FT + lane_f] = dphi_acc;
        __syncthreads();
        if (threadIdx.x < FT && f0 + threadIdx.x < F) {
            float s = 0.f;
            for (int g = 0; g < THREADS / FT; ++g) s += part[g * FT + threadIdx.x];
            dphi[(size_t)b * F + f0 + threadIdx.x] = __float2bfloat16(s);
        }
        // 4. dW_e[f, c] += sum_r dpre[r, f] * cos[r, c]
        for (int i = 0; i < 4; ++i) {
            const int t = warp + 4 * i;
            if (t >= dw_frags) break;
            const int tf = (t % 2) * 16;
            const int tc = (t / 2) * 16;
            for (int kk = 0; kk < n16; kk += 16) {
                FragACol a;
                FragBRow bc;
                wmma::load_matrix_sync(a, dpre_s + kk * ldp + tf, ldp);
                wmma::load_matrix_sync(bc, cos_s + kk * ldc + tc, ldc);
                wmma::mma_sync(acc[i], a, bc, acc[i]);
            }
        }
    }
    __syncthreads();
    // db: combine the row groups' sums in a fixed order
    part[row_grp * FT + lane_f] = db_acc;
    // stage the dW_e tile through the (now dead) pre-activation tile: [FT][C + 4] fp32
    const int ldw = C + 4;
    float* dw_s = pre_s;
    for (int i = 0; i < 4; ++i) {
        const int t = warp + 4 * i;
        if (t >= dw_frags) break;
        const int tf = (t % 2) * 16;
        const int tc = (t / 2) * 16;
        wmma::store_matrix_sync(dw_s + tf * ldw + tc, acc[i], ldw, wmma::mem_row_major);
    }
    __syncthreads();
    if (threadIdx.x < FT && f0 + threadIdx.x < F) {
        float s = 0.f;
        for (int g = 0; g < THREADS / FT; ++g) s += part[g * FT + threadIdx.x];
        db[f0 + threadIdx.x] = port::bf16_round(s);
    }
    for (int i = threadIdx.x; i < FT * C; i += THREADS) {
        const int r = i / C;
        const int c = i % C;
        if (f0 + r < F) dw[(size_t)(f0 + r) * C + c] = __float2bfloat16(dw_s[r * ldw + c]);
    }
    // dE: this block's dphi writes are visible to it after the barriers above
    if (demb != nullptr) {
        for (int i = threadIdx.x; i < G * FT; i += THREADS) {
            const int g = i / FT;
            const int ff = f0 + i % FT;
            if (ff >= F) continue;
            float s = 0.f;
            for (int b = 0; b < B; ++b)
                if (game[b] == g) s += port::to_float(dphi[(size_t)b * F + ff]);
            demb[(size_t)g * F + ff] = s;
        }
    }
}

}  // namespace

PORT_API int port_tau_embed_bwd(const void* taus, const void* w, const void* bias,
                                const void* phi, const void* dh, void* dphi, void* dw, void* db,
                                const void* game, const void* emb, void* demb, int B, int N,
                                int F, int C, int G, void* stream) {
    const int ldc = C + 8, ldp = FT + 8, lde = FT + 4;
    size_t smem = (size_t)(MAX_ROWS + FT) * ldc * sizeof(__nv_bfloat16) +
                  (size_t)MAX_ROWS * ldp * sizeof(__nv_bfloat16) +
                  (size_t)MAX_ROWS * lde * sizeof(float) + (size_t)4 * FT * sizeof(float);
    const size_t dw_stage = (size_t)FT * (C + 4) * sizeof(float);
    if (dw_stage > (size_t)MAX_ROWS * lde * sizeof(float)) return (int)cudaErrorInvalidValue;
    static bool opted = false;  // once, before any graph capture
    if (!opted) {
        const cudaError_t err = cudaFuncSetAttribute(
            tau_embed_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)((MAX_ROWS + FT) * (MAX_C + 8) * sizeof(__nv_bfloat16) +
                  MAX_ROWS * ldp * sizeof(__nv_bfloat16) + MAX_ROWS * lde * sizeof(float) +
                  4 * FT * sizeof(float)));
        if (err != cudaSuccess) return (int)err;
        opted = true;
    }
    const int grid = (F + FT - 1) / FT;
    tau_embed_bwd_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(taus), static_cast<const __nv_bfloat16*>(w),
        static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(phi),
        static_cast<const __nv_bfloat16*>(dh), static_cast<__nv_bfloat16*>(dphi),
        static_cast<__nv_bfloat16*>(dw), static_cast<float*>(db), static_cast<const int*>(game),
        static_cast<const float*>(emb), static_cast<float*>(demb), B, N, F, C, G);
    return (int)cudaGetLastError();
}
