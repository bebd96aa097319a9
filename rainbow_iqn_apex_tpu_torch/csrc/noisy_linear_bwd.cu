// K3-bwd: the backward of the factorised-noise NoisyLinear (+ReLU) of K3.
//
// Forward (K3): y = xc @ W_mu^T + ((xc * f_in) @ W_sigma^T) * f_out + b_mu + b_sigma * f_out,
// ReLU after when asked.  Given g = dL/dy (fp32 [M, N]):
//
//   dy      = g * 1{y > 0}                    (ReLU layers; y is the saved fp32 output)
//   dys     = dy * f_out
//   dxc     = bf16( bf16(dy @ W_mu) + bf16( bf16(dys @ W_sigma) * bf16(f_in) ) )
//   dW_mu   = bf16( dy^T  @ xc )              dW_sigma = bf16( dys^T @ bf16(xc * f_in) )
//   db_mu   = sum_m dy                        db_sigma = f_out * db_mu
//
// Replaces the backward that jax.grad derives for rainbow_iqn_apex_tpu/models/
// layers.py NoisyLinear (:48-91) and the ReLU of models/iqn.py (:85).  The
// rounding points are those of its jaxpr: every cotangent of a bf16 operand
// (xc, W_mu, W_sigma, xc * f_in) is an fp32 product rounded once to bf16, and
// the two cotangents of xc add in bf16.  The greedy layer (no W_sigma) keeps
// only the mu terms.
//
// JAX multiplies the fp32 cotangent dy by the bf16 operand in fp32.  The
// tensor cores take bf16 operands, so dy is split into two bf16 halves,
// dy = hi + lo with hi = bf16(dy), lo = bf16(dy - hi), and each product runs
// twice: hi @ W + lo @ W.  What is lost is lo's own rounding, ~2^-17 of dy,
// far below the final bf16 rounding (2^-9), where a single bf16 dy would
// add an error as large as that final rounding.
//
// Bound on the H100: for a noisy hidden layer of the learner (M = 2048,
// K = 3136, N = 512) the function is four products of 2*M*N*K = 6.6 GFLOP,
// 26 GFLOP, ~27 us of bf16 tensor-core time against ~25 MB of operands
// (~8 us): compute-bound.  The split doubles the tensor-core work to 53 GFLOP.
// The *_out layers (N = 1, 18) are launch-bound.  Design: three launches.
//   1. prep: one pass over g forms the masked dy and dys and writes their bf16
//      halves, zero-padded to N8 = roundup(N, 8) columns so every operand row is
//      16-byte aligned.
//   2. dx: a tiled tensor-core GEMM over (M, K) with depth N: the dy halves are
//      the A operand, W_mu / W_sigma [N, K] the B operand read along its rows;
//      the epilogue forms dxc with the bf16 rounding points above.
//   3. dW: a tiled tensor-core GEMM over (N, K) with depth M: the dy halves read
//      transposed are the A operand, xc [M, K] the B operand, and in noisy mode
//      xc * f_in is formed in shared memory from the xc tile already there.  The
//      blocks of the first K tile also sum dy over M for db.  Each output
//      element's whole depth is one block's loop, so there is no cross-block
//      reduction and no atomic: the same result on every run.
// Both GEMMs stream their tiles through a 3-stage cp.async ring (as K3's
// forward does) into 16x16x16 bf16 wmma with fp32 accumulators.  Not yet
// wgmma/TMA.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 128;  // rows of the output tile
constexpr int BN = 64;   // columns of the output tile
constexpr int BR = 32;   // depth of one pipeline stage
constexpr int STAGES = 3;
constexpr int THREADS = 128;
constexpr int LDA = BR + 8;   // A tile [BM][LDA] (dx: rows m, depth n)
constexpr int LDAT = BM + 8;  // A tile [BR][LDAT] (dW: depth m, rows n)
constexpr int LDB = BN + 8;   // B tile [BR][LDB]
constexpr int LDC = BN + 4;   // fp32 epilogue tile [BM][LDC]
constexpr int A_TILE = BM * LDA > BR * LDAT ? BM * LDA : BR * LDAT;  // elements
constexpr int B_TILE = BR * LDB;
constexpr int STAGE = 4 * A_TILE + 2 * B_TILE;  // hi | lo | s_hi | s_lo | B0 | B1
constexpr int PIPE_BYTES = (STAGES * STAGE + B_TILE) * (int)sizeof(__nv_bfloat16);
constexpr int EPI_BYTES = 2 * BM * LDC * (int)sizeof(float);
constexpr int SMEM_BYTES = PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragARow;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> FragACol;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int n = pred ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Queue the copy of the ROWS x COLS bf16 block at (row0, col0) of a row-major
// [rows, cols] matrix (row stride ld) into shared memory (row stride lds).
// cols % 8 == 0, so each 16-byte chunk is wholly inside or outside.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_block(__nv_bfloat16* dst, int lds, const __nv_bfloat16* src,
                                           int ld, int row0, int rows, int col0, int cols) {
    for (int i = threadIdx.x; i < ROWS * COLS / 8; i += THREADS) {
        const int r = i / (COLS / 8);
        const int c = (i % (COLS / 8)) * 8;
        const bool in = row0 + r < rows && col0 + c < cols;
        const __nv_bfloat16* g = in ? src + (size_t)(row0 + r) * ld + col0 + c : src;
        cp_async16(dst + r * lds + c, g, in);
    }
}

// ---------------------------------------------------------------- 1. prep
__global__ void prep_kernel(const float* __restrict__ g,      // [M, N]
                            const float* __restrict__ y,      // [M, N] or null (no ReLU)
                            const float* __restrict__ f_out,  // [N] or null (greedy)
                            __nv_bfloat16* __restrict__ halves,  // 2 or 4 x [M, N8]
                            int M, int N, int N8) {
    const size_t plane = (size_t)M * N8;
    const size_t total = plane;
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
         i += (size_t)gridDim.x * blockDim.x) {
        const int m = (int)(i / N8);
        const int n = (int)(i % N8);
        float dy = 0.f;
        if (n < N) {
            const size_t src = (size_t)m * N + n;
            dy = g[src];
            if (y != nullptr && !(y[src] > 0.f)) dy = 0.f;
        }
        const __nv_bfloat16 hi = __float2bfloat16(dy);
        halves[i] = hi;
        halves[plane + i] = __float2bfloat16(dy - __bfloat162float(hi));
        if (f_out != nullptr) {
            const float s = n < N ? dy * f_out[n] : 0.f;
            const __nv_bfloat16 shi = __float2bfloat16(s);
            halves[2 * plane + i] = shi;
            halves[3 * plane + i] = __float2bfloat16(s - __bfloat162float(shi));
        }
    }
}

// ------------------------------------------------------- 2./3. the GEMMs
// TRANS == false (dx):  C[M, K] = halves[M, N8] @ W[N, K]         rows = M, depth = N
// TRANS == true  (dW):  C[N, K] = halves[M, N8]^T @ xc[M, K]      rows = N, depth = M
template <bool TRANS>
__global__ void __launch_bounds__(THREADS) gemm_kernel(
    const __nv_bfloat16* __restrict__ halves,  // hi, lo[, s_hi, s_lo] planes of [M, N8]
    const __nv_bfloat16* __restrict__ b0,      // dx: W_mu [N, K];  dW: xc [M, K]
    const __nv_bfloat16* __restrict__ b1,      // dx: W_sigma [N, K] or null; dW: unused
    const float* __restrict__ f_in,            // [K] (noisy) or null
    const float* __restrict__ f_out,           // [N] (dW, noisy) or null
    __nv_bfloat16* __restrict__ out0,          // dx: dxc [M, K];  dW: dW_mu [N, K]
    __nv_bfloat16* __restrict__ out1,          // dW: dW_sigma [N, K] (noisy)
    float* __restrict__ db_mu,                 // dW: [N]
    float* __restrict__ db_sigma,              // dW: [N] (noisy)
    int M, int N, int N8, int K) {
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* pipe = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* xes = pipe + STAGES * STAGE;  // dW, noisy: xc * f_in of the current tile
    float* c_mu = reinterpret_cast<float*>(smem);
    float* c_sg = c_mu + BM * LDC;

    const bool noisy = f_in != nullptr;
    const int rows = TRANS ? N : M;
    const int depth = TRANS ? M : N;
    const int r0 = blockIdx.x * BM;
    const int k0 = blockIdx.y * BN;
    const int warp = threadIdx.x / 32;
    const int wm = (warp / 2) * 64;
    const int wn = (warp % 2) * 32;
    const int tiles = (depth + BR - 1) / BR;
    const size_t plane = (size_t)M * N8;
    const int nplanes = noisy ? 4 : 2;
    const bool do_bias = TRANS && blockIdx.y == 0;
    float bias_acc = 0.f;  // dW: sum over m of dy for row r0 + threadIdx.x

    FragC acc_mu[4][2], acc_sg[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            wmma::fill_fragment(acc_mu[i][j], 0.f);
            wmma::fill_fragment(acc_sg[i][j], 0.f);
        }

    auto issue = [&](int t) {
        __nv_bfloat16* st = pipe + (t % STAGES) * STAGE;
        const int d0 = t * BR;
        for (int p = 0; p < nplanes; ++p) {
            if (TRANS)  // depth m along the tile's rows, output rows n along its columns
                load_block<BR, BM>(st + p * A_TILE, LDAT, halves + p * plane, N8, d0, M, r0, N8);
            else
                load_block<BM, BR>(st + p * A_TILE, LDA, halves + p * plane, N8, r0, M, d0, N8);
        }
        __nv_bfloat16* bt = st + 4 * A_TILE;
        if (TRANS) {
            load_block<BR, BN>(bt, LDB, b0, K, d0, M, k0, K);
        } else {
            load_block<BR, BN>(bt, LDB, b0, K, d0, N, k0, K);
            if (noisy) load_block<BR, BN>(bt + B_TILE, LDB, b1, K, d0, N, k0, K);
        }
    };

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < tiles) issue(s);
        cp_async_commit();
    }

    for (int t = 0; t < tiles; ++t) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        if (t + STAGES - 1 < tiles) issue(t + STAGES - 1);
        cp_async_commit();

        const __nv_bfloat16* st = pipe + (t % STAGES) * STAGE;
        const __nv_bfloat16* bt = st + 4 * A_TILE;
        const __nv_bfloat16* bs = noisy ? (TRANS ? xes : bt + B_TILE) : nullptr;
        if (TRANS && (noisy || do_bias)) {
            if (noisy) {  // xc * f_in, rounded to bf16 as the JAX layer's product is
                for (int i = threadIdx.x; i < BR * BN / 8; i += THREADS) {
                    const int r = i / (BN / 8);
                    const int c = (i % (BN / 8)) * 8;
                    const uint4 raw = *reinterpret_cast<const uint4*>(bt + r * LDB + c);
                    const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&raw);
                    uint4 prod = make_uint4(0, 0, 0, 0);
                    __nv_bfloat16* pv = reinterpret_cast<__nv_bfloat16*>(&prod);
                    if (k0 + c < K) {
#pragma unroll
                        for (int j = 0; j < 8; ++j)
                            pv[j] = __float2bfloat16(port::to_float(xv[j]) *
                                                     port::bf16_round(f_in[k0 + c + j]));
                    }
                    *reinterpret_cast<uint4*>(xes + r * LDB + c) = prod;
                }
            }
            if (do_bias) {  // one thread per output row n; depth rows in order
                const int d0 = t * BR;
                for (int r = 0; r < BR && d0 + r < M; ++r)
                    bias_acc += port::to_float(st[r * LDAT + threadIdx.x]) +
                                port::to_float(st[A_TILE + r * LDAT + threadIdx.x]);
            }
            __syncthreads();
        }
#pragma unroll
        for (int kk = 0; kk < BR; kk += 16) {
            FragB fb[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], bt + kk * LDB + wn + 16 * j, LDB);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const __nv_bfloat16* a = st + half * A_TILE;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    if (TRANS) {
                        FragACol fa;
                        wmma::load_matrix_sync(fa, a + kk * LDAT + wm + 16 * i, LDAT);
#pragma unroll
                        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc_mu[i][j], fa, fb[j], acc_mu[i][j]);
                    } else {
                        FragARow fa;
                        wmma::load_matrix_sync(fa, a + (wm + 16 * i) * LDA + kk, LDA);
#pragma unroll
                        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc_mu[i][j], fa, fb[j], acc_mu[i][j]);
                    }
                }
            }
            if (noisy) {
#pragma unroll
                for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], bs + kk * LDB + wn + 16 * j, LDB);
#pragma unroll
                for (int half = 2; half < 4; ++half) {
                    const __nv_bfloat16* a = st + half * A_TILE;
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        if (TRANS) {
                            FragACol fa;
                            wmma::load_matrix_sync(fa, a + kk * LDAT + wm + 16 * i, LDAT);
#pragma unroll
                            for (int j = 0; j < 2; ++j) wmma::mma_sync(acc_sg[i][j], fa, fb[j], acc_sg[i][j]);
                        } else {
                            FragARow fa;
                            wmma::load_matrix_sync(fa, a + (wm + 16 * i) * LDA + kk, LDA);
#pragma unroll
                            for (int j = 0; j < 2; ++j) wmma::mma_sync(acc_sg[i][j], fa, fb[j], acc_sg[i][j]);
                        }
                    }
                }
            }
        }
    }
    cp_async_wait<0>();
    __syncthreads();  // every MMA done before the epilogue reuses the ring

    if (do_bias) {
        const int n = r0 + threadIdx.x;
        if (n < N) {
            db_mu[n] = bias_acc;
            if (noisy) db_sigma[n] = f_out[n] * bias_acc;
        }
    }
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
        const int row = r0 + r;
        const int k = k0 + c;
        if (row >= rows || k >= K) continue;
        const size_t o = (size_t)row * K + k;
        if (TRANS) {
            out0[o] = __float2bfloat16(c_mu[r * LDC + c]);
            if (noisy) out1[o] = __float2bfloat16(c_sg[r * LDC + c]);
        } else {
            float v = port::bf16_round(c_mu[r * LDC + c]);
            if (noisy) {
                const float t = port::bf16_round(port::bf16_round(c_sg[r * LDC + c]) *
                                                 port::bf16_round(f_in[k]));
                v = v + t;
            }
            out0[o] = __float2bfloat16(v);
        }
    }
}

template <bool TRANS>
int opt_in() {
    static bool done = false;  // once, before any graph capture
    if (!done) {
        const cudaError_t err = cudaFuncSetAttribute(
            gemm_kernel<TRANS>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
        if (err != cudaSuccess) return (int)err;
        done = true;
    }
    return 0;
}

}  // namespace

// workspace: (noisy ? 4 : 2) * M * roundup(N, 8) bf16 elements, 16-byte aligned
PORT_API int port_noisy_linear_bwd(const void* g, const void* y, const void* xc,
                                   const void* w_mu, const void* w_sigma, const void* f_in,
                                   const void* f_out, void* dxc, void* dw_mu, void* dw_sigma,
                                   void* db_mu, void* db_sigma, void* workspace, int M, int N,
                                   int K, void* stream) {
    int err = opt_in<false>();
    if (err) return err;
    err = opt_in<true>();
    if (err) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int N8 = (N + 7) / 8 * 8;
    const bool noisy = w_sigma != nullptr;
    auto* halves = static_cast<__nv_bfloat16*>(workspace);
    const size_t elems = (size_t)M * N8;
    int blocks = (int)((elems + 255) / 256);
    if (blocks > 4096) blocks = 4096;
    prep_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(g), static_cast<const float*>(y),
                                       noisy ? static_cast<const float*>(f_out) : nullptr,
                                       halves, M, N, N8);
    const float* fi = noisy ? static_cast<const float*>(f_in) : nullptr;
    const float* fo = noisy ? static_cast<const float*>(f_out) : nullptr;
    const dim3 grid_dx((M + BM - 1) / BM, (K + BN - 1) / BN);
    gemm_kernel<false><<<grid_dx, THREADS, SMEM_BYTES, s>>>(
        halves, static_cast<const __nv_bfloat16*>(w_mu),
        static_cast<const __nv_bfloat16*>(w_sigma), fi, fo, static_cast<__nv_bfloat16*>(dxc),
        nullptr, nullptr, nullptr, M, N, N8, K);
    const dim3 grid_dw((N + BM - 1) / BM, (K + BN - 1) / BN);
    gemm_kernel<true><<<grid_dw, THREADS, SMEM_BYTES, s>>>(
        halves, static_cast<const __nv_bfloat16*>(xc), nullptr, fi, fo,
        static_cast<__nv_bfloat16*>(dw_mu), static_cast<__nv_bfloat16*>(dw_sigma),
        static_cast<float*>(db_mu), static_cast<float*>(db_sigma), M, N, N8, K);
    return (int)cudaGetLastError();
}
