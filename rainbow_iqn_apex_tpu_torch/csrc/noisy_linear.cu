// K3: factorised-noise NoisyLinear as one GEMM with a fused epilogue.
//
//   greedy: y = x @ W_mu^T + b_mu
//   noisy:  y = x @ W_mu^T + (bf16(x * bf16(f_in)) @ W_sigma^T) * f_out + (b_mu + b_sigma * f_out)
//   then ReLU when asked.
//
// Replaces rainbow_iqn_apex_tpu/models/layers.py NoisyLinear.__call__
// (:48-91) and the hidden ReLU of models/iqn.py (:85), XLA-fused on the TPU.
// x, W_mu and W_sigma are bf16 operands with fp32 accumulation, f_in/f_out
// are the squashed noise vectors f(eps) = sign(eps) sqrt|eps| in fp32, the
// bias is fp32, y is fp32: the JAX layer's precision.  x * f_in rounds to bf16
// as the JAX layer's bf16 product does.  Weights are [N, K] (torch's Linear
// layout), so both operands of each product are K-major.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s), per layer:
//   hidden 3136 -> 512 at M 2048 (a bucket-64 dispatch, the learner's N = 64
//   passes): 6.6 GFLOP a product, 6.6 us greedy and 13.3 us noisy, against
//   16 MB of operands (4.8 us): operation-bound.  At M 512 (the act tick) 1.7
//   GFLOP, 1.7 us, and the 3.2 MB of weights (1.0 us) come close.
//   value_out / advantage_out (N 1, 18; K 512; M 2048): 2 MB of x, 0.6 us of
//   bytes and < 0.04 us of operations: byte- and launch-bound.
//
// Design, wide layers (N > 32): a warp-specialised wgmma GEMM.  One producer
// warp keeps a 3-stage ring of TMA loads in flight, each stage two 64-wide k
// boxes (128-byte swizzled) of the x tile [64 * NWG rows], of W_mu [64 rows]
// and, noisy, of W_sigma, completing on one mbarrier; NWG consumer
// warpgroups each run wgmma.m64n64k16 on 64 rows.  W_mu's product reads both
// operands through shared-memory descriptors.  W_sigma's takes A from
// registers: each consumer ldmatrix-loads its x fragment from the tile
// already in shared memory, multiplies it by bf16(f_in[k]) (one bf16x2
// multiply rounds as the JAX product does) and issues the product, so x is
// read from device memory once for both products and the [N, K] noise
// matrix is never formed.  A stage is released as soon as the wgmma group
// that read it retires (one group kept in flight).  The epilogue applies the
// noise scale, the bias and the ReLU in fp32 in registers and stores once.
// The tile height follows the wave count: NWG = 2 (128 x 64 tiles) where that
// gives >= 100 tiles on the 132 SMs (M 2048 and above at N 512: 128 tiles),
// else NWG = 1 (64 x 64: M 1024 gives 128 tiles, M 512 64); the wrapper's
// plan (kernels/noisy_linear.py) picks it.  What holds it back: the tiles'
// re-reads of x and W through L2 (at M 2048, 128 x 64 tiles, the largest that
// still fill the card, read 154 MB: ~7.9 TB/s at 19.6 us), and an m64n64
// wgmma reading 4 KB of shared memory per 131 kFLOP.  A 64 x 128 tile of one
// warpgroup and a 2-CTA cluster multicasting the x tile both measured slower.
//
// Design, narrow layers (N <= 32): their own kernel, since a 64-row wgmma
// tile would leave most of the card idle (M 2048 is 32 such tiles) and the
// time is the latency of the loads, not the products.  A block of 8 warps owns
// 16 rows (128 blocks at M 2048); each warp takes every eighth k16 step and
// runs mma.sync m16n8k16 on fragments loaded straight from device memory,
// four steps' loads in flight before the first product (K 512 is one such
// batch a warp; x is read once, in 32-byte row segments; the <= 36 KB of
// weights stay in L1), with N padded to the n8 blocks.  The eight partial
// sums meet in shared memory and are added in warp order, then the same
// epilogue.  So both paths are one launch of K3.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BN = 64;  // output columns of a wide tile
// 64-wide k boxes per stage, and stages.  Measured on the H100 against one
// box in 4 stages (4 % slower at M 2048, 10-15 % slower noisy at M 512-1024),
// one box in 6 or 8 stages (8-25 % slower) and a 64 x 128 tile of one
// warpgroup (12 % slower at M 2048).
constexpr int KSUB = 2;
constexpr int STAGES = 3;
constexpr int A_WG_BYTES = 64 * ROW_BYTES;  // one warpgroup's 64 rows of x

template <int NWG>
struct Wide {
    static constexpr int A_BYTES = NWG * A_WG_BYTES;  // one k box of x
    static constexpr int B_BYTES = BN * ROW_BYTES;    // one k box of W
    // per stage: x boxes, then W_mu boxes, then W_sigma boxes
    static constexpr int STAGE_BYTES = KSUB * (A_BYTES + 2 * B_BYTES);
    static constexpr int THREADS = NWG * 128 + 32;  // consumers, then the producer warp
    static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
    return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// bf16(f_in[k]), bf16(f_in[k + 1]) as one bf16x2 (0 past K; k is even, K % 8 == 0)
__device__ __forceinline__ uint32_t fin_pair(const float* f_in, int k, int K) {
    if (k >= K) return 0u;
    return pack_bf16x2(__ldg(f_in + k), __ldg(f_in + k + 1));
}

template <int NWG>
__global__ void __launch_bounds__(Wide<NWG>::THREADS, 1) k3_wide_kernel(
    const __grid_constant__ CUtensorMap map_x,    // x [M, K], boxes 64 x (64 * NWG)
    const __grid_constant__ CUtensorMap map_wmu,  // W_mu [N, K], boxes 64 x 64
    const __grid_constant__ CUtensorMap map_wsg,  // W_sigma [N, K] (noisy)
    const float* __restrict__ b_mu, const float* __restrict__ b_sigma,
    const float* __restrict__ f_in, const float* __restrict__ f_out, float* __restrict__ y,
    int M, int N, int K, int noisy, int relu) {
    using C = Wide<NWG>;
    constexpr int B_BYTES = C::B_BYTES;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = align1024(smem_raw);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * C::STAGE_BYTES);
    uint64_t* empty = full + STAGES;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int n0 = blockIdx.x * BN;
    const int m0 = blockIdx.y * 64 * NWG;
    const int ktiles = (K + KSUB * TILE_K - 1) / (KSUB * TILE_K);
    constexpr int W_AT = KSUB * C::A_BYTES;            // W_mu boxes in a stage
    constexpr int S_AT = KSUB * (C::A_BYTES + B_BYTES);  // W_sigma boxes

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 4 * NWG);  // lane 0 of every consumer warp
        }
        mbar_init_fence();
    }
    __syncthreads();

    if (warp == 4 * NWG) {  // ------------------------------------ producer
        if (lane == 0) {
            const uint32_t bytes = KSUB * (C::A_BYTES + (noisy ? 2 : 1) * B_BYTES);
            for (int t = 0; t < ktiles; ++t) {
                const int s = t % STAGES;
                if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
                uint8_t* st = smem + s * C::STAGE_BYTES;
                mbar_expect_tx(&full[s], bytes);
#pragma unroll
                for (int u = 0; u < KSUB; ++u) {
                    const int k = (t * KSUB + u) * TILE_K;
                    tma_load_2d(st + u * C::A_BYTES, &map_x, &full[s], k, m0);
                    tma_load_2d(st + W_AT + u * B_BYTES, &map_wmu, &full[s], k, n0);
                    if (noisy) tma_load_2d(st + S_AT + u * B_BYTES, &map_wsg, &full[s], k, n0);
                }
            }
        }
        return;
    }

    // ---------------------------------------------------------- consumers
    const int wg = warp / 4;
    const int w = warp % 4;
    const int g = lane / 4;
    const int tq = lane % 4;
    // ldmatrix: lane gives row (lane % 8) + 8 * bit 0 of (lane / 8) of its
    // warp's 16 rows, and chunk 2 kk + bit 1 of (lane / 8)
    const int lrow = 16 * w + (lane % 8) + 8 * ((lane / 8) & 1);
    const int lchunk = lane / 16;
    float acc_mu[BN / 2], acc_sg[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc_mu[i] = acc_sg[i] = 0.f;

    for (int t = 0; t < ktiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(&full[s], (t / STAGES) & 1);
        uint8_t* st = smem + s * C::STAGE_BYTES;
        wgmma_fence();
#pragma unroll
        for (int u = 0; u < KSUB; ++u) {
            const uint64_t da = desc_sw128(st + u * C::A_BYTES + wg * A_WG_BYTES);
            const uint64_t dmu = desc_sw128(st + W_AT + u * B_BYTES);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) wgmma_ss_n64(acc_mu, da + 2 * kk, dmu + 2 * kk);
        }
        if (noisy) {
#pragma unroll
            for (int u = 0; u < KSUB; ++u) {
                const uint64_t dsg = desc_sw128(st + S_AT + u * B_BYTES);
                const uint32_t a_base = smem_u32(st + u * C::A_BYTES + wg * A_WG_BYTES);
                uint32_t a[4][4];
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                    ldmatrix_x4(a[kk], a_base + sw128_offset(lrow, 2 * kk + lchunk));
                    const int k = (t * KSUB + u) * TILE_K + 16 * kk + 2 * tq;
                    const uint32_t s_lo = fin_pair(f_in, k, K);
                    const uint32_t s_hi = fin_pair(f_in, k + 8, K);
                    a[kk][0] = mul_bf16x2(a[kk][0], s_lo);
                    a[kk][1] = mul_bf16x2(a[kk][1], s_lo);
                    a[kk][2] = mul_bf16x2(a[kk][2], s_hi);
                    a[kk][3] = mul_bf16x2(a[kk][3], s_hi);
                }
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64(acc_sg, a[kk], dsg + 2 * kk);
            }
        }
        wgmma_commit();
        wgmma_wait<1>();  // the group of tile t - 1 has retired: release its stage
        if (t > 0 && lane == 0) mbar_arrive(&empty[(t - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc_mu);
    fence_regs(acc_sg);

#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int m = m0 + wg * 64 + 16 * w + g + 8 * h;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                const int n = n0 + 8 * j + 2 * tq + c;
                if (m >= M || n >= N) continue;
                float v = acc_mu[4 * j + 2 * h + c];
                float b = b_mu[n];
                if (noisy) {
                    const float fo = f_out[n];
                    v = v + acc_sg[4 * j + 2 * h + c] * fo;
                    b = b + b_sigma[n] * fo;
                }
                v = v + b;
                if (relu) v = fmaxf(v, 0.f);
                y[(size_t)m * N + n] = v;
            }
        }
    }
}

// ------------------------------------------------------------ narrow path
constexpr int NARROW_ROWS = 16;
constexpr int NARROW_WARPS = 8;
constexpr int NARROW_BATCH = 4;  // k16 steps a warp loads before it multiplies

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 at (row, k) of a row-major [rows, K] matrix; 0 outside it
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p, int row, int rows, int k, int K) {
    if (row >= rows || k >= K) return 0u;
    return __ldg(reinterpret_cast<const unsigned int*>(p + (size_t)row * K + k));
}

template <int NC>  // n8 column blocks: N <= 8 * NC
__global__ void __launch_bounds__(NARROW_WARPS * 32) k3_narrow_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w_mu,
    const __nv_bfloat16* __restrict__ w_sigma, const float* __restrict__ b_mu,
    const float* __restrict__ b_sigma, const float* __restrict__ f_in,
    const float* __restrict__ f_out, float* __restrict__ y, int M, int N, int K, int relu) {
    constexpr int W = 8 * NC;
    __shared__ float red[2][NARROW_WARPS][NARROW_ROWS][W + 1];
    const bool noisy = w_sigma != nullptr;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int tq = lane % 4;
    const int m0 = blockIdx.x * NARROW_ROWS;
    float acc_mu[NC][4], acc_sg[NC][4];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc_mu[c][i] = acc_sg[c][i] = 0.f;

    // warp w takes k16 steps w, w + 8, ...; BATCH of them at a time, every
    // load issued before the first mma so their latencies overlap (a step
    // past K loads zeros)
    const int ksteps = (K + 15) / 16;
    for (int base = warp; base < ksteps; base += NARROW_WARPS * NARROW_BATCH) {
        uint32_t a[NARROW_BATCH][4], bm[NARROW_BATCH][NC][2], bs[NARROW_BATCH][NC][2];
#pragma unroll
        for (int i = 0; i < NARROW_BATCH; ++i) {
            const int k = (base + i * NARROW_WARPS) * 16 + 2 * tq;
            a[i][0] = ld_pair(x, m0 + g, M, k, K);
            a[i][1] = ld_pair(x, m0 + g + 8, M, k, K);
            a[i][2] = ld_pair(x, m0 + g, M, k + 8, K);
            a[i][3] = ld_pair(x, m0 + g + 8, M, k + 8, K);
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                bm[i][c][0] = ld_pair(w_mu, 8 * c + g, N, k, K);
                bm[i][c][1] = ld_pair(w_mu, 8 * c + g, N, k + 8, K);
                if (noisy) {
                    bs[i][c][0] = ld_pair(w_sigma, 8 * c + g, N, k, K);
                    bs[i][c][1] = ld_pair(w_sigma, 8 * c + g, N, k + 8, K);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < NARROW_BATCH; ++i) {
#pragma unroll
            for (int c = 0; c < NC; ++c) mma_bf16_16816(acc_mu[c], a[i], bm[i][c][0], bm[i][c][1]);
            if (noisy) {
                const int k = (base + i * NARROW_WARPS) * 16 + 2 * tq;
                const uint32_t s_lo = fin_pair(f_in, k, K);
                const uint32_t s_hi = fin_pair(f_in, k + 8, K);
                const uint32_t as[4] = {mul_bf16x2(a[i][0], s_lo), mul_bf16x2(a[i][1], s_lo),
                                        mul_bf16x2(a[i][2], s_hi), mul_bf16x2(a[i][3], s_hi)};
#pragma unroll
                for (int c = 0; c < NC; ++c)
                    mma_bf16_16816(acc_sg[c], as, bs[i][c][0], bs[i][c][1]);
            }
        }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
        const int col = 8 * c + 2 * tq;
        red[0][warp][g][col] = acc_mu[c][0];
        red[0][warp][g][col + 1] = acc_mu[c][1];
        red[0][warp][g + 8][col] = acc_mu[c][2];
        red[0][warp][g + 8][col + 1] = acc_mu[c][3];
        red[1][warp][g][col] = acc_sg[c][0];
        red[1][warp][g][col + 1] = acc_sg[c][1];
        red[1][warp][g + 8][col] = acc_sg[c][2];
        red[1][warp][g + 8][col + 1] = acc_sg[c][3];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < NARROW_ROWS * W; i += NARROW_WARPS * 32) {
        const int r = i / W;
        const int n = i % W;
        const int m = m0 + r;
        if (m >= M || n >= N) continue;
        float v = red[0][0][r][n];
        float vs = red[1][0][r][n];
#pragma unroll
        for (int q = 1; q < NARROW_WARPS; ++q) {  // warp order: the same sums on every run
            v = v + red[0][q][r][n];
            vs = vs + red[1][q][r][n];
        }
        float b = b_mu[n];
        if (noisy) {
            const float fo = f_out[n];
            v = v + vs * fo;
            b = b + b_sigma[n] * fo;
        }
        v = v + b;
        if (relu) v = fmaxf(v, 0.f);
        y[(size_t)m * N + n] = v;
    }
}

template <int NWG>
int launch_wide(const void* x, const void* w_mu, const void* w_sigma, const void* b_mu,
                const void* b_sigma, const void* f_in, const void* f_out, void* y, int M, int N,
                int K, int relu, cudaStream_t stream) {
    using C = Wide<NWG>;
    static bool smem_opted_in = false;  // once, before any graph capture
    if (!smem_opted_in) {
        const cudaError_t err = cudaFuncSetAttribute(
            k3_wide_kernel<NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
        if (err != cudaSuccess) return (int)err;
        smem_opted_in = true;
    }
    const bool noisy = w_sigma != nullptr;
    CUtensorMap mx, mw, ms;
    if (!make_map(&mx, x, M, K, K, 64 * NWG) || !make_map(&mw, w_mu, N, K, K, BN) ||
        (noisy && !make_map(&ms, w_sigma, N, K, K, BN)))
        return (int)cudaErrorInvalidValue;
    if (!noisy) ms = mw;  // never read
    const dim3 grid((N + BN - 1) / BN, (M + 64 * NWG - 1) / (64 * NWG));
    k3_wide_kernel<NWG><<<grid, C::THREADS, C::SMEM, stream>>>(
        mx, mw, ms, static_cast<const float*>(b_mu), static_cast<const float*>(b_sigma),
        static_cast<const float*>(f_in), static_cast<const float*>(f_out), static_cast<float*>(y),
        M, N, K, noisy ? 1 : 0, relu);
    return (int)cudaGetLastError();
}

template <int NC>
int launch_narrow(const void* x, const void* w_mu, const void* w_sigma, const void* b_mu,
                  const void* b_sigma, const void* f_in, const void* f_out, void* y, int M, int N,
                  int K, int relu, cudaStream_t stream) {
    const dim3 grid((M + NARROW_ROWS - 1) / NARROW_ROWS);
    k3_narrow_kernel<NC><<<grid, NARROW_WARPS * 32, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w_mu),
        static_cast<const __nv_bfloat16*>(w_sigma), static_cast<const float*>(b_mu),
        static_cast<const float*>(b_sigma), static_cast<const float*>(f_in),
        static_cast<const float*>(f_out), static_cast<float*>(y), M, N, K, relu);
    return (int)cudaGetLastError();
}

}  // namespace

// nwg: 0 = the narrow path (N <= 32), else the consumer warpgroups of a wide
// tile of (64 nwg) x 64 (1 or 2), as kernels/noisy_linear.py's plan gives it.
PORT_API int port_noisy_linear(const void* x, const void* w_mu, const void* w_sigma,
                               const void* b_mu, const void* b_sigma, const void* f_in,
                               const void* f_out, void* y, int M, int N, int K, int relu, int nwg,
                               void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (M <= 0 || N <= 0 || K <= 0 || K % 8) return (int)cudaErrorInvalidValue;
    if (nwg == 0) {
        switch ((N + 7) / 8) {
            case 1: return launch_narrow<1>(x, w_mu, w_sigma, b_mu, b_sigma, f_in, f_out, y, M, N, K, relu, s);
            case 2: return launch_narrow<2>(x, w_mu, w_sigma, b_mu, b_sigma, f_in, f_out, y, M, N, K, relu, s);
            case 3: return launch_narrow<3>(x, w_mu, w_sigma, b_mu, b_sigma, f_in, f_out, y, M, N, K, relu, s);
            case 4: return launch_narrow<4>(x, w_mu, w_sigma, b_mu, b_sigma, f_in, f_out, y, M, N, K, relu, s);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    if (nwg == 1) return launch_wide<1>(x, w_mu, w_sigma, b_mu, b_sigma, f_in, f_out, y, M, N, K, relu, s);
    if (nwg == 2) return launch_wide<2>(x, w_mu, w_sigma, b_mu, b_sigma, f_in, f_out, y, M, N, K, relu, s);
    return (int)cudaErrorInvalidValue;
}
