// K10g: the weight-only quantized NoisyLinear GEMM, int8 and e4m3 weights.
//
//   W = bf16(fp32(q_W) * s_W[n])        per output row n (one s in fp8 mode)
//   b = fp32(q_b) * s_b                 one scale per bias
//   greedy: y = x @ W_mu^T + b_mu
//   noisy:  y = x @ W_mu^T + (bf16(x * bf16(f_in)) @ W_sigma^T) * f_out + (b_mu + b_sigma * f_out)
//   then ReLU when asked (NaN stays NaN, as jax.nn.relu keeps it).
//
// Replaces the quantized act path of rainbow_iqn_apex_tpu/utils/quantize.py
// (dequantize_tree_jax :219-236 under wrap_act_quantized :239-247) fused
// into models/layers.py NoisyLinear.__call__ (:71-91), which XLA compiles
// into one executable: the weights the JAX dot sees are bf16(fp32(q) * s),
// so this kernel forms exactly that value from the bytes (byte -> exact fp32
// -> one fp32 product with the row's scale -> cvt.rn to bf16) and then
// computes what K3 (noisy_linear.cu) computes.  The activations stay bf16 (an
// fp8 x fp8 or s8 x s8 product would quantize them too: another function).
//
// Bound on the H100: the products of K3 (6.6 GFLOP per serving hidden layer
// at M 2048, ~6.7 us of bf16 tensor-core time; 1.7 GFLOP a product at the act
// tick's M 512) with one byte a weight read: operation-bound for the hidden
// layers; the *_out layers (N 1, 18) are bound by x's bytes and the launch.
//
// Design, wide layers (N > 32): the operands are swapped, y^T = W x^T, so
// the weight is wgmma's register operand and never goes through shared
// memory as bf16.  A block owns 128 weight rows by BT tokens (greedy 128,
// noisy 64) and a contiguous range of 128-deep k tiles:
//   - one producer thread keeps a ring of TMA loads in flight (greedy 4
//     stages, noisy 3), each stage two 64-wide SW128 boxes of x [BT rows]
//     and the raw [128 n x 128 k] byte box of q_W_mu (and q_W_sigma), also
//     128-byte swizzled, on one mbarrier;
//   - two consumer warpgroups of 64 weight rows each read their A fragments'
//     bytes from the raw box (ld.shared.u16; the swizzle keeps the 8 rows of
//     a warp on distinct banks), form bf16(fp32(q) * s) in registers (int8
//     through the exact 2^23 + b float trick: a byte permute and a
//     subtraction, no I2F; e4m3 through cvt.rn.f16x2.e4m3x2) and run
//     wgmma.m64nBTk16 with x from a descriptor, half a stage (64 k) per
//     commit group, the next half converted while one is in flight;
//   - noisy: each warpgroup writes bf16(x * bf16(f_in)) for the stage into
//     its own double-buffered SW128 tile (the x tile's layout, chunk for
//     chunk), the B operand of the W_sigma product.
// A stage is released when the groups that read it retire.  Where the tiles
// alone would leave the card idle (the act tick, serving's smaller buckets)
// the k range is split in order over a thread-block cluster of S <= 8 blocks
// (kernels/noisy_linear_q.py's forward_plan, sized by the cluster occupancy
// query so that every cluster runs at once): each block leaves its fp32
// partial tile in its shared memory, and rank r sums the tiles of the
// consumer warps w with w % S == r over ranks 0 .. S-1 in rank order through
// distributed shared memory, then writes them.  So one launch computes the
// layer, every sum in a fixed order: a repeat is bit-equal.
// What holds it back: converting the weights (a byte load, decode, product
// and rounding per pair) on the consumers' own issue slots, which the
// tensor cores wait on (an instrumented copy showed the products waiting on
// conversion, not the reverse); each tile of tokens converts its weights
// again.  Tried and slower (PERF.md §6): converter warps writing bf16 tiles
// for K3's consumers (shared-memory traffic), 256-token greedy tiles
// (register spills, two stages), the split summed by rank 0 alone or by
// slices of each thread's accumulators (their remote loads serialized).
//
// Design, narrow layers (N <= 32): K3's narrow kernel (mma.sync m16n8k16, a
// block of 8 warps per 16 rows, fragments straight from device memory), with
// each B fragment built in registers from two bytes of q and the row's scale.
#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace hopper;

constexpr int BW = 128;               // weight rows (output columns) of a wide tile
constexpr int KT = 128;               // k per stage: one raw box, two bf16 x boxes
constexpr int CONS_THREADS = 256;     // two consumer warpgroups, 64 weight rows each
constexpr int THREADS = CONS_THREADS + 32;  // consumers, then the producer warp
constexpr int MAX_SPLITS = 8;         // a portable cluster
constexpr int RAW_BOX = BW * KT;      // [128 n x 128 k] bytes: 16 KB

// A tile is 128 weight rows by BT tokens: greedy 128 (m64n128 products, each
// converted weight serving 128 tokens), noisy 64, as two products and x * f_in
// take the registers and shared memory of the other 64.
template <bool NOISY>
struct Wide {
    static constexpr int BT = NOISY ? 64 : 128;   // tokens (x rows) of a tile: the wgmma N
    static constexpr int STAGES = NOISY ? 3 : 4;
    static constexpr int ACC = BT / 2;            // fp32 accumulators a thread holds a product
    static constexpr int MATS = NOISY ? 2 : 1;
    static constexpr int X_BOX = BT * ROW_BYTES;  // one 64-wide k box of x
    static constexpr int STAGE = 2 * X_BOX + MATS * RAW_BOX;  // x boxes, raw q_mu, raw q_sigma
    static constexpr int XE_AT = STAGES * STAGE;  // noisy: per warpgroup, 2 slots of x * f_in
    static constexpr int XE_SLOT = 2 * X_BOX;
    static constexpr int BAR_AT = XE_AT + (NOISY ? 2 * 2 * XE_SLOT : 0);
    static constexpr int SMEM = 1024 + BAR_AT + 2 * STAGES * 8;
    static_assert(MATS * ACC * CONS_THREADS * 4 <= XE_AT, "the partial tile reuses the ring");
    static_assert(SMEM <= 232448, "shared memory");
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
    return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// bytes (q[k], q[k + 1]) -> bf16(fp32(q) * s) for both, as one bf16x2.
// int8: the float with bits 0x4B0000uu is 2^23 + uu exactly, and uu = q + 128
// after flipping the sign bit, so subtracting 2^23 + 128 gives fp32(q)
// exactly (a byte permute and a subtraction, no I2F); e4m3 decodes exactly
// into f16 (cvt.rn.f16x2.e4m3x2), then fp32.
template <bool FP8>
__device__ __forceinline__ uint32_t dequant2(uint32_t v, float s) {
    float lo, hi;
    if constexpr (FP8) {
        const float2 f = __half22float2(
            __half2(__nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)v, __NV_E4M3)));
        lo = f.x;
        hi = f.y;
    } else {
        const uint32_t u = v ^ 0x8080u;
        lo = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u)), 8388736.f);
        hi = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441u)), 8388736.f);
    }
    return pack_bf16x2(__fmul_rn(lo, s), __fmul_rn(hi, s));
}

// bf16(f_in[k]), bf16(f_in[k + 1]) as one bf16x2 (0 past K; k is even)
__device__ __forceinline__ uint32_t fin_pair(const float* f_in, int k, int K) {
    if (k >= K) return 0u;
    return pack_bf16x2(__ldg(f_in + k), __ldg(f_in + k + 1));
}

template <bool FP8>
__device__ __forceinline__ float bias(const uint8_t* q, const float* s, int n) {
    if constexpr (FP8) return __fmul_rn(__half2float(__half(__nv_cvt_fp8_to_halfraw(q[n], __NV_E4M3))), s[0]);
    return __fmul_rn((float)(int8_t)q[n], s[0]);
}

// y = acc_mu + acc_sg * f_out + bias, ReLU that keeps NaN
template <bool FP8, bool NOISY>
__device__ __forceinline__ float epilogue(float mu, float sg, int n, const uint8_t* qb_mu,
                                          const float* sb_mu, const uint8_t* qb_sg,
                                          const float* sb_sg, const float* f_out, int relu) {
    float v = mu;
    float b = bias<FP8>(qb_mu, sb_mu, n);
    if constexpr (NOISY) {
        const float fo = f_out[n];
        v = v + sg * fo;
        b = b + bias<FP8>(qb_sg, sb_sg, n) * fo;
    }
    v = v + b;
    return relu && v < 0.f ? 0.f : v;
}

// Keep a half tile's A fragments allocated until the wgmma group that reads
// them has retired: each register becomes an operand of an empty asm placed
// after that group's wait, so nothing else is written into it meanwhile.
__device__ __forceinline__ void keep_frags(uint32_t (&a)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// The A fragments of k16 step q of a stage for this thread's weight rows r
// and r + 8 (raw box, 128-byte swizzled: chunk q of row r at q ^ (r % 8),
// which is g for both rows): a[0] (row r, k 2tq..+1), a[1] (row r + 8),
// a[2] (row r, k + 8), a[3] (row r + 8, k + 8).
template <bool FP8>
__device__ __forceinline__ void weight_frag(uint32_t (&a)[4], const uint8_t* raw, int r, int g,
                                            int tq, int q, float s_lo, float s_hi) {
    const uint8_t* p = raw + r * ROW_BYTES + ((q ^ g) << 4) + 2 * tq;
    const uint16_t* lo = reinterpret_cast<const uint16_t*>(p);
    const uint16_t* hi = reinterpret_cast<const uint16_t*>(p + 8 * ROW_BYTES);
    a[0] = dequant2<FP8>(lo[0], s_lo);
    a[1] = dequant2<FP8>(hi[0], s_hi);
    a[2] = dequant2<FP8>(lo[4], s_lo);
    a[3] = dequant2<FP8>(hi[4], s_hi);
}

template <bool FP8, bool NOISY>
__global__ void __launch_bounds__(THREADS, 1) k10g_wide_kernel(
    const __grid_constant__ CUtensorMap map_x,    // x [M, K] bf16, boxes 64 k x BT rows, SW128
    const __grid_constant__ CUtensorMap map_qmu,  // q_W_mu [N, K] bytes, boxes 128 k x 128 rows, SW128
    const __grid_constant__ CUtensorMap map_qsg,  // q_W_sigma (noisy)
    const float* __restrict__ sw_mu, const uint8_t* __restrict__ qb_mu,
    const float* __restrict__ sb_mu, const float* __restrict__ sw_sg,
    const uint8_t* __restrict__ qb_sg, const float* __restrict__ sb_sg,
    const float* __restrict__ f_in, const float* __restrict__ f_out, float* __restrict__ y,
    int M, int N, int K, int relu, int s_stride) {
    using C = Wide<NOISY>;
    constexpr int STAGES = C::STAGES, ACC = C::ACC, X_BOX = C::X_BOX;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = align1024(smem_raw);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR_AT);
    uint64_t* empty = full + STAGES;
    cg::cluster_group cluster = cg::this_cluster();
    const int splits = (int)gridDim.x;  // the cluster: one k range each
    const int rank = (int)blockIdx.x;
    const int n0 = blockIdx.y * BW;
    const int m0 = blockIdx.z * C::BT;
    const int ktiles = (K + KT - 1) / KT;
    const int t_begin = rank * ktiles / splits;
    const int nt = (rank + 1) * ktiles / splits - t_begin;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int wg = warp / 4;  // consumers: weight rows 64 wg .. 64 wg + 63
    const int w = warp % 4;
    const int g = lane / 4;
    const int tq = lane % 4;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], CONS_THREADS / 32);  // lane 0 of every consumer warp
        }
        mbar_init_fence();
    }
    __syncthreads();

    float acc_mu[ACC], acc_sg[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc_mu[i] = acc_sg[i] = 0.f;
    const bool consumer = threadIdx.x < CONS_THREADS;

    if (!consumer) {  // ------------------------------------------------ producer
        if (lane == 0) {
            for (int i = 0; i < nt; ++i) {
                const int s = i % STAGES;
                if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
                uint8_t* st = smem + s * C::STAGE;
                const int k = (t_begin + i) * KT;
                mbar_expect_tx(&full[s], C::STAGE);
                tma_load_2d(st, &map_x, &full[s], k, m0);
                tma_load_2d(st + X_BOX, &map_x, &full[s], k + TILE_K, m0);
                tma_load_2d(st + 2 * X_BOX, &map_qmu, &full[s], k, n0);
                if constexpr (NOISY)
                    tma_load_2d(st + 2 * X_BOX + RAW_BOX, &map_qsg, &full[s], k, n0);
            }
        }
        __syncwarp();  // the warp meets again before the block-wide barriers below
    } else {  // ------------------------------------------------------ consumers
        // this thread's weight rows within the tile, and their scales
        const int r = wg * 64 + 16 * w + g;
        float s_mu[2], s_sg[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int n = n0 + r + 8 * h;
            s_mu[h] = n < N ? sw_mu[(size_t)n * s_stride] : 0.f;
            s_sg[h] = NOISY && n < N ? sw_sg[(size_t)n * s_stride] : 0.f;
        }
        // noisy: this thread's 16-byte chunks of x * f_in, as the x boxes hold
        // them (rows wt / 8 + 16 j, physical chunk wt % 8; logical chunk lc)
        const int wt = threadIdx.x % 128;
        const int lc = (wt % 8) ^ ((wt / 8) & 7);
        uint8_t* xe = smem + C::XE_AT + wg * 2 * C::XE_SLOT;
        // A fragments of two half tiles (4 k16 steps each) in flight: group q
        // reads buffer q % 2, rewritten only after group q - 2 has retired
        uint32_t a_mu[2][4][4], a_sg[2][4][4];
        for (int i = 0; i < nt; ++i) {
            const int s = i % STAGES;
            mbar_wait(&full[s], (i / STAGES) & 1);
            const uint8_t* st = smem + s * C::STAGE;
            const uint8_t* raw_mu = st + 2 * X_BOX;
            const uint8_t* raw_sg = raw_mu + RAW_BOX;
            uint8_t* xe_slot = xe + (i % 2) * C::XE_SLOT;
            if constexpr (NOISY) {
                // slot i % 2 was last read by tile i - 2's groups, retired
                // (the wait below) in all four warps of this warpgroup
                bar_sync(1 + wg, 128);
#pragma unroll
                for (int b = 0; b < 2; ++b) {
                    const int k = (t_begin + i) * KT + b * TILE_K + 8 * lc;
                    uint32_t f[4];
#pragma unroll
                    for (int e = 0; e < 4; ++e) f[e] = fin_pair(f_in, k + 2 * e, K);
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int off = b * X_BOX + (wt / 8 + 16 * j) * ROW_BYTES + (wt % 8) * 16;
                        uint4 v = *reinterpret_cast<const uint4*>(st + off);
                        v.x = mul_bf16x2(v.x, f[0]);
                        v.y = mul_bf16x2(v.y, f[1]);
                        v.z = mul_bf16x2(v.z, f[2]);
                        v.w = mul_bf16x2(v.w, f[3]);
                        *reinterpret_cast<uint4*>(xe_slot + off) = v;
                    }
                }
                fence_proxy_async();  // x * f_in is a wgmma operand
                bar_sync(1 + wg, 128);
            }
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {  // the stage's two 64-deep halves
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                    weight_frag<FP8>(a_mu[hf][kk], raw_mu, r, g, tq, 4 * hf + kk, s_mu[0],
                                     s_mu[1]);
                    if constexpr (NOISY)
                        weight_frag<FP8>(a_sg[hf][kk], raw_sg, r, g, tq, 4 * hf + kk, s_sg[0],
                                         s_sg[1]);
                }
                const uint64_t dx = desc_sw128(st + hf * X_BOX);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) wgmma_rs<C::BT>(acc_mu, a_mu[hf][kk], dx + 2 * kk);
                if constexpr (NOISY) {
                    const uint64_t dxe = desc_sw128(xe_slot + hf * X_BOX);
#pragma unroll
                    for (int kk = 0; kk < 4; ++kk) wgmma_rs<C::BT>(acc_sg, a_sg[hf][kk], dxe + 2 * kk);
                }
                wgmma_commit();
                wgmma_wait<1>();  // the previous half's group has retired: its buffer is free
                keep_frags(a_mu[1 - hf]);
                if constexpr (NOISY) keep_frags(a_sg[1 - hf]);
                // after the first half's wait, tile i - 1 has retired: release its stage
                if (hf == 0 && i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % STAGES]);
            }
        }
        wgmma_wait<0>();
        fence_regs(acc_mu);
        if constexpr (NOISY) fence_regs(acc_sg);
    }

    // ----------- the split's in-order sum: each rank takes whole consumer warps
    if (splits > 1) {
        __syncthreads();  // every tile consumed: the ring is free for the partial tile
        float* part = reinterpret_cast<float*>(smem);
        if (consumer) {
#pragma unroll
            for (int e = 0; e < ACC; ++e) {
                part[e * CONS_THREADS + threadIdx.x] = acc_mu[e];
                if constexpr (NOISY) part[(ACC + e) * CONS_THREADS + threadIdx.x] = acc_sg[e];
            }
        }
        cluster.sync();  // the partials are written
        const bool mine = consumer && warp % splits == rank;
        if (mine) {  // this warp's sums, over the ranks in order: the same sums every run
            for (int q = 0; q < splits; ++q) {
                const float* peer = cluster.map_shared_rank(part, q);
                float v_mu[ACC], v_sg[ACC];
#pragma unroll
                for (int e = 0; e < ACC; ++e) {
                    v_mu[e] = peer[e * CONS_THREADS + threadIdx.x];
                    if constexpr (NOISY) v_sg[e] = peer[(ACC + e) * CONS_THREADS + threadIdx.x];
                }
#pragma unroll
                for (int e = 0; e < ACC; ++e) {
                    acc_mu[e] = q == 0 ? v_mu[e] : acc_mu[e] + v_mu[e];
                    if constexpr (NOISY) acc_sg[e] = q == 0 ? v_sg[e] : acc_sg[e] + v_sg[e];
                }
            }
        }
        cluster.sync();  // every rank has read its peers: they may exit
        if (!mine) return;
    }
    if (!consumer) return;

    // accumulator e = 4 j + 2 h + c: weight row r (+ 8 h), token 8 j + 2 tq + c
#pragma unroll
    for (int e = 0; e < ACC; ++e) {
        const int j = e / 4, h = (e / 2) % 2, c = e % 2;
        const int n = n0 + wg * 64 + 16 * w + g + 8 * h;
        const int m = m0 + 8 * j + 2 * tq + c;
        if (m >= M || n >= N) continue;
        y[(size_t)m * N + n] =
            epilogue<FP8, NOISY>(acc_mu[e], acc_sg[e], n, qb_mu, sb_mu, qb_sg, sb_sg, f_out, relu);
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

// two bytes of q at (row, k) (k even); 0 outside the matrix
__device__ __forceinline__ uint32_t ld_q2(const uint8_t* q, int row, int rows, int k, int K) {
    if (row >= rows || k >= K) return 0u;
    return __ldg(reinterpret_cast<const unsigned short*>(q + (size_t)row * K + k));
}

template <int NC, bool FP8>  // n8 column blocks: N <= 8 * NC
__global__ void __launch_bounds__(NARROW_WARPS * 32) k10g_narrow_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ qw_mu,
    const float* __restrict__ sw_mu, const uint8_t* __restrict__ qb_mu,
    const float* __restrict__ sb_mu, const uint8_t* __restrict__ qw_sg,
    const float* __restrict__ sw_sg, const uint8_t* __restrict__ qb_sg,
    const float* __restrict__ sb_sg, const float* __restrict__ f_in,
    const float* __restrict__ f_out, float* __restrict__ y, int M, int N, int K, int relu,
    int s_stride) {
    constexpr int W = 8 * NC;
    __shared__ float red[2][NARROW_WARPS][NARROW_ROWS][W + 1];
    const bool noisy = qw_sg != nullptr;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int tq = lane % 4;
    const int m0 = blockIdx.x * NARROW_ROWS;
    float acc_mu[NC][4], acc_sg[NC][4];
    float s_mu[NC], s_sg[NC];  // the scales of this lane's B rows n = 8c + g
#pragma unroll
    for (int c = 0; c < NC; ++c) {
        const int n = 8 * c + g;
        s_mu[c] = n < N ? sw_mu[(size_t)n * s_stride] : 0.f;
        s_sg[c] = noisy && n < N ? sw_sg[(size_t)n * s_stride] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc_mu[c][i] = acc_sg[c][i] = 0.f;
    }

    // warp w takes k16 steps w, w + 8, ...; BATCH of them at a time, every
    // load issued before the first mma (a step past K loads zeros)
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
                bm[i][c][0] = ld_q2(qw_mu, 8 * c + g, N, k, K);
                bm[i][c][1] = ld_q2(qw_mu, 8 * c + g, N, k + 8, K);
                if (noisy) {
                    bs[i][c][0] = ld_q2(qw_sg, 8 * c + g, N, k, K);
                    bs[i][c][1] = ld_q2(qw_sg, 8 * c + g, N, k + 8, K);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < NARROW_BATCH; ++i) {
#pragma unroll
            for (int c = 0; c < NC; ++c)
                mma_bf16_16816(acc_mu[c], a[i], dequant2<FP8>(bm[i][c][0], s_mu[c]),
                               dequant2<FP8>(bm[i][c][1], s_mu[c]));
            if (noisy) {
                const int k = (base + i * NARROW_WARPS) * 16 + 2 * tq;
                const uint32_t s_lo = fin_pair(f_in, k, K);
                const uint32_t s_hi = fin_pair(f_in, k + 8, K);
                const uint32_t as[4] = {mul_bf16x2(a[i][0], s_lo), mul_bf16x2(a[i][1], s_lo),
                                        mul_bf16x2(a[i][2], s_hi), mul_bf16x2(a[i][3], s_hi)};
#pragma unroll
                for (int c = 0; c < NC; ++c)
                    mma_bf16_16816(acc_sg[c], as, dequant2<FP8>(bs[i][c][0], s_sg[c]),
                                   dequant2<FP8>(bs[i][c][1], s_sg[c]));
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
        y[(size_t)m * N + n] = noisy
            ? epilogue<FP8, true>(v, vs, n, qb_mu, sb_mu, qb_sg, sb_sg, f_out, relu)
            : epilogue<FP8, false>(v, vs, n, qb_mu, sb_mu, qb_sg, sb_sg, f_out, relu);
    }
}

template <bool NOISY>
cudaLaunchConfig_t wide_config(int splits, int N, int M, cudaLaunchAttribute* attr,
                               cudaStream_t stream) {
    using C = Wide<NOISY>;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(splits, (N + BW - 1) / BW, (M + C::BT - 1) / C::BT);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = C::SMEM;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

template <bool FP8, bool NOISY>
cudaError_t opt_in() {
    static bool done = false;  // once, before any graph capture
    if (done) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        k10g_wide_kernel<FP8, NOISY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Wide<NOISY>::SMEM);
    if (err == cudaSuccess) done = true;
    return err;
}

template <bool FP8, bool NOISY>
int launch_wide(const void* x, const void* qw_mu, const void* sw_mu, const void* qb_mu,
                const void* sb_mu, const void* qw_sg, const void* sw_sg, const void* qb_sg,
                const void* sb_sg, const void* f_in, const void* f_out, void* y, int M, int N,
                int K, int relu, int s_stride, int splits, cudaStream_t stream) {
    using C = Wide<NOISY>;
    auto kernel = k10g_wide_kernel<FP8, NOISY>;
    cudaError_t err = opt_in<FP8, NOISY>();
    if (err != cudaSuccess) return (int)err;
    CUtensorMap mx, mmu, msg;
    if (!make_map(&mx, x, M, K, K, C::BT) || !make_map_u8(&mmu, qw_mu, N, K, K, BW) ||
        (NOISY && !make_map_u8(&msg, qw_sg, N, K, K, BW)))
        return (int)cudaErrorInvalidValue;
    if (!NOISY) msg = mmu;  // never read
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = wide_config<NOISY>(splits, N, M, attr, stream);
    void* args[] = {&mx, &mmu, &msg, &sw_mu, &qb_mu, &sb_mu, &sw_sg, &qb_sg, &sb_sg, &f_in,
                    &f_out, &y, &M, &N, &K, &relu, &s_stride};
    err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

template <int NC, bool FP8>
int launch_narrow(const void* x, const void* qw_mu, const void* sw_mu, const void* qb_mu,
                  const void* sb_mu, const void* qw_sg, const void* sw_sg, const void* qb_sg,
                  const void* sb_sg, const void* f_in, const void* f_out, void* y, int M, int N,
                  int K, int relu, int s_stride, cudaStream_t stream) {
    const dim3 grid((M + NARROW_ROWS - 1) / NARROW_ROWS);
    k10g_narrow_kernel<NC, FP8><<<grid, NARROW_WARPS * 32, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(qw_mu),
        static_cast<const float*>(sw_mu), static_cast<const uint8_t*>(qb_mu),
        static_cast<const float*>(sb_mu), static_cast<const uint8_t*>(qw_sg),
        static_cast<const float*>(sw_sg), static_cast<const uint8_t*>(qb_sg),
        static_cast<const float*>(sb_sg), static_cast<const float*>(f_in),
        static_cast<const float*>(f_out), static_cast<float*>(y), M, N, K, relu, s_stride);
    return (int)cudaGetLastError();
}

template <bool FP8>
int launch(const void* x, const void* qw_mu, const void* sw_mu, const void* qb_mu,
           const void* sb_mu, const void* qw_sg, const void* sw_sg, const void* qb_sg,
           const void* sb_sg, const void* f_in, const void* f_out, void* y, int M, int N, int K,
           int relu, int s_stride, int splits, cudaStream_t s) {
    if (splits == 0) {
        switch ((N + 7) / 8) {
            case 1: return launch_narrow<1, FP8>(x, qw_mu, sw_mu, qb_mu, sb_mu, qw_sg, sw_sg, qb_sg, sb_sg, f_in, f_out, y, M, N, K, relu, s_stride, s);
            case 2: return launch_narrow<2, FP8>(x, qw_mu, sw_mu, qb_mu, sb_mu, qw_sg, sw_sg, qb_sg, sb_sg, f_in, f_out, y, M, N, K, relu, s_stride, s);
            case 3: return launch_narrow<3, FP8>(x, qw_mu, sw_mu, qb_mu, sb_mu, qw_sg, sw_sg, qb_sg, sb_sg, f_in, f_out, y, M, N, K, relu, s_stride, s);
            case 4: return launch_narrow<4, FP8>(x, qw_mu, sw_mu, qb_mu, sb_mu, qw_sg, sw_sg, qb_sg, sb_sg, f_in, f_out, y, M, N, K, relu, s_stride, s);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    if (qw_sg != nullptr)
        return launch_wide<FP8, true>(x, qw_mu, sw_mu, qb_mu, sb_mu, qw_sg, sw_sg, qb_sg, sb_sg, f_in, f_out, y, M, N, K, relu, s_stride, splits, s);
    return launch_wide<FP8, false>(x, qw_mu, sw_mu, qb_mu, sb_mu, qw_sg, sw_sg, qb_sg, sb_sg, f_in, f_out, y, M, N, K, relu, s_stride, splits, s);
}

template <bool NOISY>
int max_clusters(int splits) {
    const cudaError_t err = opt_in<false, NOISY>();
    if (err != cudaSuccess) {
        cudaGetLastError();
        return 0;
    }
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = wide_config<NOISY>(splits, BW, 1, attr, nullptr);
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, k10g_wide_kernel<false, NOISY>, &cfg) !=
        cudaSuccess) {
        cudaGetLastError();  // the query's error is not a launch's
        return 0;
    }
    return n;
}

}  // namespace

// How many clusters of `splits` wide blocks (noisy or greedy: their tiles
// and shared memory differ) the card holds at once; 0 where the runtime
// cannot say.
PORT_API int port_noisy_linear_q_max_clusters(int splits, int noisy) {
    if (splits < 1 || splits > MAX_SPLITS) return 0;
    return noisy ? max_clusters<true>(splits) : max_clusters<false>(splits);
}

// splits: 0 = the narrow path (N <= 32), else the blocks of one cluster that
// split the k range of a wide tile (1 .. 8), as kernels/noisy_linear_q.py's
// forward_plan gives it.
PORT_API int port_noisy_linear_q(const void* x, const void* qw_mu, const void* sw_mu,
                                 const void* qb_mu, const void* sb_mu, const void* qw_sg,
                                 const void* sw_sg, const void* qb_sg, const void* sb_sg,
                                 const void* f_in, const void* f_out, void* y, int M, int N,
                                 int K, int relu, int s_stride, int fp8, int splits,
                                 void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (M <= 0 || N <= 0 || K <= 0 || K % 16 || splits < 0 || splits > MAX_SPLITS ||
        splits > (K + KT - 1) / KT)
        return (int)cudaErrorInvalidValue;
    if (fp8)
        return launch<true>(x, qw_mu, sw_mu, qb_mu, sb_mu, qw_sg, sw_sg, qb_sg, sb_sg, f_in,
                            f_out, y, M, N, K, relu, s_stride, splits, st);
    return launch<false>(x, qw_mu, sw_mu, qb_mu, sb_mu, qw_sg, sw_sg, qb_sg, sb_sg, f_in,
                         f_out, y, M, N, K, relu, s_stride, splits, st);
}
