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
// 2*M*F*C products are < 1 us of tensor-core time.
//
// Design: one wave of blocks (the wrapper's plan, kernels/tau_embed.py:
// forward_plan), block (s, rt) computing the 64 rows of row tile rt against
// the s-th contiguous run of 64-feature tiles.  cosf is costly, and a row
// tile's 64 x C cos features are needed by every block of the row: up to 8
// blocks of one row tile form a thread-block cluster that computes them
// once, each block a slice, written into every block's shared memory through
// distributed shared memory (the first version of this kernel computed them
// in every block: 3.3 M cosf a call, the largest part of its time).  A block is one
// consumer warpgroup and one producer warp:
//   - the producer keeps a 4-stage ring of W_e tiles (64 features x 64 of
//     the cos depth, 128-byte swizzled) in flight by TMA, completing on
//     mbarriers (when num_cosines % 8 != 0, where TMA cannot take W_e's row
//     stride, the warp copies the tile itself);
//   - the consumers hold the cos features (zero past C: the depth is padded
//     to the MMA's 16) as register A fragments, ldmatrix-loaded once, and
//     for each feature tile run wgmma.m64n64k16 against the landed W_e tile;
//   - the epilogue rounds the accumulators to bf16 into a swizzled staging
//     tile (two, alternating), and after one barrier each thread takes 16-byte
//     chunks of it, adds the bias, applies the ReLU and the phi product, and
//     writes 16 bytes, every load of a tile issued before its first product;
//     the next tile's product runs while this is stored.
// No fp32 staging tile (the first design's 33.8 KB one set its occupancy).
//
// With `cos_t` the cluster that covers a row tile's first feature tile also
// writes those cos features, transposed and zero-padded, to cos_t [Cp, Mp]
// (Cp = C rounded up to 16, Mp = M rounded up to 64): K2-bwd reads them by
// TMA instead of recomputing them for each of its feature tiles.
//
// K2g, the game embedding of multi-game runs (rainbow_iqn_apex_tpu/multitask/
// model.py:80-90, phi + E[game] before the merge): with game [B] int32 and
// E [G, F] fp32, the epilogue's phi becomes
//   phi_g[b, f] = bf16( phi[b, f] + bf16(E[game[b], f]) )
// (the rounding of multitask/model.py:89), read beside phi, so the embedding
// adds G*F*4 + B*4 bytes to the read side and no pass of its own.  Null
// game and E pointers are the single-game K2.
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
namespace cg = cooperative_groups;

constexpr int THREADS = 128 + 32;  // one consumer warpgroup, then the producer warp
constexpr int STAGES = 4;
constexpr int BOX = 64 * ROW_BYTES;  // a 64 x 64 bf16 box: 8 KB
constexpr int MAX_BOXES = 2;         // 64-wide boxes of the padded cos depth: C <= 128
constexpr float PI_F = 3.14159265358979323846f;

__host__ __device__ constexpr int smem_bytes(int boxes) {
    // cos tile, W_e ring, two staging tiles, full and empty barriers
    return 1024 + boxes * BOX + STAGES * boxes * BOX + 2 * BOX + 2 * STAGES * 8;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
    return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

// The epilogue of one 64 x 64 unit, from its staged bf16 dense values:
// bias, ReLU and phi product, 16-byte stores.  Thread t takes chunk t % 8 (8
// features, so one bias load serves its four rows) of rows t / 8 + 16 k;
// every load is issued before the first product, so a unit waits for one
// memory latency, not four.
template <bool GAME>
__device__ __forceinline__ void epilogue_unit(
    const uint8_t* stage, int tid, int m0, int f0, const float* __restrict__ bias,
    const __nv_bfloat16* __restrict__ phi, const int* __restrict__ game,
    const float* __restrict__ emb, __nv_bfloat16* __restrict__ out, int M, int F,
    int taus_per_row) {
    const int ch = tid % 8;
    const int f = f0 + 8 * ch;
    if (f >= F) return;
    uint4 dense[4], praw[4];
    float4 e[4][2];
    bool live[4];
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(bias + f));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(bias + f + 4));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int r = tid / 8 + 16 * k;
        const int m = m0 + r;
        live[k] = m < M;
        dense[k] = *reinterpret_cast<const uint4*>(stage + sw128_offset(r, ch));
        if (live[k]) {
            const int b = m / taus_per_row;
            praw[k] = __ldg(reinterpret_cast<const uint4*>(phi + (size_t)b * F + f));
            if (GAME) {
                const float* er = emb + (size_t)__ldg(game + b) * F + f;
                e[k][0] = __ldg(reinterpret_cast<const float4*>(er));
                e[k][1] = __ldg(reinterpret_cast<const float4*>(er + 4));
            }
        }
    }
    const float bs[8] = {port::bf16_round(b0.x), port::bf16_round(b0.y), port::bf16_round(b0.z),
                         port::bf16_round(b0.w), port::bf16_round(b1.x), port::bf16_round(b1.y),
                         port::bf16_round(b1.z), port::bf16_round(b1.w)};
    const __nv_bfloat162 zero2 = __float2bfloat162_rn(0.f);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        if (!live[k]) continue;
        const uint32_t dv[4] = {dense[k].x, dense[k].y, dense[k].z, dense[k].w};
        const uint32_t pv[4] = {praw[k].x, praw[k].y, praw[k].z, praw[k].w};
        float es[8];
        if (GAME) {
            es[0] = e[k][0].x; es[1] = e[k][0].y; es[2] = e[k][0].z; es[3] = e[k][0].w;
            es[4] = e[k][1].x; es[5] = e[k][1].y; es[6] = e[k][1].z; es[7] = e[k][1].w;
        }
        uint32_t o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // two features at a time in bf16x2
            const __nv_bfloat162 pre = __floats2bfloat162_rn(bf16_lo(dv[q]) + bs[2 * q],
                                                             bf16_hi(dv[q]) + bs[2 * q + 1]);
            __nv_bfloat162 p2 = *reinterpret_cast<const __nv_bfloat162*>(&pv[q]);
            if (GAME)
                p2 = __floats2bfloat162_rn(bf16_lo(pv[q]) + port::bf16_round(es[2 * q]),
                                           bf16_hi(pv[q]) + port::bf16_round(es[2 * q + 1]));
            const __nv_bfloat162 h2 = __hmul2(__hmax2(pre, zero2), p2);  // one rounding, as fp32 would
            o[q] = *reinterpret_cast<const uint32_t*>(&h2);
        }
        const int m = m0 + tid / 8 + 16 * k;
        *reinterpret_cast<uint4*>(out + (size_t)m * F + f) = make_uint4(o[0], o[1], o[2], o[3]);
    }
}

// BOXES: 64-wide boxes of the padded cos depth (1: C <= 64, 2: C <= 128);
// GAME: K2g's phi + E[game].  grid (splits, row tiles), cluster (<= 8, 1).
template <int BOXES, bool GAME>
__global__ void __launch_bounds__(THREADS, GAME ? 2 : 3) tau_embed_kernel(
    const __grid_constant__ CUtensorMap map_w,  // W_e [F, C], boxes 64 x 64 (TMA path)
    const float* __restrict__ taus,             // [M]
    const __nv_bfloat16* __restrict__ w,        // [F, C] (copy path)
    const float* __restrict__ bias,             // [F]
    const __nv_bfloat16* __restrict__ phi,      // [M / taus_per_row, F]
    __nv_bfloat16* __restrict__ out,            // [M, F]
    const int* __restrict__ game,               // [M / taus_per_row] (K2g)
    const float* __restrict__ emb,              // [G, F] (K2g)
    __nv_bfloat16* __restrict__ cos_t,          // [Cp, Mp] or null
    int M, int F, int C, int taus_per_row, int use_tma) {
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = align1024(smem_raw);
    cg::cluster_group cluster = cg::this_cluster();
    const int cp = (C + 15) / 16 * 16;
    const int ksteps = cp / 16;
    const int mp = (M + 63) / 64 * 64;
    uint8_t* cos_s = smem;
    uint8_t* ring = cos_s + BOXES * BOX;
    uint8_t* staging = ring + STAGES * BOXES * BOX;
    uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * BOX);
    uint64_t* empty = full + STAGES;

    const int tiles_f = (F + 63) / 64;
    const int t_begin = (int)((long long)tiles_f * blockIdx.x / gridDim.x);
    const int n_tiles = (int)((long long)tiles_f * (blockIdx.x + 1) / gridDim.x) - t_begin;
    const int m0 = blockIdx.y * 64;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 4);  // lane 0 of every consumer warp
        }
        mbar_init_fence();
    }
    __syncthreads();

    if (warp == 4) {  // ------------------------------------------- producer
        for (int i = 0; i < n_tiles; ++i) {
            const int s = i % STAGES;
            if (i == STAGES) cluster.sync();  // the consumers' cos exchange, below
            if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
            uint8_t* st = ring + s * BOXES * BOX;
            const int f0 = (t_begin + i) * 64;
            if (use_tma) {
                if (lane == 0) {
                    mbar_expect_tx(&full[s], BOXES * BOX);
                    for (int q = 0; q < BOXES; ++q) tma_load_2d(st + q * BOX, &map_w, &full[s], 64 * q, f0);
                }
                __syncwarp();
            } else {
                fill_boxes_sw128(st, w, F, C, C, f0, BOXES, lane);
                fence_proxy_async();
                __syncwarp();
                if (lane == 0) mbar_arrive(&full[s]);
            }
        }
        if (n_tiles <= STAGES) cluster.sync();
        return;
    }

    // ------------------------------------------------------------ consumers
    const int tid = threadIdx.x;
    const int g = lane / 4;
    const int tq = lane % 4;
    {   // this block's slice of the row tile's cos features, 8 of the depth
        // at a time, stored into every block of the cluster
        const int rank = (int)cluster.block_rank();
        const int peers = (int)cluster.num_blocks();
        uint8_t* dst[8];
#pragma unroll
        for (int p = 0; p < 8; ++p)
            dst[p] = p < peers ? cluster.map_shared_rank(cos_s, p) : cos_s;
        const bool write_t = cos_t != nullptr && blockIdx.x < (unsigned)peers;  // the first cluster
        const int chunks = 64 * (cp / 8);  // (row, 8 of the depth)
        const int lo = chunks * rank / peers, hi = chunks * (rank + 1) / peers;
        for (int q = lo + tid; q < hi; q += 128) {
            const int r = q % 64, c0 = 8 * (q / 64), m = m0 + r;
            const float arg = m < M ? PI_F * taus[m] : 0.f;
            float v[8];
#pragma unroll
            for (int k = 0; k < 8; ++k)
                v[k] = (c0 + k < C && m < M) ? cosf(arg * (float)(c0 + k + 1)) : 0.f;
            const uint4 packed = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                                            pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
            const uint32_t off = (c0 / 64) * BOX + sw128_offset(r, (c0 % 64) / 8);
#pragma unroll
            for (int p = 0; p < 8; ++p)
                if (p < peers) *reinterpret_cast<uint4*>(dst[p] + off) = packed;
            if (write_t) {
                const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&packed);
#pragma unroll
                for (int k = 0; k < 8; ++k) cos_t[(size_t)(c0 + k) * mp + m] = b[k];
            }
        }
    }
    cluster.sync();  // every slice has landed in every block
    // ldmatrix (A rows r, depth c along the tile row): lane gives row
    // 16 w + (lane % 8) + 8 * bit 0 of (lane / 8), chunk 2 kk + bit 1
    const int lrow = 16 * warp + (lane % 8) + 8 * ((lane / 8) & 1);
    const int lchunk = lane / 16;
    uint32_t afrag[4 * BOXES][4];
#pragma unroll
    for (int kk = 0; kk < 4 * BOXES; ++kk)
        if (kk < ksteps)
            ldmatrix_x4(afrag[kk], smem_u32(cos_s + (kk / 4) * BOX) + sw128_offset(lrow, 2 * (kk % 4) + lchunk));
    float acc[32];

    for (int i = 0; i < n_tiles; ++i) {
        const int f0 = (t_begin + i) * 64;
        const int s = i % STAGES;
        mbar_wait(&full[s], (i / STAGES) & 1);
        const uint8_t* st = ring + s * BOXES * BOX;
#pragma unroll
        for (int k = 0; k < 32; ++k) acc[k] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4 * BOXES; ++kk)
            if (kk < ksteps) wgmma_rs_n64(acc, afrag[kk], desc_sw128(st + (kk / 4) * BOX) + 2 * (kk % 4));
        wgmma_commit();
        if (i > 0)  // the previous tile's stores run beside this product
            epilogue_unit<GAME>(staging + ((i - 1) & 1) * BOX, tid, m0, f0 - 64, bias, phi, game, emb,
                                out, M, F, taus_per_row);
        wgmma_wait<0>();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(&empty[s]);
        // dense = bf16(acc) into this tile's staging buffer, rows r, r + 8
        uint8_t* stage = staging + (i & 1) * BOX;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
                *reinterpret_cast<uint32_t*>(stage + sw128_offset(16 * warp + g + 8 * h, j) + 4 * tq) =
                    pack_bf16x2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        bar_sync(1, 128);
    }
    if (n_tiles > 0)
        epilogue_unit<GAME>(staging + ((n_tiles - 1) & 1) * BOX, tid, m0, (t_begin + n_tiles - 1) * 64,
                            bias, phi, game, emb, out, M, F, taus_per_row);
}

template <int BOXES, bool GAME>
const void* kernel_of() {
    return reinterpret_cast<const void*>(tau_embed_kernel<BOXES, GAME>);
}

const void* kernel_for(int boxes, bool game) {
    if (boxes == 1) return game ? kernel_of<1, true>() : kernel_of<1, false>();
    return game ? kernel_of<2, true>() : kernel_of<2, false>();
}

cudaLaunchConfig_t cluster_config(int splits, int row_tiles, int cluster, int boxes,
                                  cudaLaunchAttribute* attr, cudaStream_t stream) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(splits, row_tiles, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem_bytes(boxes);
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

cudaError_t opt_in(int boxes, bool game) {
    static bool opted[2][2] = {{false, false}, {false, false}};  // once, before any graph capture
    if (opted[boxes - 1][game]) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel_for(boxes, game), cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(boxes));
    if (err == cudaSuccess) opted[boxes - 1][game] = true;
    return err;
}

}  // namespace

// splits and cluster (a divisor of splits, <= 8) are the wrapper's plan
// (kernels/tau_embed.py: forward_plan); cos_t null unless K2-bwd will read
// the cos features.
PORT_API int port_tau_embed(const void* taus, const void* w, const void* bias, const void* phi,
                            void* out, const void* game, const void* emb, void* cos_t, int M, int F,
                            int C, int taus_per_row, int splits, int cluster, void* stream) {
    const int boxes = ((C + 15) / 16 * 16 + 63) / 64;
    if (M <= 0 || F <= 0 || F % 8 || C <= 0 || boxes > MAX_BOXES || taus_per_row <= 0 ||
        splits <= 0 || splits > (F + 63) / 64 || cluster <= 0 || cluster > 8 || splits % cluster)
        return (int)cudaErrorInvalidValue;
    int use_tma = C % 8 == 0;  // TMA needs a 16-byte row stride
    CUtensorMap map_w = {};
    if (use_tma && !make_map(&map_w, w, F, C, C, 64)) return (int)cudaErrorInvalidValue;
    const bool k2g = emb != nullptr;
    cudaError_t err = opt_in(boxes, k2g);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(splits, (M + 63) / 64, cluster, boxes, attr,
                                                  static_cast<cudaStream_t>(stream));
    void* args[] = {&map_w, &taus, &w, &bias, &phi, &out, &game, &emb, &cos_t,
                    &M, &F, &C, &taus_per_row, &use_tma};
    err = cudaLaunchKernelExC(&cfg, kernel_for(boxes, k2g), args);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// How many clusters of `cluster` K2 blocks (K2g with `game`, `boxes` of cos
// depth) the card holds at once; 0 where the runtime cannot say.
PORT_API int port_tau_embed_max_clusters(int cluster, int boxes, int game) {
    if (boxes < 1 || boxes > MAX_BOXES || opt_in(boxes, game != 0) != cudaSuccess) {
        cudaGetLastError();
        return 0;
    }
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(cluster, 1, cluster, boxes, attr, nullptr);
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, kernel_for(boxes, game != 0), &cfg) != cudaSuccess) {
        cudaGetLastError();  // the query's error is not a launch's
        return 0;
    }
    return n;
}

PORT_API const char* port_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
