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
// of tensor-core time.
//
// Design: psi is recomputed, not saved (saving it would add a 12.8 MB write
// and read), from the cos features K2 saved (cos_t [Cp, Mp], transposed, the
// depth padded with zeros to Cp = C rounded up to 16), with K2's own product
// (the same wgmma.m64n64k16 on the same register A fragments and W_e tile) so
// the mask is K2's.  The grid is (feature tiles of 64) x (chunks of M), each
// column of chunks one thread-block cluster (<= 8 blocks, as many as keep the
// clusters in one wave: kernels/tau_embed.py backward_plan); a chunk holds
// whole samples (a multiple of lcm(64, N) rows), so dphi completes in one
// block.  A block is one consumer warpgroup and one producer warp.  The
// producer loads the block's W_e tile, then streams a 2-stage ring of 64-row
// sub-tiles of dh and of cos_t by TMA (128-byte swizzled, mbarriers).  Per
// sub-tile the consumers
//   1. run pre = cos . W_e^T on wgmma, A the cos fragments ldmatrix.trans-
//      loaded from the cos_t box;
//   2. form, in registers and two features at a time (bf16x2), v = bf16(dh *
//      psi) and dpre = bf16(dh * phi_g) where pre > 0, into two swizzled
//      tiles, and a segment tile S [s][r] = 1 where row r is in the sub-tile's
//      sample s;
//   3. run on wgmma, A the transposed fragments of those tiles:
//      dW_e += dpre^T . cos (B the cos_t box, N = Cp in n16 steps), db +=
//      dpre^T . 1 (B a constant tile whose first row is ones) and each
//      sample's dphi = v^T . S (the segments in n8 steps); a sample that runs
//      past the sub-tile carries its fp32 sum to the next.
// The reductions over rows are tensor-core fp32 sums, fixed in order.  The
// cluster then adds its blocks' fp32 dW_e and db partials through
// distributed shared memory in rank order, each block rounding a slice once:
// no atomics, the same result on every run.  The first design (one block per
// 32 features walking all M rows in series, legacy wmma, its own cosf for
// every feature tile, and the sums in scalar loops) took 0.44 ms.
//
// K2g-bwd (multi-game runs, game [B] int32 and E [G, F] fp32): the merge's
// phi is phi_g = bf16(phi + bf16(E[game[b]])), as K2g forms it, and the
// embedding's gradient is the transpose of the gather after the fp32 -> bf16
// cast,
//   dE[g, f] = sum over the rows b with game[b] == g of fp32(dphi[b, f])
// (dphi is also dphi_g: the add passes it through).  The same launch forms
// it after the cluster barrier: each block reads back a slice of its feature
// tile's bf16 dphi, which the cluster's blocks wrote, and sums it per game,
// rows in order, in fp32.  No atomics: the same result on every run.  dE
// adds G*F*4 bytes written.
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
namespace cg = cooperative_groups;

constexpr int CONSUMERS = 128;    // one consumer warpgroup, then the producer warp
constexpr int THREADS = CONSUMERS + 32;
constexpr int STAGES = 2;
constexpr int BOX = 64 * ROW_BYTES;  // a 64 x 64 bf16 box: 8 KB
constexpr int MAX_CP = 128;          // padded cos depth: two boxes of W_e

__host__ __device__ constexpr int stage_bytes(int cp) { return BOX + cp * ROW_BYTES; }

// segment chunks: the samples a 64-row sub-tile can touch, 8 a chunk
__host__ __device__ constexpr int seg_chunks(int n) {
    return (63 / n + 2 + 7) / 8 < 8 ? (63 / n + 2 + 7) / 8 : 8;
}

__host__ __device__ constexpr int smem_bytes(int cp, int chunks) {
    // W_e tile, ring (the dW_e partials reuse it), v and dpre tiles, the
    // ones tile, the segment tile, db partials, the bias, dphi carries,
    // barriers
    return 1024 + (cp + 63) / 64 * BOX + STAGES * stage_bytes(cp) + 2 * BOX + 1024 +
           chunks * 1024 + 4 * 64 * 4 + (2 * STAGES + 1) * 8;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
    return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

// NCH: n16 steps of the padded cos depth (4: C <= 64, 8: C <= 128)
template <int NCH>
__global__ void __launch_bounds__(THREADS, NCH <= 4 ? 3 : 2) tau_embed_bwd_kernel(
    const __grid_constant__ CUtensorMap map_w,   // W_e [F, C], boxes 64 x 64 (TMA path)
    const __grid_constant__ CUtensorMap map_dh,  // dh [M, F], boxes 64 x 64
    const __grid_constant__ CUtensorMap map_cos, // cos_t [Cp, Mp], boxes 64 x Cp
    const __nv_bfloat16* __restrict__ w,         // [F, C] (copy path)
    const float* __restrict__ bias,              // [F]
    const __nv_bfloat16* __restrict__ phi,       // [B, F]
    __nv_bfloat16* __restrict__ dphi,            // [B, F]
    __nv_bfloat16* __restrict__ dw,              // [F, C]
    float* __restrict__ db,                      // [F]
    const int* __restrict__ game,                // [B] or null (K2g-bwd)
    const float* __restrict__ emb,               // [G, F] or null (K2g-bwd)
    float* __restrict__ demb,                    // [G, F] or null (K2g-bwd)
    int M, int F, int C, int N, int B, int G, int rows_per_block, int use_tma) {
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = align1024(smem_raw);
    cg::cluster_group cluster = cg::this_cluster();
    const int cp = (C + 15) / 16 * 16;
    const int ksteps = cp / 16;
    const int wboxes = (cp + 63) / 64;
    const int sbytes = stage_bytes(cp);
    uint8_t* w_s = smem;
    uint8_t* ring = w_s + wboxes * BOX;
    uint8_t* v_s = ring + STAGES * sbytes;
    uint8_t* dpre_s = v_s + BOX;
    uint8_t* ones_s = dpre_s + BOX;  // [8][64] bf16, row 0 ones: B of db = dpre^T . 1
    uint8_t* seg_s = ones_s + 1024;  // [8 chunks][64] bf16: S[s][r] = 1 if row r is in segment s
    const int chunks_max = seg_chunks(N);
    float* db_part = reinterpret_cast<float*>(seg_s + chunks_max * 1024);
    float* bias_s = db_part + 64;   // bf16(b_e) of the block's features
    float* carry = bias_s + 64;     // [2][64]: dphi of a sample open across sub-tiles
    uint64_t* full = reinterpret_cast<uint64_t*>(carry + 128);
    uint64_t* empty = full + STAGES;
    uint64_t* wbar = empty + STAGES;
    float* dw_part = reinterpret_cast<float*>(ring);  // [64][cp + 4], after the ring is done
    const int ldp = cp + 4;

    const int f0 = blockIdx.x * 64;
    const int rank = (int)cluster.block_rank();  // == blockIdx.y: the cluster spans the M chunks
    const int csize = (int)cluster.num_blocks();
    const int row0 = blockIdx.y * rows_per_block;
    const int rows = min(rows_per_block, M - row0);
    const int subtiles = (rows + 63) / 64;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int tid = threadIdx.x;

    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], CONSUMERS / 32);  // lane 0 of every consumer warp
        }
        mbar_init(wbar, 1);
        mbar_init_fence();
    }
    if (tid < 64) bias_s[tid] = f0 + tid < F ? port::bf16_round(bias[f0 + tid]) : 0.f;
    if (tid < 128) {  // the ones tile: 8 rows of 64, row 0 all ones
        const int row = tid / 16, c4 = (tid % 16) * 4;
        const uint32_t v = row == 0 ? 0x3F803F80u : 0u;  // bf16 1.0 twice
        *reinterpret_cast<uint2*>(ones_s + sw128_offset(row, c4 / 8) + 2 * (c4 % 8)) = make_uint2(v, v);
        fence_proxy_async();
    }
    __syncthreads();

    if (warp == CONSUMERS / 32) {  // ------------------------------ producer
        if (use_tma) {
            if (lane == 0) {
                mbar_expect_tx(wbar, wboxes * BOX);
                for (int q = 0; q < wboxes; ++q) tma_load_2d(w_s + q * BOX, &map_w, wbar, 64 * q, f0);
            }
        } else {
            fill_boxes_sw128(w_s, w, F, C, C, f0, wboxes, lane);
            fence_proxy_async();
            __syncwarp();
            if (lane == 0) mbar_arrive(wbar);
        }
        if (lane == 0) {
            for (int i = 0; i < subtiles; ++i) {
                const int s = i % STAGES;
                if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
                uint8_t* st = ring + s * sbytes;
                const int r0 = row0 + 64 * i;
                mbar_expect_tx(&full[s], sbytes);
                tma_load_2d(st, &map_dh, &full[s], f0, r0);
                tma_load_2d(st + BOX, &map_cos, &full[s], r0, 0);
            }
        }
        __syncwarp();
    } else {  // ----------------------------------------------------- consumers
        const int g = lane / 4;
        const int tq = lane % 4;
        // ldmatrix.trans (the tile's rows run along the depth): lane gives
        // depth row 16 kk + (lane % 8) + 8 * bit 1 of (lane / 8), chunk
        // 2 w + bit 0 (the warp's 16 rows of A)
        const int ldrow = (lane % 8) + 8 * ((lane / 8) >> 1);
        const int lchunk = 2 * warp + ((lane / 8) & 1);
        float acc2[NCH][8];
#pragma unroll
        for (int n = 0; n < NCH; ++n)
#pragma unroll
            for (int k = 0; k < 8; ++k) acc2[n][k] = 0.f;
        float acc_db[4] = {0.f, 0.f, 0.f, 0.f};  // column 0: db of features 16 w + g (+ 8)

        mbar_wait(wbar, 0);

        for (int i = 0; i < subtiles; ++i) {
            const int s = i % STAGES;
            const int r0 = row0 + 64 * i;
            // phi_g of this thread's two rows, loaded before the sub-tile lands
            uint32_t pg[2][8];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int m = r0 + 16 * warp + g + 8 * h;
                const int b = m < M ? m / N : 0;
                const __nv_bfloat16* phi_row = phi + (size_t)b * F;
                const float* emb_row = emb != nullptr ? emb + (size_t)__ldg(game + b) * F : nullptr;
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const int f = f0 + 8 * j + 2 * tq;
                    pg[h][j] = 0u;
                    if (f < F) {
                        pg[h][j] = __ldg(reinterpret_cast<const unsigned int*>(phi_row + f));
                        if (emb_row != nullptr) {
                            const float2 e = __ldg(reinterpret_cast<const float2*>(emb_row + f));
                            pg[h][j] = pack_bf16x2(bf16_lo(pg[h][j]) + port::bf16_round(e.x),
                                                   bf16_hi(pg[h][j]) + port::bf16_round(e.y));
                        }
                    }
                }
            }
            mbar_wait(&full[s], (i / STAGES) & 1);
            const uint8_t* dh_s = ring + s * sbytes;
            const uint8_t* cos_s = dh_s + BOX;

            // 1. pre-activations [64 rows x 64 features], K2's product
            float acc1[32];
#pragma unroll
            for (int k = 0; k < 32; ++k) acc1[k] = 0.f;
            {
                uint32_t a[NCH][4];
#pragma unroll
                for (int kk = 0; kk < NCH; ++kk)
                    if (kk < ksteps)
                        ldmatrix_x4_trans(a[kk], smem_u32(cos_s) + sw128_offset(16 * kk + ldrow, lchunk));
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < NCH; ++kk)
                    if (kk < ksteps)
                        wgmma_rs_n64(acc1, a[kk], desc_sw128(w_s + (kk / 4) * BOX) + 2 * (kk % 4));
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs(acc1);
            }

            // 2. v = bf16(dh * psi), dpre = bf16(dh * phi_g) where pre > 0, two
            // features at a time in bf16x2 (each product rounds once, as an
            // fp32 product rounded to bf16 does)
            const __nv_bfloat162 zero2 = __float2bfloat162_rn(0.f);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = 16 * warp + g + 8 * h;
                const bool row_in = r0 + r < M;
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const int fl = 8 * j + 2 * tq;  // the pair's first feature in the tile
                    const uint32_t at = sw128_offset(r, j) + 4 * tq;
                    uint32_t vv = 0u, dd = 0u;
                    if (row_in && f0 + fl < F) {
                        const uint32_t draw = *reinterpret_cast<const uint32_t*>(dh_s + at);
                        const __nv_bfloat162 d2 = *reinterpret_cast<const __nv_bfloat162*>(&draw);
                        const float2 bb = *reinterpret_cast<const float2*>(bias_s + fl);
                        const __nv_bfloat162 dense = __floats2bfloat162_rn(acc1[4 * j + 2 * h], acc1[4 * j + 2 * h + 1]);
                        const __nv_bfloat162 pre = __floats2bfloat162_rn(__low2float(dense) + bb.x,
                                                                         __high2float(dense) + bb.y);
                        const __nv_bfloat162 v2 = __hmul2(d2, __hmax2(pre, zero2));
                        const __nv_bfloat162 p2 = __hmul2(d2, *reinterpret_cast<const __nv_bfloat162*>(&pg[h][j]));
                        vv = *reinterpret_cast<const uint32_t*>(&v2);
                        dd = *reinterpret_cast<const uint32_t*>(&p2) & __hgt2_mask(pre, zero2);
                    }
                    *reinterpret_cast<uint32_t*>(v_s + at) = vv;
                    *reinterpret_cast<uint32_t*>(dpre_s + at) = dd;
                }
            }
            // the segment tile: which of the sub-tile's samples each row is in
            const int first = r0 / N;
            const int nseg = (min(r0 + 64, M) - 1) / N - first + 1;
            const int nchunks = (nseg + 7) / 8;
            if (tid < 64) {
                const int m = r0 + tid;
                const int seg = m < M ? m / N - first : -1;
                for (int row = 0; row < 8 * nchunks; ++row)
                    *reinterpret_cast<__nv_bfloat16*>(seg_s + (row / 8) * 1024 + sw128_offset(row % 8, tid / 8) +
                                                      2 * (tid % 8)) = __float2bfloat16(row == seg ? 1.f : 0.f);
                fence_proxy_async();
            }
            bar_sync(1, CONSUMERS);

            // 3. on the tensor cores: dW_e[f, c] += sum_r dpre[r, f] cos[r, c],
            // db[f] += sum_r dpre[r, f], and each segment's sum_r v[r, f]
            {
                uint32_t p[4][4];
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    ldmatrix_x4_trans(p[kk], smem_u32(dpre_s) + sw128_offset(16 * kk + ldrow, lchunk));
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
                    for (int n = 0; n < NCH; ++n)
                        if (n < ksteps)
                            wgmma_rs_n16(acc2[n], p[kk], desc_sw128(cos_s + n * 16 * ROW_BYTES) + 2 * kk);
                    wgmma_rs_n8(acc_db, p[kk], desc_sw128(ones_s) + 2 * kk);
                }
                wgmma_commit();
                uint32_t pv[4][4];
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    ldmatrix_x4_trans(pv[kk], smem_u32(v_s) + sw128_offset(16 * kk + ldrow, lchunk));
                for (int c = 0; c < nchunks; ++c) {
                    float ap[4] = {0.f, 0.f, 0.f, 0.f};
                    wgmma_fence();
#pragma unroll
                    for (int kk = 0; kk < 4; ++kk) wgmma_rs_n8(ap, pv[kk], desc_sw128(seg_s + c * 1024) + 2 * kk);
                    wgmma_commit();
                    wgmma_wait<0>();
                    fence_regs(ap);
                    // ap[2h + k]: feature 16 w + g + 8 h, segment 8 c + 2 tq + k
#pragma unroll
                    for (int h = 0; h < 2; ++h)
#pragma unroll
                        for (int k = 0; k < 2; ++k) {
                            const int seg = 8 * c + 2 * tq + k;
                            if (seg >= nseg) continue;
                            const int b = first + seg, fl = 16 * warp + g + 8 * h;
                            float val = ap[2 * h + k];
                            if (b * N < r0) val += carry[((i - 1) & 1) * 64 + fl];  // begun before
                            if ((b + 1) * N <= r0 + 64) {  // ends in this sub-tile
                                if (f0 + fl < F) dphi[(size_t)b * F + f0 + fl] = __float2bfloat16(val);
                            } else {
                                carry[(i & 1) * 64 + fl] = val;
                            }
                        }
                }
            }
            wgmma_wait<0>();
#pragma unroll
            for (int n = 0; n < NCH; ++n) fence_regs(acc2[n]);
            fence_regs(acc_db);
            if (lane == 0) mbar_arrive(&empty[s]);
            bar_sync(1, CONSUMERS);  // v, dpre, the segment tile and a carry are free again
        }

        // partials: dW_e [64 f][cp] over the (now idle) ring, db [64]
#pragma unroll
        for (int n = 0; n < NCH; ++n) {
            if (n >= ksteps) break;
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int f = 16 * warp + g + 8 * h;
                    const int c = 16 * n + 8 * j + 2 * tq;
                    *reinterpret_cast<float2*>(dw_part + f * ldp + c) =
                        make_float2(acc2[n][4 * j + 2 * h], acc2[n][4 * j + 2 * h + 1]);
                }
        }
        if (tq == 0) {
            db_part[16 * warp + g] = acc_db[0];
            db_part[16 * warp + g + 8] = acc_db[2];
        }
    }
    cluster.sync();  // every block's partials and dphi are written

    // this block's slice of the cluster sums, in rank order, rounded once:
    // four dW_e values a thread, the ranks' loads all issued before the adds
    if (tid < CONSUMERS) {
        const int quads = 16 * cp;  // 64 x cp / 4
        const int q_lo = (int)((long long)quads * rank / csize);
        const int q_hi = (int)((long long)quads * (rank + 1) / csize);
        for (int q4 = q_lo + tid; q4 < q_hi; q4 += CONSUMERS) {
            const int f = q4 / (cp / 4), c = 4 * (q4 % (cp / 4));
            float4 part[8];
#pragma unroll
            for (int q = 0; q < 8; ++q)
                if (q < csize)
                    part[q] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(dw_part, q) +
                                                               f * ldp + c);
            float4 sum = part[0];
#pragma unroll
            for (int q = 1; q < 8; ++q)
                if (q < csize) {
                    sum.x += part[q].x; sum.y += part[q].y; sum.z += part[q].z; sum.w += part[q].w;
                }
            if (f0 + f >= F) continue;
            __nv_bfloat16* out = dw + (size_t)(f0 + f) * C + c;
            const float vals[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
            for (int k = 0; k < 4; ++k)
                if (c + k < C) out[k] = __float2bfloat16(vals[k]);
        }
        const int f_lo = 64 * rank / csize, f_hi = 64 * (rank + 1) / csize;
        for (int f = f_lo + tid; f < f_hi; f += CONSUMERS) {
            float part[8];
#pragma unroll
            for (int q = 0; q < 8; ++q)
                if (q < csize) part[q] = cluster.map_shared_rank(db_part, q)[f];
            float sum = part[0];
#pragma unroll
            for (int q = 1; q < 8; ++q)
                if (q < csize) sum += part[q];
            if (f0 + f < F) db[f0 + f] = port::bf16_round(sum);
        }
        if (demb != nullptr) {  // dE from the cluster's bf16 dphi, rows in order
            const int d_lo = (int)((long long)G * 64 * rank / csize);
            const int d_hi = (int)((long long)G * 64 * (rank + 1) / csize);
            for (int e = d_lo + tid; e < d_hi; e += CONSUMERS) {
                const int gi = e / 64, f = f0 + e % 64;
                if (f >= F) continue;
                float sum = 0.f;
#pragma unroll 8
                for (int b = 0; b < B; ++b) {
                    const float v = port::to_float(__ldcg(dphi + (size_t)b * F + f));
                    if (__ldg(game + b) == gi) sum += v;
                }
                demb[(size_t)gi * F + f] = sum;
            }
        }
    }
    cluster.sync();  // no block leaves while another reads its shared memory
}

template <int NCH>
int launch(const CUtensorMap& mw, const CUtensorMap& mdh, const CUtensorMap& mcos, const void* w,
           const void* bias, const void* phi, void* dphi, void* dw, void* db, const void* game,
           const void* emb, void* demb, int M, int F, int C, int N, int B, int G, int rows_per_block,
           int clusters, int use_tma, cudaStream_t stream) {
    static bool opted = false;  // once, before any graph capture
    if (!opted) {
        const cudaError_t err = cudaFuncSetAttribute(
            tau_embed_bwd_kernel<NCH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem_bytes(16 * NCH, 8));
        if (err != cudaSuccess) return (int)err;
        opted = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((F + 63) / 64, clusters, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem_bytes((C + 15) / 16 * 16, seg_chunks(N));
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = clusters;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    void* args[] = {const_cast<CUtensorMap*>(&mw), const_cast<CUtensorMap*>(&mdh),
                    const_cast<CUtensorMap*>(&mcos), &w, &bias, &phi, &dphi, &dw, &db, &game, &emb,
                    &demb, &M, &F, &C, &N, &B, &G, &rows_per_block, &use_tma};
    const cudaError_t err =
        cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(tau_embed_bwd_kernel<NCH>), args);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // namespace

// How many clusters of `cluster` blocks (at the padded cos depth cp) the card
// holds at once: the wrapper's plan keeps one wave.
PORT_API int port_tau_embed_bwd_max_clusters(int cluster, int cp, int taus_per_row) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1, cluster, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem_bytes(cp, seg_chunks(taus_per_row));
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = cluster;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    const void* fn = cp <= 64 ? reinterpret_cast<const void*>(tau_embed_bwd_kernel<4>)
                              : reinterpret_cast<const void*>(tau_embed_bwd_kernel<8>);
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(cp <= 64 ? 64 : 128, 8));
    if (cudaOccupancyMaxActiveClusters(&n, fn, &cfg) != cudaSuccess) {
        cudaGetLastError();  // the query's error is not a launch's
        return 0;
    }
    return n;
}

// rows_per_block and clusters (the blocks of M, <= 8) are the wrapper's plan
// (kernels/tau_embed.py: backward_plan); cos_t [Cp, Mp] is K2's saved output.
PORT_API int port_tau_embed_bwd(const void* cos_t, const void* w, const void* bias,
                                const void* phi, const void* dh, void* dphi, void* dw, void* db,
                                const void* game, const void* emb, void* demb, int B, int N, int F,
                                int C, int G, int rows_per_block, int clusters, void* stream) {
    const int M = B * N;
    const int cp = (C + 15) / 16 * 16;
    const int mp = (M + 63) / 64 * 64;
    if (B <= 0 || N <= 0 || F <= 0 || F % 8 || C <= 0 || cp > MAX_CP || clusters < 1 ||
        clusters > 8 || rows_per_block % 64 || (long long)rows_per_block * clusters < M)
        return (int)cudaErrorInvalidValue;
    const int use_tma = C % 8 == 0;  // TMA needs a 16-byte row stride
    CUtensorMap mw = {}, mdh, mcos;
    if ((use_tma && !make_map(&mw, w, F, C, C, 64)) || !make_map(&mdh, dh, M, F, F, 64) ||
        !make_map(&mcos, cos_t, cp, mp, mp, cp))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (cp <= 64)
        return launch<4>(mw, mdh, mcos, w, bias, phi, dphi, dw, db, game, emb, demb, M, F, C, N, B, G,
                         rows_per_block, clusters, use_tma, s);
    return launch<8>(mw, mdh, mcos, w, bias, phi, dphi, dw, db, game, emb, demb, M, F, C, N, B, G,
                     rows_per_block, clusters, use_tma, s);
}
