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
// add an error as large as that final rounding.  In the noisy dx product
// dys = dy * f_out gets a third plane, lo2 = bf16(dys - hi - lo) (exact to
// ~2^-25): where dxc's two terms cancel, its second term rounds twice
// (bf16(dys @ W_sigma), then the product with f_in), and the two-plane
// error of dys could move that rounding across a bf16 boundary (the R2D2
// head's 3840 x 512 x 512 card case did, by 0.0156 at |dxc| 0.5).
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): a noisy hidden layer of the
// learner (M 2048, K 3136, N 512) is four products of 2 M N K = 6.6 GFLOP,
// 26 us, against ~25 MB of operands (7.5 us): operation-bound.  The split
// doubles the tensor work to eight products, 53 us: the floor of this design.
// The *_out layers (N 1, 18; K 512) move ~2 MB of xc and dxc each (~1.3 us),
// far above their operations.
//
// Design: four launches, one count.
//   1. prep: 32 x 32 tiles of g (and y) form the masked dy and dys, write
//      their bf16 planes both as P [M, N8] (depth n along the row, for dx:
//      dy hi, lo, dys hi, lo, lo2) and transposed as PT [N8, MP] (depth m
//      along the row, for dW: dy hi, lo, dys hi, lo;
//      N8 = roundup(N, 8), MP = roundup(M, 8), the pads zero), and sum each
//      tile's 32 rows of dy per column into dbp [MP / 32, N].
//   2. dx and 3. dW: one warp-specialised wgmma GEMM, both written transposed
//      so that the dy planes are the B operand and the bf16 matrix the A
//      operand:  out^T[k, j] = sum_d A[d, k] * B[j, d].
//        dx:  A = W_mu / W_sigma [N, K] (d = n),  B = P rows m,  out dxc [M, K]
//        dW:  A = xc [M, K] (d = m),              B = PT rows n, out dW [N, K]
//      One CTA per output tile.  A producer warp streams a ring of TMA boxes
//      (64 k x 64 d of each A source per consumer warpgroup, BN j x 64 d of
//      each plane), 128-byte swizzled, completing on mbarriers.  Two consumer
//      warpgroups own 64 rows k each: per k16 step a warp ldmatrix.trans-loads
//      its A fragment (the tile's rows run along d) and issues wgmma.m64nBNk16
//      with A in registers against the hi and the lo plane.  dW_sigma's
//      operand bf16(xc * f_in) is that fragment times bf16(f_in[k]) for the
//      warp's rows k, one bf16x2 multiply in registers; nothing is formed in
//      shared memory.  dx's epilogue rounds as above; dW's writes bf16 when
//      the depth is whole.  The depth of dW (M) is split into S chunks when
//      the (k, n) tiles alone leave the card idle (the *_out layers: 4 tiles,
//      S 32; the R2D2 head's 512 x 512 over 2560 rows: 32 tiles, S 5): each
//      chunk writes fp32 partials.  A persistent grid (one CTA per SM walking
//      the tiles, the ring running on across them) measured 2 % slower.
//   4. finalize: the partials summed in chunk order and rounded to bf16 once,
//      db_mu summed from dbp in chunk order, db_sigma = f_out * db_mu.
// No atomics anywhere: the result is the same on every run.  The launch plan
// (dW's BN and S, the workspace sizes) is kernels/noisy_linear.py's.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int MODE_DX = 0;
constexpr int MODE_DW = 1;
constexpr int NWG = 2;            // consumer warpgroups: 128 rows k per block
constexpr int BK = 64 * NWG;
constexpr int THREADS = NWG * 128 + 32;
constexpr int BOX_BYTES = 64 * ROW_BYTES;  // a 64 x 64 bf16 box
constexpr int STAGE_CAP = 221184;           // shared bytes of the ring: three noisy dx stages

template <int MODE, int BN>
struct Gemm {
    static constexpr int A_SRC = MODE == MODE_DX ? 2 : 1;  // dx: W_mu, W_sigma; dW: xc
    static constexpr int A_BYTES = A_SRC * NWG * BOX_BYTES;
    static constexpr int PLANES = MODE == MODE_DX ? 5 : 4;  // hi, lo, s_hi, s_lo (, s_lo2)
    static constexpr int B_BYTES = PLANES * BN * ROW_BYTES;
    static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
    static constexpr int STAGES = STAGE_CAP / STAGE_BYTES < 4 ? STAGE_CAP / STAGE_BYTES : 4;
    static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
    return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// ---------------------------------------------------------------- 1. prep
__global__ void k3b_prep_kernel(const float* __restrict__ g,      // [M, N]
                            const float* __restrict__ y,      // [M, N] or null (no ReLU)
                            const float* __restrict__ f_out,  // [N] or null (greedy)
                            __nv_bfloat16* __restrict__ P,    // 5 (noisy) or 2 planes x [M, N8]
                            __nv_bfloat16* __restrict__ PT,   // 4 (noisy) or 2 planes x [N8, MP]
                            float* __restrict__ dbp,          // [MP / 32, N]
                            int M, int N, int N8, int MP) {
    __shared__ float t_dy[32][33];
    __shared__ float t_ds[32][33];
    const bool noisy = f_out != nullptr;
    const int tx = threadIdx.x;
    const int ty = threadIdx.y;
    const int n0 = blockIdx.x * 32;
    const int m0 = blockIdx.y * 32;
    const size_t plane = (size_t)M * N8;
    const size_t plane_t = (size_t)N8 * MP;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty + 8 * i;
        const int m = m0 + r;
        const int n = n0 + tx;
        float dy = 0.f, ds = 0.f;
        if (m < M && n < N) {
            const size_t o = (size_t)m * N + n;
            dy = g[o];
            if (y != nullptr && !(y[o] > 0.f)) dy = 0.f;
            if (noisy) ds = dy * f_out[n];
        }
        if (m < M && n < N8) {
            const size_t o = (size_t)m * N8 + n;
            const __nv_bfloat16 hi = __float2bfloat16(dy);
            P[o] = hi;
            P[plane + o] = __float2bfloat16(dy - __bfloat162float(hi));
            if (noisy) {
                const __nv_bfloat16 shi = __float2bfloat16(ds);
                const float rest = ds - __bfloat162float(shi);
                const __nv_bfloat16 slo = __float2bfloat16(rest);
                P[2 * plane + o] = shi;
                P[3 * plane + o] = slo;
                P[4 * plane + o] = __float2bfloat16(rest - __bfloat162float(slo));
            }
        }
        t_dy[r][tx] = dy;
        t_ds[r][tx] = ds;
    }
    __syncthreads();
    if (ty == 0 && n0 + tx < N) {  // the tile's rows in order
        float s = 0.f;
        for (int r = 0; r < 32; ++r) s += t_dy[r][tx];
        dbp[(size_t)blockIdx.y * N + n0 + tx] = s;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int c = ty + 8 * i;
        const int n = n0 + c;
        const int m = m0 + tx;
        if (n >= N8 || m >= MP) continue;
        const size_t o = (size_t)n * MP + m;
        const float dy = t_dy[tx][c];
        const __nv_bfloat16 hi = __float2bfloat16(dy);
        PT[o] = hi;
        PT[plane_t + o] = __float2bfloat16(dy - __bfloat162float(hi));
        if (noisy) {
            const float ds = t_ds[tx][c];
            const __nv_bfloat16 shi = __float2bfloat16(ds);
            PT[2 * plane_t + o] = shi;
            PT[3 * plane_t + o] = __float2bfloat16(ds - __bfloat162float(shi));
        }
    }
}

// ------------------------------------------------------ 2./3. the GEMMs
// out^T[k, j] = sum_d A[d, k] B[j, d] over the depth tiles [z T / S, (z + 1) T / S)
// of this block's chunk z = blockIdx.z (T = d_tiles).  grid: (j tiles of BN,
// k tiles of BK, S).
template <int MODE, int BN>
__global__ void __launch_bounds__(THREADS, 1) k3b_gemm_kernel(
    const __grid_constant__ CUtensorMap map_a0,  // dx: W_mu [N, K];   dW: xc [M, K]
    const __grid_constant__ CUtensorMap map_a1,  // dx: W_sigma [N, K] (noisy)
    const __grid_constant__ CUtensorMap map_b,   // dx: P [5 or 2 planes * M, N8]; dW: PT [4 or 2 planes * N8, MP]
    const float* __restrict__ f_in,              // [K] (noisy) or null
    __nv_bfloat16* __restrict__ out0,            // dx: dxc [M, K];  dW: dW_mu [N, K] (S == 1)
    __nv_bfloat16* __restrict__ out1,            // dW: dW_sigma [N, K] (noisy, S == 1)
    float* __restrict__ part,                    // dW, S > 1: [2][S][N, K] fp32 partials
    int J, int K, int plane_rows, int d_tiles, int S) {
    using C = Gemm<MODE, BN>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = align1024(smem_raw);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::STAGES * C::STAGE_BYTES);
    uint64_t* empty = full + C::STAGES;
    const bool noisy = f_in != nullptr;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int j0 = blockIdx.x * BN;
    const int k0 = blockIdx.y * BK;
    const int d_begin = (int)((long long)blockIdx.z * d_tiles / S);
    const int d_end = (int)((long long)(blockIdx.z + 1) * d_tiles / S);
    const int tiles = d_end - d_begin;

    if (threadIdx.x == 0) {
        for (int s = 0; s < C::STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 4 * NWG);
        }
        mbar_init_fence();
    }
    __syncthreads();

    if (warp == 4 * NWG) {  // ------------------------------------ producer
        if (lane == 0) {
            const int srcs = MODE == MODE_DX && noisy ? 2 : 1;
            const int planes = noisy ? C::PLANES : 2;
            const uint32_t bytes = srcs * NWG * BOX_BYTES + planes * BN * ROW_BYTES;
            for (int t = 0; t < tiles; ++t) {
                const int s = t % C::STAGES;
                if (t >= C::STAGES) mbar_wait(&empty[s], ((t / C::STAGES) - 1) & 1);
                uint8_t* st = smem + s * C::STAGE_BYTES;
                const int d = (d_begin + t) * TILE_K;
                mbar_expect_tx(&full[s], bytes);
                for (int src = 0; src < srcs; ++src)
                    for (int wg = 0; wg < NWG; ++wg)
                        tma_load_2d(st + (src * NWG + wg) * BOX_BYTES, src ? &map_a1 : &map_a0,
                                    &full[s], k0 + 64 * wg, d);
                for (int p = 0; p < planes; ++p)
                    tma_load_2d(st + C::A_BYTES + p * BN * ROW_BYTES, &map_b, &full[s], d,
                                p * plane_rows + j0);
            }
        }
        return;
    }

    // ---------------------------------------------------------- consumers
    const int wg = warp / 4;
    const int w = warp % 4;
    const int g = lane / 4;
    const int tq = lane % 4;
    // ldmatrix.trans: lane gives depth row 16 kk + (lane % 8) + 8 * bit 1 of
    // (lane / 8), chunk 2 w + bit 0 (the warp's rows k)
    const int ldrow = (lane % 8) + 8 * ((lane / 8) >> 1);
    const int lchunk = 2 * w + ((lane / 8) & 1);
    const int kr = k0 + 64 * wg + 16 * w + g;  // this lane's rows k: kr, kr + 8
    float fin[2] = {0.f, 0.f};
    if (noisy) {
        if (kr < K) fin[0] = port::bf16_round(f_in[kr]);
        if (kr + 8 < K) fin[1] = port::bf16_round(f_in[kr + 8]);
    }
    const uint32_t sc0 = pack_bf16x2(fin[0], fin[0]);
    const uint32_t sc1 = pack_bf16x2(fin[1], fin[1]);

    float acc_mu[BN / 2], acc_sg[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc_mu[i] = acc_sg[i] = 0.f;

    for (int t = 0; t < tiles; ++t) {
        const int s = t % C::STAGES;
        mbar_wait(&full[s], (t / C::STAGES) & 1);
        uint8_t* st = smem + s * C::STAGE_BYTES;
        const uint32_t a_mu = smem_u32(st + wg * BOX_BYTES);
        const uint32_t a_sg = smem_u32(st + (NWG + wg) * BOX_BYTES);
        uint8_t* b = st + C::A_BYTES;
        const uint64_t d_hi = desc_sw128(b);
        const uint64_t d_lo = desc_sw128(b + BN * ROW_BYTES);
        const uint64_t d_shi = desc_sw128(b + 2 * BN * ROW_BYTES);
        const uint64_t d_slo = desc_sw128(b + 3 * BN * ROW_BYTES);
        const uint64_t d_slo2 = desc_sw128(b + 4 * BN * ROW_BYTES);  // dx only
        uint32_t fa[4][4], fs[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const uint32_t off = sw128_offset(16 * kk + ldrow, lchunk);
            ldmatrix_x4_trans(fa[kk], a_mu + off);
            if (noisy) {
                if (MODE == MODE_DX) {
                    ldmatrix_x4_trans(fs[kk], a_sg + off);
                } else {  // bf16(xc * bf16(f_in[k])) for rows kr (a[0], a[2]) and kr + 8
                    fs[kk][0] = mul_bf16x2(fa[kk][0], sc0);
                    fs[kk][1] = mul_bf16x2(fa[kk][1], sc1);
                    fs[kk][2] = mul_bf16x2(fa[kk][2], sc0);
                    fs[kk][3] = mul_bf16x2(fa[kk][3], sc1);
                }
            }
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            wgmma_rs<BN>(acc_mu, fa[kk], d_hi + 2 * kk);
            wgmma_rs<BN>(acc_mu, fa[kk], d_lo + 2 * kk);
        }
        if (noisy) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                wgmma_rs<BN>(acc_sg, fs[kk], d_shi + 2 * kk);
                wgmma_rs<BN>(acc_sg, fs[kk], d_slo + 2 * kk);
                if (MODE == MODE_DX) wgmma_rs<BN>(acc_sg, fs[kk], d_slo2 + 2 * kk);
            }
        }
        wgmma_commit();
        wgmma_wait<1>();  // the group of tile t - 1 has retired: release its stage
        if (t > 0 && lane == 0) mbar_arrive(&empty[(t - 1) % C::STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc_mu);
    fence_regs(acc_sg);

#pragma unroll
    for (int jb = 0; jb < BN / 8; ++jb) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int k = kr + 8 * h;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                const int j = j0 + 8 * jb + 2 * tq + c;
                if (j >= J || k >= K) continue;
                const float mu = acc_mu[4 * jb + 2 * h + c];
                const float sg = acc_sg[4 * jb + 2 * h + c];
                const size_t o = (size_t)j * K + k;
                if (MODE == MODE_DX) {
                    float v = port::bf16_round(mu);
                    if (noisy) v = v + port::bf16_round(port::bf16_round(sg) * fin[h]);
                    out0[o] = __float2bfloat16(v);
                } else if (part != nullptr) {
                    const size_t plane = (size_t)J * K;
                    part[(size_t)blockIdx.z * plane + o] = mu;
                    if (noisy) part[((size_t)S + blockIdx.z) * plane + o] = sg;
                } else {
                    out0[o] = __float2bfloat16(mu);
                    if (noisy) out1[o] = __float2bfloat16(sg);
                }
            }
        }
    }
}

// ------------------------------------------------------------ 4. finalize
__global__ void k3b_finalize_kernel(const float* __restrict__ part,  // [2][S][N, K] or null
                                const float* __restrict__ dbp,   // [chunks, N]
                                const float* __restrict__ f_out, // [N] or null (greedy)
                                __nv_bfloat16* __restrict__ dw_mu, __nv_bfloat16* __restrict__ dw_sigma,
                                float* __restrict__ db_mu, float* __restrict__ db_sigma, int N,
                                int K, int S, int chunks) {
    const bool noisy = f_out != nullptr;
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    const size_t plane = (size_t)N * K;
    if (part != nullptr && i < plane) {
        float s = 0.f, ss = 0.f;
        for (int c = 0; c < S; ++c) {
            s += part[(size_t)c * plane + i];
            if (noisy) ss += part[((size_t)S + c) * plane + i];
        }
        dw_mu[i] = __float2bfloat16(s);
        if (noisy) dw_sigma[i] = __float2bfloat16(ss);
    }
    if (i < (size_t)N) {
        float s = 0.f;
        for (int c = 0; c < chunks; ++c) s += dbp[(size_t)c * N + i];
        db_mu[i] = s;
        if (noisy) db_sigma[i] = f_out[i] * s;
    }
}

template <int MODE, int BN>
int launch_gemm(const CUtensorMap& a0, const CUtensorMap& a1, const CUtensorMap& b,
                const float* f_in, __nv_bfloat16* out0, __nv_bfloat16* out1, float* part, int J,
                int K, int plane_rows, int d_tiles, int S, cudaStream_t stream) {
    using C = Gemm<MODE, BN>;
    static bool smem_opted_in = false;  // once, before any graph capture
    if (!smem_opted_in) {
        const cudaError_t err = cudaFuncSetAttribute(
            k3b_gemm_kernel<MODE, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
        if (err != cudaSuccess) return (int)err;
        smem_opted_in = true;
    }
    const dim3 grid((J + BN - 1) / BN, (K + BK - 1) / BK, S);
    k3b_gemm_kernel<MODE, BN><<<grid, THREADS, C::SMEM, stream>>>(
        a0, a1, b, f_in, out0, out1, part, J, K, plane_rows, d_tiles, S);
    return (int)cudaGetLastError();
}

}  // namespace

// Workspaces, from the wrapper's plan (kernels/noisy_linear.py):
//   ws_bf16: p_planes * M * N8 (P) then planes * N8 * MP (PT) bf16 values,
//   ws_f32:  (MP / 32) * N (dbp) then, when S > 1, 2 * S * N * K (partials),
// with p_planes = 5 noisy, 2 greedy, and planes = 4 noisy, 2 greedy.  bn_w is dW's tile width over n (8, 24 or
// 64), S (<= the 64-row tiles of M) the chunks of dW's depth.
PORT_API int port_noisy_linear_bwd(const void* g, const void* y, const void* xc,
                                   const void* w_mu, const void* w_sigma, const void* f_in,
                                   const void* f_out, void* dxc, void* dw_mu, void* dw_sigma,
                                   void* db_mu, void* db_sigma, void* ws_bf16, void* ws_f32,
                                   int M, int N, int K, int bn_w, int S, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (M <= 0 || N <= 0 || K <= 0 || K % 8 || S < 1) return (int)cudaErrorInvalidValue;
    const bool noisy = w_sigma != nullptr;
    const int N8 = (N + 7) / 8 * 8;
    const int MP = (M + 7) / 8 * 8;
    const int planes = noisy ? 4 : 2;
    const int p_planes = noisy ? 5 : 2;
    const int m_tiles = (M + TILE_K - 1) / TILE_K;
    if (S > m_tiles) return (int)cudaErrorInvalidValue;  // no chunk may be empty
    auto* P = static_cast<__nv_bfloat16*>(ws_bf16);
    __nv_bfloat16* PT = P + (size_t)p_planes * M * N8;
    auto* dbp = static_cast<float*>(ws_f32);
    const int db_chunks = (MP + 31) / 32;
    float* part = S > 1 ? dbp + (size_t)db_chunks * N : nullptr;
    const float* fi = noisy ? static_cast<const float*>(f_in) : nullptr;
    const float* fo = noisy ? static_cast<const float*>(f_out) : nullptr;

    k3b_prep_kernel<<<dim3((N8 + 31) / 32, db_chunks), dim3(32, 8), 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(y), fo, P, PT, dbp, M, N, N8, MP);
    int err = (int)cudaGetLastError();
    if (err) return err;

    CUtensorMap m_wmu, m_wsg, m_p, m_x, m_pt;
    if (!make_map(&m_wmu, w_mu, N, K, K, 64) ||
        (noisy && !make_map(&m_wsg, w_sigma, N, K, K, 64)) ||
        !make_map(&m_p, P, (uint64_t)p_planes * M, N8, N8, 64) ||
        !make_map(&m_x, xc, M, K, K, 64) ||
        !make_map(&m_pt, PT, (uint64_t)planes * N8, MP, MP, bn_w))
        return (int)cudaErrorInvalidValue;
    if (!noisy) m_wsg = m_wmu;  // never read

    auto* dx = static_cast<__nv_bfloat16*>(dxc);
    err = launch_gemm<MODE_DX, 64>(m_wmu, m_wsg, m_p, fi, dx, nullptr, nullptr, M, K, M,
                                   (N8 + TILE_K - 1) / TILE_K, 1, s);
    if (err) return err;
    auto* wm = static_cast<__nv_bfloat16*>(dw_mu);
    auto* ws = static_cast<__nv_bfloat16*>(dw_sigma);
    switch (bn_w) {
        case 8: err = launch_gemm<MODE_DW, 8>(m_x, m_x, m_pt, fi, wm, ws, part, N, K, N8, m_tiles, S, s); break;
        case 24: err = launch_gemm<MODE_DW, 24>(m_x, m_x, m_pt, fi, wm, ws, part, N, K, N8, m_tiles, S, s); break;
        case 64: err = launch_gemm<MODE_DW, 64>(m_x, m_x, m_pt, fi, wm, ws, part, N, K, N8, m_tiles, S, s); break;
        default: return (int)cudaErrorInvalidValue;
    }
    if (err) return err;
    const size_t work = part != nullptr ? (size_t)N * K : (size_t)N;
    k3b_finalize_kernel<<<(unsigned)((work + 255) / 256), 256, 0, s>>>(
        part, dbp, fo, wm, ws, static_cast<float*>(db_mu), static_cast<float*>(db_sigma), N, K, S,
        db_chunks);
    return (int)cudaGetLastError();
}
