// K10q: quantize every parameter of a network in one launch.
//
//   int8: s = max|w| * fp32(1/127) per row (1 for an all-zero row),
//         q = clip(rint(w / s), -127, 127)
//   fp8:  q = e4m3(w), s = 1; |w| > 464 and NaN give NaN, [448, 464] -> 448
//
// Replaces rainbow_iqn_apex_tpu/utils/quantize.py quantize_tree_jax (:173-192)
// and cast_tree_fp8 (:195-208), XLA-fused on the TPU.  A row is one output
// channel (dim 0) of a rank >= 2 parameter with per-channel scales, or a
// whole tensor with one scale.  The scale is a product, __fmul_rn(m,
// 1/127): XLA rewrites the JAX source's division by the constant 127 into
// that product, one ulp off the quotient for some rows.  w / s is
// __fdiv_rn (this file is built without --use_fast_math) and rintf rounds
// half to even: q and s are bit-equal to the JAX package's fp32 arithmetic.
// The fp8 cast is __nv_cvt_float_to_fp8(x, __NV_NOSAT, __NV_E4M3), with NaN
// (0x7f and x's sign) set explicitly above 464 and for NaN and inf, as
// ml_dtypes casts.
//
// Bound on the H100: 26.9 MB of fp32 read and 6.73 MB of q written for the
// full-width tree, ~10 us at 3.35 TB/s.  Design: the parameter table is a
// kernel argument (no upload, no sync: it runs inside a no-sync region and
// a CUDA graph); one block of 256 threads per row, found by a scan of the
// table's row offsets; a max-abs reduction (warp shuffles, then one word per
// warp in shared memory), then the quantize pass over the row it just read,
// which L2 still holds.  Rows are 64 to 3,136 values, so a block is short
// and ~5,000 of them fill the card.
#include <cuda_fp8.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SEGS = 32;  // kernels/quantize.py MAX_SEGMENTS
constexpr float FP8_NAN_ABOVE = 464.f;
constexpr float INV_127 = 1.f / 127.f;  // 0.00787401572f, XLA's constant

struct QSeg {
    const float* src;  // fp32, rows x cols, contiguous
    void* q;           // int8 or e4m3 bytes, same layout
    float* s;          // [rows] when per_row, else [1]
    int rows;
    int cols;
    int row0;  // first global row of this segment
    int per_row;
};

struct QTable {
    QSeg seg[MAX_SEGS];
    int nseg;
    int fp8;
};

__device__ __forceinline__ uint8_t to_e4m3(float x) {
    if (!(fabsf(x) <= FP8_NAN_ABOVE)) return signbit(x) ? 0xFF : 0x7F;
    return (uint8_t)__nv_cvt_float_to_fp8(x, __NV_NOSAT, __NV_E4M3);
}

__global__ void __launch_bounds__(THREADS) quantize_kernel(const QTable t) {
    __shared__ float warp_max[THREADS / 32];
    int k = 0;
    while (k + 1 < t.nseg && (int)blockIdx.x >= t.seg[k + 1].row0) ++k;
    const QSeg g = t.seg[k];
    const int r = blockIdx.x - g.row0;
    const float* w = g.src + (size_t)r * g.cols;
    if (t.fp8) {
        uint8_t* q = static_cast<uint8_t*>(g.q) + (size_t)r * g.cols;
        for (int i = threadIdx.x; i < g.cols; i += THREADS) q[i] = to_e4m3(w[i]);
        if (r == 0 && threadIdx.x == 0) g.s[0] = 1.f;
        return;
    }
    float m = 0.f;
    for (int i = threadIdx.x; i < g.cols; i += THREADS) m = fmaxf(m, fabsf(w[i]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
    __syncthreads();
    m = warp_max[0];
#pragma unroll
    for (int j = 1; j < THREADS / 32; ++j) m = fmaxf(m, warp_max[j]);
    const float s = m > 0.f ? __fmul_rn(m, INV_127) : 1.f;
    if (threadIdx.x == 0) g.s[g.per_row ? r : 0] = s;
    int8_t* q = static_cast<int8_t*>(g.q) + (size_t)r * g.cols;
    for (int i = threadIdx.x; i < g.cols; i += THREADS) {
        const float v = fminf(fmaxf(rintf(__fdiv_rn(w[i], s)), -127.f), 127.f);
        q[i] = (int8_t)(int)v;
    }
}

}  // namespace

PORT_API int port_quantize(const void* segs, int nseg, int fp8, void* stream) {
    if (nseg < 1 || nseg > MAX_SEGS) return (int)cudaErrorInvalidValue;
    QTable t;
    const QSeg* in = static_cast<const QSeg*>(segs);
    int rows = 0;
    for (int i = 0; i < nseg; ++i) {
        t.seg[i] = in[i];
        rows += in[i].rows;
    }
    t.nseg = nseg;
    t.fp8 = fp8;
    quantize_kernel<<<rows, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(t);
    return (int)cudaGetLastError();
}
