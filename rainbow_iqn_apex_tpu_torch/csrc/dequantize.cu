// K10d: dequantize a table of small leaves in one launch.
//
//   out = round(fp32(q) * s, out dtype)    one scale per row of row_len values, or one
//
// Replaces the conv and embedding leaves of rainbow_iqn_apex_tpu/utils/
// quantize.py dequantize_tree_jax (:219-236), which XLA fuses into the
// quantized act executable before the flax layers round them to the compute
// dtype.  The product is __fmul_rn (no contraction), then one rounding to
// bf16 (or none, for an fp32 output): the weights the JAX graph feeds its
// convs and its embedding Dense.  fp8 q decodes exactly (e4m3 is a subset
// of half).
//
// Bound on the H100: ~0.85 MB of traffic for the full-width tree's 281,824
// values, a fraction of a microsecond: launch-bound.  Design: the leaf table
// is a kernel argument; one thread per value, which finds its leaf by a scan
// of the table's value offsets (8 leaves).
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SEGS = 16;  // kernels/dequantize.py MAX_SEGMENTS

struct DSeg {
    const void* q;   // int8 or e4m3 bytes
    const float* s;  // [numel / row_len] when per_row, else [1]
    void* out;       // bf16 or fp32
    int start;       // first global value of this leaf
    int numel;
    int row_len;
    int per_row;
    int out_fp32;
};

struct DTable {
    DSeg seg[MAX_SEGS];
    int nseg;
    int fp8;
};

__global__ void __launch_bounds__(THREADS) dequantize_kernel(const DTable t, int total) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= total) return;
    int k = 0;
    while (k + 1 < t.nseg && i >= t.seg[k + 1].start) ++k;
    const DSeg g = t.seg[k];
    const int j = i - g.start;
    const uint8_t b = static_cast<const uint8_t*>(g.q)[j];
    float v;
    if (t.fp8) {
        v = __half2float(__half(__nv_cvt_fp8_to_halfraw(b, __NV_E4M3)));
    } else {
        v = (float)(int8_t)b;
    }
    const float r = __fmul_rn(v, g.s[g.per_row ? j / g.row_len : 0]);
    if (g.out_fp32) {
        static_cast<float*>(g.out)[j] = r;
    } else {
        static_cast<__nv_bfloat16*>(g.out)[j] = __float2bfloat16_rn(r);
    }
}

}  // namespace

PORT_API int port_dequantize(const void* segs, int nseg, int fp8, void* stream) {
    if (nseg < 1 || nseg > MAX_SEGS) return (int)cudaErrorInvalidValue;
    DTable t;
    const DSeg* in = static_cast<const DSeg*>(segs);
    for (int i = 0; i < nseg; ++i) t.seg[i] = in[i];
    t.nseg = nseg;
    t.fp8 = fp8;
    const int total = in[nseg - 1].start + in[nseg - 1].numel;
    dequantize_kernel<<<(total + THREADS - 1) / THREADS, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(t, total);
    return (int)cudaGetLastError();
}
