// K8s-stack: the in-sequence frame stack of R2D2's learner, uint8.
//
// Replaces rainbow_iqn_apex_tpu/ops/r2d2.py:stack_seq_frames (:59-77), which
// XLA fuses on the TPU: [B, L, H, W] single frames -> [B, L, H, W, h] with
//
//   out[b, t, y, x, k] = obs[b, t - (h - 1 - k), y, x]   (0 before the sequence starts)
//
// Bound on the H100: bytes.  At the learner's [32, 120, 84, 84], h 4, it
// reads 27 MB and writes 108 MB, ~40 us at 3.35 TB/s.  Design: one thread
// per four pixels of one (b, t) frame when h is 4 and H*W a multiple of 4:
// it loads one 32-bit word from each of the four source frames and writes the
// 4 x 4 transposed bytes as one 16-byte store, so reads and writes are wide
// and coalesced.  Any other h or frame size (or an unaligned pointer) takes
// the simple path, one thread per pixel.
#include <cstdint>

#include "common.cuh"

namespace {

__global__ void seq_stack4_kernel(const unsigned int* __restrict__ obs,  // [B, L, P/4] words
                                  uint4* __restrict__ out,               // [B, L, P/4] x 16 bytes
                                  long long frames, int L, int quads) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= frames * quads) return;
    const long long frame = i / quads;   // b * L + t
    const int q = (int)(i % quads);
    const int t = (int)(frame % L);
    unsigned int w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int back = 3 - k;  // channel k holds frame t - back
        w[k] = t >= back ? __ldg(obs + (frame - back) * quads + q) : 0u;
    }
    // pixel p of the four: bytes (w[0].p, w[1].p, w[2].p, w[3].p)
    unsigned int px[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
        const int shift = 8 * p;
        px[p] = ((w[0] >> shift) & 0xffu) | (((w[1] >> shift) & 0xffu) << 8) |
                (((w[2] >> shift) & 0xffu) << 16) | (((w[3] >> shift) & 0xffu) << 24);
    }
    out[i] = make_uint4(px[0], px[1], px[2], px[3]);
}

__global__ void seq_stack_kernel(const unsigned char* __restrict__ obs,  // [B, L, P]
                                 unsigned char* __restrict__ out,        // [B, L, P, h]
                                 long long frames, int L, int pixels, int h) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= frames * pixels) return;
    const long long frame = i / pixels;
    const int p = (int)(i % pixels);
    const int t = (int)(frame % L);
    for (int k = 0; k < h; ++k) {
        const int back = h - 1 - k;
        out[i * h + k] = t >= back ? obs[(frame - back) * pixels + p] : (unsigned char)0;
    }
}

}  // namespace

PORT_API int port_seq_stack(const void* obs, void* out, int B, int L, int pixels, int h,
                            void* stream) {
    if (B < 1 || L < 1 || pixels < 1 || h < 1) return (int)cudaErrorInvalidValue;
    const long long frames = (long long)B * L;
    const int threads = 256;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool aligned = reinterpret_cast<uintptr_t>(obs) % 4 == 0 &&
                         reinterpret_cast<uintptr_t>(out) % 16 == 0;
    if (h == 4 && pixels % 4 == 0 && aligned) {
        const int quads = pixels / 4;
        const long long n = frames * quads;
        seq_stack4_kernel<<<(unsigned int)((n + threads - 1) / threads), threads, 0, s>>>(
            static_cast<const unsigned int*>(obs), static_cast<uint4*>(out), frames, L, quads);
    } else {
        const long long n = frames * pixels;
        seq_stack_kernel<<<(unsigned int)((n + threads - 1) / threads), threads, 0, s>>>(
            static_cast<const unsigned char*>(obs), static_cast<unsigned char*>(out), frames, L,
            pixels, h);
    }
    return (int)cudaGetLastError();
}
