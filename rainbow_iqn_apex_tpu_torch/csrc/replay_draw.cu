// K5: the stratified proportional PER draw of the device replay.
//
//   total     = sum_i p[i]                                      (p: [N] f32, p >= 0)
//   cdf       = inclusive cumulative sum of p
//   u[g, k]   = (k + U[g, k]) / B * total                       (U: [G, B] uniforms in [0, 1))
//   idx[g, k] = min(#{i : cdf[i] <= u[g, k]}, N - 1)            (searchsorted side="right", clipped)
//
// Replaces DeviceReplay.draw (rainbow_iqn_apex_tpu/replay/device.py:207-220)
// and the G vmapped draws of sample_grouped (:309-310), XLA-fused on the TPU.
// As there, a slot with p = 0 has the cdf of its left neighbour, so a right
// search never lands on it, and a u that rounds up to the total is clipped
// onto slot N - 1.  The total stays on the device (K8 reads it).
//
// Bound on the H100: the one read of p, 4 MB at N = 1,000,000 (~1.2 us at
// 3.35 TB/s); the G*B searches are a few hundred.  Design, three launches on
// one stream, no atomics:
//   1. chunk sums: one block per CHUNK = 1024 priorities computes the chunk's
//      local cdf and writes its last value;
//   2. one block chains the chunk sums into prefix[0..nchunks] (prefix[nchunks]
//      is the total) and writes the total;
//   3. one block per uniform counts the chunks whose whole prefix is <= u
//      (parallel over the prefix array), then rebuilds that one chunk's local
//      cdf and counts the slots in it with prefix + local cdf <= u.
// The cdf that passes 1 and 3 agree on is cdf[i] = prefix[c] + local[i], with
// prefix[c + 1] = prefix[c] + local[last of chunk c] and, inside a chunk,
// local[i] = off[t] + (the thread's own running sum), off[t + 1] = off[t] +
// (thread t's sum).  Every link of that chain is one rounded addition of a
// non-negative value to the previous link, so the cdf is monotone in fp32 as
// it is in exact arithmetic, and both passes compute it with the same code.
// The serial links (256 in a chunk, nchunks in pass 2) cost a few us; a
// faster scan is later work.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;
constexpr int CHUNK = THREADS * PER_THREAD;

// The local cdf of chunk `c` (0 past N) into v[], PER_THREAD consecutive
// values per thread; `sums` is [THREADS + 1] floats of shared memory, and
// sums[THREADS] holds the chunk's last cdf value on return.
__device__ __forceinline__ void chunk_cdf(const float* __restrict__ p, int n, int c,
                                          float v[PER_THREAD], float* sums) {
    const long base = (long)c * CHUNK + (long)threadIdx.x * PER_THREAD;
    if (base + PER_THREAD <= n) {
        const float4 q = *reinterpret_cast<const float4*>(p + base);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
        for (int i = 0; i < PER_THREAD; ++i) v[i] = base + i < n ? p[base + i] : 0.f;
    }
    for (int i = 1; i < PER_THREAD; ++i) v[i] += v[i - 1];
    sums[threadIdx.x] = v[PER_THREAD - 1];
    __syncthreads();
    if (threadIdx.x == 0) {  // off[t] chained in thread order: the monotone links
        float run = 0.f;
        for (int t = 0; t < THREADS; ++t) {
            const float s = sums[t];
            sums[t] = run;
            run += s;
        }
        sums[THREADS] = run;
    }
    __syncthreads();
    const float off = sums[threadIdx.x];
    for (int i = 0; i < PER_THREAD; ++i) v[i] = off + v[i];
}

__global__ void __launch_bounds__(THREADS) chunk_sums_kernel(const float* __restrict__ p, int n,
                                                             float* __restrict__ partial) {
    __shared__ float sums[THREADS + 1];
    float v[PER_THREAD];
    chunk_cdf(p, n, blockIdx.x, v, sums);
    if (threadIdx.x == THREADS - 1) partial[blockIdx.x] = v[PER_THREAD - 1];
}

__global__ void __launch_bounds__(THREADS) chain_kernel(const float* __restrict__ partial, int nchunks,
                                                        float* __restrict__ prefix,
                                                        float* __restrict__ total) {
    constexpr int TILE = 4096;
    __shared__ float tile[TILE];
    float run = 0.f;  // thread 0's running prefix
    for (int t0 = 0; t0 < nchunks; t0 += TILE) {
        const int m = min(TILE, nchunks - t0);
        for (int i = threadIdx.x; i < m; i += THREADS) tile[i] = partial[t0 + i];
        __syncthreads();
        if (threadIdx.x == 0) {
            for (int i = 0; i < m; ++i) {
                prefix[t0 + i] = run;
                run += tile[i];
            }
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        prefix[nchunks] = run;
        *total = run;
    }
}

__device__ __forceinline__ int block_sum(int x, int* red) {
    for (int d = 16; d > 0; d >>= 1) x += __shfl_down_sync(0xffffffffu, x, d);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
    __syncthreads();
    int s = 0;
    for (int w = 0; w < THREADS / 32; ++w) s += red[w];
    __syncthreads();
    return s;
}

__global__ void __launch_bounds__(THREADS) search_kernel(const float* __restrict__ p, int n,
                                                         const float* __restrict__ prefix, int nchunks,
                                                         const float* __restrict__ uniforms, int B,
                                                         int* __restrict__ idx) {
    __shared__ float sums[THREADS + 1];
    __shared__ int red[THREADS / 32];
    const int b = blockIdx.x;
    const float total = prefix[nchunks];
    const float u = ((float)(b % B) + uniforms[b]) / (float)B * total;
    // whole chunks before u: #{c : prefix[c + 1] <= u}, prefix is monotone
    int below = 0;
    for (int c = threadIdx.x; c < nchunks; c += THREADS) below += prefix[c + 1] <= u ? 1 : 0;
    const int c = block_sum(below, red);
    if (c >= nchunks) {  // u >= the last cdf value: searchsorted gives N, clipped
        if (threadIdx.x == 0) idx[b] = n - 1;
        return;
    }
    float v[PER_THREAD];
    chunk_cdf(p, n, c, v, sums);
    const float start = prefix[c];
    const long base = (long)c * CHUNK + (long)threadIdx.x * PER_THREAD;
    int count = 0;
    for (int i = 0; i < PER_THREAD; ++i) count += (base + i < n && start + v[i] <= u) ? 1 : 0;
    const int k = block_sum(count, red);
    if (threadIdx.x == 0) idx[b] = min(c * CHUNK + k, n - 1);
}

}  // namespace

PORT_API int port_replay_draw_scratch(int n) { return (n + CHUNK - 1) / CHUNK; }

// p [n] f32, uniforms [draws] f32 (draws = G * B, B = batch), partial
// [nchunks] and prefix [nchunks + 1] f32 scratch, idx [draws] int32, total []
// f32.  draws == 0 computes the total only.
PORT_API int port_replay_draw(const void* p, const void* uniforms, void* partial, void* prefix,
                              void* idx, void* total, int n, int draws, int B, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int nchunks = (n + CHUNK - 1) / CHUNK;
    chunk_sums_kernel<<<nchunks, THREADS, 0, s>>>(static_cast<const float*>(p), n,
                                                  static_cast<float*>(partial));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    chain_kernel<<<1, THREADS, 0, s>>>(static_cast<const float*>(partial), nchunks,
                                       static_cast<float*>(prefix), static_cast<float*>(total));
    err = cudaGetLastError();
    if (err != cudaSuccess || draws == 0) return (int)err;
    search_kernel<<<draws, THREADS, 0, s>>>(static_cast<const float*>(p), n,
                                            static_cast<const float*>(prefix), nchunks,
                                            static_cast<const float*>(uniforms), B,
                                            static_cast<int*>(idx));
    return (int)cudaGetLastError();
}
