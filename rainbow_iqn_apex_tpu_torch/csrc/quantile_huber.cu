// K1: the pairwise quantile-Huber loss of IQN with its gradient and, in its
// weighted mode, the learn step's IS-weighted batch mean, forward only.
//
//   u[b, i, j]  = target[b, j] - online[b, i]
//   rho         = |tau[b, i] - 1{u < 0}| * Huber_k(u) / k
//   loss[b]     = sum_i mean_j rho                                  (per_sample)
//   td_abs[b]   = mean_ij |u|
//   grad[b, i]  = d loss[b] / d online[b, i] = -(1/N') sum_j |tau_i - 1{u<0}| * clip(u, -k, k) / k
//   mean        = mean_b (w[b] * loss[b]),  w = weight (* scale)    (weighted mode)
//
// Replaces the Pallas kernel that rainbow_iqn_apex_tpu once had for this loss
// (quantile_huber.py, _qh_kernel and its custom VJP; deleted, the live
// reference is ops/losses.py:31 quantile_huber_loss) and the weighted mean
// of ops/learn.py:158-162, weight * weight_scale formed first as JAX forms
// it.  As in the Pallas kernel the forward also emits d loss[b] / d online,
// so the backward (K4-bwd's loss mode) needs no second pass over the pairs.
// Huber takes the quadratic branch at |u| == k, as jnp.where(|u| <= k, ...)
// does; its derivative is then clip(u, -k, k) everywhere.  Everything is fp32.
//
// Bound on the H100: at B = 32, N = N' = 64 the inputs are ~24 KB and the
// pair tile is 131072 pairs of a dozen flops: far below a microsecond either
// way, so the launch is the cost and the kernel's own latency is what a
// design can cut.  Design: a block holds S samples, their targets, online
// quantiles and taus loaded into shared memory at once; a warp takes 4
// online quantiles i (up to 32 warps a block, so at S = 2 and N = 64 each
// warp takes one such item and the SM hides their latency), 8 lanes a row
// over j, so a lane walks N' / 8 pairs and each row's sums meet in a 3-step
// shuffle butterfly.  Each sample's rows are then summed by one warp
// (lane-strided, then a 5-step butterfly).  The per-sample mode runs one
// sample a block.  In the weighted mode the blocks are one thread-block
// cluster of C <= 16 blocks (S = ceil(B / C)): each other block sends its
// w * loss[b] into block 0's shared memory with st.async, completing on
// block 0's mbarrier (the cluster barrier that makes that barrier visible is
// arrived at on entry and waited on after the pairs, so it costs no wait),
// and block 0's first warp sums them, lane l taking b = l, l + 32, ...,
// then a butterfly: every sum has a fixed order, so two calls on one input
// give equal bits, and the mean is written by the launch that computed it,
// with nothing kept between launches.
//
// K6 folded in (the fused Anakin step, replay/device.py:build_device_learn):
// given the device ring's priorities, max_priority and the draws' ids [G, B /
// G], the weighted launch also does K6's fenced write-back of its own td_abs
// (csrc/replay_writeback.cu: pri = (td_abs + eps)^omega, max_priority =
// max(max_priority, max pri), then the groups' fenced scatters in order, the
// last occurrence of a repeated id winning, an id outside the ring dropped),
// through the same scatter_group (writeback.cuh), so the step launches no K6
// of its own.  Each sample's priority is formed where its td_abs is, and the
// other blocks send theirs into block 0 beside their w * loss; block 0 loads
// the ids, max_priority and group 0's fence values p[id] at entry (the ids
// before its inputs), while the pairs run.  After the sends have landed, warp 0 takes the maximum with the
// mean and, where a group has at most 32 draws (B 32: the main path), writes
// the groups back alone, its barriers __syncwarp; a larger group takes the
// whole block.
#include <algorithm>
#include <atomic>
#include <initializer_list>

#include "common.cuh"
#include "hopper.cuh"
#include "writeback.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kRows = 4;             // online quantiles a warp takes at once
constexpr int kLanesJ = 32 / kRows;  // lanes over the targets of one row
constexpr int kMaxCluster = 16;      // blocks of the weighted mode's cluster
constexpr size_t kMaxShared = 225 * 1024;  // dynamic, below the 227 KB a block can opt into
constexpr unsigned kSpinLimit = 1u << 22;  // polls of the barrier before the kernel traps

template <int kLanes>
__device__ __forceinline__ float butterfly(float v) {
#pragma unroll
    for (int off = kLanes / 2; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// relaxed: the one write it publishes, block 0's barrier, is ordered by
// fence.mbarrier_init.release.cluster before it
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of shared variable `addr` (this block's) in block `rank` of the cluster.
__device__ __forceinline__ uint32_t peer(uint32_t addr, int rank) {
    uint32_t out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
    return out;
}

// 4 bytes into block 0's shared memory, completing 4 bytes of its barrier's transaction count.
__device__ __forceinline__ void send(uint32_t addr, float v, uint32_t bar) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];"
                 ::"r"(addr), "f"(v), "r"(bar) : "memory");
}

// Wait for phase 0 of this block's barrier, acquiring at cluster scope what
// the other blocks sent into it; a phase that never completes traps.
__device__ __forceinline__ void wait_sent(uint64_t* bar) {
    const uint32_t addr = hopper::smem_u32(bar);
    uint32_t done = 0, spins = 0;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(addr)
            : "memory");
        if (++spins == kSpinLimit) __trap();
    } while (!done);
}

// weight null: the per-sample mode; else the weighted mode, the grid one
// cluster; kFold: K6 folded in (weighted mode only), its own instantiation,
// so the other modes run the code they ran before
template <bool kFold>
__global__ void __launch_bounds__(kMaxThreads) quantile_huber_kernel(
    const float* __restrict__ online,  // [B, N]
    const float* __restrict__ taus,    // [B, N]
    const float* __restrict__ target,  // [B, NT]
    const float* __restrict__ weight,  // [B] (weighted)
    const float* __restrict__ scale,   // [B] or null
    float* __restrict__ per_sample,    // [B]
    float* __restrict__ td_abs,        // [B]
    float* __restrict__ grad,          // [B, N]
    float* __restrict__ mean,          // [1] (weighted)
    int B, int N, int NT, int S, float kappa,
    float* __restrict__ ring,          // [N_ring] the device ring's priorities, or null
    float* __restrict__ max_priority,  // [] (ring)
    const int* __restrict__ ids,       // [G, B / G] (ring)
    int n_ring, int G, float eps, float omega) {
    extern __shared__ __align__(16) float smem[];
    __shared__ uint64_t arrived;        // block 0's barrier: every block's w * loss[b] landed
    const bool weighted = weight != nullptr;
    constexpr bool fold = kFold;
    float* tgt = smem;                  // [S, NT]
    float* on = tgt + S * NT;           // [S, N]
    float* tau_s = on + S * N;          // [S, N]
    float* row_loss = tau_s + S * N;    // [S, N]
    float* row_abs = row_loss + S * N;  // [S, N]
    float* wl = row_abs + S * N;        // [B] in block 0 (weighted): w[b] * loss[b]
    float* ta = wl + B;                 // [B] in block 0 (fold): the priorities
    int* sid = reinterpret_cast<int*>(ta + B);  // [B] in block 0 (fold): the ids
    const int warps = blockDim.x / 32;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int b0 = blockIdx.x * S;
    const int count = min(S, B - b0);
    // fold: block 0 issues its loads of group 0's ids and max_priority first
    const int per_group = fold ? B / G : 0;
    const bool fold0 = fold && blockIdx.x == 0;
    int slot0 = -1;
    float max0 = 0.f;
    if (fold0) {
        if (threadIdx.x < per_group) slot0 = ids[threadIdx.x];
        if (threadIdx.x == 0) max0 = *max_priority;
    }
    // the block's inputs, every load in flight at once
#pragma unroll 4
    for (int k = threadIdx.x; k < count * NT; k += blockDim.x) tgt[k] = target[(size_t)b0 * NT + k];
#pragma unroll 4
    for (int k = threadIdx.x; k < count * N; k += blockDim.x) {
        on[k] = online[(size_t)b0 * N + k];
        tau_s[k] = taus[(size_t)b0 * N + k];
    }
    // fold: then every id into shared memory and group 0's fence values, read
    // while the pairs run
    float cur0 = 0.f;
    if (fold0) {
        for (int b = threadIdx.x; b < B; b += blockDim.x) sid[b] = ids[b];
        if (slot0 >= 0 && slot0 < n_ring) cur0 = ring[slot0];
    }
    if (weighted) {
        if (blockIdx.x == 0 && threadIdx.x == 0) {
            hopper::mbar_init(&arrived, 1);
            hopper::mbar_init_fence();
            // the other blocks' w * loss[b] (and td_abs[b] with the fold)
            hopper::mbar_expect_tx(&arrived, (uint32_t)(B - count) * (fold ? 8u : 4u));
        }
        __syncwarp();
        cluster_arrive();  // block 0's barrier is set; the wait comes before the sends
    }
    __syncthreads();

    const float inv_k = 1.f / kappa, half_k = 0.5f * kappa;
    const float inv_nt = 1.f / (float)NT;
    const int quads = (N + kRows - 1) / kRows;
    const int r = lane / kLanesJ, jl = lane % kLanesJ;
    for (int item = warp; item < count * quads; item += warps) {
        const int s = item / quads;
        const int i = (item - s * quads) * kRows + r;
        const bool live = i < N;
        const int si = s * N + (live ? i : 0);
        const float o = on[si];
        // |tau - 1{u < 0}| for either sign of u, as the pair would form it
        const float w_neg = fabsf(tau_s[si] - 1.f), w_pos = fabsf(tau_s[si]);
        const float* t = tgt + s * NT;
        float s_rho = 0.f, s_abs = 0.f, s_grad = 0.f;  // the 1 / k comes after the sums
#pragma unroll 4
        for (int j = jl; j < NT; j += kLanesJ) {
            const float u = t[j] - o;
            const float au = fabsf(u);
            const float w = u < 0.f ? w_neg : w_pos;
            const float h = au <= kappa ? 0.5f * u * u : kappa * (au - half_k);
            s_rho += w * h;
            s_abs += au;
            s_grad += w * fminf(fmaxf(u, -kappa), kappa);
        }
        s_rho = butterfly<kLanesJ>(s_rho);
        s_abs = butterfly<kLanesJ>(s_abs);
        s_grad = butterfly<kLanesJ>(s_grad);
        if (live && jl == 0) {
            grad[(size_t)b0 * N + si] = -(s_grad * inv_k) * inv_nt;
            row_loss[si] = (s_rho * inv_k) * inv_nt;
            row_abs[si] = s_abs;
        }
    }
    __syncthreads();
    if (weighted) cluster_wait();  // every block has started: block 0's barrier is set
    for (int s = warp; s < count; s += warps) {
        float l = 0.f, a = 0.f;
        for (int i = lane; i < N; i += 32) {
            l += row_loss[s * N + i];
            a += row_abs[s * N + i];
        }
        l = butterfly<32>(l);
        a = butterfly<32>(a);
        if (lane == 0) {
            const int b = b0 + s;
            const float t = a / ((float)N * (float)NT);
            per_sample[b] = l;
            td_abs[b] = t;
            if (weighted) {
                const float w = scale != nullptr ? __fmul_rn(weight[b], scale[b]) : weight[b];
                const float v = __fmul_rn(w, l);
                const float pri = fold ? port::priority_of(t + eps, omega) : 0.f;
                if (blockIdx.x == 0) {
                    wl[b] = v;
                    if (fold) ta[b] = pri;
                } else {
                    const uint32_t bar = peer(hopper::smem_u32(&arrived), 0);
                    send(peer(hopper::smem_u32(wl + b), 0), v, bar);
                    if (fold) send(peer(hopper::smem_u32(ta + b), 0), pri, bar);
                }
            }
        }
    }
    // block 0 sums its own and what every other block sent, in the order of b
    if (!weighted || blockIdx.x != 0) return;
    __syncthreads();
    // warp 0 takes the mean (and the fold's maximum) and the scatter of
    // groups of at most 32 draws; larger groups take the whole block
    const bool one_warp = per_group <= 32;
    if (one_warp && warp != 0) return;
    wait_sent(&arrived);
    if (warp == 0) {
        float acc = 0.f, m = -INFINITY;
        for (int b = lane; b < B; b += 32) {
            acc += wl[b];
            if (fold) m = port::nan_max(m, ta[b]);
        }
        acc = butterfly<32>(acc);
        if (lane == 0) *mean = acc / (float)B;
        if (fold) {
#pragma unroll
            for (int off = 16; off > 0; off /= 2)
                m = port::nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
            if (lane == 0) *max_priority = port::nan_max(max0, m);  // K6's, before the fence
        }
    }
    if (!fold) return;
    // K6: each group's fenced scatter in order
    const int k = threadIdx.x;
    const auto sync = [one_warp] {
        if (one_warp)
            __syncwarp();
        else
            __syncthreads();
    };
    for (int g = 0; g < G; ++g) {
        const int i = g * per_group + k;
        int slot[1] = {k < per_group ? (g == 0 ? slot0 : sid[i]) : -1};
        bool inside[1] = {k < per_group && slot[0] >= 0 && slot[0] < n_ring};
        float pri[1] = {k < per_group ? ta[i] : 0.f};
        // group 0's fence was read at entry; a later group's reads what the earlier ones left
        float cur[1] = {inside[0] ? (g == 0 ? cur0 : ring[slot[0]]) : 0.f};
        port::scatter_group<1>(sid + g * per_group, per_group, slot, inside, pri, cur, true,
                               [&](int s, float v) { ring[s] = v; }, sync);
    }
}

std::atomic<unsigned long long> ready{0};

// The kernel's shared-memory ceiling and, for clusters above 8 blocks, the
// non-portable cluster size; once per device.
cudaError_t prepare() {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = 1ull << (device & 63);
    if (ready.load() & bit) return cudaSuccess;
    for (const void* kernel : {(const void*)quantile_huber_kernel<false>,
                               (const void*)quantile_huber_kernel<true>}) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kMaxShared);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return err;
    }
    ready.fetch_or(bit);
    return cudaSuccess;
}

}  // namespace

// K1 over S samples a block (kernels/quantile_huber.py: loss_plan), ceil(B / S)
// blocks, a warp for each 4 of a block's S * N rows up to 32 warps.  weight
// null: the per-sample mode.  Else the weighted mean too, the blocks one
// cluster (at most 16); and with ring (p [n_ring] f32, max_priority [] f32,
// ids [G, B / G] int32, updated in place) K6's write-back of td_abs.
PORT_API int port_quantile_huber(const void* online, const void* taus, const void* target,
                                 const void* weight, const void* scale, void* per_sample,
                                 void* td_abs, void* grad, void* mean, int B, int N, int NT,
                                 int S, float kappa, void* ring, void* max_priority,
                                 const void* ids, int n_ring, int G, float eps, float omega,
                                 void* stream) {
    const bool weighted = weight != nullptr;
    const bool fold = ring != nullptr;
    const size_t smem =
        (size_t)(S * NT + 4 * S * N + (weighted ? B : 0) + (fold ? 2 * B : 0)) * sizeof(float);
    const long long blocks = B >= 1 && S >= 1 ? ((long long)B + S - 1) / S : 0;
    const long long warps = (long long)S * ((N + kRows - 1) / kRows);
    const int threads = 32 * (int)std::min<long long>(warps, kMaxThreads / 32);
    if (B < 1 || N < 1 || NT < 1 || S < 1 || smem > kMaxShared ||
        (weighted && (blocks > kMaxCluster || mean == nullptr)) ||
        (fold && (!weighted || max_priority == nullptr || ids == nullptr || n_ring < 1 ||
                  G < 1 || B % G != 0 || B / G > threads)))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = prepare();
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)blocks, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = weighted ? (unsigned)blocks : 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, fold ? quantile_huber_kernel<true> : quantile_huber_kernel<false>,
                             static_cast<const float*>(online),
                             static_cast<const float*>(taus), static_cast<const float*>(target),
                             static_cast<const float*>(weight), static_cast<const float*>(scale),
                             static_cast<float*>(per_sample), static_cast<float*>(td_abs),
                             static_cast<float*>(grad), static_cast<float*>(mean), B, N, NT, S,
                             kappa, static_cast<float*>(ring), static_cast<float*>(max_priority),
                             static_cast<const int*>(ids), n_ring, G, eps, omega);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
