// K11: the R2D2 TD and priority epilogue, loss and gradient in one launch,
// with K6s's write-back of the priorities folded in where the caller hands
// it the sequence ring.
//
// Replaces the loss_fn of rainbow_iqn_apex_tpu/ops/r2d2.py:build_r2d2_learn_step
// (:196-260) with value_rescale / value_unrescale (:33-43), which XLA fuses
// on the TPU.  Per sequence b over its train slice of T steps and A actions:
//
//   a*[t]     = argmax_a q_sel[b, t, a]             (first index on ties, NaN maximal)
//   q_boot[t] = h^-1(q_tgt[b, t, a*[t]])
//   for t < T - n:
//     R       = sum_k gamma^k r[t+k] * prod_{m<k} (1 - d[t+m])
//     done_w  = min(sum_k d[t+k], 1)
//     y       = h(R + gamma^n (1 - done_w) q_boot[t+n])
//     mask    = v[t] * min(done_w + v[t+n], 1)
//     td      = (y - q_taken[b, t]) * mask
//   per_seq   = sum_t huber(td) / max(sum_t mask, 1)
//   priority  = eta max_t |td| + (1 - eta) sum_t |td| / max(sum_t mask, 1)
//               (1 - eta, like gamma^n, rounded from double as JAX does)
//   loss      = mean_b weight[b] per_seq[b]
//   q_mean    = sum_{b,t} q_taken v / max(sum v, 1)      (over the whole slice)
//   dq_taken  = -(weight[b] / B) huber'(td) mask / max(sum_t mask, 1)
//
// h(x) = sign(x)(sqrt(|x| + 1) - 1) + eps x and its closed-form inverse.
// reward, done and valid are read in place from the sampled batch's [B, L]
// rows: the caller passes the train slice's first element and each row's
// stride, so the slice is never copied.
//
// K6s folded in (the R2D2 Anakin step, replay/device_sequence.py:
// build_device_r2d2_learn): given the ring's priorities, max_priority and the
// draws' ids [G, B / G], the launch also does K6s's write-back of the
// priorities it computes (csrc/replay_writeback.cu, port_seq_writeback):
// pri = (priority + eps)^omega, max_priority = max(max_priority, max pri),
// then each group's unfenced scatter in order, the last occurrence of a
// repeated id winning, an id outside the ring dropped, through the shared
// scatter_group (writeback.cuh).  The priorities are still written out.
//
// Bound on the H100: ~0.4 MB at B 32, T 80, A 18, a fraction of a
// microsecond of memory time, so the launch and the kernel's chain of
// dependent steps are the cost.  Design: one warp a sequence.  Its q_sel and
// q_tgt rows go into shared memory by cp.async and its q_taken, rewards,
// dones and valids into registers and shared memory, every load issued
// before any is used; lane l takes steps l, l + 32, ... for the argmax, the
// gather of q_tgt at a*, the n-step window (read from shared memory) and the
// gradient, and the sequence's mask count, Huber sum, |td| maximum and sum
// and the q-mean's sums meet in xor butterflies (a fixed order).  The blocks
// (at most 16, ceil(B / 16) sequences each: 2 at B 32) are one thread-block
// cluster whose blocks send each sequence's partials into block 0's shared
// memory by st.async, completing on block 0's mbarrier.  (All 32 sequences
// in one block of 32 warps, which needs no cluster, measured 0.0123 ms on
// the H100: one SM's four schedulers issue every warp's work.)  Block 0's
// warp 0 sums the batch in a fixed order (lane l takes sequences l, l + 32,
// ..., then a butterfly), so two calls on one input give equal bits, and
// nothing is kept between launches: no ticket, scratch or memset.
#include <algorithm>
#include <atomic>
#include <initializer_list>

#include "common.cuh"
#include "hopper.cuh"
#include "writeback.cuh"

namespace {

constexpr int kMaxSeqs = 32;        // sequences a block, a warp each
constexpr int kMaxCluster = 16;     // blocks of the cluster
constexpr int kMaxSteps = 256;      // T: at most 8 steps a lane
constexpr int kParts = 4;           // a sequence's partials: w * per_seq, q sum, valid count, pri
constexpr size_t kMaxShared = 225 * 1024;  // dynamic, below the 227 KB a block can opt into
constexpr unsigned kSpinLimit = 1u << 22;  // polls of the barrier before the kernel traps

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// A sequence's shared memory (kernels/r2d2_td.py: seq_bytes mirrors it): its
// q_sel and q_tgt rows [T, A], then q_boot and the rewards [T] f32, dones and
// valids [T] u8.
__host__ __device__ constexpr size_t seq_bytes(int T, int A) {
    return 2 * align16((size_t)T * A * 4) + align16((size_t)T * 10);
}

__device__ __forceinline__ float sign_f(float x) {
    return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// The constants 4 eps and 2 eps arrive rounded from double, as JAX folds the
// source's Python-float products before it casts them to fp32.
struct Rescale {
    float eps, eps4, eps2;
    __device__ __forceinline__ float h(float x) const {
        return sign_f(x) * (sqrtf(fabsf(x) + 1.f) - 1.f) + eps * x;
    }
    __device__ __forceinline__ float h_inv(float x) const {
        const float inner = sqrtf(1.f + eps4 * (fabsf(x) + 1.f + eps)) - 1.f;
        const float r = inner / eps2;
        return sign_f(x) * (r * r - 1.f);
    }
};

// The step's constants.
struct TD {
    int n;
    float gamma, gamma_n, eta, eta_c;
    Rescale hr;
};

// K6s's target: ring == nullptr, no write-back.
struct Ring {
    float* p;
    float* max_priority;
    const int* ids;  // [G, rows / G]
    int n, G;
    float eps, omega;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(hopper::smem_u32(dst)),
                 "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(hopper::smem_u32(dst)),
                 "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
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

// 16 bytes into block 0's shared memory, completing 16 bytes of its barrier's transaction count.
__device__ __forceinline__ void send4(uint32_t addr, float a, float b, float c, float d,
                                      uint32_t bar) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
        "[%5];" ::"r"(addr), "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar) : "memory");
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// kR: steps a lane (ceil(T / 32)); kFold: K6s folded in, its own
// instantiation, so the plain mode runs no code of the write-back
template <int kR, bool kFold>
__global__ void __launch_bounds__(kMaxSeqs * 32) r2d2_td_kernel(
    const float* __restrict__ q_taken,        // [B, T]
    const float* __restrict__ q_sel,          // [B, T, A]
    const float* __restrict__ q_tgt,          // [B, T, A]
    const float* __restrict__ reward,         // [B, T], row stride rs_r
    const unsigned char* __restrict__ done,   // [B, T], row stride rs_d
    const unsigned char* __restrict__ valid,  // [B, T], row stride rs_v
    long long rs_r, long long rs_d, long long rs_v,
    const float* __restrict__ weight,   // [B]
    float* __restrict__ loss,           // [1]
    float* __restrict__ priorities,     // [B]
    float* __restrict__ q_mean,         // [1]
    float* __restrict__ dq,             // [B, T]
    int B, int T, int A, int S, int vec, TD td, Ring ring) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ uint64_t arrived;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int b = blockIdx.x * S + warp;
    const bool live = b < B;
    const int n = td.n, Tn = T - n;
    unsigned char* mine = smem + (size_t)warp * seq_bytes(T, A);
    const size_t rows_bytes = align16((size_t)T * A * 4);
    float* qs_s = reinterpret_cast<float*>(mine);                           // [T, A] q_sel
    float* qt_s = reinterpret_cast<float*>(mine + rows_bytes);              // [T, A] q_tgt
    float* qboot = reinterpret_cast<float*>(mine + 2 * rows_bytes);         // [T]
    float* rew = qboot + T;                                                       // [T]
    unsigned char* dn = reinterpret_cast<unsigned char*>(rew + T);                // [T]
    unsigned char* vl = dn + T;                                                   // [T]
    float* parts = reinterpret_cast<float*>(smem + (size_t)S * seq_bytes(T, A));  // [B, 4] block 0

    // fold: block 0 issues its loads of group 0's ids and max_priority first
    const int per_group = kFold ? B / ring.G : 0;
    const bool fold0 = kFold && blockIdx.x == 0;
    int slot0 = -1;
    float max0 = 0.f;
    if (fold0) {
        if ((int)threadIdx.x < per_group) slot0 = ring.ids[threadIdx.x];
        if (threadIdx.x == 0) max0 = *ring.max_priority;
    }
    // the sequence's inputs, every load in flight before any is used
    float qt[kR], rw[kR];
    unsigned char dv[kR], vv[kR];
    float w = 0.f;
    if (live) {
        const float* sel = q_sel + (size_t)b * T * A;
        const float* tgt = q_tgt + (size_t)b * T * A;
        if (vec) {
            for (int i = lane; i < T * A / 4; i += 32) {
                cp_async16(qs_s + 4 * i, sel + 4 * i);
                cp_async16(qt_s + 4 * i, tgt + 4 * i);
            }
        } else {
            for (int i = lane; i < T * A; i += 32) {
                cp_async4(qs_s + i, sel + i);
                cp_async4(qt_s + i, tgt + i);
            }
        }
#pragma unroll
        for (int r = 0; r < kR; ++r) {
            const int t = lane + 32 * r;
            if (t < T) {
                qt[r] = q_taken[(size_t)b * T + t];
                rw[r] = reward[b * rs_r + t];
                dv[r] = done[b * rs_d + t];
                vv[r] = valid[b * rs_v + t];
            }
        }
        w = weight[b];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
            const int t = lane + 32 * r;
            if (t < T) {
                rew[t] = rw[r];
                dn[t] = dv[r];
                vl[t] = vv[r];
            }
        }
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        hopper::mbar_init(&arrived, 1);
        hopper::mbar_init_fence();
        // every other block's sequences, kParts floats each (none in a cluster of one)
        hopper::mbar_expect_tx(&arrived, (uint32_t)(B - min(S, B)) * kParts * 4u);
    }
    __syncwarp();
    cluster_arrive();  // block 0's barrier is set; the wait comes before the sends
    cp_async_wait_all();
    __syncwarp();

    // a*, and q_tgt at a*, both from shared memory
    int best[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
        const int t = lane + 32 * r;
        best[r] = 0;
        if (live && t < T) {
            const float* row = qs_s + t * A;
            float best_v = row[0];
#pragma unroll 6
            for (int a = 1; a < A; ++a) {
                const float v = row[a];
                if (!isnan(best_v) && (isnan(v) || v > best_v)) {
                    best[r] = a;
                    best_v = v;
                }
            }
        }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
        const int t = lane + 32 * r;
        if (live && t < T) qboot[t] = td.hr.h_inv(qt_s[t * A + best[r]]);
    }
    __syncwarp();

    // the n-step window, td and the lane's partial sums in step order
    float tdv[kR], mk[kR];
    float cnt = 0.f, hub = 0.f, mx = 0.f, sabs = 0.f, qsum = 0.f, vsum = 0.f;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
        const int t = lane + 32 * r;
        tdv[r] = 0.f;
        mk[r] = 0.f;
        if (!live || t >= T) continue;
        const float v = (float)vl[t];
        qsum += qt[r] * v;
        vsum += v;
        if (t >= Tn) continue;
        float rn = 0.f, alive = 1.f, gk = 1.f, dsum = 0.f;
        for (int k = 0; k < n; ++k) {
            const float d = (float)dn[t + k];
            rn += rew[t + k] * alive * gk;
            alive *= 1.f - d;
            gk *= td.gamma;
            dsum += d;
        }
        const float done_w = fminf(fmaxf(dsum, 0.f), 1.f);
        const float y = td.hr.h(rn + td.gamma_n * (1.f - done_w) * qboot[t + n]);
        const float ok = fminf(fmaxf(done_w + (float)vl[t + n], 0.f), 1.f);
        const float m = v * ok;
        const float u = (y - qt[r]) * m, au = fabsf(u);
        tdv[r] = u;
        mk[r] = m;
        cnt += m;
        hub += au <= 1.f ? 0.5f * (u * u) : au - 0.5f;
        mx = fmaxf(mx, au);
        sabs += au;
    }
    cnt = warp_sum(cnt);
    hub = warp_sum(hub);
    sabs = warp_sum(sabs);
    qsum = warp_sum(qsum);
    vsum = warp_sum(vsum);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    // the rounding of each quantity pinned (no contraction), so that the
    // plain and the fold instantiations give equal bits
    const float denom = fmaxf(cnt, 1.f);
    const float prio = __fadd_rn(__fmul_rn(td.eta, mx), __fmul_rn(td.eta_c, __fdiv_rn(sabs, denom)));
    const float wl = __fmul_rn(w, __fdiv_rn(hub, denom));
    const float scale = __fdiv_rn(-__fdiv_rn(w, (float)B), denom);
    if (live) {
#pragma unroll
        for (int r = 0; r < kR; ++r) {
            const int t = lane + 32 * r;
            if (t < T)
                dq[(size_t)b * T + t] =
                    t < Tn ? __fmul_rn(__fmul_rn(scale, fminf(fmaxf(tdv[r], -1.f), 1.f)), mk[r])
                           : 0.f;
        }
    }
    cluster_wait();  // every block has started: block 0's barrier is set
    if (live && lane == 0) {
        priorities[b] = prio;
        const float pri = kFold ? port::priority_of(__fadd_rn(prio, ring.eps), ring.omega) : 0.f;
        if (blockIdx.x == 0) {
            float* mine_p = parts + (size_t)b * kParts;
            mine_p[0] = wl;
            mine_p[1] = qsum;
            mine_p[2] = vsum;
            mine_p[3] = pri;
        } else {
            send4(peer(hopper::smem_u32(parts + (size_t)b * kParts), 0), wl, qsum, vsum, pri,
                  peer(hopper::smem_u32(&arrived), 0));
        }
    }
    // block 0 sums its own sequences and what every other block sent
    if (blockIdx.x != 0) return;
    __syncthreads();
    // warp 0 takes the sums (and the fold's maximum) and the scatter of
    // groups of at most 32 draws; larger groups take the whole block
    const bool one_warp = per_group <= 32;
    if (one_warp && warp != 0) return;
    wait_sent(&arrived);
    if (warp == 0) {
        float l = 0.f, q = 0.f, v = 0.f, m = -INFINITY;
        for (int i = lane; i < B; i += 32) {
            l += parts[i * kParts];
            q += parts[i * kParts + 1];
            v += parts[i * kParts + 2];
            if (kFold) m = port::nan_max(m, parts[i * kParts + 3]);
        }
        l = warp_sum(l);
        q = warp_sum(q);
        v = warp_sum(v);
        if (lane == 0) {
            *loss = l / (float)B;
            *q_mean = q / fmaxf(v, 1.f);
        }
        if (kFold) {
#pragma unroll
            for (int off = 16; off > 0; off /= 2)
                m = port::nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
            if (lane == 0) *ring.max_priority = port::nan_max(max0, m);
        }
    }
    if (!kFold) return;
    // K6s: each group's unfenced scatter in order
    const int k = threadIdx.x;
    const auto sync = [one_warp] {
        if (one_warp)
            __syncwarp();
        else
            __syncthreads();
    };
    for (int g = 0; g < ring.G; ++g) {
        const int i = g * per_group + k;
        int slot[1] = {k < per_group ? (g == 0 ? slot0 : ring.ids[i]) : -1};
        bool inside[1] = {k < per_group && slot[0] >= 0 && slot[0] < ring.n};
        float pri[1] = {k < per_group ? parts[(size_t)i * kParts + 3] : 0.f};
        float cur[1] = {0.f};  // no fence: the sequence ring never invalidates a slot
        port::scatter_group<1>(ring.ids + g * per_group, per_group, slot, inside, pri, cur, false,
                               [&](int s, float val) { ring.p[s] = val; }, sync);
    }
}

using Kernel = void (*)(const float*, const float*, const float*, const float*,
                        const unsigned char*, const unsigned char*, long long, long long,
                        long long, const float*, float*, float*, float*, float*, int, int, int,
                        int, int, TD, Ring);

template <bool kFold>
Kernel pick(int R) {
    switch (R) {
        case 1: return r2d2_td_kernel<1, kFold>;
        case 2: return r2d2_td_kernel<2, kFold>;
        case 3: return r2d2_td_kernel<3, kFold>;
        case 4: return r2d2_td_kernel<4, kFold>;
        default: return r2d2_td_kernel<8, kFold>;
    }
}

std::atomic<unsigned long long> ready{0};

// The kernels' shared-memory ceiling and, for clusters above 8 blocks, the
// non-portable cluster size; once per device.
cudaError_t prepare() {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = 1ull << (device & 63);
    if (ready.load() & bit) return cudaSuccess;
    for (int R : {1, 2, 3, 4, 8}) {
        for (Kernel kernel : {pick<false>(R), pick<true>(R)}) {
            err = cudaFuncSetAttribute((const void*)kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxShared);
            if (err == cudaSuccess)
                err = cudaFuncSetAttribute((const void*)kernel,
                                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
            if (err != cudaSuccess) return err;
        }
    }
    ready.fetch_or(bit);
    return cudaSuccess;
}

}  // namespace

PORT_API int port_r2d2_td_seq_bytes(int T, int A) { return (int)seq_bytes(T, A); }

// K11 over S sequences a block (kernels/r2d2_td.py: td_plan), ceil(B / S)
// blocks, one cluster (of one block at B 1).  q_taken [B, T], q_sel /
// q_tgt [B, T, A] and weight [B] contiguous f32; reward (f32), done and valid
// (bool) [B, T] with unit column stride and row strides rs_*; out: loss [],
// priorities [B], q_mean [], dq [B, T].  With ring (p [n_ring] f32,
// max_priority [] f32, ids [G, B / G] int32, updated in place) K6s's
// write-back of the priorities.
PORT_API int port_r2d2_td(const void* q_taken, const void* q_sel, const void* q_tgt,
                          const void* reward, const void* done, const void* valid,
                          long long rs_r, long long rs_d, long long rs_v, const void* weight,
                          void* loss, void* priorities, void* q_mean, void* dq, int B, int T,
                          int A, int n, int S, float gamma, float gamma_n, float eta, float eta_c,
                          float eps, float eps4, float eps2, void* ring, void* max_priority,
                          const void* ids, int n_ring, int G, float wb_eps, float omega,
                          void* stream) {
    const bool fold = ring != nullptr;
    const long long blocks = B >= 1 && S >= 1 ? ((long long)B + S - 1) / S : 0;
    const size_t smem = (size_t)S * seq_bytes(T, A) + (size_t)B * kParts * sizeof(float);
    if (B < 1 || T <= n || n < 1 || T > kMaxSteps || A < 1 || S < 1 || S > kMaxSeqs ||
        blocks > kMaxCluster || smem > kMaxShared ||
        (fold && (max_priority == nullptr || ids == nullptr || n_ring < 1 || G < 1 ||
                  B % G != 0)))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = prepare();
    if (err != cudaSuccess) return (int)err;
    const int R = (T + 31) / 32;
    // 16-byte copies of both rows: each start 16-byte aligned
    const int vec = (T * A) % 4 == 0 && reinterpret_cast<uintptr_t>(q_sel) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(q_tgt) % 16 == 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)blocks, 1, 1);
    cfg.blockDim = dim3(32 * S, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const TD td{n, gamma, gamma_n, eta, eta_c, Rescale{eps, eps4, eps2}};
    const Ring rg{static_cast<float*>(ring), static_cast<float*>(max_priority),
                  static_cast<const int*>(ids), n_ring, fold ? G : 1, wb_eps, omega};
    err = cudaLaunchKernelEx(&cfg, fold ? pick<true>(R) : pick<false>(R),
                             static_cast<const float*>(q_taken), static_cast<const float*>(q_sel),
                             static_cast<const float*>(q_tgt), static_cast<const float*>(reward),
                             static_cast<const unsigned char*>(done),
                             static_cast<const unsigned char*>(valid), rs_r, rs_d, rs_v,
                             static_cast<const float*>(weight), static_cast<float*>(loss),
                             static_cast<float*>(priorities), static_cast<float*>(q_mean),
                             static_cast<float*>(dq), B, T, A, S, vec, td, rg);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
