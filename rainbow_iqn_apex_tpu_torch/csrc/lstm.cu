// K9 and K9-bwd: the resettable fp32 LSTM recurrence of R2D2, forward and
// backward through time.
//
// Replaces rainbow_iqn_apex_tpu/models/r2d2.py:_ResettableLSTMStep (:39-47),
// scanned by R2D2Net.__call__ (:89-96) and driven by ops/r2d2.py:_unroll
// (:136-167) and build_r2d2_act_step (:316-335); its backward is what
// jax.grad makes of that scan.  Per step t, in flax OptimizedLSTMCell's
// order (gates i, f, g, o; columns g*H + j of the [H, 4H] recurrent kernel):
//
//   keep   = 1 - reset[b, t]
//   c, h   = c * keep, h * keep
//   pre    = (h . W_h + b) + xw[b, t]          xw = phi . W_i, a plain product
//   i, f, o = sigmoid(pre_i, pre_f, pre_o);  g = tanh(pre_g)
//   c      = f * c + i * g;   h = o * tanh(c)
//
// The input projection xw does not depend on h, so it stays one large matrix
// product outside (as do dW_h, db, dW_i and dphi in the backward); the
// kernels own the recurrence: h . W_h on every step, the gates and the cell.
//
// Bound on the H100: the recurrence is serial in t.  At the learner's
// [32, 80, 512] each step is 67 MFLOP of fp32 (about 1 us at 67 TFLOP/s) and
// the kernels move xw, h_seq and the saved gates once (~40 us for the whole
// unroll), so the chain of T dependent steps is what bounds them: per step
// one product, a cell update and the exchange of h (forward) or of partial
// sums of dh (backward) between the blocks that share a batch row.
//
// Design (T > 1).  Batch rows never interact, so the batch is cut into
// groups of R <= 8 rows, and each group is one thread-block cluster of C =
// ceil(H / 32) blocks (16 at H 512), block u owning the 32 hidden units
// 32 u .. 32 u + 31 (128 gate columns).  A cluster needs nothing from any
// other, so the clusters run as the card fits them.  Each block keeps its
// 256 KB fp32 slice of W_h for the whole launch, in registers (64 a thread
// at 512 threads forward, 48 backward) and shared memory (the rest).  The exchange runs
// through distributed shared memory, never L2: every step a block stores its
// units' results straight into the shared memory of the cluster's blocks
// that read them and arrives on the cluster barrier (release); the readers
// wait on it (acquire) at the start of the next step.  Buffers alternate by
// the parity of t, so one barrier a step is enough.
//   Forward, per step: each thread sums its 2 columns over its 64 rows k for
//   4 rows at a time, h_{t-1} * keep_t broadcast from the block's own copy;
//   the 8 split sums of a column are added in split order; bias, xw, the
//   gates and the cell follow, and h_t * keep_{t+1} goes to every block.
//   Backward, per step: dh_t's recurrent part is sum over the gate columns of
//   dpre_{t+1} W_h^T.  Block u holds dpre_{t+1} only for its own columns, so
//   thread k sums its row of the slice against them: the partial P_u[r, k],
//   stored into the block that owns unit k, which adds P_0 .. P_C-1 in block
//   order.
// T = 1 (the act tick) needs no exchange: a plain grid of 128 narrower blocks
// (4 units each) reads W_h once.
// No atomics touch the numbers and every sum has a fixed order, so a run
// repeats bit for bit.  The launch plan (clusters, rows) is kernels/lstm.py's.
#include <atomic>

#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kUnits = 32;             // hidden units of a cluster block
constexpr int kCols = 4 * kUnits;      // its gate columns
constexpr int kMaxBlocks = 16;         // blocks of a cluster: H <= 512
constexpr int kDepth = 512;            // rows k of W_h a block holds, H zero-padded
constexpr int kMaxRows = 8;            // batch rows of a group: one pass of a product
constexpr int kRowChunk = 4;           // T = 1: rows of one pass of the tick's product
constexpr int kSplits = 8;             // forward: threads a column's sum is split over
constexpr int kSplitK = kDepth / kSplits;  // 64 rows k a forward thread: 32 held, 32 shared
constexpr int kHeld = kSplitK / 2;
constexpr int kBwdHeld = 64;           // backward: columns of a thread's W_h rows held in registers

constexpr int kTickUnits = 4;          // T = 1: units of a grid block
constexpr int kTickSplits = 32;        // threads a column's sum is split over
constexpr int kTickK = kDepth / kTickSplits;
constexpr int kTickThreads = 2 * kTickUnits * kTickSplits;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

// The global column of local gate column lc of the block at units j0.., or -1
// past H.
template <int J>
__device__ __forceinline__ int column(int lc, int j0, int H) {
    const int j = j0 + lc % J;
    return j < H ? (lc / J) * H + j : -1;
}

// The address of shared variable `addr` (this block's) in block `rank` of the cluster.
__device__ __forceinline__ uint32_t peer(uint32_t addr, int rank) {
    uint32_t out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
    return out;
}

// 16 bytes into another block's shared memory; the store completes 16 bytes
// of the transaction count of that block's barrier `bar`.
__device__ __forceinline__ void send(uint32_t addr, float4 v, uint32_t bar) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];"
        ::"r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
        : "memory");
}

constexpr unsigned kSpinLimit = 1u << 22;  // polls of a barrier before the kernel traps

// Wait for the phase of this block's barrier with the given parity to
// complete, acquiring at cluster scope what other blocks sent into it.  A
// phase that never completes traps instead of hanging the card.
__device__ __forceinline__ void wait_sent(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = hopper::smem_u32(bar);
    uint32_t done = 0, spins = 0;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(addr), "r"(parity)
            : "memory");
        if (++spins == kSpinLimit) __trap();
    } while (!done);
}

// Shared bytes of a forward cluster block (kernels/lstm.py: FWD_SHARED): two
// barriers, W_h's shared half [8][32][128], h [2][8][512], split sums
// [8][8][128], pre [8][128], c [8][32].
constexpr size_t kBarBytes = 16;
constexpr size_t kFwdShared =
    kBarBytes + sizeof(float) * ((size_t)kSplits * kHeld * kCols + 2 * kMaxRows * kDepth +
                     kSplits * kMaxRows * kCols + kMaxRows * kCols + kMaxRows * kUnits);

// What a backward cell thread reads for step t, fetched a step ahead: dh,
// the gates i, f, g, o, c_t, c_{t-1} (floats of a cell entry; 8 with the pad).
constexpr int kCellFloats = 8;

// Shared bytes of a backward cluster block (kernels/lstm.py: BWD_SHARED): two
// barriers, W_h's shared columns [16][512] float4, partials [2][16][8][32],
// dpre [8][128], dc [8][32], cell inputs [8 * 32][8], this block's partials
// [8][512].
constexpr size_t kBwdShared =
    kBarBytes + sizeof(float) * ((size_t)kDepth * (kCols - kBwdHeld) + 2 * kMaxBlocks * kMaxRows * kUnits +
                                 kMaxRows * kCols + kMaxRows * kUnits +
                                 kMaxRows * kUnits * kCellFloats + kMaxRows * kDepth);

// Shared bytes of a tick block (kernels/lstm.py: _tick_shared): h
// [R][512], split sums [32][4][16], pre [R][16].
__host__ __device__ constexpr size_t tick_shared(int R) {
    return sizeof(float) * ((size_t)R * kDepth + (size_t)kTickSplits * kRowChunk * 4 * kTickUnits +
                            (size_t)R * 4 * kTickUnits);
}

// --------------------------------------------------------- forward, T > 1
// grid (C, G), cluster (C, 1); thread (s, cq) = (tid / 32, tid % 32) sums
// local columns 4 cq .. 4 cq + 3 over rows k = 64 s .. 64 s + 63: the first
// 32 in registers, the rest in shared memory.  RC >= R: the rows of the one
// pass of the product (rows past R are zeros).
template <int RC>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_kernel(const float* __restrict__ xw,        // [B, T, 4H]
                const float* __restrict__ w_h,       // [H, 4H]
                const float* __restrict__ bias,      // [4H]
                const unsigned char* __restrict__ reset,  // [B, T] bool
                const float* __restrict__ c0,        // [B, H]
                const float* __restrict__ h0,        // [B, H]
                float* __restrict__ h_seq,           // [B, T, H]
                float* __restrict__ c_last,          // [B, H]
                float* __restrict__ h_last,          // [B, H]
                float* __restrict__ gates,           // [B, T, 4H] activations, or null
                float* __restrict__ c_seq,           // [B, T, H], or null
                int B, int T, int H, int R) {
    cg::cluster_group cluster = cg::this_cluster();
    const int u = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
    const int j0 = u * kUnits, r0 = blockIdx.y * R;
    const int rows = min(R, B - r0);
    extern __shared__ float4 smem4[];
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem4);  // [2] h_t from the other blocks, by parity
    float* ws = reinterpret_cast<float*>(smem4 + 1);      // [8][32][128] W_h[64 s + 32 + kk, col]
    float* hbuf = ws + kSplits * kHeld * kCols;           // [2][8][512] h_t * keep_{t+1} by parity
    float* red = hbuf + 2 * kMaxRows * kDepth;            // [8][8][128] split sums
    float* pre_s = red + kSplits * kMaxRows * kCols;      // [8][128]
    float* c_s = pre_s + kMaxRows * kCols;                // [8][32]
    const int tid = threadIdx.x;
    const int s = tid / (kCols / 4), cq = tid % (kCols / 4);
    const size_t G4 = (size_t)4 * H;

    float w[kHeld][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const int col = column<kUnits>(4 * cq + e, j0, H);
#pragma unroll
        for (int kk = 0; kk < kHeld; ++kk) {
            const int k = s * kSplitK + kk;
            w[kk][e] = k < H && col >= 0 ? w_h[(size_t)k * G4 + col] : 0.f;
        }
    }
    for (int e = tid; e < kSplits * kHeld * kCols; e += kThreads) {
        const int sk = e / kCols, lc = e % kCols;
        const int k = (sk / kHeld) * kSplitK + kHeld + sk % kHeld;
        const int col = column<kUnits>(lc, j0, H);
        ws[e] = k < H && col >= 0 ? w_h[(size_t)k * G4 + col] : 0.f;
    }
    // h_{-1} * keep_0 = h0 * keep_0 in the parity-1 buffer, zeros past H in both
    for (int e = tid; e < 2 * kMaxRows * kDepth; e += kThreads) {
        const int par = e / (kMaxRows * kDepth), r = e / kDepth % kMaxRows, k = e % kDepth;
        float v = 0.f;
        if (par == 1 && r < rows && k < H)
            v = h0[(size_t)(r0 + r) * H + k] * (1.f - (float)reset[(size_t)(r0 + r) * T]);
        hbuf[e] = v;
    }
    for (int p = tid; p < rows * kUnits; p += kThreads) {
        const int r = p / kUnits, j = j0 + p % kUnits;
        c_s[p] = j < H ? c0[(size_t)(r0 + r) * H + j] : 0.f;
    }
    // the sum phase: thread tid adds local column lc_r of rows r_sum, r_sum + 2, ..
    const int lc_r = tid % kCols, r_sum = tid / kCols;
    const int col_r = column<kUnits>(lc_r, j0, H);
    const float b_r = col_r >= 0 ? bias[col_r] : 0.f;
    constexpr int kSums = kMaxRows * kCols / kThreads;
    if (tid == 0) {
        hopper::mbar_init(&bar[0], 1);
        hopper::mbar_init(&bar[1], 1);
        hopper::mbar_init_fence();
    }
    cluster.sync();  // every block's buffers and barriers are set before any block sends
    const uint32_t h_at = hopper::smem_u32(hbuf), bar_at = hopper::smem_u32(bar);

    const int cell_r = tid / kUnits, cell_jj = tid % kUnits;  // the cell: tid < rows * 32
    for (int t = 0; t < T; ++t) {
        // the cell's reset bytes and xw of this thread's sums, loaded before
        // the wait for h_{t-1}
        unsigned char reset_now = 0, reset_next = 0;
        if (cell_r < rows) {
            const unsigned char* rr = reset + (size_t)(r0 + cell_r) * T + t;
            reset_now = rr[0];
            if (t + 1 < T) reset_next = rr[1];
        }
        float xw_sum[kSums];
#pragma unroll
        for (int i = 0; i < kSums; ++i) {
            const int r = r_sum + i * (kThreads / kCols);
            xw_sum[i] = r < rows && col_r >= 0 ? xw[((size_t)(r0 + r) * T + t) * G4 + col_r] : 0.f;
        }
        // h_t of the other blocks lands during this step: this block's arrival
        // for it, with the bytes it brings
        if (t + 1 < T && tid == 0)
            hopper::mbar_expect_tx(&bar[t & 1], (uint32_t)((C - 1) * rows * kUnits * sizeof(float)));
        if (t > 0) {  // h_{t-1} of every block has landed here
            wait_sent(&bar[(t - 1) & 1], ((t - 1) >> 1) & 1);
            __syncthreads();
        }
        const float* hb = hbuf + (size_t)((t + 1) & 1) * kMaxRows * kDepth + s * kSplitK;

        // every row of the group in one pass: each W_h value read from shared
        // memory serves all of them
        float acc[RC][4];
#pragma unroll
        for (int r = 0; r < RC; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kHeld; kk += 4) {
#pragma unroll
            for (int r = 0; r < RC; ++r) {
                const float4 hv = *reinterpret_cast<const float4*>(hb + r * kDepth + kk);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float a = acc[r][e];
                    a = fmaf(hv.x, w[kk][e], a);
                    a = fmaf(hv.y, w[kk + 1][e], a);
                    a = fmaf(hv.z, w[kk + 2][e], a);
                    a = fmaf(hv.w, w[kk + 3][e], a);
                    acc[r][e] = a;
                }
            }
        }
        const float* wsb = ws + (size_t)s * kHeld * kCols + 4 * cq;
#pragma unroll
        for (int kk = 0; kk < kHeld; kk += 4) {
            float4 wv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                wv[i] = *reinterpret_cast<const float4*>(wsb + (size_t)(kk + i) * kCols);
#pragma unroll
            for (int r = 0; r < RC; ++r) {
                const float4 hv = *reinterpret_cast<const float4*>(hb + r * kDepth + kHeld + kk);
                float a0 = acc[r][0], a1 = acc[r][1], a2 = acc[r][2], a3 = acc[r][3];
                a0 = fmaf(hv.x, wv[0].x, a0);
                a1 = fmaf(hv.x, wv[0].y, a1);
                a2 = fmaf(hv.x, wv[0].z, a2);
                a3 = fmaf(hv.x, wv[0].w, a3);
                a0 = fmaf(hv.y, wv[1].x, a0);
                a1 = fmaf(hv.y, wv[1].y, a1);
                a2 = fmaf(hv.y, wv[1].z, a2);
                a3 = fmaf(hv.y, wv[1].w, a3);
                a0 = fmaf(hv.z, wv[2].x, a0);
                a1 = fmaf(hv.z, wv[2].y, a1);
                a2 = fmaf(hv.z, wv[2].z, a2);
                a3 = fmaf(hv.z, wv[2].w, a3);
                a0 = fmaf(hv.w, wv[3].x, a0);
                a1 = fmaf(hv.w, wv[3].y, a1);
                a2 = fmaf(hv.w, wv[3].z, a2);
                a3 = fmaf(hv.w, wv[3].w, a3);
                acc[r][0] = a0;
                acc[r][1] = a1;
                acc[r][2] = a2;
                acc[r][3] = a3;
            }
        }
        float* rp = red + (size_t)s * kMaxRows * kCols + 4 * cq;
#pragma unroll
        for (int r = 0; r < RC; ++r)
            *reinterpret_cast<float4*>(rp + r * kCols) =
                make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kSums; ++i) {
            const int o = tid + i * kThreads, r = o / kCols;
            if (r < rows && col_r >= 0) {
                float sum = red[o];
                for (int k = 1; k < kSplits; ++k) sum += red[(size_t)k * kMaxRows * kCols + o];
                pre_s[o] = (sum + b_r) + xw_sum[i];
            }
        }
        __syncthreads();

        // the cell; h_t * keep_{t+1} goes into this block's copy first
        const int out_at = (t & 1) * kMaxRows * kDepth;
        if (cell_r < rows) {
            const int p = tid, r = cell_r, jj = cell_jj, j = j0 + jj;
            float h = 0.f;
            const size_t b = r0 + r, bt = b * T + t;
            if (j < H) {
                const float keep = 1.f - (float)reset_now;
                const float* pr = pre_s + r * kCols;
                const float ig = sigmoid_f(pr[jj]);
                const float fg = sigmoid_f(pr[kUnits + jj]);
                const float gg = tanhf(pr[2 * kUnits + jj]);
                const float og = sigmoid_f(pr[3 * kUnits + jj]);
                const float c = fg * (c_s[p] * keep) + ig * gg;
                h = og * tanhf(c);
                c_s[p] = c;
                h_seq[bt * H + j] = h;
                if (gates != nullptr) {
                    float* gr = gates + bt * G4 + j;
                    gr[0] = ig;
                    gr[(size_t)H] = fg;
                    gr[(size_t)2 * H] = gg;
                    gr[(size_t)3 * H] = og;
                }
                if (c_seq != nullptr) c_seq[bt * H + j] = c;
                if (t == T - 1) {
                    c_last[b * H + j] = c;
                    h_last[b * H + j] = h;
                }
            }
            if (t + 1 < T) hbuf[out_at + r * kDepth + j] = h * (1.f - (float)reset_next);  // 0 past H
        }
        if (t + 1 < T) {  // then 16 bytes a store into each other block, spread over all threads
            __syncthreads();
            const int quads = rows * (kUnits / 4);
            for (int i = tid; i < (C - 1) * quads; i += kThreads) {
                const int dst = (u + 1 + i / quads) % C, q = i % quads;
                const int at = out_at + (q / (kUnits / 4)) * kDepth + j0 + 4 * (q % (kUnits / 4));
                send(peer(h_at + at * (uint32_t)sizeof(float), dst),
                     *reinterpret_cast<const float4*>(hbuf + at),
                     peer(bar_at + (t & 1) * (uint32_t)sizeof(uint64_t), dst));
            }
        }
    }
    cluster.sync();  // no block leaves while a store into it may be in flight
}

// -------------------------------------------------------- forward, T = 1
// A plain grid of (ceil(H / 4), G) blocks of 256 threads: thread (s, cp) =
// (tid / 8, tid % 8) sums local columns 2 cp, 2 cp + 1 over rows k = 16 s ..
// 16 s + 15, held in registers.
__global__ void __launch_bounds__(kTickThreads, 1)
lstm_tick_kernel(const float* __restrict__ xw,        // [B, 1, 4H]
                 const float* __restrict__ w_h,       // [H, 4H]
                 const float* __restrict__ bias,      // [4H]
                 const unsigned char* __restrict__ reset,  // [B, 1]
                 const float* __restrict__ c0,        // [B, H]
                 const float* __restrict__ h0,        // [B, H]
                 float* __restrict__ h_seq,           // [B, 1, H]
                 float* __restrict__ c_last,          // [B, H]
                 float* __restrict__ h_last,          // [B, H]
                 float* __restrict__ gates,           // [B, 1, 4H], or null
                 float* __restrict__ c_seq,           // [B, 1, H], or null
                 int B, int H, int R) {
    constexpr int J = kTickUnits, C4 = 4 * J;
    const int j0 = blockIdx.x * J, r0 = blockIdx.y * R;
    const int rows = min(R, B - r0);
    extern __shared__ float4 smem4[];
    float* hs = reinterpret_cast<float*>(smem4);        // [R][512] h0 * keep
    float* red = hs + (size_t)R * kDepth;               // [32][4][16] split sums
    float* pre_s = red + kTickSplits * kRowChunk * C4;  // [R][16]
    const int tid = threadIdx.x;
    const int s = tid / (2 * J), cp = tid % (2 * J);
    const size_t G4 = (size_t)4 * H;

    float w[kTickK][2];
    {
        const int ca = column<J>(2 * cp, j0, H), cb = column<J>(2 * cp + 1, j0, H);
#pragma unroll
        for (int kk = 0; kk < kTickK; ++kk) {
            const int k = s * kTickK + kk;
            w[kk][0] = k < H && ca >= 0 ? w_h[(size_t)k * G4 + ca] : 0.f;
            w[kk][1] = k < H && cb >= 0 ? w_h[(size_t)k * G4 + cb] : 0.f;
        }
    }
    for (int e = tid; e < rows * kDepth; e += kTickThreads) {
        const int r = e / kDepth, k = e % kDepth;
        hs[e] = k < H ? h0[(size_t)(r0 + r) * H + k] * (1.f - (float)reset[r0 + r]) : 0.f;
    }
    const int lc_r = tid % C4, r_sum = tid / C4;
    const int col_r = column<J>(lc_r, j0, H);
    __syncthreads();
    for (int rc = 0; rc < rows; rc += kRowChunk) {
        float acc[kRowChunk][2];
#pragma unroll
        for (int r = 0; r < kRowChunk; ++r) acc[r][0] = acc[r][1] = 0.f;
        const float* hb = hs + (size_t)rc * kDepth + s * kTickK;
#pragma unroll
        for (int kk = 0; kk < kTickK; kk += 4) {
#pragma unroll
            for (int r = 0; r < kRowChunk; ++r) {
                if (rc + r >= rows) break;
                const float4 hv = *reinterpret_cast<const float4*>(hb + r * kDepth + kk);
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    float a = acc[r][e];
                    a = fmaf(hv.x, w[kk][e], a);
                    a = fmaf(hv.y, w[kk + 1][e], a);
                    a = fmaf(hv.z, w[kk + 2][e], a);
                    a = fmaf(hv.w, w[kk + 3][e], a);
                    acc[r][e] = a;
                }
            }
        }
        float* rp = red + (size_t)s * kRowChunk * C4 + 2 * cp;
#pragma unroll
        for (int r = 0; r < kRowChunk; ++r)
            *reinterpret_cast<float2*>(rp + r * C4) = make_float2(acc[r][0], acc[r][1]);
        __syncthreads();
        if (r_sum < kRowChunk && rc + r_sum < rows && col_r >= 0) {
            float sum = red[tid];
            for (int k = 1; k < kTickSplits; ++k) sum += red[(size_t)k * kRowChunk * C4 + tid];
            pre_s[(rc + r_sum) * C4 + lc_r] =
                (sum + bias[col_r]) + xw[(size_t)(r0 + rc + r_sum) * G4 + col_r];
        }
        __syncthreads();
    }
    for (int p = tid; p < rows * J; p += kTickThreads) {
        const int r = p / J, jj = p % J, j = j0 + jj;
        if (j >= H) continue;
        const size_t b = r0 + r;
        const float keep = 1.f - (float)reset[b];
        const float* pr = pre_s + r * C4;
        const float ig = sigmoid_f(pr[jj]);
        const float fg = sigmoid_f(pr[J + jj]);
        const float gg = tanhf(pr[2 * J + jj]);
        const float og = sigmoid_f(pr[3 * J + jj]);
        const float c = fg * (c0[b * H + j] * keep) + ig * gg;
        const float h = og * tanhf(c);
        h_seq[b * H + j] = h;
        if (gates != nullptr) {
            float* gr = gates + b * G4 + j;
            gr[0] = ig;
            gr[(size_t)H] = fg;
            gr[(size_t)2 * H] = gg;
            gr[(size_t)3 * H] = og;
        }
        if (c_seq != nullptr) c_seq[b * H + j] = c;
        c_last[b * H + j] = c;
        h_last[b * H + j] = h;
    }
}

// ----------------------------------------------------------------- backward
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(hopper::smem_u32(dst)), "l"(src)
                 : "memory");
}

// grid (C, G), cluster (C, 1); thread tid holds rows k = tid and tid + 256 of
// the block's slice: local columns 0 .. 63 in registers, 64 .. 127 in shared
// memory.  RC >= R: the rows of the one pass of the product (rows past R are
// zeros).
template <int RC>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_kernel(const float* __restrict__ dh_seq,    // [B, T, H]
                const float* __restrict__ dh_last,   // [B, H] or null
                const float* __restrict__ dc_last,   // [B, H] or null
                const float* __restrict__ w_h,       // [H, 4H]
                const unsigned char* __restrict__ reset,  // [B, T]
                const float* __restrict__ gates,     // [B, T, 4H] activations
                const float* __restrict__ c_seq,     // [B, T, H]
                const float* __restrict__ c0,        // [B, H]
                float* __restrict__ dpre,            // [B, T, 4H] out: d loss / d pre
                int B, int T, int H, int R) {
    constexpr int kHeldCols = kBwdHeld, kGroups = (kCols - kBwdHeld) / 4;
    cg::cluster_group cluster = cg::this_cluster();
    const int u = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
    const int j0 = u * kUnits, r0 = blockIdx.y * R;
    const int rows = min(R, B - r0);
    extern __shared__ float4 smem4[];
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem4);  // [2] P_t of every block, by parity
    float4* ws = smem4 + 1;  // [16][512]: W_h[k, 64 + 4 g .. 64 + 4 g + 3] at g * 512 + k
    float* pin = reinterpret_cast<float*>(ws + (size_t)kGroups * kDepth);  // [2][16][8][32] P by parity
    float* dp_s = pin + 2 * kMaxBlocks * kMaxRows * kUnits;  // [8][128] dpre_t, this block's columns
    float* dc_s = dp_s + kMaxRows * kCols;                   // [8][32] dc carried to step t - 1
    float* cin = dc_s + kMaxRows * kUnits;                   // [8 * 32][8] cell inputs of step t
    float* stage = cin + kMaxRows * kUnits * kCellFloats;    // [8][512] P_t of this block
    const int tid = threadIdx.x;
    const size_t G4 = (size_t)4 * H;

    float w[2][kHeldCols];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int k = tid + h * kThreads;
#pragma unroll
        for (int lc = 0; lc < kHeldCols; ++lc) {
            const int col = column<kUnits>(lc, j0, H);
            w[h][lc] = k < H && col >= 0 ? w_h[(size_t)k * G4 + col] : 0.f;
        }
    }
    for (int e = tid; e < kGroups * kDepth; e += kThreads) {
        const int g = e / kDepth, k = e % kDepth;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int col = column<kUnits>(kHeldCols + 4 * g + i, j0, H);
            v[i] = k < H && col >= 0 ? w_h[(size_t)k * G4 + col] : 0.f;
        }
        ws[e] = make_float4(v[0], v[1], v[2], v[3]);
    }
    for (int p = tid; p < rows * kUnits; p += kThreads) {
        const int r = p / kUnits, j = j0 + p % kUnits;
        dc_s[p] = dc_last != nullptr && j < H ? dc_last[(size_t)(r0 + r) * H + j] : 0.f;
    }
    for (int e = rows * kCols + tid; e < RC * kCols; e += kThreads) dp_s[e] = 0.f;  // rows past R
    const uint32_t pin_at = hopper::smem_u32(pin), bar_at = hopper::smem_u32(bar);
    if (tid == 0) {
        hopper::mbar_init(&bar[0], 1);
        hopper::mbar_init(&bar[1], 1);
        hopper::mbar_init_fence();
    }
    cluster.sync();  // every block's barriers are set before any block sends

    // the cell: thread tid < rows * 32 takes row cell_r, unit j0 + cell_jj
    const int cell_r = tid / kUnits, cell_jj = tid % kUnits;
    const bool cell = cell_r < rows && j0 + cell_jj < H;
    const size_t cell_b = r0 + cell_r;
    const int cell_j = j0 + cell_jj;
    auto fetch = [&](int t) {  // step t's cell inputs, into cin as they arrive
        if (!cell) return;
        const size_t bt = cell_b * T + t;
        float* in = cin + (size_t)tid * kCellFloats;
        copy_async(in, dh_seq + bt * H + cell_j);
#pragma unroll
        for (int g = 0; g < 4; ++g) copy_async(in + 1 + g, gates + bt * G4 + (size_t)g * H + cell_j);
        copy_async(in + 5, c_seq + bt * H + cell_j);
        copy_async(in + 6, t == 0 ? c0 + cell_b * H + cell_j : c_seq + (bt - 1) * H + cell_j);
        asm volatile("cp.async.commit_group;" ::: "memory");
    };
    fetch(T - 1);

    for (int t = T - 1; t >= 0; --t) {
        unsigned char reset_now = 0, reset_next = 0;  // read before the waits
        if (cell) {
            const unsigned char* rr = reset + cell_b * T + t;
            reset_now = rr[0];
            if (t + 1 < T) reset_next = rr[1];
        }
        // P_t of every block lands during this step: this block's arrival for
        // it, with the bytes it brings
        if (t > 0 && tid == 0)
            hopper::mbar_expect_tx(&bar[t & 1], (uint32_t)(C * rows * kUnits * sizeof(float)));
        asm volatile("cp.async.wait_all;" ::: "memory");
        if (t + 1 < T) wait_sent(&bar[(t + 1) & 1], ((T - 2 - t) >> 1) & 1);  // P_{t+1} is here
        __syncthreads();
        const float* pp = pin + (size_t)((t + 1) & 1) * kMaxBlocks * kMaxRows * kUnits;
        if (cell_r < rows) {
            const int r = cell_r, jj = cell_jj;
            float* dr = dp_s + r * kCols + jj;
            if (!cell) {  // columns past H: zero, as their slice of W_h
                dr[0] = dr[kUnits] = dr[2 * kUnits] = dr[3 * kUnits] = 0.f;
            } else {
                const float* in = cin + (size_t)tid * kCellFloats;
                const float ig = in[1], fg = in[2], gg = in[3], og = in[4], c = in[5];
                const float keep = 1.f - (float)reset_now;
                const float c_prev = in[6] * keep;
                float dh = in[0];
                if (t == T - 1 && dh_last != nullptr) dh += dh_last[cell_b * H + cell_j];
                if (t + 1 < T) {
                    float rec = 0.f;
                    for (int v = 0; v < C; ++v) rec += pp[((size_t)v * kMaxRows + r) * kUnits + jj];
                    dh = dh + rec * (1.f - (float)reset_next);
                }
                const float tc = tanhf(c);
                const float dc = dc_s[tid] + dh * og * (1.f - tc * tc);
                const float di = dc * gg * ig * (1.f - ig);
                const float df = dc * c_prev * fg * (1.f - fg);
                const float dg = dc * ig * (1.f - gg * gg);
                const float dout = dh * tc * og * (1.f - og);
                float* out = dpre + (cell_b * T + t) * G4 + cell_j;
                out[0] = di;
                out[(size_t)H] = df;
                out[(size_t)2 * H] = dg;
                out[(size_t)3 * H] = dout;
                dr[0] = di;
                dr[kUnits] = df;
                dr[2 * kUnits] = dg;
                dr[3 * kUnits] = dout;
                dc_s[tid] = dc * fg * keep;
            }
        }
        __syncthreads();
        if (t == 0) break;  // nothing reaches the initial state
        fetch(t - 1);  // cin is free again: the next step's inputs land during the product

        // P_t[r, k] = sum over this block's columns of dpre_t[r, lc] W_h[k, lc],
        // every row of the group in one pass, for k = tid and tid + 256
        float acc[2][RC];
#pragma unroll
        for (int r = 0; r < RC; ++r) acc[0][r] = acc[1][r] = 0.f;
#pragma unroll
        for (int lc = 0; lc < kHeldCols; lc += 4) {
#pragma unroll
            for (int r = 0; r < RC; ++r) {
                const float4 d = *reinterpret_cast<const float4*>(dp_s + r * kCols + lc);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    float a = acc[h][r];
                    a = fmaf(d.x, w[h][lc], a);
                    a = fmaf(d.y, w[h][lc + 1], a);
                    a = fmaf(d.z, w[h][lc + 2], a);
                    a = fmaf(d.w, w[h][lc + 3], a);
                    acc[h][r] = a;
                }
            }
        }
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
            const float4 wv[2] = {ws[(size_t)g * kDepth + tid], ws[(size_t)g * kDepth + tid + kThreads]};
#pragma unroll
            for (int r = 0; r < RC; ++r) {
                const float4 d = *reinterpret_cast<const float4*>(dp_s + r * kCols + kHeldCols + 4 * g);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    float a = acc[h][r];
                    a = fmaf(d.x, wv[h].x, a);
                    a = fmaf(d.y, wv[h].y, a);
                    a = fmaf(d.z, wv[h].z, a);
                    a = fmaf(d.w, wv[h].w, a);
                    acc[h][r] = a;
                }
            }
        }
#pragma unroll
        for (int r = 0; r < RC; ++r) {
            stage[r * kDepth + tid] = acc[0][r];
            stage[r * kDepth + tid + kThreads] = acc[1][r];
        }
        __syncthreads();
        // then 16 bytes a store (rows k .. k + 3) to the block that owns unit k,
        // at [parity][u][r][k % 32], spread over all threads
        const int quads = C * (kUnits / 4);
        for (int i = tid; i < rows * quads; i += kThreads) {
            const int r = i / quads, q = i % quads, owner = q / (kUnits / 4);
            const uint32_t at = (uint32_t)((((t & 1) * kMaxBlocks + u) * kMaxRows + r) * kUnits +
                                           4 * (q % (kUnits / 4))) * (uint32_t)sizeof(float);
            send(peer(pin_at + at, owner), *reinterpret_cast<const float4*>(stage + r * kDepth + 4 * q),
                 peer(bar_at + (t & 1) * (uint32_t)sizeof(uint64_t), owner));
        }
    }
    cluster.sync();  // no block leaves while a store into it may be in flight
}

// Lets a kernel take `smem` bytes of shared memory and, in a cluster above 8
// blocks, the non-portable cluster size; once per device.
cudaError_t prepare(const void* kernel, size_t smem, bool cluster,
                    std::atomic<unsigned long long>* done) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = 1ull << (device & 63);
    if (done->load() & bit) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess && cluster)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess) done->fetch_or(bit);
    return err;
}

std::atomic<unsigned long long> tick_ready{0};
std::atomic<unsigned long long> fwd_ready[4], bwd_ready[4];  // by pass_index

// The rows of the product's one pass for R rows a group: the instantiated
// sizes (1 for one row a group, 4 and 5 for the learner's B 32 on 8 and 7
// clusters, 8 otherwise).
constexpr int kPassRows[4] = {1, 4, 5, 8};

int pass_index(int R) {
    int i = 0;
    while (kPassRows[i] < R) ++i;
    return i;
}

const void* fwd_kernel(int i) {
    switch (i) {
        case 0: return (const void*)lstm_fwd_kernel<1>;
        case 1: return (const void*)lstm_fwd_kernel<4>;
        case 2: return (const void*)lstm_fwd_kernel<5>;
        default: return (const void*)lstm_fwd_kernel<8>;
    }
}

const void* bwd_kernel(int i) {
    switch (i) {
        case 0: return (const void*)lstm_bwd_kernel<1>;
        case 1: return (const void*)lstm_bwd_kernel<4>;
        case 2: return (const void*)lstm_bwd_kernel<5>;
        default: return (const void*)lstm_bwd_kernel<8>;
    }
}

cudaLaunchConfig_t cluster_config(int C, int G, size_t smem, cudaLaunchAttribute* attr,
                                  cudaStream_t stream) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C, G, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// The plan's groups cover the batch with no empty group.
bool plan_ok(int B, int T, int H, int G, int R, int max_rows) {
    return B >= 1 && T >= 1 && H >= 1 && H <= kDepth && G >= 1 && R >= 1 && R <= max_rows &&
           (long long)G * R >= B && (long long)(G - 1) * R < B;
}

int launch_cluster(const void* kernel, size_t smem, std::atomic<unsigned long long>* ready,
                   int H, int G, void** args, cudaStream_t stream) {
    cudaError_t err = prepare(kernel, smem, true, ready);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config((H + kUnits - 1) / kUnits, G, smem, attr, stream);
    err = cudaLaunchKernelExC(&cfg, kernel, args);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // namespace

// K9: T > 1 as G clusters of ceil(H / 32) blocks, R <= 8 rows each; T = 1 as
// a grid of (ceil(H / 4), G) blocks, R rows each (kernels/lstm.py's plan).
PORT_API int port_lstm_fwd(const void* xw, const void* w_h, const void* bias, const void* reset,
                           const void* c0, const void* h0, void* h_seq, void* c_last,
                           void* h_last, void* gates, void* c_seq, int B, int T, int H, int G,
                           int R, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (T == 1) {
        const size_t smem = tick_shared(R);
        if (!plan_ok(B, T, H, G, R, B) || smem > 232448) return (int)cudaErrorInvalidValue;
        cudaError_t err = prepare((const void*)lstm_tick_kernel, 232448, false, &tick_ready);
        if (err != cudaSuccess) return (int)err;
        lstm_tick_kernel<<<dim3((H + kTickUnits - 1) / kTickUnits, G), kTickThreads, smem, s>>>(
            static_cast<const float*>(xw), static_cast<const float*>(w_h),
            static_cast<const float*>(bias), static_cast<const unsigned char*>(reset),
            static_cast<const float*>(c0), static_cast<const float*>(h0),
            static_cast<float*>(h_seq), static_cast<float*>(c_last), static_cast<float*>(h_last),
            static_cast<float*>(gates), static_cast<float*>(c_seq), B, H, R);
        return (int)cudaGetLastError();
    }
    if (!plan_ok(B, T, H, G, R, kMaxRows)) return (int)cudaErrorInvalidValue;
    void* args[] = {&xw, &w_h, &bias, &reset, &c0, &h0, &h_seq, &c_last, &h_last, &gates,
                    &c_seq, &B, &T, &H, &R};
    const int i = pass_index(R);
    return launch_cluster(fwd_kernel(i), kFwdShared, &fwd_ready[i], H, G, args, s);
}

// K9-bwd: G clusters of ceil(H / 32) blocks, R <= 8 rows each.
PORT_API int port_lstm_bwd(const void* dh_seq, const void* dh_last, const void* dc_last,
                           const void* w_h, const void* reset, const void* gates,
                           const void* c_seq, const void* c0, void* dpre, int B, int T, int H,
                           int G, int R, void* stream) {
    if (!plan_ok(B, T, H, G, R, kMaxRows)) return (int)cudaErrorInvalidValue;
    void* args[] = {&dh_seq, &dh_last, &dc_last, &w_h, &reset, &gates, &c_seq, &c0, &dpre,
                    &B, &T, &H, &R};
    const int i = pass_index(R);
    return launch_cluster(bwd_kernel(i), kBwdShared, &bwd_ready[i], H, G, args,
                          static_cast<cudaStream_t>(stream));
}

// How many clusters of `blocks` K9 (backward: K9-bwd) blocks the card holds
// at once; 0 where the runtime cannot say.
PORT_API int port_lstm_max_clusters(int blocks, int backward) {
    if (blocks < 1 || blocks > kMaxBlocks) return 0;
    const int i = pass_index(kMaxRows);
    const void* kernel = backward ? bwd_kernel(i) : fwd_kernel(i);
    const size_t smem = backward ? kBwdShared : kFwdShared;
    if (prepare(kernel, smem, true, backward ? &bwd_ready[i] : &fwd_ready[i]) != cudaSuccess) {
        cudaGetLastError();
        return 0;
    }
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(blocks, 1, smem, attr, nullptr);
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
        cudaGetLastError();  // the query's error is not a launch's
        return 0;
    }
    return n;
}
