// K7s: one append tick of R2D2's device-resident sequence replay.
//
// Replaces DeviceSequenceReplay.append (rainbow_iqn_apex_tpu/replay/device_sequence.py:113-205),
// XLA-fused on the TPU.  For each lane, with k = buf_len[lane] and klen = k + 1:
//
//   builder[lane, k]         = (frame, action, reward, terminal, c, h)  of this step
//   if the lane emits (a cut, or klen == L), into ring row slot = (pos + rank) % C:
//     frames/actions/rewards/dones[slot, j] = builder[lane, j] for j < klen, else 0
//     valids[slot, j]        = j < klen
//     init_c/init_h[slot]    = builder c/h at step 0 (the state just written when k == 0)
//     priority[slot]         = max_priority
//   if it emits a full window without a cut, the builder keeps its last
//   L - stride steps at the front: builder[lane, j] = builder[lane, j + stride], j < L - stride
//
// Which lanes emit, their ranks, slots, the new lengths and the ring cursor
// depend only on buf_len and the host env's terminals and truncations, so the
// wrapper computes them on the host (the port keeps buf_len, pos and filled as
// host counters) and passes them, with the tick's rewards and terminal flags,
// by value in LaneArgs: the kernel reads no device scalar but max_priority,
// and the tick needs no upload besides its frames.
//
// Where this goes beyond the JAX graph: JAX scatters EVERY lane's full window
// each tick, the non-emitters' into the scratch row C, so its shapes stay
// static.  This kernel writes the emitters' windows only.  The scratch row's
// contents are therefore not part of the semantics (sampling never sees row
// C), and neither are builder steps at or past the new buf_len: JAX's roll
// wraps the first `stride` steps round to the end, this kernel leaves them.
//
// Bound on the H100: a typical tick writes one step per lane (16 x 7 KB of
// frames and 4 KB of state) and is launch-bound; a lane that emits moves its
// window (120 x 7,056 B) into the ring and, on a full window, moves the
// overlap inside its builder.  Design: grid (column blocks, lanes).  Frame
// and c/h column blocks give each thread one 16-byte column of its lane's
// builder rows, which the thread walks over all L steps: the ring copy and
// the in-place carry-over (which overlaps itself when stride < L - stride)
// read a batch of 8 steps into registers before writing any of them, so no
// step is overwritten before it is read, and no two threads touch one
// address.  The scalar block of an emitting lane stages its [L] actions,
// rewards and dones in shared memory and writes them, the valids and the
// priority; a lane that does not emit has its step's scalars written by its
// first state block, and a tick on which no lane emits launches no scalar
// blocks.
//
// The R2D2 act tick's prologue (train_anakin_r2d2.py:build_act_append; in the
// JAX package one jitted graph, rainbow_iqn_apex_tpu/train_anakin_r2d2.py:
// 444-456, that XLA fuses) is this launch with two more parts, so the tick
// runs nothing on the card before the act but this kernel:
//   (b) the device frame stack [lanes, H, W, h] u8: zero the lanes whose
//       episode was cut last tick (keep [lanes] 0 / 1), then shift this
//       tick's frame into the last channel (parallel/multihost.py:shift_stack).
//       At h == 4 a thread takes four pixels' history words and shifts the
//       new frame's byte into each with __byte_perm;
//   (c) pre = lstm * keep, the LSTM state the act starts from, written into
//       new tensors (the next tick's append stores it); done by the state
//       blocks beside the append's c / h columns.
// On the first tick (no last transition yet) the launch does (b) and (c).
// The lane plan passed by value stays sized for MAX_LANES (3.3 KB): a plan
// sized to the call's lanes (16, 64 or 256 entries, three instantiations a
// type) measured no difference the run-to-run spread resolves on the H100.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int MAX_LANES = 256;
constexpr int THREADS = 128;
constexpr int BATCH = 8;  // steps a column thread reads before it writes

struct LaneArgs {
    int k[MAX_LANES];           // buf_len before the write
    int slot[MAX_LANES];        // ring row of the emitted window, -1 for none
    float reward[MAX_LANES];
    unsigned char flags[MAX_LANES];  // bit 0: terminal; bit 1: carry over (full, no cut)
};

// The prologue's parts (b) and (c); stack == nullptr: the append alone.
struct Prologue {
    unsigned char* stack;        // [lanes, hw, h] u8, in place
    const unsigned char* frame;  // [lanes, hw] u8: this tick's
    const unsigned char* keep;   // [lanes] u8
    const float* lstm_c;         // [lanes, m] f32: the act's state after last tick
    const float* lstm_h;
    float* pre_c;                // [lanes, m] f32 out: lstm * keep
    float* pre_h;
    int h;
    int quads;                   // h == 4 and aligned: four pixels a thread; else 0
};

// Part (b) for one thread: pixels [4q, 4q + 4) of the lane at h == 4, else
// pixel q.  keep is 0 or 1 (a cut lane's stack restarts from zeros).
__device__ __forceinline__ void shift_pixels(const Prologue& pro, int lane, int hw, int q) {
    const bool kept = pro.keep[lane] != 0;
    if (pro.quads) {
        if (q >= hw / 4) return;
        uint4* st = reinterpret_cast<uint4*>(pro.stack + (long)lane * hw * 4) + q;
        const uint32_t f = reinterpret_cast<const uint32_t*>(pro.frame + (long)lane * hw)[q];
        const uint4 old = kept ? *st : make_uint4(0u, 0u, 0u, 0u);
        // channels 1..3 move down a byte; pixel i's new frame byte (f's byte i) goes last
        *st = make_uint4(__byte_perm(old.x, f, 0x4321), __byte_perm(old.y, f, 0x5321),
                         __byte_perm(old.z, f, 0x6321), __byte_perm(old.w, f, 0x7321));
        return;
    }
    if (q >= hw) return;
    const int h = pro.h;
    unsigned char* px = pro.stack + ((long)lane * hw + q) * h;
    for (int c = 0; c + 1 < h; ++c) px[c] = kept ? px[c + 1] : 0;
    px[h - 1] = pro.frame[(long)lane * hw + q];
}

// One 16-byte (or 1-byte) column of a lane's [L, cols] builder rows: the new
// step, then the emitted window and the carry-over.  `ring` null: no window
// to write (c and h have none; init_c / init_h are written by the caller).
template <typename V>
__device__ __forceinline__ void column(const V* __restrict__ in, V* buf, V* __restrict__ ring,
                                       int cols, int col, int L, int stride, int k, bool emit,
                                       bool carry) {
    const V v_new = in[col];
    buf[(long)k * cols + col] = v_new;
    if (!emit) return;
    const V zero{};
    if (ring != nullptr) {
        for (int j0 = 0; j0 < L; j0 += BATCH) {
            V v[BATCH];
#pragma unroll
            for (int r = 0; r < BATCH; ++r) {
                const int j = j0 + r;
                v[r] = j < k ? buf[(long)j * cols + col] : (j == k ? v_new : zero);
            }
#pragma unroll
            for (int r = 0; r < BATCH; ++r) {
                const int j = j0 + r;
                if (j >= L) break;
                ring[(long)j * cols + col] = v[r];
                if (carry && j >= stride) buf[(long)(j - stride) * cols + col] = v[r];
            }
        }
        return;
    }
    if (!carry) return;
    const int tail = L - stride;  // carry: k == L - 1, every step j < L is written
    for (int j0 = 0; j0 < tail; j0 += BATCH) {
        V v[BATCH];
#pragma unroll
        for (int r = 0; r < BATCH; ++r) {
            const int j = j0 + r + stride;
            v[r] = j < k ? buf[(long)j * cols + col] : v_new;
        }
#pragma unroll
        for (int r = 0; r < BATCH; ++r) {
            if (j0 + r >= tail) break;
            buf[(long)(j0 + r) * cols + col] = v[r];
        }
    }
}

// Blocks of a lane (blockIdx.x): frame columns [0, frame_blocks), c then h
// columns (state_blocks each), scalar_blocks (0 or 1), then stack blocks.
// append == 0: the prologue's first tick, parts (b) and (c) only.
template <typename V>
__global__ void __launch_bounds__(THREADS) seq_append_kernel(
    const V* __restrict__ frames_in, const int* __restrict__ actions_in,
    const float* __restrict__ c_in, const float* __restrict__ h_in,
    V* __restrict__ frames, int* __restrict__ actions, float* __restrict__ rewards,
    bool* __restrict__ dones, bool* __restrict__ valids, float* __restrict__ init_c,
    float* __restrict__ init_h, float* __restrict__ priority,
    const float* __restrict__ max_priority, V* buf_frames, int* buf_actions, float* buf_rewards,
    bool* buf_dones, float* buf_c, float* buf_h, int L, int fcols, int hw, int m, int stride,
    int append, int frame_blocks, int state_blocks, int scalar_blocks,
    const __grid_constant__ LaneArgs args, const __grid_constant__ Prologue pro) {
    extern __shared__ unsigned char smem[];
    const int lane = blockIdx.y;
    const int k = append ? args.k[lane] : 0, slot = append ? args.slot[lane] : -1;
    const bool emit = slot >= 0, carry = append && (args.flags[lane] & 2) != 0;
    const int b = blockIdx.x;
    if (b >= frame_blocks + 2 * state_blocks + scalar_blocks) {  // (b): the frame stack
        shift_pixels(pro, lane, hw, (b - frame_blocks - 2 * state_blocks - scalar_blocks) * THREADS +
                                        (int)threadIdx.x);
        return;
    }
    if (b < frame_blocks) {  // frames: one column per thread
        const int col = b * THREADS + threadIdx.x;
        if (col >= fcols) return;
        column<V>(frames_in + (long)lane * fcols, buf_frames + (long)lane * L * fcols,
                  emit ? frames + (long)slot * L * fcols : nullptr, fcols, col, L, stride, k,
                  emit, carry);
        return;
    }
    if (b < frame_blocks + 2 * state_blocks) {  // c, then h: one float4 column per thread
        const bool is_c = b < frame_blocks + state_blocks;
        const int col = (b - frame_blocks - (is_c ? 0 : state_blocks)) * THREADS + threadIdx.x;
        const int cols = m / 4;
        if (is_c && append && !emit && b == frame_blocks && threadIdx.x == 0) {
            // a lane that does not emit: its step's scalars (no scalar block runs for it)
            buf_actions[(long)lane * L + k] = actions_in[lane];
            buf_rewards[(long)lane * L + k] = args.reward[lane];
            buf_dones[(long)lane * L + k] = (args.flags[lane] & 1) != 0;
        }
        if (col >= cols) return;
        if (pro.stack != nullptr) {  // (c): pre = lstm * keep
            const float kf = (float)pro.keep[lane];
            const float4 x = reinterpret_cast<const float4*>((is_c ? pro.lstm_c : pro.lstm_h) +
                                                             (long)lane * m)[col];
            reinterpret_cast<float4*>((is_c ? pro.pre_c : pro.pre_h) + (long)lane * m)[col] =
                make_float4(__fmul_rn(x.x, kf), __fmul_rn(x.y, kf), __fmul_rn(x.z, kf),
                            __fmul_rn(x.w, kf));
        }
        if (!append) return;
        const float4* in = reinterpret_cast<const float4*>((is_c ? c_in : h_in) + (long)lane * m);
        float4* buf = reinterpret_cast<float4*>((is_c ? buf_c : buf_h) + (long)lane * L * m);
        if (emit) {  // the window's initial state: builder step 0 after this step's write
            float4* init = reinterpret_cast<float4*>((is_c ? init_c : init_h) + (long)slot * m);
            init[col] = k == 0 ? in[col] : buf[col];
        }
        column<float4>(in, buf, nullptr, cols, col, L, stride, k, emit, carry);
        return;
    }
    // an emitting lane's actions, rewards, dones, valids and priority
    if (!emit) return;
    const int a_new = actions_in[lane];
    const float r_new = args.reward[lane];
    const bool d_new = (args.flags[lane] & 1) != 0;
    int* buf_a = buf_actions + (long)lane * L;
    float* buf_r = buf_rewards + (long)lane * L;
    bool* buf_d = buf_dones + (long)lane * L;
    int* a_s = reinterpret_cast<int*>(smem);
    float* r_s = reinterpret_cast<float*>(a_s + L);
    bool* d_s = reinterpret_cast<bool*>(r_s + L);
    for (int j = threadIdx.x; j < L; j += THREADS) {
        a_s[j] = j < k ? buf_a[j] : (j == k ? a_new : 0);
        r_s[j] = j < k ? buf_r[j] : (j == k ? r_new : 0.f);
        d_s[j] = j < k ? buf_d[j] : (j == k ? d_new : false);
    }
    __syncthreads();
    const long row = (long)slot * L;
    for (int j = threadIdx.x; j < L; j += THREADS) {
        actions[row + j] = a_s[j];
        rewards[row + j] = r_s[j];
        dones[row + j] = d_s[j];
        valids[row + j] = j <= k;
        if (carry) {
            if (j < L - stride) {
                buf_a[j] = a_s[j + stride];
                buf_r[j] = r_s[j + stride];
                buf_d[j] = d_s[j + stride];
            }
        } else if (j == k) {
            buf_a[j] = a_new;
            buf_r[j] = r_new;
            buf_d[j] = d_new;
        }
    }
    if (threadIdx.x == 0) priority[slot] = *max_priority;
}

template <typename V>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t s, const void* frames_in,
                   const void* actions_in, const void* c_in, const void* h_in, void* frames,
                   void* actions, void* rewards, void* dones, void* valids, void* init_c,
                   void* init_h, void* priority, const void* max_priority, void* buf_frames,
                   void* buf_actions, void* buf_rewards, void* buf_dones, void* buf_c,
                   void* buf_h, const int* k, const int* slot, const float* reward,
                   const unsigned char* flags, int lanes, int L, int fcols, int hw, int m,
                   int stride, int append, int frame_blocks, int state_blocks, int scalar_blocks,
                   const Prologue& pro) {
    LaneArgs args{};
    for (int i = 0; append && i < lanes; ++i) {
        args.k[i] = k[i];
        args.slot[i] = slot[i];
        args.reward[i] = reward[i];
        args.flags[i] = flags[i];
    }
    seq_append_kernel<V><<<grid, THREADS, smem, s>>>(
        static_cast<const V*>(frames_in), static_cast<const int*>(actions_in),
        static_cast<const float*>(c_in), static_cast<const float*>(h_in), static_cast<V*>(frames),
        static_cast<int*>(actions), static_cast<float*>(rewards), static_cast<bool*>(dones),
        static_cast<bool*>(valids), static_cast<float*>(init_c), static_cast<float*>(init_h),
        static_cast<float*>(priority), static_cast<const float*>(max_priority),
        static_cast<V*>(buf_frames), static_cast<int*>(buf_actions),
        static_cast<float*>(buf_rewards), static_cast<bool*>(buf_dones),
        static_cast<float*>(buf_c), static_cast<float*>(buf_h), L, fcols, hw, m, stride, append,
        frame_blocks, state_blocks, scalar_blocks, args, pro);
    return cudaGetLastError();
}

}  // namespace

PORT_API int port_seq_append_max_lanes() { return MAX_LANES; }

// Ring: frames [C+1, L, hw] u8, actions [C+1, L] i32, rewards [C+1, L] f32,
// dones / valids [C+1, L] bool, init_c / init_h [C+1, m] f32, priority [C]
// f32, max_priority [] f32.  Builders: buf_frames [lanes, L, hw] u8,
// buf_actions [lanes, L] i32, buf_rewards [lanes, L] f32, buf_dones [lanes, L]
// bool, buf_c / buf_h [lanes, L, m] f32.  The last transition: frames_in
// [lanes, hw] u8, actions_in [lanes] i32, c_in / h_in [lanes, m] f32 on the
// device; k, slot [lanes] int32, reward [lanes] f32 and flags [lanes] u8 on
// the host; append 0: none (the prologue's first tick).  `vec16`: hw is a
// multiple of 16 and the frame pointers are 16-byte aligned.  The prologue
// (stack non-null): stack [lanes, hw, h] u8 in place, frame [lanes, hw] u8,
// keep [lanes] u8, lstm_c / lstm_h [lanes, m] f32 in, pre_c / pre_h [lanes, m]
// f32 out; `quads`: h == 4 and stack 16-byte, frame 4-byte aligned.
PORT_API int port_seq_append(const void* frames_in, const void* actions_in, const void* c_in,
                             const void* h_in, void* frames, void* actions, void* rewards,
                             void* dones, void* valids, void* init_c, void* init_h,
                             void* priority, const void* max_priority, void* buf_frames,
                             void* buf_actions, void* buf_rewards, void* buf_dones, void* buf_c,
                             void* buf_h, const int* k, const int* slot, const float* reward,
                             const unsigned char* flags, int lanes, int L, int hw, int m,
                             int stride, int vec16, int append, void* stack, const void* frame,
                             const void* keep, const void* lstm_c, const void* lstm_h,
                             void* pre_c, void* pre_h, int history, int quads, void* stream) {
    const bool prologue = stack != nullptr;
    if (lanes < 1 || lanes > MAX_LANES || L < 1 || stride < 1 || stride > L || m % 4 != 0 ||
        (!prologue && !append) ||
        (prologue && (frame == nullptr || keep == nullptr || lstm_c == nullptr ||
                      lstm_h == nullptr || pre_c == nullptr || pre_h == nullptr || history < 1 ||
                      (quads && history != 4))))
        return (int)cudaErrorInvalidValue;
    int any_emit = 0;
    for (int i = 0; append && i < lanes; ++i) any_emit |= slot[i] >= 0;
    const int fcols = vec16 ? hw / 16 : hw;
    const int frame_blocks = append ? (fcols + THREADS - 1) / THREADS : 0;
    const int state_blocks = (m / 4 + THREADS - 1) / THREADS;
    const int scalar_blocks = any_emit;
    const int stack_blocks = prologue ? ((quads ? hw / 4 : hw) + THREADS - 1) / THREADS : 0;
    const dim3 grid(frame_blocks + 2 * state_blocks + scalar_blocks + stack_blocks, lanes);
    const size_t smem = (size_t)L * (sizeof(int) + sizeof(float) + sizeof(bool));
    const Prologue pro{static_cast<unsigned char*>(stack), static_cast<const unsigned char*>(frame),
                       static_cast<const unsigned char*>(keep), static_cast<const float*>(lstm_c),
                       static_cast<const float*>(lstm_h), static_cast<float*>(pre_c),
                       static_cast<float*>(pre_h), history, quads};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return (int)(vec16 ? launch<uint4> : launch<unsigned char>)(
        grid, smem, s, frames_in, actions_in, c_in, h_in, frames, actions, rewards, dones, valids,
        init_c, init_h, priority, max_priority, buf_frames, buf_actions, buf_rewards, buf_dones,
        buf_c, buf_h, k, slot, reward, flags, lanes, L, fcols, hw, m, stride, append,
        frame_blocks, state_blocks, scalar_blocks, pro);
}
