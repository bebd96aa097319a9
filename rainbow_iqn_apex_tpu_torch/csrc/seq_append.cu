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
// address.  The last column block of a lane stages its [L] actions, rewards
// and dones in shared memory and writes them, the valids and the priority.
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

template <typename V>
__global__ void __launch_bounds__(THREADS) seq_append_kernel(
    const V* __restrict__ frames_in, const int* __restrict__ actions_in,
    const float* __restrict__ c_in, const float* __restrict__ h_in,
    V* __restrict__ frames, int* __restrict__ actions, float* __restrict__ rewards,
    bool* __restrict__ dones, bool* __restrict__ valids, float* __restrict__ init_c,
    float* __restrict__ init_h, float* __restrict__ priority,
    const float* __restrict__ max_priority, V* buf_frames, int* buf_actions, float* buf_rewards,
    bool* buf_dones, float* buf_c, float* buf_h, int L, int fcols, int m, int stride,
    int frame_blocks, int state_blocks, LaneArgs args) {
    extern __shared__ unsigned char smem[];
    const int lane = blockIdx.y;
    const int k = args.k[lane], slot = args.slot[lane];
    const bool emit = slot >= 0, carry = (args.flags[lane] & 2) != 0;
    const int b = blockIdx.x;
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
        if (col >= cols) return;
        const float4* in = reinterpret_cast<const float4*>((is_c ? c_in : h_in) + (long)lane * m);
        float4* buf = reinterpret_cast<float4*>((is_c ? buf_c : buf_h) + (long)lane * L * m);
        if (emit) {  // the window's initial state: builder step 0 after this step's write
            float4* init = reinterpret_cast<float4*>((is_c ? init_c : init_h) + (long)slot * m);
            init[col] = k == 0 ? in[col] : buf[col];
        }
        column<float4>(in, buf, nullptr, cols, col, L, stride, k, emit, carry);
        return;
    }
    // actions, rewards, dones, valids and the priority of this lane
    const int a_new = actions_in[lane];
    const float r_new = args.reward[lane];
    const bool d_new = (args.flags[lane] & 1) != 0;
    int* buf_a = buf_actions + (long)lane * L;
    float* buf_r = buf_rewards + (long)lane * L;
    bool* buf_d = buf_dones + (long)lane * L;
    if (!emit) {
        if (threadIdx.x == 0) {
            buf_a[k] = a_new;
            buf_r[k] = r_new;
            buf_d[k] = d_new;
        }
        return;
    }
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

}  // namespace

PORT_API int port_seq_append_max_lanes() { return MAX_LANES; }

// Ring: frames [C+1, L, hw] u8, actions [C+1, L] i32, rewards [C+1, L] f32,
// dones / valids [C+1, L] bool, init_c / init_h [C+1, m] f32, priority [C]
// f32, max_priority [] f32.  Builders: buf_frames [lanes, L, hw] u8,
// buf_actions [lanes, L] i32, buf_rewards [lanes, L] f32, buf_dones [lanes, L]
// bool, buf_c / buf_h [lanes, L, m] f32.  This tick: frames_in [lanes, hw] u8,
// actions_in [lanes] i32, c_in / h_in [lanes, m] f32 on the device; k, slot
// [lanes] int32, reward [lanes] f32 and flags [lanes] u8 on the host.  `vec16`:
// hw is a multiple of 16 and the frame pointers are 16-byte aligned.
PORT_API int port_seq_append(const void* frames_in, const void* actions_in, const void* c_in,
                             const void* h_in, void* frames, void* actions, void* rewards,
                             void* dones, void* valids, void* init_c, void* init_h,
                             void* priority, const void* max_priority, void* buf_frames,
                             void* buf_actions, void* buf_rewards, void* buf_dones, void* buf_c,
                             void* buf_h, const int* k, const int* slot, const float* reward,
                             const unsigned char* flags, int lanes, int L, int hw, int m,
                             int stride, int vec16, void* stream) {
    if (lanes < 1 || lanes > MAX_LANES || L < 1 || stride < 1 || stride > L || m % 4 != 0)
        return (int)cudaErrorInvalidValue;
    LaneArgs args;
    for (int i = 0; i < lanes; ++i) {
        args.k[i] = k[i];
        args.slot[i] = slot[i];
        args.reward[i] = reward[i];
        args.flags[i] = flags[i];
    }
    const int fcols = vec16 ? hw / 16 : hw;
    const int frame_blocks = (fcols + THREADS - 1) / THREADS;
    const int state_blocks = (m / 4 + THREADS - 1) / THREADS;
    const dim3 grid(frame_blocks + 2 * state_blocks + 1, lanes);
    const size_t smem = (size_t)L * (sizeof(int) + sizeof(float) + sizeof(bool));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PORT_SEQ_APPEND_ARGS(V)                                                                   \
    static_cast<const V*>(frames_in), static_cast<const int*>(actions_in),                        \
        static_cast<const float*>(c_in), static_cast<const float*>(h_in), static_cast<V*>(frames), \
        static_cast<int*>(actions), static_cast<float*>(rewards), static_cast<bool*>(dones),      \
        static_cast<bool*>(valids), static_cast<float*>(init_c), static_cast<float*>(init_h),     \
        static_cast<float*>(priority), static_cast<const float*>(max_priority),                   \
        static_cast<V*>(buf_frames), static_cast<int*>(buf_actions),                              \
        static_cast<float*>(buf_rewards), static_cast<bool*>(buf_dones),                          \
        static_cast<float*>(buf_c), static_cast<float*>(buf_h), L, fcols, m, stride,              \
        frame_blocks, state_blocks, args
    if (vec16) {
        seq_append_kernel<uint4><<<grid, THREADS, smem, s>>>(PORT_SEQ_APPEND_ARGS(uint4));
    } else {
        seq_append_kernel<unsigned char><<<grid, THREADS, smem, s>>>(
            PORT_SEQ_APPEND_ARGS(unsigned char));
    }
#undef PORT_SEQ_APPEND_ARGS
    return (int)cudaGetLastError();
}
