// K6f: the device sample frontier's fenced write-back into the priority
// mirror, applied from its queue of mirror updates.
//
//   for each segment of the queue, in order:
//     staged:      p[idx[k]] = value[k]                          (distinct slots)
//     write-back:  pri[k]    = (|td[k]| + eps)^omega
//                  p[idx[k]] = p[idx[k]] > 0 ? pri[k] : 0        (never resurrect a zero slot)
//
// Replaces DeviceSampleFrontier's _writeback (rainbow_iqn_apex_tpu/replay/frontier.py:145-153)
// and its staged scatter (:305-327), XLA-fused graphs on the TPU.  A
// write-back batch is K6 (csrc/replay_writeback.cu) for one group, with the
// absolute value taken and no running max priority (the frontier keeps the
// fresh-item default on the host trees): its fence reads the mirror as the
// segments before it left it, and a repeated id is written once, with its
// last occurrence's value (JAX's scatter leaves their order open,
// frontier.py:275-277; the host replay's sequential update keeps the last).
// omega == 0.5 takes sqrtf.  An id outside [0, N) is dropped.
//
// The frontier (replay/frontier.py) queues its staged appends and learner
// write-backs in program order instead of launching for each; its next draw
// applies them inside K5f's first launch (replay_draw.cu, the queue mode).
// This launch applies the queue where the mirror is read or changed outside
// a draw: reconcile, drop, readmit, the read-back, a full queue.  The
// segments' semantics live in writeback.cuh (apply_segment), shared by both.
//
// Bound on the H100: a few hundred bytes a batch of 32: launch-bound.
// Design: one block walks the segments in order, a barrier between each
// batch's fence reads and its writes; a thread a row of the largest segment
// (a warp for the apex loop's batches of 32: its barriers cost next to
// nothing), at most 1,024, each taking up to 4 rows of a larger batch.
#include "common.cuh"
#include "writeback.cuh"

namespace {

constexpr int MAX_THREADS = 1024;

__global__ void __launch_bounds__(MAX_THREADS) queue_apply_kernel(
    float* __restrict__ p, int N, const __grid_constant__ port::MirrorQueue q) {
    __shared__ port::QueueSegment seg[port::kQueueSegments];
    port::copy_segments(q, seg);
    __syncthreads();
    const port::MirrorSlots slots{p, 0, N};
    for (int s = 0; s < q.segments; ++s) port::apply_segment(seg[s], q.eps, q.omega, slots);
}

}  // namespace

// p [N] f32 in place; queue: a host MirrorQueue of 1..kQueueSegments segments,
// a write-back batch at most kSegmentRows * 256 rows.
PORT_API int port_frontier_writeback(void* p, int N, const void* queue, void* stream) {
    const port::MirrorQueue* q = static_cast<const port::MirrorQueue*>(queue);
    if (N < 1 || q == nullptr || q->segments < 1 || q->segments > port::kQueueSegments)
        return (int)cudaErrorInvalidValue;
    int rows = 1;
    for (int s = 0; s < q->segments; ++s) rows = q->seg[s].n > rows ? q->seg[s].n : rows;
    const int threads = rows >= MAX_THREADS ? MAX_THREADS : ((rows + 31) / 32) * 32;
    queue_apply_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(p), N, *q);
    return (int)cudaGetLastError();
}
