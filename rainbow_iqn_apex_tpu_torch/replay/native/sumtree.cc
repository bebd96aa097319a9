// Native sum-tree hot path for prioritized replay.
//
// Parity: replaces the per-item Python tree walk of the reference's
// rainbowiqn/memory.py SegmentTree (SURVEY.md §2 row 5) — the component
// SURVEY.md §7 singles out as the justified native rewrite: at the build's
// target throughput the host-side tree is on the critical path long before
// the TPU is.
//
// Design: the tree is a NumPy-owned flat double array (implicit binary heap,
// root at 1, leaves at [span, span+capacity)); C++ only runs the loops.
// Keeping storage on the Python side makes snapshots/checkpoints trivial and
// the binding zero-copy.  All functions are plain C ABI for ctypes.

#include <cstdint>

extern "C" {

// Batched leaf assignment + ancestor fix-up. Sequential per item, so
// duplicate indices naturally resolve to last-write-wins (the reference's
// per-item loop semantics).
void st_set(double* tree, int64_t span, const int64_t* idx, const double* pri,
            int64_t n) {
  for (int64_t k = 0; k < n; ++k) {
    int64_t node = span + idx[k];
    double delta = pri[k] - tree[node];
    if (delta == 0.0) continue;
    for (; node >= 1; node >>= 1) tree[node] += delta;
  }
}

// Batched prefix-sum descent: out[k] = leaf index whose cumulative-priority
// interval contains mass[k]. Clamps to capacity-1 (fp edge-fall guard).
void st_find_prefix(const double* tree, int64_t span, int64_t capacity,
                    const double* mass, int64_t* out, int64_t n) {
  for (int64_t k = 0; k < n; ++k) {
    double m = mass[k];
    int64_t node = 1;
    while (node < span) {
      int64_t left = node << 1;
      double lsum = tree[left];
      if (m < lsum) {
        node = left;
      } else {
        m -= lsum;
        node = left + 1;
      }
    }
    int64_t leaf = node - span;
    out[k] = leaf < capacity ? leaf : capacity - 1;
  }
}

// Fused stratified sample: mass[k] pre-drawn by the caller (keeps RNG in
// NumPy for reproducibility); returns leaves and their raw priorities.
void st_sample(const double* tree, int64_t span, int64_t capacity,
               const double* mass, int64_t* out_idx, double* out_pri,
               int64_t n) {
  st_find_prefix(tree, span, capacity, mass, out_idx, n);
  for (int64_t k = 0; k < n; ++k) out_pri[k] = tree[span + out_idx[k]];
}

}  // extern "C"
