// Fused native hot paths for the prioritized frame replay (v2).
//
// Parity: the reference's replay critical path is redis-server's C event
// loop + the per-sample Python assembly in rainbowiqn/memory.py (SURVEY.md
// §2 row 5, §7 "hard parts": the host replay is on the critical path long
// before the accelerator is).  v1 moved the sum-tree walks native
// (sumtree.cc); v2 fuses the remaining per-tick / per-batch work:
//
//   rb_append_tick  — one call per lockstep actor tick: ring writes for all
//                     lanes, fresh/dead-zone/ready-slot priority updates
//                     (including the truncation-eligibility rule), all tree
//                     ancestor fix-ups.
//   rb_assemble     — one call per sampled batch: n-step reward/discount
//                     scan plus BOTH frame-stack gathers, written directly
//                     in the device layout [B, H, W, hist] (uint8), with
//                     episode-cut zeroing and young-buffer age masking.
//
// Storage stays NumPy-owned (zero-copy ctypes, trivial snapshots); C++ only
// runs the loops.  Semantics mirror replay/buffer.py exactly — the fuzz
// test in tests/test_replay.py drives both implementations on identical
// streams and asserts bit-equal trees and batches.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Leaf assignment + ancestor fix-up (same walk as sumtree.cc st_set).
inline void leaf_set(double* tree, int64_t span, int64_t leaf, double pri) {
  int64_t node = span + leaf;
  double delta = pri - tree[node];
  if (delta == 0.0) return;
  for (; node >= 1; node >>= 1) tree[node] += delta;
}

inline int64_t mod(int64_t a, int64_t m) {
  int64_t r = a % m;
  return r < 0 ? r + m : r;
}

}  // namespace

extern "C" {

// One lockstep append tick for all lanes.  Mirrors
// PrioritizedReplay._append_locked; pos/filled advance on the Python side.
// priorities may be null (-> every ready slot gets max_priority as-is);
// when given, raw |TD| values are transformed to (p + eps)^omega and
// *max_priority is raised to the batch max BEFORE eligibility zeroing.
void rb_append_tick(
    uint8_t* frames, int32_t* actions, float* rewards, uint8_t* terminals,
    uint8_t* cuts, double* tree, int64_t span,
    int64_t lanes, int64_t seg, int64_t pos, int64_t filled,
    int64_t history, int64_t n_step, int64_t frame_bytes,
    const uint8_t* new_frames, const int32_t* new_actions,
    const float* new_rewards, const uint8_t* new_terminals,
    const uint8_t* new_truncs,  // may be null (-> cuts = terminals)
    const double* priorities,   // may be null
    double eps, double omega, double* max_priority) {
  const int64_t new_pos = (pos + 1) % seg;

  for (int64_t i = 0; i < lanes; ++i) {
    const int64_t slot = i * seg + pos;
    std::memcpy(frames + slot * frame_bytes, new_frames + i * frame_bytes,
                static_cast<size_t>(frame_bytes));
    actions[slot] = new_actions[i];
    rewards[slot] = new_rewards[i];
    terminals[slot] = new_terminals[i];
    cuts[slot] = new_truncs ? (new_terminals[i] | new_truncs[i])
                            : new_terminals[i];
    // fresh slot: not sampleable until its n-step future exists
    leaf_set(tree, span, slot, 0.0);
    // cursor dead zone: lookback windows crossing the write cursor would
    // mix frames from two ring laps
    for (int64_t j = 0; j < history; ++j) {
      leaf_set(tree, span, i * seg + (new_pos + j) % seg, 0.0);
    }
  }

  if (filled >= n_step) {
    const int64_t ready = mod(pos - n_step, seg);
    double mp = *max_priority;
    if (priorities) {
      for (int64_t i = 0; i < lanes; ++i) {
        const double p = std::pow(priorities[i] + eps, omega);
        if (p > mp) mp = p;
      }
      *max_priority = mp;
    }
    for (int64_t i = 0; i < lanes; ++i) {
      double pri = priorities ? std::pow(priorities[i] + eps, omega) : mp;
      // Unbiased time-limit rule: a window whose FIRST cut is a truncation
      // can't form a correct bootstrap target — never eligible.
      for (int64_t w = 0; w < n_step; ++w) {
        const int64_t ws = i * seg + (ready + w) % seg;
        if (cuts[ws]) {
          if (!terminals[ws]) pri = 0.0;
          break;
        }
      }
      leaf_set(tree, span, i * seg + ready, pri);
    }
  }
}

// Batched n-step assembly + both stack gathers in device layout.
// out_obs / out_next_obs: [B, H*W, history] uint8 (channels-last).
void rb_assemble(
    const uint8_t* frames, const int32_t* actions, const float* rewards,
    const uint8_t* terminals, const uint8_t* cuts,
    int64_t seg, int64_t filled, int64_t history, int64_t n_step,
    int64_t frame_bytes, const float* gammas /* [n_step + 1] */,
    const int64_t* idx, int64_t batch,
    uint8_t* out_obs, uint8_t* out_next_obs,
    int32_t* out_action, float* out_reward, float* out_discount) {
  const int64_t h = history;
  // Invalid window frames read from this zero page instead of branching
  // per byte in the interleave loop (keeps it straight-line for the
  // autovectorizer).
  std::vector<uint8_t> zero(static_cast<size_t>(frame_bytes), 0);

  for (int64_t b = 0; b < batch; ++b) {
    const int64_t lane = idx[b] / seg;
    const int64_t off = idx[b] % seg;
    const int64_t base = lane * seg;

    // --- n-step reward scan (truncate at terminal, bootstrap discount) ----
    float rn = 0.0f;
    float alive = 1.0f;  // no terminal strictly before step k
    int done_within = 0;
    for (int64_t k = 0; k < n_step; ++k) {
      const int64_t slot = base + (off + k) % seg;
      if (k > 0) alive *= 1.0f - static_cast<float>(
                              terminals[base + (off + k - 1) % seg]);
      rn += rewards[slot] * alive * gammas[k];
      done_within |= terminals[slot];
    }
    out_reward[b] = rn;
    out_discount[b] = done_within ? 0.0f : gammas[n_step];
    out_action[b] = actions[base + off];

    // --- both stacks, interleaved channels-last --------------------------
    for (int pass = 0; pass < 2; ++pass) {
      const int64_t end = pass ? (off + n_step) % seg : off;
      uint8_t* out = (pass ? out_next_obs : out_obs) + b * frame_bytes * h;

      // validity per window position j (frame at end - (h-1-j)):
      // a cut at window position j < h-1 kills frames [0..j]; in a young
      // buffer, offsets before slot 0 were never written.
      const uint8_t* src[16];  // history <= 16 in any sane config
      for (int64_t j = 0; j < h; ++j) {
        const int64_t rel = end + j - (h - 1);
        src[j] = (filled >= seg || rel >= 0)
                     ? frames + (base + mod(rel, seg)) * frame_bytes
                     : zero.data();
      }
      for (int64_t j = h - 2; j >= 0; --j) {
        if (cuts[base + mod(end + j - (h - 1), seg)]) {
          // cut AT window position j kills frames [0..j]
          for (int64_t k = j; k >= 0; --k) src[k] = zero.data();
          break;  // earlier cuts only re-kill already-dead frames
        }
      }
      if (h == 4) {  // the Atari shape: branchless 4-way byte interleave
        const uint8_t *s0 = src[0], *s1 = src[1], *s2 = src[2], *s3 = src[3];
        for (int64_t p = 0; p < frame_bytes; ++p) {
          uint8_t* o = out + p * 4;
          o[0] = s0[p]; o[1] = s1[p]; o[2] = s2[p]; o[3] = s3[p];
        }
      } else {
        for (int64_t p = 0; p < frame_bytes; ++p) {
          uint8_t* o = out + p * h;
          for (int64_t j = 0; j < h; ++j) o[j] = src[j][p];
        }
      }
    }
  }
}

}  // extern "C"
