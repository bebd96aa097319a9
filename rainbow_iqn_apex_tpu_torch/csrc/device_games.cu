// K12: the device games' tick, with JAX's Threefry key stream.
//
// Replaces envs/device_games.py batched_reset_step
// (rainbow_iqn_apex_tpu/envs/device_games.py:974-1011) over each game's
// init / step / render (:105-520; the seeded-level variants :547-825) and
// _upscale (:56-58), XLA-fused and vmapped over lanes on the TPU.  For L
// lanes in one launch:
//   per lane l: kl = split(key, L)[l]; (k_step, k_reset) = split(kl)
//   state, reward, term, trunc = game.step(state, action[l], k_step)
//   fresh = game.init(k_reset)                      (every lane, as JAX does)
//   cut = term | trunc; ep = ep_ret[l] + reward; out_ret = cut ? ep : NaN
//   on a cut: state = fresh, ep_ret = 0; trunc &= ~term
//   frame[l] = upscale(render(state)), uint8 [G*cell, G*cell]
// The other modes of the same kernel: one step with a given key and no reset
// (the host adapter), init (per-lane keys split(key, L), or the key itself)
// and render alone.  The games' random draws are JAX's own bits
// (threefry.cuh), so every integer and boolean result is bit-equal to the
// JAX package and to the plain twins (kernels/device_games.py); rewards are
// small integers in f32 and the returns sums of them, exact as well.
//
// Bound on the H100: the frames written once, L x 6,400 B at 80x80, plus
// the state read and written: launch-bound at training widths (L 16: ~0.03
// us of bytes), byte-bound only at thousands of lanes (L 4,096: ~8 us).
// What stands between a lane and those bounds is a chain of dependent
// Threefry hashes (20 rounds each): a reset of a seeded level hashes its
// level's keys five to seven deep, then up to 30 draws.
//
// Design: a warp per lane, four lanes a 128-thread block, so 4,096 lanes are
// 1,024 blocks, all resident at once (8 blocks an SM at <= 64 registers a
// thread).  The lane's state lives in the warp's registers: scalars the same
// in every thread, an 8-element array spread one element a thread, a 10x10
// grid as a 100-bit mask (four ballot words) in every thread.  The warp
// loads and stores each field in one coalesced access (a grid byte a
// thread).  Every Threefry hash of a tick is assigned to a thread: the
// hashes of one depth of the key tree (the step's draws and the reset's,
// side by side, as the JAX graph computes both) run as one instruction
// stream over the warp's threads, and their results move by shuffles, so a
// tick costs its tree's depth in hashes, not its size.  The step's logic
// runs in every thread at once (no divergence), per-enemy and per-car work
// a thread an element, grid-wide work (occupied columns, the fleet's march,
// the lowest alien, any brick left) by ballots over the warp.  The reset is
// selected on the cut.  The frame: the warp renders the 10x10 grid into
// shared memory, widens it to G rows of G*cell bytes, and copies each frame
// row from its widened row in 16-byte stores.  The game is a template
// parameter (one instantiation per game and variant); the host picks it.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "threefry.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int G = 10;
constexpr int MAX_FIELDS = 12;
constexpr int WARPS = 4;  // lanes (warps) a block
constexpr int CATCH = 0, BREAKOUT = 1, FREEWAY = 2, ASTERIX = 3, INVADERS = 4;
constexpr int VARIANT = 5;  // game id + 5: the seeded-level variant
constexpr uint32_t LEVEL_BASE_KEY = 9137u;
constexpr uint8_t I_PLAYER = 140, I_BALL = 255, I_BRICK = 90, I_ENEMY = 200, I_GOLD = 255,
                  I_BULLET = 255;
// modes
constexpr int TICK = 0, STEP = 1, INIT_SPLIT = 2, INIT_DIRECT = 3, RENDER = 4;

struct Fields {
    void* p[MAX_FIELDS];  // the state's tensors in the NamedTuple's field order
};

// a 10x10 grid of bools: cell j is bit j & 31 of word j >> 5, the same in every thread
struct Grid {
    uint32_t w[4];
};

__device__ __forceinline__ bool cell_of(const Grid& g, int j) {
    const uint32_t word = j < 32 ? g.w[0] : (j < 64 ? g.w[1] : (j < 96 ? g.w[2] : g.w[3]));
    return (word >> (j & 31)) & 1u;
}

__device__ __forceinline__ void clear_cell(Grid& g, int j) {
    const uint32_t keep = ~(1u << (j & 31));
#pragma unroll
    for (int m = 0; m < 4; ++m) g.w[m] &= (j >> 5) == m ? keep : FULL;
}

__device__ __forceinline__ bool any_cell(const Grid& g) {
    return (g.w[0] | g.w[1] | g.w[2] | g.w[3]) != 0u;
}

// the grid whose cell j is pred(j), built by the warp: a cell a thread, one ballot a word
template <typename Pred>
__device__ __forceinline__ Grid ballot_grid(int lane, Pred pred) {
    Grid g;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
        const int j = 32 * m + lane;
        g.w[m] = __ballot_sync(FULL, j < G * G && pred(j));
    }
    return g;
}

// every field any game has; a game uses its own.  Scalars are the same in
// every thread; an array of n <= 32 elements is spread, element j in thread j
// (0 in threads >= n); grids are masks.
struct State {
    int ball_r, ball_c, paddle, t, dr, dc;  // catch, breakout
    int chicken;                            // freeway
    int pr, pc;                             // asterix (pc also invaders)
    int adir, shot_r, shot_c, bomb_r, bomb_c, march_every, bomb_every;  // invaders
    int cars, speeds, dirs;                 // freeway
    int col, dirn, lane_dir;                // asterix
    float gold_p;
    int drift;                              // catch variant
    int active, gold;                       // asterix: 0 or not (a loaded byte as it is)
    Grid bricks, wall;                      // breakout (wall: the variant's template)
    Grid aliens, fleet;                     // invaders (fleet: the variant's template)
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }
__device__ __forceinline__ int move3(int a) { return a == 1 ? -1 : (a == 2 ? 1 : 0); }
__device__ __forceinline__ int sign_bits(uint32_t b) { return tf::uniform_bits(b) < 0.5f ? 1 : -1; }

// one Threefry hash of the counter pair (0, i) under k: split(k, i) as a key,
// or element i of a draw under k as the xor of its words
__device__ __forceinline__ uint2 hash_of(tf::Key k, uint32_t i) {
    uint32_t x0 = 0u, x1 = i;
    tf::hash(k, x0, x1);
    return make_uint2(x0, x1);
}

// the key that thread src hashed (each thread names its own src)
__device__ __forceinline__ tf::Key key_from(uint2 h, int src) {
    return tf::Key{__shfl_sync(FULL, h.x, src), __shfl_sync(FULL, h.y, src)};
}

// the draw bits that thread src hashed
__device__ __forceinline__ uint32_t bits_from(uint2 h, int src) {
    return __shfl_sync(FULL, h.x ^ h.y, src);
}

__device__ __forceinline__ uint32_t own_bits(uint2 h) { return h.x ^ h.y; }

__device__ __forceinline__ tf::Key level_key_of(int level) {
    return tf::split(tf::Key{0u, LEVEL_BASE_KEY}, (uint32_t)level);  // fold_in(PRNGKey(9137), level)
}

__device__ __forceinline__ int shfl_i(int v, int src) { return __shfl_sync(FULL, v, src); }
__device__ __forceinline__ bool shfl_b(bool v, int src) { return __shfl_sync(FULL, (int)v, src) != 0; }

// ------------------------------------------------------------ field i/o
struct Io {
    const Fields& f;
    int l, lane;
    int k = 0;  // next field
    __device__ Io(const Fields& fields, int lane_id, int thread) : f(fields), l(lane_id), lane(thread) {}
    __device__ void i(int& v, bool store) {  // a scalar: read by every thread, stored by one
        int* p = static_cast<int*>(f.p[k]) + l;
        if (store) {
            if (lane == (k & 31)) *p = v;
        } else {
            v = *p;
        }
        ++k;
    }
    template <typename T, typename S>
    __device__ void arr(T& v, int n, bool store) {  // element `lane` of an [L, n] field
        S* p = static_cast<S*>(f.p[k++]) + (size_t)l * n;
        if (store) {
            if (lane < n) p[lane] = (S)v;
        } else {
            v = lane < n ? (T)p[lane] : (T)0;
        }
    }
    __device__ void ia(int& v, int n, bool store) { arr<int, int>(v, n, store); }
    __device__ void fa(float& v, int n, bool store) { arr<float, float>(v, n, store); }
    __device__ void ba(int& v, int n, bool store) {  // a bool's byte, tested where it is used
        uint8_t* p = static_cast<uint8_t*>(f.p[k++]) + (size_t)l * n;
        if (store) {
            if (lane < n) p[lane] = v != 0;
        } else {
            v = lane < n ? p[lane] : 0;
        }
    }
    // [L, G, G] bool, a cell a thread.  A load leaves each thread's four raw
    // bytes in the words, so the loads stay in flight through the tick's
    // hashes; settle() turns them into the mask.
    __device__ void grid(Grid& g, bool store) {
        uint8_t* p = static_cast<uint8_t*>(f.p[k++]) + (size_t)l * G * G;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
            const int j = 32 * m + lane;
            if (store) {
                if (j < G * G) p[j] = (g.w[m] >> lane) & 1u;
            } else {
                g.w[m] = j < G * G ? p[j] : 0u;
            }
        }
    }
};

// a loaded grid's raw bytes (this thread's cells) -> the mask
__device__ __forceinline__ void settle(Grid& g) {
#pragma unroll
    for (int m = 0; m < 4; ++m) g.w[m] = __ballot_sync(FULL, g.w[m] != 0u);
}

// the fields in the order of the JAX NamedTuple of each game
template <int GAME>
__device__ __forceinline__ void fields_io(State& s, const Fields& f, int l, int lane, bool store) {
    Io io(f, l, lane);
    constexpr int base = GAME % VARIANT;
    constexpr bool var = GAME >= VARIANT;
    if (base == CATCH) {
        io.i(s.ball_r, store); io.i(s.ball_c, store); io.i(s.paddle, store);
        if (var) io.ia(s.drift, G, store);
        io.i(s.t, store);
    } else if (base == BREAKOUT) {
        io.i(s.paddle, store); io.i(s.ball_r, store); io.i(s.ball_c, store);
        io.i(s.dr, store); io.i(s.dc, store); io.grid(s.bricks, store);
        if (var) io.grid(s.wall, store);
        io.i(s.t, store);
    } else if (base == FREEWAY) {
        io.i(s.chicken, store); io.ia(s.cars, 8, store);
        if (var) { io.ia(s.speeds, 8, store); io.ia(s.dirs, 8, store); }
        io.i(s.t, store);
    } else if (base == ASTERIX) {
        io.i(s.pr, store); io.i(s.pc, store); io.ba(s.active, 8, store); io.ia(s.col, 8, store);
        io.ia(s.dirn, 8, store); io.ba(s.gold, 8, store);
        if (var) { io.ia(s.speeds, 8, store); io.ia(s.lane_dir, 8, store); io.fa(s.gold_p, 8, store); }
        io.i(s.t, store);
    } else {
        io.i(s.pc, store); io.grid(s.aliens, store); io.i(s.adir, store);
        io.i(s.shot_r, store); io.i(s.shot_c, store); io.i(s.bomb_r, store); io.i(s.bomb_c, store);
        if (var) { io.grid(s.fleet, store); io.i(s.march_every, store); io.i(s.bomb_every, store); }
        io.i(s.t, store);
    }
}

template <int GAME>
__device__ __forceinline__ void settle_grids(State& s) {
    constexpr int base = GAME % VARIANT;
    constexpr bool var = GAME >= VARIANT;
    if (base == BREAKOUT) {
        settle(s.bricks);
        if (var) settle(s.wall);
    } else if (base == INVADERS) {
        settle(s.aliens);
        if (var) settle(s.fleet);
    }
}

__device__ __forceinline__ Grid default_bricks(int lane) {
    return ballot_grid(lane, [](int j) { return j >= G && j < 4 * G; });
}

__device__ __forceinline__ Grid default_aliens(int lane) {
    return ballot_grid(lane, [](int j) {
        const int r = j / G, c = j % G;
        return r >= 1 && r < 5 && c >= 2 && c < 8;
    });
}

// ------------------------------------------------- draws and the reset
// The Threefry hashes of one tick by depth, each thread one hash a depth:
// the step's draws under ks (Asterix's 24 enemy draws, Invaders' bomb
// column) and the fresh init's under ki.  With `init`, f becomes game.init(ki);
// returns this thread's hash of the step's draws (Asterix: element j of the
// spawn / direction / gold draws in threads j, 8 + j, 16 + j; Invaders: the
// pick's two words in threads 0 and 1).  Where `have_levels`, thread 16 + j
// holds level pool_base + j's key in `levels` (hashed first, in the kernel),
// and the variants' first depths, whose own hashes fit in threads 0-15, hash
// that level's first subkeys in threads 16-31 beside them: once the level is
// drawn its subkeys are a shuffle away, not another hash or two deep.
// Otherwise the level's keys are hashed after its draw.  Every thread runs
// every line.
template <int GAME>
__device__ __forceinline__ uint2 draw_tick(State& f, bool init, tf::Key ks, tf::Key ki,
                                           int pool_base, int pool_size, uint2 levels,
                                           bool have_levels, int lane) {
    constexpr int base = GAME % VARIANT;
    constexpr bool var = GAME >= VARIANT;
    uint2 step = make_uint2(0u, 0u);
    const tf::Key lk_own{levels.x, levels.y};  // thread 16 + j: level pool_base + j's key
    const bool low = lane < 16;
    auto level_key = [&](int level) {
        return have_levels ? key_from(levels, 16 + level - pool_base) : level_key_of(level);
    };
    if (base == CATCH && !var) {
        if (!init) return step;
        // randint(ki, 0, 0, G): threads 0, 1 split ki, then hash their halves' element 0
        const uint2 a = hash_of(ki, lane & 1);
        const uint2 b = hash_of(key_from(a, lane & 1), 0);
        f.ball_r = 0;
        f.paddle = G / 2;
        f.ball_c = tf::randint_bits(bits_from(b, 0), bits_from(b, 1), 0, G);
        f.t = 0;
    } else if (base == CATCH) {
        if (!init) return step;
        // (k0, kc) = split(ki); level = randint(k0), ball_c = randint(kc); threads
        // 16 + j: split(level key j) into the drift's two keys
        const uint2 a = hash_of(low ? ki : lk_own, low ? (lane & 1) : 0);
        const tf::Key ka = key_from(a, (lane >> 1) & 1);
        const uint2 b = hash_of(low ? ka : lk_own, low ? (lane & 1) : 1);  // split(k0), split(kc)
        const uint2 c = hash_of(key_from(b, lane & 3), 0);
        const int level = pool_base + tf::randint_bits(bits_from(c, 0), bits_from(c, 1), 0, pool_size);
        f.ball_c = tf::randint_bits(bits_from(c, 2), bits_from(c, 3), 0, G);
        // drift[j] = randint(level_key, j, -1, 2): threads j and 16 + j hash its two words
        uint2 d;
        if (have_levels) {
            const tf::Key k0 = key_from(a, 16 + level - pool_base), k1 = key_from(b, 16 + level - pool_base);
            d = hash_of(low ? k0 : k1, lane & 15);
        } else {
            const uint2 e = hash_of(level_key(level), lane & 1);
            d = hash_of(key_from(e, (lane >> 4) & 1), lane & 15);
        }
        const uint32_t lo = __shfl_sync(FULL, own_bits(d), (lane & 15) + 16);
        f.drift = lane < G - 1 ? tf::randint_bits(own_bits(d), lo, -1, 2) : 0;  // no wind on the last row
        f.ball_r = 0;
        f.paddle = G / 2;
        f.t = 0;
    } else if (base == BREAKOUT && !var) {
        if (!init) return step;
        // (kc, kd) = split(ki); ball_c = randint(kc), dc = sign(kd)
        const uint2 a = hash_of(ki, lane & 1);
        const uint2 b = hash_of(key_from(a, (lane >> 1) & 1), lane & 1);  // split(kc); thread 2: kd's draw
        const uint2 c = hash_of(key_from(b, lane & 1), 0);
        f.ball_c = tf::randint_bits(bits_from(c, 0), bits_from(c, 1), 0, G);
        f.dc = sign_bits(bits_from(b, 2));
        f.bricks = default_bricks(lane);
        f.paddle = G / 2;
        f.ball_r = 4;
        f.dr = 1;
        f.t = 0;
    } else if (base == BREAKOUT) {
        if (!init) return step;
        // (k0, kc, kd) = split(ki); level = randint(k0), ball_c = randint(kc), dc =
        // sign(kd); threads 16 + j: (kw, kp) = split(level key j), then split(kp, 0)
        const uint2 a = hash_of(low ? ki : lk_own, low ? (lane & 3) : 0);
        const tf::Key ka = key_from(a, min(lane >> 1, 2));
        const uint2 b = hash_of(low ? ka : lk_own, low ? (lane & 1) : 1);
        const tf::Key kb = key_from(b, lane & 3);
        const uint2 c = hash_of(low ? kb : tf::Key{b.x, b.y}, 0);
        const int level = pool_base + tf::randint_bits(bits_from(c, 0), bits_from(c, 1), 0, pool_size);
        f.ball_c = tf::randint_bits(bits_from(c, 2), bits_from(c, 3), 0, G);
        f.dc = sign_bits(bits_from(b, 4));
        // wall draws j < 30 in threads j; the paddle's randint(kp): two words
        // of split(kp), in thread 30 and after split(kp, 1) in thread 31
        uint2 w;
        uint32_t pad_hi, pad_lo;
        if (have_levels) {
            const int li = 16 + level - pool_base;
            const tf::Key kw = key_from(a, li), kp = key_from(b, li), kp0 = key_from(c, li);
            w = hash_of(lane < 30 ? kw : (lane == 30 ? kp0 : kp), lane < 30 ? lane : lane - 30);
            pad_hi = bits_from(w, 30);
            pad_lo = own_bits(hash_of(key_from(w, 31), 0));
        } else {
            const uint2 e = hash_of(level_key(level), lane & 1);
            w = hash_of(key_from(e, lane >= 30 ? 1 : 0), lane >= 30 ? lane - 30 : lane);
            const uint2 p = hash_of(key_from(w, 30 + (lane & 1)), 0);
            pad_hi = bits_from(p, 0);
            pad_lo = bits_from(p, 1);
        }
        f.paddle = tf::randint_bits(pad_hi, pad_lo, 0, G);
        const uint32_t wb = own_bits(w);
        Grid wall;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
            const int j = 32 * m + lane;
            const uint32_t u = __shfl_sync(FULL, wb, (j - G) & 31);  // cell j <- draw j - G
            const bool brick = j >= G && j < 4 * G &&
                               (tf::uniform_bits(u) < 0.75f || j == 2 * G + G / 2);  // never brickless
            wall.w[m] = __ballot_sync(FULL, brick);
        }
        f.wall = wall;
        f.bricks = wall;
        f.ball_r = 4;
        f.dr = 1;
        f.t = 0;
    } else if (base == FREEWAY && !var) {
        if (!init) return step;
        // cars[j] = randint(ki, j, 0, G): threads j and 8 + j hash its two words
        const uint2 a = hash_of(ki, lane & 1);
        const uint2 b = hash_of(key_from(a, (lane >> 3) & 1), lane & 7);
        const uint32_t lo = __shfl_sync(FULL, own_bits(b), (lane & 7) + 8);
        f.cars = lane < 8 ? tf::randint_bits(own_bits(b), lo, 0, G) : 0;
        f.chicken = G - 1;
        f.t = 0;
    } else if (base == FREEWAY) {
        if (!init) return step;
        // (k0, kc) = split(ki); level = randint(k0), cars = randint(kc, j); threads
        // 16 + j: (ks, kd) = split(level key j)
        const uint2 a = hash_of(low ? ki : lk_own, low ? (lane & 1) : 0);
        const tf::Key ka = key_from(a, (lane >> 1) & 1);
        const uint2 b = hash_of(low ? ka : lk_own, low ? (lane & 1) : 1);
        // threads 0, 1: the level's words; 8 + j, 16 + j: car j's
        const uint2 c = hash_of(key_from(b, lane < 8 ? (lane & 1) : (lane < 16 ? 2 : 3)),
                                lane < 8 ? 0 : (lane & 7));
        const int level = pool_base + tf::randint_bits(bits_from(c, 0), bits_from(c, 1), 0, pool_size);
        const uint32_t car_hi = __shfl_sync(FULL, own_bits(c), 8 + (lane & 7));
        const uint32_t car_lo = __shfl_sync(FULL, own_bits(c), 16 + (lane & 7));
        f.cars = lane < 8 ? tf::randint_bits(car_hi, car_lo, 0, G) : 0;
        // speeds = randint(ks, j, 2, 5), dirs = sign(kd, j): threads 0, 1 split ks,
        // threads 8 + j draw dirs[j]
        uint2 d;
        if (have_levels) {
            const tf::Key k_s = key_from(a, 16 + level - pool_base), k_d = key_from(b, 16 + level - pool_base);
            d = hash_of(lane < 8 ? k_s : k_d, lane < 8 ? (lane & 1) : (lane & 7));
        } else {
            const uint2 e = hash_of(level_key(level), lane & 1);
            d = hash_of(key_from(e, lane < 8 ? 0 : 1), lane < 8 ? (lane & 1) : (lane & 7));
        }
        const uint32_t dir_bits = __shfl_sync(FULL, own_bits(d), 8 + (lane & 7));
        f.dirs = lane < 8 ? sign_bits(dir_bits) : 0;
        const uint2 sp = hash_of(key_from(d, (lane >> 3) & 1), lane & 7);
        const uint32_t sp_lo = __shfl_sync(FULL, own_bits(sp), 8 + (lane & 7));
        f.speeds = lane < 8 ? tf::randint_bits(own_bits(sp), sp_lo, 2, 5) : 0;
        f.chicken = G - 1;
        f.t = 0;
    } else if (base == ASTERIX) {
        // depth 1: threads 0-2 split(ks) into (k_spawn, k_dir, k_gold); 4, 5 split(ki)
        const uint2 a = hash_of(lane < 4 ? ks : ki, lane < 4 ? (lane & 3) : (lane & 1));
        // depth 2: threads 8c + j draw element j under key c; 24, 25 the level's words
        step = hash_of(key_from(a, lane < 24 ? (lane >> 3) : lane - 20), lane < 24 ? (lane & 7) : 0);
        if (init) {
            f.pr = G / 2;
            f.pc = G / 2;
            f.active = false;
            f.col = 0;
            f.dirn = lane < 8 ? 1 : 0;
            f.gold = false;
            f.t = 0;
        }
        if (var && init) {
            const int level =
                pool_base + tf::randint_bits(bits_from(step, 24), bits_from(step, 25), 0, pool_size);
            // (ks, kd, kg) = split(level_key): speeds = randint(ks, j, 1, 4),
            // lane_dir = sign(kd, j), gold_p = uniform(kg, j, 0.15, 0.5)
            const uint2 e = hash_of(level_key(level), lane & 3);
            const uint2 d = hash_of(key_from(e, lane < 8 ? 0 : (lane < 16 ? 1 : 2)),
                                    lane < 8 ? (lane & 1) : (lane & 7));
            const uint32_t dir_bits = __shfl_sync(FULL, own_bits(d), 8 + (lane & 7));
            const uint32_t gold_bits = __shfl_sync(FULL, own_bits(d), 16 + (lane & 7));
            const uint2 sp = hash_of(key_from(d, (lane >> 3) & 1), lane & 7);
            const uint32_t sp_lo = __shfl_sync(FULL, own_bits(sp), 8 + (lane & 7));
            f.speeds = lane < 8 ? tf::randint_bits(own_bits(sp), sp_lo, 1, 4) : 0;
            f.lane_dir = lane < 8 ? sign_bits(dir_bits) : 0;
            f.gold_p = lane < 8 ? tf::uniform_bits(gold_bits, 0.15f, 0.5f) : 0.f;
        }
    } else {
        // depth 1: threads 0, 1 split(ks) for the pick; 4, 5 split(ki) for the level
        const uint2 a = hash_of(lane < 4 ? ks : ki, lane & 1);
        // depth 2: thread j hashes element 0 under thread j's key
        step = hash_of(key_from(a, lane & 7), 0);
        if (init) {
            f.pc = G / 2;
            f.shot_r = -1;
            f.shot_c = 0;
            f.bomb_r = -1;
            f.bomb_c = 0;
            f.t = 0;
            if (!var) {
                f.adir = 1;
                f.aliens = default_aliens(lane);
            }
        }
        if (var && init) {
            const int level =
                pool_base + tf::randint_bits(bits_from(step, 4), bits_from(step, 5), 0, pool_size);
            // (kf, km, kb, kd) = split(level_key): the fleet's 24 draws in
            // threads 0-23, split(km) in 24, 25, split(kb) in 26, 27, sign(kd) in 28
            const uint2 e = hash_of(level_key(level), lane & 3);
            const uint2 d = hash_of(
                key_from(e, lane < 24 ? 0 : (lane < 26 ? 1 : (lane < 28 ? 2 : 3))),
                lane < 24 ? lane : (lane & 1));
            const uint2 r = hash_of(key_from(d, lane), 0);
            f.march_every = tf::randint_bits(bits_from(r, 24), bits_from(r, 25), 3, 6);
            f.bomb_every = tf::randint_bits(bits_from(r, 26), bits_from(r, 27), 4, 9);
            f.adir = sign_bits(bits_from(d, 28));
            const uint32_t fb = own_bits(d);
            Grid fleet;
#pragma unroll
            for (int m = 0; m < 4; ++m) {
                const int j = 32 * m + lane;
                const int row = j / G - 1, col = j % G - 2;
                const bool in = row >= 0 && row < 4 && col >= 0 && col < 6;
                const uint32_t u = __shfl_sync(FULL, fb, in ? row * 6 + col : 0);
                fleet.w[m] = __ballot_sync(
                    FULL, j < G * G && in && (tf::uniform_bits(u) < 0.8f || j == G + 5));  // never alien-less
            }
            f.fleet = fleet;
            f.aliens = fleet;
        }
    }
    return step;
}

// ----------------------------------------------------------------- step
// Every thread runs every line (the state's scalars and grids are the same
// in each), so the branches below do not diverge.
template <int GAME>
__device__ __forceinline__ void game_step(State& s, int a, uint2 sd, int cap, float& reward, bool& term,
                          bool& trunc, int lane) {
    constexpr int base = GAME % VARIANT;
    constexpr bool var = GAME >= VARIANT;
    reward = 0.f;
    term = false;
    trunc = false;
    if (base == CATCH) {
        s.paddle = clampi(s.paddle + move3(a), 0, G - 1);
        s.ball_r += 1;
        if (var) s.ball_c = clampi(s.ball_c + shfl_i(s.drift, s.ball_r), 0, G - 1);
        term = s.ball_r == G - 1;
        reward = term ? (s.paddle == s.ball_c ? 1.f : -1.f) : 0.f;
    } else if (base == BREAKOUT) {
        s.paddle = clampi(s.paddle + move3(a), 0, G - 1);
        int nc = s.ball_c + s.dc;
        const int dc = (nc < 0 || nc > G - 1) ? -s.dc : s.dc;
        nc = clampi(nc, 0, G - 1);
        int nr = s.ball_r + s.dr;
        int dr = nr < 0 ? 1 : s.dr;
        nr = nr < 0 ? 1 : nr;
        const int cell = clampi(nr, 0, G - 1) * G + nc;
        const bool hit = cell_of(s.bricks, cell);
        clear_cell(s.bricks, cell);
        reward = hit ? 1.f : 0.f;
        if (hit) {
            dr = -dr;
            nr = s.ball_r;
        }
        const bool at_bottom = nr >= G - 1, caught = at_bottom && nc == s.paddle;
        if (caught) {
            dr = -1;
            nr = G - 2;
        }
        term = at_bottom && !caught;
        if (!any_cell(s.bricks)) s.bricks = var ? s.wall : default_bricks(lane);  // a cleared wall respawns
        s.ball_r = nr;
        s.ball_c = nc;
        s.dr = dr;
        s.dc = dc;
    } else if (base == FREEWAY) {
        int chicken = clampi(s.chicken + move3(a), 0, G - 1);
        if (lane < 8) {  // car `lane`: speeds {2, 3, 2, 4, 2, 3, 4, 2}, directions {1, -1, 1, -1, -1, 1, -1, 1}
            const int speed = var ? s.speeds : (int)((0x24324232u >> (4 * lane)) & 15u);
            const int dir = var ? s.dirs : (((0x5Au >> lane) & 1u) ? -1 : 1);
            const int moved = s.cars + ((s.t % speed) == 0 ? dir : 0);
            s.cars = ((moved % G) + G) % G;
        }
        const int road = chicken - 1;  // -1 or 8+ when off the road
        const int car = shfl_i(s.cars, clampi(road, 0, 7));
        const bool hit = road >= 0 && road < 8 && car == 4;
        if (hit) chicken = G - 1;
        const bool scored = chicken == 0;
        reward = scored ? 1.f : 0.f;
        if (scored) chicken = G - 1;
        s.chicken = chicken;
        trunc = s.t + 1 >= cap;
    } else if (base == ASTERIX) {
        const int dmr = a == 3 ? -1 : (a == 4 ? 1 : 0), dmc = a == 1 ? -1 : (a == 2 ? 1 : 0);
        s.pr = clampi(s.pr + dmr, 1, 8);
        s.pc = clampi(s.pc + dmc, 0, G - 1);
        const uint32_t b_dir = __shfl_sync(FULL, own_bits(sd), (lane + 8) & 31);
        const uint32_t b_gold = __shfl_sync(FULL, own_bits(sd), (lane + 16) & 31);
        if (lane < 8) {  // enemy `lane`
            const int speed = var ? s.speeds : 2;
            const bool advance = s.active && (s.t % speed) == 0;
            int c = s.col + (advance ? s.dirn : 0);
            const bool act = s.active && !(c < 0 || c > G - 1);
            c = clampi(c, 0, G - 1);
            const bool spawn = !act && tf::uniform_bits(own_bits(sd)) < 0.25f;
            if (spawn) {
                const int nd = var ? s.lane_dir : sign_bits(b_dir);
                s.dirn = nd;
                c = nd > 0 ? 0 : G - 1;
                s.gold = tf::uniform_bits(b_gold) < (var ? s.gold_p : 1.0f / 3.0f);
            }
            s.active = act || spawn;
            s.col = c;
        }
        const int row = s.pr - 1;
        const bool act_r = shfl_b(s.active, row), gold_r = shfl_b(s.gold, row);
        const int col_r = shfl_i(s.col, row);
        const bool collide = act_r && col_r == s.pc;
        const bool hit_gold = collide && gold_r;
        term = collide && !gold_r;
        reward = hit_gold ? 1.f : 0.f;
        if (hit_gold && lane == row) s.active = false;
    } else {
        const int march_every = var ? s.march_every : 4, bomb_every = var ? s.bomb_every : 6;
        s.pc = clampi(s.pc + move3(a), 0, G - 1);
        // fire: one player bullet in flight at a time
        const bool fire = a == 3 && s.shot_r < 0;
        s.shot_r = fire ? G - 2 : s.shot_r - (s.shot_r >= 0 ? 1 : 0);
        if (fire) s.shot_c = s.pc;
        const int cell = clampi(s.shot_r, 0, G - 1) * G + s.shot_c;
        const bool hit = s.shot_r >= 0 && cell_of(s.aliens, cell);
        if (hit) {
            clear_cell(s.aliens, cell);
            s.shot_r = -1;
        }
        reward = hit ? 1.f : 0.f;
        // fleet march: sideways on the beat, down + reverse at an edge;
        // column `lane` is occupied where any of its rows holds an alien
        auto columns = [&](const Grid& g) {
            bool occ = false;
            for (int r = 0; r < G; ++r) occ |= lane < G && cell_of(g, r * G + lane);
            return __ballot_sync(FULL, occ);
        };
        uint32_t occ = columns(s.aliens);
        bool any = occ != 0u;
        const int leftmost = any ? __ffs(occ) - 1 : 0, rightmost = any ? 31 - __clz(occ) : G - 1;
        const bool march = (s.t % march_every) == 0;
        const bool at_edge = s.adir > 0 ? rightmost >= G - 1 : leftmost <= 0;
        if (march && at_edge && any) {  // drop a row, reverse
            const Grid old = s.aliens;
            s.aliens = ballot_grid(lane, [&](int j) { return cell_of(old, (j + G * G - G) % (G * G)); });
            s.adir = -s.adir;
        } else if (march && !at_edge) {  // shift by the old direction
            const Grid old = s.aliens;
            const int adir = s.adir;
            s.aliens = ballot_grid(lane, [&](int j) {
                const int r = j / G, c = j % G;
                return cell_of(old, r * G + ((c - adir) % G + G) % G);
            });
        }
        // bombing: the occupied column nearest a random pick releases a bomb
        // from its lowest alien on the bomb beat
        occ = columns(s.aliens);
        any = occ != 0u;
        const bool bomb_due = (s.t % bomb_every) == 0 && s.bomb_r < 0 && any;
        const int pick = tf::randint_bits(bits_from(sd, 0), bits_from(sd, 1), 0, G);
        int bcol = 0, best = G + 2;
        for (int c = 0; c < G; ++c) {
            const int d = ((occ >> c) & 1u) ? abs(c - pick) : G + 1;
            if (d < best) {
                best = d;
                bcol = c;
            }
        }
        const uint32_t in_col = __ballot_sync(FULL, lane < G && cell_of(s.aliens, lane * G + bcol));
        const int lowest = in_col != 0u ? 31 - __clz(in_col) : G - 1;
        const int bomb_r = bomb_due ? lowest + 1 : s.bomb_r + (s.bomb_r >= 0 ? 1 : 0);
        if (bomb_due) s.bomb_c = bcol;
        s.bomb_r = bomb_r > G - 1 ? -1 : bomb_r;
        // deaths: a bomb at the player, or the fleet on the bottom row (cells 90-99)
        const bool bottom = ((s.aliens.w[2] >> 26) | (s.aliens.w[3] & 0xFu)) != 0u;
        term = (s.bomb_r == G - 1 && s.bomb_c == s.pc) || bottom;
        // a cleared fleet respawns
        if (!any_cell(s.aliens)) s.aliens = var ? s.fleet : default_aliens(lane);
    }
    s.t += 1;
}

// --------------------------------------------------------------- render
__device__ __forceinline__ void put(uint8_t* grid, int r, int c, uint8_t v) {
    if (r >= 0 && r < G && c >= 0 && c < G) grid[r * G + c] = v;
}

__device__ __forceinline__ void put_max(uint8_t* grid, int r, int c, uint8_t v) {
    if (r >= 0 && r < G && c >= 0 && c < G && v > grid[r * G + c]) grid[r * G + c] = v;
}

// the 10x10 frame of `s` into the warp's `grid`: the background a cell a
// thread, then the sprites in the twins' order by thread 0
template <int GAME>
__device__ __forceinline__ void game_render(const State& s, uint8_t* grid, int lane) {
    constexpr int base = GAME % VARIANT;
    for (int j = lane; j < G * G; j += 32) {
        grid[j] = base == BREAKOUT ? (cell_of(s.bricks, j) ? I_BRICK : 0)
                : base == INVADERS ? (cell_of(s.aliens, j) ? I_ENEMY : 0) : 0;
    }
    // the spread elements every thread needs, gathered before thread 0 draws
    int col[8];
    uint8_t val[8];
    if (base == FREEWAY || base == ASTERIX) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            col[j] = shfl_i(base == FREEWAY ? s.cars : s.col, j);
            val[j] = base == FREEWAY ? I_ENEMY
                   : (shfl_b(s.active, j) ? (shfl_b(s.gold, j) ? I_GOLD : I_ENEMY) : 0);
        }
    }
    __syncwarp();
    if (lane == 0) {
        if (base == CATCH || base == BREAKOUT) {
            put(grid, s.ball_r, s.ball_c, I_BALL);
            put(grid, G - 1, s.paddle, I_PLAYER);
        } else if (base == FREEWAY) {
#pragma unroll
            for (int j = 0; j < 8; ++j) put(grid, 1 + j, col[j], val[j]);
            put(grid, s.chicken, 4, I_PLAYER);
        } else if (base == ASTERIX) {
#pragma unroll
            for (int j = 0; j < 8; ++j) put_max(grid, 1 + j, col[j], val[j]);
            put(grid, s.pr, s.pc, I_PLAYER);
        } else {
            if (s.shot_r >= 0) put_max(grid, s.shot_r, s.shot_c, I_BULLET);
            if (s.bomb_r >= 0) put_max(grid, s.bomb_r, s.bomb_c, I_BULLET);
            put(grid, G - 1, s.pc, I_PLAYER);
        }
    }
    __syncwarp();
}

// the frame: nearest-neighbour upscale of the warp's grid.  At cell 8 (the
// games' 80x80 frames) the warp widens each grid row to its 80 bytes in
// shared memory, then copies frame row y from widened row y / 8, 16 bytes a
// store; any other cell takes the byte-wise path.
__device__ __forceinline__ void write_frame(const uint8_t* grid, uint8_t* wide, uint8_t* out, int cell, int lane) {
    const int width = G * cell, hw = width * width;
    if (cell == 8 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
#pragma unroll
        for (int k = 0; k < 7; ++k) {  // 200 words: 20 a widened row, 2 a cell
            const int i = lane + 32 * k;
            if (i < G * 20)
                reinterpret_cast<uint32_t*>(wide)[i] =
                    (uint32_t)grid[(i / 20) * G + ((i % 20) >> 1)] * 0x01010101u;
        }
        __syncwarp();
#pragma unroll
        for (int k = 0; k < 13; ++k) {  // 400 stores: 5 a frame row, each from its widened row
            const int i = lane + 32 * k, y = i / 5;
            if (i < 80 * 5)
                reinterpret_cast<uint4*>(out)[i] =
                    reinterpret_cast<const uint4*>(wide)[(y >> 3) * 5 + i % 5];
        }
    } else {
        for (int i = lane; i < hw; i += 32) out[i] = grid[(i / width / cell) * G + (i % width) / cell];
    }
}

// --------------------------------------------------------------- kernel
template <int GAME>
__global__ void __launch_bounds__(32 * WARPS, 8) game_kernel(
    Fields f, float* __restrict__ ep_ret, const int* __restrict__ actions, uint32_t key_a,
    uint32_t key_b, int mode, uint8_t* __restrict__ frames, float* __restrict__ reward,
    uint8_t* __restrict__ term, uint8_t* __restrict__ trunc, float* __restrict__ out_ret, int L,
    int pool_base, int pool_size, int cap, int cell) {
    __shared__ __align__(16) uint8_t grids[WARPS][112];
    __shared__ __align__(16) uint8_t wides[WARPS][G * 80];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int l = blockIdx.x * WARPS + warp;
    if (l >= L) return;  // only warp barriers below
    const tf::Key key{key_a, key_b};
    const bool stepping = mode == TICK || mode == STEP, initing = mode != STEP && mode != RENDER;
    const bool loading = mode != INIT_SPLIT && mode != INIT_DIRECT;
    const int action = stepping ? actions[l] : 0;
    State s{}, fresh{};
    if (loading) fields_io<GAME>(s, f, l, lane, false);  // in flight through the hashes
    // depth 0: split(key, L)[l] in threads 0-15 and, for a variant's reset,
    // the pool's level keys in threads 16 + j (level pool_base + j)
    const bool have_levels = GAME >= VARIANT && initing && pool_size <= 16;
    uint2 h0 = make_uint2(0u, 0u);
    if (mode == TICK || mode == INIT_SPLIT || have_levels)
        h0 = hash_of(lane < 16 ? key : tf::Key{0u, LEVEL_BASE_KEY},
                     lane < 16 ? (uint32_t)l : (uint32_t)(pool_base + lane - 16));
    // the keys: TICK (k_step, k_reset) = split(split(key, L)[l]) in threads 0, 1
    tf::Key ks = key, ki = key;
    if (mode == TICK) {
        const uint2 kk = hash_of(key_from(h0, 0), lane & 1);
        ks = key_from(kk, 0);
        ki = key_from(kk, 1);
    } else if (mode == INIT_SPLIT) {
        ki = key_from(h0, 0);
    }
    if (stepping || initing) {
        const uint2 sd = draw_tick<GAME>(fresh, initing, ks, ki, pool_base, pool_size, h0,
                                         have_levels, lane);
        if (loading) settle_grids<GAME>(s);
        if (stepping) {
            float r;
            bool te, tr;
            game_step<GAME>(s, action, sd, cap, r, te, tr, lane);
            if (mode == TICK) {
                const bool cut = te || tr;
                if (lane == 0) {
                    const float ep = ep_ret[l] + r;
                    out_ret[l] = cut ? ep : __int_as_float(0x7fc00000);
                    ep_ret[l] = cut ? 0.f : ep;
                }
                if (cut) s = fresh;
                tr = tr && !te;
            }
            if (lane == 0) {
                reward[l] = r;
                term[l] = te;
                trunc[l] = tr;
            }
        } else {
            s = fresh;
        }
        fields_io<GAME>(s, f, l, lane, true);
    } else {
        settle_grids<GAME>(s);
    }
    game_render<GAME>(s, grids[warp], lane);
    write_frame(grids[warp], wides[warp], frames + (size_t)l * (G * cell) * (G * cell), cell, lane);
}

using KernelFn = void (*)(Fields, float*, const int*, uint32_t, uint32_t, int, uint8_t*, float*,
                          uint8_t*, uint8_t*, float*, int, int, int, int, int);

const KernelFn KERNELS[2 * VARIANT] = {
    game_kernel<0>, game_kernel<1>, game_kernel<2>, game_kernel<3>, game_kernel<4>,
    game_kernel<5>, game_kernel<6>, game_kernel<7>, game_kernel<8>, game_kernel<9>};

}  // namespace

// game: 0 catch, 1 breakout, 2 freeway, 3 asterix, 4 invaders, +5 their
// seeded-level variants.  fields: n device pointers to the state's [L, ...]
// tensors in field order (int32, bool as uint8, float32).  mode 0: the
// auto-reset tick (ep_ret, actions, reward, term, trunc, out_ret); 1: one
// step with the key itself, no reset (actions, reward, term, trunc); 2 / 3:
// init from split(key, L)[l] / the key itself; 4: render.  frames: [L,
// G*cell, G*cell] uint8, written in every mode.
PORT_API int port_device_games(int game, void* const* fields, int n_fields, void* ep_ret,
                               const void* actions, unsigned int key_a, unsigned int key_b,
                               int mode, void* frames, void* reward, void* term, void* trunc,
                               void* out_ret, int L, int pool_base, int pool_size, int cap,
                               int cell, void* stream) {
    if (game < 0 || game >= 2 * VARIANT || n_fields > MAX_FIELDS || mode < 0 || mode > RENDER ||
        L <= 0 || cell <= 0)
        return (int)cudaErrorInvalidValue;
    Fields f{};
    for (int j = 0; j < n_fields; ++j) f.p[j] = fields[j];
    KERNELS[game]<<<(L + WARPS - 1) / WARPS, 32 * WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
        f, static_cast<float*>(ep_ret), static_cast<const int*>(actions), key_a, key_b, mode,
        static_cast<uint8_t*>(frames), static_cast<float*>(reward), static_cast<uint8_t*>(term),
        static_cast<uint8_t*>(trunc), static_cast<float*>(out_ret), L, pool_base, pool_size, cap,
        cell);
    return (int)cudaGetLastError();
}
