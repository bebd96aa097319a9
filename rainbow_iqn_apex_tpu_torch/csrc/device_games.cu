// K12: the device games' tick, with JAX's Threefry key stream.
//
// Replaces envs/device_games.py batched_reset_step
// (rainbow_iqn_apex_tpu/envs/device_games.py:974-1011) over each game's
// init / step / render (:105-520; the seeded-level variants :547-825) and
// _upscale (:56-58), XLA-fused and vmapped over lanes on the TPU.  For L
// lanes in one launch:
//   per lane l: kl = split(key, L)[l]; (k_step, k_reset) = split(kl)
//   state, reward, term, trunc = game.step(state, action[l], k_step)
//   cut = term | trunc; ep = ep_ret[l] + reward; out_ret = cut ? ep : NaN
//   on a cut: state = game.init(k_reset), ep_ret = 0; trunc &= ~term
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
// us of bytes), byte-bound only at thousands of lanes.  Design, simple and
// right first: one block per lane; thread 0 runs the game's logic and its
// Threefry rounds on the lane's state in shared memory (a 10x10 grid and a
// few scalars: serial work of a few hundred instructions), then the block
// writes the frame from the grid in 16-byte stores.  The game is a template
// parameter (one instantiation per game and variant); the host picks it.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "threefry.cuh"

namespace {

constexpr int G = 10;
constexpr int MAX_FIELDS = 12;
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

// every field any game has; a game uses its own
struct State {
    int ball_r, ball_c, paddle, t, dr, dc;  // catch, breakout
    int chicken;                            // freeway
    int pr, pc;                             // asterix (pc also invaders)
    int adir, shot_r, shot_c, bomb_r, bomb_c, march_every, bomb_every;  // invaders
    int cars[8], speeds[8], dirs[8];        // freeway
    int col[8], dirn[8], lane_dir[8];       // asterix
    float gold_p[8];
    int drift[G];                           // catch variant
    bool active[8], gold[8];
    bool bricks[G * G], wall[G * G];        // breakout (wall: the variant's template)
    bool aliens[G * G], fleet[G * G];       // invaders (fleet: the variant's template)
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }
__device__ __forceinline__ int move3(int a) { return a == 1 ? -1 : (a == 2 ? 1 : 0); }
__device__ __forceinline__ int sign(tf::Key k, int i) { return tf::bernoulli(k, i, 0.5f) ? 1 : -1; }

__device__ __forceinline__ tf::Key level_key(int level) {
    return tf::split(tf::Key{0u, LEVEL_BASE_KEY}, (uint32_t)level);  // fold_in(PRNGKey(9137), level)
}

// ------------------------------------------------------------ field i/o
struct Io {
    const Fields& f;
    int l;
    int k = 0;  // next field
    __device__ Io(const Fields& fields, int lane) : f(fields), l(lane) {}
    __device__ void i(int& v, bool store) {
        int* p = static_cast<int*>(f.p[k++]) + l;
        if (store) *p = v; else v = *p;
    }
    __device__ void ia(int* v, int n, bool store) {
        int* p = static_cast<int*>(f.p[k++]) + (size_t)l * n;
        for (int j = 0; j < n; ++j) { if (store) p[j] = v[j]; else v[j] = p[j]; }
    }
    __device__ void fa(float* v, int n, bool store) {
        float* p = static_cast<float*>(f.p[k++]) + (size_t)l * n;
        for (int j = 0; j < n; ++j) { if (store) p[j] = v[j]; else v[j] = p[j]; }
    }
    __device__ void ba(bool* v, int n, bool store) {
        uint8_t* p = static_cast<uint8_t*>(f.p[k++]) + (size_t)l * n;
        for (int j = 0; j < n; ++j) { if (store) p[j] = v[j]; else v[j] = p[j] != 0; }
    }
};

// the fields in the order of the JAX NamedTuple of each game
template <int GAME>
__device__ void fields_io(State& s, const Fields& f, int l, bool store) {
    Io io(f, l);
    constexpr int base = GAME % VARIANT;
    constexpr bool var = GAME >= VARIANT;
    if (base == CATCH) {
        io.i(s.ball_r, store); io.i(s.ball_c, store); io.i(s.paddle, store);
        if (var) io.ia(s.drift, G, store);
        io.i(s.t, store);
    } else if (base == BREAKOUT) {
        io.i(s.paddle, store); io.i(s.ball_r, store); io.i(s.ball_c, store);
        io.i(s.dr, store); io.i(s.dc, store); io.ba(s.bricks, G * G, store);
        if (var) io.ba(s.wall, G * G, store);
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
        io.i(s.pc, store); io.ba(s.aliens, G * G, store); io.i(s.adir, store);
        io.i(s.shot_r, store); io.i(s.shot_c, store); io.i(s.bomb_r, store); io.i(s.bomb_c, store);
        if (var) { io.ba(s.fleet, G * G, store); io.i(s.march_every, store); io.i(s.bomb_every, store); }
        io.i(s.t, store);
    }
}

// ----------------------------------------------------------------- init
template <int GAME>
__device__ void game_init(State& s, tf::Key k, int pool_base, int pool_size) {
    constexpr int base = GAME % VARIANT;
    constexpr bool var = GAME >= VARIANT;
    s.t = 0;
    if (base == CATCH) {
        tf::Key kc = k;
        s.ball_r = 0;
        s.paddle = G / 2;
        if (var) {
            const int level = pool_base + tf::randint(tf::split(k, 0), 0, 0, pool_size);
            kc = tf::split(k, 1);
            const tf::Key lk = level_key(level);
            for (int j = 0; j < G; ++j) s.drift[j] = tf::randint(lk, j, -1, 2);
            s.drift[G - 1] = 0;  // no wind on the terminal row
        }
        s.ball_c = tf::randint(kc, 0, 0, G);
    } else if (base == BREAKOUT) {
        s.ball_r = 4;
        s.dr = 1;
        if (var) {
            const int level = pool_base + tf::randint(tf::split(k, 0), 0, 0, pool_size);
            const tf::Key kc = tf::split(k, 1), kd = tf::split(k, 2), lk = level_key(level);
            const tf::Key kw = tf::split(lk, 0), kp = tf::split(lk, 1);
            for (int j = 0; j < G * G; ++j) s.wall[j] = false;
            for (int j = 0; j < 3 * G; ++j) s.wall[G + j] = tf::uniform(kw, j) < 0.75f;
            s.wall[2 * G + G / 2] = true;  // a level can never be brickless
            for (int j = 0; j < G * G; ++j) s.bricks[j] = s.wall[j];
            s.paddle = tf::randint(kp, 0, 0, G);
            s.ball_c = tf::randint(kc, 0, 0, G);
            s.dc = sign(kd, 0);
        } else {
            const tf::Key kc = tf::split(k, 0), kd = tf::split(k, 1);
            for (int j = 0; j < G * G; ++j) s.bricks[j] = j >= G && j < 4 * G;
            s.paddle = G / 2;
            s.ball_c = tf::randint(kc, 0, 0, G);
            s.dc = sign(kd, 0);
        }
    } else if (base == FREEWAY) {
        tf::Key kc = k;
        s.chicken = G - 1;
        if (var) {
            const int level = pool_base + tf::randint(tf::split(k, 0), 0, 0, pool_size);
            kc = tf::split(k, 1);
            const tf::Key lk = level_key(level), ks = tf::split(lk, 0), kd = tf::split(lk, 1);
            for (int j = 0; j < 8; ++j) {
                s.speeds[j] = tf::randint(ks, j, 2, 5);
                s.dirs[j] = sign(kd, j);
            }
        }
        for (int j = 0; j < 8; ++j) s.cars[j] = tf::randint(kc, j, 0, G);
    } else if (base == ASTERIX) {
        s.pr = G / 2;
        s.pc = G / 2;
        for (int j = 0; j < 8; ++j) {
            s.active[j] = false;
            s.col[j] = 0;
            s.dirn[j] = 1;
            s.gold[j] = false;
        }
        if (var) {
            const int level = pool_base + tf::randint(k, 0, 0, pool_size);
            const tf::Key lk = level_key(level);
            const tf::Key ks = tf::split(lk, 0), kd = tf::split(lk, 1), kg = tf::split(lk, 2);
            for (int j = 0; j < 8; ++j) {
                s.speeds[j] = tf::randint(ks, j, 1, 4);
                s.lane_dir[j] = sign(kd, j);
                s.gold_p[j] = tf::uniform(kg, j, 0.15f, 0.5f);
            }
        }
    } else {
        s.pc = G / 2;
        s.adir = 1;
        s.shot_r = -1;
        s.shot_c = 0;
        s.bomb_r = -1;
        s.bomb_c = 0;
        if (var) {
            const int level = pool_base + tf::randint(k, 0, 0, pool_size);
            const tf::Key lk = level_key(level);
            const tf::Key kf = tf::split(lk, 0), km = tf::split(lk, 1), kb = tf::split(lk, 2),
                          kd = tf::split(lk, 3);
            for (int j = 0; j < G * G; ++j) s.fleet[j] = false;
            for (int r = 0; r < 4; ++r)
                for (int c = 0; c < 6; ++c) s.fleet[(1 + r) * G + 2 + c] = tf::uniform(kf, r * 6 + c) < 0.8f;
            s.fleet[G + 5] = true;  // a level can never start alien-less
            for (int j = 0; j < G * G; ++j) s.aliens[j] = s.fleet[j];
            s.adir = sign(kd, 0);
            s.march_every = tf::randint(km, 0, 3, 6);
            s.bomb_every = tf::randint(kb, 0, 4, 9);
        } else {
            for (int j = 0; j < G * G; ++j) {
                const int r = j / G, c = j % G;
                s.aliens[j] = r >= 1 && r < 5 && c >= 2 && c < 8;
            }
        }
    }
}

// ----------------------------------------------------------------- step
template <int GAME>
__device__ void game_step(State& s, int a, tf::Key k, int cap, float& reward, bool& term,
                          bool& trunc) {
    constexpr int base = GAME % VARIANT;
    constexpr bool var = GAME >= VARIANT;
    reward = 0.f;
    term = false;
    trunc = false;
    if (base == CATCH) {
        s.paddle = clampi(s.paddle + move3(a), 0, G - 1);
        s.ball_r += 1;
        if (var) s.ball_c = clampi(s.ball_c + s.drift[s.ball_r], 0, G - 1);
        term = s.ball_r == G - 1;
        reward = term ? (s.paddle == s.ball_c ? 1.f : -1.f) : 0.f;
    } else if (base == BREAKOUT) {
        s.paddle = clampi(s.paddle + move3(a), 0, G - 1);
        int nc = s.ball_c + s.dc;
        int dc = (nc < 0 || nc > G - 1) ? -s.dc : s.dc;
        nc = clampi(nc, 0, G - 1);
        int nr = s.ball_r + s.dr;
        int dr = nr < 0 ? 1 : s.dr;
        nr = nr < 0 ? 1 : nr;
        const int cell = clampi(nr, 0, G - 1) * G + nc;
        const bool hit = s.bricks[cell];
        s.bricks[cell] = false;
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
        bool any = false;
        for (int j = 0; j < G * G; ++j) any |= s.bricks[j];
        if (!any)  // a cleared wall respawns
            for (int j = 0; j < G * G; ++j) s.bricks[j] = var ? s.wall[j] : (j >= G && j < 4 * G);
        s.ball_r = nr;
        s.ball_c = nc;
        s.dr = dr;
        s.dc = dc;
    } else if (base == FREEWAY) {
        const int SPEEDS[8] = {2, 3, 2, 4, 2, 3, 4, 2}, DIRS[8] = {1, -1, 1, -1, -1, 1, -1, 1};
        int chicken = clampi(s.chicken + move3(a), 0, G - 1);
        for (int j = 0; j < 8; ++j) {
            const int speed = var ? s.speeds[j] : SPEEDS[j], dir = var ? s.dirs[j] : DIRS[j];
            const int moved = s.cars[j] + ((s.t % speed) == 0 ? dir : 0);
            s.cars[j] = ((moved % G) + G) % G;
        }
        const int lane = chicken - 1;  // -1 or 8+ when off the road
        const bool hit = lane >= 0 && lane < 8 && s.cars[clampi(lane, 0, 7)] == 4;
        if (hit) chicken = G - 1;
        const bool scored = chicken == 0;
        reward = scored ? 1.f : 0.f;
        if (scored) chicken = G - 1;
        s.chicken = chicken;
        trunc = s.t + 1 >= cap;
    } else if (base == ASTERIX) {
        const tf::Key k_spawn = tf::split(k, 0), k_dir = tf::split(k, 1), k_gold = tf::split(k, 2);
        const int dmr = a == 3 ? -1 : (a == 4 ? 1 : 0), dmc = a == 1 ? -1 : (a == 2 ? 1 : 0);
        s.pr = clampi(s.pr + dmr, 1, 8);
        s.pc = clampi(s.pc + dmc, 0, G - 1);
        for (int j = 0; j < 8; ++j) {
            const int speed = var ? s.speeds[j] : 2;
            const bool advance = s.active[j] && (s.t % speed) == 0;
            int c = s.col[j] + (advance ? s.dirn[j] : 0);
            bool act = s.active[j] && !(c < 0 || c > G - 1);
            c = clampi(c, 0, G - 1);
            const bool spawn = !act && tf::uniform(k_spawn, j) < 0.25f;
            if (spawn) {
                const int nd = var ? s.lane_dir[j] : sign(k_dir, j);
                s.dirn[j] = nd;
                c = nd > 0 ? 0 : G - 1;
                s.gold[j] = tf::uniform(k_gold, j) < (var ? s.gold_p[j] : 1.0f / 3.0f);
            }
            s.active[j] = act || spawn;
            s.col[j] = c;
        }
        const int lane = s.pr - 1;
        const bool collide = s.active[lane] && s.col[lane] == s.pc;
        const bool hit_gold = collide && s.gold[lane];
        term = collide && !s.gold[lane];
        reward = hit_gold ? 1.f : 0.f;
        if (hit_gold) s.active[lane] = false;
    } else {
        const int march_every = var ? s.march_every : 4, bomb_every = var ? s.bomb_every : 6;
        s.pc = clampi(s.pc + move3(a), 0, G - 1);
        // fire: one player bullet in flight at a time
        const bool fire = a == 3 && s.shot_r < 0;
        s.shot_r = fire ? G - 2 : s.shot_r - (s.shot_r >= 0 ? 1 : 0);
        if (fire) s.shot_c = s.pc;
        const int cell = clampi(s.shot_r, 0, G - 1) * G + s.shot_c;
        const bool hit = s.shot_r >= 0 && s.aliens[cell];
        if (hit) {
            s.aliens[cell] = false;
            s.shot_r = -1;
        }
        reward = hit ? 1.f : 0.f;
        // fleet march: sideways on the beat, down + reverse at an edge
        bool occ[G];
        bool any = false;
        for (int c = 0; c < G; ++c) {
            occ[c] = false;
            for (int r = 0; r < G; ++r) occ[c] |= s.aliens[r * G + c];
            any |= occ[c];
        }
        int leftmost = 0, rightmost = G - 1;
        for (int c = G - 1; c >= 0; --c) if (occ[c]) leftmost = c;
        for (int c = 0; c < G; ++c) if (occ[c]) rightmost = c;
        const bool march = (s.t % march_every) == 0;
        const bool at_edge = s.adir > 0 ? rightmost >= G - 1 : leftmost <= 0;
        bool moved[G * G];
        if (march && at_edge && any) {  // drop a row, reverse
            for (int j = 0; j < G * G; ++j) moved[j] = s.aliens[(j + G * G - G) % (G * G)];
            for (int j = 0; j < G * G; ++j) s.aliens[j] = moved[j];
            s.adir = -s.adir;
        } else if (march && !at_edge) {  // shift by the old direction
            for (int j = 0; j < G * G; ++j) {
                const int r = j / G, c = j % G;
                moved[j] = s.aliens[r * G + ((c - s.adir) % G + G) % G];
            }
            for (int j = 0; j < G * G; ++j) s.aliens[j] = moved[j];
        }
        // bombing: the occupied column nearest a random pick releases a bomb
        // from its lowest alien on the bomb beat
        any = false;
        for (int c = 0; c < G; ++c) {
            occ[c] = false;
            for (int r = 0; r < G; ++r) occ[c] |= s.aliens[r * G + c];
            any |= occ[c];
        }
        const bool bomb_due = (s.t % bomb_every) == 0 && s.bomb_r < 0 && any;
        const int pick = tf::randint(k, 0, 0, G);
        int bcol = 0, best = G + 2;
        for (int c = 0; c < G; ++c) {
            const int d = occ[c] ? abs(c - pick) : G + 1;
            if (d < best) {
                best = d;
                bcol = c;
            }
        }
        int lowest = G - 1;
        for (int r = 0; r < G; ++r) if (s.aliens[r * G + bcol]) lowest = r;
        int bomb_r = bomb_due ? lowest + 1 : s.bomb_r + (s.bomb_r >= 0 ? 1 : 0);
        if (bomb_due) s.bomb_c = bcol;
        s.bomb_r = bomb_r > G - 1 ? -1 : bomb_r;
        // deaths: a bomb at the player, or the fleet on the bottom row
        bool bottom = false;
        for (int c = 0; c < G; ++c) bottom |= s.aliens[(G - 1) * G + c];
        term = (s.bomb_r == G - 1 && s.bomb_c == s.pc) || bottom;
        // a cleared fleet respawns
        any = false;
        for (int j = 0; j < G * G; ++j) any |= s.aliens[j];
        if (!any)
            for (int j = 0; j < G * G; ++j) {
                const int r = j / G, c = j % G;
                s.aliens[j] = var ? s.fleet[j] : (r >= 1 && r < 5 && c >= 2 && c < 8);
            }
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

template <int GAME>
__device__ void game_render(const State& s, uint8_t* grid) {
    constexpr int base = GAME % VARIANT;
    for (int j = 0; j < G * G; ++j) {
        grid[j] = base == BREAKOUT ? (s.bricks[j] ? I_BRICK : 0)
                : base == INVADERS ? (s.aliens[j] ? I_ENEMY : 0) : 0;
    }
    if (base == CATCH || base == BREAKOUT) {
        put(grid, s.ball_r, s.ball_c, I_BALL);
        put(grid, G - 1, s.paddle, I_PLAYER);
    } else if (base == FREEWAY) {
        for (int j = 0; j < 8; ++j) put(grid, 1 + j, s.cars[j], I_ENEMY);
        put(grid, s.chicken, 4, I_PLAYER);
    } else if (base == ASTERIX) {
        for (int j = 0; j < 8; ++j)
            put_max(grid, 1 + j, s.col[j], s.active[j] ? (s.gold[j] ? I_GOLD : I_ENEMY) : 0);
        put(grid, s.pr, s.pc, I_PLAYER);
    } else {
        if (s.shot_r >= 0) put_max(grid, s.shot_r, s.shot_c, I_BULLET);
        if (s.bomb_r >= 0) put_max(grid, s.bomb_r, s.bomb_c, I_BULLET);
        put(grid, G - 1, s.pc, I_PLAYER);
    }
}

// --------------------------------------------------------------- kernel
template <int GAME>
__global__ void __launch_bounds__(128) game_kernel(
    Fields f, float* __restrict__ ep_ret, const int* __restrict__ actions, uint32_t key_a,
    uint32_t key_b, int mode, uint8_t* __restrict__ frames, float* __restrict__ reward,
    uint8_t* __restrict__ term, uint8_t* __restrict__ trunc, float* __restrict__ out_ret,
    int pool_base, int pool_size, int cap, int cell) {
    __shared__ State s;
    __shared__ uint8_t grid[G * G];
    const int l = blockIdx.x;
    if (threadIdx.x == 0) {
        const tf::Key key{key_a, key_b};
        if (mode == INIT_SPLIT || mode == INIT_DIRECT) {
            game_init<GAME>(s, mode == INIT_SPLIT ? tf::split(key, l) : key, pool_base, pool_size);
            fields_io<GAME>(s, f, l, true);
        } else {
            fields_io<GAME>(s, f, l, false);
        }
        if (mode == TICK || mode == STEP) {
            const tf::Key kl = tf::split(key, l);
            float r;
            bool te, tr;
            game_step<GAME>(s, actions[l], mode == TICK ? tf::split(kl, 0) : key, cap, r, te, tr);
            if (mode == TICK) {
                const bool cut = te || tr;
                const float ep = ep_ret[l] + r;
                out_ret[l] = cut ? ep : __int_as_float(0x7fc00000);
                ep_ret[l] = cut ? 0.f : ep;
                if (cut) game_init<GAME>(s, tf::split(kl, 1), pool_base, pool_size);
                tr = tr && !te;
            }
            reward[l] = r;
            term[l] = te;
            trunc[l] = tr;
            fields_io<GAME>(s, f, l, true);
        }
        game_render<GAME>(s, grid);
    }
    __syncthreads();
    // the frame: nearest-neighbour upscale of the grid, 16 bytes a store
    const int width = G * cell, hw = width * width;
    uint8_t* out = frames + (size_t)l * hw;
    if ((width & 15) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
        for (int i = threadIdx.x; i < hw / 16; i += blockDim.x) {
            const int y = (i * 16) / width, x0 = (i * 16) % width;
            const uint8_t* row = grid + (y / cell) * G;
            uint32_t w[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                uint32_t v = 0;
#pragma unroll
                for (int b = 0; b < 4; ++b) v |= (uint32_t)row[(x0 + q * 4 + b) / cell] << (8 * b);
                w[q] = v;
            }
            reinterpret_cast<uint4*>(out)[i] = make_uint4(w[0], w[1], w[2], w[3]);
        }
    } else {
        for (int i = threadIdx.x; i < hw; i += blockDim.x)
            out[i] = grid[(i / width / cell) * G + (i % width) / cell];
    }
}

using KernelFn = void (*)(Fields, float*, const int*, uint32_t, uint32_t, int, uint8_t*, float*,
                          uint8_t*, uint8_t*, float*, int, int, int, int);

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
        L <= 0)
        return (int)cudaErrorInvalidValue;
    Fields f{};
    for (int j = 0; j < n_fields; ++j) f.p[j] = fields[j];
    KERNELS[game]<<<L, 128, 0, static_cast<cudaStream_t>(stream)>>>(
        f, static_cast<float*>(ep_ret), static_cast<const int*>(actions), key_a, key_b, mode,
        static_cast<uint8_t*>(frames), static_cast<float*>(reward), static_cast<uint8_t*>(term),
        static_cast<uint8_t*>(trunc), static_cast<float*>(out_ret), pool_base, pool_size, cap,
        cell);
    return (int)cudaGetLastError();
}
