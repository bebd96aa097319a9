// JAX's Threefry-2x32 key stream on the card (partitionable form), the
// device twin of rainbow_iqn_apex_tpu_torch/envs/prng.py.
//
// A key is a pair of uint32.  split(k, n)[i] and fold_in(k, i) are both the
// hash of the counter pair (0, i); an element i of a draw of any shape reads
// the hash of (0, i) under its key, bits1 ^ bits2 (jax/_src/prng.py
// _threefry_split_foldlike, _threefry_random_bits_partitionable).  uniform,
// randint and bernoulli follow jax/_src/random.py (_uniform, _randint,
// _bernoulli); the scale of a uniform with minval / maxval is one fused
// multiply-add, as XLA contracts it.
#pragma once

#include <stdint.h>

namespace tf {

struct Key {
    uint32_t a, b;
};

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
    return (v << r) | (v >> (32 - r));
}

// the Threefry-2x32 hash of (x0, x1) under k: 20 rounds, a key injection after every 4
__device__ __forceinline__ void hash(Key k, uint32_t& x0, uint32_t& x1) {
    const uint32_t ks[3] = {k.a, k.b, k.a ^ k.b ^ 0x1BD11BDAu};
    const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
    x0 += ks[0];
    x1 += ks[1];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            x0 += x1;
            x1 = rotl(x1, rot[i & 1][j]) ^ x0;
        }
        x0 += ks[(i + 1) % 3];
        x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
    }
}

// split(k, n)[i] for any n > i; also fold_in(k, i)
__device__ __forceinline__ Key split(Key k, uint32_t i) {
    uint32_t x0 = 0u, x1 = i;
    hash(k, x0, x1);
    return Key{x0, x1};
}

// element i of random_bits(k, 32, shape)
__device__ __forceinline__ uint32_t bits(Key k, uint32_t i) {
    uint32_t x0 = 0u, x1 = i;
    hash(k, x0, x1);
    return x0 ^ x1;
}

// a uniform in [0, 1) from its 32 random bits
__device__ __forceinline__ float uniform_bits(uint32_t b) {
    return __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
}

// a uniform in [lo, hi) from its 32 random bits
__device__ __forceinline__ float uniform_bits(uint32_t b, float lo, float hi) {
    return fmaxf(lo, __fmaf_rn(uniform_bits(b), hi - lo, lo));
}

// a randint in [lo, hi) from the bits of its two keys' draws (higher, lower):
// combined modulo the span
__device__ __forceinline__ int randint_bits(uint32_t higher, uint32_t lower, int lo, int hi) {
    const uint32_t span = hi > lo ? (uint32_t)(hi - lo) : 1u;
    uint32_t mult = 65536u % span;
    mult = (mult * mult) % span;
    const uint32_t offset = ((higher % span) * mult + lower % span) % span;
    return lo + (int)offset;
}

// element i of uniform(k, shape) in [0, 1)
__device__ __forceinline__ float uniform(Key k, uint32_t i) { return uniform_bits(bits(k, i)); }

// element i of uniform(k, shape, minval=lo, maxval=hi)
__device__ __forceinline__ float uniform(Key k, uint32_t i, float lo, float hi) {
    return uniform_bits(bits(k, i), lo, hi);
}

// element i of randint(k, shape, lo, hi) in int32: two 32-bit draws from
// split(k), combined modulo the span
__device__ __forceinline__ int randint(Key k, uint32_t i, int lo, int hi) {
    return randint_bits(bits(split(k, 0), i), bits(split(k, 1), i), lo, hi);
}

// element i of bernoulli(k, p, shape)
__device__ __forceinline__ bool bernoulli(Key k, uint32_t i, float p) {
    return uniform(k, i) < p;
}

}  // namespace tf
