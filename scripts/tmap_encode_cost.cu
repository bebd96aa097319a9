// Host cost of one cuTensorMapEncodeTiled call, the encode that K3 and K3-bwd
// (rainbow_iqn_apex_tpu_torch/csrc/hopper.cuh make_map) make for each operand
// on every call: 3 maps a noisy K3 call (2 greedy), 5 a noisy K3-bwd call (4
// greedy).  Encodes the maps of the learner's noisy hidden layer (M 2048,
// K 3136, N 512) with the kernels' box and swizzle, the base pointer moving
// on every call as the learner's freshly cast weights do, and prints one JSON
// line: the median over rounds of the host ns per encode.
//
//   nvcc -O2 -std=c++17 -o tmap_encode_cost scripts/tmap_encode_cost.cu -lcuda
//   ./tmap_encode_cost
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <chrono>
#include <cstdio>
#include <vector>

static bool encode(CUtensorMap* map, void* base, cuuint64_t rows, cuuint64_t cols,
                   cuuint32_t box_rows) {
    const cuuint64_t dims[2] = {cols, rows};
    const cuuint64_t strides[1] = {cols * sizeof(__nv_bfloat16)};
    const cuuint32_t box[2] = {64, box_rows};
    const cuuint32_t elem[2] = {1, 1};
    return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, dims, strides,
                                  box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int main() {
    const cuuint64_t M = 2048, K = 3136, N = 512;
    void* buf = nullptr;
    if (cudaMalloc(&buf, (M * K + 64 * 1024) * sizeof(__nv_bfloat16)) != cudaSuccess) {
        std::fprintf(stderr, "tmap_encode_cost: cudaMalloc failed\n");
        return 1;
    }
    constexpr int ROUNDS = 21, CALLS = 20000;
    alignas(64) CUtensorMap map;
    std::vector<double> ns;
    for (int r = 0; r < ROUNDS; ++r) {
        const auto t0 = std::chrono::steady_clock::now();
        for (int i = 0; i < CALLS; ++i) {
            char* base = static_cast<char*>(buf) + 256 * (i % 128);  // a new pointer each call
            const bool ok = (i & 1) ? encode(&map, base, N, K, 64) : encode(&map, base, M, K, 128);
            if (!ok) {
                std::fprintf(stderr, "tmap_encode_cost: encode failed\n");
                return 1;
            }
        }
        const auto t1 = std::chrono::steady_clock::now();
        ns.push_back(std::chrono::duration<double, std::nano>(t1 - t0).count() / CALLS);
    }
    std::sort(ns.begin(), ns.end());
    std::printf("{\"script\": \"tmap_encode_cost\", \"calls_per_round\": %d, \"rounds\": %d, "
                "\"encode_ns_median\": %.1f, \"encode_ns_min\": %.1f, \"encode_ns_max\": %.1f}\n",
                CALLS, ROUNDS, ns[ROUNDS / 2], ns.front(), ns.back());
    cudaFree(buf);
    return 0;
}
