// Hopper building blocks shared by K3, K3-bwd (noisy_linear.cu,
// noisy_linear_bwd.cu), K2 and K2-bwd (tau_embed.cu, tau_embed_bwd.cu) and
// K10g (noisy_linear_q.cu): TMA
// tile loads into a shared-memory ring guarded by mbarriers, wgmma.mma_async
// on 128-byte-swizzled tiles, and ldmatrix loads of register A fragments from
// the same tiles.
//
// Tile layout.  Every operand tile is a TMA box of 64 bf16 (128 bytes) along
// the row, loaded with CU_TENSOR_MAP_SWIZZLE_128B into a 1024-byte-aligned
// buffer: row r sits at r * 128 bytes, and its 16-byte chunk c at chunk
// c ^ (r % 8).  A wgmma operand read through a shared-memory descriptor is
// K-major (the 64 values of a row run along the product's depth), which is
// the canonical SW128 K-major layout: 8-row atoms 1024 bytes apart (SBO), and
// the k16 step kk starts kk * 32 bytes into the row.  A register A fragment
// is read with ldmatrix from a tile whose rows run along the depth (.trans)
// or along A's rows (no .trans), with the same chunk swizzle.
//
// Accumulator layout of m64nNk16 (fp32 D): warp w of the warpgroup holds rows
// 16w .. 16w+15; lane l holds, for each n8 column block j, d[4j + 0..1] at
// (row 16w + l/4, cols 8j + 2(l%4) + 0..1) and d[4j + 2..3] at row + 8.
// A register fragment has mma.m16n8k16's A layout for the warp's 16 rows:
// a[0] (row l/4, cols 2(l%4)..+1), a[1] (row + 8), a[2] (cols + 8), a[3] (both).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int TILE_K = 64;          // bf16 values per tile row (128 bytes)
constexpr int ROW_BYTES = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

// make the initialised barriers visible to the async (TMA) proxy
__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(addr), "r"(parity)
            : "memory");
    } while (!done);
}

// named barrier over `threads` threads (a multiple of 32) of the block
__device__ __forceinline__ void bar_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// make this thread's shared-memory writes visible to the async proxy (wgmma
// operands, TMA) before a barrier hands them over
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------------- TMA
// Copy the box at (c0 along the row, c1 across rows) of the tensor map into
// shared memory; the bytes complete on `bar`.  Out-of-range values land as 0.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
        : "memory");
}

// ----------------------------------------------------------------- wgmma
// Shared-memory descriptor of a K-major SW128 tile starting at `p`
// (1024-byte aligned at the tile, plus 32 bytes per k16 step).
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
    uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
    d |= (uint64_t)1 << 16;               // leading byte offset (unused by SW128 K-major)
    d |= (uint64_t)(1024 >> 4) << 32;     // stride byte offset: one 8-row atom
    d |= (uint64_t)1 << 62;               // 128-byte swizzle
    return d;
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across a wgmma wait: each register becomes an operand of an empty asm.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ldmatrix x4 of a 16x16 bf16 A fragment.  Lane l gives the row address of
// 8x8 matrix l / 8; the caller computes it (see the kernels).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
                 : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
                 : "r"(addr));
}

// byte offset of (row, 16-byte chunk) in a SW128 tile
__device__ __forceinline__ uint32_t sw128_offset(int row, int chunk) {
    return (uint32_t)(row * ROW_BYTES + ((chunk ^ (row & 7)) << 4));
}

// bf16 x2 product rounded once to bf16: bf16(x * s) for both halves
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t x, uint32_t s) {
    __nv_bfloat162 r = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&x),
                               *reinterpret_cast<__nv_bfloat162*>(&s));
    return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&r);
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D[64 x 8] += A[64 x 16] * B[16 x 8], A in registers, B K-major in shared memory
__device__ __forceinline__ void wgmma_rs_n8(float (&d)[4], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 24] += A[64 x 16] * B[16 x 24], A in registers, B K-major in shared memory
__device__ __forceinline__ void wgmma_rs_n24(float (&d)[12], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A in registers, B K-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], A in registers, B K-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 16] += A[64 x 16] * B[16 x 16], A in registers, B K-major in shared memory
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b) {
    if constexpr (N == 8) wgmma_rs_n8(d, a, desc_b);
    else if constexpr (N == 24) wgmma_rs_n24(d, a, desc_b);
    else if constexpr (N == 128) wgmma_rs_n128(d, a, desc_b);
    else wgmma_rs_n64(d, a, desc_b);
}

// Copy rows [r0, r0 + 64) x columns [0, 64 * boxes) of a row-major bf16
// matrix [rows, cols] (row stride ld) into `boxes` SW128 boxes of 64 x 64 at
// dst, zeros outside the matrix: what a TMA box load gives, for a matrix
// whose row stride TMA cannot take (ld % 8 != 0).  One warp; the caller
// fences the writes to the async proxy before wgmma reads them.
__device__ __forceinline__ void fill_boxes_sw128(uint8_t* dst, const __nv_bfloat16* src, int rows,
                                                 int cols, int ld, int r0, int boxes, int lane) {
    for (int i = lane; i < 64 * boxes * 8; i += 32) {
        const int r = i / (boxes * 8);
        const int q = i % (boxes * 8);
        const int c0 = q * 8;  // box q / 8, chunk q % 8
        uint4 v = make_uint4(0, 0, 0, 0);
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
        if (r0 + r < rows)
            for (int t = 0; t < 8 && c0 + t < cols; ++t) e[t] = src[(size_t)(r0 + r) * ld + c0 + t];
        *reinterpret_cast<uint4*>(dst + (q / 8) * 64 * ROW_BYTES + sw128_offset(r, q % 8)) = v;
    }
}

// ------------------------------------------------------- host: tensor maps
// cuTensorMapEncodeTiled from the driver, found once through the runtime so
// the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult status;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status) ==
                cudaSuccess &&
            status == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiledFn>(p);
    }
    return fn;
}

// A row-major bf16 matrix [rows, cols] (row stride `ld` values, ld % 8 == 0)
// as boxes of 64 columns x `box_rows` rows, 128-byte swizzled; false on error.
// Encoded on every call: the learner casts its weights afresh each step, and
// an encode is host work only (its cost: scripts/tmap_encode_cost.cu).
// The encode needs the device's context current on this thread, which a
// thread whose first CUDA call this is (an autograd worker running K2-bwd
// first) does not have yet: cudaSetDevice makes it current.
inline bool bind_device() {
    static thread_local bool bound = false;
    if (!bound) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess) return false;
        bound = true;
    }
    return true;
}

inline bool make_map(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                     uint64_t ld, uint32_t box_rows) {
    EncodeTiledFn fn = encode_tiled();
    if (fn == nullptr || !bind_device()) return false;
    const cuuint64_t dims[2] = {cols, rows};
    const cuuint64_t strides[1] = {ld * sizeof(__nv_bfloat16)};
    const cuuint32_t box[2] = {(cuuint32_t)TILE_K, box_rows};
    const cuuint32_t elem[2] = {1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
              box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
           CUDA_SUCCESS;
}

// A row-major byte matrix [rows, cols] (row stride ld bytes, ld % 16 == 0) as
// boxes of 128 bytes x `box_rows` rows, 128-byte swizzled like the bf16
// boxes: row r of a box at r * 128 bytes, its 16-byte chunk c at c ^ (r % 8).
// Zeros outside the matrix; false on error.
inline bool make_map_u8(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                        uint64_t ld, uint32_t box_rows) {
    EncodeTiledFn fn = encode_tiled();
    if (fn == nullptr || !bind_device()) return false;
    const cuuint64_t dims[2] = {cols, rows};
    const cuuint64_t strides[1] = {ld};
    const cuuint32_t box[2] = {(cuuint32_t)ROW_BYTES, box_rows};
    const cuuint32_t elem[2] = {1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
              elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
           CUDA_SUCCESS;
}

}  // namespace hopper
