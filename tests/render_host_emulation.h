// Builds cilrs_tpu_torch/csrc/render.cu for the host, so that the CPU tests
// run the render kernels' arithmetic (tests/test_torch_render_host.py):
//
//   g++ -std=c++20 -O1 -ffp-contract=off -shared -fPIC -pthread -x c++
//       -DRENDER_HOST_EMULATION -include tests/render_host_emulation.h
//       cilrs_tpu_torch/csrc/render.cu -o render_host.so
//
// A launch runs its blocks one after another on one host thread a block
// thread, which meet at a barrier for __syncthreads() and at each block's
// end; the dynamic shared memory is one buffer (one block at a time). The
// CUDA math functions are the host's (glibc's expf, cosf, ... differ from
// the card's in the last bits), the rounding intrinsics IEEE float
// operations with contraction off.
#pragma once

#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__

struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};

namespace emu {
inline thread_local dim3 thread_idx, block_idx;
inline std::barrier<>* block_barrier = nullptr;

template <typename Fn>
void launch(dim3 grid, dim3 block, Fn body) {
    std::barrier<> sync((std::ptrdiff_t)block.x);
    block_barrier = &sync;
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block.x; ++t)
        threads.emplace_back([&, t]() {
            for (unsigned by = 0; by < grid.y; ++by)
                for (unsigned bx = 0; bx < grid.x; ++bx) {
                    thread_idx = dim3(t);
                    block_idx = dim3(bx, by);
                    body();
                    sync.arrive_and_wait();  // the block's shared memory is the next one's
                }
        });
    for (auto& th : threads) th.join();
}
}  // namespace emu

#define threadIdx emu::thread_idx
#define blockIdx emu::block_idx
inline void __syncthreads() { emu::block_barrier->arrive_and_wait(); }
#define RENDER_LAUNCH(kernel, grid, block, smem, stream, ...) \
    emu::launch(dim3(grid), dim3(block), [&]() { kernel(__VA_ARGS__); })

// Every kernel's dynamic shared memory (extern __shared__ float smem[]).
alignas(16) inline float smem[1 << 16];

inline unsigned atomicAdd(unsigned* p, unsigned v) {
    return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }

inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline unsigned __float_as_uint(float x) {
    unsigned u;
    std::memcpy(&u, &x, 4);
    return u;
}

struct __nv_bfloat16 {
    uint16_t bits;
};
inline __nv_bfloat16 __float2bfloat16_rn(float x) {
    uint32_t u = __float_as_uint(x);
    u += 0x7fffu + ((u >> 16) & 1u);  // round to nearest even (no NaN here)
    return __nv_bfloat16{(uint16_t)(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 h) {
    const uint32_t u = (uint32_t)h.bits << 16;
    float x;
    std::memcpy(&x, &u, 4);
    return x;
}

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetDevice(int* d) {
    *d = -1;
    return cudaSuccess;
}
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <typename T>
inline cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int bytes) {
    return bytes <= (int)sizeof(smem) ? cudaSuccess : cudaErrorInvalidValue;
}
inline const char* cudaGetErrorString(cudaError_t e) {
    return e == cudaSuccess ? "no error" : "invalid argument";
}
