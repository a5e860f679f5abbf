// Streaming-bandwidth probe for Hopper (sm_90a), exported as a plain C
// function for ctypes.
//
// K4  cge_stream_sum  replaces the Pallas kernel built by make_kernel in
//     tools/exp_dma_layout.py (its pallas_call at :53). What it computes:
//     for a [L, sub, w] f32 stack, n = L / SC_N steps; step s adds rows
//     s*SC_N .. s*SC_N+SC_N-1 into a [w] accumulator (the sum over the
//     first two axes); the trailing L % SC_N rows are never read. The
//     result is [1, w]. On the TPU each step is a DMA of SC_N rows into a
//     two-slot VMEM buffer, overlapped with the previous step's sum, and
//     the kernel's time is the layout's streaming bandwidth.
//     Bound on this card: device-memory bandwidth (one add per 4 bytes).
//     Design: a grid of blocks, each streaming a contiguous range of steps
//     (a contiguous range of the stack) through a two-slot shared-memory
//     buffer with cp.async: chunk k+1 is in flight (commit / wait groups,
//     the counterpart of make_async_copy and its DMA semaphores) while
//     chunk k is summed. A chunk is SP_CHUNK floats (32 KB), so a step of
//     the padded layout (256 KB) streams as several chunks. Every thread
//     sums a fixed column (w divides the thread count, which divides the
//     chunk), the block adds its threads' sums per column in a fixed
//     order into a partial row, and a second pass (a warp per column)
//     adds the partial rows in a fixed order: the result does not depend
//     on scheduling.

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

#define SP_THREADS 256
#define SP_CHUNK 8192      // floats per pipeline stage

__global__ void __launch_bounds__(SP_THREADS)
stream_sum_kernel(const float* __restrict__ stack, float* __restrict__ partial,
                  long long step_floats, int n_steps, int steps_per_block,
                  int w) {
    extern __shared__ __align__(16) float buf[];     // [2][SP_CHUNK]
    __shared__ float red[SP_THREADS];
    const int tid = threadIdx.x;
    const long long s0 = (long long)blockIdx.x * steps_per_block;
    const long long s1 = min((long long)n_steps, s0 + steps_per_block);
    const float* src = stack + s0 * step_floats;
    const long long total = (s1 - s0) * step_floats;  // a multiple of 4
    const int n_chunks = (int)((total + SP_CHUNK - 1) / SP_CHUNK);

    auto issue = [&](int k) {
        const long long off = (long long)k * SP_CHUNK;
        const int len = (int)min((long long)SP_CHUNK, total - off);
        float* dst = buf + (k & 1) * SP_CHUNK;
        for (int v = tid * 4; v < len; v += SP_THREADS * 4)
            cp_async16(dst + v, src + off + v);
        cp_async_commit();
    };

    float acc = 0.0f;
    if (n_chunks > 0)
        issue(0);
    for (int k = 0; k < n_chunks; ++k) {
        if (k + 1 < n_chunks) {
            issue(k + 1);          // its slot was freed by the last barrier
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();           // chunk k has landed for every thread
        const long long off = (long long)k * SP_CHUNK;
        const int len = (int)min((long long)SP_CHUNK, total - off);
        const float* b = buf + (k & 1) * SP_CHUNK;
        for (int j = tid; j < len; j += SP_THREADS)
            acc += b[j];           // column tid % w
        __syncthreads();           // slot k & 1 may be refilled now
    }
    red[tid] = acc;
    __syncthreads();
    if (tid < w) {
        float s = 0.0f;
        for (int i = tid; i < SP_THREADS; i += w)
            s += red[i];
        partial[(size_t)blockIdx.x * w + tid] = s;
    }
}

// One warp per column: lane l adds partial rows l, l + 32, ... in order,
// then the lanes combine in a fixed butterfly.
__global__ void stream_sum_finish(const float* __restrict__ partial,
                                  float* __restrict__ out, int n_blocks,
                                  int w) {
    const int c = blockIdx.x, lane = threadIdx.x;
    float s = 0.0f;
    for (int g = lane; g < n_blocks; g += 32)
        s += partial[(size_t)g * w + c];
    for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0)
        out[c] = s;
}

// stack [n_steps * SC_N (+ unread rows), sub, w] f32, 16-byte aligned;
// step_floats = SC_N * sub * w; w divides SP_THREADS; partial
// [n_blocks, w] scratch with n_blocks = ceil(n_steps / steps_per_block);
// out [w].
extern "C" int cge_stream_sum(const float* stack, float* partial, float* out,
                              long long step_floats, int n_steps,
                              int steps_per_block, int n_blocks, int w,
                              void* stream) {
    if (n_steps <= 0 || w <= 0 || SP_THREADS % w || step_floats % 4)
        return (int)cudaErrorInvalidValue;
    const size_t smem = 2 * SP_CHUNK * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        stream_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess)
        return (int)e;
    cudaStream_t st = (cudaStream_t)stream;
    stream_sum_kernel<<<n_blocks, SP_THREADS, smem, st>>>(
        stack, partial, step_floats, n_steps, steps_per_block, w);
    e = cudaGetLastError();
    if (e != cudaSuccess)
        return (int)e;
    stream_sum_finish<<<w, 32, 0, st>>>(partial, out, n_blocks, w);
    return (int)cudaGetLastError();
}
