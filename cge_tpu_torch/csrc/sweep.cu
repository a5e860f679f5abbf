// Brute-force ray x triangle closest-hit sweep for Hopper (sm_90a), exported
// as a plain C function for ctypes.
//
// K3  cge_closest_tris_sweep  replaces the Pallas kernel `_sweep_kernel`
//     (cge_tpu/ops/pallas/sweep.py, launched by pallas_closest_tris), the
//     hit oracle of every render and train step with the accel off.
//     Every ray is tested against every row of the packed [T, 16] table
//     (v0, v1, v2, n, D, valid, 2 pad): plane t = (D - o.n) / d.n, then
//     three edge tests dot(cross(b - a, p - a), n) >= 0. A hit is accepted
//     when 0 <= t <= tmax, all three edges pass and valid > 0; rays with
//     tmax < 0 are dead. The closest accepted finite t wins, and on equal t
//     the largest triangle id: the Pallas rule (largest id at a tile's
//     minimum, a later tile replacing on t <= best).
//     Bound on this card: arithmetic. R * T plane t's of 12 flops and one
//     divide each, and the edge tests (57 flops once the edge vectors are
//     hoisted) of a pair whose t could be the answer (tools/roofline.py
//     counts them from the run), against 64 bytes per triangle that every
//     ray reuses. Built without FMA contraction, every flop is an
//     instruction of its own, while the card's 67 TFLOP/s counts an FMA as
//     two.
//
//     Design (its first version ran one ray per thread, re-read 14
//     scalars from shared memory per test, recomputed the edge vectors per
//     test and staged each tile synchronously between two barriers):
//     - SWEEP_RPT rays a thread, in registers. Each staged triangle is
//       read once as six float4 broadcasts and tested against all of
//       them. Two rays beat four, whose registers cost occupancy.
//     - A plane t that cannot be taken (t < 0, past tmax, past the ray's
//       best) skips the edge tests; the skip changes no result.
//     - The edge vectors b - a are computed once per triangle while its
//       tile is expanded into shared memory: the same f32 subtractions
//       the tests made, so the results are bit-identical.
//     - The raw rows come through a two-slot cp.async ring: tile k + 1 is
//       in flight while tile k is expanded and tested.
//     - The block orders its rays live first before the sweep, so on
//       bounce levels the threads of dead rays, and whole warps of them,
//       skip the tests.
//     - The triangle range is split over gridDim.y (the wrapper picks the
//       count): a 16k-ray chunk is only 64 blocks of 256 rays, and a block
//       with few live rays would sweep all T rows alone. Each split writes
//       a partial (t, id), and a second kernel merges the splits in
//       increasing id order under the same t <= best rule, which leaves
//       the result unchanged.
//
// The file is built with --fmad=false, and the arithmetic follows the
// Pallas kernel's operation order (sweep.py:89-107), so the plain PyTorch
// twin (ops/sweep.py) computes bit-identical t's on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"

#define SWEEP_TILE 128      // triangle rows per shared-memory tile
#define SWEEP_THREADS 128
#define SWEEP_RPT 2         // rays a thread
#define FULL_MASK 0xffffffffu

// Start the copies of table rows [base, base + n) into a raw tile slot.
__device__ __forceinline__ void issue_rows(float* dst,
                                           const float* __restrict__ table,
                                           int base, int n) {
    const float* src = table + (size_t)base * 16;
    for (int i = threadIdx.x; i < n * 4; i += SWEEP_THREADS)
        cp_async16(dst + 4 * i, src + 4 * i);
    cp_async_commit();
}

__global__ void __launch_bounds__(SWEEP_THREADS)
closest_tris_sweep_kernel(const float* __restrict__ o,
                          const float* __restrict__ d,
                          const float* __restrict__ tmax,
                          const float* __restrict__ table,
                          float* __restrict__ out_t,
                          int* __restrict__ out_i,
                          int R, int T, int tiles_per_split) {
    constexpr int RPT = SWEEP_RPT;
    constexpr int NR = SWEEP_THREADS * RPT;      // rays a block
    __shared__ __align__(16) float s_raw[2][SWEEP_TILE * 16];
    // per triangle: (v0, D) (v1, valid) (v2, -) (b0 - a0, nx) (b1 - a1,
    // ny) (b2 - a2, nz), edges (a, b) = (v0, v1), (v1, v2), (v2, v0)
    __shared__ __align__(16) float4 s_tri[SWEEP_TILE * 6];
    __shared__ int s_perm[NR];
    __shared__ int s_cnt[SWEEP_THREADS / 32];

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int r0 = blockIdx.x * NR;
    const int split = blockIdx.y;

    // the block's rays, live ones first in their order, then the rest:
    // thread tid scans local rays tid * RPT .. tid * RPT + RPT - 1
    int flags = 0, cnt = 0;
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
        const int r = r0 + tid * RPT + k;
        const bool lv = r < R && tmax[r] >= 0.0f;
        flags |= (lv ? 1 : 0) << k;
        cnt += lv ? 1 : 0;
    }
    int inc = cnt;
    for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(FULL_MASK, inc, off);
        if (lane >= off)
            inc += v;
    }
    if (lane == 31)
        s_cnt[warp] = inc;
    __syncthreads();
    int lb = inc - cnt, n_live = 0;
    for (int w = 0; w < SWEEP_THREADS / 32; ++w) {
        lb += w < warp ? s_cnt[w] : 0;
        n_live += s_cnt[w];
    }
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
        const int j = tid * RPT + k;
        if ((flags >> k) & 1)
            s_perm[lb++] = j;
        else
            s_perm[n_live + j - lb] = j;
    }
    __syncthreads();

    // this thread's rays: slots tid * RPT + k of the order; past n_live
    // they are dead (tmax -1 accepts nothing)
    float ox[RPT], oy[RPT], oz[RPT], dx[RPT], dy[RPT], dz[RPT], tm[RPT];
    float bt[RPT];
    int bi[RPT], jr[RPT];
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
        const int slot = tid * RPT + k;
        jr[k] = s_perm[slot];
        bt[k] = INFINITY;
        bi[k] = -1;
        ox[k] = oy[k] = oz[k] = dx[k] = dy[k] = dz[k] = 0.0f;
        tm[k] = -1.0f;
        if (slot < n_live) {
            const size_t r = (size_t)(r0 + jr[k]);
            ox[k] = o[3 * r];
            oy[k] = o[3 * r + 1];
            oz[k] = o[3 * r + 2];
            dx[k] = d[3 * r];
            dy[k] = d[3 * r + 1];
            dz[k] = d[3 * r + 2];
            tm[k] = tmax[r];
        }
    }
    const bool mine = tid * RPT < n_live;

    const int first = split * tiles_per_split * SWEEP_TILE;
    const int last = min(T, first + tiles_per_split * SWEEP_TILE);
    // block-uniform: an all-dead block or an empty split sweeps nothing
    if (n_live > 0 && first < last) {
        issue_rows(s_raw[0], table, first, min(SWEEP_TILE, last - first));
        int k = 0;
        for (int base = first; base < last; base += SWEEP_TILE, ++k) {
            const int n = min(SWEEP_TILE, last - base);
            cp_async_wait<0>();
            __syncthreads();     // tile k has landed; tile k - 1 is used up
            if (base + SWEEP_TILE < last)
                issue_rows(s_raw[(k + 1) & 1], table, base + SWEEP_TILE,
                           min(SWEEP_TILE, last - base - SWEEP_TILE));
            if (tid < n) {
                const float* q = s_raw[k & 1] + tid * 16;
                const float v0x = q[0], v0y = q[1], v0z = q[2];
                const float v1x = q[3], v1y = q[4], v1z = q[5];
                const float v2x = q[6], v2y = q[7], v2z = q[8];
                float4* dst = s_tri + tid * 6;
                dst[0] = make_float4(v0x, v0y, v0z, q[12]);
                dst[1] = make_float4(v1x, v1y, v1z, q[13]);
                dst[2] = make_float4(v2x, v2y, v2z, 0.0f);
                dst[3] = make_float4(v1x - v0x, v1y - v0y, v1z - v0z, q[9]);
                dst[4] = make_float4(v2x - v1x, v2y - v1y, v2z - v1z, q[10]);
                dst[5] = make_float4(v0x - v2x, v0y - v2y, v0z - v2z, q[11]);
            }
            __syncthreads();
            if (!mine)
                continue;
#pragma unroll 2
            for (int c = 0; c < n; ++c) {
                const float4* q = s_tri + c * 6;
                const float4 a0 = q[0], a1 = q[1];
                if (!(a1.w > 0.0f))
                    continue;    // an invalid row is never accepted
                const float4 a2 = q[2], e0 = q[3], e1 = q[4], e2 = q[5];
                const float nx = e0.w, ny = e1.w, nz = e2.w, D = a0.w;
#pragma unroll
                for (int k2 = 0; k2 < RPT; ++k2) {
                    const float denom =
                        (dx[k2] * nx + dy[k2] * ny) + dz[k2] * nz;
                    const float t =
                        (D - ((ox[k2] * nx + oy[k2] * ny) + oz[k2] * nz)) /
                        denom;
                    // a t that cannot be accepted skips the edge tests:
                    // NaN (0/0, or NaN constants of a zero-area row)
                    // fails t >= 0, +inf fails t < inf
                    if (!(t >= 0.0f && t <= tm[k2] && t < INFINITY &&
                          t <= bt[k2]))
                        continue;
                    const float px = ox[k2] + t * dx[k2];
                    const float py = oy[k2] + t * dy[k2];
                    const float pz = oz[k2] + t * dz[k2];
                    bool inside = true;
#pragma unroll
                    for (int e = 0; e < 3; ++e) {
                        const float4 a = e == 0 ? a0 : e == 1 ? a1 : a2;
                        const float4 ev = e == 0 ? e0 : e == 1 ? e1 : e2;
                        const float wx = px - a.x, wy = py - a.y,
                                    wz = pz - a.z;
                        const float cx = ev.y * wz - ev.z * wy;
                        const float cy = ev.z * wx - ev.x * wz;
                        const float cz = ev.x * wy - ev.y * wx;
                        inside = inside &&
                                 (cx * nx + cy * ny) + cz * nz >= 0.0f;
                    }
                    if (inside) {
                        bt[k2] = t;
                        bi[k2] = base + c;
                    }
                }
            }
        }
    }
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
        const int r = r0 + jr[k];
        if (r < R) {
            out_t[(size_t)split * R + r] = bt[k];
            out_i[(size_t)split * R + r] = bi[k];
        }
    }
}

// Fold the per-split partials in increasing id order: a later split
// replaces on t <= best, as a later tile does.
__global__ void merge_splits_kernel(const float* __restrict__ part_t,
                                    const int* __restrict__ part_i,
                                    float* __restrict__ best_t,
                                    int* __restrict__ best_i,
                                    int R, int n_split) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R)
        return;
    float bt = INFINITY;
    int bi = -1;
    for (int s = 0; s < n_split; ++s) {
        const float t = part_t[(size_t)s * R + r];
        if (isfinite(t) && t <= bt) {
            bt = t;
            bi = part_i[(size_t)s * R + r];
        }
    }
    best_t[r] = bt;
    best_i[r] = bi;
}

// C interface (ctypes): pointers and the stream as void*, sizes as int.
// table 16-byte aligned; part_t / part_i hold n_split * R partials; with
// n_split == 1 they may be best_t / best_i themselves and no merge runs.
extern "C" int cge_closest_tris_sweep(const float* o, const float* d,
                                      const float* tmax, const float* table,
                                      float* best_t, int* best_i,
                                      float* part_t, int* part_i,
                                      int R, int T, int n_split,
                                      void* stream) {
    if (R == 0)
        return 0;
    const int n_tiles = (T + SWEEP_TILE - 1) / SWEEP_TILE;
    const int tiles_per_split = n_tiles > 0 ? (n_tiles + n_split - 1) / n_split
                                            : 1;
    cudaStream_t st = (cudaStream_t)stream;
    const int nr = SWEEP_THREADS * SWEEP_RPT;
    const dim3 grid((R + nr - 1) / nr, n_split);
    closest_tris_sweep_kernel<<<grid, SWEEP_THREADS, 0, st>>>(
        o, d, tmax, table, n_split == 1 ? best_t : part_t,
        n_split == 1 ? best_i : part_i, R, T, tiles_per_split);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || n_split == 1)
        return (int)e;
    merge_splits_kernel<<<(R + 255) / 256, 256, 0, st>>>(
        part_t, part_i, best_t, best_i, R, n_split);
    return (int)cudaGetLastError();
}
