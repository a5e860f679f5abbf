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
//     Bound on this card: arithmetic. R * T tests of ~60 flops and one
//     divide each, against 64 bytes per triangle that every ray reuses.
//     Design: one thread per ray, (best t, best id) in registers. The block
//     stages the table through shared memory in tiles of TILE rows (16 KB)
//     and each thread tests a tile's rows in increasing id order, taking a
//     hit when t <= best: the Pallas tie rule, exactly. The triangle range
//     is also split over gridDim.y (the wrapper picks the count): on bounce
//     levels a block often holds one or two live rays, which would sweep
//     all T rows alone on one thread, and a 16k-ray chunk fills only ~124
//     threads per SM. Each split writes a partial (t, id) and a second
//     kernel merges the splits in increasing id order under the same
//     t <= best rule, which leaves the result unchanged.
//
// The file is built with --fmad=false, and the arithmetic follows the
// Pallas kernel's operation order (sweep.py:89-107), so the plain PyTorch
// twin (ops/sweep.py) computes bit-identical t's on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define SWEEP_TILE 256      // triangle rows per shared-memory tile
#define SWEEP_THREADS 128   // rays per block

__global__ void __launch_bounds__(SWEEP_THREADS)
closest_tris_sweep_kernel(const float* __restrict__ o,
                          const float* __restrict__ d,
                          const float* __restrict__ tmax,
                          const float* __restrict__ table,
                          float* __restrict__ out_t,
                          int* __restrict__ out_i,
                          int R, int T, int tiles_per_split) {
    __shared__ __align__(16) float s_tri[SWEEP_TILE * 16];

    const int r = blockIdx.x * SWEEP_THREADS + threadIdx.x;
    const int split = blockIdx.y;
    const bool in_range = r < R;
    const float tm = in_range ? tmax[r] : -1.0f;
    const bool live = tm >= 0.0f;
    float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
    if (live) {
        ox = o[3 * (size_t)r];
        oy = o[3 * (size_t)r + 1];
        oz = o[3 * (size_t)r + 2];
        dx = d[3 * (size_t)r];
        dy = d[3 * (size_t)r + 1];
        dz = d[3 * (size_t)r + 2];
    }
    float bt = INFINITY;
    int bi = -1;

    const int first = split * tiles_per_split * SWEEP_TILE;
    const int last = min(T, first + tiles_per_split * SWEEP_TILE);
    // one vote per block, before any __syncthreads in the loop, so an
    // all-dead block leaves together and the barriers stay uniform
    if (__syncthreads_or(live) && first < last) {
        for (int base = first; base < last; base += SWEEP_TILE) {
            const int n = min(SWEEP_TILE, last - base);
            __syncthreads();     // the previous tile is fully used
            const float4* src =
                reinterpret_cast<const float4*>(table + (size_t)base * 16);
            float4* dst = reinterpret_cast<float4*>(s_tri);
            for (int i = threadIdx.x; i < n * 4; i += SWEEP_THREADS)
                dst[i] = src[i];
            __syncthreads();
            if (!live)
                continue;        // dead rays accept nothing
#pragma unroll 2
            for (int c = 0; c < n; ++c) {
                const float* q = s_tri + c * 16;
                const float v0x = q[0], v0y = q[1], v0z = q[2];
                const float v1x = q[3], v1y = q[4], v1z = q[5];
                const float v2x = q[6], v2y = q[7], v2z = q[8];
                const float nx = q[9], ny = q[10], nz = q[11];
                const float D = q[12], valid = q[13];
                const float denom = (dx * nx + dy * ny) + dz * nz;
                const float t = (D - ((ox * nx + oy * ny) + oz * nz)) / denom;
                const float px = ox + t * dx, py = oy + t * dy, pz = oz + t * dz;
                bool inside = true;
#pragma unroll
                for (int e = 0; e < 3; ++e) {
                    const float ax = e == 0 ? v0x : e == 1 ? v1x : v2x;
                    const float ay = e == 0 ? v0y : e == 1 ? v1y : v2y;
                    const float az = e == 0 ? v0z : e == 1 ? v1z : v2z;
                    const float bx = e == 0 ? v1x : e == 1 ? v2x : v0x;
                    const float by = e == 0 ? v1y : e == 1 ? v2y : v0y;
                    const float bz = e == 0 ? v1z : e == 1 ? v2z : v0z;
                    const float ex = bx - ax, ey = by - ay, ez = bz - az;
                    const float wx = px - ax, wy = py - ay, wz = pz - az;
                    const float cx = ey * wz - ez * wy;
                    const float cy = ez * wx - ex * wz;
                    const float cz = ex * wy - ey * wx;
                    inside = inside && (cx * nx + cy * ny) + cz * nz >= 0.0f;
                }
                // NaN t (0/0, or NaN constants of a zero-area row) fails
                // t >= 0; +-inf t is rejected by the finiteness test
                if (t >= 0.0f && t <= tm && inside && valid > 0.0f &&
                    isfinite(t) && t <= bt) {
                    bt = t;
                    bi = base + c;
                }
            }
        }
    }
    if (in_range) {
        out_t[(size_t)split * R + r] = bt;
        out_i[(size_t)split * R + r] = bi;
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
// part_t / part_i hold n_split * R partials; with n_split == 1 they may be
// best_t / best_i themselves and no merge runs.
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
    const dim3 grid((R + SWEEP_THREADS - 1) / SWEEP_THREADS, n_split);
    closest_tris_sweep_kernel<<<grid, SWEEP_THREADS, 0,
                                (cudaStream_t)stream>>>(
        o, d, tmax, table, n_split == 1 ? best_t : part_t,
        n_split == 1 ? best_i : part_i, R, T, tiles_per_split);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || n_split == 1)
        return (int)e;
    merge_splits_kernel<<<(R + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        part_t, part_i, best_t, best_i, R, n_split);
    return (int)cudaGetLastError();
}
