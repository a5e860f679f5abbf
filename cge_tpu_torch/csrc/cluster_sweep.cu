// Cluster-culled ray x triangle sweep for Hopper (sm_90a): the two kernels
// of the port's accel path, exported as plain C functions for ctypes.
//
// K1  cge_block_entry_keys  replaces the Pallas kernel `_keys_kernel`
//     (cge_tpu/ops/pallas/cluster_sweep.py, launched by _block_entry_keys).
//     For every (ray block, supercluster box) pair: the minimum, over the
//     block's live rays (tmax >= 0), of the clipped slab entry t; +inf where
//     no live ray enters. A zero direction component passes its slab;
//     inverted boxes (lo > hi: empty clusters, pad boxes) never enter.
//     Bound on this card: arithmetic. NB * S * BR slab tests (~30 flops
//     each) against a few bytes per pair; the rays are re-read from shared
//     memory, the boxes once per thread.
//     Design: one block per (ray block, 128 boxes). The block's rays are
//     staged once in shared memory with their reciprocal directions
//     precomputed (BR divides instead of S * BR); each thread owns one box
//     and loops over the live rays, keeping the minimum.
//
// K2  cge_cluster_walk  replaces the Pallas kernel `_cluster_kernel`
//     (cge_tpu/ops/pallas/cluster_sweep.py, launched by pallas_cluster_tris).
//     One block per ray block walks that block's supercluster order (sorted
//     by K1's keys) front to back. Per visited cluster every ray is tested
//     against the cluster's C triangles (plane t, then three edge planes);
//     a hit is accepted when 0 <= t <= tmax. The walk stops when the next
//     key is past every live ray's min(best t, tmax, scene exit t), or the
//     key is >= FLT_MAX. Modes: closest hit (last accepted wins on equal t:
//     the largest slot within a cluster, the later visit across clusters),
//     any hit (a hit ray is marked done with the -3e38 sentinel and flag 1),
//     and the shared-origin hoist of o.n for primary rays.
//     Bound on this card: arithmetic and the serial walk. Each visit is
//     C * BR ray-triangle tests (~40 flops each) on 8 KB of constants that
//     every ray reuses; the walk length is data-dependent, and a block-wide
//     reduction per step decides the stop.
//     Design: one thread per ray (BR threads). Per visited cluster the block
//     stages its C x 16 constants in shared memory, triangle-major whatever
//     the stack's layout, and each thread runs the C tests in slot order,
//     taking a hit when t <= best: that reproduces the Pallas tile's tie
//     rule exactly. The stack stays in device memory at every size; the
//     TPU's VMEM-resident / streamed split does not carry over, so the tile
//     layout is only an addressing parameter here.
//
// The file is built with --fmad=false so that the kernels round every
// product and sum as the plain PyTorch twins do: both compute bit-identical
// t's, and an edge test at a silhouette cannot flip between them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define CGE_FLT_MAX 3.4028234663852886e38f
#define CGE_DONE (-3.0e38f)

// NaN-propagating min / max, as jnp.minimum / jnp.maximum and torch's.
__device__ __forceinline__ float jmin(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

__device__ __forceinline__ float jmax(float a, float b) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

// ---------------------------------------------------------------------------
// K1: block entry keys
// ---------------------------------------------------------------------------

__global__ void block_entry_keys_kernel(const float* __restrict__ rays,
                                        const float* __restrict__ boxes,
                                        float* __restrict__ keys,
                                        int S, int BR) {
    extern __shared__ __align__(16) float smem[];
    float* s_o = smem;              // [3][BR] origins
    float* s_inv = smem + 3 * BR;   // [3][BR] 1/d, 0 where d == 0
    float* s_tm = smem + 6 * BR;    // [BR] tmax
    int* s_nz = reinterpret_cast<int*>(smem + 7 * BR);  // [BR] d != 0 bits

    const int b = blockIdx.x;
    const float* rb = rays + (size_t)b * 8 * BR;
    int live = 0;
    for (int r = threadIdx.x; r < BR; r += blockDim.x) {
        int nz_bits = 0;
        for (int ax = 0; ax < 3; ++ax) {
            const float d = rb[(3 + ax) * BR + r];
            const bool nz = d != 0.0f;
            s_o[ax * BR + r] = rb[ax * BR + r];
            s_inv[ax * BR + r] = nz ? 1.0f / d : 0.0f;
            nz_bits |= (nz ? 1 : 0) << ax;
        }
        const float tm = rb[6 * BR + r];
        s_tm[r] = tm;
        s_nz[r] = nz_bits;
        live |= tm >= 0.0f;
    }
    live = __syncthreads_or(live);

    const int s = blockIdx.y * blockDim.x + threadIdx.x;
    if (s >= S)
        return;
    float key = INFINITY;
    float lo[3], hi[3];
    bool box_ok = true;
    for (int ax = 0; ax < 3; ++ax) {
        lo[ax] = boxes[(size_t)s * 8 + ax];
        hi[ax] = boxes[(size_t)s * 8 + 3 + ax];
        box_ok = box_ok && lo[ax] <= hi[ax];
    }
    if (live && box_ok) {
        for (int r = 0; r < BR; ++r) {
            const float tm = s_tm[r];
            if (!(tm >= 0.0f))
                continue;
            const int nz_bits = s_nz[r];
            float tnear = 0.0f, tfar = 0.0f;
#pragma unroll
            for (int ax = 0; ax < 3; ++ax) {
                const float o = s_o[ax * BR + r];
                const float inv = s_inv[ax * BR + r];
                const bool nz = (nz_bits >> ax) & 1;
                const float t1 = nz ? (lo[ax] - o) * inv : -CGE_FLT_MAX;
                const float t2 = nz ? (hi[ax] - o) * inv : CGE_FLT_MAX;
                const float a = jmin(t1, t2);
                const float c = jmax(t1, t2);
                tnear = ax == 0 ? a : jmax(tnear, a);
                tfar = ax == 0 ? c : jmin(tfar, c);
            }
            if (tnear <= tfar && tfar >= 0.0f && tnear <= tm)
                key = jmin(key, jmax(tnear, 0.0f));
        }
    }
    keys[(size_t)b * S + s] = key;
}

// ---------------------------------------------------------------------------
// K2: ordered cluster walk
// ---------------------------------------------------------------------------

// Max over the block, NaN-propagating; every thread gets the result.
__device__ float block_max(float v, float* s_red) {
    for (int off = 16; off > 0; off >>= 1)
        v = jmax(v, __shfl_xor_sync(0xffffffffu, v, off));
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    __syncthreads();                 // s_red may still be read by a prior call
    if (lane == 0)
        s_red[warp] = v;
    __syncthreads();
    v = lane < (int)(blockDim.x >> 5) ? s_red[lane] : -INFINITY;
    for (int off = 16; off > 0; off >>= 1)
        v = jmax(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

// No remaining supercluster can help: the next key is behind every live
// ray's need, or +inf (no live ray enters it; inf > inf is false, so the
// FLT_MAX test is needed for blocks of unbounded rays that miss everything).
__device__ __forceinline__ bool past(float key, float need) {
    return key > need || key >= CGE_FLT_MAX;
}

__global__ void cluster_walk_kernel(const int* __restrict__ order,
                                    const float* __restrict__ skeys,
                                    const float* __restrict__ rays,
                                    const float* __restrict__ tiles,
                                    float* __restrict__ best_t,
                                    int* __restrict__ best_i,
                                    int* __restrict__ visits,
                                    int n_sc, int sc_n, int C,
                                    int field_major, int any_hit,
                                    int shared_origin) {
    extern __shared__ __align__(16) float smem[];
    float* s_tri = smem;              // [C][16] constants, triangle-major
    float* s_on = smem + C * 16;      // [C] o.n for the shared origin
    float* s_red = s_on + C;          // [32] reduction scratch

    const int b = blockIdx.x, r = threadIdx.x, BR = blockDim.x;
    const float* rb = rays + (size_t)b * 8 * BR;
    const float ox = rb[r], oy = rb[BR + r], oz = rb[2 * BR + r];
    const float dx = rb[3 * BR + r], dy = rb[4 * BR + r], dz = rb[5 * BR + r];
    const float tm = rb[6 * BR + r];
    const float tm_eff = jmin(tm, rb[7 * BR + r]);
    const bool live = tm >= 0.0f;
    // shared-origin mode: the block's first ray carries the origin (pad
    // rays only ever trail a block)
    const float o0x = rb[0], o0y = rb[BR], o0z = rb[2 * BR];
    const int* ord = order + (size_t)b * n_sc;
    const float* sk = skeys + (size_t)b * n_sc;

    float bt = INFINITY;
    int bi = -1;
    // first-key guard: an all-dead or no-overlap block makes zero visits
    float need = block_max(live ? tm_eff : -INFINITY, s_red);
    bool stop = past(sk[0], need);
    int step = 0;
    while (!stop) {
        const int sc = ord[step];
        for (int m = 0; m < sc_n; ++m) {
            const int cl = sc * sc_n + m;
            const float* src = tiles + (size_t)cl * C * 16;
            __syncthreads();         // the previous cluster is fully used
            for (int i = r; i < C * 16; i += BR) {
                const int c = field_major ? i % C : i / 16;
                const int k = field_major ? i / C : i % 16;
                s_tri[c * 16 + k] = src[i];
            }
            __syncthreads();
            if (shared_origin) {
                for (int c = r; c < C; c += BR) {
                    const float* q = s_tri + c * 16;
                    s_on[c] = (o0x * q[0] + o0y * q[1]) + o0z * q[2];
                }
                __syncthreads();
            }
            // dead rays accept nothing (t <= tmax < 0 <= t), and a done
            // any-hit ray stays done, so both skip the tests exactly
            if (!live || (any_hit && bi == 1))
                continue;
            for (int c = 0; c < C; ++c) {
                const float4* q = reinterpret_cast<const float4*>(s_tri + c * 16);
                const float4 n = q[0], e0 = q[1], e1 = q[2], e2 = q[3];
                const float dn = (dx * n.x + dy * n.y) + dz * n.z;
                const float on = shared_origin
                    ? s_on[c] : (ox * n.x + oy * n.y) + oz * n.z;
                const float t = (n.w - on) / dn;
                const float px = ox + t * dx, py = oy + t * dy, pz = oz + t * dz;
                const bool inside =
                    ((px * e0.x - e0.w) + py * e0.y) + pz * e0.z >= 0.0f &&
                    ((px * e1.x - e1.w) + py * e1.y) + pz * e1.z >= 0.0f &&
                    ((px * e2.x - e2.w) + py * e2.y) + pz * e2.z >= 0.0f;
                const bool ok = t >= 0.0f && t <= tm && inside;
                if (any_hit) {
                    if (ok) {
                        bt = CGE_DONE;
                        bi = 1;
                    }
                } else if (ok && isfinite(t) && t <= bt) {
                    bt = t;
                    bi = cl * C + c;
                }
            }
        }
        ++step;
        need = block_max(live ? jmin(bt, tm_eff) : -INFINITY, s_red);
        stop = step >= n_sc || past(sk[step < n_sc ? step : n_sc - 1], need);
    }
    best_t[(size_t)b * BR + r] = bt;
    best_i[(size_t)b * BR + r] = bi;
    if (r == 0)
        visits[b] = step;
}

// ---------------------------------------------------------------------------
// C interface (ctypes): pointers and the stream as void*, sizes as int.
// ---------------------------------------------------------------------------

extern "C" int cge_block_entry_keys(const float* rays, const float* boxes,
                                    float* keys, int NB, int S, int BR,
                                    void* stream) {
    if (NB == 0 || S == 0)
        return 0;
    const int threads = 128;
    const dim3 grid(NB, (S + threads - 1) / threads);
    const size_t smem = 8 * (size_t)BR * sizeof(float);
    block_entry_keys_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        rays, boxes, keys, S, BR);
    return (int)cudaGetLastError();
}

extern "C" int cge_cluster_walk(const int* order, const float* skeys,
                                const float* rays, const float* tiles,
                                float* best_t, int* best_i, int* visits,
                                int NB, int n_sc, int BR, int sc_n, int C,
                                int field_major, int any_hit,
                                int shared_origin, void* stream) {
    if (NB == 0)
        return 0;
    const size_t smem = ((size_t)C * 17 + 32) * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            cluster_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess)
            return (int)e;
    }
    cluster_walk_kernel<<<NB, BR, smem, (cudaStream_t)stream>>>(
        order, skeys, rays, tiles, best_t, best_i, visits, n_sc, sc_n, C,
        field_major, any_hit, shared_origin);
    return (int)cudaGetLastError();
}

extern "C" const char* cge_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
