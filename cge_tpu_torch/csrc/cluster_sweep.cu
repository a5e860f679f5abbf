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
// K2  cge_cluster_walk_split / cge_cluster_walk  replace the Pallas kernel
//     `_cluster_kernel` (cge_tpu/ops/pallas/cluster_sweep.py, launched by
//     pallas_cluster_tris). Each ray block of BR rays walks its
//     supercluster order (sorted by K1's keys) front to back. Per visited
//     cluster every ray is tested against the cluster's C triangles (plane
//     t, then three edge planes); a hit is accepted when 0 <= t <= tmax.
//     The walk stops when the next key is past every live ray's min(best
//     t, tmax, scene exit t), or the key is >= FLT_MAX. Modes: closest hit
//     (the tile's smallest t, the largest slot on a tie, taken when t <=
//     best: the later visit wins across clusters), any hit (a hit ray is
//     marked done with the -3e38 sentinel and flag 1), and the shared
//     origin of primary rays (o.n from the block's first ray).
//     Bound on this card: arithmetic. A visit is C plane t's (7-12 flops
//     and a divide each) per live ray on 8 KB of constants that every ray
//     of the block reuses, and the edge tests (24 flops) of a pair whose t
//     could be the answer (tools/roofline.py counts them from the run).
//     In practice the walk is bound by its latency: a 16k-ray chunk is 32
//     ray blocks, each walks its visits one after the other,
//     and the kernel lasts as long as the longest walk (161 visits where
//     the mean is 40 on the dragon's primary chunk), each visit ending in a
//     max over the whole ray block.
//
//     The default walk (cluster_walk_split_kernel) replaces a
//     one-thread-per-ray block (32 blocks of 512 threads on 132 SMs, the
//     tile staged synchronously between two barriers, two more barriers for
//     the stop). Its design:
//     - A ray block is a thread block cluster of CS CTAs, BR / CS rays
//       each. The stop's max is formed from the CTAs' partials through
//       distributed shared memory (remote stores, then the cluster
//       barrier), so every CTA takes exactly the block's visits.
//       Entry invariant: no CTA stores into another's shared memory before
//       a cluster barrier has shown that every CTA of the cluster has
//       started (arrived at entry, waited on before the first remote
//       store; the live-first scan runs in between). Exit invariant: each
//       remote store is followed by a barrier that every CTA waits on, and
//       all CTAs take the same stop, so none exits while a store into its
//       shared memory may still come.
//     - The stop is pipelined: visit k + 1 is tested while the stop after
//       visit k is reduced across the cluster (barrier.cluster arrive,
//       then wait after the tests). Its result is committed only when that
//       stop is known to be false. This is exact because a visit's result
//       (the smallest t, the largest id on a tie) does not depend on the
//       ray's best until it is taken (t <= best).
//     - L lanes of one warp share a ray and split each tile's C slots
//       (lane l takes slots l, l + L, ...). A lane keeps its smallest
//       accepted t and, on a tie, its largest slot; the lanes merge by
//       shuffles under the same rule, members fold in visit order, and the
//       ray takes the result when t <= best: the twin's rule, so t, ids,
//       visits and dense tiles are bit-equal.
//     - A plane t that cannot be taken (t < 0, past tmax, past the lane's
//       or the ray's best) skips the edge tests; the skip changes no result.
//     - The next tile is in flight while a tile is tested: a two-slot ring
//       filled by cp.async (the counterpart of the Pallas kernel's
//       make_async_copy), with the visit order read two visits ahead. The
//       next visit's first tile is fetched before the stop is known; the
//       walk waits for it before it leaves, so no copy is in flight at
//       exit.
//     - The copies scatter each tile, whatever its layout in the stack,
//       into a quad-major buffer: float4 (k4, c) at k4 * C + c holds
//       fields 4 k4 .. 4 k4 + 3 of slot c. The lanes of a warp then read
//       neighbouring float4s, free of bank conflicts.
//     - Each CTA orders its rays live first before the walk. The ray set
//       is unchanged, so the visits are too, and warps of dead rays skip
//       the tests on bounce levels.
//     A per-tile hoist of the shared origin's o.n would add a barrier to
//     every visit, which costs the latency-bound walk more than the five
//     flops a test it saves; each lane computes it from the block's first
//     ray instead, as the twin does.
//     The one-thread-per-ray kernel (cluster_walk_kernel below) still runs
//     the opt-in modes.
//     Opt-in modes (the Pallas kernel's refine_members and mxu flags):
//     - refine: before a member cluster's tile is staged, every ray takes
//       its slab entry into the member's box (as K1 does per pair, with
//       tmax), and the block runs the tile only if some lane has entry <=
//       its best t (__syncthreads_or, so the skip is block-uniform). A dead
//       lane has entry = best = +inf and always votes to run, as in JAX.
//       Visits, t and ids are those of the default walk; only the number
//       of dense tiles changes, and every mode reports it per block.
//     - mxu (triangle layout only): the dense tile is one contraction of
//       the quantity-major tile [4C, 8] with the rays' (o, -1) and (d, 0)
//       rows, giving o.n - D, d.n, o.m_k - b_k and d.m_k per pair, then
//       t = -(o.n - D) / d.n and the edge tests (o.m_k - b_k) + t d.m_k >=
//       0. Each warp runs it on the tensor cores with nvcuda::wmma TF32
//       m16n16k8 fragments (K = 8 is one k-step). Every operand is split
//       into three TF32 pieces (v = p0 + p1 + p2, 33 significant bits) and
//       the six products down to the 2^-22 terms are accumulated in f32,
//       smallest first: the counterpart of the TPU's Precision.HIGHEST,
//       which splits f32 into three bf16 pieces the same way. (A 2-piece
//       "3xTF32" split keeps 22 bits per operand; on grazing rays, where
//       d.n is small, that left t 1.1e-5 relative from the f32 twin.) The
//       products go through a per-warp staging tile in shared memory, so
//       each thread reads its own ray's values.
//       Bound: the tensor-core issue rate (24 mma per 16 triangles per 32
//       rays) plus the staging round trip; the SIMT side keeps only the
//       divide, three edge tests and the accept.
//
// The file is built with --fmad=false so that the kernels round every
// product and sum as the plain PyTorch twins do: both compute bit-identical
// t's, and an edge test at a silhouette cannot flip between them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "async_copy.cuh"

#define CGE_FLT_MAX 3.4028234663852886e38f
#define CGE_DONE (-3.0e38f)
#define FULL_MASK 0xffffffffu

namespace cg = cooperative_groups;

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

// Clipped slab entry t of one ray into one box (the JAX package's
// _entry_slab): +inf where the ray misses the box, is dead (tm < 0) or
// enters past tm. A zero direction component passes its slab (nz bit 0);
// an inverted box (lo > hi on an axis) never enters.
__device__ __forceinline__ float slab_entry(const float o[3],
                                            const float inv[3], int nz_bits,
                                            float tm, const float lo[3],
                                            const float hi[3]) {
    float tnear = 0.0f, tfar = 0.0f;
    bool box_ok = true;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
        const bool nz = (nz_bits >> ax) & 1;
        const float t1 = nz ? (lo[ax] - o[ax]) * inv[ax] : -CGE_FLT_MAX;
        const float t2 = nz ? (hi[ax] - o[ax]) * inv[ax] : CGE_FLT_MAX;
        const float a = jmin(t1, t2);
        const float c = jmax(t1, t2);
        tnear = ax == 0 ? a : jmax(tnear, a);
        tfar = ax == 0 ? c : jmin(tfar, c);
        box_ok = box_ok && lo[ax] <= hi[ax];
    }
    return (tnear <= tfar && tfar >= 0.0f && tm >= 0.0f && tnear <= tm &&
            box_ok) ? jmax(tnear, 0.0f) : INFINITY;
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
            const float o[3] = {s_o[r], s_o[BR + r], s_o[2 * BR + r]};
            const float inv[3] = {s_inv[r], s_inv[BR + r], s_inv[2 * BR + r]};
            key = jmin(key, slab_entry(o, inv, s_nz[r], tm, lo, hi));
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

// The accept step of one (ray, triangle) pair, in slot order: closest hit
// takes t <= best (the later slot wins an exact tie, as the Pallas tile's
// max-slot rule does); any hit marks the ray done.
__device__ __forceinline__ void accept(float t, bool ok, int slot,
                                       int any_hit, float& bt, int& bi) {
    if (any_hit) {
        if (ok) {
            bt = CGE_DONE;
            bi = 1;
        }
    } else if (ok && isfinite(t) && t <= bt) {
        bt = t;
        bi = slot;
    }
}

// The mxu mode's shared memory, in floats: the staged tile as three TF32
// pieces ([4C][8] each); per warp, a [64][MXU_LD] staging tile (rows 0:32
// the o side, 32:64 the d side of the warp's 32 rays) and the rays' third
// TF32 pieces ([2][32][8], the A operand read from shared memory); the
// reduction scratch.
#define MXU_LD 20          // staging row stride: conflict-free float4 reads
#define MXU_STAGE_FLOATS (64 * MXU_LD)
#define MXU_WARP_FLOATS (MXU_STAGE_FLOATS + 512)
#define CGE_MAX_SMEM (227 * 1024)

static size_t mxu_walk_smem_floats(int C, int BR) {
    return (size_t)96 * C + (size_t)(BR / 32) * MXU_WARP_FLOATS + 32;
}

namespace wmma = nvcuda::wmma;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32,
                             wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32,
                             wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;

// v = p[0] + p[1] + p[2] in TF32 pieces; each difference is exact.
__device__ __forceinline__ void tf32_split3(float v, float p[3]) {
    p[0] = wmma::__float_to_tf32(v);
    const float r = v - p[0];
    p[1] = wmma::__float_to_tf32(r);
    p[2] = wmma::__float_to_tf32(r - p[1]);
}

// The mxu mode keeps its ray fragments and 16 t's in registers: at most
// MXU_MAX_BR threads a block leaves it 128 registers a thread.
#define MXU_MAX_BR 512

template <bool MXU>
__global__ void __launch_bounds__(MXU ? MXU_MAX_BR : 1024)
cluster_walk_kernel(const int* __restrict__ order,
                                    const float* __restrict__ skeys,
                                    const float* __restrict__ rays,
                                    const float* __restrict__ tiles,
                                    const float* __restrict__ aabbs,
                                    float* __restrict__ best_t,
                                    int* __restrict__ best_i,
                                    int* __restrict__ visits,
                                    int* __restrict__ dense,
                                    int n_sc, int sc_n, int C,
                                    int field_major, int any_hit,
                                    int shared_origin, int refine) {
    extern __shared__ __align__(16) float smem[];
    const int b = blockIdx.x, r = threadIdx.x, BR = blockDim.x;
    const int lane = r & 31;
    // default layout: s_tri [C][16] (triangle-major), s_on [C]; mxu layout:
    // s_q [3][4C][8] (the tile's TF32 pieces), the warps' regions
    float* s_tri = smem;
    float* s_on = smem + C * 16;
    float* s_q = smem;
    float* s_warp = smem + 96 * C + (r >> 5) * MXU_WARP_FLOATS;
    float* s_ray2 = s_warp + MXU_STAGE_FLOATS;
    float* s_red = MXU ? smem + 96 * C + (BR / 32) * MXU_WARP_FLOATS
                       : smem + C * 17;

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
    // refine mode: the ray's slab terms, as K1 stages them
    const float o3[3] = {ox, oy, oz};
    const float d3[3] = {dx, dy, dz};
    float inv[3];
    int nz_bits = 0;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
        const bool nz = d3[ax] != 0.0f;
        inv[ax] = nz ? 1.0f / d3[ax] : 0.0f;
        nz_bits |= (nz ? 1 : 0) << ax;
    }

    // mxu mode: the warp's ray rows as TF32 pieces, built once. a0 / a1
    // [side][mt] are A fragments of pieces 0 and 1 for rays mt*16 ..
    // mt*16+15 of the warp, side 0 the (o, -1, 0...) rows, side 1 the
    // (d, 0...) rows; piece 2 stays in s_ray2 ([side][ray][8]) and is
    // loaded where it is used, which keeps the kernel in 128 registers.
    FragA a0[2][2], a1[2][2];
    if constexpr (MXU) {
        const float ext[2][8] = {{ox, oy, oz, -1.0f, 0.0f, 0.0f, 0.0f, 0.0f},
                                 {dx, dy, dz, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
        for (int side = 0; side < 2; ++side)
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                float p[3];
                tf32_split3(ext[side][k], p);
                s_warp[side * 512 + lane * 8 + k] = p[0];
                s_warp[side * 512 + 256 + lane * 8 + k] = p[1];
                s_ray2[side * 256 + lane * 8 + k] = p[2];
            }
        __syncwarp();
#pragma unroll
        for (int side = 0; side < 2; ++side)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
                wmma::load_matrix_sync(a0[side][mt],
                                       s_warp + side * 512 + mt * 128, 8);
                wmma::load_matrix_sync(a1[side][mt],
                                       s_warp + side * 512 + 256 + mt * 128, 8);
            }
        __syncwarp();
    }

    float bt = INFINITY;
    int bi = -1;
    int n_dense = 0;
    // first-key guard: an all-dead or no-overlap block makes zero visits
    float need = block_max(live ? tm_eff : -INFINITY, s_red);
    bool stop = past(sk[0], need);
    int step = 0;
    while (!stop) {
        const int sc = ord[step];
        for (int m = 0; m < sc_n; ++m) {
            const int cl = sc * sc_n + m;
            if (refine) {
                const float* box = aabbs + (size_t)cl * 8;
                const float lo[3] = {box[0], box[1], box[2]};
                const float hi[3] = {box[3], box[4], box[5]};
                const float e = slab_entry(o3, inv, nz_bits, tm, lo, hi);
                // block-uniform, decided before the tile is staged; the
                // barrier also retires the previous cluster's reads
                if (!__syncthreads_or(e <= bt))
                    continue;
            }
            ++n_dense;
            __syncthreads();         // the previous cluster is fully used
            // dead rays accept nothing (t <= tmax < 0 <= t), and a done
            // any-hit ray stays done, so both skip the accept exactly
            const bool active = live && !(any_hit && bi == 1);
            if constexpr (MXU) {
                const float* src = tiles + (size_t)cl * C * 32;
                for (int i = r; i < C * 32; i += BR) {
                    float p[3];
                    tf32_split3(src[i], p);
                    s_q[i] = p[0];
                    s_q[32 * C + i] = p[1];
                    s_q[64 * C + i] = p[2];
                }
                __syncthreads();
                // every lane takes part in the warp's contractions
                for (int g = 0; g < C / 16; ++g) {
                    float t[16];
                    unsigned inside = 0xffffu;
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        FragB b0, b1, b2;
                        const float* row = s_q + (q * C + g * 16) * 8;
                        wmma::load_matrix_sync(b0, row, 8);
                        wmma::load_matrix_sync(b1, row + 32 * C, 8);
                        wmma::load_matrix_sync(b2, row + 64 * C, 8);
#pragma unroll
                        for (int side = 0; side < 2; ++side)
#pragma unroll
                            for (int mt = 0; mt < 2; ++mt) {
                                FragA a2;
                                wmma::load_matrix_sync(
                                    a2, s_ray2 + side * 256 + mt * 128, 8);
                                FragC acc;
                                wmma::fill_fragment(acc, 0.0f);
                                wmma::mma_sync(acc, a2, b0, acc);
                                wmma::mma_sync(acc, a1[side][mt], b1, acc);
                                wmma::mma_sync(acc, a0[side][mt], b2, acc);
                                wmma::mma_sync(acc, a1[side][mt], b0, acc);
                                wmma::mma_sync(acc, a0[side][mt], b1, acc);
                                wmma::mma_sync(acc, a0[side][mt], b0, acc);
                                wmma::store_matrix_sync(
                                    s_warp + (side * 32 + mt * 16) * MXU_LD,
                                    acc, MXU_LD, wmma::mem_row_major);
                            }
                        __syncwarp();
                        const float4* ov = reinterpret_cast<const float4*>(
                            s_warp + lane * MXU_LD);
                        const float4* dv = reinterpret_cast<const float4*>(
                            s_warp + (32 + lane) * MXU_LD);
#pragma unroll
                        for (int j = 0; j < 4; ++j) {
                            const float4 o4 = ov[j], d4 = dv[j];
                            const float oq[4] = {o4.x, o4.y, o4.z, o4.w};
                            const float dq[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
                            for (int u = 0; u < 4; ++u) {
                                const int n = 4 * j + u;
                                if (q == 0)
                                    t[n] = -oq[u] / dq[u];
                                else if (!(oq[u] + t[n] * dq[u] >= 0.0f))
                                    inside &= ~(1u << n);
                            }
                        }
                        __syncwarp();
                    }
                    if (active) {
#pragma unroll
                        for (int n = 0; n < 16; ++n) {
                            const bool ok = t[n] >= 0.0f && t[n] <= tm &&
                                            ((inside >> n) & 1u);
                            accept(t[n], ok, cl * C + g * 16 + n, any_hit, bt,
                                   bi);
                        }
                    }
                }
            } else {
                const float* src = tiles + (size_t)cl * C * 16;
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
                if (!active)
                    continue;
                for (int c = 0; c < C; ++c) {
                    const float4* q =
                        reinterpret_cast<const float4*>(s_tri + c * 16);
                    const float4 n = q[0], e0 = q[1], e1 = q[2], e2 = q[3];
                    const float dn = (dx * n.x + dy * n.y) + dz * n.z;
                    const float on = shared_origin
                        ? s_on[c] : (ox * n.x + oy * n.y) + oz * n.z;
                    const float t = (n.w - on) / dn;
                    const float px = ox + t * dx, py = oy + t * dy,
                                pz = oz + t * dz;
                    const bool inside =
                        ((px * e0.x - e0.w) + py * e0.y) + pz * e0.z >= 0.0f &&
                        ((px * e1.x - e1.w) + py * e1.y) + pz * e1.z >= 0.0f &&
                        ((px * e2.x - e2.w) + py * e2.y) + pz * e2.z >= 0.0f;
                    accept(t, t >= 0.0f && t <= tm && inside, cl * C + c,
                           any_hit, bt, bi);
                }
            }
        }
        ++step;
        need = block_max(live ? jmin(bt, tm_eff) : -INFINITY, s_red);
        stop = step >= n_sc || past(sk[step < n_sc ? step : n_sc - 1], need);
    }
    best_t[(size_t)b * BR + r] = bt;
    best_i[(size_t)b * BR + r] = bi;
    if (r == 0) {
        visits[b] = step;
        dense[b] = n_dense;
    }
}

// ---------------------------------------------------------------------------
// K2, default walk: a thread block cluster per ray block, L lanes per ray
// ---------------------------------------------------------------------------

// Start the copies of cluster cl's tile into a quad-major buffer [4][C]
// of float4: (k4, c) holds fields 4 k4 .. 4 k4 + 3 of slot c. The
// triangle layout [C][16] moves as float4s, the field layout [16][C] as
// single floats (neighbouring threads read neighbouring slots).
__device__ __forceinline__ void issue_tile(float* dst,
                                           const float* __restrict__ tiles,
                                           int cl, int C, int field_major) {
    const float* src = tiles + (size_t)cl * C * 16;
    if (field_major) {
        for (int i = threadIdx.x; i < C * 16; i += blockDim.x) {
            const int k = i / C, c = i - k * C;
            cp_async4(dst + ((k >> 2) * C + c) * 4 + (k & 3), src + i);
        }
    } else {
        for (int i = threadIdx.x; i < C * 4; i += blockDim.x)
            cp_async16(dst + ((i & 3) * C + (i >> 2)) * 4, src + 4 * i);
    }
    cp_async_commit();
}

// The stop's max over the cluster, in two halves so that the next visit's
// tests run while it is in flight. push_partial: this CTA's max of v goes
// into slot `rank` of s_part[parity] in every CTA of the cluster (remote
// stores), then the cluster barrier is arrived at with release semantics.
// wait_max: the barrier is waited on with acquire semantics and the CS
// partials are read locally. A slot is written again two reductions later,
// after the next barrier, which no CTA passes before it has read it.
#define SPLIT_MAX_CS 8      // the portable cluster size

template <int CS>
__device__ __forceinline__ void push_partial(float v, float* s_red,
                                             float* s_part, int parity,
                                             int rank) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int off = 16; off > 0; off >>= 1)
        v = jmax(v, __shfl_xor_sync(FULL_MASK, v, off));
    if (lane == 0)
        s_red[warp] = v;
    __syncthreads();
    if (warp == 0) {
        float w = lane < (int)(blockDim.x >> 5) ? s_red[lane] : -INFINITY;
        for (int off = 16; off > 0; off >>= 1)
            w = jmax(w, __shfl_xor_sync(FULL_MASK, w, off));
        if (lane < CS)
            *cg::this_cluster().map_shared_rank(
                s_part + parity * SPLIT_MAX_CS + rank, lane) = w;
    }
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

template <int CS>
__device__ __forceinline__ float wait_max(const float* s_part, int parity) {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    float need = -INFINITY;
#pragma unroll
    for (int r = 0; r < CS; ++r)
        need = jmax(need, s_part[parity * SPLIT_MAX_CS + r]);
    return need;
}

// Shared memory of the split walk, in 4-byte words: two quad-major tile
// buffers, the reduction scratch, the cluster partials, the live-ray scan
// and the CTA's ray order.
static size_t split_walk_smem_words(int C, int rays_per_cta) {
    return (size_t)32 * C + 32 + 2 * SPLIT_MAX_CS + 32 + rays_per_cta;
}

#define SPLIT_MAX_THREADS 1024

// One visit's test of this lane's slots of the tile at q, merged over the
// ray's L lanes: (smallest accepted t, its largest slot) or, any hit, the
// OR of the hits. A plane t that cannot be accepted (behind the origin,
// past tmax, or past the ray's best bt, which the tile's result must reach
// to be taken) skips the edge tests. (o0x, o0y, o0z) is the origin of o.n:
// the block's first ray in the shared-origin mode. Every lane of the warp
// takes part in the shuffles.
template <int L>
__device__ __forceinline__ void test_tile(
        const float4* q, int C, int l, float ox, float oy, float oz,
        float o0x, float o0y, float o0z, float dx, float dy, float dz,
        float tm, float bt, int any_hit, float& lt, int& li, bool& lh) {
    lt = INFINITY;
    li = -1;
    lh = false;
#pragma unroll 4
    for (int c = l; c < C; c += L) {
        const float4 n = q[c];
        const float dn = (dx * n.x + dy * n.y) + dz * n.z;
        const float on = (o0x * n.x + o0y * n.y) + o0z * n.z;
        const float t = (n.w - on) / dn;
        if (!(t >= 0.0f && t <= tm &&
              (any_hit || (t < INFINITY && t <= lt && t <= bt))))
            continue;
        const float4 e0 = q[C + c], e1 = q[2 * C + c], e2 = q[3 * C + c];
        const float px = ox + t * dx, py = oy + t * dy, pz = oz + t * dz;
        if (((px * e0.x - e0.w) + py * e0.y) + pz * e0.z >= 0.0f &&
            ((px * e1.x - e1.w) + py * e1.y) + pz * e1.z >= 0.0f &&
            ((px * e2.x - e2.w) + py * e2.y) + pz * e2.z >= 0.0f) {
            lh = true;
            lt = t;                  // slots rise: the later one wins a tie
            li = c;
        }
    }
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) {
        const float ot = __shfl_xor_sync(FULL_MASK, lt, off);
        const int oi = __shfl_xor_sync(FULL_MASK, li, off);
        if (ot < lt || (ot == lt && oi > li)) {
            lt = ot;
            li = oi;
        }
        lh = __shfl_xor_sync(FULL_MASK, (int)lh, off) || lh;
    }
}

template <int CS, int L>
__global__ void __launch_bounds__(SPLIT_MAX_THREADS)
cluster_walk_split_kernel(const int* __restrict__ order,
                          const float* __restrict__ skeys,
                          const float* __restrict__ rays,
                          const float* __restrict__ tiles,
                          float* __restrict__ best_t,
                          int* __restrict__ best_i,
                          int* __restrict__ visits,
                          int* __restrict__ dense,
                          int n_sc, int BR, int sc_n, int C, int field_major,
                          int any_hit, int shared_origin) {
    extern __shared__ __align__(16) float smem[];
    float* s_q = smem;                       // [2][4][C] float4
    float* s_red = smem + 32 * C;            // [32]
    float* s_part = s_red + 32;              // [2][SPLIT_MAX_CS]
    int* s_cnt = reinterpret_cast<int*>(s_part + 2 * SPLIT_MAX_CS);  // [32]
    int* s_perm = s_cnt + 32;                // [BR / CS]

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int rank = (int)cg::this_cluster().block_rank();
    const int b = blockIdx.x / CS;
    const int rpc = BR / CS;                 // rays of this CTA
    const float* rb = rays + (size_t)b * 8 * BR;
    const int* ord = order + (size_t)b * n_sc;
    const float* sk = skeys + (size_t)b * n_sc;
    // distributed shared memory is written only once every CTA of the
    // cluster has started: arrive now, wait before the first remote store
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

    // the CTA's rays, live ones first in their order, then the dead ones
    const int scan_warps = (rpc + 31) >> 5;
    const bool lv = tid < rpc && rb[6 * BR + rank * rpc + tid] >= 0.0f;
    unsigned ballot = 0;
    if (warp < scan_warps) {
        ballot = __ballot_sync(FULL_MASK, lv);
        if (lane == 0)
            s_cnt[warp] = __popc(ballot);
    }
    __syncthreads();
    if (tid < rpc) {
        int before = 0, n_live = 0;
        for (int w = 0; w < scan_warps; ++w) {
            before += w < warp ? s_cnt[w] : 0;
            n_live += s_cnt[w];
        }
        const int lb = before + __popc(ballot & ((1u << lane) - 1u));
        s_perm[lv ? lb : n_live + tid - lb] = tid;
    }
    __syncthreads();

    // lanes l of group g share ray r
    const int g = tid / L, l = tid % L;
    const int r = rank * rpc + s_perm[g];
    const float ox = rb[r], oy = rb[BR + r], oz = rb[2 * BR + r];
    const float dx = rb[3 * BR + r], dy = rb[4 * BR + r], dz = rb[5 * BR + r];
    const float tm = rb[6 * BR + r];
    const float tm_eff = jmin(tm, rb[7 * BR + r]);
    const bool live = tm >= 0.0f;
    // the origin of o.n: the block's first ray in the shared-origin mode
    const float o0x = shared_origin ? rb[0] : ox;
    const float o0y = shared_origin ? rb[BR] : oy;
    const float o0z = shared_origin ? rb[2 * BR] : oz;

    float bt = INFINITY;
    int bi = -1;
    // first-key guard: an all-dead or no-overlap block makes zero visits
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    push_partial<CS>(live ? tm_eff : -INFINITY, s_red, s_part, 0, rank);
    bool stop = past(sk[0], wait_max<CS>(s_part, 0));
    int parity = 1;
    // The walk tests visit `step` while the stop after visit step - 1 is
    // still being reduced (pending); the visit's result is committed only
    // once that stop is known to be false, so exactly the twin's visits
    // change (best t, id).
    bool pending = false;
    float key = 0.0f;                        // sk[step] for the pending stop
    int step = 0, k = 0;
    // the order is read two visits ahead, the keys one
    int sc = stop ? 0 : ord[0];
    int next_sc = !stop && n_sc > 1 ? ord[1] : 0;
    if (!stop)
        issue_tile(s_q, tiles, sc * sc_n, C, field_major);
    while (!stop) {
        const int after_sc = step + 2 < n_sc ? ord[step + 2] : 0;
        const float next_key = sk[step + 1 < n_sc ? step + 1 : n_sc - 1];
        // dead rays accept nothing, a done any-hit ray stays done
        const bool active = live && !(any_hit && bi == 1);
        float vt = INFINITY;
        int vi = -1;
        bool vh = false;
        for (int m = 0; m < sc_n; ++m, ++k) {
            const int cl = sc * sc_n + m;
            cp_async_wait<0>();
            __syncthreads();     // tile k has landed; tile k - 1 is used up
            float* next = s_q + ((k + 1) & 1) * 16 * C;
            if (m + 1 < sc_n)
                issue_tile(next, tiles, cl + 1, C, field_major);
            else if (step + 1 < n_sc)
                issue_tile(next, tiles, next_sc * sc_n, C, field_major);
            if (!__any_sync(FULL_MASK, active))
                continue;
            float lt;
            int li;
            bool lh;
            test_tile<L>(
                reinterpret_cast<const float4*>(s_q + (k & 1) * 16 * C), C,
                l, ox, oy, oz, o0x, o0y, o0z, dx, dy, dz, tm, bt, any_hit,
                lt, li, lh);
            // members fold in visit order as the twin applies them: the
            // smallest t, the later member on a tie
            if (li >= 0 && lt <= vt) {
                vt = lt;
                vi = cl * C + li;
            }
            vh = vh || lh;
        }
        if (pending) {
            stop = past(key, wait_max<CS>(s_part, parity ^ 1));
            if (stop)
                break;           // visit `step` does not happen
        }
        if (active) {
            if (any_hit) {
                if (vh) {
                    bt = CGE_DONE;
                    bi = 1;
                }
            } else if (vi >= 0 && vt <= bt) {
                bt = vt;
                bi = vi;
            }
        }
        ++step;
        if (step >= n_sc)
            break;
        push_partial<CS>(live ? jmin(bt, tm_eff) : -INFINITY, s_red, s_part,
                         parity, rank);
        parity ^= 1;
        pending = true;
        key = next_key;
        sc = next_sc;
        next_sc = after_sc;
    }
    cp_async_wait<0>();         // the next visit's tile may be in flight
    if (l == 0) {
        best_t[(size_t)b * BR + r] = bt;
        best_i[(size_t)b * BR + r] = bi;
    }
    if (rank == 0 && tid == 0) {
        visits[b] = step;
        dense[b] = step * sc_n;
    }
}

template <int CS, int L>
static int launch_split_walk(const int* order, const float* skeys,
                             const float* rays, const float* tiles,
                             float* best_t, int* best_i, int* visits,
                             int* dense, int NB, int n_sc, int BR, int sc_n,
                             int C, int field_major, int any_hit,
                             int shared_origin, cudaStream_t stream) {
    static_assert(CS <= SPLIT_MAX_CS && 32 % L == 0, "split walk shape");
    const int threads = BR / CS * L;
    if (BR % CS || threads % 32 || threads > SPLIT_MAX_THREADS)
        return (int)cudaErrorInvalidValue;
    const size_t smem = split_walk_smem_words(C, BR / CS) * 4;
    if (smem > CGE_MAX_SMEM)
        return (int)cudaErrorInvalidValue;
    auto kernel = cluster_walk_split_kernel<CS, L>;
    cudaError_t e;
    if (smem > 48 * 1024) {
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess)
            return (int)e;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(NB * CS);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CS;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kernel, order, skeys, rays, tiles, best_t,
                           best_i, visits, dense, n_sc, BR, sc_n, C,
                           field_major, any_hit, shared_origin);
    if (e != cudaSuccess)
        return (int)e;
    return (int)cudaGetLastError();
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
                                const float* aabbs, float* best_t,
                                int* best_i, int* visits, int* dense, int NB,
                                int n_sc, int BR, int sc_n, int C,
                                int field_major, int any_hit,
                                int shared_origin, int refine, int mxu,
                                void* stream) {
    if (NB == 0)
        return 0;
    const size_t smem = mxu ? mxu_walk_smem_floats(C, BR) * sizeof(float)
                            : ((size_t)C * 17 + 32) * sizeof(float);
    if (smem > CGE_MAX_SMEM || (mxu && (BR > MXU_MAX_BR || C % 16)))
        return (int)cudaErrorInvalidValue;
    auto kernel = mxu ? cluster_walk_kernel<true> : cluster_walk_kernel<false>;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess)
            return (int)e;
    }
    kernel<<<NB, BR, smem, (cudaStream_t)stream>>>(
        order, skeys, rays, tiles, aabbs, best_t, best_i, visits, dense, n_sc,
        sc_n, C, field_major, any_hit, shared_origin, refine);
    return (int)cudaGetLastError();
}

// The default walk: (cs, lanes) picks CTAs per cluster and lanes per ray
// among the compiled shapes; BR / cs * lanes threads a CTA.
extern "C" int cge_cluster_walk_split(const int* order, const float* skeys,
                                      const float* rays, const float* tiles,
                                      float* best_t, int* best_i,
                                      int* visits, int* dense, int NB,
                                      int n_sc, int BR, int sc_n, int C,
                                      int field_major, int any_hit,
                                      int shared_origin, int cs, int lanes,
                                      void* stream) {
    if (NB == 0)
        return 0;
    cudaStream_t st = (cudaStream_t)stream;
#define CGE_SPLIT_SHAPE(CS_, L_)                                            \
    if (cs == CS_ && lanes == L_)                                           \
        return launch_split_walk<CS_, L_>(                                  \
            order, skeys, rays, tiles, best_t, best_i, visits, dense, NB,   \
            n_sc, BR, sc_n, C, field_major, any_hit, shared_origin, st);
    CGE_SPLIT_SHAPE(8, 16)
    CGE_SPLIT_SHAPE(8, 8)
#undef CGE_SPLIT_SHAPE
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* cge_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
