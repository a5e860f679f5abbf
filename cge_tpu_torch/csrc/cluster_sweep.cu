// Cluster-culled ray x triangle sweep for Hopper (sm_90a): the two kernels
// of the port's accel path, exported as plain C functions for ctypes.
//
// K1  cge_block_entry_keys  replaces the Pallas kernel `_keys_kernel`
//     (cge_tpu/ops/pallas/cluster_sweep.py, launched by _block_entry_keys).
//     For every (ray block, supercluster box) pair: the minimum, over the
//     block's live rays (tmax >= 0), of the clipped slab entry t; +inf where
//     no live ray enters. A zero direction component passes its slab;
//     inverted boxes (lo > hi: empty clusters, pad boxes) never enter.
//     Bound on this card: the instruction issue rate. Each (live ray, box)
//     pair is a slab test of 12 float adds and multiplies and 7 to 13
//     min / max against a few bytes per pair; the min / max and the
//     compares issue on the ALU pipe at half the FMA pipes' rate
//     (tools/sass_count.py counts the loop's instructions by kind).
//     Design: a block of 128 threads per (ray block, 128 boxes), one box
//     a thread.
//     - The block's live rays are staged once, grouped by direction octant,
//       as two float4s each: (o, tmax) and (1/d, the d != 0 bits). The
//       loop runs over the live rays only, without a branch; a block
//       without a live ray writes +inf without looping.
//     - Within an octant the order of each axis's two plane t's is known:
//       (lo - o) / d <= (hi - o) / d where d > 0, the reverse where d < 0.
//       So the near and far planes are picked once per octant and box, and
//       the loop takes no min / max per axis: 7 min / max a pair in place
//       of 13. A NaN plane t still reaches tnear or tfar and fails the test.
//     - Each thread holds its box in registers; a ray is two 16-byte
//       broadcast loads from shared memory, and the ray loop is unrolled
//       so that independent tests overlap.
//     - A box's lo <= hi test runs once, outside the loop. A block where
//       some live ray has a zero direction component (a block-uniform flag
//       set while staging) takes the general loop instead: min / max per
//       axis and the zero-direction selects.
//     - The entry test max(tnear, 0) <= min(tfar, tmax) holds, for tmax >=
//       0, exactly when the twin's tnear <= tfar, tfar >= 0 and tnear <=
//       tmax all hold (a NaN fails both through min.NaN / max.NaN). Every
//       value is computed in the twin's operation order, (lo - o) * (1/d)
//       and NaN-propagating min and max, so the keys are bit-equal.
//
// K2  cge_cluster_walk_split / cge_cluster_walk_mxu  replace the Pallas
//     kernel `_cluster_kernel` (cge_tpu/ops/pallas/cluster_sweep.py,
//     launched by pallas_cluster_tris). Each ray block of BR rays walks its
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
//     The default walk and the refine mode (cluster_walk_split_kernel)
//     replace a one-thread-per-ray block (32 blocks of 512 threads on 132
//     SMs, the tile staged synchronously between two barriers, two more
//     barriers for the stop, and for refine a block vote and a barrier per
//     member). Their design:
//     - A ray block is a thread block cluster of CS CTAs, BR / CS rays
//       each. The stop's max is formed from the CTAs' partials through
//       distributed shared memory (remote stores, then the cluster
//       barrier), so every CTA takes exactly the block's visits.
//       Entry invariant: no CTA stores into another's shared memory before
//       a cluster barrier has shown that every CTA of the cluster has
//       started (arrived at entry, waited on before the first remote
//       store; the live-first scan runs in between). Exit invariant: each
//       remote store (a stop partial or a refine vote) is followed by a
//       barrier that every CTA waits on before its next store, and all
//       CTAs take the same stops and votes, so none exits while a store
//       into its shared memory may still come, and a slot is written
//       again only two barriers after the one that published it.
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
//     - refine (the Pallas kernel's refine_members; REFINE set): before a
//       member's tile is used, every ray takes its slab entry into the
//       member's box (with its tmax, as K1 does) and votes to run the tile
//       when the entry is at most its tentative best: bt folded with the
//       visit's members run so far (the smaller t, the later member on a
//       tie; any hit: done). The votes are OR-ed over the CTA
//       (__syncthreads_or) and over the cluster in the same remote stores
//       and cluster barrier as the stop's partials: the first member's
//       vote rides with the stop after the previous visit (the first
//       visit's is true: every best is +inf), each later member's takes a
//       barrier of its own, which also publishes its tile. A CTA whose own
//       vote is true knows that the block runs the tile and tests it
//       before it waits; the others wait first. A member that does not run
//       contributes nothing to any ray, as in the twin. A dead lane has
//       entry = best = +inf and always votes to run, as in JAX. The
//       member boxes are read one member ahead, with the tiles' copies.
//     A per-tile hoist of the shared origin's o.n would add a barrier to
//     every visit, which costs the latency-bound walk more than the five
//     flops a test it saves; each lane computes it from the block's first
//     ray instead, as the twin does.
//     - mxu (the Pallas kernel's mxu flag, triangle layout only; the
//       one-thread-per-ray kernel cluster_walk_mxu_kernel): the dense tile
//       is one contraction of the quantity-major tile [4C, 8] with the
//       rays' (o, -1) and (d, 0) rows, giving o.n - D, d.n, o.m_k - b_k and
//       d.m_k per pair, then t = -(o.n - D) / d.n and the edge tests
//       (o.m_k - b_k) + t d.m_k >= 0. Each warp runs it on the tensor cores
//       with nvcuda::wmma TF32 m16n16k8 fragments (K = 8 is one k-step).
//       Every operand is split into three TF32 pieces (v = p0 + p1 + p2, 33
//       significant bits) and the six products down to the 2^-22 terms are
//       accumulated in f32, smallest first: the counterpart of the TPU's
//       Precision.HIGHEST, which splits f32 into three bf16 pieces the same
//       way. (A 2-piece "3xTF32" split keeps 22 bits per operand; on
//       grazing rays, where d.n is small, that left t 1.1e-5 relative from
//       the f32 twin.) The products go through a per-warp staging tile in
//       shared memory, so each thread reads its own ray's values.
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
#define CGE_MAX_SMEM (227 * 1024)

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
                                            float tm, const float box[6]) {
    float tnear = 0.0f, tfar = 0.0f;
    bool box_ok = true;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
        const bool nz = (nz_bits >> ax) & 1;
        const float t1 = nz ? (box[ax] - o[ax]) * inv[ax] : -CGE_FLT_MAX;
        const float t2 = nz ? (box[3 + ax] - o[ax]) * inv[ax] : CGE_FLT_MAX;
        const float a = jmin(t1, t2);
        const float c = jmax(t1, t2);
        tnear = ax == 0 ? a : jmax(tnear, a);
        tfar = ax == 0 ? c : jmin(tfar, c);
        box_ok = box_ok && box[ax] <= box[3 + ax];
    }
    return (tnear <= tfar && tfar >= 0.0f && tm >= 0.0f && tnear <= tm &&
            box_ok) ? jmax(tnear, 0.0f) : INFINITY;
}

// 1/d per axis, 0 where d == 0, and the d != 0 bits: a ray's slab terms.
__device__ __forceinline__ int slab_terms(const float d[3], float inv[3]) {
    int nz_bits = 0;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
        const bool nz = d[ax] != 0.0f;
        inv[ax] = nz ? 1.0f / d[ax] : 0.0f;
        nz_bits |= (nz ? 1 : 0) << ax;
    }
    return nz_bits;
}

// ---------------------------------------------------------------------------
// K1: block entry keys
// ---------------------------------------------------------------------------

#define KEYS_THREADS 128

// The running minimum of one box's key over the n staged live rays. The
// box is (a, b) per axis. OCTANT: the rays share a direction octant and
// have no zero component, and (a, b) is the octant's (near, far) plane
// pair: (lo, hi) on an axis where d > 0, (hi, lo) where d < 0, so that
// (a - o) / d <= (b - o) / d and the min / max of the twin's pair is the
// pair itself. Otherwise (a, b) = (lo, hi), ordered by min / max, and a
// zero direction component passes its slab.
template <bool OCTANT>
__device__ __forceinline__ float keys_over_rays(
        const float4* __restrict__ s_ray, int n, const float (&a3)[3],
        const float (&b3)[3], float key) {
#pragma unroll 4
    for (int r = 0; r < n; ++r) {
        const float4 a = s_ray[2 * r], c = s_ray[2 * r + 1];
        const float o[3] = {a.x, a.y, a.z};
        const float inv[3] = {c.x, c.y, c.z};
        const int nz_bits = __float_as_int(c.w);
        float tnear = 0.0f, tfar = 0.0f;
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
            float t1 = (a3[ax] - o[ax]) * inv[ax];
            float t2 = (b3[ax] - o[ax]) * inv[ax];
            if (!OCTANT && !((nz_bits >> ax) & 1)) {
                t1 = -CGE_FLT_MAX;
                t2 = CGE_FLT_MAX;
            }
            const float n0 = OCTANT ? t1 : jmin(t1, t2);
            const float f0 = OCTANT ? t2 : jmax(t1, t2);
            tnear = ax == 0 ? n0 : jmax(tnear, n0);
            tfar = ax == 0 ? f0 : jmin(tfar, f0);
        }
        const float v = jmax(tnear, 0.0f);
        if (v <= jmin(tfar, a.w))
            key = jmin(key, v);
    }
    return key;
}

__global__ void __launch_bounds__(KEYS_THREADS)
block_entry_keys_kernel(const float* __restrict__ rays,
                        const float* __restrict__ boxes,
                        float* __restrict__ keys, int S, int BR) {
    extern __shared__ __align__(16) float smem[];
    float4* s_ray = reinterpret_cast<float4*>(smem);   // [n_live][2]
    // per ray: octant << 16 | slot in the octant, -1 for a dead ray
    int* s_slot = reinterpret_cast<int*>(s_ray + 2 * BR);
    __shared__ int s_cnt[8], s_off[9];

    const int tid = threadIdx.x, lane = tid & 31;
    if (tid < 8)
        s_cnt[tid] = 0;
    __syncthreads();
    // stage the live rays grouped by direction octant (bit ax: d < 0), in
    // two passes: count and take slots, then place (the order within an
    // octant is free: min is exact). BR is a multiple of 32, so a warp is
    // wholly in or out of range.
    const float* rb = rays + (size_t)blockIdx.x * 8 * BR;
    int zero = 0;
    for (int r = tid; r - tid < BR; r += KEYS_THREADS) {
        const float tm = r < BR ? rb[6 * BR + r] : -1.0f;
        int oct = 8;
        if (tm >= 0.0f) {
            const float dx = rb[3 * BR + r], dy = rb[4 * BR + r],
                        dz = rb[5 * BR + r];
            oct = (dx < 0.0f) | (dy < 0.0f) << 1 | (dz < 0.0f) << 2;
            zero |= dx == 0.0f || dy == 0.0f || dz == 0.0f;
        }
        const unsigned peers = __match_any_sync(FULL_MASK, oct);
        const int leader = __ffs(peers) - 1;
        int base = 0;
        if (lane == leader && oct < 8)
            base = atomicAdd(&s_cnt[oct], __popc(peers));
        base = __shfl_sync(FULL_MASK, base, leader);
        if (r < BR)
            s_slot[r] = oct < 8 ? oct << 16 | (base + __popc(
                            peers & ((1u << lane) - 1u))) : -1;
    }
    zero = __syncthreads_or(zero);
    if (tid == 0) {
        s_off[0] = 0;
        for (int i = 0; i < 8; ++i)
            s_off[i + 1] = s_off[i] + s_cnt[i];
    }
    __syncthreads();
    for (int r = tid; r < BR; r += KEYS_THREADS) {
        const int v = s_slot[r];
        if (v < 0)
            continue;
        const int slot = s_off[v >> 16] + (v & 0xffff);
        const float d[3] = {rb[3 * BR + r], rb[4 * BR + r], rb[5 * BR + r]};
        float inv[3];
        const int nz_bits = slab_terms(d, inv);
        s_ray[2 * slot] = make_float4(rb[r], rb[BR + r], rb[2 * BR + r],
                                      rb[6 * BR + r]);
        s_ray[2 * slot + 1] = make_float4(inv[0], inv[1], inv[2],
                                          __int_as_float(nz_bits));
    }
    __syncthreads();
    const int n_live = s_off[8];

    const int s = blockIdx.y * KEYS_THREADS + tid;
    if (s >= S)
        return;
    const float4* bx = reinterpret_cast<const float4*>(boxes);
    const float4 p = bx[2 * s], q = bx[2 * s + 1];
    const float lo[3] = {p.x, p.y, p.z}, hi[3] = {p.w, q.x, q.y};
    float key = INFINITY;
    if (p.x <= p.w && p.y <= q.x && p.z <= q.y) {
        if (zero) {
            key = keys_over_rays<false>(s_ray, n_live, lo, hi, key);
        } else {
            for (int oc = 0; oc < 8; ++oc) {
                const int beg = s_off[oc], n = s_off[oc + 1] - beg;
                if (n == 0)
                    continue;
                float nr[3], fr[3];
#pragma unroll
                for (int ax = 0; ax < 3; ++ax) {
                    const bool neg = (oc >> ax) & 1;
                    nr[ax] = neg ? hi[ax] : lo[ax];
                    fr[ax] = neg ? lo[ax] : hi[ax];
                }
                key = keys_over_rays<true>(s_ray + 2 * beg, n, nr, fr, key);
            }
        }
    }
    keys[(size_t)blockIdx.x * S + s] = key;
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

// The mxu walk: one block of one thread per ray, the triangle layout's
// quantity-major tiles [Lp, 4C, 8].
__global__ void __launch_bounds__(MXU_MAX_BR)
cluster_walk_mxu_kernel(const int* __restrict__ order,
                        const float* __restrict__ skeys,
                        const float* __restrict__ rays,
                        const float* __restrict__ tiles,
                        float* __restrict__ best_t, int* __restrict__ best_i,
                        int* __restrict__ visits, int* __restrict__ dense,
                        int n_sc, int sc_n, int C, int any_hit) {
    extern __shared__ __align__(16) float smem[];
    const int b = blockIdx.x, r = threadIdx.x, BR = blockDim.x;
    const int lane = r & 31;
    // s_q [3][4C][8] (the tile's TF32 pieces), the warps' regions
    float* s_q = smem;
    float* s_warp = smem + 96 * C + (r >> 5) * MXU_WARP_FLOATS;
    float* s_ray2 = s_warp + MXU_STAGE_FLOATS;
    float* s_red = smem + 96 * C + (BR / 32) * MXU_WARP_FLOATS;

    const float* rb = rays + (size_t)b * 8 * BR;
    const float ox = rb[r], oy = rb[BR + r], oz = rb[2 * BR + r];
    const float dx = rb[3 * BR + r], dy = rb[4 * BR + r], dz = rb[5 * BR + r];
    const float tm = rb[6 * BR + r];
    const float tm_eff = jmin(tm, rb[7 * BR + r]);
    const bool live = tm >= 0.0f;
    const int* ord = order + (size_t)b * n_sc;
    const float* sk = skeys + (size_t)b * n_sc;

    // the warp's ray rows as TF32 pieces, built once. a0 / a1 [side][mt]
    // are A fragments of pieces 0 and 1 for rays mt*16 .. mt*16+15 of the
    // warp, side 0 the (o, -1, 0...) rows, side 1 the (d, 0...) rows; piece
    // 2 stays in s_ray2 ([side][ray][8]) and is loaded where it is used,
    // which keeps the kernel in 128 registers.
    FragA a0[2][2], a1[2][2];
    {
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
                wmma::load_matrix_sync(
                    a1[side][mt], s_warp + side * 512 + 256 + mt * 128, 8);
            }
        __syncwarp();
    }

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
            __syncthreads();         // the previous cluster is fully used
            // dead rays accept nothing (t <= tmax < 0 <= t), and a done
            // any-hit ray stays done, so both skip the accept exactly
            const bool active = live && !(any_hit && bi == 1);
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
                                s_warp + (side * 32 + mt * 16) * MXU_LD, acc,
                                MXU_LD, wmma::mem_row_major);
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
                        accept(t[n], ok, cl * C + g * 16 + n, any_hit, bt, bi);
                    }
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
        dense[b] = step * sc_n;
    }
}

// ---------------------------------------------------------------------------
// K2, default and refine walks: a thread block cluster per ray block, L
// lanes per ray
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

// Member cl's box (lo3, hi3) from the [Lp, 8] stack.
__device__ __forceinline__ void load_box(const float* __restrict__ aabbs,
                                         int cl, float box[6]) {
    const float4* p = reinterpret_cast<const float4*>(aabbs) + 2 * (size_t)cl;
    const float4 a = __ldg(p), b = __ldg(p + 1);
    box[0] = a.x, box[1] = a.y, box[2] = a.z;
    box[3] = a.w, box[4] = b.x, box[5] = b.y;
}

// The cluster's exchanges, in two halves so that work runs while one is in
// flight. push_partial: this CTA's max of v (and, VOTE, the OR of vote
// over its threads, which it also returns) goes into slot `rank` of
// s_part[parity] (s_vote[parity]) in every CTA of the cluster (remote
// stores), then the cluster barrier is arrived at with release semantics.
// wait_max: the barrier is waited on with acquire semantics and the CS
// partials are read locally; cluster_any reads the votes after it. A slot
// is written again two exchanges later, after the next barrier, which no
// CTA passes before it has read it. The CTA barrier inside push_partial
// also orders the block's shared-memory use, as a __syncthreads would.
#define SPLIT_MAX_CS 8      // the portable cluster size

template <int CS, bool VOTE>
__device__ __forceinline__ int push_partial(float v, int vote, float* s_red,
                                            float* s_part, int* s_vote,
                                            int parity, int rank) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int off = 16; off > 0; off >>= 1)
        v = jmax(v, __shfl_xor_sync(FULL_MASK, v, off));
    if (lane == 0)
        s_red[warp] = v;
    int own = 0;
    if (VOTE)
        own = __syncthreads_or(vote);
    else
        __syncthreads();
    if (warp == 0) {
        float w = lane < (int)(blockDim.x >> 5) ? s_red[lane] : -INFINITY;
        for (int off = 16; off > 0; off >>= 1)
            w = jmax(w, __shfl_xor_sync(FULL_MASK, w, off));
        if (lane < CS) {
            cg::cluster_group cluster = cg::this_cluster();
            *cluster.map_shared_rank(s_part + parity * SPLIT_MAX_CS + rank,
                                     lane) = w;
            if (VOTE)
                *cluster.map_shared_rank(
                    s_vote + parity * SPLIT_MAX_CS + rank, lane) = own;
        }
    }
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    return own;
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

template <int CS>
__device__ __forceinline__ bool cluster_any(const int* s_vote, int parity) {
    int any = 0;
#pragma unroll
    for (int r = 0; r < CS; ++r)
        any |= s_vote[parity * SPLIT_MAX_CS + r];
    return any != 0;
}

// Shared memory of the split walk, in 4-byte words: two quad-major tile
// buffers, the reduction scratch, the cluster partials and votes, the
// live-ray scan and the CTA's ray order.
static size_t split_walk_smem_words(int C, int rays_per_cta) {
    return (size_t)32 * C + 32 + 4 * SPLIT_MAX_CS + 32 + rays_per_cta;
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

template <int CS, int L, bool REFINE>
__global__ void __launch_bounds__(SPLIT_MAX_THREADS)
cluster_walk_split_kernel(const int* __restrict__ order,
                          const float* __restrict__ skeys,
                          const float* __restrict__ rays,
                          const float* __restrict__ tiles,
                          const float* __restrict__ aabbs,
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
    int* s_vote = reinterpret_cast<int*>(s_part + 2 * SPLIT_MAX_CS);
    int* s_cnt = s_vote + 2 * SPLIT_MAX_CS;  // [32]
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
    // refine: the ray's slab terms, as K1 stages them, and the box of the
    // member whose tile is issued next
    float inv[3] = {0.0f, 0.0f, 0.0f};
    int nz_bits = 0;
    float nbox[6];
    if (REFINE) {
        const float d3[3] = {dx, dy, dz};
        nz_bits = slab_terms(d3, inv);
    }
    const float o3[3] = {ox, oy, oz};

    float bt = INFINITY;
    int bi = -1;
    // first-key guard: an all-dead or no-overlap block makes zero visits
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    push_partial<CS, false>(live ? tm_eff : -INFINITY, 0, s_red, s_part,
                            s_vote, 0, rank);
    bool stop = past(sk[0], wait_max<CS>(s_part, 0));
    int parity = 1;
    // The walk tests visit `step` while the stop after visit step - 1 is
    // still being reduced (pending); the visit's result is committed only
    // once that stop is known to be false, so exactly the twin's visits
    // change (best t, id). refine resolves that stop at the first member,
    // whose vote it carries.
    bool pending = false;
    bool own0 = true;            // refine: the CTA's vote on the first member
    float key = 0.0f;                        // sk[step] for the pending stop
    int step = 0, k = 0, n_dense = 0;
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
        const bool warp_active = __any_sync(FULL_MASK, active);
        float vt = INFINITY;
        int vi = -1;
        bool vh = false;
        int n_run = 0;
        for (int m = 0; m < sc_n; ++m, ++k) {
            const int cl = sc * sc_n + m;
            // the member whose tile is fetched next, -1 after the last visit
            const int ncl = m + 1 < sc_n ? cl + 1
                          : step + 1 < n_sc ? next_sc * sc_n : -1;
            cp_async_wait<0>();
            // tile k has landed; tile k - 1 is used up (a later member's
            // vote exchange carries the CTA barrier)
            bool own = own0;
            if (REFINE && m > 0) {
                // the tentative best: bt folded with the members run so far
                const float tb = any_hit ? (vh ? CGE_DONE : bt)
                                         : (vi >= 0 && vt <= bt ? vt : bt);
                own = push_partial<CS, true>(
                    -INFINITY, slab_entry(o3, inv, nz_bits, tm, nbox) <= tb,
                    s_red, s_part, s_vote, parity, rank);
                parity ^= 1;
            } else {
                __syncthreads();
            }
            if (ncl >= 0) {
                issue_tile(s_q + ((k + 1) & 1) * 16 * C, tiles, ncl, C,
                           field_major);
                if (REFINE)
                    load_box(aabbs, ncl, nbox);
            }
            const float4* q =
                reinterpret_cast<const float4*>(s_q + (k & 1) * 16 * C);
            float lt = INFINITY;
            int li = -1;
            bool lh = false;
            bool run = true;
            if (REFINE && (m > 0 || pending)) {
                // a CTA whose own vote is true tests before it waits
                if (own && warp_active)
                    test_tile<L>(q, C, l, ox, oy, oz, o0x, o0y, o0z, dx, dy,
                                 dz, tm, bt, any_hit, lt, li, lh);
                const float need = wait_max<CS>(s_part, parity ^ 1);
                if (m == 0) {
                    pending = false;
                    if (past(key, need)) {
                        stop = true; // visit `step` does not happen
                        break;
                    }
                }
                run = own || cluster_any<CS>(s_vote, parity ^ 1);
                if (run && !own && warp_active)
                    test_tile<L>(q, C, l, ox, oy, oz, o0x, o0y, o0z, dx, dy,
                                 dz, tm, bt, any_hit, lt, li, lh);
            } else if (warp_active) {
                test_tile<L>(q, C, l, ox, oy, oz, o0x, o0y, o0z, dx, dy, dz,
                             tm, bt, any_hit, lt, li, lh);
            }
            if (!run)
                continue;            // the member contributes nothing
            ++n_run;
            // members fold in visit order as the twin applies them: the
            // smallest t, the later member on a tie
            if (li >= 0 && lt <= vt) {
                vt = lt;
                vi = cl * C + li;
            }
            vh = vh || lh;
        }
        if (stop)
            break;
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
        n_dense += n_run;
        ++step;
        if (step >= n_sc)
            break;
        // refine: the next visit's first member is voted on the committed
        // best (nbox holds its box)
        own0 = push_partial<CS, REFINE>(
            live ? jmin(bt, tm_eff) : -INFINITY,
            REFINE && slab_entry(o3, inv, nz_bits, tm, nbox) <= bt, s_red,
            s_part, s_vote, parity, rank);
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
        dense[b] = n_dense;
    }
}

template <int CS, int L, bool REFINE>
static int launch_split_walk(const int* order, const float* skeys,
                             const float* rays, const float* tiles,
                             const float* aabbs, float* best_t, int* best_i,
                             int* visits, int* dense, int NB, int n_sc,
                             int BR, int sc_n, int C, int field_major,
                             int any_hit, int shared_origin,
                             cudaStream_t stream) {
    static_assert(CS <= SPLIT_MAX_CS && 32 % L == 0, "split walk shape");
    const int threads = BR / CS * L;
    if (BR % CS || threads % 32 || threads > SPLIT_MAX_THREADS)
        return (int)cudaErrorInvalidValue;
    const size_t smem = split_walk_smem_words(C, BR / CS) * 4;
    if (smem > CGE_MAX_SMEM)
        return (int)cudaErrorInvalidValue;
    auto kernel = cluster_walk_split_kernel<CS, L, REFINE>;
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
    e = cudaLaunchKernelEx(&cfg, kernel, order, skeys, rays, tiles, aabbs,
                           best_t, best_i, visits, dense, n_sc, BR, sc_n, C,
                           field_major, any_hit, shared_origin);
    if (e != cudaSuccess)
        return (int)e;
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// C interface (ctypes): pointers and the stream as void*, sizes as int.
// ---------------------------------------------------------------------------

// K1: rays and boxes 16-byte aligned.
extern "C" int cge_block_entry_keys(const float* rays, const float* boxes,
                                    float* keys, int NB, int S, int BR,
                                    void* stream) {
    if (NB == 0 || S == 0)
        return 0;
    if (BR % 32)
        return (int)cudaErrorInvalidValue;
    const dim3 grid(NB, (S + KEYS_THREADS - 1) / KEYS_THREADS);
    const size_t smem = (size_t)BR * (2 * sizeof(float4) + sizeof(int));
    block_entry_keys_kernel<<<grid, KEYS_THREADS, smem,
                              (cudaStream_t)stream>>>(rays, boxes, keys, S,
                                                      BR);
    return (int)cudaGetLastError();
}

// The mxu walk: one block of BR threads per ray block, the quantity-major
// tiles [Lp, 4C, 8].
extern "C" int cge_cluster_walk_mxu(const int* order, const float* skeys,
                                    const float* rays, const float* tiles,
                                    float* best_t, int* best_i, int* visits,
                                    int* dense, int NB, int n_sc, int BR,
                                    int sc_n, int C, int any_hit,
                                    void* stream) {
    if (NB == 0)
        return 0;
    const size_t smem = mxu_walk_smem_floats(C, BR) * sizeof(float);
    if (smem > CGE_MAX_SMEM || BR > MXU_MAX_BR || C % 16)
        return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            cluster_walk_mxu_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess)
            return (int)e;
    }
    cluster_walk_mxu_kernel<<<NB, BR, smem, (cudaStream_t)stream>>>(
        order, skeys, rays, tiles, best_t, best_i, visits, dense, n_sc, sc_n,
        C, any_hit);
    return (int)cudaGetLastError();
}

// The default and refine walks: (cs, lanes) picks CTAs per cluster and
// lanes per ray among the compiled shapes; BR / cs * lanes threads a CTA.
// refine reads the member boxes aabbs [Lp, 8], 16-byte aligned.
extern "C" int cge_cluster_walk_split(const int* order, const float* skeys,
                                      const float* rays, const float* tiles,
                                      const float* aabbs, float* best_t,
                                      int* best_i, int* visits, int* dense,
                                      int NB, int n_sc, int BR, int sc_n,
                                      int C, int field_major, int any_hit,
                                      int shared_origin, int refine, int cs,
                                      int lanes, void* stream) {
    if (NB == 0)
        return 0;
    cudaStream_t st = (cudaStream_t)stream;
#define CGE_SPLIT_SHAPE(CS_, L_)                                            \
    if (cs == CS_ && lanes == L_)                                           \
        return refine                                                       \
            ? launch_split_walk<CS_, L_, true>(                             \
                  order, skeys, rays, tiles, aabbs, best_t, best_i, visits, \
                  dense, NB, n_sc, BR, sc_n, C, field_major, any_hit,       \
                  shared_origin, st)                                        \
            : launch_split_walk<CS_, L_, false>(                            \
                  order, skeys, rays, tiles, aabbs, best_t, best_i, visits, \
                  dense, NB, n_sc, BR, sc_n, C, field_major, any_hit,       \
                  shared_origin, st);
    CGE_SPLIT_SHAPE(8, 16)
    CGE_SPLIT_SHAPE(8, 8)
#undef CGE_SPLIT_SHAPE
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* cge_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
