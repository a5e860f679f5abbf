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

#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
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

extern "C" const char* cge_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
