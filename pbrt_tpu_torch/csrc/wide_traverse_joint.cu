// Joint closest-hit / any-hit traversal of the 8-wide BVH: a warp-cooperative
// walk, GW = 4 lanes per ray, 8 rays per warp.
//
// Replaces pbrt_tpu/device/pallas_bvh.py _traverse_kernel_joint (the TPU
// kernel that pallas_bvh._run launches with joint=True, opt-in with
// PBRT_TPU_JOINT=1). The TPU kernel interleaves GRID_G = 8 packets' pop
// chains in one straight-line body so that the VLIW scheduler overlaps
// their load latency; per packet its results are the sequential kernel's.
//
// Hopper form of "several pop chains in flight together" (Lier, Stamminger
// and Selgrad, "CPU-Style SIMD Ray Traversal on GPUs", HPG 2018): the
// lanes of a group split one pop's loads and tests between them, where B1
// (wide_traverse.cu) gives each ray a lane and hides latency with
// occupancy alone.
//  - Interior pop: lane c of the group loads children c and c + 4 of the
//    node record (a coalesced 256-byte read per group), runs B1's box test
//    on each (wt_box), and two ballots give the hit mask; B1's stack entry
//    (node, mask, direction) goes onto the group's stack (wt_push).
//  - Leaf pop: the n valid rows go 4 per lane (rows c, c + 4, c + 8,
//    c + 12), each through B1's triangle test (wt_tri); a butterfly over
//    the group keeps the smallest t and, among equal t, the highest row j,
//    which is the sequential loop's choice (t <= tmin), and the winner's
//    barycentrics and prim come from its lane. Across leaves only a strict
//    improvement counts (wt_take_leaf, with the 1e29 guard); an any-hit ray
//    stops at its first hit.
//  - The group's stack (72 entries) lives in shared memory; its top entry
//    is held in a register by every lane of the group, and one lane writes
//    the entries that move down.
//  - Persistent groups over the ray queue, as B1's lanes (wide_traverse.cuh),
//    refilled once REFILL_MIN groups of a warp are idle.
// The group width is by measurement: 4 lanes per ray against 8
// (tools/walk_variants.py, PERF.md).
// Results: every pop is B1's pop, in B1's order, with B1's arithmetic, so t,
// idx, b1, b2 and pops equal B1's bit for bit (-fmad=false, as B1).
//
// Bound: as B1, dependent-load latency; a group keeps one ray's loads in
// flight 4 lanes wide, so a warp holds 8 rays where B1's holds 32.
// iters gets, per warp, the loop iterations in which a group popped:
// sum(pops) / (8 x iters) is the share of groups holding a ray.

#include "wide_traverse.cuh"

#define THREADS 128
#define GW 4                   // lanes per ray
#define CPL (8 / GW)           // children per lane
#define RPL (16 / GW)          // leaf rows per lane
#define GROUPS (THREADS / GW)  // rays per block
#define REFILL_MIN 4           // idle groups a warp gathers before it takes rays (by measurement: PERF.md)

// One pop of the group's live ray; every lane of the group calls it.
__device__ __forceinline__ void group_pop(WideRay& r, int* stack, int c, int g0, unsigned gmask,
                                          const float* __restrict__ node_rec, const float* __restrict__ leaf_rec,
                                          unsigned int* counters) {
    if (r.pops >= WT_ITER_CAP) {
        if (c == 0) atomicAdd(&counters[1], 1u);
        r.sp = 0;
        return;
    }
    ++r.pops;
    const int e = wt_pop_meta(r, stack, node_rec);

    if (e > 0) {
        const float4* rec = reinterpret_cast<const float4*>(node_rec + (size_t)(e & 0x1FFFFF) * WT_NODE_REC);
        int mask = 0;
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
            const int ch = c + i * GW;
            const float4 a = __ldg(rec + 2 * ch);
            const float4 b = __ldg(rec + 2 * ch + 1);
            const bool hit = __float_as_int(b.z) != 0 && wt_box(r, a, b);  // meta 0: an empty slot
            mask |= (int)((__ballot_sync(gmask, hit) >> g0) & ((1u << GW) - 1u)) << (i * GW);
        }
        if (mask != 0) {
            wt_push(r, stack, e, mask, c == 0, counters);
            __syncwarp(gmask);  // the entry that moved down, before any lane reads it
        }
        return;
    }
    // leaf: rows c, c + GW, ... of its n valid rows
    const int row0 = wt_leaf_row0(e), n = wt_leaf_n(e);
    float tmin = 1e30f, w1 = 0.0f, w2 = 0.0f;
    int jwin = -1, gid = -1;
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
        const int j = c + i * GW;
        if (j < n) {
            const float4* row = reinterpret_cast<const float4*>(leaf_rec + (size_t)(row0 + j) * WT_ROW);
            const float4 q2 = __ldg(row + 2);
            float t, b1, b2;
            if (wt_tri(r, __ldg(row), __ldg(row + 1), q2, t, b1, b2) && t <= tmin) {
                tmin = t;
                jwin = j;
                w1 = b1;
                w2 = b2;
                gid = (int)q2.z;
            }
        }
    }
    // the group's winner: the smallest t, the highest j among equal t
#pragma unroll
    for (int off = GW / 2; off > 0; off >>= 1) {
        const float ot = __shfl_xor_sync(gmask, tmin, off);
        const int oj = __shfl_xor_sync(gmask, jwin, off);
        if (ot < tmin || (ot == tmin && oj > jwin)) {
            tmin = ot;
            jwin = oj;
        }
    }
    if (tmin < fminf(r.t_best, 1e29f)) {  // group-uniform
        const int owner = g0 + jwin % GW;  // the lane that tested row jwin
        const float b1 = __shfl_sync(gmask, w1, owner);
        const float b2 = __shfl_sync(gmask, w2, owner);
        const int g = __shfl_sync(gmask, gid, owner);
        wt_take_leaf(r, tmin, row0 + jwin, g, b1, b2, -1);
    }
}

__global__ void __launch_bounds__(THREADS)
wide_traverse_joint_kernel(const float* __restrict__ o, const float* __restrict__ d,
                           const float* __restrict__ t_max, int n_rays,
                           const float* __restrict__ node_rec, const float* __restrict__ leaf_rec,
                           int any_hit,
                           float* __restrict__ out_t, int* __restrict__ out_idx,
                           float* __restrict__ out_b1, float* __restrict__ out_b2,
                           int* __restrict__ out_pops, unsigned int* __restrict__ counters,
                           unsigned long long* __restrict__ iters, int* __restrict__ queue) {
    __shared__ int stacks[GROUPS][WT_STACK];
    const int lane = threadIdx.x & 31;
    const int c = lane % GW;  // the lane's place in its group
    const int g0 = lane - c;  // the group's first lane
    const unsigned gmask = ((1u << GW) - 1u) << g0;
    int* stack = stacks[threadIdx.x / GW];
    WideRay r;
    r.sp = 0;
    int ray = -1;  // the group's ray id, -1 none
    bool drained = false;  // warp-uniform: the queue holds no ray for it
    unsigned int n_iter = 0;
    for (;;) {
        if (ray >= 0 && r.sp == 0) {  // the group's ray is done
            if (c == 0) {
                out_t[ray] = r.t_best;
                out_idx[ray] = r.best_idx;
                out_b1[ray] = r.b1;
                out_b2[ray] = r.b2;
                out_pops[ray] = r.pops;
            }
            ray = -1;
        }
        const unsigned idle = __ballot_sync(0xffffffffu, c == 0 && ray < 0);
        if (idle != 0 && !drained && (__popc(idle) >= REFILL_MIN || __popc(idle) == 32 / GW)) {
            const int id = queue_take(idle, g0, queue, n_rays, drained);
            if (ray < 0 && id < n_rays) {
                ray = id;
                wide_init(r, o[3 * id], o[3 * id + 1], o[3 * id + 2], d[3 * id], d[3 * id + 1], d[3 * id + 2],
                          t_max[id], any_hit != 0);
            }
        }
        const bool live = r.sp > 0;
        if (__ballot_sync(0xffffffffu, live) == 0) {
            if (drained && __ballot_sync(0xffffffffu, ray >= 0) == 0) break;
            continue;
        }
        ++n_iter;
        if (live) group_pop(r, stack, c, g0, gmask, node_rec, leaf_rec, counters);
    }
    queue_finish(queue, iters, n_iter);
}

// The same arguments as wide_traverse (wide_traverse.cu).
extern "C" int wide_traverse_joint(const void* o, const void* d, const void* t_max, int n_rays,
                                   const void* node_rec, const void* leaf_rec,
                                   int any_hit, void* out_t, void* out_idx, void* out_b1, void* out_b2,
                                   void* out_pops, void* counters, void* iters, void* queue, void* stream) {
    if (n_rays > 0) {
        int blocks = 0;
        const int err = wt_grid((const void*)wide_traverse_joint_kernel, THREADS, n_rays, GROUPS, &blocks);
        if (err != 0) return err;
        wide_traverse_joint_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
            (const float*)o, (const float*)d, (const float*)t_max, n_rays,
            (const float*)node_rec, (const float*)leaf_rec, any_hit,
            (float*)out_t, (int*)out_idx, (float*)out_b1, (float*)out_b2, (int*)out_pops,
            (unsigned int*)counters, (unsigned long long*)iters, (int*)queue);
    }
    return (int)cudaGetLastError();
}

// Resident blocks of THREADS threads per SM.
extern "C" int wide_traverse_joint_occupancy(int* blocks_per_sm) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, wide_traverse_joint_kernel, THREADS,
                                                              0);
}

// Lanes per ray (GW), for the groups-with-a-ray share.
extern "C" int wide_traverse_joint_group_width() { return GW; }
