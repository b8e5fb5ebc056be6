// Closest-hit / any-hit traversal of the 8-wide BVH: persistent lanes, one
// ray per lane at a time, refilled from a ray queue.
//
// Replaces pbrt_tpu/device/pallas_bvh.py _traverse_kernel_impl (the TPU
// kernel launched by pallas_bvh._run). The TPU kernel walks 256-ray packets
// over ONE shared stack, because a TPU core cannot give each lane its own
// stack or its own node loads (ROOFLINE.md section 2). A GPU thread can, so
// here every ray keeps a private stack and visits only the nodes its own
// box tests accept, in the order of its own direction signs.
//
// Bound: dependent loads. Each pop reads a node record (eight 32-byte child
// boxes, 256 contiguous bytes) or a leaf's valid rows (64 bytes each), and
// the next pop depends on the result, so the kernel is bound by load
// latency and by how many rays the SM keeps in flight, not by FLOPs or
// bytes (the 123,650-triangle room's 12 MB of tables stay in the 50 MB L2).
// What the design does about it:
//  - the Hopper layout (wide_traverse.cuh): a node's 8 children share two
//    cache lines where the TPU layout spread them over eight, and a pop
//    reads its child's meta from the parent's record, which the thread
//    loaded when it tested the parent, not from a separate table;
//  - persistent lanes: the grid is the resident blocks per SM x SMs, and
//    once REFILL_MIN lanes of a warp are done (or all of them) the warp
//    takes that many consecutive ray ids from a device counter (one
//    atomicAdd, ballot + popc), so a warp holds rays until the queue
//    drains instead of idling behind its longest walk, and its rays stay
//    neighbours in the coherence sort; lanes that start together walk the
//    top of the tree together, which a refill per finished lane loses;
//  - counters: iters gets, per warp, the loop iterations in which it
//    popped; sum(pops) / (32 x iters) is the share of lanes holding a ray.
// tools/walk_variants.py times the alternatives (a fixed grid of one
// thread per ray, other refill thresholds, ids taken in chunks, stack
// entries that carry the child metas, the top records in shared memory);
// PERF.md has the numbers.
// Results are indexed by ray id and are the per-ray walk's (wide_pop),
// whatever lane ran it. Built with -fmad=false and without fast math (see
// the header).

#include "wide_traverse.cuh"

#define THREADS 128
#define REFILL_MIN 8  // idle lanes a warp gathers before it takes rays (by measurement: PERF.md)

__global__ void __launch_bounds__(THREADS)
wide_traverse_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ t_max, int n_rays,
                     const float* __restrict__ node_rec, const float* __restrict__ leaf_rec,
                     int any_hit,
                     float* __restrict__ out_t, int* __restrict__ out_idx,
                     float* __restrict__ out_b1, float* __restrict__ out_b2,
                     int* __restrict__ out_pops, unsigned int* __restrict__ counters,
                     unsigned long long* __restrict__ iters, int* __restrict__ queue) {
    const int lane = threadIdx.x & 31;
    WideRay r;
    r.sp = 0;
    int stack[WT_STACK];
    int ray = -1;  // the lane's ray id, -1 none
    bool drained = false;  // warp-uniform: the queue holds no ray for it
    unsigned int n_iter = 0;
    for (;;) {
        if (ray >= 0 && r.sp == 0) {  // the lane's ray is done
            out_t[ray] = r.t_best;
            out_idx[ray] = r.best_idx;
            out_b1[ray] = r.b1;
            out_b2[ray] = r.b2;
            out_pops[ray] = r.pops;
            ray = -1;
        }
        const unsigned idle = __ballot_sync(0xffffffffu, ray < 0);
        if (idle != 0 && !drained && (__popc(idle) >= REFILL_MIN || idle == 0xffffffffu)) {
            const int id = queue_take(idle, lane, queue, n_rays, drained);
            if (ray < 0 && id < n_rays) {
                ray = id;
                wide_init(r, o[3 * id], o[3 * id + 1], o[3 * id + 2], d[3 * id], d[3 * id + 1], d[3 * id + 2],
                          t_max[id], any_hit != 0);
            }
        }
        const bool live = r.sp > 0;
        if (__ballot_sync(0xffffffffu, live) == 0) {
            // no lane walks: done once the queue is drained and every ray written
            if (drained && __ballot_sync(0xffffffffu, ray >= 0) == 0) break;
            continue;
        }
        ++n_iter;
        if (live) wide_pop(r, stack, node_rec, leaf_rec, counters);
    }
    queue_finish(queue, iters, n_iter);
}

// queue: two int32 on the device, zero before the launch (the last block
// zeroes them again); iters: one u64 that the launch adds its warp
// iterations to.
extern "C" int wide_traverse(const void* o, const void* d, const void* t_max, int n_rays,
                             const void* node_rec, const void* leaf_rec,
                             int any_hit, void* out_t, void* out_idx, void* out_b1, void* out_b2,
                             void* out_pops, void* counters, void* iters, void* queue, void* stream) {
    if (n_rays > 0) {
        int blocks = 0;
        const int err = wt_grid((const void*)wide_traverse_kernel, THREADS, n_rays, THREADS, &blocks);
        if (err != 0) return err;
        wide_traverse_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
            (const float*)o, (const float*)d, (const float*)t_max, n_rays,
            (const float*)node_rec, (const float*)leaf_rec, any_hit,
            (float*)out_t, (int*)out_idx, (float*)out_b1, (float*)out_b2, (int*)out_pops,
            (unsigned int*)counters, (unsigned long long*)iters, (int*)queue);
    }
    return (int)cudaGetLastError();
}

// Resident blocks of THREADS threads per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int wide_traverse_occupancy(int* blocks_per_sm) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, wide_traverse_kernel, THREADS, 0);
}
