// Per-ray traversal of the 8-wide BVH: the device code that the standalone
// traversal kernels (wide_traverse.cu, B1; wide_traverse_joint.cu, B2) and
// the wide megakernel (megakernel_wide.cu, B4) share.
//
// Tables: the Hopper layout of the reference's tree (scene/widebvh.py
// hopper_layout). node_rec holds one 256-byte record per wide node, its 8
// children one after another, 8 floats each: lo xyz, hi xyz, meta (int32
// bits), axis. leaf_rec holds 16-float rows, row s = the reference's kernel
// slot s = oct * 8 + j, so leaf L's rows in the reference's order j are the
// 1,024 contiguous bytes from row 16L, its valid rows first.
//
// A ray's whole state is a WideRay plus a private 72-entry stack, whose top
// entry the WideRay holds in a register (r.top): a pop reads it without a
// load, and the entry below is loaded only when the top is used up, while
// that pop's node loads are in flight. An entry is (node, the mask of its
// hit children not yet popped, direction); a pop takes the child's meta
// from the node's record, which the thread loaded when it tested that node
// and which is in L1. wide_init sets a ray up, wide_pop advances it by one
// pop, wide_walk pops until the stack is empty; wt_pop_meta, wt_push,
// wt_box and wt_tri are its steps, which B2's cooperative walk takes lane
// by lane.
//
// Semantics kept from the reference kernel (pbrt_tpu/device/pallas_bvh.py
// _traverse_kernel_impl):
//  - ray setup as pack_rays: 1/d and 1/d[kz] clamp at +-1e-30, kz = argmax|d|
//    (first index on ties), kx = kz+1, ky = kz+2 (mod 3), shear constants
//    sx = -d[kx]/d[kz], sy = -d[ky]/d[kz], sz = 1/d[kz];
//  - stack entry = node id << 9 | remaining child mask << 1 | dir; a node's
//    hit children pop lowest slot first, or highest first (dir) when the
//    ray's direction along the node's split axis is negative; the root
//    sits in record 0, child 0 (sentinel parent 0, as the reference's
//    meta_tab[0]);
//  - child meta: > 0 interior (id in bits 0-20, split axis in bits 21-22),
//    < 0 leaf ~(L << 4 | n - 1) (leaf L = octets 2L, 2L+1, n valid rows),
//    0 empty (NaN box, never pushed);
//  - box test tn <= tf*1.0000004 && tf > 0 && tn < t_best;
//  - leaf: the n valid rows j, watertight shear test, hit when
//    t > 1e-4 && t < t_best; equal t inside a leaf -> highest j wins;
//    across leaves only a strict improvement counts; the 1e29 guard keeps
//    the 1e30 miss sentinel from ever counting as a hit; any hit returns
//    slot 16L + j (= oct * 8 + j), closest hit the row's global prim;
//  - t_max <= 0 is a dead lane; any-hit returns at its first hit;
//  - at most 1,000,000 pops per ray; a push onto a full stack (72 entries)
//    is dropped and counted.
// Every includer is built with -fmad=false and without fast math: the
// watertight edge functions need every multiply and add rounded on its own,
// and 1/x stays IEEE division.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define WT_STACK 72
#define WT_ITER_CAP 1000000
#define WT_EPS 1e-4f
#define WT_NODE_REC 64  // floats per node record
#define WT_ROW 16       // floats per leaf row

__device__ __forceinline__ float wt_clamp_tiny(float x) {
    return fabsf(x) < 1e-30f ? (x < 0.0f ? -1e-30f : 1e-30f) : x;
}

struct WideRay {
    float ox, oy, oz;
    float ix, iy, iz;  // 1/d, clamped
    float sx, sy, sz;  // watertight shear constants
    int kz, dir_bits;
    bool any_hit;
    float t_best;
    int best_idx;  // closest hit: global prim row; any hit: kernel slot; -1 miss
    float b1, b2;
    int best_row;  // float offset of the winner's row in leaf_rec, -1 miss
    int best_mat;  // the winner's material row (row col 11), closest hit
    int pops;
    int sp;   // stack depth; 0 once the ray is finished
    int top;  // the stack's top entry; stack[0 .. sp-2] hold the rest
};

__device__ __forceinline__ void wide_init(WideRay& r, float ox, float oy, float oz, float dx, float dy, float dz,
                                          float t_max, bool any_hit) {
    r.ox = ox;
    r.oy = oy;
    r.oz = oz;
    r.ix = 1.0f / wt_clamp_tiny(dx);
    r.iy = 1.0f / wt_clamp_tiny(dy);
    r.iz = 1.0f / wt_clamp_tiny(dz);
    const float adx = fabsf(dx), ady = fabsf(dy), adz = fabsf(dz);
    int kz = 0;
    if (ady > adx) kz = 1;
    if (adz > (kz == 0 ? adx : ady)) kz = 2;
    const float dkx = kz == 0 ? dy : (kz == 1 ? dz : dx);
    const float dky = kz == 0 ? dz : (kz == 1 ? dx : dy);
    const float dkz = kz == 0 ? dx : (kz == 1 ? dy : dz);
    const float inv_dkz = 1.0f / wt_clamp_tiny(dkz);
    r.sx = -dkx * inv_dkz;
    r.sy = -dky * inv_dkz;
    r.sz = inv_dkz;
    r.kz = kz;
    // child order per split axis: negative direction walks highest-first
    r.dir_bits = (dx < 0.0f ? 1 : 0) | (dy < 0.0f ? 2 : 0) | (dz < 0.0f ? 4 : 0);
    r.any_hit = any_hit;
    r.t_best = t_max;
    r.best_idx = -1;
    r.b1 = 0.0f;
    r.b2 = 0.0f;
    r.best_row = -1;
    r.best_mat = -1;
    r.pops = 0;
    r.top = (0 << 9) | (1 << 1) | 0;  // sentinel parent 0, child 0 = the root
    r.sp = t_max > 0.0f ? 1 : 0;  // t_max <= 0 (or NaN): a dead lane
}

// The slab test of one child (a = lo xyz, hi x; b = hi yz, meta, axis).
__device__ __forceinline__ bool wt_box(const WideRay& r, float4 a, float4 b) {
    const float t0x = (a.x - r.ox) * r.ix, t1x = (a.w - r.ox) * r.ix;
    const float t0y = (a.y - r.oy) * r.iy, t1y = (b.x - r.oy) * r.iy;
    const float t0z = (a.z - r.oz) * r.iz, t1z = (b.y - r.oz) * r.iz;
    const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z)) * 1.0000004f;
    return tn <= tf && tf > 0.0f && tn < r.t_best;
}

// The watertight test of one row (q0, q1, q2 = its floats 0-11). Returns
// true, with t and the barycentrics, when the ray hits the triangle at
// 1e-4 < t < t_best.
__device__ __forceinline__ bool wt_tri(const WideRay& r, float4 q0, float4 q1, float4 q2, float& t, float& w1,
                                       float& w2) {
    const float v[9] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x};
    float xs[3], ys[3], zs[3];
#pragma unroll
    for (int vi = 0; vi < 3; ++vi) {
        const float vx = v[3 * vi] - r.ox, vy = v[3 * vi + 1] - r.oy, vz = v[3 * vi + 2] - r.oz;
        const float px = r.kz == 0 ? vy : (r.kz == 1 ? vz : vx);
        const float py = r.kz == 0 ? vz : (r.kz == 1 ? vx : vy);
        const float pz = r.kz == 0 ? vx : (r.kz == 1 ? vy : vz);
        xs[vi] = px + r.sx * pz;
        ys[vi] = py + r.sy * pz;
        zs[vi] = r.sz * pz;
    }
    const float e0 = xs[1] * ys[2] - ys[1] * xs[2];
    const float e1 = xs[2] * ys[0] - ys[2] * xs[0];
    const float e2 = xs[0] * ys[1] - ys[0] * xs[1];
    const bool same = (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) || (e0 <= 0.0f && e1 <= 0.0f && e2 <= 0.0f);
    const float det = e0 + e1 + e2;
    if (!same || det == 0.0f) return false;
    const float inv = 1.0f / det;
    t = (e0 * zs[0] + e1 * zs[1] + e2 * zs[2]) * inv;
    w1 = e1 * inv;
    w2 = e2 * inv;
    return t > WT_EPS && t < r.t_best;
}

// The leaf of a meta e < 0: (first row, count of valid rows).
__device__ __forceinline__ int wt_leaf_row0(int e) { return ((~e) >> 4) << 4; }
__device__ __forceinline__ int wt_leaf_n(int e) { return ((~e) & 15) + 1; }

// A leaf's winner (t, global prim id or slot, barycentrics, row, material)
// becomes the ray's hit when it improves on t_best.
__device__ __forceinline__ void wt_take_leaf(WideRay& r, float tmin, int slot, int gid, float w1, float w2,
                                             int mat) {
    if (tmin < fminf(r.t_best, 1e29f)) {
        r.t_best = tmin;
        r.best_idx = r.any_hit ? slot : gid;
        r.best_mat = mat;
        r.b1 = w1;
        r.b2 = w2;
        r.best_row = slot * WT_ROW;
        if (r.any_hit) r.sp = 0;
    }
}

// Takes the next child of the top entry and returns its meta, read from
// the parent's record; moves the top down when its mask is used up.
__device__ __forceinline__ int wt_pop_meta(WideRay& r, const int* stack, const float* __restrict__ node_rec) {
    const int top = r.top;
    const int dirb = top & 1;
    const int m = (top >> 1) & 255;
    const int pn = top >> 9;
    const int k = dirb ? 31 - __clz(m) : __ffs(m) - 1;
    const int m2 = m & ~(1 << k);
    if (m2 == 0) {
        --r.sp;
        if (r.sp > 0) r.top = stack[r.sp - 1];
    } else {
        r.top = (pn << 9) | (m2 << 1) | dirb;
    }
    return __float_as_int(__ldg(node_rec + (size_t)pn * WT_NODE_REC + k * 8 + 6));
}

// Pushes node e's hit-child mask (mask != 0) as the new top; `store`: this
// thread writes the entry that moves down (B2: one lane of the group).
__device__ __forceinline__ void wt_push(WideRay& r, int* stack, int e, int mask, bool store,
                                        unsigned int* counters) {
    if (r.sp >= WT_STACK) {
        if (store) atomicAdd(&counters[0], 1u);
        return;
    }
    if (r.sp > 0 && store) stack[r.sp - 1] = r.top;
    r.top = ((e & 0x1FFFFF) << 9) | (mask << 1) | ((r.dir_bits >> (e >> 21)) & 1);
    ++r.sp;
}

// One pop of a live ray (r.sp > 0). counters[0] counts stack overflows,
// counters[1] rays stopped by the iteration cap.
__device__ __forceinline__ void wide_pop(WideRay& r, int* stack, const float* __restrict__ node_rec,
                                         const float* __restrict__ leaf_rec, unsigned int* counters) {
    if (r.pops >= WT_ITER_CAP) {
        atomicAdd(&counters[1], 1u);
        r.sp = 0;
        return;
    }
    ++r.pops;
    const int e = wt_pop_meta(r, stack, node_rec);

    if (e > 0) {
        // interior: test the 8 children of node e (two 128-byte lines)
        const float4* rec = reinterpret_cast<const float4*>(node_rec + (size_t)(e & 0x1FFFFF) * WT_NODE_REC);
        int mask = 0;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const float4 a = __ldg(rec + 2 * c);
            const float4 b = __ldg(rec + 2 * c + 1);
            if (__float_as_int(b.z) != 0 && wt_box(r, a, b)) mask |= 1 << c;  // meta 0: an empty slot
        }
        if (mask != 0) wt_push(r, stack, e, mask, true, counters);
        return;
    }
    // leaf: its n valid rows, in order j
    const int row0 = wt_leaf_row0(e), n = wt_leaf_n(e);
    float tmin = 1e30f, w1 = 0.0f, w2 = 0.0f;
    int jwin = 0, wgid = -1, wmat = -1;
    for (int j = 0; j < n; ++j) {
        const float4* row = reinterpret_cast<const float4*>(leaf_rec + (size_t)(row0 + j) * WT_ROW);
        const float4 q2 = __ldg(row + 2);
        float t, b1, b2;
        // <= : among equal t the highest j wins
        if (wt_tri(r, __ldg(row), __ldg(row + 1), q2, t, b1, b2) && t <= tmin) {
            tmin = t;
            jwin = j;
            w1 = b1;
            w2 = b2;
            wgid = (int)q2.z;  // the row's global prim id (col 10) and material row (col 11)
            wmat = (int)q2.w;
        }
    }
    wt_take_leaf(r, tmin, row0 + jwin, wgid, w1, w2, wmat);
}

// Pop until the stack is empty.
__device__ __forceinline__ void wide_walk(WideRay& r, int* stack, const float* __restrict__ node_rec,
                                          const float* __restrict__ leaf_rec, unsigned int* counters) {
    while (r.sp > 0) wide_pop(r, stack, node_rec, leaf_rec, counters);
}

// --- the ray queue of the standalone kernels (B1, B2) ---------------------------
// A launch's rays are handed out from one device counter (queue[0]; queue[1]
// counts finished blocks, and the last block to finish zeroes both, so the
// next launch on the stream starts from 0 without a memset). When enough
// workers of a warp (lanes in B1, lane groups in B2; each kernel's
// REFILL_MIN) are idle, the warp takes that many consecutive ids with one
// atomicAdd and hands them out in worker order, so a warp walks
// neighbouring rays of the coherence sort's order.

// Called by the whole warp (converged) with idle = one bit per idle worker,
// at that worker's first lane; returns the id of the worker whose bit is
// `me` (meaningful only when that bit is set; >= n_rays: no ray), and sets
// drained once the queue holds no id below n_rays.
__device__ __forceinline__ int queue_take(unsigned idle, int me, int* queue, int n_rays, bool& drained) {
    const int need = __popc(idle);
    int base = 0;
    if ((threadIdx.x & 31) == 0) base = atomicAdd(&queue[0], need);
    base = __shfl_sync(0xffffffffu, base, 0);
    drained = base + need >= n_rays;
    return base + __popc(idle & ((1u << me) - 1u));
}

// End of a block: its warps' iteration counts into iters, and the last
// block of the grid zeroes the queue. Called by every thread of the block.
__device__ __forceinline__ void queue_finish(int* queue, unsigned long long* iters, unsigned int my_iters) {
    if ((threadIdx.x & 31) == 0 && my_iters) atomicAdd(iters, (unsigned long long)my_iters);
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        if (atomicAdd(reinterpret_cast<unsigned int*>(&queue[1]), 1u) == gridDim.x - 1) {
            queue[0] = 0;
            queue[1] = 0;
            __threadfence();
        }
    }
}

// Grid of a persistent launch: resident blocks per SM x SMs, at most the
// blocks the rays fill at `rays_per_block`. Returns a cudaError_t.
__host__ static inline int wt_grid(const void* kern, int threads, int n_rays, int rays_per_block, int* blocks) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, 0);
    if (e != cudaSuccess) return (int)e;
    const long long fill = ((long long)n_rays + rays_per_block - 1) / rays_per_block;
    const long long grid = (long long)per_sm * sms;
    *blocks = (int)(fill < grid ? fill : grid);
    return *blocks > 0 ? (int)cudaSuccess : (int)cudaErrorInvalidConfiguration;
}
