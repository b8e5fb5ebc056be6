// Per-ray traversal of the 8-wide BVH: the device code that the standalone
// traversal kernels (wide_traverse.cu, B1; wide_traverse_joint.cu, B2) and
// the wide megakernel (megakernel_wide.cu, B4) share.
//
// A ray's whole state is a WideRay plus a private 72-entry stack, whose top
// entry the WideRay holds in a register (r.top): a pop reads it without a
// load, and the entry below is loaded only when the top is used up, while
// that pop's node loads are in flight. wide_init sets it up, wide_pop
// advances it by one pop, wide_walk pops until the stack is empty. A caller that interleaves several rays (B2) calls
// wide_pop on each in turn: a ray's pop order and arithmetic do not depend
// on what else the thread does, so its results are the same as wide_walk's.
//
// Semantics kept from the reference kernel (pbrt_tpu/device/pallas_bvh.py
// _traverse_kernel_impl):
//  - ray setup as pack_rays: 1/d and 1/d[kz] clamp at +-1e-30, kz = argmax|d|
//    (first index on ties), kx = kz+1, ky = kz+2 (mod 3), shear constants
//    sx = -d[kx]/d[kz], sy = -d[ky]/d[kz], sz = 1/d[kz];
//  - stack entry = node id << 9 | remaining child mask << 1 | dir; the root
//    sits in meta_tab[0] (sentinel parent 0, child slot 0);
//  - child meta = meta_tab[nid*8+k]: > 0 interior (id in bits 0-20, split
//    axis in bits 21-22), < 0 leaf -(octet+1), 0 empty (never pushed);
//  - box test tn <= tf*1.0000004 && tf > 0 && tn < t_best;
//  - leaf = octets o, o+1 (16 prim rows), watertight shear test, hit when
//    t > 1e-4 && t < t_best; equal t inside a leaf -> highest slot wins;
//    across leaves only a strict improvement counts; the 1e29 guard keeps
//    the 1e30 miss sentinel from ever counting as a hit;
//  - t_max <= 0 is a dead lane; any-hit returns at its first hit;
//  - at most 1,000,000 pops per ray.
// Every includer is built with -fmad=false and without fast math: the
// watertight edge functions need every multiply and add rounded on its own,
// and 1/x stays IEEE division.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define WT_STACK 72
#define WT_ITER_CAP 1000000
#define WT_EPS 1e-4f

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
    int best_row;  // float offset of the winner's prim row in prim_tab, -1 miss
    int best_mat;  // the winner's material row (prim_tab col 11), closest hit
    int pops;
    int sp;   // stack depth; 0 once the ray is finished
    int top;  // the stack's top entry; stack[0 .. sp-2] hold the rest
};

__device__ __forceinline__ void wide_init(WideRay& r, int* stack, float ox, float oy, float oz, float dx,
                                          float dy, float dz, float t_max, bool any_hit) {
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
    r.top = (0 << 9) | (1 << 1) | 0;
    r.sp = t_max > 0.0f ? 1 : 0;  // t_max <= 0 (or NaN): a dead lane
}

// One pop of a live ray (r.sp > 0). counters[0] counts stack overflows,
// counters[1] rays stopped by the iteration cap.
__device__ __forceinline__ void wide_pop(WideRay& r, int* stack, const int* __restrict__ meta_tab,
                                         const float* __restrict__ node_tab, const float* __restrict__ prim_tab,
                                         unsigned int* counters) {
    if (r.pops >= WT_ITER_CAP) {
        atomicAdd(&counters[1], 1u);
        r.sp = 0;
        return;
    }
    ++r.pops;
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
    const int e = __ldg(&meta_tab[pn * 8 + k]);

    if (e > 0) {
        // interior: test the 8 children of node nid
        const int nid = e & 0x1FFFFF;
        const int axis = e >> 21;
        const float* base = node_tab + ((size_t)(nid >> 3) * 8) * 128 + (nid & 7) * 16;
        int mask_new = 0;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const float4 a = __ldg(reinterpret_cast<const float4*>(base + c * 128));
            const float4 b = __ldg(reinterpret_cast<const float4*>(base + c * 128 + 4));
            if (b.z == 0.0f) continue;  // empty child slot (meta 0)
            const float t0x = (a.x - r.ox) * r.ix, t1x = (a.w - r.ox) * r.ix;
            const float t0y = (a.y - r.oy) * r.iy, t1y = (b.x - r.oy) * r.iy;
            const float t0z = (a.z - r.oz) * r.iz, t1z = (b.y - r.oz) * r.iz;
            const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
            const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z)) * 1.0000004f;
            if (tn <= tf && tf > 0.0f && tn < r.t_best) mask_new |= 1 << c;
        }
        if (mask_new != 0) {
            if (r.sp >= WT_STACK) {
                atomicAdd(&counters[0], 1u);
            } else {
                if (r.sp > 0) stack[r.sp - 1] = r.top;
                r.top = (nid << 9) | (mask_new << 1) | ((r.dir_bits >> axis) & 1);
                ++r.sp;
            }
        }
        return;
    }
    // leaf: octets o_, o_+1 (o_ even, so both share block rows)
    const int o_ = max(-e - 1, 0);
    float tmin = 1e30f;
    int jwin = 0, wgid = -1, wmat = -1;
    float w1 = 0.0f, w2 = 0.0f;
    int wrow = -1;
    for (int j = 0; j < 16; ++j) {
        const int oct = o_ + (j >> 3);
        const int rowoff = (int)(((oct >> 3) * 8 + (j & 7)) * 128 + (oct & 7) * 16);
        const float* row = prim_tab + rowoff;
        const float4 q0 = __ldg(reinterpret_cast<const float4*>(row));
        const float4 q1 = __ldg(reinterpret_cast<const float4*>(row + 4));
        const float4 q2 = __ldg(reinterpret_cast<const float4*>(row + 8));
        if (!(q2.y > 0.0f)) continue;  // padding row (valid = 0)
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
        if (!same || det == 0.0f) continue;
        const float inv = 1.0f / det;
        const float t = (e0 * zs[0] + e1 * zs[1] + e2 * zs[2]) * inv;
        // <= : among equal t the highest slot wins
        if (t > WT_EPS && t < r.t_best && t <= tmin) {
            tmin = t;
            jwin = j;
            w1 = e1 * inv;
            w2 = e2 * inv;
            wrow = rowoff;
            wgid = (int)q2.z;  // the row's global prim id (col 10) and material row (col 11)
            wmat = (int)q2.w;
        }
    }
    if (tmin < fminf(r.t_best, 1e29f)) {
        r.t_best = tmin;
        r.best_idx = r.any_hit ? o_ * 8 + jwin : wgid;
        r.best_mat = wmat;
        r.b1 = w1;
        r.b2 = w2;
        r.best_row = wrow;
        if (r.any_hit) r.sp = 0;
    }
}

// Pop until the stack is empty.
__device__ __forceinline__ void wide_walk(WideRay& r, int* stack, const int* __restrict__ meta_tab,
                                          const float* __restrict__ node_tab, const float* __restrict__ prim_tab,
                                          unsigned int* counters) {
    while (r.sp > 0) wide_pop(r, stack, meta_tab, node_tab, prim_tab, counters);
}
