// Wide persistent path-tracing megakernel: the whole path loop, with the
// closest-hit and shadow traversals of the 8-wide BVH inside the kernel.
//
// Replaces pbrt_tpu/device/megakernel_wide.py _build_kernel (the TPU kernel
// that make_wide_megakernel_fn launches through pl.pallas_call, opt-in with
// PBRT_TPU_WIDEMEGA=1). For triangle scenes with the wide-BVH tables, flat
// shading and default UVs, constant-parameter materials of the six baked
// lobe classes (at most 16), at most 8 lights (one- or two-sided triangle
// area lights, point, spot, distant), the (0,2), random and stratified
// samplers, pinhole or thin-lens perspective cameras and the box filter,
// every bounce runs here: closest hit, area-light emission with deferred
// MIS, BSDF sampling, NEE with MIS and an any-hit shadow walk, Russian
// roulette, the sample flush and camera regeneration. The estimator is the
// reference's, term for term; the plain PyTorch twin is
// device/megakernel_wide.py wide_megakernel_plain.
//
// What bounds it on Hopper, and what the design does about it:
//  - The walks are chains of dependent loads (a node record's eight child
//    boxes -> the next record, wide_traverse.cuh), so the kernel runs at the rate at
//    which the SM hides load latency, which is set by the rays in flight:
//    resident warps times the lanes that have a ray. A thread that carries a
//    whole path through both walks holds ~128 registers (4 blocks of 128
//    threads per SM); the walk alone needs ~40. So a path is not a thread
//    here: each block keeps THREADS path slots as a structure of arrays in
//    shared memory (the F_* fields below, 47 words a slot, beside the
//    832-float blob), and each phase loads only the fields it needs. Across
//    a walk only the WideRay and its stack are live, and
//    __launch_bounds__(THREADS, MIN_BLOCKS) holds the kernel to the 64
//    registers at which MIN_BLOCKS = 8 blocks (32 warps) are resident.
//  - A block iteration runs in phases with __syncthreads() between them:
//    (1) one pool of walks: the closest ray of every slot that holds a
//    pixel and the any-hit shadow ray of every slot whose last NEE sample
//    contributes; a thread whose ray is done takes the next item, so lanes
//    stay busy until the pool drains (a walk's length varies several-fold
//    from ray to ray); the closest walk also classifies its hit (miss,
//    emission only, or one of the six lobe classes); (2) a block-wide
//    counting sort of the hits by class into a permutation; (3) emission,
//    bsdf_sample and the NEE light sample in sorted order, so that a warp
//    shades one or two classes, queueing the shadow ray for the next pool;
//    (4) flush and regeneration, slot by slot.
//  - With one thread per pixel for all its samples, a lane whose pixel is
//    done idles until its block's slowest pixel is. Here the grid is
//    persistent (the occupancy query's blocks per SM x SMs), and a slot
//    whose pixel has run all n_samples takes the next pixel from a device
//    counter (queue, zeroed by the wrapper), so slots idle only in the
//    grid's tail, and for one iteration when a pixel's last sample still
//    waits for its shadow ray: an earlier finished sample waits in F_LOLD
//    while the next one walks.
// Registers, resident blocks, the cycle split of the PROF instantiation
// and the time per pop are in PERF.md.
//
// Results: a sample's stream is a pure function of (pixel, sample,
// dimension), so which thread walks or shades a path, and when, does not
// change what it draws. Each pixel's samples run one after another in one
// slot, so its radiance, weight and vertex count are summed in sample order
// and written once, with no atomics on the image; each path's arithmetic is
// the per-lane loop's, in the same order: the NEE term is added to the
// sample's radiance when its shadow ray has been walked, in the next pool,
// from the beta it was computed with and before the next vertex's
// emission, and a sample is flushed, or its pixel finished, only after
// that.
//
// Data: the traversal returns the winner's row of the leaf rows leaf_rec
// (vertices, material row, light row and flags; the Hopper layout of
// wide_traverse.cuh), read again when the hit is shaded; lights, materials
// and camera are one float blob (device/megakernel_wide.py
// pack_wide_consts, offsets below) in shared memory; node records and leaf
// rows are read with __ldg (the 123,650-triangle room's 12 MB stay in the
// 50 MB L2); sampler kind and whether the scene has area lights are
// template parameters.
//
// Counters: each warp adds its threads' closest-hit and shadow pops to
// pop_counts[0] and [1] (one atomic per warp at the end); stack overflows
// and iteration-cap hits go to trav_counters[0] and [1] as in B1. The PROF
// instantiation also sums a clock64() cycle split (SPLIT_* below).
//
// Built with -fmad=false and without fast math (pt_common.cuh).

#include "pt_common.cuh"
#include "wide_traverse.cuh"

// --- the constant blob (keep in lockstep with device/megakernel_wide.py) -----
#define H_N_LIGHTS 0
#define H_N_MATS 1
#define H_MAX_DEPTH 2
#define H_RR 3
#define H_UNIFORM 4
#define H_SAMPLER 5
#define H_STRAT_XS 6
#define H_STRAT_YS 7
#define H_WR2 8
#define H_FXW 9
#define H_FYW 10
#define H_MAX_LUM 11
#define H_G7 12
#define H_LENS_R 13
#define H_FOCAL 14  // 15 unused
#define H_R2C 16  // 16 floats, row-major 4x4 raster -> camera
#define H_C2W 32  // 12 floats, row-major 3x4 camera -> world
#define H_CDF 44  // MAX_LIGHTS floats
#define H_PMF 52  // MAX_LIGHTS floats
#define HEADER 64
#define MAX_LIGHTS 8
#define LIGHT_STRIDE 32
#define LIGHT_BASE HEADER
#define MAX_MATS 16
#define MAT_STRIDE 32
#define MAT_BASE (LIGHT_BASE + MAX_LIGHTS * LIGHT_STRIDE)
#define BLOB_FLOATS (MAT_BASE + MAX_MATS * MAT_STRIDE)

// light record: L_KIND, L_PAR, L_SPOT_DEN (pt_common.cuh), then for a
// triangle area light its area, two-sidedness, vertices and normal
#define L_AREA 14
#define L_TWO_SIDED 15
#define L_V 16
#define L_NG 25
#define LIGHT_AREA 4

// material record: the M_* fields of pt_common.cuh, plus the material-table
// row the slot bakes (the leaf rows' payload names rows, not slots)
#define M_ROW 31

// --- the block: THREADS path slots, one per thread ------------------------------
#define THREADS 128
#define MIN_BLOCKS 8  // resident blocks per SM that __launch_bounds__ asks for (8 beat 7 and 6, PERF.md)

// class keys of the counting sort: a miss, a hit that takes no BSDF sample
// (depth cap, no material or LOBE_NONE), or K_LOBE + one of six lobe classes
#define K_MISS 0
#define K_EMIT 1
#define K_LOBE 2
#define N_KEYS 8

// F_KEY: after the walk, kpos << 4 | class key (>= 0, kpos = the hit's rank
// in its class); after shading, one of the S_* states; a slot that waits
// for its shadow ray before it may finish its pixel carries S_WAIT_*
#define S_ALIVE (-1)       // the path goes on
#define S_ALIVE_SH (-2)    // ... and its NEE shadow ray is queued
#define S_DEAD (-3)        // the sample is finished
#define S_DEAD_SH (-4)     // ... once its queued shadow ray is walked
#define S_WAIT_FLUSH (-5)  // flush the pixel's last sample now: its shadow ray was walked
#define S_WAIT_CAP (-6)    // finish the pixel now (iteration cap): its shadow ray was walked

// slot fields, one 32-bit word each; field f of slot i is st[f * THREADS + i]
#define F_LANE 0    // pixel (lane index), -1 for an empty slot
#define F_S 1       // current sample index
#define F_IT 2      // loop iterations spent on the pixel (the reference's cap) | IT_OLD
#define F_O 3       // ray origin (3)
#define F_D 6       // ray direction (3)
#define F_L 9       // the sample's radiance (3)
#define F_BETA 12   // path throughput (3)
#define F_ETA 15    // accumulated eta scale
#define F_BOUNCES 16  // bounces | SPECULAR when the previous vertex's BSDF sample was specular
#define F_PPDF 17   // ... and its pdf
#define F_PP 18     // the previous vertex (3)
#define F_AL 21     // the pixel's sum of flushed radiance (3)
#define F_AW 24     // ... of weights
#define F_NV 25     // ... of path vertices
#define F_KEY 26
#define F_ROW 27    // the hit: float offset of the winner's row in leaf_rec
#define F_B1 28
#define F_B2 29
#define F_SO 30     // the queued shadow ray: origin (3)
#define F_SD 33     // ... direction (3)
#define F_TMAX 36
#define F_SBETA 37  // beta before the BSDF sample (3)
#define F_SC 40     // the unoccluded NEE contribution without beta (3)
#define F_LOLD 43   // a finished sample's radiance, flushed once its shadow ray is walked (3)
#define F_HB 46     // the pixel's hash base
#define N_FIELDS 47
#define IT_OLD (1 << 30)    // F_LOLD holds a sample, and the queued shadow ray adds to it
#define SPECULAR (1 << 30)  // in F_BOUNCES

// The PROF instantiation's record, u64 (device/megakernel_wide.py
// SPLIT_FIELDS): lane-cycles of the slots whose path walked, in each phase
// (walk pool, sort + shading + NEE, flush/regen); of slots that only waited
// for their shadow ray; of empty slots (the grid's tail); of the whole
// launch; all lanes of the walk phase; lane-cycles in which a thread had
// walk or shading work; block iterations. Phase times are thread 0's
// clock64() between barriers.
#define SPLIT_WALK 0
#define SPLIT_SHADE 1
#define SPLIT_FLUSH 2
#define SPLIT_WAIT 3
#define SPLIT_IDLE 4
#define SPLIT_TOTAL 5
#define SPLIT_WALK_LANES 6
#define SPLIT_WALK_BUSY 7
#define SPLIT_SHADE_BUSY 8
#define SPLIT_ITERS 9
#define N_SPLIT 10

struct BlockState {
    float blob[BLOB_FLOATS];
    float st[N_FIELDS * THREADS];
    uint8_t wlist[THREADS];   // slots whose path walks next, compacted
    uint8_t sperm[THREADS];   // hits sorted by class key
    uint8_t shlist[THREADS];  // slots with a queued shadow ray, compacted
    int cnt[N_KEYS];
    int n_walk, n_sh;
    int pool_next;        // the next walk item to hand out
    int n_wait;           // PROF: slots waiting for their shadow ray
};

__device__ __forceinline__ float& fld(float* st, int f, int i) { return st[f * THREADS + i]; }
__device__ __forceinline__ int geti(const float* st, int f, int i) { return __float_as_int(st[f * THREADS + i]); }
__device__ __forceinline__ void seti(float* st, int f, int i, int v) { st[f * THREADS + i] = __int_as_float(v); }

__device__ __forceinline__ float power_heuristic(float f, float g) {
    const float f2 = f * f, g2 = g * g;
    return f > 0.0f ? f2 / fmaxf(f2 + g2, 1e-30f) : 0.0f;
}

__device__ __forceinline__ int lobe_key(int lobe) {
    switch (lobe) {
        case LOBE_LAMBERT_R: return K_LOBE + 0;
        case LOBE_PLASTIC: return K_LOBE + 1;
        case LOBE_OREN_NAYAR: return K_LOBE + 2;
        case LOBE_MICRO_R: return K_LOBE + 3;
        case LOBE_SPEC_R: return K_LOBE + 4;
        default: return K_LOBE + 5;  // LOBE_FRESNEL_SPEC
    }
}

// Warp-aggregated counter: every thread of the warp calls it; a thread with
// want set gets *n's value plus its rank among the wanting lanes (in lane
// order), and *n grows by their number; the others get -1.
__device__ __forceinline__ int warp_take(bool want, int* n) {
    const unsigned mask = __ballot_sync(0xffffffffu, want);
    if (mask == 0u) return -1;
    const int lid = threadIdx.x & 31;
    const int leader = __ffs(mask) - 1;
    int base = 0;
    if (lid == leader) base = atomicAdd(n, __popc(mask));
    base = __shfl_sync(0xffffffffu, base, leader);
    return want ? base + __popc(mask & ((1u << lid) - 1u)) : -1;
}

// camera regeneration of sample s into slot i, with the path state reset
template <int SAMPLER>
__device__ __forceinline__ void start_sample(float* st, int i, const float* blob, float pxf, float pyf,
                                             uint32_t hbase, uint32_t s) {
    float ox, oy, oz, dx, dy, dz;
    regen<SAMPLER>(blob + H_R2C, blob + H_C2W, blob[H_FXW], blob[H_FYW], (int)blob[H_STRAT_XS],
                   (int)blob[H_STRAT_YS], blob[H_LENS_R], blob[H_FOCAL], hbase, pxf, pyf, s, ox, oy, oz, dx, dy,
                   dz);
    seti(st, F_S, i, (int)s);
    fld(st, F_O, i) = ox;
    fld(st, F_O + 1, i) = oy;
    fld(st, F_O + 2, i) = oz;
    fld(st, F_D, i) = dx;
    fld(st, F_D + 1, i) = dy;
    fld(st, F_D + 2, i) = dz;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        fld(st, F_L + k, i) = 0.0f;
        fld(st, F_BETA + k, i) = 1.0f;
    }
    fld(st, F_ETA, i) = 1.0f;
    seti(st, F_BOUNCES, i, SPECULAR);
    fld(st, F_PPDF, i) = 1.0f;
    fld(st, F_PP, i) = ox;
    fld(st, F_PP + 1, i) = oy;
    fld(st, F_PP + 2, i) = oz;
}

// slot i takes pixel `lane`: sample s0, empty sums
template <int SAMPLER>
__device__ __forceinline__ void start_pixel(float* st, int i, const float* blob, const int* __restrict__ px_in,
                                            const int* __restrict__ py_in, const int* __restrict__ pid_in,
                                            uint32_t hseed, uint32_t s0, int lane) {
    const uint32_t hbase = pcg(hseed ^ (uint32_t)pid_in[lane]);
    seti(st, F_LANE, i, lane);
    seti(st, F_HB, i, (int)hbase);
    seti(st, F_IT, i, 0);
#pragma unroll
    for (int k = 0; k < 3; ++k) fld(st, F_AL + k, i) = 0.0f;
    fld(st, F_AW, i) = 0.0f;
    fld(st, F_NV, i) = 0.0f;
    start_sample<SAMPLER>(st, i, blob, (float)px_in[lane], (float)py_in[lane], hbase, s0);
}

// surface_interaction's triangle branch for flat shading and default UVs
// (uv0 = (0,0), uv1 = (1,0), uv2 = (1,1), so dpdu = v1 - v0), from the
// winner's prim row; returns the row's light (-1 when it emits nothing)
__device__ __forceinline__ int tri_attrs(const float* __restrict__ row, float b1, float b2, float g7, Hit& h) {
    const float4 q0 = __ldg(reinterpret_cast<const float4*>(row));
    const float4 q1 = __ldg(reinterpret_cast<const float4*>(row + 4));
    const float4 q2 = __ldg(reinterpret_cast<const float4*>(row + 8));
    const float4 q3 = __ldg(reinterpret_cast<const float4*>(row + 12));
    const float v0x = q0.x, v0y = q0.y, v0z = q0.z;
    const float v1x = q0.w, v1y = q1.x, v1z = q1.y;
    const float v2x = q1.z, v2y = q1.w, v2z = q2.x;
    const float b0 = 1.0f - b1 - b2;
    const float e1x = v1x - v0x, e1y = v1y - v0y, e1z = v1z - v0z;
    const float e2x = v2x - v0x, e2y = v2y - v0y, e2z = v2z - v0z;
    float ngx = e1y * e2z - e1z * e2y;
    float ngy = e1z * e2x - e1x * e2z;
    float ngz = e1x * e2y - e1y * e2x;
    norm3(ngx, ngy, ngz);
    if ((int)q3.y & FLAG_FLIP_GEOM_N) {
        ngx = -ngx;
        ngy = -ngy;
        ngz = -ngz;
    }
    // frame from dpdu = e1 orthogonalised against ns = ng; coordinate_system
    // fallback when degenerate
    const float d_dot = ngx * e1x + ngy * e1y + ngz * e1z;
    float ssx = e1x - ngx * d_dot, ssy = e1y - ngy * d_dot, ssz = e1z - ngz * d_dot;
    const float sl = sqrtf(ssx * ssx + ssy * ssy + ssz * ssz);
    if (sl > 1e-9f) {
        const float inv_sl = 1.0f / fmaxf(sl, 1e-20f);
        ssx = ssx * inv_sl;
        ssy = ssy * inv_sl;
        ssz = ssz * inv_sl;
    } else {
        const float csg = ngz >= 0.0f ? 1.0f : -1.0f;
        const float a = -1.0f / (csg + ngz);
        const float bb = ngx * ngy * a;
        ssx = 1.0f + csg * ngx * ngx * a;
        ssy = csg * bb;
        ssz = -csg * ngx;
    }
    h.ngx = ngx; h.ngy = ngy; h.ngz = ngz;
    h.nsx = ngx; h.nsy = ngy; h.nsz = ngz;
    h.ssx = ssx; h.ssy = ssy; h.ssz = ssz;
    h.tsx = ngy * ssz - ngz * ssy;
    h.tsy = ngz * ssx - ngx * ssz;
    h.tsz = ngx * ssy - ngy * ssx;
    h.px = b0 * v0x + b1 * v1x + b2 * v2x;
    h.py = b0 * v0y + b1 * v1y + b2 * v2y;
    h.pz = b0 * v0z + b1 * v1z + b2 * v2z;
    h.ex = g7 * (fabsf(b0 * v0x) + fabsf(b1 * v1x) + fabsf(b2 * v2x));
    h.ey = g7 * (fabsf(b0 * v0y) + fabsf(b1 * v1y) + fabsf(b2 * v2y));
    h.ez = g7 * (fabsf(b0 * v0z) + fabsf(b1 * v1z) + fabsf(b2 * v2z));
    h.mat = (int)q2.w;
    return (int)q3.x;
}

// estimate_direct for one selected light, delta or triangle area, with MIS
// against the BSDF's pdf, up to the shadow walk: returns whether the sample
// can contribute, and then the shadow ray and the unoccluded contribution
// without beta, c
template <int SAMPLER>
__device__ __forceinline__ bool nee_light(const float* blob, const float* m, uint32_t hbase, uint32_t s,
                                          uint32_t dim_base, const Hit& h, float wox, float woy, float woz,
                                          float c[3], float so[3], float sd[3], float& tmax) {
    const int n_lights = (int)blob[H_N_LIGHTS];
    int lid = 0;
    if (n_lights > 1) {
        lid = select_light(sample_1d<SAMPLER>(hbase, s, dim_base), n_lights, blob[H_UNIFORM] != 0.0f, blob + H_CDF);
    }
    const float* lt = blob + LIGHT_BASE + lid * LIGHT_STRIDE;
    float wix, wiy, wiz, li[3], dist, p_l = 1.0f;
    const bool delta = (int)lt[L_KIND] != LIGHT_AREA;
    if (delta) {
        delta_light(lt, blob[H_WR2], h, wix, wiy, wiz, li, dist);
    } else {
        // uniform point on the emitting triangle (lights._sample_prim_point)
        float u1, u2;
        sample_2d<SAMPLER>(hbase, s, dim_base + 1u, u1, u2);
        const float su0 = sqrtf(fmaxf(u1, 0.0f));
        const float b0s = 1.0f - su0;
        const float b1s = u2 * su0;
        const float b2s = 1.0f - b0s - b1s;
        const float* v = lt + L_V;
        const float psx = b0s * v[0] + b1s * v[3] + b2s * v[6];
        const float psy = b0s * v[1] + b1s * v[4] + b2s * v[7];
        const float psz = b0s * v[2] + b1s * v[5] + b2s * v[8];
        const float tx = psx - h.px, ty = psy - h.py, tz = psz - h.pz;
        const float d2 = fmaxf(tx * tx + ty * ty + tz * tz, 1e-12f);
        const float dl = sqrtf(d2);
        const float invl = 1.0f / dl;
        wix = tx * invl;
        wiy = ty * invl;
        wiz = tz * invl;
        const float* ng = lt + L_NG;
        const float cos_l = -(wix * ng[0] + wiy * ng[1] + wiz * ng[2]);
        const bool emits = cos_l > 0.0f || lt[L_TWO_SIDED] != 0.0f;
        const float pdf_a = d2 / fmaxf(fabsf(cos_l) * lt[L_AREA], 1e-12f);
        p_l = fabsf(cos_l) > 1e-7f ? pdf_a : 0.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) li[k] = emits ? lt[L_PAR + k] : 0.0f;
        dist = dl;
    }
    const float spdf = blob[H_PMF + lid];

    const int lobe = (int)m[M_LOBE];
    const bool lam = lobe == LOBE_LAMBERT_R || lobe == LOBE_PLASTIC;
    const bool on = lobe == LOBE_OREN_NAYAR;
    const bool mic = lobe == LOBE_MICRO_R || lobe == LOBE_PLASTIC;
    const bool refl = dot3(wix, wiy, wiz, h.ngx, h.ngy, h.ngz) * dot3(wox, woy, woz, h.ngx, h.ngy, h.ngz) > 0.0f;
    const float cos_ns = fabsf(dot3(wix, wiy, wiz, h.nsx, h.nsy, h.nsz));
    float f[3] = {0.0f, 0.0f, 0.0f};
    if (lam && refl) {
#pragma unroll
        for (int k = 0; k < 3; ++k) f[k] = m[M_COLOR + k] * INV_PI_F * cos_ns;
    }
    // the BSDF's pdf toward wi (specular lobes contribute 0)
    const float wi_z = dot3(wix, wiy, wiz, h.nsx, h.nsy, h.nsz);
    const float wo_z = dot3(wox, woy, woz, h.nsx, h.nsy, h.nsz);
    float p_b = (lam || on) && wi_z * wo_z > 0.0f ? fabsf(wi_z) * INV_PI_F : 0.0f;
    if (on || mic) {
        const float wo_x = dot3(wox, woy, woz, h.ssx, h.ssy, h.ssz);
        const float wo_y = dot3(wox, woy, woz, h.tsx, h.tsy, h.tsz);
        const float wi_x = dot3(wix, wiy, wiz, h.ssx, h.ssy, h.ssz);
        const float wi_y = dot3(wix, wiy, wiz, h.tsx, h.tsy, h.tsz);
        if (on && refl) {
            const float onf = on_factor(m, wo_x, wo_y, wo_z, wi_x, wi_y, wi_z);
#pragma unroll
            for (int k = 0; k < 3; ++k) f[k] = m[M_COLOR + k] * onf * cos_ns;
        }
        if (mic) {
            float fm[3], p_m;
            micro_f_pdf(m, wo_x, wo_y, wo_z, wi_x, wi_y, wi_z, fm, p_m);
#pragma unroll
            for (int k = 0; k < 3; ++k) f[k] = f[k] + (refl ? fm[k] * cos_ns : 0.0f);
            p_b = p_b + p_m;
            if (lobe == LOBE_PLASTIC) p_b = p_b / 2.0f;
        }
    }
    const float p_sel = p_l * spdf;
    const bool contributes = p_sel > 0.0f && (f[0] * li[0] > 0.0f || f[1] * li[1] > 0.0f || f[2] * li[2] > 0.0f);
    if (!contributes) return false;
    offset_ray(h, wix, wiy, wiz, so[0], so[1], so[2]);
    sd[0] = wix;
    sd[1] = wiy;
    sd[2] = wiz;
    tmax = dist * SHADOW_SCALE;
    const float w_l = delta ? 1.0f : power_heuristic(p_sel, p_b);
    const float scale = 1.0f * w_l / fmaxf(p_sel, 1e-30f);
#pragma unroll
    for (int k = 0; k < 3; ++k) c[k] = f[k] * li[k] * scale;
    return true;
}

// Phase 3 for the hit in slot i (class key >= K_EMIT): area-light emission
// with deferred MIS; then, for a lobe class, the BSDF sample, the NEE light
// sample and the path's continuation with Russian roulette. Queues the
// shadow ray in the slot's F_SO.. fields and returns true when the NEE
// sample needs one; leaves the slot's S_* state in F_KEY.
template <int SAMPLER, int ANY_AREA>
__device__ __forceinline__ bool shade(float* st, int i, int key, const float* blob,
                                      const float* __restrict__ leaf_rec) {
    Hit h;
    const int light = tri_attrs(leaf_rec + geti(st, F_ROW, i), fld(st, F_B1, i), fld(st, F_B2, i), blob[H_G7], h);
    const float wox = -fld(st, F_D, i), woy = -fld(st, F_D + 1, i), woz = -fld(st, F_D + 2, i);
    float L[3], beta[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        L[k] = fld(st, F_L + k, i);
        beta[k] = fld(st, F_BETA + k, i);
    }
    if (ANY_AREA && light >= 0) {
        // area-light emission with deferred MIS against the BSDF sample
        // that found it (diffuse.rs l())
        const float* lt = blob + LIGHT_BASE + light * LIGHT_STRIDE;
        const float cos_e = dot3(h.ngx, h.ngy, h.ngz, wox, woy, woz);
        const bool em = cos_e > 0.0f || lt[L_TWO_SIDED] != 0.0f;
        const float tx = h.px - fld(st, F_PP, i), ty = h.py - fld(st, F_PP + 1, i), tz = h.pz - fld(st, F_PP + 2, i);
        const float d2 = fmaxf(tx * tx + ty * ty + tz * tz, 1e-12f);
        const float wl = 1.0f / sqrtf(d2);
        const float cos_l = fabsf(dot3(h.ngx, h.ngy, h.ngz, -tx * wl, -ty * wl, -tz * wl));
        const float p_lh = (cos_l > 1e-7f ? d2 / fmaxf(cos_l * lt[L_AREA], 1e-12f) : 0.0f) * blob[H_PMF + light];
        const float w_mis =
            (geti(st, F_BOUNCES, i) & SPECULAR) ? 1.0f : power_heuristic(fld(st, F_PPDF, i), p_lh);
#pragma unroll
        for (int k = 0; k < 3; ++k) L[k] = L[k] + beta[k] * (em ? lt[L_PAR + k] : 0.0f) * w_mis;
    }
    bool new_alive = false, want_sh = false;
    if (key >= K_LOBE) {
        // the hit's material slot: the last whose row matches, as the
        // per-lane loop took it (the walk found one, or the key would be
        // K_EMIT)
        const int n_mats = (int)blob[H_N_MATS];
        int ms = 0;
        for (int sl = 0; sl < n_mats; ++sl) {
            if ((int)blob[MAT_BASE + sl * MAT_STRIDE + M_ROW] == h.mat) ms = sl;
        }
        const float* m = blob + MAT_BASE + ms * MAT_STRIDE;
        const uint32_t hbase = (uint32_t)geti(st, F_HB, i), s_cur = (uint32_t)geti(st, F_S, i);
        uint32_t bounces = (uint32_t)(geti(st, F_BOUNCES, i) & (SPECULAR - 1));
        const uint32_t dim_base = 2u + bounces * DPB;
        const BsdfSample bs = bsdf_sample<SAMPLER>(m, hbase, s_cur, dim_base, h, wox, woy, woz);
        float c[3], so[3], sd[3], tmax;
        if (nee_light<SAMPLER>(blob, m, hbase, s_cur, dim_base, h, wox, woy, woz, c, so, sd, tmax)) {
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                fld(st, F_SO + k, i) = so[k];
                fld(st, F_SD + k, i) = sd[k];
                fld(st, F_SBETA + k, i) = beta[k];
                fld(st, F_SC + k, i) = c[k];
            }
            fld(st, F_TMAX, i) = tmax;
            want_sh = true;
        } else {
#pragma unroll
            for (int k = 0; k < 3; ++k) L[k] = L[k] + beta[k] * 0.0f;  // the zero estimate, added as the loop adds it
        }
        const float cos_term = fabsf(dot3(bs.wx, bs.wy, bs.wz, h.nsx, h.nsy, h.nsz));
        const float inv_pdf = cos_term / fmaxf(bs.pdf, 1e-30f);
        float th[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) th[k] = bs.f[k] * inv_pdf;
        if (bs.valid && (th[0] > 0.0f || th[1] > 0.0f || th[2] > 0.0f)) {
#pragma unroll
            for (int k = 0; k < 3; ++k) beta[k] = beta[k] * th[k];
            float ox, oy, oz;
            offset_ray(h, bs.wx, bs.wy, bs.wz, ox, oy, oz);
            fld(st, F_O, i) = ox;
            fld(st, F_O + 1, i) = oy;
            fld(st, F_O + 2, i) = oz;
            fld(st, F_D, i) = bs.wx;
            fld(st, F_D + 1, i) = bs.wy;
            fld(st, F_D + 2, i) = bs.wz;
            const float eta_acc = fld(st, F_ETA, i) * bs.eta_scale;
            fld(st, F_ETA, i) = eta_acc;
            bounces += 1u;
            seti(st, F_BOUNCES, i, (int)bounces | (bs.specular ? SPECULAR : 0));
            fld(st, F_PPDF, i) = fmaxf(bs.pdf, 1e-30f);
            fld(st, F_PP, i) = h.px;
            fld(st, F_PP + 1, i) = h.py;
            fld(st, F_PP + 2, i) = h.pz;
            new_alive = true;
            // russian roulette (path.rs:206-214)
            const float max_c = fmaxf(beta[0] * eta_acc, fmaxf(beta[1] * eta_acc, beta[2] * eta_acc));
            const float q = fmaxf(1.0f - max_c, 0.05f);
            if (bounces > 3u && max_c < blob[H_RR]) {
                if (sample_1d<SAMPLER>(hbase, s_cur, dim_base + 4u) < q) {
                    new_alive = false;
                } else {
                    const float boost = 1.0f / fmaxf(1.0f - q, 1e-6f);
#pragma unroll
                    for (int k = 0; k < 3; ++k) beta[k] = beta[k] * boost;
                }
            }
#pragma unroll
            for (int k = 0; k < 3; ++k) fld(st, F_BETA + k, i) = beta[k];
        }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) fld(st, F_L + k, i) = L[k];
    seti(st, F_KEY, i, new_alive ? (want_sh ? S_ALIVE_SH : S_ALIVE) : (want_sh ? S_DEAD_SH : S_DEAD));
    return want_sh;
}

// A finished sample's radiance (F_L or F_LOLD), clamped, into the pixel's sums.
__device__ __forceinline__ void add_sample(float* st, int i, int f, const float* blob) {
    const float l0 = fld(st, f, i), l1 = fld(st, f + 1, i), l2 = fld(st, f + 2, i);
    const bool fin = isfinite(l0) && isfinite(l1) && isfinite(l2);
    float Lf[3] = {fmaxf(fin ? l0 : 0.0f, 0.0f), fmaxf(fin ? l1 : 0.0f, 0.0f), fmaxf(fin ? l2 : 0.0f, 0.0f)};
    const float max_lum = blob[H_MAX_LUM];
    if (max_lum < INFINITY) {
        const float y = Lf[0] * 0.212671f + Lf[1] * 0.715160f + Lf[2] * 0.072169f;
        const float scl = y > max_lum ? max_lum / fmaxf(y, 1e-12f) : 1.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) Lf[k] = Lf[k] * scl;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) fld(st, F_AL + k, i) = fld(st, F_AL + k, i) + Lf[k];
    fld(st, F_AW, i) = fld(st, F_AW, i) + 1.0f;
}

// Phase 4 for slot i, which holds pixel lane: first the sample in F_LOLD,
// whose shadow ray this iteration walked, into the sums; then count the
// iteration, flush a finished sample and regenerate the next. A finished
// sample whose shadow ray is queued moves to F_LOLD while the next one
// walks; the pixel's last one makes the slot wait an iteration (S_WAIT_*:
// not walked, only its shadow ray). Returns 1 when the pixel is done (all
// n_samples flushed, or the per-lane loop's iteration cap), after writing
// its sums to the outputs; -1 when the slot waits; else 0.
template <int SAMPLER>
__device__ __forceinline__ int flush(float* st, int i, int lane, const float* blob, const int* __restrict__ px_in,
                                     const int* __restrict__ py_in, uint32_t s_end, long long cap,
                                     float* __restrict__ out_l, float* __restrict__ out_w,
                                     float* __restrict__ out_nv) {
    const int code = geti(st, F_KEY, i);
    int it = geti(st, F_IT, i);
    if (it & IT_OLD) {
        add_sample(st, i, F_LOLD, blob);
        it &= ~IT_OLD;
    }
    bool done = false;
    if (code == S_WAIT_FLUSH) {
        add_sample(st, i, F_L, blob);
        done = true;
    } else if (code == S_WAIT_CAP) {
        done = true;
    } else {
        it += 1;
        const bool at_cap = (long long)it >= cap;
        const bool dead = code != S_ALIVE && code != S_ALIVE_SH;
        const uint32_t s_next = (uint32_t)geti(st, F_S, i) + 1u;
        if (code == S_DEAD_SH && s_next < s_end && !at_cap) {
#pragma unroll
            for (int k = 0; k < 3; ++k) fld(st, F_LOLD + k, i) = fld(st, F_L + k, i);
            it |= IT_OLD;
        } else if (code == S_DEAD_SH || (code == S_ALIVE_SH && at_cap)) {
            seti(st, F_IT, i, it);
            seti(st, F_KEY, i, code == S_DEAD_SH ? S_WAIT_FLUSH : S_WAIT_CAP);
            return -1;
        } else if (dead) {
            add_sample(st, i, F_L, blob);
        }
        if (dead && s_next < s_end) {
            start_sample<SAMPLER>(st, i, blob, (float)px_in[lane], (float)py_in[lane], (uint32_t)geti(st, F_HB, i),
                                  s_next);
        }
        done = (dead && s_next >= s_end) || at_cap;
    }
    seti(st, F_IT, i, it);
    if (done) {
#pragma unroll
        for (int k = 0; k < 3; ++k) out_l[3 * lane + k] = fld(st, F_AL + k, i);
        out_w[lane] = fld(st, F_AW, i);
        out_nv[lane] = fld(st, F_NV, i);
    }
    return done ? 1 : 0;
}

// --- the persistent kernel ------------------------------------------------------

template <int SAMPLER, int ANY_AREA, int PROF>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
wide_megakernel_kernel(const float* __restrict__ blob_g, const int* __restrict__ px_in,
                       const int* __restrict__ py_in, const int* __restrict__ pid_in, int n_lanes,
                       uint32_t seed, uint32_t s0, int n_samples, const float* __restrict__ node_rec,
                       const float* __restrict__ leaf_rec,
                       float* __restrict__ out_l, float* __restrict__ out_w, float* __restrict__ out_nv,
                       unsigned long long* __restrict__ pop_counts, unsigned int* __restrict__ trav_counters,
                       int* __restrict__ queue, unsigned long long* __restrict__ prof) {
    __shared__ BlockState B;
    const int tid = threadIdx.x;
    if (n_samples <= 0) {  // no sample to trace: empty sums
        for (int i = blockIdx.x * THREADS + tid; i < n_lanes; i += gridDim.x * THREADS) {
#pragma unroll
            for (int k = 0; k < 3; ++k) out_l[3 * i + k] = 0.0f;
            out_w[i] = 0.0f;
            out_nv[i] = 0.0f;
        }
        return;
    }
    // PROF: thread 0 times the phases between barriers, every thread its
    // own busy cycles in the walk and shading phases
    const long long t0 = PROF ? clock64() : 0;
    long long t_mark = t0, t_ph = 0, t_w = 0, t_s = 0;
    unsigned long long sp[N_SPLIT];
#pragma unroll
    for (int q = 0; q < N_SPLIT; ++q) sp[q] = 0ull;

    for (int i = tid; i < BLOB_FLOATS; i += THREADS) B.blob[i] = blob_g[i];
    if (tid == 0) {
        B.n_walk = 0;
        B.n_sh = 0;
        B.pool_next = THREADS;
        B.n_wait = 0;
#pragma unroll
        for (int k = 0; k < N_KEYS; ++k) B.cnt[k] = 0;
    }
    __syncthreads();
    const float* blob = B.blob;
    float* st = B.st;
    const uint32_t hseed = pcg(0x9E3779B9u ^ seed);
    const int max_depth = (int)blob[H_MAX_DEPTH];
    const int n_mats = (int)blob[H_N_MATS];
    const long long cap = (long long)n_samples * (max_depth + 2) + 8;
    const uint32_t s_end = s0 + (uint32_t)n_samples;
    int stack[WT_STACK];
    unsigned long long pops_c = 0, pops_s = 0;

    {  // every slot takes its first pixel
        const int lane = warp_take(true, queue);
        const bool has = lane < n_lanes;
        if (has) {
            start_pixel<SAMPLER>(st, tid, blob, px_in, py_in, pid_in, hseed, s0, lane);
        } else {
            seti(st, F_LANE, tid, -1);
        }
        const int pos = warp_take(has, &B.n_walk);
        if (has) B.wlist[pos] = tid;
    }
    __syncthreads();
    if (PROF && tid == 0) {
        const long long t = clock64();
        sp[SPLIT_FLUSH] += (unsigned long long)(t - t_mark) * THREADS;
        t_mark = t;
    }

    for (;;) {
        const int n_walk = B.n_walk, n_items = n_walk + B.n_sh;
        if (n_items == 0) break;
        const int n_wait = PROF ? B.n_wait : 0;
        if (PROF) t_ph = clock64();

        // --- 1. one pool of walks: the closest ray of every slot in wlist,
        // then the shadow ray of every slot in shlist; a thread whose ray is
        // done takes the next item, so lanes stay busy until the pool drains ---
        {
            int item = tid, slot = -1;
            bool shadow = false;
            WideRay r;
            r.sp = 0;
            while (item < n_items) {
                if (slot < 0) {  // start the item
                    shadow = item >= n_walk;
                    slot = shadow ? B.shlist[item - n_walk] : B.wlist[item];
                    if (shadow) {
                        wide_init(r, fld(st, F_SO, slot), fld(st, F_SO + 1, slot), fld(st, F_SO + 2, slot),
                                  fld(st, F_SD, slot), fld(st, F_SD + 1, slot), fld(st, F_SD + 2, slot),
                                  fld(st, F_TMAX, slot), true);
                    } else {
                        wide_init(r, fld(st, F_O, slot), fld(st, F_O + 1, slot), fld(st, F_O + 2, slot),
                                  fld(st, F_D, slot), fld(st, F_D + 1, slot), fld(st, F_D + 2, slot), INFINITY,
                                  false);
                    }
                }
                if (r.sp > 0) wide_pop(r, stack, node_rec, leaf_rec, trav_counters);
                if (r.sp > 0) continue;
                // the item is done
                if (shadow) {
                    pops_s += (unsigned long long)r.pops;
                    const bool occluded = r.best_idx >= 0;
                    const int f = (geti(st, F_IT, slot) & IT_OLD) ? F_LOLD : F_L;  // the sample it belongs to
#pragma unroll
                    for (int k = 0; k < 3; ++k) {
                        fld(st, f + k, slot) =
                            fld(st, f + k, slot) + fld(st, F_SBETA + k, slot) * (occluded ? 0.0f : fld(st, F_SC + k, slot));
                    }
                } else {
                    pops_c += (unsigned long long)r.pops;
                    int key = K_MISS;
                    if (r.best_idx >= 0) {
                        fld(st, F_NV, slot) = fld(st, F_NV, slot) + 1.0f;
                        seti(st, F_ROW, slot, r.best_row);
                        fld(st, F_B1, slot) = r.b1;
                        fld(st, F_B2, slot) = r.b2;
                        // the hit's material (the last slot whose row
                        // matches) and whether it samples a BSDF
                        int lobe = LOBE_NONE;
                        for (int sl = 0; sl < n_mats; ++sl) {
                            if ((int)blob[MAT_BASE + sl * MAT_STRIDE + M_ROW] == r.best_mat) {
                                lobe = (int)blob[MAT_BASE + sl * MAT_STRIDE + M_LOBE];
                            }
                        }
                        const bool alive_sh =
                            (geti(st, F_BOUNCES, slot) & (SPECULAR - 1)) < max_depth - 1 && lobe != LOBE_NONE;
                        key = alive_sh ? lobe_key(lobe) : K_EMIT;
                    }
                    seti(st, F_KEY, slot, atomicAdd(&B.cnt[key], 1) << 4 | key);
                }
                item = atomicAdd(&B.pool_next, 1);
                slot = -1;
            }
            if (PROF) sp[SPLIT_WALK_BUSY] += (unsigned long long)(clock64() - t_ph);
        }
        __syncthreads();
        if (PROF && tid == 0) t_w = clock64();

        // --- 2. counting sort of the hits by class, slot by slot ---
        const int lane = geti(st, F_LANE, tid);
        const int code = geti(st, F_KEY, tid);
        const int key = lane >= 0 && code >= 0 ? code & 15 : -1;  // walked this iteration
        int n_shade = 0, base = 0;
#pragma unroll
        for (int k = K_EMIT; k < N_KEYS; ++k) {
            if (k == key) base = n_shade;
            n_shade += B.cnt[k];
        }
        if (key >= K_EMIT) B.sperm[base + (code >> 4)] = tid;
        if (tid == 0) {  // every thread read them before the last barrier
            B.n_walk = 0;
            B.n_sh = 0;
            B.n_wait = 0;
        }
        __syncthreads();
        if (PROF) t_ph = clock64();

        // --- 3. emission, BSDF sample and NEE light sample, class by class ---
        bool want_sh = false;
        int sslot = -1;
        if (tid < n_shade) {
            sslot = B.sperm[tid];
            want_sh = shade<SAMPLER, ANY_AREA>(st, sslot, geti(st, F_KEY, sslot) & 15, blob, leaf_rec);
            if (PROF) sp[SPLIT_SHADE_BUSY] += (unsigned long long)(clock64() - t_ph);
        }
        const int shpos = warp_take(want_sh, &B.n_sh);
        if (want_sh) B.shlist[shpos] = sslot;
        __syncthreads();
        if (PROF && tid == 0) t_s = clock64();

        // --- 4. flush finished samples; regenerate, or take the next pixel ---
        const int state =
            lane >= 0 ? flush<SAMPLER>(st, tid, lane, blob, px_in, py_in, s_end, cap, out_l, out_w, out_nv) : 0;
        const bool finish = state == 1;
        const int next = warp_take(finish, queue);
        if (finish) {
            if (next < n_lanes) {
                start_pixel<SAMPLER>(st, tid, blob, px_in, py_in, pid_in, hseed, s0, next);
            } else {
                seti(st, F_LANE, tid, -1);
            }
        }
        const bool walks = geti(st, F_LANE, tid) >= 0 && state != -1;
        const int pos = warp_take(walks, &B.n_walk);
        if (walks) B.wlist[pos] = tid;
        if (PROF && state == -1) atomicAdd(&B.n_wait, 1);
        if (tid == 0) {
            B.pool_next = THREADS;
#pragma unroll
            for (int k = 0; k < N_KEYS; ++k) B.cnt[k] = 0;
        }
        __syncthreads();
        if (PROF && tid == 0) {
            const long long t = clock64();
            const unsigned long long nw = (unsigned long long)n_walk, nq = (unsigned long long)n_wait;
            sp[SPLIT_WALK] += (unsigned long long)(t_w - t_mark) * nw;
            sp[SPLIT_WALK_LANES] += (unsigned long long)(t_w - t_mark) * THREADS;
            sp[SPLIT_SHADE] += (unsigned long long)(t_s - t_w) * nw;
            sp[SPLIT_FLUSH] += (unsigned long long)(t - t_s) * nw;
            sp[SPLIT_WAIT] += (unsigned long long)(t - t_mark) * nq;
            sp[SPLIT_IDLE] += (unsigned long long)(t - t_mark) * (THREADS - nw - nq);
            sp[SPLIT_ITERS] += 1ull;
            t_mark = t;
        }
    }

    // pops of the warp, one atomic each
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        pops_c += __shfl_down_sync(0xffffffffu, pops_c, off);
        pops_s += __shfl_down_sync(0xffffffffu, pops_s, off);
    }
    if ((tid & 31) == 0) {
        if (pops_c) atomicAdd(&pop_counts[0], pops_c);
        if (pops_s) atomicAdd(&pop_counts[1], pops_s);
    }
    if (PROF) {
        if (tid == 0) sp[SPLIT_TOTAL] = (unsigned long long)(clock64() - t0) * THREADS;
#pragma unroll
        for (int q = 0; q < N_SPLIT; ++q) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) sp[q] += __shfl_down_sync(0xffffffffu, sp[q], off);
            if ((tid & 31) == 0 && sp[q]) atomicAdd(&prof[q], sp[q]);
        }
    }
}

// the kernel of a mode (sampler * 2 + any_area; sampler 0 = (0,2)-sequence,
// 1 = random, 2 = stratified), or nullptr for a bad mode
static const void* kernel_for(int mode) {
    switch (mode) {
        case 0: return (const void*)wide_megakernel_kernel<0, 0, 0>;
        case 1: return (const void*)wide_megakernel_kernel<0, 1, 0>;
        case 2: return (const void*)wide_megakernel_kernel<1, 0, 0>;
        case 3: return (const void*)wide_megakernel_kernel<1, 1, 0>;
        case 4: return (const void*)wide_megakernel_kernel<2, 0, 0>;
        case 5: return (const void*)wide_megakernel_kernel<2, 1, 0>;
        default: return nullptr;
    }
}

// Launch kern on the persistent grid: min(resident blocks per SM x SMs,
// the blocks n_lanes can fill). Returns a cudaError_t.
static int launch(const void* kern, const void* blob, const void* px, const void* py, const void* pid, int n_lanes,
                  unsigned int seed, unsigned int s0, int n_samples, const void* node_rec,
                  const void* leaf_rec, void* out_l, void* out_w, void* out_nv, void* pop_counts,
                  void* trav_counters, void* queue, void* stream, void* prof) {
    if (n_lanes <= 0) return (int)cudaGetLastError();
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    const long long fill = ((long long)n_lanes + THREADS - 1) / THREADS;
    const long long grid = (long long)per_sm * sms;
    const int blocks = (int)(fill < grid ? fill : grid);
    if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
    uint32_t seed_u = seed, s0_u = s0;
    void* args[] = {&blob, &px, &py, &pid, &n_lanes, &seed_u, &s0_u, &n_samples, &node_rec,
                    &leaf_rec, &out_l, &out_w, &out_nv, &pop_counts, &trav_counters, &queue, &prof};
    return (int)cudaLaunchKernel(kern, dim3(blocks), dim3(THREADS), args, 0, (cudaStream_t)stream);
}

// mode = sampler * 2 + any_area. queue: one int32 on the device, zeroed
// before the launch. Returns the cudaError_t of the launch (or
// cudaErrorInvalidValue for a bad mode).
extern "C" int wide_megakernel(const void* blob, const void* px, const void* py, const void* pid, int n_lanes,
                               unsigned int seed, unsigned int s0, int n_samples, int mode, const void* node_rec,
                               const void* leaf_rec, void* out_l, void* out_w, void* out_nv,
                               void* pop_counts, void* trav_counters, void* queue, void* stream) {
    const void* kern = kernel_for(mode);
    if (kern == nullptr) return (int)cudaErrorInvalidValue;
    return launch(kern, blob, px, py, pid, n_lanes, seed, s0, n_samples, node_rec, leaf_rec, out_l, out_w,
                  out_nv, pop_counts, trav_counters, queue, stream, nullptr);
}

// The instrumented instantiation ((0,2) sampler with area lights, mode 1,
// only): wide_megakernel's launch, and the cycle split (N_SPLIT u64) added
// into prof.
extern "C" int wide_megakernel_split(const void* blob, const void* px, const void* py, const void* pid, int n_lanes,
                                     unsigned int seed, unsigned int s0, int n_samples, int mode,
                                     const void* node_rec, const void* leaf_rec, void* out_l,
                                     void* out_w, void* out_nv, void* pop_counts, void* trav_counters, void* queue,
                                     void* stream, void* prof) {
    if (mode != 1) return (int)cudaErrorInvalidValue;
    return launch((const void*)wide_megakernel_kernel<0, 1, 1>, blob, px, py, pid, n_lanes, seed, s0, n_samples,
                  node_rec, leaf_rec, out_l, out_w, out_nv, pop_counts, trav_counters, queue, stream,
                  prof);
}

// Resident blocks of THREADS threads per SM for one mode.
extern "C" int wide_megakernel_occupancy(int mode, int* blocks_per_sm) {
    const void* kern = kernel_for(mode);
    if (kern == nullptr) return (int)cudaErrorInvalidValue;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kern, THREADS, 0);
}
