// Brute-force persistent path-tracing megakernel: path slots in shared
// memory, a persistent pixel queue and phase-grouped block iterations.
//
// Replaces pbrt_tpu/device/megakernel.py _build_kernel (the TPU kernel that
// make_megakernel_fn launches through pl.pallas_call). For scenes of at most
// 16 triangle or full-sphere prims, at most 4 point/spot/distant lights and
// constant-parameter materials, the whole persistent path or directlighting
// loop runs here: camera regeneration, brute-force closest-hit and shadow
// tests, next-event estimation, BSDF sampling, Russian roulette and the
// sample flush. The estimator is the reference's, term for term; the plain
// PyTorch twin is device/megakernel.py megakernel_plain.
//
// Textured Kd (the TEX instantiations): a grayscale imagemap on the Kd slot
// of a matte or plastic material of triangle prims is looked up in a mip
// atlas in device memory, read with __ldg (a 128^2 pyramid is 255 rows of
// 128 floats, 130,560 bytes per texture, which does not fit in shared
// memory beside the slots), with the reference's ray-cone trilinear filter
// (eval_kd_tex): the cone's world width at the hit (the camera's pixel
// angle times the distance travelled since the camera, F_TSPREAD, over
// |cos| of the hit) times the prim's uv density picks the level. TEX = 0
// compiles none of it and keeps the slot layout and shared blob below; TEX
// = 1 adds one word per slot and one per material record.
//
// What bounds it on Hopper, and what the design does about it:
//  - Arithmetic issue, not bytes: the inputs are three int32 and the outputs
//    five float32 per pixel, the scene a few KB. Per sample the kernel makes
//    one closest-hit test over every prim per ray (hit or miss), one any-hit
//    shadow test per contributing NEE sample, the shading of each vertex and
//    one camera regeneration. So the kernel runs at the rate at which the SMs
//    issue useful lane-instructions: it loses to lanes that idle in a warp
//    (divergent phases, finished pixels) and to latency no warp hides.
//  - One thread per pixel for all samples held 125-128 registers (4 blocks
//    of 128 threads per SM), and in almost every iteration some lanes of a
//    warp shaded while their mates flushed and regenerated (most samples
//    end at their first vertex), so the warp issued both paths; a lane whose
//    pixel was done idled until its block's slowest pixel was. Here a path is
//    not a thread: each block keeps one path slot per thread as a structure
//    of arrays in shared memory (the F_* fields below, 43 words a slot,
//    beside the scene blob compacted to the fields the kernel reads), and
//    each phase loads only the fields it needs, so __launch_bounds__(THREADS,
//    MIN_BLOCKS) holds the kernel to the registers at which MIN_BLOCKS
//    blocks are resident: 8 blocks of 128 threads at 64 registers and 7 at
//    72 measured within 1% of each other, 6 slower, and two slots per
//    thread at 4 blocks slower (PERF.md).
//  - A block iteration runs in phases with __syncthreads() between them:
//    (1) one pool of brute-force tests: the closest ray of every slot that
//    holds a pixel and the any-hit shadow ray of every slot whose last NEE
//    sample contributes, all through one prim loop, so a warp's lanes test
//    the same prim at the same time whichever kind of ray they hold; a hit
//    that samples a BSDF is compacted into the shading list; (2) bsdf_sample,
//    the NEE light sample, Russian roulette and the queueing of the shadow
//    ray, over the compacted hits; (3) flush of finished samples and camera
//    regeneration, slot by slot. Lanes that shade and lanes that regenerate
//    no longer share a warp instruction stream. (Regenerating over a
//    compacted list in a fourth phase, or sorting the hits by lobe class
//    before shading, measured no faster: PERF.md.)
//  - The grid is persistent (the occupancy query's blocks per SM x SMs), and
//    a slot whose pixel has run all n_samples takes the next pixel from a
//    device counter (queue[0]; the grid's last block zeroes it again, one
//    queue per device and stream), so slots idle only in the grid's tail,
//    and for one iteration when a pixel's last sample still waits for its
//    shadow ray: an earlier finished sample waits in F_LOLD while the next
//    one is tested.
//
// Results: a sample's stream is a pure function of (pixel, sample,
// dimension), so which thread tests or shades a path, and when, does not
// change what it draws. Each pixel's samples run one after another in one
// slot, so its radiance, weight and vertex count are summed in sample order
// and written once, with no atomics on the image; each path's arithmetic is
// the per-lane loop's, in the same order: the NEE term is added to the
// sample's radiance when its shadow ray has been tested, in the next pool,
// from the beta it was computed with and before the next vertex, and a
// sample is flushed, or its pixel finished, only after that. The per-lane
// loop's iteration cap n_samples*(max_depth+2)+8 is counted per pixel;
// pixels finished by it go to counters[0] (it must read 0).
//
// The PROF instantiation, which no route launches, sums a clock64() cycle
// split and the tests the launch made (SPLIT_* below); the others count
// nothing but the pixels cut by the cap.
//
// The samplers, camera regeneration, lobes, bsdf_sample, light selection,
// the delta-light part of NEE and the ray-origin offset are pt_common.cuh's,
// shared with the wide megakernel (megakernel_wide.cu). Arithmetic: uint32
// hash and Sobol' math is native and bit-exact with the twin; built with
// -fmad=false and without fast math (see pt_common.cuh), so the kernel is
// held to its twin at image level only because sinf/cosf may differ by ulps.

#include "pt_common.cuh"

// --- the constant blob (keep in lockstep with device/megakernel.py) --------
#define H_N_PRIMS 0
#define H_N_LIGHTS 1
#define H_N_MATS 2
#define H_MAX_DEPTH 3
#define H_RR 4
#define H_UNIFORM 5
#define H_IKIND 6
#define H_SAMPLER 7
#define H_STRAT_XS 8
#define H_STRAT_YS 9
#define H_WR2 10
#define H_FXW 11
#define H_FYW 12
#define H_MAX_LUM 13
#define H_G7 14
#define H_G53 15
#define H_R2C 16
#define H_C2W 32
#define H_CDF 44
#define H_PMF 48
#define H_CONE_PA 52  // float32(cone_k) * float32(pixel_angle)
#define HEADER 64
#define MAX_LIGHTS 4
#define MAX_PRIMS 16
#define MAX_MATS 16
#define LIGHT_STRIDE 16
#define LIGHT_BASE HEADER
#define PRIM_STRIDE 48
#define PRIM_BASE (LIGHT_BASE + MAX_LIGHTS * LIGHT_STRIDE)
#define MAT_STRIDE 32
#define MAT_BASE (PRIM_BASE + MAX_PRIMS * PRIM_STRIDE)
#define BLOB_FLOATS (MAT_BASE + MAX_MATS * MAT_STRIDE)

// prim record: kind, material slot, flags, then a triangle's fields below
// or a sphere's (pt_common.cuh's sphere record, SPH_*)
#define P_KIND 0
#define P_MAT 1
#define P_FLAGS 2
#define P_V 3
#define P_NG 12
#define P_NS 15
#define P_SS 18
#define P_TS 21
#define P_UV 24   // triangle: uv0 uv1 uv2 (6)
#define P_UVD 30  // triangle: the uv density sqrt(|duv cross| / |dp cross|)

// material record field past pt_common.cuh's: 1 + the Kd texture's row of
// the texture table, 0 for none (TEX)
#define M_TEX 24

// the texture table: one TEX_STRIDE row per atlas texture (keep in lockstep
// with device/megakernel.py pack_textures)
#define TX_NLEV 0
#define TX_BASE 1
#define TX_US 2
#define TX_VS 3
#define TX_UD 4
#define TX_VD 5
#define TX_SCALE 6
#define TX_SMAX 7
#define TX_LMAX 8
#define TX_LEVELS 9  // (row offset, height, width) per level
#define TEX_STRIDE 40
#define ATLAS_W 128

// --- brute-force intersection ------------------------------------------------

struct RaySetup {
    int k;  // 0: x is the largest |d| component, 1: y, 2: z
    float sx, sy, sz;
};

__device__ __forceinline__ void permute(int k, float vx, float vy, float vz, float& px, float& py, float& pz) {
    if (k == 0) {
        px = vy; py = vz; pz = vx;
    } else if (k == 1) {
        px = vz; py = vx; pz = vy;
    } else {
        px = vx; py = vy; pz = vz;
    }
}

__device__ __forceinline__ RaySetup ray_setup(float dx, float dy, float dz) {
    float adx = fabsf(dx), ady = fabsf(dy), adz = fabsf(dz);
    RaySetup rs;
    rs.k = (adx >= ady && adx >= adz) ? 0 : (ady >= adz ? 1 : 2);
    float dpx, dpy, dpz;
    permute(rs.k, dx, dy, dz, dpx, dpy, dpz);
    float inv_dz = 1.0f / dpz;
    rs.sx = -dpx * inv_dz;
    rs.sy = -dpy * inv_dz;
    rs.sz = inv_dz;
    return rs;
}

// watertight test against constant vertices (intersect.ray_triangle)
__device__ __forceinline__ bool tri_test(const float* pr, const RaySetup& rs, float ox, float oy, float oz,
                                         float t_query, float& t, float& b1, float& b2) {
    float x[3], y[3], z[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const float* v = pr + P_V + 3 * c;
        float px, py, pz;
        permute(rs.k, v[0] - ox, v[1] - oy, v[2] - oz, px, py, pz);
        x[c] = px + rs.sx * pz;
        y[c] = py + rs.sy * pz;
        z[c] = rs.sz * pz;
    }
    float e0 = x[1] * y[2] - y[1] * x[2];
    float e1 = x[2] * y[0] - y[2] * x[0];
    float e2 = x[0] * y[1] - y[0] * x[1];
    bool same = (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) || (e0 <= 0.0f && e1 <= 0.0f && e2 <= 0.0f);
    float det = e0 + e1 + e2;
    bool dok = det != 0.0f;
    float inv_det = dok ? 1.0f / det : 0.0f;
    t = (e0 * z[0] + e1 * z[1] + e2 * z[2]) * inv_det;
    b1 = e1 * inv_det;
    b2 = e2 * inv_det;
    return same && dok && t > SHADOW_EPS && t < t_query;
}

// --- the block: THREADS threads, one path slot each ---------------------------
#define THREADS 128  // at most 256 (byte-sized slot lists)
#define MIN_BLOCKS 8  // resident blocks per SM that __launch_bounds__ asks for (7 measured equal, 6 slower)

// The blob in shared memory: header and lights as in device memory, then
// the first P_FIELDS floats of every prim record and M_FIELDS (TEX: one
// more, M_TEX) of every material record, the fields the kernel reads.
#define P_FIELDS 33  // SPH_ERRC + 3
#define M_FIELDS 24  // M_ON_B + 1
#define SB_PRIM (LIGHT_BASE + MAX_LIGHTS * LIGHT_STRIDE)
#define SB_MAT (SB_PRIM + MAX_PRIMS * P_FIELDS)
#define SB_FLOATS (SB_MAT + MAX_MATS * M_FIELDS)
template <int TEX>
struct Layout {
    static constexpr int m_fields = M_FIELDS + TEX;
    static constexpr int sb_floats = SB_MAT + MAX_MATS * m_fields;
    static constexpr int n_fields = 43 + TEX;  // N_FIELDS, and F_TSPREAD (TEX)
};

// F_KEY: after the pool, the hit prim of a hit that samples a BSDF (>= 0),
// else S_DEAD; after shading, one of the S_* states; a slot that waits for
// its shadow ray before it may finish its pixel carries S_WAIT_*
#define S_ALIVE (-1)       // the path goes on
#define S_ALIVE_SH (-2)    // ... and its NEE shadow ray is queued
#define S_DEAD (-3)        // the sample is finished
#define S_DEAD_SH (-4)     // ... once its queued shadow ray is tested
#define S_WAIT_FLUSH (-5)  // flush the pixel's last sample now: its shadow ray was tested
#define S_WAIT_CAP (-6)    // finish the pixel now (iteration cap): its shadow ray was tested

// slot fields, one 32-bit word each; field f of slot i is st[f * THREADS + i]
#define F_LANE 0      // pixel (lane index), -1 for an empty slot
#define F_S 1         // current sample index
#define F_IT 2        // loop iterations spent on the pixel (the reference's cap) | IT_OLD
#define F_O 3         // ray origin (3)
#define F_D 6         // ray direction (3)
#define F_L 9         // the sample's radiance (3)
#define F_BETA 12     // path throughput (3)
#define F_ETA 15      // accumulated eta scale
#define F_BOUNCES 16
#define F_AL 17       // the pixel's sum of flushed radiance (3)
#define F_AW 20       // ... of weights
#define F_NV 21       // ... of path vertices
#define F_KEY 22
#define F_HA 23       // the hit: a triangle's (b1, b2), a sphere's object-space point (3)
#define F_SO 26       // the queued shadow ray: origin (3)
#define F_SD 29       // ... direction (3)
#define F_TMAX 32
#define F_SBETA 33    // beta before the BSDF sample (3)
#define F_SC 36       // the unoccluded NEE contribution without beta (3)
#define F_LOLD 39     // a finished sample's radiance, flushed once its shadow ray is tested (3)
#define F_HB 42       // the pixel's hash base
#define N_FIELDS 43
#define F_TSPREAD 43  // TEX: the distance the sample's ray cone has travelled
#define IT_OLD (1 << 30)  // F_LOLD holds a sample, and the queued shadow ray adds to it

// The PROF instantiation's record, u64 (device/megakernel.py SPLIT_FIELDS):
// slot-cycles of the slots whose path was tested, in each phase (test pool,
// shading + NEE, flush + regeneration); of slots that only waited for their
// shadow ray; of empty slots (the grid's tail); of the whole launch; thread-
// cycles of the pool phase; thread-cycles in which a thread had pool or
// shading work; block iterations. Phase times are thread 0's clock64()
// between barriers. Then the tests made: closest rays, shadow rays, and the
// triangle and sphere tests those shadow rays made up to their first hit.
#define SPLIT_POOL 0
#define SPLIT_SHADE 1
#define SPLIT_FLUSH 2
#define SPLIT_WAIT 3
#define SPLIT_IDLE 4
#define SPLIT_TOTAL 5
#define SPLIT_POOL_LANES 6
#define SPLIT_POOL_BUSY 7
#define SPLIT_SHADE_BUSY 8
#define SPLIT_ITERS 9
#define SPLIT_CLOSEST 10
#define SPLIT_SHADOW 11
#define SPLIT_SHADOW_TRI 12
#define SPLIT_SHADOW_SPH 13
#define N_SPLIT 14

template <int TEX>
struct BlockState {
    float blob[Layout<TEX>::sb_floats];
    float st[Layout<TEX>::n_fields * THREADS];
    uint8_t wlist[THREADS];   // slots whose closest ray is tested next, compacted
    uint8_t shlist[THREADS];  // slots with a queued shadow ray, compacted
    uint8_t hlist[THREADS];   // hits to shade, compacted
    int n_walk, n_sh, n_sh_next, n_hit;
    int n_wait;                     // PROF: slots waiting for their shadow ray
    int tri_before[MAX_PRIMS + 1];  // PROF: triangles among the first i prims
};

__device__ __forceinline__ float& fld(float* st, int f, int i) { return st[f * THREADS + i]; }
__device__ __forceinline__ int geti(const float* st, int f, int i) { return __float_as_int(st[f * THREADS + i]); }
__device__ __forceinline__ void seti(float* st, int f, int i, int v) { st[f * THREADS + i] = __int_as_float(v); }
__device__ __forceinline__ const float* prim_rec(const float* blob, int i) { return blob + SB_PRIM + i * P_FIELDS; }
template <int TEX>
__device__ __forceinline__ const float* mat_rec(const float* blob, int s) {
    return blob + SB_MAT + s * Layout<TEX>::m_fields;
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

// surface_interaction's triangle branch with constant vertices and frame,
// at barycentrics (b1, b2)
__device__ __forceinline__ void tri_attrs(const float* pr, float g7, float b1, float b2, Hit& h) {
    const float b0 = 1.0f - b1 - b2;
    const float* v = pr + P_V;
    h.px = b0 * v[0] + b1 * v[3] + b2 * v[6];
    h.py = b0 * v[1] + b1 * v[4] + b2 * v[7];
    h.pz = b0 * v[2] + b1 * v[5] + b2 * v[8];
    const float ab0 = fabsf(b0), ab1 = fabsf(b1), ab2 = fabsf(b2);
    h.ex = g7 * (ab0 * fabsf(v[0]) + ab1 * fabsf(v[3]) + ab2 * fabsf(v[6]));
    h.ey = g7 * (ab0 * fabsf(v[1]) + ab1 * fabsf(v[4]) + ab2 * fabsf(v[7]));
    h.ez = g7 * (ab0 * fabsf(v[2]) + ab1 * fabsf(v[5]) + ab2 * fabsf(v[8]));
    h.ngx = pr[P_NG]; h.ngy = pr[P_NG + 1]; h.ngz = pr[P_NG + 2];
    h.nsx = pr[P_NS]; h.nsy = pr[P_NS + 1]; h.nsz = pr[P_NS + 2];
    h.ssx = pr[P_SS]; h.ssy = pr[P_SS + 1]; h.ssz = pr[P_SS + 2];
    h.tsx = pr[P_TS]; h.tsy = pr[P_TS + 1]; h.tsz = pr[P_TS + 2];
}

// One brute-force test over every prim, in blob order: the closest hit
// (shadow false; the first t_max is a bound above every hit, and each hit
// lowers it, which accepts exactly the hits the per-lane loop's t < t_best
// accepted) or the first hit below t_max (shadow true). Returns the hit
// prim or -1, with a triangle's (b1, b2) or a sphere's object-space point in
// a[] and its distance in t_hit; *tested: the prims tested.
__device__ __forceinline__ int brute_test(const float* blob, int n_prims, float ox, float oy, float oz, float dx,
                                          float dy, float dz, float t_max, bool shadow, float a[3], int* tested,
                                          float& t_hit) {
    const RaySetup rs = ray_setup(dx, dy, dz);
    float tq = t_max;
    int best = -1, i = 0;
    for (; i < n_prims; ++i) {
        const float* pr = prim_rec(blob, i);
        float t, u, v, w = 0.0f;
        const bool hit = pr[P_KIND] == 0.0f ? tri_test(pr, rs, ox, oy, oz, tq, t, u, v)
                                            : sph_test(pr, ox, oy, oz, dx, dy, dz, tq, t, u, v, w);
        if (!hit) continue;
        best = i;
        a[0] = u;
        a[1] = v;
        a[2] = w;
        if (shadow) {
            ++i;
            break;
        }
        tq = t;
    }
    *tested = i;
    t_hit = tq;
    return best;
}

// uniform_sample_onelight + estimate_direct for delta lights, up to the
// shadow test: returns whether the sample can contribute, and then the
// shadow ray and the unoccluded contribution without beta, c
template <int SAMPLER>
__device__ __forceinline__ bool nee_light(const float* blob, const float* m, uint32_t hbase, uint32_t s,
                                          uint32_t dim_base, const Hit& h, float wox, float woy, float woz,
                                          float c[3], float so[3], float sd[3], float& tmax,
                                          const float* kd = nullptr) {
    const float* col = kd != nullptr ? kd : m + M_COLOR;
    const int n_lights = (int)blob[H_N_LIGHTS];
    int lid = 0;
    if (n_lights > 1) {
        lid = select_light(sample_1d<SAMPLER>(hbase, s, dim_base), n_lights, blob[H_UNIFORM] != 0.0f, blob + H_CDF);
    }
    float wix, wiy, wiz, li[3], dist;
    delta_light(blob + LIGHT_BASE + lid * LIGHT_STRIDE, blob[H_WR2], h, wix, wiy, wiz, li, dist);
    const float spdf = blob[H_PMF + lid];

    const int lobe = (int)m[M_LOBE];
    const bool refl = dot3(wix, wiy, wiz, h.ngx, h.ngy, h.ngz) * dot3(wox, woy, woz, h.ngx, h.ngy, h.ngz) > 0.0f;
    const float cos_ns = fabsf(dot3(wix, wiy, wiz, h.nsx, h.nsy, h.nsz));
    float f[3] = {0.0f, 0.0f, 0.0f};
    if ((lobe == LOBE_LAMBERT_R || lobe == LOBE_PLASTIC) && refl) {
#pragma unroll
        for (int k = 0; k < 3; ++k) f[k] = col[k] * INV_PI_F * cos_ns;
    }
    if (lobe == LOBE_OREN_NAYAR || lobe == LOBE_MICRO_R || lobe == LOBE_PLASTIC) {
        float wo_x, wo_y, wo_z, wi_x, wi_y, wi_z;
        to_local(h, wox, woy, woz, wo_x, wo_y, wo_z);
        to_local(h, wix, wiy, wiz, wi_x, wi_y, wi_z);
        if (lobe == LOBE_OREN_NAYAR && refl) {
            const float onf = on_factor(m, wo_x, wo_y, wo_z, wi_x, wi_y, wi_z);
#pragma unroll
            for (int k = 0; k < 3; ++k) f[k] = col[k] * onf * cos_ns;
        }
        if (lobe != LOBE_OREN_NAYAR && refl) {
            float fm[3], p_m;
            micro_f_pdf(m, wo_x, wo_y, wo_z, wi_x, wi_y, wi_z, fm, p_m);
#pragma unroll
            for (int k = 0; k < 3; ++k) f[k] = f[k] + fm[k] * cos_ns;
        }
    }
    const bool contributes = spdf > 0.0f && (f[0] * li[0] > 0.0f || f[1] * li[1] > 0.0f || f[2] * li[2] > 0.0f);
    if (!contributes) return false;
    offset_ray(h, wix, wiy, wiz, so[0], so[1], so[2]);
    sd[0] = wix;
    sd[1] = wiy;
    sd[2] = wiz;
    tmax = dist * SHADOW_SCALE;
    const float inv_pl = 1.0f / fmaxf(spdf, 1e-30f);
#pragma unroll
    for (int k = 0; k < 3; ++k) c[k] = f[k] * li[k] * 1.0f * inv_pl;
    return true;
}

// The bilinear taps of level l of an atlas texture at (su, sv), weighted by
// w: the lower row's texel pair (x) and the upper row's (y).
__device__ __forceinline__ float2 kd_level(const float* __restrict__ atlas, const float* __restrict__ tx, int l,
                                          float su, float sv, float w) {
    const int off = (int)__ldg(tx + TX_LEVELS + 3 * l), hl = (int)__ldg(tx + TX_LEVELS + 3 * l + 1);
    const int wl = (int)__ldg(tx + TX_LEVELS + 3 * l + 2), base = (int)__ldg(tx + TX_BASE);
    // v flipped: pbrt images are top-down (imagemap.rs st.y -> 1 - t)
    const float x = (su - floorf(su)) * (float)wl - 0.5f;
    const float y = (1.0f - (sv - floorf(sv))) * (float)hl - 0.5f;
    const int ix = (int)floorf(x), iy = (int)floorf(y);
    const float fx = x - (float)ix, fy = y - (float)iy;
    const int ixm = ((ix % wl) + wl) % wl, ixp = (ixm + 1) % wl;
    const int iym = ((iy % hl) + hl) % hl, iyp = (iym + 1) % hl;
    const float* ra = atlas + (size_t)(base + off + iym) * ATLAS_W;
    const float* rb = atlas + (size_t)(base + off + iyp) * ATLAS_W;
    return make_float2(w * (1.0f - fy) * (1.0f - fx) * __ldg(ra + ixm) + w * (1.0f - fy) * fx * __ldg(ra + ixp),
                       w * fy * (1.0f - fx) * __ldg(rb + ixm) + w * fy * fx * __ldg(rb + ixp));
}

// The grayscale Kd of an atlas texture (row tx of the texture table) at the
// hit's uv: the ray cone's width (cone_pa * t_tot / max(|cos|, 0.25), times
// the prim's uv density and the mapping's scale) picks a level, then a
// trilinear fetch over it and the next (reference eval_kd_tex :1468-1574).
__device__ __forceinline__ float eval_kd_tex(const float* __restrict__ atlas, const float* __restrict__ tx,
                                             float cone_pa, float u, float v, float uvd, float t_tot, float cosg) {
    const float world_fp = cone_pa * t_tot / fmaxf(cosg, 0.25f);
    const float su = u * __ldg(tx + TX_US) + __ldg(tx + TX_UD);
    const float sv = v * __ldg(tx + TX_VS) + __ldg(tx + TX_VD);
    const float width = world_fp * uvd * __ldg(tx + TX_SMAX);
    const float nlev = __ldg(tx + TX_NLEV);
    float lvl = (nlev - 1.0f) + log2f(fmaxf(width, 1e-8f));
    lvl = fminf(fmaxf(lvl, 0.0f), __ldg(tx + TX_LMAX));
    const int l0 = (int)lvl;
    const float ft = lvl - (float)l0;
    const float2 lo = kd_level(atlas, tx, l0, su, sv, 1.0f - ft);
    const float2 hi = kd_level(atlas, tx, min(l0 + 1, (int)nlev - 1), su, sv, ft);
    return (lo.x + lo.y + hi.x + hi.y) * __ldg(tx + TX_SCALE);
}

// Phase 2 for the hit in slot i (F_KEY: its prim): the BSDF sample, the NEE
// light sample and the path's continuation with Russian roulette. Queues the
// shadow ray in the slot's F_SO.. fields and returns true when the NEE
// sample needs one; leaves the slot's S_* state in F_KEY. TEX: a material
// with an atlas texture takes its Kd from it.
template <int SAMPLER, int IKIND, int TEX>
__device__ __forceinline__ bool shade(float* st, int i, const float* blob, const float* __restrict__ atlas,
                                      const float* __restrict__ tex) {
    const float* pr = prim_rec(blob, geti(st, F_KEY, i));
    Hit h;
    if (pr[P_KIND] == 0.0f) {
        tri_attrs(pr, blob[H_G7], fld(st, F_HA, i), fld(st, F_HA + 1, i), h);
    } else {
        sph_attrs(pr, blob[H_G53], fld(st, F_HA, i), fld(st, F_HA + 1, i), fld(st, F_HA + 2, i), h);
    }
    h.mat = (int)pr[P_MAT];
    const float* m = mat_rec<TEX>(blob, h.mat);
    const float wox = -fld(st, F_D, i), woy = -fld(st, F_D + 1, i), woz = -fld(st, F_D + 2, i);
    float kdv[3];
    const float* kd = nullptr;
    if (TEX) {
#pragma unroll
        for (int k = 0; k < 3; ++k) kdv[k] = m[M_COLOR + k];
        const int tx = (int)m[M_TEX];
        if (tx > 0) {  // a triangle (textured spheres are outside the class)
            const float b1 = fld(st, F_HA, i), b2 = fld(st, F_HA + 1, i);
            const float b0 = 1.0f - b1 - b2;
            const float u = b0 * pr[P_UV] + b1 * pr[P_UV + 2] + b2 * pr[P_UV + 4];
            const float v = b0 * pr[P_UV + 1] + b1 * pr[P_UV + 3] + b2 * pr[P_UV + 5];
            const float cosg = fabsf(dot3(fld(st, F_D, i), fld(st, F_D + 1, i), fld(st, F_D + 2, i), h.ngx, h.ngy,
                                          h.ngz));
            const float val = eval_kd_tex(atlas, tex + (tx - 1) * TEX_STRIDE, blob[H_CONE_PA], u, v, pr[P_UVD],
                                          fld(st, F_TSPREAD, i), cosg);
#pragma unroll
            for (int k = 0; k < 3; ++k) kdv[k] = val;
        }
        kd = kdv;
    }
    const uint32_t hbase = (uint32_t)geti(st, F_HB, i), s_cur = (uint32_t)geti(st, F_S, i);
    uint32_t bounces = (uint32_t)geti(st, F_BOUNCES, i);
    const uint32_t dim_base = 2u + bounces * DPB;
    const BsdfSample bs = bsdf_sample<SAMPLER>(m, hbase, s_cur, dim_base, h, wox, woy, woz, kd);
    float beta[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) beta[k] = fld(st, F_BETA + k, i);
    bool want_sh = false;
    if ((int)blob[H_N_LIGHTS] > 0) {
        float c[3], so[3], sd[3], tmax;
        if (nee_light<SAMPLER>(blob, m, hbase, s_cur, dim_base, h, wox, woy, woz, c, so, sd, tmax, kd)) {
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
            for (int k = 0; k < 3; ++k) {  // the zero estimate, added as the loop adds it
                fld(st, F_L + k, i) = fld(st, F_L + k, i) + beta[k] * 0.0f;
            }
        }
    }
    const float cos_term = fabsf(dot3(bs.wx, bs.wy, bs.wz, h.nsx, h.nsy, h.nsz));
    const float inv_pdf = cos_term / fmaxf(bs.pdf, 1e-30f);
    float th[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) th[k] = bs.f[k] * inv_pdf;
    bool surf_cont = bs.valid && (th[0] > 0.0f || th[1] > 0.0f || th[2] > 0.0f);
    if (IKIND == 1) surf_cont = surf_cont && bs.specular;
    bool new_alive = false;
    if (surf_cont) {
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
        seti(st, F_BOUNCES, i, (int)bounces);
        new_alive = true;
        if (IKIND == 0) {  // russian roulette (path.rs:206-214)
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
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) fld(st, F_BETA + k, i) = beta[k];
    }
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

// Phase 3 for slot i, which holds pixel lane: first the sample in F_LOLD,
// whose shadow ray this iteration tested, into the sums; then count the
// iteration, flush a finished sample and move on to the next (F_S; the
// caller regenerates it). A finished sample whose shadow ray is queued moves to
// F_LOLD while the next one is tested; the pixel's last one makes the slot
// wait an iteration (S_WAIT_*: not tested, only its shadow ray). Returns 1
// when the pixel is done (all n_samples flushed, or the per-lane loop's
// iteration cap), after writing its sums to the outputs and counting a cap
// hit; -1 when the slot waits; 2 when it starts its next sample; else 0.
__device__ __forceinline__ int flush(float* st, int i, int lane, const float* blob, uint32_t s_end, int n_samples,
                                     long long cap, float* __restrict__ out_l, float* __restrict__ out_w,
                                     float* __restrict__ out_nv, unsigned int* __restrict__ counters) {
    const int code = geti(st, F_KEY, i);
    int it = geti(st, F_IT, i);
    if (it & IT_OLD) {
        add_sample(st, i, F_LOLD, blob);
        it &= ~IT_OLD;
    }
    bool done = false, next_sample = false;
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
        done = (dead && s_next >= s_end) || at_cap;
        if (dead && !done) {
            seti(st, F_S, i, (int)s_next);
            next_sample = true;
        }
    }
    seti(st, F_IT, i, it);
    if (done) {
#pragma unroll
        for (int k = 0; k < 3; ++k) out_l[3 * lane + k] = fld(st, F_AL + k, i);
        out_w[lane] = fld(st, F_AW, i);
        out_nv[lane] = fld(st, F_NV, i);
        if (fld(st, F_AW, i) != (float)n_samples) atomicAdd(&counters[0], 1u);  // cut by the cap
        return 1;
    }
    return next_sample ? 2 : 0;
}

// slot i takes pixel `lane` at sample s0, with empty sums (start_sample
// then regenerates its ray)
__device__ __forceinline__ void take_pixel(float* st, int i, const int* __restrict__ pid_in, uint32_t hseed,
                                           uint32_t s0, int lane) {
    seti(st, F_LANE, i, lane);
    seti(st, F_HB, i, (int)pcg(hseed ^ (uint32_t)pid_in[lane]));
    seti(st, F_IT, i, 0);
    seti(st, F_S, i, (int)s0);
#pragma unroll
    for (int k = 0; k < 3; ++k) fld(st, F_AL + k, i) = 0.0f;
    fld(st, F_AW, i) = 0.0f;
    fld(st, F_NV, i) = 0.0f;
}

// camera regeneration of slot i's sample F_S, with the path state reset
template <int SAMPLER, int TEX>
__device__ __forceinline__ void start_sample(float* st, int i, const float* blob, const int* __restrict__ px_in,
                                             const int* __restrict__ py_in) {
    const int lane = geti(st, F_LANE, i);
    float ox, oy, oz, dx, dy, dz;
    regen<SAMPLER>(blob + H_R2C, blob + H_C2W, blob[H_FXW], blob[H_FYW], (int)blob[H_STRAT_XS],
                   (int)blob[H_STRAT_YS], 0.0f, 0.0f, (uint32_t)geti(st, F_HB, i), (float)px_in[lane],
                   (float)py_in[lane], (uint32_t)geti(st, F_S, i), ox, oy, oz, dx, dy, dz);
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
    seti(st, F_BOUNCES, i, 0);
    if (TEX) fld(st, F_TSPREAD, i) = 0.0f;
}

// --- the persistent kernel ------------------------------------------------------

template <int SAMPLER, int IKIND, int TEX, int PROF>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
brute_megakernel_kernel(const float* __restrict__ blob_g, const int* __restrict__ px_in,
                        const int* __restrict__ py_in, const int* __restrict__ pid_in, int n_lanes,
                        uint32_t seed, uint32_t s0, int n_samples, float* __restrict__ out_l,
                        float* __restrict__ out_w, float* __restrict__ out_nv,
                        unsigned int* __restrict__ counters, int* __restrict__ queue,
                        const float* __restrict__ atlas, const float* __restrict__ tex,
                        unsigned long long* __restrict__ prof) {
    constexpr int MF = Layout<TEX>::m_fields;
    __shared__ BlockState<TEX> B;
    const int tid = threadIdx.x;
    const long long t0 = PROF ? clock64() : 0;
    long long t_mark = t0, t_ph = 0, t_w = 0, t_s = 0;
    unsigned long long sp[N_SPLIT];
#pragma unroll
    for (int q = 0; q < N_SPLIT; ++q) sp[q] = 0ull;

    for (int i = tid; i < Layout<TEX>::sb_floats; i += THREADS) {
        int g = i;
        if (i >= SB_MAT) {
            g = MAT_BASE + (i - SB_MAT) / MF * MAT_STRIDE + (i - SB_MAT) % MF;
        } else if (i >= SB_PRIM) {
            g = PRIM_BASE + (i - SB_PRIM) / P_FIELDS * PRIM_STRIDE + (i - SB_PRIM) % P_FIELDS;
        }
        B.blob[i] = blob_g[g];
    }
    if (tid == 0) {
        if (PROF) {
            int n_tri = 0;
            B.tri_before[0] = 0;
            for (int i = 0; i < MAX_PRIMS; ++i) {
                n_tri += (i < (int)blob_g[H_N_PRIMS] && blob_g[PRIM_BASE + i * PRIM_STRIDE + P_KIND] == 0.0f) ? 1 : 0;
                B.tri_before[i + 1] = n_tri;
            }
        }
        B.n_walk = 0;
        B.n_sh = 0;
        B.n_sh_next = 0;
        B.n_hit = 0;
        B.n_wait = 0;
    }
    __syncthreads();
    const float* blob = B.blob;
    float* st = B.st;
    const uint32_t hseed = pcg(0x9E3779B9u ^ seed);
    const int n_prims = (int)blob[H_N_PRIMS];
    const int max_depth = (int)blob[H_MAX_DEPTH];
    const long long cap = (long long)n_samples * (max_depth + 2) + 8;
    const uint32_t s_end = s0 + (uint32_t)n_samples;

    if (n_samples > 0) {  // every slot takes its first pixel
        const int i = tid;
        const int lane = warp_take(true, queue);
        const bool has = lane < n_lanes;
        if (has) {
            take_pixel(st, i, pid_in, hseed, s0, lane);
            start_sample<SAMPLER, TEX>(st, i, blob, px_in, py_in);
        } else {
            seti(st, F_LANE, i, -1);
        }
        const int pos = warp_take(has, &B.n_walk);
        if (has) B.wlist[pos] = i;
    } else {  // no sample to trace: empty sums
        for (int i = blockIdx.x * THREADS + tid; i < n_lanes; i += gridDim.x * THREADS) {
#pragma unroll
            for (int k = 0; k < 3; ++k) out_l[3 * i + k] = 0.0f;
            out_w[i] = 0.0f;
            out_nv[i] = 0.0f;
        }
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

        // --- 1. one pool of tests: the closest ray of every slot in wlist,
        // then the shadow ray of every slot in shlist ---
        for (int base = 0; base < n_items; base += THREADS) {
            const int item = base + tid;
            int slot = -1;
            bool shades = false;
            if (item < n_items) {
                const bool shadow = item >= n_walk;
                slot = shadow ? B.shlist[item - n_walk] : B.wlist[item];
                const int fo = shadow ? F_SO : F_O, fd = shadow ? F_SD : F_D;
                float a[3], t_hit;
                int tested;
                const int hit = brute_test(blob, n_prims, fld(st, fo, slot), fld(st, fo + 1, slot),
                                           fld(st, fo + 2, slot), fld(st, fd, slot), fld(st, fd + 1, slot),
                                           fld(st, fd + 2, slot), shadow ? fld(st, F_TMAX, slot) : 1e30f, shadow, a,
                                           &tested, t_hit);
                if (shadow) {
                    const bool occluded = hit >= 0;
                    const int f = (geti(st, F_IT, slot) & IT_OLD) ? F_LOLD : F_L;  // the sample it belongs to
#pragma unroll
                    for (int k = 0; k < 3; ++k) {
                        fld(st, f + k, slot) = fld(st, f + k, slot) +
                                               fld(st, F_SBETA + k, slot) * (occluded ? 0.0f : fld(st, F_SC + k, slot));
                    }
                    if (PROF) {
                        sp[SPLIT_SHADOW] += 1ull;
                        sp[SPLIT_SHADOW_TRI] += (unsigned long long)B.tri_before[tested];
                        sp[SPLIT_SHADOW_SPH] += (unsigned long long)(tested - B.tri_before[tested]);
                    }
                } else {
                    if (PROF) sp[SPLIT_CLOSEST] += 1ull;
                    int key = S_DEAD;
                    if (hit >= 0) {
                        fld(st, F_NV, slot) = fld(st, F_NV, slot) + 1.0f;
#pragma unroll
                        for (int k = 0; k < 3; ++k) fld(st, F_HA + k, slot) = a[k];
                        const float* m = mat_rec<TEX>(blob, (int)prim_rec(blob, hit)[P_MAT]);
                        shades = geti(st, F_BOUNCES, slot) < max_depth - 1 && (int)m[M_LOBE] != LOBE_NONE;
                        if (shades) key = hit;
                        // the cone's distance at this hit (t_spread + t); kept when the path
                        // goes on, restarted with the next sample otherwise
                        if (TEX && shades) fld(st, F_TSPREAD, slot) = fld(st, F_TSPREAD, slot) + t_hit;
                    }
                    seti(st, F_KEY, slot, key);
                }
            }
            const int pos = warp_take(shades, &B.n_hit);
            if (shades) B.hlist[pos] = slot;
        }
        if (PROF) sp[SPLIT_POOL_BUSY] += (unsigned long long)(clock64() - t_ph);
        __syncthreads();
        if (PROF && tid == 0) t_w = clock64();

        // --- 2. BSDF sample, NEE light sample and continuation of every hit ---
        if (PROF) t_ph = clock64();
        const int n_hit = B.n_hit;
        if (tid == 0) {  // every thread read it before the last barrier
            B.n_walk = 0;
            B.n_wait = 0;
        }
        for (int base = 0; base < n_hit; base += THREADS) {
            bool want_sh = false;
            int sslot = -1;
            if (base + tid < n_hit) {
                sslot = B.hlist[base + tid];
                want_sh = shade<SAMPLER, IKIND, TEX>(st, sslot, blob, atlas, tex);
            }
            const int shpos = warp_take(want_sh, &B.n_sh_next);
            if (want_sh) B.shlist[shpos] = sslot;
        }
        if (PROF && tid < n_hit) sp[SPLIT_SHADE_BUSY] += (unsigned long long)(clock64() - t_ph);
        __syncthreads();
        if (PROF && tid == 0) t_s = clock64();

        // --- 3. flush finished samples; regenerate, or take the next pixel ---
        if (tid == 0) {
            B.n_sh = B.n_sh_next;
            B.n_sh_next = 0;
            B.n_hit = 0;
        }
        {
            const int i = tid;
            const int lane = geti(st, F_LANE, i);
            const int state = lane >= 0 ? flush(st, i, lane, blob, s_end, n_samples, cap, out_l, out_w, out_nv,
                                               counters) : 0;
            const bool finish = state == 1;
            const int next = warp_take(finish, queue);
            bool starts = state == 2;
            if (finish) {
                if (next < n_lanes) {
                    take_pixel(st, i, pid_in, hseed, s0, next);
                    starts = true;
                } else {
                    seti(st, F_LANE, i, -1);
                }
            }
            const bool walks = geti(st, F_LANE, i) >= 0 && state != -1;
            const int pos = warp_take(walks, &B.n_walk);
            if (walks) B.wlist[pos] = i;
            if (starts) start_sample<SAMPLER, TEX>(st, i, blob, px_in, py_in);
            if (PROF && state == -1) atomicAdd(&B.n_wait, 1);
        }
        __syncthreads();

        if (PROF && tid == 0) {
            const long long t = clock64();
            const unsigned long long nw = (unsigned long long)n_walk, nq = (unsigned long long)n_wait;
            sp[SPLIT_POOL] += (unsigned long long)(t_w - t_mark) * nw;
            sp[SPLIT_POOL_LANES] += (unsigned long long)(t_w - t_mark) * THREADS;
            sp[SPLIT_SHADE] += (unsigned long long)(t_s - t_w) * nw;
            sp[SPLIT_FLUSH] += (unsigned long long)(t - t_s) * nw;
            sp[SPLIT_WAIT] += (unsigned long long)(t - t_mark) * nq;
            sp[SPLIT_IDLE] += (unsigned long long)(t - t_mark) * (THREADS - nw - nq);
            sp[SPLIT_ITERS] += 1ull;
            t_mark = t;
        }
    }

    // the queue's reset by the grid's last block
    if (tid == 0) {
        __threadfence();
        if (atomicAdd(reinterpret_cast<unsigned int*>(&queue[1]), 1u) == gridDim.x - 1) {
            queue[0] = 0;
            queue[1] = 0;
            __threadfence();
        }
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

// the kernel of a mode (tex * 6 + sampler * 2 + ikind; sampler 0 =
// (0,2)-sequence, 1 = random, 2 = stratified; ikind 0 = path, 1 =
// directlighting; tex 1 = the atlas), or nullptr for a bad mode
static const void* kernel_for(int mode) {
    switch (mode) {
        case 0: return (const void*)brute_megakernel_kernel<0, 0, 0, 0>;
        case 1: return (const void*)brute_megakernel_kernel<0, 1, 0, 0>;
        case 2: return (const void*)brute_megakernel_kernel<1, 0, 0, 0>;
        case 3: return (const void*)brute_megakernel_kernel<1, 1, 0, 0>;
        case 4: return (const void*)brute_megakernel_kernel<2, 0, 0, 0>;
        case 5: return (const void*)brute_megakernel_kernel<2, 1, 0, 0>;
        case 6: return (const void*)brute_megakernel_kernel<0, 0, 1, 0>;
        case 7: return (const void*)brute_megakernel_kernel<0, 1, 1, 0>;
        case 8: return (const void*)brute_megakernel_kernel<1, 0, 1, 0>;
        case 9: return (const void*)brute_megakernel_kernel<1, 1, 1, 0>;
        case 10: return (const void*)brute_megakernel_kernel<2, 0, 1, 0>;
        case 11: return (const void*)brute_megakernel_kernel<2, 1, 1, 0>;
        default: return nullptr;
    }
}

// Resident blocks of THREADS threads per SM for kern. Returns a cudaError_t.
static int occupancy_of(const void* kern, int* blocks_per_sm) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kern, THREADS, 0);
}

// Launch kern on the persistent grid: min(resident blocks per SM x SMs,
// the blocks n_lanes can fill). Returns a cudaError_t.
static int launch(const void* kern, const void* blob, const void* px, const void* py, const void* pid, int n_lanes,
                  unsigned int seed, unsigned int s0, int n_samples, void* out_l, void* out_w, void* out_nv,
                  void* counters, void* queue, const void* atlas, const void* tex, void* stream, void* prof) {
    if (n_lanes <= 0) return (int)cudaGetLastError();
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = (cudaError_t)occupancy_of(kern, &per_sm);
    if (e != cudaSuccess) return (int)e;
    const long long fill = ((long long)n_lanes + THREADS - 1) / THREADS;
    const long long grid = (long long)per_sm * sms;
    const int blocks = (int)(fill < grid ? fill : grid);
    if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
    uint32_t seed_u = seed, s0_u = s0;
    void* args[] = {&blob, &px, &py, &pid, &n_lanes, &seed_u, &s0_u, &n_samples, &out_l, &out_w, &out_nv,
                    &counters, &queue, &atlas, &tex, &prof};
    return (int)cudaLaunchKernel(kern, dim3(blocks), dim3(THREADS), args, 0, (cudaStream_t)stream);
}

// counters: one u32, pixels cut by the iteration cap; queue: two int32 on the device, zero before the launch
// (the grid's last block zeroes them again); atlas, tex: the Kd atlas and
// the texture table (the textured modes; else unread). Returns the
// cudaError_t of the launch (or cudaErrorInvalidValue for a bad mode).
extern "C" int brute_megakernel(const void* blob, const void* px, const void* py, const void* pid, int n_lanes,
                                unsigned int seed, unsigned int s0, int n_samples, int mode, void* out_l,
                                void* out_w, void* out_nv, void* counters, void* queue, const void* atlas,
                                const void* tex, void* stream) {
    const void* kern = kernel_for(mode);
    if (kern == nullptr) return (int)cudaErrorInvalidValue;
    return launch(kern, blob, px, py, pid, n_lanes, seed, s0, n_samples, out_l, out_w, out_nv, counters, queue,
                  atlas, tex, stream, nullptr);
}

// The instrumented instantiation ((0,2) sampler, path, mode 0, only):
// brute_megakernel's launch, and the cycle split and test counts (N_SPLIT
// u64) added into prof.
extern "C" int brute_megakernel_split(const void* blob, const void* px, const void* py, const void* pid,
                                      int n_lanes, unsigned int seed, unsigned int s0, int n_samples, int mode,
                                      void* out_l, void* out_w, void* out_nv, void* counters, void* queue,
                                      const void* atlas, const void* tex, void* stream, void* prof) {
    if (mode != 0) return (int)cudaErrorInvalidValue;
    return launch((const void*)brute_megakernel_kernel<0, 0, 0, 1>, blob, px, py, pid, n_lanes, seed, s0,
                  n_samples, out_l, out_w, out_nv, counters, queue, atlas, tex, stream, prof);
}

// Resident blocks of THREADS threads per SM for one mode.
extern "C" int brute_megakernel_occupancy(int mode, int* blocks_per_sm) {
    const void* kern = kernel_for(mode);
    if (kern == nullptr) return (int)cudaErrorInvalidValue;
    return occupancy_of(kern, blocks_per_sm);
}
