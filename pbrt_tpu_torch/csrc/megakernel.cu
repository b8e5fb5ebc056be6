// Brute-force persistent path-tracing megakernel, one thread per lane.
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
// What changed from the TPU kernel, and why:
//  - The TPU bakes the scene into its instruction stream and runs 16x128
//    lanes in lock step until all of them are done. Here the scene is one
//    float blob (device/megakernel.py pack_consts, offsets below), copied
//    into shared memory by each block at its start, and every thread runs
//    its own loop with the same iteration cap. A finished lane's state never
//    changes again, so the per-lane loop gives the block loop's result.
//  - The brute loops read the same prim record in every thread of a warp:
//    a shared-memory broadcast.
//  - Sampler and integrator kind are template parameters.
//
// Bound: float32 work outside the tensor cores. Per lane-iteration the
// kernel does about 2 x n_prims ray-prim tests (closest hit, then one shadow
// ray) plus the shading, against 67 TFLOP/s; device memory traffic is three
// int32 inputs and five float32 outputs per lane, negligible. The design
// answers the bound by keeping the scene in shared memory and the path state
// in registers. Warp divergence between lanes that finish early and lanes
// that bounce on is expected; regrouping lanes is later work.
//
// Arithmetic: uint32 hash and Sobol' math is native and bit-exact with the
// twin. Built with -fmad=false and without fast math, like wide_traverse.cu:
// the watertight edge functions x1*y2 - y1*x2 are exact only without FMA
// contraction, and 1/x and sqrtf stay IEEE. sinf/cosf/powf/logf may differ
// from torch's by ulps, so the kernel is held to its twin at image level.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// prim record
#define P_KIND 0
#define P_MAT 1
#define P_FLAGS 2
#define P_V 3
#define P_NG 12
#define P_NS 15
#define P_SS 18
#define P_TS 21
#define P_W2O 3
#define P_O2W 15
#define P_R 27
#define P_R2 28
#define P_PHIMAX 29
#define P_ERRC 30

// material record
#define M_LOBE 0
#define M_COLOR 1
#define M_ETA 4
#define M_KT 5
#define M_FRESNEL 8
#define M_KS 9
#define M_AX 12
#define M_AY 13
#define M_FR_M 14
#define M_ETA_M 15
#define M_ETA_RGB 16
#define M_K_RGB 19
#define M_ON_A 22
#define M_ON_B 23

// light kinds (scene/arrays.py LIGHT_*)
#define LIGHT_POINT 0
#define LIGHT_SPOT 1
#define LIGHT_DISTANT 2

// lobe ids (device/bsdf.py; LOBE_PLASTIC is the baked Lambert+GGX row)
#define LOBE_NONE 0
#define LOBE_LAMBERT_R 1
#define LOBE_OREN_NAYAR 3
#define LOBE_MICRO_R 4
#define LOBE_SPEC_R 6
#define LOBE_FRESNEL_SPEC 8
#define LOBE_PLASTIC 100

#define FLAG_FLIP_GEOM_N 1

#define SHADOW_EPS 1e-4f
#define DPB 8u
#define INV_PI_F 0.31830987f      // float32(1/pi)
#define PI_F 3.14159274f          // float32(pi)
#define PIO4_F 0.785398185f       // float32(pi/4)
#define PIO2_F 1.57079637f        // float32(pi/2)
#define ONE_MINUS_EPS 0.99999994f // float32(1 - 2^-24)
#define INV_2_32 2.3283064365386963e-10f  // 2^-32
#define SHADOW_SCALE 0.998f       // float32(1 - 2 * RAY_EPS)

// --- hashing and low-discrepancy samples (uint32, bit-exact) ---------------

__device__ __forceinline__ uint32_t pcg(uint32_t x) {
    uint32_t state = x * 747796405u + 2891336453u;
    uint32_t word = ((state >> ((state >> 28) + 4u)) ^ state) * 277803737u;
    return (word >> 22) ^ word;
}

__device__ __forceinline__ float u2f01(uint32_t u) {
    float f = (float)(int32_t)u;
    if (f < 0.0f) f = f + 4294967296.0f;
    return fminf(f * INV_2_32, ONE_MINUS_EPS);
}

__device__ __forceinline__ float vdc(uint32_t index, uint32_t scramble) {
    return u2f01(__brev(index) ^ scramble);
}

__device__ __forceinline__ float sobol2(uint32_t index, uint32_t scramble) {
    uint32_t res = scramble;
    uint32_t v = 1u << 31;
    for (int i = 0; i < 32; ++i) {
        if ((index >> i) & 1u) res ^= v;
        v ^= v >> 1;
    }
    return u2f01(res);
}

template <int SAMPLER>
__device__ __forceinline__ float sample_1d(uint32_t hbase, uint32_t s, uint32_t dim) {
    if (SAMPLER != 0) return u2f01(pcg(pcg(hbase ^ s) ^ (1024u + dim)));
    return vdc(s, pcg(hbase ^ (4096u + dim)));
}

template <int SAMPLER>
__device__ __forceinline__ void sample_2d(uint32_t hbase, uint32_t s, uint32_t dim, float& u1, float& u2) {
    uint32_t d2 = 2u * dim;
    if (SAMPLER != 0) {
        uint32_t h = pcg(hbase ^ s);
        u1 = u2f01(pcg(h ^ d2));
        u2 = u2f01(pcg(h ^ (d2 + 1u)));
    } else {
        u1 = vdc(s, pcg(hbase ^ d2));
        u2 = sobol2(s, pcg(hbase ^ (d2 + 1u)));
    }
}

// --- small vector helpers (every multiply and add rounded on its own) ------

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by, float bz) {
    return ax * bx + ay * by + az * bz;
}

__device__ __forceinline__ void norm3(float& x, float& y, float& z) {
    float n = sqrtf(fmaxf(x * x + y * y + z * z, 0.0f));
    float inv = 1.0f / fmaxf(n, 1e-30f);
    x = x * inv;
    y = y * inv;
    z = z * inv;
}

__device__ __forceinline__ float next_float_away(float x, float dir) {
    if (dir == 0.0f) return x;
    bool up = dir > 0.0f;
    if (x == 0.0f) return up ? 1.17549435e-38f : -1.17549435e-38f;
    int bits = __float_as_int(x);
    bits += (up == (x >= 0.0f)) ? 1 : -1;
    return __int_as_float(bits);
}

struct Hit {
    float px, py, pz;
    float ngx, ngy, ngz, nsx, nsy, nsz, ssx, ssy, ssz, tsx, tsy, tsz;
    float ex, ey, ez;
    int mat;
};

__device__ __forceinline__ void offset_ray(const Hit& h, float wx, float wy, float wz,
                                           float& ox, float& oy, float& oz) {
    float d = fabsf(h.ngx) * h.ex + fabsf(h.ngy) * h.ey + fabsf(h.ngz) * h.ez;
    float offx = d * h.ngx, offy = d * h.ngy, offz = d * h.ngz;
    if (dot3(wx, wy, wz, h.ngx, h.ngy, h.ngz) < 0.0f) {
        offx = -offx;
        offy = -offy;
        offz = -offz;
    }
    ox = next_float_away(h.px + offx, offx);
    oy = next_float_away(h.py + offy, offy);
    oz = next_float_away(h.pz + offz, offz);
}

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

__device__ __forceinline__ void xf_point(const float* m, float x, float y, float z, float& ox, float& oy, float& oz) {
    ox = m[0] * x + m[1] * y + m[2] * z + m[3];
    oy = m[4] * x + m[5] * y + m[6] * z + m[7];
    oz = m[8] * x + m[9] * y + m[10] * z + m[11];
}

// full-sphere quadric (intersect.ray_quadric sphere branch); p_loc is the
// object-space hit before reprojection
__device__ __forceinline__ bool sph_test(const float* pr, float ox, float oy, float oz, float dx, float dy,
                                         float dz, float t_query, float& t, float& plx, float& ply, float& plz) {
    const float* m = pr + P_W2O;
    float oox, ooy, ooz;
    xf_point(m, ox, oy, oz, oox, ooy, ooz);
    float odx = m[0] * dx + m[1] * dy + m[2] * dz;
    float ody = m[4] * dx + m[5] * dy + m[6] * dz;
    float odz = m[8] * dx + m[9] * dy + m[10] * dz;
    float a = dot3(odx, ody, odz, odx, ody, odz);
    float b = 2.0f * dot3(oox, ooy, ooz, odx, ody, odz);
    float c = dot3(oox, ooy, ooz, oox, ooy, ooz) - pr[P_R2];
    float disc = b * b - 4.0f * a * c;
    bool has_root = disc > 0.0f;
    float sq = sqrtf(fmaxf(disc, 0.0f));
    float q = b < 0.0f ? -0.5f * (b - sq) : -0.5f * (b + sq);
    float safe = fabsf(q) > 1e-30f ? q : 1.0f;
    float t0 = q / (fabsf(a) > 1e-30f ? a : 1e-30f);
    float t1 = c / safe;
    float tn = fminf(t0, t1), tf = fmaxf(t0, t1);
    bool near_valid = has_root && tn > SHADOW_EPS && tn < t_query;
    bool far_valid = has_root && tf > SHADOW_EPS && tf < t_query;
    t = near_valid ? tn : tf;
    plx = oox + odx * t;
    ply = ooy + ody * t;
    plz = ooz + odz * t;
    return near_valid || far_valid;
}

// surface_interaction sphere branch with constant transforms
__device__ __forceinline__ void sph_attrs(const float* pr, float g53, float px_o, float py_o, float pz_o, Hit& h) {
    const float* o2w = pr + P_O2W;
    const float* w2o = pr + P_W2O;
    float r = pr[P_R];
    float norm = sqrtf(fmaxf(px_o * px_o + py_o * py_o + pz_o * pz_o, 1e-30f));
    float scale = r / fmaxf(norm, 1e-30f);
    px_o = px_o * scale;
    py_o = py_o * scale;
    pz_o = pz_o * scale;
    float nx = px_o / r, ny = py_o / r, nz = pz_o / r;
    float ngx = w2o[0] * nx + w2o[4] * ny + w2o[8] * nz;
    float ngy = w2o[1] * nx + w2o[5] * ny + w2o[9] * nz;
    float ngz = w2o[2] * nx + w2o[6] * ny + w2o[10] * nz;
    norm3(ngx, ngy, ngz);
    if ((int)pr[P_FLAGS] & FLAG_FLIP_GEOM_N) {
        ngx = -ngx;
        ngy = -ngy;
        ngz = -ngz;
    }
    float pm = pr[P_PHIMAX];
    float dux_o = -pm * py_o, duy_o = pm * px_o;
    float dux = o2w[0] * dux_o + o2w[1] * duy_o;
    float duy = o2w[4] * dux_o + o2w[5] * duy_o;
    float duz = o2w[8] * dux_o + o2w[9] * duy_o;
    float dot_nd = dot3(ngx, ngy, ngz, dux, duy, duz);
    float sxp = dux - ngx * dot_nd, syp = duy - ngy * dot_nd, szp = duz - ngz * dot_nd;
    float sl = sqrtf(fmaxf(sxp * sxp + syp * syp + szp * szp, 0.0f));
    float ssx, ssy, ssz;
    if (sl > 1e-9f) {
        float inv_sl = 1.0f / fmaxf(sl, 1e-20f);
        ssx = sxp * inv_sl;
        ssy = syp * inv_sl;
        ssz = szp * inv_sl;
    } else {  // coordinate_system fallback
        float sign = ngz >= 0.0f ? 1.0f : -1.0f;
        float a_f = -1.0f / (sign + ngz);
        float b_f = ngx * ngy * a_f;
        ssx = 1.0f + sign * ngx * ngx * a_f;
        ssy = sign * b_f;
        ssz = -sign * ngx;
    }
    h.ngx = ngx; h.ngy = ngy; h.ngz = ngz;
    h.nsx = ngx; h.nsy = ngy; h.nsz = ngz;
    h.ssx = ssx; h.ssy = ssy; h.ssz = ssz;
    h.tsx = ngy * ssz - ngz * ssy;
    h.tsy = ngz * ssx - ngx * ssz;
    h.tsz = ngx * ssy - ngy * ssx;
    xf_point(o2w, px_o, py_o, pz_o, h.px, h.py, h.pz);
    float apx = fabsf(px_o), apy = fabsf(py_o), apz = fabsf(pz_o);
    h.ex = g53 * (fabsf(o2w[0]) * apx + fabsf(o2w[1]) * apy + fabsf(o2w[2]) * apz) + pr[P_ERRC];
    h.ey = g53 * (fabsf(o2w[4]) * apx + fabsf(o2w[5]) * apy + fabsf(o2w[6]) * apz) + pr[P_ERRC + 1];
    h.ez = g53 * (fabsf(o2w[8]) * apx + fabsf(o2w[9]) * apy + fabsf(o2w[10]) * apz) + pr[P_ERRC + 2];
}

// closest hit over all prims, in blob order
__device__ bool intersect_closest(const float* blob, float ox, float oy, float oz, float dx, float dy, float dz,
                                  Hit& h) {
    const int n_prims = (int)blob[H_N_PRIMS];
    const float g7 = blob[H_G7], g53 = blob[H_G53];
    RaySetup rs = ray_setup(dx, dy, dz);
    const float BIG = 1e30f;
    float t_best = BIG;
    for (int i = 0; i < n_prims; ++i) {
        const float* pr = blob + PRIM_BASE + i * PRIM_STRIDE;
        float t;
        if (pr[P_KIND] == 0.0f) {
            float b1, b2;
            bool hit = tri_test(pr, rs, ox, oy, oz, INFINITY, t, b1, b2);
            if (!(hit && t < t_best)) continue;
            t_best = t;
            float b0 = 1.0f - b1 - b2;
            const float* v = pr + P_V;
            h.px = b0 * v[0] + b1 * v[3] + b2 * v[6];
            h.py = b0 * v[1] + b1 * v[4] + b2 * v[7];
            h.pz = b0 * v[2] + b1 * v[5] + b2 * v[8];
            float ab0 = fabsf(b0), ab1 = fabsf(b1), ab2 = fabsf(b2);
            h.ex = g7 * (ab0 * fabsf(v[0]) + ab1 * fabsf(v[3]) + ab2 * fabsf(v[6]));
            h.ey = g7 * (ab0 * fabsf(v[1]) + ab1 * fabsf(v[4]) + ab2 * fabsf(v[7]));
            h.ez = g7 * (ab0 * fabsf(v[2]) + ab1 * fabsf(v[5]) + ab2 * fabsf(v[8]));
            h.ngx = pr[P_NG]; h.ngy = pr[P_NG + 1]; h.ngz = pr[P_NG + 2];
            h.nsx = pr[P_NS]; h.nsy = pr[P_NS + 1]; h.nsz = pr[P_NS + 2];
            h.ssx = pr[P_SS]; h.ssy = pr[P_SS + 1]; h.ssz = pr[P_SS + 2];
            h.tsx = pr[P_TS]; h.tsy = pr[P_TS + 1]; h.tsz = pr[P_TS + 2];
        } else {
            float plx, ply, plz;
            bool hit = sph_test(pr, ox, oy, oz, dx, dy, dz, INFINITY, t, plx, ply, plz);
            if (!(hit && t < t_best)) continue;
            t_best = t;
            sph_attrs(pr, g53, plx, ply, plz, h);
        }
        h.mat = (int)pr[P_MAT];
    }
    return t_best < BIG;
}

// any hit with t in (SHADOW_EPS, t_query)
__device__ bool intersect_any(const float* blob, float ox, float oy, float oz, float dx, float dy, float dz,
                              float t_query) {
    const int n_prims = (int)blob[H_N_PRIMS];
    RaySetup rs = ray_setup(dx, dy, dz);
    for (int i = 0; i < n_prims; ++i) {
        const float* pr = blob + PRIM_BASE + i * PRIM_STRIDE;
        float t, a, b, c;
        bool hit = pr[P_KIND] == 0.0f ? tri_test(pr, rs, ox, oy, oz, t_query, t, a, b)
                                      : sph_test(pr, ox, oy, oz, dx, dy, dz, t_query, t, a, b, c);
        if (hit) return true;
    }
    return false;
}

// --- camera --------------------------------------------------------------------

template <int SAMPLER>
__device__ __forceinline__ void regen(const float* blob, uint32_t hbase, float pxf, float pyf, uint32_t s,
                                      float& ox, float& oy, float& oz, float& dx, float& dy, float& dz) {
    float u1, u2;
    if (SAMPLER != 0) {
        uint32_t h = pcg(hbase ^ s);
        u1 = u2f01(pcg(h));
        u2 = u2f01(pcg(h ^ 1u));
        if (SAMPLER == 2) {
            // the reference's strata: floor(sqrt(spp)) x spp // that, always
            // jittered (ROADMAP C)
            int xs = (int)blob[H_STRAT_XS], ys = (int)blob[H_STRAT_YS];
            uint32_t idx = s % (uint32_t)(xs * ys);
            u1 = ((float)(idx % (uint32_t)xs) + u1) / (float)xs;
            u2 = ((float)((idx / (uint32_t)xs) % (uint32_t)ys) + u2) / (float)ys;
        }
    } else {
        u1 = vdc(s, pcg(hbase));
        u2 = sobol2(s, pcg(hbase ^ 1u));
    }
    float fx = pxf + 0.5f + (2.0f * u1 - 1.0f) * blob[H_FXW];
    float fy = pyf + 0.5f + (2.0f * u2 - 1.0f) * blob[H_FYW];
    const float* r2c = blob + H_R2C;
    float cx = r2c[0] * fx + r2c[1] * fy + r2c[3];
    float cy = r2c[4] * fx + r2c[5] * fy + r2c[7];
    float cz = r2c[8] * fx + r2c[9] * fy + r2c[11];
    float w = r2c[12] * fx + r2c[13] * fy + r2c[15];
    float inv_w = 1.0f / w;
    cx = cx * inv_w;
    cy = cy * inv_w;
    cz = cz * inv_w;
    norm3(cx, cy, cz);
    const float* c2w = blob + H_C2W;
    dx = c2w[0] * cx + c2w[1] * cy + c2w[2] * cz;
    dy = c2w[4] * cx + c2w[5] * cy + c2w[6] * cz;
    dz = c2w[8] * cx + c2w[9] * cy + c2w[10] * cz;
    norm3(dx, dy, dz);
    ox = c2w[3];
    oy = c2w[7];
    oz = c2w[11];
}

// --- BSDF pieces (bsdf.py channel forms) ----------------------------------------

__device__ __forceinline__ float fresnel_dielectric(float cos_i, float eta) {
    cos_i = fminf(fmaxf(cos_i, -1.0f), 1.0f);
    bool entering = cos_i > 0.0f;
    float ei = entering ? 1.0f : eta;
    float et = entering ? eta : 1.0f;
    float ci = fabsf(cos_i);
    float sin_t = ei / et * sqrtf(fmaxf(1.0f - ci * ci, 0.0f));
    float ct = sqrtf(fmaxf(1.0f - sin_t * sin_t, 0.0f));
    float r_parl = (et * ci - ei * ct) / fmaxf(et * ci + ei * ct, 1e-30f);
    float r_perp = (ei * ci - et * ct) / fmaxf(ei * ci + et * ct, 1e-30f);
    return sin_t >= 1.0f ? 1.0f : 0.5f * (r_parl * r_parl + r_perp * r_perp);
}

__device__ __forceinline__ float fresnel_conductor(float cos_i, float eta, float k) {
    float ci = fminf(fmaxf(fabsf(cos_i), 0.0f), 1.0f);
    float cos2 = ci * ci;
    float sin2 = 1.0f - cos2;
    float eta2 = eta * eta;
    float k2 = k * k;
    float t0 = eta2 - k2 - sin2;
    float a2b2 = sqrtf(fmaxf(t0 * t0 + 4.0f * eta2 * k2, 0.0f));
    float t1 = a2b2 + cos2;
    float a = sqrtf(fmaxf(0.5f * (a2b2 + t0), 0.0f));
    float t2 = 2.0f * a * ci;
    float rs = (t1 - t2) / fmaxf(t1 + t2, 1e-30f);
    float t3 = cos2 * a2b2 + sin2 * sin2;
    float t4 = t2 * sin2;
    float rp = rs * (t3 - t4) / fmaxf(t3 + t4, 1e-30f);
    return 0.5f * (rp + rs);
}

__device__ __forceinline__ float ggx_d(float hx, float hy, float hz, float ax, float ay) {
    float c2 = hz * hz;
    if (!(c2 > 1e-12f)) return 0.0f;
    float e = (hx * hx / fmaxf(ax * ax, 1e-12f) + hy * hy / fmaxf(ay * ay, 1e-12f)) / fmaxf(c2, 1e-12f);
    float e1 = 1.0f + e;
    float denom = PI_F * ax * ay * c2 * c2 * (e1 * e1);
    return 1.0f / fmaxf(denom, 1e-20f);
}

__device__ __forceinline__ float ggx_lambda(float x, float y, float z, float ax, float ay) {
    float c2 = z * z;
    float a2 = x * x * ax * ax + y * y * ay * ay;
    float alpha2_tan2 = c2 > 1e-12f ? a2 / fmaxf(c2, 1e-12f) : 1e12f;
    float lam = 0.5f * (-1.0f + sqrtf(1.0f + alpha2_tan2));
    return fabsf(z) > 1e-6f ? lam : 1e6f;
}

// visible-normal GGX sampling (bsdf.ggx_sample_wh, channel form)
__device__ __forceinline__ void ggx_sample_wh(float wo_x, float wo_y, float wo_z, float u1, float u2, float ax,
                                              float ay, float& hx, float& hy, float& hz) {
    bool flip = wo_z < 0.0f;
    float sx = ax * (flip ? -wo_x : wo_x), sy = ay * (flip ? -wo_y : wo_y), sz = flip ? -wo_z : wo_z;
    norm3(sx, sy, sz);
    float tl = sqrtf(fmaxf(sx * sx + sy * sy, 0.0f));
    bool near_z = sz >= 0.9999f;
    float inv_tl = 1.0f / fmaxf(tl, 1e-30f);
    float t1x = near_z ? 1.0f : -sy * inv_tl;
    float t1y = near_z ? 0.0f : sx * inv_tl;
    float t2x = sy * 0.0f - sz * t1y;
    float t2y = sz * t1x - sx * 0.0f;
    float t2z = sx * t1y - sy * t1x;
    float a = 1.0f / (1.0f + sz);
    float r = sqrtf(fmaxf(u1, 0.0f));
    bool lower = u2 < a;
    float phi = lower ? u2 / fmaxf(a, 1e-12f) * PI_F : PI_F + (u2 - a) / fmaxf(1.0f - a, 1e-12f) * PI_F;
    float p1 = r * cosf(phi);
    float p2 = r * sinf(phi) * (lower ? 1.0f : sz);
    float p3 = sqrtf(fmaxf(1.0f - p1 * p1 - p2 * p2, 0.0f));
    float nhx = p1 * t1x + p2 * t2x + p3 * sx;
    float nhy = p1 * t1y + p2 * t2y + p3 * sy;
    float nhz = p2 * t2z + p3 * sz;
    hx = ax * nhx;
    hy = ay * nhy;
    hz = fmaxf(nhz, 1e-6f);
    norm3(hx, hy, hz);
    if (flip) {
        hx = -hx;
        hy = -hy;
        hz = -hz;
    }
}

// GGX f (rgb, no cosine) and visible-normal pdf toward wi, local frame
__device__ __forceinline__ void micro_f_pdf(const float* m, float wo_x, float wo_y, float wo_z, float wi_x,
                                            float wi_y, float wi_z, float f[3], float& pdf) {
    float ax = m[M_AX], ay = m[M_AY];
    float whx = wi_x + wo_x, why = wi_y + wo_y, whz = wi_z + wo_z;
    float wh_len = sqrtf(whx * whx + why * why + whz * whz);
    float inv_l = 1.0f / fmaxf(wh_len, 1e-30f);
    float hx = whx * inv_l, hy = why * inv_l, hz = whz * inv_l;
    float d_val = ggx_d(hx, hy, hz, ax, ay);
    float lam_o = ggx_lambda(wo_x, wo_y, wo_z, ax, ay);
    float g_val = 1.0f / (1.0f + lam_o + ggx_lambda(wi_x, wi_y, wi_z, ax, ay));
    float cos_f = (wi_x * hx + wi_y * hy + wi_z * hz) * (hz < 0.0f ? -1.0f : 1.0f);
    int fr_m = (int)m[M_FR_M];
    float abs_ci = fabsf(wi_z), abs_co = fabsf(wo_z);
    float base = d_val * g_val / fmaxf(4.0f * abs_co * abs_ci, 1e-12f);
    bool refl_hemi = wo_z * wi_z > 0.0f;
    bool ok = refl_hemi && wh_len > 1e-12f && abs_ci > 0.0f && abs_co > 0.0f;
    float fd = fr_m == 1 ? fresnel_dielectric(cos_f, m[M_ETA_M]) : 1.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        float fr = fr_m == 2 ? fresnel_conductor(cos_f, m[M_ETA_RGB + c], m[M_K_RGB + c]) : fd;
        f[c] = ok ? m[M_KS + c] * fr * base : 0.0f;
    }
    float g1 = 1.0f / (1.0f + lam_o);
    float dot_oh = fabsf(wo_x * hx + wo_y * hy + wo_z * hz);
    float p = d_val * g1 * dot_oh / fmaxf(abs_co, 1e-9f) / fmaxf(4.0f * dot_oh, 1e-12f);
    pdf = refl_hemi ? p : 0.0f;
}

// Oren-Nayar f / kd
__device__ __forceinline__ float on_factor(const float* m, float wo_x, float wo_y, float wo_z, float wi_x,
                                           float wi_y, float wi_z) {
    float si = sqrtf(fmaxf(1.0f - wi_z * wi_z, 0.0f));
    float so = sqrtf(fmaxf(1.0f - wo_z * wo_z, 0.0f));
    float cpi = si > 1e-4f ? wi_x / fmaxf(si, 1e-12f) : 1.0f;
    float spi = si > 1e-4f ? wi_y / fmaxf(si, 1e-12f) : 0.0f;
    float cpo = so > 1e-4f ? wo_x / fmaxf(so, 1e-12f) : 1.0f;
    float spo = so > 1e-4f ? wo_y / fmaxf(so, 1e-12f) : 0.0f;
    float max_cos = fmaxf(cpi * cpo + spi * spo, 0.0f);
    float abs_ci = fabsf(wi_z), abs_co = fabsf(wo_z);
    bool big_i = abs_ci > abs_co;
    float sin_alpha = big_i ? so : si;
    float tan_beta = big_i ? si / fmaxf(abs_ci, 1e-9f) : so / fmaxf(abs_co, 1e-9f);
    return INV_PI_F * (m[M_ON_A] + m[M_ON_B] * max_cos * sin_alpha * tan_beta);
}

__device__ __forceinline__ void to_local(const Hit& h, float x, float y, float z, float& lx, float& ly, float& lz) {
    lx = dot3(x, y, z, h.ssx, h.ssy, h.ssz);
    ly = dot3(x, y, z, h.tsx, h.tsy, h.tsz);
    lz = dot3(x, y, z, h.nsx, h.nsy, h.nsz);
}

struct BsdfSample {
    float wx, wy, wz;  // world direction
    float f[3];
    float pdf;
    float eta_scale;
    bool specular, valid;
};

// bsdf_sample for the baked lobe classes
template <int SAMPLER>
__device__ BsdfSample bsdf_sample(const float* m, uint32_t hbase, uint32_t s, uint32_t dim_base, const Hit& h,
                                  float wox, float woy, float woz) {
    float wo_x, wo_y, wo_z;
    to_local(h, wox, woy, woz, wo_x, wo_y, wo_z);
    float u1, u2;
    sample_2d<SAMPLER>(hbase, s, dim_base + 3u, u1, u2);
    const int lobe = (int)m[M_LOBE];
    const bool lam = lobe == LOBE_LAMBERT_R || lobe == LOBE_PLASTIC;
    const bool on = lobe == LOBE_OREN_NAYAR;
    const bool diff_like = lam || on;
    const bool mic = lobe == LOBE_MICRO_R || lobe == LOBE_PLASTIC;
    const bool plast = lobe == LOBE_PLASTIC;
    const bool mirror = lobe == LOBE_SPEC_R;
    const bool glass = lobe == LOBE_FRESNEL_SPEC;
    const bool entering = wo_z > 0.0f;
    const float eta = fmaxf(m[M_ETA], 1.000001f);

    BsdfSample bs;
    bs.valid = lobe != LOBE_NONE;
    float wix = 0.0f, wiy = 0.0f, wiz = 0.0f;
    int pick = 0;
    if (plast) {
        float u_lobe = sample_1d<SAMPLER>(hbase, s, dim_base + 2u);
        pick = min((int)(u_lobe * 2.0f), 1);
    }
    const bool samp_diff = diff_like && pick == 0;
    const bool samp_mic = mic && (!lam || pick == 1);
    if (samp_diff) {  // cosine hemisphere through the concentric disk
        float ox = 2.0f * u1 - 1.0f, oy = 2.0f * u2 - 1.0f;
        float r = 0.0f, theta = 0.0f;
        if (!(ox == 0.0f && oy == 0.0f)) {
            if (fabsf(ox) > fabsf(oy)) {
                r = ox;
                theta = PIO4_F * (oy / ox);
            } else {
                r = oy;
                theta = PIO2_F - PIO4_F * (ox / oy);
            }
        }
        wix = r * cosf(theta);
        wiy = r * sinf(theta);
        float dz = sqrtf(fmaxf(1.0f - wix * wix - wiy * wiy, 0.0f));
        wiz = entering ? dz : -dz;
    }
    if (samp_mic) {
        float hx, hy, hz;
        ggx_sample_wh(wo_x, wo_y, wo_z, u1, u2, m[M_AX], m[M_AY], hx, hy, hz);
        float dwh = wo_x * hx + wo_y * hy + wo_z * hz;
        wix = -wo_x + 2.0f * dwh * hx;
        wiy = -wo_y + 2.0f * dwh * hy;
        wiz = -wo_z + 2.0f * dwh * hz;
        bs.valid = bs.valid && wo_z * wiz > 0.0f;
    }
    if (mirror) {
        wix = -wo_x;
        wiy = -wo_y;
        wiz = wo_z;
    }
    float fr_s = 0.0f, eta_ratio = 1.0f;
    bool choose_r = false;
    if (glass) {
        fr_s = fresnel_dielectric(wo_z, eta);
        choose_r = u1 < fr_s;
        eta_ratio = entering ? 1.0f / eta : eta;
        float nz = entering ? 1.0f : -1.0f;
        float cos_i = nz * wo_z;
        float sin2_i = fmaxf(1.0f - cos_i * cos_i, 0.0f);
        float sin2_t = eta_ratio * eta_ratio * sin2_i;
        float cos_t = sqrtf(fmaxf(1.0f - sin2_t, 0.0f));
        if (choose_r) {
            wix = -wo_x;
            wiy = -wo_y;
            wiz = wo_z;
        } else {
            wix = eta_ratio * -wo_x;
            wiy = eta_ratio * -wo_y;
            wiz = eta_ratio * -wo_z + (eta_ratio * cos_i - cos_t) * nz;
            bs.valid = bs.valid && sin2_t < 1.0f;
        }
    }
    norm3(wix, wiy, wiz);
    const float abs_ci = fabsf(wiz);
    const float inv_ci = 1.0f / fmaxf(abs_ci, 1e-9f);
    bs.specular = mirror || glass;
    if (mirror) {
        float frm = (int)m[M_FRESNEL] == 1 ? fresnel_dielectric(wo_z, eta) : 1.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) bs.f[c] = m[M_COLOR + c] * frm * inv_ci;
        bs.pdf = 1.0f;
    } else if (glass) {
        float st_scale = eta_ratio * eta_ratio;
        float t_term = (1.0f - fr_s) * st_scale * inv_ci;
        float r_term = fr_s * inv_ci;
#pragma unroll
        for (int c = 0; c < 3; ++c) bs.f[c] = choose_r ? m[M_COLOR + c] * r_term : m[M_KT + c] * t_term;
        bs.pdf = choose_r ? fr_s : 1.0f - fr_s;
    } else {
        const bool refl_hemi = wo_z * wiz > 0.0f;
        float f_diff = lam && refl_hemi ? INV_PI_F : 0.0f;
        if (on && refl_hemi) f_diff = on_factor(m, wo_x, wo_y, wo_z, wix, wiy, wiz);
        float pdf = diff_like && refl_hemi ? abs_ci * INV_PI_F : 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) bs.f[c] = m[M_COLOR + c] * f_diff;
        if (mic) {
            float fm[3], p_m;
            micro_f_pdf(m, wo_x, wo_y, wo_z, wix, wiy, wiz, fm, p_m);
#pragma unroll
            for (int c = 0; c < 3; ++c) bs.f[c] = bs.f[c] + fm[c];
            pdf = pdf + p_m;
            if (plast) pdf = pdf / 2.0f;
        }
        bs.pdf = pdf;
    }
    bs.eta_scale = glass && !choose_r ? (entering ? eta * eta : 1.0f / (eta * eta)) : 1.0f;
    bs.valid = bs.valid && bs.pdf > 0.0f;
    bs.wx = wix * h.ssx + wiy * h.tsx + wiz * h.nsx;
    bs.wy = wix * h.ssy + wiy * h.tsy + wiz * h.nsy;
    bs.wz = wix * h.ssz + wiy * h.tsz + wiz * h.nsz;
    return bs;
}

// uniform_sample_onelight + estimate_direct for delta lights; adds the
// contribution (without beta) to c
template <int SAMPLER>
__device__ void nee(const float* blob, const float* m, uint32_t hbase, uint32_t s, uint32_t dim_base, const Hit& h,
                    float wox, float woy, float woz, float c[3]) {
    c[0] = c[1] = c[2] = 0.0f;
    const int n_lights = (int)blob[H_N_LIGHTS];
    int lid = 0;
    if (n_lights > 1) {
        float u_sel = sample_1d<SAMPLER>(hbase, s, dim_base);
        if (blob[H_UNIFORM] != 0.0f) {
            lid = min((int)(u_sel * (float)n_lights), n_lights - 1);
        } else {
            for (int i = 0; i < n_lights - 1; ++i) lid += u_sel > blob[H_CDF + i] ? 1 : 0;
            lid = min(max(lid, 0), n_lights - 1);
        }
    }
    const float* lt = blob + LIGHT_BASE + lid * LIGHT_STRIDE;
    const float* par = lt + 1;
    const int kind = (int)lt[0];
    float wix, wiy, wiz, li[3], dist;
    if (kind == LIGHT_DISTANT) {
        wix = par[0];
        wiy = par[1];
        wiz = par[2];
        li[0] = par[3];
        li[1] = par[4];
        li[2] = par[5];
        dist = blob[H_WR2];
    } else {
        float tx = par[0] - h.px, ty = par[1] - h.py, tz = par[2] - h.pz;
        float d2 = fmaxf(tx * tx + ty * ty + tz * tz, 1e-12f);
        float dl = sqrtf(d2);
        float inv = 1.0f / dl;
        wix = tx * inv;
        wiy = ty * inv;
        wiz = tz * inv;
        float fall = 1.0f;
        if (kind == LIGHT_SPOT) {
            float cos_t = -(wix * par[6] + wiy * par[7] + wiz * par[8]);
            float ctw = par[9], cfs = par[10];
            float dfall = fminf(fmaxf((cos_t - ctw) / lt[13], 0.0f), 1.0f);
            float df2 = dfall * dfall;
            fall = cos_t < ctw ? 0.0f : (cos_t > cfs ? 1.0f : df2 * df2);
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) li[k] = par[3 + k] * fall / d2;
        dist = dl;
    }
    const float spdf = blob[H_PMF + lid];

    const int lobe = (int)m[M_LOBE];
    const bool refl = dot3(wix, wiy, wiz, h.ngx, h.ngy, h.ngz) * dot3(wox, woy, woz, h.ngx, h.ngy, h.ngz) > 0.0f;
    const float cos_ns = fabsf(dot3(wix, wiy, wiz, h.nsx, h.nsy, h.nsz));
    float f[3] = {0.0f, 0.0f, 0.0f};
    if ((lobe == LOBE_LAMBERT_R || lobe == LOBE_PLASTIC) && refl) {
#pragma unroll
        for (int k = 0; k < 3; ++k) f[k] = m[M_COLOR + k] * INV_PI_F * cos_ns;
    }
    if (lobe == LOBE_OREN_NAYAR || lobe == LOBE_MICRO_R || lobe == LOBE_PLASTIC) {
        float wo_x, wo_y, wo_z, wi_x, wi_y, wi_z;
        to_local(h, wox, woy, woz, wo_x, wo_y, wo_z);
        to_local(h, wix, wiy, wiz, wi_x, wi_y, wi_z);
        if (lobe == LOBE_OREN_NAYAR && refl) {
            float onf = on_factor(m, wo_x, wo_y, wo_z, wi_x, wi_y, wi_z);
#pragma unroll
            for (int k = 0; k < 3; ++k) f[k] = m[M_COLOR + k] * onf * cos_ns;
        }
        if (lobe != LOBE_OREN_NAYAR && refl) {
            float fm[3], p_m;
            micro_f_pdf(m, wo_x, wo_y, wo_z, wi_x, wi_y, wi_z, fm, p_m);
#pragma unroll
            for (int k = 0; k < 3; ++k) f[k] = f[k] + fm[k] * cos_ns;
        }
    }
    const bool contributes = spdf > 0.0f && (f[0] * li[0] > 0.0f || f[1] * li[1] > 0.0f || f[2] * li[2] > 0.0f);
    if (!contributes) return;
    float osx, osy, osz;
    offset_ray(h, wix, wiy, wiz, osx, osy, osz);
    if (intersect_any(blob, osx, osy, osz, wix, wiy, wiz, dist * SHADOW_SCALE)) return;
    const float inv_pl = 1.0f / fmaxf(spdf, 1e-30f);
#pragma unroll
    for (int k = 0; k < 3; ++k) c[k] = f[k] * li[k] * 1.0f * inv_pl;
}

// --- the persistent loop -------------------------------------------------------

template <int SAMPLER, int IKIND>
__global__ void __launch_bounds__(128)
brute_megakernel_kernel(const float* __restrict__ blob_g, const int* __restrict__ px_in,
                        const int* __restrict__ py_in, const int* __restrict__ pid_in, int n_lanes,
                        uint32_t seed, uint32_t s0, int n_samples, float* __restrict__ out_l,
                        float* __restrict__ out_w, float* __restrict__ out_nv) {
    __shared__ float blob[BLOB_FLOATS];
    for (int i = threadIdx.x; i < BLOB_FLOATS; i += blockDim.x) blob[i] = blob_g[i];
    __syncthreads();
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n_lanes) return;

    const float pxf = (float)px_in[lane], pyf = (float)py_in[lane];
    const uint32_t hbase = pcg(pcg(0x9E3779B9u ^ seed) ^ (uint32_t)pid_in[lane]);
    const int max_depth = (int)blob[H_MAX_DEPTH];
    const int n_lights = (int)blob[H_N_LIGHTS];
    const float rr_threshold = blob[H_RR];
    const float max_lum = blob[H_MAX_LUM];
    const long long cap = (long long)n_samples * (max_depth + 2) + 8;
    const uint32_t s_end = s0 + (uint32_t)n_samples;

    float ox, oy, oz, dx, dy, dz;
    uint32_t s_cur = s0;
    regen<SAMPLER>(blob, hbase, pxf, pyf, s_cur, ox, oy, oz, dx, dy, dz);
    bool done = n_samples <= 0;
    float L[3] = {0.0f, 0.0f, 0.0f}, beta[3] = {1.0f, 1.0f, 1.0f}, aL[3] = {0.0f, 0.0f, 0.0f};
    float aW = 0.0f, nv = 0.0f, eta_acc = 1.0f;
    uint32_t bounces = 0;

    for (long long it = 0; it < cap && !done; ++it) {
        // a live lane's ray: closest hit over all prims
        Hit h;
        const bool valid = intersect_closest(blob, ox, oy, oz, dx, dy, dz, h);
        bool new_alive = false;
        if (valid) {
            nv = nv + 1.0f;
            const float wox = -dx, woy = -dy, woz = -dz;
            const uint32_t dim_base = 2u + bounces * DPB;
            const float* m = blob + MAT_BASE + h.mat * MAT_STRIDE;
            const bool alive_sh = (int)bounces < max_depth - 1 && (int)m[M_LOBE] != LOBE_NONE;
            if (alive_sh) {
                BsdfSample bs = bsdf_sample<SAMPLER>(m, hbase, s_cur, dim_base, h, wox, woy, woz);
                if (n_lights > 0) {
                    float c[3];
                    nee<SAMPLER>(blob, m, hbase, s_cur, dim_base, h, wox, woy, woz, c);
#pragma unroll
                    for (int k = 0; k < 3; ++k) L[k] = L[k] + beta[k] * c[k];
                }
                const float cos_term = fabsf(dot3(bs.wx, bs.wy, bs.wz, h.nsx, h.nsy, h.nsz));
                const float inv_pdf = cos_term / fmaxf(bs.pdf, 1e-30f);
                float th[3];
#pragma unroll
                for (int k = 0; k < 3; ++k) th[k] = bs.f[k] * inv_pdf;
                bool surf_cont = bs.valid && (th[0] > 0.0f || th[1] > 0.0f || th[2] > 0.0f);
                if (IKIND == 1) surf_cont = surf_cont && bs.specular;
                if (surf_cont) {
#pragma unroll
                    for (int k = 0; k < 3; ++k) beta[k] = beta[k] * th[k];
                    offset_ray(h, bs.wx, bs.wy, bs.wz, ox, oy, oz);
                    dx = bs.wx;
                    dy = bs.wy;
                    dz = bs.wz;
                    eta_acc = eta_acc * bs.eta_scale;
                    bounces += 1u;
                    new_alive = true;
                    if (IKIND == 0) {  // russian roulette (path.rs:206-214)
                        const float max_c = fmaxf(beta[0] * eta_acc, fmaxf(beta[1] * eta_acc, beta[2] * eta_acc));
                        const float q = fmaxf(1.0f - max_c, 0.05f);
                        if (bounces > 3u && max_c < rr_threshold) {
                            if (sample_1d<SAMPLER>(hbase, s_cur, dim_base + 4u) < q) {
                                new_alive = false;
                            } else {
                                const float boost = 1.0f / fmaxf(1.0f - q, 1e-6f);
#pragma unroll
                                for (int k = 0; k < 3; ++k) beta[k] = beta[k] * boost;
                            }
                        }
                    }
                }
            }
        }
        if (new_alive) continue;
        // the sample is finished: flush it, then regenerate or retire
        const bool fin = isfinite(L[0]) && isfinite(L[1]) && isfinite(L[2]);
        float Lf[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) Lf[k] = fmaxf(fin ? L[k] : 0.0f, 0.0f);
        if (max_lum < INFINITY) {
            const float y = Lf[0] * 0.212671f + Lf[1] * 0.715160f + Lf[2] * 0.072169f;
            const float scl = y > max_lum ? max_lum / fmaxf(y, 1e-12f) : 1.0f;
#pragma unroll
            for (int k = 0; k < 3; ++k) Lf[k] = Lf[k] * scl;
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) aL[k] = aL[k] + Lf[k];
        aW = aW + 1.0f;
        const uint32_t s_next = s_cur + 1u;
        if (s_next < s_end) {
            s_cur = s_next;
            regen<SAMPLER>(blob, hbase, pxf, pyf, s_cur, ox, oy, oz, dx, dy, dz);
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                L[k] = 0.0f;
                beta[k] = 1.0f;
            }
            eta_acc = 1.0f;
            bounces = 0u;
        } else {
            done = true;
        }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) out_l[3 * lane + k] = aL[k];
    out_w[lane] = aW;
    out_nv[lane] = nv;
}

template <int SAMPLER, int IKIND>
static void launch(const float* blob, const int* px, const int* py, const int* pid, int n, uint32_t seed,
                   uint32_t s0, int n_samples, float* out_l, float* out_w, float* out_nv, cudaStream_t stream) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    brute_megakernel_kernel<SAMPLER, IKIND><<<blocks, threads, 0, stream>>>(blob, px, py, pid, n, seed, s0,
                                                                             n_samples, out_l, out_w, out_nv);
}

// mode = sampler * 2 + ikind; sampler 0 = (0,2)-sequence, 1 = random,
// 2 = stratified; ikind 0 = path, 1 = directlighting. Returns the
// cudaError_t of the launch (or cudaErrorInvalidValue for a bad mode).
extern "C" int brute_megakernel(const void* blob, const void* px, const void* py, const void* pid, int n_lanes,
                                unsigned int seed, unsigned int s0, int n_samples, int mode, void* out_l,
                                void* out_w, void* out_nv, void* stream) {
    if (n_lanes <= 0) return (int)cudaGetLastError();
    const float* b = (const float*)blob;
    const int *x = (const int*)px, *y = (const int*)py, *p = (const int*)pid;
    float *l = (float*)out_l, *w = (float*)out_w, *nv = (float*)out_nv;
    cudaStream_t st = (cudaStream_t)stream;
    switch (mode) {
        case 0: launch<0, 0>(b, x, y, p, n_lanes, seed, s0, n_samples, l, w, nv, st); break;
        case 1: launch<0, 1>(b, x, y, p, n_lanes, seed, s0, n_samples, l, w, nv, st); break;
        case 2: launch<1, 0>(b, x, y, p, n_lanes, seed, s0, n_samples, l, w, nv, st); break;
        case 3: launch<1, 1>(b, x, y, p, n_lanes, seed, s0, n_samples, l, w, nv, st); break;
        case 4: launch<2, 0>(b, x, y, p, n_lanes, seed, s0, n_samples, l, w, nv, st); break;
        case 5: launch<2, 1>(b, x, y, p, n_lanes, seed, s0, n_samples, l, w, nv, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
