// Device code that the persistent path-tracing megakernels share: the brute
// megakernel (megakernel.cu, B3) and the wide megakernel (megakernel_wide.cu,
// B4). Both reproduce the reference kernels' estimators term for term
// (pbrt_tpu/device/megakernel.py and megakernel_wide.py), and these are the
// pieces in which the two reference kernels agree:
//  - the uint32 PCG hash, van der Corput and Sobol' samples, bit-exact with
//    the plain PyTorch twins, and the (pixel, sample, dimension) keying of
//    the (0,2), random and stratified samplers;
//  - camera regeneration (pinhole and thin lens, box filter) and the camera
//    ray of a raster point;
//  - the baked lobe classes: Lambert, Oren-Nayar, specular reflection,
//    fresnel-specular glass, GGX conductor/dielectric and Lambert+GGX
//    plastic, their f, pdf and bsdf_sample;
//  - light selection and the delta-light (point, spot, distant) part of
//    next-event estimation;
//  - the ray-origin offset past the hit point's error bound;
//  - the full-sphere test and its shading record, over a sphere record
//    (SPH_* offsets) of baked constant transforms.
// A material record (M_* offsets, 32 floats in both kernels' blobs) and the
// first 14 floats of a light record (kind, 12 parameters, the spot falloff
// denominator) have one layout, kept in lockstep with device/megakernel.py
// and device/megakernel_wide.py.
//
// Every includer is built with -fmad=false and without fast math: the
// watertight edge functions x1*y2 - y1*x2 are exact only without FMA
// contraction, and 1/x and sqrtf stay IEEE. sinf/cosf/powf/logf may differ
// from torch's by ulps, so the kernels are held to their twins at image
// level.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// light record: kind, 12 parameters (scene/arrays.py light_param), then
// the spot falloff denominator max(cos_falloff_start - cos_total, 1e-9)
#define L_KIND 0
#define L_PAR 1
#define L_SPOT_DEN 13

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

// The second Sobol' dimension's direction numbers: v_0 = 2^31,
// v_{i+1} = v_i ^ (v_i >> 1).
static __constant__ uint32_t SOBOL2_V[32] = {
    0x80000000u, 0xc0000000u, 0xa0000000u, 0xf0000000u, 0x88000000u, 0xcc000000u, 0xaa000000u, 0xff000000u,
    0x80800000u, 0xc0c00000u, 0xa0a00000u, 0xf0f00000u, 0x88880000u, 0xcccc0000u, 0xaaaa0000u, 0xffff0000u,
    0x80008000u, 0xc000c000u, 0xa000a000u, 0xf000f000u, 0x88008800u, 0xcc00cc00u, 0xaa00aa00u, 0xff00ff00u,
    0x80808080u, 0xc0c0c0c0u, 0xa0a0a0a0u, 0xf0f0f0f0u, 0x88888888u, 0xccccccccu, 0xaaaaaaaau, 0xffffffffu};

// XOR of the direction numbers of the index's set bits into the scramble,
// visiting only those bits (a sample index is below a few dozen)
__device__ __forceinline__ float sobol2(uint32_t index, uint32_t scramble) {
    uint32_t res = scramble;
    while (index != 0u) {
        res ^= SOBOL2_V[__ffs(index) - 1];
        index &= index - 1u;
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
    float u, v;  // the hit's uv, where a textured Kd reads it
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

__device__ __forceinline__ void concentric_disk(float u1, float u2, float& x, float& y) {
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
    x = r * cosf(theta);
    y = r * sinf(theta);
}

// --- camera --------------------------------------------------------------------

// Film dimension 0 of the (0,2), random and stratified samplers: (u1, u2) in
// the pixel; strat_xs x strat_ys: the stratified sampler's strata.
template <int SAMPLER>
__device__ __forceinline__ void film_u(uint32_t hbase, uint32_t s, int strat_xs, int strat_ys, float& u1,
                                       float& u2) {
    if (SAMPLER != 0) {
        uint32_t h = pcg(hbase ^ s);
        u1 = u2f01(pcg(h));
        u2 = u2f01(pcg(h ^ 1u));
        if (SAMPLER == 2) {
            // the reference's strata: floor(sqrt(spp)) x spp // that, always
            // jittered (ROADMAP C)
            uint32_t idx = s % (uint32_t)(strat_xs * strat_ys);
            u1 = ((float)(idx % (uint32_t)strat_xs) + u1) / (float)strat_xs;
            u2 = ((float)((idx / (uint32_t)strat_xs) % (uint32_t)strat_ys) + u2) / (float)strat_ys;
        }
    } else {
        u1 = vdc(s, pcg(hbase));
        u2 = sobol2(s, pcg(hbase ^ 1u));
    }
}

// Lens dimension 1 of the same samplers, keyed like the film's.
template <int SAMPLER>
__device__ __forceinline__ void lens_u(uint32_t hbase, uint32_t s, float& ul1, float& ul2) {
    if (SAMPLER != 0) {
        uint32_t h = pcg(hbase ^ s);
        ul1 = u2f01(pcg(h ^ 2u));
        ul2 = u2f01(pcg(h ^ 3u));
    } else {
        ul1 = vdc(s, pcg(hbase ^ 2u));
        ul2 = sobol2(s, pcg(hbase ^ 3u));
    }
}

// The camera ray through raster point (fx, fy), and when lens_r > 0 the
// lens point of the lens sample (ul1, ul2) (perspective.rs generate_ray).
// r2c: row-major 4x4 raster -> camera; c2w: row-major 3x4 camera -> world.
__device__ __forceinline__ void camera_ray(const float* r2c, const float* c2w, float lens_r, float focal, float fx,
                                           float fy, float ul1, float ul2, float& ox, float& oy, float& oz,
                                           float& dx, float& dy, float& dz) {
    float cx = r2c[0] * fx + r2c[1] * fy + r2c[3];
    float cy = r2c[4] * fx + r2c[5] * fy + r2c[7];
    float cz = r2c[8] * fx + r2c[9] * fy + r2c[11];
    float w = r2c[12] * fx + r2c[13] * fy + r2c[15];
    float inv_w = 1.0f / w;
    cx = cx * inv_w;
    cy = cy * inv_w;
    cz = cz * inv_w;
    norm3(cx, cy, cz);
    float ocx = 0.0f, ocy = 0.0f;
    if (lens_r > 0.0f) {
        concentric_disk(ul1, ul2, ocx, ocy);
        ocx = lens_r * ocx;
        ocy = lens_r * ocy;
        float ft = focal / fmaxf(cz, 1e-9f);
        cx = cx * ft - ocx;
        cy = cy * ft - ocy;
        cz = cz * ft;
        norm3(cx, cy, cz);
    }
    dx = c2w[0] * cx + c2w[1] * cy + c2w[2] * cz;
    dy = c2w[4] * cx + c2w[5] * cy + c2w[6] * cz;
    dz = c2w[8] * cx + c2w[9] * cy + c2w[10] * cz;
    norm3(dx, dy, dz);
    if (lens_r > 0.0f) {
        ox = c2w[0] * ocx + c2w[1] * ocy + c2w[2] * 0.0f + c2w[3];
        oy = c2w[4] * ocx + c2w[5] * ocy + c2w[6] * 0.0f + c2w[7];
        oz = c2w[8] * ocx + c2w[9] * ocy + c2w[10] * 0.0f + c2w[11];
    } else {
        ox = c2w[3];
        oy = c2w[7];
        oz = c2w[11];
    }
}

// A camera sample of pixel (pxf, pyf), sample s: film dimension 0 through
// the box filter of half-widths (fxw, fyw), lens dimension 1 when
// lens_r > 0.
template <int SAMPLER>
__device__ __forceinline__ void regen(const float* r2c, const float* c2w, float fxw, float fyw, int strat_xs,
                                      int strat_ys, float lens_r, float focal, uint32_t hbase, float pxf, float pyf,
                                      uint32_t s, float& ox, float& oy, float& oz, float& dx, float& dy, float& dz) {
    float u1, u2, ul1 = 0.0f, ul2 = 0.0f;
    film_u<SAMPLER>(hbase, s, strat_xs, strat_ys, u1, u2);
    if (lens_r > 0.0f) lens_u<SAMPLER>(hbase, s, ul1, ul2);
    camera_ray(r2c, c2w, lens_r, focal, pxf + 0.5f + (2.0f * u1 - 1.0f) * fxw, pyf + 0.5f + (2.0f * u2 - 1.0f) * fyw,
               ul1, ul2, ox, oy, oz, dx, dy, dz);
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

// bsdf_sample for the baked lobe classes, from the sample's uniforms: u_lobe
// (dimension dim_base + 2, read by the plastic lobe pair only) and (u1, u2)
// (dimension dim_base + 3). kd: a textured Kd (3 floats) in place of the
// record's color, or nullptr.
__device__ __forceinline__ BsdfSample bsdf_sample_u(const float* m, float u_lobe, float u1, float u2, const Hit& h,
                                                    float wox, float woy, float woz, const float* kd = nullptr) {
    const float* col = kd != nullptr ? kd : m + M_COLOR;
    float wo_x, wo_y, wo_z;
    to_local(h, wox, woy, woz, wo_x, wo_y, wo_z);
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
    if (plast) pick = min((int)(u_lobe * 2.0f), 1);
    const bool samp_diff = diff_like && pick == 0;
    const bool samp_mic = mic && (!lam || pick == 1);
    if (samp_diff) {  // cosine hemisphere through the concentric disk
        concentric_disk(u1, u2, wix, wiy);
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
        for (int c = 0; c < 3; ++c) bs.f[c] = col[c] * frm * inv_ci;
        bs.pdf = 1.0f;
    } else if (glass) {
        float st_scale = eta_ratio * eta_ratio;
        float t_term = (1.0f - fr_s) * st_scale * inv_ci;
        float r_term = fr_s * inv_ci;
#pragma unroll
        for (int c = 0; c < 3; ++c) bs.f[c] = choose_r ? col[c] * r_term : m[M_KT + c] * t_term;
        bs.pdf = choose_r ? fr_s : 1.0f - fr_s;
    } else {
        const bool refl_hemi = wo_z * wiz > 0.0f;
        float f_diff = lam && refl_hemi ? INV_PI_F : 0.0f;
        if (on && refl_hemi) f_diff = on_factor(m, wo_x, wo_y, wo_z, wix, wiy, wiz);
        float pdf = diff_like && refl_hemi ? abs_ci * INV_PI_F : 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) bs.f[c] = col[c] * f_diff;
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

// bsdf_sample for the baked lobe classes, drawing its uniforms from the
// (0,2), random or stratified stream of sample s
template <int SAMPLER>
__device__ __forceinline__ BsdfSample bsdf_sample(const float* m, uint32_t hbase, uint32_t s, uint32_t dim_base,
                                                  const Hit& h, float wox, float woy, float woz,
                                                  const float* kd = nullptr) {
    float u1, u2;
    sample_2d<SAMPLER>(hbase, s, dim_base + 3u, u1, u2);
    const float u_lobe = (int)m[M_LOBE] == LOBE_PLASTIC ? sample_1d<SAMPLER>(hbase, s, dim_base + 2u) : 0.0f;
    return bsdf_sample_u(m, u_lobe, u1, u2, h, wox, woy, woz, kd);
}

// --- light selection and delta lights ---------------------------------------------

// The light of one NEE sample: floor(u * n) under uniform selection (not a
// cdf walk: cdf rounding can differ by one light at float32 boundaries),
// else the number of cdf entries below u.
__device__ __forceinline__ int select_light(float u_sel, int n_lights, bool uniform, const float* cdf) {
    int lid = 0;
    if (uniform) {
        lid = min((int)(u_sel * (float)n_lights), n_lights - 1);
    } else {
        for (int i = 0; i < n_lights - 1; ++i) lid += u_sel > cdf[i] ? 1 : 0;
        lid = min(max(lid, 0), n_lights - 1);
    }
    return lid;
}

// Incident direction, radiance and distance of a point, spot or distant
// light record lt at the hit point (lights.sample_li's delta branches);
// wr2 = 2 x the world radius, the distant light's shadow-ray length.
__device__ __forceinline__ void delta_light(const float* lt, float wr2, const Hit& h, float& wix, float& wiy,
                                            float& wiz, float li[3], float& dist) {
    const float* par = lt + L_PAR;
    const int kind = (int)lt[L_KIND];
    if (kind == LIGHT_DISTANT) {
        wix = par[0];
        wiy = par[1];
        wiz = par[2];
        li[0] = par[3];
        li[1] = par[4];
        li[2] = par[5];
        dist = wr2;
        return;
    }
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
        float dfall = fminf(fmaxf((cos_t - ctw) / lt[L_SPOT_DEN], 0.0f), 1.0f);
        float df2 = dfall * dfall;
        fall = cos_t < ctw ? 0.0f : (cos_t > cfs ? 1.0f : df2 * df2);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) li[k] = par[3 + k] * fall / d2;
    dist = dl;
}

// --- baked full spheres (the brute and wide megakernels) -----------------------
// A sphere record (the brute megakernel's prim record, the wide one's
// sphere record): SPH_FLAGS the prim flags, the 3x4 world -> object and
// object -> world rows, radius, radius^2, phimax, and the p_err constant
// terms gamma(3) |o2w[row][3]|; words 0 and 1 are the kernel's own.
#define SPH_FLAGS 2
#define SPH_W2O 3
#define SPH_O2W 15
#define SPH_R 27
#define SPH_R2 28
#define SPH_PHIMAX 29
#define SPH_ERRC 30

__device__ __forceinline__ void xf_point(const float* m, float x, float y, float z, float& ox, float& oy, float& oz) {
    ox = m[0] * x + m[1] * y + m[2] * z + m[3];
    oy = m[4] * x + m[5] * y + m[6] * z + m[7];
    oz = m[8] * x + m[9] * y + m[10] * z + m[11];
}

// full-sphere quadric (intersect.ray_quadric sphere branch) on a sphere
// record pr; p_loc is the object-space hit before reprojection
__device__ __forceinline__ bool sph_test(const float* pr, float ox, float oy, float oz, float dx, float dy,
                                         float dz, float t_query, float& t, float& plx, float& ply, float& plz) {
    const float* m = pr + SPH_W2O;
    float oox, ooy, ooz;
    xf_point(m, ox, oy, oz, oox, ooy, ooz);
    float odx = m[0] * dx + m[1] * dy + m[2] * dz;
    float ody = m[4] * dx + m[5] * dy + m[6] * dz;
    float odz = m[8] * dx + m[9] * dy + m[10] * dz;
    float a = dot3(odx, ody, odz, odx, ody, odz);
    float b = 2.0f * dot3(oox, ooy, ooz, odx, ody, odz);
    float c = dot3(oox, ooy, ooz, oox, ooy, ooz) - pr[SPH_R2];
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

// surface_interaction sphere branch with constant transforms; g53 is
// float32(gamma(5) + gamma(3))
__device__ __forceinline__ void sph_attrs(const float* pr, float g53, float px_o, float py_o, float pz_o, Hit& h) {
    const float* o2w = pr + SPH_O2W;
    const float* w2o = pr + SPH_W2O;
    float r = pr[SPH_R];
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
    if ((int)pr[SPH_FLAGS] & FLAG_FLIP_GEOM_N) {
        ngx = -ngx;
        ngy = -ngy;
        ngz = -ngz;
    }
    float pm = pr[SPH_PHIMAX];
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
    h.ex = g53 * (fabsf(o2w[0]) * apx + fabsf(o2w[1]) * apy + fabsf(o2w[2]) * apz) + pr[SPH_ERRC];
    h.ey = g53 * (fabsf(o2w[4]) * apx + fabsf(o2w[5]) * apy + fabsf(o2w[6]) * apz) + pr[SPH_ERRC + 1];
    h.ez = g53 * (fabsf(o2w[8]) * apx + fabsf(o2w[9]) * apy + fabsf(o2w[10]) * apz) + pr[SPH_ERRC + 2];
}
