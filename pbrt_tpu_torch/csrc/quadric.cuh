// The EFloat ray test of the six quadric kinds (sphere, cylinder, disk,
// cone, paraboloid, hyperboloid; full or partial): the CUDA transcription of
// pbrt_tpu_torch/device/prims.py ray_quadric and device/efloat.py, operation
// for operation, so that a walk's hits are its plain twin's. Only the BVH
// and kd walks (bvh_walk.cu) include it; B3's and B4's sphere test stays in
// pt_common.cuh, so their binaries do not change.
//
// EFloat: every operation widens its interval by +/- 2 eps |x| (device/
// efloat.py), exact zeros stay zero; torch.minimum / maximum propagate NaN,
// and so do qf_min / qf_max. A root counts iff its interval is strictly
// positive and below t_max; the cone uses k = (radius / height)^2; a
// hyperboloid whose row carries p1, p2 (the 26-column prim table) measures
// phi against its twisted frame; the disk is the plane z = height clipped to
// its annulus, any t in (0, t_max).
// Built with -fmad=false and without fast math (device/nvcc.py): every
// multiply and add rounds on its own, division and sqrt are IEEE.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define QF_TWO_EPS 2.384185791015625e-07f  // 2 * 2^-23
#define QF_TWO_PI 0x1.921fb6p+2f          // float32(2 pi)
#define QF_FULL_PHI 0x1.921fb2p+2f        // float32(2 pi - 1e-6)

enum { Q_SPHERE = 0, Q_CYLINDER = 1, Q_DISK = 2, Q_CONE = 3, Q_PARABOLOID = 4, Q_HYPERBOLOID = 5 };

struct QF {
    float v, lo, hi;
};

__device__ __forceinline__ float qf_min(float a, float b) { return (isnan(a) || isnan(b)) ? NAN : fminf(a, b); }
__device__ __forceinline__ float qf_max(float a, float b) { return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b); }
__device__ __forceinline__ float qf_down(float x) { return x - fabsf(x) * QF_TWO_EPS; }
__device__ __forceinline__ float qf_up(float x) { return x + fabsf(x) * QF_TWO_EPS; }
__device__ __forceinline__ QF qf_exact(float v) { return {v, v, v}; }
__device__ __forceinline__ QF qf_err(float v, float err) { return {v, qf_down(v - err), qf_up(v + err)}; }
__device__ __forceinline__ QF qf_add(QF a, QF b) { return {a.v + b.v, qf_down(a.lo + b.lo), qf_up(a.hi + b.hi)}; }
__device__ __forceinline__ QF qf_sub(QF a, QF b) { return {a.v - b.v, qf_down(a.lo - b.hi), qf_up(a.hi - b.lo)}; }

__device__ __forceinline__ QF qf_mul(QF a, QF b) {
    const float p00 = a.lo * b.lo, p01 = a.lo * b.hi, p10 = a.hi * b.lo, p11 = a.hi * b.hi;
    const float lo = qf_min(qf_min(p00, p01), qf_min(p10, p11));
    const float hi = qf_max(qf_max(p00, p01), qf_max(p10, p11));
    return {a.v * b.v, qf_down(lo), qf_up(hi)};
}

__device__ __forceinline__ QF qf_scale(QF a, float s) { return qf_mul(a, qf_exact(s)); }

__device__ __forceinline__ QF qf_div(QF a, QF b) {
    const bool straddle = b.lo <= 0.0f && b.hi >= 0.0f;
    const float sb_lo = straddle ? 1.0f : b.lo, sb_hi = straddle ? 1.0f : b.hi;
    const float q00 = a.lo / sb_lo, q01 = a.lo / sb_hi, q10 = a.hi / sb_lo, q11 = a.hi / sb_hi;
    const float lo = qf_min(qf_min(q00, q01), qf_min(q10, q11));
    const float hi = qf_max(qf_max(q00, q01), qf_max(q10, q11));
    return {a.v / (b.v != 0.0f ? b.v : 1e-30f), straddle ? -INFINITY : qf_down(lo), straddle ? INFINITY : qf_up(hi)};
}

__device__ __forceinline__ QF qf_sqr(QF a) {
    const float m0 = a.lo * a.lo, m1 = a.hi * a.hi;
    float lo = qf_min(m0, m1);
    const float hi = qf_max(m0, m1);
    if (a.lo <= 0.0f && a.hi >= 0.0f) lo = 0.0f;
    return {a.v * a.v, qf_down(lo), qf_up(hi)};
}

__device__ __forceinline__ float qf_clamp0(float x) { return isnan(x) ? x : fmaxf(x, 0.0f); }

// efloat.quadratic: (has a root, t0, t1), t0 <= t1 by value.
__device__ __forceinline__ bool qf_quadratic(QF a, QF b, QF c, QF& t0, QF& t1) {
    const float disc = b.v * b.v - 4.0f * a.v * c.v;
    const float rd = sqrtf(qf_clamp0(disc));
    const QF e_disc = qf_sub(qf_sqr(b), qf_mul(qf_mul(qf_exact(4.0f), a), c));
    const QF frd = {rd, sqrtf(qf_clamp0(e_disc.lo)), sqrtf(qf_clamp0(e_disc.hi))};
    const QF q = b.v < 0.0f ? qf_mul(qf_sub(b, frd), qf_exact(-0.5f)) : qf_mul(qf_add(b, frd), qf_exact(-0.5f));
    const QF r0 = qf_div(q, a), r1 = qf_div(c, q);
    const bool swap = r0.v > r1.v;
    t0 = swap ? r1 : r0;
    t1 = swap ? r0 : r1;
    return disc >= 0.0f;
}

#define QF_GAMMA3 0x1.800004p-23f  // float32(3 eps / (1 - 3 eps)), eps = 2^-24 (efloat._GAMMA3)

// The clip of one root at t: the re-projected object-space point and whether
// it lies inside the z range and phi sweep (prims.ray_quadric clip_ok).
__device__ __forceinline__ bool qf_clip(float t, int kind, const float ob[3], const float db[3], const float* par,
                                        bool twisted, float pn[3]) {
    const float radius = par[0], p1 = par[1], p2 = par[2], phimax = par[3];
    const float px = ob[0] + db[0] * t, py = ob[1] + db[1] * t, pz = ob[2] + db[2] * t;
    float s, zs;
    if (kind == Q_CYLINDER) {
        s = radius / fmaxf(sqrtf(px * px + py * py), 1e-30f);
        zs = pz;
    } else if (kind == Q_CONE || kind == Q_PARABOLOID || kind == Q_HYPERBOLOID) {
        s = 1.0f;
        zs = pz;
    } else {
        s = radius / fmaxf(sqrtf(px * px + py * py + pz * pz), 1e-30f);
        zs = pz * s;
    }
    pn[0] = px * s;
    pn[1] = py * s;
    pn[2] = zs;
    const float z = pn[2];
    float phi = atan2f(pn[1], pn[0]);
    if (kind == Q_HYPERBOLOID && twisted) {
        const float dz_h = par[11] - par[8];
        const float v_h = (z - par[8]) / (fabsf(dz_h) > 1e-12f ? dz_h : 1.0f);
        const float prx = par[6] + v_h * (par[9] - par[6]);
        const float pry = par[7] + v_h * (par[10] - par[7]);
        phi = atan2f(prx * pn[1] - pn[0] * pry, pn[0] * prx + pn[1] * pry);
    }
    if (phi < 0.0f) phi = phi + QF_TWO_PI;
    const bool full = kind == Q_SPHERE && p1 <= -radius + 1e-7f * radius && p2 >= radius - 1e-7f * radius &&
                      phimax >= QF_FULL_PHI;
    const float zlo = kind == Q_CONE ? 0.0f : p1;
    const float zhi = kind == Q_CONE ? p1 : p2;
    return full || (z >= zlo && z <= zhi && phi <= phimax);
}

// One quadric against the ray (o, d) in world (or instance) space. w2o: the
// 12 floats of its world -> object rows; par: its params (6, or 12 when
// `twisted`: p1, p2 in 6:12). Returns the hit, with t and the object-space
// hit's x and y.
__device__ __forceinline__ bool qf_ray_quadric(const float o[3], const float d[3], const float* w2o, const float* par,
                                            int kind, bool twisted, float t_max, float& t_out, float& x_out,
                                            float& y_out) {
    float ob[3], db[3], oerr[3], derr[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const float* m = w2o + 4 * i;
        ob[i] = m[0] * o[0] + m[1] * o[1] + m[2] * o[2] + m[3];
        db[i] = m[0] * d[0] + m[1] * d[1] + m[2] * d[2];
        oerr[i] = QF_GAMMA3 * (fabsf(m[0]) * fabsf(o[0]) + fabsf(m[1]) * fabsf(o[1]) + fabsf(m[2]) * fabsf(o[2]) +
                               fabsf(m[3]));
        derr[i] = QF_GAMMA3 * (fabsf(m[0]) * fabsf(d[0]) + fabsf(m[1]) * fabsf(d[1]) + fabsf(m[2]) * fabsf(d[2]));
    }
    const float radius = par[0], p1 = par[1], p2 = par[2], phimax = par[3];
    if (kind == Q_DISK) {
        const float dz = db[2];
        const bool dz_ok = fabsf(dz) > 1e-12f;
        const float td = (p1 - ob[2]) / (dz_ok ? dz : 1.0f);
        const float px = ob[0] + db[0] * td, py = ob[1] + db[1] * td;
        const float d2 = px * px + py * py;
        float phi = atan2f(py, px);
        if (phi < 0.0f) phi = phi + QF_TWO_PI;
        t_out = td;
        x_out = px;
        y_out = py;
        return dz_ok && td > 0.0f && td < t_max && d2 <= radius * radius && d2 >= p2 * p2 && phi <= phimax;
    }
    const QF ox = qf_err(ob[0], oerr[0]), oy = qf_err(ob[1], oerr[1]), oz = qf_err(ob[2], oerr[2]);
    const QF dx = qf_err(db[0], derr[0]), dy = qf_err(db[1], derr[1]), dz = qf_err(db[2], derr[2]);
    const QF dxy2 = qf_add(qf_sqr(dx), qf_sqr(dy));
    const QF oxyd = qf_add(qf_mul(dx, ox), qf_mul(dy, oy));
    const QF oxy2 = qf_add(qf_sqr(ox), qf_sqr(oy));
    const QF dzz = qf_sqr(dz), ozz = qf_sqr(oz), ozdz = qf_mul(oz, dz);
    QF a, b, c;
    if (kind == Q_CYLINDER) {
        a = dxy2;
        b = qf_scale(oxyd, 2.0f);
        c = qf_sub(oxy2, qf_sqr(qf_exact(radius)));
    } else if (kind == Q_CONE) {
        const float kr = radius / fmaxf(fabsf(p1), 1e-12f);
        const float k = kr * kr;
        const QF oz_h = qf_sub(oz, qf_exact(p1));
        a = qf_sub(dxy2, qf_scale(dzz, k));
        b = qf_scale(qf_sub(oxyd, qf_scale(qf_mul(dz, oz_h), k)), 2.0f);
        c = qf_sub(oxy2, qf_scale(qf_sqr(oz_h), k));
    } else if (kind == Q_PARABOLOID) {
        const float k = p2 / fmaxf(radius * radius, 1e-20f);
        a = qf_scale(dxy2, k);
        b = qf_sub(qf_scale(oxyd, 2.0f * k), dz);
        c = qf_sub(qf_scale(oxy2, k), oz);
    } else if (kind == Q_HYPERBOLOID) {
        const float ah = par[4], ch = par[5];
        a = qf_sub(qf_scale(dxy2, ah), qf_scale(dzz, ch));
        b = qf_scale(qf_sub(qf_scale(oxyd, ah), qf_scale(ozdz, ch)), 2.0f);
        c = qf_sub(qf_sub(qf_scale(oxy2, ah), qf_scale(ozz, ch)), qf_exact(1.0f));
    } else {
        a = qf_add(dxy2, dzz);
        b = qf_scale(qf_add(oxyd, ozdz), 2.0f);
        c = qf_sub(qf_add(oxy2, ozz), qf_sqr(qf_exact(radius)));
    }
    QF t0, t1;
    const bool has = qf_quadratic(a, b, c, t0, t1);
    float pn0[3], pn1[3];
    const bool ok0 = qf_clip(t0.v, kind, ob, db, par, twisted, pn0);
    const bool ok1 = qf_clip(t1.v, kind, ob, db, par, twisted, pn1);
    const bool near = has && t0.lo > 0.0f && t0.hi < t_max && ok0;
    const bool far = has && t1.lo > 0.0f && t1.hi < t_max && ok1;
    (void)phimax;
    t_out = near ? t0.v : t1.v;
    x_out = near ? pn0[0] : pn1[0];
    y_out = near ? pn0[1] : pn1[1];
    return near || far;
}
