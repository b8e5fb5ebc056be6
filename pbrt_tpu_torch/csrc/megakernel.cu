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

// uniform_sample_onelight + estimate_direct for delta lights; adds the
// contribution (without beta) to c
template <int SAMPLER>
__device__ void nee(const float* blob, const float* m, uint32_t hbase, uint32_t s, uint32_t dim_base, const Hit& h,
                    float wox, float woy, float woz, float c[3]) {
    c[0] = c[1] = c[2] = 0.0f;
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
    const float* r2c = blob + H_R2C;
    const float* c2w = blob + H_C2W;
    const float fxw = blob[H_FXW], fyw = blob[H_FYW];
    const int strat_xs = (int)blob[H_STRAT_XS], strat_ys = (int)blob[H_STRAT_YS];

    float ox, oy, oz, dx, dy, dz;
    uint32_t s_cur = s0;
    regen<SAMPLER>(r2c, c2w, fxw, fyw, strat_xs, strat_ys, 0.0f, 0.0f, hbase, pxf, pyf, s_cur, ox, oy, oz, dx, dy,
                       dz);
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
            regen<SAMPLER>(r2c, c2w, fxw, fyw, strat_xs, strat_ys, 0.0f, 0.0f, hbase, pxf, pyf, s_cur, ox, oy, oz, dx, dy,
                       dz);
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

// Resident blocks of 128 threads per SM for one mode.
extern "C" int brute_megakernel_occupancy(int mode, int* blocks_per_sm) {
    const void* kernels[6] = {(const void*)brute_megakernel_kernel<0, 0>, (const void*)brute_megakernel_kernel<0, 1>,
                              (const void*)brute_megakernel_kernel<1, 0>, (const void*)brute_megakernel_kernel<1, 1>,
                              (const void*)brute_megakernel_kernel<2, 0>, (const void*)brute_megakernel_kernel<2, 1>};
    if (mode < 0 || mode > 5) return (int)cudaErrorInvalidValue;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernels[mode], 128, 0);
}
