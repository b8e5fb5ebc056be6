// Wide persistent path-tracing megakernel: the whole path loop, with the
// closest-hit and shadow traversals of the 8-wide BVH inside the kernel,
// one thread per lane.
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
// What changed from the TPU kernel, and why:
//  - The TPU kernel walks 8 packets of 128 lanes, one traversal stack per
//    packet, with every packet's pop chain interleaved in one branchless
//    body (pallas_bvh's joint layout), and orders lanes into 16x8 pixel
//    tiles so that a packet's rays stay coherent. Here every lane is a
//    thread with its own loop to the reference's cap n_samples *
//    (max_depth + 2) + 8 and its own 72-entry stack, and walks the tree
//    through wide_traverse.cuh, the per-ray traversal of B1: a ray visits
//    only the nodes its own box tests accept, so lane order cannot change
//    what it costs or what it returns, and lanes stay in raster order.
//  - The reference reads the winner's vertices and payload out of the
//    traversal with masked reductions; here the traversal returns the
//    winner's row of wprim_tab (vertices in cols 0:9, material row, light
//    row and flags in cols 11:14), which is read once after the walk.
//  - Lights, materials and the camera are one float blob
//    (device/megakernel_wide.py pack_wide_consts, offsets below) in shared
//    memory per block; wmeta, wnode and wprim are read from device memory
//    with __ldg (the 123,650-triangle room's 13 MB stay in the 50 MB L2).
//  - Sampler kind and whether the scene has area lights are template
//    parameters; the lens is a runtime branch.
//
// Counters: each warp adds its threads' closest-hit and shadow pops to
// pop_counts[0] and [1] (one atomic per warp at the end), so a caller can
// compute the work a launch did; stack overflows and iteration-cap hits go
// to trav_counters[0] and [1] as in B1.
//
// Bound: dependent-load latency of the traversal, as in B1, plus float32
// shading work; the path state stays in registers. Lanes diverge in path
// length, lobe and tree walk; regrouping them is later work.
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
// row the slot bakes (the wprim_tab payload names rows, not slots)
#define M_ROW 31

__device__ __forceinline__ float power_heuristic(float f, float g) {
    const float f2 = f * f, g2 = g * g;
    return f > 0.0f ? f2 / fmaxf(f2 + g2, 1e-30f) : 0.0f;
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
// against the BSDF's pdf and an any-hit shadow walk; writes the
// contribution (without beta) to c and adds the walk's pops to pops_s
template <int SAMPLER>
__device__ void nee_wide(const float* blob, const float* m, uint32_t hbase, uint32_t s, uint32_t dim_base,
                         const Hit& h, float wox, float woy, float woz, const int* __restrict__ meta_tab,
                         const float* __restrict__ node_tab, const float* __restrict__ prim_tab,
                         unsigned int* trav_counters, int* stack, unsigned long long& pops_s, float c[3]) {
    c[0] = c[1] = c[2] = 0.0f;
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
    if (!contributes) return;
    float osx, osy, osz;
    offset_ray(h, wix, wiy, wiz, osx, osy, osz);
    WideRay r;
    wide_init(r, stack, osx, osy, osz, wix, wiy, wiz, dist * SHADOW_SCALE, true);
    wide_walk(r, stack, meta_tab, node_tab, prim_tab, trav_counters);
    pops_s += (unsigned long long)r.pops;
    if (r.best_idx >= 0) return;  // occluded
    const float w_l = delta ? 1.0f : power_heuristic(p_sel, p_b);
    const float scale = 1.0f * w_l / fmaxf(p_sel, 1e-30f);
#pragma unroll
    for (int k = 0; k < 3; ++k) c[k] = f[k] * li[k] * scale;
}

// --- the persistent loop -------------------------------------------------------

template <int SAMPLER, int ANY_AREA>
__global__ void __launch_bounds__(128)
wide_megakernel_kernel(const float* __restrict__ blob_g, const int* __restrict__ px_in,
                       const int* __restrict__ py_in, const int* __restrict__ pid_in, int n_lanes,
                       uint32_t seed, uint32_t s0, int n_samples, const int* __restrict__ meta_tab,
                       const float* __restrict__ node_tab, const float* __restrict__ prim_tab,
                       float* __restrict__ out_l, float* __restrict__ out_w, float* __restrict__ out_nv,
                       unsigned long long* __restrict__ pop_counts, unsigned int* __restrict__ trav_counters) {
    __shared__ float blob[BLOB_FLOATS];
    for (int i = threadIdx.x; i < BLOB_FLOATS; i += blockDim.x) blob[i] = blob_g[i];
    __syncthreads();
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    unsigned long long pops_c = 0, pops_s = 0;
    if (lane < n_lanes) {
        const float pxf = (float)px_in[lane], pyf = (float)py_in[lane];
        const uint32_t hbase = pcg(pcg(0x9E3779B9u ^ seed) ^ (uint32_t)pid_in[lane]);
        const int max_depth = (int)blob[H_MAX_DEPTH];
        const int n_mats = (int)blob[H_N_MATS];
        const float rr_threshold = blob[H_RR];
        const float max_lum = blob[H_MAX_LUM];
        const float g7 = blob[H_G7];
        const float* r2c = blob + H_R2C;
        const float* c2w = blob + H_C2W;
        const float fxw = blob[H_FXW], fyw = blob[H_FYW];
        const int strat_xs = (int)blob[H_STRAT_XS], strat_ys = (int)blob[H_STRAT_YS];
        const float lens_r = blob[H_LENS_R], focal = blob[H_FOCAL];
        const long long cap = (long long)n_samples * (max_depth + 2) + 8;
        const uint32_t s_end = s0 + (uint32_t)n_samples;

        float ox, oy, oz, dx, dy, dz;
        uint32_t s_cur = s0;
        regen<SAMPLER>(r2c, c2w, fxw, fyw, strat_xs, strat_ys, lens_r, focal, hbase, pxf, pyf, s_cur, ox, oy, oz,
                       dx, dy, dz);
        bool done = n_samples <= 0;
        float L[3] = {0.0f, 0.0f, 0.0f}, beta[3] = {1.0f, 1.0f, 1.0f}, aL[3] = {0.0f, 0.0f, 0.0f};
        float aW = 0.0f, nv = 0.0f, eta_acc = 1.0f;
        uint32_t bounces = 0;
        // the previous vertex's BSDF sample, for the emission pickup's MIS
        bool prev_spec = true;
        float prev_pdf = 1.0f, ppx = ox, ppy = oy, ppz = oz;
        int stack[WT_STACK];

        for (long long it = 0; it < cap && !done; ++it) {
            WideRay r;
            wide_init(r, stack, ox, oy, oz, dx, dy, dz, INFINITY, false);
            wide_walk(r, stack, meta_tab, node_tab, prim_tab, trav_counters);
            pops_c += (unsigned long long)r.pops;
            bool new_alive = false;
            if (r.best_idx >= 0) {
                nv = nv + 1.0f;
                Hit h;
                const int light = tri_attrs(prim_tab + r.best_row, r.b1, r.b2, g7, h);
                const float wox = -dx, woy = -dy, woz = -dz;
                if (ANY_AREA && light >= 0) {
                    // area-light emission with deferred MIS against the
                    // BSDF sample that found it (diffuse.rs l())
                    const float* lt = blob + LIGHT_BASE + light * LIGHT_STRIDE;
                    const float cos_e = dot3(h.ngx, h.ngy, h.ngz, wox, woy, woz);
                    const bool em = cos_e > 0.0f || lt[L_TWO_SIDED] != 0.0f;
                    const float tx = h.px - ppx, ty = h.py - ppy, tz = h.pz - ppz;
                    const float d2 = fmaxf(tx * tx + ty * ty + tz * tz, 1e-12f);
                    const float wl = 1.0f / sqrtf(d2);
                    const float cos_l = fabsf(dot3(h.ngx, h.ngy, h.ngz, -tx * wl, -ty * wl, -tz * wl));
                    const float p_lh =
                        (cos_l > 1e-7f ? d2 / fmaxf(cos_l * lt[L_AREA], 1e-12f) : 0.0f) * blob[H_PMF + light];
                    const float w_mis = prev_spec ? 1.0f : power_heuristic(prev_pdf, p_lh);
#pragma unroll
                    for (int k = 0; k < 3; ++k) L[k] = L[k] + beta[k] * (em ? lt[L_PAR + k] : 0.0f) * w_mis;
                }
                const float* m = nullptr;
                for (int sl = 0; sl < n_mats; ++sl) {
                    if ((int)blob[MAT_BASE + sl * MAT_STRIDE + M_ROW] == h.mat) m = blob + MAT_BASE + sl * MAT_STRIDE;
                }
                const uint32_t dim_base = 2u + bounces * DPB;
                const bool alive_sh = (int)bounces < max_depth - 1 && m != nullptr && (int)m[M_LOBE] != LOBE_NONE;
                if (alive_sh) {
                    BsdfSample bs = bsdf_sample<SAMPLER>(m, hbase, s_cur, dim_base, h, wox, woy, woz);
                    float c[3];
                    nee_wide<SAMPLER>(blob, m, hbase, s_cur, dim_base, h, wox, woy, woz, meta_tab, node_tab, prim_tab,
                                      trav_counters, stack, pops_s, c);
#pragma unroll
                    for (int k = 0; k < 3; ++k) L[k] = L[k] + beta[k] * c[k];
                    const float cos_term = fabsf(dot3(bs.wx, bs.wy, bs.wz, h.nsx, h.nsy, h.nsz));
                    const float inv_pdf = cos_term / fmaxf(bs.pdf, 1e-30f);
                    float th[3];
#pragma unroll
                    for (int k = 0; k < 3; ++k) th[k] = bs.f[k] * inv_pdf;
                    if (bs.valid && (th[0] > 0.0f || th[1] > 0.0f || th[2] > 0.0f)) {
#pragma unroll
                        for (int k = 0; k < 3; ++k) beta[k] = beta[k] * th[k];
                        offset_ray(h, bs.wx, bs.wy, bs.wz, ox, oy, oz);
                        dx = bs.wx;
                        dy = bs.wy;
                        dz = bs.wz;
                        eta_acc = eta_acc * bs.eta_scale;
                        bounces += 1u;
                        prev_spec = bs.specular;
                        prev_pdf = fmaxf(bs.pdf, 1e-30f);
                        ppx = h.px;
                        ppy = h.py;
                        ppz = h.pz;
                        new_alive = true;
                        // russian roulette (path.rs:206-214)
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
                regen<SAMPLER>(r2c, c2w, fxw, fyw, strat_xs, strat_ys, lens_r, focal, hbase, pxf, pyf, s_cur, ox, oy,
                               oz, dx, dy, dz);
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                    L[k] = 0.0f;
                    beta[k] = 1.0f;
                }
                eta_acc = 1.0f;
                bounces = 0u;
                prev_spec = true;
                prev_pdf = 1.0f;
                ppx = ox;
                ppy = oy;
                ppz = oz;
            } else {
                done = true;
            }
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) out_l[3 * lane + k] = aL[k];
        out_w[lane] = aW;
        out_nv[lane] = nv;
    }
    // pops of the warp, one atomic each
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        pops_c += __shfl_down_sync(0xffffffffu, pops_c, off);
        pops_s += __shfl_down_sync(0xffffffffu, pops_s, off);
    }
    if ((threadIdx.x & 31) == 0) {
        if (pops_c) atomicAdd(&pop_counts[0], pops_c);
        if (pops_s) atomicAdd(&pop_counts[1], pops_s);
    }
}

template <int SAMPLER, int ANY_AREA>
static void launch(const float* blob, const int* px, const int* py, const int* pid, int n, uint32_t seed,
                   uint32_t s0, int n_samples, const int* meta, const float* node, const float* prim, float* out_l,
                   float* out_w, float* out_nv, unsigned long long* pops, unsigned int* counters,
                   cudaStream_t stream) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    wide_megakernel_kernel<SAMPLER, ANY_AREA><<<blocks, threads, 0, stream>>>(
        blob, px, py, pid, n, seed, s0, n_samples, meta, node, prim, out_l, out_w, out_nv, pops, counters);
}

// mode = sampler * 2 + any_area; sampler 0 = (0,2)-sequence, 1 = random,
// 2 = stratified. Returns the cudaError_t of the launch (or
// cudaErrorInvalidValue for a bad mode).
extern "C" int wide_megakernel(const void* blob, const void* px, const void* py, const void* pid, int n_lanes,
                               unsigned int seed, unsigned int s0, int n_samples, int mode, const void* meta_tab,
                               const void* node_tab, const void* prim_tab, void* out_l, void* out_w, void* out_nv,
                               void* pop_counts, void* trav_counters, void* stream) {
    if (n_lanes <= 0) return (int)cudaGetLastError();
    const float* b = (const float*)blob;
    const int *x = (const int*)px, *y = (const int*)py, *p = (const int*)pid;
    const int* meta = (const int*)meta_tab;
    const float *node = (const float*)node_tab, *prim = (const float*)prim_tab;
    float *l = (float*)out_l, *w = (float*)out_w, *nv = (float*)out_nv;
    unsigned long long* pc = (unsigned long long*)pop_counts;
    unsigned int* tc = (unsigned int*)trav_counters;
    cudaStream_t st = (cudaStream_t)stream;
    switch (mode) {
        case 0: launch<0, 0>(b, x, y, p, n_lanes, seed, s0, n_samples, meta, node, prim, l, w, nv, pc, tc, st); break;
        case 1: launch<0, 1>(b, x, y, p, n_lanes, seed, s0, n_samples, meta, node, prim, l, w, nv, pc, tc, st); break;
        case 2: launch<1, 0>(b, x, y, p, n_lanes, seed, s0, n_samples, meta, node, prim, l, w, nv, pc, tc, st); break;
        case 3: launch<1, 1>(b, x, y, p, n_lanes, seed, s0, n_samples, meta, node, prim, l, w, nv, pc, tc, st); break;
        case 4: launch<2, 0>(b, x, y, p, n_lanes, seed, s0, n_samples, meta, node, prim, l, w, nv, pc, tc, st); break;
        case 5: launch<2, 1>(b, x, y, p, n_lanes, seed, s0, n_samples, meta, node, prim, l, w, nv, pc, tc, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
