"""The integrators: the persistent wavefront and the per-sample wave.

``trace_wave`` is the port's counterpart of the reference's per-sample wave
(``pbrt_tpu/device/integrator.py trace_wave``): one camera sample per pixel
traced to the end through a fixed number of bounces, for path, volpath
(participating media, interface crossings), directlighting, whitted and ao
(``_trace_ao``), with subsurface materials (the tabulated BSSRDF's exit
event, or the random walk through their interior media), and at each ray's
shutter time in a scene with moving prims; render.py takes it for every
scene outside the persistent wavefront's class (motion, the animated and
realistic cameras among them), and for a checkpointed render.

``trace_persistent`` is the port's counterpart of
``pbrt_tpu/device/integrator.py trace_persistent`` for the path and
directlighting integrators
(src/integrators/path.rs li :79-222, directlighting.rs; shared NEE/MIS
src/core/integrator.rs estimate_direct :109-237): one lane per pixel, each
lane traces its pixel's samples one after another and regenerates a camera
ray the moment its path ends. Per bounce it makes one closest-hit query and
one shadow query per light sample, shades with the material's lobes, does
NEE with MIS (one light picked by the uniform, power or spatial
distribution, or every light with its own sample count for
directlighting's "all" strategy; delta lights unweighted), continues the
path (directlighting: through specular lobes only) with Russian roulette on
path, and flushes finished samples into per-lane accumulators.

The (pixel, sample, dimension) sample streams and the per-sample math are
the reference's, so the port reproduces its images to fp tolerance
(tests/test_torch_render.py).

The reference's ``jax.lax.while_loop`` becomes a Python loop whose
condition syncs once per iteration; CUDA graphs or a megakernel are later
work.
"""
from __future__ import annotations

import math

import torch

from . import media, rng
from .bsdf import (
    LOBE_SSS_ADAPTER, SPECULAR_KINDS, _is_specular, bsdf_f, bsdf_pdf, bsdf_sample, cosine_sample_hemisphere, num_lobes,
)
from .bssrdf import pdf_sp, sample_radial_cdf, sr_eval, sw_factor
from .intersect import intersect, intersect_p
from .lightdistrib import spatial_pmf_of, spatial_select
from .lights import area_light_emission, compute_power, env_le, env_pdf_li, pdf_li_area_hit, sample_li
from .materials import lobe_table, make_bsdf
from .sampler import sample_1d, sample_2d
from .shading import apply_bump, dot, surface_interaction
from .texture import has_imagemaps
from ..scene.arrays import MAT_KDSUBSURFACE, MAT_SUBSURFACE

RAY_EPS = 1e-3
DPB = 8  # sampler dimensions per bounce


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """Power heuristic beta=2 (src/core/sampling.rs:327-330)."""
    f = nf * f_pdf
    g = ng * g_pdf
    return torch.where(f > 0, f * f / torch.clamp(f * f + g * g, min=1e-30), 0.0)


def _next_float_away(x, direction):
    """Next representable f32 away from x in `direction`'s sign; unchanged
    where direction == 0 (pbrt.rs next_float_up/down as one signed bit-bump
    on the int32 view)."""
    bits = x.view(torch.int32)
    up = direction > 0
    nonneg = x >= 0
    moved = (bits + torch.where(up == nonneg, 1, -1).to(torch.int32)).view(torch.float32)
    # zero steps to the smallest normal of the right sign
    tiny = 1.17549435e-38
    moved = torch.where(x == 0.0, torch.where(up, tiny, -tiny), moved)
    return torch.where(direction == 0.0, x, moved)


def _offset_ray(p, ng, w, p_err):
    """Offset a secondary-ray origin along the geometric normal past the hit
    point's FP error bound, then one ulp away (transform.rs
    offset_ray_origin :455-475). p_err None (a medium vertex, which has no
    error bound): the reference's conservative displacement proportional to
    the point's magnitude instead."""
    if p_err is None:
        s = torch.sign(dot(ng, w))[:, None]
        mag = p.abs().max(-1, keepdim=True).values
        return p + ng * s * (RAY_EPS * (0.1 + 0.05 * mag))
    dist = (ng.abs() * p_err).sum(-1, keepdim=True)
    offset = dist * ng
    offset = torch.where((dot(w, ng) < 0)[:, None], -offset, offset)
    return _next_float_away(p + offset, offset)


def _to_local(si, w):
    return torch.stack([dot(w, si["ss"]), dot(w, si["ts"]), dot(w, si["ns"])], dim=-1)


def _to_world(si, w):
    return w[..., 0:1] * si["ss"] + w[..., 1:2] * si["ts"] + w[..., 2:3] * si["ns"]


def _light_select_pdf(static) -> float:
    """The uniform light choice's probability, 1 / n_lights (reference
    integrator._light_select_pdf; SPPM's camera pass selects so)."""
    return 1.0 / max(static.n_lights, 1)


def _round_ns(kind: str, n: int) -> int:
    """Sampler::round_count: the power-of-2 samplers round an array's size up
    to a power of two (zerotwosequence.rs, maxmindist.rs)."""
    if kind in ("zerotwosequence", "lowdiscrepancy", "maxmindist") and n > 1:
        return 1 << (n - 1).bit_length()
    return max(n, 1)


def _compute_duv(si, o, d, dd):
    """uv-footprint derivative (R, 2) of the +1-pixel offset ray with
    direction dd and the shared origin o (interaction.rs
    compute_differentials :269): its hit on the tangent plane, solved for
    (du, dv) over the two axes where |ng| is smallest; zero where the
    offset ray runs parallel to the plane or dpdu, dpdv are degenerate."""
    ng = si["ng"]
    denom = dot(ng, dd)
    t_off = dot(ng, si["p"] - o) / torch.where(denom.abs() > 1e-9, denom, 1e-9)
    dp = o + dd * t_off[:, None] - si["p"]
    drop = ng.abs().argmax(-1)  # the dominant axis of ng
    ax0 = torch.where(drop == 0, 1, 0)[:, None]
    ax1 = torch.where(drop == 2, 1, 2)[:, None]

    def pick(v, ax):
        return v.gather(1, ax)[:, 0]

    a00, a01 = pick(si["dpdu"], ax0), pick(si["dpdv"], ax0)
    a10, a11 = pick(si["dpdu"], ax1), pick(si["dpdv"], ax1)
    b0, b1 = pick(dp, ax0), pick(dp, ax1)
    det = a00 * a11 - a01 * a10
    ok = det.abs() > 1e-12
    inv = 1.0 / torch.where(ok, det, 1.0)
    du = torch.where(ok, (a11 * b0 - a01 * b1) * inv, 0.0)
    dv = torch.where(ok, (a00 * b1 - a10 * b0) * inv, 0.0)
    valid = denom.abs() > 1e-9
    return torch.where(valid[:, None], torch.stack([du, dv], dim=-1), 0.0)


def _light_selectors(sa, static, icfg: dict, nee_on: bool = True, ikind: str = "path"):
    """Light-selection closures (lightdistrib.rs): "uniform",
    power-proportional, or the voxel-grid "spatial" distribution, whose
    table the route builds into icfg["spatial_distribution"]. Returns
    (_select_light(u, p_at) -> (lid, pmf), _sel_pmf_of(lid, p_at)); p_at is
    the shading point that selects (for the MIS weight at an emission hit,
    the previous path vertex). Without NEE (nee_on False) the spatial
    distribution is not used, and whitted selects by power under "power"
    and "spatial" (the reference's _light_selectors)."""
    strategy = str(icfg.get("light_strategy", "uniform"))
    n = static.n_lights
    sel_pdf = 1.0 / max(n, 1)
    spatial = strategy == "spatial" and n > 1 and nee_on
    use_power = not spatial and strategy in ("power", "spatial") and n > 1 and (nee_on or ikind == "whitted")
    if spatial:
        dist = icfg.get("spatial_distribution")
        if dist is None:
            raise ValueError("the 'spatial' light strategy needs icfg['spatial_distribution'] "
                             "(lightdistrib.build_spatial_distribution)")
    if use_power:
        pw = compute_power(sa, static)
        pmf = torch.clamp(pw / torch.clamp(pw.sum(), min=1e-20), min=1e-6)
        pmf = pmf / pmf.sum()  # every light stays selectable (unbiased)
        cdf = torch.cumsum(pmf, 0)

    def _sel_pmf_of(lid, p_at):
        if spatial:
            return spatial_pmf_of(dist, p_at, lid)
        if not use_power:
            return torch.full(lid.shape, sel_pdf, dtype=torch.float32, device=lid.device)
        return pmf[lid]

    def _select_light(u_sel, p_at):
        if spatial:
            return spatial_select(dist, p_at, u_sel)
        if not use_power:
            lid = torch.clamp((u_sel * n).to(torch.int64), max=n - 1)
            return lid, torch.full(u_sel.shape, sel_pdf, dtype=torch.float32, device=u_sel.device)
        lid = (u_sel[:, None] > cdf[None, :-1]).sum(1)
        lid = torch.clamp(lid, 0, n - 1)
        return lid, _sel_pmf_of(lid, p_at)

    return _select_light, _sel_pmf_of


def trace_persistent(sa, static, icfg: dict, scfg: dict, seed: int, pixel, s0: int,
                     n_samples: int, regen, max_sample_luminance=float("inf"), joint=False):
    """Persistent wavefront path tracer with in-place ray regeneration.

    One lane per pixel (pixel: (R,) int64 pixel ids); lane samples s0 ..
    s0+n_samples-1 are traced one after another. regen(sample_idx (R,)) ->
    (o, d, w_filter, dd_x, dd_y) gives fresh camera samples for every lane,
    with the directions of the +1-pixel offset rays that a scene with
    imagemaps carries on camera rays (bounced rays carry none, as in the
    reference). icfg: kind ("path" or "directlighting"), max_depth,
    rr_threshold, strategy (directlighting's "all" or "one"),
    light_strategy, and what the route builds once: "spatial_distribution",
    "lobe_table" (made here when absent) and, for textured scenes,
    "tex_atlases" (texture.prepare_atlases). A scene without imagemaps,
    textured parameters and bump maps traces none of that. scfg: sampler
    kind, spp and, for "stratified", "strata". joint: CUDA queries of a
    wide scene go through the joint traversal kernel (B2) instead of B1.

    Returns (accLw (R, 3), accW (R,), n_vertices (R,)), float32.
    """
    ikind = icfg.get("kind", "path")
    if ikind not in ("path", "directlighting"):
        raise NotImplementedError(f"pbrt_tpu_torch does not support the '{ikind}' integrator yet")
    R = pixel.shape[0]
    dev = pixel.device
    max_depth = int(icfg["max_depth"])
    rr_threshold = float(icfg.get("rr_threshold", 1.0))
    kind_s = scfg["kind"]
    spp = scfg["spp"]
    strata = scfg.get("strata")
    n_lights = static.n_lights
    direct_all = ikind == "directlighting" and icfg.get("strategy", "all") == "all" and n_lights > 1
    _select_light, _sel_pmf_of = _light_selectors(sa, static, icfg)
    table = icfg.get("lobe_table")
    if table is None:
        table = lobe_table(sa, static)
    textured = bool(table.get("textured"))
    atlases = icfg.get("tex_atlases")
    differentials = has_imagemaps(static)
    s_end = s0 + n_samples

    def _nee(si, lobes, alive_m, dim_base, s_cur, light_index=None, dim_salt=0, array_j=0, array_n=1):
        """uniform_sample_onelight / estimate_direct, surface-only form. With
        light_index: that light, sample j of its n-point array
        (UniformSampleAll: sampler.rs request_2d_array, stratified.rs)."""
        u1, u2 = sample_2d(kind_s, seed, pixel, s_cur, dim_base + 1 + 131 * dim_salt, spp, strata)
        if light_index is None:
            u_sel = sample_1d(kind_s, seed, pixel, s_cur, dim_base, spp, strata)
            lid, spdf = _select_light(u_sel, si["p"])
        else:
            lid = torch.full((R,), light_index, dtype=torch.int64, device=dev)
            spdf = 1.0
            if array_n > 1:
                r1 = rng.hash_combine(seed, pixel, s_cur, 0xA117 + light_index)
                r2 = rng.hash_combine(seed, pixel, s_cur, 0xB229 + light_index)
                u1 = (((array_j + r1 % array_n) % array_n).float() + u1) / array_n
                u2 = (((array_j + r2 % array_n) % array_n).float() + u2) / array_n
        ls = sample_li(sa, static, lid, si["p"], u1, u2, cone_spheres=static.has_cone_sphere_lights)
        wi = ls["wi"]
        wo_l = _to_local(si, si["wo"])
        wi_l = _to_local(si, wi)
        refl = dot(wi, si["ng"]) * dot(si["wo"], si["ng"]) > 0
        f_val = bsdf_f(lobes, wo_l, wi_l, refl) * dot(wi, si["ns"]).abs()[:, None]
        p_b = bsdf_pdf(lobes, wo_l, wi_l)
        p_l = ls["pdf"] * spdf
        contributes = alive_m & (p_l > 0) & (f_val * ls["li"] > 0).any(-1)
        o_sh = _offset_ray(si["p"], si["ng"], wi, si["p_err"])
        t_sh = torch.where(contributes, ls["dist"] * (1.0 - 2.0 * RAY_EPS), -1.0)
        occ = intersect_p(sa, static, o_sh, wi, t_sh, sort_rays=True, joint=joint)
        vis = torch.where(occ[:, None], 0.0, 1.0)
        w_l = torch.where(ls["delta"], 1.0, power_heuristic(1.0, p_l, 1.0, p_b))
        contrib = f_val * ls["li"] * vis * (w_l / torch.clamp(p_l, min=1e-30))[:, None]
        return torch.where(contributes[:, None], contrib, 0.0)

    s_cur = torch.full((R,), s0, dtype=torch.int64, device=dev)
    o, d, w_cur, dd_x, dd_y = regen(s_cur)
    L = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    beta = torch.ones((R, 3), dtype=torch.float32, device=dev)
    alive = torch.full((R,), n_samples > 0, dtype=torch.bool, device=dev)
    prev_spec = torch.ones(R, dtype=torch.bool, device=dev)
    prev_pdf = torch.ones(R, dtype=torch.float32, device=dev)
    prev_p = o
    eta_scale = torch.ones(R, dtype=torch.float32, device=dev)
    bounces = torch.zeros(R, dtype=torch.int64, device=dev)
    accL = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    accW = torch.zeros(R, dtype=torch.float32, device=dev)
    nverts = torch.zeros(R, dtype=torch.float32, device=dev)
    done = ~alive
    # each live-lane iteration deepens a path (<= max_depth) or consumes a
    # sample, so the cap is a safety valve only
    it_cap = n_samples * (max_depth + 2) + 8
    it = 0
    while it < it_cap and bool((~done).any()):
        it += 1
        # --- extend: intersect + escaped/emitted pickup (deferred MIS) ---
        t_query = torch.where(alive, torch.inf, -1.0)
        hit = intersect(sa, static, o, d, t_query, sort_rays=True, joint=joint)
        si = surface_interaction(sa, hit, o, d, static.quadric_kinds)
        if static.has_bump:
            si = apply_bump(sa, static, si, atlases)
        valid = si["valid"]
        nverts = nverts + (alive & valid).to(torch.float32)

        if static.has_infinite:
            # escaped rays pick up the environment with the deferred MIS
            # weight (the selection pmf at the previous vertex)
            esc = alive & ~valid
            env_row = torch.full((R,), max(static.infinite_light_index, 0), dtype=torch.int64, device=dev)
            p_l = env_pdf_li(sa, static, d) * _sel_pmf_of(env_row, prev_p)
            w = torch.where(prev_spec, 1.0, power_heuristic(1.0, prev_pdf, 1.0, p_l))
            L = L + torch.where(esc[:, None], beta * env_le(sa, static, d) * w[:, None], 0.0)
        alive = alive & valid

        if static.has_area_lights:
            lid = si["light"]
            emitting = alive & (lid >= 0)
            le = area_light_emission(sa, lid, si["ng"], si["wo"])
            area = sa.prim_area[torch.clamp(si["prim"], min=0)]
            p_l = pdf_li_area_hit(sa, prev_p, si["p"], si["ng"], lid, area,
                                  cone_spheres=static.has_cone_sphere_lights) * _sel_pmf_of(
                torch.clamp(lid, min=0), prev_p)
            w = torch.where(prev_spec, 1.0, power_heuristic(1.0, prev_pdf, 1.0, p_l))
            L = L + torch.where(emitting[:, None], beta * le * w[:, None], 0.0)

        # --- shade: NEE + BSDF continuation (per-lane bounce depth) ---
        dim_base = 2 + bounces * DPB
        can_scatter = alive & (bounces < max_depth - 1)
        if textured:
            duvdx = _compute_duv(si, o, d, dd_x) if differentials else None
            duvdy = _compute_duv(si, o, d, dd_y) if differentials else None
            lobes = make_bsdf(sa, static, si["mat"], table, si["uv"], si["p"], duvdx, duvdy, atlases)
        else:
            # the hit's uv and p: a mix row's hash and hair's h read them
            lobes = make_bsdf(sa, static, si["mat"], table, si["uv"], si["p"])
        alive_sh = can_scatter & (num_lobes(lobes) > 0)
        if direct_all:
            # UniformSampleAll (directlighting.rs strategy "all"): each light's
            # nsamples array samples, averaged (sampler round_count)
            for li in range(n_lights):
                ns = _round_ns(kind_s, static.light_n_samples[li])
                acc = torch.zeros((R, 3), dtype=torch.float32, device=dev)
                for j in range(ns):
                    acc = acc + _nee(si, lobes, alive_sh, dim_base, s_cur, light_index=li,
                                     dim_salt=1 + li * 1024 + j, array_j=j, array_n=ns)
                L = L + beta * acc / ns
        elif n_lights > 0:
            L = L + beta * _nee(si, lobes, alive_sh, dim_base, s_cur)

        u_lobe = sample_1d(kind_s, seed, pixel, s_cur, dim_base + 2, spp, strata)
        u1, u2 = sample_2d(kind_s, seed, pixel, s_cur, dim_base + 3, spp, strata)
        wo_l = _to_local(si, si["wo"])
        if ikind == "directlighting":
            # continuation through the specular lobes only (the
            # specular_reflect/transmit recursion, integrator.rs:409-520);
            # a diffuse vertex ends the path
            kinds = lobes["kind"]
            lobes = {"kind": torch.where(_is_specular(kinds), kinds, 0), "data": lobes["data"],
                     "possible": tuple(p & SPECULAR_KINDS for p in lobes["possible"])}
        bs = bsdf_sample(lobes, wo_l, u_lobe, u1, u2)
        wi_w = _to_world(si, bs["wi"])
        cos_term = dot(wi_w, si["ns"]).abs()
        thru = bs["f"] * (cos_term / torch.clamp(bs["pdf"], min=1e-30))[:, None]
        surf_cont = alive_sh & bs["valid"] & (thru > 0).any(-1)
        sc = surf_cont[:, None]

        new_alive = surf_cont
        new_beta = torch.where(sc, beta * thru, beta)
        new_d = torch.where(sc, wi_w, d)
        new_o = torch.where(sc, _offset_ray(si["p"], si["ng"], wi_w, si["p_err"]), o)
        new_spec = bs["specular"] & surf_cont
        new_pdf = torch.where(surf_cont, torch.clamp(bs["pdf"], min=1e-30), prev_pdf)
        new_prev_p = torch.where(sc, si["p"], prev_p)
        eta_scale = torch.where(surf_cont, eta_scale * bs["eta_scale"], eta_scale)
        new_bounces = bounces + surf_cont.to(torch.int64)

        if ikind == "path":
            # russian roulette (path.rs:206-214); directlighting's specular
            # chains are cut by depth only
            max_c = (new_beta * eta_scale[:, None]).max(-1).values
            q = torch.clamp(1.0 - max_c, min=0.05)
            do_rr = (new_bounces > 3) & (max_c < rr_threshold)
            u_rr = sample_1d(kind_s, seed, pixel, s_cur, dim_base + 4, spp, strata)
            killed = do_rr & (u_rr < q)
            new_alive = new_alive & ~killed
            new_beta = torch.where((do_rr & ~killed)[:, None], new_beta / torch.clamp(1.0 - q, min=1e-6)[:, None],
                                   new_beta)

        # --- flush finished samples, regenerate or retire lanes ---
        die = ~done & ~new_alive
        Lf = torch.clamp(torch.where(torch.isfinite(L), L, 0.0), min=0.0)
        if max_sample_luminance < float("inf"):
            y = Lf[:, 0] * 0.212671 + Lf[:, 1] * 0.715160 + Lf[:, 2] * 0.072169
            scale = torch.where(y > max_sample_luminance, max_sample_luminance / torch.clamp(y, min=1e-12), 1.0)
            Lf = Lf * scale[:, None]
        accL = accL + torch.where(die[:, None], Lf * w_cur[:, None], 0.0)
        accW = accW + torch.where(die, w_cur, 0.0)

        s_next = s_cur + 1
        more = die & (s_next < s_end)
        done = done | (die & ~more)
        o_r, d_r, w_r, ddx_r, ddy_r = regen(torch.where(more, s_next, s_cur))
        sel = more[:, None]
        o = torch.where(sel, o_r, new_o)
        d = torch.where(sel, d_r, new_d)
        L = torch.where(sel, 0.0, L)
        beta = torch.where(sel, 1.0, new_beta)
        alive = new_alive | more
        prev_spec = more | new_spec
        prev_pdf = torch.where(more, 1.0, new_pdf)
        prev_p = torch.where(sel, o_r, new_prev_p)
        eta_scale = torch.where(more, 1.0, eta_scale)
        bounces = torch.where(more, 0, new_bounces)
        s_cur = torch.where(more, s_next, s_cur)
        w_cur = torch.where(more, w_r, w_cur)
        if differentials:
            # camera rays only: a lane that bounces carries none
            dd_x = torch.where(sel, ddx_r, 0.0)
            dd_y = torch.where(sel, ddy_r, 0.0)

    return accL, accW, nverts


def _lane_samples(sample_idx, R, dev):
    """The wave's sample index as an (R,) int64 tensor."""
    return torch.as_tensor(sample_idx, dtype=torch.int64, device=dev).expand(R).contiguous()


def trace_wave(sa, static, icfg: dict, scfg: dict, seed: int, o, d, pixel, sample_idx, diff_dirs=None, joint=False,
               time=None):
    """Trace one wave of camera rays to completion: the per-sample wave of
    the path, volpath, directlighting, whitted and ao integrators
    (reference device/integrator.py trace_wave :192-692; path.rs li,
    volpath.rs li, directlighting.rs, whitted.rs, ao.rs). Returns (L (R, 3),
    n_vertices (R,)).

    icfg: kind, max_depth, rr_threshold, strategy (directlighting's "all"
    or "one"), light_strategy, n_samples and cos_sample (ao), and what the
    route builds once: "spatial_distribution", "lobe_table", "tex_atlases".
    scfg: sampler kind, spp and, for "stratified", "strata". pixel: (R,)
    pixel ids; sample_idx: the wave's sample index; diff_dirs: the camera
    rays' +1-pixel offset directions (dd_x, dd_y), or None.

    Every wave runs max_depth - 1 + extra_iters bounces with no early exit
    (extra_iters 4 where interface crossings or media can occur, 24 with
    subsurface walk media; 0 otherwise), then a last pickup. A bounce: the
    closest hit; in a medium, the distance sample, whose weight lands on
    beta before emission is collected; escaped and emitted radiance with the
    deferred MIS weight; NEE at the surface or medium vertex (shadow rays
    through interface boundaries carry the media's transmittance); the
    BSDF or phase continuation; the subsurface event of the tabulated
    BSSRDF; the medium transition at a crossed interface; Russian roulette.
    An interface (null) crossing passes the ray on with its MIS state and
    costs no depth, nor does scattering inside a subsurface walk medium.
    Sample dimensions: 2 + 8 b per bounce b (NEE 0-1, lobe 2-3, roulette 4,
    phase 6, the BSSRDF 8-10); medium keys hash_combine(seed, pixel,
    sample, 0xC0FFEE00 + 2 b), shadow keys the same + 1. time: the rays'
    shutter fractions (R,) in a scene with moving prims: every camera,
    bounce and shadow query and every hit's shading record is taken at it
    (the subsurface probe chain at shutter open, as in the reference)."""
    R = o.shape[0]
    dev = o.device
    if not static.has_motion:
        time = None
    ikind = icfg["kind"]
    max_depth = int(icfg["max_depth"])
    kind_s = scfg["kind"]
    spp = scfg["spp"]
    strata = scfg.get("strata")
    sidx = _lane_samples(sample_idx, R, dev)
    if ikind == "ao":
        return _trace_ao(sa, static, icfg, scfg, seed, o, d, pixel, sidx, joint, time), torch.ones(R, device=dev)

    nee_on = ikind in ("path", "volpath", "directlighting")
    _select_light, _sel_pmf_of = _light_selectors(sa, static, icfg, nee_on, ikind)
    handle_media, pass_null = _wave_media(static, ikind)
    table = icfg.get("lobe_table")
    if table is None:
        table = lobe_table(sa, static)
    textured = bool(table.get("textured"))
    atlases = icfg.get("tex_atlases")
    differentials = has_imagemaps(static) and diff_dirs is not None
    f32 = dict(dtype=torch.float32, device=dev)

    def s1(dim):
        return sample_1d(kind_s, seed, pixel, sidx, dim, spp, strata)

    def s2(dim):
        return sample_2d(kind_s, seed, pixel, sidx, dim, spp, strata)

    def query(sa_, static_, o_, d_, t_):
        return intersect(sa_, static_, o_, d_, t_, joint=joint, time=time)

    def pickup(st, b):
        """Closest hit, the medium's distance sample, then escaped and
        emitted radiance with the deferred MIS weight (reference :232)."""
        t_query = torch.where(st["alive"], torch.inf, -1.0)
        o_, d_ = st["o"], st["d"]
        hit = intersect(sa, static, o_, d_, t_query, sort_rays=True, joint=joint, time=time)
        si = surface_interaction(sa, hit, o_, d_, static.quadric_kinds, time)
        if static.has_bump:
            si = apply_bump(sa, static, si, atlases)
        valid = si["valid"]
        alive = st["alive"]
        st["nv"] = st["nv"] + (alive & valid).to(torch.float32)
        beta = st["beta"]
        if handle_media:
            t_surf = torch.where(valid, hit["t"], torch.inf)
            mkey = rng.hash_combine(seed, pixel, sidx, 0xC0FFEE00 + 2 * b)
            ms = media.medium_sample(sa, static, st["medium"], o_, d_, t_surf, mkey)
            in_scatter = alive & ms["hit_medium"]
            beta = torch.where((alive & (st["medium"] >= 0))[:, None], beta * ms["weight"], beta)
            g_par = sa.med_param[torch.clamp(st["medium"], min=0)][:, 6]
            med_vertex = {"p": o_ + d_ * ms["t"][:, None], "wo": -d_, "g": g_par, "active": in_scatter}
        else:
            in_scatter = torch.zeros(R, dtype=torch.bool, device=dev)
            med_vertex = None
        L = st["L"]
        if static.has_infinite:
            esc = alive & ~valid & ~in_scatter
            le = env_le(sa, static, d_)
            if nee_on:
                env_row = torch.full((R,), max(static.infinite_light_index, 0), dtype=torch.int64, device=dev)
                p_l = env_pdf_li(sa, static, d_) * _sel_pmf_of(env_row, st["prev_p"])
                w = torch.where(st["prev_spec"], 1.0, power_heuristic(1.0, st["prev_pdf"], 1.0, p_l))
            else:
                w = torch.ones(R, **f32)
            L = L + torch.where(esc[:, None], beta * le * w[:, None], 0.0)
        alive = alive & (valid | in_scatter)
        if static.has_area_lights:
            lid = si["light"]
            emitting = alive & ~in_scatter & (lid >= 0)
            le = area_light_emission(sa, lid, si["ng"], si["wo"])
            if nee_on:
                area = sa.prim_area[torch.clamp(si["prim"], min=0)]
                p_l = pdf_li_area_hit(sa, st["prev_p"], si["p"], si["ng"], lid, area,
                                      cone_spheres=static.has_cone_sphere_lights) * _sel_pmf_of(
                    torch.clamp(lid, min=0), st["prev_p"])
                w = torch.where(st["prev_spec"], 1.0, power_heuristic(1.0, st["prev_pdf"], 1.0, p_l))
            else:
                w = torch.ones(R, **f32)
            L = L + torch.where(emitting[:, None], beta * le * w[:, None], 0.0)
        if textured and differentials:
            si["duvdx"] = _compute_duv(si, o_, d_, st["dd_x"])
            si["duvdy"] = _compute_duv(si, o_, d_, st["dd_y"])
        st.update(L=L, beta=beta, alive=alive)
        return si, in_scatter, med_vertex

    def shadow_tr(p_v, ng_v, wi, dist, medium_v, b, needed=None, p_err=None):
        """Shadow factor: visibility, or the transmittance through interface
        boundaries and media (VisibilityTester::unoccluded / ::tr)."""
        o_sh = _offset_ray(p_v, ng_v, wi, p_err)
        t_sh = dist * (1.0 - 2.0 * RAY_EPS)
        if pass_null:
            key = rng.hash_combine(seed, pixel, sidx, 0xC0FFEE00 + 2 * b + 1)
            return media.transmittance_shadow(sa, static, o_sh, wi, t_sh, medium_v, key, _offset_ray, RAY_EPS,
                                              query=query)
        if needed is not None:
            t_sh = torch.where(needed, t_sh, -1.0)
        occ = intersect_p(sa, static, o_sh, wi, t_sh, sort_rays=True, joint=joint, time=time)
        return torch.where(occ[:, None], 0.0, 1.0)

    def nee_at(si, lobes, alive_m, medium_v, b, dim_base, light_index=None, dim_salt=0, medium_vertex=None,
               array_j=0, array_n=1):
        """NEE at a surface or (medium_vertex) a medium vertex (reference
        _nee_at :326): one light by the selection distribution, or light
        light_index with sample j of its n-point array (UniformSampleAll,
        strata hashes 0xA117 and 0xB229)."""
        if static.n_lights == 0:
            return torch.zeros((R, 3), **f32)
        u_sel = s1(dim_base + 131 * dim_salt)
        u1, u2 = s2(dim_base + 1 + 131 * dim_salt)
        if medium_vertex is None:
            p_v = si["p"]
        else:
            p_v = torch.where(medium_vertex["active"][:, None], medium_vertex["p"], si["p"])
        if light_index is None:
            lid, spdf = _select_light(u_sel, p_v)
        else:
            lid = torch.full((R,), light_index, dtype=torch.int64, device=dev)
            spdf = 1.0
            if array_n > 1:
                r1 = rng.hash_combine(seed, pixel, sidx, 0xA117 + light_index)
                r2 = rng.hash_combine(seed, pixel, sidx, 0xB229 + light_index)
                u1 = (((array_j + r1 % array_n) % array_n).float() + u1) / array_n
                u2 = (((array_j + r2 % array_n) % array_n).float() + u2) / array_n
        ls = sample_li(sa, static, lid, p_v, u1, u2, cone_spheres=static.has_cone_sphere_lights)
        wi = ls["wi"]
        wo_l = _to_local(si, si["wo"])
        wi_l = _to_local(si, wi)
        refl = dot(wi, si["ng"]) * dot(si["wo"], si["ng"]) > 0
        f_val = bsdf_f(lobes, wo_l, wi_l, refl) * dot(wi, si["ns"]).abs()[:, None]
        p_b = bsdf_pdf(lobes, wo_l, wi_l)
        if medium_vertex is not None:
            ph = media.hg_p(dot(medium_vertex["wo"], wi), medium_vertex["g"])
            f_val = torch.where(medium_vertex["active"][:, None], ph[:, None], f_val)
            p_b = torch.where(medium_vertex["active"], ph, p_b)
        p_l = ls["pdf"] * spdf
        contributes = alive_m & (p_l > 0) & (f_val * ls["li"] > 0).any(-1)
        if medium_vertex is None:
            vis = shadow_tr(p_v, si["ng"], wi, ls["dist"], medium_v, b, needed=contributes, p_err=si["p_err"])
        else:
            # a medium vertex has no normal: offset along wi itself
            ng_sh = torch.where(medium_vertex["active"][:, None], wi, si["ng"])
            vis = shadow_tr(p_v, ng_sh, wi, ls["dist"], medium_v, b, needed=contributes)
        w_l = torch.where(ls["delta"], 1.0, power_heuristic(1.0, p_l, 1.0, p_b))
        contrib = f_val * ls["li"] * vis * (w_l / torch.clamp(p_l, min=1e-30))[:, None]
        return torch.where(contributes[:, None], contrib, 0.0)

    def sss_event(mask, si, L, nw, medium_v, b, dim_base):
        """The tabulated BSSRDF's exit event (bssrdf.rs sample_s / sample_sp;
        reference _sss_event :393): the projection axis, channel and chain
        pick from one dimension, a radius from the channel's profile, a
        chain of K_PROBE = 4 probe queries along the axis collecting hits
        on the same material, the sel_idx-th of them as the exit, Sp /
        pdf_sp (pdf_sp over nfound), NEE there with the adapter lobe
        (dim_salt 7) and a cosine continuation about its normal."""
        mat = torch.clamp(si["mat"], min=0)
        sigt3, prof3, cdf3 = sa.sss_sigma_t[mat], sa.sss_prof[mat], sa.sss_cdf[mat]
        rhoeff3, eta_m, radius = sa.sss_rhoeff[mat], sa.sss_eta[mat], sa.sss_radius
        ssv, tsv, nsv = si["ss"], si["ts"], si["ns"]
        u_ax = s1(dim_base + 8)
        u_r, u_phi = s2(dim_base + 9)
        use0 = u_ax < 0.5
        use1 = ~use0 & (u_ax < 0.75)
        u0c, u1c = use0[:, None], use1[:, None]
        vx = torch.where(u0c, ssv, torch.where(u1c, tsv, nsv))
        vy = torch.where(u0c, tsv, torch.where(u1c, nsv, ssv))
        vz = torch.where(u0c, nsv, torch.where(u1c, ssv, tsv))
        u1n = torch.where(use0, u_ax * 2.0, torch.where(use1, (u_ax - 0.5) * 4.0, (u_ax - 0.75) * 4.0))
        ch = torch.clamp((u1n * 3.0).to(torch.int64), 0, 2)
        u1n = u1n * 3.0 - ch.to(torch.float32)
        prof_ch = prof3.gather(1, ch[:, None, None].expand(R, 1, prof3.shape[2]))[:, 0]
        cdf_ch = cdf3.gather(1, ch[:, None, None].expand(R, 1, cdf3.shape[2]))[:, 0]
        rhoeff_ch = rhoeff3.gather(1, ch[:, None])[:, 0]
        sigt_ch = sigt3.gather(1, ch[:, None])[:, 0]
        r_w = sample_radial_cdf(radius, prof_ch, cdf_ch, rhoeff_ch, u_r) / torch.clamp(sigt_ch, min=1e-9)
        rmax_w = sample_radial_cdf(radius, prof_ch, cdf_ch, rhoeff_ch, torch.full((R,), 0.999, **f32)) / torch.clamp(
            sigt_ch, min=1e-9)
        ok_r = mask & (sigt_ch > 0) & (r_w < rmax_w)
        l_probe = 2.0 * torch.sqrt(torch.clamp(rmax_w * rmax_w - r_w * r_w, min=0.0))
        phi = 2.0 * math.pi * u_phi
        p0 = (si["p"] + r_w[:, None] * (torch.cos(phi)[:, None] * vx + torch.sin(phi)[:, None] * vy)
              - (0.5 * l_probe)[:, None] * vz)
        recs = probe_chain(sa, static, p0, vz, torch.where(ok_r, l_probe, -1.0), si["mat"], joint)
        nfound = sum(m.to(torch.int64) for m, _h, _b in recs)
        sel_idx = torch.minimum(torch.clamp((u1n * nfound.to(torch.float32)).to(torch.int64), min=0),
                                torch.clamp(nfound - 1, min=0))
        run = torch.zeros(R, dtype=torch.int64, device=dev)
        hit_sel = {"t": torch.zeros(R, **f32), "prim": torch.full((R,), -1, dtype=torch.int64, device=dev),
                   "b1": torch.zeros(R, **f32), "b2": torch.zeros(R, **f32)}
        o_sel = p0
        for m, hk, bs_ in recs:
            take = m & (run == sel_idx)
            hit_sel = {kk: torch.where(take, hk[kk].to(v.dtype), v) for kk, v in hit_sel.items()}
            o_sel = torch.where(take[:, None], bs_, o_sel)
            run = run + m.to(torch.int64)
        si2 = surface_interaction(sa, hit_sel, o_sel, vz, static.quadric_kinds)
        act = ok_r & (nfound > 0)
        d_vec = si["p"] - si2["p"]
        dist = torch.sqrt((d_vec * d_vec).sum(-1))
        pdf_v = pdf_sp(radius, prof3, rhoeff3, sigt3, d_vec, si2["ng"], ssv, tsv, nsv)
        pdf_v = pdf_v / torch.clamp(nfound.to(torch.float32), min=1.0)
        w_sp = sr_eval(radius, prof3, sigt3, dist) / torch.clamp(pdf_v, min=1e-12)[:, None]
        beta2 = nw["beta"] * torch.where(act[:, None], w_sp, 1.0)
        act = act & (beta2 > 0).any(-1)
        # NEE at the exit with the Sw adapter lobe, wo = +ns (sample_s tail)
        data = torch.zeros((R, 1, 14), **f32)
        data[:, 0, 3] = eta_m
        adapter = {"kind": torch.where(act, LOBE_SSS_ADAPTER, 0).to(torch.int32)[:, None], "data": data,
                   "possible": (frozenset({LOBE_SSS_ADAPTER}),), "has_beckmann": False, "has_schlick": False}
        si2_nee = dict(si2, wo=si2["ns"])
        L = L + beta2 * nee_at(si2_nee, adapter, act, medium_v, b, dim_base, dim_salt=7)
        u1d, u2d = s2(dim_base + 10)
        wi_loc = cosine_sample_hemisphere(u1d, u2d)
        wi2 = wi_loc[:, 0:1] * si2["ss"] + wi_loc[:, 1:2] * si2["ts"] + wi_loc[:, 2:3] * si2["ns"]
        cos_z = torch.clamp(wi_loc[:, 2], min=1e-6)
        pdf_dir = cos_z * (1.0 / math.pi)
        f_sw = sw_factor(eta_m, cos_z) * eta_m * eta_m
        beta2 = beta2 * (f_sw * math.pi)[:, None]  # f cos / (cos / pi)
        a3 = act[:, None]
        nw["o"] = torch.where(a3, _offset_ray(si2["p"], si2["ng"], wi2, si2["p_err"]), nw["o"])
        nw["d"] = torch.where(a3, wi2, nw["d"])
        nw["beta"] = torch.where(a3, beta2, nw["beta"])
        nw["alive"] = torch.where(mask, act & (beta2 > 0).any(-1), nw["alive"])
        nw["spec"] = torch.where(mask, False, nw["spec"])
        nw["pdf"] = torch.where(act, pdf_dir, nw["pdf"])
        nw["prev_p"] = torch.where(a3, si2["p"], nw["prev_p"])
        return L

    def bounce(b, st):
        si, in_scatter, med_vertex = pickup(st, b)
        o_, d_, beta, alive = st["o"], st["d"], st["beta"], st["alive"]
        medium, bounces = st["medium"], st["bounces"]
        L = st["L"]
        dim_base = 2 + b * DPB
        can_scatter = alive & (bounces < max_depth - 1)
        in_scatter = in_scatter & can_scatter
        on_surface = can_scatter & si["valid"] & ~in_scatter
        if pass_null:
            # interface (null) boundary: pass through, swap the medium, no depth
            is_null = on_surface & (sa.mat_kind[si["mat"]] == 0) & (si["light"] < 0)
            on_surface = on_surface & ~is_null
        else:
            is_null = torch.zeros(R, dtype=torch.bool, device=dev)
        if textured:
            lobes = make_bsdf(sa, static, si["mat"], table, si["uv"], si["p"], si.get("duvdx"), si.get("duvdy"),
                              atlases)
        else:
            lobes = make_bsdf(sa, static, si["mat"], table, si["uv"], si["p"])
        alive_sh = on_surface & (num_lobes(lobes) > 0)
        alive_nee = alive_sh | in_scatter

        # --- NEE (uniform_sample_onelight / estimate_direct) ---
        if nee_on and static.n_lights > 0:
            if ikind == "directlighting" and icfg.get("strategy", "all") == "all":
                # UniformSampleAll: each light's nsamples array samples, averaged
                for li in range(static.n_lights):
                    ns = _round_ns(kind_s, max(int(static.light_n_samples[li]), 1))
                    acc = torch.zeros((R, 3), **f32)
                    for j in range(ns):
                        acc = acc + nee_at(si, lobes, alive_sh, medium, b, dim_base, light_index=li,
                                           dim_salt=1 + li * 1024 + j, array_j=j, array_n=ns)
                    L = L + beta * acc / ns
            else:
                L = L + beta * nee_at(si, lobes, alive_nee, medium, b, dim_base, medium_vertex=med_vertex)
        elif ikind == "whitted" and static.n_lights > 0:
            L = L + beta * nee_at(si, lobes, alive_sh, medium, b, dim_base)

        # --- BSDF continuation (directlighting, whitted: specular lobes only) ---
        u_lobe = s1(dim_base + 2)
        u1, u2 = s2(dim_base + 3)
        wo_l = _to_local(si, si["wo"])
        if ikind in ("directlighting", "whitted"):
            kinds = lobes["kind"]
            lobes_c = dict(lobes, kind=torch.where(_is_specular(kinds), kinds, 0),
                           possible=tuple(p & SPECULAR_KINDS for p in lobes["possible"]))
        else:
            lobes_c = lobes
        bs = bsdf_sample(lobes_c, wo_l, u_lobe, u1, u2)
        wi_w = _to_world(si, bs["wi"])
        thru = bs["f"] * (dot(wi_w, si["ns"]).abs() / torch.clamp(bs["pdf"], min=1e-30))[:, None]
        surf_cont = alive_sh & bs["valid"] & (thru > 0).any(-1)
        sc = surf_cont[:, None]
        nw = {
            "alive": surf_cont,
            "beta": torch.where(sc, beta * thru, beta),
            "d": torch.where(sc, wi_w, d_),
            "o": torch.where(sc, _offset_ray(si["p"], si["ng"], wi_w, si["p_err"]), o_),
            "spec": bs["specular"] & surf_cont,
            "pdf": torch.where(surf_cont, torch.clamp(bs["pdf"], min=1e-30), st["prev_pdf"]),
            "prev_p": torch.where(sc, si["p"], st["prev_p"]),
        }
        eta_scale = torch.where(surf_cont, st["eta_scale"] * bs["eta_scale"], st["eta_scale"])
        # scattering inside a subsurface walk medium costs no depth
        scatter_counts = in_scatter
        for mid in static.sss_media:
            scatter_counts = scatter_counts & (medium != mid)
        new_bounces = bounces + (surf_cont | scatter_counts).to(torch.int64)

        # --- the tabulated BSSRDF after a specular transmission into a
        # subsurface material (path.rs:177-204) ---
        if static.has_tab_sss and ikind in ("path", "volpath"):
            mk = sa.mat_kind[torch.clamp(si["mat"], min=0)]
            is_sss = (mk == MAT_SUBSURFACE) | (mk == MAT_KDSUBSURFACE)
            crossed = dot(wi_w, si["ng"]) * dot(si["wo"], si["ng"]) < 0
            L = sss_event(surf_cont & is_sss & bs["specular"] & crossed, si, L, nw, medium, b, dim_base)

        # --- the medium transition through a medium interface ---
        if handle_media or pass_null:
            pm = sa.prim_medium[torch.clamp(si["prim"], min=0)].to(torch.int64)
            transition = pm[:, 0] != pm[:, 1]
            crossed_med = torch.where(dot(nw["d"], si["ng"]) < 0, pm[:, 0], pm[:, 1])
            medium = torch.where((surf_cont | is_null) & transition, crossed_med, medium)

        # --- phase-function continuation at a medium vertex (f / pdf = 1) ---
        if handle_media:
            u1m, u2m = s2(dim_base + 6)
            wi_ph, ph_pdf = media.hg_sample(med_vertex["wo"], med_vertex["g"], u1m, u2m)
            ins = in_scatter[:, None]
            nw["alive"] = nw["alive"] | in_scatter
            nw["d"] = torch.where(ins, wi_ph, nw["d"])
            nw["o"] = torch.where(ins, med_vertex["p"], nw["o"])
            nw["spec"] = torch.where(in_scatter, False, nw["spec"])
            nw["pdf"] = torch.where(in_scatter, torch.clamp(ph_pdf, min=1e-30), nw["pdf"])
            nw["prev_p"] = torch.where(ins, med_vertex["p"], nw["prev_p"])

        # --- interface pass-through: the MIS state kept, no depth ---
        if pass_null:
            nl = is_null[:, None]
            nw["alive"] = nw["alive"] | is_null
            nw["d"] = torch.where(nl, d_, nw["d"])
            nw["o"] = torch.where(nl, _offset_ray(si["p"], si["ng"], d_, si["p_err"]), nw["o"])
            nw["spec"] = torch.where(is_null, st["prev_spec"], nw["spec"])
            nw["pdf"] = torch.where(is_null, st["prev_pdf"], nw["pdf"])
            nw["prev_p"] = torch.where(nl, st["prev_p"], nw["prev_p"])

        # --- russian roulette (path.rs:206-214), never at a null crossing ---
        if ikind in ("path", "volpath"):
            max_c = (nw["beta"] * eta_scale[:, None]).max(-1).values
            q = torch.clamp(1.0 - max_c, min=0.05)
            do_rr = (new_bounces > 3) & (max_c < float(icfg.get("rr_threshold", 1.0))) & ~is_null
            killed = do_rr & (s1(dim_base + 4) < q)
            nw["alive"] = nw["alive"] & ~killed
            nw["beta"] = torch.where((do_rr & ~killed)[:, None], nw["beta"] / torch.clamp(1.0 - q, min=1e-6)[:, None],
                                     nw["beta"])
        if differentials:
            # the differentials ride camera rays and null crossings only
            keep = is_null[:, None]
            st["dd_x"] = torch.where(keep, st["dd_x"], 0.0)
            st["dd_y"] = torch.where(keep, st["dd_y"], 0.0)
        st.update(o=nw["o"], d=nw["d"], L=L, beta=nw["beta"], alive=nw["alive"], prev_spec=nw["spec"],
                  prev_pdf=nw["pdf"], prev_p=nw["prev_p"], eta_scale=eta_scale, medium=medium, bounces=new_bounces)

    st = {
        "o": o, "d": d, "L": torch.zeros((R, 3), **f32), "beta": torch.ones((R, 3), **f32),
        "alive": torch.ones(R, dtype=torch.bool, device=dev),
        "prev_spec": torch.ones(R, dtype=torch.bool, device=dev),  # bounce 0's emission counts fully
        "prev_pdf": torch.ones(R, **f32), "prev_p": o, "eta_scale": torch.ones(R, **f32),
        "nv": torch.zeros(R, **f32),
        "medium": torch.full((R,), static.camera_medium, dtype=torch.int64, device=dev),
        "bounces": torch.zeros(R, dtype=torch.int64, device=dev),
    }
    if differentials:
        st["dd_x"], st["dd_y"] = diff_dirs
    n_iters = wave_iterations(static, ikind, max_depth)
    for b in range(n_iters):
        bounce(b, st)
    pickup(st, n_iters)
    return st["L"], st["nv"]


K_PROBE = 4  # the BSSRDF's probe queries per exit sample (reference _sss_event)


def _wave_media(static, ikind: str):
    """(handle_media, pass_null): the wave samples media (volpath with
    media, or path and volpath with subsurface walk media), and interface
    (null) crossings can occur (such media or an interface material)."""
    handle_media = ((ikind == "volpath" and static.n_media > 0)
                    or (ikind in ("path", "volpath") and static.has_sss_media))
    return handle_media, static.has_null_material or handle_media


def wave_iterations(static, ikind: str, max_depth: int) -> int:
    """The wave's bounces before its last pickup: max_depth - 1, plus 4
    where interface crossings can occur (24 with subsurface walk media,
    whose interior scattering costs no depth)."""
    if ikind == "ao":
        return 0
    extra_iters = (24 if static.has_sss_media else 4) if _wave_media(static, ikind)[1] else 0
    return max_depth - 1 + extra_iters


def probe_chain(sa, static, p0, vz, t_rem, mat, joint=False):
    """The BSSRDF's K_PROBE sequential probe queries from p0 along vz
    (reference _sss_event :442-455): each continues past the last hit
    (RAY_EPS beyond it) with what is left of its segment; a lane whose
    probe misses stops (t_max < 0). Returns [(same material as `mat`
    (R,), hit, origin (R, 3))] per query."""
    base = p0
    recs = []
    for _k in range(K_PROBE):
        hk = intersect(sa, static, base, vz, t_rem, sort_rays=True, joint=joint)
        hv = hk["prim"] >= 0
        recs.append((hv & (sa.prim_mat[torch.clamp(hk["prim"], min=0)] == mat), hk, base))
        step = torch.where(hv, hk["t"] + RAY_EPS, 0.0)
        base = base + vz * step[:, None]
        t_rem = torch.where(hv, t_rem - step, -1.0)
    return recs


def _trace_ao(sa, static, icfg, scfg, seed, o, d, pixel, sidx, joint=False, time=None):
    """Ambient occlusion (ao.rs; reference _trace_ao :942-977): at each
    camera hit, n_samples shadow rays over the hemisphere of the normal
    faced toward the camera, cosine-weighted or uniform; the mean of
    cos / (pi pdf) over the unoccluded ones, as a gray radiance."""
    R = o.shape[0]
    dev = o.device
    hit = intersect(sa, static, o, d, torch.full((R,), torch.inf, device=dev), joint=joint, time=time)
    si = surface_interaction(sa, hit, o, d, static.quadric_kinds, time)
    valid = si["valid"]
    n_samples = int(icfg.get("n_samples", 64))
    cos_sample = bool(icfg.get("cos_sample", True))
    ns = torch.where((dot(si["ns"], si["wo"]) < 0)[:, None], -si["ns"], si["ns"])
    ng = torch.where((dot(si["ng"], si["wo"]) < 0)[:, None], -si["ng"], si["ng"])
    acc = torch.zeros(R, dtype=torch.float32, device=dev)
    for s in range(n_samples):
        u1, u2 = sample_2d(scfg["kind"], seed, pixel, sidx, 2 + s, scfg["spp"], scfg.get("strata"))
        if cos_sample:
            w_l = cosine_sample_hemisphere(u1, u2)
            pdf = torch.clamp(w_l[..., 2], min=1e-9) / math.pi
        else:
            z = u1
            r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
            phi = 2 * math.pi * u2
            w_l = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
            pdf = torch.full((R,), 1.0 / (2 * math.pi), dtype=torch.float32, device=dev)
        w = w_l[..., 0:1] * si["ss"] + w_l[..., 1:2] * si["ts"] + w_l[..., 2:3] * ns
        o_sh = _offset_ray(si["p"], ng, w, si["p_err"])
        occ = intersect_p(sa, static, o_sh, w, torch.full((R,), torch.inf, device=dev), joint=joint, time=time)
        cos_w = dot(w, ns)
        acc = acc + torch.where(valid & ~occ & (cos_w > 0), cos_w / (math.pi * pdf), 0.0)
    return (acc / n_samples)[:, None].expand(R, 3).contiguous()
