"""Persistent wavefront path tracer.

The port's counterpart of ``pbrt_tpu/device/integrator.py
trace_persistent`` for the path and directlighting integrators
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

import torch

from . import rng
from .bsdf import SPECULAR_KINDS, _is_specular, bsdf_f, bsdf_pdf, bsdf_sample, num_lobes
from .intersect import intersect, intersect_p
from .lightdistrib import spatial_pmf_of, spatial_select
from .lights import area_light_emission, compute_power, env_le, env_pdf_li, pdf_li_area_hit, sample_li
from .materials import lobe_table, make_bsdf
from .sampler import sample_1d, sample_2d
from .shading import apply_bump, dot, surface_interaction
from .texture import has_imagemaps

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
    offset_ray_origin :455-475)."""
    dist = (ng.abs() * p_err).sum(-1, keepdim=True)
    offset = dist * ng
    offset = torch.where((dot(w, ng) < 0)[:, None], -offset, offset)
    return _next_float_away(p + offset, offset)


def _to_local(si, w):
    return torch.stack([dot(w, si["ss"]), dot(w, si["ts"]), dot(w, si["ns"])], dim=-1)


def _to_world(si, w):
    return w[..., 0:1] * si["ss"] + w[..., 1:2] * si["ts"] + w[..., 2:3] * si["ns"]


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


def _light_selectors(sa, static, icfg: dict):
    """Light-selection closures (lightdistrib.rs): "uniform",
    power-proportional, or the voxel-grid "spatial" distribution, whose
    table render.make_persistent_fn builds into icfg["spatial_distribution"].
    Returns (_select_light(u, p_at) -> (lid, pmf), _sel_pmf_of(lid, p_at));
    p_at is the shading point that selects (for the MIS weight at an
    emission hit, the previous path vertex)."""
    strategy = str(icfg.get("light_strategy", "uniform"))
    n = static.n_lights
    sel_pdf = 1.0 / max(n, 1)
    spatial = strategy == "spatial" and n > 1
    use_power = strategy == "power" and n > 1
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
