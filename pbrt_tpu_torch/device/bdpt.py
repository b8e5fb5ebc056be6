"""Bidirectional path tracing (BDPT).

The port's counterpart of ``pbrt_tpu/device/bdpt.py`` (src/integrators/
bdpt.rs). Every lane of a wave is one pixel sample: its camera subpath and
its light subpath are two batched random walks that fill fixed-width
vertex arrays (R, NV, ...), and every (s, t) connection strategy
(bdpt.rs :1250) runs as a masked batched step over the whole wave. The
t = 1 strategies (a light vertex seen by the camera) splat into the film
at the pixel they project to, by a float64 ``index_add_`` on the device
(the reference sums them with segment_sum, the renderer with AtomicFloat
splats, bdpt.rs :798-803).

The MIS weight is bdpt.rs mis_weight's remapped pdf-ratio walk with the
four junction pdfs of each strategy re-derived on the fly
(``_mis_weight``'s overrides, the reference's ScopedAssignment edits); the
light side's i = 0 term alone is gated by the delta-light flag
(bdpt.rs:1225-1228). The light subpath scatters in importance transport
(``bsdf_sample(..., "importance")`` with ``correct_shading_normal``), the
camera subpath in radiance transport.

Sample streams: BDPT draws from the stateless (0,2)-sequence hash whatever
the scene's sampler (``prov_1d`` / ``prov_2d``; MLT passes explicit
primary-sample arrays through the same ``prov`` interface): the camera
stream from the render's seed, the light stream from seed ^ 0xABCD137;
the camera walk from dimension 4, the light walk from dim0 + 5, strategy
(s, t)'s light sample at nee_dim 100 + 3 (s + t).

Where the port differs from the reference: a connection evaluates the
vertex's BSDF with its lobe set's Beckmann, Schlick and Fourier tables
(the reference's ``_vertex_f`` drops them, so a Beckmann or Fourier
material connects as GGX or fails; ROADMAP C). The reference's debug films
(visualizestrategies, visualizeweights) are written, as its are, to the
working directory (a known reference fault, kept; ROADMAP C).
"""
from __future__ import annotations

import logging
import math
import time

import numpy as np
import torch

from ..scene.arrays import LIGHT_AREA, LIGHT_DISTANT, LIGHT_GONIO, LIGHT_POINT, LIGHT_PROJECTION, LIGHT_SPOT
from .bsdf import bsdf_f, bsdf_pdf, bsdf_sample, correct_shading_normal, num_lobes
from .camera import camera_pdf_we, camera_sample_wi, generate_rays, make_camera
from .integrator import _offset_ray, _to_local, _to_world
from .intersect import intersect, intersect_p
from .lights import (_projection_cos_total, area_light_emission, area_light_pdf_dir, compute_power, sample_le,
                     sample_li)
from .materials import lobe_table, make_bsdf
from .sampler import sample_1d, sample_2d
from .shading import apply_bump, dot, surface_interaction

log = logging.getLogger(__name__)

VT_NONE = 0
VT_CAMERA = 1
VT_LIGHT = 2
VT_SURFACE = 3
# delta-position lights (scene.arrays._DELTA_LIGHTS): no s = 0 alternative
DELTA_LIGHTS = (LIGHT_POINT, LIGHT_SPOT, LIGHT_DISTANT, LIGHT_GONIO, LIGHT_PROJECTION)
LIGHT_SEED_XOR = 0xABCD137  # the light stream's seed, seed ^ this
NEE_DIM = 100  # strategy (s, t)'s light sample at NEE_DIM + 3 (s + t)


# ---------------------------------------------------------------------------
# sample providers
# ---------------------------------------------------------------------------


def prov_1d(prov, dim: int):
    """The 1D sample of dimension dim: ("hash", seed, pixel, sample) draws
    the (0,2)-sequence hash, ("array", u (R, D)) reads column dim (the last
    one past D)."""
    if prov[0] == "hash":
        _, seed, pid, sidx = prov
        return sample_1d("zerotwosequence", seed, pid, sidx, dim, 1)
    u = prov[1]
    return u[:, min(dim, u.shape[1] - 1)]


def prov_2d(prov, dim: int):
    """The 2D sample of dimension dim (columns 2 dim, 2 dim + 1 of an array)."""
    if prov[0] == "hash":
        _, seed, pid, sidx = prov
        return sample_2d("zerotwosequence", seed, pid, sidx, dim, 1)
    u = prov[1]
    return u[:, min(2 * dim, u.shape[1] - 1)], u[:, min(2 * dim + 1, u.shape[1] - 1)]


# ---------------------------------------------------------------------------
# the vertex arrays
# ---------------------------------------------------------------------------


def _empty_vertices(R, NV, S, dev):
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "type": torch.zeros((R, NV), dtype=torch.int32, device=dev),
        "p": torch.zeros((R, NV, 3), **f32),
        "ng": torch.zeros((R, NV, 3), **f32),
        "ns": torch.zeros((R, NV, 3), **f32),
        "ss": torch.zeros((R, NV, 3), **f32),
        "ts": torch.zeros((R, NV, 3), **f32),
        "wo": torch.zeros((R, NV, 3), **f32),  # toward the previous vertex
        "beta": torch.zeros((R, NV, 3), **f32),
        "pdf_fwd": torch.zeros((R, NV), **f32),
        "pdf_rev": torch.zeros((R, NV), **f32),
        "delta": torch.zeros((R, NV), dtype=torch.bool, device=dev),
        "light": torch.full((R, NV), -1, dtype=torch.int64, device=dev),
        "kind": torch.zeros((R, NV, S), dtype=torch.int64, device=dev),
        "data": torch.zeros((R, NV, S, 14), **f32),
    }


def _gather(v, i):
    # is_delta_light is a per-path (R,) endpoint flag, not a vertex column
    return {k: a[:, i] for k, a in v.items() if k != "is_delta_light"}


def _convert_pdf(pdf_dir, p_from, p_to, ng_to):
    """A solid-angle pdf at p_from -> the area pdf at p_to (vertex.rs
    convert_density); no normal at p_to: no cosine."""
    w = p_to - p_from
    inv_d2 = 1.0 / torch.clamp(dot(w, w), min=1e-20)
    cos = dot(ng_to, w * torch.sqrt(inv_d2)[:, None]).abs()
    return pdf_dir * inv_d2 * torch.where((ng_to != 0).any(-1), cos, 1.0)


def _norm(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-30)


class _Ctx:
    """What the walks and connections share: the lobe table, the lobe set's
    metadata (possible kinds per slot, Beckmann, Schlick, Fourier tables),
    the texture atlases."""

    def __init__(self, sa, static):
        self.table = lobe_table(sa, static)
        self.atlases = None
        if self.table.get("textured") or static.has_bump:
            from .texture import prepare_atlases

            self.atlases = prepare_atlases(sa, static)
        atlases = self.atlases
        dev = sa.prim_mat.device
        probe = make_bsdf(sa, static, torch.zeros(1, dtype=torch.int64, device=dev), self.table,
                          uv=torch.zeros((1, 2), device=dev), p=torch.zeros((1, 3), device=dev), atlases=atlases)
        self.meta = {k: v for k, v in probe.items() if k not in ("kind", "data")}
        self.slots = probe["kind"].shape[1]

    def lobes(self, vtx):
        return dict(self.meta, kind=vtx["kind"], data=vtx["data"])


def _frame(vtx):
    return {"ss": vtx["ss"], "ts": vtx["ts"], "ns": vtx["ns"]}


def _vertex_f(ctx, vtx, w_to, mode: str = "radiance"):
    """The BSDF at a stored vertex toward w_to, times |cos| at its shading
    normal (vertex.rs f()); a light-subpath vertex evaluates in importance
    transport with the shading-normal correction (bdpt.rs:356-366)."""
    fr = _frame(vtx)
    refl = dot(w_to, vtx["ng"]) * dot(vtx["wo"], vtx["ng"]) > 0
    f = bsdf_f(ctx.lobes(vtx), _to_local(fr, vtx["wo"]), _to_local(fr, w_to), refl, mode)
    f = f * dot(w_to, vtx["ns"]).abs()[:, None]
    if mode == "importance":
        f = f * correct_shading_normal(vtx["ns"], vtx["ng"], vtx["wo"], w_to)[:, None]
    return f


def _vertex_pdf_dir(ctx, vtx, w_prev, w_next):
    """The BSDF's directional pdf at a vertex: w_next sampled given w_prev
    (vertex.rs pdf())."""
    fr = _frame(vtx)
    return bsdf_pdf(ctx.lobes(vtx), _to_local(fr, w_prev), _to_local(fr, w_next))


def _set(v, i, ok, **vals):
    """Write the vertex i of the lanes ok."""
    for k, val in vals.items():
        col = v[k][:, i]
        m = ok.view((-1,) + (1,) * (col.dim() - 1))
        v[k][:, i] = torch.where(m, val.to(col.dtype), col)


# ---------------------------------------------------------------------------
# subpath generation
# ---------------------------------------------------------------------------


def _random_walk(sa, static, ctx, prov, dim0, v, start, n_steps, o, d, beta, pdf_dir, alive, mode, stats=None):
    """Extend the subpaths by up to n_steps surface vertices, writing
    vertices start .. start + n_steps - 1 (bdpt.rs random_walk); each step
    draws its lobe and direction at dim0 + 3 i (1D) and + 1 (2D)."""
    R = o.shape[0]
    dev = o.device
    for i in range(n_steps):
        idx = start + i
        dim = dim0 + i * 3
        hit = intersect(sa, static, o, d, torch.full((R,), math.inf, device=dev), sort_rays=True)
        si = surface_interaction(sa, hit, o, d, static.quadric_kinds)
        if static.has_bump:
            si = apply_bump(sa, static, si, ctx.atlases)
        ok = alive & si["valid"]
        lobes = make_bsdf(sa, static, si["mat"], ctx.table, uv=si["uv"], p=si["p"], atlases=ctx.atlases)
        _set(v, idx, ok, type=torch.full((R,), VT_SURFACE, device=dev), p=si["p"], ng=si["ng"], ns=si["ns"],
             ss=si["ss"], ts=si["ts"], wo=si["wo"], beta=beta, pdf_fwd=_convert_pdf(pdf_dir, o, si["p"], si["ng"]),
             light=si["light"], kind=lobes["kind"], data=lobes["data"])
        if stats is not None:
            stats["vertices"] += ok.sum()
        if i == n_steps - 1:
            break
        u_lo = prov_1d(prov, dim)
        u1, u2 = prov_2d(prov, dim + 1)
        bs = bsdf_sample(lobes, _to_local(si, si["wo"]), u_lo, u1, u2, mode)
        wi_w = _to_world(si, bs["wi"])
        thru = bs["f"] * (dot(wi_w, si["ns"]).abs() / torch.clamp(bs["pdf"], min=1e-30))[:, None]
        if mode == "importance":
            # the adjoint shading-normal correction on every light-walk
            # scatter (bdpt.rs:1048)
            thru = thru * correct_shading_normal(si["ns"], si["ng"], si["wo"], wi_w)[:, None]
        cont = ok & bs["valid"] & (num_lobes(lobes) > 0) & (thru > 0).any(-1)
        # the reverse pdf at this vertex's predecessor (vertex.rs pdf fwd / rev)
        pdf_rev_dir = _vertex_pdf_dir(ctx, _gather(v, idx), wi_w, si["wo"])
        prev_ng = v["ng"][:, idx - 1] if idx > 0 else torch.zeros((R, 3), device=dev)
        pdf_rev_area = _convert_pdf(pdf_rev_dir, si["p"], o, prev_ng)
        if idx > 0:
            v["pdf_rev"][:, idx - 1] = torch.where(cont, pdf_rev_area, v["pdf_rev"][:, idx - 1])
        v["delta"][:, idx] = bs["specular"] & cont
        beta = torch.where(cont[:, None], beta * thru, beta)
        pdf_dir = torch.where(bs["specular"], 0.0, bs["pdf"])
        o = _offset_ray(si["p"], si["ng"], wi_w, si.get("p_err"))
        d = wi_w
        alive = cont
    return v


def generate_camera_subpath(sa, static, ctx, prov, cam, pxf, pyf, max_t, stats=None):
    """The camera vertex and the walk from it (bdpt.rs
    generate_camera_subpath :861). pxf, pyf: float raster positions (the
    caller jitters them, so that MLT's primary-sample map stays
    measure-preserving). Returns (vertices, n_cam (R,))."""
    R = pxf.shape[0]
    dev = pxf.device
    v = _empty_vertices(R, max_t, ctx.slots, dev)
    ul1, ul2 = prov_2d(prov, 1)
    o, d = generate_rays(cam, pxf, pyf, ul1, ul2)
    every = torch.ones(R, dtype=torch.bool, device=dev)
    _set(v, 0, every, type=torch.full((R,), VT_CAMERA, device=dev),
         p=cam["camera_to_world"][:3, 3].expand(R, 3), beta=torch.ones((R, 3), device=dev),
         pdf_fwd=torch.ones(R, device=dev))
    _pdf_pos, pdf_dir = camera_pdf_we(cam, d)
    v = _random_walk(sa, static, ctx, prov, 4, v, 1, max_t - 1, o, d, torch.ones((R, 3), device=dev), pdf_dir,
                     every, "radiance", stats)
    return v, (v["type"] != VT_NONE).sum(1)


def _light_emission_pdf_dir(sa, static, lid, n_l, d):
    """The emission-direction pdf of light lid along d (pdf_le's directional
    half), the one both the light walk's forward pdf and every MIS override
    that re-derives it read (the ratio walk is a partition of unity only
    with the same pdf on both sides): an area light's cosine, the spot and
    projection lights' uniform cone, 1 / 4 pi for the rest."""
    kindl = sa.light_kind[lid]
    pdf_dir = torch.full(lid.shape, 1.0 / (4.0 * math.pi), dtype=torch.float32, device=lid.device)
    if static.has_area_lights:
        pdf_dir = torch.where(kindl == LIGHT_AREA, area_light_pdf_dir(sa, lid, n_l, d), pdf_dir)
    if any(k in (LIGHT_SPOT, LIGHT_PROJECTION) for k in static.light_kinds):
        parl = sa.light_param[lid]
        pdf_dir = torch.where(kindl == LIGHT_SPOT,
                              1.0 / torch.clamp(2.0 * math.pi * (1.0 - parl[:, 9]), min=1e-9), pdf_dir)
        pdf_dir = torch.where(kindl == LIGHT_PROJECTION,
                              1.0 / torch.clamp(2.0 * math.pi * (1.0 - _projection_cos_total(parl)), min=1e-9),
                              pdf_dir)
    return pdf_dir


def generate_light_subpath(sa, static, ctx, prov, dim0, power_cdf, max_s, R, stats=None):
    """The light vertex (a light chosen by power, dimension dim0; its
    emitted ray from dim0 + 1 .. dim0 + 4) and the walk from it in
    importance transport (bdpt.rs generate_light_subpath :896). Returns
    (vertices, n_light (R,))."""
    dev = power_cdf.device
    v = _empty_vertices(R, max_s, ctx.slots, dev)
    if static.n_lights == 0:
        return v, torch.zeros(R, dtype=torch.int64, device=dev)
    u_l = prov_1d(prov, dim0)
    lid = torch.clamp(torch.searchsorted(power_cdf, u_l.contiguous(), right=True), 0, static.n_lights - 1)
    sel_pdf = power_cdf[lid] - torch.where(lid > 0, power_cdf[torch.clamp(lid - 1, min=0)], 0.0)
    em = sample_le(sa, static, lid, prov_1d(prov, dim0 + 1), prov_1d(prov, dim0 + 2), prov_1d(prov, dim0 + 3),
                   prov_1d(prov, dim0 + 4))
    beta = em["le_over_pdf"] / torch.clamp(sel_pdf, min=1e-12)[:, None]
    alive = (beta > 0).any(-1)
    kindl = sa.light_kind[lid]
    is_area = kindl == LIGHT_AREA
    n_l = torch.zeros((R, 3), device=dev)
    pdf_origin = sel_pdf  # a delta position's pdf is the choice's alone
    if static.has_area_lights:
        # the sampled point's true normal (the emission direction in its
        # place would make every endpoint conversion's cosine 1)
        n_l = torch.where(is_area[:, None], em["n"], n_l)
        area_l = sa.prim_area[torch.clamp(sa.light_prim[lid], min=0)]
        pdf_origin = torch.where(is_area, sel_pdf / torch.clamp(area_l, min=1e-12), sel_pdf)
    every = torch.ones(R, dtype=torch.bool, device=dev)
    _set(v, 0, every, type=torch.where(alive, VT_LIGHT, VT_NONE), p=em["o"], ng=n_l, ns=n_l,
         beta=torch.where(alive[:, None], beta, 0.0), pdf_fwd=pdf_origin, light=lid)
    # a delta-position light excludes the s = 0 alternative: a per-path
    # flag, read only for the MIS walk's i = 0 term (bdpt.rs:1225-1228), so
    # that the i = 1 term (the s = 1 alternative) stays counted
    is_delta = torch.zeros(R, dtype=torch.bool, device=dev)
    for k in DELTA_LIGHTS:
        is_delta = is_delta | (kindl == k)
    v["is_delta_light"] = is_delta
    pdf_dir = _light_emission_pdf_dir(sa, static, lid, n_l, em["d"])
    v = _random_walk(sa, static, ctx, prov, dim0 + 5, v, 1, max_s - 1, em["o"], em["d"], beta, pdf_dir, alive,
                     "importance", stats)
    return v, (v["type"] != VT_NONE).sum(1)


# ---------------------------------------------------------------------------
# the MIS weight (bdpt.rs mis_weight :1100-1240)
# ---------------------------------------------------------------------------


def _remap0(x):
    return torch.where(x > 0, x, 1.0)


def _mis_weight(cam_v, light_v, s: int, t: int, overrides):
    """The balance heuristic's weight of strategy (s, t). overrides:
    {(side, i): value} in place of pdf_rev at the junction vertices."""
    R = cam_v["type"].shape[0]
    dev = cam_v["type"].device
    if s + t == 2:
        return torch.ones(R, device=dev)
    sum_ri = torch.zeros(R, device=dev)
    zeros = torch.zeros(R, dtype=torch.bool, device=dev)

    def rev_of(side_v, i, side):
        ov = overrides.get((side, i))
        return side_v["pdf_rev"][:, i] if ov is None else ov

    # the camera side: strategies with more light vertices
    ri = torch.ones(R, device=dev)
    for i in range(t - 1, 0, -1):
        ri = ri * _remap0(rev_of(cam_v, i, "cam")) / _remap0(cam_v["pdf_fwd"][:, i])
        d_prev = cam_v["delta"][:, i - 1] if i - 1 > 0 else zeros
        sum_ri = sum_ri + torch.where(~cam_v["delta"][:, i] & ~d_prev, ri, 0.0)
    # the light side: the i = 0 term is gated by the delta-light flag, the
    # others by the previous vertex's delta flag
    is_delta_light = light_v.get("is_delta_light")
    if is_delta_light is None:
        is_delta_light = zeros
    ri = torch.ones(R, device=dev)
    for i in range(s - 1, -1, -1):
        ri = ri * _remap0(rev_of(light_v, i, "light")) / _remap0(light_v["pdf_fwd"][:, i])
        d_prev = is_delta_light if i == 0 else light_v["delta"][:, i - 1]
        sum_ri = sum_ri + torch.where(~light_v["delta"][:, i] & ~d_prev, ri, 0.0)
    return 1.0 / (1.0 + sum_ri)


# ---------------------------------------------------------------------------
# the connection strategies (bdpt.rs connect_bdpt :1250)
# ---------------------------------------------------------------------------


def connect_bdpt(sa, static, ctx, cam, prov, cam_v, n_cam, light_v, n_light, s: int, t: int, nee_dim: int):
    """Strategy (s, t), t >= 2, on every lane: (L (R, 3) MIS-weighted, its
    weight (R,) or None where the strategy cannot contribute)."""
    R = cam_v["type"].shape[0]
    dev = cam_v["type"].device
    sel_pdf_uniform = 1.0 / max(static.n_lights, 1)
    pt = _gather(cam_v, t - 1)
    pt_ok = (n_cam >= t) & (pt["type"] != VT_NONE)

    if s == 0:
        # the camera path alone: pt must lie on an area light (bdpt.rs :1270)
        if not static.has_area_lights:
            return torch.zeros((R, 3), device=dev), None
        lid = pt["light"]
        emitting = pt_ok & (lid >= 0)
        L = pt["beta"] * area_light_emission(sa, lid, pt["ng"], pt["wo"])
        # pt.rev <- the light's origin pdf; pt-1.rev <- its emission pdf there
        area = sa.prim_area[torch.clamp(sa.light_prim[torch.clamp(lid, min=0)], min=0)]
        pdf_origin = (1.0 / torch.clamp(area, min=1e-12)) * sel_pdf_uniform
        prev = _gather(cam_v, t - 2)
        pdf_dir = area_light_pdf_dir(sa, lid, pt["ng"], _norm(prev["p"] - pt["p"]))
        pdf_at_prev = _convert_pdf(pdf_dir, pt["p"], prev["p"], prev["ng"])
        w = _mis_weight(cam_v, light_v, s, t, {("cam", t - 1): pdf_origin, ("cam", t - 2): pdf_at_prev})
        return torch.where((emitting & (L > 0).any(-1))[:, None], L * w[:, None], 0.0), w

    if s == 1:
        # a fresh light sample connected to pt (bdpt.rs :1320)
        u_sel = prov_1d(prov, nee_dim)
        ua, ub = prov_2d(prov, nee_dim + 1)
        lid = torch.clamp((u_sel * static.n_lights).to(torch.int64), max=static.n_lights - 1)
        ls = sample_li(sa, static, lid, pt["p"], ua, ub)
        p_l = ls["pdf"] * sel_pdf_uniform
        L = pt["beta"] * _vertex_f(ctx, pt, ls["wi"]) * ls["li"] / torch.clamp(p_l, min=1e-20)[:, None]
        ok = pt_ok & (p_l > 0) & (L > 0).any(-1) & ~pt["delta"]
        occ = intersect_p(sa, static, _offset_ray(pt["p"], pt["ng"], ls["wi"], None), ls["wi"], ls["dist"] * 0.998,
                          sort_rays=True)
        ok = ok & ~occ
        # the sampled vertex stands in for light_v[0] in the MIS walk
        p_light = pt["p"] + ls["wi"] * ls["dist"][:, None]
        n_light = ls["n"]
        # pt.rev <- the light's emission pdf converted to area at pt: the
        # per-kind pdf the light walk used as its forward pdf
        pdf_dir_l = _light_emission_pdf_dir(sa, static, lid, n_light, -ls["wi"])
        pdf_rev_pt = _convert_pdf(pdf_dir_l, p_light, pt["p"], pt["ng"])
        prev = _gather(cam_v, t - 2)
        w_prev = _norm(prev["p"] - pt["p"])
        # pt-1.rev <- pt's bsdf pdf toward prev, given the light's direction
        pdf_rev_prev = _convert_pdf(_vertex_pdf_dir(ctx, pt, ls["wi"], w_prev), pt["p"], prev["p"], prev["ng"])
        # the light vertex: fwd its origin pdf; rev pt's bsdf pdf toward it
        pdf_origin = torch.where(ls["delta"], sel_pdf_uniform, sel_pdf_uniform / torch.clamp(ls["area"], min=1e-12))
        pdf_rev_light = _convert_pdf(_vertex_pdf_dir(ctx, pt, w_prev, ls["wi"]), pt["p"], p_light, n_light)
        lv = dict(light_v)
        for k in ("pdf_fwd", "delta", "type"):
            lv[k] = light_v[k].clone()
        lv["pdf_fwd"][:, 0] = torch.clamp(pdf_origin, min=1e-20)
        lv["delta"][:, 0] = False
        lv["type"][:, 0] = VT_LIGHT
        lv["is_delta_light"] = ls["delta"]
        w = _mis_weight(cam_v, lv, s, t, {("cam", t - 1): pdf_rev_pt, ("cam", t - 2): pdf_rev_prev,
                                          ("light", 0): pdf_rev_light})
        return torch.where(ok[:, None], L * w[:, None], 0.0), w

    # s >= 2, t >= 2 (bdpt.rs :1380)
    qs = _gather(light_v, s - 1)
    qs_ok = (n_light >= s) & (qs["type"] == VT_SURFACE)
    both = pt_ok & qs_ok & ~pt["delta"] & ~qs["delta"]
    w_c = qs["p"] - pt["p"]
    d2 = torch.clamp(dot(w_c, w_c), min=1e-12)
    wdir = w_c / torch.sqrt(d2)[:, None]
    # the cosines are in _vertex_f (|cos ns|)
    L = pt["beta"] * _vertex_f(ctx, pt, wdir) * _vertex_f(ctx, qs, -wdir, "importance") * qs["beta"] * (1.0 / d2)[:, None]
    ok = both & (L > 0).any(-1)
    # the occlusion test: both ends offset off their surfaces, pbrt's
    # relative ShadowEpsilon (1e-4) shaved off the far end
    o_sh = _offset_ray(pt["p"], pt["ng"], wdir, None)
    dest = _offset_ray(qs["p"], qs["ng"], -wdir, None)
    t_sh = torch.clamp(dot(dest - o_sh, wdir), min=0.0)
    ok = ok & ~intersect_p(sa, static, o_sh, wdir, t_sh * (1.0 - 1e-4), sort_rays=True)
    prev_c = _gather(cam_v, t - 2)
    prev_l = _gather(light_v, s - 2)
    to_prev_l = _norm(prev_l["p"] - qs["p"])
    to_prev_c = _norm(prev_c["p"] - pt["p"])
    # the junction overrides (vertex.rs pdf calls in mis_weight):
    # pt.rev <- qs.pdf(qs_prev -> pt); pt_prev.rev <- pt.pdf(qs -> pt_prev);
    # qs.rev <- pt.pdf(pt_prev -> qs); qs_prev.rev <- qs.pdf(pt -> qs_prev)
    ov_pt = _convert_pdf(_vertex_pdf_dir(ctx, qs, to_prev_l, -wdir), qs["p"], pt["p"], pt["ng"])
    ov_ptm = _convert_pdf(_vertex_pdf_dir(ctx, pt, wdir, to_prev_c), pt["p"], prev_c["p"], prev_c["ng"])
    ov_qs = _convert_pdf(_vertex_pdf_dir(ctx, pt, to_prev_c, wdir), pt["p"], qs["p"], qs["ng"])
    ov_qsm = _convert_pdf(_vertex_pdf_dir(ctx, qs, -wdir, to_prev_l), qs["p"], prev_l["p"], prev_l["ng"])
    w = _mis_weight(cam_v, light_v, s, t, {("cam", t - 1): ov_pt, ("cam", t - 2): ov_ptm,
                                          ("light", s - 1): ov_qs, ("light", s - 2): ov_qsm})
    return torch.where(ok[:, None], L * w[:, None], 0.0), w


def connect_t1(sa, static, ctx, cam, cam_v, light_v, n_light, s: int, W: int, H: int):
    """t = 1: light vertex s - 1 connected to the camera, a splat at the
    pixel it projects to: {pixel (R,) (W H where none), value (R, 3), w}
    (bdpt.rs :798-803)."""
    R = light_v["type"].shape[0]
    qs = _gather(light_v, s - 1)
    ok = (n_light >= s) & (qs["type"] == VT_SURFACE) & ~qs["delta"]
    cw = camera_sample_wi(cam, qs["p"])
    L = qs["beta"] * _vertex_f(ctx, qs, cw["wi"], "importance") * (cw["we"] / torch.clamp(cw["pdf"], min=1e-20))[:, None]
    ok = ok & cw["valid"] & (L > 0).any(-1)
    # the camera is no geometry: only the origin is offset; pbrt's
    # ShadowEpsilon shaved off
    occ = intersect_p(sa, static, _offset_ray(qs["p"], qs["ng"], cw["wi"], None), cw["wi"],
                      cw["dist"] * (1.0 - 1e-4), sort_rays=True)
    ok = ok & ~occ
    # qs.rev <- the camera's pdf toward qs; qs-1.rev <- qs's pdf toward it
    _pp, pdf_dir_cam = camera_pdf_we(cam, -cw["wi"])
    cam_p = cam["camera_to_world"][:3, 3].expand(R, 3)
    overrides = {("light", s - 1): _convert_pdf(pdf_dir_cam, cam_p, qs["p"], qs["ng"])}
    if s >= 2:
        prev_l = _gather(light_v, s - 2)
        pd = _vertex_pdf_dir(ctx, qs, cw["wi"], _norm(prev_l["p"] - qs["p"]))
        overrides[("light", s - 2)] = _convert_pdf(pd, qs["p"], prev_l["p"], prev_l["ng"])
    w = _mis_weight(cam_v, light_v, s, 1, overrides)
    val = torch.where(ok[:, None], L * w[:, None], 0.0)
    px = torch.clamp(cw["px"].to(torch.int64), 0, W - 1)
    py = torch.clamp(cw["py"].to(torch.int64), 0, H - 1)
    return {"pixel": torch.where(ok, py * W + px, W * H), "value": val, "w": w}


# ---------------------------------------------------------------------------
# one sample of every lane
# ---------------------------------------------------------------------------


def strategies(max_depth: int):
    """The (s, t) strategies a wave runs, in the reference's order: t from 1
    to max_depth + 2, s from 0 to max_depth + 1, depth s + t - 2 at most
    max_depth; t = 1 only with s >= 2 (s = 1, t = 1 is never run)."""
    return [(s, t) for t in range(1, max_depth + 3) for s in range(0, max_depth + 2)
            if 0 <= s + t - 2 <= max_depth and not (t == 1 and s < 2)]


def bdpt_wave(sa, static, ctx, cam, power_cdf, seed: int, px, py, pids, sample_idx, max_depth: int, W: int, H: int,
              collect_debug: bool = False, stats=None):
    """One BDPT sample per lane, every strategy. Returns (L (R, 3), splat
    pixels (N,), splat values (N, 3)[, dbg]): dbg (collect_debug) maps (s, t)
    to ("film", weighted c (R, 3), weight (R,)) for t >= 2 and ("splat",
    pixel, value, weight) for t = 1 (the reference's debug films,
    bdpt.rs:686-709). stats: {"vertices"} accumulates the surface vertices
    of both subpaths."""
    R = px.shape[0]
    sidx = torch.as_tensor(sample_idx, dtype=torch.int64, device=px.device).expand(R)
    prov_c = ("hash", seed, pids, sidx)
    prov_l = ("hash", (int(seed) ^ LIGHT_SEED_XOR) & 0xFFFFFFFF, pids, sidx)
    max_t = max_depth + 2
    max_s = max_depth + 1
    uj1, uj2 = prov_2d(prov_c, 0)
    cam_v, n_cam = generate_camera_subpath(sa, static, ctx, prov_c, cam, px.to(torch.float32) + uj1,
                                           py.to(torch.float32) + uj2, max_t, stats)
    light_v, n_light = generate_light_subpath(sa, static, ctx, prov_l, 0, power_cdf, max_s, R, stats)
    L = torch.zeros((R, 3), device=px.device)
    splat_px, splat_val, dbg = [], [], {}
    for s, t in strategies(max_depth):
        if t == 1:
            sp = connect_t1(sa, static, ctx, cam, cam_v, light_v, n_light, s, W, H)
            splat_px.append(sp["pixel"])
            splat_val.append(sp["value"])
            if collect_debug:
                dbg[(s, t)] = ("splat", sp["pixel"], sp["value"], sp["w"])
            continue
        c, w = connect_bdpt(sa, static, ctx, cam, prov_c, cam_v, n_cam, light_v, n_light, s, t,
                            NEE_DIM + 3 * (s + t))
        L = L + c
        if collect_debug:
            dbg[(s, t)] = ("film", c, w)
    if splat_px:
        spx, sval = torch.cat(splat_px), torch.cat(splat_val)
    else:
        spx = torch.zeros(0, dtype=torch.int64, device=px.device)
        sval = torch.zeros((0, 3), device=px.device)
    if collect_debug:
        return L, spx, sval, dbg
    return L, spx, sval


def _splat(film, pixel, value):
    """Add value (N, 3) at film rows pixel (N,) into the float64 film (its
    last row takes the splats that land nowhere)."""
    film.index_add_(0, pixel, value.to(torch.float64))


def render_bdpt(cs, seed: int = 0, spp: int | None = None, progress=None):
    """The BDPT host loop: spp waves over the camera pixel bounds (the crop
    window and the integrator's "pixelbounds", bdpt.rs:1371), each lane's
    L into the float64 film on the device at its pixel and every t = 1
    splat wherever it lands on the full film. Lights are chosen by power
    (Light::power), the lobe kinds possible from a probe of make_bsdf.
    Returns the (H, W, 3) float32 image; records ``render_bdpt.last_timing``
    {"n_vertices", "seconds"}. The debug films of visualizestrategies and
    visualizeweights go to the working directory, as the reference's do."""
    from ..render import film_pixel_bounds

    desc = cs.description
    sa = cs.arrays
    static = cs.static
    dev = sa.device
    cam = make_camera(desc.camera, desc.film, dev)
    W, H = desc.film.x_resolution, desc.film.y_resolution
    R = W * H
    spp = int(spp if spp is not None else desc.sampler.pixel_samples)
    max_depth = max(int(desc.integrator.max_depth), 1)
    x0, x1, y0, y1 = film_pixel_bounds(desc)
    ys, xs = np.mgrid[y0:y1, x0:x1]
    px = torch.as_tensor(xs.ravel().astype(np.int64), device=dev)
    py = torch.as_tensor(ys.ravel().astype(np.int64), device=dev)
    pids = torch.as_tensor((ys * W + xs).ravel().astype(np.int64), device=dev)
    power = compute_power(sa, static)
    cdf = torch.cumsum(power, 0)
    cdf = cdf / torch.clamp(cdf[-1], min=1e-12)
    ctx = _Ctx(sa, static)
    viz_s = bool(getattr(desc.integrator, "visualize_strategies", False))
    viz_w = bool(getattr(desc.integrator, "visualize_weights", False))
    collect_debug = viz_s or viz_w
    film = torch.zeros((R + 1, 3), dtype=torch.float64, device=dev)
    dbg_acc = {}
    stats = {"vertices": torch.zeros((), dtype=torch.int64, device=dev)}
    t0 = time.perf_counter()
    for s in range(spp):
        out = bdpt_wave(sa, static, ctx, cam, cdf, seed, px, py, pids, s, max_depth, W, H, collect_debug, stats)
        L, spx, sval = out[:3]
        _splat(film, spx, sval)
        _splat(film, pids, L)
        if collect_debug:
            for key, rec in out[3].items():
                ent = dbg_acc.setdefault(key, [torch.zeros((R + 1, 3), dtype=torch.float64, device=dev),
                                               torch.zeros((R + 1, 3), dtype=torch.float64, device=dev)])
                if rec[0] == "splat":
                    _, dpx, dval, dw = rec
                    _splat(ent[0], dpx, torch.where(dw[:, None] > 0, dval / torch.clamp(dw[:, None], min=1e-30), 0.0))
                    _splat(ent[1], dpx, dval)
                else:
                    _, c, w = rec
                    ent[0].index_add_(0, pids, torch.where(w[:, None] > 0, c / torch.clamp(w[:, None], min=1e-30),
                                                           0.0).to(torch.float64))
                    ent[1].index_add_(0, pids, c.to(torch.float64))
        if progress:
            progress(s + 1, spp)
    img = (film[:R] / spp).reshape(H, W, 3).to(torch.float32).cpu().numpy()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    if collect_debug:
        # the per-strategy debug films (bdpt.rs:686-709 names)
        from ..core.imageio import write_exr

        for (s_, t_), (unweighted, weighted) in sorted(dbg_acc.items()):
            d_ = s_ + t_ - 2
            if viz_s:
                write_exr(f"bdpt_d{d_:02d}_s{s_:02d}_t{t_:02d}.exr",
                          (unweighted[:R] / spp).reshape(H, W, 3).to(torch.float32).cpu().numpy())
            if viz_w:
                write_exr(f"bdpt_w_d{d_:02d}_s{s_:02d}_t{t_:02d}.exr",
                          (weighted[:R] / spp).reshape(H, W, 3).to(torch.float32).cpu().numpy())
    render_bdpt.last_timing = {"n_vertices": float(stats["vertices"]), "seconds": seconds}
    log.info("bdpt: %dspp in %.1fs", spp, seconds)
    return img


render_bdpt.last_timing = None
