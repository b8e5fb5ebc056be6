"""Participating media: the Henyey-Greenstein phase function, distance
sampling and transmittance.

The port's counterpart of ``pbrt_tpu/device/media.py`` (the reference's
Medium layer, src/core/medium.rs, src/media/homogeneous.rs, grid.rs, and
VisibilityTester::tr of src/core/light.rs):

- ``hg_p``, ``hg_sample``: the HG phase function and its sampling, cos
  theta measured from wo (medium.rs:138-199);
- ``medium_sample``: a homogeneous medium's channel-stratified exponential
  distance, a grid medium's delta tracking (device/medium_track.py: the
  CUDA kernel on the card, its twin on the CPU), with the throughput weight
  of the segment;
- ``medium_tr``: Beer-Lambert in a homogeneous medium, ratio tracking in a
  grid medium;
- ``transmittance_shadow``: a shadow ray walked through interface (null)
  boundaries, MAX_NULL_CROSSINGS queries whatever the lanes do, the medium
  swapped at each crossing and each segment's transmittance multiplied in.

Medium ids are rows of the scene's medium table; -1 is vacuum. Random draws
come from per-lane keys (device/rng.py, uint32 values in int64), as the
reference's; a scalar key falls back to the lane index, as there.
"""
from __future__ import annotations

import math

import torch

from . import rng
from .intersect import intersect
from .medium_track import delta_track, ratio_track
from .shading import coordinate_system, dot, surface_interaction

INV_4PI = 1.0 / (4.0 * math.pi)
MAX_NULL_CROSSINGS = 8


def hg_p(cos_theta, g):
    """Henyey-Greenstein phase function value (medium.rs phase_hg)."""
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_4PI * (1.0 - g * g) / torch.clamp(denom * torch.sqrt(torch.clamp(denom, min=1e-12)), min=1e-12)


def hg_sample(wo, g, u1, u2):
    """Sample wi with cos theta measured from wo (medium.rs sample_p): for
    g > 0 the density peaks at cos = -1, i.e. wi continues forward along
    -wo. Returns (wi, pdf), pdf = hg_p(cos theta, g); |g| < 1e-3 samples
    the sphere uniformly."""
    small = g.abs() < 1e-3
    g_safe = torch.where(small, 1e-3 * torch.sign(g + 1e-9), g)
    sqr = (1.0 - g_safe * g_safe) / (1.0 + g_safe - 2.0 * g_safe * u1)
    cos_theta = torch.where(small, 1.0 - 2.0 * u1, -(1.0 + g_safe * g_safe - sqr * sqr) / (2.0 * g_safe))
    cos_theta = torch.clamp(cos_theta, -1.0, 1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2.0 * math.pi * u2
    v1, v2 = coordinate_system(wo)
    wi = (sin_theta[..., None] * torch.cos(phi)[..., None] * v1
          + sin_theta[..., None] * torch.sin(phi)[..., None] * v2
          + cos_theta[..., None] * wo)
    return wi, hg_p(cos_theta, g)


def _lane_keys(key, R, dev, stride):
    """Per-lane uint32 keys; a scalar key falls back to key + lane * stride
    (the reference's fallback, not invariant under a split of the lanes)."""
    if isinstance(key, int) or key.dim() == 0:
        return rng._u32(rng._u32(int(key)) + torch.arange(R, dtype=torch.int64, device=dev) * stride)
    return rng._u32(key)


def _grid_mask(static, med):
    out = torch.zeros(med.shape, dtype=torch.bool, device=med.device)
    for i, kind in enumerate(static.media_kinds):
        if kind == "heterogeneous":
            out = out | (med == i)
    return out


def medium_sample(sa, static, med, o, d, t_surf, key):
    """Sample a medium interaction along [0, t_surf) (media.py :126-225).

    med: (R,) medium rows (-1: vacuum, no interaction); key: per-lane keys.
    Returns {hit_medium (R,), t (R,), weight (R, 3)}: weight is the
    throughput factor (sigma_s Tr / pdf at a medium vertex, Tr / pdf on
    the way to the surface; a grid medium's sigma_s / sigma_t or 1)."""
    R = o.shape[0]
    dev = o.device
    key = rng.pcg_hash(_lane_keys(key, R, dev, 0x9E3779B1))
    if static.n_media:
        par = sa.med_param[torch.clamp(med, min=0)]
    else:
        par = torch.zeros((R, 8), dtype=torch.float32, device=dev)
    sig_s = par[:, 3:6]
    sig_t = par[:, 0:3] + sig_s
    in_medium = med >= 0
    hit_medium = torch.zeros(R, dtype=torch.bool, device=dev)
    t_med = torch.zeros(R, dtype=torch.float32, device=dev)
    weight = torch.ones((R, 3), dtype=torch.float32, device=dev)
    is_grid = _grid_mask(static, med)

    if "homogeneous" in static.media_kinds:
        # channel-stratified exponential sampling (homogeneous.rs:24-61)
        key = rng.pcg_hash(key)
        u_ch = rng.u32_to_float(key)
        key = rng.pcg_hash(key)
        u_t = rng.u32_to_float(key)
        ch = torch.clamp((u_ch * 3).to(torch.int64), max=2)
        sig_ch = torch.clamp(sig_t.gather(1, ch[:, None])[:, 0], min=1e-12)
        t_s = -torch.log(torch.clamp(1.0 - u_t, min=1e-12)) / sig_ch
        hm = in_medium & ~is_grid & (t_s < t_surf)
        tr = torch.exp(-sig_t * torch.clamp(torch.minimum(t_s, t_surf), max=1e7)[:, None])
        pdf_med = (sig_t * tr).mean(-1)
        pdf_surf = tr.mean(-1)
        w_med = tr * sig_s / torch.clamp(pdf_med, min=1e-24)[:, None]
        w_surf = tr / torch.clamp(pdf_surf, min=1e-24)[:, None]
        m_any = in_medium & ~is_grid
        hit_medium = torch.where(m_any, hm, hit_medium)
        t_med = torch.where(m_any, t_s, t_med)
        weight = torch.where(m_any[:, None], torch.where(hm[:, None], w_med, w_surf), weight)

    if "heterogeneous" in static.media_kinds:
        # delta tracking (grid.rs:107-139), channel 0's sigma_t
        active = in_medium & is_grid
        t_fin, found, _steps = delta_track(sa, static, torch.where(active, med, -1), o, d, t_surf, key)
        found = found & active
        w_het = torch.where(found[:, None], sig_s / torch.clamp(sig_t, min=1e-12), 1.0)
        hit_medium = torch.where(active, found, hit_medium)
        t_med = torch.where(active, t_fin, t_med)
        weight = torch.where(active[:, None], w_het, weight)

    return {"hit_medium": hit_medium & in_medium, "t": t_med, "weight": weight}


def medium_tr(sa, static, med, o, d, t_max, key):
    """Transmittance (R, 3) through medium `med` along [0, t_max]."""
    R = o.shape[0]
    dev = o.device
    if static.n_media == 0:
        return torch.ones((R, 3), dtype=torch.float32, device=dev)
    par = sa.med_param[torch.clamp(med, min=0)]
    sig_t = par[:, 0:3] + par[:, 3:6]
    in_medium = med >= 0
    is_grid = _grid_mask(static, med)
    tr = torch.exp(-sig_t * torch.clamp(t_max, max=1e7)[:, None])
    tr = torch.where((in_medium & ~is_grid)[:, None], tr, 1.0)
    if "heterogeneous" in static.media_kinds:
        # ratio tracking (grid.rs tr :141-182)
        active = in_medium & is_grid
        trv, _steps = ratio_track(sa, static, torch.where(active, med, -1), o, d, t_max,
                                  _lane_keys(key, R, dev, 0x85EBCA6B))
        tr = torch.where(active[:, None], trv[:, None].expand(R, 3), tr)
    return tr


def transmittance_shadow(sa, static, o, d, t_max, medium, key, offset_ray, ray_eps, query=intersect):
    """Visibility with transmittance (light.rs tr :121-151): walk the shadow
    segment through interface (null) boundaries, multiplying in each
    segment's medium transmittance; an opaque hit gives 0. Makes
    MAX_NULL_CROSSINGS closest-hit queries (one without media or null
    materials) whether or not a lane still walks, each key
    pcg_hash(key + it * 7919). offset_ray(p, ng, w, p_err) and ray_eps are
    the integrator's; query is the closest-hit query. Returns (R, 3)."""
    R = o.shape[0]
    dev = o.device
    tr = torch.ones((R, 3), dtype=torch.float32, device=dev)
    cur_o, cur_t, cur_med = o, t_max, medium
    done = torch.zeros(R, dtype=torch.bool, device=dev)
    key = rng._u32(key)
    n_iters = MAX_NULL_CROSSINGS if (static.has_null_material or static.n_media) else 1
    for it in range(n_iters):
        hit = query(sa, static, cur_o, d, cur_t)
        prim = torch.clamp(hit["prim"], min=0)
        hit_valid = hit["prim"] >= 0
        mat_kind = sa.mat_kind[sa.prim_mat[prim]]
        is_null = hit_valid & (mat_kind == 0)
        blocked = hit_valid & (mat_kind != 0)
        seg_t = torch.where(hit_valid, hit["t"], cur_t)
        key = rng.pcg_hash(key + it * 7919)
        tr_seg = medium_tr(sa, static, cur_med, cur_o, d, seg_t, key)
        tr = torch.where(done[:, None], tr, tr * tr_seg)
        tr = torch.where((~done & blocked)[:, None], 0.0, tr)
        done = done | blocked | ~hit_valid
        if it == n_iters - 1:
            break
        # cross the null boundary: the medium by the side it is crossed from
        p_hit = cur_o + d * hit["t"][:, None]
        si = surface_interaction(sa, hit, cur_o, d, static.quadric_kinds)
        entering = dot(d, si["ng"]) < 0
        pm = sa.prim_medium[prim]
        new_med = torch.where(entering, pm[:, 0], pm[:, 1]).to(cur_med.dtype)
        transition = pm[:, 0] != pm[:, 1]
        cur_med = torch.where(~done & is_null & transition, new_med, cur_med)
        cur_o = torch.where((~done)[:, None], offset_ray(p_hit, si["ng"], d, si["p_err"]), cur_o)
        cur_t = torch.where(~done, cur_t - hit["t"] - ray_eps, cur_t)
        cur_t = torch.clamp(cur_t, min=0.0)
    return tr
