"""Stochastic progressive photon mapping (SPPM).

The port's counterpart of ``pbrt_tpu/device/sppm.py`` (src/integrators/
sppm.rs). Each iteration is the reference's three passes and its update:

- the camera pass (sppm.rs :124-256): one path per pixel traced to its
  first vertex with a non-specular lobe, the visible point; direct light
  by NEE with MIS on the way, the BSDF-sampled half of the MIS pair picked
  up one segment past the visible point (``mis_tail``); samples from the
  (0,2)-sequence with spp = the iteration count;
- the grid (sppm.rs :259-335): each visible point registers the up to 8
  voxels its ball overlaps (first occurrence only, the reference's order),
  keyed by the packed 10-bit voxel coordinates, and the entries are sorted
  by key with a stable sort (the order within a run decides which entries
  the cap drops);
- the photon pass (sppm.rs :341-464): photons from ``sample_le`` over the
  lights' power CDF, scattered in importance transport with Russian
  roulette on the throughput ratio; from the second hit on each photon
  deposits on the visible points of its voxel's run, at most the first
  KMAX * N_CHUNKS (1,024) entries of it (the reference's scan cap; the
  rest are counted as dropped);
- the update (sppm.rs :470-502): radius and tau with gamma = 2/3.

L = Ld / iterations + tau / (N_photons pi r^2) (sppm.rs :504-528).

The deposit is not the reference's window scan: each photon's capped run
becomes (photon, visible point) pairs by a cumulative sum and a
searchsorted, the distance test and the BSDF run once over fixed-size
chunks of pairs, and phi and the counts add in float64 by ``index_add_``
(the reference sums float32 segment sums, so phi agrees to float32
rounding; tests/test_torch_sppm.py states the tolerance). The pairs are
exactly the reference's. KMAX and N_CHUNKS are read when called, so a
test may set them. The visible point's BSDF keeps its lobe set's tables
(the reference's deposit drops the Beckmann, Schlick and Fourier tables,
as its BDPT does; ROADMAP C), which no test scene's matte surfaces read.
"""
from __future__ import annotations

import logging
import math
import time

import numpy as np
import torch

from . import rng
from .bdpt import _Ctx
from .bsdf import _is_specular, bsdf_f, bsdf_pdf, bsdf_sample, num_lobes
from .camera import generate_rays, make_camera
from .integrator import _light_select_pdf, _offset_ray, _to_local, _to_world, power_heuristic
from .intersect import intersect, intersect_p
from .lights import area_light_emission, compute_power, env_le, env_pdf_li, pdf_li_area_hit, sample_le, sample_li
from .materials import make_bsdf
from .sampler import sample_1d, sample_2d
from .shading import apply_bump, dot, surface_interaction

log = logging.getLogger(__name__)

KMAX = 64  # the reference's scan window (visible points per chunk)
N_CHUNKS = 16  # its windows per run: a run's first KMAX * N_CHUNKS entries deposit
GAMMA = 2.0 / 3.0
KEY_SENTINEL = 1 << 30  # the key of an entry that registers nowhere
PHOTON_SLICE = 1 << 16  # the reference's photons per pass: the count rounds up to whole slices
PHOTON_PASS = 1 << 19  # photons traced together (whole slices; the streams do not depend on it)
PAIR_CHUNK = 1 << 20  # photon-visible point pairs per deposit evaluation


def _cell_key(ix, iy, iz):
    """The packed voxel key: 10 bits per axis (coordinates mod 1024)."""
    return (ix & 1023) | ((iy & 1023) << 10) | ((iz & 1023) << 20)


class _Split:
    """Seconds per phase, each span closed after a device synchronize."""

    def __init__(self, dev):
        self.dev = dev
        self.seconds = {}
        self.t = time.perf_counter()

    def lap(self, name):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self.t
        self.t = now


def _surface(sa, static, ctx, o, d):
    R = o.shape[0]
    hit = intersect(sa, static, o, d, torch.full((R,), math.inf, device=o.device), sort_rays=True)
    si = surface_interaction(sa, hit, o, d, static.quadric_kinds)
    if static.has_bump:
        si = apply_bump(sa, static, si, ctx.atlases)
    return si


def _lobes_at(sa, static, ctx, si):
    return make_bsdf(sa, static, si["mat"], ctx.table, uv=si["uv"], p=si["p"], atlases=ctx.atlases)


def _camera_pass(sa, static, ctx, cam, max_depth: int, seed: int, px, py, pids, it: int, spp: int):
    """Trace each pixel's camera path to its visible point (the reference's
    _camera_pass, sample index it of spp): (the direct light it gathered (R,
    3), the visible points {valid, p, beta, wo, kind, data, ns, ss, ts,
    ng})."""
    R = px.shape[0]
    dev = px.device
    kind_s = "zerotwosequence"
    sel_pdf = _light_select_pdf(static)
    sidx = torch.full_like(pids, it)
    u1, u2 = sample_2d(kind_s, seed, pids, sidx, 0, spp)
    ul1, ul2 = sample_2d(kind_s, seed, pids, sidx, 1, spp)
    o, d = generate_rays(cam, px.to(torch.float32) + u1, py.to(torch.float32) + u2, ul1, ul2)
    f32 = dict(dtype=torch.float32, device=dev)
    ld = torch.zeros((R, 3), **f32)
    beta = torch.ones((R, 3), **f32)
    alive = torch.ones(R, dtype=torch.bool, device=dev)
    prev_spec = torch.ones(R, dtype=torch.bool, device=dev)
    prev_pdf = torch.ones(R, **f32)
    prev_p = o
    # lanes that recorded their visible point but owe the BSDF-sampled half
    # of the direct light's MIS pair (the camera path stops there)
    mis_tail = torch.zeros(R, dtype=torch.bool, device=dev)
    S = ctx.slots
    vp = {"valid": torch.zeros(R, dtype=torch.bool, device=dev), "p": torch.zeros((R, 3), **f32),
          "beta": torch.zeros((R, 3), **f32), "wo": torch.zeros((R, 3), **f32),
          "kind": torch.zeros((R, S), dtype=torch.int64, device=dev), "data": torch.zeros((R, S, 14), **f32),
          "ns": torch.zeros((R, 3), **f32), "ss": torch.zeros((R, 3), **f32), "ts": torch.zeros((R, 3), **f32),
          "ng": torch.zeros((R, 3), **f32)}
    for b in range(max_depth + 1):
        dim = 2 + b * 6
        si = _surface(sa, static, ctx, o, d)
        valid = si["valid"]
        if static.has_infinite:
            esc = (alive | mis_tail) & ~valid
            le = env_le(sa, static, d)
            p_l = env_pdf_li(sa, static, d) * sel_pdf
            w = torch.where(prev_spec, 1.0, power_heuristic(1.0, prev_pdf, 1.0, p_l))
            ld = ld + torch.where(esc[:, None], beta * le * w[:, None], 0.0)
        if static.has_area_lights:
            lid = si["light"]
            emitting = (alive | mis_tail) & valid & (lid >= 0)
            le = area_light_emission(sa, lid, si["ng"], si["wo"])
            area = sa.prim_area[torch.clamp(si["prim"], min=0)]
            p_l = pdf_li_area_hit(sa, prev_p, si["p"], si["ng"], lid, area) * sel_pdf
            w = torch.where(prev_spec, 1.0, power_heuristic(1.0, prev_pdf, 1.0, p_l))
            ld = ld + torch.where(emitting[:, None], beta * le * w[:, None], 0.0)
        alive = alive & valid
        mis_tail = torch.zeros_like(mis_tail)  # the owed pickup is consumed
        if b == max_depth:
            break
        lobes = _lobes_at(sa, static, ctx, si)
        alive_sh = alive & (num_lobes(lobes) > 0)
        wo_l = _to_local(si, si["wo"])
        if static.n_lights > 0:
            # NEE at the vertex (sppm.rs's camera pass gathers direct light)
            u_sel = sample_1d(kind_s, seed, pids, sidx, dim, spp)
            ua, ub = sample_2d(kind_s, seed, pids, sidx, dim + 1, spp)
            lid_s = torch.clamp((u_sel * static.n_lights).to(torch.int64), max=static.n_lights - 1)
            ls = sample_li(sa, static, lid_s, si["p"], ua, ub)
            wi_l = _to_local(si, ls["wi"])
            refl = dot(ls["wi"], si["ng"]) * dot(si["wo"], si["ng"]) > 0
            f_v = bsdf_f(lobes, wo_l, wi_l, refl) * dot(ls["wi"], si["ns"]).abs()[:, None]
            p_b = bsdf_pdf(lobes, wo_l, wi_l)
            p_l = ls["pdf"] * sel_pdf
            o_sh = _offset_ray(si["p"], si["ng"], ls["wi"], si.get("p_err"))
            occ = intersect_p(sa, static, o_sh, ls["wi"], ls["dist"] * 0.998, sort_rays=True)
            ok = alive_sh & (p_l > 0) & ~occ
            w_l = torch.where(ls["delta"], 1.0, power_heuristic(1.0, p_l, 1.0, p_b))
            ld = ld + torch.where(ok[:, None], beta * f_v * ls["li"] * (w_l / torch.clamp(p_l, min=1e-30))[:, None],
                                  0.0)
        # the first vertex with a non-specular lobe records the visible point
        any_nonspec = ((lobes["kind"] != 0) & ~_is_specular(lobes["kind"])).sum(1) > 0
        record = alive_sh & any_nonspec & ~vp["valid"]
        vp["valid"] = vp["valid"] | record
        for key, val in (("p", si["p"]), ("beta", beta), ("wo", si["wo"]), ("kind", lobes["kind"]),
                         ("data", lobes["data"]), ("ns", si["ns"]), ("ss", si["ss"]), ("ts", si["ts"]),
                         ("ng", si["ng"])):
            vp[key] = torch.where(record.view((-1,) + (1,) * (val.dim() - 1)), val.to(vp[key].dtype), vp[key])
        alive = alive_sh & ~record  # specular-only vertices continue
        u_lo = sample_1d(kind_s, seed, pids, sidx, dim + 2, spp)
        ua, ub = sample_2d(kind_s, seed, pids, sidx, dim + 3, spp)
        bs = bsdf_sample(lobes, wo_l, u_lo, ua, ub)
        wi_w = _to_world(si, bs["wi"])
        thru = bs["f"] * (dot(wi_w, si["ns"]).abs() / torch.clamp(bs["pdf"], min=1e-30))[:, None]
        ok_bs = bs["valid"] & (thru > 0).any(-1)
        # recorded lanes continue one segment for the owed MIS pickup
        mis_tail = record & ok_bs
        if b == max_depth - 1:
            alive = torch.zeros_like(alive)  # the depth limit: the tails alone
        else:
            alive = alive & ok_bs
        cont = alive | mis_tail
        beta = torch.where(cont[:, None], beta * thru, beta)
        prev_spec = bs["specular"]
        prev_pdf = torch.clamp(bs["pdf"], min=1e-30)
        prev_p = si["p"]
        o = torch.where(cont[:, None], _offset_ray(si["p"], si["ng"], wi_w, si.get("p_err")), o)
        d = torch.where(cont[:, None], wi_w, d)
    return ld, vp


def _build_grid(vp, radius, grid_min, inv_cell: float):
    """The visible points' voxel entries sorted by key: (sorted keys (8 R,),
    their visible points (8 R,)). Entry j R + i is point i's corner j
    (z-major, then y, then x, each from its ball's low or high side); a
    corner whose voxel an earlier corner of the same point took, and every
    corner of an invalid point, takes KEY_SENTINEL."""
    R = radius.shape[0]
    lo_i = torch.floor((vp["p"] - radius[:, None] - grid_min) * inv_cell).to(torch.int64)
    hi_i = torch.floor((vp["p"] + radius[:, None] - grid_min) * inv_cell).to(torch.int64)
    corner = [(cx, cy, cz) for cz in range(2) for cy in range(2) for cx in range(2)]

    def key(c):
        return _cell_key(*(hi_i[:, a] if c[a] else lo_i[:, a] for a in range(3)))

    keys = [key(c) for c in corner]
    cells = []
    for j, kj in enumerate(keys):
        dup = torch.zeros(R, dtype=torch.bool, device=radius.device)
        for i in range(j):
            dup = dup | (keys[i] == kj)
        cells.append(torch.where(vp["valid"] & ~dup, kj, KEY_SENTINEL))
    cells = torch.cat(cells)
    vps = torch.arange(R, device=radius.device).repeat(8)
    order = torch.argsort(cells, stable=True)
    return cells[order], vps[order]


def _deposit(ctx, vp, r2, sorted_cells, sorted_vp, grid_min, inv_cell, alive, p, wi, beta, phi, m_cnt, stats):
    """Deposit each live photon at p (P, 3), arriving along -wi, on the
    visible points of its voxel's run: of the run, the first KMAX *
    N_CHUNKS entries, each within its point's radius, add f(wo, wi) beta
    to the point's phi (float64 (R + 1, 3)) and 1 to its count (float64 (R
    + 1,)); row R takes nothing that counts. stats: device tensors
    "dropped", "max_run" and "pairs", updated."""
    R = r2.shape[0]
    cap = KMAX * N_CHUNKS
    pg = (p - grid_min) * inv_cell
    c = _cell_key(*(torch.floor(pg[:, a]).to(torch.int64) for a in range(3)))
    lo = torch.searchsorted(sorted_cells, c)
    run = torch.where(alive, torch.searchsorted(sorted_cells, c, right=True) - lo, 0)
    stats["dropped"] += torch.clamp(run - cap, min=0).sum()
    stats["max_run"] = torch.maximum(stats["max_run"], run.max())
    n = torch.clamp(run, max=cap)
    ends = torch.cumsum(n, 0)
    total = int(ends[-1]) if ends.numel() else 0  # the one host read of a deposit
    stats["pairs"] += total
    for c0 in range(0, total, PAIR_CHUNK):
        j = torch.arange(c0, min(c0 + PAIR_CHUNK, total), device=p.device)
        ph = torch.searchsorted(ends, j, right=True)
        v = sorted_vp[lo[ph] + j - (ends[ph] - n[ph])]
        dv = vp["p"][v] - p[ph]
        dist2 = (dv[:, 0] * dv[:, 0] + dv[:, 1] * dv[:, 1]) + dv[:, 2] * dv[:, 2]
        close = vp["valid"][v] & (dist2 <= r2[v])
        fr = {"ss": vp["ss"][v], "ts": vp["ts"][v], "ns": vp["ns"][v]}
        w_ph = wi[ph]
        wo_v = vp["wo"][v]
        refl = dot(w_ph, vp["ng"][v]) * dot(wo_v, vp["ng"][v]) > 0
        f_v = bsdf_f(dict(ctx.meta, kind=vp["kind"][v], data=vp["data"][v]), _to_local(fr, wo_v), _to_local(fr, w_ph),
                     refl)
        val = torch.where(close[:, None], f_v * beta[ph], 0.0)
        val = torch.where(torch.isfinite(val), val, 0.0)
        idx = torch.where(close, v, R)
        phi.index_add_(0, idx, val.to(torch.float64))
        m_cnt.index_add_(0, idx, close.to(torch.float64))


def _photon_pass(sa, static, ctx, max_depth: int, seed: int, it: int, pid0: int, P: int, power_cdf, vp, radius,
                 sorted_cells, sorted_vp, grid_min, inv_cell, phi, m_cnt, stats, split):
    """Trace photons pid0 .. pid0 + P - 1 of iteration it (seed: the
    iteration's, seed + 9781 it) and deposit them (_deposit) from their
    second hit on."""
    dev = radius.device
    pid = torch.arange(pid0, pid0 + P, dtype=torch.int64, device=dev)
    phseed = (seed ^ 0xC0FFEE) & rng.MASK32

    def ph_u1(dim):
        return rng.uniform_1d(phseed, pid, it, dim)

    # the light by power (halton-indexed in pbrt, sppm.rs:349)
    lid = torch.clamp(torch.searchsorted(power_cdf, ph_u1(0).contiguous(), right=True), 0, static.n_lights - 1)
    sel_pdf = power_cdf[lid] - torch.where(lid > 0, power_cdf[torch.clamp(lid - 1, min=0)], 0.0)
    em = sample_le(sa, static, lid, ph_u1(1), ph_u1(2), ph_u1(3), ph_u1(4))
    beta = em["le_over_pdf"] / torch.clamp(sel_pdf, min=1e-12)[:, None]
    o, d = em["o"], em["d"]
    alive = (beta > 0).any(-1)
    r2 = radius * radius
    for b in range(max_depth):
        dim = 5 + b * 4
        si = _surface(sa, static, ctx, o, d)
        alive = alive & si["valid"]
        if b > 0:
            # photons deposit from their second hit on (sppm.rs)
            split.lap("photon_trace")
            _deposit(ctx, vp, r2, sorted_cells, sorted_vp, grid_min, inv_cell, alive, si["p"], -d, beta, phi, m_cnt,
                     stats)
            split.lap("deposit")
        if b == max_depth - 1:
            break
        lobes = _lobes_at(sa, static, ctx, si)
        alive = alive & (num_lobes(lobes) > 0)
        # importance transport, without the shading-normal correction
        # (sppm.rs:431, :455)
        bs = bsdf_sample(lobes, _to_local(si, si["wo"]), ph_u1(dim), ph_u1(dim + 1), ph_u1(dim + 2), "importance")
        wi_w = _to_world(si, bs["wi"])
        bnew = beta * bs["f"] * (dot(wi_w, si["ns"]).abs() / torch.clamp(bs["pdf"], min=1e-30))[:, None]
        alive = alive & bs["valid"] & (bnew > 0).any(-1)
        # Russian roulette on the throughput ratio (sppm.rs :450)
        q = torch.clamp(1.0 - bnew.max(-1).values / torch.clamp(beta.max(-1).values, min=1e-12), min=0.0)
        alive = alive & ~(ph_u1(dim + 3) < q)
        beta = torch.where(alive[:, None], bnew / torch.clamp(1.0 - q, min=1e-6)[:, None], beta)
        o = _offset_ray(si["p"], si["ng"], wi_w, si.get("p_err"))
        d = wi_w
    split.lap("photon_trace")


def _write_progress(desc, img):
    """The progressive image to the film's filename (sppm.rs:505-528); a
    failed write is logged, never raised."""
    name = getattr(desc.film, "filename", "pbrt.exr") or "pbrt.exr"
    try:
        from ..core.imageio import write_exr, write_image

        (write_exr if name.lower().endswith(".exr") else write_image)(name, img * desc.film.scale)
        log.info("sppm: progressive image -> %s", name)
    except Exception as e:  # a progressive write must never end a render
        log.warning("sppm: progressive write failed: %s", e)


def grid_inv_cell(max_r: float, wr: float, in_float32: bool = False) -> float:
    """1 / the grid's cell size: the largest valid radius's diameter, but at
    most 1022 cells across the world's diameter (the packed 10-bit key is
    exact below 1024 per axis). in_float32: the reference's sharded step
    computes it in float32, its single-device render in float64."""
    if in_float32:
        cell = max(np.float32(2.0) * np.float32(max_r), np.float32(2.0 * wr / 1022.0), np.float32(1e-6))
        return float(np.float32(1.0) / cell)
    return float(np.float32(1.0 / max(2.0 * max_r, 2.0 * wr / 1022.0, 1e-6)))


def update_points(radius, n_eff, tau, beta, phi, m):
    """The radius and tau update (sppm.rs :470-502) of the visible points
    that took photons (m > 0), in float32; returns (radius, n_eff, tau)."""
    has = m > 0
    n_new = n_eff + GAMMA * m
    r_new = torch.where(has, radius * torch.sqrt(n_new / torch.clamp(n_eff + m, min=1e-12)), radius)
    tau = torch.where(has[:, None], (tau + beta * phi)
                      * ((r_new * r_new) / torch.clamp(radius * radius, min=1e-20))[:, None], tau)
    return torch.where(has, r_new, radius), torch.where(has, n_new, n_eff), tau


def sppm_image(ld, tau, radius, n_iters: int, n_photons: int):
    """The estimate after n_iters iterations of n_photons photons each:
    Ld / n_iters + tau / (n_iters n_photons pi r^2)."""
    return ld / n_iters + tau / (float(n_iters) * n_photons * math.pi
                                 * torch.clamp(radius * radius, min=1e-20))[:, None]


def render_sppm(cs, seed: int = 0, progress=None):
    """The SPPM host loop over the integrator's iterations: the camera pass,
    the grid (cell size max(2 max_r, 2 world_radius / 1022, 1e-6)), the
    photons in slices, the radius and tau update; the progressive image
    every imagewritefrequency iterations. Renders the whole film (no crop,
    as the reference's). Returns the (H, W, 3) float32 image; records
    ``render_sppm.last_timing`` {"seconds", "iterations", "photons" (all
    iterations'), "visible_points" (summed over iterations), "split" (the
    seconds of the camera pass, grid, photon trace and deposit), "max_run",
    "dropped" (pairs the cap dropped), "pairs" (pairs evaluated)}."""
    desc = cs.description
    sa, static = cs.arrays, cs.static
    dev = sa.device
    cam = make_camera(desc.camera, desc.film, dev)
    W, H = desc.film.x_resolution, desc.film.y_resolution
    R = W * H
    max_depth = max(int(desc.integrator.max_depth), 1)
    n_iters = int(desc.integrator.num_iterations)
    # the photons of an iteration (<= 0: one per pixel) in slices of at most
    # PHOTON_SLICE, the count rounded up to a whole number of equal slices
    n_photons = int(desc.integrator.photons_per_iteration)
    if n_photons <= 0:
        n_photons = R
    n_slices = max(1, -(-n_photons // PHOTON_SLICE))
    n_slice = -(-n_photons // n_slices)
    n_photons = n_slices * n_slice
    per_pass = max(1, PHOTON_PASS // n_slice) * n_slice
    ys, xs = np.mgrid[0:H, 0:W]
    px = torch.as_tensor(xs.ravel().astype(np.int64), device=dev)
    py = torch.as_tensor(ys.ravel().astype(np.int64), device=dev)
    pids = torch.as_tensor((ys * W + xs).ravel().astype(np.int64), device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    radius = torch.full((R,), float(desc.integrator.initial_radius), **f32)
    n_eff = torch.zeros(R, **f32)
    tau = torch.zeros((R, 3), **f32)
    ld = torch.zeros((R, 3), **f32)
    power = compute_power(sa, static)
    cdf = torch.cumsum(power, 0)
    cdf = cdf / torch.clamp(cdf[-1], min=1e-12)
    wr = float(sa.world_radius)
    grid_min = sa.world_center - sa.world_radius
    ctx = _Ctx(sa, static)
    wf = int(getattr(desc.integrator, "write_frequency", 1 << 31))
    stats = {k: torch.zeros((), dtype=torch.int64, device=dev) for k in ("dropped", "max_run", "visible_points")}
    stats["pairs"] = 0
    split = _Split(dev)
    t0 = time.perf_counter()
    for it in range(n_iters):
        ld_add, vp = _camera_pass(sa, static, ctx, cam, max_depth, seed, px, py, pids, it, n_iters)
        ld = ld + torch.where(torch.isfinite(ld_add), ld_add, 0.0)
        vp["beta"] = torch.where(torch.isfinite(vp["beta"]), vp["beta"], 0.0)
        stats["visible_points"] += vp["valid"].sum()
        max_r = float(torch.where(vp["valid"], radius, 0.0).max())
        split.lap("camera")
        inv_cell = grid_inv_cell(max_r, wr)
        sc, sv = _build_grid(vp, radius, grid_min, inv_cell)
        split.lap("grid")
        phi = torch.zeros((R + 1, 3), dtype=torch.float64, device=dev)
        m_cnt = torch.zeros(R + 1, dtype=torch.float64, device=dev)
        seed_it = (seed + it * 9781) & rng.MASK32
        dropped0 = int(stats["dropped"])
        for p0 in range(0, n_photons, per_pass):
            _photon_pass(sa, static, ctx, max_depth, seed_it, it, p0, min(per_pass, n_photons - p0), cdf, vp, radius,
                         sc, sv, grid_min, inv_cell, phi, m_cnt, stats, split)
        dropped = int(stats["dropped"]) - dropped0
        if dropped > 0:
            log.warning("sppm iter %d: %d photon-VP pairs dropped by the %d-entry scan cap", it, dropped,
                        KMAX * N_CHUNKS)
        radius, n_eff, tau = update_points(radius, n_eff, tau, vp["beta"], phi[:R].to(torch.float32),
                                           m_cnt[:R].to(torch.float32))
        if progress:
            progress(it + 1, n_iters)
        if wf < n_iters and (it + 1) % wf == 0 and (it + 1) < n_iters:
            img = sppm_image(ld, tau, radius, it + 1, n_photons)
            _write_progress(desc, img.reshape(H, W, 3).cpu().numpy())
        split.lap("update")
    img = sppm_image(ld, tau, radius, n_iters, n_photons).reshape(H, W, 3).cpu().numpy()
    seconds = time.perf_counter() - t0
    render_sppm.last_timing = {"seconds": seconds, "iterations": n_iters, "photons": n_iters * n_photons,
                               "visible_points": int(stats["visible_points"]), "split": dict(split.seconds),
                               "max_run": int(stats["max_run"]), "dropped": int(stats["dropped"]),
                               "pairs": stats["pairs"]}
    log.info("sppm: %d iters x %d photons in %.1fs", n_iters, n_photons, seconds)
    return img


render_sppm.last_timing = None
