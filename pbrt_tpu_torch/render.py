"""Top-level render driver: SceneDescription -> image, on one device.

The port's counterpart of ``pbrt_tpu/render.py`` (``make_regen``,
``make_persistent_fn``, ``persistent_eligible``, ``make_wave_fn``,
``render_compiled``, ``render``). ``render_compiled`` picks the route as
the reference's does: the sppm, bdpt and mlt integrators first, each to a
host loop of its own (device/sppm.py, bdpt.py, mlt.py; route label
"torch-sppm/", "torch-bdpt/" or "torch-mlt/" + the query's route; sppm and
mlt render the whole film); then the persistent routes for a scene of the reference's
``persistent_eligible`` class (path or directlighting without media,
interface or subsurface materials) when no checkpoint is asked for and
PBRT_TPU_FORCE_WAVE is unset, else the per-sample wave (``make_wave_fn``,
device/integrator.py trace_wave): every pixel's sample s traced to the end,
sample after sample, in chunks of MAX_RAYS_PER_PASS rays, with a checkpoint
of the film's accumulators every `checkpoint_every` samples that a matching
render resumes. The wave's route label is "torch-wave/" + the query's route
(LAST_WAVE_TIER). ``make_persistent_fn`` tries, in the reference's order:

- the brute megakernel (device/megakernel.py) for every path or
  directlighting scene of its class; all samples of a render go in one
  launch;
- the wide megakernel (device/megakernel_wide.py) for path-traced scenes
  of its class when PBRT_TPU_WIDEMEGA=1 (PBRT_TPU_WIDEMEGA_MAX_TRIS sets
  its triangle cap, default 4096); one launch per render as well, under
  the halton and sobol samplers from the same film tables as the
  wavefront's;
- the persistent wavefront (device/integrator.py) otherwise, in spp chunks
  of PERSISTENT_SPP_CHUNK = 8 (the reference mesh tier's accumulation
  granularity): brute-force intersection for scenes of at most 64 prims
  without instances, the kd-tree walk for a scene that asks for the
  kd-tree, the wide-BVH traversal for triangle scenes (PBRT_TPU_JOINT=1
  sends its CUDA queries through the joint traversal kernel) and mixed
  scenes of at most 8 spheres, and the binary-BVH walk for every other
  scene (device/intersect.py route_name). It renders every scene that
  compile_scene takes: the reference's persistent_eligible class.

PBRT_TPU_NO_MEGAKERNEL (any non-empty value) skips both megakernels. The
switches are the reference's, read once when a route is built; the route
is chosen by the scene's class, and a route that fails raises.

The whole film (or crop) is one lane set, accumulated in float64. The
reference's dispatch-shape table and its TPU watchdog chunking are not
carried over: GPU chunk sizes are for measurement to set.
"""
from __future__ import annotations

import logging
import math
import os
import time

import numpy as np
import torch

from .core.transform import AnimatedTransform
from .device.camera import generate_rays, make_camera, ray_differential_dirs
from .device.realistic import realistic_generate_rays
from .device.integrator import trace_persistent, trace_wave
from .device.intersect import route_name
from .device.lightdistrib import build_spatial_distribution
from .device.materials import lobe_table
from .device.texture import has_imagemaps, prepare_atlases
from .device.megakernel import make_megakernel_fn
from .device.megakernel_wide import DEFAULT_MAX_TRIS, make_wide_megakernel_fn
from .device.sampler import (
    halton_dim_2d, halton_film_jitter, halton_tables, sample_1d, sample_2d, sobol_dim_2d, sobol_film_jitter,
    sobol_tables,
)
from .scene.arrays import scene_byte_size
from .scene.builder import CompiledScene, compile_scene
from .scene.host import SceneDescription
from .utils.stats import STATS

log = logging.getLogger(__name__)

PERSISTENT_SPP_CHUNK = 8
MAX_RAYS_PER_PASS = 1 << 20  # the wave's rays per pass (render.MAX_RAYS_PER_PASS)

# route of the most recent make_persistent_fn build, so a run shows the
# path it took: torch-megakernel/{cuda,plain}-brute,
# torch-megakernel/{cuda,plain}-wide, torch-wavefront/{cuda,plain}-brute,
# torch-wavefront/{cuda,plain}-wide (-mixed with spheres beside the walk),
# torch-wavefront/cuda-wide-joint, torch-wavefront/{cuda,plain}-bvh or
# torch-wavefront/{cuda,plain}-kdtree (the CUDA kernels, or their plain
# twins on the CPU)
LAST_PERSISTENT_TIER = "unbuilt"
# route of the most recent make_wave_fn build: "torch-wave/" + the query's
# route (intersect.route_name: brute, kdtree, wide, wide-joint, bvh, with
# "-mixed" where spheres ride beside the wide walk)
LAST_WAVE_TIER = "unbuilt"


def _erfinv(x):
    """Winitzki's approximation of erf^-1 (render._erfinv)."""
    a = 0.147
    ln1 = torch.log(torch.clamp(1.0 - x * x, min=1e-30))
    t1 = 2.0 / (math.pi * a) + ln1 / 2.0
    return torch.sign(x) * torch.sqrt(torch.clamp(torch.sqrt(t1 * t1 - ln1 / a) - t1, min=0.0))


def filter_offset(name: str, params: dict, u1, u2):
    """Map uniform (u1, u2) -> raster offset (dx, dy) and per-sample weight
    (None = 1) by filter importance sampling (render.filter_offset): the
    triangle and gaussian filters warp the offset and weigh 1; mitchell and
    sinc/lanczossinc draw it uniformly over the filter's extent and weigh it
    by the filter value over that density."""
    if name == "triangle":
        r = params.get("xwidth", 2.0)

        def tent(u):
            return torch.where(u < 0.5, torch.sqrt(torch.clamp(2.0 * u, min=0.0)) - 1.0,
                               1.0 - torch.sqrt(torch.clamp(2.0 - 2.0 * u, min=0.0)))

        return tent(u1) * r, tent(u2) * params.get("ywidth", r), None
    if name == "gaussian":
        r = params.get("xwidth", 2.0)
        ry = params.get("ywidth", r)
        sigma = 1.0 / math.sqrt(2.0 * params.get("alpha", 2.0))
        # truncated gaussian via the inverse CDF of the untruncated one
        dx = torch.clamp(sigma * math.sqrt(2.0) * _erfinv(2.0 * u1 - 1.0), -r, r)
        dy = torch.clamp(sigma * math.sqrt(2.0) * _erfinv(2.0 * u2 - 1.0), -ry, ry)
        return dx, dy, None
    if name in ("mitchell", "sinc", "lanczossinc"):
        r = params.get("xwidth", 2.0 if name == "mitchell" else 4.0)
        ry = params.get("ywidth", r)
        dx = (2.0 * u1 - 1.0) * r
        dy = (2.0 * u2 - 1.0) * ry
        if name == "mitchell":
            b = params.get("B", 1.0 / 3.0)
            c = params.get("C", 1.0 / 3.0)

            def m1d(x, rad):
                x = torch.abs(2.0 * x / rad)
                x3 = x * x * x
                return torch.where(
                    x > 1,
                    ((-b - 6 * c) * x3 + (6 * b + 30 * c) * x * x + (-12 * b - 48 * c) * x + (8 * b + 24 * c)) / 6.0,
                    ((12 - 9 * b - 6 * c) * x3 + (-18 + 12 * b + 6 * c) * x * x + (6 - 2 * b)) / 6.0,
                )

            w = m1d(dx, r) * m1d(dy, ry) * (4.0 * r * ry)
        else:
            tau = params.get("tau", 3.0)

            def sinc1d(x, rad):
                x = torch.abs(x)
                small = x < 1e-5
                px = torch.clamp(math.pi * x, min=1e-9)
                lanczos = torch.where(small, 1.0, torch.sin(math.pi * x / tau) * tau / px)
                sn = torch.where(small, 1.0, torch.sin(math.pi * x) / px)
                return torch.where(x > rad, 0.0, sn * lanczos)

            w = sinc1d(dx, r) * sinc1d(dy, ry) * (4.0 * r * ry)
        return dx, dy, w
    # box, and any other name, as in the reference: uniform in [-r, r]
    r = params.get("xwidth", 0.5)
    ry = params.get("ywidth", r)
    return (2.0 * u1 - 1.0) * r, (2.0 * u2 - 1.0) * ry, None


TIME_DIM = 8117  # the sampler dimension of a ray's shutter time (render._one_sample_wave :153)


def _shutter_fraction(cam, scfg, seed: int, pixel_ids, sample_idx):
    """The shutter time of sample sample_idx of every pixel (camera.rs
    CameraSample::time, sampler dimension TIME_DIM), normalised to the
    TransformTimes range of the motion tables and clamped to [0, 1]."""
    ut = sample_1d(scfg["kind"], seed, pixel_ids, sample_idx, TIME_DIM, scfg["spp"], scfg.get("strata"))
    so, sc = cam["shutter"]
    ts, te = cam["motion_times"]
    return torch.clamp((so + ut * (sc - so) - ts) / max(te - ts, 1e-9), 0.0, 1.0)


def _film_sample(scfg, fcfg, px_base, py_base, pixel_ids, seed: int, sample_idx):
    """The raster position (px, py) of sample sample_idx of every pixel, its
    lens sample (ul1, ul2) and its filter weight (None = 1): film dimension 0
    for the offset, 1 for the lens; the halton and sobol samplers draw both
    from the film enumeration tables in scfg["halton"] / scfg["sobol"]."""
    kind = scfg["kind"]
    spp = scfg["spp"]
    strata = scfg.get("strata")
    if kind == "halton" and scfg.get("halton") is not None:
        # the Halton points of the film (CRT pixel enumeration)
        aux = scfg["halton"]
        u1, u2 = halton_film_jitter(aux, pixel_ids, sample_idx)
        ul1, ul2 = halton_dim_2d(aux, pixel_ids, sample_idx, 1)
    elif kind == "sobol" and scfg.get("sobol") is not None:
        # the global Sobol sequence over the power-of-2 padded film
        aux = scfg["sobol"]
        u1, u2 = sobol_film_jitter(aux, px_base, py_base, sample_idx)
        ul1, ul2 = sobol_dim_2d(aux, px_base, py_base, sample_idx, 1)
    else:
        u1, u2 = sample_2d(kind, seed, pixel_ids, sample_idx, 0, spp, strata)
        ul1, ul2 = sample_2d(kind, seed, pixel_ids, sample_idx, 1, spp, strata)
    dx, dy, w = filter_offset(fcfg["filter"], fcfg["filter_params"], u1, u2)
    px = px_base.to(torch.float32) + 0.5 + dx
    py = py_base.to(torch.float32) + 0.5 + dy
    return px, py, ul1, ul2, w


def make_regen(cam, scfg, fcfg, px_base, py_base, pixel_ids, seed: int, differentials: bool = False):
    """Camera-sample regeneration closure for the persistent wavefront:
    regen(sample_idx (R,)) -> (o, d, w_filter, dd_x, dd_y), using film
    dimension 0 for the pixel offset and dimension 1 for the lens
    (render.make_regen); the halton and sobol samplers draw both from the
    film enumeration tables in scfg["halton"] / scfg["sobol"]. dd_x, dd_y:
    the +1-pixel offset rays' directions when `differentials` (the scene
    has imagemaps), else zeros."""
    def regen(sample_idx):
        px, py, ul1, ul2, w = _film_sample(scfg, fcfg, px_base, py_base, pixel_ids, seed, sample_idx)
        o, d = generate_rays(cam, px, py, ul1, ul2)
        if w is None:
            w = torch.ones(o.shape[0], dtype=torch.float32, device=o.device)
        if differentials:
            return (o, d, w, *ray_differential_dirs(cam, px, py))
        return o, d, w, torch.zeros_like(o), torch.zeros_like(o)

    return regen


def _configs(desc, dev, kind: str, film_tables: bool = True):
    """The route's integrator, sampler and film configurations (icfg, scfg,
    fcfg), the halton and sobol film tables built on `dev` unless
    film_tables is False (the sharded steps', parallel/shard.py)."""
    icfg = {
        "kind": kind,
        "max_depth": max(int(desc.integrator.max_depth), 1),
        "rr_threshold": desc.integrator.rr_threshold,
        "strategy": desc.integrator.strategy,
        "light_strategy": desc.integrator.light_strategy,
    }
    scfg = {"kind": desc.sampler.kind, "spp": int(desc.sampler.pixel_samples)}
    if desc.sampler.kind == "stratified":
        # the declared strata and jitter flag (stratified.rs:121-131)
        scfg["strata"] = (max(int(desc.sampler.x_samples), 1), max(int(desc.sampler.y_samples), 1),
                          bool(desc.sampler.jitter))
    elif film_tables and desc.sampler.kind == "halton":
        scfg["halton"] = halton_tables(desc.film.x_resolution, desc.film.y_resolution, dev)
    elif film_tables and desc.sampler.kind == "sobol":
        scfg["sobol"] = sobol_tables(desc.film.x_resolution, desc.film.y_resolution, int(desc.sampler.pixel_samples))
    fcfg = {
        "filter": desc.film.filter_name,
        "filter_params": dict(desc.film.filter_params),
        "max_sample_luminance": desc.film.max_sample_luminance,
    }
    return icfg, scfg, fcfg


def _route_tables(cs, icfg):
    """The tables a wavefront or wave builds once per render: the spatial
    light distribution, the lobe table and the texture atlases."""
    static = cs.static
    if icfg["light_strategy"] == "spatial" and static.n_lights > 1:
        icfg["spatial_distribution"] = build_spatial_distribution(cs.arrays, static)
    icfg["lobe_table"] = lobe_table(cs.arrays, static)
    if icfg["lobe_table"].get("textured") or static.has_bump:
        icfg["tex_atlases"] = prepare_atlases(cs.arrays, static)


def _joint(static, dev) -> bool:
    return os.environ.get("PBRT_TPU_JOINT", "0") == "1" and dev.type == "cuda" and static.has_wide_tri


def make_persistent_fn(cs: CompiledScene, cam=None):
    """Build the persistent-wave function: (sa, px, py, pids, s0, n_samples,
    seed) -> (accLw, accW, n_vertices), all on the scene's device.

    Sets LAST_PERSISTENT_TIER to the route that will execute. The
    halton and sobol film tables (for the wide megakernel and the
    wavefront) and the wavefront's tables (the spatial light distribution,
    the material lobe table) are built here, once, on the scene's device."""
    global LAST_PERSISTENT_TIER
    desc = cs.description
    dev = cs.arrays.device
    if cam is None:
        cam = make_camera(desc.camera, desc.film, dev)
    icfg, scfg, fcfg = _configs(desc, dev, desc.integrator.kind if desc.integrator.kind == "directlighting"
                                else "path")
    static = cs.static
    mega = not os.environ.get("PBRT_TPU_NO_MEGAKERNEL")
    if mega and static.use_brute_force:
        mk = make_megakernel_fn(cs, cam, icfg, scfg, fcfg)
        if mk is not None:
            LAST_PERSISTENT_TIER = "torch-megakernel/" + ("cuda-brute" if dev.type == "cuda" else "plain-brute")
            return mk
    if mega and os.environ.get("PBRT_TPU_WIDEMEGA", "") == "1" and icfg["kind"] == "path" and static.has_wide_tri:
        max_tris = int(os.environ.get("PBRT_TPU_WIDEMEGA_MAX_TRIS", str(DEFAULT_MAX_TRIS)))
        mkw = make_wide_megakernel_fn(cs, cam, icfg, scfg, fcfg, max_tris)
        if mkw is not None:
            LAST_PERSISTENT_TIER = "torch-megakernel/" + ("cuda-wide" if dev.type == "cuda" else "plain-wide")
            return mkw
    joint = _joint(static, dev)
    _route_tables(cs, icfg)
    differentials = has_imagemaps(static)
    LAST_PERSISTENT_TIER = f"torch-wavefront/{'cuda' if dev.type == 'cuda' else 'plain'}-{route_name(static, joint)}"

    def wave_p(sa, px, py, pixel_ids, s0: int, n_samples: int, seed: int):
        regen = make_regen(cam, scfg, fcfg, px, py, pixel_ids, seed, differentials)
        return trace_persistent(sa, static, icfg, scfg, seed, pixel_ids, s0, n_samples, regen,
                                max_sample_luminance=float(fcfg["max_sample_luminance"]), joint=joint)

    return wave_p


def camera_animated(cfg) -> bool:
    """The camera's transform moves over the shutter (make_camera builds
    its "anim")."""
    return cfg.camera_to_world_end is not None and AnimatedTransform(cfg.camera_to_world,
                                                                     cfg.camera_to_world_end).actually_animated


def persistent_eligible(desc, static) -> bool:
    """The persistent routes' class (render.persistent_eligible :235-249):
    path or directlighting without moving prims, an animated or a realistic
    camera, media, subsurface or interface materials; every other scene
    takes the per-sample wave."""
    return (desc.integrator.kind in ("path", "directlighting") and not static.has_motion
            and desc.camera.kind != "realistic" and not camera_animated(desc.camera) and static.n_media == 0
            and not static.has_sss_media and not static.has_tab_sss and not static.has_null_material)


def scene_camera(desc, dev):
    """make_camera with the scene's TransformTimes range as "motion_times"
    (the shutter times' normalisation, render.make_wave_fn :461)."""
    cam = make_camera(desc.camera, desc.film, dev)
    cam["motion_times"] = (float(desc.transform_start_time), float(desc.transform_end_time))
    return cam


def make_wave_fn(cs: CompiledScene, cam=None, cfgs=None):
    """Build the per-sample wave: (sa, px, py, pixel_ids, sample_idx, seed)
    -> (L w (R, 3), w (R,), n_vertices (R,)) for one sample of every pixel
    given (render._one_sample_wave): the camera ray from film dimensions 0
    and 1 (_film_sample), at the shutter time of dimension TIME_DIM when the
    camera or the scene moves (the shutter interval mapped onto the
    TransformTimes range), through a realistic camera's lens with its
    vignetting weight on L; trace_wave, the NaN and negative clamps
    (integrator.rs:350-368) and max_sample_luminance, weighted by the
    filter's sample weight. Sets LAST_WAVE_TIER; the spatial light
    distribution and the lobe table are built here, once. cfgs: the
    route's (icfg, scfg, fcfg) in place of the scene's own (the sharded
    step's, parallel/shard.py), its tables built by the caller."""
    global LAST_WAVE_TIER
    desc = cs.description
    dev = cs.arrays.device
    if cam is None:
        cam = scene_camera(desc, dev)
    static = cs.static
    if cfgs is None:
        icfg, scfg, fcfg = _configs(desc, dev, desc.integrator.kind)
        icfg["n_samples"] = desc.integrator.n_samples
        icfg["cos_sample"] = desc.integrator.cos_sample
        _route_tables(cs, icfg)
    else:
        icfg, scfg, fcfg = cfgs
    joint = _joint(static, dev)
    differentials = has_imagemaps(static)
    max_lum = float(fcfg["max_sample_luminance"])
    LAST_WAVE_TIER = f"torch-wave/{route_name(static, joint)}"

    timed = cam.get("anim") is not None or static.has_motion

    def wave(sa, px, py, pixel_ids, sample_idx: int, seed: int):
        sidx = torch.full(pixel_ids.shape, int(sample_idx), dtype=torch.int64, device=pixel_ids.device)
        pxf, pyf, ul1, ul2, w = _film_sample(scfg, fcfg, px, py, pixel_ids, seed, sidx)
        time_frac = _shutter_fraction(cam, scfg, seed, pixel_ids, sidx) if timed else None
        ray_w = None
        if cam.get("realistic") is not None:
            o, d, ray_w = realistic_generate_rays(cam, cam["realistic"], pxf, pyf, ul1, ul2)
        else:
            o, d = generate_rays(cam, pxf, pyf, ul1, ul2, time_frac)
        diff = ray_differential_dirs(cam, pxf, pyf) if differentials else None
        L, nv = trace_wave(sa, static, icfg, scfg, seed, o, d, pixel_ids, sidx, diff, joint=joint, time=time_frac)
        L = torch.clamp(torch.where(torch.isfinite(L), L, 0.0), min=0.0)
        if max_lum < float("inf"):
            y = L[:, 0] * 0.212671 + L[:, 1] * 0.715160 + L[:, 2] * 0.072169
            L = L * torch.where(y > max_lum, max_lum / torch.clamp(y, min=1e-12), 1.0)[:, None]
        if w is None:
            w = torch.ones(L.shape[0], dtype=torch.float32, device=L.device)
        if ray_w is not None:
            # the lens's vignetting weight weighs the sample, not the filter
            L = L * ray_w[:, None]
        return L * w[:, None], w, nv

    return wave


def render(desc: SceneDescription, seed: int = 0, spp: int | None = None, progress=None, device="cuda", **kw):
    """Render a scene description to an (H, W, 3) float32 numpy image."""
    return render_compiled(compile_scene(desc, device), seed=seed, spp=spp, progress=progress, **kw)


# integrator kinds whose reference create() accepts "pixelbounds"
_PIXELBOUNDS_KINDS = frozenset({"ao", "bdpt", "directlighting", "path", "volpath", "whitted"})


def film_pixel_bounds(desc) -> tuple[int, int, int, int]:
    """(x0, x1, y0, y1) camera pixel bounds: the film's crop-window bounds
    (film.rs create_film :385-393) intersected with the integrator's
    "pixelbounds"; degenerate intersections fall back to the crop bounds."""
    W = desc.film.x_resolution
    H = desc.film.y_resolution
    cx0, cx1, cy0, cy1 = desc.film.crop_window
    x0 = int(math.ceil(W * cx0))
    x1 = max(int(math.ceil(W * cx1)), x0 + 1)
    y0 = int(math.ceil(H * cy0))
    y1 = max(int(math.ceil(H * cy1)), y0 + 1)
    pb = getattr(desc.integrator, "pixel_bounds", None)
    if pb is not None and len(pb) == 4 and desc.integrator.kind in _PIXELBOUNDS_KINDS:
        nx0 = max(x0, int(pb[0]))
        nx1 = min(x1, int(pb[1]))
        ny0 = max(y0, int(pb[2]))
        ny1 = min(y1, int(pb[3]))
        if nx1 > nx0 and ny1 > ny0:
            return nx0, nx1, ny0, ny1
        log.error("degenerate \"pixelbounds\" %s ignored", tuple(pb))
    return x0, x1, y0, y1


def _load_checkpoint(path, spp, seed, acc, wacc):
    """(acc, wacc, next sample) from a checkpoint that matches this render
    (spp, film shape and seed), else None (render.py :742-753)."""
    try:
        ck = np.load(path)
        if int(ck["spp_total"]) == spp and ck["acc"].shape == tuple(acc.shape) and int(ck["seed"]) == seed:
            log.info("resumed checkpoint at sample %d/%d", int(ck["next_sample"]), spp)
            return (torch.as_tensor(ck["acc"], device=acc.device), torch.as_tensor(ck["wacc"], device=acc.device),
                    int(ck["next_sample"]))
        log.warning("checkpoint %s does not match this render; ignoring", path)
    except Exception as e:  # a corrupt snapshot: start over
        log.warning("checkpoint unreadable (%s); starting fresh", e)
    return None


def _write_checkpoint(path, acc, wacc, next_sample, spp, seed):
    """The film's accumulators as the reference writes them: an .npz of
    acc (R, 3) and wacc (R,) float64, next_sample, spp_total and seed,
    written beside the target and moved over it."""
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as fh:
        np.savez(fh, acc=acc.cpu().numpy(), wacc=wacc.cpu().numpy(), next_sample=next_sample, spp_total=spp, seed=seed)
    os.replace(tmp, path)


def _render_sharded(cs: CompiledScene, devices, seed: int, spp: int | None):
    """render_compiled's multi-device branch (reference :574-625): the
    integrator's sharded step over devices (parallel/shard.py); MLT with
    n_chains = max(n_chains, devices), n_mut = mutations per pixel x pixels
    // (n_chains (max_depth + 1)) clipped to 1-8192, each depth's film
    summed; SPPM with max(photons per iteration, 1) photons. The film
    scale applies; records ``render_compiled.last_timing`` {"wall_s",
    "n_vertices" (the path family's, else None), "tier": "torch-shard<n>/"
    + the query's route, "shards"}."""
    from .parallel import shard

    desc = cs.description
    ic = desc.integrator
    W, H = desc.film.x_resolution, desc.film.y_resolution
    n_vertices = None
    t0 = time.perf_counter()
    if ic.kind == "sppm":
        img = shard.render_sppm_sharded_step(cs, desc, devices, seed=seed, n_iters=max(int(ic.num_iterations), 1),
                                             n_photons=max(int(ic.photons_per_iteration), 1))
    elif ic.kind == "bdpt":
        img = shard.render_bdpt_sharded_step(cs, desc, devices, seed=seed,
                                             spp=int(spp if spp is not None else desc.sampler.pixel_samples))
    elif ic.kind == "mlt":
        max_depth = max(int(ic.max_depth), 1)
        n_chains = max(int(ic.n_chains), len(devices))
        n_mut = int(np.clip((max(int(ic.mutations_per_pixel), 1) * W * H) // (n_chains * (max_depth + 1)), 1, 8192))
        img = np.zeros((W * H, 3), np.float32)
        for depth in range(max_depth + 1):
            img = img + shard.render_mlt_sharded_step(cs, desc, devices, seed=seed, depth=depth, n_chains=n_chains,
                                                      n_mut=n_mut)
    else:
        img = shard.render_sharded_step(cs, desc, devices, spp=spp, seed=seed)
        n_vertices = shard.render_sharded_step.last_timing["n_vertices"]
    wall = time.perf_counter() - t0  # the steps end with their images on the host
    route = route_name(cs.static, _joint(cs.static, torch.device(devices[0])))
    render_compiled.last_timing = {"wall_s": wall, "n_vertices": n_vertices, "shards": len(devices),
                                   "tier": f"torch-shard{len(devices)}/{route}"}
    log.info("sharded %s render over %d devices in %.2fs", ic.kind, len(devices), wall)
    return img.reshape(H, W, 3) * desc.film.scale


def render_compiled(cs: CompiledScene, seed: int = 0, spp: int | None = None, progress=None,
                    checkpoint_path: str | None = None, checkpoint_every: int = 0, devices=None):
    """Render a compiled scene on its device; returns the (H, W, 3) float32
    image and records ``render_compiled.last_timing`` = {"wall_s",
    "n_vertices", "tier"} (wall time ends after a device synchronize).
    devices: a list of torch devices, in which a device may repeat, to
    split the whole film over (``_render_sharded``, parallel/shard.py: the
    reference's sharded steps, which take no megakernel, no film tables
    and no progress); None renders on the scene's device. The port never
    chooses it by itself, where the reference shards whenever it sees
    several devices: on one card two shards take longer than one.
    progress(done_spp, spp), when given, is called after each spp chunk (the
    wave: after each sample); the reference's counters (camera rays, path
    vertices, path length, scene bytes) go to utils.stats.STATS.
    checkpoint_path: the wave writes the film's accumulators there every
    checkpoint_every samples, and resumes from a matching one (spp, film
    shape and seed); asking for a checkpoint sends any scene to the wave,
    as in the reference."""
    desc = cs.description
    dev = cs.arrays.device
    kind = desc.integrator.kind
    if devices is not None:
        # the reference's branch checks the crop window, not "pixelbounds"; so does this
        if checkpoint_path is not None or tuple(desc.film.crop_window or (0.0, 1.0, 0.0, 1.0)) != (0.0, 1.0, 0.0, 1.0):
            raise ValueError("a sharded render takes the whole film and no checkpoint")
        return _render_sharded(cs, devices, seed, spp)
    if kind in ("sppm", "bdpt", "mlt"):
        # sppm, bdpt and mlt have host loops of their own (reference
        # render_compiled :629-640); sppm and mlt render the whole film
        from .device import bdpt, mlt, sppm

        render_fn = {"sppm": sppm.render_sppm, "bdpt": bdpt.render_bdpt, "mlt": mlt.render_mlt}[kind]
        kw = {"spp": spp} if kind == "bdpt" else {}
        t0 = time.perf_counter()
        img = render_fn(cs, seed=seed, progress=progress, **kw) * desc.film.scale  # on the host: the device is done
        render_compiled.last_timing = dict(render_fn.last_timing, wall_s=time.perf_counter() - t0,
                                           tier=f"torch-{kind}/" + route_name(cs.static))
        return img
    W = desc.film.x_resolution
    H = desc.film.y_resolution
    spp = int(spp if spp is not None else desc.sampler.pixel_samples)
    x0, x1, y0, y1 = film_pixel_bounds(desc)
    ww = x1 - x0
    wh = y1 - y0
    ys, xs = np.mgrid[y0:y1, x0:x1]
    px = torch.as_tensor(xs.ravel().astype(np.int64), device=dev)
    py = torch.as_tensor(ys.ravel().astype(np.int64), device=dev)
    pixel_ids = torch.as_tensor((ys * W + xs).ravel().astype(np.int64), device=dev)

    acc = torch.zeros((ww * wh, 3), dtype=torch.float64, device=dev)
    wacc = torch.zeros(ww * wh, dtype=torch.float64, device=dev)
    n_vertices = torch.zeros((), dtype=torch.float64, device=dev)
    if (persistent_eligible(desc, cs.static) and checkpoint_path is None
            and not os.environ.get("PBRT_TPU_FORCE_WAVE")):
        wave_p = make_persistent_fn(cs)
        tier = LAST_PERSISTENT_TIER
        # the megakernel takes every sample of the render in one launch
        chunk = spp if tier.startswith("torch-megakernel") else PERSISTENT_SPP_CHUNK
        t0 = time.perf_counter()
        for s in range(0, spp, chunk):
            n_s = min(chunk, spp - s)
            Lw, w, nv = wave_p(cs.arrays, px, py, pixel_ids, s, n_s, seed)
            acc += Lw.to(torch.float64)
            wacc += w.to(torch.float64)
            n_vertices += nv.to(torch.float64).sum()
            if progress:
                progress(s + n_s, spp)
    else:
        wave = make_wave_fn(cs)
        tier = LAST_WAVE_TIER
        R = ww * wh
        n_chunks = max(1, math.ceil(R / MAX_RAYS_PER_PASS))
        chunk = math.ceil(R / n_chunks)
        s_start = 0
        if checkpoint_path and os.path.exists(checkpoint_path):
            resumed = _load_checkpoint(checkpoint_path, spp, seed, acc, wacc)
            if resumed is not None:
                acc, wacc, s_start = resumed
        t0 = time.perf_counter()
        for s in range(s_start, spp):
            for c in range(n_chunks):
                sl = slice(c * chunk, min((c + 1) * chunk, R))
                Lw, w, nv = wave(cs.arrays, px[sl], py[sl], pixel_ids[sl], s, seed)
                acc[sl] += Lw.to(torch.float64)
                wacc[sl] += w.to(torch.float64)
                n_vertices += nv.to(torch.float64).sum()
            if checkpoint_path and checkpoint_every and (s + 1) % checkpoint_every == 0:
                _write_checkpoint(checkpoint_path, acc, wacc, s + 1, spp, seed)
            if progress:
                progress(s + 1, spp)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    nv_total = float(n_vertices)
    log.info("rendered %dx%d @ %dspp (%s) in %.2fs (%.2f Mverts/s)",
             ww, wh, spp, tier, dt, nv_total / max(dt, 1e-9) / 1e6)
    render_compiled.last_timing = {"wall_s": dt, "n_vertices": nv_total, "tier": tier}
    n_camera = ww * wh * spp
    STATS.counter("Integrator/Camera rays traced", n_camera)
    STATS.counter("Integrator/Path vertices", int(nv_total))
    STATS.distribution("Integrator/Path length", nv_total / max(n_camera, 1), n_camera)
    STATS.memory_counter("Memory/Scene arrays", scene_byte_size(cs.arrays))
    img_crop = (acc / torch.clamp(wacc, min=1e-9)[:, None]).reshape(wh, ww, 3).to(torch.float32).cpu().numpy()
    img_crop *= desc.film.scale
    if (ww, wh) == (W, H):
        return img_crop
    img = np.zeros((H, W, 3), np.float32)
    img[y0:y1, x0:x1] = img_crop
    return img


render_compiled.last_timing = None
