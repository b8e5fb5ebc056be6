"""Multi-device rendering: one image over a list of devices.

The port's counterpart of ``pbrt_tpu/parallel/shard.py``, whose
``shard_map`` steps split the pixel axis over a device mesh. Here one
controller stands for the mesh:

- the shards: a list of torch devices, in which a device may repeat
  (``["cpu", "cpu"]``, or two shards on one card). Shard i takes the i-th
  contiguous slice of the pixel axis padded to a multiple of the shard
  count; the padding lanes repeat pixel 0 (``_pixel_arrays``);
- the scene: copied once to each distinct device (``CompiledScene.to``),
  and what a route builds once (the camera, the lobe table, the lights'
  power CDF) is built there before any shard runs;
- the collectives: the reference's all_gather is every shard's tensor
  moved to one device and concatenated in shard order, its psum a sum in
  shard order, so the result never depends on which shard finished first;
- the threads: one per shard, also where devices repeat (``_Shards.run``).
  A CUDA shard's thread makes its device current and issues its work on
  a stream of its own, which first waits for the controller's stream and
  is synchronized before the thread ends; SPPM's passes are separate runs,
  the gather between them. An exception in a shard is raised again in the
  caller; no shard carries on elsewhere.

The four steps keep the reference's sharded estimators, quirks included
(ROADMAP "Known faults in the reference"): their configurations carry no
halton or sobol film tables, so those samplers' film and lens dimensions
come from the hashed sampler; the wave's shutter times are normalised to
(0, 1), not to the scene's TransformTimes; the path family never takes a
megakernel; SPPM's camera pass takes the iteration's seed (seed + 9781
it) and each shard's photons the seed xor (shard x 0x9E3779B1); MLT draws
a bootstrap of max(4 chains, 256) samples from RandomState(seed + 17) for
each depth. The one difference: SPPM zeroes a visible point's non-finite
throughput, as the single-device render does, where the reference's
sharded step would carry it into the image.
"""
from __future__ import annotations

import logging
import threading

import numpy as np
import torch

from ..device import mlt as dmlt
from ..device import rng
from ..device import sppm as dsppm
from ..device.bdpt import _Ctx, _splat, bdpt_wave
from ..device.camera import make_camera
from ..device.integrator import trace_persistent
from ..device.lights import compute_power
from ..device.texture import has_imagemaps
from ..render import _configs as _route_configs
from ..render import _joint, _route_tables, make_regen, make_wave_fn, persistent_eligible

log = logging.getLogger(__name__)

PHOTON_SEED_MUL = 0x9E3779B1  # a shard's photon seed: the iteration's xor (shard index x this), uint32


def _round_up(x, m):
    return (x + m - 1) // m * m


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class _Shards:
    """The shard list: each shard's device, one copy of the scene per
    distinct device, and each CUDA shard's stream."""

    def __init__(self, cs, devices):
        self.devices = [_device(d) for d in devices]
        if not self.devices:
            raise ValueError("a sharded render needs at least one device")
        self.n = len(self.devices)
        self.scenes = {}
        for d in self.devices:
            if d not in self.scenes:
                self.scenes[d] = cs.to(d)
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None for d in self.devices]

    def scene(self, i):
        return self.scenes[self.devices[i]]

    def lanes(self, i, *arrays):
        """Shard i's slice of each host array, as tensors on its device."""
        n_loc = arrays[0].shape[0] // self.n
        return [torch.as_tensor(a[i * n_loc:(i + 1) * n_loc], device=self.devices[i]) for a in arrays]

    def run(self, fn) -> list:
        """fn(i) for every shard i, each in a thread of its own; returns the
        results in shard order, each complete on its device; raises the
        first failed shard's exception."""
        for d, s in zip(self.devices, self.streams):
            if s is not None:  # after what the controller queued (inputs, freed blocks)
                s.wait_stream(torch.cuda.current_stream(d))
        out = [None] * self.n
        errors = [None] * self.n

        def work(i):
            try:
                stream = self.streams[i]
                if stream is None:
                    out[i] = fn(i)
                    return
                with torch.cuda.device(self.devices[i]), torch.cuda.stream(stream):
                    out[i] = fn(i)
                stream.synchronize()
            except Exception as e:  # raised again in the caller, below
                errors[i] = e

        threads = [threading.Thread(target=work, args=(i,), name=f"shard-{i}") for i in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, e in enumerate(errors):
            if e is not None:
                raise RuntimeError(f"shard {i} of {self.n} ({self.devices[i]}) failed: {e}") from e
        return out


def _gather(parts) -> torch.Tensor:
    """The shards' tensors concatenated in shard order, on the host."""
    return torch.cat([p.cpu() for p in parts])


def _psum(parts) -> torch.Tensor:
    """The shards' tensors summed in shard order, on the host."""
    total = parts[0].cpu().clone()
    for p in parts[1:]:
        total += p.cpu()
    return total


def _configs(cs, desc, spp):
    """The sharded step's (icfg, scfg, fcfg) (reference :41-63): the
    route's, without the halton and sobol film tables, at spp samples; the
    route's tables built on cs's device."""
    icfg, scfg, fcfg = _route_configs(desc, cs.arrays.device, desc.integrator.kind, film_tables=False)
    icfg["n_samples"] = desc.integrator.n_samples
    icfg["cos_sample"] = desc.integrator.cos_sample
    scfg["spp"] = spp
    _route_tables(cs, icfg)
    return icfg, scfg, fcfg


def _pixel_arrays(W, H, n):
    """(px, py, pids, R, Rp): every pixel's coordinates and id, padded to
    Rp, a multiple of n, with pixel 0 (reference :66-76)."""
    R = W * H
    Rp = _round_up(R, n)
    ys, xs = np.mgrid[0:H, 0:W]
    px = np.zeros(Rp, np.int64)
    py = np.zeros(Rp, np.int64)
    pids = np.zeros(Rp, np.int64)
    px[:R] = xs.ravel()
    py[:R] = ys.ravel()
    pids[:R] = (ys * W + xs).ravel()
    return px, py, pids, R, Rp


def _light_cdf_and_ctx(cs):
    """The lights' power CDF and the walks' shared tables (bdpt._Ctx) on
    cs's device (reference :136-147)."""
    cdf = torch.cumsum(compute_power(cs.arrays, cs.static), 0)
    return cdf / torch.clamp(cdf[-1], min=1e-12), _Ctx(cs.arrays, cs.static)


def render_sharded_step(cs, desc, devices, spp: int | None = None, seed: int = 0) -> np.ndarray:
    """One full render of every pixel at spp samples over the shards
    (reference :79-133): a scene of render.persistent_eligible's class
    through the persistent wavefront (integrator.trace_persistent, all spp
    in one call), any other through the per-sample wave
    (render.make_wave_fn), each shard on its pixel slice. Returns the (H W,
    3) float32 image, Lsum / max(wsum, 1e-9); records
    ``render_sharded_step.last_timing`` {"n_vertices"} (the real lanes')."""
    shards = _Shards(cs, devices)
    n = shards.n
    W, H = desc.film.x_resolution, desc.film.y_resolution
    spp = int(spp if spp is not None else desc.sampler.pixel_samples)
    static = cs.static
    px, py, pids, R, Rp = _pixel_arrays(W, H, n)
    n_loc = Rp // n
    persistent = persistent_eligible(desc, static)
    differentials = has_imagemaps(static)
    route = {}
    for dev, cs_d in shards.scenes.items():
        cam = make_camera(desc.camera, desc.film, dev)
        cam["motion_times"] = (0.0, 1.0)
        cfgs = _configs(cs_d, desc, spp)
        route[dev] = (cam, cfgs) if persistent else make_wave_fn(cs_d, cam, cfgs)

    def shard(i):
        dev = shards.devices[i]
        sa = shards.scene(i).arrays
        px_l, py_l, pids_l = shards.lanes(i, px, py, pids)
        joint = _joint(static, dev)
        if persistent:
            cam, (icfg, scfg, fcfg) = route[dev]
            regen = make_regen(cam, scfg, fcfg, px_l, py_l, pids_l, seed, differentials)
            Lsum, wsum, nv = trace_persistent(sa, static, icfg, scfg, seed, pids_l, 0, spp, regen,
                                              max_sample_luminance=float(fcfg["max_sample_luminance"]), joint=joint)
        else:
            Lsum = torch.zeros((n_loc, 3), device=dev)
            wsum = torch.zeros(n_loc, device=dev)
            nv = torch.zeros(n_loc, device=dev)
            for s in range(spp):
                Lw, w, nv_s = route[dev](sa, px_l, py_l, pids_l, s, seed)
                Lsum, wsum, nv = Lsum + Lw, wsum + w, nv + nv_s
        real = max(min(R - i * n_loc, n_loc), 0)
        return Lsum / torch.clamp(wsum, min=1e-9)[:, None], nv[:real].to(torch.float64).sum()

    outs = shards.run(shard)
    render_sharded_step.last_timing = {"n_vertices": float(sum(float(o[1]) for o in outs))}
    return _gather([o[0] for o in outs])[:R].numpy()


render_sharded_step.last_timing = None


def render_bdpt_sharded_step(cs, desc, devices, spp: int = 1, seed: int = 0) -> np.ndarray:
    """BDPT over the shards (reference :245-303): every strategy of each
    shard's pixel slice (device/bdpt.bdpt_wave), its L at its pixels and
    its t = 1 splats wherever they land, in a float64 film of its own
    (index_add_, as render_bdpt's); the films summed. A padding lane's L
    and splats go to the film's spare row: it repeats pixel 0, whose light
    subpath would be counted again. Returns the (H W, 3) float32 image."""
    shards = _Shards(cs, devices)
    n = shards.n
    W, H = desc.film.x_resolution, desc.film.y_resolution
    n_pix = W * H
    max_depth = max(int(desc.integrator.max_depth), 1)
    px, py, pids, R, Rp = _pixel_arrays(W, H, n)
    n_loc = Rp // n
    per_dev = {dev: (make_camera(desc.camera, desc.film, dev), *_light_cdf_and_ctx(cs_d))
               for dev, cs_d in shards.scenes.items()}

    def shard(i):
        dev = shards.devices[i]
        cs_d = shards.scene(i)
        cam, cdf, ctx = per_dev[dev]
        px_l, py_l, pids_l = shards.lanes(i, px, py, pids)
        valid = torch.arange(i * n_loc, (i + 1) * n_loc, device=dev) < R
        film = torch.zeros((n_pix + 1, 3), dtype=torch.float64, device=dev)
        for s in range(spp):
            L, spx, sval = bdpt_wave(cs_d.arrays, cs_d.static, ctx, cam, cdf, seed, px_l, py_l, pids_l, s, max_depth,
                                     W, H)
            # the splats come in blocks of n_loc lanes, one block per t = 1 strategy
            _splat(film, torch.where(valid.repeat(spx.shape[0] // n_loc), spx, n_pix), sval)
            _splat(film, torch.where(valid, pids_l, n_pix), L)
        return film

    film = _psum(shards.run(shard))
    return (film[:n_pix] / max(spp, 1)).to(torch.float32).numpy()


def render_mlt_sharded_step(cs, desc, devices, seed: int = 0, depth: int = 1, n_chains: int | None = None,
                            n_mut: int = 2, n_boot: int | None = None) -> np.ndarray:
    """MLT at one path depth over the shards (reference :306-370): the
    bootstrap's rows from RandomState(seed + 17) split over the shards,
    b_d the mean of all their luminances, the chains picked by numpy over
    all of them; shard i runs chains i n_c / n .. with their global ids, n_mut
    steps of keys seed 7919 + depth 104729 + m (device/mlt.mlt_block), its
    splats in a float64 film of its own; the films summed and scaled by
    b_d n_pix / (n_mut n_chains). Returns the depth's (H W, 3) float32 film;
    records ``render_mlt_sharded_step.last_timing`` {"b", "mutations",
    "accepted"}."""
    shards = _Shards(cs, devices)
    n = shards.n
    W, H = desc.film.x_resolution, desc.film.y_resolution
    n_pix = W * H
    sigma = float(getattr(desc.integrator, "sigma", 0.0)) or dmlt.SIGMA
    p_large = float(getattr(desc.integrator, "large_step_probability", 0.0)) or dmlt.P_LARGE
    n_chains = _round_up(int(n_chains or max(getattr(desc.integrator, "n_chains", 64), n)), n)
    n_boot = _round_up(int(n_boot or max(n_chains * 4, 256)), n)
    per_dev = {dev: (make_camera(desc.camera, desc.film, dev), *_light_cdf_and_ctx(cs_d))
               for dev, cs_d in shards.scenes.items()}
    rstate = np.random.RandomState(seed + 17)
    u_boot = rstate.rand(n_boot, dmlt.DIMS).astype(np.float32)

    def args(i):
        cs_d = shards.scene(i)
        cam, cdf, ctx = per_dev[shards.devices[i]]
        return cs_d.arrays, cs_d.static, ctx, cam, cdf

    def boot(i):
        (u,) = shards.lanes(i, u_boot)
        return torch.as_tensor(dmlt._bootstrap(*args(i), u, depth, W, H))

    lum = _gather(shards.run(boot)).numpy()
    b_d = lum.mean()
    render_mlt_sharded_step.last_timing = {"b": float(b_d), "mutations": 0, "accepted": 0}
    if b_d <= 0:
        return np.zeros((n_pix, 3), np.float32)
    # the global bootstrap selection (mlt.rs's Distribution1D over every sample)
    u_sel = u_boot[rstate.choice(n_boot, size=n_chains, p=lum / lum.sum())]
    ids = np.arange(n_chains, dtype=np.int64)

    def chains(i):
        u, chain_ids = shards.lanes(i, u_sel, ids)
        cur = dmlt._l_fn(*args(i), u, depth, W, H)
        film = torch.zeros((n_pix + 1, 3), dtype=torch.float64, device=u.device)
        accepted = torch.zeros((), dtype=torch.int64, device=u.device)
        dmlt.mlt_block(*args(i), depth, W, H, sigma, p_large, chain_ids, u, cur, seed * 7919 + depth * 104729, 0,
                       n_mut, film, accepted)
        return film, accepted

    outs = shards.run(chains)
    film = _psum([o[0] for o in outs])
    render_mlt_sharded_step.last_timing = {"b": float(b_d), "mutations": n_mut * n_chains,
                                           "accepted": int(sum(int(o[1]) for o in outs))}
    return (film[:n_pix] * (b_d * n_pix / max(n_mut * n_chains, 1))).to(torch.float32).numpy()


render_mlt_sharded_step.last_timing = None


class _NoSplit:
    """The photon pass's phase timer, off: its laps would synchronize the
    whole device from one shard's thread."""

    def lap(self, name):
        pass


def render_sppm_sharded_step(cs, desc, devices, n_iters: int = 1, seed: int = 0,
                             n_photons: int | None = None) -> np.ndarray:
    """SPPM iterations over the shards (reference :150-242). Per iteration:
    the camera pass on each shard's pixel slice (seed + 9781 it); the
    visible points and radii gathered in shard order onto every device,
    which builds the grid from all of them (cell size from the largest
    valid radius, in float32 as the reference's); shard i traces photons 0
    .. P / n - 1 under the seed xor (i x 0x9E3779B1) and deposits them on
    every visible point (float64, device/sppm._deposit); phi and the counts
    summed in shard order; the radius and tau update on each shard's slice.
    P is n_photons (default: the padded pixel count) rounded up to a
    multiple of the shard count. Returns the (H W, 3) float32 image,
    Ld / iterations + tau / (iterations P pi r^2); records
    ``render_sppm_sharded_step.last_timing`` {"photons", "dropped"}."""
    shards = _Shards(cs, devices)
    n = shards.n
    W, H = desc.film.x_resolution, desc.film.y_resolution
    max_depth = max(int(desc.integrator.max_depth), 1)
    spp = max(n_iters, 1)
    px, py, pids, R, Rp = _pixel_arrays(W, H, n)
    n_loc = Rp // n
    P_ph = _round_up(int(n_photons if n_photons is not None else Rp), n)
    P_loc = P_ph // n
    wr = float(cs.arrays.world_radius)
    per_dev = {}
    for dev, cs_d in shards.scenes.items():
        sa = cs_d.arrays
        per_dev[dev] = (make_camera(desc.camera, desc.film, dev), *_light_cdf_and_ctx(cs_d),
                        sa.world_center - sa.world_radius)
    r0 = float(desc.integrator.initial_radius)
    f32 = torch.float32
    radius = [torch.full((n_loc,), r0, dtype=f32, device=d) for d in shards.devices]
    n_eff = [torch.zeros(n_loc, dtype=f32, device=d) for d in shards.devices]
    tau = [torch.zeros((n_loc, 3), dtype=f32, device=d) for d in shards.devices]
    ld = [torch.zeros((n_loc, 3), dtype=f32, device=d) for d in shards.devices]
    dropped = 0

    for it in range(n_iters):
        seed_it = (seed + it * 9781) & rng.MASK32

        def camera(i):
            cs_d = shards.scene(i)
            cam, _cdf, ctx, _gm = per_dev[shards.devices[i]]
            px_l, py_l, pids_l = shards.lanes(i, px, py, pids)
            ld_a, vp = dsppm._camera_pass(cs_d.arrays, cs_d.static, ctx, cam, max_depth, seed_it, px_l, py_l, pids_l,
                                          it, spp)
            vp["beta"] = torch.where(torch.isfinite(vp["beta"]), vp["beta"], 0.0)
            return ld_a, vp

        cams = shards.run(camera)
        vps = [c[1] for c in cams]
        # the all_gather: every shard's visible points and radii, in shard order, on every device
        vp_all = {d: {k: torch.cat([vp[k].to(d) for vp in vps]) for k in vps[0]} for d in shards.scenes}
        r_all = {d: torch.cat([r.to(d) for r in radius]) for d in shards.scenes}
        max_r = max(float(torch.where(vp["valid"], r, 0.0).max()) for vp, r in zip(vps, radius))
        inv_cell = dsppm.grid_inv_cell(max_r, wr, in_float32=True)

        def photons(i):
            dev = shards.devices[i]
            cs_d = shards.scene(i)
            _cam, cdf, ctx, grid_min = per_dev[dev]
            vp, r = vp_all[dev], r_all[dev]
            sc, sv = dsppm._build_grid(vp, r, grid_min, inv_cell)
            phi = torch.zeros((Rp + 1, 3), dtype=torch.float64, device=dev)
            m_cnt = torch.zeros(Rp + 1, dtype=torch.float64, device=dev)
            stats = {"dropped": torch.zeros((), dtype=torch.int64, device=dev),
                     "max_run": torch.zeros((), dtype=torch.int64, device=dev), "pairs": 0}
            ph_seed = (seed_it ^ (i * PHOTON_SEED_MUL)) & rng.MASK32
            for p0 in range(0, P_loc, dsppm.PHOTON_PASS):
                dsppm._photon_pass(cs_d.arrays, cs_d.static, ctx, max_depth, ph_seed, it, p0,
                                   min(dsppm.PHOTON_PASS, P_loc - p0), cdf, vp, r, sc, sv, grid_min, inv_cell, phi,
                                   m_cnt, stats, _NoSplit())
            return phi, m_cnt, int(stats["dropped"])

        outs = shards.run(photons)
        # the psum: phi and the counts summed in shard order; each shard keeps its slice
        phi = _psum([o[0] for o in outs])[:Rp].to(f32)
        m_all = _psum([o[1] for o in outs])[:Rp].to(f32)
        dropped += sum(o[2] for o in outs)
        for i, dev in enumerate(shards.devices):
            ld_a, vp = cams[i]
            ld[i] = ld[i] + torch.where(torch.isfinite(ld_a), ld_a, 0.0)
            sl = slice(i * n_loc, (i + 1) * n_loc)
            radius[i], n_eff[i], tau[i] = dsppm.update_points(radius[i], n_eff[i], tau[i], vp["beta"], phi[sl].to(dev),
                                                              m_all[sl].to(dev))
    if dropped > 0:
        log.warning("sharded sppm: %d photon-VP pairs dropped by the %d-entry scan cap", dropped,
                    dsppm.KMAX * dsppm.N_CHUNKS)
    img = [dsppm.sppm_image(ld[i], tau[i], radius[i], spp, P_ph) for i in range(n)]
    render_sppm_sharded_step.last_timing = {"photons": n_iters * P_ph, "dropped": dropped}
    return _gather(img)[:R].numpy()


render_sppm_sharded_step.last_timing = None
