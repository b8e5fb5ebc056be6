"""Tracking through grid media: the hand-written CUDA kernel and its plain
PyTorch twin.

The reference tracks grid (heterogeneous) media in XLA
(``pbrt_tpu/device/media.py medium_sample`` :183-223, delta tracking for the
distance to a real collision, and ``medium_tr`` :248-282, ratio tracking for
the transmittance): a ``lax.while_loop`` of at most MAX_TRACKING_STEPS = 256
steps over every lane until the last lane ends. In eager PyTorch that is a
host sync and some thirty launches per step, once per bounce for the
distance and up to MAX_NULL_CROSSINGS times per shadow ray for the
transmittance, so the port tracks each ray in one thread instead
(``csrc/medium_track.cu``: one thread per ray, the grid read through its
corner table ``SceneTensors.med_grid_corners``, one 32-byte row of a
voxel's eight densities per voxel, ``scene/arrays.py grid_corners``):

- ``delta_track(sa, med, o, d, t_end, key)`` -> (t, found, steps): entry
  ``delta_track``; key is the per-lane key before the medium's own
  ``pcg_hash(key ^ 0x6A09E667)``; t is the last distance stepped to (0 for a
  ray outside every grid medium), found whether it collided for real before
  t_end;
- ``ratio_track(sa, med, o, d, t_end, key)`` -> (tr, steps): entry
  ``ratio_track``; key before its ``pcg_hash``; tr the transmittance
  estimate (1 outside every grid medium).

med (R,) is each ray's medium row (-1 vacuum; a homogeneous medium is no
grid medium here), keys (R,) uint32 values in int64 (device/rng.py). steps
is the steps each ray took, at most 256. A CUDA tensor launches the kernel
(compiled by nvcc at its first launch, device/nvcc.py) and a CPU tensor runs
the twin, ``delta_track_plain`` / ``ratio_track_plain``: the reference's
loop in torch, every lane stepping while any is not done, one host read of
that condition per step. The kernel is held to the twin on the card
(chip_smoke.py phase 38) and the twin to the reference's while_loops
(tests/test_torch_media.py).
"""
from __future__ import annotations

import ctypes

import torch

from . import nvcc, rng
from .affine import xf_point

MAX_TRACKING_STEPS = 256
KERNEL_SOURCE = nvcc.CSRC / "medium_track.cu"

# o, d, t_end, med, key, n_rays, corners, dims, w2m, par, n_media,
# outputs..., stream
_IN_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int]


def build_kernel() -> dict:
    """Compile (if needed) and load csrc/medium_track.cu: {"lib",
    "seconds", "log", "path"} as device/nvcc.build returns it. Entries
    delta_track, ratio_track and medium_track_occupancy."""
    info = nvcc.build(KERNEL_SOURCE)
    lib = info["lib"]
    lib.delta_track.argtypes = _IN_ARGS + [ctypes.c_void_p] * 4
    lib.delta_track.restype = ctypes.c_int
    lib.ratio_track.argtypes = _IN_ARGS + [ctypes.c_void_p] * 3
    lib.ratio_track.restype = ctypes.c_int
    return info


def _inputs(sa, med, o, d, t_end, key):
    dev = o.device
    R = o.shape[0]
    f32 = torch.float32
    # the keys as int64: the kernel reads their low 32 bits (rng._u32's value)
    ins = (o.to(f32).contiguous(), d.to(f32).contiguous(), t_end.to(f32).contiguous(),
           med.to(torch.int64).contiguous(), key.to(torch.int64).contiguous())
    for name, x, shape in zip(("o", "d", "t_end", "med", "key"), ins, ((R, 3), (R, 3), (R,), (R,), (R,))):
        if x.device != dev or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be a {shape} tensor on {dev}")
    n_media = sa.med_param.shape[0]
    tables = (sa.med_grid_corners, sa.med_grid_dims, sa.med_w2m.reshape(n_media, 12).contiguous(),
              sa.med_param.contiguous())
    for name, x, dtype, shape in zip(("med_grid_corners", "med_grid_dims"), tables, (torch.float32, torch.int32),
                                     ((tables[0].shape[0], 8), (n_media, 4))):
        if x.device != dev or x.dtype != dtype or not x.is_contiguous() or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be a contiguous {dtype} {shape} tensor on {dev}")
    return R, ins, tables, n_media


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def delta_track_cuda(sa, med, o, d, t_end, key):
    """Launch delta_track; adds one to ``delta_track_cuda.launches``."""
    R, ins, tables, n_media = _inputs(sa, med, o, d, t_end, key)
    dev = o.device
    t = torch.empty(R, dtype=torch.float32, device=dev)
    found = torch.empty(R, dtype=torch.bool, device=dev)
    steps = torch.empty(R, dtype=torch.int32, device=dev)
    lib = build_kernel()["lib"]
    with torch.cuda.device(dev):  # the C entry launches on the calling thread's current device
        err = lib.delta_track(*(x.data_ptr() for x in ins), R, *(x.data_ptr() for x in tables), n_media,
                              t.data_ptr(), found.data_ptr(), steps.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"delta_track launch failed: cudaError {err}")
    nvcc.count_launch(delta_track_cuda)
    return t, found, steps


delta_track_cuda.launches = 0


def ratio_track_cuda(sa, med, o, d, t_end, key):
    """Launch ratio_track; adds one to ``ratio_track_cuda.launches``."""
    R, ins, tables, n_media = _inputs(sa, med, o, d, t_end, key)
    dev = o.device
    tr = torch.empty(R, dtype=torch.float32, device=dev)
    steps = torch.empty(R, dtype=torch.int32, device=dev)
    lib = build_kernel()["lib"]
    with torch.cuda.device(dev):  # the C entry launches on the calling thread's current device
        err = lib.ratio_track(*(x.data_ptr() for x in ins), R, *(x.data_ptr() for x in tables), n_media,
                              tr.data_ptr(), steps.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"ratio_track launch failed: cudaError {err}")
    nvcc.count_launch(ratio_track_cuda)
    return tr, steps


ratio_track_cuda.launches = 0


# ---------------------------------------------------------------------------
# The plain PyTorch twin (the reference's loops)
# ---------------------------------------------------------------------------


def grid_density(grid, pg):
    """Trilinear density lookup (media.py _grid_density :76): grid (nz, ny,
    nx), pg (R, 3) in the grid's [0, 1]^3; voxel coordinates p * n - 0.5,
    zero outside the grid."""
    nz, ny, nx = grid.shape
    gx = pg[..., 0] * nx - 0.5
    gy = pg[..., 1] * ny - 0.5
    gz = pg[..., 2] * nz - 0.5
    x0 = torch.floor(gx).to(torch.int32)
    y0 = torch.floor(gy).to(torch.int32)
    z0 = torch.floor(gz).to(torch.int32)
    fx = gx - x0
    fy = gy - y0
    fz = gz - z0

    def at(xi, yi, zi):
        inside = (xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny) & (zi >= 0) & (zi < nz)
        v = grid[torch.clamp(zi, 0, nz - 1).long(), torch.clamp(yi, 0, ny - 1).long(),
                 torch.clamp(xi, 0, nx - 1).long()]
        return torch.where(inside, v, 0.0)

    d00 = at(x0, y0, z0) * (1 - fx) + at(x0 + 1, y0, z0) * fx
    d10 = at(x0, y0 + 1, z0) * (1 - fx) + at(x0 + 1, y0 + 1, z0) * fx
    d01 = at(x0, y0, z0 + 1) * (1 - fx) + at(x0 + 1, y0, z0 + 1) * fx
    d11 = at(x0, y0 + 1, z0 + 1) * (1 - fx) + at(x0 + 1, y0 + 1, z0 + 1) * fx
    d0 = d00 * (1 - fy) + d10 * fy
    d1 = d01 * (1 - fy) + d11 * fy
    return d0 * (1 - fz) + d1 * fz


def density_at(sa, media_kinds, med, p):
    """Density multiplier at world p (media.py _density_at :104): each grid
    medium's lookup where med is that medium, 1 elsewhere."""
    dens = torch.ones(p.shape[0], dtype=torch.float32, device=p.device)
    for i, kind in enumerate(media_kinds):
        if kind != "heterogeneous" or f"med{i}" not in sa.med_grids:
            continue
        di = grid_density(sa.med_grids[f"med{i}"], xf_point(sa.med_w2m[i], p))
        dens = torch.where(med == i, di, dens)
    return dens


def _grid_lanes(sa, media_kinds, med):
    """(lanes in a grid medium, 1 / majorant, max(max density, 1e-12)) per
    lane (media.py :185-188)."""
    par = sa.med_param[torch.clamp(med, min=0)]
    sig_t0 = torch.clamp(par[:, 0] + par[:, 3], min=1e-12)
    inv_maj = 1.0 / torch.clamp(par[:, 7] * sig_t0, min=1e-12)
    grid_ids = [i for i, k in enumerate(media_kinds) if k == "heterogeneous" and f"med{i}" in sa.med_grids]
    active = torch.zeros(med.shape, dtype=torch.bool, device=med.device)
    for i in grid_ids:
        active = active | (med == i)
    return active, inv_maj, torch.clamp(par[:, 7], min=1e-12)


def delta_track_plain(sa, media_kinds, med, o, d, t_end, key):
    """delta_track's twin on any device: (t, found, steps)."""
    active, inv_maj, dmax = _grid_lanes(sa, media_kinds, med)
    R = o.shape[0]
    dev = o.device
    t = torch.zeros(R, dtype=torch.float32, device=dev)
    found = torch.zeros(R, dtype=torch.bool, device=dev)
    done = ~active
    steps = torch.zeros(R, dtype=torch.int32, device=dev)
    k = rng.pcg_hash(rng._u32(key) ^ 0x6A09E667)
    n = 0
    while n < MAX_TRACKING_STEPS and bool((~done).any()):
        n += 1
        steps = steps + (~done).to(torch.int32)
        k = rng.pcg_hash(k)
        u1 = rng.u32_to_float(k)
        k = rng.pcg_hash(k)
        u2 = rng.u32_to_float(k)
        t_new = t - torch.log(torch.clamp(1.0 - u1, min=1e-12)) * inv_maj
        past = t_new >= t_end
        dens = density_at(sa, media_kinds, med, o + d * t_new[:, None])
        real = u2 < dens / dmax
        newly_found = ~done & ~past & real
        t = torch.where(done, t, t_new)
        done = done | past | newly_found
        found = found | newly_found
    return t, found, steps


def ratio_track_plain(sa, media_kinds, med, o, d, t_end, key):
    """ratio_track's twin on any device: (tr, steps)."""
    active, inv_maj, dmax = _grid_lanes(sa, media_kinds, med)
    R = o.shape[0]
    dev = o.device
    t = torch.zeros(R, dtype=torch.float32, device=dev)
    tr = torch.ones(R, dtype=torch.float32, device=dev)
    done = ~active
    steps = torch.zeros(R, dtype=torch.int32, device=dev)
    k = rng.pcg_hash(rng._u32(key))
    n = 0
    while n < MAX_TRACKING_STEPS and bool((~done).any()):
        n += 1
        steps = steps + (~done).to(torch.int32)
        k = rng.pcg_hash(k)
        u = rng.u32_to_float(k)
        t_new = t - torch.log(torch.clamp(1.0 - u, min=1e-12)) * inv_maj
        past = t_new >= t_end
        dens = density_at(sa, media_kinds, med, o + d * t_new[:, None])
        factor = 1.0 - dens / dmax
        tr = torch.where(~done & ~past, tr * torch.clamp(factor, min=0.0), tr)
        t = torch.where(done, t, t_new)
        done = done | past | (tr < 1e-4)
    return tr, steps


def delta_track(sa, static, med, o, d, t_end, key):
    """Delta tracking: the kernel for CUDA tensors, the twin for CPU ones."""
    if o.device.type == "cuda":
        return delta_track_cuda(sa, med, o, d, t_end, key)
    return delta_track_plain(sa, static.media_kinds, med, o, d, t_end, key)


def ratio_track(sa, static, med, o, d, t_end, key):
    """Ratio tracking: the kernel for CUDA tensors, the twin for CPU ones."""
    if o.device.type == "cuda":
        return ratio_track_cuda(sa, med, o, d, t_end, key)
    return ratio_track_plain(sa, static.media_kinds, med, o, d, t_end, key)
