"""Realistic camera: film samples traced through a lens system.

The port's counterpart of ``pbrt_tpu/device/realistic.py`` (src/cameras/
realistic.rs). A lens file lists the elements front first, one row each of
curvature radius, thickness, index of refraction and aperture diameter, in
mm (``load_lens_file``; a radius of 0 is the aperture stop). A ray starts on
the film, refracts through every element (a loop over the elements, each a
vectorised step over the rays) and leaves into the scene. The film distance
is focused numerically on the host (``LensSystem.focus_offset``: the film
offset that brings near-axis rays from the focus distance to a point), and
the exit pupil is bounded per film-radius bucket, 64 of them
(``compute_exit_pupil``), so that film samples aim only at rear-element
points with a chance of getting through. ``realistic_generate_rays``
returns each ray's weight: 0 where the lens vignettes it, else cos^4 times
the sampled bucket's pupil area over the on-axis one (realistic.rs
simple_weighting :494).

An unreadable lens file warns and falls back to the built-in double Gauss
``DEFAULT_LENS``, as the reference does (scene semantics, kept).
"""
from __future__ import annotations

import logging
import math

import numpy as np
import torch

log = logging.getLogger(__name__)

# the built-in 4-element double-Gauss-like lens (pbrt-style rows: curvature
# radius, thickness, eta, aperture diameter, in mm; the reference's rows)
DEFAULT_LENS = [
    [35.98738, 1.21638, 1.54, 23.716],
    [11.69718, 9.9957, 1.0, 17.996],
    [13.08714, 5.12622, 1.772, 12.364],
    [-22.63294, 1.76924, 1.617, 9.812],
    [71.05802, 0.8184, 1.0, 9.152],
    [0.0, 2.27766, 0.0, 8.756],  # aperture stop
    [-9.58584, 2.43254, 1.617, 8.184],
    [-11.28864, 0.11506, 1.0, 9.152],
    [-166.7765, 3.09606, 1.713, 10.648],
    [-7.5911, 1.32682, 1.805, 11.44],
    [-16.7662, 3.98068, 1.0, 12.276],
    [-7.70286, 1.21638, 1.617, 13.42],
    [-11.97328, 0.0, 1.0, 17.996],
]
PUPIL_BUCKETS = 64  # realistic.rs:91


def load_lens_file(path: str):
    """Whitespace-separated floats with # comments, 4 per element
    (floatfile.rs)."""
    vals = []
    with open(path) as fh:
        for line in fh:
            line = line.split("#")[0].strip()
            if line:
                vals.extend(float(t) for t in line.split())
    if len(vals) % 4:
        raise ValueError(f"lens file {path}: count {len(vals)} not a multiple of 4")
    return [vals[i:i + 4] for i in range(0, len(vals), 4)]


class LensSystem:
    """The lens rows in meters, and the host-side focusing (reference
    realistic.LensSystem)."""

    def __init__(self, rows, aperture_diameter_mm: float):
        # the stop's aperture is the smaller of its row's and the camera's
        self.curvature, self.thickness, self.eta, self.aperture_r = [], [], [], []
        for cr, th, eta, ap in rows:
            if cr == 0.0 and aperture_diameter_mm > 0:
                ap = min(ap, aperture_diameter_mm)
            self.curvature.append(cr * 1e-3)
            self.thickness.append(th * 1e-3)
            self.eta.append(eta)
            self.aperture_r.append(ap * 1e-3 / 2.0)
        self.n = len(rows)

    def rear_z(self):
        return self.thickness[-1]

    def focus_offset(self, focus_distance: float) -> float:
        """The film offset (of 1,300 between -5 mm and 60 mm) at which
        near-axis rays from the point at focus_distance land closest to the
        film centre."""

        def blur(delta):
            spot = []
            for h in (0.2, 0.35, 0.5):
                # paraxial probes, inside the smallest aperture
                r = min(self.aperture_r) * h
                ok, o, d = self._trace_from_scene(np.array([0.0, 0.0, -focus_distance]), np.array([r, 0.0, 0.0]))
                if not ok or abs(d[2]) < 1e-9:
                    continue
                t = (delta - o[2]) / d[2]
                spot.append(abs(o[0] + t * d[0]))
            return sum(spot) / max(len(spot), 1) if spot else 1e9

        best, best_b = 0.0, 1e18
        for delta in np.linspace(-5e-3, 60e-3, 1300):
            b = blur(delta)
            if b < best_b:
                best_b = b
                best = delta
        return float(best)

    def _trace_from_scene(self, p_scene, p_front):
        """A scalar float64 trace from the scene to the film: (ok, o, d)
        of the ray leaving the rear element."""
        z = -sum(self.thickness)
        o = np.asarray(p_scene, float)
        d = np.asarray(p_front, float) + np.array([0, 0, z]) - o
        d = d / np.linalg.norm(d)
        eta_prev = 1.0
        for i in range(self.n):
            r = self.curvature[i]
            eta_next = self.eta[i] if self.eta[i] != 0 else 1.0
            if r == 0:
                t = (z - o[2]) / d[2]
            else:
                oc = o - np.array([0, 0, z + r])
                b = np.dot(oc, d)
                c = np.dot(oc, oc) - r * r
                disc = b * b - c
                if disc < 0:
                    return False, o, d
                sq = math.sqrt(disc)
                # the closer sheet when the travel direction and the
                # curvature agree (realistic.rs intersect_spherical_element)
                closer = (d[2] > 0) != (r < 0)
                t = (-b - sq) if closer else (-b + sq)
                if t < 1e-9:
                    return False, o, d
            p = o + t * d
            if p[0] ** 2 + p[1] ** 2 > self.aperture_r[i] ** 2:
                return False, o, d
            if r != 0:
                n = (p - np.array([0, 0, z + r])) / abs(r)
                n = n if np.dot(n, d) < 0 else -n
                eta_ratio = eta_prev / eta_next
                cos_i = -np.dot(n, d)
                sin2t = eta_ratio * eta_ratio * (1 - cos_i * cos_i)
                if sin2t >= 1:
                    return False, o, d
                cos_t = math.sqrt(1 - sin2t)
                d = eta_ratio * d + (eta_ratio * cos_i - cos_t) * n
                d = d / np.linalg.norm(d)
            o = p
            eta_prev = eta_next
            z += self.thickness[i]
        return True, o, d


def make_realistic(cfg, film, device="cuda"):
    """The realistic camera's lens dict: element tables (Python floats), the
    focused film z, the physical film extent and the exit pupil's bucket
    bounds (PUPIL_BUCKETS, 4) on `device`."""
    rows = None
    if cfg.lens_file:
        try:
            rows = load_lens_file(cfg.lens_file)
        except (OSError, ValueError) as e:
            log.warning("lens file '%s' unreadable (%s); using built-in double gauss", cfg.lens_file, e)
    if rows is None:
        rows = DEFAULT_LENS
    lens = LensSystem(rows, cfg.aperture_diameter)
    film_z = lens.focus_offset(max(cfg.focus_distance, 0.1))
    # the physical film from its diagonal (film.rs create_film)
    aspect = film.x_resolution / film.y_resolution
    diag = film.diagonal * 1e-3
    fy = math.sqrt(diag * diag / (1 + aspect * aspect))
    fx = aspect * fy
    elem_z, z = [], -sum(lens.thickness)
    for th in lens.thickness:
        elem_z.append(z)
        z += th
    rcam = {
        "curvature": tuple(float(c) for c in lens.curvature),
        "elem_z": tuple(float(z_) for z_ in elem_z),
        "eta": tuple(float(e) if e != 0 else 1.0 for e in lens.eta),
        "aperture_r": tuple(float(a) for a in lens.aperture_r),
        "n_elements": lens.n,
        "film_z": float(film_z),
        "rear_r": float(lens.aperture_r[-1]),
        "rear_z": float(lens.rear_z()),
        "film_extent": (fx, fy),
    }
    rcam["pupil_bounds"] = torch.as_tensor(compute_exit_pupil(rcam, (fx, fy), PUPIL_BUCKETS), device=device)
    return rcam


def _dot3(a, b):
    return (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]) + a[:, 2] * b[:, 2]


def _div(x, s: float):
    """x / s rounded as one IEEE division on every device: PyTorch's CUDA
    divide by a Python number multiplies by its rounded reciprocal instead
    (an ulp off the CPU's quotient in some lanes, which the lens's
    refractions amplify), so s rides in as a tensor on x's device."""
    return x / x.new_full((), s)


def trace_film_to_scene(rcam, o, d):
    """Rays (R, 3) in lens space, leaving the film toward -z, through every
    element, rear first: (ok (R,), o, d) of the ray leaving the front
    element (ok false where an aperture stops it or it is totally
    internally reflected)."""
    dev = o.device
    ok = torch.ones(o.shape[0], dtype=torch.bool, device=dev)
    for i in range(rcam["n_elements"] - 1, -1, -1):
        r = rcam["curvature"][i]
        zs = rcam["elem_z"][i]
        ap2 = rcam["aperture_r"][i] ** 2
        if r == 0.0:
            t = (zs - o[:, 2]) / torch.where(d[:, 2].abs() > 1e-9, d[:, 2], 1e-9)
            p = o + d * t[:, None]
            ok = ok & (t > 0) & (p[:, 0] ** 2 + p[:, 1] ** 2 <= ap2)
            o = p
            continue
        zc = zs + r
        center = torch.tensor([0.0, 0.0, zc], dtype=torch.float32, device=dev)
        ocz = o - center
        b = _dot3(ocz, d)
        c = _dot3(ocz, ocz) - r * r
        disc = b * b - c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        use_closer = (d[:, 2] > 0) != (r < 0)
        t = torch.where(use_closer, -b - sq, -b + sq)
        p = o + d * t[:, None]
        good = (disc >= 0) & (t > 1e-9) & (p[:, 0] ** 2 + p[:, 1] ** 2 <= ap2)
        eta_next = rcam["eta"][i - 1] if i > 0 else 1.0
        nrm = _div(p - center, abs(r))
        nrm = torch.where((_dot3(nrm, d) > 0)[:, None], -nrm, nrm)
        eta_ratio = rcam["eta"][i] / max(eta_next, 1e-6)
        cos_i = -_dot3(nrm, d)
        sin2t = eta_ratio * eta_ratio * (1.0 - cos_i * cos_i)
        tir = sin2t >= 1.0
        cos_t = torch.sqrt(torch.clamp(1.0 - sin2t, min=0.0))
        d_ref = eta_ratio * d + (eta_ratio * cos_i - cos_t)[:, None] * nrm
        d_ref = d_ref / torch.clamp(torch.sqrt(_dot3(d_ref, d_ref)), min=1e-30)[:, None]
        d = torch.where(tir[:, None], d, d_ref)
        o = p
        ok = ok & good & ~tir
    return ok, o, d


def compute_exit_pupil(rcam, film_extent, n_buckets: int = PUPIL_BUCKETS, grid: int = 32):
    """Per film-radius bucket, the bounding rectangle (x0, x1, y0, y1) of
    the rear-element points (a grid x grid lattice over 1.5 rear radii)
    whose ray from the bucket's film point gets through, padded by one
    lattice step; the whole rear element where none does (realistic.rs exit
    pupil). A float32 numpy (n_buckets, 4) array, traced on the CPU."""
    fx, fy = film_extent
    film_diag_half = 0.5 * math.hypot(fx, fy)
    rr = rcam["rear_r"] * 1.5
    xs = np.linspace(-rr, rr, grid)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    n = grid * grid
    rear = np.stack([gx.ravel(), gy.ravel(), np.full(n, rcam["elem_z"][-1])], axis=-1).astype(np.float32)
    bounds = np.zeros((n_buckets, 4), np.float32)
    for b in range(n_buckets):
        r_film = (b + 0.5) / n_buckets * film_diag_half
        o = np.broadcast_to(np.array([r_film, 0.0, rcam["film_z"]], np.float32), (n, 3)).copy()
        d = rear - o
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        ok, _, _ = trace_film_to_scene(rcam, torch.as_tensor(o), torch.as_tensor(d))
        okn = ok.numpy()
        if okn.any():
            pxs = rear[okn]
            pad = 2 * rr / grid
            bounds[b] = [pxs[:, 0].min() - pad, pxs[:, 0].max() + pad, pxs[:, 1].min() - pad, pxs[:, 1].max() + pad]
        else:
            bounds[b] = [-rcam["rear_r"], rcam["rear_r"], -rcam["rear_r"], rcam["rear_r"]]
    return bounds


def realistic_generate_rays(cam, rcam, p_film_x, p_film_y, u1, u2):
    """Raster film samples -> world rays through the lens: (o, d, weight),
    weight 0 for a ray the lens vignettes."""
    W, H = cam["resolution"]
    fx, fy = rcam["film_extent"]
    dev = p_film_x.device
    # the film point (flipped, realistic.rs p_film)
    x = (0.5 - _div(p_film_x, W)) * fx
    y = (_div(p_film_y, H) - 0.5) * fy
    o = torch.stack([x, y, torch.full_like(x, rcam["film_z"])], dim=-1)
    # a point of the film radius's pupil bucket, turned to the film azimuth
    # (realistic.rs sample_exit_pupil)
    pupil = rcam["pupil_bounds"]
    film_diag_half = 0.5 * math.hypot(fx, fy)
    r_film = torch.sqrt(x * x + y * y)
    nb = pupil.shape[0]
    bidx = torch.clamp((_div(r_film, film_diag_half) * nb).to(torch.int64), 0, nb - 1)
    bb = pupil[bidx]
    px_r = bb[:, 0] + u1 * (bb[:, 1] - bb[:, 0])
    py_r = bb[:, 2] + u2 * (bb[:, 3] - bb[:, 2])
    far = r_film > 1e-9
    inv_r = torch.where(far, 1.0 / torch.clamp(r_film, min=1e-9), 0.0)
    cs = torch.where(far, x * inv_r, 1.0)
    sn = torch.where(far, y * inv_r, 0.0)
    p_rear = torch.stack([cs * px_r - sn * py_r, sn * px_r + cs * py_r, torch.full_like(x, rcam["elem_z"][-1])],
                         dim=-1)
    d = p_rear - o
    d = d / torch.sqrt(_dot3(d, d))[:, None]
    cos0 = d[:, 2].abs()
    ok, o, d = trace_film_to_scene(rcam, o, d)
    # leaving rays travel toward -z in lens space: flip into the camera's
    # +z-forward frame, then to world
    c2w = cam["camera_to_world"]
    d_cam = torch.stack([d[:, 0], d[:, 1], -d[:, 2]], dim=-1)
    d_cam = torch.where(ok[:, None], d_cam, torch.tensor([0.0, 0.0, 1.0], device=dev))
    o_cam = torch.stack([o[:, 0], o[:, 1], -o[:, 2]], dim=-1)
    from .camera import _xf_vector

    o_w = _xf_vector(c2w, o_cam) + c2w[:3, 3]
    d_w = _xf_vector(c2w, d_cam)
    d_w = d_w / torch.clamp(torch.sqrt(_dot3(d_w, d_w)), min=1e-30)[:, None]
    # simple_weighting (realistic.rs:494): cos^4 times the sampled bucket's
    # pupil area over the on-axis bucket's
    area = (bb[:, 1] - bb[:, 0]) * (bb[:, 3] - bb[:, 2])
    area0 = torch.clamp((pupil[0, 1] - pupil[0, 0]) * (pupil[0, 3] - pupil[0, 2]), min=1e-12)
    cos2 = cos0 * cos0  # cos^4 as two products: a float power's rounding differs between devices
    weight = torch.where(ok, cos2 * cos2 * area / area0, 0.0)
    return o_w, d_w, weight
