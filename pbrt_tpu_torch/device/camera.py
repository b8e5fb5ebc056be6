"""Camera ray generation: perspective (pinhole and thin lens),
orthographic and environment cameras.

The port's counterpart of ``pbrt_tpu/device/camera.py``. The host builds the
raster->camera and camera->world matrices exactly as the reference does (in
float64, exported as float32); the device maps raster sample positions to
world rays with explicit multiply-adds in the reference's order. An
orthographic ray starts on the raster's point of the z = 0 plane and runs
along +z; an environment ray runs along the (theta, phi) of its raster
position over the whole sphere (cameras/environment.rs), from the camera's
origin. Ray differentials carry directions only, as the reference's do, so
an orthographic camera's offset rays share the main ray's origin and
direction: its texture footprint is zero (the reference's fault, kept;
ROADMAP C).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..scene.host import CameraConfig, FilmConfig
from .shading import normalize


def _perspective_matrix(fov_deg, n=1e-2, f=1000.0):
    inv_tan = 1.0 / math.tan(math.radians(fov_deg) / 2.0)
    m = np.array(
        [
            [1, 0, 0, 0],
            [0, 1, 0, 0],
            [0, 0, f / (f - n), -f * n / (f - n)],
            [0, 0, 1, 0],
        ],
        dtype=np.float64,
    )
    s = np.diag([inv_tan, inv_tan, 1.0, 1.0])
    return s @ m


CAM_PERSPECTIVE = 0
CAM_ORTHOGRAPHIC = 1
CAM_ENVIRONMENT = 2
KINDS = {"perspective": CAM_PERSPECTIVE, "orthographic": CAM_ORTHOGRAPHIC, "environment": CAM_ENVIRONMENT}


def make_camera(cfg: CameraConfig, film: FilmConfig, device="cuda"):
    """Build the camera parameter dict (matrices as float32 tensors on
    `device`: the card unless the caller names another device; "kind" one
    of the CAM_* ids)."""
    if cfg.kind not in KINDS:
        raise NotImplementedError(f"pbrt_tpu_torch does not support '{cfg.kind}' cameras yet")
    if cfg.camera_to_world_end is not None:
        raise NotImplementedError("pbrt_tpu_torch does not support animated cameras yet")
    xres, yres = film.x_resolution, film.y_resolution
    aspect = xres / yres
    if cfg.screen_window is not None:
        x0, x1, y0, y1 = cfg.screen_window
    elif aspect > 1:
        x0, x1, y0, y1 = -aspect, aspect, -1.0, 1.0
    else:
        x0, x1, y0, y1 = -1.0, 1.0, -1.0 / aspect, 1.0 / aspect

    # raster -> screen -> camera (camera.rs ProjectiveCamera ctor math)
    screen_to_raster = (
        np.diag([xres, yres, 1.0, 1.0])
        @ np.array([[1 / (x1 - x0), 0, 0, -x0 / (x1 - x0)], [0, 1 / (y0 - y1), 0, -y1 / (y0 - y1)], [0, 0, 1, 0], [0, 0, 0, 1.0]])
    )
    raster_to_screen = np.linalg.inv(screen_to_raster)
    kind = KINDS[cfg.kind]
    proj = _perspective_matrix(cfg.fov) if kind == CAM_PERSPECTIVE else np.eye(4)
    raster_to_camera = np.linalg.inv(proj) @ raster_to_screen
    c2w = np.asarray(cfg.camera_to_world.m, dtype=np.float32)
    return {
        "kind": kind,
        "resolution": (xres, yres),
        "raster_to_camera": torch.as_tensor(raster_to_camera.astype(np.float32), device=device),
        "camera_to_world": torch.as_tensor(c2w, device=device),
        "lens_radius": float(np.float32(cfg.lens_radius)),
        "focal_distance": float(np.float32(cfg.focal_distance)),
    }


def concentric_sample_disk(u1, u2):
    """Concentric disk mapping (src/core/sampling.rs:147-168)."""
    ox = 2.0 * u1 - 1.0
    oy = 2.0 * u2 - 1.0
    deg = (ox == 0) & (oy == 0)
    use_x = ox.abs() > oy.abs()
    safe_x = torch.where(ox == 0, 1.0, ox)
    safe_y = torch.where(oy == 0, 1.0, oy)
    r = torch.where(use_x, ox, oy)
    theta = torch.where(use_x, (math.pi / 4.0) * (oy / safe_x), math.pi / 2.0 - (math.pi / 4.0) * (ox / safe_y))
    r = torch.where(deg, 0.0, r)
    theta = torch.where(deg, 0.0, theta)
    return r * torch.cos(theta), r * torch.sin(theta)


def _apply44_point(m, x, y, z):
    """Projective 4x4 point transform with homogeneous divide
    (reference device/affine.apply44_point)."""
    r = torch.stack([
        m[0, 0] * x + m[0, 1] * y + m[0, 2] * z + m[0, 3],
        m[1, 0] * x + m[1, 1] * y + m[1, 2] * z + m[1, 3],
        m[2, 0] * x + m[2, 1] * y + m[2, 2] * z + m[2, 3],
    ], dim=-1)
    w = m[3, 0] * x + m[3, 1] * y + m[3, 2] * z + m[3, 3]
    return r / w[..., None]


def _xf_vector(m, v):
    """Linear (no-translation) transform of a direction (affine.xf_vector)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([
        m[0, 0] * x + m[0, 1] * y + m[0, 2] * z,
        m[1, 0] * x + m[1, 1] * y + m[1, 2] * z,
        m[2, 0] * x + m[2, 1] * y + m[2, 2] * z,
    ], dim=-1)


def generate_rays(cam, p_film_x, p_film_y, u_lens1, u_lens2):
    """Raster-space sample positions -> world-space rays (o, d), each (R, 3)."""
    r2c = cam["raster_to_camera"]
    c2w = cam["camera_to_world"]
    kind = cam.get("kind", CAM_PERSPECTIVE)
    if kind == CAM_ENVIRONMENT:
        # equirect over the full sphere (cameras/environment.rs)
        xres, yres = cam["resolution"]
        theta = math.pi * p_film_y / yres
        phi = 2.0 * math.pi * p_film_x / xres
        st = torch.sin(theta)
        d_cam = torch.stack([st * torch.cos(phi), torch.cos(theta), st * torch.sin(phi)], dim=-1)
        o_cam = torch.zeros_like(d_cam)
    else:
        p_cam = _apply44_point(r2c, p_film_x, p_film_y, torch.zeros_like(p_film_x))
        if kind == CAM_ORTHOGRAPHIC:
            o_cam = p_cam
            d_cam = torch.broadcast_to(torch.tensor([0.0, 0.0, 1.0], device=p_cam.device), p_cam.shape)
        else:
            o_cam = torch.zeros_like(p_cam)
            d_cam = normalize(p_cam)
    lens_r = cam["lens_radius"]
    if kind == CAM_PERSPECTIVE and lens_r > 0:
        # thin-lens DoF (perspective.rs generate_ray)
        lx, ly = concentric_sample_disk(u_lens1, u_lens2)
        lx = lens_r * lx
        ly = lens_r * ly
        ft = cam["focal_distance"] / torch.clamp(d_cam[..., 2], min=1e-9)
        p_focus = o_cam + d_cam * ft[..., None]
        o_cam = torch.stack([lx, ly, torch.zeros_like(lx)], dim=-1)
        d_cam = normalize(p_focus - o_cam)
    o_w = _xf_vector(c2w, o_cam) + c2w[:3, 3]
    d_w = normalize(_xf_vector(c2w, d_cam))
    return o_w, d_w


def ray_differential_dirs(cam, p_film_x, p_film_y):
    """World directions of the +1-pixel x and y offset rays
    (camera.rs generate_ray_differential's finite-difference default
    :43-97), both with the lens sample (0, 0)."""
    zeros = torch.zeros_like(p_film_x)
    _, dx = generate_rays(cam, p_film_x + 1.0, p_film_y, zeros, zeros)
    _, dy = generate_rays(cam, p_film_x, p_film_y + 1.0, zeros, zeros)
    return dx, dy
