"""Camera ray generation: perspective (pinhole and thin lens),
orthographic, environment and realistic cameras, the animated camera, and
the camera's light-transport endpoint (BDPT's t = 1 strategies).

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

An animated camera (a shutter-close camera transform) interpolates its
camera-to-world per ray at the ray's shutter fraction (reference :138-170
``_quat_rot_batch``, ``_anim_c2w``: the decomposed T / R / S keyframes,
translation and scale lerped, rotation slerped). A realistic camera traces
film samples through its lens system (device/realistic.py). ``camera_we``,
``camera_pdf_we`` and ``camera_sample_wi`` are the pinhole perspective
camera's importance, its direction pdf and the sampled connection toward
it (perspective.rs we / pdf_we / sample_wi; reference :242-294).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.transform import AnimatedTransform
from ..scene.host import CameraConfig, FilmConfig
from .affine import xf_vector_t
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
CAM_REALISTIC = 3
KINDS = {"perspective": CAM_PERSPECTIVE, "orthographic": CAM_ORTHOGRAPHIC, "environment": CAM_ENVIRONMENT,
         "realistic": CAM_REALISTIC}


def make_camera(cfg: CameraConfig, film: FilmConfig, device="cuda"):
    """Build the camera parameter dict (matrices as float32 tensors on
    `device`: the card unless the caller names another device; "kind" one
    of the CAM_* ids; "anim" the animated camera's keyframes or None;
    "realistic" the lens system of a realistic camera or None; "shutter"
    (open, close); "motion_times", the TransformTimes range, is (0, 1) until
    the render sets the scene's)."""
    if cfg.kind not in KINDS:
        raise NotImplementedError(f"pbrt_tpu_torch does not support '{cfg.kind}' cameras yet")
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
    # the animated camera (transform.rs AnimatedTransform): its decomposed
    # T / R / S keyframes, interpolated per ray by generate_rays
    anim = None
    if cfg.camera_to_world_end is not None:
        at = AnimatedTransform(cfg.camera_to_world, cfg.camera_to_world_end)
        if at.actually_animated:
            (t0, q0, s0), (t1, q1, s1) = at._parts()
            anim = {k: torch.as_tensor(np.stack(v).astype(np.float32), device=device)
                    for k, v in (("t", (t0, t1)), ("q", (q0, q1)), ("s", (s0, s1)))}
    realistic = None
    if kind == CAM_REALISTIC:
        from .realistic import make_realistic

        realistic = make_realistic(cfg, film, device)
    # the screen window's area at z = 1 (the perspective camera's We)
    if kind == CAM_PERSPECTIVE:
        tan_half = math.tan(math.radians(cfg.fov) / 2.0)
        screen_area = (x1 - x0) * (y1 - y0) * tan_half * tan_half
    else:
        screen_area = (x1 - x0) * (y1 - y0)
    return {
        "kind": kind,
        "resolution": (xres, yres),
        "raster_to_camera": torch.as_tensor(raster_to_camera.astype(np.float32), device=device),
        # the float32 raster_to_camera inverted in float32 (camera_we's
        # camera -> raster map, reference :254)
        "camera_to_raster": torch.as_tensor(
            np.linalg.inv(raster_to_camera.astype(np.float32)).astype(np.float32), device=device),
        "camera_to_world": torch.as_tensor(c2w, device=device),
        "lens_radius": float(np.float32(cfg.lens_radius)),
        "focal_distance": float(np.float32(cfg.focal_distance)),
        "shutter": (cfg.shutter_open, cfg.shutter_close),
        "motion_times": (0.0, 1.0),
        "screen_area": float(screen_area),
        "anim": anim,
        "realistic": realistic,
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
    """Linear (no-translation) transform of a direction (affine.xf_vector);
    m (3, >= 3) or per ray (R, 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([
        m[..., 0, 0] * x + m[..., 0, 1] * y + m[..., 0, 2] * z,
        m[..., 1, 0] * x + m[..., 1, 1] * y + m[..., 1, 2] * z,
        m[..., 2, 0] * x + m[..., 2, 1] * y + m[..., 2, 2] * z,
    ], dim=-1)


def _quat_rot_batch(q):
    """(R, 4) wxyz quaternions -> (R, 3, 3) rotations (reference :138)."""
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def _anim_c2w(anim, tf):
    """Per-ray interpolated camera-to-world at shutter fractions tf (R,):
    (R, 3, 3) rotation times scale and (R, 3) translation
    (AnimatedTransform::interpolate; reference :151)."""
    t0, t1 = anim["t"][0], anim["t"][1]
    q0, q1 = anim["q"][0], anim["q"][1]
    s0, s1 = anim["s"][0], anim["s"][1]
    dt = torch.clamp(tf, 0.0, 1.0)
    trans = (1.0 - dt)[:, None] * t0 + dt[:, None] * t1
    cos_th = torch.clamp((q0 * q1).sum(), -1.0, 1.0)
    theta = torch.arccos(cos_th)
    sin_th = torch.clamp(torch.sin(theta), min=1e-9)
    lin = cos_th > 0.9995
    w0 = torch.where(lin, 1.0 - dt, torch.sin((1.0 - dt) * theta) / sin_th)
    w1 = torch.where(lin, dt, torch.sin(dt * theta) / sin_th)
    q = w0[:, None] * q0[None, :] + w1[:, None] * q1[None, :]
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
    rot = _quat_rot_batch(q)
    s_t = (1.0 - dt)[:, None, None] * s0[None] + dt[:, None, None] * s1[None]
    return torch.einsum("rij,rjk->rik", rot, s_t), trans


def generate_rays(cam, p_film_x, p_film_y, u_lens1, u_lens2, time_frac=None):
    """Raster-space sample positions -> world-space rays (o, d), each (R, 3).
    time_frac: the rays' shutter fractions (R,), which an animated camera
    interpolates its transform at. A realistic camera's rays go through its
    lens (realistic.realistic_generate_rays; its vignetting weight is the
    render's)."""
    if cam.get("realistic") is not None:
        from .realistic import realistic_generate_rays

        o, d, _w = realistic_generate_rays(cam, cam["realistic"], p_film_x, p_film_y, u_lens1, u_lens2)
        return o, d
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
    if cam.get("anim") is not None and time_frac is not None:
        m3, trans = _anim_c2w(cam["anim"], time_frac)
        return _xf_vector(m3, o_cam) + trans, normalize(_xf_vector(m3, d_cam))
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


# ---------------------------------------------------------------------------
# The camera as a light-transport endpoint (camera.rs we / pdf_we /
# sample_wi :98-121; perspective.rs; reference :236-294): BDPT's t = 1
# strategies. The pinhole perspective camera (a lens radius is treated as
# a delta, as in the reference).
# ---------------------------------------------------------------------------


def _camera_dir(cam, w):
    """World direction -> camera space (the rotation's transpose)."""
    return xf_vector_t(cam["camera_to_world"][:3, :3], w)


def camera_we(cam, p_from, w):
    """The importance We of a camera ray leaving along w, and the raster
    position it maps to: (we (R,), px, py, inside) (perspective.rs we)."""
    d_cam = _camera_dir(cam, w)
    cos_theta = d_cam[..., 2]
    valid = cos_theta > 1e-4
    p_z1 = d_cam / torch.clamp(cos_theta, min=1e-6)[..., None]
    pr = _apply44_point(cam["camera_to_raster"], p_z1[..., 0], p_z1[..., 1], p_z1[..., 2])
    W, H = cam["resolution"]
    inside = valid & (pr[..., 0] >= 0) & (pr[..., 0] < W) & (pr[..., 1] >= 0) & (pr[..., 1] < H)
    cos2 = cos_theta * cos_theta
    we = torch.where(inside, 1.0 / torch.clamp(cam["screen_area"] * cos2 * cos2, min=1e-12), 0.0)
    return we, pr[..., 0], pr[..., 1], inside


def camera_pdf_we(cam, w):
    """(pdf_pos, pdf_dir) of a camera ray along w (perspective.rs pdf_we):
    the pinhole's position is a delta (1); pdf_dir = 1 / (A cos^3)."""
    cos_theta = torch.clamp(_camera_dir(cam, w)[..., 2], min=1e-6)
    pdf_dir = 1.0 / (cam["screen_area"] * cos_theta ** 3)
    return torch.ones_like(pdf_dir), pdf_dir


def camera_sample_wi(cam, p_ref):
    """The connection from p_ref to the pinhole (perspective.rs sample_wi):
    {wi, dist, we, px, py, valid, pdf}, pdf = dist^2 / cos (the delta
    position's pdf over the solid angle)."""
    cam_p = cam["camera_to_world"][:3, 3]
    to_cam = cam_p - p_ref
    d2 = (to_cam * to_cam).sum(-1)
    dist = torch.sqrt(torch.clamp(d2, min=1e-20))
    wi = to_cam / dist[..., None]
    we, px, py, valid = camera_we(cam, cam_p, -wi)
    cos_theta = torch.clamp(_camera_dir(cam, -wi)[..., 2], min=1e-6)
    return {"wi": wi, "dist": dist, "we": we, "px": px, "py": py, "valid": valid, "pdf": d2 / cos_theta}
