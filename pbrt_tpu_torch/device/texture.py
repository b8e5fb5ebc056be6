"""Texture evaluation.

The port's counterpart of ``pbrt_tpu/device/texture.py``: the scene
compiler flattens the named-texture DAG into an ordered program list
(creation order is a topological order, scene/builder._TextureRegistry);
``eval_textures`` evaluates the programs once per shading wave into a stack
of (R, 3) values that ``material_param`` reads by texture id.

Every texture plugin of the reference (src/textures/*): constant, scale,
mix, bilerp, imagemap (bilinear without ray differentials, else MIPMap
trilinear or EWA, device/mipmap.py; wraps repeat, clamp and black), uv,
checkerboard (2D and 3D), dots, and the Perlin-noise family fbm, wrinkled,
windy and marble, over the uv, spherical, cylindrical and planar mappings.
The reference's known faults are kept (ROADMAP C): the texture-space
transform is never applied (spherical and cylindrical mappings and the
noise textures read world p) and checkerboard "aamode" is dropped.

Plain torch tensor code: the reference runs these outside any Pallas
kernel.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .mipmap import image_bilinear, lookup_ewa, lookup_trilinear, mip_atlas

# --- Perlin noise (texture.rs noise/fbm/turbulence) -------------------------

_NOISE_PERM_SIZE = 256
# the reference's permutation: numpy's RandomState(1619), rebuilt here
_PERM = np.random.RandomState(1619).permutation(_NOISE_PERM_SIZE).astype(np.int64)
_NOISE_PERM = np.concatenate([_PERM, _PERM])

# marble color spline (texture.rs marble colors)
_MARBLE_C = np.array(
    [[0.58, 0.58, 0.6], [0.58, 0.58, 0.6], [0.58, 0.58, 0.6], [0.5, 0.5, 0.5],
     [0.6, 0.59, 0.58], [0.58, 0.58, 0.6], [0.58, 0.58, 0.6], [0.2, 0.2, 0.33],
     [0.58, 0.58, 0.6]], dtype=np.float32)


def _grad(h, dx, dy, dz):
    h = h & 15
    u = torch.where(h < 8, dx, dy)
    v = torch.where(h < 4, dy, torch.where((h == 12) | (h == 14), dx, dz))
    u = torch.where((h & 1) != 0, -u, u)
    v = torch.where((h & 2) != 0, -v, v)
    return u + v


def _noise_weight(t):
    t3 = t * t * t
    t4 = t3 * t
    return 6.0 * t4 * t - 15.0 * t4 + 10.0 * t3


def perlin_noise(p):
    """Classic Perlin noise at points p (R, 3) -> (R,)."""
    perm = torch.as_tensor(_NOISE_PERM, device=p.device)
    fl = torch.floor(p)
    pi = fl.to(torch.int64)
    pf = p - fl
    ix = pi[..., 0] & (_NOISE_PERM_SIZE - 1)
    iy = pi[..., 1] & (_NOISE_PERM_SIZE - 1)
    iz = pi[..., 2] & (_NOISE_PERM_SIZE - 1)
    dx, dy, dz = pf[..., 0], pf[..., 1], pf[..., 2]

    def g(ox, oy, oz):
        h = perm[perm[perm[ix + ox] + iy + oy] + iz + oz]
        return _grad(h, dx - ox, dy - oy, dz - oz)

    w000, w100, w010, w110 = g(0, 0, 0), g(1, 0, 0), g(0, 1, 0), g(1, 1, 0)
    w001, w101, w011, w111 = g(0, 0, 1), g(1, 0, 1), g(0, 1, 1), g(1, 1, 1)
    wx, wy, wz = _noise_weight(dx), _noise_weight(dy), _noise_weight(dz)
    x00 = w000 + wx * (w100 - w000)
    x10 = w010 + wx * (w110 - w010)
    x01 = w001 + wx * (w101 - w001)
    x11 = w011 + wx * (w111 - w011)
    y0 = x00 + wy * (x10 - x00)
    y1 = x01 + wy * (x11 - x01)
    return y0 + wz * (y1 - y0)


def fbm(p, omega, max_octaves):
    s = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    lam, o = 1.0, 1.0
    for _ in range(int(max_octaves)):
        s = s + o * perlin_noise(p * lam)
        lam *= 1.99
        o = o * omega
    return s


def turbulence(p, omega, max_octaves):
    s = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    lam, o = 1.0, 1.0
    for _ in range(int(max_octaves)):
        s = s + o * perlin_noise(p * lam).abs()
        lam *= 1.99
        o = o * omega
    return s


# --- program evaluation -----------------------------------------------------


def _mapping_uv(prog, par, uv, p):
    """2D mapping (texture.rs:114-276) -> (s, t)."""
    if prog.mapping == "planar":
        v1, v2 = par[4:7], par[7:10]
        s = par[2] + p[:, 0] * v1[0] + p[:, 1] * v1[1] + p[:, 2] * v1[2]
        t = par[3] + p[:, 0] * v2[0] + p[:, 1] * v2[1] + p[:, 2] * v2[2]
        return s, t
    if prog.mapping == "spherical":
        d = p / torch.clamp(torch.linalg.norm(p, dim=-1, keepdim=True), min=1e-30)
        theta = torch.arccos(torch.clamp(d[:, 2], -1, 1))
        phi = torch.atan2(d[:, 1], d[:, 0])
        phi = torch.where(phi < 0, phi + 2 * math.pi, phi)
        return theta / math.pi, phi / (2 * math.pi)
    if prog.mapping == "cylindrical":
        phi = torch.atan2(p[:, 1], p[:, 0])
        phi = torch.where(phi < 0, phi + 2 * math.pi, phi)
        return phi / (2 * math.pi), p[:, 2]
    # uv mapping with scale and delta
    return par[0] * uv[:, 0] + par[2], par[1] * uv[:, 1] + par[3]


def has_imagemaps(static) -> bool:
    """Whether a texture of the scene reads an image (render._has_imagemaps):
    only then do camera rays carry differentials."""
    return any(p.kind == "imagemap" for p in static.tex_programs)


def _imagemap_levels(sa, prog):
    return [sa.tex_images[f"{prog.image_key}_l{k}"] for k in range(prog.n_levels)]


def prepare_atlases(sa, static) -> dict:
    """The mip atlas of every imagemap program's pyramid (image_key ->
    mipmap.mip_atlas), built once per route for eval_textures."""
    out = {}
    for prog in static.tex_programs:
        if prog.kind == "imagemap" and prog.n_levels > 1 and prog.image_key not in out:
            out[prog.image_key] = mip_atlas(_imagemap_levels(sa, prog))
    return out


def needed_programs(programs, roots) -> list[int]:
    """The programs that roots (texture indices) read, with their children
    (children precede their parents), in evaluation order."""
    need = set()
    stack = [int(r) for r in roots if int(r) >= 0]
    while stack:
        x = stack.pop()
        if x in need:
            continue
        need.add(x)
        prog = programs[x]
        stack += [c for c in (prog.tex1, prog.tex2, prog.amount, prog.v01, prog.v10) if c >= 0]
    return sorted(need)


def eval_textures(sa, programs, uv, p, duvdx=None, duvdy=None, atlases=None, only=None):
    """Evaluate the texture programs at (uv (R, 2), p (R, 3)): a list of
    (R, 3) float32 values, one per program (None for a program outside
    `only`, when it is given: a list of indices closed under children,
    needed_programs). duvdx, duvdy: the (R, 2) texture-footprint
    derivatives that select MIPMap levels (None: the finest level, the
    reference's width-0 lookup). atlases: prepare_atlases of the scene."""
    R = uv.shape[0]
    dev = uv.device
    results = [None] * len(programs)
    par_all = sa.tex_param
    keep = set(range(len(programs))) if only is None else set(only)
    for xi, prog in enumerate(programs):
        if xi not in keep:
            continue
        par = par_all[xi]

        def child(idx, const_slice):
            if idx >= 0:
                return results[idx]
            return torch.broadcast_to(const_slice, (R, 3))

        if prog.kind == "constant":
            val = torch.broadcast_to(par[10:13], (R, 3))
        elif prog.kind == "scale":
            val = child(prog.tex1, par[10:13]) * child(prog.tex2, par[13:16])
        elif prog.kind == "mix":
            amt = child(prog.amount, par[16:19])
            val = (1.0 - amt) * child(prog.tex1, par[10:13]) + amt * child(prog.tex2, par[13:16])
        elif prog.kind == "imagemap":
            s, t = _mapping_uv(prog, par, uv, p)
            levels = _imagemap_levels(sa, prog)
            if duvdx is None or prog.n_levels == 1:
                val = image_bilinear(levels[0], s, t, prog.wrap) * par[10]
            else:
                atlas = (atlases or {}).get(prog.image_key)
                # the mapping scales the footprint (uv mapping only; other
                # mappings keep the raw uv derivative scale)
                sc = par[0:2] if prog.mapping == "uv" else torch.ones(2, dtype=torch.float32, device=dev)
                dx = duvdx * sc
                dy = duvdy * sc
                if prog.trilinear:
                    width = 2.0 * torch.maximum(dx.abs().amax(-1), dy.abs().amax(-1))
                    val = lookup_trilinear(levels, s, t, width, prog.wrap, atlas=atlas) * par[10]
                else:
                    val = lookup_ewa(levels, s, t, dx, dy, prog.wrap, max_anisotropy=prog.max_aniso,
                                     atlas=atlas) * par[10]
        elif prog.kind == "uv":
            s, t = _mapping_uv(prog, par, uv, p)
            val = torch.stack([s - torch.floor(s), t - torch.floor(t), torch.zeros_like(s)], dim=-1)
        elif prog.kind == "checkerboard":
            if prog.dimension == 2:
                s, t = _mapping_uv(prog, par, uv, p)
                even = torch.remainder(torch.floor(s) + torch.floor(t), 2) == 0
            else:
                q = torch.floor(p)
                even = torch.remainder(q[:, 0] + q[:, 1] + q[:, 2], 2) == 0
            val = torch.where(even[:, None], child(prog.tex1, par[10:13]), child(prog.tex2, par[13:16]))
        elif prog.kind == "dots":
            s, t = _mapping_uv(prog, par, uv, p)
            sc = torch.floor(s + 0.5)
            tc = torch.floor(t + 0.5)
            # one pseudo-random dot per cell (texture.rs dots: noise-driven)
            cell = torch.stack([sc + 0.5, tc + 0.5, torch.zeros_like(sc)], dim=-1)
            has_dot = perlin_noise(cell) > 0
            rx = perlin_noise(cell + torch.tensor([1.5, 2.5, 0.0], device=dev))
            ry = perlin_noise(cell + torch.tensor([4.5, 9.5, 0.0], device=dev))
            radius = 0.35
            maxshift = 0.5 - radius
            xc = sc + maxshift * rx
            yc = tc + maxshift * ry
            inside = has_dot & ((s - xc) ** 2 + (t - yc) ** 2 < radius * radius)
            val = torch.where(inside[:, None], child(prog.tex1, par[10:13]), child(prog.tex2, par[13:16]))
        elif prog.kind in ("fbm", "wrinkled"):
            fn = fbm if prog.kind == "fbm" else turbulence
            val = torch.broadcast_to(fn(p, par[10], prog.octaves)[:, None], (R, 3))
        elif prog.kind == "windy":
            strength = fbm(0.1 * p, 0.5, 3).abs()
            height = fbm(p, 0.5, 6)
            val = torch.broadcast_to((strength * height)[:, None], (R, 3))
        elif prog.kind == "marble":
            scale = torch.where(par[11] > 0, par[11], 1.0)
            variation = torch.where(par[12] > 0, par[12], 0.2)
            marble = p * scale
            t_m = 0.5 + 0.5 * torch.sin(marble[:, 0] + variation * fbm(marble, 0.5, prog.octaves))
            nseg = len(_MARBLE_C) - 3
            tt = torch.clamp(t_m, 0.0, 0.9999) * nseg
            first = torch.floor(tt).to(torch.int64)
            ft = (tt - first)[:, None]
            cj = torch.as_tensor(_MARBLE_C, device=dev)
            c0, c1, c2, c3 = cj[first], cj[first + 1], cj[first + 2], cj[first + 3]
            s0 = (1 - ft) * c0 + ft * c1
            s1 = (1 - ft) * c1 + ft * c2
            s2 = (1 - ft) * c2 + ft * c3
            s0 = (1 - ft) * s0 + ft * s1
            s1 = (1 - ft) * s1 + ft * s2
            val = 1.5 * ((1 - ft) * s0 + ft * s1)
        elif prog.kind == "bilerp":
            s, t = _mapping_uv(prog, par, uv, p)
            v00 = child(prog.tex1, par[10:13])
            v11 = child(prog.tex2, par[13:16])
            v01 = child(prog.v01, par[16:19])
            v10 = child(prog.v10, par[19:22])
            ss = (s - torch.floor(s))[:, None]
            tt = (t - torch.floor(t))[:, None]
            val = (1 - ss) * (1 - tt) * v00 + (1 - ss) * tt * v01 + ss * (1 - tt) * v10 + ss * tt * v11
        else:
            val = torch.zeros((R, 3), dtype=torch.float32, device=dev)
        results[xi] = val.to(torch.float32)
    return results


def material_param(sa, tex_values, mat_ids, slot):
    """Per-lane value (R, 3) of a material parameter slot: the row's
    constant, or the value of the texture the row names there."""
    const = sa.mat_const[mat_ids, slot]
    tid = sa.mat_tex[mat_ids, slot]
    out = const
    for x, val in enumerate(tex_values):
        if val is not None:
            out = torch.where((tid == x)[:, None], val, out)
    return out
