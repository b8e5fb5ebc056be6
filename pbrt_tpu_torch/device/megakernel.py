"""Brute-force persistent path-tracing megakernel: the hand-written CUDA
kernel (``csrc/megakernel.cu``) and its plain PyTorch twin.

The port's counterpart of ``pbrt_tpu/device/megakernel.py``. For scenes of
at most MAX_PRIMS triangle or full-sphere prims, at most MAX_LIGHTS point,
spot or distant lights and constant-parameter materials whose lobe set it
bakes (Lambert or Oren-Nayar matte, mirror, glass, GGX metal, and
Lambert+GGX plastic, glossy uber or translucent without transmission:
``bake_lobe_entry``; substrate, disney, fourier and hair rows are refused
by their lobe set, mix rows by name), the
whole persistent path or directlighting loop runs in one kernel: camera
regeneration, brute-force closest-hit and shadow tests, NEE, BSDF sampling,
Russian roulette and the sample flush.

- ``extract_consts`` / ``megakernel_eligible``: the reference's class and
  its ``None`` gates, with the same baked constants (``bake_lobe_entry``
  over ``device/materials.bake_lobes``).
- ``pack_consts``: the constants as one flat float32 blob (layout below),
  the only thing the CUDA kernel reads of the scene.
- ``megakernel_plain``: the reference's ``_build_kernel`` transcribed over
  (R,) lane tensors, with the same loop cap. uint32 hash and Sobol'
  arithmetic rides int64 masked to 32 bits, bit-exact.
- ``megakernel_cuda``: builds the kernel at first use, launches it on the
  current stream, counts launches and iteration-cap hits, and raises on any
  error; ``megakernel_split`` launches the instrumented instantiation (a
  clock64 cycle split per phase and the tests the launch made), which no
  route launches.
- ``make_megakernel_fn``: the wave_p-compatible function of the render
  route; CUDA tensors launch the kernel, CPU tensors run the plain twin.

Textured Kd: a grayscale imagemap of at most 128 x 128 texels under the
uv mapping with the repeat wrap, on the Kd slot of a matte (Lambert or
Oren-Nayar) or plastic material of triangle prims, rides a mip atlas in
device memory (``_bake_imagemap_atlas``; the reference keeps it in VMEM)
that the kernel reads with a ray-cone trilinear lookup (the reference's
``eval_kd_tex``: the cone's width at the hit, from the camera's pixel
angle, the distance travelled since the camera (``t_spread``) and the
prim's uv density, picks the level; PBRT_TPU_CONE_K scales the width).
Every other texture puts the scene outside the class, and so do bump maps:
the reference's megakernels render them without bumps (ROADMAP C), the
port sends them to the wavefront.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..scene.arrays import (
    LIGHT_DISTANT, LIGHT_POINT, LIGHT_SPOT, MAT_MIX, QUADRIC_SPHERE,
)
from . import nvcc
from .bsdf import (
    LOBE_FRESNEL_SPEC, LOBE_LAMBERT_R, LOBE_MICRO_R, LOBE_NONE, LOBE_OREN_NAYAR, LOBE_SPEC_R,
)

MAX_PRIMS = 16
MAX_LIGHTS = 4
MAX_MATS = MAX_PRIMS  # one material row per prim at most
SHADOW_EPS = 1e-4  # intersect.SHADOW_EPS
RAY_EPS = 1e-3  # integrator.RAY_EPS
DPB = 8  # sampler dimensions per bounce
INV_PI = float(1.0 / np.pi)
_EPS32 = float(np.finfo(np.float32).eps) * 0.5
# synthetic lobe id of the 2-lobe Lambert+GGX class (plastic): the reference
# writes it as two slots; the baked kernels fold it into one row with a
# per-sample lobe pick
LOBE_PLASTIC = 100

FLAG_FLIP_GEOM_N = 1
FLAG_HAS_SHADING_N = 2

SAMPLERS = {"zerotwosequence": 0, "lowdiscrepancy": 0, "random": 1, "stratified": 2}
IKINDS = {"path": 0, "directlighting": 1}

KERNEL_SOURCE = nvcc.CSRC / "megakernel.cu"

# ---------------------------------------------------------------------------
# The constant blob (float32; small integers stored as exact floats).
# Keep in lockstep with csrc/megakernel.cu.
# ---------------------------------------------------------------------------
H_N_PRIMS, H_N_LIGHTS, H_N_MATS, H_MAX_DEPTH, H_RR, H_UNIFORM, H_IKIND, H_SAMPLER = range(8)
H_STRAT_XS, H_STRAT_YS, H_WR2, H_FXW, H_FYW, H_MAX_LUM, H_G7, H_G53 = range(8, 16)
H_R2C = 16  # 16 floats, row-major 4x4 raster -> camera
H_C2W = 32  # 12 floats, row-major 3x4 camera -> world
H_CDF = 44  # MAX_LIGHTS floats
H_PMF = 48  # MAX_LIGHTS floats
H_CONE_PA = 52  # float32(cone_k) * float32(pixel_angle): the ray cone's spread per unit distance
HEADER = 64
LIGHT_STRIDE = 16  # kind, par[0:12], spot falloff denominator, pad
LIGHT_BASE = HEADER
PRIM_STRIDE = 48
PRIM_BASE = LIGHT_BASE + MAX_LIGHTS * LIGHT_STRIDE
MAT_STRIDE = 32
MAT_BASE = PRIM_BASE + MAX_PRIMS * PRIM_STRIDE
BLOB_FLOATS = MAT_BASE + MAX_MATS * MAT_STRIDE
# prim record: 0 kind (0 triangle, 1 sphere), 1 material slot, 2 flags, then
#   triangle: 3 v0, 6 v1, 9 v2, 12 ng, 15 ns, 18 ss, 21 ts (3 floats each),
#           24 uv0 uv1 uv2 (6), 30 the uv density sqrt(|duv cross| / |dp cross|)
#   sphere: 3 w2o (3x4), 15 o2w (3x4), 27 radius, 28 radius^2, 29 phimax,
#           30 the p_err constant terms gamma(3) |o2w[row][3]| (3 floats)
P_KIND, P_MAT, P_FLAGS = 0, 1, 2
P_V, P_NG, P_NS, P_SS, P_TS, P_UV, P_UVD = 3, 12, 15, 18, 21, 24, 30
P_W2O, P_O2W, P_R, P_R2, P_PHIMAX, P_ERRC = 3, 15, 27, 28, 29, 30
# material record: 0 lobe, 1 color(3), 4 eta, 5 kt(3), 8 fresnel, 9 ks(3),
#   12 ax, 13 ay, 14 fr_m, 15 eta_m, 16 eta_rgb(3), 19 k_rgb(3), 22 on_a,
#   23 on_b, 24 the Kd texture: 1 + its row of the texture table, 0 for none;
#   absent fields hold mat_select's defaults
M_LOBE, M_COLOR, M_ETA, M_KT, M_FRESNEL, M_KS, M_AX, M_AY = 0, 1, 4, 5, 8, 9, 12, 13
M_FR_M, M_ETA_M, M_ETA_RGB, M_K_RGB, M_ON_A, M_ON_B, M_TEX = 14, 15, 16, 19, 22, 23, 24
# the texture table (float32, one TEX_STRIDE row per atlas texture): level
# count, first atlas row, uscale, vscale, udelta, vdelta, scale, max(|uscale|,
# |vscale|, 1e-9), the level clamp's upper bound, then (row offset, height,
# width) per level from TX_LEVELS
TX_NLEV, TX_BASE, TX_US, TX_VS, TX_UD, TX_VD, TX_SCALE, TX_SMAX, TX_LMAX, TX_LEVELS = range(10)
TEX_STRIDE = 40
MAX_LEVELS = 8  # a 128 x 128 base: 128, 64, ..., 1
ATLAS_W = 128  # atlas row width in texels (the widest base level)
MAT_DEFAULTS = {"eta": 1.5, "fresnel": 0, "ax": 1e-3, "ay": 1e-3, "fr_m": 0, "eta_m": 1.5,
                "on_a": 1.0, "on_b": 0.0}


def _gamma(n: int) -> float:
    return n * _EPS32 / (1.0 - n * _EPS32)


def _f32(x) -> float:
    return float(np.float32(x))


# ---------------------------------------------------------------------------
# Host-side constant extraction and eligibility
# ---------------------------------------------------------------------------


def bake_lobe_entry(kinds, slots, ld_m, kd_tex=None):
    """Bake one material's active lobe slots into a kernel material entry,
    or return None when the combination is outside the kernel's class
    (reference megakernel.bake_lobe_entry). kd_tex, a textured Kd (B3's
    atlas texture, B4's checkerboard), rides the Lambert, Oren-Nayar or
    plastic lobe only."""
    tex = {} if kd_tex is None else {"kd_tex": kd_tex}
    if kinds == [LOBE_OREN_NAYAR]:
        # matte with sigma > 0 (reflection.rs OrenNayar :901); cosine
        # sampled like Lambert with the A/B retro factor in f
        d = ld_m[slots[0]]
        return {"lobe": LOBE_OREN_NAYAR, "color": d[0:3].astype(float).tolist(),
                "on_a": float(d[12]), "on_b": float(d[13]), **tex}
    if kinds in ([LOBE_MICRO_R], [LOBE_LAMBERT_R, LOBE_MICRO_R]):
        # GGX microfacet reflection (metal, plastic): slot order is
        # [lambert?, micro], the reference's active-slot pick order.
        # Beckmann (data[12] > 0) and Schlick Fresnel stay outside
        md = ld_m[slots[-1]]
        if float(md[12]) > 0:
            return None
        fr_kind = int(md[11])
        if fr_kind not in (0, 1, 2):
            return None
        two = len(kinds) == 2
        if kd_tex is not None and not two:
            return None  # a textured Kd needs the Lambert lobe
        return {
            "lobe": LOBE_PLASTIC if two else LOBE_MICRO_R,
            "color": ld_m[slots[0]][0:3].astype(float).tolist() if two else [0.0, 0.0, 0.0],
            "ks": md[0:3].astype(float).tolist(),
            "ax": float(md[9]), "ay": float(md[10]),
            "fr_m": fr_kind,
            "eta_m": float(max(float(md[3]), 1.0 + 1e-6)),
            "eta_rgb": md[3:6].astype(float).tolist(),
            "k_rgb": md[6:9].astype(float).tolist(),
            **tex,
        }
    if len(slots) != 1:
        return None
    kind = kinds[0]
    if kind not in (LOBE_LAMBERT_R, LOBE_SPEC_R, LOBE_FRESNEL_SPEC):
        return None
    if kd_tex is not None and kind != LOBE_LAMBERT_R:
        return None  # a textured Kd rides the Lambert lobe only
    d = ld_m[int(slots[0])]
    if kind == LOBE_SPEC_R and int(d[11]) not in (0, 1):
        return None
    return {"lobe": kind, "color": d[0:3].astype(float).tolist(),
            "eta": float(d[3]), "kt": d[6:9].astype(float).tolist(), "fresnel": int(d[11]), **tex}


def _h(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tri_frame(p):
    """Constant shading frame of a flat triangle (ng, ns, ss, ts), float64
    math rounded to float32 as the reference bakes it, and its uv density."""
    v0, v1, v2 = (p["v"][k].astype(np.float64) for k in range(3))
    e1, e2 = v1 - v0, v2 - v0
    ng = np.cross(e1, e2)
    nl = np.linalg.norm(ng)
    ng = ng / max(nl, 1e-30)
    if p["flags"] & FLAG_FLIP_GEOM_N:
        ng = -ng
    ns = ng
    uv = p["uv"].astype(np.float64)
    duv1, duv2 = uv[1] - uv[0], uv[2] - uv[0]
    det = duv1[0] * duv2[1] - duv1[1] * duv2[0]
    dpdu = (duv2[1] * e1 - duv1[1] * e2) / det if abs(det) > 1e-12 else e1
    ssp = dpdu - ns * float(np.dot(ns, dpdu))
    sl = np.linalg.norm(ssp)
    if sl > 1e-9:
        ss = ssp / sl
    else:  # coordinate_system fallback
        sign = 1.0 if ns[2] >= 0 else -1.0
        a = -1.0 / (sign + ns[2])
        b = ns[0] * ns[1] * a
        ss = np.array([1.0 + sign * ns[0] * ns[0] * a, sign * b, -sign * ns[0]])
    ts = np.cross(ns, ss)
    for key, vec in (("ng_c", ng), ("ns_c", ns), ("ss_c", ss), ("ts_c", ts)):
        p[key] = vec.astype(np.float32)
    # uv length per world length on the chart: turns the ray cone's world
    # width into a texture-space width (reference extract_consts :744)
    p["uvd_c"] = float(np.sqrt(abs(duv1[0] * duv2[1] - duv1[1] * duv2[0]) / max(nl, 1e-30)))


def _bake_imagemap_atlas(sa, xi: int, prog):
    """One imagemap program as a kernel mip atlas: ({"atlas" (rows, 128)
    f32, "offs" [(row offset, h, w)] per level, "uscale", "vscale",
    "udelta", "vdelta", "scale"}, None), or (None, the reason it is outside
    the class): the uv mapping, the repeat wrap, grayscale texels and a
    base level of at most 128 x 128 (reference megakernel._bake_imagemap_atlas
    :523)."""
    if prog.mapping != "uv" or prog.wrap != "repeat":
        return None, f"imagemaps with the '{prog.mapping}' mapping or the '{prog.wrap}' wrap"
    par = _h(sa.tex_param[xi]).astype(np.float64)
    levels = []
    for k in range(prog.n_levels):
        img = _h(sa.tex_images[f"{prog.image_key}_l{k}"]).astype(np.float32)
        if img.ndim != 3 or img.shape[2] != 3 or np.abs(img - img[:, :, :1]).max() > 1e-5:
            return None, "colored imagemaps"
        levels.append(img[:, :, 0])
    if not levels or levels[0].shape[0] > ATLAS_W or levels[0].shape[1] > ATLAS_W:
        return None, f"imagemaps larger than {ATLAS_W} x {ATLAS_W}"
    rows, offs, off = [], [], 0
    for g in levels:
        h, w = g.shape
        padded = np.zeros((h, ATLAS_W), np.float32)
        padded[:, :w] = g
        rows.append(padded)
        offs.append((off, h, w))
        off += h
    atlas = np.concatenate(rows, axis=0)
    if atlas.shape[0] % 8:  # the reference pads to a sublane multiple
        atlas = np.concatenate([atlas, np.zeros((8 - atlas.shape[0] % 8, ATLAS_W), np.float32)])
    return {"kind": "imagemap", "atlas": atlas, "offs": offs, "uscale": float(par[0]), "vscale": float(par[1]),
            "udelta": float(par[2]), "vdelta": float(par[3]),
            "scale": float(par[10]) if par[10] != 0 else 1.0}, None


def _pixel_angle(r2c):
    """Angular size of one pixel (the ray cone's spread): the camera-space
    length of a one-pixel raster step over the image plane's depth
    (reference extract_consts :763-769)."""
    p0 = r2c @ np.array([0.0, 0.0, 0.0, 1.0])
    p1 = r2c @ np.array([1.0, 0.0, 0.0, 1.0])
    p2 = r2c @ np.array([0.0, 1.0, 0.0, 1.0])
    z0 = max(abs(float(p0[2])), 1e-6)
    return float(max(np.linalg.norm((p1 - p0)[:3]), np.linalg.norm((p2 - p0)[:3])) / z0)


_QUADRIC_NAMES = ("sphere", "cylinder", "disk", "cone", "paraboloid", "hyperboloid")


def new_kind_refusal(cs, cam) -> str | None:
    """The first kind of the persistent wavefront's class that neither
    megakernel bakes, named, or None: orthographic and environment cameras
    (the reference's gate: cam kind != 0), goniometric and projection
    lights, quadrics other than spheres, object instancing, alpha cutouts
    (the reference's B3 never checks them and would render a cut-out
    triangle whole: the port refuses them, ROADMAP C) and the kd-tree; and
    of the per-sample wave's: medium interfaces, participating media, the
    interface material and the subsurface and kdsubsurface materials, and
    motion blur, animated cameras and the realistic camera (the reference's
    gates :577-579), which render.py never sends to a megakernel. Both
    extractors ask it first."""
    from .camera import CAM_PERSPECTIVE
    from ..scene.arrays import LIGHT_GONIO, LIGHT_PROJECTION, MAT_KDSUBSURFACE, MAT_NONE, MAT_SUBSURFACE

    static = cs.static
    if bool((cs.arrays.prim_medium >= 0).any()):
        return "medium interfaces"
    if static.n_media or static.camera_medium >= 0:
        return "participating media"
    for k, name in ((MAT_NONE, "interface"), (MAT_SUBSURFACE, "subsurface"), (MAT_KDSUBSURFACE, "kdsubsurface")):
        if k in static.mat_kinds_present:
            return f"the '{name}' material"
    if static.has_motion:
        return "motion blur"
    if cam.get("anim") is not None:
        return "animated cameras"
    kind = cam.get("kind", CAM_PERSPECTIVE)
    if kind != CAM_PERSPECTIVE:
        return f"'{cs.description.camera.kind}' cameras"
    for k, name in ((LIGHT_GONIO, "goniometric"), (LIGHT_PROJECTION, "projection")):
        if k in static.light_kinds:
            return f"{name} lights"
    for q in static.quadric_kinds:
        if q != QUADRIC_SPHERE:
            return f"'{_QUADRIC_NAMES[q]}' quadrics"
    if static.has_instances:
        return "object instancing"
    if static.has_alpha:
        return "alpha cutouts"
    if static.accel_kind == "kdtree":
        return "the 'kdtree' accelerator"
    return None


def _extract(cs, cam, icfg, scfg, fcfg):
    """(consts, None) for a scene of the kernel's class, else (None, the
    reason it is outside)."""
    import os

    from .lights import compute_power
    from .materials import lobes_at_origin
    from ..scene.arrays import P_KD

    sa, static = cs.arrays, cs.static
    why = new_kind_refusal(cs, cam)
    if why is not None:
        return None, why
    if not static.use_brute_force or static.n_prims == 0 or static.n_prims > MAX_PRIMS:
        return None, f"more than {MAX_PRIMS} primitives"
    if static.has_infinite or static.has_area_lights or static.n_media:
        return None, "area or infinite lights, or media"
    if static.has_motion:
        return None, "motion blur"
    if float(cam["lens_radius"]) != 0.0:
        return None, "thin-lens cameras"
    if scfg["kind"] not in SAMPLERS:
        return None, f"the '{scfg['kind']}' sampler"
    if fcfg["filter"] != "box":
        return None, f"the '{fcfg['filter']}' filter"
    if static.has_bump:
        return None, "bump maps"
    # constant textures bake into the lobes; uv-mapped grayscale imagemaps
    # ride the atlas; any other texture is outside
    imagemaps = {}
    for xi, prog in enumerate(static.tex_programs):
        if prog.kind == "constant":
            continue
        if prog.kind != "imagemap":
            return None, f"the '{prog.kind}' texture"
        atlas, why = _bake_imagemap_atlas(sa, xi, prog)
        if atlas is None:
            return None, why
        imagemaps[xi] = atlas
    if static.n_lights > MAX_LIGHTS:
        return None, f"more than {MAX_LIGHTS} lights"
    n_l = static.n_lights
    light_kind = _h(sa.light_kind)
    if not all(int(k) in (LIGHT_POINT, LIGHT_DISTANT, LIGHT_SPOT) for k in light_kind):
        return None, "lights other than point, spot and distant"
    light_param = _h(sa.light_param)

    # light selection pmf/cdf (integrator._light_selectors)
    strategy = str(icfg.get("light_strategy", "uniform"))
    uniform_select = not (n_l > 1 and strategy in ("power", "spatial"))
    if not uniform_select:
        if strategy == "spatial":
            return None, "the 'spatial' light distribution"
        pw = _h(compute_power(sa, static))
        pmf = np.maximum(pw / max(pw.sum(), 1e-20), 1e-6)
        pmf = pmf / pmf.sum()
    else:
        pmf = np.full(max(n_l, 1), 1.0 / max(n_l, 1), np.float32)
    cdf = np.cumsum(pmf)

    # prims in _brute_all order: all triangles (table order), then quadrics
    prim_mat, prim_flags, prim_light = _h(sa.prim_mat), _h(sa.prim_flags), _h(sa.prim_light)
    if (prim_light >= 0).any():
        return None, "emissive shapes"
    prims = []
    tri_p, tri_n, tri_uv, tri_pid = _h(sa.tri_p), _h(sa.tri_n), _h(sa.tri_uv), _h(sa.tri_prim_ids)
    for i in range(tri_p.shape[0]):
        pid = int(tri_pid[i])
        prims.append({"kind": "tri", "v": tri_p[i], "n": tri_n[i], "uv": tri_uv[i], "pid": pid,
                      "mat": int(prim_mat[pid]), "flags": int(prim_flags[pid])})
    sph_w2o, sph_o2w, sph_par = _h(sa.sph_w2o), _h(sa.sph_o2w), _h(sa.sph_param)
    sph_kind, sph_pid = _h(sa.sph_kind), _h(sa.sph_prim_ids)
    for i in range(sph_par.shape[0]):
        if int(sph_kind[i]) != QUADRIC_SPHERE:
            return None, "quadrics other than spheres"
        r = float(sph_par[i, 0])
        zmin, zmax, phimax = float(sph_par[i, 1]), float(sph_par[i, 2]), float(sph_par[i, 3])
        if not (zmin <= -r + 1e-7 * r and zmax >= r - 1e-7 * r and phimax >= 2 * np.pi - 1e-6):
            return None, "partial spheres"
        pid = int(sph_pid[i])
        prims.append({"kind": "sph", "w2o": sph_w2o[i], "o2w": sph_o2w[i], "r": r, "phimax": phimax,
                      "pid": pid, "mat": int(prim_mat[pid]), "flags": int(prim_flags[pid])})
    if len(prims) != static.n_prims:
        return None, "instanced or other primitive rows"

    # bake material lobes by evaluating the lobe builder once per row; a
    # row is in the class by its lobe set (bake_lobe_entry), not its kind
    if MAT_MIX in set(static.mat_kinds_present):
        return None, "mix materials"
    # the lobes of each row with its textures at the origin, as the
    # reference bakes them; an imagemap on the Kd slot becomes the row's
    # atlas texture (kd_tex: its index in kd_textures)
    lk, ld = (_h(x) for x in lobes_at_origin(sa, static))
    mat_tex = _h(sa.mat_tex)
    mats = {}
    kd_tid = {}
    for m in sorted({p["mat"] for p in prims}):
        for slot in range(mat_tex.shape[1]):
            tid = int(mat_tex[m, slot])
            if tid < 0 or tid not in imagemaps:
                continue
            if slot != P_KD:
                return None, "imagemaps on parameters other than Kd"
            kd_tid[m] = tid
    # in program order, as the reference stacks its atlas
    kd_textures = [imagemaps[t] for t in sorted(set(kd_tid.values()))]
    tex_row = {t: i for i, t in enumerate(sorted(set(kd_tid.values())))}
    for m in sorted({p["mat"] for p in prims}):
        slots = np.nonzero(lk[m])[0]
        if len(slots) == 0:
            mats[m] = {"lobe": LOBE_NONE}
            continue
        kd_tex = tex_row[kd_tid[m]] if m in kd_tid else None
        entry = bake_lobe_entry([int(lk[m, s]) for s in slots], [int(s) for s in slots], ld[m], kd_tex)
        if entry is None:
            return None, f"the lobe set {[int(lk[m, s]) for s in slots]} of material {m}"
        mats[m] = entry
    if any(mats[p["mat"]].get("kd_tex") is not None for p in prims if p["kind"] != "tri"):
        return None, "textured spheres (no uv is baked for them)"

    for p in prims:
        if p["kind"] == "tri":
            if p["flags"] & FLAG_HAS_SHADING_N:
                return None, "meshes with per-vertex normals"
            _tri_frame(p)
    # the atlas textures, stacked in kd_textures order, each with its first row
    kd_atlas = None
    if kd_textures:
        off = 0
        for t in kd_textures:
            t["base"] = off
            off += t["atlas"].shape[0]
        kd_atlas = np.concatenate([t["atlas"] for t in kd_textures], axis=0)
    r2c = _h(cam["raster_to_camera"]).astype(np.float64)

    consts = {
        "prims": prims,
        "mats": mats,
        "lights": [{"kind": int(light_kind[i]), "par": light_param[i].astype(float)} for i in range(n_l)],
        "light_cdf": cdf.astype(float).tolist(),
        "light_pmf": pmf.astype(float).tolist(),
        "uniform_select": uniform_select,
        "world_radius": float(_h(sa.world_radius)),
        "r2c": r2c,
        "c2w": _h(cam["camera_to_world"]).astype(np.float64),
        "filter_xw": float(fcfg["filter_params"].get("xwidth", 0.5)),
        "filter_yw": float(fcfg["filter_params"].get("ywidth", fcfg["filter_params"].get("xwidth", 0.5))),
        "max_depth": int(icfg["max_depth"]),
        "rr_threshold": float(icfg.get("rr_threshold", 1.0)),
        "sampler": scfg["kind"],
        "spp": int(scfg["spp"]),
        "max_lum": float(fcfg.get("max_sample_luminance", float("inf"))),
        "ikind": str(icfg.get("kind", "path")),
        "kd_textures": kd_textures,
        "kd_atlas": kd_atlas,
        "pixel_angle": _pixel_angle(r2c),
        # the ray cone's width factor, read as the reference reads it
        "cone_k": float(os.environ.get("PBRT_TPU_CONE_K", "1.0")),
    }
    if consts["ikind"] not in IKINDS:
        return None, f"the '{consts['ikind']}' integrator"
    if consts["ikind"] == "directlighting" and str(icfg.get("strategy", "all")) == "all" and n_l > 1:
        return None, "directlighting 'all' with more than one light"
    return consts, None


def extract_consts(cs, cam, icfg, scfg, fcfg):
    """Bake the scene into Python constants, or return None if the scene is
    outside the megakernel's class."""
    return _extract(cs, cam, icfg, scfg, fcfg)[0]


def explain_ineligible(cs, cam, icfg, scfg, fcfg) -> str | None:
    """What puts the scene outside the megakernel's class, or None."""
    return _extract(cs, cam, icfg, scfg, fcfg)[1]


def megakernel_eligible(cs, cam, icfg, scfg, fcfg) -> bool:
    try:
        return extract_consts(cs, cam, icfg, scfg, fcfg) is not None
    except NotImplementedError:
        return False


def _mat_slots(consts):
    """Material row -> dense slot of the packed material table."""
    return {m: i for i, m in enumerate(sorted(consts["mats"]))}


def pack_consts(consts) -> torch.Tensor:
    """The constants as one flat float32 CPU tensor of BLOB_FLOATS values in
    the layout of the H_*, P_* and M_* offsets above."""
    b = np.zeros(BLOB_FLOATS, np.float64)
    slots = _mat_slots(consts)
    spp = max(int(consts["spp"]), 1)
    xs = max(int(math.floor(math.sqrt(spp))), 1)
    b[H_N_PRIMS] = len(consts["prims"])
    b[H_N_LIGHTS] = len(consts["lights"])
    b[H_N_MATS] = len(slots)
    b[H_MAX_DEPTH] = consts["max_depth"]
    b[H_RR] = consts["rr_threshold"]
    b[H_UNIFORM] = 1.0 if consts["uniform_select"] else 0.0
    b[H_IKIND] = IKINDS[consts["ikind"]]
    b[H_SAMPLER] = SAMPLERS[consts["sampler"]]
    b[H_STRAT_XS] = xs
    b[H_STRAT_YS] = max(spp // xs, 1)
    b[H_WR2] = 2.0 * consts["world_radius"]
    b[H_FXW] = consts["filter_xw"]
    b[H_FYW] = consts["filter_yw"]
    b[H_MAX_LUM] = consts["max_lum"]
    b[H_G7] = _gamma(7)
    b[H_G53] = _gamma(5) + _gamma(3)
    b[H_CONE_PA] = _cone_pa(consts)
    b[H_R2C:H_R2C + 16] = np.asarray(consts["r2c"]).ravel()
    b[H_C2W:H_C2W + 12] = np.asarray(consts["c2w"])[:3, :].ravel()
    n_l = len(consts["lights"])
    b[H_CDF:H_CDF + n_l] = consts["light_cdf"][:n_l]
    b[H_PMF:H_PMF + n_l] = consts["light_pmf"][:n_l]
    for i, lt in enumerate(consts["lights"]):
        o = LIGHT_BASE + i * LIGHT_STRIDE
        par = np.asarray(lt["par"], np.float64)
        b[o] = lt["kind"]
        b[o + 1:o + 13] = par
        b[o + 13] = max(float(par[10]) - float(par[9]), 1e-9)
    for i, p in enumerate(consts["prims"]):
        o = PRIM_BASE + i * PRIM_STRIDE
        b[o + P_MAT] = slots[p["mat"]]
        b[o + P_FLAGS] = p["flags"]
        if p["kind"] == "tri":
            b[o + P_KIND] = 0
            b[o + P_V:o + P_V + 9] = np.asarray(p["v"], np.float64).ravel()
            for key, off in (("ng_c", P_NG), ("ns_c", P_NS), ("ss_c", P_SS), ("ts_c", P_TS)):
                b[o + off:o + off + 3] = p[key]
            b[o + P_UV:o + P_UV + 6] = np.asarray(p["uv"], np.float64).ravel()
            b[o + P_UVD] = p["uvd_c"]
        else:
            o2w = np.asarray(p["o2w"], np.float64)
            b[o + P_KIND] = 1
            b[o + P_W2O:o + P_W2O + 12] = np.asarray(p["w2o"], np.float64).ravel()
            b[o + P_O2W:o + P_O2W + 12] = o2w.ravel()
            b[o + P_R] = p["r"]
            b[o + P_R2] = p["r"] * p["r"]
            b[o + P_PHIMAX] = p["phimax"]
            b[o + P_ERRC:o + P_ERRC + 3] = [_gamma(3) * abs(o2w[row][3]) for row in range(3)]
    for m, s in slots.items():
        e = dict(MAT_DEFAULTS, **consts["mats"][m])
        o = MAT_BASE + s * MAT_STRIDE
        b[o + M_LOBE] = e["lobe"]
        for key, off, n in (("color", M_COLOR, 3), ("kt", M_KT, 3), ("ks", M_KS, 3),
                            ("eta_rgb", M_ETA_RGB, 3), ("k_rgb", M_K_RGB, 3)):
            if key in e:
                b[o + off:o + off + n] = e[key]
        for key, off in (("eta", M_ETA), ("fresnel", M_FRESNEL), ("ax", M_AX), ("ay", M_AY),
                         ("fr_m", M_FR_M), ("eta_m", M_ETA_M), ("on_a", M_ON_A), ("on_b", M_ON_B)):
            b[o + off] = e[key]
        b[o + M_TEX] = 0 if e.get("kd_tex") is None else 1 + e["kd_tex"]
    return torch.from_numpy(b.astype(np.float32))


def _cone_pa(consts) -> float:
    """float32(cone_k) * float32(pixel_angle), in float32, as the reference
    kernel forms the cone's spread."""
    return float(np.float32(consts.get("cone_k", 1.0)) * np.float32(consts.get("pixel_angle", 0.0)))


def pack_textures(consts):
    """The Kd atlas (rows, ATLAS_W) and the texture table (n_tex *
    TEX_STRIDE,) as float32 CPU tensors, or (None, None) without atlas
    textures."""
    if consts.get("kd_atlas") is None:
        return None, None
    tab = np.zeros(len(consts["kd_textures"]) * TEX_STRIDE, np.float64)
    for i, t in enumerate(consts["kd_textures"]):
        o = i * TEX_STRIDE
        n = len(t["offs"])
        if n > MAX_LEVELS:
            raise ValueError(f"an atlas texture has {n} levels, more than {MAX_LEVELS}")
        tab[o + TX_NLEV] = n
        tab[o + TX_BASE] = t["base"]
        tab[o + TX_US:o + TX_VD + 1] = t["uscale"], t["vscale"], t["udelta"], t["vdelta"]
        tab[o + TX_SCALE] = t["scale"]
        tab[o + TX_SMAX] = max(abs(t["uscale"]), abs(t["vscale"]), 1e-9)
        tab[o + TX_LMAX] = np.float32(n - 1) - np.float32(1e-4)
        tab[o + TX_LEVELS:o + TX_LEVELS + 3 * n] = np.asarray(t["offs"], np.float64).ravel()
    return (torch.from_numpy(np.ascontiguousarray(consts["kd_atlas"], np.float32)),
            torch.from_numpy(tab.astype(np.float32)))


# ---------------------------------------------------------------------------
# The plain PyTorch twin: _build_kernel over (R,) lane tensors
# ---------------------------------------------------------------------------

M32 = 0xFFFFFFFF
_ONE_MINUS_EPS = float(np.float32(1.0 - 2.0 ** -24))
_INV_2_32 = float(np.float32(2.3283064365386963e-10))


def _sobol2_matrix():
    v, a = [], 1 << 31
    for _ in range(32):
        v.append(a)
        a ^= a >> 1
    return v


_SOBOL2 = _sobol2_matrix()


def _pcg(x):
    """PCG output permutation of uint32 values held in int64."""
    state = (x * 747796405 + 2891336453) & M32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & M32
    return (word >> 22) ^ word


def _u2f01(u):
    """uint32 -> [0, 1) float32 as the kernel converts it: through the
    signed int32 view, plus 2^32 where negative, times 2^-32."""
    i = torch.where(u >= 2 ** 31, u - 2 ** 32, u)
    f = i.to(torch.float32)
    f = torch.where(f < 0, f + 4294967296.0, f)
    return torch.clamp(f * _INV_2_32, max=_ONE_MINUS_EPS)


def _reverse_bits(x):
    x = ((x << 16) & M32) | (x >> 16)
    x = ((x & 0x00FF00FF) << 8) | ((x & 0xFF00FF00) >> 8)
    x = ((x & 0x0F0F0F0F) << 4) | ((x & 0xF0F0F0F0) >> 4)
    x = ((x & 0x33333333) << 2) | ((x & 0xCCCCCCCC) >> 2)
    x = ((x & 0x55555555) << 1) | ((x & 0xAAAAAAAA) >> 1)
    return x


def _vdc(index, scramble):
    return _u2f01(_reverse_bits(index) ^ scramble)


def _sobol2(index, scramble):
    res = scramble
    for i in range(32):
        res = res ^ (((index >> i) & 1) * _SOBOL2[i])
    return _u2f01(res)


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _norm3(x, y, z):
    n = torch.sqrt(torch.clamp(x * x + y * y + z * z, min=0.0))
    inv = 1.0 / torch.clamp(n, min=1e-30)
    return x * inv, y * inv, z * inv


def _next_float_away(x, direction):
    bits = x.view(torch.int32)
    up = direction > 0
    moved = (bits + torch.where(up == (x >= 0), 1, -1).to(torch.int32)).view(torch.float32)
    tiny = 1.17549435e-38
    moved = torch.where(x == 0.0, torch.where(up, tiny, -tiny), moved)
    return torch.where(direction == 0.0, x, moved)


def _offset_ray(at, wx, wy, wz):
    d = at["ngx"].abs() * at["ex"] + at["ngy"].abs() * at["ey"] + at["ngz"].abs() * at["ez"]
    ox, oy, oz = d * at["ngx"], d * at["ngy"], d * at["ngz"]
    flip = _dot3(wx, wy, wz, at["ngx"], at["ngy"], at["ngz"]) < 0
    ox, oy, oz = (torch.where(flip, -c, c) for c in (ox, oy, oz))
    return (_next_float_away(at["px"] + ox, ox), _next_float_away(at["py"] + oy, oy),
            _next_float_away(at["pz"] + oz, oz))


def _concentric_disk(u1, u2):
    ox = 2.0 * u1 - 1.0
    oy = 2.0 * u2 - 1.0
    deg = (ox == 0) & (oy == 0)
    use_x = ox.abs() > oy.abs()
    safe_x = torch.where(ox == 0, 1.0, ox)
    safe_y = torch.where(oy == 0, 1.0, oy)
    r = torch.where(use_x, ox, oy)
    theta = torch.where(use_x, _f32(np.pi / 4.0) * (oy / safe_x), _f32(np.pi / 2.0) - _f32(np.pi / 4.0) * (ox / safe_y))
    r = torch.where(deg, 0.0, r)
    theta = torch.where(deg, 0.0, theta)
    return r * torch.cos(theta), r * torch.sin(theta)


def _fresnel_dielectric(cos_i, eta):
    """Dielectric Fresnel reflectance with eta_i = 1 and per-lane eta_t."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    entering = cos_i > 0
    ei = torch.where(entering, 1.0, eta)
    et = torch.where(entering, eta, 1.0)
    ci = cos_i.abs()
    sin_t = ei / et * torch.sqrt(torch.clamp(1.0 - ci * ci, min=0.0))
    ct = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
    r_parl = (et * ci - ei * ct) / torch.clamp(et * ci + ei * ct, min=1e-30)
    r_perp = (ei * ci - et * ct) / torch.clamp(ei * ci + et * ct, min=1e-30)
    return torch.where(sin_t >= 1.0, 1.0, 0.5 * (r_parl * r_parl + r_perp * r_perp))


def _fresnel_conductor(ci, eta_c, k_c):
    ci = torch.clamp(ci.abs(), 0.0, 1.0)
    cos2 = ci * ci
    sin2 = 1.0 - cos2
    eta2 = eta_c * eta_c
    k2 = k_c * k_c
    t0 = eta2 - k2 - sin2
    a2b2 = torch.sqrt(torch.clamp(t0 * t0 + 4.0 * eta2 * k2, min=0.0))
    t1 = a2b2 + cos2
    a_ = torch.sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0.0))
    t2 = 2.0 * a_ * ci
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-30)
    t3 = cos2 * a2b2 + sin2 * sin2
    t4 = t2 * sin2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-30)
    return 0.5 * (rp + rs)


def _ggx_d(hx, hy, hz, ax, ay):
    c2 = hz * hz
    e = torch.where(c2 > 1e-12, (hx * hx / torch.clamp(ax * ax, min=1e-12)
                                 + hy * hy / torch.clamp(ay * ay, min=1e-12)) / torch.clamp(c2, min=1e-12), 0.0)
    e1 = 1.0 + e
    denom = _f32(math.pi) * ax * ay * c2 * c2 * (e1 * e1)
    return torch.where(c2 > 1e-12, 1.0 / torch.clamp(denom, min=1e-20), 0.0)


def _ggx_lambda(x, y, z, ax, ay):
    c2 = z * z
    a2 = x * x * ax * ax + y * y * ay * ay
    alpha2_tan2 = torch.where(c2 > 1e-12, a2 / torch.clamp(c2, min=1e-12), 1e12)
    lam = 0.5 * (-1.0 + torch.sqrt(1.0 + alpha2_tan2))
    return torch.where(z.abs() > 1e-6, lam, 1e6)


def _ggx_sample_wh(wo_x, wo_y, wo_z, u1, u2, ax, ay):
    """Visible-normal GGX sampling (bsdf.ggx_sample_wh, channel form)."""
    flip = wo_z < 0
    wfx, wfy, wfz = (torch.where(flip, -c, c) for c in (wo_x, wo_y, wo_z))
    sx, sy, sz = _norm3(ax * wfx, ay * wfy, wfz)
    tl = torch.sqrt(torch.clamp(sx * sx + sy * sy, min=0.0))
    near_z = sz >= 0.9999
    inv_tl = 1.0 / torch.clamp(tl, min=1e-30)
    t1x = torch.where(near_z, 1.0, -sy * inv_tl)
    t1y = torch.where(near_z, 0.0, sx * inv_tl)
    t2x = sy * 0.0 - sz * t1y
    t2y = sz * t1x - sx * 0.0
    t2z = sx * t1y - sy * t1x
    a = 1.0 / (1.0 + sz)
    r = torch.sqrt(torch.clamp(u1, min=0.0))
    pi = _f32(math.pi)
    lower = u2 < a
    phi = torch.where(lower, u2 / torch.clamp(a, min=1e-12) * pi,
                      pi + (u2 - a) / torch.clamp(1.0 - a, min=1e-12) * pi)
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi) * torch.where(lower, 1.0, sz)
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nhx = p1 * t1x + p2 * t2x + p3 * sx
    nhy = p1 * t1y + p2 * t2y + p3 * sy
    nhz = p2 * t2z + p3 * sz
    hx, hy, hz = _norm3(ax * nhx, ay * nhy, torch.clamp(nhz, min=1e-6))
    return tuple(torch.where(flip, -c, c) for c in (hx, hy, hz))


def _local(at, x, y, z):
    return (_dot3(x, y, z, at["ssx"], at["ssy"], at["ssz"]), _dot3(x, y, z, at["tsx"], at["tsy"], at["tsz"]),
            _dot3(x, y, z, at["nsx"], at["nsy"], at["nsz"]))


def _samplers(is_random: bool):
    """(sample_1d, sample_2d) of the traced dimensions: the random and
    stratified samplers' uniform hash, or the (0,2) sequence, keyed by
    (hbase, sample, dimension) as the reference kernels key them."""

    def sample_1d(hbase, s_cur, dim):
        if is_random:
            return _u2f01(_pcg(_pcg(hbase ^ s_cur) ^ (1024 + dim)))
        return _vdc(s_cur, _pcg(hbase ^ (4096 + dim)))

    def sample_2d(hbase, s_cur, dim):
        d2 = 2 * dim
        if is_random:
            h = _pcg(hbase ^ s_cur)
            return _u2f01(_pcg(h ^ d2)), _u2f01(_pcg(h ^ (d2 + 1)))
        return _vdc(s_cur, _pcg(hbase ^ d2)), _sobol2(s_cur, _pcg(hbase ^ (d2 + 1)))

    return sample_1d, sample_2d


class _MatTable:
    """Per-lane material lookups over the baked rows (mat_select /
    mat_color / mat_mask of the reference): rows the scene does not use
    read the defaults and match no lobe."""

    def __init__(self, mats, dev):
        n = max(mats) + 2
        self.lobe = torch.full((n,), -1, dtype=torch.int64, device=dev)
        self.f = {}
        for key, default in MAT_DEFAULTS.items():
            self.f[key] = torch.full((n,), _f32(default), dtype=torch.float32, device=dev)
        for key in ("color", "kt", "ks", "eta_rgb", "k_rgb"):
            self.f[key] = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        for m, e in mats.items():
            self.lobe[m] = e["lobe"]
            for key, v in e.items():
                if key in self.f:
                    self.f[key][m] = torch.as_tensor(np.float32(v), device=dev)
        self.rows = sorted(mats)
        self.lobes = {e["lobe"] for e in mats.values()}
        self.any_mirror_die = any(e["lobe"] == LOBE_SPEC_R and e["fresnel"] == 1 for e in mats.values())
        self.dev = dev
        self.any_on = LOBE_OREN_NAYAR in self.lobes
        self.any_diffuse = bool(self.lobes & {LOBE_OREN_NAYAR, LOBE_LAMBERT_R, LOBE_PLASTIC})
        self.any_mirror = LOBE_SPEC_R in self.lobes
        self.any_glass = LOBE_FRESNEL_SPEC in self.lobes
        self.any_micro = bool(self.lobes & {LOBE_MICRO_R, LOBE_PLASTIC})
        self.any_plastic = LOBE_PLASTIC in self.lobes

    def in_lobes(self, mat, kinds):
        lobe = self.lobe[mat]
        out = torch.zeros(mat.shape, dtype=torch.bool, device=self.dev)
        for k in kinds:
            out = out | (lobe == k)
        return out

    def micro_f_pdf(self, mat, mic_m, wo_x, wo_y, wo_z, wi_x, wi_y, wi_z):
        """GGX f (rgb, no cosine) and visible-normal pdf toward wi."""
        axv, ayv = self.f["ax"][mat], self.f["ay"][mat]
        whx, why, whz = wi_x + wo_x, wi_y + wo_y, wi_z + wo_z
        wh_len = torch.sqrt(whx * whx + why * why + whz * whz)
        inv_l = 1.0 / torch.clamp(wh_len, min=1e-30)
        hx, hy, hz = whx * inv_l, why * inv_l, whz * inv_l
        d_val = _ggx_d(hx, hy, hz, axv, ayv)
        lam_o = _ggx_lambda(wo_x, wo_y, wo_z, axv, ayv)
        g_val = 1.0 / (1.0 + lam_o + _ggx_lambda(wi_x, wi_y, wi_z, axv, ayv))
        cos_f = (wi_x * hx + wi_y * hy + wi_z * hz) * torch.where(hz < 0, -1.0, 1.0)
        fr_m = self.f["fr_m"][mat]
        fd = _fresnel_dielectric(cos_f, self.f["eta_m"][mat])
        fr = []
        for ch in range(3):
            fc = _fresnel_conductor(cos_f, self.f["eta_rgb"][mat, ch], self.f["k_rgb"][mat, ch])
            fr.append(torch.where(fr_m == 1, fd, torch.where(fr_m == 2, fc, 1.0)))
        abs_ci, abs_co = wi_z.abs(), wo_z.abs()
        base = d_val * g_val / torch.clamp(4.0 * abs_co * abs_ci, min=1e-12)
        refl_hemi = wo_z * wi_z > 0
        ok = mic_m & refl_hemi & (wh_len > 1e-12) & (abs_ci > 0) & (abs_co > 0)
        f = [torch.where(ok, self.f["ks"][mat, ch] * fr[ch] * base, 0.0) for ch in range(3)]
        g1 = 1.0 / (1.0 + lam_o)
        dot_oh = (wo_x * hx + wo_y * hy + wo_z * hz).abs()
        p = d_val * g1 * dot_oh / torch.clamp(abs_co, min=1e-9) / torch.clamp(4.0 * dot_oh, min=1e-12)
        return f, torch.where(mic_m & refl_hemi, p, 0.0)

    def on_factor(self, mat, wo_x, wo_y, wo_z, wi_x, wi_y, wi_z):
        si = torch.sqrt(torch.clamp(1.0 - wi_z * wi_z, min=0.0))
        so = torch.sqrt(torch.clamp(1.0 - wo_z * wo_z, min=0.0))
        cpi = torch.where(si > 1e-4, wi_x / torch.clamp(si, min=1e-12), 1.0)
        spi = torch.where(si > 1e-4, wi_y / torch.clamp(si, min=1e-12), 0.0)
        cpo = torch.where(so > 1e-4, wo_x / torch.clamp(so, min=1e-12), 1.0)
        spo = torch.where(so > 1e-4, wo_y / torch.clamp(so, min=1e-12), 0.0)
        max_cos = torch.clamp(cpi * cpo + spi * spo, min=0.0)
        abs_ci, abs_co = wi_z.abs(), wo_z.abs()
        big_i = abs_ci > abs_co
        sin_alpha = torch.where(big_i, so, si)
        tan_beta = torch.where(big_i, si / torch.clamp(abs_ci, min=1e-9), so / torch.clamp(abs_co, min=1e-9))
        return _f32(INV_PI) * (self.f["on_a"][mat] + self.f["on_b"][mat] * max_cos * sin_alpha * tan_beta)

    def bsdf_sample(self, sample_1d, sample_2d, hbase, s_cur, dim_base, at, wox, woy, woz, mat, kd_over=None):
        """bsdf_sample for the baked lobe classes. kd_over: (R,) bool mask and
        (R, 3) Kd, a textured Kd in place of the row's color where the mask
        is set."""
        wo_x, wo_y, wo_z = _local(at, wox, woy, woz)
        u1, u2 = sample_2d(hbase, s_cur, dim_base + 3)
        false = torch.zeros(wox.shape, dtype=torch.bool, device=self.dev)
        lam_m = self.in_lobes(mat, (LOBE_LAMBERT_R, LOBE_PLASTIC))
        on_m = self.in_lobes(mat, (LOBE_OREN_NAYAR,))
        diff_like = lam_m | on_m
        mic_m = self.in_lobes(mat, (LOBE_MICRO_R, LOBE_PLASTIC))
        plast_m = self.in_lobes(mat, (LOBE_PLASTIC,))
        mirror_m = self.in_lobes(mat, (LOBE_SPEC_R,))
        glass_m = self.in_lobes(mat, (LOBE_FRESNEL_SPEC,))
        entering = wo_z > 0
        zero = torch.zeros_like(wox)
        wix = wiy = wiz = zero
        valid = ~self.in_lobes(mat, (LOBE_NONE,))
        eta = torch.clamp(self.f["eta"][mat], min=_f32(1.0 + 1e-6))
        if self.any_plastic:
            u_lobe = sample_1d(hbase, s_cur, dim_base + 2)
            n_act = torch.where(plast_m, 2, 1)
            pick = torch.minimum((u_lobe * n_act.to(torch.float32)).to(torch.int64), n_act - 1)
        else:
            pick = torch.zeros(wox.shape, dtype=torch.int64, device=self.dev)
        samp_diff = diff_like & (pick == 0)
        samp_mic = mic_m & (~lam_m | (pick == 1))
        if self.any_diffuse:
            ddx, ddy = _concentric_disk(u1, u2)
            dz = torch.sqrt(torch.clamp(1.0 - ddx * ddx - ddy * ddy, min=0.0))
            dz = torch.where(entering, dz, -dz)
            wix, wiy, wiz = (torch.where(samp_diff, a, b) for a, b in ((ddx, wix), (ddy, wiy), (dz, wiz)))
        if self.any_micro:
            hx, hy, hz = _ggx_sample_wh(wo_x, wo_y, wo_z, u1, u2, self.f["ax"][mat], self.f["ay"][mat])
            dwh = wo_x * hx + wo_y * hy + wo_z * hz
            wi_m = (-wo_x + 2.0 * dwh * hx, -wo_y + 2.0 * dwh * hy, -wo_z + 2.0 * dwh * hz)
            wix, wiy, wiz = (torch.where(samp_mic, a, b) for a, b in zip(wi_m, (wix, wiy, wiz)))
            valid = valid & (~samp_mic | (wo_z * wi_m[2] > 0))
        wi_sr = (-wo_x, -wo_y, wo_z)
        if self.any_mirror:
            wix, wiy, wiz = (torch.where(mirror_m, a, b) for a, b in zip(wi_sr, (wix, wiy, wiz)))
        if self.any_glass:
            fr_s = _fresnel_dielectric(wo_z, eta)
            choose_r = u1 < fr_s
            eta_ratio = torch.where(entering, 1.0 / eta, eta)
            nz = torch.where(entering, 1.0, -1.0)
            cos_i = nz * wo_z
            sin2_i = torch.clamp(1.0 - cos_i * cos_i, min=0.0)
            sin2_t = eta_ratio * eta_ratio * sin2_i
            cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
            wi_st = (eta_ratio * -wo_x, eta_ratio * -wo_y, eta_ratio * -wo_z + (eta_ratio * cos_i - cos_t) * nz)
            wix, wiy, wiz = (torch.where(glass_m, torch.where(choose_r, r_, t_), b)
                             for r_, t_, b in zip(wi_sr, wi_st, (wix, wiy, wiz)))
            valid = valid & ((sin2_t < 1.0) | ~(glass_m & ~choose_r))
        else:
            fr_s, choose_r, eta_ratio = zero, false, torch.ones_like(wox)
        wix, wiy, wiz = _norm3(wix, wiy, wiz)
        abs_ci = wiz.abs()
        kd = [self.f["color"][mat, ch] for ch in range(3)]
        if kd_over is not None:
            kd = [torch.where(kd_over[0], kd_over[1][:, ch], kd[ch]) for ch in range(3)]
        f_spec = [zero] * 3
        pdf_spec = zero
        inv_ci = 1.0 / torch.clamp(abs_ci, min=1e-9)
        if self.any_mirror:
            frm = torch.ones_like(wox)
            if self.any_mirror_die:
                frm = torch.where(mirror_m & (self.f["fresnel"][mat] == 1), _fresnel_dielectric(wo_z, eta), frm)
            f_spec = [torch.where(mirror_m, kd[ch] * frm * inv_ci, f_spec[ch]) for ch in range(3)]
            pdf_spec = torch.where(mirror_m, 1.0, pdf_spec)
        if self.any_glass:
            st_scale = eta_ratio * eta_ratio
            t_term = (1.0 - fr_s) * st_scale * inv_ci
            r_term = fr_s * inv_ci
            f_spec = [torch.where(glass_m, torch.where(choose_r, kd[ch] * r_term, self.f["kt"][mat, ch] * t_term),
                                  f_spec[ch]) for ch in range(3)]
            pdf_spec = torch.where(glass_m, torch.where(choose_r, fr_s, 1.0 - fr_s), pdf_spec)
        refl_hemi = wo_z * wiz > 0
        f_diff = torch.where(lam_m & refl_hemi, _f32(INV_PI), 0.0)
        if self.any_on:
            f_diff = torch.where(on_m & refl_hemi, self.on_factor(mat, wo_x, wo_y, wo_z, wix, wiy, wiz), f_diff)
        pdf_ns = torch.where(diff_like & refl_hemi, abs_ci * _f32(INV_PI), 0.0)
        f_ns = [kd[ch] * f_diff for ch in range(3)]
        if self.any_micro:
            fmic, p_m = self.micro_f_pdf(mat, mic_m, wo_x, wo_y, wo_z, wix, wiy, wiz)
            f_ns = [f_ns[ch] + fmic[ch] for ch in range(3)]
            pdf_ns = pdf_ns + p_m
            if self.any_plastic:
                pdf_ns = pdf_ns / torch.where(plast_m, 2.0, 1.0)
        specular = mirror_m | glass_m
        f_out = [torch.where(specular, f_spec[ch], f_ns[ch]) for ch in range(3)]
        pdf = torch.where(specular, pdf_spec, pdf_ns)
        transmissive = glass_m & ~choose_r
        eta_sc = torch.where(transmissive, torch.where(entering, eta * eta, 1.0 / (eta * eta)), 1.0)
        valid = valid & (pdf > 0)
        ww = tuple(wix * at["ss" + c] + wiy * at["ts" + c] + wiz * at["ns" + c] for c in "xyz")
        return {"ww": ww, "f": f_out, "pdf": pdf, "specular": specular, "valid": valid, "eta_scale": eta_sc,
                "kd": kd}


def _xf(m, x, y, z, point):
    """Rows 0-2 of a 3x4 matrix of floats applied to (x, y, z) lane tensors."""
    out = []
    for row in range(3):
        c = m[row][0] * x + m[row][1] * y + m[row][2] * z
        out.append(c + m[row][3] if point else c)
    return out


def _sph_consts(pr):
    """A baked full sphere's float32 constants, as the kernels read them
    (the csrc/pt_common.cuh sphere record), added to its dict pr."""
    g3 = _gamma(3)
    pr["w2o_c"] = [[_f32(x) for x in row] for row in pr["w2o"]]
    pr["o2w_c"] = [[_f32(x) for x in row] for row in pr["o2w"]]
    pr["r_c"], pr["r2_c"], pr["phimax_c"] = _f32(pr["r"]), _f32(pr["r"] * pr["r"]), _f32(pr["phimax"])
    pr["errc"] = [_f32(g3 * abs(float(pr["o2w"][row][3]))) for row in range(3)]
    return pr


def _sph_test(pr, ox, oy, oz, dx, dy, dz, t_query):
    """The kernels' full-sphere test (pt_common.cuh sph_test; reference
    megakernel._sph_test): (hit, t, the object-space hit before
    reprojection)."""
    oox, ooy, ooz = _xf(pr["w2o_c"], ox, oy, oz, True)
    odx, ody, odz = _xf(pr["w2o_c"], dx, dy, dz, False)
    a = _dot3(odx, ody, odz, odx, ody, odz)
    b = 2.0 * _dot3(oox, ooy, ooz, odx, ody, odz)
    c = _dot3(oox, ooy, ooz, oox, ooy, ooz) - pr["r2_c"]
    disc = b * b - 4.0 * a * c
    has_root = disc > 0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    q = torch.where(b < 0, -0.5 * (b - sq), -0.5 * (b + sq))
    safe = torch.where(q.abs() > 1e-30, q, 1.0)
    t0 = q / torch.where(a.abs() > 1e-30, a, 1e-30)
    t1 = c / safe
    tn = torch.minimum(t0, t1)
    tf = torch.maximum(t0, t1)
    near_valid = has_root & (tn > SHADOW_EPS) & (tn < t_query)
    far_valid = has_root & (tf > SHADOW_EPS) & (tf < t_query)
    t = torch.where(near_valid, tn, tf)
    return near_valid | far_valid, t, (oox + odx * t, ooy + ody * t, ooz + odz * t)


def _sph_attrs(pr, p_loc):
    """The kernels' sphere shading record (pt_common.cuh sph_attrs;
    reference megakernel._sph_attrs): the shading dict of lanes that hit
    the sphere pr at object-space p_loc."""
    g53 = _f32(_gamma(5) + _gamma(3))
    r = pr["r_c"]
    o2w, w2o = pr["o2w_c"], pr["w2o_c"]
    px_o, py_o, pz_o = p_loc
    norm = torch.sqrt(torch.clamp(px_o * px_o + py_o * py_o + pz_o * pz_o, min=1e-30))
    # the radius as a tensor: torch divides by a scalar (or a scalar by a
    # tensor) through a rounded reciprocal, the kernel with one division
    r = torch.full_like(norm, r)
    scale = r / torch.clamp(norm, min=1e-30)
    px_o, py_o, pz_o = px_o * scale, py_o * scale, pz_o * scale
    nx_o, ny_o, nz_o = px_o / r, py_o / r, pz_o / r
    ngx = w2o[0][0] * nx_o + w2o[1][0] * ny_o + w2o[2][0] * nz_o
    ngy = w2o[0][1] * nx_o + w2o[1][1] * ny_o + w2o[2][1] * nz_o
    ngz = w2o[0][2] * nx_o + w2o[1][2] * ny_o + w2o[2][2] * nz_o
    ngx, ngy, ngz = _norm3(ngx, ngy, ngz)
    if pr["flags"] & FLAG_FLIP_GEOM_N:
        ngx, ngy, ngz = -ngx, -ngy, -ngz
    pm = pr["phimax_c"]
    dux_o, duy_o = -pm * py_o, pm * px_o
    dux = o2w[0][0] * dux_o + o2w[0][1] * duy_o
    duy = o2w[1][0] * dux_o + o2w[1][1] * duy_o
    duz = o2w[2][0] * dux_o + o2w[2][1] * duy_o
    dot_nd = _dot3(ngx, ngy, ngz, dux, duy, duz)
    sx_p, sy_p, sz_p = dux - ngx * dot_nd, duy - ngy * dot_nd, duz - ngz * dot_nd
    sl = torch.sqrt(torch.clamp(sx_p * sx_p + sy_p * sy_p + sz_p * sz_p, min=0.0))
    ok = sl > 1e-9
    inv_sl = 1.0 / torch.clamp(sl, min=1e-20)
    sign = torch.where(ngz >= 0.0, 1.0, -1.0)
    a_f = -1.0 / (sign + ngz)
    b_f = ngx * ngy * a_f
    ssx = torch.where(ok, sx_p * inv_sl, 1.0 + sign * ngx * ngx * a_f)
    ssy = torch.where(ok, sy_p * inv_sl, sign * b_f)
    ssz = torch.where(ok, sz_p * inv_sl, -sign * ngx)
    pw = _xf(o2w, px_o, py_o, pz_o, True)
    apx, apy, apz = px_o.abs(), py_o.abs(), pz_o.abs()
    errs = [g53 * (abs(o2w[row][0]) * apx + abs(o2w[row][1]) * apy + abs(o2w[row][2]) * apz)
            + pr["errc"][row] for row in range(3)]
    zero = torch.zeros_like(pw[0])
    return {"px": pw[0], "py": pw[1], "pz": pw[2], "ngx": ngx, "ngy": ngy, "ngz": ngz,
            "nsx": ngx, "nsy": ngy, "nsz": ngz, "ssx": ssx, "ssy": ssy, "ssz": ssz,
            "tsx": ngy * ssz - ngz * ssy, "tsy": ngz * ssx - ngx * ssz, "tsz": ngx * ssy - ngy * ssx,
            "ex": errs[0], "ey": errs[1], "ez": errs[2], "b1": zero, "b2": zero}


def megakernel_plain(consts, px, py, pids, s0: int, n_samples: int, seed: int):
    """The kernel's estimator in plain PyTorch on any device: lanes px, py,
    pids (R,) integer tensors trace samples s0 .. s0+n_samples-1.

    Returns (accLw (R, 3), accW (R,), n_vertices (R,)), float32."""
    dev = px.device
    prims = [dict(p) for p in consts["prims"]]  # gains float32 copies of its constants below
    lights = consts["lights"]
    n_lights = len(lights)
    max_depth = consts["max_depth"]
    sampler = SAMPLERS[consts["sampler"]]
    is_random = sampler != 0
    spp = max(int(consts["spp"]), 1)
    strat_xs = max(int(math.floor(math.sqrt(spp))), 1)
    strat_ys = max(spp // strat_xs, 1)
    r2c = [[_f32(v) for v in row] for row in consts["r2c"]]
    c2w = [[_f32(v) for v in row] for row in consts["c2w"]]
    wr2 = _f32(2.0 * consts["world_radius"])
    fxw, fyw = _f32(consts["filter_xw"]), _f32(consts["filter_yw"])
    max_lum = consts["max_lum"]
    cap = n_samples * (max_depth + 2) + 8
    ikind = consts["ikind"]
    T = _MatTable(consts["mats"], dev)
    g7 = _f32(_gamma(7))

    sample_1d, sample_2d = _samplers(is_random)
    kd_textures = consts.get("kd_textures") or []
    any_kd_tex = bool(kd_textures)
    if any_kd_tex:
        atlas_t, tab_t = (x.to(dev) for x in pack_textures(consts))
        cone_pa = _cone_pa(consts)

    def eval_kd_tex(at, mat, t_tot, cosg):
        """The textured Kd of each lane whose material has an atlas texture:
        the ray cone's width at the hit picks a level, then a trilinear
        fetch over it and the next, v flipped (reference eval_kd_tex
        :1468-1574); returns (mask, (R, 3) grayscale Kd)."""
        world_fp = cone_pa * t_tot / torch.clamp(cosg, min=0.25)
        mask_any = torch.zeros(mat.shape, dtype=torch.bool, device=dev)
        val = torch.zeros_like(t_tot)
        for ti in range(len(kd_textures)):
            tx = tab_t[ti * TEX_STRIDE:(ti + 1) * TEX_STRIDE]
            m_mask = torch.zeros_like(mask_any)
            for m, e in consts["mats"].items():
                if e.get("kd_tex") == ti:
                    m_mask = m_mask | (mat == m)
            su = at["u"] * tx[TX_US] + tx[TX_UD]
            sv = at["v"] * tx[TX_VS] + tx[TX_VD]
            width = world_fp * at["uvd"] * tx[TX_SMAX]
            lvl = (tx[TX_NLEV] - 1.0) + torch.log2(torch.clamp(width, min=1e-8))
            lvl = torch.minimum(torch.clamp(lvl, min=0.0), tx[TX_LMAX])
            l0 = lvl.to(torch.int64)
            ft = lvl - l0.to(torch.float32)
            lv = tx[TX_LEVELS:TX_LEVELS + 3 * MAX_LEVELS].reshape(MAX_LEVELS, 3).to(torch.int64)
            base = int(tx[TX_BASE])

            def bil(lsel):
                off_l, h_l, w_l = lv[lsel, 0], lv[lsel, 1], lv[lsel, 2]
                x = (su - torch.floor(su)) * w_l.to(torch.float32) - 0.5
                y = (1.0 - (sv - torch.floor(sv))) * h_l.to(torch.float32) - 0.5
                ix, iy = torch.floor(x).to(torch.int64), torch.floor(y).to(torch.int64)
                fx, fy = x - ix.to(torch.float32), y - iy.to(torch.float32)
                ixm, iym = torch.remainder(ix, w_l), torch.remainder(iy, h_l)
                ixp, iyp = torch.remainder(ixm + 1, w_l), torch.remainder(iym + 1, h_l)
                ra, rb = base + off_l + iym, base + off_l + iyp
                return atlas_t[ra, ixm], atlas_t[ra, ixp], atlas_t[rb, ixm], atlas_t[rb, ixp], fx, fy

            a0, b0, c0, d0, fx0, fy0 = bil(l0)
            a1, b1, c1, d1, fx1, fy1 = bil(torch.clamp(l0 + 1, max=len(kd_textures[ti]["offs"]) - 1))
            t00 = (1 - ft) * (1 - fy0) * (1 - fx0) * a0 + (1 - ft) * (1 - fy0) * fx0 * b0
            t01 = (1 - ft) * fy0 * (1 - fx0) * c0 + (1 - ft) * fy0 * fx0 * d0
            t10 = ft * (1 - fy1) * (1 - fx1) * a1 + ft * (1 - fy1) * fx1 * b1
            t11 = ft * fy1 * (1 - fx1) * c1 + ft * fy1 * fx1 * d1
            val = torch.where(m_mask, (t00 + t01 + t10 + t11) * tx[TX_SCALE], val)
            mask_any = mask_any | m_mask
        return mask_any, torch.stack([val, val, val], dim=-1)

    def tri_test(v, ox, oy, oz, permute, sx, sy, sz, t_query):
        def shear(c):
            px_, py_, pz_ = permute(v[c][0] - ox, v[c][1] - oy, v[c][2] - oz)
            return px_ + sx * pz_, py_ + sy * pz_, sz * pz_

        x0, y0, z0 = shear(0)
        x1, y1, z1 = shear(1)
        x2, y2, z2 = shear(2)
        e0 = x1 * y2 - y1 * x2
        e1 = x2 * y0 - y2 * x0
        e2 = x0 * y1 - y0 * x1
        same = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0))
        det = e0 + e1 + e2
        dok = det != 0
        inv_det = torch.where(dok, 1.0 / torch.where(dok, det, 1.0), 0.0)
        t = (e0 * z0 + e1 * z1 + e2 * z2) * inv_det
        hit = same & dok & (t > SHADOW_EPS) & (t < t_query)
        return hit, t, e1 * inv_det, e2 * inv_det

    # float32 values of every prim constant, as the kernel reads them
    for pr in prims:
        if pr["kind"] == "tri":
            pr["v_c"] = [[_f32(x) for x in row] for row in pr["v"]]
            pr["uv_c"] = [[_f32(x) for x in row] for row in pr["uv"]]
        else:
            _sph_consts(pr)

    attr_keys = ("px", "py", "pz", "ngx", "ngy", "ngz", "nsx", "nsy", "nsz", "ssx", "ssy", "ssz",
                 "tsx", "tsy", "tsz", "ex", "ey", "ez", "b1", "b2") + (("u", "v", "uvd") if any_kd_tex else ())

    def intersect_all(ox, oy, oz, dx, dy, dz, t_query, want_attrs):
        """Brute-force closest hit (want_attrs) or any hit over all prims."""
        adx, ady, adz = dx.abs(), dy.abs(), dz.abs()
        k0 = (adx >= ady) & (adx >= adz)
        k1 = ~k0 & (ady >= adz)

        def permute(vx, vy, vz):
            return (torch.where(k0, vy, torch.where(k1, vz, vx)), torch.where(k0, vz, torch.where(k1, vx, vy)),
                    torch.where(k0, vx, torch.where(k1, vy, vz)))

        dpx, dpy, dpz = permute(dx, dy, dz)
        inv_dz = 1.0 / dpz
        sx, sy, sz = -dpx * inv_dz, -dpy * inv_dz, inv_dz
        big = 1e30
        t_best = torch.full_like(ox, big)
        zero = torch.zeros_like(ox)
        attrs = {k: zero for k in attr_keys}
        attrs["mat"] = torch.zeros(ox.shape, dtype=torch.int64, device=dev)
        hit_any = torch.zeros(ox.shape, dtype=torch.bool, device=dev)
        for pr in prims:
            if pr["kind"] == "tri":
                v = pr["v_c"]
                h_p, t_p, b1_p, b2_p = tri_test(v, ox, oy, oz, permute, sx, sy, sz, t_query)
            else:
                h_p, t_p, p_loc = _sph_test(pr, ox, oy, oz, dx, dy, dz, t_query)
            hit_any = hit_any | h_p
            if not want_attrs:
                continue
            t_p = torch.where(h_p, t_p, big)
            better = t_p < t_best
            t_best = torch.where(better, t_p, t_best)
            if pr["kind"] == "tri":
                b0_p = 1.0 - b1_p - b2_p
                at = {}
                for c, key in enumerate(("px", "py", "pz")):
                    at[key] = b0_p * v[0][c] + b1_p * v[1][c] + b2_p * v[2][c]
                for c, key in enumerate(("ex", "ey", "ez")):
                    at[key] = g7 * (b0_p.abs() * abs(v[0][c]) + b1_p.abs() * abs(v[1][c]) + b2_p.abs() * abs(v[2][c]))
                for vec, keys in ((pr["ng_c"], ("ngx", "ngy", "ngz")), (pr["ns_c"], ("nsx", "nsy", "nsz")),
                                  (pr["ss_c"], ("ssx", "ssy", "ssz")), (pr["ts_c"], ("tsx", "tsy", "tsz"))):
                    for c, key in enumerate(keys):
                        at[key] = float(vec[c])
                at["b1"], at["b2"] = b1_p, b2_p
                if any_kd_tex:
                    st = pr["uv_c"]
                    at["u"] = b0_p * st[0][0] + b1_p * st[1][0] + b2_p * st[2][0]
                    at["v"] = b0_p * st[0][1] + b1_p * st[1][1] + b2_p * st[2][1]
                    at["uvd"] = _f32(pr["uvd_c"])
            else:
                at = _sph_attrs(pr, p_loc)
                if any_kd_tex:  # textured spheres are outside the class
                    at.update(u=attrs["u"], v=attrs["v"], uvd=attrs["uvd"])
            for key in attr_keys:
                attrs[key] = torch.where(better, at[key], attrs[key])
            attrs["mat"] = torch.where(better, pr["mat"], attrs["mat"])
        if want_attrs:
            return t_best < big, t_best, attrs
        return hit_any

    def camera_ray(pxf, pyf):
        cx = r2c[0][0] * pxf + r2c[0][1] * pyf + r2c[0][3]
        cy = r2c[1][0] * pxf + r2c[1][1] * pyf + r2c[1][3]
        cz = r2c[2][0] * pxf + r2c[2][1] * pyf + r2c[2][3]
        w = r2c[3][0] * pxf + r2c[3][1] * pyf + r2c[3][3]
        inv_w = 1.0 / w
        dx, dy, dz = _norm3(cx * inv_w, cy * inv_w, cz * inv_w)
        wx, wy, wz = _norm3(*_xf(c2w, dx, dy, dz, False))
        return (torch.full_like(pxf, c2w[0][3]), torch.full_like(pxf, c2w[1][3]), torch.full_like(pxf, c2w[2][3]),
                wx, wy, wz)

    def regen(hbase, px_f, py_f, s_sel):
        if is_random:
            h = _pcg(hbase ^ s_sel)
            u1, u2 = _u2f01(_pcg(h)), _u2f01(_pcg(h ^ 1))
            if sampler == 2:
                # the reference's own strata: floor(sqrt(spp)) x spp // that,
                # always jittered (ROADMAP C)
                idx = s_sel % (strat_xs * strat_ys)
                u1 = ((idx % strat_xs).to(torch.float32) + u1) / float(strat_xs)
                u2 = (((idx // strat_xs) % strat_ys).to(torch.float32) + u2) / float(strat_ys)
        else:
            u1, u2 = _vdc(s_sel, _pcg(hbase)), _sobol2(s_sel, _pcg(hbase ^ 1))
        dx = (2.0 * u1 - 1.0) * fxw
        dy = (2.0 * u2 - 1.0) * fyw
        return camera_ray(px_f + 0.5 + dx, py_f + 0.5 + dy)

    def nee(hbase, s_cur, dim_base, alive_sh, at, wox, woy, woz, mat, kd):
        """uniform_sample_onelight + estimate_direct for delta lights."""
        lam_m = T.in_lobes(mat, (LOBE_LAMBERT_R, LOBE_PLASTIC))
        if n_lights > 1:
            u_sel = sample_1d(hbase, s_cur, dim_base)
            if consts["uniform_select"]:
                lid = torch.clamp((u_sel * float(n_lights)).to(torch.int64), max=n_lights - 1)
            else:
                lid = torch.zeros(u_sel.shape, dtype=torch.int64, device=dev)
                for i in range(n_lights - 1):
                    lid = lid + (u_sel > _f32(consts["light_cdf"][i])).to(torch.int64)
                lid = torch.clamp(lid, 0, n_lights - 1)
        else:
            lid = torch.zeros(wox.shape, dtype=torch.int64, device=dev)
        # dims dim_base+1 are drawn (and unused) for stream parity
        zero = torch.zeros_like(wox)
        wix, wiy, wiz, lir, lig, lib, dist, spdf = (zero,) * 8
        for i, lt in enumerate(lights):
            m = lid == i
            par = [_f32(x) for x in lt["par"]]
            if lt["kind"] == LIGHT_DISTANT:
                vals = (par[0], par[1], par[2], par[3], par[4], par[5], wr2)
            else:
                tx, ty, tz = par[0] - at["px"], par[1] - at["py"], par[2] - at["pz"]
                d2 = torch.clamp(tx * tx + ty * ty + tz * tz, min=1e-12)
                dl = torch.sqrt(d2)
                inv = 1.0 / dl
                wxa, wya, wza = tx * inv, ty * inv, tz * inv
                fall = 1.0
                if lt["kind"] == LIGHT_SPOT:
                    cos_t = -(wxa * par[6] + wya * par[7] + wza * par[8])
                    ctw, cfs = par[9], par[10]
                    dfall = torch.clamp((cos_t - ctw) / _f32(max(float(lt["par"][10]) - float(lt["par"][9]), 1e-9)),
                                        0.0, 1.0)
                    df2 = dfall * dfall
                    fall = torch.where(cos_t < ctw, 0.0, torch.where(cos_t > cfs, 1.0, df2 * df2))
                vals = (wxa, wya, wza, par[3] * fall / d2, par[4] * fall / d2, par[5] * fall / d2, dl)
            wix, wiy, wiz, lir, lig, lib, dist = (torch.where(m, v, cur) for v, cur in
                                                 zip(vals, (wix, wiy, wiz, lir, lig, lib, dist)))
            spdf = torch.where(m, _f32(consts["light_pmf"][i]), spdf)

        refl = (_dot3(wix, wiy, wiz, at["ngx"], at["ngy"], at["ngz"])
                * _dot3(wox, woy, woz, at["ngx"], at["ngy"], at["ngz"])) > 0
        cos_ns = _dot3(wix, wiy, wiz, at["nsx"], at["nsy"], at["nsz"]).abs()
        fm = lam_m & refl
        f = [torch.where(fm, kd[ch] * _f32(INV_PI) * cos_ns, 0.0) for ch in range(3)]
        if T.any_micro or T.any_on:
            wo_l = _local(at, wox, woy, woz)
            wi_l = _local(at, wix, wiy, wiz)
        if T.any_on:
            onf = T.on_factor(mat, *wo_l, *wi_l)
            onm = T.in_lobes(mat, (LOBE_OREN_NAYAR,)) & refl
            f = [torch.where(onm, kd[ch] * onf * cos_ns, f[ch]) for ch in range(3)]
        if T.any_micro:
            fmic, _p = T.micro_f_pdf(mat, T.in_lobes(mat, (LOBE_MICRO_R, LOBE_PLASTIC)), *wo_l, *wi_l)
            f = [f[ch] + torch.where(refl, fmic[ch] * cos_ns, 0.0) for ch in range(3)]
        li = (lir, lig, lib)
        contributes = alive_sh & (spdf > 0) & ((f[0] * lir > 0) | (f[1] * lig > 0) | (f[2] * lib > 0))
        osx, osy, osz = _offset_ray(at, wix, wiy, wiz)
        t_sh = torch.where(contributes, dist * _f32(1.0 - 2.0 * RAY_EPS), -1.0)
        occ = intersect_all(osx, osy, osz, wix, wiy, wiz, t_sh, want_attrs=False)
        vis = torch.where(occ, 0.0, 1.0)
        inv_pl = 1.0 / torch.clamp(spdf, min=1e-30)
        return [torch.where(contributes, f[ch] * li[ch] * vis * inv_pl, 0.0) for ch in range(3)]

    # --- the persistent loop -------------------------------------------------
    px_f = px.to(torch.float32)
    py_f = py.to(torch.float32)
    seed_u = int(seed) & M32
    hbase = _pcg(_pcg(torch.tensor(0x9E3779B9 ^ seed_u, dtype=torch.int64, device=dev)) ^ (pids.to(torch.int64) & M32))
    R = px.shape[0]
    s_cur = torch.full((R,), int(s0) & M32, dtype=torch.int64, device=dev)
    ox, oy, oz, dx, dy, dz = regen(hbase, px_f, py_f, s_cur)
    zero = torch.zeros(R, dtype=torch.float32, device=dev)
    alive = torch.full((R,), n_samples > 0, dtype=torch.bool, device=dev)
    done = ~alive
    L = [zero] * 3
    beta = [zero + 1.0] * 3
    aL = [zero] * 3
    aW = zero
    nv = zero
    eta_acc = zero + 1.0
    t_spread = zero  # the ray cone's distance since the camera
    bounces = torch.zeros(R, dtype=torch.int64, device=dev)
    s_end = (int(s0) + int(n_samples)) & M32
    it = 0
    while it < cap and bool((~done).any()):
        it += 1
        t_query = torch.where(alive, float("inf"), -1.0)
        valid, t_best, at = intersect_all(ox, oy, oz, dx, dy, dz, t_query, want_attrs=True)
        nv = nv + torch.where(alive & valid, 1.0, 0.0)
        alive_b = alive & valid
        wox, woy, woz = -dx, -dy, -dz
        dim_base = 2 + bounces * DPB
        can_scatter = alive_b & (bounces < max_depth - 1)
        mat = at["mat"]
        alive_sh = can_scatter & ~T.in_lobes(mat, (LOBE_NONE,))
        kd_over = None
        t_tot = t_spread
        if any_kd_tex:
            cosg = _dot3(dx, dy, dz, at["ngx"], at["ngy"], at["ngz"]).abs()
            t_tot = t_spread + torch.where(alive_b, t_best, 0.0)
            kd_over = eval_kd_tex(at, mat, t_tot, cosg)
        bs = T.bsdf_sample(sample_1d, sample_2d, hbase, s_cur, dim_base, at, wox, woy, woz, mat, kd_over)
        if n_lights > 0:
            c = nee(hbase, s_cur, dim_base, alive_sh, at, wox, woy, woz, mat, bs["kd"])
            L = [L[ch] + beta[ch] * c[ch] for ch in range(3)]
        wwx, wwy, wwz = bs["ww"]
        cos_term = _dot3(wwx, wwy, wwz, at["nsx"], at["nsy"], at["nsz"]).abs()
        inv_pdf = cos_term / torch.clamp(bs["pdf"], min=1e-30)
        th = [bs["f"][ch] * inv_pdf for ch in range(3)]
        surf_cont = alive_sh & bs["valid"] & ((th[0] > 0) | (th[1] > 0) | (th[2] > 0))
        if ikind == "directlighting":
            surf_cont = surf_cont & bs["specular"]
        new_b = [torch.where(surf_cont, beta[ch] * th[ch], beta[ch]) for ch in range(3)]
        nox, noy, noz = _offset_ray(at, wwx, wwy, wwz)
        new_o = [torch.where(surf_cont, a, b) for a, b in ((nox, ox), (noy, oy), (noz, oz))]
        new_d = [torch.where(surf_cont, a, b) for a, b in ((wwx, dx), (wwy, dy), (wwz, dz))]
        eta_acc = torch.where(surf_cont, eta_acc * bs["eta_scale"], eta_acc)
        new_bounces = bounces + surf_cont.to(torch.int64)
        new_alive = surf_cont
        if ikind == "path":
            # russian roulette (path.rs:206-214)
            max_c = torch.maximum(new_b[0] * eta_acc, torch.maximum(new_b[1] * eta_acc, new_b[2] * eta_acc))
            q = torch.clamp(1.0 - max_c, min=0.05)
            do_rr = (new_bounces > 3) & (max_c < _f32(consts["rr_threshold"]))
            killed = do_rr & (sample_1d(hbase, s_cur, dim_base + 4) < q)
            new_alive = new_alive & ~killed
            boost = 1.0 / torch.clamp(1.0 - q, min=1e-6)
            keepm = do_rr & ~killed
            new_b = [torch.where(keepm, new_b[ch] * boost, new_b[ch]) for ch in range(3)]
        # --- flush finished samples, regenerate or retire ---
        die = ~done & ~new_alive
        fin = torch.isfinite(L[0]) & torch.isfinite(L[1]) & torch.isfinite(L[2])
        Lf = [torch.clamp(torch.where(fin, L[ch], 0.0), min=0.0) for ch in range(3)]
        if max_lum < float("inf"):
            y = Lf[0] * 0.212671 + Lf[1] * 0.715160 + Lf[2] * 0.072169
            scl = torch.where(y > max_lum, _f32(max_lum) / torch.clamp(y, min=1e-12), 1.0)
            Lf = [Lf[ch] * scl for ch in range(3)]
        aL = [aL[ch] + torch.where(die, Lf[ch], 0.0) for ch in range(3)]
        aW = aW + torch.where(die, 1.0, 0.0)
        s_next = (s_cur + 1) & M32
        more = die & (s_next < s_end)
        done = done | (die & ~more)
        r_ = regen(hbase, px_f, py_f, torch.where(more, s_next, s_cur))
        ox, oy, oz = (torch.where(more, a, b) for a, b in zip(r_[:3], new_o))
        dx, dy, dz = (torch.where(more, a, b) for a, b in zip(r_[3:], new_d))
        L = [torch.where(more, 0.0, L[ch]) for ch in range(3)]
        beta = [torch.where(more, 1.0, new_b[ch]) for ch in range(3)]
        alive = new_alive | more
        eta_acc = torch.where(more, 1.0, eta_acc)
        bounces = torch.where(more, 0, new_bounces)
        s_cur = torch.where(more, s_next, s_cur)
        # the cone's distance grows along continuations, restarts at the camera
        t_spread = torch.where(more, 0.0, torch.where(surf_cont, t_tot, t_spread))
    return torch.stack(aL, dim=-1), aW, nv


# ---------------------------------------------------------------------------
# The CUDA kernel and the render route
# ---------------------------------------------------------------------------


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_uint, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
# The record of the instrumented instantiation, u64 in the order of
# csrc/megakernel.cu SPLIT_*: slot-cycles of the slots whose path was tested,
# in the test pool, in shading + NEE and in flush + regeneration; of slots
# that waited for their shadow ray; of empty slots (the grid's tail); of the
# whole launch; thread-cycles of the pool phase; thread-cycles in which a
# thread had pool or shading work; block iterations. Then the tests the
# launch made: closest rays, shadow rays, and the triangle and sphere tests
# those shadow rays made up to their first hit.
SPLIT_FIELDS = ("pool", "shade_nee", "flush_regen", "wait", "idle_tail", "total", "pool_lanes", "pool_busy",
                "shade_busy", "iterations", "closest", "shadow", "shadow_tri", "shadow_sph")


def build_kernel() -> dict:
    """Compile (if needed) and load csrc/megakernel.cu: {"lib", "seconds",
    "log", "path"} as device/nvcc.build returns it."""
    info = nvcc.build(KERNEL_SOURCE)
    lib = info["lib"]
    lib.brute_megakernel.argtypes = _ARGTYPES
    lib.brute_megakernel.restype = ctypes.c_int
    lib.brute_megakernel_split.argtypes = _ARGTYPES + [ctypes.c_void_p]
    lib.brute_megakernel_split.restype = ctypes.c_int
    return info


N_PLAIN_MODES = 6  # sampler (3) x integrator kind (2)


def kernel_mode(consts) -> int:
    """The kernel's template selector: tex * 6 + sampler * 2 + integrator
    kind, tex = 1 for the textured instantiation (atlas textures in the
    scene), which alone reads the atlas and carries the cone's distance."""
    tex = consts.get("kd_atlas") is not None
    return int(tex) * N_PLAIN_MODES + SAMPLERS[consts["sampler"]] * 2 + IKINDS[consts["ikind"]]


def occupancy(mode: int) -> int:
    """Resident blocks per SM of the kernel for one mode."""
    return nvcc.occupancy(build_kernel()["lib"].brute_megakernel_occupancy, mode)


def _launch(entry: str, blob, mode: int, px, py, pids, s0: int, n_samples: int, seed: int, atlas, tex, *extra):
    dev = px.device
    if dev.type != "cuda":
        raise ValueError("megakernel_cuda takes CUDA tensors")
    if blob.device != dev or blob.dtype != torch.float32 or blob.numel() != BLOB_FLOATS:
        raise ValueError(f"blob must be {BLOB_FLOATS} float32 values on {dev}")
    if mode >= N_PLAIN_MODES:
        for name, x in (("atlas", atlas), ("tex", tex)):
            if x is None or x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
                raise ValueError(f"the textured mode {mode} needs {name} as a contiguous float32 tensor on {dev}")
        if atlas.dim() != 2 or atlas.shape[1] != ATLAS_W or tex.numel() % TEX_STRIDE:
            raise ValueError(f"atlas must be (rows, {ATLAS_W}) and tex n x {TEX_STRIDE} floats")
    R = px.shape[0]
    lanes = []
    for name, x in (("px", px), ("py", py), ("pids", pids)):
        if x.device != dev or x.shape != (R,) or x.dtype.is_floating_point:
            raise ValueError(f"{name} must be an integer ({R},) tensor on {dev}")
        lanes.append(x.to(torch.int32).contiguous())
    blob = blob.contiguous()
    fn = getattr(build_kernel()["lib"], entry)
    out_l = torch.empty((R, 3), dtype=torch.float32, device=dev)
    out_w = torch.empty(R, dtype=torch.float32, device=dev)
    out_nv = torch.empty(R, dtype=torch.float32, device=dev)
    w = megakernel_cuda
    counters = w.counters.get(dev)
    if counters is None:
        counters = w.counters.setdefault(dev, torch.zeros(1, dtype=torch.int32, device=dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    queue = w.queues.get((dev, stream))
    if queue is None:  # next pixel, finished blocks; the grid's last block zeroes both
        queue = w.queues.setdefault((dev, stream), torch.zeros(2, dtype=torch.int32, device=dev))
    with torch.cuda.device(dev):  # the C entry launches on the calling thread's current device
        err = fn(blob.data_ptr(), lanes[0].data_ptr(), lanes[1].data_ptr(), lanes[2].data_ptr(), R,
                 int(seed) & M32, int(s0) & M32, int(n_samples), int(mode),
                 out_l.data_ptr(), out_w.data_ptr(), out_nv.data_ptr(), counters.data_ptr(), queue.data_ptr(),
                 None if atlas is None else atlas.data_ptr(), None if tex is None else tex.data_ptr(),
                 stream, *(x.data_ptr() for x in extra))
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    return out_l, out_w, out_nv


def megakernel_cuda(blob, mode: int, px, py, pids, s0: int, n_samples: int, seed: int, atlas=None, tex=None):
    """Launch the CUDA kernel on the current stream. blob: pack_consts's
    float32 tensor on the lanes' device; mode: kernel_mode(consts); px, py,
    pids: (R,) integer CUDA tensors; atlas, tex: pack_textures's tensors on
    the lanes' device, for a textured mode. Returns (accLw (R, 3), accW (R,),
    n_vertices (R,)) float32. Adds one to ``megakernel_cuda.launches`` per
    launch; the pixels cut by the iteration cap accumulate in
    ``megakernel_cuda.counters[device]`` (int32 (1,)); raises on a refused
    launch."""
    out = _launch("brute_megakernel", blob, mode, px, py, pids, s0, n_samples, seed, atlas, tex)
    nvcc.count_launch(megakernel_cuda)
    return out


def megakernel_split(blob, mode: int, px, py, pids, s0: int, n_samples: int, seed: int):
    """megakernel_cuda through the instrumented instantiation, which exists
    for mode 0 only ((0,2) sampler, path) and which no route launches:
    returns (accLw, accW, n_vertices, split), split mapping SPLIT_FIELDS to
    cycle and test counts summed over the launch."""
    prof = torch.zeros(len(SPLIT_FIELDS), dtype=torch.int64, device=px.device)
    out = _launch("brute_megakernel_split", blob, mode, px, py, pids, s0, n_samples, seed, None, None, prof)
    return (*out, dict(zip(SPLIT_FIELDS, prof.tolist())))


megakernel_cuda.launches = 0
megakernel_cuda.counters = {}  # device -> int32 (1,): pixels cut by the iteration cap
megakernel_cuda.queues = {}  # (device, stream) -> int32 (2,): next pixel, finished blocks


def make_megakernel_fn(cs, cam, icfg, scfg, fcfg, consts=None):
    """The wave_p-compatible persistent function backed by the megakernel:
    fn(sa, px, py, pids, s0, n_samples, seed) -> (accLw (R, 3), accW (R,),
    n_vertices (R,)), or None if the scene is outside the class. CUDA lanes
    launch the kernel, CPU lanes run the plain twin; there is no fallback
    from one to the other. fn.blob (on the scene's device) and fn.mode are
    the kernel's arguments for the scene's consts."""
    if consts is None:
        consts = extract_consts(cs, cam, icfg, scfg, fcfg)
    if consts is None:
        return None
    blob_cpu = pack_consts(consts)
    tex_cpu = pack_textures(consts)
    mode = kernel_mode(consts)

    def upload(dev):
        return blob_cpu.to(dev), *(None if x is None else x.to(dev) for x in tex_cpu)

    # uploaded here, not in the first launch, so a render's timed loop holds
    # only the launch
    blobs = {cs.arrays.device: upload(cs.arrays.device)}

    def wave_p(sa, px, py, pixel_ids, s0, n_samples, seed):
        del sa  # the scene is in the constants
        if px.device.type == "cuda":
            args = blobs.get(px.device)
            if args is None:
                args = blobs[px.device] = upload(px.device)
            blob, atlas, tex = args
            return megakernel_cuda(blob, mode, px, py, pixel_ids, s0, n_samples, seed, atlas, tex)
        if px.device.type == "cpu":
            return megakernel_plain(consts, px, py, pixel_ids, s0, n_samples, seed)
        raise ValueError(f"the brute megakernel has no implementation for device {px.device}")

    # what the launch takes, for tools that time or instrument the route's
    # own launch (tools/torch_phases.py, chip_smoke.py)
    wave_p.blob, wave_p.atlas, wave_p.tex = blobs[cs.arrays.device]
    wave_p.mode = mode
    return wave_p
