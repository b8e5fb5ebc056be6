"""Wide persistent path-tracing megakernel: the hand-written CUDA kernel
(``csrc/megakernel_wide.cu``) and its plain PyTorch twin.

The port's counterpart of ``pbrt_tpu/device/megakernel_wide.py``: the whole
persistent path loop for triangle scenes, with the closest-hit and shadow
walks of the wide BVH inside the kernel. Its class here: triangle-only
wide-BVH scenes with flat shading and default UVs; constant-parameter
materials of the six lobe classes ``bake_lobe_entry`` bakes (at most 16
used); at most 8 lights among one- or two-sided triangle area lights and
point, spot and distant lights, with uniform or power selection; pinhole and
thin-lens perspective cameras; the box filter; the (0,2), random and
stratified samplers (stratified without a lens, and with the reference's
own strata, ROADMAP C); the path integrator with its Russian-roulette
threshold and sample clamp; at most ``max_tris`` triangles (the route
reads PBRT_TPU_WIDEMEGA_MAX_TRIS, default 4096).

- ``extract_wide_consts`` / ``wide_megakernel_eligible`` /
  ``explain_ineligible_wide``: the reference's gates for this class, and
  the same baked constants; anything outside the class gives None and a
  reason. The reference's two TPU memory budgets are not carried over.
- ``pack_wide_consts``: lights, materials, camera and header as one flat
  float32 blob (layout below), beside the wide BVH's node records and leaf
  rows (``scene/widebvh.hopper_layout``) the only things the CUDA kernel
  reads.
- ``wide_megakernel_plain``: the same per-lane loop over (R,) tensors,
  reusing the brute megakernel's plain helpers and ``traverse_plain`` for
  both walks.
- ``wide_megakernel_cuda``: builds the kernel at first use, launches it on
  its persistent grid with a zeroed pixel counter, counts launches, pops,
  stack overflows and iteration-cap hits; ``wide_megakernel_split``
  launches the instrumented instantiation (the cycle split per phase,
  ``SPLIT_FIELDS``) for tools/torch_phases.py, and ``occupancy`` returns
  the kernel's resident blocks per SM.
- ``make_wide_megakernel_fn``: the wave_p-compatible function of the render
  route; CUDA tensors launch the kernel, CPU tensors run the plain twin.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..scene.arrays import (
    GEOM_SPHERE, LIGHT_AREA, LIGHT_DISTANT, LIGHT_INFINITE, LIGHT_POINT, LIGHT_SPOT, MAT_MIX,
)
from . import nvcc
from .bsdf import LOBE_LAMBERT_R, LOBE_MICRO_R, LOBE_NONE, LOBE_OREN_NAYAR
from .megakernel import (
    DPB, FLAG_FLIP_GEOM_N, FLAG_HAS_SHADING_N, INV_PI, LOBE_PLASTIC, M32, MAT_DEFAULTS, MAT_STRIDE, RAY_EPS,
    SAMPLERS, _concentric_disk, _dot3, _f32, _gamma, _h, _local, _MatTable, _norm3, _offset_ray, _pcg, _samplers,
    _sobol2, _u2f01, _vdc, bake_lobe_entry,
)
from .wide_bvh import _check_tables, traverse_plain

MAX_MATS = 16
MAX_LIGHTS = 8
DEFAULT_MAX_TRIS = 4096  # the reference's PBRT_TPU_WIDEMEGA_MAX_TRIS default
SAMPLER_NAMES = ("zerotwosequence", "lowdiscrepancy", "random", "stratified")

KERNEL_SOURCE = nvcc.CSRC / "megakernel_wide.cu"

# ---------------------------------------------------------------------------
# The constant blob (float32; small integers stored as exact floats).
# Keep in lockstep with csrc/megakernel_wide.cu.
# ---------------------------------------------------------------------------
H_N_LIGHTS, H_N_MATS, H_MAX_DEPTH, H_RR, H_UNIFORM, H_SAMPLER, H_STRAT_XS, H_STRAT_YS = range(8)
H_WR2, H_FXW, H_FYW, H_MAX_LUM, H_G7, H_LENS_R, H_FOCAL = range(8, 15)  # 15 unused
H_R2C = 16  # 16 floats, row-major 4x4 raster -> camera
H_C2W = 32  # 12 floats, row-major 3x4 camera -> world
H_CDF = 44  # MAX_LIGHTS floats
H_PMF = 52  # MAX_LIGHTS floats
HEADER = 64
LIGHT_STRIDE = 32
LIGHT_BASE = HEADER
MAT_BASE = LIGHT_BASE + MAX_LIGHTS * LIGHT_STRIDE
BLOB_FLOATS = MAT_BASE + MAX_MATS * MAT_STRIDE
# light record: 0 kind, 1 par (12), 13 spot falloff denominator (the brute
# megakernel's record), then for a triangle area light 14 area,
# 15 two-sided, 16 v0 v1 v2 (9), 25 ng (3)
L_KIND, L_PAR, L_SPOT_DEN, L_AREA, L_TWO_SIDED, L_V, L_NG = 0, 1, 13, 14, 15, 16, 25
# material record: device/megakernel.py's M_* fields, plus 31 the material
# row the slot bakes (the prim table's payload names rows, not slots)
M_ROW = 31


# ---------------------------------------------------------------------------
# Host-side constant extraction and eligibility
# ---------------------------------------------------------------------------


def _extract(cs, cam, icfg, scfg, fcfg, max_tris):
    """(consts, None) for a scene of the kernel's class, else (None, the
    reason it is outside), in the reference's gate order."""
    from .lights import compute_power
    from .materials import bake_lobes

    sa, static = cs.arrays, cs.static
    if not static.has_wide or sa.wnode_rec is None:
        return None, "scenes without the wide-BVH tables (at most 64 prims, or quadrics)"
    if static.n_tris > max_tris:
        return None, f"more than {max_tris} triangles (PBRT_TPU_WIDEMEGA_MAX_TRIS)"
    if static.n_media:
        return None, "participating media"
    if int(sa.sph_kind.shape[0]):
        return None, "spheres (baked quadrics)"
    if static.has_motion:
        return None, "motion blur"
    kind = scfg["kind"]
    if kind not in SAMPLER_NAMES:
        return None, f"the '{kind}' sampler"
    if kind == "stratified" and float(cam["lens_radius"]) != 0.0:
        return None, "the stratified sampler with a lens"
    if fcfg["filter"] != "box":
        return None, f"the '{fcfg['filter']}' filter"
    n_l = static.n_lights
    if n_l > MAX_LIGHTS or n_l == 0:
        return None, f"more than {MAX_LIGHTS} lights, or none"
    prim_flags = _h(sa.prim_flags)
    if (prim_flags & FLAG_HAS_SHADING_N).any():
        return None, "per-vertex shading normals (the attribute table)"
    tri_uv = _h(sa.tri_uv)
    default_uv = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]], np.float32)
    if tri_uv.shape[0] and not np.array_equal(tri_uv, np.broadcast_to(default_uv, tri_uv.shape)):
        return None, "UV charts (the attribute table)"

    strategy = str(icfg.get("light_strategy", "uniform"))
    if strategy == "spatial" and n_l > 1:
        return None, "the 'spatial' light distribution"
    uniform_select = not (n_l > 1 and strategy in ("power", "spatial"))
    if not uniform_select:
        pw = _h(compute_power(sa, static))
        pmf = np.maximum(pw / max(pw.sum(), 1e-20), 1e-6)
        pmf = pmf / pmf.sum()
    else:
        pmf = np.full(max(n_l, 1), 1.0 / max(n_l, 1), np.float32)
    cdf = np.cumsum(pmf)

    light_kind, light_param, light_prim = _h(sa.light_kind), _h(sa.light_param), _h(sa.light_prim)
    prim_area, prim_geom, prim_kind = _h(sa.prim_area), _h(sa.prim_geom), _h(sa.prim_kind)
    tri_p = _h(sa.tri_p)
    lights = []
    for i in range(n_l):
        k = int(light_kind[i])
        if k in (LIGHT_POINT, LIGHT_DISTANT, LIGHT_SPOT):
            lights.append({"kind": k, "par": light_param[i].astype(float)})
        elif k == LIGHT_INFINITE:
            return None, "the constant infinite light"
        elif k == LIGHT_AREA:
            pid = int(light_prim[i])
            if int(prim_kind[pid]) == GEOM_SPHERE:
                return None, "sphere area lights"
            v = tri_p[prim_geom[pid]].astype(np.float64)
            ng = np.cross(v[1] - v[0], v[2] - v[0])
            ng = ng / max(np.linalg.norm(ng), 1e-30)
            if prim_flags[pid] & FLAG_FLIP_GEOM_N:
                ng = -ng
            lights.append({"kind": k, "par": light_param[i].astype(float), "v": v, "ng": ng,
                           "area": float(prim_area[pid]), "two_sided": bool(light_param[i][3] > 0)})
        else:
            return None, f"lights of kind {k}"

    if MAT_MIX in set(static.mat_kinds_present):
        return None, "mix materials"
    prim_mat = _h(sa.prim_mat)
    used_mats = sorted(set(int(m) for m in prim_mat))
    if len(used_mats) > MAX_MATS:
        return None, f"more than {MAX_MATS} materials"
    try:
        lk, ld = (_h(x) for x in bake_lobes(sa, static))
    except NotImplementedError:
        return None, "materials other than matte, mirror, glass, metal and plastic"
    mat_tex = _h(sa.mat_tex)
    mats = {}
    for m in used_mats:
        if (mat_tex[m] >= 0).any():
            return None, "textured material parameters (the checkerboard Kd)"
        slots = np.nonzero(lk[m])[0]
        if len(slots) == 0:
            mats[m] = {"lobe": LOBE_NONE}
            continue
        entry = bake_lobe_entry([int(lk[m, s]) for s in slots], [int(s) for s in slots], ld[m])
        if entry is None:
            return None, f"the lobe set {[int(lk[m, s]) for s in slots]} of material {m}"
        mats[m] = entry

    fp = fcfg["filter_params"]
    return {
        "has_ns": False,
        "has_attr": False,
        "mats": mats,
        "lights": lights,
        "spheres": [],
        "light_cdf": cdf.astype(float).tolist(),
        "light_pmf": pmf.astype(float).tolist(),
        "uniform_select": uniform_select,
        "world_radius": float(_h(sa.world_radius)),
        "wide_root": int(static.wide_root),
        "r2c": _h(cam["raster_to_camera"]).astype(np.float64),
        "c2w": _h(cam["camera_to_world"]).astype(np.float64),
        "lens_radius": float(cam["lens_radius"]),
        "focal_distance": float(cam["focal_distance"]),
        "filter": fcfg["filter"],
        "filter_params": dict(fp),
        "filter_xw": float(fp.get("xwidth", 0.5)),
        "filter_yw": float(fp.get("ywidth", fp.get("xwidth", 0.5))),
        "max_depth": int(icfg["max_depth"]),
        "rr_threshold": float(icfg.get("rr_threshold", 1.0)),
        "sampler": kind,
        "spp": int(scfg["spp"]),
        "halton": None,
        "sobol": None,
        "maxmin": None,
        "max_lum": float(fcfg.get("max_sample_luminance", float("inf"))),
    }, None


def extract_wide_consts(cs, cam, icfg, scfg, fcfg, max_tris):
    """Bake everything but the geometry (which rides the wide tables) into
    Python constants, or return None if the scene is outside the class.
    max_tris: the triangle cap (the route reads PBRT_TPU_WIDEMEGA_MAX_TRIS,
    default DEFAULT_MAX_TRIS)."""
    return _extract(cs, cam, icfg, scfg, fcfg, max_tris)[0]


def explain_ineligible_wide(cs, cam, icfg, scfg, fcfg, max_tris) -> str | None:
    """What puts the scene outside the wide megakernel's class, or None."""
    return _extract(cs, cam, icfg, scfg, fcfg, max_tris)[1]


def wide_megakernel_eligible(cs, cam, icfg, scfg, fcfg, max_tris) -> bool:
    return extract_wide_consts(cs, cam, icfg, scfg, fcfg, max_tris) is not None


def pack_wide_consts(consts) -> torch.Tensor:
    """The constants as one flat float32 CPU tensor of BLOB_FLOATS values in
    the layout of the H_*, L_* and M_* offsets above (material records as
    device/megakernel.py's, in ascending row order)."""
    from .megakernel import (
        M_AX, M_AY, M_COLOR, M_ETA, M_ETA_M, M_ETA_RGB, M_FR_M, M_FRESNEL, M_K_RGB, M_KS, M_KT, M_LOBE, M_ON_A,
        M_ON_B,
    )

    b = np.zeros(BLOB_FLOATS, np.float64)
    spp = max(int(consts["spp"]), 1)
    xs = max(int(math.floor(math.sqrt(spp))), 1)
    lights = consts["lights"]
    b[H_N_LIGHTS] = len(lights)
    b[H_N_MATS] = len(consts["mats"])
    b[H_MAX_DEPTH] = consts["max_depth"]
    b[H_RR] = consts["rr_threshold"]
    b[H_UNIFORM] = 1.0 if consts["uniform_select"] else 0.0
    b[H_SAMPLER] = SAMPLERS[consts["sampler"]]
    b[H_STRAT_XS] = xs
    b[H_STRAT_YS] = max(spp // xs, 1)
    b[H_WR2] = 2.0 * consts["world_radius"]
    b[H_FXW] = consts["filter_xw"]
    b[H_FYW] = consts["filter_yw"]
    b[H_MAX_LUM] = consts["max_lum"]
    b[H_G7] = _gamma(7)
    b[H_LENS_R] = consts["lens_radius"]
    b[H_FOCAL] = consts["focal_distance"]
    b[H_R2C:H_R2C + 16] = np.asarray(consts["r2c"]).ravel()
    b[H_C2W:H_C2W + 12] = np.asarray(consts["c2w"])[:3, :].ravel()
    b[H_CDF:H_CDF + len(lights)] = consts["light_cdf"][:len(lights)]
    b[H_PMF:H_PMF + len(lights)] = consts["light_pmf"][:len(lights)]
    for i, lt in enumerate(lights):
        o = LIGHT_BASE + i * LIGHT_STRIDE
        par = np.asarray(lt["par"], np.float64)
        b[o + L_KIND] = lt["kind"]
        b[o + L_PAR:o + L_PAR + 12] = par
        b[o + L_SPOT_DEN] = max(float(par[10]) - float(par[9]), 1e-9)
        if lt["kind"] == LIGHT_AREA:
            b[o + L_AREA] = lt["area"]
            b[o + L_TWO_SIDED] = 1.0 if lt["two_sided"] else 0.0
            b[o + L_V:o + L_V + 9] = np.asarray(lt["v"], np.float64).ravel()
            b[o + L_NG:o + L_NG + 3] = lt["ng"]
    for s, m in enumerate(sorted(consts["mats"])):
        e = dict(MAT_DEFAULTS, **consts["mats"][m])
        o = MAT_BASE + s * MAT_STRIDE
        b[o + M_ROW] = m
        b[o + M_LOBE] = e["lobe"]
        for key, off, n in (("color", M_COLOR, 3), ("kt", M_KT, 3), ("ks", M_KS, 3),
                            ("eta_rgb", M_ETA_RGB, 3), ("k_rgb", M_K_RGB, 3)):
            if key in e:
                b[o + off:o + off + n] = e[key]
        for key, off in (("eta", M_ETA), ("fresnel", M_FRESNEL), ("ax", M_AX), ("ay", M_AY),
                         ("fr_m", M_FR_M), ("eta_m", M_ETA_M), ("on_a", M_ON_A), ("on_b", M_ON_B)):
            b[o + off] = e[key]
    return torch.from_numpy(b.astype(np.float32))


def kernel_mode(consts) -> int:
    """The kernel's template selector: sampler * 2 + (any area light)."""
    any_area = any(lt["kind"] == LIGHT_AREA for lt in consts["lights"])
    return SAMPLERS[consts["sampler"]] * 2 + int(any_area)


# ---------------------------------------------------------------------------
# The plain PyTorch twin: the kernel's per-lane loop over (R,) lane tensors
# ---------------------------------------------------------------------------


def _power_heuristic(f, g):
    f2, g2 = f * f, g * g
    return torch.where(f > 0, f2 / torch.clamp(f2 + g2, min=1e-30), 0.0)


def wide_megakernel_plain(consts, sa, px, py, pids, s0: int, n_samples: int, seed: int):
    """The kernel's estimator in plain PyTorch on any device: lanes px, py,
    pids (R,) integer tensors trace samples s0 .. s0+n_samples-1 through the
    scene tensors sa (wide tables and the prim rows they index).

    Returns (accLw (R, 3), accW (R,), n_vertices (R,)), float32."""
    dev = px.device
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
    lens_r, focal = _f32(consts["lens_radius"]), _f32(consts["focal_distance"])
    wr2 = _f32(2.0 * consts["world_radius"])
    fxw, fyw = _f32(consts["filter_xw"]), _f32(consts["filter_yw"])
    max_lum = consts["max_lum"]
    cap = n_samples * (max_depth + 2) + 8
    T = _MatTable(consts["mats"], dev)
    sample_1d, sample_2d = _samplers(is_random)
    g7 = _f32(_gamma(7))
    any_area = any(lt["kind"] == LIGHT_AREA for lt in lights)
    pmf = [_f32(x) for x in consts["light_pmf"]]
    # per light row, for the emission pickup: radiance, area, sidedness, pmf
    le_t = torch.zeros((max(n_lights, 1), 3), dtype=torch.float32, device=dev)
    area_t = torch.ones(max(n_lights, 1), dtype=torch.float32, device=dev)
    two_t = torch.zeros(max(n_lights, 1), dtype=torch.bool, device=dev)
    selp_t = torch.zeros(max(n_lights, 1), dtype=torch.float32, device=dev)
    for i, lt in enumerate(lights):
        if lt["kind"] == LIGHT_AREA:
            le_t[i] = torch.as_tensor(np.float32(lt["par"][0:3]), device=dev)
            area_t[i] = _f32(lt["area"])
            two_t[i] = bool(lt["two_sided"])
            selp_t[i] = pmf[i]

    def camera(hbase, px_f, py_f, s_sel):
        """regen: film dimension 0 through the box filter, lens dimension 1."""
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
        fx = px_f + 0.5 + (2.0 * u1 - 1.0) * fxw
        fy = py_f + 0.5 + (2.0 * u2 - 1.0) * fyw
        cx = r2c[0][0] * fx + r2c[0][1] * fy + r2c[0][3]
        cy = r2c[1][0] * fx + r2c[1][1] * fy + r2c[1][3]
        cz = r2c[2][0] * fx + r2c[2][1] * fy + r2c[2][3]
        w = r2c[3][0] * fx + r2c[3][1] * fy + r2c[3][3]
        inv_w = 1.0 / w
        dx, dy, dz = _norm3(cx * inv_w, cy * inv_w, cz * inv_w)
        if lens_r > 0:
            # thin-lens depth of field (perspective.rs generate_ray)
            if is_random:
                h = _pcg(hbase ^ s_sel)
                ul1, ul2 = _u2f01(_pcg(h ^ 2)), _u2f01(_pcg(h ^ 3))
            else:
                ul1, ul2 = _vdc(s_sel, _pcg(hbase ^ 2)), _sobol2(s_sel, _pcg(hbase ^ 3))
            llx, lly = _concentric_disk(ul1, ul2)
            llx, lly = lens_r * llx, lens_r * lly
            ft = focal / torch.clamp(dz, min=1e-9)
            dx, dy, dz = _norm3(dx * ft - llx, dy * ft - lly, dz * ft)
            o = [c2w[r][0] * llx + c2w[r][1] * lly + c2w[r][2] * 0.0 + c2w[r][3] for r in range(3)]
        else:
            o = [torch.full_like(px_f, c2w[r][3]) for r in range(3)]
        wx, wy, wz = _norm3(*(c2w[r][0] * dx + c2w[r][1] * dy + c2w[r][2] * dz for r in range(3)))
        return o[0], o[1], o[2], wx, wy, wz

    def tri_attrs(prim, b1, b2):
        """surface_interaction's flat, default-UV triangle branch."""
        v = sa.tri_p[sa.prim_geom[prim].long()]  # (R, 3, 3): the prim row's vertices
        b0 = 1.0 - b1 - b2
        e1 = [v[:, 1, c] - v[:, 0, c] for c in range(3)]
        e2 = [v[:, 2, c] - v[:, 0, c] for c in range(3)]
        ngx, ngy, ngz = _norm3(e1[1] * e2[2] - e1[2] * e2[1], e1[2] * e2[0] - e1[0] * e2[2],
                               e1[0] * e2[1] - e1[1] * e2[0])
        flip = (sa.prim_flags[prim] & FLAG_FLIP_GEOM_N) != 0
        ngx, ngy, ngz = (torch.where(flip, -c, c) for c in (ngx, ngy, ngz))
        d_dot = ngx * e1[0] + ngy * e1[1] + ngz * e1[2]
        ssx, ssy, ssz = e1[0] - ngx * d_dot, e1[1] - ngy * d_dot, e1[2] - ngz * d_dot
        sl = torch.sqrt(ssx * ssx + ssy * ssy + ssz * ssz)
        ok = sl > 1e-9
        inv_sl = 1.0 / torch.clamp(sl, min=1e-20)
        csg = torch.where(ngz >= 0, 1.0, -1.0)
        a = -1.0 / (csg + ngz)
        bb = ngx * ngy * a
        ssx = torch.where(ok, ssx * inv_sl, 1.0 + csg * ngx * ngx * a)
        ssy = torch.where(ok, ssy * inv_sl, csg * bb)
        ssz = torch.where(ok, ssz * inv_sl, -csg * ngx)
        at = {"ngx": ngx, "ngy": ngy, "ngz": ngz, "nsx": ngx, "nsy": ngy, "nsz": ngz,
              "ssx": ssx, "ssy": ssy, "ssz": ssz,
              "tsx": ngy * ssz - ngz * ssy, "tsy": ngz * ssx - ngx * ssz, "tsz": ngx * ssy - ngy * ssx}
        for c, key in enumerate("xyz"):
            at["p" + key] = b0 * v[:, 0, c] + b1 * v[:, 1, c] + b2 * v[:, 2, c]
            at["e" + key] = g7 * ((b0 * v[:, 0, c]).abs() + (b1 * v[:, 1, c]).abs() + (b2 * v[:, 2, c]).abs())
        return at

    def nee(hbase, s_cur, dim_base, alive_sh, at, wox, woy, woz, mat):
        """estimate_direct for one selected light, delta or triangle area,
        with MIS and an any-hit shadow walk."""
        kd = [T.f["color"][mat, ch] for ch in range(3)]
        lam_m = T.in_lobes(mat, (LOBE_LAMBERT_R, LOBE_PLASTIC))
        on_m = T.in_lobes(mat, (LOBE_OREN_NAYAR,))
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
        zero = torch.zeros_like(wox)
        wix, wiy, wiz, lir, lig, lib, dist, spdf = (zero,) * 8
        p_l = zero
        is_delta = torch.ones(wox.shape, dtype=torch.bool, device=dev)
        if any_area:
            u1, u2 = sample_2d(hbase, s_cur, dim_base + 1)
        for i, lt in enumerate(lights):
            m = lid == i
            par = [_f32(x) for x in lt["par"]]
            if lt["kind"] == LIGHT_DISTANT:
                vals = (par[0], par[1], par[2], par[3], par[4], par[5], wr2, 1.0)
            elif lt["kind"] in (LIGHT_POINT, LIGHT_SPOT):
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
                vals = (wxa, wya, wza, par[3] * fall / d2, par[4] * fall / d2, par[5] * fall / d2, dl, 1.0)
            else:  # uniform point on one triangle area light
                v = [[_f32(x) for x in row] for row in lt["v"]]
                su0 = torch.sqrt(torch.clamp(u1, min=0.0))
                b0s = 1.0 - su0
                b1s = u2 * su0
                b2s = 1.0 - b0s - b1s
                ps = [b0s * v[0][c] + b1s * v[1][c] + b2s * v[2][c] for c in range(3)]
                tx, ty, tz = ps[0] - at["px"], ps[1] - at["py"], ps[2] - at["pz"]
                d2 = torch.clamp(tx * tx + ty * ty + tz * tz, min=1e-12)
                dl = torch.sqrt(d2)
                inv = 1.0 / dl
                wxa, wya, wza = tx * inv, ty * inv, tz * inv
                ng = [_f32(x) for x in lt["ng"]]
                cos_l = -(wxa * ng[0] + wya * ng[1] + wza * ng[2])
                emits = (cos_l > 0) | bool(lt["two_sided"])
                pdf_a = d2 / torch.clamp(cos_l.abs() * _f32(lt["area"]), min=1e-12)
                pdf_a = torch.where(cos_l.abs() > 1e-7, pdf_a, 0.0)
                vals = (wxa, wya, wza, torch.where(emits, par[0], 0.0), torch.where(emits, par[1], 0.0),
                        torch.where(emits, par[2], 0.0), dl, pdf_a)
                is_delta = is_delta & ~m
            wix, wiy, wiz, lir, lig, lib, dist, p_l = (torch.where(m, v_, cur) for v_, cur in
                                                        zip(vals, (wix, wiy, wiz, lir, lig, lib, dist, p_l)))
            spdf = torch.where(m, pmf[i], spdf)

        refl = (_dot3(wix, wiy, wiz, at["ngx"], at["ngy"], at["ngz"])
                * _dot3(wox, woy, woz, at["ngx"], at["ngy"], at["ngz"])) > 0
        cos_ns = _dot3(wix, wiy, wiz, at["nsx"], at["nsy"], at["nsz"]).abs()
        fm = lam_m & refl
        f = [torch.where(fm, kd[ch] * _f32(INV_PI) * cos_ns, 0.0) for ch in range(3)]
        # the BSDF's pdf toward wi (specular lobes contribute 0)
        wo_l = _local(at, wox, woy, woz)
        wi_l = _local(at, wix, wiy, wiz)
        p_b = torch.where((lam_m | on_m) & (wi_l[2] * wo_l[2] > 0), wi_l[2].abs() * _f32(INV_PI), 0.0)
        if T.any_on:
            onf = T.on_factor(mat, *wo_l, *wi_l)
            f = [torch.where(on_m & refl, kd[ch] * onf * cos_ns, f[ch]) for ch in range(3)]
        if T.any_micro:
            fmic, p_m = T.micro_f_pdf(mat, T.in_lobes(mat, (LOBE_MICRO_R, LOBE_PLASTIC)), *wo_l, *wi_l)
            f = [f[ch] + torch.where(refl, fmic[ch] * cos_ns, 0.0) for ch in range(3)]
            p_b = p_b + p_m
            if T.any_plastic:
                p_b = p_b / torch.where(T.in_lobes(mat, (LOBE_PLASTIC,)), 2.0, 1.0)
        p_sel = p_l * spdf
        li = (lir, lig, lib)
        contributes = alive_sh & (p_sel > 0) & ((f[0] * lir > 0) | (f[1] * lig > 0) | (f[2] * lib > 0))
        osx, osy, osz = _offset_ray(at, wix, wiy, wiz)
        t_sh = torch.where(contributes, dist * _f32(1.0 - 2.0 * RAY_EPS), -1.0)
        occ = traverse_plain(sa, torch.stack([osx, osy, osz], -1), torch.stack([wix, wiy, wiz], -1), t_sh,
                             True)[1] >= 0
        vis = torch.where(occ, 0.0, 1.0)
        w_l = torch.where(is_delta, 1.0, _power_heuristic(p_sel, p_b))
        scale = vis * w_l / torch.clamp(p_sel, min=1e-30)
        return [torch.where(contributes, f[ch] * li[ch] * scale, 0.0) for ch in range(3)]

    # --- the persistent loop -------------------------------------------------
    px_f = px.to(torch.float32)
    py_f = py.to(torch.float32)
    seed_u = int(seed) & M32
    hbase = _pcg(_pcg(torch.tensor(0x9E3779B9 ^ seed_u, dtype=torch.int64, device=dev)) ^ (pids.to(torch.int64) & M32))
    R = px.shape[0]
    s_cur = torch.full((R,), int(s0) & M32, dtype=torch.int64, device=dev)
    ox, oy, oz, dx, dy, dz = camera(hbase, px_f, py_f, s_cur)
    zero = torch.zeros(R, dtype=torch.float32, device=dev)
    alive = torch.full((R,), n_samples > 0, dtype=torch.bool, device=dev)
    done = ~alive
    L = [zero] * 3
    beta = [zero + 1.0] * 3
    aL = [zero] * 3
    aW = zero
    nv = zero
    eta_acc = zero + 1.0
    bounces = torch.zeros(R, dtype=torch.int64, device=dev)
    prev_spec = torch.ones(R, dtype=torch.bool, device=dev)
    prev_pdf = zero + 1.0
    ppx, ppy, ppz = ox, oy, oz
    s_end = (int(s0) + int(n_samples)) & M32
    it = 0
    while it < cap and bool((~done).any()):
        it += 1
        t_query = torch.where(alive, float("inf"), -1.0)
        _t, prim, b1, b2 = traverse_plain(sa, torch.stack([ox, oy, oz], -1), torch.stack([dx, dy, dz], -1),
                                          t_query, False)[:4]
        valid = prim >= 0
        nv = nv + torch.where(alive & valid, 1.0, 0.0)
        prim = torch.clamp(prim, min=0)
        at = tri_attrs(prim, b1, b2)
        mat = sa.prim_mat[prim].long()
        wox, woy, woz = -dx, -dy, -dz
        if any_area:
            # area-light emission with deferred MIS (diffuse.rs l())
            light_h = sa.prim_light[prim].long()
            emitting = alive & valid & (light_h >= 0)
            lh = torch.clamp(light_h, min=0)
            em = (_dot3(at["ngx"], at["ngy"], at["ngz"], wox, woy, woz) > 0) | two_t[lh]
            tx, ty, tz = at["px"] - ppx, at["py"] - ppy, at["pz"] - ppz
            d2 = torch.clamp(tx * tx + ty * ty + tz * tz, min=1e-12)
            wl = 1.0 / torch.sqrt(d2)
            cos_l = _dot3(at["ngx"], at["ngy"], at["ngz"], -tx * wl, -ty * wl, -tz * wl).abs()
            p_lh = torch.where(cos_l > 1e-7, d2 / torch.clamp(cos_l * area_t[lh], min=1e-12), 0.0) * selp_t[lh]
            w_mis = torch.where(prev_spec, 1.0, _power_heuristic(prev_pdf, p_lh))
            L = [L[ch] + torch.where(emitting, beta[ch] * torch.where(em, le_t[lh, ch], 0.0) * w_mis, 0.0)
                 for ch in range(3)]
        alive_b = alive & valid
        dim_base = 2 + bounces * DPB
        can_scatter = alive_b & (bounces < max_depth - 1)
        alive_sh = can_scatter & ~T.in_lobes(mat, (LOBE_NONE,))
        bs = T.bsdf_sample(sample_1d, sample_2d, hbase, s_cur, dim_base, at, wox, woy, woz, mat)
        c = nee(hbase, s_cur, dim_base, alive_sh, at, wox, woy, woz, mat)
        L = [L[ch] + beta[ch] * c[ch] for ch in range(3)]
        wwx, wwy, wwz = bs["ww"]
        cos_term = _dot3(wwx, wwy, wwz, at["nsx"], at["nsy"], at["nsz"]).abs()
        inv_pdf = cos_term / torch.clamp(bs["pdf"], min=1e-30)
        th = [bs["f"][ch] * inv_pdf for ch in range(3)]
        surf_cont = alive_sh & bs["valid"] & ((th[0] > 0) | (th[1] > 0) | (th[2] > 0))
        new_b = [torch.where(surf_cont, beta[ch] * th[ch], beta[ch]) for ch in range(3)]
        nox, noy, noz = _offset_ray(at, wwx, wwy, wwz)
        new_o = [torch.where(surf_cont, a, b) for a, b in ((nox, ox), (noy, oy), (noz, oz))]
        new_d = [torch.where(surf_cont, a, b) for a, b in ((wwx, dx), (wwy, dy), (wwz, dz))]
        eta_acc = torch.where(surf_cont, eta_acc * bs["eta_scale"], eta_acc)
        new_bounces = bounces + surf_cont.to(torch.int64)
        new_spec = torch.where(surf_cont, bs["specular"], prev_spec)
        new_pdf = torch.where(surf_cont, torch.clamp(bs["pdf"], min=1e-30), prev_pdf)
        new_pp = [torch.where(surf_cont, at["p" + k], q) for k, q in zip("xyz", (ppx, ppy, ppz))]
        # russian roulette (path.rs:206-214)
        max_c = torch.maximum(new_b[0] * eta_acc, torch.maximum(new_b[1] * eta_acc, new_b[2] * eta_acc))
        q = torch.clamp(1.0 - max_c, min=0.05)
        do_rr = (new_bounces > 3) & (max_c < _f32(consts["rr_threshold"]))
        killed = do_rr & (sample_1d(hbase, s_cur, dim_base + 4) < q)
        new_alive = surf_cont & ~killed
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
        r_ = camera(hbase, px_f, py_f, torch.where(more, s_next, s_cur))
        ox, oy, oz = (torch.where(more, a, b) for a, b in zip(r_[:3], new_o))
        dx, dy, dz = (torch.where(more, a, b) for a, b in zip(r_[3:], new_d))
        L = [torch.where(more, 0.0, L[ch]) for ch in range(3)]
        beta = [torch.where(more, 1.0, new_b[ch]) for ch in range(3)]
        alive = new_alive | more
        eta_acc = torch.where(more, 1.0, eta_acc)
        bounces = torch.where(more, 0, new_bounces)
        s_cur = torch.where(more, s_next, s_cur)
        prev_spec = new_spec | more
        prev_pdf = torch.where(more, 1.0, new_pdf)
        ppx, ppy, ppz = (torch.where(more, a, b) for a, b in zip(r_[:3], new_pp))
    return torch.stack(aL, dim=-1), aW, nv


# ---------------------------------------------------------------------------
# The CUDA kernel and the render route
# ---------------------------------------------------------------------------


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_uint, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p]
# The cycle split of the instrumented instantiation, in the order of its
# u64 record (csrc/megakernel_wide.cu SPLIT_*): lane-cycles of the slots
# whose path walked, in the walk pool, in sort + shading + NEE and in
# flush/regen; of slots that waited for their shadow ray; of empty slots
# (the grid's tail); of the whole launch; of all lanes in the walk phase;
# lane-cycles in which a thread had walk or shading work; block iterations.
SPLIT_FIELDS = ("walk", "shade_nee", "flush_regen", "wait", "idle_tail", "total", "walk_lanes", "walk_busy",
                "shade_busy", "iterations")


def build_kernel() -> dict:
    """Compile (if needed) and load csrc/megakernel_wide.cu: {"lib",
    "seconds", "log", "path"} as device/nvcc.build returns it."""
    info = nvcc.build(KERNEL_SOURCE)
    lib = info["lib"]
    lib.wide_megakernel.argtypes = _ARGTYPES
    lib.wide_megakernel.restype = ctypes.c_int
    lib.wide_megakernel_split.argtypes = _ARGTYPES + [ctypes.c_void_p]
    lib.wide_megakernel_split.restype = ctypes.c_int
    return info


def occupancy(mode: int) -> int:
    """Resident blocks per SM of the kernel for one mode."""
    return nvcc.occupancy(build_kernel()["lib"].wide_megakernel_occupancy, mode)


def _launch(entry: str, blob, mode: int, tables, px, py, pids, s0: int, n_samples: int, seed: int, *extra):
    dev = px.device
    if dev.type != "cuda":
        raise ValueError("wide_megakernel_cuda takes CUDA tensors")
    if blob.device != dev or blob.dtype != torch.float32 or blob.numel() != BLOB_FLOATS:
        raise ValueError(f"blob must be {BLOB_FLOATS} float32 values on {dev}")
    _check_tables(tables, dev)
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
    pops = wide_megakernel_cuda.pops.get(dev)
    if pops is None:
        pops = wide_megakernel_cuda.pops[dev] = torch.zeros(2, dtype=torch.int64, device=dev)
    counters = wide_megakernel_cuda.counters.get(dev)
    if counters is None:
        counters = wide_megakernel_cuda.counters[dev] = torch.zeros(2, dtype=torch.int32, device=dev)
    queue = torch.zeros(1, dtype=torch.int32, device=dev)  # the next unserved lane
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(blob.data_ptr(), lanes[0].data_ptr(), lanes[1].data_ptr(), lanes[2].data_ptr(), R,
             int(seed) & M32, int(s0) & M32, int(n_samples), int(mode),
             tables.wnode_rec.data_ptr(), tables.wleaf_rec.data_ptr(),
             out_l.data_ptr(), out_w.data_ptr(), out_nv.data_ptr(), pops.data_ptr(), counters.data_ptr(),
             queue.data_ptr(), stream, *(x.data_ptr() for x in extra))
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    return out_l, out_w, out_nv


def wide_megakernel_cuda(blob, mode: int, tables, px, py, pids, s0: int, n_samples: int, seed: int):
    """Launch the CUDA kernel on the current stream. blob: pack_wide_consts's
    float32 tensor on the lanes' device; mode: kernel_mode(consts); tables:
    the scene tensors holding the wide BVH's wnode_rec and wleaf_rec; px, py,
    pids: (R,) integer CUDA tensors. Returns (accLw (R, 3), accW (R,),
    n_vertices (R,)) float32. Adds one to ``wide_megakernel_cuda.launches``
    per launch; the closest-hit and shadow pops accumulate in
    ``wide_megakernel_cuda.pops[device]`` (int64 (2,)), stack overflows and
    iteration-cap hits in ``wide_megakernel_cuda.counters[device]`` (int32
    (2,)); raises on a refused launch."""
    out = _launch("wide_megakernel", blob, mode, tables, px, py, pids, s0, n_samples, seed)
    wide_megakernel_cuda.launches += 1
    return out


def wide_megakernel_split(blob, mode: int, tables, px, py, pids, s0: int, n_samples: int, seed: int):
    """wide_megakernel_cuda through the instrumented instantiation, which
    exists for mode 1 only ((0,2) sampler, area lights) and which no route
    launches: returns (accLw, accW, n_vertices, split), split mapping
    SPLIT_FIELDS to cycle counts summed over the launch."""
    prof = torch.zeros(len(SPLIT_FIELDS), dtype=torch.int64, device=px.device)
    out = _launch("wide_megakernel_split", blob, mode, tables, px, py, pids, s0, n_samples, seed, prof)
    return (*out, dict(zip(SPLIT_FIELDS, prof.tolist())))


wide_megakernel_cuda.launches = 0
wide_megakernel_cuda.pops = {}  # device -> int64 (2,): closest-hit pops, shadow pops
wide_megakernel_cuda.counters = {}  # device -> int32 (2,): stack overflows, iteration-cap hits


def make_wide_megakernel_fn(cs, cam, icfg, scfg, fcfg, max_tris, consts=None):
    """The wave_p-compatible persistent function backed by the wide
    megakernel: fn(sa, px, py, pids, s0, n_samples, seed) -> (accLw (R, 3),
    accW (R,), n_vertices (R,)), or None if the scene is outside the class.
    CUDA lanes launch the kernel, CPU lanes run the plain twin; there is no
    fallback from one to the other. fn.blob (on the scene's device) and
    fn.mode are the kernel's arguments for the scene's consts."""
    if consts is None:
        consts = extract_wide_consts(cs, cam, icfg, scfg, fcfg, max_tris)
    if consts is None:
        return None
    blob_cpu = pack_wide_consts(consts)
    mode = kernel_mode(consts)
    # uploaded here, not in the first launch, so a render's timed loop holds
    # only the launch
    blobs = {cs.arrays.device: blob_cpu.to(cs.arrays.device)}

    def wave_p(sa, px, py, pixel_ids, s0, n_samples, seed):
        if px.device.type == "cuda":
            blob = blobs.get(px.device)
            if blob is None:
                blob = blobs[px.device] = blob_cpu.to(px.device)
            return wide_megakernel_cuda(blob, mode, sa, px, py, pixel_ids, s0, n_samples, seed)
        if px.device.type == "cpu":
            return wide_megakernel_plain(consts, sa, px, py, pixel_ids, s0, n_samples, seed)
        raise ValueError(f"the wide megakernel has no implementation for device {px.device}")

    # what the launch takes, for tools that time or instrument the route's
    # own launch (chip_smoke.py, tools/torch_phases.py)
    wave_p.blob, wave_p.mode = blobs[cs.arrays.device], mode
    return wave_p
