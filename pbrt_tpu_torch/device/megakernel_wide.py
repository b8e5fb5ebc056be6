"""Wide persistent path-tracing megakernel: the hand-written CUDA kernel
(``csrc/megakernel_wide.cu``) and its plain PyTorch twin.

The port's counterpart of ``pbrt_tpu/device/megakernel_wide.py``: the whole
persistent path loop for triangle scenes, with the closest-hit and shadow
walks of the wide BVH inside the kernel. Its class here: wide-BVH scenes,
flat or smooth-shaded, with default or real UV charts (the attribute
table), and beside the triangles at most 8 full spheres (the mixed
scenes, whose wide tables cover the triangle subset; each ray tests the
spheres after its walk and keeps the nearer hit, the triangle on a tie);
materials of the six lobe classes ``bake_lobe_entry`` bakes (at most 16
used; a row is in the class by its lobe set, so a glossy uber row and a
translucent row without transmission bake as plastic does, and
substrate, disney, fourier and hair rows are refused by theirs; mix rows
are refused by name), with constant parameters or constant textures,
and a 2D uv-mapped checkerboard of two constant, non-black cells on a matte
or plastic Kd (selected per hit in the kernel, reference :398-440,
:1273-1287); no bump maps (the reference's kernel renders them without
bumps, ROADMAP C; the port sends them to the wavefront); untextured sphere
materials; at most 8 lights among one- or two-sided triangle area lights,
full-sphere area lights (sampled by the cone they subtend from outside,
uniformly over their area from inside, sphere.rs sample_interaction),
point, spot and distant lights and a constant infinite light, with
uniform or power selection; pinhole and
thin-lens perspective cameras; the box, triangle and gaussian filters; the
(0,2), random, stratified, halton, sobol and maxmindist samplers
(stratified and halton without a lens, stratified with the reference's own
strata, ROADMAP C; halton's and sobol's film enumerations from the tables
the route builds); the path integrator with its Russian-roulette threshold
and sample clamp; at most ``max_tris`` triangles (the route reads
PBRT_TPU_WIDEMEGA_MAX_TRIS, default 4096).

- ``extract_wide_consts`` / ``wide_megakernel_eligible`` /
  ``explain_ineligible_wide``: the reference's gates for this class, and
  the same baked constants; anything outside the class gives None and a
  reason. The reference's two TPU memory budgets are not carried over.
- ``pack_wide_consts``: lights, materials, camera and header as one flat
  float32 blob (layout below); ``sampler_table``: the halton per-pixel
  offsets, the sobol generator columns and film inversion, or the
  maxmindist columns, as one int32 tensor. Beside the wide BVH's node
  records, leaf rows and attribute rows (``scene/widebvh.hopper_layout``,
  ``hopper_rows``) they are the only things the CUDA kernel reads.
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
    GEOM_SPHERE, LIGHT_AREA, LIGHT_DISTANT, LIGHT_INFINITE, LIGHT_POINT, LIGHT_SPOT, MAT_MIX, QUADRIC_SPHERE,
)
from . import nvcc, rng
from .bsdf import LOBE_LAMBERT_R, LOBE_MICRO_R, LOBE_NONE, LOBE_OREN_NAYAR
from .lights import INV_4PI, uniform_sample_sphere
from .megakernel import (
    DPB, FLAG_FLIP_GEOM_N, FLAG_HAS_SHADING_N, INV_PI, LOBE_PLASTIC, M32, MAT_DEFAULTS, MAT_STRIDE, RAY_EPS,
    _concentric_disk, _dot3, _f32, _gamma, _h, _local, _MatTable, _norm3, _offset_ray, _pcg, _reverse_bits,
    _samplers, _sobol2, _sph_attrs, _sph_consts, _sph_test, _u2f01, _vdc, bake_lobe_entry,
)
from .sampler import _sobol_cols, _wrap, _xor_columns, sobol_dim_dyn, sobol_global_index
from .wide_bvh import _check_tables, traverse_plain

MAX_MATS = 16
MAX_LIGHTS = 8
MAX_SPHERES = 8
DEFAULT_MAX_TRIS = 4096  # the reference's PBRT_TPU_WIDEMEGA_MAX_TRIS default
# the kernel's sampler ids (0-2 as the brute megakernel's SAMPLERS)
SAMPLERS = {"zerotwosequence": 0, "lowdiscrepancy": 0, "random": 1, "stratified": 2, "halton": 3, "sobol": 4,
            "maxmindist": 5}
SAMPLER_NAMES = tuple(SAMPLERS)
N_SAMPLER_IDS = 6
FILTERS = {"box": 0, "triangle": 1, "gaussian": 2}
SOBOL_DIMS = 64  # generator matrices the bounce dimensions draw from (sampler.sobol_dim_dyn)

KERNEL_SOURCE = nvcc.CSRC / "megakernel_wide.cu"

# ---------------------------------------------------------------------------
# The constant blob (float32; small integers stored as exact floats).
# Keep in lockstep with csrc/megakernel_wide.cu.
# ---------------------------------------------------------------------------
H_N_LIGHTS, H_N_MATS, H_MAX_DEPTH, H_RR, H_UNIFORM, H_SAMPLER, H_STRAT_XS, H_STRAT_YS = range(8)
# H_FXW, H_FYW: the filter's radii (the box filter's half-widths)
H_WR2, H_FXW, H_FYW, H_MAX_LUM, H_G7, H_LENS_R, H_FOCAL, H_FILTER = range(8, 16)
H_R2C = 16  # 16 floats, row-major 4x4 raster -> camera
H_C2W = 32  # 12 floats, row-major 3x4 camera -> world
H_CDF = 44  # MAX_LIGHTS floats
H_PMF = 52  # MAX_LIGHTS floats
# the film enumeration's constants: halton stride, sx, sy; sobol m, res,
# frame bits; maxmindist n
H_SAMP = 60  # 3 floats
H_GK = 63  # the gaussian filter's sigma * sqrt(2)
HEADER = 64
LIGHT_STRIDE = 32
LIGHT_BASE = HEADER
MAT_BASE = LIGHT_BASE + MAX_LIGHTS * LIGHT_STRIDE
BLOB_FLOATS = MAT_BASE + MAX_MATS * MAT_STRIDE
# light record: 0 kind, 1 par (12), 13 spot falloff denominator (the brute
# megakernel's record), then for a triangle area light 14 area,
# 15 two-sided, 16 v0 v1 v2 (9), 25 ng (3); for a sphere lamp 14 area,
# 15 two-sided, 16 the world center (3), 19 the world radius r, 20 r^2,
# 21 r^2 x 1.0001 (outside the sphere beyond it), 22 the object radius,
# 28 1 + its sphere record (0 for a triangle); for the infinite light 14
# the escaped ray's MIS density, 1/4pi x its selection pmf
L_KIND, L_PAR, L_SPOT_DEN, L_AREA, L_TWO_SIDED, L_V, L_NG = 0, 1, 13, 14, 15, 16, 25
L_C, L_RW, L_RW2, L_RW2X, L_ROBJ, L_SPH = 16, 19, 20, 21, 22, 28
L_ENV_P = 14
# the sampler table (int32): sobol's generator columns of SOBOL_DIMS
# dimensions (32 each), then the film inversion's 32 columns and its 32
# frame columns; halton's per-pixel offsets; maxmindist's 32 columns
SOB_INV = SOBOL_DIMS * 32
SOB_DELTA = SOB_INV + 32
# material record: device/megakernel.py's M_* fields, plus 31 the material
# row the slot bakes (the prim table's payload names rows, not slots), and
# the checkerboard Kd: 24 set for one, 25 uscale, vscale, udelta, vdelta;
# its even cells' color in M_COLOR, its odd cells' in M_KT
M_ROW = 31
M_CHK, M_CHK_UV = 24, 25
# the spheres (the SPH modes only): past BLOB_FLOATS a count, then one
# SPH_STRIDE record per sphere: 0 its light row (-1 for none), 1 its
# material row, then csrc/pt_common.cuh's sphere record (flags, w2o, o2w,
# radius, radius^2, phimax, the p_err constant terms)
SPH_BASE = BLOB_FLOATS
SPH_HEADER = 4
SPH_STRIDE = 36
S_LIGHT, S_MAT, S_FLAGS, S_W2O, S_O2W, S_R, S_R2, S_PHIMAX, S_ERRC = 0, 1, 2, 3, 15, 27, 28, 29, 30
SPH_BLOB_FLOATS = SPH_BASE + SPH_HEADER + MAX_SPHERES * SPH_STRIDE
N_MODES = 3 * 2 * N_SAMPLER_IDS  # ext 0-2 x sampler x any area light


# ---------------------------------------------------------------------------
# Host-side constant extraction and eligibility
# ---------------------------------------------------------------------------


def _extract(cs, cam, icfg, scfg, fcfg, max_tris):
    """(consts, None) for a scene of the kernel's class, else (None, the
    reason it is outside), in the reference's gate order."""
    from .lights import compute_power
    from .materials import lobes_at_origin
    from ..scene.arrays import P_KD

    from .megakernel import new_kind_refusal

    sa, static = cs.arrays, cs.static
    why = new_kind_refusal(cs, cam)
    if why is not None:
        return None, why
    if static.n_spheres > MAX_SPHERES:
        return None, f"more than {MAX_SPHERES} spheres"
    if not static.has_wide_tri or sa.wnode_rec is None:
        return None, "scenes without the wide-BVH tables (at most 64 prims)"
    if static.n_tris > max_tris:
        return None, f"more than {max_tris} triangles (PBRT_TPU_WIDEMEGA_MAX_TRIS)"
    if static.n_media:
        return None, "participating media"
    if static.has_env_map:
        return None, "the image-mapped infinite light (the env map)"
    if static.has_motion:
        return None, "motion blur"
    kind = scfg["kind"]
    lens = float(cam["lens_radius"]) != 0.0
    if kind not in SAMPLER_NAMES:
        return None, f"the '{kind}' sampler"
    if kind == "stratified" and lens:
        return None, "the stratified sampler with a lens"
    if kind == "halton" and (scfg.get("halton") is None or lens):
        return None, "the halton sampler without its film tables, or with a lens"
    if kind == "sobol" and scfg.get("sobol") is None:
        return None, "the sobol sampler without its film tables"
    if fcfg["filter"] not in FILTERS:
        return None, f"the '{fcfg['filter']}' filter"
    n_l = static.n_lights
    if n_l > MAX_LIGHTS or n_l == 0:
        return None, f"more than {MAX_LIGHTS} lights, or none"
    prim_flags = _h(sa.prim_flags)
    has_ns = bool((prim_flags & FLAG_HAS_SHADING_N).any())
    has_attr = sa.wattr_tab is not None
    if has_ns and not has_attr:
        return None, "per-vertex shading normals without the attribute table"
    tri_uv = _h(sa.tri_uv)
    default_uv = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]], np.float32)
    if tri_uv.shape[0] and not np.array_equal(tri_uv, np.broadcast_to(default_uv, tri_uv.shape)) and not has_attr:
        return None, "UV charts without the attribute table"

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
    sph_w2o, sph_o2w, sph_par, sph_kind = _h(sa.sph_w2o), _h(sa.sph_o2w), _h(sa.sph_param), _h(sa.sph_kind)
    lights = []
    for i in range(n_l):
        k = int(light_kind[i])
        if k in (LIGHT_POINT, LIGHT_DISTANT, LIGHT_SPOT, LIGHT_INFINITE):
            lights.append({"kind": k, "par": light_param[i].astype(float)})
        elif k == LIGHT_AREA:
            pid = int(light_prim[i])
            if int(prim_kind[pid]) == GEOM_SPHERE:
                # a sphere lamp: the cone it subtends from outside, its
                # area from inside (reference :305-339), on a full,
                # outward-facing sphere (lights._sphere_cone_info)
                si = int(prim_geom[pid])
                if int(sph_kind[si]) != QUADRIC_SPHERE:
                    return None, "quadrics other than spheres"
                r_o = float(sph_par[si, 0])
                if not (float(sph_par[si, 1]) <= -r_o + 1e-6 * r_o and float(sph_par[si, 2]) >= r_o - 1e-6 * r_o
                        and float(sph_par[si, 3]) >= 2 * np.pi - 1e-6):
                    return None, "partial-sphere area lights"
                if prim_flags[pid] & 4:  # builder.FLAG_REVERSE_ORIENTATION: emits inward
                    return None, "reverse-oriented sphere area lights"
                o2w_l, w2o_l = sph_o2w[si].astype(np.float64), sph_w2o[si].astype(np.float64)
                lights.append({"kind": k, "par": light_param[i].astype(float), "sphere": True, "pid": pid,
                               "c": o2w_l[:3, 3].tolist(), "r": float(r_o * np.linalg.norm(o2w_l[:3, 0])),
                               "r_obj": r_o, "o2w": o2w_l[:3, :4].tolist(), "w2oT": w2o_l[:3, :3].T.tolist(),
                               "flip": bool(prim_flags[pid] & FLAG_FLIP_GEOM_N), "area": float(prim_area[pid]),
                               "two_sided": bool(light_param[i][3] > 0)})
                continue
            v = tri_p[prim_geom[pid]].astype(np.float64)
            ng = np.cross(v[1] - v[0], v[2] - v[0])
            ng = ng / max(np.linalg.norm(ng), 1e-30)
            if prim_flags[pid] & FLAG_FLIP_GEOM_N:
                ng = -ng
            lights.append({"kind": k, "par": light_param[i].astype(float), "v": v, "ng": ng,
                           "area": float(prim_area[pid]), "two_sided": bool(light_param[i][3] > 0)})
        else:
            return None, f"lights of kind {k}"
    if sum(lt["kind"] == LIGHT_INFINITE for lt in lights) > 1:
        # escaped rays would take every sky row in the kernel, the first in
        # the reference kernel and the last (infinite_light_index) in the
        # wavefront
        return None, "more than one infinite light"

    # the baked full spheres (reference :354-380), tested in the kernel
    # beside the walk
    prim_mat, prim_light, sph_pid = _h(sa.prim_mat), _h(sa.prim_light), _h(sa.sph_prim_ids)
    spheres = []
    for si in range(int(static.n_spheres)):
        if int(sph_kind[si]) != QUADRIC_SPHERE:
            return None, "quadrics other than spheres"
        r = float(sph_par[si, 0])
        zmin, zmax, phimax = float(sph_par[si, 1]), float(sph_par[si, 2]), float(sph_par[si, 3])
        if not (zmin <= -r + 1e-7 * r and zmax >= r - 1e-7 * r and phimax >= 2 * np.pi - 1e-6):
            return None, "partial spheres"
        pid = int(sph_pid[si])
        li = int(prim_light[pid])
        if li >= 0 and not (li < len(lights) and lights[li].get("sphere")):
            return None, "a sphere whose light row is not a sphere lamp"
        spheres.append({"w2o": sph_w2o[si], "o2w": sph_o2w[si], "r": r, "phimax": phimax,
                        "mat": int(prim_mat[pid]), "flags": int(prim_flags[pid]), "light": li})

    if MAT_MIX in set(static.mat_kinds_present):
        return None, "mix materials"
    if static.has_bump:
        return None, "bump maps"
    used_mats = sorted(set(int(m) for m in prim_mat))
    if len(used_mats) > MAX_MATS:
        return None, f"more than {MAX_MATS} materials"
    try:
        # the lobes with the textures at the origin, as the reference bakes them
        lk, ld = (_h(x) for x in lobes_at_origin(sa, static))
    except NotImplementedError:
        return None, "the subsurface and kdsubsurface materials (the BSSRDF adapter lobe)"
    mat_tex = _h(sa.mat_tex)
    tex_param = _h(sa.tex_param)
    mats = {}
    for m in used_mats:
        # constant textures fold into the lobes; a Kd checkerboard of
        # constant cells becomes the kernel's per-hit select
        kd_tex = None
        for slot in range(mat_tex.shape[1]):
            tid = int(mat_tex[m, slot])
            if tid < 0:
                continue
            prog = static.tex_programs[tid]
            if prog.kind == "constant":
                continue
            if not (slot == P_KD and prog.kind == "checkerboard" and prog.dimension == 2 and prog.mapping == "uv"
                    and prog.tex1 < 0 and prog.tex2 < 0):
                return None, f"the '{prog.kind}' texture (only a 2D uv checkerboard of constant cells on Kd)"
            par = tex_param[tid]
            c1, c2 = np.clip(par[10:13], 0.0, 1.0), np.clip(par[13:16], 0.0, 1.0)
            if not (c1.max() > 0 and c2.max() > 0):
                # the lobes are baked at the origin: a black cell would
                # switch the lobe off where the baked row has it
                return None, "a checkerboard Kd with a black cell"
            kd_tex = {"us": float(par[0]), "vs": float(par[1]), "du": float(par[2]), "dv": float(par[3]),
                      "c1": c1.astype(float).tolist(), "c2": c2.astype(float).tolist()}
        slots = np.nonzero(lk[m])[0]
        if len(slots) == 0:
            mats[m] = {"lobe": LOBE_NONE}
            continue
        entry = bake_lobe_entry([int(lk[m, s]) for s in slots], [int(s) for s in slots], ld[m], kd_tex)
        if entry is None:
            return None, f"the lobe set {[int(lk[m, s]) for s in slots]} of material {m}"
        mats[m] = entry
    if any(mats[sp["mat"]].get("kd_tex") for sp in spheres):
        return None, "textured sphere materials (no uv is baked for spheres)"

    fp = fcfg["filter_params"]
    consts = {
        "has_ns": has_ns,
        "has_attr": has_attr,
        "mats": mats,
        "lights": lights,
        "spheres": spheres,
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
        # the film enumerations' constants, as the reference bakes them
        "halton": ({k_: int(scfg["halton"][k_]) for k_ in ("stride", "sx", "sy")} if kind == "halton" else None),
        "sobol": _bake_sobol(scfg["sobol"]) if kind == "sobol" else None,
        "maxmin": _bake_maxmin(int(scfg["spp"])) if kind == "maxmindist" else None,
        "max_lum": float(fcfg.get("max_sample_luminance", float("inf"))),
    }
    if kind == "halton":
        # the per-pixel offsets of the halton film enumeration (a device
        # tensor, indexed by pixel id; not one of the reference's consts)
        consts["halton_offset"] = scfg["halton"]["offset"]
    return consts, None


def _bake_maxmin(spp: int):
    """The maxmindist film pair's generator matrix (sampler.maxmin_matrix)."""
    from .sampler import maxmin_matrix

    k = max(int(math.ceil(math.log2(max(spp, 1)))), 0)
    return {"n": 1 << k, "cols": tuple(int(c) for c in maxmin_matrix(k))}


def _bake_sobol(aux):
    """The global-Sobol film enumeration's constants: sampler.sobol_tables'
    dict plus the generator columns of dimensions 0-3 (film x, y; lens u, v)."""
    from ..core.sobolmat import matrix

    return {
        "m": int(aux["m"]),
        "res": int(aux["res"]),
        "inv_cols": tuple(int(c) for c in aux["inv_cols"]),
        "delta_cols": tuple(int(c) for c in aux["delta_cols"]),
        "n_frame_bits": int(aux["n_frame_bits"]),
        "cols": tuple(tuple(int(c) for c in matrix(d)) for d in range(4)),
    }


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

    b = np.zeros(SPH_BLOB_FLOATS if consts["spheres"] else BLOB_FLOATS, np.float64)
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
    b[H_FXW], b[H_FYW], b[H_GK] = _filter_radii(consts)
    b[H_FILTER] = FILTERS[consts["filter"]]
    for key, fields in (("halton", ("stride", "sx", "sy")), ("sobol", ("m", "res", "n_frame_bits")),
                        ("maxmin", ("n",))):
        if consts[key] is not None:
            b[H_SAMP:H_SAMP + len(fields)] = [consts[key][f] for f in fields]
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
            if lt.get("sphere"):
                r = lt["r"]
                b[o + L_C:o + L_C + 3] = lt["c"]
                b[o + L_RW], b[o + L_RW2], b[o + L_RW2X], b[o + L_ROBJ] = r, r * r, r * r * 1.0001, lt["r_obj"]
                b[o + L_SPH] = 1 + next(j for j, sp in enumerate(consts["spheres"]) if sp["light"] == i)
            else:
                b[o + L_V:o + L_V + 9] = np.asarray(lt["v"], np.float64).ravel()
                b[o + L_NG:o + L_NG + 3] = lt["ng"]
        elif lt["kind"] == LIGHT_INFINITE:
            b[o + L_ENV_P] = INV_4PI * float(consts["light_pmf"][i])
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
        chk = e.get("kd_tex")
        if chk:
            b[o + M_CHK] = 1.0
            b[o + M_CHK_UV:o + M_CHK_UV + 4] = chk["us"], chk["vs"], chk["du"], chk["dv"]
            b[o + M_COLOR:o + M_COLOR + 3] = chk["c1"]
            b[o + M_KT:o + M_KT + 3] = chk["c2"]
    if consts["spheres"]:
        b[SPH_BASE] = len(consts["spheres"])
        for j, sp in enumerate(consts["spheres"]):
            o = SPH_BASE + SPH_HEADER + j * SPH_STRIDE
            o2w = np.asarray(sp["o2w"], np.float64)
            b[o + S_LIGHT], b[o + S_MAT], b[o + S_FLAGS] = sp["light"], sp["mat"], sp["flags"]
            b[o + S_W2O:o + S_W2O + 12] = np.asarray(sp["w2o"], np.float64).ravel()
            b[o + S_O2W:o + S_O2W + 12] = o2w.ravel()
            b[o + S_R], b[o + S_R2], b[o + S_PHIMAX] = sp["r"], sp["r"] * sp["r"], sp["phimax"]
            b[o + S_ERRC:o + S_ERRC + 3] = [_gamma(3) * abs(o2w[row][3]) for row in range(3)]
    return torch.from_numpy(b.astype(np.float32))


def _filter_radii(consts):
    """(x radius, y radius, the gaussian's sigma * sqrt(2)) of the filter:
    the box filter's half-widths, else the triangle's or gaussian's radii
    (render.filter_offset's defaults)."""
    fp = consts["filter_params"]
    if consts["filter"] == "box":
        return consts["filter_xw"], consts["filter_yw"], 0.0
    r = fp.get("xwidth", 2.0)
    return r, fp.get("ywidth", r), 1.0 / math.sqrt(2.0 * fp.get("alpha", 2.0)) * math.sqrt(2.0)


def kernel_mode(consts) -> int:
    """The kernel's template selector: ext * 12 + sampler * 2 + (any area
    light), sampler as in SAMPLERS; ext = 1 selects the extended
    instantiation, for a filter other than the box, the attribute table, a
    constant infinite light or a checkerboard Kd; ext = 2 the extended
    instantiation with the baked spheres (SPH)."""
    any_area = any(lt["kind"] == LIGHT_AREA for lt in consts["lights"])
    ext = (consts["filter"] != "box" or consts["has_attr"] or any(lt["kind"] == LIGHT_INFINITE
                                                                  for lt in consts["lights"])
           or any(e.get("kd_tex") for e in consts["mats"].values()))
    ext = 2 if consts["spheres"] else int(ext)
    return ext * 2 * N_SAMPLER_IDS + SAMPLERS[consts["sampler"]] * 2 + int(any_area)


def sampler_table(consts, device) -> torch.Tensor:
    """The int32 table of the film enumeration (layout at SOB_INV above) on
    `device`; a single zero for the samplers that need none."""
    if consts["sampler"] == "halton":
        return (consts["halton_offset"].to(device=device, dtype=torch.int64) & M32).to(torch.int32)
    if consts["sampler"] == "sobol":
        sob = consts["sobol"]
        t = np.zeros(SOB_DELTA + 32, np.uint32)
        t[:SOB_INV] = _sobol_cols(SOBOL_DIMS).astype(np.uint32).ravel()
        t[SOB_INV:SOB_INV + len(sob["inv_cols"])] = sob["inv_cols"]
        t[SOB_DELTA:SOB_DELTA + len(sob["delta_cols"])] = sob["delta_cols"]
        return torch.as_tensor(t.view(np.int32), device=device)
    if consts["sampler"] == "maxmindist":
        t = np.zeros(32, np.uint32)
        t[:len(consts["maxmin"]["cols"])] = consts["maxmin"]["cols"]
        return torch.as_tensor(t.view(np.int32), device=device)
    return torch.zeros(1, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# The plain PyTorch twin: the kernel's per-lane loop over (R,) lane tensors
# ---------------------------------------------------------------------------


def _power_heuristic(f, g):
    f2, g2 = f * f, g * g
    return torch.where(f > 0, f2 / torch.clamp(f2 + g2, min=1e-30), 0.0)


def _traced_samplers(sampler: int):
    """(sample_1d, sample_2d) of the traced (per-lane bounce) dimensions,
    keyed by (hbase, sample, dimension) as the reference kernel keys them:
    halton and sobol continue their sequences into these dimensions (a
    prime base per lane, the generator columns of SOBOL_DIMS dimensions),
    maxmindist draws them from the (0,2) sequence."""
    if sampler == SAMPLERS["halton"]:
        last = len(rng.PRIMES) - 2

        def ri(base, hbase, s_cur, d):
            return _wrap(rng.radical_inverse_dyn(base, s_cur) + _u2f01(_pcg(hbase ^ d)))

        def sample_1d(hbase, s_cur, dim):
            return ri(torch.clamp(2 * dim, max=last), hbase, s_cur, 2 * dim)

        def sample_2d(hbase, s_cur, dim):
            b0 = torch.clamp(2 * dim, max=last)
            return ri(b0, hbase, s_cur, 2 * dim), ri(b0 + 1, hbase, s_cur, 2 * dim + 1)

        return sample_1d, sample_2d
    if sampler == SAMPLERS["sobol"]:

        def sob(d, s_cur, scr):
            return sobol_dim_dyn(s_cur, d, scr, SOBOL_DIMS, to_float=_u2f01)

        def sample_1d(hbase, s_cur, dim):
            return sob(2 * dim, s_cur, _pcg(hbase ^ (2 * dim)))

        def sample_2d(hbase, s_cur, dim):
            return sob(2 * dim, s_cur, _pcg(hbase ^ (2 * dim))), sob(2 * dim + 1, s_cur, _pcg(hbase ^ (2 * dim + 1)))

        return sample_1d, sample_2d
    return _samplers(sampler in (SAMPLERS["random"], SAMPLERS["stratified"]))


def wide_megakernel_plain(consts, sa, px, py, pids, s0: int, n_samples: int, seed: int):
    """The kernel's estimator in plain PyTorch on any device: lanes px, py,
    pids (R,) integer tensors trace samples s0 .. s0+n_samples-1 through the
    scene tensors sa (wide tables, attribute rows and the prim rows they
    index).

    Returns (accLw (R, 3), accW (R,), n_vertices (R,)), float32."""
    from ..render import filter_offset

    dev = px.device
    lights = consts["lights"]
    n_lights = len(lights)
    max_depth = consts["max_depth"]
    sampler = SAMPLERS[consts["sampler"]]
    is_random = sampler in (SAMPLERS["random"], SAMPLERS["stratified"])
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
    sample_1d, sample_2d = _traced_samplers(sampler)
    g7 = _f32(_gamma(7))
    any_area = any(lt["kind"] == LIGHT_AREA for lt in lights)
    inf_idx = next((i for i, lt in enumerate(lights) if lt["kind"] == LIGHT_INFINITE), -1)
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
    if consts["has_attr"]:
        # the attribute row of each prim: the row of its kernel slot (a
        # mixed scene's slots name the triangle subset's prims)
        slots = sa.wslot_prim.to(torch.int64)
        prims_of = slots[slots >= 0]
        if sa.wide_prim_rows is not None:
            prims_of = sa.wide_prim_rows.to(torch.int64)[prims_of]
        attr_row = torch.zeros(int(sa.prim_mat.shape[0]), dtype=torch.int64, device=dev)
        attr_row[prims_of] = torch.nonzero(slots >= 0).squeeze(1)
    # the baked spheres with their float32 constants, and the sphere lamps'
    spheres = [_sph_consts(dict(sp)) for sp in consts["spheres"]]
    two_pi = _f32(2.0 * math.pi)

    def sph_lamp(lt):
        """A sphere lamp's float32 constants, as the kernel's light record holds them."""
        r = lt["r"]
        return {"c": [_f32(x) for x in lt["c"]], "rw": _f32(r), "rw2": _f32(r * r), "rw2x": _f32(r * r * 1.0001),
                "robj": _f32(lt["r_obj"]), "o2w": [[_f32(x) for x in row] for row in lt["o2w"]],
                "w2oT": [[_f32(x) for x in row] for row in lt["w2oT"]]}

    lamps = {i: sph_lamp(lt) for i, lt in enumerate(lights) if lt.get("sphere")}

    def cone_pdf(lp, px_, py_, pz_):
        """(outside, the cone's pdf) of a sphere lamp seen from (px_, py_, pz_)."""
        tcx, tcy, tcz = lp["c"][0] - px_, lp["c"][1] - py_, lp["c"][2] - pz_
        dc2 = torch.clamp(tcx * tcx + tcy * tcy + tcz * tcz, min=1e-12)
        sin2_tm = torch.clamp(torch.full_like(dc2, lp["rw2"]) / dc2, 0.0, 1.0)  # one division, as the kernel's
        cos_tm = torch.sqrt(torch.clamp(1.0 - sin2_tm, min=0.0))
        return dc2 > lp["rw2x"], 1.0 / torch.clamp(two_pi * (1.0 - cos_tm), min=1e-12), (tcx, tcy, tcz, dc2, cos_tm)
    hoff = consts["halton_offset"].to(dev)[pids.to(torch.int64)] if sampler == SAMPLERS["halton"] else None

    def film_sample(hbase, px_f, py_f, s_sel):
        """Film dimension 0: the sampler's (u1, u2) in the pixel, and for
        sobol the global index its lens dimensions read."""
        sob_idx = None
        if sampler == SAMPLERS["sobol"]:
            sob = consts["sobol"]
            sob_idx = sobol_global_index(sob, px.to(torch.int64), py.to(torch.int64), s_sel)
            res = float(sob["res"])
            x = _u2f01(_xor_columns(sob_idx, sob["cols"][0], torch.zeros_like(sob_idx))) * res - px_f
            y = _u2f01(_xor_columns(sob_idx, sob["cols"][1], torch.zeros_like(sob_idx))) * res - py_f
            return torch.clamp(x, 0.0, 1.0 - 1e-6), torch.clamp(y, 0.0, 1.0 - 1e-6), sob_idx
        if sampler == SAMPLERS["maxmindist"]:
            # x = (i + 1/2) / n rotated per pixel, y = the searched generator
            # matrix, XOR-scrambled per pixel (sampler.maxmin_2d_dim0)
            n_mm = consts["maxmin"]["n"]
            i_mm = s_sel % n_mm
            y_mm = _xor_columns(i_mm, consts["maxmin"]["cols"], torch.zeros_like(i_mm)) ^ _pcg(hbase ^ 0x51D)
            u1 = (i_mm.to(torch.float32) + 0.5) / float(n_mm) + _u2f01(_pcg(hbase ^ 0xC9))
            return torch.where(u1 >= 1.0, u1 - 1.0, u1), _u2f01(y_mm), None
        if sampler == SAMPLERS["halton"]:
            # global index = offset[pixel] + s * stride; the jitter is the
            # fractional part of ri_2 * 2^j and ri_3 * 3^k
            hc = consts["halton"]
            idx = (hoff + s_sel * hc["stride"]) & M32
            x = _u2f01(_reverse_bits(idx)) * float(hc["sx"])
            y = rng.radical_inverse(1, idx) * float(hc["sy"])
            return x - torch.floor(x), y - torch.floor(y), None
        if is_random:
            h = _pcg(hbase ^ s_sel)
            u1, u2 = _u2f01(_pcg(h)), _u2f01(_pcg(h ^ 1))
            if sampler == SAMPLERS["stratified"]:
                # the reference's own strata: floor(sqrt(spp)) x spp // that,
                # always jittered (ROADMAP C)
                idx = s_sel % (strat_xs * strat_ys)
                u1 = ((idx % strat_xs).to(torch.float32) + u1) / float(strat_xs)
                u2 = (((idx // strat_xs) % strat_ys).to(torch.float32) + u2) / float(strat_ys)
            return u1, u2, None
        return _vdc(s_sel, _pcg(hbase)), _sobol2(s_sel, _pcg(hbase ^ 1)), None

    def camera(hbase, px_f, py_f, s_sel):
        """regen: film dimension 0 through the filter, lens dimension 1."""
        u1, u2, sob_idx = film_sample(hbase, px_f, py_f, s_sel)
        if consts["filter"] == "box":
            fx = px_f + 0.5 + (2.0 * u1 - 1.0) * fxw
            fy = py_f + 0.5 + (2.0 * u2 - 1.0) * fyw
        else:
            ox_, oy_, _w = filter_offset(consts["filter"], consts["filter_params"], u1, u2)
            fx, fy = px_f + 0.5 + ox_, py_f + 0.5 + oy_
        cx = r2c[0][0] * fx + r2c[0][1] * fy + r2c[0][3]
        cy = r2c[1][0] * fx + r2c[1][1] * fy + r2c[1][3]
        cz = r2c[2][0] * fx + r2c[2][1] * fy + r2c[2][3]
        w = r2c[3][0] * fx + r2c[3][1] * fy + r2c[3][3]
        inv_w = 1.0 / w
        dx, dy, dz = _norm3(cx * inv_w, cy * inv_w, cz * inv_w)
        if lens_r > 0:
            # thin-lens depth of field (perspective.rs generate_ray)
            if sob_idx is not None:
                ul1 = _u2f01(_xor_columns(sob_idx, consts["sobol"]["cols"][2], torch.zeros_like(sob_idx)))
                ul2 = _u2f01(_xor_columns(sob_idx, consts["sobol"]["cols"][3], torch.zeros_like(sob_idx)))
            elif is_random:
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
        """surface_interaction's triangle branch: flat with dpdu = v1 - v0
        without the attribute table; with it, the interpolated shading
        normal (ng flipped to its side) and the UV chart's dpdu."""
        v = sa.tri_p[sa.prim_geom[prim].long()]  # (R, 3, 3): the prim row's vertices
        b0 = 1.0 - b1 - b2
        e1 = [v[:, 1, c] - v[:, 0, c] for c in range(3)]
        e2 = [v[:, 2, c] - v[:, 0, c] for c in range(3)]
        ngx, ngy, ngz = _norm3(e1[1] * e2[2] - e1[2] * e2[1], e1[2] * e2[0] - e1[0] * e2[2],
                               e1[0] * e2[1] - e1[1] * e2[0])
        flip = (sa.prim_flags[prim] & FLAG_FLIP_GEOM_N) != 0
        ngx, ngy, ngz = (torch.where(flip, -c, c) for c in (ngx, ngy, ngz))
        if consts["has_attr"]:
            a = sa.wattr_rec[attr_row[prim]]  # (R, 16): n0 n1 n2, uv0 uv1 uv2
            nsx, nsy, nsz = _norm3(*(b0 * a[:, c] + b1 * a[:, 3 + c] + b2 * a[:, 6 + c] for c in range(3)))
            align = torch.where((ngx * nsx + ngy * nsy + ngz * nsz) < 0, -1.0, 1.0)
            ngx, ngy, ngz = ngx * align, ngy * align, ngz * align
            duv1x, duv1y = a[:, 11] - a[:, 9], a[:, 12] - a[:, 10]
            duv2x, duv2y = a[:, 13] - a[:, 9], a[:, 14] - a[:, 10]
            det = duv1x * duv2y - duv1y * duv2x
            degen = det.abs() <= 1e-12
            inv_det = torch.where(degen, 0.0, 1.0 / torch.where(degen, 1.0, det))
            dpdu = [torch.where(degen, e1[c], (duv2y * e1[c] - duv1y * e2[c]) * inv_det) for c in range(3)]
        else:
            nsx, nsy, nsz = ngx, ngy, ngz
            dpdu = e1
        d_dot = nsx * dpdu[0] + nsy * dpdu[1] + nsz * dpdu[2]
        ssx, ssy, ssz = dpdu[0] - nsx * d_dot, dpdu[1] - nsy * d_dot, dpdu[2] - nsz * d_dot
        sl = torch.sqrt(ssx * ssx + ssy * ssy + ssz * ssz)
        ok = sl > 1e-9
        inv_sl = 1.0 / torch.clamp(sl, min=1e-20)
        csg = torch.where(nsz >= 0, 1.0, -1.0)
        a_ = -1.0 / (csg + nsz)
        bb = nsx * nsy * a_
        ssx = torch.where(ok, ssx * inv_sl, 1.0 + csg * nsx * nsx * a_)
        ssy = torch.where(ok, ssy * inv_sl, csg * bb)
        ssz = torch.where(ok, ssz * inv_sl, -csg * nsx)
        at = {"ngx": ngx, "ngy": ngy, "ngz": ngz, "nsx": nsx, "nsy": nsy, "nsz": nsz,
              "ssx": ssx, "ssy": ssy, "ssz": ssz,
              "tsx": nsy * ssz - nsz * ssy, "tsy": nsz * ssx - nsx * ssz, "tsz": nsx * ssy - nsy * ssx}
        if consts["has_attr"]:  # the hit's uv: the chart's, or the default uvs'
            at["u"] = b0 * a[:, 9] + b1 * a[:, 11] + b2 * a[:, 13]
            at["v"] = b0 * a[:, 10] + b1 * a[:, 12] + b2 * a[:, 14]
        else:
            at["u"], at["v"] = b1 + b2, b2
        for c, key in enumerate("xyz"):
            at["p" + key] = b0 * v[:, 0, c] + b1 * v[:, 1, c] + b2 * v[:, 2, c]
            at["e" + key] = g7 * ((b0 * v[:, 0, c]).abs() + (b1 * v[:, 1, c]).abs() + (b2 * v[:, 2, c]).abs())
        return at

    checkers = {m: e["kd_tex"] for m, e in consts["mats"].items() if e.get("kd_tex")}

    def checker_kd(at, mat):
        """The checkerboard Kd of the lanes whose material has one: (mask,
        (R, 3) Kd), the even cells' color where floor(s) + floor(t) is even
        (reference :1273-1287), or None without checkerboards."""
        if not checkers:
            return None
        mask = torch.zeros(mat.shape, dtype=torch.bool, device=dev)
        kd = torch.zeros(mat.shape + (3,), dtype=torch.float32, device=dev)
        for m, c in checkers.items():
            s_t = _f32(c["us"]) * at["u"] + _f32(c["du"])
            t_t = _f32(c["vs"]) * at["v"] + _f32(c["dv"])
            even = torch.remainder(torch.floor(s_t) + torch.floor(t_t), 2.0) == 0
            cells = torch.where(even[:, None], torch.tensor(np.float32(c["c1"]), device=dev),
                                torch.tensor(np.float32(c["c2"]), device=dev))
            mm = mat == m
            kd = torch.where(mm[:, None], cells, kd)
            mask = mask | mm
        return mask, kd

    def sphere_lamp_sample(lp, lt, par, at, u1, u2):
        """NEE toward a sphere lamp (reference :1443-1537): the visible
        cone from outside, a uniform point on the sphere from inside;
        returns the light sample's (wi, Li, distance, pdf)."""
        outside, pdf_cone, (tox, toy, toz, dc2, cos_tm) = cone_pdf(lp, at["px"], at["py"], at["pz"])
        dc = torch.sqrt(dc2)
        invc = 1.0 / dc
        wcx, wcy, wcz = tox * invc, toy * invc, toz * invc
        sgn = torch.where(wcz >= 0.0, 1.0, -1.0)
        a_cs = -1.0 / (sgn + wcz)
        b_cs = wcx * wcy * a_cs
        vxx, vxy, vxz = 1.0 + sgn * wcx * wcx * a_cs, sgn * b_cs, -sgn * wcx
        vyx, vyy, vyz = b_cs, sgn + wcy * wcy * a_cs, -wcy
        cos_t = (1.0 - u1) + u1 * cos_tm
        sin2_t = torch.clamp(1.0 - cos_t * cos_t, min=0.0)
        ds_ = dc * cos_t - torch.sqrt(torch.clamp(lp["rw2"] - dc2 * sin2_t, min=0.0))
        cos_a = torch.clamp((dc2 + lp["rw2"] - ds_ * ds_) / torch.clamp(2.0 * dc * lp["rw"], min=1e-12), -1.0, 1.0)
        sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
        phi_c = two_pi * u2
        sa_c, sa_s = sin_a * torch.cos(phi_c), sin_a * torch.sin(phi_c)
        nwx = sa_c * -vxx + sa_s * -vyx + cos_a * -wcx
        nwy = sa_c * -vxy + sa_s * -vyy + cos_a * -wcy
        nwz = sa_c * -vxz + sa_s * -vyz + cos_a * -wcz
        ps_c = [lp["c"][0] + lp["rw"] * nwx, lp["c"][1] + lp["rw"] * nwy, lp["c"][2] + lp["rw"] * nwz]
        # inside: a uniform object-space point (lights._sample_prim_point)
        zz = 1.0 - 2.0 * u1
        rr = torch.sqrt(torch.clamp(1.0 - zz * zz, min=0.0))
        ph = two_pi * u2
        do = [rr * torch.cos(ph), rr * torch.sin(ph), zz]
        M, Tt = lp["o2w"], lp["w2oT"]
        ps_a = [M[r][0] * (lp["robj"] * do[0]) + M[r][1] * (lp["robj"] * do[1]) + M[r][2] * (lp["robj"] * do[2])
                + M[r][3] for r in range(3)]
        na = _norm3(*(Tt[r][0] * do[0] + Tt[r][1] * do[1] + Tt[r][2] * do[2] for r in range(3)))
        if lt["flip"]:
            na = [-x for x in na]
        ps = [torch.where(outside, a, b) for a, b in zip(ps_c, ps_a)]
        ngl = [torch.where(outside, a, b) for a, b in zip((nwx, nwy, nwz), na)]
        tx, ty, tz = ps[0] - at["px"], ps[1] - at["py"], ps[2] - at["pz"]
        d2 = torch.clamp(tx * tx + ty * ty + tz * tz, min=1e-12)
        dl = torch.sqrt(d2)
        invl = 1.0 / dl
        wxa, wya, wza = tx * invl, ty * invl, tz * invl
        cos_l = -(wxa * ngl[0] + wya * ngl[1] + wza * ngl[2])
        emits = outside | (cos_l > 0) | bool(lt["two_sided"])
        pdf_a = d2 / torch.clamp(cos_l.abs() * _f32(lt["area"]), min=1e-12)
        pdf_a = torch.where(cos_l.abs() > 1e-7, pdf_a, 0.0)
        return (wxa, wya, wza, torch.where(emits, par[0], 0.0), torch.where(emits, par[1], 0.0),
                torch.where(emits, par[2], 0.0), dl, torch.where(outside, pdf_cone, pdf_a))

    def nee(hbase, s_cur, dim_base, alive_sh, at, wox, woy, woz, mat, kd_over=None):
        """estimate_direct for one selected light, delta or triangle area,
        with MIS and an any-hit shadow walk."""
        kd = [T.f["color"][mat, ch] for ch in range(3)]
        if kd_over is not None:
            kd = [torch.where(kd_over[0], kd_over[1][:, ch], kd[ch]) for ch in range(3)]
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
        if any_area or inf_idx >= 0:
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
            elif lt["kind"] == LIGHT_INFINITE:
                # the constant environment: a uniform sphere direction, pdf 1/4pi
                ws = uniform_sample_sphere(u1, u2)
                vals = (ws[:, 0], ws[:, 1], ws[:, 2], par[3], par[4], par[5], wr2, _f32(INV_4PI))
                is_delta = is_delta & ~m
            elif lt.get("sphere"):
                vals = sphere_lamp_sample(lamps[i], lt, par, at, u1, u2)
                is_delta = is_delta & ~m
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
        for pr in spheres:
            occ = occ | _sph_test(pr, osx, osy, osz, wix, wiy, wiz, t_sh)[0]
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
        prim = torch.clamp(prim, min=0)
        at = tri_attrs(prim, b1, b2)
        mat = sa.prim_mat[prim].long()
        light_h = sa.prim_light[prim].long()
        if spheres:
            # the baked spheres merged against the walk's winner, the
            # triangle keeping a tie (reference :1663-1677)
            t_all = torch.where(valid, _t, 1e30)
            for pr in spheres:
                h_s, t_s, p_loc = _sph_test(pr, ox, oy, oz, dx, dy, dz, t_query)
                better = torch.where(h_s, t_s, 1e30) < t_all
                t_all = torch.where(better, t_s, t_all)
                at_s = _sph_attrs(pr, p_loc)
                at_s["u"] = at_s["v"] = torch.zeros_like(ox)  # no uv is baked for spheres
                at = {k: torch.where(better, at_s[k], v) for k, v in at.items()}
                mat = torch.where(better, pr["mat"], mat)
                light_h = torch.where(better, pr["light"], light_h)
                valid = valid | better
        nv = nv + torch.where(alive & valid, 1.0, 0.0)
        wox, woy, woz = -dx, -dy, -dz
        if inf_idx >= 0:
            # escaped rays pick up the constant environment with the
            # deferred MIS weight
            esc = alive & ~valid
            p_env = _f32(INV_4PI * float(consts["light_pmf"][inf_idx]))
            w_env = torch.where(prev_spec, 1.0, _power_heuristic(prev_pdf, torch.full_like(prev_pdf, p_env)))
            par_e = [_f32(x) for x in lights[inf_idx]["par"][3:6]]
            L = [L[ch] + torch.where(esc, beta[ch] * par_e[ch] * w_env, 0.0) for ch in range(3)]
        if any_area:
            # area-light emission with deferred MIS (diffuse.rs l())
            emitting = alive & valid & (light_h >= 0)
            lh = torch.clamp(light_h, min=0)
            em = (_dot3(at["ngx"], at["ngy"], at["ngz"], wox, woy, woz) > 0) | two_t[lh]
            tx, ty, tz = at["px"] - ppx, at["py"] - ppy, at["pz"] - ppz
            d2 = torch.clamp(tx * tx + ty * ty + tz * tz, min=1e-12)
            wl = 1.0 / torch.sqrt(d2)
            cos_l = _dot3(at["ngx"], at["ngy"], at["ngz"], -tx * wl, -ty * wl, -tz * wl).abs()
            p_lh = torch.where(cos_l > 1e-7, d2 / torch.clamp(cos_l * area_t[lh], min=1e-12), 0.0) * selp_t[lh]
            for i, lp in lamps.items():
                # a sphere lamp seen from outside: the cone's density
                outside, pdf_cone, _geo = cone_pdf(lp, ppx, ppy, ppz)
                p_lh = torch.where((light_h == i) & outside, pdf_cone * pmf[i], p_lh)
            w_mis = torch.where(prev_spec, 1.0, _power_heuristic(prev_pdf, p_lh))
            L = [L[ch] + torch.where(emitting, beta[ch] * torch.where(em, le_t[lh, ch], 0.0) * w_mis, 0.0)
                 for ch in range(3)]
        alive_b = alive & valid
        dim_base = 2 + bounces * DPB
        can_scatter = alive_b & (bounces < max_depth - 1)
        alive_sh = can_scatter & ~T.in_lobes(mat, (LOBE_NONE,))
        kd_over = checker_kd(at, mat)
        bs = T.bsdf_sample(sample_1d, sample_2d, hbase, s_cur, dim_base, at, wox, woy, woz, mat, kd_over)
        c = nee(hbase, s_cur, dim_base, alive_sh, at, wox, woy, woz, mat, kd_over)
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
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
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


def _launch(entry: str, blob, mode: int, tables, px, py, pids, s0: int, n_samples: int, seed: int, stab, *extra):
    dev = px.device
    if dev.type != "cuda":
        raise ValueError("wide_megakernel_cuda takes CUDA tensors")
    if not 0 <= mode < N_MODES:
        raise ValueError(f"bad kernel mode {mode}")
    n_blob = SPH_BLOB_FLOATS if mode >= 4 * N_SAMPLER_IDS else BLOB_FLOATS
    if blob.device != dev or blob.dtype != torch.float32 or blob.numel() != n_blob:
        raise ValueError(f"blob must be {n_blob} float32 values on {dev}")
    _check_tables(tables, dev)
    sampler = (mode // 2) % N_SAMPLER_IDS
    if stab is None:
        if sampler in (SAMPLERS["halton"], SAMPLERS["sobol"], SAMPLERS["maxmindist"]):
            raise ValueError("the halton, sobol and maxmindist modes need their sampler_table")
        stab = torch.zeros(1, dtype=torch.int32, device=dev)
    if stab.device != dev or stab.dtype != torch.int32 or not stab.is_contiguous():
        raise ValueError(f"the sampler table must be a contiguous int32 tensor on {dev}")
    attr = tables.wattr_rec
    if mode >= 2 * N_SAMPLER_IDS and attr is not None and (
            attr.device != dev or attr.dtype != torch.float32 or not attr.is_contiguous()
            or attr.shape != tables.wleaf_rec.shape):
        raise ValueError(f"wattr_rec must be a contiguous float32 tensor of wleaf_rec's shape on {dev}")
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
        pops = wide_megakernel_cuda.pops.setdefault(dev, torch.zeros(2, dtype=torch.int64, device=dev))
    counters = wide_megakernel_cuda.counters.get(dev)
    if counters is None:
        counters = wide_megakernel_cuda.counters.setdefault(dev, torch.zeros(2, dtype=torch.int32, device=dev))
    queue = torch.zeros(1, dtype=torch.int32, device=dev)  # the next unserved lane
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the extended modes read the attribute rows when the scene has them
    attr_ptr = attr.data_ptr() if mode >= 2 * N_SAMPLER_IDS and attr is not None else None
    with torch.cuda.device(dev):  # the C entry launches on the calling thread's current device
        err = fn(blob.data_ptr(), lanes[0].data_ptr(), lanes[1].data_ptr(), lanes[2].data_ptr(), R,
                 int(seed) & M32, int(s0) & M32, int(n_samples), int(mode),
                 tables.wnode_rec.data_ptr(), tables.wleaf_rec.data_ptr(), attr_ptr, stab.data_ptr(),
                 out_l.data_ptr(), out_w.data_ptr(), out_nv.data_ptr(), pops.data_ptr(), counters.data_ptr(),
                 queue.data_ptr(), stream, *(x.data_ptr() for x in extra))
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    return out_l, out_w, out_nv


def wide_megakernel_cuda(blob, mode: int, tables, px, py, pids, s0: int, n_samples: int, seed: int, stab=None):
    """Launch the CUDA kernel on the current stream. blob: pack_wide_consts's
    float32 tensor on the lanes' device; mode: kernel_mode(consts); tables:
    the scene tensors holding the wide BVH's wnode_rec and wleaf_rec (and
    wattr_rec, read by the extended modes); px, py, pids: (R,) integer CUDA
    tensors; stab: sampler_table(consts) on the device (required by the
    halton, sobol and maxmindist modes; the halton offsets cover every pixel
    id in pids). Returns (accLw (R, 3), accW (R,),
    n_vertices (R,)) float32. Adds one to ``wide_megakernel_cuda.launches``
    per launch; the closest-hit and shadow pops accumulate in
    ``wide_megakernel_cuda.pops[device]`` (int64 (2,)), stack overflows and
    iteration-cap hits in ``wide_megakernel_cuda.counters[device]`` (int32
    (2,)); raises on a refused launch."""
    out = _launch("wide_megakernel", blob, mode, tables, px, py, pids, s0, n_samples, seed, stab)
    nvcc.count_launch(wide_megakernel_cuda)
    return out


def wide_megakernel_split(blob, mode: int, tables, px, py, pids, s0: int, n_samples: int, seed: int):
    """wide_megakernel_cuda through the instrumented instantiation, which
    exists for mode 1 only ((0,2) sampler, box filter, area lights) and which no route
    launches: returns (accLw, accW, n_vertices, split), split mapping
    SPLIT_FIELDS to cycle counts summed over the launch."""
    prof = torch.zeros(len(SPLIT_FIELDS), dtype=torch.int64, device=px.device)
    out = _launch("wide_megakernel_split", blob, mode, tables, px, py, pids, s0, n_samples, seed, None, prof)
    return (*out, dict(zip(SPLIT_FIELDS, prof.tolist())))


wide_megakernel_cuda.launches = 0
wide_megakernel_cuda.pops = {}  # device -> int64 (2,): closest-hit pops, shadow pops
wide_megakernel_cuda.counters = {}  # device -> int32 (2,): stack overflows, iteration-cap hits


def make_wide_megakernel_fn(cs, cam, icfg, scfg, fcfg, max_tris, consts=None):
    """The wave_p-compatible persistent function backed by the wide
    megakernel: fn(sa, px, py, pids, s0, n_samples, seed) -> (accLw (R, 3),
    accW (R,), n_vertices (R,)), or None if the scene is outside the class.
    CUDA lanes launch the kernel, CPU lanes run the plain twin; there is no
    fallback from one to the other. fn.blob, fn.stab (on the scene's device)
    and fn.mode are the kernel's arguments for the scene's consts."""
    if consts is None:
        consts = extract_wide_consts(cs, cam, icfg, scfg, fcfg, max_tris)
    if consts is None:
        return None
    blob_cpu = pack_wide_consts(consts)
    mode = kernel_mode(consts)
    # uploaded here, not in the first launch, so a render's timed loop holds
    # only the launch
    dev0 = cs.arrays.device
    blobs = {dev0: blob_cpu.to(dev0)}
    stabs = {dev0: sampler_table(consts, dev0)}

    def wave_p(sa, px, py, pixel_ids, s0, n_samples, seed):
        if px.device.type == "cuda":
            if px.device not in blobs:
                blobs[px.device] = blob_cpu.to(px.device)
                stabs[px.device] = sampler_table(consts, px.device)
            return wide_megakernel_cuda(blobs[px.device], mode, sa, px, py, pixel_ids, s0, n_samples, seed,
                                        stabs[px.device])
        if px.device.type == "cpu":
            return wide_megakernel_plain(consts, sa, px, py, pixel_ids, s0, n_samples, seed)
        raise ValueError(f"the wide megakernel has no implementation for device {px.device}")

    # what the launch takes, for tools that time or instrument the route's
    # own launch (chip_smoke.py, tools/torch_phases.py)
    wave_p.blob, wave_p.mode, wave_p.stab = blobs[dev0], mode, stabs[dev0]
    return wave_p
