"""Material evaluation: per-ray material rows -> BSDF lobe sets.

The port's counterpart of ``pbrt_tpu/device/materials.py make_bsdf`` for
matte (Lambert or Oren-Nayar), mirror, glass, metal, plastic and uber
(src/materials/*.rs). With constant parameters a material row's lobes do
not depend on the hit, so:

- ``bake_lobes`` writes every material row's full lobe set, kinds (M, 8)
  and data (M, 8, 14), to the reference's slots with the reference's
  float32 arithmetic (the brute megakernel reads it too);
- ``lobe_table`` keeps the slots that hold a lobe in some row, with the
  kinds each can hold (the reference's static ``possible`` sets, here read
  from the table), once per route;
- ``make_bsdf`` is a row gather of that table.

A scene with a textured parameter builds each hit's lobes instead: the
texture programs the rows read are evaluated per lane (device/texture.py)
and the same lobe formulas (``_lobes``) run over the lanes' parameters.
The scene compiler refuses every other material.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..scene.arrays import (
    MAT_GLASS, MAT_MATTE, MAT_METAL, MAT_MIRROR, MAT_PLASTIC, MAT_UBER, P_ETA, P_K, P_KD, P_KR, P_KS, P_KT,
    P_OPACITY, P_SIGMA, P_UROUGH, P_VROUGH,
)
from .texture import eval_textures, material_param, needed_programs
from .bsdf import (
    LOBE_FRESNEL_SPEC, LOBE_LAMBERT_R, LOBE_MICRO_R, LOBE_MICRO_T, LOBE_NONE, LOBE_OREN_NAYAR,
    LOBE_SPEC_R, LOBE_SPEC_T, N_SLOTS, tr_roughness_to_alpha,
)

# Fresnel kinds of a lobe's data[11] (materials.py FR_*)
FR_NONE = 0.0
FR_DIELECTRIC = 1.0
FR_CONDUCTOR = 2.0

BAKED_KINDS = frozenset({MAT_MATTE, MAT_MIRROR, MAT_GLASS, MAT_METAL, MAT_PLASTIC, MAT_UBER})


# the slots and lobe kinds each material kind can write (the reference's
# make_bsdf puts), for the `possible` sets of rows whose lobes vary per hit
_KIND_SLOTS = {
    MAT_MATTE: {0: (LOBE_LAMBERT_R, LOBE_OREN_NAYAR)},
    MAT_MIRROR: {4: (LOBE_SPEC_R,)},
    MAT_GLASS: {4: (LOBE_FRESNEL_SPEC, LOBE_SPEC_R), 5: (LOBE_SPEC_T,), 2: (LOBE_MICRO_R,), 3: (LOBE_MICRO_T,)},
    MAT_PLASTIC: {0: (LOBE_LAMBERT_R,), 2: (LOBE_MICRO_R,)},
    MAT_METAL: {2: (LOBE_MICRO_R,)},
    MAT_UBER: {6: (LOBE_SPEC_T,), 0: (LOBE_LAMBERT_R,), 2: (LOBE_MICRO_R,), 4: (LOBE_SPEC_R,), 5: (LOBE_SPEC_T,)},
}


def lobe_table(sa, static):
    """The scene's lobes per material row, for make_bsdf: {"kind" (M, S),
    "data" (M, S, 14), "possible" (S frozensets of lobe kinds),
    "has_beckmann", "slots"}, S the slots of bake_lobes that some row
    fills, in slot order (a row with fewer lobes holds LOBE_NONE and zero
    data there). A scene with textured parameters gets {"textured": True,
    "slots", "possible", "has_beckmann", "programs"}: its lobes are built
    per hit, in every slot each present material kind can fill, from the
    texture programs the material rows read."""
    if bool((sa.mat_tex >= 0).any()):
        if set(static.mat_kinds_present) - BAKED_KINDS:
            raise NotImplementedError("textured lobes cover matte, mirror, glass, metal, plastic and uber only")
        poss: dict[int, set] = {}
        for k in static.mat_kinds_present:
            for slot, kinds in _KIND_SLOTS[int(k)].items():
                poss.setdefault(slot, set()).update(kinds)
        slots = sorted(poss) or [0]
        return {"textured": True, "slots": slots,
                "possible": tuple(frozenset(poss.get(s_, ())) for s_ in slots),
                "has_beckmann": bool(((sa.mat_remap >> 1) & 1).any()),
                "programs": needed_programs(static.tex_programs, sa.mat_tex.flatten().tolist())}
    kind, data = bake_lobes(sa, static)
    k = kind.cpu().numpy()
    slots = [s for s in range(N_SLOTS) if (k[:, s] != LOBE_NONE).any()] or [0]
    micro = np.isin(k, (LOBE_MICRO_R, LOBE_MICRO_T)) & (data[..., 12].cpu().numpy() > 0)
    return {"kind": kind[:, slots].contiguous(), "data": data[:, slots].contiguous(),
            "possible": tuple(frozenset(int(x) for x in np.unique(k[:, s]) if x != LOBE_NONE) for s in slots),
            "has_beckmann": bool(micro.any()), "slots": slots}


def make_bsdf(sa, static, mat_ids, table=None, uv=None, p=None, duvdx=None, duvdy=None, atlases=None):
    """Lobe sets for a wave of shading points (mat_ids: (R,) rows): rows of
    `table` (lobe_table of the scene, made here when not given), or, for a
    scene with textured parameters, the lobes of each hit's parameters:
    the textures evaluated at uv (R, 2) and p (R, 3) with the MIPMap
    footprint duvdx, duvdy (R, 2) (None: the finest level) and the route's
    mip atlases (texture.prepare_atlases)."""
    if table is None:
        table = lobe_table(sa, static)
    if not table.get("textured"):
        return {"kind": table["kind"][mat_ids], "data": table["data"][mat_ids], "possible": table["possible"],
                "has_beckmann": table["has_beckmann"]}
    tex_values = eval_textures(sa, static.tex_programs, uv, p, duvdx, duvdy, atlases=atlases,
                               only=table["programs"])
    kind, data = _lobes(sa.mat_kind[mat_ids], sa.mat_remap[mat_ids],
                        lambda slot: material_param(sa, tex_values, mat_ids, slot), static.mat_kinds_present)
    slots = table["slots"]
    return {"kind": kind[:, slots].contiguous(), "data": data[:, slots].contiguous(),
            "possible": table["possible"], "has_beckmann": table["has_beckmann"]}


def bake_lobes(sa, static):
    """Lobe kinds (M, 8) int32 and data (M, 8, 14) float32 of every material
    row, as the reference's make_bsdf writes them for constant parameters
    (materials.py:150-260). Data columns: color 0:3, eta 3 (or rgb 3:6),
    k or Kt 6:9, alpha_x 9, alpha_y 10, Fresnel kind 11, then Oren-Nayar
    (A, B) or the micro lobes' Beckmann flag in 12:14."""
    if set(static.mat_kinds_present) - BAKED_KINDS:
        raise NotImplementedError("bake_lobes covers matte, mirror, glass, metal, plastic and uber only")
    return _lobes(sa.mat_kind, sa.mat_remap, lambda slot: sa.mat_const[:, slot], static.mat_kinds_present)


def _lobes(kind, remap_row, param, kinds_present):
    """Lobe kinds (N, 8) and data (N, 8, 14) of N shading points or material
    rows: kind and remap_row (N,) per point, param(slot) -> (N, 3) the
    parameter values, with the reference's clamps (materials.py:150-260).
    Uber's lobes are built only when kinds_present (the scene's material
    kinds) holds it, so other scenes trace no more operations."""
    M = kind.shape[0]
    dev = kind.device
    remap = (remap_row & 1) != 0
    beck_f = ((remap_row >> 1) & 1).to(torch.float32)
    zero_r = torch.zeros(M, dtype=torch.float32, device=dev)

    kd = torch.clamp(param(P_KD), 0.0, 1.0)
    sigma = param(P_SIGMA)[:, 0]
    kr = torch.clamp(param(P_KR), min=0.0)
    kt = torch.clamp(param(P_KT), min=0.0)
    ks = torch.clamp(param(P_KS), min=0.0)
    eta3 = param(P_ETA)
    eta = torch.where(eta3[:, 0] > 0, eta3[:, 0], 1.5)
    kcond = param(P_K)

    def alpha_of(r):
        return torch.clamp(torch.where(remap, tr_roughness_to_alpha(r), r), min=1e-3)

    urough = param(P_UROUGH)[:, 0]
    vrough = param(P_VROUGH)[:, 0]
    ax = alpha_of(urough)
    ay = alpha_of(vrough)

    out_kind = torch.zeros((M, N_SLOTS), dtype=torch.int32, device=dev)
    data = torch.zeros((M, N_SLOTS, 14), dtype=torch.float32, device=dev)

    def put(slot, mask, lobe, color, eta=None, k_or_t=None, ax=None, ay=None, fresnel=FR_NONE, ab=None):
        """Masked write of one lobe into `slot` (materials._LobeWriter.put)."""
        def sel(c, value):
            v = torch.broadcast_to(torch.as_tensor(value, dtype=torch.float32, device=dev), (M,))
            data[:, slot, c] = torch.where(mask, v, data[:, slot, c])

        out_kind[:, slot] = torch.where(mask, lobe, out_kind[:, slot])
        for c in range(3):
            sel(c, color[:, c] if color.dim() == 2 else color)
        if eta is not None:
            eta = torch.as_tensor(eta, dtype=torch.float32, device=dev)
            if eta.dim() <= 1:
                sel(3, eta)
            else:
                for c in range(3):
                    sel(3 + c, eta[:, c])
        if k_or_t is not None:
            for c in range(3):
                sel(6 + c, k_or_t[:, c])
        if ax is not None:
            sel(9, ax)
            sel(10, ay)
        sel(11, fresnel)
        if ab is not None:
            sel(12, ab[0])
            sel(13, ab[1])

    def nonblack(c):
        return (c > 0).any(-1)

    m = kind == MAT_MATTE
    has_kd = nonblack(kd)
    # Oren-Nayar A/B from sigma in degrees (reflection.rs:901)
    sig_rad = torch.clamp(sigma, 0.0, 90.0) * torch.tensor(math.pi / 180.0, dtype=torch.float32)
    s2 = sig_rad * sig_rad
    a_on = 1.0 - s2 / (2.0 * (s2 + 0.33))
    b_on = 0.45 * s2 / (s2 + 0.09)
    use_on = sigma != 0.0
    put(0, m & has_kd & ~use_on, LOBE_LAMBERT_R, kd)
    put(0, m & has_kd & use_on, LOBE_OREN_NAYAR, kd, ab=(a_on, b_on))

    m = kind == MAT_MIRROR
    put(4, m & nonblack(kr), LOBE_SPEC_R, kr, fresnel=FR_NONE)

    m = kind == MAT_GLASS
    smooth = (urough == 0) & (vrough == 0)
    both = nonblack(kr) & nonblack(kt)
    put(4, m & smooth & both, LOBE_FRESNEL_SPEC, kr, eta=eta, k_or_t=kt)
    put(4, m & smooth & ~both & nonblack(kr), LOBE_SPEC_R, kr, eta=eta, fresnel=FR_DIELECTRIC)
    put(5, m & smooth & ~both & nonblack(kt), LOBE_SPEC_T, kt, eta=eta)
    put(2, m & ~smooth & nonblack(kr), LOBE_MICRO_R, kr, eta=eta, ax=ax, ay=ay, fresnel=FR_DIELECTRIC,
        ab=(beck_f, zero_r))
    put(3, m & ~smooth & nonblack(kt), LOBE_MICRO_T, kt, eta=eta, ax=ax, ay=ay, ab=(beck_f, zero_r))

    m = kind == MAT_PLASTIC
    put(0, m & nonblack(kd), LOBE_LAMBERT_R, kd)
    put(2, m & nonblack(ks), LOBE_MICRO_R, ks, eta=1.5, ax=ax, ay=ay, fresnel=FR_DIELECTRIC, ab=(beck_f, zero_r))

    m = kind == MAT_METAL
    one = torch.ones((M, 3), dtype=torch.float32, device=dev)
    put(2, m, LOBE_MICRO_R, one, eta=eta3, k_or_t=kcond, ax=ax, ay=ay, fresnel=FR_CONDUCTOR, ab=(beck_f, zero_r))

    if MAT_UBER in kinds_present:
        # uber.rs: a pass-through specular transmission of weight 1 -
        # opacity, then the opaque lobes scaled by opacity
        m = kind == MAT_UBER
        op = torch.clamp(param(P_OPACITY), 0.0, 1.0)
        inv_op = 1.0 - op
        put(6, m & nonblack(inv_op), LOBE_SPEC_T, inv_op, eta=1.0 + 1e-5)
        put(0, m & nonblack(op * kd), LOBE_LAMBERT_R, op * kd)
        put(2, m & nonblack(op * ks), LOBE_MICRO_R, op * ks, eta=eta, ax=ax, ay=ay, fresnel=FR_DIELECTRIC,
            ab=(beck_f, zero_r))
        put(4, m & nonblack(op * kr), LOBE_SPEC_R, op * kr, eta=eta, fresnel=FR_DIELECTRIC)
        put(5, m & nonblack(op * kt), LOBE_SPEC_T, op * kt, eta=eta)
    return out_kind, data


def lobes_at_origin(sa, static):
    """Lobe kinds (M, 8) and data (M, 8, 14) of every material row with its
    textures evaluated at uv = (0, 0), p = 0 and the finest MIP level: what
    the reference's megakernel extractors bake (make_bsdf over the rows at
    the origin); bake_lobes for a scene without textured parameters."""
    if not bool((sa.mat_tex >= 0).any()):
        return bake_lobes(sa, static)
    if set(static.mat_kinds_present) - BAKED_KINDS:
        raise NotImplementedError("bake_lobes covers matte, mirror, glass, metal, plastic and uber only")
    M = sa.mat_kind.shape[0]
    dev = sa.mat_kind.device
    rows = torch.arange(M, device=dev)
    uv = torch.zeros((M, 2), dtype=torch.float32, device=dev)
    p = torch.zeros((M, 3), dtype=torch.float32, device=dev)
    tex_values = eval_textures(sa, static.tex_programs, uv, p,
                               only=needed_programs(static.tex_programs, sa.mat_tex.flatten().tolist()))
    return _lobes(sa.mat_kind, sa.mat_remap, lambda slot: material_param(sa, tex_values, rows, slot),
                  static.mat_kinds_present)
