"""Material evaluation: per-ray material rows -> BSDF lobe sets.

The port's counterpart of ``pbrt_tpu/device/materials.py make_bsdf`` for
matte (Lambert or Oren-Nayar), mirror, glass, metal, plastic, uber,
substrate, translucent, disney, mix, fourier and hair (src/materials/*.rs).
With constant parameters a material row's lobes do not depend on the hit,
so:

- ``bake_lobes`` writes every material row's full lobe set, kinds (M, 8)
  and data (M, 8, 14), to the reference's slots with the reference's
  float32 arithmetic (the megakernels' extractors read it too);
- ``lobe_table`` keeps the slots that hold a lobe in some row, with the
  kinds each can hold (the reference's static ``possible`` sets, here read
  from the table), once per route;
- ``make_bsdf`` is a row gather of that table, with two per-hit steps:
  a mix row resolves to one of its two sub-rows by a hash of the hit point
  (``_resolve_mix``) and that row's lobe colors are scaled, and a hair
  lobe takes its h across the fiber from the hit's v.

A scene with a textured parameter builds each hit's lobes instead: the
texture programs the rows read are evaluated per lane (device/texture.py)
and the same lobe formulas (``_lobes``) run over the lanes' parameters.
The subsurface and kdsubsurface materials build their interface lobes
(Fresnel reflection, specular or GGX, and diffuse transmission); the
BSSRDF's exit-point lobe (bsdf.LOBE_SSS_ADAPTER) is made by the wave's
subsurface event itself. The interface (null) material writes no lobe.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import rng
from ..scene.arrays import (
    MAT_DISNEY, MAT_FOURIER, MAT_GLASS, MAT_HAIR, MAT_KDSUBSURFACE, MAT_MATTE, MAT_METAL, MAT_MIRROR, MAT_MIX,
    MAT_NONE, MAT_PLASTIC, MAT_SUBSTRATE, MAT_SUBSURFACE, MAT_TRANSLUCENT, MAT_UBER, P_ETA, P_EXTRA, P_EXTRA2, P_K,
    P_KD, P_KR, P_KS, P_KT, P_OPACITY, P_REFLECT, P_SIGMA, P_TRANSMIT, P_UROUGH, P_VROUGH,
)
from .texture import eval_textures, material_param, needed_programs
from .bsdf import (
    LOBE_CLEARCOAT, LOBE_DISNEY_DIFF, LOBE_FOURIER, LOBE_FRESNEL_BLEND, LOBE_FRESNEL_SPEC, LOBE_HAIR,
    LOBE_LAMBERT_R, LOBE_LAMBERT_T, LOBE_MICRO_R, LOBE_MICRO_T, LOBE_NONE, LOBE_OREN_NAYAR, LOBE_SPEC_R,
    LOBE_SPEC_T, N_SLOTS, ipow, tr_roughness_to_alpha,
)

# Fresnel kinds of a lobe's data[11] (materials.py FR_*)
FR_NONE = 0.0
FR_DIELECTRIC = 1.0
FR_CONDUCTOR = 2.0
FR_SCHLICK = 3.0

# the slots and lobe kinds each material kind can write (the reference's
# make_bsdf puts), for the `possible` sets of rows whose lobes vary per hit
_KIND_SLOTS = {
    MAT_MATTE: {0: (LOBE_LAMBERT_R, LOBE_OREN_NAYAR)},
    MAT_MIRROR: {4: (LOBE_SPEC_R,)},
    MAT_GLASS: {4: (LOBE_FRESNEL_SPEC, LOBE_SPEC_R), 5: (LOBE_SPEC_T,), 2: (LOBE_MICRO_R,), 3: (LOBE_MICRO_T,)},
    MAT_PLASTIC: {0: (LOBE_LAMBERT_R,), 2: (LOBE_MICRO_R,)},
    MAT_METAL: {2: (LOBE_MICRO_R,)},
    MAT_UBER: {6: (LOBE_SPEC_T,), 0: (LOBE_LAMBERT_R,), 2: (LOBE_MICRO_R,), 4: (LOBE_SPEC_R,), 5: (LOBE_SPEC_T,)},
    MAT_SUBSTRATE: {2: (LOBE_FRESNEL_BLEND,)},
    MAT_TRANSLUCENT: {0: (LOBE_LAMBERT_R,), 1: (LOBE_LAMBERT_T,), 2: (LOBE_MICRO_R,), 3: (LOBE_MICRO_T,)},
    MAT_DISNEY: {0: (LOBE_DISNEY_DIFF,), 2: (LOBE_MICRO_R,), 6: (LOBE_CLEARCOAT,), 3: (LOBE_MICRO_T,)},
    MAT_MIX: {},  # its sub-materials' kinds are in mat_kinds_present
    MAT_FOURIER: {5: (LOBE_FOURIER,)},
    MAT_HAIR: {0: (LOBE_HAIR,)},
    MAT_SUBSURFACE: {4: (LOBE_SPEC_R,), 2: (LOBE_MICRO_R,), 1: (LOBE_LAMBERT_T,)},
    MAT_KDSUBSURFACE: {4: (LOBE_SPEC_R,), 2: (LOBE_MICRO_R,), 1: (LOBE_LAMBERT_T,)},
    MAT_NONE: {},
}


def _extras(table, sa, static):
    """The lobe set's scene-wide entries: the Beckmann and Schlick flags
    (a Schlick Fresnel comes with disney rows only) and the Fourier tables."""
    out = {"has_beckmann": table["has_beckmann"], "has_schlick": MAT_DISNEY in static.mat_kinds_present}
    if static.has_fourier:
        out["fourier"] = sa.fourier
    return out


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


def _resolve_mix(sa, mat_ids, p, amount):
    """mix.rs resolved once per hit (the reference's materials.py:167-189):
    a mix row takes its first sub-row where a hash of the hit point's float
    bits and the row id falls below q = clip(mean(amount), 0.02, 0.98),
    else its second, and the sub-row's lobe colors are scaled by
    amount / q or (1 - amount) / (1 - q). amount: (R, 3) the mix rows' Kd
    slot. Returns (is_mix (R,), rows (R,), scale (R, 3)). A sub-row that is
    itself a mix is not resolved again: it writes no lobe, as in the
    reference."""
    is_mix = sa.mat_kind[mat_ids] == MAT_MIX
    amt = torch.clamp(amount, 0.0, 1.0)
    q = torch.clamp((amt[:, 0] + amt[:, 1] + amt[:, 2]) / 3.0, 0.02, 0.98)
    bits = [p[:, c].contiguous().view(torch.int32) for c in range(3)]
    u_mix = rng.u32_to_float(rng.hash_combine(*bits, mat_ids))
    use1 = u_mix < q
    sub = sa.mat_const[mat_ids, P_EXTRA, 0:2].to(torch.int64)
    scale = torch.where(use1[:, None], amt / q[:, None], (1.0 - amt) / (1.0 - q)[:, None])
    rows = torch.where(is_mix, torch.where(use1, sub[:, 0], sub[:, 1]), mat_ids.to(torch.int64))
    return is_mix, rows, scale


def make_bsdf(sa, static, mat_ids, table=None, uv=None, p=None, duvdx=None, duvdy=None, atlases=None):
    """Lobe sets for a wave of shading points (mat_ids: (R,) rows): rows of
    `table` (lobe_table of the scene, made here when not given), or, for a
    scene with textured parameters, the lobes of each hit's parameters:
    the textures evaluated at uv (R, 2) and p (R, 3) with the MIPMap
    footprint duvdx, duvdy (R, 2) (None: the finest level) and the route's
    mip atlases (texture.prepare_atlases). A scene with mix rows needs p
    (its hash) and one with hair rows uv (h across the fiber) on both
    routes."""
    if table is None:
        table = lobe_table(sa, static)
    kinds_present = set(static.mat_kinds_present)
    mix = MAT_MIX in kinds_present
    slots = table["slots"]
    if not table.get("textured"):
        if mix:
            is_mix, mat_ids, scale = _resolve_mix(sa, mat_ids, p, sa.mat_const[mat_ids, P_KD])
        kind, data = table["kind"][mat_ids], table["data"][mat_ids]
        if MAT_HAIR in kinds_present:
            j = slots.index(0)
            h = (-1.0 + 2.0 * uv[:, 1]).to(data.dtype)
            data[:, j, 13] = torch.where(kind[:, j] == LOBE_HAIR, h, data[:, j, 13])
        if mix:
            data[..., 0:3] = torch.where(is_mix[:, None, None], data[..., 0:3] * scale[:, None, :], data[..., 0:3])
        return {"kind": kind, "data": data, "possible": table["possible"], **_extras(table, sa, static)}
    tex_values = eval_textures(sa, static.tex_programs, uv, p, duvdx, duvdy, atlases=atlases,
                               only=table["programs"])
    if mix:
        is_mix, mat_ids, scale = _resolve_mix(sa, mat_ids, p, material_param(sa, tex_values, mat_ids, P_KD))
    kind, data = _lobes(sa.mat_kind[mat_ids], sa.mat_remap[mat_ids],
                        lambda slot: material_param(sa, tex_values, mat_ids, slot), static,
                        lambda slot: sa.mat_const[mat_ids, slot], uv)
    kind, data = kind[:, slots].contiguous(), data[:, slots].contiguous()
    if mix:
        data[..., 0:3] = torch.where(is_mix[:, None, None], data[..., 0:3] * scale[:, None, :], data[..., 0:3])
    return {"kind": kind, "data": data, "possible": table["possible"], **_extras(table, sa, static)}


def bake_lobes(sa, static):
    """Lobe kinds (M, 8) int32 and data (M, 8, 14) float32 of every material
    row, as the reference's make_bsdf writes them for constant parameters
    at uv = 0 (materials.py:150-351; a hair row's h is then -1, and a mix
    row writes none). Data columns: color 0:3, eta 3 (or rgb 3:6), k, Kt
    or a second color 6:9, alpha_x 9, alpha_y 10, Fresnel kind 11, then
    12:14 as device/bsdf.py lists them."""
    return _lobes(sa.mat_kind, sa.mat_remap, lambda slot: sa.mat_const[:, slot], static,
                  lambda slot: sa.mat_const[:, slot])


def _lobes(kind, remap_row, param, static, const, uv=None):
    """Lobe kinds (N, 8) and data (N, 8, 14) of N shading points or material
    rows: kind and remap_row (N,) per point, param(slot) -> (N, 3) the
    parameter values and const(slot) -> (N, 3) the rows' constants (disney's
    and hair's scalars, the Fourier table id), uv (N, 2) (None: zeros),
    with the reference's clamps and puts in its order (materials.py:150-351).
    A kind's lobes are built only when the scene holds it, so other scenes
    trace no more operations."""
    kinds_present = set(static.mat_kinds_present)
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

    def sel(slot, c, mask, value):
        v = torch.broadcast_to(torch.as_tensor(value, dtype=torch.float32, device=dev), (M,))
        data[:, slot, c] = torch.where(mask, v, data[:, slot, c])

    def put(slot, mask, lobe, color, eta=None, k_or_t=None, ax=None, ay=None, fresnel=FR_NONE, ab=None):
        """Masked write of one lobe into `slot` (materials._LobeWriter.put)."""
        out_kind[:, slot] = torch.where(mask, lobe, out_kind[:, slot])
        for c in range(3):
            sel(slot, c, mask, color[:, c] if color.dim() == 2 else color)
        if eta is not None:
            eta = torch.as_tensor(eta, dtype=torch.float32, device=dev)
            if eta.dim() <= 1:
                sel(slot, 3, mask, eta)
            else:
                for c in range(3):
                    sel(slot, 3 + c, mask, eta[:, c])
        if k_or_t is not None:
            for c in range(3):
                sel(slot, 6 + c, mask, k_or_t[:, c])
        if ax is not None:
            sel(slot, 9, mask, ax)
            sel(slot, 10, mask, ay)
        sel(slot, 11, mask, fresnel)
        if ab is not None:
            sel(slot, 12, mask, ab[0])
            sel(slot, 13, mask, ab[1])

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

    if MAT_SUBSTRATE in kinds_present:
        # substrate.rs: a Fresnel blend of Kd (diffuse) and Ks (glossy)
        m = kind == MAT_SUBSTRATE
        put(2, m & (nonblack(kd) | nonblack(ks)), LOBE_FRESNEL_BLEND, kd, k_or_t=ks, ax=ax, ay=ay)

    if MAT_TRANSLUCENT in kinds_present:
        # translucent.rs: Lambert and GGX lobes, reflected by `reflect` and
        # transmitted by `transmit`
        m = kind == MAT_TRANSLUCENT
        refl_c = torch.clamp(param(P_REFLECT), min=0.0)
        trans_c = torch.clamp(param(P_TRANSMIT), min=0.0)
        put(0, m & nonblack(refl_c * kd), LOBE_LAMBERT_R, refl_c * kd)
        put(1, m & nonblack(trans_c * kd), LOBE_LAMBERT_T, trans_c * kd)
        put(2, m & nonblack(refl_c * ks), LOBE_MICRO_R, refl_c * ks, eta=1.5, ax=ax, ay=ay, fresnel=FR_DIELECTRIC,
            ab=(beck_f, zero_r))
        put(3, m & nonblack(trans_c * ks), LOBE_MICRO_T, trans_c * ks, eta=1.5, ax=ax, ay=ay, ab=(beck_f, zero_r))

    if MAT_DISNEY in kinds_present:
        # disney.rs: Burley diffuse + sheen weighted by (1 - metallic)(1 -
        # spectrans), a GGX specular with Schlick F0, the clearcoat, the
        # specular transmission; the roughness rides slot 0's data[12] of
        # every disney row, lobe or not, as in the reference
        m = kind == MAT_DISNEY
        ex, ex2 = const(P_EXTRA), const(P_EXTRA2)
        metallic, clearcoat, gloss = ex[:, 0], ex[:, 1], ex[:, 2]
        sheen_amt, spectrans, spec_tint = ex2[:, 0], ex2[:, 1], ex2[:, 2]
        color = kd
        lum = torch.clamp(color[:, 0] * 0.2126 + color[:, 1] * 0.7152 + color[:, 2] * 0.0722, min=1e-6)
        tint = color / lum[:, None]
        dweight = (1.0 - metallic) * (1.0 - spectrans)
        diff_c = color * dweight[:, None]
        sheen_c = sheen_amt[:, None] * dweight[:, None] * tint
        put(0, m & (nonblack(diff_c) | nonblack(sheen_c)), LOBE_DISNEY_DIFF, diff_c, k_or_t=sheen_c)
        sel(0, 12, m, urough)
        f0 = ((1.0 - metallic)[:, None] * 0.08 * ((1.0 - spec_tint)[:, None] + spec_tint[:, None] * tint)
              + metallic[:, None] * color)
        put(2, m, LOBE_MICRO_R, one, eta=f0, ax=ax, ay=ay, fresnel=FR_SCHLICK)
        cc_alpha = 0.1 * (1.0 - gloss) + 0.001 * gloss
        put(6, m & (clearcoat > 0), LOBE_CLEARCOAT, 0.25 * clearcoat[:, None] * one, ax=cc_alpha, ay=cc_alpha)
        st_c = torch.sqrt(torch.clamp(color, 0.0, 1.0)) * spectrans[:, None]
        put(3, m & nonblack(st_c), LOBE_MICRO_T, st_c, eta=eta, ax=ax, ay=ay)

    if MAT_SUBSURFACE in kinds_present or MAT_KDSUBSURFACE in kinds_present:
        # the subsurface interface (materials.py:313-330): Fresnel
        # reflection (specular, or GGX where rough) and a diffuse
        # transmission of weight Kt (1 - F0), F0 = ((eta - 1) / (eta + 1))^2
        m = (kind == MAT_SUBSURFACE) | (kind == MAT_KDSUBSURFACE)
        smooth = (urough == 0) & (vrough == 0)
        f0 = ipow((eta - 1.0) / (eta + 1.0), 2)
        trans_w = torch.clamp(kt * (1.0 - f0)[:, None], 0.0, 1.0)
        put(4, m & smooth, LOBE_SPEC_R, kr, eta=eta, fresnel=FR_DIELECTRIC)
        put(2, m & ~smooth, LOBE_MICRO_R, kr, eta=eta, ax=ax, ay=ay, fresnel=FR_DIELECTRIC)
        put(1, m, LOBE_LAMBERT_T, trans_w)

    if MAT_FOURIER in kinds_present:
        # fourier.rs: the table id in data[12] (the tables ride the lobe set;
        # a row whose table was unreadable compiled as matte)
        m = kind == MAT_FOURIER
        put(5, m, LOBE_FOURIER, one, ab=(const(P_EXTRA)[:, 0], zero_r))

    if MAT_HAIR in kinds_present:
        # hair.rs: sigma_a in the Kd slot, or (P_EXTRA[1] = 1) a textured
        # reflectance color inverted here with beta_n; h = -1 + 2 v across
        # the tessellated fiber (hair.rs:188)
        m = kind == MAT_HAIR
        ex = const(P_EXTRA)
        kd_raw = torch.clamp(param(P_KD), min=0.0)
        bn = torch.clamp(vrough, 1e-3, 1.0)
        denom = (5.969 - 0.215 * bn + 2.532 * ipow(bn, 2) - 10.73 * ipow(bn, 3) + 5.574 * ipow(bn, 4)
                 + 0.245 * ipow(bn, 5))
        sig_conv = ipow(torch.log(torch.clamp(kd_raw, 1e-4, 1.0)) / denom[:, None], 2)
        sig = torch.where((ex[:, 1] > 0.5)[:, None], sig_conv, kd_raw)
        h = zero_r - 1.0 if uv is None else -1.0 + 2.0 * uv[:, 1]
        put(0, m, LOBE_HAIR, sig, eta=eta, ax=torch.clamp(urough, 0.0, 1.0), ay=bn, ab=(ex[:, 0], h))
    return out_kind, data


def lobes_at_origin(sa, static):
    """Lobe kinds (M, 8) and data (M, 8, 14) of every material row with its
    textures evaluated at uv = (0, 0), p = 0 and the finest MIP level: what
    the reference's megakernel extractors bake (make_bsdf over the rows at
    the origin); bake_lobes for a scene without textured parameters."""
    if not bool((sa.mat_tex >= 0).any()):
        return bake_lobes(sa, static)
    M = sa.mat_kind.shape[0]
    dev = sa.mat_kind.device
    rows = torch.arange(M, device=dev)
    uv = torch.zeros((M, 2), dtype=torch.float32, device=dev)
    p = torch.zeros((M, 3), dtype=torch.float32, device=dev)
    tex_values = eval_textures(sa, static.tex_programs, uv, p,
                               only=needed_programs(static.tex_programs, sa.mat_tex.flatten().tolist()))
    return _lobes(sa.mat_kind, sa.mat_remap, lambda slot: material_param(sa, tex_values, rows, slot), static,
                  lambda slot: sa.mat_const[:, slot], uv)
