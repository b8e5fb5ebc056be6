"""Scene compiler: SceneDescription (host records) -> SceneTensors.

The port's counterpart of ``pbrt_tpu/scene/builder.py compile_scene`` for
two scene classes:

- the wide class (more than BRUTE_FORCE_MAX_PRIMS prims): static triangle
  meshes with the BVH accelerator and the wide-BVH tables, and the mixed
  scenes among them, more than BRUTE_FORCE_MAX_PRIMS triangles beside at
  most MAX_WIDE_QUADRICS full or partial spheres, whose wide tables cover
  the triangle subset (``has_wide_tri``; ``has_wide`` stays False, as in
  the reference);
- the brute-force class (at most BRUTE_FORCE_MAX_PRIMS prims, no BVH
  tables): static triangle meshes and full or partial spheres.

Both take point, spot, distant and infinite lights (constant, or
image-mapped through ``mapname``) and area lights on triangles and
spheres; matte (Lambert or Oren-Nayar), mirror, glass, metal, plastic,
uber, substrate, translucent, disney, mix (its sub-materials registered
as rows of their own, the mix row reserved first), fourier (each SCATFUN
table read once per path and stacked, ``_stack_fourier_tables``; an
unreadable table makes the row matte) and hair, with
constant or textured parameters, and bump maps (the texture programs,
their parameter rows and MIP pyramids of ``_TextureRegistry``); the (0,2),
random, stratified, halton, sobol and
maxmindist samplers; a perspective camera and every pixel filter; the path
and directlighting integrators. The persistent wavefront
(device/integrator.py) renders all of it; the brute and wide megakernels
(device/megakernel.py, device/megakernel_wide.py) take the parts of it that
the reference's take.
Primitive order, areas, light and material rows, world bounds and the wide
tables are computed with the reference's NumPy code in the reference's
order, so they come out bit-identical (tests/test_torch_scene.py,
tests/test_torch_megakernel.py hold them equal table for table).

Anything outside those classes raises NotImplementedError naming the
feature; nothing is silently dropped. The reference's cluster tables,
joint-kernel probe and fused shading rows are not built: nothing in the
port reads them. The reference's known texture faults are kept, so the
tables stay bit-identical (ROADMAP C): the noise textures' parameters
are overwritten by their texture matrix, and checkerboard "aamode" is
dropped.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.fourierbsdf import read_fourier_table
from ..core.spectrum import copper_eta_k_rgb, y_of_rgb
from ..device.mipmap import build_pyramid
from .arrays import (
    GEOM_SPHERE,
    GEOM_TRI,
    LIGHT_AREA,
    LIGHT_DISTANT,
    LIGHT_INFINITE,
    LIGHT_POINT,
    LIGHT_SPOT,
    MAT_DISNEY,
    MAT_FOURIER,
    MAT_HAIR,
    MAT_IDS,
    MAT_MATTE,
    MAT_MIX,
    N_MAT_PARAMS,
    P_ETA,
    P_EXTRA,
    P_EXTRA2,
    P_K,
    P_KD,
    P_KR,
    P_KS,
    P_KT,
    P_OPACITY,
    P_REFLECT,
    P_SIGMA,
    P_TRANSMIT,
    P_UROUGH,
    P_VROUGH,
    QUADRIC_SPHERE,
    SceneStatic,
    SceneTensors,
    TexProgram,
    scene_tensors_from_numpy,
)
from .bvh import build_bvh
from .host import HostMaterial, HostTexture, SceneDescription
from .widebvh import build_wide_bvh

BRUTE_FORCE_MAX_PRIMS = 64
MAX_WIDE_QUADRICS = 8  # quadrics beside the triangle subset's wide tables (the reference's mixed_ok)

# flags bits for prim_flags
FLAG_FLIP_GEOM_N = 1
FLAG_HAS_SHADING_N = 2
FLAG_REVERSE_ORIENTATION = 4
FLAG_HAS_UV = 8

# what the compiler admits (the wavefront renders all of it)
MATERIALS = ("matte", "mirror", "glass", "metal", "plastic", "uber", "substrate", "translucent", "disney", "mix",
             "fourier", "hair")
SAMPLERS = ("zerotwosequence", "lowdiscrepancy", "random", "stratified", "halton", "sobol", "maxmindist")
INTEGRATORS = ("path", "directlighting")

# per-kind parameter defaults (reference src/materials/*.rs create_* fns)
_MATERIAL_DEFAULTS = {
    "matte": {"Kd": 0.5},
    "mirror": {"Kr": 0.9},
    "glass": {"Kr": 1.0, "Kt": 1.0},
    "plastic": {"Kd": 0.25, "Ks": 0.25, "roughness": 0.1},
    "metal": {"roughness": 0.01},
    "uber": {"Kd": 0.25, "Ks": 0.25, "roughness": 0.1},
    "substrate": {"Kd": 0.5, "Ks": 0.5, "uroughness": 0.1, "vroughness": 0.1},
    "translucent": {"Kd": 0.25, "Ks": 0.25, "roughness": 0.1, "reflect": 0.5, "transmit": 0.5},
}


class _TextureRegistry:
    """Flattens the host texture DAG into an ordered program list (the
    reference's builder._TextureRegistry, :72-160): children register
    before their parents, each texture once; every program gets a (24,)
    parameter row (mapping uscale, vscale, udelta, vdelta at 0:4, planar
    v1 4:7 and v2 7:10, constant children at 10:13, 13:16, 16:19, 19:22;
    imagemap scale at 10; noise roughness, scale, variation at 10:13,
    then overwritten by the texture matrix at 4:16, as the reference
    does); imagemaps add their MIP pyramid to `images`."""

    def __init__(self):
        self.programs: list[TexProgram] = []
        self.params: list[np.ndarray] = []
        self.images: dict = {}
        self._by_id: dict[int, int] = {}

    def register_source(self, src):
        """src: ('const', value) | ('texture', HostTexture) | None ->
        (const rgb (3,), texture index or -1)."""
        if src is None:
            return np.zeros(3), -1
        kind, val = src
        if kind == "const":
            v = np.atleast_1d(np.asarray(val, dtype=np.float64)).ravel()
            if v.size == 1:
                v = np.repeat(v, 3)
            return v[:3], -1
        return np.zeros(3), self.register(val)

    def register(self, tex: HostTexture) -> int:
        key = id(tex)
        if key in self._by_id:
            return self._by_id[key]
        prog = TexProgram(kind=tex.kind, is_float=tex.is_float, mapping=tex.mapping, wrap=tex.wrap,
                          dimension=tex.dimension, octaves=tex.octaves)
        par = np.zeros(24, dtype=np.float64)
        par[0:4] = tex.uscale, tex.vscale, tex.udelta, tex.vdelta
        if tex.v1 is not None:
            par[4:7] = tex.v1
        if tex.v2 is not None:
            par[7:10] = tex.v2
        if tex.kind == "constant":
            v = np.atleast_1d(np.asarray(tex.value, dtype=np.float64)).ravel()
            par[10:13] = (np.repeat(v, 3) if v.size == 1 else v)[:3]
        elif tex.kind in ("scale", "mix", "checkerboard", "dots", "bilerp"):
            par[10:13], prog.tex1 = self.register_source(tex.tex1)
            par[13:16], prog.tex2 = self.register_source(tex.tex2)
            if tex.kind == "mix":
                par[16:19], prog.amount = self.register_source(tex.amount)
            if tex.kind == "bilerp":
                par[16:19], prog.v01 = self.register_source(tex.v01)
                par[19:22], prog.v10 = self.register_source(tex.v10)
        elif tex.kind == "imagemap":
            key_name = f"img{sum(1 for k in self.images if k.endswith('_l0'))}"
            pyr = build_pyramid(np.asarray(tex.image, dtype=np.float32))
            for li, level in enumerate(pyr):
                self.images[f"{key_name}_l{li}"] = level
            prog.image_key = key_name
            prog.n_levels = len(pyr)
            prog.trilinear = tex.trilinear
            prog.max_aniso = float(getattr(tex, "max_aniso", 8.0))
            par[10] = tex.scale
        elif tex.kind in ("fbm", "wrinkled", "marble", "windy"):
            par[10:13] = tex.roughness, tex.scale, tex.variation
            if tex.world_to_texture is not None:
                # the reference's fault, kept: the matrix overwrites 10:16
                par[4:16] = tex.world_to_texture.m[:3, :].ravel()[:12]
        idx = len(self.programs)
        self.programs.append(prog)
        self.params.append(par)
        self._by_id[key] = idx
        return idx


@dataclass
class CompiledScene:
    arrays: SceneTensors
    static: SceneStatic
    description: SceneDescription

    def to(self, device) -> "CompiledScene":
        return CompiledScene(self.arrays.to(device), self.static, self.description)


def _unsupported(feature: str):
    raise NotImplementedError(f"pbrt_tpu_torch does not support {feature} yet")


def _count_prims(desc: SceneDescription) -> int:
    return sum(len(p.shape.mesh.indices) if p.shape.mesh is not None else 1 for p in desc.primitives)


def _check_slice(desc: SceneDescription) -> None:
    """Raise NotImplementedError for any feature outside the ported classes."""
    n_prims = _count_prims(desc)
    brute = n_prims <= BRUTE_FORCE_MAX_PRIMS
    n_quadrics = sum(p.shape.mesh is None for p in desc.primitives)
    if not brute and n_quadrics:
        # the reference walks these through its binary-BVH packet loop
        if n_prims - n_quadrics <= BRUTE_FORCE_MAX_PRIMS:
            _unsupported("scenes of > 64 primitives with 64 triangles or fewer beside quadrics")
        if n_quadrics > MAX_WIDE_QUADRICS:
            _unsupported(f"more than {MAX_WIDE_QUADRICS} quadrics in scenes of > 64 primitives")
    for light in desc.lights:
        if light.kind not in ("point", "spot", "distant", "infinite"):
            _unsupported(f"'{light.kind}' lights")
    if desc.media or desc.camera_medium:
        _unsupported("participating media")
    if str(desc.accelerator or "bvh") != "bvh":
        _unsupported(f"the '{desc.accelerator}' accelerator")
    cam = desc.camera
    if cam.kind != "perspective":
        _unsupported(f"'{cam.kind}' cameras")
    if cam.camera_to_world_end is not None:
        _unsupported("animated cameras")
    if desc.sampler.kind not in SAMPLERS:
        _unsupported(f"the '{desc.sampler.kind}' sampler")
    if desc.integrator.kind not in INTEGRATORS:
        _unsupported(f"the '{desc.integrator.kind}' integrator")
    for prim in desc.primitives:
        sh = prim.shape
        if sh.mesh is None:
            sph = sh.sphere
            if getattr(sph, "kind", "sphere") != "sphere":
                _unsupported(f"'{sph.kind}' quadrics")
            if sph.object_to_world_end is not None or sph.anim is not None:
                _unsupported("motion blur")
        else:
            mesh = sh.mesh
            if mesh.p_end is not None or mesh.anim is not None:
                _unsupported("motion blur")
            if mesh.alpha_texture is not None or mesh.shadow_alpha_texture is not None:
                _unsupported("alpha cutouts")
        if prim.instance_transform is not None:
            _unsupported("object instancing")
        if prim.inside_medium or prim.outside_medium:
            _unsupported("medium interfaces")
        if prim.area_light is not None:
            if prim.area_light.kind != "area":
                _unsupported(f"'{prim.area_light.kind}' lights attached to shapes")
        _check_material(prim.material)


def _check_material(mat: HostMaterial, seen=None) -> None:
    """Refuse a material outside MATERIALS by name, and a mix whose
    sub-materials hold one; the null material is the 'interface' one."""
    seen = set() if seen is None else seen
    if id(mat) in seen:
        return
    seen.add(id(mat))
    if mat.kind in ("", "none", "interface"):
        _unsupported("the 'interface' material")
    if mat.kind not in MATERIALS:
        _unsupported(f"the '{mat.kind}' material")
    if mat.kind == "mix":
        for name in ("material1", "material2"):
            src = mat.params.get(name)
            if src is not None:
                _check_material(src[1], seen)


def _hair_sigma_a_from_reflectance(c, beta_n):
    """hair.rs sigmaa_from_reflectance :291-306 (reference builder :1344)."""
    bn = float(beta_n)
    denom = 5.969 - 0.215 * bn + 2.532 * bn ** 2 - 10.73 * bn ** 3 + 5.574 * bn ** 4 + 0.245 * bn ** 5
    return (np.log(np.clip(np.asarray(c, np.float64), 1e-4, 1.0)) / denom) ** 2


def _hair_sigma_a_from_concentration(ce: float, cp: float):
    """hair.rs sigmaa_from_concentration :279-289 (eumelanin, pheomelanin)."""
    return ce * np.array([0.419, 0.697, 1.37]) + cp * np.array([0.187, 0.4, 1.05])


def _stack_fourier_tables(tables: list[dict]) -> dict:
    """Stack the per-path Fourier BSDF tables into one padded block (the
    reference builder's :1356-1396, its arithmetic and order): mu nodes
    past a table's range keep increasing (the interval search never picks
    them for an in-range cosine), coefficient rows pad with zeros, cdf
    columns pad with a steep ramp so the sampling inversion cannot land in
    the padding. Host arrays; {} without a table."""
    if not tables:
        return {}
    nmu_max = max(t["nmu"] for t in tables)
    mcap_max = max(t["m_cap"] for t in tables)
    nt = len(tables)
    mu_s = np.zeros((nt, nmu_max), np.float32)
    a_s = np.zeros((nt, nmu_max * nmu_max, 3 * mcap_max), np.float32)
    a0_s = np.zeros((nt, nmu_max, nmu_max), np.float32)
    cdf_s = np.zeros((nt, nmu_max, nmu_max), np.float32)
    eta_s = np.zeros((nt,), np.float32)
    for ti, t in enumerate(tables):
        n, mc = t["nmu"], t["m_cap"]
        mu_s[ti, :n] = t["mu"]
        if n < nmu_max:
            mu_s[ti, n:] = t["mu"][-1] + 1e-3 * np.arange(1, nmu_max - n + 1, dtype=np.float32)
        grid = np.zeros((nmu_max, nmu_max, 3, mcap_max), np.float32)
        grid[:n, :n, :, :mc] = t["a"].reshape(n, n, 3, mc)  # rows [o, i]
        a_s[ti] = grid.reshape(nmu_max * nmu_max, 3 * mcap_max)
        a0_s[ti, :n, :n] = t["a0"]
        cdf_s[ti, :n, :n] = t["cdf"]
        if n < nmu_max:
            step = max(1.0, float(t["cdf"].max()))
            ramp = t["cdf"][:, -1:] + step * np.arange(1, nmu_max - n + 1, dtype=np.float32)[None, :]
            cdf_s[ti, :n, n:] = ramp
            cdf_s[ti, n:, :] = cdf_s[ti, n - 1 : n, :]
        eta_s[ti] = t["eta"]
    return {"mu": mu_s, "aflat": a_s, "a0": a0_s, "cdf": cdf_s, "eta": eta_s}


def _compile_material(mat: HostMaterial, tex_reg: _TextureRegistry, register_material=None,
                      register_fourier=None):
    """HostMaterial of a ported kind -> (kind_id, const (N_MAT_PARAMS, 3),
    tex (N_MAT_PARAMS,), remap, bump texture or -1), filled as the
    reference's _compile_material (:1398-1593) fills such a row: a textured
    slot keeps a zero constant and names its program. register_material
    (HostMaterial -> row) registers mix's sub-materials; register_fourier
    (path -> table id, -1 when unreadable) loads a fourier row's table."""
    kind = MAT_IDS.get(mat.kind, MAT_MATTE)
    const = np.zeros((N_MAT_PARAMS, 3), dtype=np.float64)
    tex = np.full(N_MAT_PARAMS, -1, dtype=np.int64)
    remap = 1
    params = dict(mat.params)
    for name, dv in _MATERIAL_DEFAULTS.get(mat.kind, {}).items():
        params.setdefault(name, ("const", np.array([dv, dv, dv])))
    if mat.kind == "metal" and "eta" not in params:
        cu_eta, cu_k = copper_eta_k_rgb()
        params["eta"] = ("const", np.asarray(cu_eta))
        params.setdefault("k", ("const", np.asarray(cu_k)))

    def put(slot, name, default=None):
        src = params.get(name)
        if src is None:
            if default is not None:
                const[slot] = default
            return False
        if src[0] == "const":
            v = np.atleast_1d(np.asarray(src[1], dtype=np.float64)).ravel()
            const[slot] = np.repeat(v, 3)[:3] if v.size == 1 else v[:3]
        else:
            tex[slot] = tex_reg.register_source(src)[1]
        return True

    put(P_KD, "Kd")
    put(P_SIGMA, "sigma")
    put(P_KR, "Kr")
    put(P_KT, "Kt")
    put(P_KS, "Ks")
    put(P_OPACITY, "opacity", default=[1.0, 1.0, 1.0])
    put(P_REFLECT, "reflect")
    put(P_TRANSMIT, "transmit")
    put(P_ETA, "eta", default=1.5)
    put(P_K, "k")
    if not put(P_UROUGH, "uroughness"):
        put(P_UROUGH, "roughness")
    if not put(P_VROUGH, "vroughness"):
        put(P_VROUGH, "roughness")
    dist = params.get("distribution")
    beckmann = dist is not None and str(dist[1]).lower() == "beckmann"
    rm = params.get("remaproughness")
    if rm is not None and rm[0] == "const":
        remap = 1 if rm[1] else 0

    if kind == MAT_FOURIER:
        # the SCATFUN table, loaded once per path; an unreadable one makes
        # the row matte, as the reference's api.rs does
        src = params.get("bsdffile")
        tid = -1
        if register_fourier is not None and src is not None and src[0] == "const":
            tid = register_fourier(str(src[1]))
        if tid < 0:
            kind = MAT_MATTE
        else:
            const[P_EXTRA][0] = tid
    if kind == MAT_MIX:
        # the amount in the Kd slot, the sub-materials' rows in P_EXTRA
        put(P_KD, "amount", default=[0.5, 0.5, 0.5])
        m1, m2 = params.get("material1"), params.get("material2")
        if register_material is not None and m1 is not None and m2 is not None:
            const[P_EXTRA][0] = register_material(m1[1])
            const[P_EXTRA][1] = register_material(m2[1])
        else:
            kind = MAT_MATTE
    elif kind == MAT_DISNEY:
        # disney.rs: color in Kd; metallic, clearcoat, clearcoatgloss in
        # P_EXTRA; sheen, spectrans, speculartint in P_EXTRA2 (constants)
        put(P_KD, "color", default=[0.5, 0.5, 0.5])
        for slot, comp, name, dv in ((P_EXTRA, 0, "metallic", 0.0), (P_EXTRA, 1, "clearcoat", 0.0),
                                     (P_EXTRA, 2, "clearcoatgloss", 1.0), (P_EXTRA2, 0, "sheen", 0.0),
                                     (P_EXTRA2, 1, "spectrans", 0.0), (P_EXTRA2, 2, "speculartint", 0.0)):
            src = params.get(name)
            const[slot][comp] = (np.atleast_1d(np.asarray(src[1], dtype=np.float64)).ravel()[0]
                                 if src is not None and src[0] == "const" else dv)
    elif kind == MAT_HAIR:
        # hair.rs create_hair_material :604-651: sigma_a before color before
        # the melanin concentrations; a constant color is converted here, a
        # textured one on the device (P_EXTRA[1] = 1)
        remap = 0
        if "eta" not in params:
            const[P_ETA] = 1.55
        if not put(P_UROUGH, "beta_m"):
            const[P_UROUGH] = 0.3
        if not put(P_VROUGH, "beta_n"):
            const[P_VROUGH] = 0.3
        alpha_src = params.get("alpha")
        const[P_EXTRA][0] = (float(np.ravel(alpha_src[1])[0]) if alpha_src is not None and alpha_src[0] == "const"
                             else 2.0)
        mode = 0.0
        bn_for_conv = const[P_VROUGH][0] if tex[P_VROUGH] < 0 else 0.3
        if "sigma_a" in params:
            put(P_KD, "sigma_a")
        elif "color" in params:
            csrc = params["color"]
            if csrc[0] == "const":
                const[P_KD] = _hair_sigma_a_from_reflectance(np.asarray(csrc[1], np.float64), bn_for_conv)
            else:
                put(P_KD, "color")
                mode = 1.0
        elif "eumelanin" in params or "pheomelanin" in params:
            def conc(name):
                s_ = params.get(name)
                if s_ is None or s_[0] != "const":
                    return 0.0  # the reference warns and takes 0 for a textured one
                return max(float(np.ravel(s_[1])[0]), 0.0)

            const[P_KD] = _hair_sigma_a_from_concentration(conc("eumelanin"), conc("pheomelanin"))
        else:
            const[P_KD] = _hair_sigma_a_from_concentration(1.3, 0.0)
        const[P_EXTRA][1] = mode
    # a bump map is a float texture (material.rs:46-87); a constant source
    # has no gradient, so only a texture registers
    bump = mat.bump_map
    bump_tid = tex_reg.register(bump[1]) if bump is not None and bump[0] == "texture" else -1
    return kind, const, tex, remap | (2 if beckmann else 0), bump_tid


def _compile_light(hl):
    """Point / spot / distant / infinite HostLight -> (kind, params (12,)),
    as the reference's light loop writes them (scene/builder.py:361-410)."""
    p = np.zeros(12)
    if hl.kind == "infinite":
        p[3:6] = hl.intensity
        return LIGHT_INFINITE, p
    if hl.kind == "point":
        p[0:3] = hl.from_point
        p[3:6] = hl.intensity
        return LIGHT_POINT, p
    if hl.kind == "spot":
        p[0:3] = hl.from_point
        p[3:6] = hl.intensity
        d = np.asarray(hl.to_point) - np.asarray(hl.from_point)
        d = d / max(np.linalg.norm(d), 1e-12)
        p[6:9] = d
        p[9] = np.cos(np.radians(hl.cone_angle))  # cosTotalWidth
        p[10] = np.cos(np.radians(hl.cone_angle - hl.cone_delta))  # cosFalloffStart
        return LIGHT_SPOT, p
    d = np.asarray(hl.from_point) - np.asarray(hl.to_point)  # distant: direction TO the light
    d = d / max(np.linalg.norm(d), 1e-12)
    p[0:3] = d
    p[3:6] = hl.intensity
    return LIGHT_DISTANT, p


def _env_tables(hl):
    """The image-mapped infinite light's tables (reference builder
    :953-978): the map scaled by L, the luminance x sin(theta) 2D
    distribution as per-row conditional CDFs (H, W + 1) and the marginal
    CDF (H + 1,) (infinite.rs:81, sampling.rs Distribution2D), the
    world -> light rows (3, 4), and the map's mean, which replaces the
    light row's radiance (read only by the power heuristics)."""
    scale = np.asarray(hl.intensity, np.float64) if hl.intensity is not None else np.ones(3)
    img = np.asarray(hl.image, dtype=np.float64) * scale[None, None, :]
    h, w, _ = img.shape
    theta = (np.arange(h) + 0.5) / h * np.pi
    f = y_of_rgb(img) * np.sin(theta)[:, None]
    row_sum = f.sum(axis=1)
    cond = np.zeros((h, w + 1))
    cond[:, 1:] = np.cumsum(f, axis=1)
    cond_int = cond[:, -1:].copy()
    cond = np.where(cond_int > 0, cond / np.maximum(cond_int, 1e-30), np.linspace(0, 1, w + 1)[None, :])
    marg = np.zeros(h + 1)
    marg[1:] = np.cumsum(row_sum)
    marg = marg / max(marg[-1], 1e-30)
    tables = {
        "env_image": img.astype(np.float32),
        "env_cond_cdf": cond.astype(np.float32),
        "env_marg_cdf": marg.astype(np.float32),
        "env_w2l": hl.light_to_world.m_inv[:3, :].astype(np.float32),
    }
    return tables, img.mean(axis=(0, 1))


def _geom_to_prim_map(prim_kind, prim_geom, kind_id, n_geom):
    """geometry-table row -> primitive row (prims are in BVH leaf order)."""
    out = np.zeros(max(n_geom, 0), np.int32)
    for i, (k, g) in enumerate(zip(prim_kind, prim_geom)):
        if k == kind_id:
            out[g] = i
    return out


def compile_scene(desc: SceneDescription, device="cuda") -> CompiledScene:
    """Compile a scene of a ported class into tables on `device` (the card
    unless the caller names another device)."""
    _check_slice(desc)
    tri_p, tri_n, tri_uv = [], [], []
    sph_o2w, sph_w2o, sph_param, sph_kind = [], [], [], []
    prim_kind, prim_geom, prim_mat, prim_light, prim_flags, prim_area = [], [], [], [], [], []
    prim_lo, prim_hi = [], []
    mat_index: dict[int, int] = {}
    mat_rows: list[tuple] = []
    tex_reg = _TextureRegistry()
    fourier_tables: list[dict] = []
    fourier_ids: dict[str, int] = {}

    def register_fourier(path: str) -> int:
        """Read and densify a SCATFUN table once per path (fourier.rs:16-36)."""
        if path not in fourier_ids:
            tbl = read_fourier_table(path)
            fourier_ids[path] = -1 if tbl is None else len(fourier_tables)
            if tbl is not None:
                fourier_tables.append(tbl)
        return fourier_ids[path]

    def material_id(mat: HostMaterial) -> int:
        """The material's row; a new row is reserved before its
        sub-materials (mix) register, so rows come in the reference's order."""
        key = id(mat)
        if key not in mat_index:
            mat_index[key] = len(mat_rows)
            mat_rows.append(None)
            mat_rows[mat_index[key]] = _compile_material(mat, tex_reg, material_id, register_fourier)
        return mat_index[key]

    lights: list[tuple] = []  # (kind, params(12,), prim_id, nsamples)

    # non-area lights first, in description order; the last infinite light
    # is the scene's environment, as in the reference
    infinite_host = None
    for hl in desc.lights:
        kind, p = _compile_light(hl)
        lights.append((kind, p, -1, max(int(hl.n_samples), 1)))
        if kind == LIGHT_INFINITE:
            infinite_host = hl

    for prim in desc.primitives:
        mid = material_id(prim.material)
        if prim.shape.mesh is None:
            # full or partial sphere (sphere.rs); the checks admit no other quadric
            sph = prim.shape.sphere
            o2w = sph.object_to_world
            si = len(sph_o2w)
            sph_o2w.append(o2w.m[:3, :])
            sph_w2o.append(o2w.inverse().m[:3, :])
            sph_kind.append(QUADRIC_SPHERE)
            zmin = np.clip(min(sph.z_min, sph.z_max), -sph.radius, sph.radius)
            zmax = np.clip(max(sph.z_min, sph.z_max), -sph.radius, sph.radius)
            theta_min = np.arccos(np.clip(zmin / sph.radius, -1.0, 1.0))
            theta_max = np.arccos(np.clip(zmax / sph.radius, -1.0, 1.0))
            sph_param.append([sph.radius, zmin, zmax, sph.phi_max, theta_min, theta_max] + [0.0] * 6)
            flags = 0
            if sph.reverse_orientation ^ o2w.swaps_handedness():
                flags |= FLAG_FLIP_GEOM_N
            if sph.reverse_orientation:
                flags |= FLAG_REVERSE_ORIENTATION
            light_id = -1
            if prim.area_light is not None:
                light_id = len(lights)
                lp = np.zeros(12)
                lp[0:3] = prim.area_light.intensity
                lp[3] = 1.0 if prim.area_light.two_sided else 0.0
                lights.append((LIGHT_AREA, lp, len(prim_kind), max(int(prim.area_light.n_samples), 1)))
            prim_kind.append(GEOM_SPHERE)
            prim_geom.append(si)
            prim_mat.append(mid)
            prim_light.append(light_id)
            prim_flags.append(flags)
            prim_area.append(sph.phi_max * sph.radius * (np.clip(sph.z_max, -sph.radius, sph.radius)
                                                         - np.clip(sph.z_min, -sph.radius, sph.radius)))
            lo, hi = o2w.xbounds([-sph.radius] * 3, [sph.radius] * 3)
            prim_lo.append(lo)
            prim_hi.append(hi)
            continue
        mesh = prim.shape.mesh
        v = np.asarray(mesh.p, dtype=np.float64)
        f = np.asarray(mesh.indices, dtype=np.int64)
        pv = v[f]  # (t, 3, 3)
        e1 = pv[:, 1] - pv[:, 0]
        e2 = pv[:, 2] - pv[:, 0]
        gn = np.cross(e1, e2)
        areas = 0.5 * np.linalg.norm(gn, axis=-1)
        flags = 0
        if mesh.reverse_orientation ^ mesh.transform_swaps_handedness:
            flags |= FLAG_FLIP_GEOM_N
        if mesh.reverse_orientation:
            flags |= FLAG_REVERSE_ORIENTATION
        if mesh.n is not None:
            flags |= FLAG_HAS_SHADING_N
            nv = np.asarray(mesh.n, dtype=np.float64)[f]
        else:
            gnn = gn / np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-30)
            if flags & FLAG_FLIP_GEOM_N:
                gnn = -gnn
            nv = np.repeat(gnn[:, None, :], 3, axis=1)
        if mesh.uv is not None:
            flags |= FLAG_HAS_UV
            uvv = np.asarray(mesh.uv, dtype=np.float64)[f]
        else:
            uvv = np.broadcast_to(np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]]), (len(f), 3, 2)).copy()

        t = len(f)
        t0 = sum(len(c) for c in tri_p)
        tri_p.append(pv)
        tri_n.append(nv)
        tri_uv.append(uvv)
        base_prim = len(prim_kind)
        light_ids = np.full(t, -1, dtype=np.int64)
        if prim.area_light is not None:
            light_ids = np.arange(len(lights), len(lights) + t)
            lp = np.zeros(12)
            lp[0:3] = prim.area_light.intensity
            lp[3] = 1.0 if prim.area_light.two_sided else 0.0
            ns = max(int(prim.area_light.n_samples), 1)
            lights.extend((LIGHT_AREA, lp, base_prim + ti, ns) for ti in range(t))
        prim_kind.extend([GEOM_TRI] * t)
        prim_geom.extend(range(t0, t0 + t))
        prim_mat.extend([mid] * t)
        prim_light.extend(light_ids.tolist())
        prim_flags.extend([flags] * t)
        prim_area.extend(areas.tolist())
        # static meshes: the reference's Bezier-hull motion bound reduces to
        # the triangle's own AABB exactly
        prim_lo.extend(pv.min(axis=1))
        prim_hi.extend(pv.max(axis=1))

    n_prims = len(prim_kind)
    use_brute = n_prims <= BRUTE_FORCE_MAX_PRIMS
    if n_prims == 0:
        _unsupported("scenes without primitives")
    if not lights and not use_brute:
        _unsupported("scenes of > 64 primitives without lights")

    # --- world bounds ---------------------------------------------------------
    wlo = np.min(np.asarray(prim_lo), axis=0)
    whi = np.max(np.asarray(prim_hi), axis=0)
    wc = 0.5 * (wlo + whi)
    wr = float(np.linalg.norm(whi - wc)) + 1e-4

    # --- BVH: its leaf order fixes the primitive row order --------------------
    max_leaf = desc.accelerator_params.get("maxnodeprims", 4)
    split_method = {"sah": "sah", "middle": "middle", "equal": "equal",
                    "equalcounts": "equal", "hlbvh": "hlbvh"}.get(
        str(desc.accelerator_params.get("splitmethod", "sah")).lower(), "sah")
    bvh = build_bvh(np.asarray(prim_lo), np.asarray(prim_hi), max_leaf, split_method)
    perm = np.asarray(bvh.prim_ids, dtype=np.int64)
    inv = np.empty(n_prims, dtype=np.int64)
    inv[perm] = np.arange(n_prims)

    def _perm(lst):
        return [lst[i] for i in perm]

    prim_kind = _perm(prim_kind)
    prim_geom = _perm(prim_geom)
    prim_mat = _perm(prim_mat)
    prim_light = _perm(prim_light)
    prim_flags = _perm(prim_flags)
    prim_area = _perm(prim_area)
    prim_lo = _perm(prim_lo)
    prim_hi = _perm(prim_hi)
    lights = [(k, p_, int(inv[pr]) if pr >= 0 else -1, ns) for (k, p_, pr, ns) in lights]

    def _cat(chunks, shape):
        if not chunks:
            return np.zeros((0,) + shape, dtype=np.float32)
        return np.concatenate([np.asarray(c, dtype=np.float32).reshape((-1,) + shape) for c in chunks], axis=0)

    tri_p_cat = _cat(tri_p, (3, 3))
    mat_kind = np.array([r[0] for r in mat_rows], dtype=np.int32)
    arrays = {
        "tri_p": tri_p_cat,
        "tri_n": _cat(tri_n, (3, 3)),
        "tri_uv": _cat(tri_uv, (3, 2)),
        "tri_prim_ids": _geom_to_prim_map(prim_kind, prim_geom, GEOM_TRI, len(tri_p_cat)),
        "sph_o2w": np.asarray(sph_o2w, dtype=np.float32).reshape(-1, 3, 4),
        "sph_w2o": np.asarray(sph_w2o, dtype=np.float32).reshape(-1, 3, 4),
        "sph_param": np.asarray(sph_param, dtype=np.float32).reshape(-1, 12),
        "sph_kind": np.asarray(sph_kind, dtype=np.int32),
        "sph_prim_ids": _geom_to_prim_map(prim_kind, prim_geom, GEOM_SPHERE, len(sph_o2w)),
        "prim_kind": np.asarray(prim_kind, dtype=np.int32),
        "prim_geom": np.asarray(prim_geom, dtype=np.int32),
        "prim_mat": np.asarray(prim_mat, dtype=np.int32),
        "prim_light": np.asarray(prim_light, dtype=np.int32),
        "prim_flags": np.asarray(prim_flags, dtype=np.int32),
        "prim_area": np.asarray(prim_area, dtype=np.float32),
        "mat_kind": mat_kind,
        "mat_const": np.stack([r[1] for r in mat_rows]).astype(np.float32),
        "mat_tex": np.stack([r[2] for r in mat_rows]).astype(np.int32),
        "mat_remap": np.array([r[3] for r in mat_rows], dtype=np.int32),
        "mat_bump": np.array([r[4] for r in mat_rows], dtype=np.int32),
        "tex_param": (np.stack(tex_reg.params).astype(np.float32) if tex_reg.params
                      else np.zeros((1, 24), dtype=np.float32)),
        "tex_images": tex_reg.images,
        "light_kind": np.array([l[0] for l in lights], dtype=np.int32),
        "light_param": np.asarray([l[1] for l in lights], dtype=np.float32).reshape(-1, 12),
        "light_prim": np.array([l[2] for l in lights], dtype=np.int32),
        "fourier": _stack_fourier_tables(fourier_tables),
        "world_center": wc.astype(np.float32),
        "world_radius": np.float32(wr),
    }
    inf_idx = max((i for i, l in enumerate(lights) if l[0] == LIGHT_INFINITE), default=-1)
    if infinite_host is not None and infinite_host.image is not None:
        env, mean = _env_tables(infinite_host)
        arrays.update(env)
        arrays["light_param"][inf_idx, 3:6] = mean
    wide_root = 1
    if not use_brute:
        # --- wide BVH over the (permuted) triangle rows -----------------------
        # a mixed scene's tables cover its triangle prims only (the
        # reference's mixed_ok branch); the quadrics are tested beside them
        rows = np.nonzero(np.asarray(prim_kind) == GEOM_TRI)[0]
        # payload cols 11-13 (mat, light, flags) as the reference writes them
        extra = np.stack([
            np.asarray(prim_mat, np.float32)[rows],
            np.asarray(prim_light, np.float32)[rows],
            np.asarray(prim_flags, np.float32)[rows],
        ], axis=1)
        pg = np.asarray(prim_geom)[rows]
        tv = tri_p_cat[pg]
        # the attribute table (reference builder :1118-1139), built when some
        # prim has shading normals or a non-default UV chart: lanes 0:9 the
        # per-vertex normals n0/n1/n2, 9:15 uv0/uv1/uv2, in the prim table's
        # (octet, slot) layout
        attr = None
        tn, tuv = arrays["tri_n"][pg], arrays["tri_uv"][pg]
        need_ns = bool((np.asarray(prim_flags, np.int64)[rows] & FLAG_HAS_SHADING_N).any())
        need_uv = bool(tuv.shape[0]) and not np.array_equal(
            tuv, np.broadcast_to(np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]], tuv.dtype), tuv.shape))
        if need_ns or need_uv:
            attr = np.concatenate([tn.reshape(len(rows), 9), tuv.reshape(len(rows), 6)], axis=1).astype(np.float32)
        wide = build_wide_bvh(np.asarray(prim_lo)[rows], np.asarray(prim_hi)[rows], tv[:, 0], tv[:, 1], tv[:, 2],
                              extra_cols=extra, attr_cols=attr)
        arrays.update(wnode_tab=wide.node_tab, wprim_tab=wide.prim_tab, wmeta_tab=wide.meta_tab,
                      wslot_prim=wide.slot_prim, wattr_tab=wide.attr_tab)
        wide_root = wide.root
    static = {
        "n_tris": len(tri_p_cat),
        "n_prims": n_prims,
        "n_materials": len(mat_rows),
        "n_lights": len(lights),
        "mat_kinds_present": tuple(sorted(set(int(k) for k in mat_kind))),
        "light_kinds": tuple(int(l[0]) for l in lights),
        "light_n_samples": tuple(l[3] for l in lights),
        "has_area_lights": any(l[0] == LIGHT_AREA for l in lights),
        "has_infinite": inf_idx >= 0,
        "infinite_light_index": inf_idx,
        "has_env_map": "env_image" in arrays,
        "use_brute_force": use_brute,
        "n_spheres": len(sph_o2w),
        # full, outward-facing spheres, which NEE samples by their visible
        # cone (reference builder :1306-1313)
        "has_cone_sphere_lights": any(
            l[0] == LIGHT_AREA and prim_kind[l[2]] == GEOM_SPHERE
            and sph_param[prim_geom[l[2]]][1] <= -sph_param[prim_geom[l[2]]][0] * (1 - 1e-6)
            and sph_param[prim_geom[l[2]]][2] >= sph_param[prim_geom[l[2]]][0] * (1 - 1e-6)
            and sph_param[prim_geom[l[2]]][3] >= 2.0 * np.pi - 1e-6
            and (prim_flags[l[2]] & FLAG_REVERSE_ORIENTATION) == 0
            for l in lights),
        "n_media": 0,
        "has_motion": False,
        "tex_programs": tuple(tex_reg.programs),
        "has_bump": any(r[4] >= 0 for r in mat_rows),
        "has_fourier": bool(fourier_tables),
        "has_wide": not use_brute and not sph_o2w,
        "has_wide_tri": not use_brute,
        "wide_root": wide_root,
    }
    tensors, st = scene_tensors_from_numpy(arrays, static, device)
    return CompiledScene(arrays=tensors, static=st, description=desc)
