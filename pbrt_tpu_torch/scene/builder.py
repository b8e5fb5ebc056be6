"""Scene compiler: SceneDescription (host records) -> SceneTensors.

The port's counterpart of ``pbrt_tpu/scene/builder.py compile_scene`` for
the persistent wavefront's class (the reference's ``persistent_eligible``)
and the per-sample wave's: triangle meshes (with alpha and shadow-alpha
cutouts; moving over the shutter or not: ``_Motion``'s keyframe tables,
animated-transform groups and swept bounds, with the reference's float64
arithmetic; a scene with motion gets no wide tables) and the six
quadric kinds (sphere, cylinder, disk, cone, paraboloid, hyperboloid; full
or partial), object instancing of meshes (instanced prims keep their
prototype's rows and carry an instance transform), the BVH or kd-tree
accelerator, and for every scene the binary BVH's packed tables
(``bvh_packed``, ``prim_test_data``). Scenes of more than
BRUTE_FORCE_MAX_PRIMS prims without instances also get the wide-BVH tables
when they hold only triangles, or more than BRUTE_FORCE_MAX_PRIMS triangles
beside at most MAX_WIDE_QUADRICS quadrics (the mixed scenes, whose wide
tables cover the triangle subset: ``has_wide_tri`` without ``has_wide``),
as in the reference.

Lights: point, spot, distant, goniometric and projection (their frames in
``light_w2l``, their images in ``light_images``), infinite (constant, or
image-mapped through ``mapname``) and area lights on triangles and
quadrics (an area light on an instanced prototype is dropped with the
reference's warning). Materials: matte (Lambert or Oren-Nayar), mirror,
glass, metal, plastic, uber, substrate, translucent, disney, mix (its
sub-materials registered as rows of their own, the mix row reserved
first), fourier (each SCATFUN table read once per path and stacked,
``_stack_fourier_tables``; an unreadable table makes the row matte) and
hair, with constant or textured parameters, and bump maps (the texture
programs, their parameter rows and MIP pyramids of ``_TextureRegistry``);
the (0,2), random, stratified, halton, sobol and maxmindist samplers;
perspective (animated or not), orthographic, environment and realistic
cameras and every pixel filter; the path, volpath, directlighting, whitted,
ao and bdpt integrators. Participating
media: homogeneous and grid (heterogeneous) media in the medium table
(``med_param``, ``med_w2m``, ``med_grids``), each prim's inside and outside
medium (``prim_medium``, from MediumInterface), the camera's medium and the
interface (null, "none") material. Subsurface and kdsubsurface materials get
the tabulated BSSRDF's rows (``sss_*``: the beam-diffusion table of
core/bssrdf.py with the albedo axis folded per material row), or, under the
reference's PBRT_TPU_NO_TABSSS=1, an implicit homogeneous interior medium
per material that the volumetric random walk crosses (``sss_media``). The
persistent wavefront (device/integrator.py trace_persistent) renders the
path and directlighting scenes of the reference's ``persistent_eligible``
class and the per-sample wave (trace_wave) every other; the brute and wide
megakernels (device/megakernel.py, device/megakernel_wide.py) take the parts
of the first class that the reference's take.
Primitive order, areas, light and material rows, world bounds and the BVH,
kd-tree and wide tables are computed with the reference's NumPy code in the
reference's order, so they come out bit-identical (tests/test_torch_scene.py,
tests/test_torch_quadrics.py, tests/test_torch_megakernel.py hold them equal
table for table).

Anything outside this class raises NotImplementedError naming the
feature; nothing is silently dropped but what the reference drops. The
reference's cluster tables, joint-kernel probe and fused shading rows are
not built: nothing in the port reads them. The reference's known texture
faults are kept, so the tables stay bit-identical (ROADMAP C): the noise
textures' parameters are overwritten by their texture matrix, and
checkerboard "aamode" is dropped.
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass

import numpy as np

from ..core.bssrdf import catmull_rom_weights, compute_beam_diffusion_table, subsurface_from_diffuse
from ..core.fourierbsdf import read_fourier_table
from ..core.spectrum import copper_eta_k_rgb, y_of_rgb
from ..core.transform import AnimatedTransform, Transform
from ..device.mipmap import build_pyramid
from .arrays import (
    GEOM_SPHERE,
    GEOM_TRI,
    LIGHT_AREA,
    LIGHT_DISTANT,
    LIGHT_GONIO,
    LIGHT_INFINITE,
    LIGHT_POINT,
    LIGHT_PROJECTION,
    LIGHT_SPOT,
    MAT_DISNEY,
    MAT_FOURIER,
    MAT_HAIR,
    MAT_IDS,
    MAT_MATTE,
    MAT_KDSUBSURFACE,
    MAT_MIX,
    MAT_SUBSURFACE,
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
    QUADRIC_CONE,
    QUADRIC_CYLINDER,
    QUADRIC_DISK,
    QUADRIC_HYPERBOLOID,
    QUADRIC_PARABOLOID,
    QUADRIC_SPHERE,
    SceneStatic,
    SceneTensors,
    TexProgram,
    scene_tensors_from_numpy,
)
from .bvh import build_bvh
from .host import HostMaterial, HostMedium, HostTexture, SceneDescription
from .kdtree import build_kdtree
from .widebvh import build_wide_bvh

log = logging.getLogger(__name__)

BRUTE_FORCE_MAX_PRIMS = 64
MAX_WIDE_QUADRICS = 8  # quadrics beside the triangle subset's wide tables (the reference's mixed_ok)

# flags bits for prim_flags
FLAG_FLIP_GEOM_N = 1
FLAG_HAS_SHADING_N = 2
FLAG_REVERSE_ORIENTATION = 4
FLAG_HAS_UV = 8

# what the compiler admits (the wavefront renders all of it)
MATERIALS = ("matte", "mirror", "glass", "metal", "plastic", "uber", "substrate", "translucent", "disney", "mix",
             "fourier", "hair", "subsurface", "kdsubsurface", "none")
SAMPLERS = ("zerotwosequence", "lowdiscrepancy", "random", "stratified", "halton", "sobol", "maxmindist")
INTEGRATORS = ("path", "volpath", "directlighting", "whitted", "ao", "bdpt", "mlt", "sppm")
CAMERAS = ("perspective", "orthographic", "environment", "realistic")
LIGHTS = ("point", "spot", "distant", "infinite", "goniometric", "projection")
QUADRICS = {"sphere": QUADRIC_SPHERE, "cylinder": QUADRIC_CYLINDER, "disk": QUADRIC_DISK, "cone": QUADRIC_CONE,
            "paraboloid": QUADRIC_PARABOLOID, "hyperboloid": QUADRIC_HYPERBOLOID}

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
    # prim row -> the prim's index in description order (the BVH's leaf
    # order), a host array; None for tables filled from another compiler
    prim_order: np.ndarray | None = None

    def to(self, device) -> "CompiledScene":
        return CompiledScene(self.arrays.to(device), self.static, self.description, self.prim_order)


def _unsupported(feature: str):
    raise NotImplementedError(f"pbrt_tpu_torch does not support {feature} yet")


def _count_prims(desc: SceneDescription) -> int:
    return sum(len(p.shape.mesh.indices) if p.shape.mesh is not None else 1 for p in desc.primitives)


def _check_slice(desc: SceneDescription) -> None:
    """Raise NotImplementedError for any feature outside the ported class."""
    for light in desc.lights:
        if light.kind not in LIGHTS:
            _unsupported(f"'{light.kind}' lights")
    if str(desc.accelerator or "bvh") not in ("bvh", "kdtree"):
        _unsupported(f"the '{desc.accelerator}' accelerator")
    cam = desc.camera
    if cam.kind not in CAMERAS:
        _unsupported(f"'{cam.kind}' cameras")
    if desc.sampler.kind not in SAMPLERS:
        _unsupported(f"the '{desc.sampler.kind}' sampler")
    if desc.integrator.kind not in INTEGRATORS:
        _unsupported(f"the '{desc.integrator.kind}' integrator")
    for prim in desc.primitives:
        sh = prim.shape
        if sh.mesh is None:
            sph = sh.sphere
            if getattr(sph, "kind", "sphere") not in QUADRICS:
                _unsupported(f"'{sph.kind}' quadrics")
        if prim.area_light is not None:
            if prim.area_light.kind != "area":
                _unsupported(f"'{prim.area_light.kind}' lights attached to shapes")
        _check_material(prim.material)


def _check_material(mat: HostMaterial, seen=None) -> None:
    """Refuse a material outside MATERIALS by name, and a mix whose
    sub-materials hold one (the interface material is kind "none", the
    parser's name for Material "" and "none")."""
    seen = set() if seen is None else seen
    if id(mat) in seen:
        return
    seen.add(id(mat))
    if mat.kind not in MATERIALS:
        _unsupported(f"the '{mat.kind}' material")
    if mat.kind == "mix":
        for name in ("material1", "material2"):
            src = mat.params.get(name)
            if src is not None:
                _check_material(src[1], seen)


class _MediaTable:
    """The medium rows (the reference builder's media table, :264-311):
    the named media in description order, each an (8,) row sigma_a,
    sigma_s, g and the majorant's density (a grid's max density; 1 for a
    homogeneous medium) with its world -> medium frame; a grid medium's
    frame maps its [p0, p1] box onto [0, 1]^3 and its densities go to
    grids["med{i}"]. add() appends the subsurface walk's implicit media."""

    def __init__(self, media: dict):
        self.ids: dict[str, int] = {}
        self.param_rows: list = []
        self.w2m_rows: list = []
        self.grids: dict = {}
        self.kinds: list[str] = []
        for name, hm in media.items():
            row = self.add(hm, name)
            if hm.kind == "heterogeneous" and hm.density is not None:
                self.param_rows[row][7] = float(hm.density.max())
                self.grids[f"med{row}"] = hm.density.astype(np.float32)
                span = np.maximum(hm.p1 - hm.p0, 1e-12)
                norm = np.eye(4)
                norm[:3, :3] = np.diag(1.0 / span)
                norm[:3, 3] = -hm.p0 / span
                self.w2m_rows[row] = (norm @ hm.medium_to_world.inverse().m)[:3, :]

    def add(self, hm, name: str) -> int:
        mid = len(self.param_rows)
        self.ids[name] = mid
        self.kinds.append(hm.kind)
        row = np.zeros(8)
        row[0:3] = hm.sigma_a
        row[3:6] = hm.sigma_s
        row[6] = hm.g
        row[7] = 1.0
        self.param_rows.append(row)
        self.w2m_rows.append(hm.medium_to_world.inverse().m[:3, :])
        return mid

    def medium_id(self, name: str) -> int:
        if not name:
            return -1
        mid = self.ids.get(name)
        if mid is None:
            log.error("medium '%s' not defined", name)
            return -1
        return mid


class _SubsurfaceRows:
    """The subsurface and kdsubsurface materials (the reference builder
    :415-505, :1032-1065): by default each material row gets the tabulated
    BSSRDF's rows; under PBRT_TPU_NO_TABSSS=1 each gets an implicit
    homogeneous interior medium of its coefficients instead, which the
    wave's volumetric random walk crosses."""

    def __init__(self, med: _MediaTable):
        self.med = med
        self.walk = os.environ.get("PBRT_TPU_NO_TABSSS", "") == "1"
        self.walk_media: dict[int, str] = {}  # material row -> its medium's name
        self.tab_mats: dict[int, HostMaterial] = {}  # material row -> material
        self._tables: dict[tuple, dict] = {}

    def table(self, g, eta) -> dict:
        """The beam-diffusion table of (g, eta), computed once (cached by
        both rounded to 4 places, as the reference's _sss_table_for)."""
        key = (round(float(g), 4), round(float(eta), 4))
        if key not in self._tables:
            self._tables[key] = compute_beam_diffusion_table(g, eta)
        return self._tables[key]

    def coefficients(self, mat: HostMaterial):
        """(sigma_a, sigma_s, g, eta) of a subsurface-family material
        (subsurface.rs / kdsubsurface.rs create): kdsubsurface's Kd and mfp,
        or subsurface's reflectance and mfp, inverted through the table
        (bssrdf.rs subsurface_from_diffuse); else sigma_a, sigma_s times
        scale."""

        def cscalar(name, default):
            v = mat.params.get(name)
            if v is not None and v[0] == "const":
                return float(np.atleast_1d(v[1]).ravel()[0])
            return default

        def cvec(name, default):
            v = mat.params.get(name)
            if v is not None and v[0] == "const":
                a = np.atleast_1d(np.asarray(v[1], float)).ravel()
                return np.repeat(a, 3)[:3] if a.size == 1 else a[:3]
            return None if default is None else np.asarray(default, float)

        scale = cscalar("scale", 1.0)
        g = cscalar("g", 0.0)
        eta = cscalar("eta", cscalar("index", 1.33))
        if mat.kind == "kdsubsurface":
            kdv = np.clip(cvec("Kd", [0.5, 0.5, 0.5]), 1e-4, 0.999)
            mfp = np.maximum(cvec("mfp", [1.0, 1.0, 1.0]), 1e-6)
            sig_a, sig_s = subsurface_from_diffuse(self.table(g, eta), kdv, mfp)
        else:
            refl = cvec("reflectance", None)
            if refl is not None:
                mfp = np.maximum(cvec("mfp", [1.0, 1.0, 1.0]), 1e-6)
                sig_a, sig_s = subsurface_from_diffuse(self.table(g, eta), np.clip(refl, 1e-4, 0.999), mfp)
            else:
                sig_a = cvec("sigma_a", [0.0011, 0.0024, 0.014]) * scale
                sig_s = cvec("sigma_s", [2.55, 3.21, 3.77]) * scale
        return np.maximum(sig_a, 0.0), np.maximum(sig_s, 0.0), g, eta

    def register(self, mat: HostMaterial, mid: int) -> None:
        if mat.kind not in ("subsurface", "kdsubsurface"):
            return
        if not self.walk:
            self.tab_mats.setdefault(mid, mat)
        elif mid not in self.walk_media:
            sig_a, sig_s, g, _eta = self.coefficients(mat)
            name = f"__sss_walk_{mid}"
            self.med.add(HostMedium(kind="homogeneous", sigma_a=np.asarray(sig_a, float),
                                    sigma_s=np.asarray(sig_s, float), g=float(g)), name)
            self.walk_media[mid] = name

    def inside_medium(self, prim, mid: int) -> int:
        """The prim's inside medium, else its material's walk medium."""
        if prim.inside_medium:
            return self.med.medium_id(prim.inside_medium)
        name = self.walk_media.get(mid)
        return self.med.ids[name] if name else -1

    def tables(self, n_materials: int) -> dict:
        """The sss_* rows: each tabulated material's spline rows with the
        albedo axis folded by its Catmull-Rom weights; {} without one."""
        if not self.tab_mats:
            return {}
        M = n_materials
        s_prof = np.zeros((M, 3, 64), np.float32)
        s_cdf = np.zeros((M, 3, 64), np.float32)
        s_rhoeff = np.zeros((M, 3), np.float32)
        s_sigt = np.zeros((M, 3), np.float32)
        s_eta = np.full((M,), 1.33, np.float32)
        radius = None
        for mid, mat in self.tab_mats.items():
            sig_a, sig_s, g, eta = self.coefficients(mat)
            tab = self.table(g, eta)
            radius = tab["radius_samples"]
            sigma_t = sig_a + sig_s
            rho = np.where(sigma_t > 0, sig_s / np.maximum(sigma_t, 1e-12), 0.0)
            s_sigt[mid] = sigma_t
            s_eta[mid] = eta
            for ch in range(3):
                off, w = catmull_rom_weights(tab["rho_samples"].astype(np.float64), rho[ch])
                for k in range(4):
                    idx = int(np.clip(off + k, 0, len(tab["rho_samples"]) - 1))
                    s_prof[mid, ch] += np.float32(w[k]) * tab["profile"][idx]
                    s_cdf[mid, ch] += np.float32(w[k]) * tab["profile_cdf"][idx]
                    s_rhoeff[mid, ch] += np.float32(w[k]) * tab["rho_eff"][idx]
        return {"sss_prof": s_prof, "sss_cdf": s_cdf, "sss_rhoeff": np.maximum(s_rhoeff, 1e-6),
                "sss_sigma_t": s_sigt, "sss_eta": s_eta, "sss_radius": radius}


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
    elif kind in (MAT_SUBSURFACE, MAT_KDSUBSURFACE):
        # the interface's surface lobes (Fresnel reflection and diffuse
        # transmission); the BSSRDF's rows are the compiler's sss_* tables
        if not np.any(const[P_KR]):
            const[P_KR] = 1.0
        if not np.any(const[P_KT]):
            const[P_KT] = 1.0
    # a bump map is a float texture (material.rs:46-87); a constant source
    # has no gradient, so only a texture registers
    bump = mat.bump_map
    bump_tid = tex_reg.register(bump[1]) if bump is not None and bump[0] == "texture" else -1
    return kind, const, tex, remap | (2 if beckmann else 0), bump_tid


def _compile_light(hl):
    """Point / spot / distant / goniometric / projection / infinite
    HostLight -> (kind, params (12,)), as the reference's light loop writes
    them (scene/builder.py:361-410)."""
    p = np.zeros(12)
    if hl.kind == "infinite":
        p[3:6] = hl.intensity
        return LIGHT_INFINITE, p
    if hl.kind == "point":
        p[0:3] = hl.from_point
        p[3:6] = hl.intensity
        return LIGHT_POINT, p
    if hl.kind in ("goniometric", "projection"):
        p[0:3] = hl.light_to_world.xpoint(np.zeros(3))
        p[3:6] = hl.intensity
        if hl.kind == "goniometric":
            return LIGHT_GONIO, p
        # projection.rs: the screen from the fov; tan(fov / 2) and the
        # image's aspect
        p[9] = np.tan(np.radians(hl.cone_angle) / 2.0)
        p[10] = hl.image.shape[1] / hl.image.shape[0] if hl.image is not None and hl.image.shape[0] > 0 else 1.0
        return LIGHT_PROJECTION, p
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


def _quadric_area(sph, qkind):
    """Analytic surface areas (sphere.rs / cylinder.rs / disk.rs / cone.rs /
    paraboloid.rs area()); the hyperboloid's by midpoint quadrature of
    |dp/du x dp/dv|, the reference's deliberate replacement of pbrt-v3's
    broken closed form (reference builder._quadric_area :178-230)."""
    if qkind == QUADRIC_DISK:
        return sph.phi_max * 0.5 * (sph.radius ** 2 - sph.inner_radius ** 2)
    if qkind == QUADRIC_CYLINDER:
        return sph.phi_max * sph.radius * abs(sph.z_max - sph.z_min)
    if qkind == QUADRIC_CONE:
        return sph.radius * np.sqrt(sph.height ** 2 + sph.radius ** 2) * sph.phi_max / 2.0
    if qkind == QUADRIC_HYPERBOLOID:
        p1 = np.asarray(sph.p1, np.float64)
        p2 = np.asarray(sph.p2, np.float64)
        nv, nu = 256, 64
        v = (np.arange(nv) + 0.5) / nv
        phi = (np.arange(nu) + 0.5) / nu * sph.phi_max
        seg = p1[None, :] + v[:, None] * (p2 - p1)[None, :]
        cph, sph_ = np.cos(phi), np.sin(phi)
        x = seg[:, None, 0] * cph[None, :] - seg[:, None, 1] * sph_[None, :]
        y = seg[:, None, 0] * sph_[None, :] + seg[:, None, 1] * cph[None, :]
        dpdu = np.stack([-y, x, np.zeros_like(x)], axis=-1) * sph.phi_max
        dseg = p2 - p1
        dvx = dseg[0] * cph - dseg[1] * sph_
        dvy = dseg[0] * sph_ + dseg[1] * cph
        dpdv = np.stack([np.broadcast_to(dvx, x.shape), np.broadcast_to(dvy, x.shape),
                         np.full_like(x, dseg[2])], axis=-1)
        return float(np.linalg.norm(np.cross(dpdu, dpdv), axis=-1).mean())
    if qkind == QUADRIC_PARABOLOID:
        r2 = sph.radius ** 2
        zmax = max(sph.z_min, sph.z_max)
        zmin = min(sph.z_min, sph.z_max)
        if zmax <= 0:
            return 0.0
        k = 4.0 * zmax / r2
        return (r2 * r2 * sph.phi_max / (12.0 * zmax * zmax)) * ((k * zmax + 1.0) ** 1.5 - (k * zmin + 1.0) ** 1.5)
    return sph.phi_max * sph.radius * (np.clip(sph.z_max, -sph.radius, sph.radius)
                                       - np.clip(sph.z_min, -sph.radius, sph.radius))


def _hyperboloid_coefficients(sph):
    """The implicit ah (x^2 + y^2) - ch z^2 = 1 of a hyperboloid's segment
    (hyperboloid.rs:44-62; reference builder :700-728): pp walks away from
    p1 until the system is conditioned; degenerate inputs (on which the
    reference's loop spins) warn and give a never-hit shape."""
    p1 = np.asarray(sph.p1, np.float64).copy()
    p2 = np.asarray(sph.p2, np.float64).copy()
    if p2[2] == 0.0:
        p1, p2 = p2.copy(), p1.copy()
    pp = p1.copy()
    ah = np.inf
    for _ in range(64):
        pp += 2.0 * (p2 - p1)
        xy1 = pp[0] * pp[0] + pp[1] * pp[1]
        xy2 = p2[0] * p2[0] + p2[1] * p2[1]
        den = 1.0 - (xy2 * pp[2] * pp[2]) / (xy1 * p2[2] * p2[2])
        ah = (1.0 / xy1 - (pp[2] * pp[2]) / (xy1 * p2[2] * p2[2])) / den
        ch = (ah * xy2 - 1.0) / (p2[2] * p2[2])
        if np.isfinite(ah):
            break
    if not (np.isfinite(ah) and np.isfinite(ch)):
        log.warning("degenerate hyperboloid p1=%s p2=%s: implicit coefficients are non-finite; "
                    "shape will not render", p1, p2)
        ah = ch = 0.0
    return p1, p2, ah, ch


def _quadric_row(sph, qkind):
    """(sph_param row (12,), object-space bounds lo, hi) of a quadric, as
    the reference writes them (builder :684-772)."""
    pad6 = [0.0] * 6
    r = sph.radius
    if qkind == QUADRIC_SPHERE:
        zmin = np.clip(min(sph.z_min, sph.z_max), -r, r)
        zmax = np.clip(max(sph.z_min, sph.z_max), -r, r)
        theta_min = np.arccos(np.clip(zmin / r, -1.0, 1.0))
        theta_max = np.arccos(np.clip(zmax / r, -1.0, 1.0))
        return [r, zmin, zmax, sph.phi_max, theta_min, theta_max] + pad6, [-r] * 3, [r] * 3
    if qkind in (QUADRIC_CYLINDER, QUADRIC_PARABOLOID):
        zmin, zmax = min(sph.z_min, sph.z_max), max(sph.z_min, sph.z_max)
        return [r, zmin, zmax, sph.phi_max, 0.0, 0.0] + pad6, [-r, -r, zmin], [r, r, zmax]
    if qkind == QUADRIC_CONE:
        return [r, sph.height, 0.0, sph.phi_max, 0.0, 0.0] + pad6, [-r, -r, 0.0], [r, r, sph.height]
    if qkind == QUADRIC_HYPERBOLOID:
        p1, p2, ah, ch = _hyperboloid_coefficients(sph)
        rmax = max(np.hypot(p1[0], p1[1]), np.hypot(p2[0], p2[1]))
        zmin, zmax = min(p1[2], p2[2]), max(p1[2], p2[2])
        return ([rmax, zmin, zmax, sph.phi_max, float(ah), float(ch)] + list(p1) + list(p2),
                [-rmax, -rmax, zmin], [rmax, rmax, zmax])
    # disk (disk.rs): the plane z = height, the annulus [inner, radius]
    return ([r, sph.height, sph.inner_radius, sph.phi_max, 0.0, 0.0] + pad6,
            [-r, -r, sph.height - 1e-4], [r, r, sph.height + 1e-4])


_IDENT34 = np.eye(4)[:3, :]
N_T = 16  # samples of a rotating prim's exact path in its swept bounds (reference builder :835)


class _Motion:
    """The motion rows of the prim loop (reference builder :230-262,
    :513-526, :571-600, :620-672, :774-850): the shutter-close and
    mid-shutter keyframes of every triangle and quadric row, one
    animated-transform group per distinct (M0, M1) shutter CTM pair
    (group 0 the identity), each prim's group and compose constant, and
    the prims whose swept bounds are re-sampled along the exact path when
    a group rotates. All in float64, in the reference's order."""

    def __init__(self):
        self.tri_p_e, self.tri_p_m = [], []
        self.sph_w2o_e, self.sph_o2w_e, self.sph_w2o_m, self.sph_o2w_m = [], [], [], []
        self.any_motion = False
        self.any_rot_motion = False
        self.keys: dict = {}
        self.group_mats: list = [(np.eye(4), np.eye(4))]
        self.prim_gid: list = []
        self.prim_c: list = []
        self.rot_prims: list = []  # (prim row, group, lo0 (3,), hi0 (3,))
        self.parts: list = []
        self.has_rot_motion = False

    def gid(self, pair) -> int:
        key = (pair[0].tobytes(), pair[1].tobytes())
        g = self.keys.get(key)
        if g is None:
            g = len(self.group_mats)
            self.keys[key] = g
            self.group_mats.append((np.asarray(pair[0], np.float64), np.asarray(pair[1], np.float64)))
        return g

    def mesh_keyframes(self, mesh, pv):
        """A new mesh's shutter-close and mid-shutter vertices."""
        f = np.asarray(mesh.indices, dtype=np.int64)
        if mesh.p_end is not None:
            pv_end = np.asarray(mesh.p_end, dtype=np.float64)[f]
            self.any_motion = True
            if mesh.p_mid is not None:
                pv_mid = np.asarray(mesh.p_mid, dtype=np.float64)[f]
                if not np.allclose(pv_mid, 0.5 * (pv + pv_end), atol=1e-9):
                    self.any_rot_motion = True
            else:
                pv_mid = 0.5 * (pv + pv_end)
        else:
            pv_end = pv_mid = pv
        self.tri_p_e.append(pv_end)
        self.tri_p_m.append(pv_mid)

    def mesh_bounds(self, pv):
        """A new, non-instanced mesh's swept bounds: the hull of the
        quadratic arc's Bezier control points {p0, 2m - (p0 + p1) / 2, p1}."""
        pv_end, pv_mid = self.tri_p_e[-1], self.tri_p_m[-1]
        ctrl = 2.0 * pv_mid - 0.5 * (pv + pv_end)
        return (np.minimum.reduce([pv.min(axis=1), pv_end.min(axis=1), ctrl.min(axis=1)]),
                np.maximum.reduce([pv.max(axis=1), pv_end.max(axis=1), ctrl.max(axis=1)]))

    @staticmethod
    def instance_sweep(mesh, inst_t, pv, lo_rows, hi_rows):
        """An animated instanced prototype's bounds over the whole shutter:
        N_T + 1 samples of the exact path in world space, and the arc pad."""
        m0a = np.asarray(mesh.anim[0], np.float64)
        at = AnimatedTransform(Transform.from_matrix(m0a), Transform.from_matrix(np.asarray(mesh.anim[1], np.float64)),
                               0.0, 1.0)
        m0inv = np.linalg.inv(m0a)
        for i_t in range(N_T + 1):
            hm = at.interpolate(i_t / N_T).m @ m0inv
            pw = inst_t.xpoint((pv.reshape(-1, 3) @ hm[:3, :3].T) + hm[:3, 3]).reshape(-1, 3, 3)
            lo_rows = np.minimum(lo_rows, pw.min(axis=1))
            hi_rows = np.maximum(hi_rows, pw.max(axis=1))
        ext = float(np.linalg.norm(hi_rows.max(axis=0) - lo_rows.min(axis=0)))
        (_, q0a, _), (_, q1a, _) = at._parts()
        th = float(np.arccos(np.clip(np.dot(q0a, q1a), -1.0, 1.0)))
        pad = ext * (th / N_T) ** 2 / 8.0 + 1e-6
        return lo_rows - pad, hi_rows + pad

    def mesh_prims(self, mesh, inst_t, base_prim, pv):
        t = len(pv)
        if getattr(mesh, "anim", None) is not None:
            # an instanced prototype's ray is brought to instance space
            # first; the exact motion acts in prototype space
            g = self.gid(mesh.anim)
            self.prim_gid.extend([g] * t)
            self.prim_c.extend([np.linalg.inv(mesh.anim[0])[:3, :]] * t)
            if inst_t is None:
                lo0, hi0 = pv.min(axis=1), pv.max(axis=1)
                self.rot_prims.extend((base_prim + ti, g, lo0[ti], hi0[ti]) for ti in range(t))
        else:
            self.prim_gid.extend([0] * t)
            self.prim_c.extend([_IDENT34] * t)

    def quadric(self, sph, o2w, w2o, pid, lo, hi, obj_lo, obj_hi):
        """A quadric's keyframes, group and swept bounds."""
        end = sph.object_to_world_end
        if end is not None:
            self.sph_w2o_e.append(end.inverse().m[:3, :])
            self.sph_o2w_e.append(end.m[:3, :])
            self.any_motion = True
            mid = sph.object_to_world_mid
            if mid is None:
                self.sph_w2o_m.append(0.5 * (w2o.m[:3, :] + end.inverse().m[:3, :]))
                self.sph_o2w_m.append(0.5 * (o2w.m[:3, :] + end.m[:3, :]))
            else:
                self.sph_w2o_m.append(mid.inverse().m[:3, :])
                self.sph_o2w_m.append(mid.m[:3, :])
                self.any_rot_motion = True
        else:
            for rows, m in ((self.sph_w2o_e, w2o), (self.sph_o2w_e, o2w), (self.sph_w2o_m, w2o),
                            (self.sph_o2w_m, o2w)):
                rows.append(m.m[:3, :])
        if getattr(sph, "anim", None) is not None:
            g = self.gid(sph.anim)
            self.prim_gid.append(g)
            self.prim_c.append((w2o.m @ np.asarray(sph.anim[0], np.float64))[:3, :])
            self.rot_prims.append((pid, g, np.asarray(lo, float), np.asarray(hi, float)))
        else:
            # a static quadric under group 0 (M(t) = I): C . M^-1 must still
            # be its own world-to-object
            self.prim_gid.append(0)
            self.prim_c.append(w2o.m[:3, :])
        if end is not None:
            lo2, hi2 = end.xbounds(obj_lo, obj_hi)
            lo, hi = np.minimum(lo, lo2), np.maximum(hi, hi2)
        return lo, hi

    def rebound(self, prim_lo, prim_hi):
        """Decompose every group; when one rotates, re-bound its prims by
        N_T + 1 samples of the exact transform path plus the inter-sample
        arc pad (reference :817-850)."""
        for (m0, m1) in self.group_mats:
            at = AnimatedTransform(Transform.from_matrix(m0), Transform.from_matrix(m1), 0.0, 1.0)
            (t0_, q0_, s0_), (t1_, q1_, s1_) = at._parts()
            theta = float(np.arccos(np.clip(np.dot(q0_, q1_), -1.0, 1.0)))
            self.parts.append((t0_, q0_, s0_, t1_, q1_, s1_, theta))
            if theta > 1e-6:
                self.has_rot_motion = True
        if not (self.has_rot_motion and self.rot_prims):
            return
        hs = [[(AnimatedTransform(Transform.from_matrix(m0), Transform.from_matrix(m1), 0.0, 1.0)
                .interpolate(i / N_T).m @ np.linalg.inv(m0))[:3, :] for i in range(N_T + 1)]
              for (m0, m1) in self.group_mats]
        for (row, g, lo0, hi0) in self.rot_prims:
            theta = self.parts[g][6]
            corners = np.array([[lo0[0], lo0[1], lo0[2]], [hi0[0], lo0[1], lo0[2]],
                                [lo0[0], hi0[1], lo0[2]], [hi0[0], hi0[1], lo0[2]],
                                [lo0[0], lo0[1], hi0[2]], [hi0[0], lo0[1], hi0[2]],
                                [lo0[0], hi0[1], hi0[2]], [hi0[0], hi0[1], hi0[2]]])
            pts = np.concatenate([(h[:, :3] @ corners.T).T + h[:, 3] for h in hs[g]])
            # the inter-sample chord deviation of a rotation arc: r phi^2 / 8
            r = float(np.linalg.norm(hi0 - lo0)) * 0.5 + float(np.max(np.linalg.norm(pts - pts.mean(axis=0), axis=1)))
            pad = r * (theta / N_T) ** 2 / 8.0 + 1e-6
            prim_lo[row] = np.minimum(prim_lo[row], pts.min(axis=0) - pad)
            prim_hi[row] = np.maximum(prim_hi[row], pts.max(axis=0) + pad)

    def tables(self, perm, tri_p_cat, sph_w2o_cat, sph_param_cat, sph_kind, ptd, pk, pg, partial_hyp):
        """The keyframe tables (reference builder :986-1025, :1212-1219)
        and the anim tables (:1275-1289), prim rows in BVH leaf order."""
        out = {}
        if self.any_motion:
            def cat(chunks):
                return np.concatenate([np.asarray(c, dtype=np.float32).reshape(-1, 3, 3) for c in chunks], axis=0)

            tri_pe = cat(self.tri_p_e) if self.tri_p_e else tri_p_cat
            tri_pm = cat(self.tri_p_m) if self.tri_p_m else tri_p_cat
            w2oe = np.asarray(self.sph_w2o_e, dtype=np.float32).reshape(-1, 3, 4)
            w2om = np.asarray(self.sph_w2o_m, dtype=np.float32).reshape(-1, 3, 4)
            tri_rows = np.where(pk == GEOM_TRI)[0]
            q_rows = np.where(pk == GEOM_SPHERE)[0]
            for name, tri_k, w2o_k in (("end", tri_pe, w2oe), ("mid", tri_pm, w2om)):
                if name == "mid" and not self.any_rot_motion:
                    continue
                p = np.zeros_like(ptd)
                if len(tri_rows):
                    p[tri_rows, 0:9] = tri_k[pg[tri_rows]].reshape(len(tri_rows), 9)
                if len(q_rows):
                    p[q_rows, 0:12] = w2o_k[pg[q_rows]].reshape(len(q_rows), 12)
                    p[q_rows, 12:18] = sph_param_cat[pg[q_rows]][:, 0:6]
                    p[q_rows, 18] = np.asarray(sph_kind, np.float32)[pg[q_rows]]
                    if partial_hyp:
                        p[q_rows, 19:25] = sph_param_cat[pg[q_rows]][:, 6:12]
                out[f"prim_test_data_{name}"] = p
                out[f"tri_p_{name}"] = tri_k
                out[f"sph_w2o_{name}"] = w2o_k
                out[f"sph_o2w_{name}"] = np.asarray(getattr(self, f"sph_o2w_{name[0]}"),
                                                    dtype=np.float32).reshape(-1, 3, 4)
        if self.has_rot_motion:
            idx = {"t0": 0, "q0": 1, "s0": 2, "t1": 3, "q1": 4, "s1": 5}
            out["anim"] = {k: np.stack([p[i] for p in self.parts]).astype(np.float32) for k, i in idx.items()}
            out["anim"]["theta"] = np.asarray([p[6] for p in self.parts], np.float32)
            out["anim_gid"] = np.asarray([self.prim_gid[i] for i in perm], np.int32)
            out["anim_c"] = np.stack([self.prim_c[i] for i in perm]).astype(np.float32)
        return out


def _mesh_rows(mesh):
    """A mesh's per-triangle rows: (vertices (t, 3, 3), shading normals,
    uvs, areas, flags), as the reference's prim loop computes them."""
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
    return pv, nv, uvv, areas, flags


def compile_scene(desc: SceneDescription, device="cuda") -> CompiledScene:
    """Compile a scene of the ported class into tables on `device` (the
    card unless the caller names another device)."""
    _check_slice(desc)
    tri_p, tri_n, tri_uv = [], [], []
    sph_o2w, sph_w2o, sph_param, sph_kind = [], [], [], []
    prim_kind, prim_geom, prim_mat, prim_light, prim_flags, prim_area = [], [], [], [], [], []
    prim_lo, prim_hi = [], []
    prim_alpha, prim_shadow_alpha = [], []  # float texture ids or -1 (cutouts)
    prim_medium = []  # [inside, outside] medium rows per prim
    med = _MediaTable(desc.media)
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
    # per light row: its world -> light frame and its image key (the
    # goniometric and projection lights' maps), as the reference pushes them
    light_w2l_rows: list = []
    light_images: dict = {}
    light_image_keys: list = []

    def push_light_frame(hl, has_image):
        light_w2l_rows.append(np.eye(4)[:3, :] if hl is None else hl.light_to_world.inverse().m[:3, :])
        if has_image and hl.image is not None:
            key = f"lim{len(light_images)}"
            light_images[key] = np.asarray(hl.image, dtype=np.float32)
            light_image_keys.append(key)
        else:
            light_image_keys.append(None)

    # non-area lights first, in description order; the last infinite light
    # is the scene's environment, as in the reference
    infinite_host = None
    for hl in desc.lights:
        kind, p = _compile_light(hl)
        lights.append((kind, p, -1, max(int(hl.n_samples), 1)))
        push_light_frame(hl, kind in (LIGHT_GONIO, LIGHT_PROJECTION))
        if kind == LIGHT_INFINITE:
            infinite_host = hl

    def add_area_lights(area_light, first_prim, n):
        """n area-light rows for prims first_prim.. (one per triangle or
        quadric); returns their light ids."""
        lp = np.zeros(12)
        lp[0:3] = area_light.intensity
        lp[3] = 1.0 if area_light.two_sided else 0.0
        ns = max(int(area_light.n_samples), 1)
        ids = np.arange(len(lights), len(lights) + n)
        for ti in range(n):
            lights.append((LIGHT_AREA, lp, first_prim + ti, ns))
            push_light_frame(None, False)
        return ids

    # instance transforms (primitive.rs TransformedPrimitive): row 0 is the
    # identity; an instanced mesh's prims keep its prototype's rows (one
    # set of rows per mesh) and carry the instance id
    inst_i2w_rows = [np.eye(4)[:3, :]]
    inst_w2i_rows = [np.eye(4)[:3, :]]
    prim_inst: list[int] = []
    proto_rows: dict[int, tuple] = {}  # id(mesh) -> (t0, t, pv, areas, flags)

    sss = _SubsurfaceRows(med)
    mo = _Motion()
    for prim in desc.primitives:
        mid = material_id(prim.material)
        sss.register(prim.material, mid)
        media = [sss.inside_medium(prim, mid), med.medium_id(prim.outside_medium)]
        if prim.shape.mesh is None:
            sph = prim.shape.sphere
            o2w = sph.object_to_world
            qkind = QUADRICS[getattr(sph, "kind", "sphere")]
            si = len(sph_o2w)
            sph_o2w.append(o2w.m[:3, :])
            sph_w2o.append(o2w.inverse().m[:3, :])
            sph_kind.append(qkind)
            row, obj_lo, obj_hi = _quadric_row(sph, qkind)
            sph_param.append(row)
            flags = 0
            if sph.reverse_orientation ^ o2w.swaps_handedness():
                flags |= FLAG_FLIP_GEOM_N
            if sph.reverse_orientation:
                flags |= FLAG_REVERSE_ORIENTATION
            light_id = -1
            pid = len(prim_kind)
            if prim.area_light is not None:
                light_id = int(add_area_lights(prim.area_light, pid, 1)[0])
            prim_kind.append(GEOM_SPHERE)
            prim_inst.append(0)
            prim_geom.append(si)
            prim_mat.append(mid)
            prim_light.append(light_id)
            prim_flags.append(flags)
            prim_area.append(_quadric_area(sph, qkind))
            prim_alpha.append(-1)
            prim_shadow_alpha.append(-1)
            prim_medium.append(media)
            lo, hi = mo.quadric(sph, o2w, o2w.inverse(), pid, *o2w.xbounds(obj_lo, obj_hi), obj_lo, obj_hi)
            prim_lo.append(lo)
            prim_hi.append(hi)
            continue
        mesh = prim.shape.mesh
        inst_t = prim.instance_transform
        cached = proto_rows.get(id(mesh)) if inst_t is not None else None
        if cached is None:
            pv, nv, uvv, areas, flags = _mesh_rows(mesh)
            t = len(pv)
            t0 = sum(len(c) for c in tri_p)
            mo.mesh_keyframes(mesh, pv)
            tri_p.append(pv)
            tri_n.append(nv)
            tri_uv.append(uvv)
            if inst_t is not None:
                proto_rows[id(mesh)] = (t0, t, pv, areas, flags)
        else:
            t0, t, pv, areas, flags = cached
        if inst_t is not None:
            iid = len(inst_i2w_rows)
            inst_i2w_rows.append(inst_t.m[:3, :])
            inst_w2i_rows.append(inst_t.inverse().m[:3, :])
            flags_p = flags ^ (FLAG_FLIP_GEOM_N if inst_t.swaps_handedness() else 0)
            # world bounds of the instance-space triangles, swept over the
            # shutter for an animated prototype
            pv_w = inst_t.xpoint(pv.reshape(-1, 3)).reshape(-1, 3, 3)
            lo_rows, hi_rows = pv_w.min(axis=1), pv_w.max(axis=1)
            if getattr(mesh, "anim", None) is not None:
                lo_rows, hi_rows = mo.instance_sweep(mesh, inst_t, pv, lo_rows, hi_rows)
        else:
            iid, flags_p = 0, flags
            lo_rows, hi_rows = mo.mesh_bounds(pv)
        base_prim = len(prim_kind)
        light_ids = np.full(t, -1, dtype=np.int64)
        if prim.area_light is not None:
            if inst_t is not None:
                log.warning("area lights on instanced prototypes are not supported (dropped)")
            else:
                light_ids = add_area_lights(prim.area_light, base_prim, t)
        prim_kind.extend([GEOM_TRI] * t)
        prim_geom.extend(range(t0, t0 + t))
        prim_mat.extend([mid] * t)
        prim_light.extend(light_ids.tolist())
        prim_flags.extend([flags_p] * t)
        prim_area.extend(areas.tolist())
        prim_inst.extend([iid] * t)
        prim_lo.extend(lo_rows)
        prim_hi.extend(hi_rows)
        mo.mesh_prims(mesh, inst_t, base_prim, pv)
        # alpha / shadow-alpha cutout masks (triangle.rs:29-30)
        a_id = tex_reg.register(mesh.alpha_texture) if mesh.alpha_texture is not None else -1
        sa_id = tex_reg.register(mesh.shadow_alpha_texture) if mesh.shadow_alpha_texture is not None else a_id
        prim_alpha.extend([a_id] * t)
        prim_shadow_alpha.extend([sa_id] * t)
        prim_medium.extend([media] * t)

    n_prims = len(prim_kind)
    has_instances = len(inst_i2w_rows) > 1
    use_brute = n_prims <= BRUTE_FORCE_MAX_PRIMS and not has_instances
    if n_prims == 0:
        _unsupported("scenes without primitives")
    if not lights and not use_brute:
        _unsupported("scenes of > 64 primitives without lights")

    mo.rebound(prim_lo, prim_hi)

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
    prim_alpha = _perm(prim_alpha)
    prim_shadow_alpha = _perm(prim_shadow_alpha)
    prim_medium = _perm(prim_medium)
    prim_lo = _perm(prim_lo)
    prim_hi = _perm(prim_hi)
    lights = [(k, p_, int(inv[pr]) if pr >= 0 else -1, ns) for (k, p_, pr, ns) in lights]
    # the reference leaves prim_inst in description order (builder :887-904
    # permutes every other prim table), so its instanced prims read other
    # prims' transforms once the BVH reorders them; the port permutes it
    # with the rest (ROADMAP C)
    prim_inst = _perm(prim_inst)

    def _cat(chunks, shape):
        if not chunks:
            return np.zeros((0,) + shape, dtype=np.float32)
        return np.concatenate([np.asarray(c, dtype=np.float32).reshape((-1,) + shape) for c in chunks], axis=0)

    tri_p_cat = _cat(tri_p, (3, 3))
    sph_w2o_cat = np.asarray(sph_w2o, dtype=np.float32).reshape(-1, 3, 4)
    sph_param_cat = np.asarray(sph_param, dtype=np.float32).reshape(-1, 12)

    # --- the binary BVH's packed tables (the walks' input) --------------------
    # node rows (N, 12): lo (3), hi (3), offset, n prims, axis, pad (3)
    node_data = np.zeros((len(bvh.n_prims), 12), np.float32)
    node_data[:, 0:3] = bvh.bounds_min
    node_data[:, 3:6] = bvh.bounds_max
    node_data[:, 6] = bvh.offset
    node_data[:, 7] = bvh.n_prims
    node_data[:, 8] = bvh.axis
    # prim rows (P, 20): a triangle's 9 vertex floats; a quadric's w2o (12),
    # params 0:6, kind (col 18); a partial-phimax hyperboloid widens every
    # row to 26 with params 6:12 (its p1, p2) in cols 19:25
    partial_hyp = any(k == QUADRIC_HYPERBOLOID and row[3] < 2.0 * np.pi - 1e-6 for k, row in zip(sph_kind, sph_param))
    ptd = np.zeros((n_prims, 26 if partial_hyp else 20), np.float32)
    pk = np.asarray(prim_kind)
    pg = np.asarray(prim_geom)
    tri_rows = np.where(pk == GEOM_TRI)[0]
    q_rows = np.where(pk == GEOM_SPHERE)[0]
    if len(tri_rows):
        ptd[tri_rows, 0:9] = tri_p_cat[pg[tri_rows]].reshape(len(tri_rows), 9)
    if len(q_rows):
        ptd[q_rows, 0:12] = sph_w2o_cat[pg[q_rows]].reshape(len(q_rows), 12)
        ptd[q_rows, 12:18] = sph_param_cat[pg[q_rows]][:, 0:6]
        ptd[q_rows, 18] = np.asarray(sph_kind, np.float32)[pg[q_rows]]
        if partial_hyp:
            ptd[q_rows, 19:25] = sph_param_cat[pg[q_rows]][:, 6:12]

    mat_kind = np.array([r[0] for r in mat_rows], dtype=np.int32)
    motion = mo.tables(perm, tri_p_cat, sph_w2o_cat, sph_param_cat, sph_kind, ptd, pk, pg, partial_hyp)
    arrays = {
        "tri_p": tri_p_cat,
        "tri_n": _cat(tri_n, (3, 3)),
        "tri_uv": _cat(tri_uv, (3, 2)),
        "tri_prim_ids": _geom_to_prim_map(prim_kind, prim_geom, GEOM_TRI, len(tri_p_cat)),
        "sph_o2w": np.asarray(sph_o2w, dtype=np.float32).reshape(-1, 3, 4),
        "sph_w2o": sph_w2o_cat,
        "sph_param": sph_param_cat,
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
        "light_w2l": np.asarray(light_w2l_rows, dtype=np.float32).reshape(-1, 3, 4),
        "light_images": light_images,
        "bvh_packed": node_data,
        "prim_test_data": ptd,
        "prim_inst": np.asarray(prim_inst, dtype=np.int32),
        "inst_i2w": np.asarray(inst_i2w_rows, dtype=np.float32).reshape(-1, 3, 4),
        "inst_w2i": np.asarray(inst_w2i_rows, dtype=np.float32).reshape(-1, 3, 4),
        "prim_alpha_tex": np.asarray(prim_alpha, dtype=np.int32),
        "prim_shadow_alpha_tex": np.asarray(prim_shadow_alpha, dtype=np.int32),
        "prim_medium": np.asarray(prim_medium, dtype=np.int32).reshape(-1, 2),
        "med_param": np.asarray(med.param_rows, dtype=np.float32).reshape(-1, 8),
        "med_w2m": np.asarray(med.w2m_rows, dtype=np.float32).reshape(-1, 3, 4),
        "med_grids": med.grids,
        **sss.tables(len(mat_rows)),
        "fourier": _stack_fourier_tables(fourier_tables),
        "world_center": wc.astype(np.float32),
        "world_radius": np.float32(wr),
        **motion,
    }
    inf_idx = max((i for i, l in enumerate(lights) if l[0] == LIGHT_INFINITE), default=-1)
    if infinite_host is not None and infinite_host.image is not None:
        env, mean = _env_tables(infinite_host)
        arrays.update(env)
        arrays["light_param"][inf_idx, 3:6] = mean

    # --- the kd-tree (Accelerator "kdtree"), with the reference's demotions:
    # instancing keeps the BVH (with its warning), a brute-force scene the
    # brute route
    accel_kind = str(desc.accelerator or "bvh")
    if accel_kind == "kdtree" and has_instances:
        log.warning("kd-tree accelerator does not support instancing; using bvh")
        accel_kind = "bvh"
    kd = None
    if accel_kind == "kdtree" and not use_brute:
        kd = build_kdtree(np.asarray(prim_lo), np.asarray(prim_hi))
        arrays.update(kd_flags=kd.flags, kd_split=kd.split, kd_above=kd.above, kd_nprims=kd.nprims,
                      kd_prim_ids=kd.prim_ids, kd_lo=kd.bounds_lo.astype(np.float32),
                      kd_hi=kd.bounds_hi.astype(np.float32))
    else:
        accel_kind = "bvh"

    wide_root = 1
    n_tri_prims = len(tri_rows)
    all_tri = n_tri_prims == n_prims
    mixed_ok = not all_tri and n_tri_prims > BRUTE_FORCE_MAX_PRIMS and 0 < len(sph_o2w) <= MAX_WIDE_QUADRICS
    has_wide_tri = (not use_brute and accel_kind == "bvh" and not has_instances and not mo.any_motion
                    and (all_tri or mixed_ok))
    if has_wide_tri:
        # --- wide BVH over the (permuted) triangle rows -----------------------
        # a mixed scene's tables cover its triangle prims only (the
        # reference's mixed_ok branch)
        rows = tri_rows
        # payload cols 11-13 (mat, light, flags) as the reference writes them
        extra = np.stack([
            np.asarray(prim_mat, np.float32)[rows],
            np.asarray(prim_light, np.float32)[rows],
            np.asarray(prim_flags, np.float32)[rows],
        ], axis=1)
        pgt = pg[rows]
        tv = tri_p_cat[pgt]
        # the attribute table (reference builder :1118-1139), built when some
        # prim has shading normals or a non-default UV chart: lanes 0:9 the
        # per-vertex normals n0/n1/n2, 9:15 uv0/uv1/uv2, in the prim table's
        # (octet, slot) layout
        attr = None
        tn, tuv = arrays["tri_n"][pgt], arrays["tri_uv"][pgt]
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
            and sph_kind[prim_geom[l[2]]] == QUADRIC_SPHERE
            and sph_param[prim_geom[l[2]]][1] <= -sph_param[prim_geom[l[2]]][0] * (1 - 1e-6)
            and sph_param[prim_geom[l[2]]][2] >= sph_param[prim_geom[l[2]]][0] * (1 - 1e-6)
            and sph_param[prim_geom[l[2]]][3] >= 2.0 * np.pi - 1e-6
            and (prim_flags[l[2]] & FLAG_REVERSE_ORIENTATION) == 0
            for l in lights),
        "n_media": len(med.param_rows),
        "media_kinds": tuple(med.kinds),
        "camera_medium": med.ids.get(desc.camera_medium, -1),
        "has_null_material": bool((mat_kind[np.asarray(prim_mat, dtype=np.int64)] == 0).any()),
        "has_sss_media": bool(sss.walk_media),
        "sss_media": tuple(med.ids[n] for n in sss.walk_media.values()),
        "has_tab_sss": bool(sss.tab_mats),
        "has_motion": mo.any_motion,
        "has_rot_motion": mo.has_rot_motion,
        "tex_programs": tuple(tex_reg.programs),
        "has_bump": any(r[4] >= 0 for r in mat_rows),
        "has_fourier": bool(fourier_tables),
        "has_wide": has_wide_tri and all_tri,
        "has_wide_tri": has_wide_tri,
        "wide_root": wide_root,
        "max_leaf": max_leaf,
        "has_instances": has_instances,
        "has_alpha": any(a >= 0 for a in prim_alpha) or any(a >= 0 for a in prim_shadow_alpha),
        "accel_kind": accel_kind,
        "kd_max_leaf": int(kd.max_leaf) if kd is not None else 1,
        "light_image_keys": tuple(light_image_keys),
    }
    tensors, st = scene_tensors_from_numpy(arrays, static, device)
    return CompiledScene(arrays=tensors, static=st, description=desc, prim_order=perm)
