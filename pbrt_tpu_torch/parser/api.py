"""The pbrt scene-build API state machine.

One method per .pbrt directive, mirroring the semantics of the reference's
``API`` struct (src/core/api.rs:898-1771): current-transform
stack, graphics-state stack with attribute begin/end, named coordinate
systems, named materials/textures/media, object instancing, and area-light
binding to shapes.  The output is a ``SceneDescription`` of host records
instead of a trait-object graph; geometry is transformed to world space here.

The port's copy of ``pbrt_tpu/parser/api.py``: it builds every directive the
reference builds, with the reference's error-and-degrade behaviour and its
known faults (it stores the texture-space transform and the checkerboard
"aamode", which the reference's device code never reads). What the port cannot
render yet, ``scene.builder.compile_scene`` refuses by name.
"""
from __future__ import annotations

import copy
import logging
import math
import os
from dataclasses import dataclass, field

import numpy as np

from ..core.options import Options
from ..core.paramset import ParamSet, TextureParams
from ..core.spectrum import copper_eta_k_rgb
from ..core.transform import Transform
from ..core import imageio
from ..scene import host
from ..scene.ply import read_ply
from ..scene.host import (
    CameraConfig,
    FilmConfig,
    HostLight,
    HostMaterial,
    HostPrimitive,
    HostTexture,
    IntegratorConfig,
    SamplerConfig,
    SceneDescription,
    ShapeRecord,
    Sphere,
    TriangleMesh,
)

log = logging.getLogger(__name__)

_STATE_UNINIT = 0
_STATE_OPTIONS = 1
_STATE_WORLD = 2

MAX_TRANSFORMS = 2  # start/end time, reference api.rs:103
ALL_TRANSFORM_BITS = (1 << MAX_TRANSFORMS) - 1


@dataclass
class GraphicsState:
    """Reference api.rs:327-404."""

    current_material: HostMaterial = field(default_factory=lambda: copy.deepcopy(host.MATTE_DEFAULT))
    area_light: str = ""
    area_light_params: ParamSet = None
    reverse_orientation: bool = False
    float_textures: dict = field(default_factory=dict)
    spectrum_textures: dict = field(default_factory=dict)
    named_materials: dict = field(default_factory=dict)
    current_inside_medium: str = ""
    current_outside_medium: str = ""

    def clone(self):
        g = GraphicsState(
            current_material=self.current_material,
            area_light=self.area_light,
            area_light_params=self.area_light_params,
            reverse_orientation=self.reverse_orientation,
            float_textures=dict(self.float_textures),
            spectrum_textures=dict(self.spectrum_textures),
            named_materials=dict(self.named_materials),
            current_inside_medium=self.current_inside_medium,
            current_outside_medium=self.current_outside_medium,
        )
        return g


@dataclass
class RenderOptions:
    """Reference api.rs:191-300."""

    transform_start_time: float = 0.0
    transform_end_time: float = 1.0
    filter_name: str = "box"
    filter_params: ParamSet = field(default_factory=ParamSet)
    film_name: str = "image"
    film_params: ParamSet = field(default_factory=ParamSet)
    sampler_name: str = "halton"
    sampler_params: ParamSet = field(default_factory=ParamSet)
    accelerator_name: str = "bvh"
    accelerator_params: ParamSet = field(default_factory=ParamSet)
    integrator_name: str = "path"
    integrator_params: ParamSet = field(default_factory=ParamSet)
    camera_name: str = "perspective"
    camera_params: ParamSet = field(default_factory=ParamSet)
    camera_to_world: Transform = field(default_factory=Transform)
    camera_to_world_end: Transform | None = None
    named_media: dict = field(default_factory=dict)
    lights: list = field(default_factory=list)
    primitives: list = field(default_factory=list)
    instances: dict = field(default_factory=dict)  # name -> list[HostPrimitive]
    current_instance: str | None = None
    have_scattering_media: bool = False
    camera_medium: str = ""


class API:
    """Scene-building state machine. Drive with pbrt_tpu_torch.parser.parser.parse."""

    def __init__(self, options: Options | None = None, search_dir: str = ""):
        self.options = options or Options()
        self.state = _STATE_UNINIT
        self.search_dir = search_dir
        self.ctm = [Transform(), Transform()]  # start/end time CTMs
        self.active_transform_bits = ALL_TRANSFORM_BITS
        self.named_coordinate_systems: dict[str, list[Transform]] = {}
        self.render_options = RenderOptions()
        self.graphics_state = GraphicsState()
        self.pushed_graphics_states: list[GraphicsState] = []
        self.pushed_transforms: list[list[Transform]] = []
        self.pushed_active_transform_bits: list[int] = []
        self.scene: SceneDescription | None = None

    # -- state verification (reference api.rs:914-961) ----------------------
    def _verify_initialized(self, api_func):
        if self.state == _STATE_UNINIT:
            raise RuntimeError(f"init() must be called before {api_func}()")

    def _verify_options(self, api_func):
        self._verify_initialized(api_func)
        if self.state == _STATE_WORLD:
            log.error("options cannot be set inside world block: %s ignored", api_func)
            return False
        return True

    def _verify_world(self, api_func):
        self._verify_initialized(api_func)
        if self.state == _STATE_OPTIONS:
            log.error("scene description must be inside world block: %s ignored", api_func)
            return False
        return True

    # -- lifecycle ----------------------------------------------------------
    def init(self):
        if self.state != _STATE_UNINIT:
            raise RuntimeError("init() already called")
        self.state = _STATE_OPTIONS

    def cleanup(self):
        self.state = _STATE_UNINIT

    # -- transforms ---------------------------------------------------------
    def _for_active_transforms(self, fn):
        for i in range(MAX_TRANSFORMS):
            if self.active_transform_bits & (1 << i):
                self.ctm[i] = fn(self.ctm[i])

    def identity(self):
        self._verify_initialized("Identity")
        self._for_active_transforms(lambda _t: Transform())

    def translate(self, dx, dy, dz):
        self._verify_initialized("Translate")
        self._for_active_transforms(lambda t: t @ Transform.translate([dx, dy, dz]))

    def scale(self, sx, sy, sz):
        self._verify_initialized("Scale")
        self._for_active_transforms(lambda t: t @ Transform.scale(sx, sy, sz))

    def rotate(self, angle, ax, ay, az):
        self._verify_initialized("Rotate")
        self._for_active_transforms(lambda t: t @ Transform.rotate(angle, [ax, ay, az]))

    def look_at(self, ex, ey, ez, lx, ly, lz, ux, uy, uz):
        self._verify_initialized("LookAt")
        l2w = Transform.look_at([ex, ey, ez], [lx, ly, lz], [ux, uy, uz])
        self._for_active_transforms(lambda t: t @ l2w.inverse())

    def transform(self, *m16):
        self._verify_initialized("Transform")
        m = np.array(m16, dtype=np.float64).reshape(4, 4).T  # column-major input
        self._for_active_transforms(lambda _t: Transform.from_matrix(m))

    def concat_transform(self, *m16):
        self._verify_initialized("ConcatTransform")
        m = np.array(m16, dtype=np.float64).reshape(4, 4).T
        self._for_active_transforms(lambda t: t @ Transform.from_matrix(m))

    def transform_times(self, start, end):
        if self._verify_options("TransformTimes"):
            self.render_options.transform_start_time = start
            self.render_options.transform_end_time = end

    def active_transform(self, which):
        self._verify_initialized("ActiveTransform")
        if which == "All":
            self.active_transform_bits = ALL_TRANSFORM_BITS
        elif which == "StartTime":
            self.active_transform_bits = 1
        elif which == "EndTime":
            self.active_transform_bits = 2
        else:
            log.error("ActiveTransform: unknown time '%s'", which)

    def coordinate_system(self, name):
        self._verify_initialized("CoordinateSystem")
        self.named_coordinate_systems[name] = [self.ctm[0], self.ctm[1]]

    def coord_sys_transform(self, name):
        self._verify_initialized("CoordSysTransform")
        if name in self.named_coordinate_systems:
            self.ctm = list(self.named_coordinate_systems[name])
        else:
            log.error("couldn't find named coordinate system '%s'", name)

    def transform_begin(self):
        if self._verify_world("TransformBegin"):
            self.pushed_transforms.append(list(self.ctm))
            self.pushed_active_transform_bits.append(self.active_transform_bits)

    def transform_end(self):
        if self._verify_world("TransformEnd"):
            if not self.pushed_transforms:
                log.error("unmatched TransformEnd ignored")
                return
            self.ctm = self.pushed_transforms.pop()
            self.active_transform_bits = self.pushed_active_transform_bits.pop()

    # -- options block ------------------------------------------------------
    def camera(self, name, params: ParamSet):
        if self._verify_options("Camera"):
            self.render_options.camera_name = name
            self.render_options.camera_params = params
            self.render_options.camera_to_world = self.ctm[0].inverse()
            self.render_options.camera_to_world_end = self.ctm[1].inverse() if self.ctm[0].m is not self.ctm[1].m and not np.allclose(self.ctm[0].m, self.ctm[1].m) else None
            self.render_options.camera_medium = self.graphics_state.current_outside_medium
            self.named_coordinate_systems["camera"] = [self.ctm[0].inverse(), self.ctm[1].inverse()]

    def sampler(self, name, params: ParamSet):
        if self._verify_options("Sampler"):
            self.render_options.sampler_name = name
            self.render_options.sampler_params = params

    def film(self, name, params: ParamSet):
        if self._verify_options("Film"):
            self.render_options.film_name = name
            self.render_options.film_params = params

    def pixel_filter(self, name, params: ParamSet):
        if self._verify_options("PixelFilter"):
            self.render_options.filter_name = name
            self.render_options.filter_params = params

    def integrator(self, name, params: ParamSet):
        if self._verify_options("Integrator"):
            self.render_options.integrator_name = name
            self.render_options.integrator_params = params

    def accelerator(self, name, params: ParamSet):
        if self._verify_options("Accelerator"):
            self.render_options.accelerator_name = name
            self.render_options.accelerator_params = params

    def make_named_medium(self, name, params: ParamSet):
        self._verify_initialized("MakeNamedMedium")
        mtype = params.find_one_string("type", "")
        self.render_options.named_media[name] = {"type": mtype, "params": params, "medium_to_world": self.ctm[0]}
        if mtype not in ("", "homogeneous", "heterogeneous"):
            log.warning("medium type '%s' unknown", mtype)

    def medium_interface(self, inside, outside=""):
        self._verify_initialized("MediumInterface")
        self.graphics_state.current_inside_medium = inside
        self.graphics_state.current_outside_medium = outside
        self.render_options.have_scattering_media = True

    # -- world block --------------------------------------------------------
    def world_begin(self):
        if self._verify_options("WorldBegin"):
            self.state = _STATE_WORLD
            self.ctm = [Transform(), Transform()]
            self.active_transform_bits = ALL_TRANSFORM_BITS
            self.named_coordinate_systems["world"] = [Transform(), Transform()]

    def attribute_begin(self):
        if self._verify_world("AttributeBegin"):
            self.pushed_graphics_states.append(self.graphics_state.clone())
            self.pushed_transforms.append(list(self.ctm))
            self.pushed_active_transform_bits.append(self.active_transform_bits)

    def attribute_end(self):
        if self._verify_world("AttributeEnd"):
            if not self.pushed_graphics_states:
                log.error("unmatched AttributeEnd ignored")
                return
            self.graphics_state = self.pushed_graphics_states.pop()
            self.ctm = self.pushed_transforms.pop()
            self.active_transform_bits = self.pushed_active_transform_bits.pop()

    def reverse_orientation(self):
        if self._verify_world("ReverseOrientation"):
            self.graphics_state.reverse_orientation = not self.graphics_state.reverse_orientation

    # -- textures -----------------------------------------------------------
    def texture(self, name, tex_type, tex_class, params: ParamSet):
        if not self._verify_world("Texture"):
            return
        tp = TextureParams(params, ParamSet(), self.graphics_state.float_textures, self.graphics_state.spectrum_textures)
        is_float = tex_type == "float"
        tex = self._make_texture(tex_class, tp, is_float)
        if tex is None:
            return
        if is_float:
            if name in self.graphics_state.float_textures:
                log.warning("float texture '%s' being redefined", name)
            self.graphics_state.float_textures[name] = tex
        elif tex_type in ("color", "spectrum"):
            if name in self.graphics_state.spectrum_textures:
                log.warning("spectrum texture '%s' being redefined", name)
            self.graphics_state.spectrum_textures[name] = tex
        else:
            log.error("texture type '%s' unknown", tex_type)

    def _mapping_params(self, tex: HostTexture, tp: TextureParams):
        tex.mapping = tp.find_one_string("mapping", "uv")
        tex.uscale = tp.find_one_float("uscale", 1.0)
        tex.vscale = tp.find_one_float("vscale", 1.0)
        tex.udelta = tp.find_one_float("udelta", 0.0)
        tex.vdelta = tp.find_one_float("vdelta", 0.0)
        tex.v1 = np.asarray(tp.geom.find_one_vector3("v1", [1.0, 0.0, 0.0]))
        tex.v2 = np.asarray(tp.geom.find_one_vector3("v2", [0.0, 1.0, 0.0]))
        tex.world_to_texture = self.ctm[0].inverse()

    def _make_texture(self, tex_class, tp: TextureParams, is_float):
        def child(name, default):
            if is_float:
                return tp.get_float_texture(name, default)
            return tp.get_spectrum_texture(name, [default] * 3)

        t = HostTexture(kind=tex_class, is_float=is_float)
        if tex_class == "constant":
            src = child("value", 1.0)
            t.value = np.atleast_1d(np.asarray(src[1], dtype=np.float64)) if src[0] == "const" else np.array([1.0])
            t.kind = "constant"
        elif tex_class == "scale":
            t.tex1 = child("tex1", 1.0)
            t.tex2 = child("tex2", 1.0)
        elif tex_class == "mix":
            t.tex1 = child("tex1", 0.0)
            t.tex2 = child("tex2", 1.0)
            t.amount = tp.get_float_texture("amount", 0.5)
        elif tex_class == "checkerboard":
            t.dimension = tp.find_one_int("dimension", 2)
            t.tex1 = child("tex1", 1.0)
            t.tex2 = child("tex2", 0.0)
            t.aa_mode = tp.find_one_string("aamode", "closedform")
            self._mapping_params(t, tp)
        elif tex_class == "imagemap":
            fname = tp.find_one_filename("filename")
            t.wrap = tp.find_one_string("wrap", "repeat")
            t.scale = tp.find_one_float("scale", 1.0)
            t.trilinear = tp.find_one_bool("trilinear", False)
            t.max_aniso = tp.find_one_float("maxanisotropy", 8.0)
            default_gamma = fname.lower().endswith((".png", ".tga", ".jpg", ".jpeg", ".bmp"))
            gamma = tp.find_one_bool("gamma", default_gamma)
            try:
                t.image = imageio.read_image(fname, gamma=gamma)
            except (OSError, ValueError) as e:
                # fallback search path for assets missing from the scene's
                # own tree (PBRT_TPU_TEXTURE_PATH, colon-separated)
                loaded = False
                for root in os.environ.get("PBRT_TPU_TEXTURE_PATH", "").split(":"):
                    if not root:
                        continue
                    alt = os.path.join(root, os.path.basename(fname))
                    try:
                        t.image = imageio.read_image(alt, gamma=gamma)
                        log.warning("imagemap '%s' resolved from fallback '%s'", fname, alt)
                        loaded = True
                        break
                    except (OSError, ValueError):
                        continue
                if not loaded:
                    log.warning("imagemap '%s' unreadable (%s); using constant 0.5", fname, e)
                    t.kind = "constant"
                    t.value = np.array([0.5])
            self._mapping_params(t, tp)
        elif tex_class == "uv":
            self._mapping_params(t, tp)
        elif tex_class == "bilerp":
            t.tex1 = child("v00", 0.0)
            t.tex2 = child("v11", 1.0)
            # v01/v10 stored via amount slot pair in builder; keep params dict
            t.v01 = child("v01", 1.0)
            t.v10 = child("v10", 0.0)
            self._mapping_params(t, tp)
        elif tex_class == "dots":
            t.tex1 = child("inside", 1.0)
            t.tex2 = child("outside", 0.0)
            self._mapping_params(t, tp)
        elif tex_class in ("fbm", "wrinkled"):
            t.octaves = tp.find_one_int("octaves", 8)
            t.roughness = tp.find_one_float("roughness", 0.5)
            t.world_to_texture = self.ctm[0].inverse()
        elif tex_class == "marble":
            t.octaves = tp.find_one_int("octaves", 8)
            t.roughness = tp.find_one_float("roughness", 0.5)
            t.scale = tp.find_one_float("scale", 1.0)
            t.variation = tp.find_one_float("variation", 0.2)
            t.world_to_texture = self.ctm[0].inverse()
        elif tex_class == "windy":
            t.world_to_texture = self.ctm[0].inverse()
        else:
            log.warning("texture class '%s' unknown; using constant 0.5", tex_class)
            t.kind = "constant"
            t.value = np.array([0.5])
        return t

    # -- materials ----------------------------------------------------------
    def material(self, name, params: ParamSet):
        if not self._verify_world("Material"):
            return
        tp = TextureParams(ParamSet(), params, self.graphics_state.float_textures, self.graphics_state.spectrum_textures)
        self.graphics_state.current_material = self._make_material(name, tp)

    def make_named_material(self, name, params: ParamSet):
        if not self._verify_world("MakeNamedMaterial"):
            return
        mat_type = params.find_one_string("type", "")
        if not mat_type:
            log.error("MakeNamedMaterial: no parameter 'string type' found")
            return
        tp = TextureParams(ParamSet(), params, self.graphics_state.float_textures, self.graphics_state.spectrum_textures)
        self.graphics_state.named_materials[name] = self._make_material(mat_type, tp)

    def named_material(self, name):
        if not self._verify_world("NamedMaterial"):
            return
        mat = self.graphics_state.named_materials.get(name)
        if mat is None:
            log.error("NamedMaterial: unknown material '%s'", name)
            return
        self.graphics_state.current_material = mat

    def _make_material(self, name, tp: TextureParams) -> HostMaterial:
        """Factory dispatch (reference api.rs:595-787). Parameter defaults
        follow each material's create_* function in src/materials/."""
        m = HostMaterial(kind=name)
        p = m.params

        def spec(pname, default):
            src = tp.get_spectrum_texture(pname, default)
            if src is not None:
                p[pname] = src

        def flt(pname, default):
            src = tp.get_float_texture(pname, default)
            if src is not None:
                p[pname] = src

        if name in ("", "none"):
            m.kind = "none"
        elif name == "matte":
            spec("Kd", [0.5, 0.5, 0.5])
            flt("sigma", 0.0)
        elif name == "mirror":
            spec("Kr", [0.9, 0.9, 0.9])
        elif name == "glass":
            spec("Kr", [1.0, 1.0, 1.0])
            spec("Kt", [1.0, 1.0, 1.0])
            eta = tp.get_float_texture_or_none("eta")
            if eta is None:
                eta = tp.get_float_texture("index", 1.5)
            p["eta"] = eta
            flt("uroughness", 0.0)
            flt("vroughness", 0.0)
            p["remaproughness"] = ("const", tp.find_one_bool("remaproughness", True))
            p["distribution"] = ("const", tp.find_one_string("distribution", "trowbridgereitz"))
        elif name == "plastic":
            spec("Kd", [0.25, 0.25, 0.25])
            spec("Ks", [0.25, 0.25, 0.25])
            flt("roughness", 0.1)
            p["remaproughness"] = ("const", tp.find_one_bool("remaproughness", True))
            p["distribution"] = ("const", tp.find_one_string("distribution", "trowbridgereitz"))
        elif name == "metal":
            cu_eta, cu_k = copper_eta_k_rgb()
            spec("eta", list(cu_eta))
            spec("k", list(cu_k))
            flt("roughness", 0.01)
            ur = tp.get_float_texture_or_none("uroughness")
            vr = tp.get_float_texture_or_none("vroughness")
            if ur is not None:
                p["uroughness"] = ur
            if vr is not None:
                p["vroughness"] = vr
            p["remaproughness"] = ("const", tp.find_one_bool("remaproughness", True))
            p["distribution"] = ("const", tp.find_one_string("distribution", "trowbridgereitz"))
        elif name == "uber":
            spec("Kd", [0.25, 0.25, 0.25])
            spec("Ks", [0.25, 0.25, 0.25])
            spec("Kr", [0.0, 0.0, 0.0])
            spec("Kt", [0.0, 0.0, 0.0])
            flt("roughness", 0.1)
            ur = tp.get_float_texture_or_none("uroughness")
            vr = tp.get_float_texture_or_none("vroughness")
            if ur is not None:
                p["uroughness"] = ur
            if vr is not None:
                p["vroughness"] = vr
            eta = tp.get_float_texture_or_none("eta")
            if eta is None:
                eta = tp.get_float_texture("index", 1.5)
            p["eta"] = eta
            spec("opacity", [1.0, 1.0, 1.0])
            p["remaproughness"] = ("const", tp.find_one_bool("remaproughness", True))
            p["distribution"] = ("const", tp.find_one_string("distribution", "trowbridgereitz"))
        elif name == "substrate":
            spec("Kd", [0.5, 0.5, 0.5])
            spec("Ks", [0.5, 0.5, 0.5])
            flt("uroughness", 0.1)
            flt("vroughness", 0.1)
            p["remaproughness"] = ("const", tp.find_one_bool("remaproughness", True))
            p["distribution"] = ("const", tp.find_one_string("distribution", "trowbridgereitz"))
        elif name == "translucent":
            spec("Kd", [0.25, 0.25, 0.25])
            spec("Ks", [0.25, 0.25, 0.25])
            flt("roughness", 0.1)
            spec("reflect", [0.5, 0.5, 0.5])
            spec("transmit", [0.5, 0.5, 0.5])
            p["remaproughness"] = ("const", tp.find_one_bool("remaproughness", True))
            p["distribution"] = ("const", tp.find_one_string("distribution", "trowbridgereitz"))
        elif name == "mix":
            m1 = tp.find_one_string("namedmaterial1", "")
            m2 = tp.find_one_string("namedmaterial2", "")
            mat1 = self.graphics_state.named_materials.get(m1)
            mat2 = self.graphics_state.named_materials.get(m2)
            if mat1 is None or mat2 is None:
                log.error("mix material: named material missing; using matte")
                return copy.deepcopy(host.MATTE_DEFAULT)
            spec("amount", [0.5, 0.5, 0.5])
            p["material1"] = ("material", mat1)
            p["material2"] = ("material", mat2)
        elif name == "disney":
            # disney.rs create_disney_material parameter set
            spec("color", [0.5, 0.5, 0.5])
            flt("metallic", 0.0)
            eta = tp.get_float_texture_or_none("eta")
            p["eta"] = eta if eta is not None else ("const", 1.5)
            flt("roughness", 0.5)
            flt("speculartint", 0.0)
            flt("anisotropic", 0.0)
            flt("sheen", 0.0)
            flt("sheentint", 0.5)
            flt("clearcoat", 0.0)
            flt("clearcoatgloss", 1.0)
            flt("spectrans", 0.0)
            p["remaproughness"] = ("const", False)
        elif name in ("subsurface", "kdsubsurface"):
            # subsurface.rs / kdsubsurface.rs: scattering props + interface
            preset = tp.find_one_string("name", "")
            if preset:
                p["preset"] = ("const", preset)
            spec("sigma_a", [0.0011, 0.0024, 0.014])
            spec("sigma_s", [2.55, 3.21, 3.77])
            if name == "kdsubsurface":
                spec("Kd", [0.5, 0.5, 0.5])
                spec("mfp", [1.0, 1.0, 1.0])
            spec("Kr", [1.0, 1.0, 1.0])
            spec("Kt", [1.0, 1.0, 1.0])
            flt("scale", 1.0)
            flt("g", 0.0)
            eta = tp.get_float_texture_or_none("eta")
            if eta is None:
                eta = tp.get_float_texture("index", 1.33)
            p["eta"] = eta
            flt("uroughness", 0.0)
            flt("vroughness", 0.0)
            p["remaproughness"] = ("const", tp.find_one_bool("remaproughness", True))
            p["distribution"] = ("const", tp.find_one_string("distribution", "trowbridgereitz"))
        elif name == "fourier":
            # tabulated BSDF (SCATFUN file, loaded at scene compile)
            s = tp.find_one_filename("bsdffile", "")
            if s:
                p["bsdffile"] = ("const", s)
            spec("Kd", [0.5, 0.5, 0.5])
        elif name == "hair":
            # Marschner fiber model (materials/hair.rs create_hair_material
            # :604-651): sigma_a > color > melanin concentration precedence
            for key in ("sigma_a", "color"):
                src = tp.get_spectrum_texture(key, None)
                if src is not None:
                    p[key] = src
            for key in ("eumelanin", "pheomelanin"):
                src = tp.get_float_texture_or_none(key)
                if src is not None:
                    p[key] = src
            flt("eta", 1.55)
            flt("beta_m", 0.3)
            flt("beta_n", 0.3)
            flt("alpha", 2.0)
        else:
            log.warning("material '%s' unknown; using matte", name)
            return copy.deepcopy(host.MATTE_DEFAULT)

        bump = tp.get_float_texture_or_none("bumpmap")
        if bump is not None:
            m.bump_map = bump
        return m

    # -- lights -------------------------------------------------------------
    def light_source(self, name, params: ParamSet):
        if not self._verify_world("LightSource"):
            return
        light = self._make_light(name, params, self.ctm[0])
        if light is not None:
            self.render_options.lights.append(light)

    def area_light_source(self, name, params: ParamSet):
        if self._verify_world("AreaLightSource"):
            self.graphics_state.area_light = name
            self.graphics_state.area_light_params = params

    def _make_light(self, name, params: ParamSet, l2w: Transform) -> HostLight | None:
        if name == "point":
            i = params.find_one_rgb("I", [1.0, 1.0, 1.0]) * params.find_one_rgb("scale", [1.0, 1.0, 1.0])
            frm = params.find_one_point3("from", [0.0, 0.0, 0.0])
            return HostLight(kind="point", light_to_world=l2w, intensity=i, from_point=l2w.xpoint(frm))
        if name == "spot":
            i = params.find_one_rgb("I", [1.0, 1.0, 1.0]) * params.find_one_rgb("scale", [1.0, 1.0, 1.0])
            frm = params.find_one_point3("from", [0.0, 0.0, 0.0])
            to = params.find_one_point3("to", [0.0, 0.0, 1.0])
            return HostLight(
                kind="spot",
                light_to_world=l2w,
                intensity=i,
                from_point=l2w.xpoint(frm),
                to_point=l2w.xpoint(to),
                cone_angle=params.find_one_float("coneangle", 30.0),
                cone_delta=params.find_one_float("conedeltaangle", 5.0),
            )
        if name == "distant":
            i = params.find_one_rgb("L", [1.0, 1.0, 1.0]) * params.find_one_rgb("scale", [1.0, 1.0, 1.0])
            frm = params.find_one_point3("from", [0.0, 0.0, 0.0])
            to = params.find_one_point3("to", [0.0, 0.0, 1.0])
            return HostLight(kind="distant", light_to_world=l2w, intensity=i, from_point=l2w.xpoint(frm), to_point=l2w.xpoint(to))
        if name in ("infinite", "exinfinite"):
            i = params.find_one_rgb("L", [1.0, 1.0, 1.0]) * params.find_one_rgb("scale", [1.0, 1.0, 1.0])
            map_name = params.find_one_filename("mapname", "")
            image = None
            if map_name:
                try:
                    image = imageio.read_image(map_name)
                except (OSError, ValueError) as e:
                    log.warning("infinite light map '%s' unreadable (%s)", map_name, e)
            return HostLight(
                kind="infinite",
                light_to_world=l2w,
                intensity=i,
                map_name=map_name,
                image=image,
                n_samples=params.find_one_int("samples", params.find_one_int("nsamples", 1)),
            )
        if name in ("goniometric", "projection"):
            i = params.find_one_rgb("I", [1.0, 1.0, 1.0]) * params.find_one_rgb("scale", [1.0, 1.0, 1.0])
            map_name = params.find_one_filename("mapname", "")
            image = None
            if map_name:
                try:
                    image = imageio.read_image(map_name)
                except (OSError, ValueError) as e:
                    log.warning("%s light map '%s' unreadable (%s)", name, map_name, e)
            return HostLight(
                kind=name,
                light_to_world=l2w,
                intensity=i,
                map_name=map_name,
                image=image,
                cone_angle=params.find_one_float("fov", 45.0),
            )
        log.error("light '%s' unknown", name)
        return None

    # -- shapes -------------------------------------------------------------
    def shape(self, name, params: ParamSet):
        if not self._verify_world("Shape"):
            return
        prims = []
        shapes = self._make_shapes(name, params)
        if not shapes:
            return
        # motion blur (transform.rs AnimatedTransform, decompose :1442 +
        # slerp, applied per-ray by TransformedPrimitive::intersect).
        # Rotating CTMs evaluate the EXACT per-ray decompose+slerp on
        # device (device/motion.py; builder group tables from `anim`
        # below); the baked keyframes remain as (a) the exact linear path
        # for translation-only motion and (b) the bounds source.
        if not np.allclose(self.ctm[0].m, self.ctm[1].m):
            from ..core.transform import AnimatedTransform, Transform as _T

            rel = self.ctm[1] @ self.ctm[0].inverse()
            anim = AnimatedTransform(_T(), rel, 0.0, 1.0)
            mid = anim.interpolate(0.5)
            # absolute keyframe pair for the EXACT per-ray TRS path
            # (device/motion.py; transform.rs decomposes M0 AND M1 — the
            # identity->rel parametrization above is only the fallback /
            # bounds source)
            key_pair = (np.asarray(self.ctm[0].m, np.float64).copy(),
                        np.asarray(self.ctm[1].m, np.float64).copy())
            for sh in shapes:
                if sh.mesh is not None:
                    p0 = np.asarray(sh.mesh.p, dtype=np.float64).reshape(-1, 3)
                    sh.mesh.p_end = rel.xpoint(p0)
                    sh.mesh.p_mid = mid.xpoint(p0)
                    sh.mesh.anim = key_pair
                elif sh.sphere is not None:
                    sh.sphere.object_to_world_end = rel @ sh.sphere.object_to_world
                    sh.sphere.object_to_world_mid = mid @ sh.sphere.object_to_world
                    sh.sphere.anim = key_pair
        area_light_template = None
        if self.graphics_state.area_light:
            alp = self.graphics_state.area_light_params
            area_light_template = HostLight(
                kind="area",
                light_to_world=self.ctm[0],
                intensity=alp.find_one_rgb("L", [1.0, 1.0, 1.0]) * alp.find_one_rgb("scale", [1.0, 1.0, 1.0]),
                two_sided=alp.find_one_bool("twosided", False),
                n_samples=alp.find_one_int("samples", alp.find_one_int("nsamples", 1)),
            )
        for sh in shapes:
            prims.append(
                HostPrimitive(
                    shape=sh,
                    material=self.graphics_state.current_material,
                    area_light=copy.copy(area_light_template) if area_light_template is not None else None,
                    inside_medium=self.graphics_state.current_inside_medium,
                    outside_medium=self.graphics_state.current_outside_medium,
                )
            )
        if self.render_options.current_instance is not None:
            if area_light_template is not None:
                log.warning("area lights not supported with object instancing")
            self.render_options.instances[self.render_options.current_instance].extend(prims)
        else:
            self.render_options.primitives.extend(prims)
        params.report_unused(f"Shape {name}")

    def _make_shapes(self, name, params: ParamSet) -> list[ShapeRecord]:
        o2w = self.ctm[0]
        rev = self.graphics_state.reverse_orientation
        if name == "sphere":
            return [
                ShapeRecord(
                    sphere=Sphere(
                        object_to_world=o2w,
                        radius=params.find_one_float("radius", 1.0),
                        z_min=params.find_one_float("zmin", -params.find_one_float("radius", 1.0)),
                        z_max=params.find_one_float("zmax", params.find_one_float("radius", 1.0)),
                        phi_max=math.radians(np.clip(params.find_one_float("phimax", 360.0), 0.0, 360.0)),
                        reverse_orientation=rev,
                    )
                )
            ]
        if name == "trianglemesh":
            return self._make_trianglemesh(params, o2w, rev)
        if name == "plymesh":
            fname = params.find_one_filename("filename")
            try:
                data = read_ply(fname)
            except (OSError, ValueError) as e:
                log.error("plymesh '%s' unreadable: %s", fname, e)
                return []
            mesh = TriangleMesh(
                p=o2w.xpoint(data["p"]),
                indices=data["indices"],
                n=_normed(o2w.xnormal(data["n"])) if "n" in data else None,
                uv=data.get("uv"),
                reverse_orientation=rev,
                transform_swaps_handedness=o2w.swaps_handedness(),
            )
            return [ShapeRecord(mesh=mesh)]
        if name == "disk":
            # analytic disk rows (disk.rs); tessellation retired per the
            # round-1 review (curved-reflector/area-light accuracy)
            return [
                ShapeRecord(
                    sphere=Sphere(
                        kind="disk",
                        object_to_world=o2w,
                        radius=params.find_one_float("radius", 1.0),
                        height=params.find_one_float("height", 0.0),
                        inner_radius=params.find_one_float("innerradius", 0.0),
                        phi_max=math.radians(np.clip(params.find_one_float("phimax", 360.0), 0.0, 360.0)),
                        reverse_orientation=rev,
                    )
                )
            ]
        if name == "cylinder":
            return [
                ShapeRecord(
                    sphere=Sphere(
                        kind="cylinder",
                        object_to_world=o2w,
                        radius=params.find_one_float("radius", 1.0),
                        z_min=params.find_one_float("zmin", -1.0),
                        z_max=params.find_one_float("zmax", 1.0),
                        phi_max=math.radians(np.clip(params.find_one_float("phimax", 360.0), 0.0, 360.0)),
                        reverse_orientation=rev,
                    )
                )
            ]
        if name == "cone":
            return [
                ShapeRecord(
                    sphere=Sphere(
                        kind="cone",
                        object_to_world=o2w,
                        radius=params.find_one_float("radius", 1.0),
                        height=params.find_one_float("height", 1.0),
                        phi_max=math.radians(np.clip(params.find_one_float("phimax", 360.0), 0.0, 360.0)),
                        reverse_orientation=rev,
                    )
                )
            ]
        if name == "__cone_tessellated":
            return [
                ShapeRecord(
                    mesh=host.tessellate_cone(
                        o2w,
                        params.find_one_float("height", 1.0),
                        params.find_one_float("radius", 1.0),
                        math.radians(np.clip(params.find_one_float("phimax", 360.0), 0.0, 360.0)),
                        rev,
                    )
                )
            ]
        if name == "paraboloid":
            return [
                ShapeRecord(
                    sphere=Sphere(
                        kind="paraboloid",
                        object_to_world=o2w,
                        radius=params.find_one_float("radius", 1.0),
                        z_min=params.find_one_float("zmin", 0.0),
                        z_max=params.find_one_float("zmax", 1.0),
                        phi_max=math.radians(np.clip(params.find_one_float("phimax", 360.0), 0.0, 360.0)),
                        reverse_orientation=rev,
                    )
                )
            ]
        if name == "hyperboloid":
            phimax_h = math.radians(np.clip(params.find_one_float("phimax", 360.0), 0.0, 360.0))
            p1_h = params.find_one_point3("p1", [0.0, 0.0, 0.0])
            p2_h = params.find_one_point3("p2", [1.0, 1.0, 1.0])
            # analytic quadric (hyperboloid.rs), full AND partial phimax —
            # the intersect clip measures phi against the twisted frame
            # (intersect.ray_quadric)
            return [
                ShapeRecord(
                    sphere=Sphere(
                        kind="hyperboloid",
                        object_to_world=o2w,
                        p1=np.asarray(p1_h, np.float64),
                        p2=np.asarray(p2_h, np.float64),
                        phi_max=phimax_h,
                        reverse_orientation=rev,
                    )
                )
            ]
        if name == "heightfield":
            from ..scene.tessellate import tessellate_heightfield

            nu = params.find_one_int("nu", -1)
            nv = params.find_one_int("nv", -1)
            pz = params.find_floats("Pz")
            if nu <= 0 or nv <= 0 or pz is None or len(pz) != nu * nv:
                log.error("heightfield: need nu, nv and nu*nv 'Pz' values")
                return []
            return [ShapeRecord(mesh=tessellate_heightfield(o2w, nu, nv, pz, rev))]
        if name == "loopsubdiv":
            from ..scene.tessellate import loop_subdivide

            levels = params.find_one_int("levels", params.find_one_int("nlevels", 3))
            indices = params.find_ints("indices")
            p = params.find_point3s("P")
            if indices is None or p is None:
                log.error("loopsubdiv: missing 'indices' or 'P'")
                return []
            return [ShapeRecord(mesh=loop_subdivide(o2w, levels, indices, p, rev))]
        if name == "curve":
            from ..scene.tessellate import tessellate_curve

            p = params.find_point3s("P")
            if p is None or len(p) < 4:
                log.error("curve: need >= 4 'P' control points")
                return []
            ctype = params.find_one_string("type", "flat")
            width = params.find_one_float("width", 1.0)
            w0 = params.find_one_float("width0", width)
            w1 = params.find_one_float("width1", width)
            degree = 3
            nseg = (len(p) - 1) // degree
            norms = params.find_normals("N")
            out = []
            for s in range(max(nseg, 1)):
                cp = p[s * degree : s * degree + 4]
                if len(cp) < 4:
                    break
                u0 = s / max(nseg, 1)
                u1 = (s + 1) / max(nseg, 1)
                ws0 = (1 - u0) * w0 + u0 * w1
                ws1 = (1 - u1) * w0 + u1 * w1
                seg_norms = None
                if norms is not None and len(norms) >= nseg + 1:
                    seg_norms = (norms[s], norms[s + 1])
                out.append(ShapeRecord(mesh=tessellate_curve(o2w, cp, ws0, ws1, ctype, seg_norms, reverse_orientation=rev)))
            return out
        if name == "nurbs":
            from ..scene.tessellate import tessellate_nurbs

            nu = params.find_one_int("nu", -1)
            nv = params.find_one_int("nv", -1)
            uorder = params.find_one_int("uorder", -1)
            vorder = params.find_one_int("vorder", -1)
            uknots = params.find_floats("uknots")
            vknots = params.find_floats("vknots")
            if min(nu, nv, uorder, vorder) <= 0 or uknots is None or vknots is None:
                log.error("nurbs: need nu/nv/uorder/vorder/uknots/vknots")
                return []
            u0 = params.find_one_float("u0", float(uknots[uorder - 1]))
            u1 = params.find_one_float("u1", float(uknots[nu]))
            v0 = params.find_one_float("v0", float(vknots[vorder - 1]))
            v1 = params.find_one_float("v1", float(vknots[nv]))
            p = params.find_point3s("P")
            pw = params.find_floats("Pw")
            if p is None and pw is None:
                log.error("nurbs: need 'P' or 'Pw'")
                return []
            return [ShapeRecord(mesh=tessellate_nurbs(o2w, nu, uorder, uknots, u0, u1, nv, vorder, vknots, v0, v1, p, pw, rev))]
        log.error("shape '%s' unknown", name)
        return []

    def _make_trianglemesh(self, params: ParamSet, o2w: Transform, rev) -> list[ShapeRecord]:
        indices = params.find_ints("indices")
        p = params.find_point3s("P")
        if indices is None or p is None:
            log.error("trianglemesh: missing 'indices' or 'P'")
            return []
        if len(indices) % 3 != 0:
            log.error("trianglemesh: index count %d not multiple of 3", len(indices))
            return []
        n = params.find_normals("N")
        s = params.find_vector3s("S")
        uv = params.find_point2s("uv")
        if uv is None:
            uv = params.find_point2s("st")
        if uv is None:
            fuv = params.find_floats("uv")
            if fuv is None:
                fuv = params.find_floats("st")
            if fuv is not None:
                uv = np.asarray(fuv, dtype=np.float64).reshape(-1, 2)
        # alpha / shadow-alpha cutout masks (triangle.rs:728-755): texture
        # by name, or a constant-0 float makes the mesh fully cut out
        def _alpha_tex(pname):
            tex = params.find_texture_name(pname)
            if tex is not None:
                t = self.graphics_state.float_textures.get(tex)
                if t is None:
                    log.error("couldn't find float texture '%s' for '%s'", tex, pname)
                return t
            fval = params.find_one_float(pname, 1.0)
            if fval == 0.0:
                from ..scene.host import HostTexture

                return HostTexture(kind="constant", is_float=True, value=np.array([0.0]))
            return None

        alpha = _alpha_tex("alpha")
        shadow_alpha = _alpha_tex("shadowalpha")
        mesh = TriangleMesh(
            p=o2w.xpoint(p),
            indices=np.asarray(indices, dtype=np.int32).reshape(-1, 3),
            n=_normed(o2w.xnormal(n)) if n is not None else None,
            s=o2w.xvector(s) if s is not None else None,
            uv=uv,
            alpha_texture=alpha,
            shadow_alpha_texture=shadow_alpha,
            reverse_orientation=rev,
            transform_swaps_handedness=o2w.swaps_handedness(),
        )
        return [ShapeRecord(mesh=mesh)]

    # -- instancing (reference api.rs:1630-1713) ----------------------------
    def object_begin(self, name):
        if self._verify_world("ObjectBegin"):
            self.attribute_begin()
            if self.render_options.current_instance is not None:
                log.error("ObjectBegin called inside of instance definition")
            self.render_options.instances[name] = []
            self.render_options.current_instance = name

    def object_end(self):
        if self._verify_world("ObjectEnd"):
            if self.render_options.current_instance is None:
                log.error("ObjectEnd called outside of instance definition")
            self.render_options.current_instance = None
            self.attribute_end()

    def object_instance(self, name):
        if not self._verify_world("ObjectInstance"):
            return
        if self.render_options.current_instance is not None:
            log.error("ObjectInstance can't be called inside instance definition")
            return
        prims = self.render_options.instances.get(name)
        if prims is None:
            log.error("unable to find instance named '%s'", name)
            return
        # Instance reuse (reference TransformedPrimitive, api.rs:1672-1710):
        # meshes are SHARED between instances — the prim references the
        # prototype's vertex rows and carries the instance transform, so N
        # instances of a mesh cost N prim-row sets, not N vertex copies.
        # Quadrics compose the transform into their o2w (zero extra memory).
        i2w = self.ctm[0]
        identity = i2w.is_identity() if hasattr(i2w, "is_identity") else False
        for prim in prims:
            if prim.shape.mesh is not None and not identity:
                self.render_options.primitives.append(
                    HostPrimitive(
                        shape=prim.shape,  # shared prototype mesh
                        material=prim.material,
                        area_light=prim.area_light,
                        inside_medium=prim.inside_medium,
                        outside_medium=prim.outside_medium,
                        instance_transform=i2w,
                    )
                )
            else:
                self.render_options.primitives.append(_transform_primitive(prim, i2w))

    # -- finish -------------------------------------------------------------
    def world_end(self):
        if not self._verify_world("WorldEnd"):
            return
        while self.pushed_graphics_states:
            log.warning("missing AttributeEnd")
            self.pushed_graphics_states.pop()
            self.pushed_transforms.pop()
            self.pushed_active_transform_bits.pop()
        self.scene = self._build_scene_description()
        self.state = _STATE_OPTIONS
        self.ctm = [Transform(), Transform()]
        self.active_transform_bits = ALL_TRANSFORM_BITS
        self.named_coordinate_systems.clear()

    def _build_scene_description(self) -> SceneDescription:
        ro = self.render_options
        opts = self.options

        fp = ro.film_params
        xres = fp.find_one_int("xresolution", 1280)
        yres = fp.find_one_int("yresolution", 720)
        if opts.quick_render:
            xres = max(1, xres // 4)
            yres = max(1, yres // 4)
        crop = opts.crop_window
        if crop is None:
            cw = fp.find_floats("cropwindow")
            crop = tuple(cw) if cw is not None and len(cw) == 4 else (0.0, 1.0, 0.0, 1.0)
        filename = opts.image_file or fp.find_one_string("filename", "pbrt.exr")
        flp = ro.filter_params
        film = FilmConfig(
            x_resolution=xres,
            y_resolution=yres,
            crop_window=crop,
            filename=filename,
            scale=fp.find_one_float("scale", 1.0),
            diagonal=fp.find_one_float("diagonal", 35.0),
            max_sample_luminance=fp.find_one_float("maxsampleluminance", float("inf")),
            filter_name=ro.filter_name,
            filter_params={
                "xwidth": flp.find_one_float("xwidth", _default_filter_width(ro.filter_name)),
                "ywidth": flp.find_one_float("ywidth", _default_filter_width(ro.filter_name)),
                "alpha": flp.find_one_float("alpha", 2.0),
                "B": flp.find_one_float("B", 1.0 / 3.0),
                "C": flp.find_one_float("C", 1.0 / 3.0),
                "tau": flp.find_one_float("tau", 3.0),
            },
        )

        cp = ro.camera_params
        aspect = cp.find_one_float("frameaspectratio", xres / yres)
        sw = cp.find_floats("screenwindow")
        if sw is not None and len(sw) == 4:
            screen = (sw[0], sw[1], sw[2], sw[3])
        elif aspect > 1.0:
            screen = (-aspect, aspect, -1.0, 1.0)
        else:
            screen = (-1.0, 1.0, -1.0 / aspect, 1.0 / aspect)
        camera = CameraConfig(
            kind=ro.camera_name,
            camera_to_world=ro.camera_to_world,
            camera_to_world_end=ro.camera_to_world_end,
            fov=cp.find_one_float("fov", 90.0),
            lens_radius=cp.find_one_float("lensradius", 0.0),
            focal_distance=cp.find_one_float("focaldistance", 1e6),
            shutter_open=cp.find_one_float("shutteropen", 0.0),
            shutter_close=cp.find_one_float("shutterclose", 1.0),
            screen_window=screen,
            lens_file=cp.find_one_filename("lensfile", ""),
            aperture_diameter=cp.find_one_float("aperturediameter", 1.0),
            focus_distance=cp.find_one_float("focusdistance", 10.0),
            simple_weighting=cp.find_one_bool("simpleweighting", True),
        )

        sp = ro.sampler_params
        sampler_name = {"lowdiscrepancy": "zerotwosequence", "02sequence": "zerotwosequence"}.get(
            ro.sampler_name, ro.sampler_name
        )
        x_samples = sp.find_one_int("xsamples", 4)
        y_samples = sp.find_one_int("ysamples", 4)
        if sampler_name == "stratified":
            # stratified.rs:121-131: spp = xsamples * ysamples (there is no
            # "pixelsamples" parameter on the reference's stratified sampler)
            pixel_samples = x_samples * y_samples
        else:
            pixel_samples = sp.find_one_int("pixelsamples", 16)
        if opts.quick_render:
            pixel_samples = max(1, pixel_samples // 4)
        sampler = SamplerConfig(
            kind=sampler_name,
            pixel_samples=pixel_samples,
            jitter=sp.find_one_bool("jitter", True),
            x_samples=x_samples,
            y_samples=y_samples,
            sampled_dimensions=sp.find_one_int("dimensions", 4),
        )
        if sp.find_one_int("dimensions", 4) != 4:
            log.info("sampler \"dimensions\" has no effect: stateless hash "
                     "samplers generate every dimension on demand")

        ip = ro.integrator_params
        pb = ip.find_ints("pixelbounds")
        integrator = IntegratorConfig(
            kind=ro.integrator_name,
            max_depth=ip.find_one_int("maxdepth", 5),
            rr_threshold=ip.find_one_float("rrthreshold", 1.0),
            light_strategy=ip.find_one_string("lightsamplestrategy", "spatial"),
            strategy=ip.find_one_string("strategy", "all"),
            pixel_bounds=tuple(pb) if pb is not None and len(pb) == 4 else None,
            cos_sample=ip.find_one_bool("cossample", True),
            n_samples=ip.find_one_int("nsamples", 64),
            num_iterations=ip.find_one_int("numiterations", ip.find_one_int("iterations", 64)),
            photons_per_iteration=ip.find_one_int("photonsperiteration", -1),
            initial_radius=ip.find_one_float("radius", 1.0),
            write_frequency=ip.find_one_int("imagewritefrequency", 1 << 31),
            visualize_strategies=ip.find_one_bool("visualizestrategies", False),
            visualize_weights=ip.find_one_bool("visualizeweights", False),
            mutations_per_pixel=ip.find_one_int("mutationsperpixel", 100),
            large_step_probability=ip.find_one_float("largestepprobability", 0.3),
            sigma=ip.find_one_float("sigma", 0.01),
            n_bootstrap=ip.find_one_int("bootstrapsamples", 100000),
            n_chains=ip.find_one_int("chains", 1000),
        )

        return SceneDescription(
            primitives=list(ro.primitives),
            lights=list(ro.lights),
            camera=camera,
            film=film,
            sampler=sampler,
            integrator=integrator,
            accelerator=ro.accelerator_name,
            accelerator_params={
                "maxnodeprims": ro.accelerator_params.find_one_int("maxnodeprims", 4),
                "splitmethod": ro.accelerator_params.find_one_string("splitmethod", "sah"),
            },
            media=_build_media(ro.named_media),
            camera_medium=ro.camera_medium,
            transform_start_time=ro.transform_start_time,
            transform_end_time=ro.transform_end_time,
        )


# Named scattering presets: sigma_prime_s / sigma_a in mm^-1 from the
# measured-media table the reference exposes via
# get_medium_scattering_properties (src/core/medium.rs:81; data from
# Jensen et al. 2001 / Narasimhan et al. 2006, public pbrt constants).
MEDIUM_PRESETS = {
    "Apple": ([2.29, 2.39, 1.97], [0.0030, 0.0034, 0.046]),
    "Chicken1": ([0.15, 0.21, 0.38], [0.015, 0.077, 0.19]),
    "Chicken2": ([0.19, 0.25, 0.32], [0.018, 0.088, 0.20]),
    "Cream": ([7.38, 5.47, 3.15], [0.0002, 0.0028, 0.0163]),
    "Ketchup": ([0.18, 0.07, 0.03], [0.061, 0.97, 1.45]),
    "Marble": ([2.19, 2.62, 3.00], [0.0021, 0.0041, 0.0071]),
    "Potato": ([0.68, 0.70, 0.55], [0.0024, 0.0090, 0.12]),
    "Skimmilk": ([0.70, 1.22, 1.90], [0.0014, 0.0025, 0.0142]),
    "Skin1": ([0.74, 0.88, 1.01], [0.032, 0.17, 0.48]),
    "Skin2": ([1.09, 1.59, 1.79], [0.013, 0.070, 0.145]),
    "Spectralon": ([11.6, 20.4, 14.9], [0.00, 0.00, 0.00]),
    "Wholemilk": ([2.55, 3.21, 3.77], [0.0011, 0.0024, 0.014]),
    "Lowfat Milk": ([0.89187, 1.5136, 2.532], [0.002875, 0.00575, 0.0115]),
    "Regular Milk": ([2.4858, 3.1669, 4.5214], [0.0001153, 0.0001964, 0.026]),
}


def _build_media(named_media: dict) -> dict:
    """named_media (raw directive records) -> {name: HostMedium}."""
    from ..scene.host import HostMedium

    out = {}
    for name, rec in named_media.items():
        params: ParamSet = rec["params"]
        mtype = rec["type"]
        preset = params.find_one_string("preset", "")
        sig_a = np.array([1.0, 1.0, 1.0])
        sig_s = np.array([1.0, 1.0, 1.0])
        if preset:
            if preset in MEDIUM_PRESETS:
                sp, sa = MEDIUM_PRESETS[preset]
                # table stores sigma' in mm^-1; pbrt scales to m^-1 (x100... the
                # reference uses the values as-is in scene units)
                sig_s = np.asarray(sp, dtype=np.float64)
                sig_a = np.asarray(sa, dtype=np.float64)
            else:
                log.warning("medium preset '%s' unknown; using defaults", preset)
        sig_a = params.find_one_rgb("sigma_a", sig_a)
        sig_s = params.find_one_rgb("sigma_s", sig_s)
        scale = params.find_one_float("scale", 1.0)
        g = params.find_one_float("g", 0.0)
        m = HostMedium(
            kind="heterogeneous" if mtype == "heterogeneous" else "homogeneous",
            sigma_a=np.asarray(sig_a, dtype=np.float64) * scale,
            sigma_s=np.asarray(sig_s, dtype=np.float64) * scale,
            g=g,
            scale=scale,
            medium_to_world=rec["medium_to_world"],
        )
        if m.kind == "heterogeneous":
            nx = params.find_one_int("nx", 1)
            ny = params.find_one_int("ny", 1)
            nz = params.find_one_int("nz", 1)
            dens = params.find_floats("density")
            if dens is None or len(dens) != nx * ny * nz:
                log.error("heterogeneous medium '%s': need nx*ny*nz density values", name)
                continue
            m.nx, m.ny, m.nz = nx, ny, nz
            m.density = np.asarray(dens, dtype=np.float64).reshape(nz, ny, nx)
            m.p0 = np.asarray(params.find_one_point3("p0", [0.0, 0.0, 0.0]), dtype=np.float64)
            m.p1 = np.asarray(params.find_one_point3("p1", [1.0, 1.0, 1.0]), dtype=np.float64)
        out[name] = m
        params.report_unused(f"MakeNamedMedium {name}")
    return out


def _normed(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)


def _default_filter_width(name):
    return {"box": 0.5, "triangle": 2.0, "gaussian": 2.0, "mitchell": 2.0, "sinc": 4.0}.get(name, 0.5)


def _transform_primitive(prim: HostPrimitive, i2w: Transform) -> HostPrimitive:
    sh = prim.shape
    if sh.mesh is not None:
        mesh = sh.mesh
        new_mesh = TriangleMesh(
            p=i2w.xpoint(mesh.p),
            indices=mesh.indices,
            n=_normed(i2w.xnormal(mesh.n)) if mesh.n is not None else None,
            s=i2w.xvector(mesh.s) if mesh.s is not None else None,
            uv=mesh.uv,
            alpha_texture=mesh.alpha_texture,
            reverse_orientation=mesh.reverse_orientation,
            transform_swaps_handedness=mesh.transform_swaps_handedness ^ i2w.swaps_handedness(),
        )
        new_shape = ShapeRecord(mesh=new_mesh)
    else:
        sph = sh.sphere
        new_shape = ShapeRecord(
            sphere=Sphere(
                object_to_world=i2w @ sph.object_to_world,
                radius=sph.radius,
                z_min=sph.z_min,
                z_max=sph.z_max,
                phi_max=sph.phi_max,
                reverse_orientation=sph.reverse_orientation,
                kind=getattr(sph, "kind", "sphere"),
                height=getattr(sph, "height", 0.0),
                inner_radius=getattr(sph, "inner_radius", 0.0),
            )
        )
    return HostPrimitive(
        shape=new_shape,
        material=prim.material,
        area_light=prim.area_light,
        inside_medium=prim.inside_medium,
        outside_medium=prim.outside_medium,
    )


def pbrt_parse(path, options: Options | None = None) -> SceneDescription:
    """Parse a scene file end to end (reference pbrtparser.rs:26)."""
    from .parser import parse

    api = API(options, search_dir=os.path.dirname(os.path.abspath(path)))
    api.init()
    parse(path, api)
    if api.scene is None:
        raise RuntimeError(f"{path}: no WorldEnd directive — nothing to render")
    return api.scene
