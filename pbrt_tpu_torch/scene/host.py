"""Host-side scene description objects.

The subset of ``pbrt_tpu/scene/host.py`` that the port's scene compiler
reads: the same plain records with the same fields and defaults, so a scene
built on these types compiles to the same tables as the reference's.
Quadrics other than full spheres, textures and media are not part of the
port yet (the compiler raises NotImplementedError on them).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..core.transform import Transform


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


@dataclass
class TriangleMesh:
    """World-space triangle mesh (reference src/shapes/triangle.rs:21-48)."""

    p: np.ndarray  # (V, 3) world-space positions
    indices: np.ndarray  # (T, 3) int32
    n: np.ndarray | None = None  # (V, 3) shading normals (world space)
    s: np.ndarray | None = None  # (V, 3) shading tangents
    uv: np.ndarray | None = None  # (V, 2)
    alpha_texture: object | None = None  # float texture: 0 => hit ignored
    shadow_alpha_texture: object | None = None  # same, for shadow rays
    reverse_orientation: bool = False
    transform_swaps_handedness: bool = False
    p_end: np.ndarray | None = None  # (V, 3) shutter-close positions (motion blur)
    p_mid: np.ndarray | None = None  # (V, 3) mid-shutter positions
    anim: tuple | None = None  # (M0, M1) 4x4 shutter keyframe CTMs


@dataclass
class Sphere:
    """Analytic quadric, kept parametric on device.

    kind selects the shape: "sphere" (src/shapes/sphere.rs), "cylinder"
    (cylinder.rs) or "disk" (disk.rs). height/inner_radius apply to disks
    only; z_min/z_max to spheres and cylinders. The port's compiler takes
    spheres only, in scenes of at most 64 prims; its megakernel renders
    full ones."""

    object_to_world: Transform
    radius: float = 1.0
    z_min: float = -1.0
    z_max: float = 1.0
    phi_max: float = 2.0 * math.pi  # radians
    reverse_orientation: bool = False
    object_to_world_end: Transform | None = None  # motion blur keyframe
    object_to_world_mid: Transform | None = None  # mid-shutter slerp sample
    anim: tuple | None = None  # (M0, M1) 4x4 shutter keyframe CTMs (exact path)
    kind: str = "sphere"
    height: float = 0.0
    inner_radius: float = 0.0
    # hyperboloid endpoints (hyperboloid.rs): the segment p1->p2 revolved
    # around z
    p1: np.ndarray | None = None
    p2: np.ndarray | None = None


# Shape record: exactly one of mesh/sphere is set.
@dataclass
class ShapeRecord:
    mesh: TriangleMesh | None = None
    sphere: Sphere | None = None


# ---------------------------------------------------------------------------
# Materials
# ---------------------------------------------------------------------------


@dataclass
class HostMaterial:
    """Material = type name + parameter sources.

    Each entry of ``params`` maps a parameter name to either
    ('const', value) or ('texture', texture) — the scene compiler turns
    these into fixed-width parameter rows (reference: each
    Material::compute_scattering_functions, src/materials/).
    """

    kind: str  # matte | mirror | glass | plastic | metal | uber | ... | none
    params: dict = field(default_factory=dict)
    bump_map: object = None  # float texture or None


# ---------------------------------------------------------------------------
# Lights
# ---------------------------------------------------------------------------


@dataclass
class HostLight:
    """One light source (reference src/lights/*)."""

    kind: str  # point | spot | distant | goniometric | projection | infinite | area
    light_to_world: Transform = field(default_factory=Transform)
    intensity: np.ndarray | None = None  # I or L (rgb)
    scale: np.ndarray | None = None
    # point / spot
    from_point: np.ndarray | None = None
    to_point: np.ndarray | None = None
    cone_angle: float = 30.0
    cone_delta: float = 5.0
    # infinite
    map_name: str = ""
    image: np.ndarray | None = None  # lat-long env map (H, W, 3)
    n_samples: int = 1
    # area
    two_sided: bool = False
    prim_index: int = -1  # filled in by the builder (first primitive of shape)


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


@dataclass
class HostPrimitive:
    """Geometric primitive: shape + material + optional area light
    (reference src/core/primitive.rs:105 GeometricPrimitive)."""

    shape: ShapeRecord
    material: HostMaterial
    area_light: HostLight | None = None
    inside_medium: str = ""
    outside_medium: str = ""
    instance_transform: object = None  # Transform | None


# ---------------------------------------------------------------------------
# Config records (camera / film / sampler / integrator / accelerator)
# ---------------------------------------------------------------------------


@dataclass
class FilmConfig:
    x_resolution: int = 1280
    y_resolution: int = 720
    crop_window: tuple = (0.0, 1.0, 0.0, 1.0)
    filename: str = "pbrt.exr"
    scale: float = 1.0
    diagonal: float = 35.0
    max_sample_luminance: float = float("inf")
    filter_name: str = "box"
    filter_params: dict = field(default_factory=dict)  # xwidth/ywidth/alpha/B/C/tau


@dataclass
class CameraConfig:
    kind: str = "perspective"
    camera_to_world: Transform = field(default_factory=Transform)
    camera_to_world_end: Transform | None = None  # animated camera (motion blur)
    fov: float = 90.0
    lens_radius: float = 0.0
    focal_distance: float = 1e6
    shutter_open: float = 0.0
    shutter_close: float = 1.0
    screen_window: tuple | None = None  # (x0, x1, y0, y1)


@dataclass
class SamplerConfig:
    kind: str = "halton"
    pixel_samples: int = 16
    jitter: bool = True
    x_samples: int = 4
    y_samples: int = 4
    sampled_dimensions: int = 4


@dataclass
class IntegratorConfig:
    kind: str = "path"
    max_depth: int = 5
    rr_threshold: float = 1.0
    light_strategy: str = "spatial"  # path/volpath lightsampling
    strategy: str = "all"  # directlighting: all|one
    pixel_bounds: tuple | None = None


@dataclass
class SceneDescription:
    """Everything the renderer needs, as plain host data."""

    primitives: list = field(default_factory=list)  # list[HostPrimitive]
    lights: list = field(default_factory=list)  # list[HostLight] (non-area)
    camera: CameraConfig = field(default_factory=CameraConfig)
    film: FilmConfig = field(default_factory=FilmConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    integrator: IntegratorConfig = field(default_factory=IntegratorConfig)
    accelerator: str = "bvh"
    accelerator_params: dict = field(default_factory=dict)
    media: dict = field(default_factory=dict)  # name -> medium
    camera_medium: str = ""  # medium the camera sits in
    transform_start_time: float = 0.0
    transform_end_time: float = 1.0
