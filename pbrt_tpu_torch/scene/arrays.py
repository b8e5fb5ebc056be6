"""SceneTensors: the flat SoA device representation of a scene, in torch.

The port's counterpart of ``pbrt_tpu/scene/arrays.py``: the same id
constants and the same table layouts, holding only the fields the ported
slices read: triangle meshes and full spheres, the material rows, the
light rows and, for scenes above the brute-force size, the wide BVH.

- ``SceneTensors``: torch tensors, all on one device.
- ``SceneStatic``: Python-level counts and flags that shape the program.

``scene_tensors_from_numpy`` is the one place tables cross from host arrays
to the device; the port's own compiler and the parity tests (which fill it
from a reference ``CompiledScene``) both go through it. It also derives,
once per scene, the wide BVH's Hopper layout (``HOPPER_TABLES``,
``widebvh.hopper_layout``) that the CUDA walks and their plain twin read;
every other table is the reference's, bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from .widebvh import hopper_layout

# geometry type ids
GEOM_TRI = 0
GEOM_SPHERE = 1  # any analytic quadric row (see QUADRIC_* for the sub-kind)

# quadric sub-kinds (sph_kind)
QUADRIC_SPHERE = 0

# material kind ids
MAT_NONE = 0
MAT_MATTE = 1
MAT_MIRROR = 2
MAT_GLASS = 3
MAT_PLASTIC = 4
MAT_METAL = 5
MAT_UBER = 6
MAT_SUBSTRATE = 7
MAT_TRANSLUCENT = 8
MAT_DISNEY = 9
MAT_MIX = 10
MAT_SUBSURFACE = 11
MAT_KDSUBSURFACE = 12
MAT_FOURIER = 13
MAT_HAIR = 14

MAT_IDS = {
    "none": MAT_NONE,
    "matte": MAT_MATTE,
    "mirror": MAT_MIRROR,
    "glass": MAT_GLASS,
    "plastic": MAT_PLASTIC,
    "metal": MAT_METAL,
    "uber": MAT_UBER,
    "substrate": MAT_SUBSTRATE,
    "translucent": MAT_TRANSLUCENT,
    "disney": MAT_DISNEY,
    "mix": MAT_MIX,
    "subsurface": MAT_SUBSURFACE,
    "kdsubsurface": MAT_KDSUBSURFACE,
    "fourier": MAT_FOURIER,
    "hair": MAT_HAIR,
}

# material parameter slots (each a vec3 + texture-id indirection)
P_KD = 0
P_SIGMA = 1
P_KR = 2
P_KT = 3
P_ETA = 4
P_K = 5
P_KS = 6
P_UROUGH = 7
P_VROUGH = 8
P_OPACITY = 9
P_REFLECT = 10
P_TRANSMIT = 11
P_EXTRA = 12
P_EXTRA2 = 13
N_MAT_PARAMS = 14

# light kind ids
LIGHT_POINT = 0
LIGHT_SPOT = 1
LIGHT_DISTANT = 2
LIGHT_INFINITE = 3
LIGHT_AREA = 4
LIGHT_GONIO = 5
LIGHT_PROJECTION = 6

# dtype of every table, as the reference stores it
_TABLE_DTYPES = {
    "tri_p": torch.float32,  # (T, 3, 3) vertex positions
    "tri_n": torch.float32,  # (T, 3, 3) shading normals (geometric if absent)
    "tri_uv": torch.float32,  # (T, 3, 2)
    "tri_prim_ids": torch.int32,  # (T,) triangle row -> prim row
    "sph_o2w": torch.float32,  # (S, 3, 4) quadric object -> world
    "sph_w2o": torch.float32,  # (S, 3, 4) world -> object
    "sph_param": torch.float32,  # (S, 12) sphere: radius, zmin, zmax, phimax, thetamin, thetamax
    "sph_kind": torch.int32,  # (S,) QUADRIC_*
    "sph_prim_ids": torch.int32,  # (S,) quadric row -> prim row
    "prim_kind": torch.int32,  # (P,) GEOM_*
    "prim_geom": torch.int32,  # (P,) row in tri_*
    "prim_mat": torch.int32,  # (P,) material row
    "prim_light": torch.int32,  # (P,) area light row or -1
    "prim_flags": torch.int32,  # (P,) bit0 flip ng, bit1 shading normals, bit2 reverse, bit3 uv
    "prim_area": torch.float32,  # (P,) surface area
    "mat_kind": torch.int32,  # (M,) MAT_*
    "mat_const": torch.float32,  # (M, N_MAT_PARAMS, 3)
    "mat_tex": torch.int32,  # (M, N_MAT_PARAMS) texture index or -1
    "mat_remap": torch.int32,  # (M,) bit0 remap roughness, bit1 Beckmann
    "light_kind": torch.int32,  # (L,) LIGHT_*
    "light_param": torch.float32,  # (L, 12): area L(3), two_sided; point/spot/distant see builder
    "light_prim": torch.int32,  # (L,) prim row of an area light
    "world_center": torch.float32,  # (3,)
    "world_radius": torch.float32,  # ()
}

# the wide-BVH tables: None for a brute-force scene, which has none
_WIDE_DTYPES = {
    "wnode_tab": torch.float32,  # (ceil(Nw/8)*8, 128) wide-BVH node boxes
    "wprim_tab": torch.float32,  # (ceil(n_oct/8)*8, 128) leaf triangles
    "wmeta_tab": torch.int32,  # (n_nodes*8,) packed child metas
    "wslot_prim": torch.int32,  # (n_oct*8,) kernel slot -> prim row
}
# derived from the wide tables above (widebvh.hopper_layout); not reference tables
HOPPER_TABLES = ("wnode_rec", "wleaf_rec")


@dataclass
class SceneTensors:
    tri_p: torch.Tensor
    tri_n: torch.Tensor
    tri_uv: torch.Tensor
    tri_prim_ids: torch.Tensor
    sph_o2w: torch.Tensor
    sph_w2o: torch.Tensor
    sph_param: torch.Tensor
    sph_kind: torch.Tensor
    sph_prim_ids: torch.Tensor
    prim_kind: torch.Tensor
    prim_geom: torch.Tensor
    prim_mat: torch.Tensor
    prim_light: torch.Tensor
    prim_flags: torch.Tensor
    prim_area: torch.Tensor
    mat_kind: torch.Tensor
    mat_const: torch.Tensor
    mat_tex: torch.Tensor
    mat_remap: torch.Tensor
    light_kind: torch.Tensor
    light_param: torch.Tensor
    light_prim: torch.Tensor
    world_center: torch.Tensor
    world_radius: torch.Tensor
    wnode_tab: torch.Tensor | None = None
    wprim_tab: torch.Tensor | None = None
    wmeta_tab: torch.Tensor | None = None
    wslot_prim: torch.Tensor | None = None
    wnode_rec: torch.Tensor | None = None  # (n_nodes, 64) f32 node records
    wleaf_rec: torch.Tensor | None = None  # (n_oct*8, 16) f32 leaf rows, row = kernel slot

    @property
    def device(self) -> torch.device:
        return self.tri_p.device

    def to(self, device) -> "SceneTensors":
        return SceneTensors(**{f.name: None if getattr(self, f.name) is None else getattr(self, f.name).to(device)
                               for f in fields(self)})

    def byte_size(self) -> int:
        return sum(t.numel() * t.element_size() for t in (getattr(self, f.name) for f in fields(self))
                   if t is not None)


@dataclass
class SceneStatic:
    """Static (Python-level) scene configuration; field names as in the
    reference's SceneStatic."""

    n_tris: int = 0
    n_prims: int = 0
    n_materials: int = 0
    n_lights: int = 0
    mat_kinds_present: tuple = ()
    light_kinds: tuple = ()  # LIGHT_* per light row
    has_area_lights: bool = False
    has_infinite: bool = False
    use_brute_force: bool = False  # n_prims <= 64: brute-force intersection, no BVH tables
    n_media: int = 0
    has_motion: bool = False
    tex_programs: tuple = ()  # texture programs (the port compiles none yet)
    has_wide: bool = False
    wide_root: int = 1


def scene_tensors_from_numpy(arrays: dict, static: dict, device) -> tuple[SceneTensors, SceneStatic]:
    """Host tables (name -> array, reference layouts) -> (SceneTensors on
    `device`, SceneStatic). Extra keys in either dict are ignored, so a
    reference scene's full field set can be passed as is."""
    tensors = {}
    for name, dtype in _TABLE_DTYPES.items():
        # np.array copies: reference arrays may be read-only views
        tensors[name] = torch.as_tensor(np.array(arrays[name]), dtype=dtype, device=device)
    for name, dtype in _WIDE_DTYPES.items():
        if arrays.get(name) is not None:
            tensors[name] = torch.as_tensor(np.array(arrays[name]), dtype=dtype, device=device)
    if arrays.get("wnode_tab") is not None:
        recs = hopper_layout(*(np.asarray(arrays[n]) for n in ("wnode_tab", "wprim_tab", "wmeta_tab")))
        for name, rec in zip(HOPPER_TABLES, recs):
            tensors[name] = torch.as_tensor(rec, device=device)
    st = SceneStatic(**{f.name: static[f.name] for f in fields(SceneStatic)})
    st.mat_kinds_present = tuple(int(k) for k in st.mat_kinds_present)
    st.light_kinds = tuple(int(k) for k in st.light_kinds)
    st.tex_programs = tuple(st.tex_programs)
    return SceneTensors(**tensors), st
