"""SceneTensors: the flat SoA device representation of a scene, in torch.

The port's counterpart of ``pbrt_tpu/scene/arrays.py``: the same id
constants and the same table layouts, holding only the fields the ported
slices read: triangle meshes and the six quadric kinds, the binary BVH
with its per-prim test rows, the instance transforms, the alpha masks,
the material rows, the light rows with the goniometric and projection
lights' frames and images, the texture programs with their parameters and
MIP pyramids, the stacked Fourier BSDF tables, the image-mapped infinite
light's tables, the kd-tree of a scene that asks for one, the
participating media (each prim's inside and outside medium, the medium rows,
their world-to-grid frames and density grids), the tabulated BSSRDF's rows
of a scene with subsurface materials and, for scenes above the brute-force
size, the wide BVH with its attribute table, and the motion tables of a
scene with moving prims (the shutter-close and mid-shutter keyframe rows,
the animated-transform groups and each prim's group and compose constant).

- ``SceneTensors``: torch tensors, all on one device.
- ``SceneStatic``: Python-level counts and flags that shape the program.

``scene_tensors_from_numpy`` is the one place tables cross from host arrays
to the device; the port's own compiler and the parity tests (which fill it
from a reference ``CompiledScene``) both go through it. It also derives,
once per scene, the wide BVH's Hopper layout (``HOPPER_TABLES``,
``widebvh.hopper_layout``) that the CUDA walks and their plain twin read,
and the binary BVH walk's records (``bvh_walk_records``: both child boxes
in the parent's record, a compact row per prim); every other table is the
reference's, bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields

import numpy as np
import torch

from .widebvh import hopper_layout, hopper_rows

# geometry type ids
GEOM_TRI = 0
GEOM_SPHERE = 1  # any analytic quadric row (see QUADRIC_* for the sub-kind)

# quadric sub-kinds (sph_kind)
QUADRIC_SPHERE = 0
QUADRIC_CYLINDER = 1
QUADRIC_DISK = 2
QUADRIC_CONE = 3
QUADRIC_PARABOLOID = 4
QUADRIC_HYPERBOLOID = 5

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
    "sph_param": torch.float32,  # (S, 12) per kind (builder; intersect.ray_quadric)
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
    "mat_bump": torch.int32,  # (M,) bump-map texture index or -1
    "tex_param": torch.float32,  # (X, 24) per-texture parameters (builder._TextureRegistry)
    "light_kind": torch.int32,  # (L,) LIGHT_*
    "light_param": torch.float32,  # (L, 12): area L(3), two_sided; point/spot/distant see builder
    "light_prim": torch.int32,  # (L,) prim row of an area light
    "light_w2l": torch.float32,  # (L, 3, 4) world -> light (goniometric and projection frames)
    "bvh_packed": torch.float32,  # (N, 12) binary BVH nodes: lo (3), hi (3), offset, n prims, axis, pad (3)
    "prim_test_data": torch.float32,  # (P, 20 | 26) tri verts (9) | quadric w2o (12), params 0:6, kind; 19:25 p1 p2
    "prim_inst": torch.int32,  # (P,) instance row (0: the identity)
    "inst_i2w": torch.float32,  # (I, 3, 4) instance -> world
    "inst_w2i": torch.float32,  # (I, 3, 4) world -> instance
    "prim_alpha_tex": torch.int32,  # (P,) alpha cutout texture or -1
    "prim_shadow_alpha_tex": torch.int32,  # (P,) shadow-alpha texture (the alpha one by default) or -1
    "prim_medium": torch.int32,  # (P, 2) inside, outside medium row (-1: vacuum)
    "med_param": torch.float32,  # (Md, 8) sigma_a (3), sigma_s (3), g, max density (1 if homogeneous)
    "med_w2m": torch.float32,  # (Md, 3, 4) world -> medium ([0, 1]^3 grid space of a grid medium)
    "world_center": torch.float32,  # (3,)
    "world_radius": torch.float32,  # ()
}

# the kd-tree (scene/kdtree.py): None unless static.accel_kind == "kdtree"
_KD_DTYPES = {
    "kd_flags": torch.int32,  # (N,) 0-2 split axis, 3 leaf
    "kd_split": torch.float32,  # (N,) split position
    "kd_above": torch.int32,  # (N,) interior: above child; leaf: offset into kd_prim_ids
    "kd_nprims": torch.int32,  # (N,) leaf prim count
    "kd_prim_ids": torch.int32,  # (M,) leaf prim lists
    "kd_lo": torch.float32,  # (3,) root bounds
    "kd_hi": torch.float32,  # (3,)
}

# the image-mapped infinite light: None without one
_ENV_DTYPES = {
    "env_image": torch.float32,  # (H, W, 3) the map times L
    "env_cond_cdf": torch.float32,  # (H, W + 1) per-row conditional CDFs
    "env_marg_cdf": torch.float32,  # (H + 1,) marginal CDF over rows
    "env_w2l": torch.float32,  # (3, 4) world -> light
}

# the tabulated BSSRDF's rows (builder; device/bssrdf.py): None without a
# subsurface or kdsubsurface material (or under PBRT_TPU_NO_TABSSS=1)
_SSS_DTYPES = {
    "sss_prof": torch.float32,  # (M, 3, 64) radial profile rows, the albedo axis folded per row
    "sss_cdf": torch.float32,  # (M, 3, 64) their running integrals
    "sss_rhoeff": torch.float32,  # (M, 3) effective albedo
    "sss_sigma_t": torch.float32,  # (M, 3) extinction
    "sss_eta": torch.float32,  # (M,)
    "sss_radius": torch.float32,  # (64,) optical-radius knots
}

# motion blur (reference arrays :147-153, :204-222): the shutter-close
# keyframe rows (None for a static scene), the mid-shutter rows of a scene
# whose shutter transform rotates, and the exact animated-transform tables
# (device/motion.py): per prim its group and compose constant (a triangle's
# M0^-1, a quadric's w2o0 . M0), the group 0 the identity
_MOTION_DTYPES = {
    "tri_p_end": torch.float32,  # (T, 3, 3)
    "sph_w2o_end": torch.float32,  # (S, 3, 4)
    "sph_o2w_end": torch.float32,  # (S, 3, 4)
    "prim_test_data_end": torch.float32,  # prim_test_data's layout
    "tri_p_mid": torch.float32,  # (T, 3, 3)
    "sph_w2o_mid": torch.float32,  # (S, 3, 4)
    "sph_o2w_mid": torch.float32,  # (S, 3, 4)
    "prim_test_data_mid": torch.float32,
    "anim_gid": torch.int32,  # (P,) animation group per prim
    "anim_c": torch.float32,  # (P, 3, 4) per-prim compose constant
}
# the animated-transform groups (SceneTensors.anim; empty without rotation)
ANIM_TABLES = ("q0", "q1", "t0", "t1", "s0", "s1", "theta")

# the wide-BVH tables: None for a brute-force scene, which has none
_WIDE_DTYPES = {
    "wnode_tab": torch.float32,  # (ceil(Nw/8)*8, 128) wide-BVH node boxes
    "wprim_tab": torch.float32,  # (ceil(n_oct/8)*8, 128) leaf triangles
    "wmeta_tab": torch.int32,  # (n_nodes*8,) packed child metas
    "wslot_prim": torch.int32,  # (n_oct*8,) kernel slot -> prim row
    "wattr_tab": torch.float32,  # prim_tab-shaped: n0 n1 n2 (9), uv0 uv1 uv2 (6); None if flat, default UVs
}
# the tables scene_tensors_from_numpy derives for the Hopper kernels, not
# reference tables: the wide BVH's records (widebvh.hopper_layout,
# hopper_rows); wide_prim_rows, the global prim row of each wide-table prim
# in a mixed scene (more than 64 triangles beside 1-8 quadrics), whose wide
# tables cover the triangle subset and index it locally (None when they
# cover every prim); the grid media's densities packed for
# csrc/medium_track.cu (med_grid_corners, med_grid_dims); and the
# animated-transform groups as one row each for csrc/bvh_walk.cu's motion
# walk (anim_rec: q0, q1, t0, t1, s0, s1, theta in ANIM_REC_COLS floats);
# and the binary BVH walk's records (bvh_walk_records: bw_node_rec,
# bw_prim_rec) of the scenes whose route is bvh or kdtree; and the kd
# walk's (kd_walk_records: kd_node_rec, kd_leaf_rec) of a kd scene
HOPPER_TABLES = ("wnode_rec", "wleaf_rec", "wattr_rec", "wide_prim_rows", "med_grid_corners", "med_grid_dims",
                 "anim_rec", "bw_node_rec", "bw_prim_rec", "kd_node_rec", "kd_leaf_rec")
ANIM_REC_COLS = 36
# the stacked Fourier BSDF tables (empty dict without one)
FOURIER_TABLES = ("mu", "aflat", "a0", "cdf", "eta")


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
    mat_bump: torch.Tensor
    tex_param: torch.Tensor
    light_kind: torch.Tensor
    light_param: torch.Tensor
    light_prim: torch.Tensor
    light_w2l: torch.Tensor
    bvh_packed: torch.Tensor
    prim_test_data: torch.Tensor
    prim_inst: torch.Tensor
    inst_i2w: torch.Tensor
    inst_w2i: torch.Tensor
    prim_alpha_tex: torch.Tensor
    prim_shadow_alpha_tex: torch.Tensor
    prim_medium: torch.Tensor
    med_param: torch.Tensor
    med_w2m: torch.Tensor
    world_center: torch.Tensor
    world_radius: torch.Tensor
    kd_flags: torch.Tensor | None = None
    kd_split: torch.Tensor | None = None
    kd_above: torch.Tensor | None = None
    kd_nprims: torch.Tensor | None = None
    kd_prim_ids: torch.Tensor | None = None
    kd_lo: torch.Tensor | None = None
    kd_hi: torch.Tensor | None = None
    env_image: torch.Tensor | None = None
    env_cond_cdf: torch.Tensor | None = None
    env_marg_cdf: torch.Tensor | None = None
    env_w2l: torch.Tensor | None = None
    wnode_tab: torch.Tensor | None = None
    wprim_tab: torch.Tensor | None = None
    wmeta_tab: torch.Tensor | None = None
    wslot_prim: torch.Tensor | None = None
    wattr_tab: torch.Tensor | None = None
    wnode_rec: torch.Tensor | None = None  # (n_nodes, 64) f32 node records
    wleaf_rec: torch.Tensor | None = None  # (n_oct*8, 16) f32 leaf rows, row = kernel slot
    wattr_rec: torch.Tensor | None = None  # (n_oct*8, 16) f32 attribute rows, row = kernel slot
    wide_prim_rows: torch.Tensor | None = None  # (T,) int32 wide-table prim -> prim row (mixed scenes)
    # derived from med_grids (None without a grid medium; grid_corners):
    # every grid medium's voxel corners, one 32-byte row of eight densities
    # per voxel of the grid padded by one voxel below, and per medium row
    # the offset of its first row there and its (nx, ny, nz), nx = 0 for a
    # homogeneous one (medium_track.cu). A second copy of each grid at
    # 32 (nx + 1) (ny + 1) (nz + 1) bytes, about 8x the grid's own (8.8 MB
    # for 64^3, 543 MB for 256^3), counted in byte_size; it stays within
    # the H100's 50 MB L2 up to about 115^3 voxels
    # (tools/medium_track_variants.py measures it against the flat grid)
    med_grid_corners: torch.Tensor | None = None  # (V, 8) f32
    med_grid_dims: torch.Tensor | None = None  # (Md, 4) int32
    anim_rec: torch.Tensor | None = None  # (G, ANIM_REC_COLS) f32, None without rotating motion
    # the binary BVH walk's records (bvh_walk_records; None on the brute
    # and wide routes): one 16-word row per interior node, one 12-word row
    # per prim
    bw_node_rec: torch.Tensor | None = None  # (n_interior, 16) f32, words 12-15 int32 bits
    bw_prim_rec: torch.Tensor | None = None  # (P, 12) f32, words 9-11 int32 bits
    # the kd walk's records (kd_walk_records; None but on the kdtree route):
    # 8 bytes per node, one 12-word row per entry of kd_prim_ids
    kd_node_rec: torch.Tensor | None = None  # (N, 2) int32
    kd_leaf_rec: torch.Tensor | None = None  # (M, 12) f32, words 9-11 int32 bits
    sss_prof: torch.Tensor | None = None
    sss_cdf: torch.Tensor | None = None
    sss_rhoeff: torch.Tensor | None = None
    sss_sigma_t: torch.Tensor | None = None
    sss_eta: torch.Tensor | None = None
    sss_radius: torch.Tensor | None = None
    tri_p_end: torch.Tensor | None = None
    sph_w2o_end: torch.Tensor | None = None
    sph_o2w_end: torch.Tensor | None = None
    prim_test_data_end: torch.Tensor | None = None
    tri_p_mid: torch.Tensor | None = None
    sph_w2o_mid: torch.Tensor | None = None
    sph_o2w_mid: torch.Tensor | None = None
    prim_test_data_mid: torch.Tensor | None = None
    anim_gid: torch.Tensor | None = None
    anim_c: torch.Tensor | None = None
    # the animated-transform groups of a scene whose shutter transform
    # rotates (static.has_rot_motion): q0, q1 (G, 4) wxyz, sign-aligned;
    # t0, t1 (G, 3); s0, s1 (G, 3, 3); theta (G,) the angle between q0 and
    # q1; all f32; None otherwise, as in the reference
    anim: dict | None = None
    # MIP pyramid levels of the imagemap textures, "{image_key}_l{k}" ->
    # (H_k, W_k, 3) f32 (TexProgram.image_key, n_levels)
    tex_images: dict = field(default_factory=dict)
    # the stacked Fourier BSDF tables (builder._stack_fourier_tables; read by
    # device/fourier.py): mu (NT, NMU), aflat (NT, NMU^2, 3 MCAP), a0 and
    # cdf (NT, NMU, NMU), eta (NT,), all f32; empty without a readable table
    fourier: dict = field(default_factory=dict)
    # the goniometric and projection lights' images, "lim{i}" -> (H, W, 3)
    # f32 (SceneStatic.light_image_keys names each light's)
    light_images: dict = field(default_factory=dict)
    # the grid media's densities, "med{i}" -> (nz, ny, nx) f32 (i the medium row)
    med_grids: dict = field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return self.tri_p.device

    def to(self, device) -> "SceneTensors":
        def move(x):
            if isinstance(x, dict):
                return {k: v.to(device) for k, v in x.items()}
            return None if x is None else x.to(device)

        return SceneTensors(**{f.name: move(getattr(self, f.name)) for f in fields(self)})

    def byte_size(self) -> int:
        tensors = []
        for f in fields(self):
            x = getattr(self, f.name)
            tensors += list(x.values()) if isinstance(x, dict) else [x]
        return sum(t.numel() * t.element_size() for t in tensors if t is not None)


@dataclass
class TexProgram:
    """Static per-texture evaluation recipe (children are earlier indices);
    the reference's scene.arrays.TexProgram."""

    kind: str
    is_float: bool
    mapping: str = "uv"
    image_key: str = ""  # key into SceneTensors.tex_images
    n_levels: int = 1  # MIP pyramid levels ("{image_key}_l{k}")
    trilinear: bool = False  # else EWA
    wrap: str = "repeat"
    tex1: int = -1  # child index or -1 (then const in tex_param)
    tex2: int = -1
    amount: int = -1
    v01: int = -1
    v10: int = -1
    dimension: int = 2
    octaves: int = 8
    max_aniso: float = 8.0  # imagemap "maxanisotropy" (EWA eccentricity clamp)


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
    light_n_samples: tuple = ()  # per-light "nsamples" (directlighting's UniformSampleAll arrays)
    has_area_lights: bool = False
    has_infinite: bool = False
    infinite_light_index: int = -1  # the infinite light's row
    has_env_map: bool = False  # ... and it is image-mapped
    use_brute_force: bool = False  # n_prims <= 64: brute-force intersection, no BVH tables
    n_spheres: int = 0  # quadric rows
    has_cone_sphere_lights: bool = False  # an area light on a full, outward-facing sphere
    n_media: int = 0
    media_kinds: tuple = ()  # "homogeneous" | "heterogeneous" per medium row
    camera_medium: int = -1  # the camera's medium row (-1: vacuum)
    has_null_material: bool = False  # some prim has the interface (null) material
    has_sss_media: bool = False  # subsurface interiors walked as media (PBRT_TPU_NO_TABSSS=1)
    has_tab_sss: bool = False  # subsurface materials with the tabulated BSSRDF's rows
    sss_media: tuple = ()  # the medium rows that are subsurface interiors
    has_motion: bool = False  # some prim carries shutter-close keyframes
    has_rot_motion: bool = False  # ... and a shutter transform rotates: the exact TRS tables (anim)
    tex_programs: tuple = ()  # TexProgram per texture, in evaluation (creation) order
    has_bump: bool = False  # some material carries a bump-map texture
    has_fourier: bool = False  # a readable tabulated (fourier) BSDF table
    has_wide: bool = False  # wide-BVH tables over every prim (triangle-only scenes)
    has_wide_tri: bool = False  # ... over the triangle prims (has_wide, or a mixed scene)
    wide_root: int = 1
    max_leaf: int = 4  # prims per binary-BVH leaf at most ("maxnodeprims")
    has_instances: bool = False  # some prim carries an instance transform (inst_i2w has more than the identity)
    has_alpha: bool = False  # some prim carries an alpha or shadow-alpha cutout
    accel_kind: str = "bvh"  # "bvh" | "kdtree" (the Accelerator directive, after the reference's demotions)
    kd_max_leaf: int = 1  # longest kd leaf list
    light_image_keys: tuple = ()  # per light: its light_images key or None
    # derived from the tables by scene_tensors_from_numpy, not reference
    # fields: the quadric kinds present, and the texture programs the alpha
    # and shadow-alpha cutouts read
    quadric_kinds: tuple = ()
    alpha_programs: tuple = ()
    # ... and of a kd scene the most interior nodes on a path from the
    # root to a leaf: the kd walk's todo stack never holds more entries
    kd_depth: int = 0


_DERIVED_STATIC = ("quadric_kinds", "alpha_programs", "kd_depth")


def scene_tensors_from_numpy(arrays: dict, static: dict, device) -> tuple[SceneTensors, SceneStatic]:
    """Host tables (name -> array, reference layouts) -> (SceneTensors on
    `device`, SceneStatic). Extra keys in either dict are ignored, so a
    reference scene's full field set can be passed as is."""
    tensors = {}
    for name, dtype in _TABLE_DTYPES.items():
        # np.array copies: reference arrays may be read-only views
        tensors[name] = torch.as_tensor(np.array(arrays[name]), dtype=dtype, device=device)
    for name, dtype in {**_ENV_DTYPES, **_WIDE_DTYPES, **_KD_DTYPES, **_SSS_DTYPES, **_MOTION_DTYPES}.items():
        if arrays.get(name) is not None:
            tensors[name] = torch.as_tensor(np.array(arrays[name]), dtype=dtype, device=device)
    # mipmap levels (the reference's dict holds device arrays: np.array copies)
    tensors["tex_images"] = {k: torch.as_tensor(np.array(v), dtype=torch.float32, device=device)
                             for k, v in (arrays.get("tex_images") or {}).items()}
    tensors["light_images"] = {k: torch.as_tensor(np.array(v), dtype=torch.float32, device=device)
                               for k, v in (arrays.get("light_images") or {}).items()}
    tensors["med_grids"] = {k: torch.as_tensor(np.array(v), dtype=torch.float32, device=device)
                            for k, v in (arrays.get("med_grids") or {}).items()}
    if tensors["med_grids"]:
        corners, dims = grid_corners(tensors["med_grids"], np.asarray(arrays["med_param"]).shape[0])
        tensors["med_grid_corners"] = torch.as_tensor(corners, device=device)
        tensors["med_grid_dims"] = torch.as_tensor(dims, device=device)
    if arrays.get("anim"):
        tensors["anim"] = {k: torch.as_tensor(np.array(v), dtype=torch.float32, device=device)
                           for k, v in arrays["anim"].items()}
        tensors["anim_rec"] = anim_records(tensors["anim"])
    fourier = arrays.get("fourier") or {}
    tensors["fourier"] = {k: torch.as_tensor(np.array(fourier[k]), dtype=torch.float32, device=device)
                          for k in FOURIER_TABLES if k in fourier}
    if arrays.get("wnode_tab") is not None:
        recs = hopper_layout(*(np.asarray(arrays[n]) for n in ("wnode_tab", "wprim_tab", "wmeta_tab")))
        if arrays.get("wattr_tab") is not None:
            # one attribute row per kernel slot, beside the slot's leaf row
            recs = (*recs, hopper_rows(np.asarray(arrays["wattr_tab"])))
        prim_kind = np.asarray(arrays["prim_kind"])
        if (prim_kind != GEOM_TRI).any():
            # a mixed scene: the tables cover the triangle prims in prim
            # order and name them by their rank there; the leaf rows' prim
            # column (10) gets the global row, so every walk returns it
            rows = np.nonzero(prim_kind == GEOM_TRI)[0].astype(np.int32)
            leaf = recs[1]
            valid = leaf[:, 9] > 0
            leaf[valid, 10] = rows[leaf[valid, 10].astype(np.int64)].astype(np.float32)
            tensors["wide_prim_rows"] = torch.as_tensor(rows, device=device)
        for name, rec in zip(HOPPER_TABLES, recs):
            tensors[name] = torch.as_tensor(rec, device=device)
    st = SceneStatic(**{f.name: static[f.name] for f in fields(SceneStatic) if f.name not in _DERIVED_STATIC})
    st.has_motion = bool(st.has_motion)
    st.has_rot_motion = bool(st.has_rot_motion)
    st.quadric_kinds = tuple(sorted(set(int(k) for k in np.asarray(arrays["sph_kind"]).ravel())))
    alpha = np.concatenate([np.asarray(arrays[n]).ravel() for n in ("prim_alpha_tex", "prim_shadow_alpha_tex")])
    st.alpha_programs = tuple(sorted(set(int(x) for x in alpha if x >= 0)))
    st.mat_kinds_present = tuple(int(k) for k in st.mat_kinds_present)
    st.light_kinds = tuple(int(k) for k in st.light_kinds)
    st.light_n_samples = tuple(int(n) for n in st.light_n_samples)
    st.light_image_keys = tuple(st.light_image_keys)
    st.accel_kind = str(st.accel_kind)
    st.media_kinds = tuple(str(k) for k in st.media_kinds)
    st.sss_media = tuple(int(m) for m in st.sss_media)
    st.tex_programs = tuple(p if isinstance(p, TexProgram) else TexProgram(**vars(p)) for p in st.tex_programs)
    from ..device.intersect import route_name  # the device layer imports this module

    if st.n_prims > 0 and route_name(st) in ("bvh", "kdtree"):
        # the binary BVH walk serves the scene (a kd scene keeps its binary
        # BVH too, which its twin checks walk); the brute and wide routes
        # never launch it
        gid = arrays.get("anim_gid")
        recs = bvh_walk_records(np.asarray(arrays["bvh_packed"]), np.asarray(arrays["prim_test_data"]),
                                np.asarray(arrays["prim_kind"]), np.asarray(arrays["prim_inst"]),
                                None if gid is None else np.asarray(gid))
        tensors["bw_node_rec"], tensors["bw_prim_rec"] = (torch.as_tensor(r, device=device) for r in recs)
    if st.n_prims > 0 and route_name(st) == "kdtree":
        gid = arrays.get("anim_gid")
        node_rec, leaf_rec, st.kd_depth = kd_walk_records(
            *(np.asarray(arrays[n]) for n in ("kd_flags", "kd_split", "kd_above", "kd_nprims", "kd_prim_ids",
                                              "prim_test_data", "prim_kind")),
            None if gid is None else np.asarray(gid))
        tensors["kd_node_rec"], tensors["kd_leaf_rec"] = (torch.as_tensor(r, device=device)
                                                          for r in (node_rec, leaf_rec))
    return SceneTensors(**tensors), st


def bvh_walk_records(bvh_packed, prim_test_data, prim_kind, prim_inst, anim_gid=None):
    """The binary BVH walk's records (csrc/bvh_walk.cu, device/bvh_walk.py
    walk_plain) derived from the reference's tables: (node_rec
    (n_interior, 16), prim_rec (P, 12)), both float32 arrays whose int
    words hold int32 bits.

    Interior nodes are numbered by their rank among the interior rows of
    bvh_packed (row 0, the root, is record 0 when it is interior). A
    record holds both children's boxes, so a walk tests the two at their
    parent with three float4 loads: words 0-5 child 0's lo and hi, 6-11
    child 1's; word 12 child 0's reference, 13 child 1's (an interior
    child's record number, a leaf's ~offset: its prims are rows offset,
    offset + 1, ... of the prim tables); 14 the split axis; 15 the node's
    row in bvh_packed. Child 0 is row node + 1, child 1 row offset, as in
    bvh_packed. A prim row holds a triangle's 9 vertex floats (the first 9
    of its prim_test_data row, for every prim), then kind | rem << 4 (rem:
    the prims of its leaf from it to the leaf's end, so the walk knows a
    leaf's length from its first prim), its instance row and its
    animation group (0 without one). Raises ValueError if two leaves share
    a prim row."""
    nodes = np.asarray(bvh_packed, np.float32)
    n_leaf = nodes[:, 7].astype(np.int64)
    off = nodes[:, 6].astype(np.int64)
    interior = np.nonzero(n_leaf == 0)[0]
    rank = np.full(nodes.shape[0], -1, np.int64)
    rank[interior] = np.arange(interior.size)

    def ref(child):
        return np.where(n_leaf[child] > 0, ~off[child], rank[child]).astype(np.int32)

    left, right = interior + 1, off[interior]
    node_rec = np.zeros((interior.size, 16), np.float32)
    node_rec[:, 0:6] = nodes[left, 0:6]
    node_rec[:, 6:12] = nodes[right, 0:6]
    words = node_rec.view(np.int32)
    words[:, 12] = ref(left)
    words[:, 13] = ref(right)
    words[:, 14] = nodes[interior, 8].astype(np.int32)
    words[:, 15] = interior.astype(np.int32)
    P = prim_test_data.shape[0]
    rem = np.zeros(P, np.int64)
    leaves = np.nonzero(n_leaf > 0)[0]
    starts, counts = off[leaves], n_leaf[leaves]
    k = np.arange(int(counts.max()) if leaves.size else 0)
    rows = starts[:, None] + k[None, :]
    valid = k[None, :] < counts[:, None]
    if valid.sum() != np.unique(rows[valid]).size:
        raise ValueError("bvh_walk_records: two leaves share a prim row")
    rem[rows[valid]] = (counts[:, None] - k[None, :])[valid]
    prim_rec = np.zeros((P, 12), np.float32)
    prim_rec[:, 0:9] = prim_test_data[:, 0:9]
    pw = prim_rec.view(np.int32)
    pw[:, 9] = (np.asarray(prim_kind, np.int64) | (rem << 4)).astype(np.int32)
    pw[:, 10] = np.asarray(prim_inst, np.int32)
    pw[:, 11] = 0 if anim_gid is None else np.asarray(anim_gid, np.int32)
    return node_rec, prim_rec


def kd_walk_records(kd_flags, kd_split, kd_above, kd_nprims, kd_prim_ids, prim_test_data, prim_kind,
                    anim_gid=None):
    """The kd walk's records (csrc/bvh_walk.cu kd_walk_kernel) derived from
    the kd tables, which stay as they are: (node_rec (N, 2) int32,
    leaf_rec (M, 12) float32 whose words 9-11 hold int32 bits, the tree's
    depth: the most interior nodes on a path from the root to a leaf).

    A node is one 8-byte record, pbrt's KdAccelNode: an interior node's
    word 0 holds its split's float bits and word 1 its axis | above << 2
    (the below child is the next node); a leaf's word 0 the offset of its
    first row in leaf_rec and word 1 3 | count << 2. leaf_rec holds one row
    per entry of kd_prim_ids, in leaf order, so a prim listed in two leaves
    has two rows: the BVH walk's 48-byte prim row (bvh_walk_records: a
    triangle's 9 vertex floats, kind | rem << 4, then the animation group
    in word 11) with the prim's row in word 10, where the BVH walk keeps
    the instance (a kd scene has no instances: compile_scene keeps the BVH
    for them). Raises ValueError if two leaves share an entry, or an entry
    is in no leaf."""
    flags = np.asarray(kd_flags, np.int64)
    above = np.asarray(kd_above, np.int64)
    nprims = np.asarray(kd_nprims, np.int64)
    ids = np.asarray(kd_prim_ids, np.int64)
    leaf = flags == 3
    node_rec = np.zeros((flags.size, 2), np.int32)
    node_rec[:, 0] = np.where(leaf, above, np.asarray(kd_split, np.float32).view(np.int32))
    node_rec[:, 1] = np.where(leaf, 3 | (nprims << 2), flags | (above << 2)).astype(np.int32)
    starts, counts = above[leaf], nprims[leaf]
    k = np.arange(int(counts.max()) if counts.size else 0)
    entry = starts[:, None] + k[None, :]
    valid = k[None, :] < counts[:, None]
    listed = entry[valid]
    if listed.size != ids.size or np.unique(listed).size != ids.size or (ids.size and listed.max() >= ids.size):
        raise ValueError("kd_walk_records: the leaves do not cover kd_prim_ids once each")
    rem = np.zeros(ids.size, np.int64)
    rem[entry[valid]] = (counts[:, None] - k[None, :])[valid]
    leaf_rec = np.zeros((ids.size, 12), np.float32)
    leaf_rec[:, 0:9] = np.asarray(prim_test_data, np.float32)[ids, 0:9]
    words = leaf_rec.view(np.int32)
    words[:, 9] = (np.asarray(prim_kind, np.int64)[ids] | (rem << 4)).astype(np.int32)
    words[:, 10] = ids.astype(np.int32)
    words[:, 11] = 0 if anim_gid is None else np.asarray(anim_gid, np.int32)[ids]
    # the depth, a level of interior nodes at a time (children follow their parent)
    depth, level = 0, np.zeros(1, np.int64)
    while True:
        inner = level[~leaf[level]]
        if inner.size == 0:
            break
        depth += 1
        level = np.concatenate([inner + 1, above[inner]])
    return node_rec, leaf_rec, depth


def anim_records(anim: dict) -> torch.Tensor:
    """The animated-transform groups as (G, ANIM_REC_COLS) rows, the motion
    walk's layout: q0 (0:4), q1 (4:8), t0 (8:11), t1 (11:14), s0 (14:23),
    s1 (23:32) row-major, theta (32), zeros after."""
    g = anim["q0"].shape[0]
    parts = [anim[k].reshape(g, -1) for k in ANIM_TABLES[:6]] + [anim["theta"].reshape(g, 1)]
    rec = torch.cat(parts, dim=1)
    return torch.nn.functional.pad(rec, (0, ANIM_REC_COLS - rec.shape[1])).contiguous()


def grid_corners(grids: dict, n_media: int):
    """Every grid's voxel corners for csrc/medium_track.cu: (corners (V, 8)
    float32, dims (n_media, 4) int32: per medium row the offset of its
    first row in corners, nx, ny, nz; nx = 0 where the medium has no grid).
    For a grid "med{i}" of grids ((nz, ny, nx)) the rows are its voxels
    (x0, y0, z0) from (-1, -1, -1) to (nx - 1, ny - 1, nz - 1), x fastest:
    row (z0 + 1) * (ny + 1) * (nx + 1) + (y0 + 1) * (nx + 1) + x0 + 1 from
    the medium's offset, holding the densities at (x0 + i, y0 + j, z0 + k)
    for (i, j, k) = (0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0), (0, 0, 1),
    (1, 0, 1), (0, 1, 1), (1, 1, 1): the grid's values, 0 outside it. A
    trilinear lookup reads one 32-byte row where the grid itself takes
    eight scattered values; the values are the same floats."""
    dims = np.zeros((n_media, 4), np.int32)
    parts, off = [], 0
    for i in range(n_media):
        grid = grids.get(f"med{i}")
        if grid is None:
            continue
        grid = grid.detach().cpu().numpy().astype(np.float32)
        nz, ny, nx = grid.shape
        g = np.zeros((nz + 2, ny + 2, nx + 2), np.float32)
        g[1:-1, 1:-1, 1:-1] = grid
        corners = [g[k:k + nz + 1, j:j + ny + 1, i_:i_ + nx + 1] for k in (0, 1) for j in (0, 1) for i_ in (0, 1)]
        dims[i] = off, nx, ny, nz
        parts.append(np.stack(corners, axis=-1).reshape(-1, 8))
        off += parts[-1].shape[0]
    return np.concatenate(parts), dims


def scene_byte_size(sa: SceneTensors) -> int:
    """Bytes of every table of the scene (arrays.scene_byte_size)."""
    return sa.byte_size()
