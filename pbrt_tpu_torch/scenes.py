"""Built-in scenes, made on the port's host types.

``spheres_gallery`` is the reference bench's "value" configuration (bench.py
renders the spheres scene at 1000x500, 16 spp, depth 5 through the brute
megakernel) rebuilt on a scene that lives in the repository: a ground quad
and six full spheres, one per lobe class the megakernel bakes (Lambert,
Oren-Nayar, mirror, glass, GGX copper, Lambert+GGX plastic), lit by a
distant, a point and a spot light with power-proportional light selection.

``mesh_room`` is bench.py's mesh configuration (``bench._grid_mesh`` and
``bench._mesh_scene``) with the same numbers: an enclosed displaced-terrain
room of 2 * n_side^2 floor triangles (123,650 prims in all at n_side=248),
tessellated walls and ceiling, and a two-sided emissive ceiling panel. Every
camera and bounce ray hits a surface, so a render measures traversal and
shading, not empty lanes.

``area_box`` is the brute-force counterpart of ``material_room``: 15 prims
that hold every lobe kind of the five constant materials, triangle area
lights and a delta light, a partial sphere and pbrt's default 'spatial'
light distribution in one render. The brute megakernel refuses its area
lights, so it renders through the brute wavefront.

``sky_meshes`` is the open scene of the wide megakernel's class with pbrt's
defaults: a displaced ground grid and four UV-sphere meshes with analytic
per-vertex normals and a UV chart (matte, plastic, copper metal, glass)
under a constant infinite light and a distant sun; halton with the gaussian
filter, power light selection.

``textured_room`` is material_room's geometry with UV charts and the
texture kinds users' scenes carry: a 1024x1024 RGB imagemap Kd on the floor
(EWA, pbrt's default filter), a 512x512 trilinear imagemap on the back
wall, a checkerboard, a scale of marble and a mix driven by fbm, and a
float-imagemap bump map; halton with the gaussian filter. The wavefront
renders it. ``textured_gallery`` is spheres_gallery with 128x128 grayscale
imagemap Kds on its ground quad and on a backdrop quad, the brute
megakernel's atlas class; ``material_room(checker=True)`` gives the floor
a UV chart and a checkerboard Kd of two constant cells, the wide
megakernel's.

``sphere_room`` is material_room with seven full spheres among its
triangles (the mixed scenes: the wide tables cover the triangle subset,
the spheres are tested beside them): glass, mirror, GGX copper, plastic,
Oren-Nayar, glossy uber (Kd and Ks only) and an emissive sphere lamp, and
its left wall of glossy uber; at n_side=248 the same spheres sit among the
mesh room's terrain. ``uber_room`` is sphere_room with its uber rows made
full (Kr, Kt and opacity 0.7), outside both megakernels' lobe sets.

``zoo_room`` is material_room re-dressed with the surface materials of
the persistent wavefront that the megakernels do not bake: an anisotropic
substrate floor, a disney left wall, a right wall that mixes plastic and
copper, a rough-conductor fourier box in place of the glass one (its
SCATFUN table written by core/fourierbsdf.py), a two-sided translucent
quad under the spot light and a tuft of 32 flat hair curves on the floor;
``textured=True`` drives the mix amount by a uv checkerboard and the
substrate's Kd by an imagemap.

``fog_room`` is the mesh room's enclosure filled with a homogeneous fog
that is also the camera's medium, with a box of the interface (null)
material that holds a grid medium of smoke (a sum of Gaussian blobs made
from a seed) and a spot light shining through the fog: volpath's media,
medium interfaces and null crossings in one render. ``sss_room`` is the
same enclosure with a displaced sphere of the measured "Skin1" subsurface
material and a UV sphere of kdsubsurface, under path: the tabulated BSSRDF
(or, under PBRT_TPU_NO_TABSSS=1, the volumetric random walk). Both are
triangle-only, so they walk the wide BVH.

``motion_room`` is the mesh room's enclosure with three moving prims over
a 0-1 shutter (TransformTimes 0 1): a 1,984-triangle UV sphere spinning 30
degrees about its vertical axis, a 12-triangle box translating 0.3 and a
full sphere quadric crossing the room, seen by a camera that dollies and
yaws over the shutter; with rotate=False the UV sphere translates instead,
no group rotates, and the scene takes the keyframe tables in place of the
exact animated transform. Its moving prims carry the keyframes the parser
gives the same directives (``_animate``). ``realistic_mesh_room`` is the
mesh room under Camera "realistic" with the lens file ``write_lens``
writes (the built-in double Gauss), an aperture and a focus distance on
the room's far wall.

``write_pbrt`` writes a scene of these out as a .pbrt file, each mesh as a
binary PLY beside it, each imagemap as a PFM image and each Fourier table
as a copy, so the front end can be driven with the same scenes
(``python -m pbrt_tpu_torch``).
"""
from __future__ import annotations

import math
import os
import shutil
import tempfile

import numpy as np

from .core.fourierbsdf import write_rough_conductor_table
from .core.transform import AnimatedTransform, Transform
from .parser.api import MEDIUM_PRESETS, _normed
from .scene.host import (
    CameraConfig, FilmConfig, HostLight, HostMaterial, HostMedium, HostPrimitive, HostTexture,
    IntegratorConfig, SamplerConfig, SceneDescription, ShapeRecord, Sphere, TriangleMesh,
)
from .scene.tessellate import tessellate_curve


def _grid_mesh(f, u0, u1, v0, v1, n):
    """Tessellated parametric patch: f(u, v) -> (x, y, z) grids."""
    us = np.linspace(u0, u1, n + 1)
    vs = np.linspace(v0, v1, n + 1)
    gu, gv = np.meshgrid(us, vs)
    verts = np.stack(f(gu, gv), axis=-1).reshape(-1, 3)
    idx = []
    for i in range(n):
        row = i * (n + 1)
        for j in range(n):
            a = row + j
            b = a + 1
            c = a + n + 1
            dd = c + 1
            idx.append([a, c, b])
            idx.append([b, c, dd])
    return verts.astype(np.float64), np.asarray(idx, np.int32)


def _prim(verts, idx, kd, emit=None):
    light = None
    if emit is not None:
        # two-sided: the panel's winding faces the ceiling; two-sided
        # emission lights the whole room so every bounce does real NEE
        light = HostLight(kind="area", intensity=np.asarray(emit, np.float64), two_sided=True)
    return HostPrimitive(
        shape=ShapeRecord(mesh=TriangleMesh(p=verts, indices=idx)),
        material=HostMaterial(kind="matte", params={"Kd": ("const", np.asarray(kd))}),
        area_light=light,
    )


# (eye, look, up) of the rooms' camera
ROOM_LOOK_AT = ([0, 2.3, 3.3], [0, 0.2, -1.0], [0, 1, 0])


def mesh_room(n_side: int = 248) -> SceneDescription:
    """The 1000x500, 16 spp, depth-5 path-traced mesh room."""
    terrain = _prim(*_grid_mesh(
        lambda x, z: (x, 0.9 * np.sin(1.7 * x) * np.cos(1.3 * z) + 0.25 * np.sin(6.1 * x + 2.0 * z), z),
        -4, 4, -4, 4, n_side), [0.55, 0.45, 0.35])
    y0, y1 = -1.3, 4.0
    walls = [
        _prim(*_grid_mesh(lambda u, v: (u, v, np.full_like(u, -4.0)), -4, 4, y0, y1, 8), [0.6, 0.6, 0.6]),
        _prim(*_grid_mesh(lambda u, v: (u, v, np.full_like(u, 4.0)), -4, 4, y0, y1, 8), [0.6, 0.6, 0.6]),
        _prim(*_grid_mesh(lambda u, v: (np.full_like(u, -4.0), v, u), -4, 4, y0, y1, 8), [0.55, 0.3, 0.3]),
        _prim(*_grid_mesh(lambda u, v: (np.full_like(u, 4.0), v, u), -4, 4, y0, y1, 8), [0.3, 0.55, 0.3]),
        _prim(*_grid_mesh(lambda u, v: (u, np.full_like(u, y1), v), -4, 4, -4, 4, 8), [0.7, 0.7, 0.7]),
    ]
    panel = _prim(*_grid_mesh(lambda u, v: (u, np.full_like(u, y1 - 0.01), v), -1.4, 1.4, -1.4, 1.4, 1),
                  [0.0, 0.0, 0.0], emit=[14.0, 13.5, 12.5])
    return SceneDescription(
        primitives=[terrain] + walls + [panel],
        lights=[],
        camera=CameraConfig(kind="perspective",
                            camera_to_world=Transform.look_at(*ROOM_LOOK_AT), fov=70.0),
        film=FilmConfig(x_resolution=1000, y_resolution=500),
        sampler=SamplerConfig(kind="zerotwosequence", pixel_samples=16),
        integrator=IntegratorConfig(kind="path", max_depth=5, light_strategy="power"),
    )


def _const(v):
    return ("const", np.asarray(v, np.float64))


# the fog room's box of smoke: its corners, and the fog's and the smoke's
# coefficients (per unit density)
FOG_BOX = ([-0.5, 1.2, -1.6], [0.9, 2.6, -0.2])
FOG = {"sigma_a": [0.02, 0.02, 0.025], "sigma_s": [0.07, 0.075, 0.08], "g": 0.2}
SMOKE = {"sigma_a": [0.6, 0.65, 0.7], "sigma_s": [2.2, 2.0, 1.8], "g": 0.4}


def smoke_grid(res: int = 64, seed: int = 11, n_blobs: int = 12) -> np.ndarray:
    """(res, res, res) float32 densities (z, y, x): a sum of n_blobs
    Gaussian blobs with centers, widths and weights drawn from `seed`,
    sampled at the voxel centers of [0, 1]^3 (64^3: 1 MiB)."""
    rs = np.random.RandomState(seed)
    c = (np.arange(res) + 0.5) / res
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    dens = np.zeros((res, res, res))
    for _ in range(n_blobs):
        cx, cy, cz = rs.uniform(0.2, 0.8, 3)
        sig = rs.uniform(0.07, 0.18)
        dens += rs.uniform(0.3, 1.0) * np.exp(-((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2) / (2.0 * sig * sig))
    return dens.astype(np.float32)


def fog_room(n_side: int = 248, grid_res: int = 64) -> SceneDescription:
    """The mesh room's enclosure in a homogeneous fog (the camera's medium
    too), a 12-triangle box of the interface material whose inside is a
    grid medium of grid_res^3 smoke densities (smoke_grid), and a spot
    light through the fog beside the ceiling panel: volpath, depth 5,
    (0,2) samples with the box filter, power light selection. n_side 248:
    123,662 triangles."""
    desc = mesh_room(n_side)
    lo, hi = (np.asarray(v, np.float64) for v in FOG_BOX)
    verts, idx = _box(0.5 * (lo + hi), 1.0)
    verts = 0.5 * (lo + hi) + (verts - 0.5 * (lo + hi)) * (hi - lo)
    box = HostPrimitive(shape=ShapeRecord(mesh=TriangleMesh(p=verts, indices=idx)),
                        material=HostMaterial(kind="none"), inside_medium="smoke", outside_medium="fog")
    desc.primitives.append(box)
    # densities as float64 values of float32 numbers: what a written file
    # parses back to, bit for bit
    grid = smoke_grid(grid_res).astype(np.float64)
    desc.media = {
        "fog": HostMedium(kind="homogeneous", sigma_a=np.asarray(FOG["sigma_a"], np.float64),
                          sigma_s=np.asarray(FOG["sigma_s"], np.float64), g=FOG["g"]),
        "smoke": HostMedium(kind="heterogeneous", sigma_a=np.asarray(SMOKE["sigma_a"], np.float64),
                            sigma_s=np.asarray(SMOKE["sigma_s"], np.float64), g=SMOKE["g"],
                            nx=grid_res, ny=grid_res, nz=grid_res, density=grid, p0=lo, p1=hi),
    }
    desc.camera_medium = "fog"
    desc.lights = [HostLight(kind="spot", intensity=np.array([40.0, 36.0, 30.0]),
                             from_point=np.array([-2.6, 3.6, 1.8]), to_point=np.array([0.2, 1.6, -0.9]),
                             cone_angle=22.0, cone_delta=6.0)]
    desc.integrator = IntegratorConfig(kind="volpath", max_depth=5, light_strategy="power")
    return desc


def fog_box_rays(n: int, seed: int = 0):
    """n rays from the room's eye to uniform points of fog_room's smoke box,
    each started where it enters the box and ending where it leaves it (a
    slab test), with a uint32 key each: (o (n, 3), d (n, 3), t_end (n,),
    key (n,) int64), float64 but for the keys."""
    rs = np.random.RandomState(seed)
    eye = np.asarray(ROOM_LOOK_AT[0], np.float64)
    lo, hi = (np.asarray(v, np.float64) for v in FOG_BOX)
    d = lo + rs.random_sample((n, 3)) * (hi - lo) - eye
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t0, t1 = (lo - eye) / d, (hi - eye) / d
    tn, tf = np.minimum(t0, t1).max(1), np.maximum(t0, t1).min(1)
    return eye + d * tn[:, None], d, tf - tn, rs.randint(0, 2 ** 32, n, dtype=np.int64)


def _subsurface(kind, **params):
    """A subsurface-family material: every parameter the parser would set
    for it that the compiler reads (eta 1.33, the parser's default, where
    not given)."""
    out = {"eta": ("const", 1.33)}
    for k, v in params.items():
        out[k] = ("const", v) if isinstance(v, str) else _const(v)
    return HostMaterial(kind=kind, params=out)


def _displaced_sphere(center, radius, n, amp=0.06):
    """A UV sphere of 2 n (n - 1) triangles whose radius is displaced by a
    few sinusoids of its angles (geometric normals, the sphere's chart)."""
    m = _uv_sphere([0.0, 0.0, 0.0], 1.0, n, n)
    d = m.p / np.linalg.norm(m.p, axis=-1, keepdims=True)
    th, ph = np.arccos(np.clip(d[:, 1], -1.0, 1.0)), np.arctan2(d[:, 2], d[:, 0])
    r = radius * (1.0 + amp * (np.sin(5.0 * th) * np.cos(3.0 * ph) + 0.5 * np.sin(11.0 * ph + 2.0 * th)))
    return TriangleMesh(p=np.asarray(center, np.float64) + d * r[:, None], indices=m.indices, uv=m.uv)


def sss_room(n_side: int = 248, sss_res: int = 128, kd_res: int = 32) -> SceneDescription:
    """The mesh room's enclosure with a displaced sphere of 2 sss_res
    (sss_res - 1) triangles (32,512 at 128) in the measured "Skin1"
    subsurface material (eta 1.33, scale 20 as tools/fidelity.py's
    cross-check scene) and a UV sphere of 2 kd_res (kd_res - 1) triangles
    (1,984 at 32) in kdsubsurface with a constant Kd and mfp: path, depth 5.
    n_side 248: 158,146 triangles."""
    desc = mesh_room(n_side)
    sp, sa = MEDIUM_PRESETS["Skin1"]
    skin = _subsurface("subsurface", preset="Skin1", sigma_a=sa, sigma_s=sp, scale=20.0)
    kd = _subsurface("kdsubsurface", Kd=[0.75, 0.55, 0.35], mfp=[0.08, 0.05, 0.03])
    desc.primitives += [
        HostPrimitive(shape=ShapeRecord(mesh=_displaced_sphere([-0.9, 1.25, -0.8], 0.55, sss_res)), material=skin),
        HostPrimitive(shape=ShapeRecord(mesh=_uv_sphere([0.95, 1.15, -0.5], 0.45, kd_res, kd_res)), material=kd),
    ]
    return desc


def _animate(shape: ShapeRecord, ctm0: Transform, ctm1: Transform) -> ShapeRecord:
    """Give a shape made under ctm0 the shutter-close CTM ctm1: its
    keyframes, as parser.api's shape() computes them for the directives
    ActiveTransform EndTime / Transform / ActiveTransform All (write_pbrt
    writes those)."""
    rel = ctm1 @ ctm0.inverse()
    mid = AnimatedTransform(Transform(), rel, 0.0, 1.0).interpolate(0.5)
    key_pair = (np.asarray(ctm0.m, np.float64).copy(), np.asarray(ctm1.m, np.float64).copy())
    if shape.mesh is not None:
        p0 = np.asarray(shape.mesh.p, dtype=np.float64).reshape(-1, 3)
        shape.mesh.p_end = rel.xpoint(p0)
        shape.mesh.p_mid = mid.xpoint(p0)
        shape.mesh.anim = key_pair
    else:
        shape.sphere.object_to_world_end = rel @ shape.sphere.object_to_world
        shape.sphere.object_to_world_mid = mid @ shape.sphere.object_to_world
        shape.sphere.anim = key_pair
    return shape


def _about(center, rot: Transform) -> Transform:
    """rot about center: T(c) . rot . T(-c), as one from_matrix transform."""
    c = np.asarray(center, np.float64)
    return Transform.from_matrix(Transform.translate(c).m @ rot.m @ Transform.translate(-c).m)


MOTION_SPHERE = ([-1.2, 1.7, -1.2], 0.6)  # the spinning UV sphere's center and radius
MOTION_BOX = ([1.3, 1.6, -0.6], 0.6)  # the translating box's center and edge
MOTION_BALL = ([-2.2, 2.7, -2.0], [2.2, 2.7, -2.0], 0.35)  # the quadric's start, end and radius


def motion_room(n_side: int = 248, rotate: bool = True, sphere_res: int = 32,
                accelerator: str = "bvh") -> SceneDescription:
    """The mesh room with moving prims under a moving camera, path depth 5,
    (0,2) + box, power light selection (its docstring above). sphere_res:
    the UV sphere's rings and segments (2 res (res - 1) triangles: 1,984 at
    32); accelerator: "bvh" or "kdtree"."""
    desc = mesh_room(n_side)
    desc.accelerator = accelerator
    desc.transform_start_time, desc.transform_end_time = 0.0, 1.0
    ident = Transform()
    c, r = MOTION_SPHERE
    ball = _uv_sphere(c, r, sphere_res, sphere_res)
    spin = _about(c, Transform.rotate(30.0, [0.0, 1.0, 0.0])) if rotate else Transform.from_matrix(
        Transform.translate([0.0, 0.2, 0.0]).m)
    sphere = HostPrimitive(shape=_animate(ShapeRecord(mesh=ball), ident, spin),
                           material=HostMaterial(kind="plastic", params={"Kd": ("const", np.array([0.2, 0.35, 0.6])),
                                                                         "Ks": ("const", np.array([0.3, 0.3, 0.3]))}))
    bc, edge = MOTION_BOX
    verts, idx = _box(bc, edge)
    box = HostPrimitive(shape=_animate(ShapeRecord(mesh=TriangleMesh(p=verts, indices=idx)), ident,
                                       Transform.from_matrix(Transform.translate([0.3, 0.0, 0.0]).m)),
                        material=HostMaterial(kind="matte", params={"Kd": ("const", np.array([0.7, 0.55, 0.2]))}))
    q0, q1, qr = MOTION_BALL
    start = Transform.translate(q0)
    quad = HostPrimitive(shape=_animate(ShapeRecord(sphere=Sphere(object_to_world=start, radius=qr, z_min=-qr,
                                                                  z_max=qr)), start,
                                        Transform.from_matrix(Transform.translate(q1).m)),
                         material=HostMaterial(kind="matte", params={"Kd": ("const", np.array([0.6, 0.2, 0.2]))}))
    desc.primitives += [sphere, box, quad]
    # the camera dollies 0.25 forward and yaws 3 degrees over the shutter
    eye, look, up = (np.asarray(v, np.float64) for v in ROOM_LOOK_AT)
    yaw = Transform.rotate(3.0, [0.0, 1.0, 0.0]).m[:3, :3]
    fwd = (look - eye) / np.linalg.norm(look - eye)
    eye1 = eye + 0.25 * fwd
    c2w_end = Transform.look_at(eye1, eye1 + yaw @ (look - eye), up)
    desc.camera.camera_to_world_end = Transform.from_matrix(c2w_end.m_inv).inverse()
    return desc


LENS_FILE = "dgauss.dat"  # write_lens's file name


def write_lens(path: str) -> str:
    """Write the built-in double Gauss (realistic.DEFAULT_LENS) as a pbrt
    lens file: one row per element of curvature radius, thickness, index
    of refraction and aperture diameter, in mm. Returns path."""
    from .device.realistic import DEFAULT_LENS

    with open(path, "w") as f:
        f.write("# radius thickness eta aperture (mm), front element first\n")
        for row in DEFAULT_LENS:
            f.write(" ".join(repr(float(v)) for v in row) + "\n")
    return path


def realistic_mesh_room(n_side: int = 248, lens_dir: str | None = None, aperture: float = 4.0,
                        focus: float = 7.5) -> SceneDescription:
    """The mesh room under Camera "realistic": the lens file write_lens
    writes into lens_dir (a new temporary folder when None), the aperture
    diameter in mm, the focus distance on the far wall."""
    desc = mesh_room(n_side)
    lens = write_lens(os.path.join(lens_dir or tempfile.mkdtemp(prefix="pbrt_lens_"), LENS_FILE))
    desc.camera = CameraConfig(kind="realistic", camera_to_world=Transform.look_at(*ROOM_LOOK_AT), lens_file=lens,
                               aperture_diameter=aperture, focus_distance=focus)
    return desc


def _box(center, edge):
    """Closed axis-aligned box: 8 vertices, 12 triangles wound outward."""
    c = np.asarray(center, np.float64)
    corners = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (-0.5, 0.5)])
    # corner index = 4 * (x > 0) + 2 * (y > 0) + (z > 0); each face as a
    # quad (a, b, c, d) counter-clockwise seen from outside
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    idx = [t for a, b, cc, d in quads for t in ((a, b, cc), (a, cc, d))]
    return c + edge * corners, np.asarray(idx, np.int32)


def _grid_uv(n, u_rep=1.0, v_rep=1.0):
    """The (u, v) chart of a _grid_mesh patch of n x n cells: u and v run
    over [0, u_rep] and [0, v_rep] along the patch's two parameters."""
    t = np.linspace(0.0, 1.0, n + 1)
    gu, gv = np.meshgrid(t * u_rep, t * v_rep)
    return np.stack([gu, gv], axis=-1).reshape(-1, 2)


def material_room(n_side: int = 40, checker: bool = False) -> SceneDescription:
    """The mesh room at n_side 40 (3,842 triangles) with a closed glass box
    (12 triangles) added and its materials and lights changed so that one
    render exercises every lobe and light kind of the wide megakernel's
    class: plastic terrain, a mirror back wall, an Oren-Nayar left wall, a
    copper right wall, matte front wall and ceiling, the two-sided area
    panel, a point and a spot light, power light selection. 3,854
    triangles, under the wide megakernel's default cap of 4,096. checker:
    the terrain is matte instead, its Kd a checkerboard of two constant
    cells over a UV chart (8 x 8 cells across the floor)."""
    desc = mesh_room(n_side)
    terrain, back, _front, left, right, _ceiling, _panel = desc.primitives
    terrain.material = HostMaterial(kind="plastic", params={
        "Kd": _const([0.55, 0.45, 0.35]), "Ks": _const([0.4, 0.4, 0.4]), "roughness": ("const", 0.15)})
    back.material = HostMaterial(kind="mirror", params={"Kr": _const([0.9, 0.9, 0.9])})
    left.material = HostMaterial(kind="matte", params={"Kd": _const([0.55, 0.3, 0.3]), "sigma": ("const", 20.0)})
    right.material = HostMaterial(kind="metal", params={"roughness": ("const", 0.08)})
    desc.primitives.append(HostPrimitive(shape=ShapeRecord(mesh=TriangleMesh(*_box([1.5, 0.4, -1.5], 1.0))),
                                         material=HostMaterial(kind="glass", params={})))
    desc.lights = [
        HostLight(kind="point", from_point=np.array([-2.0, 2.5, -1.0]), intensity=np.array([6.0, 6.0, 6.0])),
        HostLight(kind="spot", from_point=np.array([2.0, 3.5, 1.0]), to_point=np.array([0.0, -0.5, -1.5]),
                  intensity=np.array([30.0, 28.0, 26.0]), cone_angle=30.0, cone_delta=18.0),
    ]
    if checker:
        terrain.shape.mesh.uv = _grid_uv(n_side)
        terrain.material = HostMaterial(kind="matte", params={"Kd": ("texture", _texture(
            "checkerboard", tex1=_const([0.8, 0.75, 0.7]), tex2=_const([0.25, 0.3, 0.35]), uscale=8.0,
            vscale=8.0))})
    return desc


# sphere_room's spheres: (center, radius, material kind, parameters)
_ROOM_SPHERES = (
    ([-2.0, 1.6, -1.0], 0.6, "glass", {}),
    ([0.0, 1.8, -2.2], 0.7, "mirror", {"Kr": [0.9, 0.9, 0.9]}),
    ([2.3, 2.2, 0.0], 0.5, "metal", {"roughness": 0.08}),
    ([-0.8, 1.2, 0.2], 0.45, "plastic", {"Kd": [0.2, 0.35, 0.6], "Ks": [0.4, 0.4, 0.4], "roughness": 0.12}),
    ([1.0, 2.6, -0.5], 0.4, "matte", {"Kd": [0.6, 0.55, 0.3], "sigma": 25.0}),
    ([-2.6, 2.8, 1.0], 0.5, "uber", {"Kd": [0.5, 0.2, 0.2], "Ks": [0.3, 0.3, 0.3], "roughness": 0.1}),
)
SPHERE_LAMP = ([0.6, 3.2, 1.0], 0.3, [12.0, 10.0, 8.0])  # center, radius, L


def _sphere(center, radius, material, light=None):
    return HostPrimitive(shape=ShapeRecord(sphere=Sphere(object_to_world=Transform.translate(center), radius=radius,
                                                         z_min=-radius, z_max=radius)),
                         material=material, area_light=light)


def _full_uber(params):
    """An uber row outside the megakernels' lobe sets: reflection,
    transmission and 70% opacity beside its Kd and Ks."""
    return dict(params, Kr=_const([0.3, 0.3, 0.3]), Kt=_const([0.3, 0.3, 0.3]), opacity=_const([0.7, 0.7, 0.7]))


def sphere_room(n_side: int = 40) -> SceneDescription:
    """material_room (3,854 triangles at n_side 40) with its left wall of
    glossy uber (Kd and Ks only) and seven full spheres: glass, mirror, GGX
    copper, plastic, Oren-Nayar, glossy uber and an emissive sphere lamp
    (a black matte sphere with a one-sided area light). Five lights: the
    panel's two triangles, the sphere lamp, the point and the spot, under
    power selection; 1000x500, 16 spp, depth 5. At n_side 248 the same
    spheres sit among the mesh room's 123,650 terrain and wall triangles."""
    desc = material_room(n_side)
    left = desc.primitives[3]
    left.material = HostMaterial(kind="uber", params={
        "Kd": _const([0.5, 0.45, 0.3]), "Ks": _const([0.25, 0.25, 0.25]), "roughness": ("const", 0.2)})
    for center, radius, kind, params in _ROOM_SPHERES:
        mat = HostMaterial(kind=kind, params={k: ("const", np.asarray(v, np.float64)) for k, v in params.items()})
        desc.primitives.append(_sphere(center, radius, mat))
    center, radius, emit = SPHERE_LAMP
    desc.primitives.append(_sphere(center, radius, HostMaterial(kind="matte", params={"Kd": _const([0.0, 0.0, 0.0])}),
                                   HostLight(kind="area", intensity=np.asarray(emit, np.float64))))
    return desc


def uber_room(n_side: int = 40) -> SceneDescription:
    """sphere_room with its uber wall and uber sphere made full (Kr, Kt and
    opacity 0.7 beside Kd and Ks): the wavefront renders it, and the wide
    megakernel refuses it by lobe set."""
    desc = sphere_room(n_side)
    for prim in desc.primitives:
        if prim.material.kind == "uber":
            prim.material = HostMaterial(kind="uber", params=_full_uber(prim.material.params))
    return desc


def _texture(kind, is_float=False, **fields) -> HostTexture:
    """A HostTexture as the parser makes one from a Texture directive
    (parser/api.py _make_texture): a mapped kind's planar axes and the
    texture-space transform of mapped and noise kinds at their defaults
    (the identity after WorldBegin), so that write_pbrt's file compiles to
    the same tables."""
    if kind in _MAPPED:
        fields.setdefault("v1", np.array([1.0, 0.0, 0.0]))
        fields.setdefault("v2", np.array([0.0, 1.0, 0.0]))
    if kind in _MAPPED or kind in ("fbm", "wrinkled", "marble", "windy"):
        fields.setdefault("world_to_texture", Transform())
    return HostTexture(kind=kind, is_float=is_float, **fields)


def _tiles(res: int, rs) -> np.ndarray:
    """A res x res RGB floor of 8 x 8 tiles: a color per tile, dark grout
    lines and a per-texel grain."""
    t = (np.arange(res) + 0.5) / res * 8.0
    fx, fy = np.meshgrid(t, t)
    colors = rs.uniform(0.3, 0.75, (8, 8, 3))
    img = colors[fy.astype(int) % 8, fx.astype(int) % 8]
    grout = ((fx % 1.0) < 0.05) | ((fy % 1.0) < 0.05)
    img = np.where(grout[..., None], 0.12, img) * (0.85 + 0.15 * rs.rand(res, res, 1))
    return img.astype(np.float32)


def _wallpaper(res: int, rs) -> np.ndarray:
    """A res x res RGB wallpaper: stripes and a diagonal wave, with grain."""
    t = (np.arange(res) + 0.5) / res
    x, y = np.meshgrid(t, t)
    base = 0.5 + 0.25 * np.sin(2 * np.pi * 12 * x)[..., None] * np.array([1.0, 0.6, 0.3])
    wave = 0.15 * np.sin(2 * np.pi * 6 * (x + y))[..., None]
    img = np.clip(base + wave, 0.05, 0.95) * (0.9 + 0.1 * rs.rand(res, res, 1))
    return img.astype(np.float32)


def _bricks(res: int) -> np.ndarray:
    """A res x res height field of raised bricks (grayscale RGB), for a
    bump map: 1 on the bricks, falling to 0 in the mortar."""
    t = (np.arange(res) + 0.5) / res
    x, y = np.meshgrid(t * 6.0, t * 12.0)
    x = x + 0.5 * (np.floor(y) % 2)
    d = np.minimum(np.minimum(x % 1.0, 1.0 - x % 1.0) * 2.0, np.minimum(y % 1.0, 1.0 - y % 1.0))
    h = np.clip(d / 0.2, 0.0, 1.0)
    return np.repeat(h[..., None], 3, axis=-1).astype(np.float32)


def textured_room(n_side: int = 40, floor_res: int = 1024, wall_res: int = 512, bump_res: int = 256,
                  seed: int = 11) -> SceneDescription:
    """The 1000x500, 16 spp, depth-5 textured room: material_room's
    geometry (3,854 triangles at n_side 40) with UV charts on the floor and
    walls and
    - the floor matte, Kd a floor_res^2 RGB tile imagemap, 4 x 4 repeats,
      EWA (pbrt's default);
    - the back wall matte, Kd a wall_res^2 RGB imagemap, trilinear;
    - the front wall matte, Kd a checkerboard (8 x 8);
    - the left wall matte, Kd a mix of two colors by an fbm amount, and a
      bump map, a bump_res^2 brick height imagemap;
    - the right wall plastic, Kd a scale of a marble texture;
    - the glass box, the ceiling, the area panel and the point and spot
      lights as material_room's;
    - halton with the gaussian filter (pbrt's defaults).
    Every image comes from numpy with the given seed."""
    rs = np.random.RandomState(seed)
    desc = material_room(n_side)
    terrain, back, front, left, right, ceiling = desc.primitives[:6]
    terrain.shape.mesh.uv = _grid_uv(n_side, 4.0, 4.0)
    for wall in (back, front, left, right, ceiling):
        wall.shape.mesh.uv = _grid_uv(8)
    floor_tex = _texture("imagemap", image=_tiles(floor_res, rs))
    wall_tex = _texture("imagemap", image=_wallpaper(wall_res, rs), trilinear=True)
    checker = _texture("checkerboard", tex1=_const([0.75, 0.7, 0.6]), tex2=_const([0.2, 0.25, 0.3]),
                       uscale=8.0, vscale=8.0)
    fbm = _texture("fbm", is_float=True, octaves=4)
    mix = _texture("mix", tex1=_const([0.6, 0.25, 0.2]), tex2=_const([0.2, 0.5, 0.6]), amount=("texture", fbm))
    marble = _texture("marble", octaves=4, scale=2.0)
    scaled = _texture("scale", tex1=("texture", marble), tex2=_const([0.8, 0.8, 0.8]))
    bump = _texture("imagemap", is_float=True, image=_bricks(bump_res), scale=0.02)
    terrain.material = HostMaterial(kind="matte", params={"Kd": ("texture", floor_tex)})
    back.material = HostMaterial(kind="matte", params={"Kd": ("texture", wall_tex)})
    front.material = HostMaterial(kind="matte", params={"Kd": ("texture", checker)})
    left.material = HostMaterial(kind="matte", params={"Kd": ("texture", mix)}, bump_map=("texture", bump))
    right.material = HostMaterial(kind="plastic", params={
        "Kd": ("texture", scaled), "Ks": _const([0.3, 0.3, 0.3]), "roughness": ("const", 0.1)})
    ceiling.material = HostMaterial(kind="matte", params={"Kd": _const([0.7, 0.7, 0.7])})
    desc.film.filter_name = "gaussian"
    desc.film.filter_params = dict(GAUSSIAN_DEFAULTS)
    desc.sampler = SamplerConfig(kind="halton", pixel_samples=16)
    return desc


def spheres_gallery() -> SceneDescription:
    """The 1000x500, 16 spp, depth-5 path-traced spheres gallery: 8 prims
    (2 ground triangles, 6 spheres), 3 delta lights."""
    ground = HostPrimitive(
        shape=ShapeRecord(mesh=TriangleMesh(
            p=np.array([[-20, -1, -20], [20, -1, -20], [20, -1, 20], [-20, -1, 20]], np.float64),
            indices=np.array([[0, 2, 1], [0, 3, 2]], np.int32),
            uv=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64))),
        material=HostMaterial(kind="matte", params={"Kd": _const([0.6, 0.5, 0.4])}))
    materials = [
        HostMaterial(kind="matte", params={"Kd": _const([0.7, 0.3, 0.3])}),
        HostMaterial(kind="matte", params={"Kd": _const([0.5, 0.55, 0.6]), "sigma": ("const", 20.0)}),
        HostMaterial(kind="mirror", params={"Kr": _const([0.9, 0.9, 0.9])}),
        HostMaterial(kind="glass", params={}),
        HostMaterial(kind="metal", params={"roughness": ("const", 0.08)}),
        HostMaterial(kind="plastic", params={"Kd": _const([0.6, 0.5, 0.4]), "Ks": _const([0.4, 0.4, 0.4]),
                                             "roughness": ("const", 0.2)}),
    ]
    spheres = [HostPrimitive(shape=ShapeRecord(sphere=Sphere(object_to_world=Transform.translate([x, 0.0, 0.0]),
                                                             radius=0.9)), material=m)
               for x, m in zip((-5.0, -3.0, -1.0, 1.0, 3.0, 5.0), materials)]
    lights = [
        HostLight(kind="distant", from_point=np.array([0.0, 10.0, 0.0]), to_point=np.zeros(3),
                  intensity=np.array([3.0, 3.0, 3.0])),
        HostLight(kind="point", from_point=np.array([0.0, 4.0, 2.0]), intensity=np.array([30.0, 28.0, 26.0])),
        HostLight(kind="spot", from_point=np.array([0.0, 5.0, 3.0]), to_point=np.array([0.0, -1.0, 0.0]),
                  intensity=np.array([55.0, 50.0, 45.0]), cone_angle=25.0, cone_delta=15.0),
    ]
    return SceneDescription(
        primitives=[ground] + spheres,
        lights=lights,
        camera=CameraConfig(kind="perspective",
                            camera_to_world=Transform.look_at([0, 2.5, 9], [0, -0.3, 0], [0, 1, 0]),
                            fov=40.0),
        film=FilmConfig(x_resolution=1000, y_resolution=500),
        sampler=SamplerConfig(kind="zerotwosequence", pixel_samples=16),
        integrator=IntegratorConfig(kind="path", max_depth=5, light_strategy="power"),
    )


def _grayscale_noise(res: int, rs, cells: int) -> np.ndarray:
    """A res x res grayscale (equal-channel) RGB image: smooth value noise
    on a cells x cells lattice, in [0.2, 0.8]."""
    lat = rs.rand(cells + 1, cells + 1)
    t = (np.arange(res) + 0.5) / res * cells
    i = np.minimum(t.astype(int), cells - 1)
    f = t - i
    f = f * f * (3.0 - 2.0 * f)
    row = lat[i] * (1 - f)[:, None] + lat[i + 1] * f[:, None]  # (res, cells + 1)
    g = row[:, i] * (1 - f)[None, :] + row[:, i + 1] * f[None, :]
    g = 0.2 + 0.6 * g
    return np.repeat(g[..., None], 3, axis=-1).astype(np.float32)


def textured_gallery(res: int = 128, seed: int = 5) -> SceneDescription:
    """spheres_gallery with grayscale imagemap Kds of res x res texels (at
    most 128, the brute megakernel's atlas class): the ground quad's (uv
    mapping, 8 x 8 repeats) and a backdrop quad's behind the spheres; 10
    prims. A textured sphere is outside that class (the reference's
    megakernel bakes no uv for spheres), so the spheres keep constant
    materials."""
    rs = np.random.RandomState(seed)
    desc = spheres_gallery()
    ground = desc.primitives[0]
    ground.material = HostMaterial(kind="matte", params={"Kd": ("texture", _texture(
        "imagemap", image=_grayscale_noise(res, rs, 8), uscale=8.0, vscale=8.0))})
    backdrop = HostPrimitive(
        shape=ShapeRecord(mesh=TriangleMesh(
            p=np.array([[-9, -1, -4], [9, -1, -4], [9, 5, -4], [-9, 5, -4]], np.float64),
            indices=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
            uv=np.array([[0, 0], [3, 0], [3, 1], [0, 1]], np.float64))),
        material=HostMaterial(kind="matte", params={"Kd": ("texture", _texture(
            "imagemap", image=_grayscale_noise(res, rs, 16)))}))
    desc.primitives.insert(1, backdrop)
    return desc


def _quad(a, b, c, d, material, light=None):
    """Quad a-b-c-d as two triangles (a, b, c), (a, c, d); its geometric
    normal is (b - a) x (c - a)."""
    return HostPrimitive(shape=ShapeRecord(mesh=TriangleMesh(p=np.array([a, b, c, d], np.float64),
                                                             indices=np.array([[0, 1, 2], [0, 2, 3]], np.int32))),
                         material=material, area_light=light)


def area_box(sphere_lamp: bool = False) -> SceneDescription:
    """The 1000x500, 16 spp, depth-5 path-traced area box: a box open toward
    the camera, its floor plastic, its back wall a mirror, its ceiling and
    side walls matte (10 triangles); a 1 x 1 one-sided quad light under the
    ceiling facing down (2 triangles, 2 lights) and a point light; a glass
    full sphere, a GGX copper full sphere and an Oren-Nayar (sigma 20)
    sphere clipped at z_max; pbrt's default light strategy ('spatial' over
    the 3 lights). 15 prims. sphere_lamp: the copper sphere emits too, a
    sphere lamp (4 lights)."""
    x0, x1, y0, y1, z0, z1 = -3.0, 3.0, 0.0, 3.0, -3.0, 2.0

    def matte(kd, **extra):
        return HostMaterial(kind="matte", params={"Kd": _const(kd), **extra})

    plastic = HostMaterial(kind="plastic", params={
        "Kd": _const([0.55, 0.45, 0.35]), "Ks": _const([0.4, 0.4, 0.4]), "roughness": ("const", 0.15)})
    walls = [
        _quad([x0, y0, z1], [x1, y0, z1], [x1, y0, z0], [x0, y0, z0], plastic),  # floor
        _quad([x0, y1, z0], [x1, y1, z0], [x1, y1, z1], [x0, y1, z1], matte([0.7, 0.7, 0.7])),  # ceiling
        _quad([x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
              HostMaterial(kind="mirror", params={"Kr": _const([0.9, 0.9, 0.9])})),  # back
        _quad([x0, y0, z1], [x0, y0, z0], [x0, y1, z0], [x0, y1, z1], matte([0.6, 0.25, 0.25])),  # left
        _quad([x1, y0, z0], [x1, y0, z1], [x1, y1, z1], [x1, y1, z0], matte([0.25, 0.6, 0.25])),  # right
    ]
    yl = y1 - 0.01
    light = _quad([-0.5, yl, -1.5], [0.5, yl, -1.5], [0.5, yl, -0.5], [-0.5, yl, -0.5], matte([0.0, 0.0, 0.0]),
                  light=HostLight(kind="area", intensity=np.array([10.0, 9.5, 9.0])))

    def sphere(center, radius, material, z_max=None):
        return HostPrimitive(shape=ShapeRecord(sphere=Sphere(
            object_to_world=Transform.translate(center), radius=radius, z_min=-radius,
            z_max=radius if z_max is None else z_max)), material=material)

    spheres = [
        sphere([-1.3, 0.7, -1.2], 0.7, HostMaterial(kind="glass", params={})),
        sphere([1.4, 0.7, -1.6], 0.7, HostMaterial(kind="metal", params={"roughness": ("const", 0.08)})),
        sphere([0.3, 0.6, 0.5], 0.6, matte([0.5, 0.55, 0.6], sigma=("const", 20.0)), z_max=0.3),
    ]
    if sphere_lamp:
        spheres[1].area_light = HostLight(kind="area", intensity=np.array([3.0, 2.5, 2.0]))
    return SceneDescription(
        primitives=walls + [light] + spheres,
        lights=[HostLight(kind="point", from_point=np.array([1.6, 2.2, 0.8]), intensity=np.array([4.0, 4.0, 4.0]))],
        camera=CameraConfig(kind="perspective",
                            camera_to_world=Transform.look_at([0, 1.6, 7.0], [0, 1.2, -1.0], [0, 1, 0]), fov=38.0),
        film=FilmConfig(x_resolution=1000, y_resolution=500),
        sampler=SamplerConfig(kind="zerotwosequence", pixel_samples=16),
        integrator=IntegratorConfig(kind="path", max_depth=5),
    )


# zoo_room's disney wall: the reference test's parameters (tests/test_materials2.py:39-48)
ZOO_DISNEY = {"color": [0.6, 0.4, 0.3], "metallic": 0.3, "roughness": 0.4, "clearcoat": 1.0,
              "clearcoatgloss": 0.8, "sheen": 0.5}
ZOO_TABLE = "rough_conductor_a0.3.bsdf"  # the fourier box's table, in table_dir


def _floor_height(x, z):
    """The mesh room's terrain height (mesh_room)."""
    return 0.9 * np.sin(1.7 * x) * np.cos(1.3 * z) + 0.25 * np.sin(6.1 * x + 2.0 * z)


def hair_tuft(center, n_curves: int = 32, n_segments: int = 64, seed: int = 7) -> TriangleMesh:
    """n_curves flat hair curves (cubic Beziers, tessellate_curve with
    n_segments segments: 2 n_segments triangles each, u along the fiber and
    v across it) rising from the terrain around center (x, z), as one mesh."""
    rs = np.random.RandomState(seed)
    ps, idx, ns, uvs = [], [], [], []
    for _ in range(n_curves):
        r, a = 0.25 * np.sqrt(rs.uniform()), rs.uniform(0.0, 2.0 * np.pi)
        x, z = center[0] + r * np.cos(a), center[1] + r * np.sin(a)
        lean = rs.uniform(0.0, 2.0 * np.pi)
        dx, dz = np.cos(lean), np.sin(lean)
        h = rs.uniform(0.5, 0.8)
        base = np.array([x, _floor_height(x, z) - 0.02, z])
        cp = base + np.array([[0.0, 0.0, 0.0], [0.1 * dx, 0.4 * h, 0.1 * dz], [0.3 * dx, 0.8 * h, 0.3 * dz],
                              [0.6 * dx, h, 0.6 * dz]])
        m = tessellate_curve(Transform(), cp, 0.03, 0.008, "flat", n_segments=n_segments)
        idx.append(np.asarray(m.indices) + sum(len(q) for q in ps))
        ps.append(m.p)
        ns.append(m.n)
        uvs.append(m.uv)
    return TriangleMesh(p=np.concatenate(ps), indices=np.concatenate(idx).astype(np.int32), n=np.concatenate(ns),
                        uv=np.concatenate(uvs))


def zoo_room(n_side: int = 40, textured: bool = False, table_dir: str | None = None,
             seed: int = 12) -> SceneDescription:
    """The 1000x500, 16 spp, depth-5 material zoo: material_room's meshes,
    lights, camera and (0,2) sampler with
    - the floor an anisotropic substrate (Kd 0.45/0.35/0.25, Ks 0.25,
      uroughness 0.05, vroughness 0.2);
    - the left wall disney (ZOO_DISNEY);
    - the right wall a mix of plastic and copper metal at amount 0.35;
    - the glass box a fourier box: a rough conductor (alpha 0.3) tabulated
      by write_rough_conductor_table into table_dir (a folder under the
      temporary directory when None);
    - a two-sided translucent quad (reflect 0.5, transmit 0.5) between the
      spot light and the floor;
    - a tuft of 32 flat hair curves (eumelanin 1.3) on the floor: 4,096
      triangles.
    7,952 triangles at n_side 40, 127,760 at n_side 248. textured: the mix
    amount is a uv checkerboard (8 x 8 cells of 0.2 and 0.8) and the
    substrate's Kd a 256 x 256 RGB tile imagemap made with numpy from seed."""
    desc = material_room(n_side)
    terrain, _back, _front, left, right, _ceiling, _panel, box = desc.primitives
    if table_dir is None:
        table_dir = os.path.join(tempfile.gettempdir(), "pbrt_tpu_torch_tables")
    os.makedirs(table_dir, exist_ok=True)
    table = os.path.join(table_dir, ZOO_TABLE)
    if not os.path.exists(table):
        write_rough_conductor_table(table, alpha=0.3)
    kd = _const([0.45, 0.35, 0.25])
    amount = _const([0.35, 0.35, 0.35])
    if textured:
        rs = np.random.RandomState(seed)
        terrain.shape.mesh.uv = _grid_uv(n_side, 4.0, 4.0)
        right.shape.mesh.uv = _grid_uv(8)
        kd = ("texture", _texture("imagemap", image=_tiles(256, rs)))
        amount = ("texture", _texture("checkerboard", tex1=_const([0.2, 0.2, 0.2]), tex2=_const([0.8, 0.8, 0.8]),
                                      uscale=8.0, vscale=8.0))
    terrain.material = HostMaterial(kind="substrate", params={
        "Kd": kd, "Ks": _const([0.25, 0.25, 0.25]), "uroughness": ("const", 0.05), "vroughness": ("const", 0.2)})
    left.material = HostMaterial(kind="disney", params={
        **{k: ("const", np.asarray(v, np.float64)) for k, v in ZOO_DISNEY.items()},
        "remaproughness": ("const", False)})
    plastic = HostMaterial(kind="plastic", params={
        "Kd": _const([0.2, 0.35, 0.6]), "Ks": _const([0.4, 0.4, 0.4]), "roughness": ("const", 0.12)})
    copper = HostMaterial(kind="metal", params={"roughness": ("const", 0.08)})
    right.material = HostMaterial(kind="mix", params={"amount": amount, "material1": ("material", plastic),
                                                      "material2": ("material", copper)})
    box.material = HostMaterial(kind="fourier", params={"bsdffile": ("const", table), "Kd": _const([0.5, 0.5, 0.5])})
    yq = 2.2
    desc.primitives.append(_quad([0.75, yq, -0.4], [1.95, yq, -0.4], [1.95, yq, 0.8], [0.75, yq, 0.8],
                                 HostMaterial(kind="translucent", params={
                                     "Kd": _const([0.6, 0.6, 0.5]), "Ks": _const([0.25, 0.25, 0.25]),
                                     "roughness": ("const", 0.1), "reflect": _const([0.5, 0.5, 0.5]),
                                     "transmit": _const([0.5, 0.5, 0.5])})))
    desc.primitives.append(HostPrimitive(shape=ShapeRecord(mesh=hair_tuft((-1.0, 0.6))),
                                         material=HostMaterial(kind="hair", params={"eumelanin": ("const", 1.3)})))
    return desc


def _uv_sphere(center, radius, n_theta, n_phi):
    """UV-sphere mesh (tests/test_megakernel_wide.py _uv_sphere) with
    analytic per-vertex normals and the (phi / 2pi, theta / pi) chart:
    2 n_phi (n_theta - 1) triangles."""
    th = np.linspace(0.0, np.pi, n_theta + 1)
    ph = np.linspace(0.0, 2 * np.pi, n_phi, endpoint=False)
    gt, gp = np.meshgrid(th, ph, indexing="ij")
    norms = np.stack([np.sin(gt) * np.cos(gp), np.cos(gt), np.sin(gt) * np.sin(gp)], axis=-1).reshape(-1, 3)
    uv = np.stack([gp / (2 * np.pi), gt / np.pi], axis=-1).reshape(-1, 2)
    idx = []
    for i in range(n_theta):
        for j in range(n_phi):
            a = i * n_phi + j
            b = i * n_phi + (j + 1) % n_phi
            c = (i + 1) * n_phi + j
            d = (i + 1) * n_phi + (j + 1) % n_phi
            if i > 0:
                idx.append([a, c, b])
            if i < n_theta - 1:
                idx.append([b, c, d])
    return TriangleMesh(p=np.asarray(center, np.float64) + radius * norms, indices=np.asarray(idx, np.int32),
                        n=norms, uv=uv)


# quadric_room's quadrics: per kind, five (parameters, material, extra)
# rows; placed on a 6 x 5 grid (a column per kind) standing upright
_QUADRIC_MATERIALS = (
    ("matte", {"Kd": [0.6, 0.5, 0.35]}),
    ("plastic", {"Kd": [0.2, 0.35, 0.6], "Ks": [0.4, 0.4, 0.4], "roughness": 0.12}),
    ("glass", {}),
    ("metal", {"roughness": 0.08}),
    ("matte", {"Kd": [0.35, 0.6, 0.4], "sigma": 20.0}),
)
_QUADRICS = (
    ("sphere", ({"radius": 0.3}, {"radius": 0.3, "z_min": -0.15, "z_max": 0.25, "phi_max": np.radians(270.0)},
                {"radius": 0.25}, {"radius": 0.35, "z_min": -0.35, "z_max": 0.1}, {"radius": 0.2})),
    ("cylinder", ({"radius": 0.2, "z_min": -0.3, "z_max": 0.3}, {"radius": 0.25, "z_min": -0.2, "z_max": 0.35,
                                                               "phi_max": np.radians(200.0)},
                  {"radius": 0.15, "z_min": -0.35, "z_max": 0.35}, {"radius": 0.22, "z_min": 0.0, "z_max": 0.4},
                  {"radius": 0.12, "z_min": -0.25, "z_max": 0.25})),
    ("disk", ({"radius": 0.3}, {"radius": 0.3, "inner_radius": 0.12}, {"radius": 0.25, "phi_max": np.radians(300.0)},
              {"radius": 0.2, "height": 0.1}, {"radius": 0.28, "inner_radius": 0.05})),
    ("cone", ({"radius": 0.25, "height": 0.5}, {"radius": 0.3, "height": 0.4, "phi_max": np.radians(240.0)},
              {"radius": 0.2, "height": 0.6}, {"radius": 0.15, "height": 0.3}, {"radius": 0.28, "height": 0.45})),
    ("paraboloid", ({"radius": 0.3, "z_min": 0.0, "z_max": 0.5}, {"radius": 0.25, "z_min": 0.1, "z_max": 0.4},
                    {"radius": 0.2, "z_min": 0.0, "z_max": 0.3, "phi_max": np.radians(220.0)},
                    {"radius": 0.3, "z_min": 0.0, "z_max": 0.25}, {"radius": 0.18, "z_min": 0.0, "z_max": 0.45})),
    ("hyperboloid", ({"p1": [0.25, 0.0, -0.3], "p2": [0.0, 0.25, 0.3]},
                     {"p1": [0.2, 0.0, -0.3], "p2": [0.1, 0.2, 0.3], "phi_max": np.radians(250.0)},
                     {"p1": [0.3, 0.0, -0.25], "p2": [0.3, 0.0, 0.25]}, {"p1": [0.1, 0.0, -0.3], "p2": [0.25, 0.1, 0.3]},
                     {"p1": [0.22, -0.1, -0.2], "p2": [-0.1, 0.22, 0.3]})),
)
QUADRIC_LIGHTS = {("disk", 0): [9.0, 8.0, 7.0], ("cylinder", 4): [6.0, 7.0, 9.0]}  # (kind, row) -> L


def _quadric(kind, params, o2w, material, light=None):
    fields = dict(params)
    for k in ("p1", "p2"):
        if k in fields:
            fields[k] = np.asarray(fields[k], np.float64)
    if kind == "sphere":
        fields.setdefault("z_min", -fields["radius"])
        fields.setdefault("z_max", fields["radius"])
    return HostPrimitive(shape=ShapeRecord(sphere=Sphere(object_to_world=o2w, kind=kind, **fields)),
                         material=material, area_light=light)


def _alpha_panel(n: int = 16, res: int = 64, seed: int = 3):
    """A vertical 1.6 x 1.6 panel of 2 n^2 triangles (512 at n 16) with a
    UV chart, an alpha cutout (a float imagemap of round holes and
    random speckle) and a shadow-alpha one (a float imagemap of stripes);
    both images from numpy with the given seed."""
    rs = np.random.RandomState(seed)
    verts, idx = _grid_mesh(lambda u, v: (u, v, np.full_like(u, -0.6)), -0.8, 0.8, 0.9, 2.5, n)
    t = (np.arange(res) + 0.5) / res
    x, y = np.meshgrid(t * 4.0, t * 4.0)
    holes = ((x % 1.0 - 0.5) ** 2 + (y % 1.0 - 0.5) ** 2 < 0.09) | (rs.rand(res, res) < 0.05)
    alpha_img = np.repeat(np.where(holes, 0.0, 1.0)[..., None], 3, axis=-1).astype(np.float32)
    stripes = np.repeat(np.where((x * 2.0) % 1.0 < 0.35, 0.0, 1.0)[..., None], 3, axis=-1).astype(np.float32)
    mesh = TriangleMesh(p=verts, indices=idx, uv=_grid_uv(n),
                        alpha_texture=_texture("imagemap", is_float=True, image=alpha_img),
                        shadow_alpha_texture=_texture("imagemap", is_float=True, image=stripes))
    return HostPrimitive(shape=ShapeRecord(mesh=mesh),
                         material=HostMaterial(kind="matte", params={"Kd": _const([0.7, 0.3, 0.2])}))


def _image_light_maps(seed: int = 9):
    """The goniometric light's 64 x 32 map (a lobed pattern over theta and
    phi) and the projection light's 32 x 32 image (colored squares)."""
    rs = np.random.RandomState(seed)
    th = (np.arange(32) + 0.5) / 32 * np.pi
    ph = (np.arange(64) + 0.5) / 64 * 2 * np.pi
    gp, gt = np.meshgrid(ph, th)
    lobe = 0.3 + np.abs(np.cos(3.0 * gp)) * np.sin(gt) ** 2
    gonio = (lobe[..., None] * np.array([1.0, 0.9, 0.7])).astype(np.float32)
    proj = np.kron(rs.uniform(0.1, 1.0, (4, 4, 3)), np.ones((8, 8, 1))).astype(np.float32)
    return gonio, proj


def _placed(t: Transform) -> Transform:
    """t as a Transform directive gives it (the matrix, its inverse by
    np.linalg.inv), so that write_pbrt's file compiles to the same tables."""
    return Transform.from_matrix(t.m)


def _upright(center, deg=-90.0):
    """Object -> world of a quadric standing along +y (deg -90 about x) at
    center."""
    return _placed(Transform.translate(center) @ Transform.rotate(deg, [1.0, 0.0, 0.0]))


def quadric_room(n_side: int = 248, instances: int | bool = True, accelerator: str = "bvh",
                 prop_res: int = 32) -> SceneDescription:
    """The mesh room's enclosure (123,650 triangles at n_side 248, its
    two-sided ceiling lamp) with the rest of the persistent wavefront's
    class in it:
    - 30 quadrics, 5 of each kind (sphere, cylinder, disk, cone, paraboloid,
      hyperboloid) standing on a 6 x 5 grid above the floor, among them
      partial ones (a partial sphere, a partial-phimax hyperboloid), in
      matte, plastic, glass, metal and Oren-Nayar materials; one disk and
      one cylinder are area lights;
    - a goniometric light with a 64 x 32 map and a projection light with
      a 32 x 32 image (_image_light_maps);
    - a 512-triangle panel with an alpha and a shadow-alpha cutout
      (_alpha_panel);
    - with `instances`, a 1,984-triangle prop (a UV sphere with per-vertex
      normals and a chart) instanced 64 times on an 8 x 8 grid under the ceiling, with
      rotations, anisotropic scales and one mirrored instance (126,976
      instanced triangles: 251,168 prims in all at n_side 248);
    - the given accelerator ("bvh" or "kdtree"); 1000 x 500, 16 spp,
      depth 5, power light selection.
    An int `instances` places that many of the 64 instances, and prop_res
    sets the prop's UV-sphere resolution (2 prop_res (prop_res - 1)
    triangles), for small test scenes.
    The reference builds its kd-tree by Python recursion: keep the kd
    variant small (n_side 40, without instances)."""
    desc = mesh_room(n_side)
    for q, (kind, rows) in enumerate(_QUADRICS):
        for j, params in enumerate(rows):
            mk, mp = _QUADRIC_MATERIALS[j]
            mat = HostMaterial(kind=mk, params={k: ("const", np.asarray(v, np.float64)) for k, v in mp.items()})
            center = [-3.2 + 1.28 * q, 1.75, -3.2 + 1.0 * j]
            light = None
            emit = QUADRIC_LIGHTS.get((kind, j))
            if emit is not None:
                # the lamps hang near the ceiling, facing down
                center = [-2.0 + 4.0 * (kind == "cylinder"), 3.5, -1.0]
                light = HostLight(kind="area", intensity=np.asarray(emit, np.float64), two_sided=kind == "cylinder")
                mat = HostMaterial(kind="matte", params={"Kd": _const([0.1, 0.1, 0.1])})
            desc.primitives.append(_quadric(kind, params, _upright(center, 90.0 if kind == "disk" else -90.0),
                                            mat, light))
    desc.primitives.append(_alpha_panel())
    gonio, proj = _image_light_maps()
    desc.lights = [
        HostLight(kind="goniometric", light_to_world=_upright([-2.5, 3.2, 1.5], 90.0),
                  intensity=np.array([3.0, 3.0, 3.0]), image=gonio, map_name="gonio.pfm"),
        HostLight(kind="projection", light_to_world=_upright([2.5, 3.4, 2.0], 126.87),
                  intensity=np.array([8.0, 8.0, 8.0]), image=proj, map_name="proj.pfm", cone_angle=40.0),
    ]
    if instances:
        # a smooth prop; the parser transforms and normalises the
        # per-vertex normals it reads (parser/api.py: _normed(o2w.xnormal(n)),
        # whose product turns a -0.0 into 0.0), so the prop's go through the
        # same two functions, and a written file compiles to its tables bit
        # for bit
        prop = _uv_sphere([0.0, 0.0, 0.0], 1.0, prop_res, prop_res)
        prop.n = _normed(Transform.identity().xnormal(prop.n))
        mat = HostMaterial(kind="plastic", params={"Kd": _const([0.5, 0.3, 0.15]), "Ks": _const([0.3, 0.3, 0.3]),
                                                   "roughness": ("const", np.asarray(0.1))})
        rs = np.random.RandomState(17)
        for i in range(64 if instances is True else int(instances)):
            gx, gz = i % 8, i // 8
            s = rs.uniform(0.12, 0.22, 3)
            if i == 5:
                s[0] = -s[0]  # the mirrored instance
            i2w = _placed(Transform.translate([-3.5 + gx, 3.0 + 0.2 * rs.rand(), -3.5 + gz * 0.8])
                          @ Transform.rotate(float(rs.uniform(0, 360)), rs.uniform(-1, 1, 3)) @ Transform.scale(*s))
            desc.primitives.append(HostPrimitive(shape=ShapeRecord(mesh=prop), material=mat, instance_transform=i2w))
    desc.accelerator = accelerator
    return desc


def camera_room(kind: str, n_side: int = 40) -> SceneDescription:
    """material_room(checker=True) under an orthographic camera (its screen
    window fitted to the room, along the rooms' view) or under an
    environment camera at the room's center, 1000 x 500, with
    quadric_room's alpha panel added (the environment one)."""
    desc = material_room(n_side, checker=True)
    if kind == "orthographic":
        desc.camera = CameraConfig(kind="orthographic", camera_to_world=Transform.look_at(*ROOM_LOOK_AT),
                                   screen_window=(-3.9, 3.9, -1.95, 1.95))
    elif kind == "environment":
        desc.camera = CameraConfig(kind="environment",
                                   camera_to_world=Transform.look_at([0.0, 1.8, 0.0], [0.0, 1.8, -1.0], [0, 1, 0]))
        desc.primitives.append(_alpha_panel())
    else:
        raise ValueError(f"camera_room takes 'orthographic' or 'environment', not {kind!r}")
    return desc


# the parser's parameters of a bare PixelFilter "gaussian"
GAUSSIAN_DEFAULTS = {"xwidth": 2.0, "ywidth": 2.0, "alpha": 2.0, "B": 1.0 / 3.0, "C": 1.0 / 3.0, "tau": 3.0}
# (eye, look, up) of sky_meshes' camera
SKY_LOOK_AT = ([0.0, 1.7, 7.5], [0.0, 0.3, 0.0], [0, 1, 0])


def sky_meshes(n_ground: int = 24, n_theta: int = 14, n_phi: int = 20) -> SceneDescription:
    """The 1000x500, 16 spp, depth-5 sky scene: a 2 n_ground^2-triangle
    displaced ground and four spheres of 2 n_phi (n_theta - 1) triangles
    each (3,232 triangles at the defaults, under the wide megakernel's cap
    of 4,096)."""
    ground = HostPrimitive(
        shape=ShapeRecord(mesh=TriangleMesh(*_grid_mesh(
            lambda x, z: (x, 0.35 * np.sin(0.9 * x) * np.cos(0.7 * z) - 1.0, z), -12, 12, -12, 12, n_ground))),
        material=HostMaterial(kind="matte", params={"Kd": _const([0.5, 0.45, 0.35])}))
    materials = [
        HostMaterial(kind="matte", params={"Kd": _const([0.7, 0.25, 0.2])}),
        HostMaterial(kind="plastic", params={"Kd": _const([0.2, 0.35, 0.6]), "Ks": _const([0.4, 0.4, 0.4]),
                                             "roughness": ("const", 0.1)}),
        HostMaterial(kind="metal", params={"roughness": ("const", 0.05)}),
        HostMaterial(kind="glass", params={}),
    ]
    spheres = [HostPrimitive(shape=ShapeRecord(mesh=_uv_sphere([x, -0.1, z], 0.9, n_theta, n_phi)), material=m)
               for (x, z), m in zip(((-3.0, -0.5), (-1.0, 0.5), (1.0, -0.5), (3.0, 0.5)), materials)]
    return SceneDescription(
        primitives=[ground] + spheres,
        lights=[HostLight(kind="infinite", intensity=np.array([0.4, 0.5, 0.7])),
                HostLight(kind="distant", from_point=np.array([3.0, 8.0, 2.0]), to_point=np.zeros(3),
                          intensity=np.array([2.5, 2.3, 2.0]))],
        camera=CameraConfig(kind="perspective", camera_to_world=Transform.look_at(*SKY_LOOK_AT), fov=45.0),
        film=FilmConfig(x_resolution=1000, y_resolution=500, filter_name="gaussian",
                        filter_params=dict(GAUSSIAN_DEFAULTS)),
        sampler=SamplerConfig(kind="halton", pixel_samples=16),
        integrator=IntegratorConfig(kind="path", max_depth=5, light_strategy="power"),
    )


def _fmt(values) -> str:
    return " ".join(repr(float(v)) for v in np.ravel(values))


def _param(name, src, tex_names=None) -> str:
    if src[0] == "texture":
        return f'"texture {name}" "{tex_names[id(src[1])]}"'
    if isinstance(src[1], (bool, np.bool_)):
        return f'"bool {name}" {"true" if src[1] else "false"}'
    if isinstance(src[1], str):
        return f'"string {name}" "{src[1]}"'
    v = np.ravel(np.asarray(src[1], np.float64))
    return f'"rgb {name}" [{_fmt(v)}]' if v.size == 3 else f'"float {name}" [{_fmt(v)}]'


def _material_params(mat, tex_names, folder, named) -> str:
    """The parameter list of a Material (or MakeNamedMaterial) directive:
    a mix names its sub-materials (named: id -> name, written before it),
    a fourier material's table is copied beside the file."""
    params = []
    for k, v in mat.params.items():
        if k == "preset":  # a subsurface material's measured medium
            params.append(f'"string name" "{v[1]}"')
        elif v[0] == "material":
            params.append(f'"string named{k}" "{named[id(v[1])]}"')
        elif k == "bsdffile":
            name = os.path.basename(v[1])
            if os.path.abspath(v[1]) != os.path.join(folder, name):
                shutil.copyfile(v[1], os.path.join(folder, name))
            params.append(f'"string bsdffile" "{name}"')
        else:
            params.append(_param(k, v, tex_names))
    if mat.bump_map is not None:
        params.append(_param("bumpmap", mat.bump_map, tex_names))
    return " ".join(params)


# the children a texture kind reads, by the parameter names of its Texture
# directive (parser/api.py _make_texture)
_TEX_CHILDREN = {"scale": (("tex1", "tex1"), ("tex2", "tex2")),
                 "mix": (("tex1", "tex1"), ("tex2", "tex2"), ("amount", "amount")),
                 "checkerboard": (("tex1", "tex1"), ("tex2", "tex2")),
                 "bilerp": (("tex1", "v00"), ("tex2", "v11"), ("v01", "v01"), ("v10", "v10")),
                 "dots": (("tex1", "inside"), ("tex2", "outside"))}
_MAPPED = ("imagemap", "checkerboard", "uv", "bilerp", "dots")


def _texture_lines(desc: SceneDescription, folder: str) -> tuple[list[str], dict]:
    """Texture directives for every texture the materials read (children
    before parents), each imagemap's image written beside the file as
    t<i>.pfm (float32, exact); returns the lines and id(texture) -> name."""
    from .core.imageio import write_image

    names: dict[int, str] = {}
    lines: list[str] = []

    def child_param(name, src, is_float):
        if src is None:
            return ""
        if src[0] == "texture":
            return f' "texture {name}" "{visit(src[1])}"'
        v = np.ravel(np.asarray(src[1], np.float64))
        kind = "float" if is_float or v.size == 1 else "rgb"
        return f' "{kind} {name}" [{_fmt(v)}]'

    def visit(tex) -> str:
        if id(tex) in names:
            return names[id(tex)]
        params = ""
        for field, pname in _TEX_CHILDREN.get(tex.kind, ()):
            params += child_param(pname, getattr(tex, field), tex.is_float or field == "amount")
        name = f"t{len(names)}"
        if tex.kind == "constant":
            v = np.ravel(np.asarray(tex.value, np.float64))
            params += f' "{"float" if tex.is_float or v.size == 1 else "rgb"} value" [{_fmt(v)}]'
        elif tex.kind == "imagemap":
            write_image(os.path.join(folder, f"{name}.pfm"), np.asarray(tex.image, np.float32))
            params += (f' "string filename" "{name}.pfm" "string wrap" "{tex.wrap}" "float scale" [{_fmt([tex.scale])}]'
                       f' "bool trilinear" {"true" if tex.trilinear else "false"}'
                       f' "float maxanisotropy" [{_fmt([tex.max_aniso])}]')
        elif tex.kind == "checkerboard":
            params += f' "integer dimension" [{int(tex.dimension)}]'
        elif tex.kind in ("fbm", "wrinkled", "marble"):
            params += f' "integer octaves" [{int(tex.octaves)}] "float roughness" [{_fmt([tex.roughness])}]'
            if tex.kind == "marble":
                params += f' "float scale" [{_fmt([tex.scale])}] "float variation" [{_fmt([tex.variation])}]'
        elif tex.kind not in _TEX_CHILDREN and tex.kind not in ("uv", "windy"):
            raise NotImplementedError(f"write_pbrt does not write '{tex.kind}' textures")
        if tex.kind in _MAPPED:
            params += (f' "string mapping" "{tex.mapping}" "float uscale" [{_fmt([tex.uscale])}]'
                       f' "float vscale" [{_fmt([tex.vscale])}] "float udelta" [{_fmt([tex.udelta])}]'
                       f' "float vdelta" [{_fmt([tex.vdelta])}]')
            if tex.mapping == "planar":
                params += f' "vector v1" [{_fmt(tex.v1)}] "vector v2" [{_fmt(tex.v2)}]'
        lines.append(f'Texture "{name}" "{"float" if tex.is_float else "spectrum"}" "{tex.kind}"{params}')
        names[id(tex)] = name
        return name

    def visit_material(mat):
        for src in list(mat.params.values()) + [mat.bump_map]:
            if isinstance(src, tuple) and src and src[0] == "texture":
                visit(src[1])
            elif isinstance(src, tuple) and src and src[0] == "material":
                visit_material(src[1])

    for prim in desc.primitives:
        visit_material(prim.material)
        mesh = prim.shape.mesh
        for tex in (mesh.alpha_texture, mesh.shadow_alpha_texture) if mesh is not None else ():
            if tex is not None:
                visit(tex)
    return lines, names


def _transform_line(t: Transform) -> str:
    """The directive that makes the CTM (identity before it) equal t bit
    for bit, matrix and inverse: Translate for a translation,
    Transform (column-major) for a Transform.from_matrix."""
    tr = Transform.translate(t.m[:3, 3])
    if np.array_equal(tr.m, t.m) and np.array_equal(tr.m_inv, t.m_inv):
        return f"Translate {_fmt(t.m[:3, 3])}"
    if np.array_equal(np.linalg.inv(t.m), t.m_inv):
        return f"Transform {_fmt(t.m.T.ravel())}"
    raise NotImplementedError("write_pbrt writes transforms made by Translate or Transform.from_matrix only")


def _degrees(rad: float) -> float:
    """A phimax in degrees that the parser's math.radians maps back to rad."""
    deg = float(np.degrees(rad))
    for cand in (deg, np.nextafter(deg, np.inf), np.nextafter(deg, -np.inf)):
        if math.radians(float(cand)) == rad:
            return float(cand)
    raise NotImplementedError(f"write_pbrt cannot write phimax {rad!r} exactly")


def _quadric_shape(sph) -> str:
    """The Shape directive of a quadric (the parser's parameter names)."""
    phi = f'"float phimax" [{_fmt([_degrees(sph.phi_max)])}]'
    if sph.kind in ("sphere", "cylinder", "paraboloid"):
        return (f'Shape "{sph.kind}" "float radius" [{_fmt([sph.radius])}] "float zmin" [{_fmt([sph.z_min])}] '
                f'"float zmax" [{_fmt([sph.z_max])}] {phi}')
    if sph.kind == "disk":
        return (f'Shape "disk" "float radius" [{_fmt([sph.radius])}] "float height" [{_fmt([sph.height])}] '
                f'"float innerradius" [{_fmt([sph.inner_radius])}] {phi}')
    if sph.kind == "cone":
        return f'Shape "cone" "float radius" [{_fmt([sph.radius])}] "float height" [{_fmt([sph.height])}] {phi}'
    return f'Shape "hyperboloid" "point p1" [{_fmt(sph.p1)}] "point p2" [{_fmt(sph.p2)}] {phi}'


def _moving(desc) -> bool:
    """Some prim or the camera moves over the shutter."""
    return desc.camera.camera_to_world_end is not None or any(
        (p.shape.mesh or p.shape.sphere).anim is not None for p in desc.primitives)


def write_pbrt(desc: SceneDescription, path: str, look_at, sampler: bool = True) -> None:
    """Write a scene of triangle meshes (with their normals, UVs and alpha
    cutouts), quadrics of the six kinds and instanced meshes (an
    ObjectBegin block per prototype before its first ObjectInstance), with
    materials of constant or textured parameters and bump maps (each
    texture a Texture directive, each imagemap a PFM image beside the
    file), area lights on meshes and quadrics, point, spot, distant,
    goniometric and projection lights (their maps as PFM images beside the
    file) and infinite lights (a map named by its file name, relative to
    the .pbrt file) as a .pbrt file: a LookAt camera (look_at = (eye, look,
    up), the one the description's camera was made with; a perspective,
    orthographic, environment or realistic camera, its shutter-close
    transform, the shutter and TransformTimes when something moves), the
    moving shapes' shutter-close CTMs (ActiveTransform EndTime), the film,
    pixel filter,
    integrator, the accelerator, participating media (MakeNamedMedium,
    homogeneous or a grid with its densities, each prim's MediumInterface
    and the camera's medium), the interface material (Material "none") and
    subsurface materials (a measured medium by its "name") and, when
    `sampler`, the Sampler directive
    (without it the file gets pbrt's default, halton at 16 spp). Mesh i
    goes into mesh_<i>.ply beside the file (binary, catprint._write_ply
    with float64 positions, so the tables compile bit for bit as the
    description's); a mesh with an alpha cutout is written inline (a PLY
    carries no alpha); each shape gets its own Material directive, as each
    of the description's does. Quadrics, lights and instances are placed
    by Translate or Transform directives (_transform_line)."""
    from .core.imageio import write_image
    from .parser.catprint import _write_ply

    folder = os.path.dirname(os.path.abspath(path))
    cam, film, integ = desc.camera, desc.film, desc.integrator
    out = [f"LookAt {_fmt(np.concatenate([np.ravel(v) for v in look_at]))}"]
    if cam.camera_to_world_end is not None:
        # the shutter-close camera: its world-to-camera as the end CTM
        out += ["ActiveTransform EndTime", f"Transform {_fmt(cam.camera_to_world_end.m_inv.T.ravel())}",
                "ActiveTransform All"]
    if (desc.transform_start_time, desc.transform_end_time) != (0.0, 1.0) or _moving(desc):
        out.append(f"TransformTimes {_fmt([desc.transform_start_time])} {_fmt([desc.transform_end_time])}")
    shutter = ""
    if (cam.shutter_open, cam.shutter_close) != (0.0, 1.0) or _moving(desc):
        shutter = f' "float shutteropen" [{_fmt([cam.shutter_open])}] "float shutterclose" [{_fmt([cam.shutter_close])}]'
    if cam.kind == "perspective":
        out.append(f'Camera "perspective" "float fov" [{_fmt([cam.fov])}]{shutter}')
    elif cam.kind == "realistic":
        out.append(f'Camera "realistic" "string lensfile" "{cam.lens_file}" '
                   f'"float aperturediameter" [{_fmt([cam.aperture_diameter])}] '
                   f'"float focusdistance" [{_fmt([cam.focus_distance])}]{shutter}')
    elif cam.kind == "orthographic":
        window = f' "float screenwindow" [{_fmt(cam.screen_window)}]' if cam.screen_window is not None else ""
        out.append(f'Camera "orthographic"{window}')
    else:
        out.append(f'Camera "{cam.kind}"')
    out.append(f'Film "image" "integer xresolution" [{film.x_resolution}] "integer yresolution" [{film.y_resolution}]')
    if sampler:
        kind = "02sequence" if desc.sampler.kind == "zerotwosequence" else desc.sampler.kind
        out.append(f'Sampler "{kind}" "integer pixelsamples" [{desc.sampler.pixel_samples}]')
    if film.filter_name != "box":
        out.append(f'PixelFilter "{film.filter_name}"')
    if str(desc.accelerator or "bvh") != "bvh":
        out.append(f'Accelerator "{desc.accelerator}"')
    if desc.camera_medium:
        # the camera's medium is the outside medium current at Camera
        out.insert(1, f'MediumInterface "" "{desc.camera_medium}"')
    extra = ""
    if integ.kind == "mlt":
        extra = (f' "integer mutationsperpixel" [{integ.mutations_per_pixel}] "integer bootstrapsamples" '
                 f'[{integ.n_bootstrap}] "integer chains" [{integ.n_chains}] "float largestepprobability" '
                 f'[{_fmt([integ.large_step_probability])}] "float sigma" [{_fmt([integ.sigma])}]')
    elif integ.kind == "sppm":
        extra = (f' "integer numiterations" [{integ.num_iterations}] "integer photonsperiteration" '
                 f'[{integ.photons_per_iteration}] "float radius" [{_fmt([integ.initial_radius])}]')
        if integ.write_frequency < 1 << 31:
            extra += f' "integer imagewritefrequency" [{integ.write_frequency}]'
    out += [f'Integrator "{integ.kind}" "integer maxdepth" [{integ.max_depth}] '
            f'"string lightsamplestrategy" "{integ.light_strategy}"' + extra, "WorldBegin"]
    for name, hm in desc.media.items():
        if not (np.array_equal(hm.medium_to_world.m, np.eye(4)) and np.array_equal(hm.medium_to_world.m_inv, np.eye(4))):
            raise NotImplementedError("write_pbrt writes media with the identity transform only")
        params = (f'"rgb sigma_a" [{_fmt(hm.sigma_a)}] "rgb sigma_s" [{_fmt(hm.sigma_s)}] '
                  f'"float g" [{_fmt([hm.g])}]')
        if hm.kind == "heterogeneous":
            params += (f' "integer nx" [{hm.nx}] "integer ny" [{hm.ny}] "integer nz" [{hm.nz}]'
                       f' "point p0" [{_fmt(hm.p0)}] "point p1" [{_fmt(hm.p1)}] "float density" [{_fmt(hm.density)}]')
        out.append(f'MakeNamedMedium "{name}" "string type" "{hm.kind}" {params}')
    for li, hl in enumerate(desc.lights):
        if hl.kind == "point":
            out.append(f'LightSource "point" "point from" [{_fmt(hl.from_point)}] "rgb I" [{_fmt(hl.intensity)}]')
        elif hl.kind in ("spot", "distant"):
            field = "I" if hl.kind == "spot" else "L"
            extra = (f' "float coneangle" [{_fmt([hl.cone_angle])}] "float conedeltaangle" [{_fmt([hl.cone_delta])}]'
                     if hl.kind == "spot" else "")
            out.append(f'LightSource "{hl.kind}" "point from" [{_fmt(hl.from_point)}] "point to" [{_fmt(hl.to_point)}] '
                       f'"rgb {field}" [{_fmt(hl.intensity)}]{extra}')
        elif hl.kind == "infinite":
            if not np.array_equal(hl.light_to_world.m, np.eye(4)):
                raise NotImplementedError("write_pbrt writes infinite lights with the identity transform only")
            mapname = f' "string mapname" "{hl.map_name}"' if hl.map_name else ""
            out.append(f'LightSource "infinite" "rgb L" [{_fmt(hl.intensity)}]{mapname}')
        elif hl.kind in ("goniometric", "projection"):
            params = f'"rgb I" [{_fmt(hl.intensity)}]'
            if hl.image is not None:
                name = f"light{li}.pfm"
                write_image(os.path.join(folder, name), np.asarray(hl.image, np.float32))
                params += f' "string mapname" "{name}"'
            if hl.kind == "projection":
                params += f' "float fov" [{_fmt([hl.cone_angle])}]'
            out += ["AttributeBegin", f"  {_transform_line(hl.light_to_world)}",
                    f'  LightSource "{hl.kind}" {params}', "AttributeEnd"]
        else:
            raise NotImplementedError(f"write_pbrt does not write '{hl.kind}' lights")
    tex_lines, tex_names = _texture_lines(desc, folder)
    out += tex_lines
    # mix's sub-materials, as named materials (each once, before its mix)
    named: dict[int, str] = {}

    def name_subs(mat):
        for v in mat.params.values():
            if v[0] == "material" and id(v[1]) not in named:
                name_subs(v[1])
                named[id(v[1])] = f"m{len(named)}"
                out.append(f'MakeNamedMaterial "{named[id(v[1])]}" "string type" "{v[1].kind}" '
                           + _material_params(v[1], tex_names, folder, named))

    for prim in desc.primitives:
        name_subs(prim.material)

    def shape_lines(i, prim):
        """The Material, AreaLightSource and Shape lines of prim i."""
        mesh, sph = prim.shape.mesh, prim.shape.sphere
        mat = prim.material
        lines = [f'  Material "{mat.kind}" ' + _material_params(mat, tex_names, folder, named)]
        if prim.area_light is not None:
            al = prim.area_light
            lines.append(f'  AreaLightSource "diffuse" "rgb L" [{_fmt(al.intensity)}] '
                         f'"bool twosided" {"true" if al.two_sided else "false"}')
        if mesh is None:
            if sph.reverse_orientation:
                raise NotImplementedError("write_pbrt does not write reverse-oriented quadrics")
            lines.append(f"  {_quadric_shape(sph)}")
        elif mesh.alpha_texture is not None or mesh.shadow_alpha_texture is not None:
            if mesh.n is not None:
                raise NotImplementedError("write_pbrt writes alpha-cut meshes without normals only")
            alpha = "".join(f' "texture {name}" "{tex_names[id(t)]}"'
                            for name, t in (("alpha", mesh.alpha_texture), ("shadowalpha", mesh.shadow_alpha_texture))
                            if t is not None)
            uv = f' "float uv" [{_fmt(mesh.uv)}]' if mesh.uv is not None else ""
            indices = " ".join(str(int(v)) for v in np.ravel(mesh.indices))
            lines.append(f'  Shape "trianglemesh" "integer indices" [{indices}] "point P" [{_fmt(mesh.p)}]{uv}{alpha}')
        else:
            fname = f"mesh_{i}.ply"
            _write_ply(os.path.join(folder, fname), mesh.p, mesh.indices, n=mesh.n, uv=mesh.uv, double=True)
            lines.append(f'  Shape "plymesh" "string filename" "{fname}"')
        return lines

    prototypes: dict[int, str] = {}  # id(mesh) -> object name
    for i, prim in enumerate(desc.primitives):
        if prim.instance_transform is not None:
            key = id(prim.shape.mesh)
            if key not in prototypes:
                prototypes[key] = f"object{len(prototypes)}"
                out.append(f'ObjectBegin "{prototypes[key]}"')
                out += shape_lines(i, prim)
                out.append("ObjectEnd")
            out += ["AttributeBegin", f"  {_transform_line(prim.instance_transform)}",
                    f'  ObjectInstance "{prototypes[key]}"', "AttributeEnd"]
            continue
        out.append("AttributeBegin")
        if desc.media:
            out.append(f'  MediumInterface "{prim.inside_medium}" "{prim.outside_medium}"')
        if prim.shape.mesh is None:
            out.append(f"  {_transform_line(prim.shape.sphere.object_to_world)}")
        anim = (prim.shape.mesh or prim.shape.sphere).anim
        if anim is not None:
            # a moving shape: its shutter-close CTM (_animate's ctm1)
            out += ["  ActiveTransform EndTime", f"  Transform {_fmt(np.asarray(anim[1]).T.ravel())}",
                    "  ActiveTransform All"]
        out += shape_lines(i, prim)
        out.append("AttributeEnd")
    out.append("WorldEnd")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
