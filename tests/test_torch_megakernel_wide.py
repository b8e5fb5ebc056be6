"""The wide megakernel slice of the port against the reference, on the CPU.

The reference test's mini room (tests/test_megakernel_wide.py _room_scene)
is rebuilt on the port's host types and converted field for field to the
reference's (tests/test_torch_megakernel.py ``_to_ref``). Covered:

(a) the wide tables of scenes in the class, and extract_wide_consts, equal
    the reference's;
(b) the gates: what the port's class leaves out gives None and a reason;
    the reference refuses the halton sampler without its tables, a
    negative-lobe filter, mix materials, meshes over the triangle cap, more
    than 8 spheres, a partial sphere, a textured sphere material and an
    uber row outside the baked lobe sets as well, and takes two infinite
    lights (which the port refuses: the reference's kernel lights escaped
    rays with the first sky, its wavefront with the last); per-vertex
    normals, a constant infinite light, the gaussian filter and full
    spheres are in both classes;
(c) wide_megakernel_plain against the reference kernel itself in Pallas
    interpret mode on the reference test's cases of this class (the
    heavier half of them in tests/test_torch_megakernel_wide_ref.py, with
    the mixed scenes' cases), with its
    tolerance (tests/test_megakernel_wide.py:190-198): weights allclose,
    total path vertices within 6, per-pixel |dL| / (|L| + 1e-2) < 2e-2 and
    mean |dL| < 1e-4. The stratified case holds the reference's own strata
    on both sides: floor(sqrt(spp)) x spp // that (ROADMAP C). The sobol
    (under the triangle filter) and maxmindist cases run at 32x16, and
    scenes.sky_meshes, cut to 600 triangles, holds halton, the gaussian
    filter, the attribute table and the constant sky: each case costs a
    reference kernel compile in interpret mode (sobol's alone about
    50 s), so the slice's features share three cases;
(d) pack_wide_consts round-trips;
(e) the routes: PBRT_TPU_WIDEMEGA=1 takes material_room to the wide
    megakernel, whose image matches the reference kernel's; without it the
    wavefront renders the scene, within the same tolerance of that kernel;
    on the mesh room the two routes agree;
(f) the blob offsets and the cycle-split record equal the CUDA source's,
    and the kernel's wrappers refuse CPU lanes.
"""
import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import pbrt_tpu.core.transform as ref_transform
from pbrt_tpu.device import megakernel_wide as ref_mw
from pbrt_tpu.device.sampler import halton_tables as ref_halton_tables
from pbrt_tpu.device.sampler import sobol_tables as ref_sobol_tables
from pbrt_tpu.render import make_camera as ref_make_camera
from pbrt_tpu.scene import host as ref_host
from pbrt_tpu.scene.builder import compile_scene as ref_compile_scene
from pbrt_tpu_torch import render
from pbrt_tpu_torch.core.transform import Transform
from pbrt_tpu_torch.device import megakernel_wide as mw
from pbrt_tpu_torch.device.camera import make_camera
from pbrt_tpu_torch.device.megakernel import MAT_DEFAULTS, SAMPLERS
from pbrt_tpu_torch.device.sampler import halton_tables, sobol_tables
from pbrt_tpu_torch import scenes
from pbrt_tpu_torch.scene.arrays import (
    HOPPER_TABLES, LIGHT_AREA, LIGHT_DISTANT, LIGHT_INFINITE, SceneTensors, scene_tensors_from_numpy,
)
from pbrt_tpu_torch.scene.builder import CompiledScene, compile_scene
from pbrt_tpu_torch.scene.host import (
    CameraConfig, FilmConfig, HostLight, HostMaterial, HostPrimitive, IntegratorConfig, SamplerConfig,
    SceneDescription, ShapeRecord, Sphere, TriangleMesh,
)
from pbrt_tpu_torch.scenes import _texture, material_room, mesh_room
from test_torch_megakernel import NEW_KINDS, SLICE_KINDS, _to_ref, new_material, slice_kind_scene
from torch_threads import one_torch_thread  # noqa: F401  (autouse: PyTorch single-threaded in this module)

W, H, SPP = 48, 24, 2
FCFG = {"filter": "box", "filter_params": {}, "max_sample_luminance": float("inf")}


def _grid(f, u0, u1, v0, v1, n):
    us = np.linspace(u0, u1, n + 1)
    vs = np.linspace(v0, v1, n + 1)
    gu, gv = np.meshgrid(us, vs)
    verts = np.stack(f(gu, gv), axis=-1).reshape(-1, 3)
    idx = []
    for i in range(n):
        row = i * (n + 1)
        for j in range(n):
            a = row + j
            idx.append([a, a + n + 1, a + 1])
            idx.append([a + 1, a + n + 1, a + n + 2])
    return verts.astype(np.float64), np.asarray(idx, np.int32)


def _room_scene(sampler="zerotwosequence", light="area", strategy="power", micro=False, sigma=0.0, with_mirror=True):
    """tests/test_megakernel_wide.py's _room_scene on the port's host types:
    ~260 triangles, default UVs."""
    def prim(verts, idx, kind="matte", kd=(0.6, 0.6, 0.6), emit=None):
        lightp = None
        if emit is not None:
            lightp = HostLight(kind="area", intensity=np.asarray(emit, np.float64), two_sided=True)
        params = {}
        if kind in ("matte", "plastic"):
            params["Kd"] = ("const", np.asarray(kd))
        if kind == "matte" and sigma:
            params["sigma"] = ("const", sigma)
        if kind == "plastic":
            params["Ks"] = ("const", np.array([0.4, 0.4, 0.4]))
            params["roughness"] = ("const", 0.15)
        if kind == "metal":
            params["roughness"] = ("const", 0.08)
        return HostPrimitive(shape=ShapeRecord(mesh=TriangleMesh(p=verts, indices=idx)),
                             material=HostMaterial(kind=kind, params=params), area_light=lightp)

    terrain = prim(*_grid(lambda x, z: (x, 0.5 * np.sin(1.9 * x) * np.cos(1.3 * z), z), -4, 4, -4, 4, 8),
                   kd=(0.55, 0.45, 0.35), kind="plastic" if micro else "matte")
    y0, y1 = -1.3, 4.0
    walls = [
        prim(*_grid(lambda u, v: (u, v, np.full_like(u, -4.0)), -4, 4, y0, y1, 2)),
        prim(*_grid(lambda u, v: (u, v, np.full_like(u, 4.0)), -4, 4, y0, y1, 2)),
        prim(*_grid(lambda u, v: (np.full_like(u, -4.0), v, u), -4, 4, y0, y1, 2), kd=(0.55, 0.3, 0.3)),
        prim(*_grid(lambda u, v: (np.full_like(u, 4.0), v, u), -4, 4, y0, y1, 2),
             kind="metal" if micro else ("mirror" if with_mirror else "matte"), kd=(0.3, 0.55, 0.3)),
        prim(*_grid(lambda u, v: (u, np.full_like(u, y1), v), -4, 4, -4, 4, 2), kd=(0.7, 0.7, 0.7)),
    ]
    panel = prim(*_grid(lambda u, v: (u, np.full_like(u, y1 - 0.01), v), -1.4, 1.4, -1.4, 1.4, 1),
                 kd=(0.0, 0.0, 0.0), emit=[12.0, 11.0, 10.0])
    lights = []
    if light in ("distant", "both"):
        lights = [HostLight(kind="distant", from_point=np.array([1.0, 10.0, 2.0]), to_point=np.zeros(3),
                            intensity=np.array([2.0, 2.0, 2.0]))]
    if light == "spot":
        lights = [HostLight(kind="spot", from_point=np.array([0.0, 3.2, 2.8]), to_point=np.array([0.0, -0.5, -1.0]),
                            intensity=np.array([40.0, 36.0, 33.0]), cone_angle=30.0, cone_delta=18.0)]
    return SceneDescription(
        primitives=[terrain] + walls + [panel],
        lights=lights,
        camera=CameraConfig(kind="perspective",
                            camera_to_world=Transform.look_at([0, 2.3, 3.3], [0, 0.2, -1.0], [0, 1, 0]), fov=70.0),
        film=FilmConfig(x_resolution=W, y_resolution=H),
        sampler=SamplerConfig(kind=sampler, pixel_samples=SPP),
        integrator=IntegratorConfig(kind="path", max_depth=4, light_strategy=strategy),
    )


def _sphere(center, radius, material, light=None):
    return HostPrimitive(shape=ShapeRecord(sphere=Sphere(object_to_world=Transform.translate(center), radius=radius)),
                         material=material, area_light=light)


GLOSSY_UBER = {"Kd": ("const", np.array([0.5, 0.3, 0.2])), "Ks": ("const", np.array([0.3, 0.3, 0.3])),
               "roughness": ("const", 0.15), "eta": ("const", 1.7)}


def _mixed_room(kind):
    """The reference test's mixed scenes on the port's host types: "spheres"
    (tests/test_megakernel_wide.py:251: a mirror and a glass sphere beside
    the room's triangles), "lamp" (:312: the room without its mirror and a
    full-sphere area light), and "uber": the lamp room with a glossy uber
    sphere (Kd and Ks) beside its lamp."""
    if kind == "spheres":
        desc = _room_scene(light="area")
        desc.primitives.append(_sphere([-1.2, 1.0, 0.0], 0.8, HostMaterial(
            kind="mirror", params={"Kr": ("const", np.array([0.9, 0.9, 0.9]))})))
        desc.primitives.append(_sphere([1.4, 0.9, 0.5], 0.6, HostMaterial(kind="glass", params={})))
        return desc
    desc = _room_scene(light="area", with_mirror=False)
    desc.primitives.append(_sphere([0.8, 1.6, -0.5], 0.5, HostMaterial(kind="matte", params={"Kd": ("const", np.zeros(3))}),
                                   HostLight(kind="area", intensity=np.array([18.0, 15.0, 12.0]))))
    if kind == "uber":
        desc.primitives.append(_sphere([-1.3, 0.9, -0.8], 0.6, HostMaterial(kind="uber", params=dict(GLOSSY_UBER))))
        desc.primitives.append(_sphere([1.4, 0.9, 0.5], 0.6, HostMaterial(kind="glass", params={})))
    return desc


# the reference test's cases (tests/test_megakernel_wide.py:103-132) that lie
# in the port's class: (sampler, light, depth, strategy)
CASES = {
    "02-area": ("zerotwosequence", "area", 4, "power"),
    "random-distant": ("random", "distant", 4, "power"),
    "02-area-rr": ("zerotwosequence", "area", 7, "power"),
    "02-both-uniform": ("zerotwosequence", "both", 4, "uniform"),
    "02-dof": ("zerotwosequence", "dof", 4, "power"),
    "stratified-area": ("stratified", "area", 4, "power"),
    "02-spot": ("zerotwosequence", "spot", 4, "power"),
    "02-micro": ("zerotwosequence", "micro", 4, "power"),
    "random-micro": ("random", "micro", 5, "power"),
    "02-sigma": ("zerotwosequence", "sigma", 4, "power"),
    "sobol-triangle": ("sobol", "triangle", 4, "power"),
    "maxmin-area": ("maxmindist", "area", 4, "power"),
}
# the reference test's sobol and maxmindist cases, the first under the
# triangle filter, run at 32x16 (one 1,024-lane block of the reference
# kernel), the others at the reference test's 48x24; its halton and
# gaussian cases are test_plain_matches_reference_sky_meshes's
SMALL_CASES = ("sobol-triangle", "maxmin-area")
FILTERS = {"gauss": ("gaussian", {"xwidth": 1.5, "alpha": 2.0}), "triangle": ("triangle", {"xwidth": 1.25})}


def _case(name):
    """(port desc, icfg, scfg, fcfg) of one case, as the reference test
    builds it; the port's scfg holds the port's halton and sobol tables
    (_ref_scfg gives the reference's)."""
    sampler, light, depth, strategy = CASES[name]
    desc = _room_scene(sampler=sampler,
                       light="area" if light in ("dof", "micro", "sigma", "gauss", "triangle") else light,
                       strategy=strategy, micro=light == "micro", sigma=25.0 if light == "sigma" else 0.0)
    desc.integrator.max_depth = depth
    if name in SMALL_CASES:
        desc.film.x_resolution, desc.film.y_resolution = 32, 16
    if light == "dof":
        desc.camera.lens_radius = 0.15
        desc.camera.focal_distance = 4.0
    fcfg = dict(FCFG)
    if light in FILTERS:
        desc.film.filter_name, desc.film.filter_params = FILTERS[light][0], dict(FILTERS[light][1])
        fcfg.update(filter=FILTERS[light][0], filter_params=dict(FILTERS[light][1]))
    icfg = {"kind": "path", "max_depth": depth, "rr_threshold": desc.integrator.rr_threshold,
            "light_strategy": strategy}
    scfg = {"kind": sampler, "spp": SPP}
    w, h = desc.film.x_resolution, desc.film.y_resolution
    if sampler == "halton":
        scfg["halton"] = halton_tables(w, h, "cpu")
    if sampler == "sobol":
        scfg["sobol"] = sobol_tables(w, h, SPP)
    return desc, icfg, scfg, fcfg


def _ref_scfg(scfg, w, h):
    """The reference's sampler config for the port's scfg."""
    out = {"kind": scfg["kind"], "spp": scfg["spp"]}
    if "halton" in scfg:
        out["halton"] = ref_halton_tables(w, h)
    if "sobol" in scfg:
        out["sobol"] = ref_sobol_tables(w, h, scfg["spp"])
    return out


def _both(desc):
    """The port's (cpu) and the reference's compiled scene, and both cameras."""
    cs, ref = compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))
    return cs, ref, make_camera(desc.camera, desc.film, "cpu"), ref_make_camera(ref.description.camera,
                                                                                   ref.description.film)


def _pixels(w=W, h=H):
    ys, xs = np.mgrid[0:h, 0:w]
    return xs.ravel(), ys.ravel(), (ys * w + xs).ravel()


def _reference_image(ref, ref_cam, icfg, scfg, fcfg, w=W, h=H, seed=0):
    fn = ref_mw.make_wide_megakernel_fn(ref, ref_cam, icfg, scfg, fcfg, interpret=True)
    assert fn is not None
    px, py, pid = _pixels(w, h)
    return tuple(np.asarray(x) for x in fn(
        ref.arrays, jnp.asarray(px.astype(np.int32)), jnp.asarray(py.astype(np.int32)),
        jnp.asarray(pid.astype(np.uint32)), jnp.uint32(0), scfg["spp"], jnp.uint32(seed)))


def _assert_wide_tolerance(L, w, nv, L_r, w_r, nv_r):
    """tests/test_megakernel_wide.py:190-198."""
    assert (L_r.sum(-1) > 1e-4).mean() > 0.5
    assert np.allclose(w, w_r)
    assert abs(float(np.sum(nv)) - float(np.sum(nv_r))) <= 6
    diff = np.abs(L - L_r)
    rel = diff / (np.abs(L_r) + 1e-2)
    assert float(rel.max()) < 2e-2, (float(rel.max()), float(diff.max()))
    assert float(diff.mean()) < 1e-4


# --- (a) tables and constants ------------------------------------------------------


@pytest.mark.parametrize("scene", ["material_room", "02-micro", "02-both-uniform", "02-spot", "02-sigma",
                                   "sky_meshes"])
def test_wide_tables_bit_identical(scene):
    """compile_scene takes the wide megakernel's materials and lights in
    wide scenes, with the reference's tables bit for bit: sky_meshes's
    attribute table (smooth UV-mapped spheres beside a flat ground) and its
    infinite light's row included."""
    desc = {"material_room": lambda: material_room(8), "sky_meshes": lambda: scenes.sky_meshes(10, 6, 10)}.get(
        scene, lambda: _case(scene)[0])()
    cs, ref, _cam, _ref_cam = _both(desc)
    assert cs.static.has_wide and ref.static.has_wide
    assert (cs.arrays.wattr_tab is not None) == (scene == "sky_meshes") == ref.static.has_infinite
    for name in ("has_infinite", "infinite_light_index", "has_env_map"):
        assert getattr(cs.static, name) == getattr(ref.static, name), name
    for f in dataclasses.fields(SceneTensors):
        if f.name in HOPPER_TABLES:  # derived from the reference tables, not one of them
            continue
        a, b = getattr(cs.arrays, f.name), getattr(ref.arrays, f.name)
        assert (a is None) == (b is None), f.name
        if a is None:
            continue
        if isinstance(a, dict):  # the MIP levels: none in these scenes
            assert a.keys() == b.keys() == set(), f.name
            continue
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("case", list(CASES))
def test_extract_wide_consts_matches_reference(case):
    desc, icfg, scfg, fcfg = _case(case)
    cs, ref, cam, ref_cam = _both(desc)
    mine = mw.extract_wide_consts(cs, cam, icfg, scfg, fcfg, mw.DEFAULT_MAX_TRIS)
    theirs = ref_mw.extract_wide_consts(ref, ref_cam, icfg, _ref_scfg(scfg, desc.film.x_resolution,
                                                                      desc.film.y_resolution), fcfg)
    assert mine is not None and theirs is not None
    assert mine["mats"].keys() == theirs["mats"].keys()
    for m, e in theirs["mats"].items():
        assert mine["mats"][m] == {k: v for k, v in e.items() if k != "kd_tex"}, m
    assert len(mine["lights"]) == len(theirs["lights"])
    for a, b in zip(mine["lights"], theirs["lights"]):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), err_msg=key)
    for key in ("light_cdf", "light_pmf", "r2c", "c2w"):
        np.testing.assert_array_equal(np.asarray(mine[key]), np.asarray(theirs[key]), err_msg=key)
    for key in ("has_ns", "has_attr", "spheres", "uniform_select", "world_radius", "wide_root", "lens_radius",
                "focal_distance", "filter", "filter_params", "filter_xw", "filter_yw", "max_depth", "rr_threshold",
                "sampler", "spp", "halton", "sobol", "maxmin", "max_lum"):
        assert mine[key] == theirs[key], key


# --- (b) gates ---------------------------------------------------------------------


def _crossed(ref_desc):
    """A scene the port's compiler refuses, compiled by the reference and
    read into the port through scene_tensors_from_numpy."""
    ref = ref_compile_scene(ref_desc)
    arrays = {f.name: getattr(ref.arrays, f.name) for f in dataclasses.fields(ref.arrays)}
    static = {f.name: getattr(ref.static, f.name) for f in dataclasses.fields(ref.static)}
    sa, st = scene_tensors_from_numpy(arrays, static, "cpu")
    return CompiledScene(sa, st, None), ref


def _gate_scene(gate):
    """(port scene, reference scene, icfg, scfg, fcfg, whether the reference
    refuses it, the word the port's reason holds; None where the port takes
    the scene)."""
    desc, icfg, scfg, fcfg = _case("02-area")
    rdesc = _to_ref(desc)
    if gate == "normals":
        n = np.tile([[0.0, 1.0, 0.0]], (len(desc.primitives[0].shape.mesh.p), 1))
        desc.primitives[0].shape.mesh.n = n
        rdesc.primitives[0].shape.mesh.n = n
        cs, ref = compile_scene(desc, "cpu"), ref_compile_scene(rdesc)
        return cs, ref, icfg, scfg, fcfg, False, None
    if gate == "checker":
        checker = ref_host.HostTexture(kind="checkerboard", is_float=False, tex1=("const", np.array([0.7, 0.7, 0.6])),
                                       tex2=("const", np.array([0.1, 0.1, 0.3])), uscale=6.0, vscale=6.0)
        rdesc.primitives[0].material = ref_host.HostMaterial(kind="matte", params={"Kd": ("texture", checker)})
        return *_crossed(rdesc), icfg, scfg, fcfg, False, None
    if gate == "bump":
        bump = ref_host.HostTexture(kind="wrinkled", is_float=True, octaves=2)
        rdesc.primitives[0].material = ref_host.HostMaterial(
            kind="matte", params={"Kd": ("const", np.array([0.5, 0.5, 0.5]))}, bump_map=("texture", bump))
        return *_crossed(rdesc), icfg, scfg, fcfg, False, "bump maps"
    if gate == "sphere":
        rdesc.primitives.append(ref_host.HostPrimitive(
            shape=ref_host.ShapeRecord(sphere=ref_host.Sphere(
                object_to_world=ref_transform.Transform.translate([0.0, 1.0, 0.0]), radius=0.5)),
            material=ref_host.HostMaterial(kind="glass", params={})))
        return *_crossed(rdesc), icfg, scfg, fcfg, False, None
    if gate == "nine-spheres":  # the port's compiler refuses them: crossed from the reference
        for i in range(9):
            rdesc.primitives.append(ref_host.HostPrimitive(
                shape=ref_host.ShapeRecord(sphere=ref_host.Sphere(
                    object_to_world=ref_transform.Transform.translate([-3.0 + 0.7 * i, 2.0, 0.0]), radius=0.3)),
                material=ref_host.HostMaterial(kind="glass", params={})))
        return *_crossed(rdesc), icfg, scfg, fcfg, True, "more than 8 spheres"
    if gate in ("partial-sphere", "textured-sphere", "full-uber"):
        sph = _sphere([0.0, 1.0, 0.0], 0.5, HostMaterial(kind="glass", params={}))
        if gate == "partial-sphere":
            sph.shape.sphere.z_max = 0.2
        elif gate == "textured-sphere":
            checker = _texture("checkerboard", tex1=("const", np.array([0.7, 0.7, 0.6])),
                               tex2=("const", np.array([0.1, 0.1, 0.3])), uscale=6.0, vscale=6.0)
            sph.material = HostMaterial(kind="matte", params={"Kd": ("texture", checker)})
        else:
            sph.material = HostMaterial(kind="uber", params=scenes._full_uber(GLOSSY_UBER))
        desc.primitives.append(sph)
        cs, ref = compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))
        word = {"partial-sphere": "partial spheres", "textured-sphere": "textured sphere",
                "full-uber": "lobe set [1, 4, 6, 7, 7]"}[gate]
        return cs, ref, icfg, scfg, fcfg, True, word
    if gate in ("infinite", "two-skies"):
        desc.lights.append(HostLight(kind="infinite", intensity=np.array([0.5, 0.5, 0.5])))
        if gate == "two-skies":
            desc.lights.append(HostLight(kind="infinite", intensity=np.array([0.1, 0.2, 0.3])))
        cs, ref = compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))
        return cs, ref, icfg, scfg, fcfg, False, None if gate == "infinite" else "more than one infinite light"
    if gate == "mix":
        m1 = ref_host.HostMaterial(kind="matte", params={"Kd": ("const", np.array([0.8, 0.1, 0.1]))})
        m2 = ref_host.HostMaterial(kind="matte", params={"Kd": ("const", np.array([0.1, 0.1, 0.8]))})
        rdesc.primitives[0].material = ref_host.HostMaterial(kind="mix", params={
            "amount": ("const", np.array([0.5, 0.5, 0.5])), "material1": ("material", m1),
            "material2": ("material", m2)})
        return *_crossed(rdesc), icfg, scfg, fcfg, True, "mix"
    cs, ref = compile_scene(desc, "cpu"), ref_compile_scene(rdesc)
    if gate == "halton":
        return cs, ref, icfg, {"kind": "halton", "spp": SPP}, fcfg, True, "halton"
    if gate == "gaussian":
        return cs, ref, icfg, scfg, dict(fcfg, filter="gaussian", filter_params={"xwidth": 1.5}), False, None
    if gate == "mitchell":
        return cs, ref, icfg, scfg, dict(fcfg, filter="mitchell"), True, "mitchell"
    assert gate == "over-cap"
    return cs, ref, icfg, scfg, fcfg, True, "triangles"


GATES = ["normals", "checker", "sphere", "infinite", "two-skies", "mix", "halton", "gaussian", "mitchell", "over-cap",
         "bump", "nine-spheres", "partial-sphere", "textured-sphere", "full-uber"]


@pytest.mark.parametrize("gate", GATES)
def test_eligibility_gates(gate, monkeypatch):
    """The port refuses two infinite lights, mix, mitchell, the triangle
    cap, halton without its film tables, bump maps, more than 8 spheres, a
    partial sphere, a textured sphere material and an uber row outside the
    baked lobe sets, naming each (the reference takes two skies: its kernel
    lights escaped rays with the first sky, its wavefront with the last; it
    takes bump maps and renders them without bumps, ROADMAP C, which the
    port fixes by sending them to the wavefront); it takes per-vertex
    normals, a constant infinite light, the gaussian filter, the
    checkerboard Kd and full spheres, as the reference does."""
    cs, ref, icfg, scfg, fcfg, ref_refuses, word = _gate_scene(gate)
    max_tris = 100 if gate == "over-cap" else mw.DEFAULT_MAX_TRIS  # the room has 170 triangles
    monkeypatch.setenv("PBRT_TPU_WIDEMEGA_MAX_TRIS", str(max_tris))  # the reference reads its cap here
    desc = ref.description
    cam = make_camera(desc.camera, desc.film, "cpu")
    theirs = ref_mw.extract_wide_consts(ref, ref_make_camera(desc.camera, desc.film), icfg, scfg, fcfg)
    assert (theirs is None) == ref_refuses
    if word is None:  # in the class since this slice: both packages take it
        assert mw.wide_megakernel_eligible(cs, cam, icfg, scfg, fcfg, max_tris)
        assert mw.explain_ineligible_wide(cs, cam, icfg, scfg, fcfg, max_tris) is None
        return
    assert mw.extract_wide_consts(cs, cam, icfg, scfg, fcfg, max_tris) is None
    assert not mw.wide_megakernel_eligible(cs, cam, icfg, scfg, fcfg, max_tris)
    assert word in mw.explain_ineligible_wide(cs, cam, icfg, scfg, fcfg, max_tris)


@pytest.mark.parametrize("kind", NEW_KINDS)
def test_new_material_gates_as_reference(kind, tmp_path):
    """The wide extractor decides a row of each new kind by its lobe set, as
    the reference's does (tests/test_torch_megakernel.py
    test_new_material_gates_as_reference): the room's floor re-dressed;
    refused with the lobe set named (mix rows by name), or, for a
    translucent row without transmission, baked to the reference's entry."""
    desc, icfg, scfg, fcfg = _case("02-area")
    mat, word = new_material(kind, tmp_path)
    desc.primitives[0].material = mat
    cs, ref, cam, ref_cam = _both(desc)
    mine = mw.extract_wide_consts(cs, cam, icfg, scfg, fcfg, mw.DEFAULT_MAX_TRIS)
    theirs = ref_mw.extract_wide_consts(ref, ref_cam, icfg, scfg, fcfg)
    if word is not None:
        assert mine is None and theirs is None
        assert word in mw.explain_ineligible_wide(cs, cam, icfg, scfg, fcfg, mw.DEFAULT_MAX_TRIS)
        return
    assert mine is not None and theirs is not None
    assert mine["mats"].keys() == theirs["mats"].keys()
    for m, e in theirs["mats"].items():
        assert mine["mats"][m] == {k: v for k, v in e.items() if k != "kd_tex"}, m


@pytest.mark.parametrize("n_side,eligible", [(40, True), (64, False)])
def test_mesh_room_class_as_reference(n_side, eligible):
    """tests/test_megakernel_wide.py:218-248: the bench mesh room is in the
    class at n_side 40 and over the triangle cap at 64, on both sides."""
    cs, ref, cam, ref_cam = _both(mesh_room(n_side))
    icfg = {"kind": "path", "max_depth": 5, "rr_threshold": 1.0, "light_strategy": "power"}
    scfg = {"kind": "zerotwosequence", "spp": 16}
    assert (mw.extract_wide_consts(cs, cam, icfg, scfg, FCFG, mw.DEFAULT_MAX_TRIS) is not None) == eligible
    assert (ref_mw.extract_wide_consts(ref, ref_cam, icfg, scfg, FCFG) is not None) == eligible


# --- (c) the estimator against the reference kernel ----------------------------


def _twin_against_reference(desc, icfg, scfg, fcfg):
    """The twin's image of a port scene against the reference kernel's (in
    interpret mode) under the reference test's tolerance; returns consts."""
    w, h = desc.film.x_resolution, desc.film.y_resolution
    cs, ref, cam, ref_cam = _both(desc)
    L_r, w_r, nv_r = _reference_image(ref, ref_cam, icfg, _ref_scfg(scfg, w, h), fcfg, w, h)
    consts = mw.extract_wide_consts(cs, cam, icfg, scfg, fcfg, mw.DEFAULT_MAX_TRIS)
    px, py, pid = (torch.as_tensor(x.astype(np.int64)) for x in _pixels(w, h))
    L, wt, nv = (x.numpy() for x in mw.wide_megakernel_plain(consts, cs.arrays, px, py, pid, 0, SPP, 0))
    _assert_wide_tolerance(L, wt, nv, L_r, w_r, nv_r)
    return consts


# the reference-kernel cases of this file; the others, the heavier half
# (sobol's compile alone is the longest case), run in
# tests/test_torch_megakernel_wide_ref.py, so that the two files, one
# worker each, take about equal time
REF_CASES_ELSEWHERE = ("sobol-triangle", "maxmin-area", "02-sigma", "random-micro", "02-area", "02-both-uniform",
                       "random-distant")


@pytest.mark.parametrize("case", [c for c in CASES if c not in REF_CASES_ELSEWHERE])
def test_plain_matches_reference_kernel(case):
    _twin_against_reference(*_case(case))


def test_plain_matches_reference_sky_meshes():
    """scenes.sky_meshes cut to 600 triangles at 32x16: pbrt's defaults
    (halton, the gaussian filter; the reference test's halton :117 and
    gaussian :112 cases), the attribute table with smooth normals and UV
    charts on the spheres beside the flat ground (its shading-normal test
    :394, with UV charts and constant Kd) and a constant infinite light with
    a distant sun over an open scene (its constant-infinite test :548)."""
    desc = _small(scenes.sky_meshes(10, 6, 10), 32, 16)
    icfg = {"kind": "path", "max_depth": 5, "rr_threshold": 1.0, "light_strategy": "power"}
    fcfg = dict(FCFG, filter="gaussian", filter_params=dict(desc.film.filter_params))
    scfg = {"kind": "halton", "spp": SPP, "halton": halton_tables(32, 16, "cpu")}
    consts = _twin_against_reference(desc, icfg, scfg, fcfg)
    assert consts["has_ns"] and consts["has_attr"] and mw.kernel_mode(consts) == 2 * mw.N_SAMPLER_IDS + 6
    assert sorted(lt["kind"] for lt in consts["lights"]) == [LIGHT_DISTANT, LIGHT_INFINITE]


# --- (d) the blob layout -------------------------------------------------------------


@pytest.mark.parametrize("case", ["02-both-uniform", "random-micro", "02-dof"])
def test_pack_wide_consts_round_trips(case):
    desc, icfg, scfg, fcfg = _case(case)
    cs = compile_scene(desc, "cpu")
    consts = mw.extract_wide_consts(cs, make_camera(desc.camera, desc.film, "cpu"), icfg, scfg, fcfg,
                                    mw.DEFAULT_MAX_TRIS)
    blob = mw.pack_wide_consts(consts)
    assert blob.dtype == torch.float32 and blob.shape == (mw.BLOB_FLOATS,)
    b = blob.numpy().astype(np.float64)

    def f32(x):
        return np.asarray(x, np.float64).astype(np.float32).astype(np.float64)

    lights = consts["lights"]
    assert int(b[mw.H_N_LIGHTS]) == len(lights) and int(b[mw.H_N_MATS]) == len(consts["mats"])
    assert int(b[mw.H_MAX_DEPTH]) == consts["max_depth"] and int(b[mw.H_SAMPLER]) == SAMPLERS[consts["sampler"]]
    assert bool(b[mw.H_UNIFORM]) == consts["uniform_select"]
    assert mw.kernel_mode(consts) == 2 * SAMPLERS[consts["sampler"]] + any(lt["kind"] == LIGHT_AREA for lt in lights)
    np.testing.assert_array_equal(b[mw.H_R2C:mw.H_R2C + 16], f32(consts["r2c"]).ravel())
    np.testing.assert_array_equal(b[mw.H_C2W:mw.H_C2W + 12], f32(consts["c2w"][:3]).ravel())
    np.testing.assert_array_equal(b[mw.H_PMF:mw.H_PMF + len(lights)], f32(consts["light_pmf"]))
    for key, off in (("lens_radius", mw.H_LENS_R), ("focal_distance", mw.H_FOCAL), ("max_lum", mw.H_MAX_LUM)):
        assert b[off] == f32(consts[key]), key
    for i, lt in enumerate(lights):
        o = mw.LIGHT_BASE + i * mw.LIGHT_STRIDE
        assert b[o + mw.L_KIND] == lt["kind"]
        np.testing.assert_array_equal(b[o + mw.L_PAR:o + mw.L_PAR + 12], f32(lt["par"]))
        if lt["kind"] == LIGHT_AREA:
            np.testing.assert_array_equal(b[o + mw.L_V:o + mw.L_V + 9], f32(lt["v"]).ravel())
            np.testing.assert_array_equal(b[o + mw.L_NG:o + mw.L_NG + 3], f32(lt["ng"]))
            assert b[o + mw.L_AREA] == f32(lt["area"]) and bool(b[o + mw.L_TWO_SIDED]) == lt["two_sided"]
    for s, m in enumerate(sorted(consts["mats"])):
        o = mw.MAT_BASE + s * mw.MAT_STRIDE
        e = dict(MAT_DEFAULTS, **consts["mats"][m])
        assert int(b[o + mw.M_ROW]) == m and int(b[o]) == e["lobe"]


def _cu_defines():
    src = mw.KERNEL_SOURCE.read_text()
    return {k: v for k, v in re.findall(r"^#define (\w+) (\d+)\b", src, re.MULTILINE)}


def test_blob_and_split_layouts_match_the_kernel():
    """The blob offsets and the cycle-split record that the wrapper reads are
    the kernel source's (csrc/megakernel_wide.cu)."""
    d = _cu_defines()
    for name in ("H_N_LIGHTS", "H_N_MATS", "H_MAX_DEPTH", "H_RR", "H_UNIFORM", "H_SAMPLER", "H_STRAT_XS",
                 "H_STRAT_YS", "H_WR2", "H_FXW", "H_FYW", "H_MAX_LUM", "H_G7", "H_LENS_R", "H_FOCAL", "H_R2C",
                 "H_C2W", "H_CDF", "H_PMF", "HEADER", "MAX_LIGHTS", "LIGHT_STRIDE", "MAX_MATS", "MAT_STRIDE",
                 "L_AREA", "L_TWO_SIDED", "L_V", "L_NG", "M_ROW", "H_FILTER", "H_SAMP", "H_GK", "L_ENV_P",
                 "SOBOL_DIMS", "N_SAMPLER_IDS", "M_CHK", "M_CHK_UV", "L_C", "L_RW", "L_RW2", "L_RW2X", "L_ROBJ",
                 "L_SPH", "MAX_SPHERES", "SPH_HEADER", "SPH_STRIDE", "S_LIGHT", "S_MAT"):
        assert int(d[name]) == getattr(mw, name), name
    for name, kind in (("S_HALTON", "halton"), ("S_SOBOL", "sobol"), ("S_MAXMIN", "maxmindist")):
        assert int(d[name]) == mw.SAMPLERS[kind], name
    split = {k[len("SPLIT_"):].lower(): int(v) for k, v in d.items() if k.startswith("SPLIT_")}
    assert int(d["N_SPLIT"]) == len(mw.SPLIT_FIELDS) == len(split)
    kernel_names = {"shade": "shade_nee", "flush": "flush_regen", "idle": "idle_tail", "iters": "iterations"}
    assert sorted(split.values()) == list(range(len(split)))
    for name, i in split.items():
        assert mw.SPLIT_FIELDS[i] == kernel_names.get(name, name), name


@pytest.mark.parametrize("entry", ["wide_megakernel_cuda", "wide_megakernel_split"])
def test_cuda_entries_refuse_cpu_lanes(entry):
    """The kernel's wrappers take CUDA tensors only: CPU lanes raise before
    any build or launch (the route sends CPU lanes to the plain twin)."""
    lanes = torch.arange(4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(mw, entry)(torch.zeros(mw.BLOB_FLOATS), 1, None, lanes, lanes, lanes, 0, 1, 0)


# --- (e) the routes --------------------------------------------------------------------


def _small(desc, w=W, h=H, spp=SPP):
    desc.film.x_resolution, desc.film.y_resolution = w, h
    desc.sampler.pixel_samples = spp
    return desc


def _route_image(cs, seed=0):
    wave = render.make_persistent_fn(cs)
    px, py, pid = (torch.as_tensor(x.astype(np.int64)) for x in _pixels(cs.description.film.x_resolution,
                                                                       cs.description.film.y_resolution))
    L, w, nv = wave(cs.arrays, px, py, pid, 0, cs.description.sampler.pixel_samples, seed)
    return L.numpy(), w.numpy(), nv.numpy()


@pytest.fixture(scope="module")
def material_room_32x16():
    """The port's material_room(8) at 32x16 and the reference wide
    megakernel's image of it (Pallas interpret mode)."""
    desc = _small(material_room(8), 32, 16)
    cs, ref, _cam, ref_cam = _both(desc)
    icfg = {"kind": "path", "max_depth": 5, "rr_threshold": 1.0, "light_strategy": "power"}
    return cs, _reference_image(ref, ref_cam, icfg, {"kind": "zerotwosequence", "spp": SPP}, FCFG, 32, 16)


def test_checker_room_route_matches_reference(monkeypatch):
    """material_room(8, checker=True) at 24x12: the floor's matte Kd a uv
    checkerboard of two constant cells, selected per hit in the kernel's
    extended instantiation (reference megakernel_wide :1273-1287); the port's
    route (the twin) against the reference kernel in interpret mode, at the
    tolerance of test_material_room_route_matches_reference."""
    desc = _small(material_room(8, checker=True), 24, 12)
    cs, ref, cam, ref_cam = _both(desc)
    icfg = {"kind": "path", "max_depth": 5, "rr_threshold": 1.0, "light_strategy": "power"}
    scfg = {"kind": "zerotwosequence", "spp": SPP}
    mine = mw.extract_wide_consts(cs, cam, icfg, scfg, FCFG, mw.DEFAULT_MAX_TRIS)
    theirs = ref_mw.extract_wide_consts(ref, ref_cam, icfg, scfg, FCFG)
    assert mine["mats"] == {m: {k: v for k, v in e.items() if v is not None} for m, e in theirs["mats"].items()}
    assert sum(bool(e.get("kd_tex")) for e in mine["mats"].values()) == 1
    assert mw.kernel_mode(mine) >= 2 * mw.N_SAMPLER_IDS  # the extended instantiation
    ref_out = _reference_image(ref, ref_cam, icfg, scfg, FCFG, 24, 12)
    monkeypatch.setenv("PBRT_TPU_WIDEMEGA", "1")
    L, w, nv = _route_image(cs)
    assert render.LAST_PERSISTENT_TIER == "torch-megakernel/plain-wide"
    _assert_wide_tolerance(L, w, nv, *ref_out)


def test_material_room_route_matches_reference(material_room_32x16, monkeypatch):
    cs, ref_out = material_room_32x16
    monkeypatch.setenv("PBRT_TPU_WIDEMEGA", "1")
    L, w, nv = _route_image(cs)
    assert render.LAST_PERSISTENT_TIER == "torch-megakernel/plain-wide"
    _assert_wide_tolerance(L, w, nv, *ref_out)


def test_material_room_wavefront_refuses(material_room_32x16, monkeypatch):
    """Without PBRT_TPU_WIDEMEGA=1 the wavefront renders material_room (its
    point and spot lights, mirror, glass, metal, plastic and Oren-Nayar),
    within the reference wide megakernel's tolerance of that kernel."""
    cs, ref_out = material_room_32x16
    monkeypatch.delenv("PBRT_TPU_WIDEMEGA", raising=False)
    L, w, nv = _route_image(cs)
    assert render.LAST_PERSISTENT_TIER == "torch-wavefront/plain-wide"
    _assert_wide_tolerance(L, w, nv, *ref_out)


def test_route_reads_the_triangle_cap(monkeypatch):
    """PBRT_TPU_WIDEMEGA_MAX_TRIS is read when the route is built: under the
    cap of 10 triangles neither the mesh room nor material_room is the wide
    megakernel's, and both take the wavefront."""
    monkeypatch.setenv("PBRT_TPU_WIDEMEGA", "1")
    monkeypatch.setenv("PBRT_TPU_WIDEMEGA_MAX_TRIS", "10")
    render.make_persistent_fn(compile_scene(_small(mesh_room(8), 24, 16), "cpu"))
    assert render.LAST_PERSISTENT_TIER == "torch-wavefront/plain-wide"
    render.make_persistent_fn(compile_scene(_small(material_room(8)), "cpu"))
    assert render.LAST_PERSISTENT_TIER == "torch-wavefront/plain-wide"


def test_mesh_room_routes_agree(monkeypatch):
    cs = compile_scene(_small(mesh_room(8), 24, 16), "cpu")
    monkeypatch.delenv("PBRT_TPU_WIDEMEGA", raising=False)
    wave = _route_image(cs, seed=3)
    assert render.LAST_PERSISTENT_TIER == "torch-wavefront/plain-wide"
    monkeypatch.setenv("PBRT_TPU_WIDEMEGA", "1")
    mega = _route_image(cs, seed=3)
    assert render.LAST_PERSISTENT_TIER == "torch-megakernel/plain-wide"
    _assert_wide_tolerance(*mega, *wave)


def test_reference_mesh_bench_is_the_port_room():
    """material_room and the route tests stand on mesh_room, which is
    bench._mesh_scene on the port's host types (tests/test_torch_scene.py)."""
    a, b = mesh_room(8), bench._mesh_scene(8)
    assert len(a.primitives) == len(b.primitives)
    for p, q in zip(a.primitives, b.primitives):
        np.testing.assert_array_equal(p.shape.mesh.indices, q.shape.mesh.indices)
        np.testing.assert_array_equal(p.shape.mesh.p, q.shape.mesh.p)


def test_material_room_is_in_the_class():
    desc = material_room()
    cs = compile_scene(desc, "cpu")
    assert cs.static.n_tris == 3854
    icfg = {"kind": "path", "max_depth": 5, "rr_threshold": 1.0, "light_strategy": "power"}
    consts = mw.extract_wide_consts(cs, make_camera(desc.camera, desc.film, "cpu"), icfg,
                                    {"kind": "zerotwosequence", "spp": 16}, FCFG, mw.DEFAULT_MAX_TRIS)
    assert consts is not None
    assert sorted(lt["kind"] for lt in consts["lights"]) == [0, 1, LIGHT_AREA, LIGHT_AREA]
    assert {e["lobe"] for e in consts["mats"].values()} == {0, 1, 3, 4, 6, 8, 100}


@pytest.mark.parametrize("kind", list(SLICE_KINDS) + ["kdtree"])
def test_slice_kinds_refused_by_name(kind):
    """B4's extractor refuses each kind of the wavefront's class that it
    does not bake, naming it, as the reference's refuses them all: the
    cameras other than the perspective one, goniometric and projection
    lights, a quadric other than a sphere beside the room's triangles,
    instancing, alpha cutouts and the kd-tree (whose scenes have no wide
    tables)."""
    from pbrt_tpu_torch.scene.host import HostPrimitive, ShapeRecord, Sphere

    desc, icfg, scfg, fcfg = _case("02-area")
    if kind == "kdtree":
        desc.accelerator = "kdtree"
        word = "the 'kdtree' accelerator"
    else:
        if kind in ("cylinder", "disk", "cone", "paraboloid", "hyperboloid"):
            desc.primitives.append(HostPrimitive(shape=ShapeRecord(sphere=Sphere(
                object_to_world=Transform.translate([0.5, 1.5, 0.0]), radius=0.3)),
                material=HostMaterial(kind="matte")))
        desc = slice_kind_scene(desc, kind)
        word = SLICE_KINDS[kind]
    cs, ref, cam, ref_cam = _both(desc)
    assert mw.extract_wide_consts(cs, cam, icfg, scfg, fcfg, mw.DEFAULT_MAX_TRIS) is None
    assert ref_mw.extract_wide_consts(ref, ref_cam, icfg, scfg, fcfg) is None
    assert mw.explain_ineligible_wide(cs, cam, icfg, scfg, fcfg, mw.DEFAULT_MAX_TRIS) == word
