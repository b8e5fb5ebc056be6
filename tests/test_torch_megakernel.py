"""The brute megakernel slice of the port against the reference, on the CPU.

Each scene is built once on the port's host types and converted field for
field to pbrt_tpu.scene.host's (``_to_ref``), so both compilers see the same
description. Covered:

(a) the brute-class tables equal the reference's bit for bit;
(b) bake_lobes equals the reference make_bsdf's lobe kinds and data, and
    extract_consts equals the reference's baked constants;
(c) the eligibility gates return None where the reference's do;
(d) megakernel_plain against the reference kernel itself in Pallas
    interpret mode, with the reference's own tolerance
    (tests/test_megakernel.py): weights allclose, total path vertices within
    4, per-pixel |dL| / (|L| + 1e-2) < 2e-2 and mean |dL| < 1e-4;
(e) pack_consts round-trips through a Python reader of its layout;
(f) render_compiled of a small spheres_gallery takes the plain-brute route.
"""
import dataclasses
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pbrt_tpu.core.transform as ref_transform
import pbrt_tpu.scene.host as ref_host
from pbrt_tpu.device import megakernel as ref_mk
from pbrt_tpu.device.materials import make_bsdf as ref_make_bsdf
from pbrt_tpu.render import make_camera as ref_make_camera
from pbrt_tpu.scene.builder import compile_scene as ref_compile_scene
from pbrt_tpu_torch import render
from pbrt_tpu_torch.core.transform import Transform
from pbrt_tpu_torch.device import megakernel as mk
from pbrt_tpu_torch.device.camera import make_camera
from pbrt_tpu_torch.device.materials import bake_lobes
from pbrt_tpu_torch.scene.arrays import HOPPER_TABLES, SceneTensors, scene_tensors_from_numpy
from pbrt_tpu_torch.scene.builder import CompiledScene, compile_scene
from pbrt_tpu_torch.scene.host import (
    CameraConfig, FilmConfig, HostLight, HostMaterial, HostPrimitive, IntegratorConfig, SamplerConfig,
    SceneDescription, ShapeRecord, Sphere, TriangleMesh,
)
from pbrt_tpu_torch.scenes import spheres_gallery

W, H, SPP = 32, 16, 2
FCFG = {"filter": "box", "filter_params": {}, "max_sample_luminance": float("inf")}


def _to_ref(x, memo=None):
    """A port host record -> the reference's record of the same class name,
    field for field (shared objects stay shared)."""
    memo = {} if memo is None else memo
    if id(x) in memo:
        return memo[id(x)]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        name = type(x).__name__
        cls = getattr(ref_host, name, None) or getattr(ref_transform, name)
        out = cls(**{f.name: _to_ref(getattr(x, f.name), memo) for f in dataclasses.fields(x)})
    elif isinstance(x, (list, tuple)):
        out = type(x)(_to_ref(v, memo) for v in x)
    elif isinstance(x, dict):
        out = {k: _to_ref(v, memo) for k, v in x.items()}
    else:
        return x
    memo[id(x)] = out
    return out


def _mini_spheres(sampler="zerotwosequence", light="distant", micro=False):
    """tests/test_megakernel.py's _mini_spheres on the port's host types."""
    gkind, gparams = "matte", {"Kd": ("const", np.array([0.6, 0.5, 0.4]))}
    if micro:
        gkind = "plastic"
        gparams = {"Kd": ("const", np.array([0.6, 0.5, 0.4])), "Ks": ("const", np.array([0.4, 0.4, 0.4])),
                   "roughness": ("const", 0.2)}
    ground = HostPrimitive(
        shape=ShapeRecord(mesh=TriangleMesh(
            p=np.array([[-20, -1, -20], [20, -1, -20], [20, -1, 20], [-20, -1, 20]], np.float64),
            indices=np.array([[0, 2, 1], [0, 3, 2]], np.int32),
            uv=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64))),
        material=HostMaterial(kind=gkind, params=gparams))

    def sphere(tx, mat):
        return HostPrimitive(shape=ShapeRecord(sphere=Sphere(object_to_world=Transform.translate([tx, 0.0, 0.0]),
                                                             radius=1.0)), material=mat)

    if micro:
        a = sphere(-1.3, HostMaterial(kind="metal", params={"roughness": ("const", 0.08)}))
        b = sphere(1.3, HostMaterial(kind="matte", params={"Kd": ("const", np.array([0.5, 0.55, 0.6])),
                                                           "sigma": ("const", 20.0)}))
    else:
        a = sphere(-1.3, HostMaterial(kind="mirror", params={"Kr": ("const", np.array([0.9, 0.9, 0.9]))}))
        b = sphere(1.3, HostMaterial(kind="glass", params={}))
    if light == "distant":
        lights = [HostLight(kind="distant", from_point=np.array([0.0, 10.0, 0.0]), to_point=np.zeros(3),
                            intensity=np.array([3.0, 3.0, 3.0]))]
    elif light == "spot":
        lights = [HostLight(kind="spot", from_point=np.array([0.0, 5.0, 3.0]), to_point=np.array([0.0, -1.0, 0.0]),
                            intensity=np.array([55.0, 50.0, 45.0]), cone_angle=25.0, cone_delta=15.0)]
    else:
        lights = [HostLight(kind="point", from_point=np.array([0.0, 4.0, 2.0]),
                            intensity=np.array([30.0, 28.0, 26.0]))]
    return SceneDescription(
        primitives=[ground, a, b], lights=lights,
        camera=CameraConfig(kind="perspective", camera_to_world=Transform.look_at([2, 2, 5], [0, -0.4, 0], [0, 1, 0]),
                            fov=30.0),
        film=FilmConfig(x_resolution=W, y_resolution=H),
        sampler=SamplerConfig(kind=sampler, pixel_samples=SPP),
        integrator=IntegratorConfig(kind="path", max_depth=5))


def _small_gallery(w=W, h=H, spp=SPP):
    desc = spheres_gallery()
    desc.film.x_resolution, desc.film.y_resolution = w, h
    desc.sampler.pixel_samples = spp
    return desc


SCENES = {
    "mini": lambda: _mini_spheres(),
    "mini-micro": lambda: _mini_spheres(light="point", micro=True),
    "gallery": _small_gallery,
}


def _cfgs(desc):
    icfg = {"kind": desc.integrator.kind, "max_depth": desc.integrator.max_depth,
            "rr_threshold": desc.integrator.rr_threshold, "strategy": desc.integrator.strategy,
            "light_strategy": desc.integrator.light_strategy}
    return icfg, {"kind": desc.sampler.kind, "spp": desc.sampler.pixel_samples}, dict(FCFG)


def _compile_both(desc):
    return compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))


@pytest.fixture(scope="module")
def compiled():
    return {name: _compile_both(make()) for name, make in SCENES.items()}


# --- (a) tables ---------------------------------------------------------------


@pytest.mark.parametrize("scene", list(SCENES))
def test_brute_tables_bit_identical(compiled, scene):
    cs, ref = compiled[scene]
    assert cs.static.use_brute_force and ref.static.use_brute_force
    for f in dataclasses.fields(SceneTensors):
        if f.name in HOPPER_TABLES:  # derived from the wide tables, not reference tables
            assert getattr(cs.arrays, f.name) is None, f.name
            continue
        mine, theirs = getattr(cs.arrays, f.name), getattr(ref.arrays, f.name)
        if mine is None:
            assert f.name.startswith("w"), f.name  # only the wide tables are absent
            continue
        a, b = mine.numpy(), np.asarray(theirs)
        assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    for name in ("n_prims", "n_tris", "n_lights", "n_materials", "has_area_lights", "has_infinite",
                 "n_media", "use_brute_force"):
        assert getattr(cs.static, name) == getattr(ref.static, name), name
    assert cs.static.light_kinds == tuple(int(k) for k in ref.static.light_kinds)


def test_compile_scene_defaults_to_the_card():
    from pbrt_tpu_torch.scene import builder

    assert inspect.signature(builder.compile_scene).parameters["device"].default == "cuda"


# --- (b) lobes and constants -------------------------------------------------


@pytest.mark.parametrize("scene", list(SCENES))
def test_bake_lobes_matches_make_bsdf(compiled, scene):
    cs, ref = compiled[scene]
    n = int(ref.arrays.mat_kind.shape[0])
    lob = ref_make_bsdf(ref.arrays, ref.static, jnp.arange(n, dtype=jnp.int32), jnp.zeros((n, 2)), jnp.zeros((n, 3)))
    kind, data = bake_lobes(cs.arrays, cs.static)
    np.testing.assert_array_equal(kind.numpy(), np.asarray(lob["kind"]))
    np.testing.assert_array_equal(data.numpy(), np.asarray(lob["data"]))


def _both_consts(scene_desc, cs, ref, icfg=None, scfg=None):
    i, s, f = _cfgs(scene_desc)
    icfg, scfg = icfg or i, scfg or s
    mine = mk.extract_consts(cs, make_camera(scene_desc.camera, scene_desc.film, "cpu"), icfg, scfg, f)
    theirs = ref_mk.extract_consts(ref, ref_make_camera(ref.description.camera, ref.description.film), icfg, scfg, f)
    return mine, theirs


@pytest.mark.parametrize("scene", list(SCENES))
def test_extract_consts_matches_reference(compiled, scene):
    cs, ref = compiled[scene]
    mine, theirs = _both_consts(cs.description, cs, ref)
    assert mine is not None and theirs is not None
    assert len(mine["prims"]) == len(theirs["prims"])
    for p, q in zip(mine["prims"], theirs["prims"]):
        for key in ("kind", "pid", "mat", "flags", "r", "phimax"):
            assert p.get(key) == q.get(key), key
        for key in ("v", "w2o", "o2w", "ng_c", "ns_c", "ss_c", "ts_c"):
            if key in q:
                np.testing.assert_array_equal(np.asarray(p[key]), np.asarray(q[key]), err_msg=key)
    assert mine["mats"].keys() == theirs["mats"].keys()
    for m, e in theirs["mats"].items():
        assert mine["mats"][m] == {k: v for k, v in e.items() if k != "kd_tex"}, m
    assert [lt["kind"] for lt in mine["lights"]] == [lt["kind"] for lt in theirs["lights"]]
    for a, b in zip(mine["lights"], theirs["lights"]):
        np.testing.assert_array_equal(a["par"], b["par"])
    for key in ("light_cdf", "light_pmf", "r2c", "c2w"):
        np.testing.assert_array_equal(np.asarray(mine[key]), np.asarray(theirs[key]), err_msg=key)
    for key in ("uniform_select", "world_radius", "filter_xw", "filter_yw", "max_depth", "rr_threshold",
                "sampler", "spp", "max_lum", "ikind"):
        assert mine[key] == theirs[key], key


# --- (c) eligibility gates ---------------------------------------------------


def _area_lit_scene():
    """The mini scene with its ground quad emitting: brute class, area light.
    The port's compiler refuses it, so the port reads the reference's tables
    through scene_tensors_from_numpy, the one crossing point."""
    desc = _to_ref(_mini_spheres())
    desc.primitives[0].area_light = ref_host.HostLight(kind="area", intensity=np.array([1.0, 1.0, 1.0]))
    ref = ref_compile_scene(desc)
    arrays = {f.name: getattr(ref.arrays, f.name) for f in dataclasses.fields(ref.arrays)}
    static = {f.name: getattr(ref.static, f.name) for f in dataclasses.fields(ref.static)}
    sa, st = scene_tensors_from_numpy(arrays, static, "cpu")
    return CompiledScene(sa, st, _mini_spheres()), ref


def _many_tris_scene():
    desc = _mini_spheres()
    n = 10  # 2 * n = 20 ground triangles (> 16 prims, still brute)
    xs = np.linspace(-20, 20, n + 1)
    p = np.array([[x, -1.0, z] for x in xs for z in (-20.0, 20.0)])
    idx = np.array([[2 * i, 2 * i + 2, 2 * i + 1] for i in range(n)] + [[2 * i + 1, 2 * i + 2, 2 * i + 3] for i in range(n)],
                   np.int32)
    desc.primitives[0] = HostPrimitive(shape=ShapeRecord(mesh=TriangleMesh(p=p, indices=idx)),
                                       material=desc.primitives[0].material)
    return desc


def _partial_sphere_scene():
    desc = _mini_spheres()
    desc.primitives[1].shape.sphere.z_max = 0.5
    return desc


def _three_lights(desc):
    desc.lights = _small_gallery().lights
    return desc


GATES = ["halton", "area-light", "many-prims", "partial-sphere", "spatial", "directlighting-all"]


@pytest.mark.parametrize("gate", GATES)
def test_eligibility_gates(gate):
    if gate == "area-light":
        cs, ref = _area_lit_scene()
    else:
        desc = {"many-prims": _many_tris_scene, "partial-sphere": _partial_sphere_scene}.get(gate, _mini_spheres)()
        if gate in ("spatial", "directlighting-all"):
            desc = _three_lights(desc)
        cs, ref = _compile_both(desc)
    icfg, scfg, fcfg = _cfgs(cs.description)
    if gate == "halton":
        scfg = {"kind": "halton", "spp": SPP}
    elif gate == "spatial":
        icfg["light_strategy"] = "spatial"
    elif gate == "directlighting-all":
        icfg.update(kind="directlighting", strategy="all")
    mine, theirs = _both_consts(cs.description, cs, ref, icfg, scfg)
    assert mine is None and theirs is None
    cam = make_camera(cs.description.camera, cs.description.film, "cpu")
    assert not mk.megakernel_eligible(cs, cam, icfg, scfg, fcfg)
    assert mk.explain_ineligible(cs, cam, icfg, scfg, fcfg)
    if gate in ("many-prims", "partial-sphere"):
        # the port has no brute wavefront: the route refuses, naming why
        with pytest.raises(NotImplementedError, match="megakernel"):
            render.make_persistent_fn(cs)


def test_wavefront_still_refuses_glass_meshes(monkeypatch):
    """Glass in a wide scene compiles (the wide megakernel's class) and the
    wavefront route refuses it unless PBRT_TPU_WIDEMEGA=1."""
    from pbrt_tpu_torch.scenes import mesh_room

    desc = mesh_room(8)
    desc.primitives[0].material = HostMaterial(kind="glass")
    cs = compile_scene(desc, "cpu")
    monkeypatch.delenv("PBRT_TPU_WIDEMEGA", raising=False)
    with pytest.raises(NotImplementedError, match="glass"):
        render.make_persistent_fn(cs)


def test_make_camera_defaults_to_the_card():
    assert inspect.signature(make_camera).parameters["device"].default == "cuda"


def test_library_hash_covers_included_headers(tmp_path):
    """device/nvcc.py names a library by the source and every csrc header it
    includes, so an edit to a shared header rebuilds each kernel using it."""
    from pbrt_tpu_torch.device import nvcc

    (tmp_path / "a.cuh").write_text("#pragma once\n#define X 1\n")
    (tmp_path / "b.cuh").write_text('#pragma once\n#include "a.cuh"\n')
    src = tmp_path / "k.cu"
    src.write_text('#include "b.cuh"\n#include <cuda_runtime.h>\n')
    assert [f.name for f in nvcc._sources_of(src)] == ["k.cu", "b.cuh", "a.cuh"]
    before = nvcc._target(src)
    (tmp_path / "a.cuh").write_text("#pragma once\n#define X 2\n")
    after = nvcc._target(src)
    assert before != after and before.parent == after.parent
    assert nvcc._target(nvcc.CSRC / "megakernel_wide.cu") != nvcc._target(nvcc.CSRC / "megakernel.cu")
    assert {f.name for f in nvcc._sources_of(nvcc.CSRC / "megakernel_wide.cu")} == {
        "megakernel_wide.cu", "pt_common.cuh", "wide_traverse.cuh"}


# --- (d) the estimator against the reference kernel ----------------------------

CASES = [("zerotwosequence", "distant", False, "path"), ("random", "point", False, "path"),
         ("stratified", "distant", False, "path"), ("zerotwosequence", "spot", False, "path"),
         ("zerotwosequence", "point", True, "path"), ("random", "point", True, "path"),
         ("zerotwosequence", "distant", False, "directlighting")]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("sampler,light,micro,ikind", CASES)
def test_plain_matches_reference_kernel(sampler, light, micro, ikind, seed):
    """The stratified case holds the reference's own strata on both sides:
    floor(sqrt(spp)) x spp // that, always jittered (ROADMAP C)."""
    desc = _mini_spheres(sampler, light, micro)
    desc.integrator.kind = ikind
    cs, ref = _compile_both(desc)
    icfg, scfg, fcfg = _cfgs(desc)
    fn = ref_mk.make_megakernel_fn(ref, ref_make_camera(ref.description.camera, ref.description.film),
                                   icfg, scfg, fcfg, interpret=True)
    ys, xs = np.mgrid[0:H, 0:W]
    px, py, pid = xs.ravel(), ys.ravel(), (ys * W + xs).ravel()
    L_r, w_r, nv_r = (np.asarray(x) for x in fn(
        ref.arrays, jnp.asarray(px.astype(np.int32)), jnp.asarray(py.astype(np.int32)),
        jnp.asarray(pid.astype(np.uint32)), jnp.uint32(0), SPP, jnp.uint32(seed)))
    consts = mk.extract_consts(cs, make_camera(desc.camera, desc.film, "cpu"), icfg, scfg, fcfg)
    L, w, nv = (x.numpy() for x in mk.megakernel_plain(
        consts, *(torch.as_tensor(x.astype(np.int64)) for x in (px, py, pid)), 0, SPP, seed))
    assert L_r.mean() > 1e-3
    assert np.allclose(w, w_r)
    assert abs(float(nv.sum()) - float(nv_r.sum())) <= 4
    diff = np.abs(L - L_r)
    rel = diff / (np.abs(L_r) + 1e-2)
    assert float(rel.max()) < 2e-2, (float(rel.max()), float(diff.max()))
    assert float(diff.mean()) < 1e-4


# --- (e) the blob layout -------------------------------------------------------


def _unpack(blob, consts):
    """Read pack_consts's blob back into the fields consts holds."""
    b = blob.numpy().astype(np.float64)
    n_p, n_l, n_m = int(b[mk.H_N_PRIMS]), int(b[mk.H_N_LIGHTS]), int(b[mk.H_N_MATS])
    out = {
        "max_depth": int(b[mk.H_MAX_DEPTH]), "rr_threshold": b[mk.H_RR], "uniform_select": bool(b[mk.H_UNIFORM]),
        "ikind": {v: k for k, v in mk.IKINDS.items()}[int(b[mk.H_IKIND])], "sampler": int(b[mk.H_SAMPLER]),
        "world_radius": b[mk.H_WR2] / 2.0, "filter_xw": b[mk.H_FXW], "filter_yw": b[mk.H_FYW],
        "max_lum": b[mk.H_MAX_LUM], "r2c": b[mk.H_R2C:mk.H_R2C + 16].reshape(4, 4),
        "c2w": b[mk.H_C2W:mk.H_C2W + 12].reshape(3, 4), "light_cdf": b[mk.H_CDF:mk.H_CDF + n_l],
        "light_pmf": b[mk.H_PMF:mk.H_PMF + n_l], "lights": [], "prims": [], "mats": [],
    }
    for i in range(n_l):
        o = mk.LIGHT_BASE + i * mk.LIGHT_STRIDE
        out["lights"].append({"kind": int(b[o]), "par": b[o + 1:o + 13]})
    for i in range(n_p):
        o = mk.PRIM_BASE + i * mk.PRIM_STRIDE
        p = {"mat": int(b[o + mk.P_MAT]), "flags": int(b[o + mk.P_FLAGS])}
        if b[o + mk.P_KIND] == 0:
            p.update(kind="tri", v=b[o + mk.P_V:o + mk.P_V + 9].reshape(3, 3), ng_c=b[o + mk.P_NG:o + mk.P_NG + 3])
        else:
            p.update(kind="sph", w2o=b[o + mk.P_W2O:o + mk.P_W2O + 12].reshape(3, 4),
                     o2w=b[o + mk.P_O2W:o + mk.P_O2W + 12].reshape(3, 4), r=b[o + mk.P_R], phimax=b[o + mk.P_PHIMAX])
        out["prims"].append(p)
    for s in range(n_m):
        o = mk.MAT_BASE + s * mk.MAT_STRIDE
        out["mats"].append({"lobe": int(b[o + mk.M_LOBE]), "color": b[o + mk.M_COLOR:o + mk.M_COLOR + 3],
                            "ks": b[o + mk.M_KS:o + mk.M_KS + 3], "ax": b[o + mk.M_AX], "ay": b[o + mk.M_AY],
                            "eta": b[o + mk.M_ETA], "on_a": b[o + mk.M_ON_A], "on_b": b[o + mk.M_ON_B]})
    return out


@pytest.mark.parametrize("scene", list(SCENES))
def test_pack_consts_round_trips(compiled, scene):
    cs, _ref = compiled[scene]
    icfg, scfg, fcfg = _cfgs(cs.description)
    consts = mk.extract_consts(cs, make_camera(cs.description.camera, cs.description.film, "cpu"), icfg, scfg, fcfg)
    blob = mk.pack_consts(consts)
    assert blob.dtype == torch.float32 and blob.shape == (mk.BLOB_FLOATS,)
    got = _unpack(blob, consts)

    def f32(x):
        return np.asarray(x, np.float64).astype(np.float32).astype(np.float64)

    for key in ("max_depth", "uniform_select", "ikind"):
        assert got[key] == consts[key], key
    assert got["sampler"] == mk.SAMPLERS[consts["sampler"]]
    for key in ("rr_threshold", "filter_xw", "filter_yw", "max_lum", "light_cdf", "light_pmf", "r2c"):
        np.testing.assert_array_equal(got[key], f32(consts[key]), err_msg=key)
    np.testing.assert_array_equal(got["world_radius"], f32(2.0 * consts["world_radius"]) / 2.0)
    np.testing.assert_array_equal(got["c2w"], f32(np.asarray(consts["c2w"])[:3]))
    for a, b in zip(got["lights"], consts["lights"]):
        assert a["kind"] == b["kind"]
        np.testing.assert_array_equal(a["par"], f32(b["par"]))
    slots = {m: i for i, m in enumerate(sorted(consts["mats"]))}
    assert len(got["prims"]) == len(consts["prims"])
    for a, b in zip(got["prims"], consts["prims"]):
        assert (a["kind"], a["mat"], a["flags"]) == (b["kind"], slots[b["mat"]], b["flags"])
        for key in ("v", "ng_c", "w2o", "o2w", "r", "phimax"):
            if key in b:
                np.testing.assert_array_equal(a[key], f32(b[key]), err_msg=key)
    for m, s in slots.items():
        e = dict(mk.MAT_DEFAULTS, **consts["mats"][m])
        a = got["mats"][s]
        assert a["lobe"] == e["lobe"]
        for key in ("color", "ks", "ax", "ay", "eta", "on_a", "on_b"):
            if key in e:
                np.testing.assert_array_equal(a[key], f32(e[key]), err_msg=key)


# --- (f) the render route ------------------------------------------------------


def test_render_compiled_gallery_plain_brute():
    desc = _small_gallery(24, 12, 2)
    cs = compile_scene(desc, "cpu")
    full = render.render_compiled(cs, seed=1)
    timing = render.render_compiled.last_timing
    assert timing["tier"] == "torch-megakernel/plain-brute"
    assert full.shape == (12, 24, 3) and np.isfinite(full).all() and full.mean() > 0
    assert timing["n_vertices"] >= 24 * 12 * 2
    crop = dataclasses.replace(desc, integrator=dataclasses.replace(desc.integrator, pixel_bounds=(5, 17, 3, 9)))
    img = render.render_compiled(CompiledScene(cs.arrays, cs.static, crop), seed=1)
    np.testing.assert_array_equal(img[3:9, 5:17], full[3:9, 5:17])
    assert not img[:3].any() and not img[:, 17:].any()
    assert math.isclose(float(img[3:9, 5:17].mean()), float(full[3:9, 5:17].mean()))
