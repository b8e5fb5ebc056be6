"""The brute megakernel slice of the port against the reference, on the CPU.

Each scene is built once on the port's host types and converted field for
field to pbrt_tpu.scene.host's (``_to_ref``), so both compilers see the same
description. Covered:

(a) the brute-class tables equal the reference's bit for bit;
(b) bake_lobes equals the reference make_bsdf's lobe kinds and data, and
    extract_consts equals the reference's baked constants (a glossy uber
    row baked as the Lambert + GGX class among them);
(c) the eligibility gates return None where the reference's do (an uber
    row outside the baked lobe sets refused by its lobe set);
(d) megakernel_plain against the reference kernel itself in Pallas
    interpret mode, with the reference's own tolerance
    (tests/test_megakernel.py): weights allclose, total path vertices within
    4, per-pixel |dL| / (|L| + 1e-2) < 2e-2 and mean |dL| < 1e-4;
(e) pack_consts round-trips through a Python reader of its layout;
(f) render_compiled of a small spheres_gallery takes the plain-brute route.
"""
import dataclasses
import functools
import inspect
import math
import os
import re

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
from pbrt_tpu_torch.device.materials import bake_lobes, lobes_at_origin
from pbrt_tpu_torch.scene.arrays import HOPPER_TABLES, SceneTensors
from pbrt_tpu_torch.scene.builder import CompiledScene, compile_scene
from pbrt_tpu_torch.scene.host import (
    CameraConfig, FilmConfig, HostLight, HostMaterial, HostPrimitive, IntegratorConfig, SamplerConfig,
    SceneDescription, ShapeRecord, Sphere, TriangleMesh,
)
from pbrt_tpu_torch.scenes import spheres_gallery
from torch_threads import one_torch_thread  # noqa: F401  (autouse: PyTorch single-threaded in this module)

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


def _atlas_texture(res=16, colored=False, seed=4):
    """A res x res imagemap texture, grayscale unless colored, uv-mapped
    with 4 x 4 repeats: the brute megakernel's atlas class at res <= 128."""
    from pbrt_tpu_torch.scenes import _texture

    img = np.random.RandomState(seed).uniform(0.2, 0.9, (res, res, 3 if colored else 1)).astype(np.float32)
    return _texture("imagemap", image=np.broadcast_to(img, (res, res, 3)).copy(), uscale=4.0, vscale=4.0)


def _mini_spheres(sampler="zerotwosequence", light="distant", micro=False):
    """tests/test_megakernel.py's _mini_spheres on the port's host types;
    micro "atlas": the matte ground's Kd a grayscale imagemap of the
    megakernel's atlas class; "uber": the glass sphere a glossy uber one
    (Kd and Ks: the Lambert + GGX lobe set, which bakes), "uber-full": an
    uber one with Kr, Kt and opacity 0.7 too (outside the lobe sets)."""
    atlas = micro == "atlas"
    uber = micro if micro in ("uber", "uber-full") else None
    micro = micro is True
    gkind, gparams = "matte", {"Kd": ("const", np.array([0.6, 0.5, 0.4]))}
    if atlas:
        gparams = {"Kd": ("texture", _atlas_texture())}
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
    if uber:
        params = {"Kd": ("const", np.array([0.5, 0.3, 0.2])), "Ks": ("const", np.array([0.3, 0.3, 0.3])),
                  "roughness": ("const", 0.15), "eta": ("const", 1.7)}
        if uber == "uber-full":
            params.update(Kr=("const", np.array([0.3, 0.3, 0.3])), Kt=("const", np.array([0.3, 0.3, 0.3])),
                          opacity=("const", np.array([0.7, 0.7, 0.7])))
        b = sphere(1.3, HostMaterial(kind="uber", params=params))
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


def _small_textured_gallery():
    from pbrt_tpu_torch.scenes import textured_gallery

    desc = textured_gallery(16)
    desc.film.x_resolution, desc.film.y_resolution = W, H
    desc.sampler.pixel_samples = SPP
    return desc


SCENES = {
    "mini": lambda: _mini_spheres(),
    "mini-micro": lambda: _mini_spheres(light="point", micro=True),
    "mini-uber": lambda: _mini_spheres(light="point", micro="uber"),
    "gallery": _small_gallery,
    "textured-gallery": _small_textured_gallery,
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
            # the wide tables are absent, and the env map's where the reference's are
            assert f.name.startswith("w") or theirs is None, f.name
            continue
        if isinstance(mine, dict):  # the MIP levels
            assert mine.keys() == theirs.keys(), f.name
            for k in mine:
                np.testing.assert_array_equal(mine[k].numpy(), np.asarray(theirs[k]), err_msg=k)
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
    # what the extractor bakes: the rows' lobes with their textures at the
    # origin (bake_lobes for a scene without textured parameters)
    kind, data = lobes_at_origin(cs.arrays, cs.static)
    if not cs.static.tex_programs:
        k2, d2 = bake_lobes(cs.arrays, cs.static)
        assert torch.equal(kind, k2) and torch.equal(data, d2)
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
        assert {k: v for k, v in mine["mats"][m].items() if k != "kd_tex"} == {
            k: v for k, v in e.items() if k != "kd_tex"}, m
        # an atlas texture: the port names its row of kd_textures
        if e.get("kd_tex") is None:
            assert mine["mats"][m].get("kd_tex") is None
            continue
        t = mine["kd_textures"][mine["mats"][m]["kd_tex"]]
        for key in ("offs", "uscale", "vscale", "udelta", "vdelta", "scale", "base"):
            assert t[key] == e["kd_tex"][key], key
        np.testing.assert_array_equal(t["atlas"], e["kd_tex"]["atlas"])
    assert (mine["kd_atlas"] is None) == (theirs["kd_atlas"] is None)
    if theirs["kd_atlas"] is not None:
        np.testing.assert_array_equal(mine["kd_atlas"], theirs["kd_atlas"])
        assert mine["pixel_angle"] == theirs["pixel_angle"]
        for p, q in zip(mine["prims"], theirs["prims"]):
            assert p.get("uvd_c") == q.get("uvd_c")
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
    """The mini scene with its ground quad emitting: brute class, area light,
    which both compilers take and both megakernels refuse."""
    desc = _mini_spheres()
    desc.primitives[0].area_light = HostLight(kind="area", intensity=np.array([1.0, 1.0, 1.0]))
    return _compile_both(desc)


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


def _textured_gate(gate):
    """The atlas gates: a colored map, a map over 128 x 128, a textured
    sphere (both packages refuse each)."""
    desc = _mini_spheres(micro="atlas")
    if gate == "colored-imagemap":
        desc.primitives[0].material.params["Kd"] = ("texture", _atlas_texture(colored=True))
    elif gate == "imagemap-over-128":
        desc.primitives[0].material.params["Kd"] = ("texture", _atlas_texture(res=130))
    else:
        desc.primitives[1].material = HostMaterial(kind="matte", params={"Kd": ("texture", _atlas_texture())})
    return _compile_both(desc)


GATES = ["halton", "area-light", "many-prims", "partial-sphere", "spatial", "directlighting-all", "colored-imagemap",
         "imagemap-over-128", "textured-sphere", "full-uber"]
GATE_WORDS = {"colored-imagemap": "colored", "imagemap-over-128": "larger than 128", "textured-sphere": "spheres",
              "full-uber": "lobe set [1, 4, 6, 7, 7]"}


@pytest.mark.parametrize("gate", GATES)
def test_eligibility_gates(gate):
    if gate == "area-light":
        cs, ref = _area_lit_scene()
    elif gate == "full-uber":
        # uber's lobes are baked by lobe set, not by kind: transmission and
        # specular reflection are in no baked class (reference bake_lobe_entry)
        cs, ref = _compile_both(_mini_spheres(micro="uber-full"))
    elif gate in GATE_WORDS:
        cs, ref = _textured_gate(gate)
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
    assert GATE_WORDS.get(gate, "") in mk.explain_ineligible(cs, cam, icfg, scfg, fcfg)
    if gate in ("many-prims", "partial-sphere", "area-light") or gate in GATE_WORDS:
        # outside the megakernel's class, the brute wavefront takes the scene
        render.make_persistent_fn(cs)
        assert render.LAST_PERSISTENT_TIER == "torch-wavefront/plain-brute"


def new_material(kind, table_dir):
    """A material of the kinds the megakernels gate by lobe set since the
    slice of substrate, translucent, disney, mix, fourier and hair, and the
    reason each port extractor names when it refuses it (None: baked). A
    translucent row without transmission has the lobe set [LAMBERT_R,
    MICRO_R] (plastic's) and without Ks [LAMBERT_R] (matte's)."""
    from pbrt_tpu_torch.core.fourierbsdf import write_rough_conductor_table
    from pbrt_tpu_torch.scenes import ZOO_DISNEY

    const = lambda v: ("const", np.asarray(v, np.float64))  # noqa: E731
    if kind == "substrate":
        return HostMaterial(kind="substrate", params={"uroughness": ("const", 0.05)}), "the lobe set [9]"
    if kind == "disney":
        params = {k: const(v) for k, v in ZOO_DISNEY.items()}
        return HostMaterial(kind="disney", params=dict(params, remaproughness=("const", False))), "lobe set [10, 4, 11]"
    if kind == "fourier":
        path = str(table_dir / "rc.bsdf")
        write_rough_conductor_table(path, alpha=0.3, nmu=8)
        return HostMaterial(kind="fourier", params={"bsdffile": ("const", path), "Kd": const([0.5] * 3)}), "[12]"
    if kind == "hair":
        return HostMaterial(kind="hair", params={"eumelanin": ("const", 1.3)}), "the lobe set [13]"
    if kind == "translucent":
        return HostMaterial(kind="translucent", params={}), "the lobe set [1, 2, 4, 5]"
    if kind == "mix":
        return HostMaterial(kind="mix", params={"material1": ("material", HostMaterial(kind="matte")),
                                                "material2": ("material", HostMaterial(kind="plastic"))}), "mix"
    transmit0 = {"Kd": const([0.6, 0.5, 0.4]), "transmit": const([0.0] * 3)}
    if kind == "translucent-no-transmit":
        return HostMaterial(kind="translucent", params=transmit0), None
    assert kind == "translucent-no-transmit-no-ks"
    return HostMaterial(kind="translucent", params=dict(transmit0, Ks=const([0.0] * 3))), None


NEW_KINDS = ["substrate", "disney", "fourier", "hair", "translucent", "mix", "translucent-no-transmit",
             "translucent-no-transmit-no-ks"]


@pytest.mark.parametrize("kind", NEW_KINDS)
def test_new_material_gates_as_reference(kind, tmp_path):
    """The extractor decides a row of each new kind by its lobe set, as the
    reference's does: substrate, disney, fourier, hair and a transmitting
    translucent row are refused naming their lobe set, mix rows by name;
    a translucent row without transmission bakes to the reference's entry
    (Lambert + GGX, as plastic; Lambert alone without Ks)."""
    desc = _mini_spheres(light="point")
    mat, word = new_material(kind, tmp_path)
    desc.primitives[2].material = mat
    cs, ref = _compile_both(desc)
    mine, theirs = _both_consts(desc, cs, ref)
    cam = make_camera(desc.camera, desc.film, "cpu")
    icfg, scfg, fcfg = _cfgs(desc)
    if word is not None:
        assert mine is None and theirs is None
        assert word in mk.explain_ineligible(cs, cam, icfg, scfg, fcfg)
        return
    assert mine is not None and theirs is not None
    assert mine["mats"].keys() == theirs["mats"].keys()
    for m, e in theirs["mats"].items():
        assert mine["mats"][m] == {k: v for k, v in e.items() if k != "kd_tex"}, m
    m = int(cs.arrays.mat_kind.numpy().tolist().index(8))  # the translucent row
    assert mine["mats"][m]["lobe"] == (mk.LOBE_PLASTIC if kind == "translucent-no-transmit" else 1)


def test_bump_maps_go_to_the_wavefront():
    """A bump-mapped scene of the class: the reference's megakernel takes it
    and renders it without bumps (ROADMAP C); the port's refuses it, naming
    "bump maps", and the brute wavefront renders it with them."""
    from pbrt_tpu_torch.scenes import _texture

    desc = _mini_spheres()
    height = _atlas_texture()
    height.is_float = True  # a grayscale height map of the atlas class, which the reference's kernel takes
    desc.primitives[0].material.bump_map = ("texture", height)
    cs, ref = _compile_both(desc)
    assert cs.static.has_bump and ref.static.has_bump
    mine, theirs = _both_consts(desc, cs, ref)
    assert theirs is not None and mine is None
    icfg, scfg, fcfg = _cfgs(desc)
    assert mk.explain_ineligible(cs, make_camera(desc.camera, desc.film, "cpu"), icfg, scfg, fcfg) == "bump maps"
    render.make_persistent_fn(cs)
    assert render.LAST_PERSISTENT_TIER == "torch-wavefront/plain-brute"


def test_wavefront_still_refuses_glass_meshes(monkeypatch):
    """Glass in a wide scene compiles (the wide megakernel's class), and
    without PBRT_TPU_WIDEMEGA=1 the wavefront renders it."""
    from pbrt_tpu_torch.scenes import mesh_room

    desc = mesh_room(8)
    desc.primitives[0].material = HostMaterial(kind="glass")
    cs = compile_scene(desc, "cpu")
    monkeypatch.delenv("PBRT_TPU_WIDEMEGA", raising=False)
    wave = render.make_persistent_fn(cs)
    assert render.LAST_PERSISTENT_TIER == "torch-wavefront/plain-wide"
    lanes = torch.arange(0, 32 * 16, 37)
    L, w, nv = wave(cs.arrays, lanes % 32, lanes // 32, lanes, 0, 2, 0)
    assert torch.isfinite(L).all() and torch.equal(w, torch.full_like(w, 2.0)) and float(nv.sum()) > 0


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


def _cu_defines():
    """The kernel's defines, and pt_common.cuh's sphere record (SPH_*) under
    the prim record's names, which a sphere's prim record shares."""
    src = mk.KERNEL_SOURCE.read_text() + (mk.KERNEL_SOURCE.parent / "pt_common.cuh").read_text()
    d = {k: int(v) for k, v in re.findall(r"^#define (\w+) \(?(-?\d+)\)?\s*(?://.*)?$", src, re.MULTILINE)}
    for name in ("W2O", "O2W", "R", "R2", "PHIMAX", "ERRC"):
        d["P_" + name] = d["SPH_" + name]
    assert d["SPH_FLAGS"] == d["P_FLAGS"]
    return d


def test_blob_test_and_split_layouts_match_the_kernel():
    """The blob offsets and the record of cycles and test counts that the
    wrapper reads are the kernel source's (csrc/megakernel.cu), and the
    shared-memory copy of the blob keeps every field the kernel reads."""
    d = _cu_defines()
    for name in ("H_N_PRIMS", "H_N_LIGHTS", "H_N_MATS", "H_MAX_DEPTH", "H_RR", "H_UNIFORM", "H_IKIND",
                 "H_SAMPLER", "H_STRAT_XS", "H_STRAT_YS", "H_WR2", "H_FXW", "H_FYW", "H_MAX_LUM", "H_G7", "H_G53",
                 "H_R2C", "H_C2W", "H_CDF", "H_PMF", "HEADER", "MAX_LIGHTS", "MAX_PRIMS", "MAX_MATS",
                 "LIGHT_STRIDE", "PRIM_STRIDE", "MAT_STRIDE", "P_KIND", "P_MAT", "P_FLAGS", "P_V", "P_NG", "P_NS",
                 "P_SS", "P_TS", "P_W2O", "P_O2W", "P_R", "P_R2", "P_PHIMAX", "P_ERRC", "H_CONE_PA", "P_UV", "P_UVD",
                 "M_TEX", "TX_NLEV", "TX_BASE", "TX_US", "TX_VS", "TX_UD", "TX_VD", "TX_SCALE", "TX_SMAX", "TX_LMAX",
                 "TX_LEVELS", "TEX_STRIDE", "ATLAS_W"):
        assert d[name] == getattr(mk, name), name
    assert d["P_FIELDS"] == mk.P_ERRC + 3 and d["M_FIELDS"] == mk.M_ON_B + 1 == mk.M_TEX
    assert mk.P_UVD < d["P_FIELDS"]  # the triangle's uv fields ride the shared copy
    got = {k[len("SPLIT_"):].lower(): v for k, v in d.items() if k.startswith("SPLIT_")}
    assert d["N_SPLIT"] == len(mk.SPLIT_FIELDS) == len(got)
    names = {"shade": "shade_nee", "flush": "flush_regen", "idle": "idle_tail", "iters": "iterations"}
    assert [names.get(k, k) for k in sorted(got, key=got.get)] == list(mk.SPLIT_FIELDS)


def test_sobol2_direction_table_matches_the_twin():
    """pt_common.cuh's sobol2 XORs a table of direction numbers over the set
    bits of the index; the table is the twin's recurrence, so the result is
    the 32-bit loop's bit for bit."""
    src = (mk.nvcc.CSRC / "pt_common.cuh").read_text()
    body = src[src.index("SOBOL2_V[32] = {"):]
    table = [int(x, 16) for x in re.findall(r"0x([0-9a-f]{8})u", body[:body.index("};")])]
    assert table == mk._SOBOL2
    idx = torch.arange(0, 4096, 37, dtype=torch.int64)
    scr = torch.as_tensor(np.random.RandomState(4).randint(0, 2 ** 32, idx.shape[0], dtype=np.uint64).astype(np.int64))
    set_bits = scr.clone()
    for i, v in enumerate(table):  # the set bits only, in any order
        set_bits = torch.where((idx >> i) & 1 == 1, set_bits ^ v, set_bits)
    assert torch.equal(mk._u2f01(set_bits), mk._sobol2(idx, scr))


@pytest.mark.parametrize("entry", ["megakernel_cuda", "megakernel_split"])
def test_cuda_entries_refuse_cpu_lanes(entry):
    """The kernel's wrappers take CUDA tensors only: CPU lanes raise before
    any build or launch (the route sends CPU lanes to the plain twin)."""
    lanes = torch.arange(4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(mk, entry)(torch.zeros(mk.BLOB_FLOATS), 0, lanes, lanes, lanes, 0, 1, 0)


# --- (d) the estimator against the reference kernel ----------------------------

CASES = [("zerotwosequence", "distant", False, "path"), ("random", "point", False, "path"),
         ("stratified", "distant", False, "path"), ("zerotwosequence", "spot", False, "path"),
         ("zerotwosequence", "point", True, "path"), ("random", "point", True, "path"),
         ("zerotwosequence", "distant", False, "directlighting"), ("zerotwosequence", "distant", "atlas", "path")]


@functools.lru_cache(maxsize=1)
def _kernel_case(sampler, light, micro, ikind):
    """One case's scenes, the reference kernel (jitted once: the seeds'
    runs share its compile) and the port's constants."""
    desc = _mini_spheres(sampler, light, micro)
    desc.integrator.kind = ikind
    cs, ref = _compile_both(desc)
    icfg, scfg, fcfg = _cfgs(desc)
    fn = ref_mk.make_megakernel_fn(ref, ref_make_camera(ref.description.camera, ref.description.film),
                                   icfg, scfg, fcfg, interpret=True)
    return ref, fn, mk.extract_consts(cs, make_camera(desc.camera, desc.film, "cpu"), icfg, scfg, fcfg)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("sampler,light,micro,ikind", CASES)
def test_plain_matches_reference_kernel(sampler, light, micro, ikind, seed):
    """The stratified case holds the reference's own strata on both sides:
    floor(sqrt(spp)) x spp // that, always jittered (ROADMAP C). The atlas
    case's ground Kd is a grayscale imagemap: the ray-cone trilinear
    lookup in the mip atlas (the sums of its taps may differ from the
    reference's row-by-row order in the last ulp). The two seeds of a case
    run one after the other and share its compiled reference kernel."""
    ref, fn, consts = _kernel_case(sampler, light, micro, ikind)
    ys, xs = np.mgrid[0:H, 0:W]
    px, py, pid = xs.ravel(), ys.ravel(), (ys * W + xs).ravel()
    L_r, w_r, nv_r = (np.asarray(x) for x in fn(
        ref.arrays, jnp.asarray(px.astype(np.int32)), jnp.asarray(py.astype(np.int32)),
        jnp.asarray(pid.astype(np.uint32)), jnp.uint32(0), SPP, jnp.uint32(seed)))
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


# the kinds of the persistent wavefront's class that no megakernel bakes,
# and the name each extractor gives when it refuses them
SLICE_KINDS = {"orthographic": "'orthographic' cameras", "environment": "'environment' cameras",
               "goniometric": "goniometric lights", "projection": "projection lights",
               "cylinder": "'cylinder' quadrics", "disk": "'disk' quadrics", "cone": "'cone' quadrics",
               "paraboloid": "'paraboloid' quadrics", "hyperboloid": "'hyperboloid' quadrics",
               "instancing": "object instancing", "alpha": "alpha cutouts",
               "media": "participating media", "medium interface": "medium interfaces",
               "interface": "the 'interface' material", "subsurface": "the 'subsurface' material",
               "kdsubsurface": "the 'kdsubsurface' material", "motion": "motion blur",
               "animated camera": "animated cameras", "realistic": "'realistic' cameras"}


@functools.lru_cache(maxsize=None)
def _one_lens() -> str:
    """A lens file of one biconvex element and the stop (a realistic camera
    that focuses and bounds its pupil in a fraction of the double Gauss's
    time)."""
    import tempfile

    path = os.path.join(tempfile.mkdtemp(prefix="lens_"), "one.dat")
    with open(path, "w") as f:
        f.write("20.0 3.0 1.5 12.0\n-20.0 2.0 1.0 12.0\n0.0 40.0 0.0 8.0\n")
    return path


def slice_kind_scene(desc, kind):
    """desc with one of SLICE_KINDS put in: the camera, a light at (0, 4, 2)
    (an 8 x 4 map), the last prim's sphere made that quadric, the first
    mesh instanced by a translation, or the first mesh given an alpha
    texture (a constant 0.5: cut nowhere), a homogeneous fog as the
    camera's medium (and the first prim's inside), the first mesh given
    the interface, subsurface or kdsubsurface material, the last prim
    moving 0.2 over the shutter, or the camera doing so (animated)."""
    from pbrt_tpu_torch.scene.host import HostMedium
    from pbrt_tpu_torch.scenes import _texture

    if kind in ("media", "medium interface"):
        desc.media = {"fog": HostMedium(kind="homogeneous", sigma_a=np.full(3, 0.1), sigma_s=np.full(3, 0.2))}
        desc.camera_medium = "fog"
        desc.primitives[0].inside_medium = "fog" if kind == "medium interface" else ""
        return desc
    if kind in ("interface", "subsurface", "kdsubsurface"):
        mesh = next(p for p in desc.primitives if p.shape.mesh is not None)
        mesh.material = HostMaterial(kind={"interface": "none"}.get(kind, kind), params={"eta": ("const", 1.33)})
        return desc

    if kind == "motion":
        from pbrt_tpu_torch.scenes import _animate

        prim = desc.primitives[-1]
        o2w = prim.shape.sphere.object_to_world if prim.shape.mesh is None else Transform()
        _animate(prim.shape, o2w, Transform.from_matrix(Transform.translate([0.2, 0.0, 0.0]).m @ o2w.m))
    elif kind == "animated camera":
        c2w = desc.camera.camera_to_world
        desc.camera = dataclasses.replace(desc.camera, camera_to_world_end=Transform.translate([0.1, 0.0, 0.0]) @ c2w)
    elif kind == "realistic":
        desc.camera = dataclasses.replace(desc.camera, kind=kind, lens_file=_one_lens())
    elif kind in ("orthographic", "environment"):
        desc.camera = dataclasses.replace(desc.camera, kind=kind)
    elif kind in ("goniometric", "projection"):
        desc.lights.append(HostLight(kind=kind, light_to_world=Transform.translate([0.0, 4.0, 2.0]),
                                     intensity=np.array([5.0, 5.0, 5.0]), image=np.full((4, 8, 3), 0.5, np.float32),
                                     cone_angle=40.0))
    elif kind == "instancing":
        first = next(p for p in desc.primitives if p.shape.mesh is not None)
        desc.primitives.append(dataclasses.replace(first, instance_transform=Transform.translate([0.0, 0.5, 0.0])))
    elif kind == "alpha":
        mesh = next(p for p in desc.primitives if p.shape.mesh is not None).shape.mesh
        mesh.alpha_texture = _texture("constant", is_float=True, value=np.array([0.5]))
    else:
        sph = next(p for p in reversed(desc.primitives) if p.shape.mesh is None).shape.sphere
        sph.kind = kind
        sph.height, sph.z_min, sph.z_max = 0.8, 0.0, 0.8
        sph.p1, sph.p2 = np.array([0.6, 0.0, -0.5]), np.array([0.3, 0.5, 0.5])
    return desc


@pytest.mark.parametrize("kind", list(SLICE_KINDS))
def test_slice_kinds_refused_by_name(kind):
    """B3's extractor refuses each kind of the wavefront's class that it does
    not bake, naming it, as the reference's refuses them (a camera other
    than the perspective one, lights other than point, spot and distant,
    quadrics other than spheres, instanced rows) -- except alpha cutouts:
    the reference's B3 never checks them and would render a cut-out
    triangle whole (ROADMAP C); the port refuses them and the brute
    wavefront renders the cut-outs; and the interface material, which the
    reference's B3 bakes as a surface without lobes (its render_compiled
    sends such a scene to the wave; the port's B3 refuses it)."""
    desc = slice_kind_scene(_mini_spheres(light="point"), kind)
    cs, ref = _compile_both(desc)
    mine, theirs = _both_consts(desc, cs, ref)
    assert mine is None and (theirs is not None) == (kind in ("alpha", "interface"))
    icfg, scfg, fcfg = _cfgs(desc)
    assert mk.explain_ineligible(cs, make_camera(desc.camera, desc.film, "cpu"), icfg, scfg, fcfg) == SLICE_KINDS[kind]
