"""The port's scene compiler against the reference's, table for table.

pbrt_tpu_torch.scene.builder.compile_scene(mesh_room(8)) must produce
exactly the tables pbrt_tpu.scene.builder.compile_scene(bench._mesh_scene(8))
produces (770 prims: wide-eligible), and the port must import without JAX.
"""
import subprocess
import sys
from dataclasses import fields
from pathlib import Path

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from pbrt_tpu.scene.builder import compile_scene as ref_compile_scene
from pbrt_tpu_torch.scene.arrays import HOPPER_TABLES, SceneTensors, scene_tensors_from_numpy
from pbrt_tpu_torch.scene.builder import compile_scene
from pbrt_tpu_torch.scene.widebvh import hopper_layout
from pbrt_tpu_torch.scene.host import HostMaterial
from pbrt_tpu_torch.scenes import mesh_room
from torch_threads import one_torch_thread  # noqa: F401  (autouse: PyTorch single-threaded in this module)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def both():
    return compile_scene(mesh_room(8), "cpu"), ref_compile_scene(bench._mesh_scene(8))


@pytest.mark.parametrize("name", [f.name for f in fields(SceneTensors) if f.name not in HOPPER_TABLES])
def test_tables_bit_identical(both, name):
    """Every table of the mesh room equals the reference's; the room has
    neither an attribute table nor an image-mapped light, and those are
    None in both; it has no texture (tex_param the reference's zero row,
    mat_bump -1, no MIP levels)."""
    cs, ref = both
    a, b = getattr(cs.arrays, name), getattr(ref.arrays, name)
    assert (a is None) == (b is None)
    if a is None:
        return
    if isinstance(a, dict):  # the MIP levels: the room has no imagemap
        assert a.keys() == b.keys() == set()
        return
    a, b = a.numpy(), np.asarray(b)
    assert a.shape == b.shape
    assert a.dtype.kind == b.dtype.kind and a.dtype.itemsize == b.dtype.itemsize
    np.testing.assert_array_equal(a, b)


def test_static_matches(both):
    cs, ref = both
    assert cs.static.n_prims == ref.static.n_prims == 770
    assert ref.static.has_wide and cs.static.has_wide
    for name in ("wide_root", "n_tris", "n_lights", "n_materials", "mat_kinds_present",
                 "light_kinds", "has_area_lights"):
        mine, theirs = getattr(cs.static, name), getattr(ref.static, name)
        if isinstance(mine, tuple):
            theirs = tuple(int(x) for x in theirs)
        assert mine == theirs, name


def test_reference_tables_cross_unchanged(both):
    """scene_tensors_from_numpy fills the port from a reference scene."""
    _cs, ref = both
    arrays = {f.name: getattr(ref.arrays, f.name) for f in fields(ref.arrays)}
    static = {f.name: getattr(ref.static, f.name) for f in fields(ref.static)}
    sa, st = scene_tensors_from_numpy(arrays, static, "cpu")
    assert st.wide_root == ref.static.wide_root
    np.testing.assert_array_equal(sa.wprim_tab.numpy(), np.asarray(ref.arrays.wprim_tab))
    assert sa.prim_mat.dtype == torch.int32


def test_hopper_tables_derive_from_reference(both):
    """The wide BVH's Hopper records, which the kernels read, are
    widebvh.hopper_layout of the reference's own tables."""
    cs, ref = both
    want = hopper_layout(*(np.asarray(getattr(ref.arrays, n)) for n in ("wnode_tab", "wprim_tab", "wmeta_tab")))
    for name, rec in zip(HOPPER_TABLES, want):
        got = getattr(cs.arrays, name)
        assert got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy().view(np.int32), rec.view(np.int32))


@pytest.mark.parametrize("feature", ["material", "light", "small", "sampler"])
def test_outside_the_slice_raises(feature, monkeypatch):
    """A mirror or a point light in a wide scene and a lone emitting panel
    (brute class, area lights) compile, and the wavefront takes them
    without PBRT_TPU_WIDEMEGA=1 (the panel: the brute wavefront); so does
    the halton sampler with its film tables. A sampler the port does not
    know is still refused at compile time."""
    from pbrt_tpu_torch import render
    from pbrt_tpu_torch.scene.host import HostLight

    desc = mesh_room(8)
    if feature == "material":
        desc.primitives[0].material = HostMaterial(kind="mirror")
    elif feature == "light":
        desc.lights.append(HostLight(kind="point", from_point=np.array([0.0, 2.0, 0.0]), intensity=np.ones(3)))
    elif feature == "small":
        desc = mesh_room(1)
        desc.primitives = desc.primitives[-1:]
    else:
        desc.sampler.kind = "pmj02bn"
        with pytest.raises(NotImplementedError, match="pmj02bn"):
            compile_scene(desc, "cpu")
        desc.sampler.kind = "halton"
    cs = compile_scene(desc, "cpu")
    monkeypatch.delenv("PBRT_TPU_WIDEMEGA", raising=False)
    wave = render.make_persistent_fn(cs)
    assert render.LAST_PERSISTENT_TIER == "torch-wavefront/plain-" + ("brute" if feature == "small" else "wide")
    lanes = torch.arange(0, 1000 * 500, 12_347)
    L, w, _nv = wave(cs.arrays, lanes % 1000, lanes // 1000, lanes, 0, 1, 0)
    assert torch.isfinite(L).all() and torch.equal(w, torch.ones_like(w))


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['PIL'] = None\n"
        "import pbrt_tpu_torch.render, pbrt_tpu_torch.scenes, pbrt_tpu_torch.device.wide_bvh\n"
        "import pbrt_tpu_torch.device.megakernel, pbrt_tpu_torch.device.nvcc, pbrt_tpu_torch.core.spectrum\n"
        "import pbrt_tpu_torch.device.megakernel_wide, pbrt_tpu_torch.device.sampler, pbrt_tpu_torch.device.media\n"
        "import pbrt_tpu_torch.parser.api, pbrt_tpu_torch.parser.parser, pbrt_tpu_torch.parser.catprint\n"
        "import pbrt_tpu_torch.main, pbrt_tpu_torch.__main__\n"
        "import pbrt_tpu_torch.core.imageio, pbrt_tpu_torch.scene.tessellate, pbrt_tpu_torch.utils.stats\n"
        "import pbrt_tpu_torch.device.medium_track, pbrt_tpu_torch.device.bssrdf, pbrt_tpu_torch.core.bssrdf\n"
        "import pbrt_tpu_torch.device.motion, pbrt_tpu_torch.device.realistic, pbrt_tpu_torch.device.bdpt\n"
        "import pbrt_tpu_torch.device.mlt, pbrt_tpu_torch.device.sppm, pbrt_tpu_torch.parallel.shard\n"
        "assert not any(m == 'pbrt_tpu' or m.startswith('pbrt_tpu.') for m in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# --- mixed scenes: more than 64 triangles beside full or partial spheres ---------


@pytest.fixture(scope="module")
def mixed():
    """The reference test's mixed rooms (tests/test_megakernel_wide.py:251,
    :312) on the port's host types, compiled by both packages."""
    from test_torch_megakernel import _to_ref
    from test_torch_megakernel_wide import _mixed_room

    out = {}
    for kind in ("spheres", "lamp"):
        desc = _mixed_room(kind)
        out[kind] = compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))
    return out


@pytest.mark.parametrize("kind", ["spheres", "lamp"])
def test_mixed_tables_bit_identical(mixed, kind):
    """A mixed room's tables equal the reference's, the wide tables over the
    triangle subset included, and so do its static fields: has_wide stays
    False, has_wide_tri is True, n_spheres, has_cone_sphere_lights (the
    sphere lamp). The leaf rows the walks read carry the global prim row;
    wide_prim_rows lists them (the reference tables index the subset)."""
    cs, ref = mixed[kind]
    for f in fields(SceneTensors):
        if f.name in HOPPER_TABLES:
            continue
        a, b = getattr(cs.arrays, f.name), getattr(ref.arrays, f.name)
        assert (a is None) == (b is None), f.name
        if a is None or isinstance(a, dict):
            continue
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f.name)
    for name in ("n_prims", "n_tris", "n_spheres", "n_lights", "use_brute_force", "has_wide", "has_wide_tri",
                 "has_cone_sphere_lights", "has_area_lights", "wide_root"):
        assert getattr(cs.static, name) == getattr(ref.static, name), name
    assert cs.static.has_wide_tri and not cs.static.has_wide
    assert cs.static.has_cone_sphere_lights == (kind == "lamp")
    rows = np.nonzero(cs.arrays.prim_kind.numpy() == 0)[0]
    np.testing.assert_array_equal(cs.arrays.wide_prim_rows.numpy(), rows)
    leaf = cs.arrays.wleaf_rec.numpy()
    valid = leaf[:, 9] > 0
    slots = cs.arrays.wslot_prim.numpy()
    np.testing.assert_array_equal(leaf[valid, 10], rows[slots[slots >= 0]])


def test_mixed_queries_match_reference(mixed):
    """The mixed closest and any hit (the triangle subset's walk, the
    spheres tested beside it and merged by t) against the reference's
    intersect and intersect_p (its packet loop over the binary BVH of every
    prim) on the same rays: random rays in the room and rays toward the
    spheres. Prim ids and hit flags equal; t within rtol 1e-6 on
    triangles and 1e-5 on spheres (the reference's jitted loop contracts
    the quadratic's b^2 - 4ac into fused multiply-adds, and the root's
    cancellation carries that to ~7e-6 relative on 10 of the 1,563 hits);
    barycentrics within atol 1e-6; a sphere's b1, b2 are its object-space
    hit point o + t d, the reference's likewise, within atol 2e-5 (t's
    error times the distance: up to 1.3e-5 here)."""
    from pbrt_tpu.device import intersect as ref_isect
    from pbrt_tpu_torch.device import intersect

    cs, ref = mixed["spheres"]
    rs = np.random.RandomState(21)
    n = 2048
    o = np.stack([rs.uniform(-3.5, 3.5, n), rs.uniform(0.6, 3.5, n), rs.uniform(-3.5, 3.5, n)], -1)
    centers = cs.arrays.sph_o2w.numpy()[:, :, 3]
    d = rs.normal(size=(n, 3))
    d[: n // 2] = centers[rs.randint(0, len(centers), n // 2)] + rs.normal(scale=0.4, size=(n // 2, 3)) - o[: n // 2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    t_max = np.where(rs.uniform(size=n) < 0.5, np.inf, rs.uniform(0.5, 6.0, n)).astype(np.float32)
    mine = intersect.intersect(cs.arrays, cs.static, *(torch.as_tensor(x) for x in (o, d, t_max)))
    theirs = ref_isect.intersect(ref.arrays, ref.static, *(jnp.asarray(x) for x in (o, d, t_max)))
    prim = np.asarray(theirs["prim"])
    np.testing.assert_array_equal(mine["prim"].numpy(), prim)
    kind = cs.arrays.prim_kind.numpy()[np.maximum(prim, 0)]
    assert ((prim >= 0) & (kind == 1)).mean() > 0.2 and ((prim >= 0) & (kind == 0)).mean() > 0.2
    t, t_r = mine["t"].numpy(), np.asarray(theirs["t"])
    tri, sph = (prim >= 0) & (kind == 0), (prim >= 0) & (kind == 1)
    np.testing.assert_allclose(t[tri], t_r[tri], rtol=1e-6)
    np.testing.assert_allclose(t[sph], t_r[sph], rtol=1e-5)
    for key in ("b1", "b2"):
        b, b_r = mine[key].numpy(), np.asarray(theirs[key])
        np.testing.assert_allclose(b[tri], b_r[tri], atol=1e-6, err_msg=key)
        np.testing.assert_allclose(b[sph], b_r[sph], atol=2e-5, err_msg=key)
    occ = intersect.intersect_p(cs.arrays, cs.static, *(torch.as_tensor(x) for x in (o, d, t_max)))
    occ_r = ref_isect.intersect_p(ref.arrays, ref.static, *(jnp.asarray(x) for x in (o, d, t_max)))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_r))


@pytest.mark.parametrize("case", ["cylinder", "nine-quadrics", "few-triangles"])
def test_mixed_scene_refusals_name_the_feature(case):
    """What the reference takes through its binary-BVH packet loop: the
    other quadrics, more than 8 quadrics in a scene of more than 64 prims,
    and such a scene of 64 triangles or fewer. Since the binary-BVH walk
    (device/bvh_walk.py) the port compiles each and routes it there, with
    the reference's tables; motion blur on one of the quadrics too, which
    keeps the scene on the walk; under the sppm integrator it renders
    through SPPM's host loop on the walk (route torch-sppm/bvh)."""
    from pbrt_tpu_torch.core.transform import Transform
    from pbrt_tpu_torch.device.intersect import route_name
    from pbrt_tpu_torch.scene.host import HostPrimitive, ShapeRecord, Sphere
    from test_torch_megakernel import _to_ref
    from test_torch_sppm import render_small

    desc = mesh_room(8)
    glass = HostMaterial(kind="glass")

    def quadric(i, kind="sphere"):
        return HostPrimitive(shape=ShapeRecord(sphere=Sphere(object_to_world=Transform.translate([i * 0.5, 2.0, 0.0]),
                                                             radius=0.2, kind=kind, height=0.3)), material=glass)

    if case == "cylinder":
        desc.primitives.append(quadric(0, "cylinder"))
    elif case == "nine-quadrics":
        desc.primitives += [quadric(i) for i in range(9)]
    else:
        desc.primitives = desc.primitives[-1:] + [quadric(i) for i in range(70)]  # the panel: 2 triangles
    cs, ref = compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))
    assert route_name(cs.static) == "bvh"
    for name in ("prim_test_data", "bvh_packed", "sph_param", "prim_kind", "prim_area"):
        np.testing.assert_array_equal(getattr(cs.arrays, name).numpy(), np.asarray(getattr(ref.arrays, name)))
    desc.primitives[-1].shape.sphere.object_to_world_end = Transform.translate([0.0, 3.0, 0.0])
    moving = compile_scene(desc, "cpu")
    assert moving.static.has_motion and route_name(moving.static) == "bvh"
    img, tier = render_small(desc, "sppm")
    assert tier == "torch-sppm/bvh" and np.isfinite(img).all()


def test_sphere_room_routes(monkeypatch):
    """sphere_room and uber_room: seven full spheres (a sphere lamp among
    them) beside material_room's 3,854 triangles, five lights; the
    wavefront's route label names the mixed query; the wide megakernel
    takes sphere_room (its uber rows glossy) and refuses uber_room by lobe
    set."""
    from pbrt_tpu_torch import render, scenes

    monkeypatch.setenv("PBRT_TPU_WIDEMEGA", "1")
    for make, tier in ((scenes.sphere_room, "torch-megakernel/plain-wide"),
                       (scenes.uber_room, "torch-wavefront/plain-wide-mixed")):
        cs = compile_scene(make(), "cpu")
        st = cs.static
        assert (st.n_tris, st.n_spheres, st.n_lights) == (3854, 7, 5)
        assert st.has_wide_tri and not st.has_wide and st.has_cone_sphere_lights
        render.make_persistent_fn(cs)
        assert render.LAST_PERSISTENT_TIER == tier
    monkeypatch.delenv("PBRT_TPU_WIDEMEGA")
    render.make_persistent_fn(cs)
    assert render.LAST_PERSISTENT_TIER == "torch-wavefront/plain-wide-mixed"


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    from pbrt_tpu_torch.scenes import zoo_room
    from test_torch_megakernel import _to_ref

    desc = zoo_room(4, table_dir=str(tmp_path_factory.mktemp("zoo_tables")))
    return compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))


def test_zoo_room_tables_bit_identical(zoo):
    """zoo_room(4): substrate, disney, a mix of plastic and copper (its
    sub-materials' rows after the mix row's, as the reference reserves
    them), a fourier box (its table read and stacked), translucent and
    hair: every table equals the reference's, the Fourier arrays
    included, and so do the static fields the routes read."""
    cs, ref = zoo
    for f in fields(SceneTensors):
        if f.name in HOPPER_TABLES:
            continue
        a, b = getattr(cs.arrays, f.name), getattr(ref.arrays, f.name)
        assert (a is None) == (b is None), f.name
        if a is None:
            continue
        if isinstance(a, dict):
            assert a.keys() == b.keys(), f.name
            for k in a:
                np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]), err_msg=k)
            continue
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype.kind == b.dtype.kind and a.dtype.itemsize == b.dtype.itemsize, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert set(cs.arrays.fourier) == {"mu", "aflat", "a0", "cdf", "eta"}
    for name in ("n_prims", "n_tris", "n_materials", "n_lights", "has_fourier", "has_wide", "wide_root",
                 "has_bump", "use_brute_force"):
        assert getattr(cs.static, name) == getattr(ref.static, name), name
    assert cs.static.mat_kinds_present == tuple(int(k) for k in ref.static.mat_kinds_present) == (
        1, 2, 4, 5, 7, 8, 9, 10, 13, 14)
    assert cs.static.n_tris == 4784 and cs.static.has_fourier


@pytest.mark.parametrize("kind", ["subsurface", "kdsubsurface", "interface", "mix-of-subsurface"])
def test_bssrdf_and_interface_materials_refused_by_name(kind):
    """The subsurface and interface ("none") materials, also in a mix,
    compile to the reference's tables, and under mlt and sppm render
    through their host loops (route torch-mlt/ or torch-sppm/ and the
    query's)."""
    from test_torch_megakernel import _to_ref
    from test_torch_sppm import render_small

    desc = mesh_room(8)
    sub = HostMaterial(kind={"interface": "none", "mix-of-subsurface": "subsurface"}.get(kind, kind))
    desc.primitives[1].material = sub if kind != "mix-of-subsurface" else HostMaterial(kind="mix", params={
        "material1": ("material", HostMaterial(kind="matte")), "material2": ("material", sub)})
    assert compile_scene(desc, "cpu").static.has_tab_sss == (kind in ("subsurface", "kdsubsurface"))
    integrator = {"subsurface": "mlt", "kdsubsurface": "sppm", "interface": "mlt", "mix-of-subsurface": "sppm"}[kind]
    desc.integrator.kind = integrator
    cs, ref = compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))
    for name in ("prim_mat", "mat_kind", "mat_remap", "bvh_packed"):
        np.testing.assert_array_equal(getattr(cs.arrays, name).numpy(), np.asarray(getattr(ref.arrays, name)))
    img, tier = render_small(desc, integrator)
    assert tier == f"torch-{integrator}/wide" and np.isfinite(img).all()


def test_unreadable_fourier_table_makes_the_row_matte(tmp_path):
    """A fourier row whose table cannot be read compiles as matte, as in the
    reference (api.rs logs and degrades); the scene then has no tables."""
    from test_torch_megakernel import _to_ref

    desc = mesh_room(8)
    desc.primitives[1].material = HostMaterial(kind="fourier", params={
        "bsdffile": ("const", str(tmp_path / "missing.bsdf")), "Kd": ("const", np.array([0.5, 0.5, 0.5]))})
    cs, ref = compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))
    assert not cs.static.has_fourier and not ref.static.has_fourier and cs.arrays.fourier == {}
    np.testing.assert_array_equal(cs.arrays.mat_kind.numpy(), np.asarray(ref.arrays.mat_kind))
    np.testing.assert_array_equal(cs.arrays.mat_const.numpy(), np.asarray(ref.arrays.mat_const))
    assert 13 not in cs.static.mat_kinds_present
