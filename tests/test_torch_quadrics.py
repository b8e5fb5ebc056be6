"""The quadrics, instances, alpha masks, kd-tree and image lights of the
port against the reference, on the CPU: the tables of quadric_room (with
instances, and its kd variant) bit for bit, ray_quadric for the six kinds,
surface_interaction on quadric and instanced hits, the area-light samples
of the new quadrics, and sample_li and compute_power of goniometric and
projection lights.

Two reference faults show in the tables and are fixed in the port
(ROADMAP C): the reference leaves prim_inst in description order while it
permutes every other prim table into BVH order, and its kd-tree build drops
a prim lying flat in a split plane from both children. The tests hold the
port's prim_inst to the reference's permuted by the BVH order
(CompiledScene.prim_order), and its kd tables to the reference's on a scene
that has no such prim; the reference's queries below read the port's
prim_inst. Inputs come from numpy seeds; both packages see the same
float32 inputs.
"""
import dataclasses
from dataclasses import fields

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.device import intersect as ref_intersect
from pbrt_tpu.device import lights as ref_lights
from pbrt_tpu.device import shading as ref_shading
from pbrt_tpu.scene.builder import compile_scene as ref_compile_scene
from pbrt_tpu_torch import scenes
from pbrt_tpu_torch.device import intersect, lights, prims, shading
from pbrt_tpu_torch.scene.arrays import HOPPER_TABLES, SceneTensors
from pbrt_tpu_torch.scene.builder import FLAG_HAS_SHADING_N, compile_scene
from test_torch_megakernel import _to_ref
from torch_threads import one_torch_thread  # noqa: F401  (autouse: PyTorch single-threaded in this module)

N_RAYS = 4096


def _t(x):
    return torch.as_tensor(np.array(x))


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def small_quadric_room(**kw):
    """quadric_room at n_side 2 with 8 instances of a 60-triangle prop: its
    30 quadrics, alpha panel, goniometric and projection lights and
    instances in 1,208 prims."""
    return scenes.quadric_room(2, instances=kw.pop("instances", 8), prop_res=6, **kw)


def fixed_reference(cs, ref):
    """The reference's compiled scene with the port's prim_inst, the
    reference's own permuted into BVH order (its fault, fixed)."""
    return dataclasses.replace(ref, arrays=dataclasses.replace(
        ref.arrays, prim_inst=jnp.asarray(cs.arrays.prim_inst.numpy())))


@pytest.fixture(scope="module")
def room():
    desc = small_quadric_room()
    cs = compile_scene(desc, "cpu")
    return cs, ref_compile_scene(_to_ref(desc))


def _tables_differ(cs, ref, skip=()) -> list:
    bad = []
    for f in fields(SceneTensors):
        if f.name in HOPPER_TABLES or f.name in skip:
            continue
        a, b = getattr(cs.arrays, f.name), getattr(ref.arrays, f.name)
        if (a is None) != (b is None):
            bad.append(f.name)
        elif isinstance(a, dict):
            if a.keys() != b.keys() or any(not np.array_equal(a[k].numpy(), np.asarray(b[k])) for k in a):
                bad.append(f.name)
        elif a is not None and not np.array_equal(a.numpy(), np.asarray(b), equal_nan=True):
            bad.append(f.name)
    return bad


@pytest.mark.parametrize("variant", ["instances", "kdtree-no-flat-prims", "kdtree"])
def test_quadric_room_tables_bit_identical(room, variant):
    """quadric_room's tables equal the reference's bit for bit: the six
    quadric kinds' rows (a partial-phimax hyperboloid widens prim_test_data
    to 26 columns), the binary BVH, the alpha and shadow-alpha texture ids,
    the goniometric and projection lights' frames and images, the instance
    transforms (prim_inst: the reference's in BVH order) and the static
    fields the routes read. The kd variant's tree equals the reference's on
    the quadrics and a terrain; on the room, whose walls lie flat in split planes,
    the reference's build drops prims that the port's keeps."""
    if variant == "instances":
        cs, ref = room
        assert _tables_differ(cs, ref, skip=("prim_inst",)) == []
        np.testing.assert_array_equal(cs.arrays.prim_inst.numpy(), np.asarray(ref.arrays.prim_inst)[cs.prim_order])
        st = cs.static
        assert st.has_instances and st.has_alpha and not st.use_brute_force and not st.has_wide_tri
        assert cs.arrays.prim_test_data.shape[1] == 26 and st.quadric_kinds == (0, 1, 2, 3, 4, 5)
        assert st.light_image_keys == ref.static.light_image_keys and st.light_image_keys[:2] == ("lim0", "lim1")
        for name in ("max_leaf", "has_instances", "has_alpha", "accel_kind", "kd_max_leaf", "has_cone_sphere_lights",
                     "n_spheres", "n_lights", "light_kinds", "has_area_lights"):
            mine, theirs = getattr(st, name), getattr(ref.static, name)
            assert mine == (tuple(int(x) for x in theirs) if isinstance(mine, tuple) else theirs), name
        return
    desc = small_quadric_room(instances=False, accelerator="kdtree")
    if variant == "kdtree-no-flat-prims":
        # the quadrics and a terrain of 128 sloped triangles: no prim lies
        # flat in an axis plane
        desc.primitives = scenes.mesh_room(8).primitives[:1] + [p for p in desc.primitives if p.shape.mesh is None]
    cs, ref = compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))
    assert cs.static.accel_kind == ref.static.accel_kind == "kdtree"
    kd = ("kd_flags", "kd_split", "kd_above", "kd_nprims", "kd_prim_ids")
    assert _tables_differ(cs, ref, skip=kd if variant == "kdtree" else ()) == []
    if variant == "kdtree":
        kept = set(cs.arrays.kd_prim_ids.tolist())
        assert kept == set(range(cs.static.n_prims))
        assert len(set(np.asarray(ref.arrays.kd_prim_ids).tolist())) < cs.static.n_prims


def test_kd_with_instances_keeps_the_bvh():
    """The reference's demotions: a kd-tree scene with instances keeps the
    BVH (route bvh), a brute-force one the brute route."""
    cs = compile_scene(small_quadric_room(accelerator="kdtree"), "cpu")
    assert cs.static.accel_kind == "bvh" and cs.arrays.kd_flags is None
    assert intersect.route_name(cs.static) == "bvh"
    tiny = small_quadric_room(instances=False, accelerator="kdtree")
    tiny.primitives = [p for p in tiny.primitives if p.shape.mesh is None]  # the 30 quadrics
    small = compile_scene(tiny, "cpu")
    assert small.static.use_brute_force and small.static.accel_kind == "bvh"
    assert intersect.route_name(small.static) == "brute"


def _quadric_tables():
    """One quadric of each kind (full and partial) from the room, placed
    apart along x: (w2o (Q, 3, 4), params (Q, 12), kinds (Q,), centres)."""
    desc = small_quadric_room(instances=False)
    quads = [p.shape.sphere for p in desc.primitives if p.shape.mesh is None]
    from pbrt_tpu_torch.scene.builder import QUADRICS, _quadric_row

    rows, w2o, kinds, centres = [], [], [], []
    for i, q in enumerate(quads):
        k = QUADRICS[q.kind]
        rows.append(_quadric_row(q, k)[0])
        w2o.append(q.object_to_world.inverse().m[:3, :])
        kinds.append(k)
        centres.append(q.object_to_world.m[:3, 3])
    return (np.asarray(w2o, np.float32), np.asarray(rows, np.float32), np.asarray(kinds, np.int32),
            np.asarray(centres, np.float32))


@pytest.mark.parametrize("kind", ["sphere", "cylinder", "disk", "cone", "paraboloid", "hyperboloid"])
def test_ray_quadric_matches_reference(kind):
    """ray_quadric against the reference's on rays aimed near each of the
    kind's five quadrics (full and partial) and rays from inside them: hit
    flags equal, t within 2 ulps, the object-space hit within 1e-5."""
    from pbrt_tpu_torch.scene.builder import QUADRICS

    w2o, par, kinds, centres = _quadric_tables()
    sel = kinds == QUADRICS[kind]
    w2o, par, kinds, centres = w2o[sel], par[sel], kinds[sel], centres[sel]
    rs = np.random.RandomState(5 + QUADRICS[kind])
    target = centres[rs.randint(0, len(centres), N_RAYS)] + rs.normal(0, 0.3, (N_RAYS, 3)).astype(np.float32)
    o = (target + 2.0 * _unit(rs.normal(size=(N_RAYS, 3)))).astype(np.float32)
    d = _unit(target - o)
    n4 = N_RAYS // 4
    o[:n4] = target[:n4]  # from inside or beside the shapes
    t_max = np.where(rs.rand(N_RAYS, 1) < 0.5, np.inf, rs.uniform(0.5, 4.0, (N_RAYS, 1))).astype(np.float32)
    args = (o[:, None], d[:, None], w2o[None], par[None], kinds[None], t_max)
    hit, t, p_obj = (x.numpy() for x in prims.ray_quadric(*(_t(a) for a in args)))
    hit_r, t_r, p_r = (np.asarray(x) for x in ref_intersect.ray_quadric(*(jnp.asarray(a) for a in args)))
    np.testing.assert_array_equal(hit, hit_r)
    assert hit.sum() > 300 and hit.any(axis=0).all()
    np.testing.assert_array_max_ulp(t[hit], t_r[hit], maxulp=2)
    np.testing.assert_allclose(p_obj[hit], p_r[hit], rtol=1e-5, atol=1e-5)


def _room_rays(n, seed):
    rs = np.random.RandomState(seed)
    o = rs.uniform([-3.5, -0.5, -3.5], [3.5, 3.8, 3.5], (n, 3)).astype(np.float32)
    return o, _unit(rs.normal(size=(n, 3)))


def test_surface_interaction_on_quadric_and_instanced_hits(room):
    """surface_interaction of both packages on the same hits in the room
    (the port's query, held to the reference's in
    tests/test_torch_bvh_walk.py; every quadric kind, instanced and plain
    triangles): p within 2 ulps (a sphere's re-projection sums its squares
    in another order), p_err within 1e-6, the frames, uv and tangents
    within 1e-5 relative (atan2, acos and the normalisations round
    differently in the two packages), material and light rows equal."""
    cs, ref = room
    ref = fixed_reference(cs, ref)
    o, d = _room_rays(N_RAYS, 7)
    hit = intersect.intersect(cs.arrays, cs.static, _t(o), _t(d), torch.full((N_RAYS,), float("inf")))
    hit_r = {k: jnp.asarray(v.numpy()) for k, v in hit.items()}
    si_r = ref_shading.surface_interaction(ref.arrays, hit_r, jnp.asarray(o), jnp.asarray(d))
    si = shading.surface_interaction(cs.arrays, hit, _t(o), _t(d), cs.static.quadric_kinds)
    valid = np.asarray(si_r["valid"])
    prim = np.maximum(hit["prim"].numpy(), 0)
    is_tri = cs.arrays.prim_kind.numpy()[prim] == 0
    kind = np.where(is_tri, -1, cs.arrays.sph_kind.numpy()[np.where(is_tri, 0, cs.arrays.prim_geom.numpy()[prim])])
    inst = cs.arrays.prim_inst.numpy()[prim] > 0
    assert set(kind[valid].tolist()) == {-1, 0, 1, 2, 3, 4, 5} and (valid & inst).sum() > 10
    # the instances' smooth normals, through the transpose of w2i, on the
    # anisotropically scaled instances and the mirrored one
    smooth = valid & inst & ((cs.arrays.prim_flags.numpy()[prim] & FLAG_HAS_SHADING_N) != 0)
    mirrored = np.linalg.det(cs.arrays.inst_i2w.numpy()[:, :, :3]) < 0
    ns_off_ng = np.abs(np.sum(si["ns"].numpy() * si["ng"].numpy(), axis=-1)) < 1 - 1e-4
    assert (smooth & ns_off_ng).sum() > 10 and mirrored.sum() == 1
    assert (smooth & mirrored[cs.arrays.prim_inst.numpy()[prim]]).sum() > 0
    np.testing.assert_array_max_ulp(si["p"].numpy()[valid], np.asarray(si_r["p"])[valid], maxulp=2)
    np.testing.assert_allclose(si["p_err"].numpy()[valid], np.asarray(si_r["p_err"])[valid], rtol=1e-6)
    for key in ("ng", "ns", "uv", "dpdu", "dpdv", "ss", "ts"):
        a, b = si[key].numpy()[valid], np.asarray(si_r[key])[valid]
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=key)
    for key in ("mat", "light"):
        np.testing.assert_array_equal(si[key].numpy(), np.asarray(si_r[key]), err_msg=key)


def test_sample_li_and_power_match_reference(room):
    """sample_li over every light of the room (the goniometric and
    projection lights through their images, the disk and cylinder lamps by
    _sample_prim_point, the panel's triangles) from hit points, and
    compute_power (the image lights' rows from their images' means, float32
    means over 2,048 texels summed in another order: rtol 1e-5); pdf_li_area_hit is
    the same function of the lamp's area on every kind."""
    cs, ref = room
    ref = fixed_reference(cs, ref)
    rs = np.random.RandomState(3)
    n = N_RAYS
    p = rs.uniform([-3.0, 0.5, -3.0], [3.0, 3.0, 2.0], (n, 3)).astype(np.float32)
    lid = rs.randint(0, cs.static.n_lights, n).astype(np.int32)
    u1, u2 = (rs.rand(n).astype(np.float32) for _ in range(2))
    mine = lights.sample_li(cs.arrays, cs.static, _t(lid), _t(p), _t(u1), _t(u2),
                            cone_spheres=cs.static.has_cone_sphere_lights)
    theirs = ref_lights.sample_li(ref.arrays, ref.static, jnp.asarray(lid), jnp.asarray(p), jnp.asarray(u1),
                                  jnp.asarray(u2), cone_spheres=ref.static.has_cone_sphere_lights)
    kinds = set(cs.arrays.light_kind.numpy()[lid].tolist())
    assert {4, 5, 6} <= kinds
    for key in ("wi", "li", "dist", "n", "area"):
        np.testing.assert_allclose(mine[key].numpy(), np.asarray(theirs[key]), rtol=2e-6, atol=2e-6, err_msg=key)
    np.testing.assert_array_equal(mine["delta"].numpy(), np.asarray(theirs["delta"]))
    # the area pdf divides by cos at the lamp: relative error grows at grazing angles
    np.testing.assert_allclose(mine["pdf"].numpy(), np.asarray(theirs["pdf"]), rtol=1e-4)
    lit = np.asarray(theirs["li"]).sum(-1) > 0
    assert lit[cs.arrays.light_kind.numpy()[lid] == 5].any() and lit[cs.arrays.light_kind.numpy()[lid] == 6].any()
    np.testing.assert_allclose(lights.compute_power(cs.arrays, cs.static).numpy(),
                               np.asarray(ref_lights.compute_power(ref.arrays, ref.static)), rtol=1e-5)
    # pdf_li_area_hit on the lamps' own samples
    lamps = cs.arrays.light_kind.numpy()[lid] == 4
    area = cs.arrays.prim_area[cs.arrays.light_prim[_t(lid)].clamp(min=0)]
    got = lights.pdf_li_area_hit(cs.arrays, _t(p), _t(p) + mine["wi"] * mine["dist"][:, None], mine["n"], _t(lid),
                                 area).numpy()
    want = np.asarray(ref_lights.pdf_li_area_hit(ref.arrays, jnp.asarray(p), jnp.asarray(p + np.asarray(
        theirs["wi"]) * np.asarray(theirs["dist"])[:, None]), theirs["n"], jnp.asarray(lid), jnp.asarray(area.numpy())))
    np.testing.assert_allclose(got[lamps], want[lamps], rtol=1e-4)


def test_written_quadric_room_compiles_to_the_same_tables(tmp_path):
    """scenes.write_pbrt of quadric_room (asking for the kd-tree, which its
    instances demote to the BVH, under camera_room's orthographic camera)
    writes every directive of the class and parses to the hand-built
    scene's tables bit for bit (chip_smoke.py phase 37 at its size)."""
    from pbrt_tpu_torch.parser.api import pbrt_parse

    desc = small_quadric_room(accelerator="kdtree")
    desc.camera = scenes.camera_room("orthographic").camera
    path = tmp_path / "q.pbrt"
    scenes.write_pbrt(desc, str(path), scenes.ROOM_LOOK_AT)
    text = path.read_text()
    for w in ('Shape "cylinder"', 'Shape "disk"', 'Shape "cone"', 'Shape "paraboloid"', 'Shape "hyperboloid"',
              "ObjectBegin", "ObjectInstance", '"texture alpha"', '"texture shadowalpha"', 'LightSource "goniometric"',
              'LightSource "projection"', 'Accelerator "kdtree"', 'Camera "orthographic"'):
        assert w in text, w
    parsed = pbrt_parse(str(path))
    assert parsed.camera.kind == "orthographic" and parsed.camera.screen_window == desc.camera.screen_window
    got, want = compile_scene(parsed, "cpu"), compile_scene(desc, "cpu")
    for f in fields(SceneTensors):
        a, b = getattr(got.arrays, f.name), getattr(want.arrays, f.name)
        assert (a is None) == (b is None), f.name
        if isinstance(a, dict):
            assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a), f.name
        elif a is not None:
            if a.dtype.is_floating_point:  # bits: a 0.0 for a -0.0 differs
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), f.name
    assert got.static == want.static and got.static.accel_kind == "bvh" and got.static.has_instances
