"""The per-ray walks of the binary BVH and of the kd-tree (device/
bvh_walk.py), the alpha wrapper over every route, and the whole slice,
against the reference on the CPU.

- walk_plain against the reference's packet loop ``_traverse`` on the
  instanced quadric room (every quadric kind, 8 instances, a mirrored one
  among them), closest and any hit: hits equal, t within 5e-5 relative
  (the reference's jitted packet loop contracts multiply-adds into FMAs;
  an instance scaled by 0.12-0.22 amplifies those ulps in the watertight
  test's edge functions, and a quadric's root cancels in q / a), prim
  equal where t is not tied.
- the walk's records (scene.arrays.bvh_walk_records, which the kernel and
  walk_plain read): on quadric_room(40) and a motion room they give back
  every box, offset, count and interior axis of bvh_packed bit for bit,
  each row once, and every prim's row, instance, kind and group;
  bvh_packed itself equals the reference's on the instanced room.
- the kd walk's records (scene.arrays.kd_walk_records, which the kernel
  reads): on quadric_room(4)'s kd variant and a small kd motion room they
  give back kd_flags, kd_split, kd_above and kd_nprims bit for bit, and
  every entry of kd_prim_ids as one row holding that prim's triangle
  floats, kind, group and the prims left in its leaf; a mutated node or
  row fails the check; the tree's depth is its deepest leaf's interior
  ancestors. A tree deeper than the walks' KD_STACK is refused by the
  twin and by the kernel's wrapper before any launch, and a tree of
  exactly KD_STACK levels walks with no push dropped.
- kd_walk_plain against the all-pairs test over the same prims: the
  reference's own kd walk (``_traverse_kd``) drops the near child when
  every ray of a packet moves away from the split plane and misses hits
  (ROADMAP C), so the truth it is held to is the port's intersect_brute
  (whose triangle and quadric tests are held to the reference's in
  tests/test_torch_brute.py and tests/test_torch_quadrics.py); the walk
  also equals walk_plain's hits, and the interior and leaf visits it
  counts for the bound sum to its pops.
- the witness of that fault: on the kd-tree of the quadrics and a sloped
  terrain (no prim flat in a split plane, so the two packages' kd tables
  are equal bit for bit), packets of camera-like rays (one origin, a cone
  of directions), the reference's jitted ``_traverse_kd`` misses hits
  that its own ``intersect_brute`` finds, while
  kd_walk_plain finds the brute-force hits (t within 5e-5 relative of the
  jitted reference's, prim equal where t is not tied).
- the alpha wrapper against the reference's intersect and intersect_p on
  the walk's route (quadric_room) and on B1's (camera_room's environment
  scene: the wide tables and the alpha panel).
- one render against the reference's persistent wavefront at 24x16,
  4 spp, depth 3: quadric_room with instances (the kd variant's queries
  are held to brute force above; the orthographic camera's rays in
  tests/test_torch_camera.py; both render on the card against their cpu
  twins in chip_smoke.py phase 35).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.device import intersect as ref_intersect
from pbrt_tpu.scene.builder import compile_scene as ref_compile_scene
from pbrt_tpu_torch import scenes
from pbrt_tpu_torch.device import bvh_walk, intersect
from pbrt_tpu_torch.scene.builder import compile_scene
from test_torch_megakernel import _to_ref
from test_torch_quadrics import fixed_reference, small_quadric_room
from torch_test_scenes import deep_kd_room
from torch_threads import one_torch_thread  # noqa: F401  (autouse: PyTorch single-threaded in this module)

N_RAYS = 2048


def _rays(n, seed):
    """Origins through the room, directions uniform on the sphere; a quarter
    of the rays with a finite t_max."""
    rs = np.random.RandomState(seed)
    o = rs.uniform([-3.5, -0.5, -3.5], [3.5, 3.8, 3.5], (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full(n, np.inf, np.float32)
    t_max[::4] = rs.uniform(0.1, 3.0, len(t_max[::4]))
    return o, d, t_max


@pytest.fixture(scope="module")
def rooms():
    desc = small_quadric_room()
    cs = compile_scene(desc, "cpu")
    ref = fixed_reference(cs, ref_compile_scene(_to_ref(desc)))
    kd_desc = small_quadric_room(instances=False, accelerator="kdtree")
    kd = compile_scene(kd_desc, "cpu")
    return cs, ref, kd, ref_compile_scene(_to_ref(kd_desc))


def _t(x):
    return torch.as_tensor(np.array(x))


_WALKS = {}


def _reference_walk(ref, any_hit):
    """The reference's packet loop ``_traverse`` over ref's tables, jitted
    once per query kind: the twin test and the alpha wrapper's passes on
    the instanced room share its compile."""
    key = (id(ref), any_hit)
    if key not in _WALKS:
        _WALKS[key] = jax.jit(lambda o, d, t_max: ref_intersect._traverse(ref.arrays, ref.static, o, d, t_max,
                                                                         any_hit=any_hit))
    return _WALKS[key]


@pytest.mark.parametrize("any_hit", [False, True])
def test_bvh_walk_twin_matches_reference(rooms, any_hit):
    cs, ref, _kd, _ref_kd = rooms
    o, d, t_max = _rays(N_RAYS, 1)
    # a quarter of the rays aimed at the instances
    rs = np.random.RandomState(6)
    k = N_RAYS // 4
    centres = cs.arrays.inst_i2w.numpy()[1:, :, 3]
    target = centres[rs.randint(0, len(centres), k)] + rs.normal(0, 0.1, (k, 3)).astype(np.float32)
    d[:k] = (target - o[:k]) / np.linalg.norm(target - o[:k], axis=1, keepdims=True)
    t, prim, b1, b2, pops, overflow = bvh_walk.walk_plain(cs.arrays, cs.static, _t(o), _t(d), _t(t_max), any_hit)
    hit_r, hit_any_r = _reference_walk(ref, any_hit)(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    hit = prim.numpy() >= 0
    np.testing.assert_array_equal(hit, np.asarray(hit_any_r))
    assert overflow == 0 and 0.3 < hit.mean() < 1.0 and int(pops.max()) > 10
    if any_hit:
        return
    t_r, prim_r = np.asarray(hit_r["t"]), np.asarray(hit_r["prim"])
    quad = hit & (cs.arrays.prim_kind.numpy()[np.maximum(prim_r, 0)] == 1)
    inst = hit & (cs.arrays.prim_inst.numpy()[np.maximum(prim_r, 0)] > 0)
    np.testing.assert_allclose(t.numpy()[hit], t_r[hit], rtol=5e-5)
    differ = hit & (prim.numpy() != prim_r)
    assert (t.numpy()[differ] == t_r[differ]).all()  # another prim only on a tie
    assert quad.sum() > 100 and inst.sum() > 20
    same = hit & ~differ
    np.testing.assert_allclose(b1.numpy()[same & quad], np.asarray(hit_r["b1"])[same & quad], atol=1e-4)


def _check_records_against(packed, node_rec, prim_rec):
    """Every row of bvh_packed (columns 0-8: box, offset, count, axis) as
    the walk's records give it: each interior record names its row j (word
    15), whose axis it holds; its child 0 is row j + 1 and its child 1 row
    j's offset, each with the box the record holds; an interior child's
    record names that row, a leaf child's reference is ~its offset and its
    first prim row's rem its count. The root's row is 0 (record 0, or the
    one leaf), and together the rows cover bvh_packed once each."""
    words = node_rec.view(np.int32)
    rows, refs = words[:, 15].astype(np.int64), words[:, 12:14].astype(np.int64)
    rem = prim_rec.view(np.int32)[:, 9] >> 4
    interior = packed[:, 7] == 0
    np.testing.assert_array_equal(interior[rows], True)
    np.testing.assert_array_equal(packed[rows, 8].astype(np.int32), words[:, 14])
    assert packed[0, 7] > 0 or rows[0] == 0
    seen = [np.zeros(1, np.int64)]
    for c, child_row in enumerate((rows + 1, packed[rows, 6].astype(np.int64))):
        seen.append(child_row)
        np.testing.assert_array_equal(node_rec[:, 6 * c:6 * c + 6].view(np.int32),
                                      packed[child_row, 0:6].view(np.int32))
        ref = refs[:, c]
        inner = ref >= 0
        np.testing.assert_array_equal(rows[ref[inner]], child_row[inner])
        leaf_row, off = child_row[~inner], ~ref[~inner]
        np.testing.assert_array_equal(packed[leaf_row, 7] > 0, True)
        np.testing.assert_array_equal(packed[leaf_row, 6].astype(np.int64), off)
        np.testing.assert_array_equal(packed[leaf_row, 7].astype(np.int64), rem[off])
    covered = np.concatenate(seen)
    assert covered.size == packed.shape[0] and np.unique(covered).size == covered.size


@pytest.mark.parametrize("scene", ["quadric_room_40", "motion_room"])
def test_walk_records_reproduce_bvh_packed(rooms, scene):
    cs, ref, _kd, _ref_kd = rooms
    np.testing.assert_array_equal(cs.arrays.bvh_packed.numpy(), np.asarray(ref.arrays.bvh_packed))
    desc = scenes.quadric_room(40) if scene == "quadric_room_40" else scenes.motion_room(16, sphere_res=12)
    sa = compile_scene(desc, "cpu").arrays
    packed = sa.bvh_packed.numpy()
    node_rec, prim_rec = sa.bw_node_rec.numpy(), sa.bw_prim_rec.numpy()
    assert (packed[:, 7] > 0).sum() > 1000
    _check_records_against(packed, node_rec, prim_rec)
    words = prim_rec.view(np.int32)
    np.testing.assert_array_equal(prim_rec[:, 0:9], sa.prim_test_data.numpy()[:, 0:9])
    np.testing.assert_array_equal(words[:, 9] & 15, sa.prim_kind.numpy())
    np.testing.assert_array_equal(words[:, 10], sa.prim_inst.numpy())
    gid = np.zeros(len(words), np.int32) if sa.anim_gid is None else sa.anim_gid.numpy()
    np.testing.assert_array_equal(words[:, 11], gid)
    assert (words[:, 11] > 0).any() == (scene == "motion_room")


def _check_kd_records_against(sa, node_rec, leaf_rec):
    """The kd tables as the kd walk's records give them: each node's flag,
    split bits, above child and count from its 8-byte record, each entry
    of kd_prim_ids from its leaf row (word 10), with the prim's triangle
    floats, kind and group and the prims left in its leaf (rem)."""
    flags, above, nprims = (getattr(sa, n).numpy() for n in ("kd_flags", "kd_above", "kd_nprims"))
    leaf = flags == 3
    np.testing.assert_array_equal(np.where(node_rec[:, 1] & 3 == 3, 3, node_rec[:, 1] & 3), flags)
    np.testing.assert_array_equal(node_rec[:, 1] >> 2, np.where(leaf, nprims, above))
    np.testing.assert_array_equal(node_rec[leaf, 0], above[leaf])
    np.testing.assert_array_equal(node_rec[~leaf, 0], sa.kd_split.numpy()[~leaf].view(np.int32))
    ids = sa.kd_prim_ids.numpy()
    words = leaf_rec.view(np.int32)
    assert leaf_rec.shape == (ids.size, 12)
    np.testing.assert_array_equal(words[:, 10], ids)
    np.testing.assert_array_equal(leaf_rec[:, 0:9], sa.prim_test_data.numpy()[ids, 0:9])
    np.testing.assert_array_equal(words[:, 9] & 15, sa.prim_kind.numpy()[ids])
    gid = np.zeros(ids.size, np.int32) if sa.anim_gid is None else sa.anim_gid.numpy()[ids]
    np.testing.assert_array_equal(words[:, 11], gid)
    rem = np.zeros(ids.size, np.int64)
    for off, n in zip(above[leaf], nprims[leaf]):
        rem[off:off + n] = np.arange(n, 0, -1)
    np.testing.assert_array_equal(words[:, 9] >> 4, rem)


@pytest.mark.parametrize("scene", ["quadric_room_4", "motion_room"])
def test_kd_records_reproduce_kd_tables(scene):
    if scene == "quadric_room_4":
        desc = scenes.quadric_room(4, instances=False, accelerator="kdtree", prop_res=6)
    else:
        desc = scenes.motion_room(6, sphere_res=6)
        desc.accelerator = "kdtree"
    cs = compile_scene(desc, "cpu")
    sa = cs.arrays
    assert cs.static.accel_kind == "kdtree" and (sa.kd_flags.numpy() == 3).sum() > 100
    node_rec, leaf_rec = sa.kd_node_rec.numpy(), sa.kd_leaf_rec.numpy()
    _check_kd_records_against(sa, node_rec, leaf_rec)
    assert (leaf_rec.view(np.int32)[:, 11] > 0).any() == (scene == "motion_room")
    # the depth: the most interior ancestors of a leaf
    flags, above = sa.kd_flags.numpy(), sa.kd_above.numpy()
    depth = np.zeros(flags.size, np.int64)
    for i in np.nonzero(flags != 3)[0]:
        depth[i + 1] = depth[above[i]] = depth[i] + 1
    assert cs.static.kd_depth == int(depth.max()) > 5
    # a mutated node, split or row fails the check
    for mutate in (lambda n, r: n.__setitem__((n.shape[0] // 2, 1), n[n.shape[0] // 2, 1] + 4),
                   lambda n, r: n.__setitem__((int(np.argmax(flags != 3)), 0), n[int(np.argmax(flags != 3)), 0] + 1),
                   lambda n, r: r.view(np.int32).__setitem__((r.shape[0] // 3, 10), 0)):
        n, r = node_rec.copy(), leaf_rec.copy()
        mutate(n, r)
        with pytest.raises(AssertionError):
            _check_kd_records_against(sa, n, r)


def test_kd_walk_refuses_a_tree_deeper_than_its_stack():
    deep, o, d, t_max = deep_kd_room(bvh_walk.KD_STACK + 1)
    sa, st = deep.arrays, deep.static
    with pytest.raises(ValueError, match="stack"):
        bvh_walk.kd_walk_plain(sa, st, _t(o), _t(d), _t(t_max), False)
    with pytest.raises(ValueError, match="stack"):
        bvh_walk.kd_walk_cuda(sa, st, _t(o), _t(d), _t(t_max), False)
    full, o, d, t_max = deep_kd_room(bvh_walk.KD_STACK)
    n = 64
    res = bvh_walk.kd_walk_plain(full.arrays, full.static, _t(o[:n]), _t(d[:n]), _t(t_max[:n]), False)
    assert res[5] == 0 and int(res[4].min()) >= bvh_walk.KD_STACK


@pytest.mark.parametrize("any_hit", [False, True])
def test_kd_walk_twin_matches_brute_force(rooms, any_hit):
    _cs, _ref, kd, _ref_kd = rooms
    o, d, t_max = _rays(N_RAYS, 2)
    counts = {}
    t, prim, _b1, _b2, pops, overflow = bvh_walk.kd_walk_plain(kd.arrays, kd.static, _t(o), _t(d), _t(t_max), any_hit,
                                                               counts=counts)
    truth = intersect.intersect_brute(kd.arrays, kd.static, _t(o), _t(d), _t(t_max))
    hit, t_r = prim.numpy() >= 0, truth["t"].numpy()
    np.testing.assert_array_equal(hit, np.isfinite(t_r))
    assert overflow == 0 and 0.3 < hit.mean() < 1.0 and int(pops.max()) > 5
    # the bound's counts: every pop is an interior or a leaf visit
    assert counts["interior_visits"] > 0 and counts["leaf_visits"] > 0
    assert counts["interior_visits"] + counts["leaf_visits"] == int(pops.sum())
    if not any_hit:
        np.testing.assert_array_equal(t.numpy()[hit], t_r[hit])
        walk = bvh_walk.walk_plain(kd.arrays, kd.static, _t(o), _t(d), _t(t_max), False)
        np.testing.assert_array_equal(walk[0].numpy()[hit], t.numpy()[hit])


def test_reference_kd_walk_misses_hits_its_brute_force_finds():
    desc = small_quadric_room(instances=False, accelerator="kdtree")
    desc.primitives = scenes.mesh_room(8).primitives[:1] + [p for p in desc.primitives if p.shape.mesh is None]
    cs, ref = compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))
    assert cs.static.accel_kind == ref.static.accel_kind == "kdtree"
    np.testing.assert_array_equal(cs.arrays.kd_prim_ids.numpy(), np.asarray(ref.arrays.kd_prim_ids))
    # four packets of 256 rays (the reference's PACKET), each from one
    # origin into a cone around a direction of its own
    rs = np.random.RandomState(5)
    n = 4 * ref_intersect.PACKET
    o = np.repeat(rs.uniform([-3.0, 0.5, -3.0], [3.0, 3.0, 3.0], (4, 3)), ref_intersect.PACKET, 0).astype(np.float32)
    axis = np.repeat(rs.normal(size=(4, 3)), ref_intersect.PACKET, 0)
    d = axis + rs.normal(0.0, 0.35, (n, 3)) * np.linalg.norm(axis, axis=1, keepdims=True)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_max = np.full(n, np.inf, np.float32)
    args = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    kd_r = jax.jit(lambda o, d, t: ref_intersect._traverse_kd(ref.arrays, ref.static, o, d, t, any_hit=False)[0])(*args)
    brute_r = jax.jit(lambda o, d, t: ref_intersect.intersect_brute(ref.arrays, ref.static, o, d, t))(*args)
    hit_kd, hit = np.asarray(kd_r["prim"]) >= 0, np.asarray(brute_r["prim"]) >= 0
    t_r, prim_r = np.asarray(brute_r["t"]), np.asarray(brute_r["prim"])
    assert not (hit_kd & ~hit).any()
    assert (hit & ~hit_kd).sum() > 10  # hits the reference's kd walk misses
    t, prim, _b1, _b2, _pops, overflow = bvh_walk.kd_walk_plain(cs.arrays, cs.static, _t(o), _t(d), _t(t_max), False)
    assert overflow == 0
    np.testing.assert_array_equal(prim.numpy() >= 0, hit)
    np.testing.assert_allclose(t.numpy()[hit], t_r[hit], rtol=5e-5)
    differ = hit & (prim.numpy() != prim_r)
    assert (np.abs(t.numpy()[differ] - t_r[differ]) <= 5e-5 * t_r[differ]).all()


@pytest.mark.parametrize("route", ["bvh", "wide"])
def test_alpha_wrapper_matches_reference(rooms, route, monkeypatch):
    """intersect and intersect_p of an alpha scene: the closest hit that is
    not cut out (re-cast at most 4 times past cut hits), and the shadow
    query as that closest-hit query, on the walk's route and on B1's,
    against the reference's wrapper over its packet loop ``_traverse``
    (which its ``_intersect_once`` takes for these scenes on the CPU),
    jitted once for the ten passes of a query pair (called eagerly, each
    pass compiles its own while loop); on the walk's route, the instanced
    room of the twin test above, with its jitted loop."""
    if route == "bvh":
        cs, ref, _kd, _ref_kd = rooms
    else:
        desc = scenes.camera_room("environment", 4)
        cs, ref = compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))
    assert cs.static.has_alpha and cs.static.has_wide == (route == "wide")
    assert intersect.route_name(cs.static) == route
    walk = _reference_walk(ref, False)
    walk_r = lambda o, d, t_max: walk(o, d, t_max)[0]  # noqa: E731
    monkeypatch.setattr(ref_intersect, "_intersect_once", lambda sa, st, o, d, t_max, time=None, sort_rays=False:
                        walk_r(o, d, jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (o.shape[0],))))
    rs = np.random.RandomState(4)
    o, d, t_max = _rays(N_RAYS, 3)
    # a third of the rays aimed through the alpha panel (z = -0.6)
    k = N_RAYS // 3
    target = rs.uniform([-0.8, 0.9, -0.6], [0.8, 2.5, -0.6], (k, 3)).astype(np.float32)
    o[:k] = target + np.array([0.0, 0.0, 2.0], np.float32)
    d[:k] = (target - o[:k]) / np.linalg.norm(target - o[:k], axis=1, keepdims=True)
    mine = intersect.intersect(cs.arrays, cs.static, _t(o), _t(d), _t(t_max))
    theirs = ref_intersect.intersect(ref.arrays, ref.static, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    hit = np.asarray(theirs["prim"]) >= 0
    np.testing.assert_array_equal(mine["prim"].numpy() >= 0, hit)
    # t accumulates each re-cast's advance: within 1e-5 relative or 1e-6
    np.testing.assert_allclose(mine["t"].numpy()[hit], np.asarray(theirs["t"])[hit], rtol=1e-5, atol=1e-6)
    occ = intersect.intersect_p(cs.arrays, cs.static, _t(o), _t(d), _t(t_max)).numpy()
    occ_r = np.asarray(ref_intersect.intersect_p(ref.arrays, ref.static, jnp.asarray(o), jnp.asarray(d),
                                                 jnp.asarray(t_max)))
    np.testing.assert_array_equal(occ, occ_r)
    # the cut-outs matter: some panel rays pass through a hole to a farther hit
    panel = cs.arrays.prim_alpha_tex.numpy() >= 0
    first = intersect._intersect_once(cs.arrays, cs.static, _t(o), _t(d), _t(t_max))["prim"].numpy()
    through = (first >= 0) & panel[np.maximum(first, 0)] & (mine["prim"].numpy() != first)
    assert through[:k].sum() > 10


def test_wavefront_matches_reference(monkeypatch):
    """The port's persistent wavefront against the reference's at 24x16,
    4 spp, depth 3 on quadric_room with its instances (route plain-bvh
    against the reference's packet loop; its alpha panel left out, whose
    re-casts cost the reference's XLA compile minutes: the alpha wrapper's
    queries are held above). Held as an estimate: weights equal, the path
    vertices within 0.5%, the means within 2% and 90% of the pixels within
    the reference megakernel test's per-pixel tolerance (|dL| / (|L| +
    1e-2) < 2e-2). A ray leaving a cone, paraboloid or hyperboloid starts
    from the hit that the reference does not re-project onto the surface
    (cone.rs, paraboloid.rs), so the ulps by which XLA's FMA-contracted
    arithmetic and PyTorch's differ move its origin across the surface in
    some rays, and those paths part; with spheres, cylinders and disks
    alone the two renders agree pixel for pixel (2e-6 relative)."""
    from pbrt_tpu import render as ref_render
    from pbrt_tpu_torch import render

    monkeypatch.delenv("PBRT_TPU_WIDEMEGA", raising=False)
    W, H, SPP, SEED = 24, 16, 4, 3
    desc = small_quadric_room()
    desc.primitives = [p for p in desc.primitives if p.shape.mesh is None or p.shape.mesh.alpha_texture is None]
    desc.film.x_resolution, desc.film.y_resolution = W, H
    desc.sampler.pixel_samples = SPP
    desc.integrator.max_depth = 3
    cs = compile_scene(desc, "cpu")
    ref = fixed_reference(cs, ref_compile_scene(_to_ref(desc)))
    ys, xs = np.mgrid[0:H, 0:W]
    px, py, pids = xs.ravel(), ys.ravel(), (ys * W + xs).ravel()
    wave_r = ref_render.make_persistent_fn(ref)
    assert ref_render.LAST_PERSISTENT_TIER == "xla-wavefront/packet"
    L_r, w_r, nv_r = (np.asarray(x) for x in wave_r(
        ref.arrays, jnp.asarray(px.astype(np.int32)), jnp.asarray(py.astype(np.int32)),
        jnp.asarray(pids.astype(np.uint32)), jnp.uint32(0), SPP, jnp.uint32(SEED)))
    wave = render.make_persistent_fn(cs)
    assert render.LAST_PERSISTENT_TIER == "torch-wavefront/plain-bvh"
    L, w, nv = (x.numpy() for x in wave(cs.arrays, *(torch.as_tensor(x.astype(np.int64)) for x in (px, py, pids)),
                                        0, SPP, SEED))
    np.testing.assert_array_equal(w, w_r)
    assert abs(float(nv.sum()) / float(nv_r.sum()) - 1.0) < 5e-3
    assert L_r.mean() > 0.1 and abs(L.mean() / L_r.mean() - 1.0) < 2e-2
    close = (np.abs(L - L_r) / (np.abs(L_r) + 1e-2)).max(-1) < 2e-2
    assert close.mean() >= 0.9, close.mean()
