"""Motion blur and the animated camera in the port, against the reference.

- compile_scene's motion tables: the keyframe rows (``*_end``, ``*_mid``),
  the animated-transform groups (``anim``) with each prim's group and
  compose constant, the BVH built over the swept bounds and the prim rows,
  bit for bit with the reference's on small motion_room variants (the UV
  sphere spinning, or translating: no group rotates, the keyframe tables
  serve), on their written .pbrt files, and on an animated instanced
  prototype (the reference's tests/test_motion.py :345 scene);
- device/motion.py op by op against the reference's motion.py on random
  groups and times, within 2e-6 relative (the reference's matmuls and
  einsums sum in XLA's order, the port's in the motion walk's);
- the time-aware queries: the binary-BVH walk's twin (walk_plain with
  time) against the reference's packet walk with time on 2,000 random
  rays and shutter times: the same prims hit, t within 1e-5 relative (1e-6
  absolute near the origin), the same occlusion; the brute route with time against the reference's
  ``intersect_brute``; the kd walk's twin with time against the brute
  route with time (the reference's kd packet walk drops near children,
  ROADMAP C); a motion scene never takes the wide tables;
- surface_interaction at a time against the reference's on those hits
  (p, normals, uv within 1e-5 absolute), and generate_rays of the animated
  camera against the reference's (within 2e-6);
- trace_wave of motion_room (6 sides, the UV sphere at 6 x 6) on a 16 x 12
  film at depth 2 against the reference's make_wave_fn: the filter weights
  and path vertices equal, the radiance within rtol 1e-4, atol 1e-5;
- a static scene: its queries and shading records with a time given are
  the ones without, bit for bit (time is ignored without moving prims).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu import render as ref_render
from pbrt_tpu.device import camera as ref_camera
from pbrt_tpu.device import intersect as ref_intersect
from pbrt_tpu.device import motion as ref_motion
from pbrt_tpu.device import shading as ref_shading
from pbrt_tpu.parser.api import pbrt_parse as ref_pbrt_parse
from pbrt_tpu.scene.builder import compile_scene as ref_compile_scene
from pbrt_tpu_torch import render, scenes
from pbrt_tpu_torch.device import bvh_walk, camera, intersect, motion, shading
from pbrt_tpu_torch.parser.api import pbrt_parse
from pbrt_tpu_torch.scene.builder import compile_scene
from test_torch_megakernel import _to_ref
from torch_threads import one_torch_thread  # noqa: F401  (autouse: PyTorch single-threaded in this module)

N = 2000
MOTION_TABLES = ("tri_p_end", "sph_w2o_end", "sph_o2w_end", "prim_test_data_end", "tri_p_mid", "sph_w2o_mid",
                 "sph_o2w_mid", "prim_test_data_mid", "anim_gid", "anim_c", "bvh_packed", "prim_test_data", "tri_p")


def _small(rotate=True, accelerator="bvh"):
    desc = scenes.motion_room(6, rotate=rotate, sphere_res=6)
    desc.accelerator = accelerator
    return desc


def _tables_equal(cs, ref):
    for name in MOTION_TABLES:
        a, b = getattr(cs.arrays, name), getattr(ref.arrays, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert (cs.arrays.anim is None) == (ref.arrays.anim is None)
    for k in ref.arrays.anim or {}:
        np.testing.assert_array_equal(cs.arrays.anim[k].numpy(), np.asarray(ref.arrays.anim[k]), err_msg=k)
    assert (cs.static.has_motion, cs.static.has_rot_motion) == (ref.static.has_motion, ref.static.has_rot_motion)


@pytest.fixture(scope="module")
def rooms():
    out = {}
    for rotate in (True, False):
        desc = _small(rotate)
        out[rotate] = desc, compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))
    return out


@pytest.mark.parametrize("rotate", [True, False])
@pytest.mark.parametrize("written", [False, True])
def test_motion_tables_match_reference(rooms, rotate, written, tmp_path):
    """The tables of motion_room, and of its written file, are the
    reference's bit for bit; rotate gives the anim tables, a translation
    the keyframe rows alone (the moving quadric's mid-shutter rows in both,
    as the reference's parser gives a moving sphere its mid transform)."""
    desc, cs, ref = rooms[rotate]
    if written:
        path = str(tmp_path / "motion.pbrt")
        scenes.write_pbrt(desc, path, scenes.ROOM_LOOK_AT)
        parsed = pbrt_parse(path)
        np.testing.assert_array_equal(parsed.camera.camera_to_world_end.m, desc.camera.camera_to_world_end.m)
        assert parsed.integrator.max_depth == 5
        cs = compile_scene(parsed, "cpu")
    _tables_equal(cs, ref)
    assert cs.static.has_rot_motion == rotate and cs.static.has_motion
    assert (cs.arrays.anim is not None) == rotate
    assert not cs.static.has_wide_tri and intersect.route_name(cs.static) == "bvh"


ROTOR = """
Film "image" "integer xresolution" [8] "integer yresolution" [8]
Integrator "path" "integer maxdepth" [1]
Camera "perspective" "float fov" [45] "float shutteropen" [0] "float shutterclose" [1]
WorldBegin
LightSource "point" "rgb I" [5 5 5]
ObjectBegin "rotor"
ActiveTransform EndTime
Rotate 120 0 1 0
ActiveTransform All
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point3 P" [0.98 -1 -0.1  1.02 -1 0.1  1.02 1 0.1  0.98 1 -0.1]
ObjectEnd
AttributeBegin
Translate 0 0 -2
ObjectInstance "rotor"
AttributeEnd
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point3 P" [-5 -1 -5  5 -1 -5  5 -1 5  -5 -1 5]
WorldEnd
"""


def test_animated_instanced_prototype_matches_reference(tmp_path):
    """An instanced prototype under a rotating shutter CTM: its tables and
    swept bounds are the reference's, and a ray at the exact arc's point
    at two times hits it, as the reference's test_motion.py :345 asks."""
    path = tmp_path / "rotor.pbrt"
    path.write_text(ROTOR)
    cs, ref = compile_scene(pbrt_parse(str(path)), "cpu"), ref_compile_scene(ref_pbrt_parse(str(path)))
    _tables_equal(cs, ref)
    assert cs.static.has_instances and cs.static.has_rot_motion and intersect.route_name(cs.static) == "bvh"
    from pbrt_tpu_torch.core.transform import AnimatedTransform, Transform

    anim = AnimatedTransform(Transform.identity(), Transform.rotate(120.0, [0.0, 1.0, 0.0]))
    off = np.array([0.0, 0.0, -2.0])
    for tm in (0.3, 0.7):
        c_t = anim.interpolate(tm).xpoint(np.array([[1.0, 0.0, 0.0]]))[0] + off
        n_t = (c_t - off) / np.linalg.norm(c_t - off)
        o = torch.as_tensor((c_t + 3.0 * n_t)[None], dtype=torch.float32)
        d = torch.as_tensor((-n_t)[None], dtype=torch.float32)
        hit = intersect.intersect(cs.arrays, cs.static, o, d, torch.full((1,), torch.inf),
                                  time=torch.tensor([tm], dtype=torch.float32))
        assert int(hit["prim"][0]) >= 0 and abs(float(hit["t"][0]) - 3.0) < 2e-3


def test_motion_ops_match_reference(rooms):
    """_slerp (both branches), _quat_to_matrix, eval_anim, _affine_inverse,
    _compose, xform_point and motion_matrices on the rotating room's groups
    and prims at random times."""
    _desc, cs, ref = rooms[True]
    rs = np.random.RandomState(3)
    n = 512
    an, an_r = cs.arrays.anim, ref.arrays.anim
    gid = rs.randint(0, an["q0"].shape[0], n)
    dt = rs.uniform(0, 1, n).astype(np.float32)
    g, t = torch.as_tensor(gid), torch.as_tensor(dt)
    gj, tj = jnp.asarray(gid.astype(np.int32)), jnp.asarray(dt)
    close = dict(rtol=2e-6, atol=2e-6)
    theta = rs.choice([0.01, 0.3, 1.2], n).astype(np.float32)  # the nlerp and slerp branches
    q0, q1 = (rs.normal(size=(n, 4)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(motion._slerp(torch.as_tensor(q0), torch.as_tensor(q1), torch.as_tensor(theta), t),
                               ref_motion._slerp(jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(theta), tj), **close)
    np.testing.assert_allclose(motion._quat_to_matrix(torch.as_tensor(q0)), ref_motion._quat_to_matrix(jnp.asarray(q0)),
                               **close)
    m = motion.eval_anim(an, g, t)
    m_r = ref_motion.eval_anim(an_r, gj, tj)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_r), **close)
    np.testing.assert_allclose(motion._affine_inverse(m).numpy(), np.asarray(ref_motion._affine_inverse(m_r)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(motion._compose(m, m.flip(0)).numpy(),
                               np.asarray(ref_motion._compose(m_r, m_r[::-1])), rtol=1e-5, atol=1e-5)
    p = rs.normal(size=(n, 3)).astype(np.float32)
    np.testing.assert_allclose(motion.xform_point(m, torch.as_tensor(p)).numpy(),
                               np.asarray(ref_motion.xform_point(m_r, jnp.asarray(p))), rtol=1e-5, atol=1e-5)
    prim = rs.randint(0, cs.static.n_prims, n)
    moving = np.asarray(ref.arrays.anim_gid)[prim] > 0
    assert moving.any() and (~moving).any()
    for quadric in (False, True):
        a = motion.motion_matrices(cs.arrays, torch.as_tensor(prim), t, quadric)
        b = ref_motion.motion_matrices(ref.arrays, jnp.asarray(prim.astype(np.int32)), tj, quadric)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def _rays(seed, n=N):
    rs = np.random.RandomState(seed)
    o = rs.uniform([-3.0, 0.5, -3.0], [3.0, 3.5, 3.0], (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d, rs.uniform(0, 1, n).astype(np.float32)


def _same_hits(mine, theirs, moving_rows):
    prim, prim_r = mine["prim"].numpy(), np.asarray(theirs["prim"])
    np.testing.assert_array_equal(prim, prim_r)
    hit = prim >= 0
    assert hit.mean() > 0.9 and np.isin(prim, moving_rows).sum() >= max(5, len(prim) // 100)
    t, t_r = mine["t"].numpy()[hit], np.asarray(theirs["t"])[hit]
    np.testing.assert_allclose(t, t_r, rtol=1e-5, atol=1e-6)


def _moving_rows(cs):
    if cs.arrays.anim_gid is not None:
        return np.nonzero(cs.arrays.anim_gid.numpy() > 0)[0]
    moved = (cs.arrays.prim_test_data_end != cs.arrays.prim_test_data).any(1)
    return np.nonzero(moved.numpy())[0]


def test_bvh_walk_with_time_matches_reference(rooms):
    """walk_plain with time (bvh_walk_motion_cuda's twin), closest and any
    hit, against the reference's packet walk with time, under the exact
    animated transform (the keyframe motion's walk is held to the
    reference's brute route below)."""
    _desc, cs, ref = rooms[True]
    o, d, tm = _rays(5)
    args = [torch.as_tensor(x) for x in (o, d)]
    hit = intersect.intersect(cs.arrays, cs.static, *args, torch.full((N,), torch.inf), time=torch.as_tensor(tm))
    hit_r = ref_intersect.intersect(ref.arrays, ref.static, jnp.asarray(o), jnp.asarray(d),
                                    jnp.full(N, jnp.inf, jnp.float32), time=jnp.asarray(tm))
    _same_hits(hit, hit_r, _moving_rows(cs))
    occ = intersect.intersect_p(cs.arrays, cs.static, *args, torch.full((N,), 2.0), time=torch.as_tensor(tm))
    occ_r = ref_intersect.intersect_p(ref.arrays, ref.static, jnp.asarray(o), jnp.asarray(d),
                                      jnp.full(N, 2.0, jnp.float32), time=jnp.asarray(tm))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_r))
    # the time moves the hits: at shutter open the walk answers otherwise
    static = intersect.intersect(cs.arrays, cs.static, *args, torch.full((N,), torch.inf))
    assert (static["prim"] != hit["prim"]).sum() > 5


@pytest.mark.parametrize("rotate", [True, False])
def test_brute_route_with_time_matches_reference(rooms, rotate):
    """The brute route with time (every prim moved by broadcasting) against
    the reference's intersect_brute with time on the same tables, under the
    exact animated transform (rotate: motion_matrices over every prim) and
    the keyframe motion; the brute route's answer equals the walk's."""
    _desc, cs, ref = rooms[rotate]
    o, d, tm = _rays(6, 300)
    t_max = torch.full((300,), torch.inf)
    brute = intersect.intersect_brute(cs.arrays, cs.static, torch.as_tensor(o), torch.as_tensor(d), t_max,
                                      torch.as_tensor(tm))
    brute_r = jax.jit(lambda o, d, t: ref_intersect.intersect_brute(
        ref.arrays, ref.static, o, d, jnp.full(300, jnp.inf, jnp.float32), t))(jnp.asarray(o), jnp.asarray(d),
                                                                                jnp.asarray(tm))
    _same_hits(brute, brute_r, _moving_rows(cs))
    walk = intersect.intersect(cs.arrays, cs.static, torch.as_tensor(o), torch.as_tensor(d), t_max,
                               time=torch.as_tensor(tm))
    np.testing.assert_array_equal(walk["prim"].numpy(), brute["prim"].numpy())


def test_kd_walk_with_time_matches_brute_force():
    """The kd-tree walk's twin with time against the brute route with time
    on the kd variant (the reference's kd packet walk drops near children:
    tests/test_torch_bvh_walk.py)."""
    cs = compile_scene(_small(True, "kdtree"), "cpu")
    assert intersect.route_name(cs.static) == "kdtree"
    o, d, tm = (torch.as_tensor(x) for x in _rays(7, 1000))
    t_max = torch.full((1000,), torch.inf)
    t, prim, _b1, _b2, _pops, overflow = bvh_walk.kd_walk_plain(cs.arrays, cs.static, o, d, t_max, False, time=tm)
    truth = intersect.intersect_brute(cs.arrays, cs.static, o, d, t_max, tm)
    assert overflow == 0
    np.testing.assert_array_equal(prim.numpy(), truth["prim"].numpy())
    hit = prim >= 0
    np.testing.assert_allclose(t[hit].numpy(), truth["t"][hit].numpy(), rtol=1e-6)


def test_surface_interaction_at_time_matches_reference(rooms):
    """The shading record at the hits' times, under the exact animated
    transform (normals through its inverse's transpose)."""
    for rotate in (True,):
        _desc, cs, ref = rooms[rotate]
        o, d, tm = _rays(8, 800)
        hit = intersect.intersect(cs.arrays, cs.static, torch.as_tensor(o), torch.as_tensor(d),
                                  torch.full((800,), torch.inf), time=torch.as_tensor(tm))
        si = shading.surface_interaction(cs.arrays, hit, torch.as_tensor(o), torch.as_tensor(d),
                                         cs.static.quadric_kinds, torch.as_tensor(tm))
        hit_r = {k: jnp.asarray(v.numpy().astype(np.int32 if k == "prim" else np.float32)) for k, v in hit.items()}
        si_r = jax.jit(lambda h, o, d, t: ref_shading.surface_interaction(ref.arrays, h, o, d, time=t))(
            hit_r, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm))
        ok = si["valid"].numpy()
        moving = np.isin(hit["prim"].numpy(), _moving_rows(cs))
        assert ok.mean() > 0.9 and (ok & moving).sum() > 10
        for key in ("p", "ng", "ns", "uv"):
            np.testing.assert_allclose(si[key].numpy()[ok], np.asarray(si_r[key])[ok], rtol=1e-5, atol=1e-5,
                                       err_msg=key)


def test_animated_camera_matches_reference(rooms):
    """generate_rays of motion_room's dollying, yawing camera at random
    shutter fractions, and its transform keyframes."""
    desc, _cs, ref = rooms[True]
    cam = camera.make_camera(desc.camera, desc.film, "cpu")
    cam_r = ref_camera.make_camera(ref.description.camera, ref.description.film)
    for k in ("t", "q", "s"):
        np.testing.assert_array_equal(cam["anim"][k].numpy(), np.asarray(cam_r["anim"][k]))
    rs = np.random.RandomState(9)
    n = 1024
    px, py = rs.uniform(0, 1000, n).astype(np.float32), rs.uniform(0, 500, n).astype(np.float32)
    tf = rs.uniform(0, 1, n).astype(np.float32)
    z = np.zeros(n, np.float32)
    o, d = camera.generate_rays(cam, *(torch.as_tensor(x) for x in (px, py, z, z, tf)))
    o_r, d_r = jax.jit(lambda *a: ref_camera.generate_rays(cam_r, *a))(*(jnp.asarray(x) for x in (px, py, z, z, tf)))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_r), rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_r), rtol=2e-6, atol=2e-6)
    o0, _d0 = camera.generate_rays(cam, *(torch.as_tensor(x) for x in (px, py, z, z)))
    assert (o.numpy() - o0.numpy()).std() > 0.01  # the camera moves


def test_motion_wave_matches_reference(rooms):
    """trace_wave of the rotating motion room through make_wave_fn (the
    shutter time from dimension 8117, the animated camera, the time-aware
    walk and shading) against the reference's: 16 x 12, depth 2, sample 1."""
    W, H, seed = 16, 12, 3
    desc = _small(True)
    desc.film.x_resolution, desc.film.y_resolution = W, H
    desc.sampler.pixel_samples, desc.integrator.max_depth = 2, 2
    cs, ref = compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))
    wave = render.make_wave_fn(cs)
    assert render.LAST_WAVE_TIER == "torch-wave/bvh"
    assert not render.persistent_eligible(desc, cs.static)
    ys, xs = np.mgrid[0:H, 0:W]
    lanes = [xs.ravel(), ys.ravel(), (ys * W + xs).ravel()]
    L, w, nv = (x.numpy() for x in wave(cs.arrays, *(torch.as_tensor(a.astype(np.int64)) for a in lanes), 1, seed))
    L_r, w_r, nv_r = (np.asarray(x) for x in ref_render.make_wave_fn(ref)(
        ref.arrays, *(jnp.asarray(a.astype(t)) for a, t in zip(lanes, (np.int32, np.int32, np.uint32))),
        jnp.uint32(1), jnp.uint32(seed)))
    np.testing.assert_array_equal(w, w_r)
    np.testing.assert_array_equal(nv, nv_r)
    np.testing.assert_allclose(L, L_r, rtol=1e-4, atol=1e-5)
    assert L.mean() > 0.05


def test_static_scene_ignores_time():
    """A scene without moving prims answers a query, and builds a shading
    record, with a time as without one, bit for bit, on the wide route; its
    wave draws no shutter time (persistent_eligible keeps it)."""
    desc = scenes.mesh_room(8)
    cs = compile_scene(desc, "cpu")
    assert not cs.static.has_motion and render.persistent_eligible(desc, cs.static)
    o, d, tm = (torch.as_tensor(x) for x in _rays(10, 512))
    t_max = torch.full((512,), torch.inf)
    a = intersect.intersect(cs.arrays, cs.static, o, d, t_max)
    b = intersect.intersect(cs.arrays, cs.static, o, d, t_max, time=tm)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    sa = shading.surface_interaction(cs.arrays, a, o, d, cs.static.quadric_kinds)
    sb = shading.surface_interaction(cs.arrays, b, o, d, cs.static.quadric_kinds, tm)
    for k in ("p", "ng", "ns", "uv", "ss"):
        assert torch.equal(sa[k], sb[k]), k
    assert torch.equal(intersect.intersect_p(cs.arrays, cs.static, o, d, t_max),
                       intersect.intersect_p(cs.arrays, cs.static, o, d, t_max, time=tm))
