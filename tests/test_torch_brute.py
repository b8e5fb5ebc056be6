"""The brute-force route of the port against the reference, on the CPU:
the watertight triangle test, the EFloat sphere test (full and partial
spheres) with its interval quadratic, the all-pairs closest and any-hit
queries on area_box's tables, and the sphere branch of
surface_interaction.

Rays come from a numpy seed; both packages see the same float32 inputs.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.device import efloat as ref_efl
from pbrt_tpu.device import intersect as ref_intersect
from pbrt_tpu.device import shading as ref_shading
from pbrt_tpu.scene.builder import compile_scene as ref_compile_scene
from pbrt_tpu_torch.device import efloat as efl
from pbrt_tpu_torch.device import intersect, shading
from pbrt_tpu_torch.scene.builder import compile_scene
from pbrt_tpu_torch.scenes import area_box
from test_torch_megakernel import _to_ref
from torch_threads import one_torch_thread  # noqa: F401  (autouse: PyTorch single-threaded in this module)

N_RAYS = 4096


def _t(x):
    return torch.as_tensor(np.array(x))


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def box():
    desc = area_box()
    return compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))


def _rays(rs, n):
    """Origins inside and around the box, directions uniform on the sphere."""
    o = rs.uniform([-3.5, -0.5, -3.5], [3.5, 3.5, 6.0], (n, 3)).astype(np.float32)
    return o, _unit(rs.normal(size=(n, 3)))


def test_ray_triangle_matches_reference(box):
    """All rays against all of area_box's 12 triangles; a quarter of the
    rays graze a triangle's plane (direction within 1e-4 of it)."""
    cs, _ref = box
    rs = np.random.RandomState(0)
    o, d = _rays(rs, N_RAYS)
    tv = cs.arrays.tri_p.numpy()
    n = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    g = N_RAYS // 4
    pick = rs.randint(0, len(tv), g)
    c = tv[pick].mean(1)
    tang = np.cross(n[pick], rs.normal(size=(g, 3)))
    o[:g] = (c - 2.0 * _unit(tang) + n[pick] * rs.uniform(-1e-3, 1e-3, (g, 1))).astype(np.float32)
    d[:g] = _unit(_unit(tang) + n[pick] * rs.uniform(-1e-4, 1e-4, (g, 1)))
    t_max = np.full((N_RAYS, 1), np.inf, np.float32)
    args = (o[:, None], d[:, None], tv[None, :, 0], tv[None, :, 1], tv[None, :, 2], t_max)
    mine = [x.numpy() for x in intersect.ray_triangle(*(_t(a) for a in args))]
    theirs = [np.asarray(x) for x in ref_intersect.ray_triangle(*(jnp.asarray(a) for a in args))]
    np.testing.assert_array_equal(mine[0], theirs[0])
    hit = theirs[0]
    assert 0.3 < hit.any(1).mean() < 1.0 and hit[:g].any()
    for a, b in zip(mine[1:], theirs[1:]):
        np.testing.assert_allclose(a[hit], b[hit], rtol=1e-6, atol=1e-7)


def _sphere_tables():
    """Three spheres: full, clipped at z_max (the 0.3 cap of a 0.6 sphere),
    and clipped in phi; scaled and translated."""
    rows = [(1.0, -1.0, 1.0, 2 * math.pi), (0.6, -0.6, 0.3, 2 * math.pi), (0.8, -0.5, 0.8, 1.5 * math.pi)]
    params, w2o = [], []
    for i, (r, zmin, zmax, phimax) in enumerate(rows):
        tmin, tmax = math.acos(zmin / r), math.acos(zmax / r)
        params.append([r, zmin, zmax, phimax, tmin, tmax] + [0.0] * 6)
        o2w = np.eye(4)
        o2w[:3, :3] *= 1.0 + 0.25 * i
        o2w[:3, 3] = [2.5 * i - 2.5, 0.3 * i, -0.5 * i]
        w2o.append(np.linalg.inv(o2w)[:3])
    return np.asarray(params, np.float32), np.asarray(w2o, np.float32), np.asarray(
        [[2.5 * i - 2.5, 0.3 * i, -0.5 * i] for i in range(3)], np.float32)


def test_ray_sphere_matches_reference():
    """Rays aimed near each sphere's centre, rays tangent to it, and rays
    from inside it, against full and partial spheres."""
    params, w2o, centres = _sphere_tables()
    rs = np.random.RandomState(1)
    n3 = N_RAYS // 4
    target = centres[rs.randint(0, 3, N_RAYS)] + rs.normal(0, 0.6, (N_RAYS, 3)).astype(np.float32)
    o = (target + 4.0 * _unit(rs.normal(size=(N_RAYS, 3)))).astype(np.float32)
    d = _unit(target - o)
    o[:n3] = (centres[rs.randint(0, 3, n3)] + rs.normal(0, 0.2, (n3, 3))).astype(np.float32)  # inside
    d[:n3] = _unit(rs.normal(size=(n3, 3)))
    # grazing: tangent to the first sphere's surface (radius 1)
    g = slice(n3, 2 * n3)
    nrm = _unit(rs.normal(size=(n3, 3)))
    tang = _unit(np.cross(nrm, rs.normal(size=(n3, 3))))
    o[g] = (centres[0] + nrm * (1.0 + rs.uniform(-1e-4, 1e-4, (n3, 1))) - 3.0 * tang).astype(np.float32)
    d[g] = tang
    t_max = rs.uniform(0.5, 20.0, (N_RAYS, 1)).astype(np.float32)
    t_max[: N_RAYS // 2] = np.inf
    args = (o[:, None], d[:, None], w2o[None], params[None], t_max)
    hit, t, p_obj = (x.numpy() for x in intersect.ray_sphere(*(_t(a) for a in args)))
    hit_r, t_r, p_r = (np.asarray(x) for x in ref_intersect.ray_sphere(*(jnp.asarray(a) for a in args)))
    np.testing.assert_array_equal(hit, hit_r)
    assert 0.1 < hit.mean() < 0.9 and hit[:n3].any() and hit[g].any()
    np.testing.assert_allclose(t[hit], t_r[hit], rtol=1e-6)
    np.testing.assert_allclose(p_obj[hit], p_r[hit], rtol=1e-5, atol=1e-6)


def test_efloat_quadratic_matches_reference():
    rs = np.random.RandomState(2)
    n = N_RAYS
    coef = []
    for scale in (1.0, 3.0, 10.0):
        v = (rs.normal(size=n) * scale).astype(np.float32)
        err = (np.abs(rs.normal(size=n)) * 1e-5 * scale).astype(np.float32)
        coef.append((v, err))
    coef[0][0][:16] = 0.0  # a = 0: the division's straddling interval
    mine = efl.quadratic(*(efl.ef(_t(v), _t(e)) for v, e in coef))
    theirs = ref_efl.quadratic(*(ref_efl.ef(jnp.asarray(v), jnp.asarray(e)) for v, e in coef))
    np.testing.assert_array_equal(mine[0].numpy(), np.asarray(theirs[0]))
    ok = np.asarray(theirs[0])
    for a, b in zip(mine[1] + mine[2], theirs[1] + theirs[2]):
        np.testing.assert_allclose(a.numpy()[ok], np.asarray(b)[ok], rtol=1e-6)


def test_brute_tables_bit_identical(box):
    cs, ref = box
    assert cs.static.use_brute_force and cs.static.n_prims == 15 and cs.static.n_lights == 3
    for name in ("tri_p", "sph_w2o", "sph_o2w", "sph_param", "tri_prim_ids", "sph_prim_ids", "prim_kind",
                 "prim_geom", "prim_flags", "prim_mat", "prim_light", "light_param", "light_prim", "mat_const"):
        np.testing.assert_array_equal(getattr(cs.arrays, name).numpy(), np.asarray(getattr(ref.arrays, name)), name)
    assert cs.static.light_n_samples == tuple(ref.static.light_n_samples)


def _box_hits(cs, ref, seed):
    rs = np.random.RandomState(seed)
    o, d = _rays(rs, N_RAYS)
    t_max = np.full(N_RAYS, np.inf, np.float32)
    t_max[::3] = rs.uniform(0.1, 5.0, len(t_max[::3]))
    mine = intersect.intersect(cs.arrays, cs.static, _t(o), _t(d), _t(t_max))
    theirs = ref_intersect.intersect(ref.arrays, ref.static, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    return o, d, t_max, mine, {k: np.asarray(v) for k, v in theirs.items()}


def test_intersect_brute_matches_reference(box):
    cs, ref = box
    o, d, t_max, mine, theirs = _box_hits(cs, ref, 3)
    np.testing.assert_array_equal(mine["prim"].numpy(), theirs["prim"])
    hit = theirs["prim"] >= 0
    is_sph = np.asarray(ref.arrays.prim_kind)[np.maximum(theirs["prim"], 0)] == 1
    assert 0.3 < hit.mean() < 1.0 and (hit & is_sph).sum() > 100
    for key in ("t", "b1", "b2"):
        np.testing.assert_allclose(mine[key].numpy()[hit], theirs[key][hit], rtol=1e-6, atol=1e-7, err_msg=key)
    assert np.isinf(mine["t"].numpy()[~hit]).all()
    occ = intersect.intersect_p(cs.arrays, cs.static, _t(o), _t(d), _t(t_max)).numpy()
    occ_r = np.asarray(ref_intersect.intersect_p(ref.arrays, ref.static, jnp.asarray(o), jnp.asarray(d),
                                                 jnp.asarray(t_max)))
    np.testing.assert_array_equal(occ, occ_r)
    assert occ.any() and not occ.all()


def test_select_min_ties_to_the_lowest_column():
    t = torch.tensor([[2.0, 1.0, 1.0], [math.inf, math.inf, math.inf], [3.0, 3.0, 0.5]])
    cols = torch.arange(9.0).reshape(3, 3)
    tbest, k, (c,) = intersect._select_min(t, [cols])
    assert k.tolist() == [1, 0, 2] and c.tolist() == [1.0, 3.0, 8.0]
    ref_t, _sel, (ref_c,) = ref_intersect._select_min(jnp.asarray(t.numpy()), [jnp.asarray(cols.numpy())])
    np.testing.assert_array_equal(tbest.numpy(), np.asarray(ref_t))
    np.testing.assert_array_equal(c.numpy(), np.asarray(ref_c))


def test_sphere_surface_interaction_matches_reference(box):
    """surface_interaction on the reference's own hits (spheres and
    triangles of area_box): p, normals, uv, frame and error bound."""
    cs, ref = box
    o, d, _t_max, _mine, theirs = _box_hits(cs, ref, 4)
    hit = theirs["prim"] >= 0
    is_sph = hit & (np.asarray(ref.arrays.prim_kind)[np.maximum(theirs["prim"], 0)] == 1)
    hit_t = {k: _t(v) for k, v in theirs.items()}
    hit_t["prim"] = hit_t["prim"].to(torch.int64)
    si = shading.surface_interaction(cs.arrays, hit_t, _t(o), _t(d))
    si_r = ref_shading.surface_interaction(ref.arrays, {k: jnp.asarray(v) for k, v in theirs.items()},
                                           jnp.asarray(o), jnp.asarray(d))
    assert is_sph.sum() > 100
    for key in ("p", "ng", "ns", "uv", "ss", "ts", "p_err", "dpdu", "dpdv"):
        np.testing.assert_allclose(si[key].numpy()[hit], np.asarray(si_r[key])[hit], rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    for key in ("mat", "light", "valid"):
        np.testing.assert_array_equal(si[key].numpy(), np.asarray(si_r[key]), err_msg=key)
