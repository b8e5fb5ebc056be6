"""Light sampling and the spatial light distribution of the port against
the reference, on the CPU: sample_li for point, spot and distant lights
(and the area lights beside them), build_spatial_distribution on area_box
and on the mesh room, and spatial_select / spatial_pmf_of at random points;
the infinite light, constant and image-mapped: env_le, env_pdf_li,
_env_sample and its lanes of sample_li.

Tolerances: the delta lights' samples at rtol 1e-6. An area light's pdf
divides by the cosine at the light, which is small at grazing angles, so a
one-ulp difference in the direction (the two packages sum the dot products
in different orders) moves it by up to ~1e-6 relative: rtol 1e-5 there. The
reference builds its distribution in one jitted sweep, in which XLA:CPU
contracts multiply-adds into fused multiply-adds (a jitted c + a * b equals
the fused result on every element, the separately rounded one on 71%); the
port's sweep rounds each operation, so about half of the pmf entries are
bit-equal and the rest within 1e-5 relative. The image-mapped infinite
light's pdf of a direction near the map's poles is amplified as
test_env_light_matches_reference states.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from pbrt_tpu.device import lightdistrib as ref_ld
from pbrt_tpu.device import lights as ref_lights
from pbrt_tpu.scene.builder import compile_scene as ref_compile_scene
from pbrt_tpu_torch.device import lightdistrib, lights
from pbrt_tpu_torch.scene.builder import compile_scene
from pbrt_tpu_torch.core.transform import Transform
from pbrt_tpu_torch.scene.host import HostLight
from pbrt_tpu_torch.scenes import area_box, mesh_room, sky_meshes, spheres_gallery
from test_torch_megakernel import _to_ref
from torch_threads import one_torch_thread  # noqa: F401  (autouse: PyTorch single-threaded in this module)

N = 4096


def _sky(image):
    """sky_meshes cut to 600 triangles: its constant sky, or an image-mapped
    one (a 16x32 map of random radiance, rotated by its light-to-world)."""
    desc = sky_meshes(10, 6, 10)
    if image:
        rs = np.random.RandomState(11)
        desc.lights[0] = HostLight(kind="infinite", intensity=np.array([1.2, 1.0, 0.9]),
                                   image=rs.uniform(0.0, 3.0, (16, 32, 3)),
                                   light_to_world=Transform.rotate(35.0, [0.3, 1.0, 0.2]))
    return desc, None


SCENES = {
    "gallery": lambda: (spheres_gallery(), None),  # distant, point, spot
    "area_box": lambda: (area_box(), None),  # point and two triangle area lights
    "mesh_room": lambda: (mesh_room(8), bench._mesh_scene(8)),  # two area lights
    "sky": lambda: _sky(False),  # a constant infinite light and a distant light
    "sky_map": lambda: _sky(True),  # an image-mapped infinite light and a distant light
}


@pytest.fixture(scope="module")
def compiled():
    out = {}
    for name, make in SCENES.items():
        desc, ref_desc = make()
        out[name] = compile_scene(desc, "cpu"), ref_compile_scene(ref_desc if ref_desc is not None else _to_ref(desc))
    return out


def _points(cs, rs, n):
    c = cs.arrays.world_center.numpy()
    r = float(cs.arrays.world_radius)
    return (c + rs.uniform(-0.7, 0.7, (n, 3)) * r).astype(np.float32)


@pytest.mark.parametrize("scene", ["gallery", "area_box"])
def test_sample_li_matches_reference(compiled, scene):
    cs, ref = compiled[scene]
    rs = np.random.RandomState(5)
    p = _points(cs, rs, N)
    lid = rs.randint(0, cs.static.n_lights, N)
    u1, u2 = rs.uniform(0, 1, (2, N)).astype(np.float32)
    mine = lights.sample_li(cs.arrays, cs.static, torch.as_tensor(lid), *(torch.as_tensor(x) for x in (p, u1, u2)))
    theirs = ref_lights.sample_li(ref.arrays, ref.static, jnp.asarray(lid.astype(np.int32)),
                                  *(jnp.asarray(x) for x in (p, u1, u2)))
    delta = np.asarray(theirs["delta"])
    np.testing.assert_array_equal(mine["delta"].numpy(), delta)
    kinds = np.asarray(ref.arrays.light_kind)[lid]
    assert delta.any() and (set(kinds.tolist()) == set(cs.static.light_kinds))
    for key in ("wi", "li", "pdf", "dist", "n", "area"):
        a, b = mine[key].numpy(), np.asarray(theirs[key])
        np.testing.assert_allclose(a[delta], b[delta], rtol=1e-6, atol=1e-7, err_msg=key)
        np.testing.assert_allclose(a[~delta], b[~delta], rtol=1e-5, atol=1e-6, err_msg=key)
    spot = kinds == 1
    if spot.any():  # the falloff is exercised inside, across and outside the cone
        li = mine["li"].numpy()[spot].sum(-1)
        assert (li == 0).any() and (li > 0).any()


@pytest.mark.parametrize("scene", ["area_box", "mesh_room", "sky_map"])
def test_spatial_distribution_matches_reference(compiled, scene):
    cs, ref = compiled[scene]
    mine = lightdistrib.build_spatial_distribution(cs.arrays, cs.static)
    theirs = ref_ld.build_spatial_distribution(ref.arrays, ref.static)
    assert tuple(mine["res"]) == tuple(int(x) for x in np.asarray(theirs["res"]))
    assert mine["n_voxels"] == theirs["n_voxels"]
    for key in ("lo", "inv_cell"):
        np.testing.assert_array_equal(mine[key].numpy(), np.asarray(theirs[key]), err_msg=key)
    for key in ("pmf", "cdf"):
        np.testing.assert_allclose(mine[key].numpy(), np.asarray(theirs[key]), rtol=1e-5, err_msg=key)
    pmf = mine["pmf"].numpy()
    assert (pmf.max(1) - pmf.min(1)).max() > 0.1  # the voxels tell the lights apart

    rs = np.random.RandomState(6)
    p = _points(cs, rs, N)
    u = rs.uniform(0, 1, N).astype(np.float32)
    lid, pmf_sel = lightdistrib.spatial_select(mine, torch.as_tensor(p), torch.as_tensor(u))
    lid_r, pmf_r = ref_ld.spatial_select(theirs, jnp.asarray(p), jnp.asarray(u))
    np.testing.assert_array_equal(lid.numpy(), np.asarray(lid_r))
    np.testing.assert_allclose(pmf_sel.numpy(), np.asarray(pmf_r), rtol=1e-5)
    q = rs.randint(0, cs.static.n_lights, N)
    np.testing.assert_allclose(
        lightdistrib.spatial_pmf_of(mine, torch.as_tensor(p), torch.as_tensor(q)).numpy(),
        np.asarray(ref_ld.spatial_pmf_of(theirs, jnp.asarray(p), jnp.asarray(q.astype(np.int32)))), rtol=1e-5)


def _directions(rs, n):
    d = rs.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("scene", ["sky", "sky_map"])
def test_env_light_matches_reference(compiled, scene):
    """env_le and env_pdf_li of random directions, _env_sample of random
    uniforms and the infinite light's lanes of sample_li, constant and
    image-mapped."""
    cs, ref = compiled[scene]
    assert cs.static.has_env_map == (scene == "sky_map") and cs.static.infinite_light_index == 0
    rs = np.random.RandomState(8)
    d = _directions(rs, N)
    np.testing.assert_allclose(lights.env_le(cs.arrays, cs.static, torch.as_tensor(d)).numpy(),
                               np.asarray(ref_lights.env_le(ref.arrays, ref.static, jnp.asarray(d))), rtol=1e-6,
                               atol=1e-7)
    pdf = lights.env_pdf_li(cs.arrays, cs.static, torch.as_tensor(d)).numpy()
    pdf_r = np.asarray(ref_lights.env_pdf_li(ref.arrays, ref.static, jnp.asarray(d)))
    # near the map's poles acos amplifies an ulp of the light-space z into
    # dtheta = dz / sin(theta), and the pdf's 1 / sin(theta) once more: a
    # relative difference up to ~2.5e-7 / sin^2(theta) (1.2e-4 at the
    # smallest sin(theta) drawn, 0.0226)
    tol = 1e-6
    if cs.static.has_env_map:
        sin_t = np.sin(lights._env_dir_to_uv(cs.arrays, torch.as_tensor(d))[2].numpy())
        tol = np.maximum(tol, 2.5e-7 / sin_t ** 2)
    assert (np.abs(pdf - pdf_r) <= tol * np.abs(pdf_r) + 1e-7).all()
    u1, u2 = rs.uniform(0, 1, (2, N)).astype(np.float32)
    p = _points(cs, rs, N)
    lid = np.zeros(N, np.int64)
    mine = lights.sample_li(cs.arrays, cs.static, torch.as_tensor(lid), *(torch.as_tensor(x) for x in (p, u1, u2)))
    theirs = ref_lights.sample_li(ref.arrays, ref.static, jnp.asarray(lid.astype(np.int32)),
                                  *(jnp.asarray(x) for x in (p, u1, u2)))
    assert not mine["delta"].any() and not np.asarray(theirs["delta"]).any()
    for key in ("wi", "li", "pdf", "dist", "n", "area"):
        np.testing.assert_allclose(mine[key].numpy(), np.asarray(theirs[key]), rtol=1e-5, atol=1e-6, err_msg=key)
    if scene == "sky_map":
        got = lights._env_sample(cs.arrays, torch.as_tensor(u1), torch.as_tensor(u2))
        want = ref_lights._env_sample(ref.arrays, jnp.asarray(u1), jnp.asarray(u2))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def _sphere_lamps():
    """A brute scene of sphere lamps beside a triangle panel: a full,
    outward-facing lamp (sampled by its visible cone), one scaled by 1.5
    (its world radius from o2w's column 0), a reverse-oriented one and a
    partial one (both sampled over their area, as a full sphere), and a
    one-sided triangle area light."""
    from pbrt_tpu_torch.scene.host import HostMaterial, HostPrimitive, ShapeRecord, Sphere

    desc = area_box()
    black = HostMaterial(kind="matte", params={"Kd": ("const", np.zeros(3))})

    def lamp(o2w, emit, **kw):
        kw = {"z_min": -0.3, "z_max": 0.3, **kw}
        return HostPrimitive(shape=ShapeRecord(sphere=Sphere(object_to_world=o2w, radius=0.3, **kw)),
                             material=black, area_light=HostLight(kind="area", intensity=np.asarray(emit, float)))

    desc.primitives += [
        lamp(Transform.translate([0.2, 1.2, -0.4]), [9.0, 8.0, 7.0]),
        lamp(Transform.translate([-0.6, 0.9, 0.3]) @ Transform.scale(1.5, 1.5, 1.5), [4.0, 5.0, 6.0]),
        lamp(Transform.translate([0.7, 0.5, 0.5]), [3.0, 3.0, 3.0], reverse_orientation=True),
        lamp(Transform.translate([-0.2, 0.4, 0.9]), [2.0, 2.5, 3.0], z_max=0.1),
    ]
    return desc


@pytest.fixture(scope="module")
def lamps():
    desc = _sphere_lamps()
    return compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))


def _lamp_refs(cs, rs, n):
    """Reference points: half around the scene, half inside the full lamps
    (the cone branch takes only points outside them)."""
    p = _points(cs, rs, n)
    sph = cs.arrays.sph_o2w.numpy()[:2]
    inside = sph[rs.randint(0, 2, n // 2), :, 3] + rs.uniform(-0.15, 0.15, (n // 2, 3))
    p[: n // 2] = inside.astype(np.float32)
    return p


def test_sphere_lamps_match_reference(lamps):
    """The sphere lamps' ops against the reference's on the same inputs:
    _sample_prim_point on every light prim, _sphere_cone_info, sample_li
    with and without cone_spheres from points inside and outside the
    lamps, pdf_li_area_hit with cone_spheres at points on the lamps, and
    compute_power. Tolerances: rtol 1e-6 for the point samples, the cone
    info and the powers; the cone's direction comes through sqrt(1 - cos^2)
    and a square root of a difference near the silhouette, which turn an
    ulp of cos theta_max into up to ~7e-5 relative in a component of the
    sampled direction and normal (~4e-6 in the pdf): rtol 1e-4, atol 1e-5
    there (the area branch keeps test_sample_li_matches_reference's 1e-5)."""
    cs, ref = lamps
    st = cs.static
    assert st.has_cone_sphere_lights and ref.static.has_cone_sphere_lights and st.n_spheres == ref.static.n_spheres
    rs = np.random.RandomState(12)
    area = [i for i, k in enumerate(st.light_kinds) if k == 4]
    lid = np.asarray(area)[rs.randint(0, len(area), N)]
    u1, u2 = rs.uniform(0, 1, (2, N)).astype(np.float32)
    prim = cs.arrays.light_prim.numpy()[lid]
    got = lights._sample_prim_point(cs.arrays, torch.as_tensor(prim), torch.as_tensor(u1), torch.as_tensor(u2))
    want = ref_lights._sample_prim_point(ref.arrays, jnp.asarray(prim.astype(np.int32)), jnp.asarray(u1),
                                         jnp.asarray(u2))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    got = lights._sphere_cone_info(cs.arrays, torch.as_tensor(prim))
    want = ref_lights._sphere_cone_info(ref.arrays, jnp.asarray(prim.astype(np.int32)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].numpy().any() and not got[0].numpy().all()  # the reversed and partial lamps sample by area
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    p = _lamp_refs(cs, rs, N)
    for cone in (False, True):
        mine = lights.sample_li(cs.arrays, st, torch.as_tensor(lid), *(torch.as_tensor(x) for x in (p, u1, u2)),
                                cone_spheres=cone)
        theirs = ref_lights.sample_li(ref.arrays, ref.static, jnp.asarray(lid.astype(np.int32)),
                                      *(jnp.asarray(x) for x in (p, u1, u2)), cone_spheres=cone)
        for key in ("wi", "li", "pdf", "dist", "n", "area"):
            np.testing.assert_allclose(mine[key].numpy(), np.asarray(theirs[key]), rtol=1e-4 if cone else 1e-5,
                                       atol=1e-5 if cone else 1e-6, err_msg=f"{key} cone {cone}")
    # a BSDF-sampled ray's hit on a lamp: points on its surface, seen from p
    hit_p, hit_n, hit_area = (x.numpy() for x in lights._sample_prim_point(
        cs.arrays, torch.as_tensor(prim), torch.as_tensor(u2), torch.as_tensor(u1)))
    mine = lights.pdf_li_area_hit(cs.arrays, *(torch.as_tensor(x) for x in (p, hit_p, hit_n, lid, hit_area)),
                                  cone_spheres=True)
    theirs = ref_lights.pdf_li_area_hit(ref.arrays, *(jnp.asarray(x) for x in (p, hit_p, hit_n)),
                                        jnp.asarray(lid.astype(np.int32)), jnp.asarray(hit_area), cone_spheres=True)
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lights.compute_power(cs.arrays, st).numpy(),
                               np.asarray(ref_lights.compute_power(ref.arrays, ref.static)), rtol=1e-6)
