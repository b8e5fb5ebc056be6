"""The port's lobe sets and BSDF against the reference, on the CPU.

For every material row of area_box, of the spheres gallery, of a scene
of the remaining lobe variants (rough glass, a glass that only transmits,
Beckmann plastic and metal) and of a scene of uber materials (glossy, full,
half-opaque, Beckmann), 4,096 lanes each with random (wo, wi) over
both hemispheres and random (u_lobe, u1, u2) from a numpy seed:
make_bsdf (a row gather of the port's lobe table) gives the reference
make_bsdf's kinds and data, and bsdf_f, bsdf_pdf and bsdf_sample agree at
rtol 1e-5, atol 1e-6 with equal specular and valid flags.

Two places amplify one-ulp differences between the packages (XLA's and
PyTorch's sin, cos, exp and tan, and the order of a dot product's sums):
- a sampled direction within 0.05 of the horizon has its z from
  sqrt(1 - x^2 - y^2): those lanes (2 of area_box's) are held at atol 5e-5;
- a sample's f and pdf at a direction one ulp away, where the microfacet D
  is steep or the Fresnel term is near total internal reflection: f and
  pdf of at most 0.1% of the lanes (1 of area_box's 28,672, 9 of the
  variants' 24,576) differ by more than rtol 1e-5, and all by less than
  rtol 1e-3. bsdf_f and bsdf_pdf themselves agree at rtol 1e-5 everywhere.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.device import bsdf as ref_bsdf
from pbrt_tpu.device.materials import make_bsdf as ref_make_bsdf
from pbrt_tpu.scene.builder import compile_scene as ref_compile_scene
from pbrt_tpu_torch.core.transform import Transform
from pbrt_tpu_torch.device import bsdf
from pbrt_tpu_torch.device.materials import lobe_table, make_bsdf
from pbrt_tpu_torch.scene.builder import compile_scene
from pbrt_tpu_torch.scene.host import HostMaterial, HostPrimitive, ShapeRecord, Sphere
from pbrt_tpu_torch.scenes import area_box, spheres_gallery
from test_torch_megakernel import _to_ref
from torch_threads import one_torch_thread  # noqa: F401  (autouse: PyTorch single-threaded in this module)

N = 4096


def _variants():
    """The gallery with its spheres' materials replaced by the lobe variants
    that area_box and the gallery do not hold."""
    desc = spheres_gallery()
    const = lambda v: ("const", np.asarray(v, np.float64))  # noqa: E731
    mats = [
        HostMaterial(kind="glass", params={"roughness": ("const", 0.2)}),  # MICRO_R + MICRO_T
        HostMaterial(kind="glass", params={"Kr": const([0.0, 0.0, 0.0]), "eta": ("const", 1.33)}),  # SPEC_T
        HostMaterial(kind="glass", params={"Kt": const([0.0, 0.0, 0.0])}),  # dielectric SPEC_R
        HostMaterial(kind="plastic", params={"Kd": const([0.3, 0.4, 0.5]), "Ks": const([0.5, 0.5, 0.5]),
                                             "roughness": ("const", 0.3), "distribution": ("const", "beckmann")}),
        HostMaterial(kind="metal", params={"roughness": ("const", 0.2), "distribution": ("const", "beckmann"),
                                           "remaproughness": ("const", False)}),
        HostMaterial(kind="glass", params={"uroughness": ("const", 0.1), "vroughness": ("const", 0.3),
                                           "distribution": ("const", "beckmann")}),
    ]
    desc.primitives = desc.primitives[:1] + [
        HostPrimitive(shape=ShapeRecord(sphere=Sphere(object_to_world=Transform.translate([2.0 * i, 0.0, 0.0]),
                                                      radius=0.9)), material=m) for i, m in enumerate(mats)]
    return desc


def _ubers():
    """The gallery with uber spheres (uber.rs): glossy (Kd and Ks), full (Kr,
    Kt and opacity 0.7 beside them: a pass-through transmission and four
    opaque lobes scaled by opacity), half-opaque matte-like (Kd only, opacity
    0.5), and one under the Beckmann distribution with eta 1.33."""
    desc = spheres_gallery()
    const = lambda v: ("const", np.asarray(v, np.float64))  # noqa: E731
    glossy = {"Kd": const([0.5, 0.3, 0.2]), "Ks": const([0.3, 0.3, 0.3]), "roughness": ("const", 0.15)}
    mats = [
        HostMaterial(kind="uber", params=dict(glossy)),
        HostMaterial(kind="uber", params=dict(glossy, Kr=const([0.3, 0.3, 0.3]), Kt=const([0.2, 0.3, 0.4]),
                                              opacity=const([0.7, 0.7, 0.7]), eta=("const", 1.7))),
        HostMaterial(kind="uber", params={"Kd": const([0.6, 0.6, 0.5]), "Ks": const([0.0, 0.0, 0.0]),
                                          "opacity": const([0.5, 0.4, 0.5])}),
        HostMaterial(kind="uber", params=dict(glossy, distribution=("const", "beckmann"), eta=("const", 1.33),
                                              roughness=("const", 0.3))),
    ]
    desc.primitives = desc.primitives[:1] + [
        HostPrimitive(shape=ShapeRecord(sphere=Sphere(object_to_world=Transform.translate([2.0 * i, 0.0, 0.0]),
                                                      radius=0.9)), material=m) for i, m in enumerate(mats)]
    return desc


SCENES = {"area_box": area_box, "gallery": spheres_gallery, "variants": _variants, "uber": _ubers}


@pytest.fixture(scope="module", params=list(SCENES))
def lanes(request):
    """(port lobes, reference lobes, wo, wi, refl, u_lobe, u1, u2) over every
    material row of one scene."""
    desc = SCENES[request.param]()
    cs, ref = compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))
    M = cs.static.n_materials
    mat = np.repeat(np.arange(M), N)
    rs = np.random.RandomState(7)
    n = len(mat)

    def unit():
        v = rs.normal(size=(n, 3))
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)

    wo, wi = unit(), unit()
    refl = rs.uniform(size=n) < 0.7
    u = rs.uniform(0, 1, (3, n)).astype(np.float32)
    table = lobe_table(cs.arrays, cs.static)
    mine = make_bsdf(cs.arrays, cs.static, torch.as_tensor(mat), table)
    theirs = ref_make_bsdf(ref.arrays, ref.static, jnp.asarray(mat.astype(np.int32)), jnp.zeros((n, 2)),
                           jnp.zeros((n, 3)))
    return request.param, table, mine, theirs, wo, wi, refl, u


def test_make_bsdf_matches_reference(lanes):
    """The port keeps the slots that hold a lobe; they hold the reference's
    kinds and data, and the slots it drops hold none in the reference."""
    _name, table, mine, theirs, *_ = lanes
    kind_r, data_r = np.asarray(theirs["kind"]), np.asarray(theirs["data"])
    slots = [s for s in range(kind_r.shape[1]) if (kind_r[:, s] != 0).any()]
    assert len(table["possible"]) == len(slots) == mine["kind"].shape[1]
    np.testing.assert_array_equal(mine["kind"].numpy(), kind_r[:, slots])
    np.testing.assert_array_equal(mine["data"].numpy(), data_r[:, slots])
    assert not np.delete(kind_r, slots, axis=1).any()
    for s, p in zip(slots, table["possible"]):
        assert p == {int(k) for k in np.unique(kind_r[:, s]) if k} and p <= theirs["possible"][s]
    assert table["has_beckmann"] == bool(theirs.get("has_beckmann", False))


def _close(a, b, key):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6, err_msg=key)


def _close_but_few(a, b, key):
    """All but 0.1% of the lanes at rtol 1e-5, atol 1e-6; every lane at rtol 1e-3."""
    a, b = np.asarray(a), np.asarray(b)
    off = ~np.isclose(a, b, rtol=1e-5, atol=1e-6).reshape(len(a), -1).all(1)
    assert off.mean() <= 1e-3, (key, int(off.sum()))
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-6, err_msg=key)


def test_bsdf_f_and_pdf_match_reference(lanes):
    _name, _table, mine, theirs, wo, wi, refl, _u = lanes
    t = [torch.as_tensor(x) for x in (wo, wi)]
    j = [jnp.asarray(x) for x in (wo, wi)]
    f = bsdf.bsdf_f(mine, *t, torch.as_tensor(refl))
    f_r = ref_bsdf.bsdf_f(theirs, *j, jnp.asarray(refl))
    _close(f.numpy(), f_r, "f")
    assert (f.numpy() > 0).any()
    _close(bsdf.bsdf_pdf(mine, *t).numpy(), ref_bsdf.bsdf_pdf(theirs, *j), "pdf")


def test_bsdf_sample_matches_reference(lanes):
    _name, _table, mine, theirs, wo, _wi, _refl, u = lanes
    bs = bsdf.bsdf_sample(mine, torch.as_tensor(wo), *(torch.as_tensor(x) for x in u))
    bs_r = ref_bsdf.bsdf_sample(theirs, jnp.asarray(wo), *(jnp.asarray(x) for x in u))
    for key in ("specular", "valid"):
        np.testing.assert_array_equal(bs[key].numpy(), np.asarray(bs_r[key]), err_msg=key)
    valid = np.asarray(bs_r["valid"])
    assert valid.mean() > 0.3 and np.asarray(bs_r["specular"]).any()
    graze = np.abs(np.asarray(bs_r["wi"])[:, 2]) < 0.05
    for key in ("wi", "eta_scale", "abs_cos"):
        a, b = bs[key].numpy(), np.asarray(bs_r[key])
        _close(a[~graze], b[~graze], key)
        np.testing.assert_allclose(a[graze], b[graze], rtol=1e-5, atol=5e-5, err_msg=key)
    for key in ("f", "pdf"):
        _close_but_few(bs[key].numpy(), bs_r[key], key)


def test_textured_make_bsdf_matches_reference():
    """make_bsdf of a scene with textured parameters builds each lane's
    lobes from its texture values (imagemap Kd under EWA and trilinear
    filtering, a checkerboard, a mix driven by fbm, a scale of marble on a
    plastic Kd): kinds equal the reference's in every slot the port keeps,
    the other slots hold none in the reference, and the data agree at rtol
    1e-5, atol 1e-5 (texture values differ by ulps, tests/test_torch_texture.py).
    The possible sets cover each kept slot's kinds."""
    from pbrt_tpu_torch.device.texture import prepare_atlases
    from pbrt_tpu_torch.scenes import textured_room

    desc = textured_room(4, 48, 24, 12)
    cs, ref = compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))
    rs = np.random.RandomState(13)
    n = 4096
    mat = rs.randint(0, cs.static.n_materials, n)
    uv = rs.uniform(-1.0, 3.0, (n, 2)).astype(np.float32)
    p = rs.uniform(-4.0, 4.0, (n, 3)).astype(np.float32)
    dx = (rs.normal(size=(n, 2)) * 1e-2).astype(np.float32)
    dy = (rs.normal(size=(n, 2)) * 3e-3).astype(np.float32)
    table = lobe_table(cs.arrays, cs.static)
    assert table["textured"]
    mine = make_bsdf(cs.arrays, cs.static, torch.as_tensor(mat), table, *(torch.as_tensor(x) for x in (uv, p, dx, dy)),
                     prepare_atlases(cs.arrays, cs.static))
    theirs = ref_make_bsdf(ref.arrays, ref.static, jnp.asarray(mat.astype(np.int32)),
                           *(jnp.asarray(x) for x in (uv, p, dx, dy)))
    kind_r, data_r = np.asarray(theirs["kind"]), np.asarray(theirs["data"])
    slots = table["slots"]
    np.testing.assert_array_equal(mine["kind"].numpy(), kind_r[:, slots])
    assert not np.delete(kind_r, slots, axis=1).any()
    np.testing.assert_allclose(mine["data"].numpy(), data_r[:, slots], rtol=1e-5, atol=1e-5)
    for s, poss in zip(slots, table["possible"]):
        assert {int(k) for k in np.unique(kind_r[:, s]) if k} <= poss


def test_textured_uber_make_bsdf_matches_reference():
    """An uber material with a checkerboard Kd and an fbm-driven opacity:
    each lane's lobes from its texture values, as the reference builds
    them, at the tolerance of test_textured_make_bsdf_matches_reference."""
    from pbrt_tpu_torch.device.texture import prepare_atlases
    from pbrt_tpu_torch.scenes import _texture

    desc = _ubers()
    checker = _texture("checkerboard", tex1=("const", np.array([0.7, 0.6, 0.5])),
                       tex2=("const", np.array([0.2, 0.3, 0.4])), uscale=4.0, vscale=4.0)
    fbm = _texture("fbm", is_float=True, octaves=3)
    desc.primitives[2].material.params.update(Kd=("texture", checker), opacity=("texture", fbm))
    cs, ref = compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))
    rs = np.random.RandomState(14)
    n = 4096
    mat = rs.randint(0, cs.static.n_materials, n)
    uv = rs.uniform(-1.0, 3.0, (n, 2)).astype(np.float32)
    p = rs.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    table = lobe_table(cs.arrays, cs.static)
    assert table["textured"]
    mine = make_bsdf(cs.arrays, cs.static, torch.as_tensor(mat), table, torch.as_tensor(uv), torch.as_tensor(p),
                     None, None, prepare_atlases(cs.arrays, cs.static))
    theirs = ref_make_bsdf(ref.arrays, ref.static, jnp.asarray(mat.astype(np.int32)), jnp.asarray(uv), jnp.asarray(p))
    kind_r, data_r = np.asarray(theirs["kind"]), np.asarray(theirs["data"])
    slots = table["slots"]
    np.testing.assert_array_equal(mine["kind"].numpy(), kind_r[:, slots])
    assert not np.delete(kind_r, slots, axis=1).any() and 6 in slots
    np.testing.assert_allclose(mine["data"].numpy(), data_r[:, slots], rtol=1e-5, atol=1e-5)
