"""The port's substrate, translucent, disney, mix, fourier and hair
materials against the reference, on the CPU.

A brute scene holds one sphere (or the ground quad) per new material and
lobe variant: an anisotropic substrate, translucent with and without
transmission, disney with and without specular transmission, a mix of
plastic and copper, a mix whose first sub-material is itself a mix, a
rough-conductor fourier table and hair. 512 lanes per material row with
random (wo, wi, u, uv, p) from a numpy seed; the reference is called op by
op (no jit).

- make_bsdf, row gather (constant parameters): kinds and data equal the
  reference make_bsdf's bit for bit on the same uv and p, so the mix's
  per-hit choice (a hash of p's float bits and the row) and its color
  scale are the reference's, and a mix resolved to an inner mix has no
  lobe in either (ROADMAP C, a known fault of the reference, reproduced);
- make_bsdf with textured parameters (the substrate's Kd an imagemap, the
  mix amount a checkerboard, hair's color a checkerboard, so sigma_a is
  converted per hit): kinds equal, data within rtol 1e-5, atol 1e-5
  (texture values differ by ulps, tests/test_torch_texture.py);
- each new lobe kind's f, pdf and sample (one slot holding that kind, the
  lanes whose row has it) against pbrt_tpu.device.bsdf. Tolerances: the
  analytic kinds (LAMBERT_T, FRESNEL_BLEND, DISNEY_DIFF, CLEARCOAT) as
  tests/test_torch_bsdf.py states them (f and pdf at rtol 1e-5, atol 1e-6,
  CLEARCOAT's at rtol 1e-4: GTR1 cancels near its peak; a sample's f and
  pdf on all but 0.1% of the lanes, every lane within rtol 1e-3, where
  CLEARCOAT's samples, all at its steep peak, take rtol 1e-3); FOURIER
  and HAIR as tests/test_torch_fourier.py and
  tests/test_torch_hair.py state theirs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.device import bsdf as ref_bsdf
from pbrt_tpu.device.materials import make_bsdf as ref_make_bsdf
from pbrt_tpu.scene.builder import compile_scene as ref_compile_scene
from pbrt_tpu_torch.core.fourierbsdf import write_rough_conductor_table
from pbrt_tpu_torch.core.transform import Transform
from pbrt_tpu_torch.device import bsdf
from pbrt_tpu_torch.device.materials import lobe_table, make_bsdf
from pbrt_tpu_torch.scene.builder import compile_scene
from pbrt_tpu_torch.scene.host import HostMaterial, HostPrimitive, ShapeRecord, Sphere
from pbrt_tpu_torch.scenes import ZOO_DISNEY, _const, _texture, _tiles, spheres_gallery
from test_torch_megakernel import _to_ref
from torch_threads import one_torch_thread  # noqa: F401  (autouse: PyTorch single-threaded in this module)

N = 512


def zoo_gallery(table: str, textured: bool = False):
    """spheres_gallery with its ground and spheres re-dressed in the new
    materials (brute class: 11 prims)."""
    desc = spheres_gallery()
    disney = {k: ("const", np.asarray(v, np.float64)) for k, v in ZOO_DISNEY.items()}
    disney["remaproughness"] = ("const", False)
    plastic = HostMaterial(kind="plastic", params={"Kd": _const([0.2, 0.35, 0.6]), "Ks": _const([0.4, 0.4, 0.4])})
    copper = HostMaterial(kind="metal", params={"roughness": ("const", 0.08)})
    inner = HostMaterial(kind="mix", params={"amount": _const([0.5, 0.5, 0.5]), "material1": ("material", plastic),
                                             "material2": ("material", copper)})
    kd = _const([0.45, 0.35, 0.25])
    amount = _const([0.35, 0.35, 0.35])
    hair_params = {"eumelanin": ("const", 1.3)}
    if textured:
        checker = _texture("checkerboard", tex1=_const([0.2, 0.2, 0.2]), tex2=_const([0.8, 0.8, 0.8]),
                           uscale=4.0, vscale=4.0)
        kd = ("texture", _texture("imagemap", image=_tiles(32, np.random.RandomState(3))))
        amount = ("texture", checker)
        hair_params = {"color": ("texture", _texture("checkerboard", tex1=_const([0.3, 0.2, 0.1]),
                                                     tex2=_const([0.6, 0.5, 0.3]), uscale=2.0, vscale=2.0)),
                       "beta_n": ("const", 0.4)}
    mats = [
        HostMaterial(kind="translucent", params={"Kd": _const([0.6, 0.6, 0.5])}),
        HostMaterial(kind="translucent", params={"transmit": _const([0.0, 0.0, 0.0])}),
        HostMaterial(kind="disney", params=disney),
        HostMaterial(kind="disney", params=dict(disney, spectrans=("const", 0.4), speculartint=("const", 0.5),
                                                clearcoat=("const", 0.0))),
        HostMaterial(kind="mix", params={"amount": amount, "material1": ("material", plastic),
                                         "material2": ("material", copper)}),
        HostMaterial(kind="mix", params={"amount": _const([0.6, 0.6, 0.6]), "material1": ("material", inner),
                                         "material2": ("material", HostMaterial(kind="matte", params={}))}),
        HostMaterial(kind="fourier", params={"bsdffile": ("const", table), "Kd": _const([0.5, 0.5, 0.5])}),
        HostMaterial(kind="hair", params=hair_params),
    ]
    desc.primitives[0].material = HostMaterial(kind="substrate", params={
        "Kd": kd, "Ks": _const([0.25, 0.25, 0.25]), "uroughness": ("const", 0.05), "vroughness": ("const", 0.2)})
    desc.primitives = desc.primitives[:1] + [
        HostPrimitive(shape=ShapeRecord(sphere=Sphere(object_to_world=Transform.translate([2.0 * i - 7.0, 0.0, 0.0]),
                                                      radius=0.9)), material=m) for i, m in enumerate(mats)]
    return desc


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("zoo") / "rc.bsdf")
    write_rough_conductor_table(path, alpha=0.3, nmu=10)
    return path


def _lanes(cs, seed):
    M = cs.static.n_materials
    mat = np.repeat(np.arange(M), N)
    n = len(mat)
    rs = np.random.RandomState(seed)

    def unit():
        v = rs.normal(size=(n, 3))
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)

    return {"mat": mat, "wo": unit(), "wi": unit(), "refl": rs.uniform(size=n) < 0.6,
            "u": rs.uniform(0, 1, (3, n)).astype(np.float32), "uv": rs.uniform(-0.5, 1.5, (n, 2)).astype(np.float32),
            "p": rs.uniform(-4.0, 4.0, (n, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def gather(table):
    desc = zoo_gallery(table)
    cs, ref = compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))
    ln = _lanes(cs, 31)
    tbl = lobe_table(cs.arrays, cs.static)
    mine = make_bsdf(cs.arrays, cs.static, torch.as_tensor(ln["mat"]), tbl, torch.as_tensor(ln["uv"]),
                     torch.as_tensor(ln["p"]))
    theirs = ref_make_bsdf(ref.arrays, ref.static, jnp.asarray(ln["mat"].astype(np.int32)), jnp.asarray(ln["uv"]),
                           jnp.asarray(ln["p"]))
    return cs, tbl, mine, theirs, ln


def test_make_bsdf_row_gather_matches_reference_bit_for_bit(gather):
    cs, tbl, mine, theirs, ln = gather
    assert not tbl.get("textured")
    kind_r, data_r = np.asarray(theirs["kind"]), np.asarray(theirs["data"])
    slots = tbl["slots"]
    np.testing.assert_array_equal(mine["kind"].numpy(), kind_r[:, slots])
    np.testing.assert_array_equal(mine["data"].numpy(), data_r[:, slots])
    assert not np.delete(kind_r, slots, axis=1).any()
    for s, p in zip(slots, tbl["possible"]):
        assert p <= theirs["possible"][s]
    assert set(mine["fourier"]) == set(theirs["fourier"]) and mine["has_schlick"]
    # the mixes: both sub-rows taken; a lane resolved to the inner mix is black
    kinds = cs.arrays.mat_kind.numpy()
    const = cs.arrays.mat_const.numpy()
    for m in np.nonzero(kinds == 10)[0]:
        lanes = ln["mat"] == m
        sub1, sub2 = const[m, 12, :2].astype(int)
        if kinds[sub1] == 10:
            black = ~(kind_r[lanes] != 0).any(1)
            assert 0.3 < black.mean() < 0.9
        else:
            assert len({tuple(r) for r in kind_r[lanes]}) == 2


def test_make_bsdf_textured_matches_reference(table):
    from pbrt_tpu_torch.device.texture import prepare_atlases

    desc = zoo_gallery(table, textured=True)
    cs, ref = compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))
    ln = _lanes(cs, 32)
    tbl = lobe_table(cs.arrays, cs.static)
    assert tbl["textured"]
    mine = make_bsdf(cs.arrays, cs.static, torch.as_tensor(ln["mat"]), tbl, torch.as_tensor(ln["uv"]),
                     torch.as_tensor(ln["p"]), None, None, prepare_atlases(cs.arrays, cs.static))
    theirs = ref_make_bsdf(ref.arrays, ref.static, jnp.asarray(ln["mat"].astype(np.int32)), jnp.asarray(ln["uv"]),
                           jnp.asarray(ln["p"]))
    kind_r, data_r = np.asarray(theirs["kind"]), np.asarray(theirs["data"])
    slots = tbl["slots"]
    np.testing.assert_array_equal(mine["kind"].numpy(), kind_r[:, slots])
    assert not np.delete(kind_r, slots, axis=1).any()
    np.testing.assert_allclose(mine["data"].numpy(), data_r[:, slots], rtol=1e-5, atol=1e-5)
    for s, poss in zip(slots, tbl["possible"]):
        assert {int(k) for k in np.unique(kind_r[:, s]) if k} <= poss
    hair = ln["mat"] == int(np.nonzero(cs.arrays.mat_kind.numpy() == 14)[0][0])
    assert len(np.unique(data_r[hair, 0, 0])) == 2  # sigma_a of both checker cells, converted per hit


LOBE_KINDS = {"lambert_t": 2, "fresnel_blend": 9, "disney_diff": 10, "clearcoat": 11, "fourier": 12, "hair": 13}


def _one_slot(lobes, s, lanes, kind, extras):
    return {"kind": lobes["kind"][lanes, s:s + 1], "data": lobes["data"][lanes, s:s + 1],
            "possible": (frozenset({kind}),), **extras}


def _close_but_few(a, b, key):
    a, b = np.asarray(a), np.asarray(b)
    off = ~np.isclose(a, b, rtol=1e-5, atol=1e-6).reshape(len(a), -1).all(1)
    assert off.mean() <= 1e-3, (key, int(off.sum()))
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("name", list(LOBE_KINDS))
def test_lobe_kind_matches_reference(gather, name):
    kind = LOBE_KINDS[name]
    _cs, tbl, mine, theirs, ln = gather
    kind_r = np.asarray(theirs["kind"])
    s_ref = int(np.nonzero((kind_r == kind).any(0))[0][0])
    s = tbl["slots"].index(s_ref)
    lanes = np.nonzero(kind_r[:, s_ref] == kind)[0]
    assert len(lanes) >= N // 2
    lt = torch.as_tensor(lanes)
    extras = {k: mine[k] for k in ("fourier", "has_schlick") if k in mine}
    a = _one_slot(mine, s, lt, kind, extras)
    b = _one_slot({k: np.asarray(v) for k, v in theirs.items() if k in ("kind", "data")}, s_ref, lanes, kind,
                  {"fourier": theirs.get("fourier")})
    b = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in b.items()}
    wo, wi, refl = ln["wo"][lanes], ln["wi"][lanes], ln["refl"][lanes]
    u = ln["u"][:, lanes]
    f = bsdf.bsdf_f(a, torch.as_tensor(wo), torch.as_tensor(wi), torch.as_tensor(refl)).numpy()
    f_r = np.asarray(ref_bsdf.bsdf_f(b, jnp.asarray(wo), jnp.asarray(wi), jnp.asarray(refl)))
    p = bsdf.bsdf_pdf(a, torch.as_tensor(wo), torch.as_tensor(wi)).numpy()
    p_r = np.asarray(ref_bsdf.bsdf_pdf(b, jnp.asarray(wo), jnp.asarray(wi)))
    assert (f_r > 0).any(1).mean() > 0.2
    bs = bsdf.bsdf_sample(a, torch.as_tensor(wo), *(torch.as_tensor(x) for x in u))
    bs_r = ref_bsdf.bsdf_sample(b, jnp.asarray(wo), *(jnp.asarray(x) for x in u))
    valid = np.asarray(bs_r["valid"])
    np.testing.assert_array_equal(bs["valid"].numpy(), valid)
    np.testing.assert_array_equal(bs["specular"].numpy(), np.asarray(bs_r["specular"]))
    assert valid.mean() > 0.3
    wi_s, wi_r = bs["wi"].numpy()[valid], np.asarray(bs_r["wi"])[valid]
    if name == "fourier":
        for x, y, key in ((f, f_r, "f"), (p, p_r, "pdf")):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-5 * np.abs(y).max(), err_msg=key)
        np.testing.assert_allclose(wi_s, wi_r, rtol=0, atol=2e-4)
        for key, rtol in (("pdf", 2e-3), ("f", 5e-3)):
            y = np.asarray(bs_r[key])
            np.testing.assert_allclose(bs[key].numpy(), y, rtol=rtol, atol=1e-5 * np.abs(y).max(), err_msg=key)
        return
    if name == "hair":
        for x, y, key in ((f, f_r, "f"), (p, p_r, "pdf"), (bs["f"].numpy(), bs_r["f"], "sample f"),
                          (bs["pdf"].numpy(), bs_r["pdf"], "sample pdf")):
            y = np.asarray(y)
            np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-6 * np.abs(y).max(), err_msg=key)
        np.testing.assert_allclose(wi_s, wi_r, rtol=0, atol=1e-4)
        return
    # GTR1's denominator 1 - (1 - a2) cos^2(theta_h) cancels to ~a2 at its
    # peak, which carries the half vector's ulps to ~3e-5 relative
    rtol = 1e-4 if name == "clearcoat" else 1e-5
    np.testing.assert_allclose(f, f_r, rtol=rtol, atol=1e-6, err_msg="f")
    np.testing.assert_allclose(p, p_r, rtol=rtol, atol=1e-6, err_msg="pdf")
    graze = np.abs(wi_r[:, 2]) < 0.05
    np.testing.assert_allclose(wi_s[~graze], wi_r[~graze], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(wi_s[graze], wi_r[graze], rtol=1e-5, atol=5e-5)
    for key in ("f", "pdf"):
        if name == "clearcoat":
            # a sampled half vector sits at GTR1's peak (alpha 0.0208 here),
            # where the directions' 1e-7 differences move f and pdf by up to
            # 4.4e-4 relative
            np.testing.assert_allclose(bs[key].numpy(), bs_r[key], rtol=1e-3, atol=1e-6, err_msg=key)
        else:
            _close_but_few(bs[key].numpy(), bs_r[key], key)
