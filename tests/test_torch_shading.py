"""The port's shading, BSDF and light modules against the reference's.

Both sides read the reference's tables of the 770-prim mesh room (the port
through scene_tensors_from_numpy) and the same hits and random numbers,
made with numpy from a seed. Results agree within rtol 1e-5, atol 1e-6
(float32 math in the same order; the atol covers components near zero).
"""
from dataclasses import fields

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from pbrt_tpu.device import bsdf as ref_bsdf
from pbrt_tpu.device import lights as ref_lights
from pbrt_tpu.device.materials import make_bsdf as ref_make_bsdf
from pbrt_tpu.device.shading import surface_interaction as ref_surface_interaction
from pbrt_tpu.scene.builder import compile_scene as ref_compile_scene
from pbrt_tpu_torch.device import bsdf, lights
from pbrt_tpu_torch.device.intersect import intersect
from pbrt_tpu_torch.device.materials import make_bsdf
from pbrt_tpu_torch.device.shading import surface_interaction
from pbrt_tpu_torch.scene.arrays import scene_tensors_from_numpy
from torch_threads import one_torch_thread  # noqa: F401  (autouse: PyTorch single-threaded in this module)

RTOL, ATOL = 1e-5, 1e-6
R = 512


def _close(port, ref):
    np.testing.assert_allclose(port.numpy() if torch.is_tensor(port) else port, np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def setup():
    ref = ref_compile_scene(bench._mesh_scene(8))
    sa, st = scene_tensors_from_numpy({f.name: getattr(ref.arrays, f.name) for f in fields(ref.arrays)},
                                      {f.name: getattr(ref.static, f.name) for f in fields(ref.static)}, "cpu")
    rs = np.random.RandomState(11)
    # rays from inside the room in all directions: floor, walls, ceiling, panel
    o = np.stack([rs.uniform(-3, 3, R), rs.uniform(0.5, 3.0, R), rs.uniform(-3, 3, R)], -1).astype(np.float32)
    d = rs.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    hit = intersect(sa, st, torch.as_tensor(o), torch.as_tensor(d), torch.full((R,), np.inf))
    u = rs.uniform(0, 1, (4, R)).astype(np.float32)
    return ref, sa, st, o, d, hit, u


def _ref_hit(hit):
    return {k: jnp.asarray(v.numpy().astype(np.int32 if k == "prim" else np.float32)) for k, v in hit.items()}


def test_surface_interaction(setup):
    ref, sa, _st, o, d, hit, _u = setup
    assert bool((hit["prim"] >= 0).all())
    si = surface_interaction(sa, hit, torch.as_tensor(o), torch.as_tensor(d))
    si_r = ref_surface_interaction(ref.arrays, _ref_hit(hit), jnp.asarray(o), jnp.asarray(d))
    for k in ("p", "p_err", "ng", "ns", "uv", "ss", "ts", "dpdu", "dpdv", "wo"):
        _close(si[k], si_r[k])
    for k in ("valid", "mat", "light", "prim"):
        np.testing.assert_array_equal(si[k].numpy(), np.asarray(si_r[k]))
    assert (si["light"] >= 0).any()


def test_bsdf(setup):
    ref, sa, st, o, d, hit, u = setup
    si = surface_interaction(sa, hit, torch.as_tensor(o), torch.as_tensor(d))
    si_r = ref_surface_interaction(ref.arrays, _ref_hit(hit), jnp.asarray(o), jnp.asarray(d))
    lobes = make_bsdf(sa, st, si["mat"])
    lobes_r = ref_make_bsdf(ref.arrays, ref.static, si_r["mat"], si_r["uv"], si_r["p"])
    # matte only: the port keeps slot 0, the one slot the reference fills
    assert lobes["possible"] == (frozenset({bsdf.LOBE_LAMBERT_R}),)
    np.testing.assert_array_equal(lobes["kind"].numpy(), np.asarray(lobes_r["kind"][:, :1]))
    assert not np.asarray(lobes_r["kind"][:, 1:]).any()
    np.testing.assert_array_equal(lobes["data"].numpy(), np.asarray(lobes_r["data"][:, :1]))
    assert (lobes["kind"] == 0).any() and (lobes["kind"] == 1).any()  # black panel and matte

    # local-frame directions on both hemispheres
    wo = torch.as_tensor(np.stack([u[0] - 0.5, u[1] - 0.5, u[2] - 0.5], -1))
    wo = wo / torch.linalg.norm(wo, dim=-1, keepdim=True)
    bs = bsdf.bsdf_sample(lobes, wo, torch.as_tensor(u[3]), torch.as_tensor(u[0]), torch.as_tensor(u[1]))
    bs_r = ref_bsdf.bsdf_sample(lobes_r, jnp.asarray(wo.numpy()), jnp.asarray(u[3]), jnp.asarray(u[0]),
                                jnp.asarray(u[1]))
    for k in ("wi", "f", "pdf", "eta_scale", "abs_cos"):
        _close(bs[k], bs_r[k])
    for k in ("valid", "specular"):
        np.testing.assert_array_equal(bs[k].numpy(), np.asarray(bs_r[k]))
    wi = torch.flip(wo, dims=[0])
    refl = bsdf.same_hemisphere(wo, wi)
    _close(bsdf.bsdf_f(lobes, wo, wi, refl),
           ref_bsdf.bsdf_f(lobes_r, jnp.asarray(wo.numpy()), jnp.asarray(wi.numpy()), jnp.asarray(refl.numpy())))
    _close(bsdf.bsdf_pdf(lobes, wo, wi), ref_bsdf.bsdf_pdf(lobes_r, jnp.asarray(wo.numpy()), jnp.asarray(wi.numpy())))
    np.testing.assert_array_equal(bsdf.num_lobes(lobes).numpy(), np.asarray(ref_bsdf.num_lobes(lobes_r)))


def test_lights(setup):
    ref, sa, st, o, d, hit, u = setup
    si = surface_interaction(sa, hit, torch.as_tensor(o), torch.as_tensor(d))
    p = si["p"]
    lid = torch.as_tensor(np.arange(R) % st.n_lights)
    ls = lights.sample_li(sa, st, lid, p, torch.as_tensor(u[0]), torch.as_tensor(u[1]))
    ls_r = ref_lights.sample_li(ref.arrays, ref.static, jnp.asarray(lid.numpy().astype(np.int32)),
                                jnp.asarray(p.numpy()), jnp.asarray(u[0]), jnp.asarray(u[1]))
    for k in ("wi", "li", "pdf", "dist", "n", "area"):
        _close(ls[k], ls_r[k])
    assert not bool(ls["delta"].any()) and not np.asarray(ls_r["delta"]).any()

    light = si["light"]
    _close(lights.area_light_emission(sa, light, si["ng"], si["wo"]),
           ref_lights.area_light_emission(ref.arrays, jnp.asarray(light.numpy()), jnp.asarray(si["ng"].numpy()),
                                          jnp.asarray(si["wo"].numpy())))
    area = sa.prim_area[si["prim"]]
    p_ref = torch.as_tensor(o)
    _close(lights.pdf_li_area_hit(sa, p_ref, p, si["ng"], light, area),
           ref_lights.pdf_li_area_hit(ref.arrays, jnp.asarray(o), jnp.asarray(p.numpy()),
                                      jnp.asarray(si["ng"].numpy()), jnp.asarray(light.numpy()),
                                      jnp.asarray(area.numpy())))
    _close(lights.compute_power(sa, st), ref_lights.compute_power(ref.arrays, ref.static))


@pytest.fixture(scope="module")
def textured():
    """A small textured_room (imagemaps with MIP pyramids, a bump map) in
    both packages, and the camera rays of 512 seeded pixels with their
    +1-pixel differentials, traced to their first hits."""
    from pbrt_tpu_torch.device.camera import generate_rays, make_camera, ray_differential_dirs
    from pbrt_tpu_torch.scene.builder import compile_scene
    from pbrt_tpu_torch.scenes import textured_room
    from test_torch_megakernel import _to_ref

    desc = textured_room(4, 48, 24, 32)
    cs, ref = compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))
    cam = make_camera(desc.camera, desc.film, "cpu")
    rs = np.random.RandomState(5)
    px = torch.as_tensor(rs.uniform(0, 1000, R).astype(np.float32))
    py = torch.as_tensor(rs.uniform(0, 500, R).astype(np.float32))
    zeros = torch.zeros(R)
    o, d = generate_rays(cam, px, py, zeros, zeros)
    ddx, ddy = ray_differential_dirs(cam, px, py)
    hit = intersect(cs.arrays, cs.static, o, d, torch.full((R,), np.inf))
    si = surface_interaction(cs.arrays, hit, o, d)
    si_r = ref_surface_interaction(ref.arrays, _ref_hit(hit), jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    return cs, ref, o, d, ddx, ddy, si, si_r


def test_ray_differentials_and_duv(textured):
    """The camera's offset-ray directions and the uv footprint each hit
    derives from them (integrator._compute_duv) agree with the reference's."""
    from pbrt_tpu.device.camera import make_camera as ref_make_camera, ray_differential_dirs as ref_dirs
    from pbrt_tpu.device.integrator import _compute_duv as ref_compute_duv
    from pbrt_tpu_torch.device.integrator import _compute_duv

    cs, ref, o, d, ddx, ddy, si, si_r = textured
    desc = ref.description
    # the same film points as the fixture's draw
    rs = np.random.RandomState(5)
    px, py = rs.uniform(0, 1000, R).astype(np.float32), rs.uniform(0, 500, R).astype(np.float32)
    ref_dx, ref_dy = ref_dirs(ref_make_camera(desc.camera, desc.film), jnp.asarray(px), jnp.asarray(py))
    _close(ddx, ref_dx)
    _close(ddy, ref_dy)
    for dd in (ddx, ddy):
        got = _compute_duv(si, o, d, dd)
        want = ref_compute_duv(si_r, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jnp.asarray(dd.numpy()))
        # the solve divides by small determinants: rtol 1e-4 (ulps of the hit amplified)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-7)
        assert float(got.abs().max()) > 0
    zero = _compute_duv(si, o, d, torch.zeros_like(d))  # bounced rays carry no differentials
    assert not bool(zero.any())


def test_apply_bump(textured):
    """The bump-mapped shading frame (the left wall's brick height map):
    ns, ss and ts agree with the reference's; lanes without a bump map keep
    their frame. The port evaluates the bump textures only."""
    from pbrt_tpu.device.shading import apply_bump as ref_apply_bump
    from pbrt_tpu_torch.device.shading import apply_bump

    cs, ref, _o, _d, _ddx, _ddy, si, si_r = textured
    got = apply_bump(cs.arrays, cs.static, si)
    want = ref_apply_bump(ref.arrays, ref.static, si_r)
    bumped = cs.arrays.mat_bump[si["mat"]] >= 0
    assert 0 < int(bumped.sum()) < R
    for k in ("ns", "ss", "ts"):
        # finite differences over du = 0.0005 amplify ulps of the height lookups
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=2e-5, err_msg=k)
        assert torch.equal(got[k][~bumped], si[k][~bumped]), k
    assert float((got["ns"][bumped] - si["ns"][bumped]).abs().max()) > 1e-3
