"""The whole ported slice against the reference: the persistent path tracer
on the 770-prim mesh room at 24x16, 4 spp, depth 5, seed 3.

The reference runs its own make_persistent_fn on the CPU (its default CPU
route is the XLA packet traversal, which tests/test_widebvh.py holds equal
to the Pallas kernel); the port runs its plain-PyTorch route. The sample
streams are identical, so accL/accW agree within tests/test_persistent.py's
tier tolerance (rtol 2e-4, atol 2e-4) and the path-vertex counts within 1e-3.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from pbrt_tpu import render as ref_render
from pbrt_tpu.scene.builder import compile_scene as ref_compile_scene
from pbrt_tpu_torch import render
from pbrt_tpu_torch.scene.builder import CompiledScene, compile_scene
from pbrt_tpu_torch.scenes import mesh_room

W, H, SPP, SEED = 24, 16, 4, 3


def _small(desc):
    desc.film.x_resolution, desc.film.y_resolution = W, H
    desc.sampler.pixel_samples = SPP
    return desc


@pytest.fixture(scope="module")
def port_scene():
    return compile_scene(_small(mesh_room(8)), "cpu")


def _pixels():
    ys, xs = np.mgrid[0:H, 0:W]
    return xs.ravel(), ys.ravel(), (ys * W + xs).ravel()


def test_persistent_matches_reference(port_scene):
    ref = ref_compile_scene(_small(bench._mesh_scene(8)))
    px, py, pids = _pixels()
    wave_r = ref_render.make_persistent_fn(ref)
    assert ref_render.LAST_PERSISTENT_TIER.startswith("xla-wavefront")
    L_r, w_r, nv_r = (np.asarray(x) for x in wave_r(
        ref.arrays, jnp.asarray(px.astype(np.int32)), jnp.asarray(py.astype(np.int32)),
        jnp.asarray(pids.astype(np.uint32)), jnp.uint32(0), SPP, jnp.uint32(SEED)))

    wave = render.make_persistent_fn(port_scene)
    assert render.LAST_PERSISTENT_TIER == "torch-wavefront/plain-wide"
    t = [torch.as_tensor(x.astype(np.int64)) for x in (px, py, pids)]
    L, w, nv = (x.numpy() for x in wave(port_scene.arrays, *t, 0, SPP, SEED))

    assert L_r.mean() > 0.1
    np.testing.assert_allclose(w, w_r, atol=1e-5)
    assert abs(float(nv.sum()) - float(nv_r.sum())) < 1e-3
    np.testing.assert_allclose(L, L_r, rtol=2e-4, atol=2e-4)


def test_render_compiled_crop_and_scale(port_scene):
    """A pixelbounds crop renders exactly the full render's pixels there, and
    film scale multiplies the image."""
    full = render.render_compiled(port_scene, seed=SEED)
    assert full.shape == (H, W, 3) and np.isfinite(full).all() and full.mean() > 0
    timing = render.render_compiled.last_timing
    assert timing["tier"] == "torch-wavefront/plain-wide" and timing["n_vertices"] > W * H * SPP

    desc = port_scene.description
    crop = dataclasses.replace(desc, integrator=dataclasses.replace(desc.integrator, pixel_bounds=(5, 17, 3, 11)),
                               film=dataclasses.replace(desc.film, scale=2.0))
    img = render.render_compiled(CompiledScene(port_scene.arrays, port_scene.static, crop), seed=SEED)
    np.testing.assert_allclose(img[3:11, 5:17], 2.0 * full[3:11, 5:17], rtol=1e-6, atol=1e-7)
    assert not img[:3].any() and not img[:, 17:].any()


def test_integrator_helpers_match_reference():
    """Ray-origin offsetting (one-ulp bump past the error bound) and the MIS
    power heuristic, on numpy inputs from a seed."""
    from pbrt_tpu.device import integrator as ref_integrator
    from pbrt_tpu_torch.device import integrator

    rs = np.random.RandomState(2)
    n = 512
    p = (rs.normal(size=(n, 3)) * 3).astype(np.float32)
    p[:16] = 0.0  # zero components step to the smallest normal
    ng = rs.normal(size=(n, 3)).astype(np.float32)
    ng /= np.linalg.norm(ng, axis=1, keepdims=True)
    w = rs.normal(size=(n, 3)).astype(np.float32)
    p_err = (np.abs(rs.normal(size=(n, 3))) * 1e-6).astype(np.float32)
    got = integrator._offset_ray(*(torch.as_tensor(x) for x in (p, ng, w, p_err))).numpy()
    ref = np.asarray(ref_integrator._offset_ray(*(jnp.asarray(x) for x in (p, ng, w, p_err))))
    np.testing.assert_array_max_ulp(got, ref, maxulp=2)
    assert (got != p).all()

    a = rs.uniform(0, 5, n).astype(np.float32)
    b = rs.uniform(0, 5, n).astype(np.float32)
    a[:8] = 0.0
    np.testing.assert_allclose(
        integrator.power_heuristic(1.0, torch.as_tensor(a), 1.0, torch.as_tensor(b)).numpy(),
        np.asarray(ref_integrator.power_heuristic(1.0, jnp.asarray(a), 1.0, jnp.asarray(b))),
        rtol=1e-6, atol=0)


@pytest.mark.parametrize("widemega", [None, "1"])
def test_spatial_light_strategy_refused_when_the_route_is_built(monkeypatch, widemega):
    """pbrt's default light strategy, 'spatial', over the room's two panel
    lights: no route of the port renders it, so make_persistent_fn raises
    naming the strategy (and, under PBRT_TPU_WIDEMEGA=1, the wide
    megakernel's own reason) before it records a route. With one light the
    strategy is the uniform selector, and the wavefront renders it."""
    if widemega is None:
        monkeypatch.delenv("PBRT_TPU_WIDEMEGA", raising=False)
    else:
        monkeypatch.setenv("PBRT_TPU_WIDEMEGA", widemega)
    desc = _small(mesh_room(8))
    desc.integrator.light_strategy = "spatial"
    cs = compile_scene(desc, "cpu")
    assert cs.static.n_lights == 2 and not desc.lights  # both lights ride the panel's triangles
    monkeypatch.setattr(render, "LAST_PERSISTENT_TIER", "unbuilt")
    with pytest.raises(NotImplementedError, match="'spatial' light distribution") as err:
        render.make_persistent_fn(cs)
    assert render.LAST_PERSISTENT_TIER == "unbuilt"
    if widemega:
        assert "the wide megakernel (PBRT_TPU_WIDEMEGA=1) does not take the 'spatial' light" in str(err.value)

    panel = desc.primitives[-1].shape.mesh
    panel.indices = panel.indices[:1]  # one emitting triangle: one light
    one = compile_scene(desc, "cpu")
    assert one.static.n_lights == 1
    wave = render.make_persistent_fn(one)
    assert render.LAST_PERSISTENT_TIER == ("torch-megakernel/plain-wide" if widemega else "torch-wavefront/plain-wide")
    px, py, pids = (torch.as_tensor(x[:8].astype(np.int64)) for x in _pixels())
    L, w, _nv = wave(one.arrays, px, py, pids, 0, 1, SEED)
    assert torch.isfinite(L).all() and torch.equal(w, torch.ones(8))
