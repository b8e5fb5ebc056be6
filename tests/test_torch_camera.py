"""The orthographic and environment cameras of the port against the
reference's, on the CPU: make_camera's matrices, generate_rays and
ray_differential_dirs on raster positions and lens samples from a numpy
seed, and camera_room's tables (material_room(checker=True) under each
camera; the environment one with quadric_room's alpha panel) bit for bit.

The reference's differentials carry directions only, so an orthographic
camera's offset rays share the main ray's direction and its texture
footprint is zero (ROADMAP C); the port keeps that.
"""
from dataclasses import fields

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.device import camera as ref_camera
from pbrt_tpu.scene.builder import compile_scene as ref_compile_scene
from pbrt_tpu_torch import render, scenes
from pbrt_tpu_torch.device import camera
from pbrt_tpu_torch.scene.arrays import HOPPER_TABLES, SceneTensors
from pbrt_tpu_torch.scene.builder import compile_scene
from test_torch_megakernel import _to_ref
from torch_threads import one_torch_thread  # noqa: F401  (autouse: PyTorch single-threaded in this module)


@pytest.mark.parametrize("kind", ["orthographic", "environment"])
def test_camera_rays_match_reference(kind):
    """Rays within 2 ulps of the reference's (the environment camera's sin
    and cos round differently in the two packages: 1e-6), differentials
    likewise; the orthographic camera's directions are all its axis and
    its differentials equal them."""
    desc = scenes.camera_room(kind, 4)
    cam = camera.make_camera(desc.camera, desc.film, "cpu")
    ref_desc = _to_ref(desc)
    cam_r = ref_camera.make_camera(ref_desc.camera, ref_desc.film)
    assert cam["kind"] == cam_r["kind"] == camera.KINDS[kind]
    np.testing.assert_array_equal(cam["raster_to_camera"].numpy(), np.asarray(cam_r["raster_to_camera"]))
    rs = np.random.RandomState(2)
    n = 4096
    px = rs.uniform(0, desc.film.x_resolution, n).astype(np.float32)
    py = rs.uniform(0, desc.film.y_resolution, n).astype(np.float32)
    u1, u2 = (rs.rand(n).astype(np.float32) for _ in range(2))
    o, d = camera.generate_rays(cam, *(torch.as_tensor(x) for x in (px, py, u1, u2)))
    o_r, d_r = ref_camera.generate_rays(cam_r, *(jnp.asarray(x) for x in (px, py, u1, u2)))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_r), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_r), rtol=1e-6, atol=1e-6)
    dx, dy = camera.ray_differential_dirs(cam, torch.as_tensor(px), torch.as_tensor(py))
    dx_r, dy_r = ref_camera.ray_differential_dirs(cam_r, jnp.asarray(px), jnp.asarray(py))
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_r), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dy.numpy(), np.asarray(dy_r), rtol=1e-6, atol=1e-6)
    if kind == "orthographic":
        assert np.ptp(d.numpy(), axis=0).max() < 1e-6 and np.array_equal(dx.numpy(), d.numpy())
        assert np.ptp(o.numpy(), axis=0).max() > 1.0
    else:
        assert np.ptp(o.numpy(), axis=0).max() == 0.0 and d.numpy()[:, 1].min() < -0.9 < 0.9 < d.numpy()[:, 1].max()


@pytest.mark.parametrize("kind", ["orthographic", "environment"])
def test_camera_room_tables_and_route(kind, monkeypatch):
    """camera_room's tables equal the reference's bit for bit; the
    wavefront takes it through the wide tables (B1 on the card) and both
    megakernels refuse its camera by name."""
    from pbrt_tpu_torch.device import megakernel, megakernel_wide

    desc = scenes.camera_room(kind, 4)
    cs, ref = compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))
    for f in fields(SceneTensors):
        if f.name in HOPPER_TABLES:
            continue
        a, b = getattr(cs.arrays, f.name), getattr(ref.arrays, f.name)
        assert (a is None) == (b is None), f.name
        if isinstance(a, dict):
            assert a.keys() == b.keys() and all(np.array_equal(a[k].numpy(), np.asarray(b[k])) for k in a), f.name
        elif a is not None:
            assert np.array_equal(a.numpy(), np.asarray(b), equal_nan=True), f.name
    assert cs.static.has_wide and cs.static.has_alpha == (kind == "environment")
    monkeypatch.setenv("PBRT_TPU_WIDEMEGA", "1")
    render.make_persistent_fn(cs)
    assert render.LAST_PERSISTENT_TIER == "torch-wavefront/plain-wide"
    cam = camera.make_camera(desc.camera, desc.film, "cpu")
    icfg = {"kind": "path", "max_depth": 5, "rr_threshold": 1.0, "light_strategy": "power", "strategy": "all"}
    scfg = {"kind": desc.sampler.kind, "spp": desc.sampler.pixel_samples}
    fcfg = {"filter": "box", "filter_params": {}, "max_sample_luminance": float("inf")}
    assert megakernel.explain_ineligible(cs, cam, icfg, scfg, fcfg) == f"'{kind}' cameras"
    assert megakernel_wide.explain_ineligible_wide(cs, cam, icfg, scfg, fcfg, 100_000) == f"'{kind}' cameras"
