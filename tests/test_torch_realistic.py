"""The realistic camera in the port, against the reference.

- the lens file scenes.write_lens writes reads back (load_lens_file) as
  the reference reads it, the lens system (meters, the stop's aperture)
  and its focusing (the film offset of 1,300 trials) equal: the camera's
  film z, element tables and film extent equal as Python floats;
- the exit pupil (64 radial buckets of a 32 x 32 lattice over the rear
  element): every bucket's bounds equal the reference's bit for bit (the
  same lattice points get through in both packages' traces here; an ulp
  of difference at a point on an aperture's rim would move one bound by a
  lattice step);
- realistic_generate_rays on 4,096 random film and lens samples against the
  reference's, with the reference's pupil table in both, so that the
  inputs are bit-equal: origins and directions within 2e-6, the vignetting
  weights within 1e-6 relative, the same rays vignetted;
- an unreadable lens file: the reference's warning and the built-in lens;
- the per-sample wave of the mesh room (6 sides) under the realistic
  camera, 16 x 12, depth 2, against the reference's make_wave_fn: the
  filter weights and path vertices equal, the radiance (the vignetting
  weight on it) within rtol 1e-4, atol 1e-5.
"""
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu import render as ref_render
from pbrt_tpu.device import camera as ref_camera
from pbrt_tpu.device import realistic as ref_realistic
from pbrt_tpu.scene.builder import compile_scene as ref_compile_scene
from pbrt_tpu_torch import render, scenes
from pbrt_tpu_torch.device import camera, realistic
from pbrt_tpu_torch.scene.builder import compile_scene
from test_torch_megakernel import _to_ref
from torch_threads import one_torch_thread  # noqa: F401  (autouse: PyTorch single-threaded in this module)


@pytest.fixture(scope="module")
def cams(tmp_path_factory):
    desc = scenes.realistic_mesh_room(6, lens_dir=str(tmp_path_factory.mktemp("lens")))
    cam = camera.make_camera(desc.camera, desc.film, "cpu")
    cam_r = ref_camera.make_camera(_to_ref(desc.camera), _to_ref(desc.film))
    return desc, cam, cam_r


def test_lens_system_matches_reference(cams):
    desc, cam, cam_r = cams
    rows = realistic.load_lens_file(desc.camera.lens_file)
    assert rows == ref_realistic.load_lens_file(desc.camera.lens_file) == realistic.DEFAULT_LENS
    lens, lens_r = realistic.LensSystem(rows, 4.0), ref_realistic.LensSystem(rows, 4.0)
    for key in ("curvature", "thickness", "eta", "aperture_r"):
        assert getattr(lens, key) == getattr(lens_r, key), key
    rc, rc_r = cam["realistic"], cam_r["realistic"]
    for key in ("curvature", "elem_z", "eta", "aperture_r", "n_elements", "film_z", "rear_r", "rear_z",
                "film_extent"):
        assert rc[key] == rc_r[key], key
    assert cam["kind"] == camera.CAM_REALISTIC and cam["realistic"]["pupil_bounds"].shape == (64, 4)


def test_exit_pupil_matches_reference(cams):
    _desc, cam, cam_r = cams
    mine, theirs = cam["realistic"]["pupil_bounds"].numpy(), np.asarray(cam_r["realistic"]["pupil_bounds"])
    np.testing.assert_array_equal(mine, theirs)
    # the pupil narrows toward the film's corner (vignetting)
    area = (mine[:, 1] - mine[:, 0]) * (mine[:, 3] - mine[:, 2])
    assert area[-1] < area[0]


def test_realistic_rays_match_reference(cams):
    _desc, cam, cam_r = cams
    rcam = dict(cam["realistic"], pupil_bounds=torch.as_tensor(np.array(cam_r["realistic"]["pupil_bounds"])))
    rs = np.random.RandomState(4)
    n = 4096
    W, H = cam["resolution"]
    args = [rs.uniform(0, W, n), rs.uniform(0, H, n), rs.uniform(0, 1, n), rs.uniform(0, 1, n)]
    args = [a.astype(np.float32) for a in args]
    o, d, w = realistic.realistic_generate_rays(cam, rcam, *(torch.as_tensor(a) for a in args))
    o_r, d_r, w_r = jax.jit(lambda *a: ref_realistic.realistic_generate_rays(cam_r, cam_r["realistic"], *a))(
        *(jnp.asarray(a) for a in args))
    w_r = np.asarray(w_r)
    np.testing.assert_array_equal(w.numpy() > 0, w_r > 0)
    assert 0.3 < (w_r > 0).mean() < 1.0
    np.testing.assert_allclose(w.numpy(), w_r, rtol=1e-6, atol=1e-7)
    ok = w_r > 0
    np.testing.assert_allclose(o.numpy()[ok], np.asarray(o_r)[ok], rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(d.numpy()[ok], np.asarray(d_r)[ok], rtol=2e-6, atol=2e-6)
    # generate_rays routes a realistic camera through its lens
    o2, d2 = camera.generate_rays(cam, *(torch.as_tensor(a) for a in args))
    assert torch.equal(o2, realistic.realistic_generate_rays(cam, cam["realistic"], *(torch.as_tensor(a)
                                                                                      for a in args))[0])


def test_unreadable_lens_file_warns_and_uses_the_builtin_lens(cams, tmp_path, caplog):
    desc, cam, _cam_r = cams
    missing = dataclasses.replace(desc.camera, lens_file=str(tmp_path / "missing.dat"))
    with caplog.at_level(logging.WARNING):
        fallback = camera.make_camera(missing, desc.film, "cpu")
    assert "unreadable" in caplog.text
    assert fallback["realistic"]["curvature"] == cam["realistic"]["curvature"]


def _small_raster(desc, cam, cam_r):
    """The fixture's cameras (their lens tables, focused and bounded for
    the 1000 x 500 film) on desc's raster, in both packages alike: a small
    film without a second focusing and pupil."""
    cfg = dataclasses.replace(desc.camera, kind="perspective")
    plain = camera.make_camera(cfg, desc.film, "cpu")
    plain_r = ref_camera.make_camera(_to_ref(cfg), _to_ref(desc.film))
    mine = dict(cam, resolution=plain["resolution"], raster_to_camera=plain["raster_to_camera"],
                camera_to_raster=plain["camera_to_raster"])
    theirs = dict(cam_r, resolution=plain_r["resolution"], raster_to_camera=plain_r["raster_to_camera"],
                  motion_times=(0.0, 1.0))
    return mine, theirs


def test_realistic_wave_matches_reference(cams):
    """On a 16 x 12 raster, with the fixture's lens tables (_small_raster)."""
    desc, cam, cam_r = cams
    W, H, seed = 16, 12, 3
    desc.film.x_resolution, desc.film.y_resolution = W, H
    desc.sampler.pixel_samples, desc.integrator.max_depth = 2, 2
    cs, ref = compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))
    assert not render.persistent_eligible(desc, cs.static)
    small = _small_raster(desc, cam, cam_r)
    wave = render.make_wave_fn(cs, small[0])
    assert render.LAST_WAVE_TIER == "torch-wave/wide"
    ys, xs = np.mgrid[0:H, 0:W]
    lanes = [xs.ravel(), ys.ravel(), (ys * W + xs).ravel()]
    L, w, nv = (x.numpy() for x in wave(cs.arrays, *(torch.as_tensor(a.astype(np.int64)) for a in lanes), 1, seed))
    L_r, w_r, nv_r = (np.asarray(x) for x in ref_render.make_wave_fn(ref, small[1])(
        ref.arrays, *(jnp.asarray(a.astype(t)) for a, t in zip(lanes, (np.int32, np.int32, np.uint32))),
        jnp.uint32(1), jnp.uint32(seed)))
    np.testing.assert_array_equal(w, w_r)
    np.testing.assert_array_equal(nv, nv_r)
    np.testing.assert_allclose(L, L_r, rtol=1e-4, atol=1e-5)
    assert L.mean() > 0.01
