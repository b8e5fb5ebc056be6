"""The port's multi-device rendering (pbrt_tpu_torch/parallel/shard.py) on
shards of the CPU, at the reference dryrun's scene (16 x 8: 128 pixels,
which 3 shards do not divide, so the padding lanes run):

- path, volpath (a homogeneous fog around the camera), BDPT and MLT on 2
  and 3 shards against 1 shard, within the reference's mesh-invariance
  tolerances (tests/test_shard_parity.py: rtol 2e-4 and atol 2e-5, MLT
  atol 3e-5); MLT with 12 chains and 72 bootstrap samples, which 1, 2 and 3
  shards divide, so every mesh draws the same chains;
- SPPM on 2 and 3 shards against 1 shard in its band: each shard's photons
  have a seed of their own, so the lit pixels' mean ratio is held within
  0.1 (3 iterations of 8,192 photons);
- a shard that raises makes the step raise;
- render_compiled's branch: taken only when the caller gives devices, and
  then only for a whole film (no crop window, no checkpoint); on CPU
  shards it gives the step's image and the tier torch-shard<n>/;
- the launch count: exact when many threads count at once.

tests/test_torch_shard_ref.py holds the steps against the reference's.
"""
import sys
import threading

import numpy as np
import pytest
import torch

from pbrt_tpu_torch import render
from pbrt_tpu_torch.device import nvcc
from pbrt_tpu_torch.parallel import shard
from pbrt_tpu_torch.scene.builder import compile_scene
from torch_test_scenes import tiny_scene
from torch_threads import one_torch_thread  # noqa: F401  (autouse: PyTorch single-threaded in this module)

MESH_TOL = {"path": (2e-4, 2e-5), "volpath": (2e-4, 2e-5), "bdpt": (2e-4, 2e-5), "mlt": (2e-4, 3e-5)}


def _scene(family):
    desc = tiny_scene(res=(16, 8), integrator=family, fog=family == "volpath", max_depth=2)
    if family == "sppm":
        desc.integrator.initial_radius = 0.25
    return desc, compile_scene(desc, "cpu")


def _render(family, n):
    desc, cs = _scene(family)
    devices = ["cpu"] * n
    if family == "bdpt":
        return shard.render_bdpt_sharded_step(cs, desc, devices, spp=1)
    if family == "mlt":
        return shard.render_mlt_sharded_step(cs, desc, devices, depth=1, n_chains=12, n_mut=2, n_boot=72)
    if family == "sppm":
        return shard.render_sppm_sharded_step(cs, desc, devices, n_iters=3, n_photons=8192)
    return shard.render_sharded_step(cs, desc, devices, spp=2)


@pytest.fixture(scope="module")
def images():
    cache = {}

    def get(family, n):
        if (family, n) not in cache:
            cache[family, n] = _render(family, n)
        return cache[family, n]

    return get


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("family", list(MESH_TOL))
def test_shards_agree(images, family, n):
    img, img1 = images(family, n), images(family, 1)
    assert img.shape == (128, 3) and np.isfinite(img).all() and img1.mean() > 1e-4
    rtol, atol = MESH_TOL[family]
    np.testing.assert_allclose(img, img1, rtol=rtol, atol=atol)


@pytest.mark.parametrize("n", [2, 3])
def test_sppm_shards_agree_as_estimates(images, n):
    img, img1 = images("sppm", n), images("sppm", 1)
    lit = img1.mean(-1) > 1e-3
    assert lit.sum() > 50 and np.isfinite(img).all()
    assert abs(img[lit].mean() / img1[lit].mean() - 1.0) < 0.1


def test_a_failing_shard_raises(monkeypatch):
    desc, cs = _scene("bdpt")
    wave = shard.bdpt_wave
    calls = []

    def fail_on_second_shard(sa, static, ctx, cam, cdf, seed, px, py, pids, *args, **kw):
        calls.append(int(pids[0]))
        if int(pids[0]) != 0:
            raise FloatingPointError("shard fault")
        return wave(sa, static, ctx, cam, cdf, seed, px, py, pids, *args, **kw)

    monkeypatch.setattr(shard, "bdpt_wave", fail_on_second_shard)
    with pytest.raises(RuntimeError, match="shard 1 of 2") as err:
        shard.render_bdpt_sharded_step(cs, desc, ["cpu", "cpu"], spp=1)
    assert isinstance(err.value.__cause__, FloatingPointError) and len(calls) == 2


def test_branch_is_taken_only_for_a_whole_gpu_render():
    """render_compiled splits a scene only over the devices it is given, and
    only a whole film without a checkpoint; without devices it renders on
    the scene's device, whatever devices the machine shows."""
    desc, cs = _scene("path")
    render.render_compiled(cs, spp=1)
    assert not render.render_compiled.last_timing["tier"].startswith("torch-shard")
    with pytest.raises(ValueError, match="whole film"):
        render.render_compiled(cs, spp=1, devices=["cpu", "cpu"], checkpoint_path="film.npz")
    desc.film.crop_window = (0.0, 0.5, 0.0, 1.0)
    with pytest.raises(ValueError, match="whole film"):
        render.render_compiled(cs, spp=1, devices=["cpu", "cpu"])


def test_branch_renders_the_steps_image(images):
    desc, cs = _scene("path")
    img = render.render_compiled(cs, seed=0, spp=2, devices=["cpu", "cpu"])
    tm = render.render_compiled.last_timing
    assert tm["tier"] == "torch-shard2/brute" and tm["shards"] == 2 and tm["n_vertices"] > 0
    np.testing.assert_array_equal(img, images("path", 2).reshape(8, 16, 3) * desc.film.scale)


def test_launch_count_is_exact_under_threads():
    def wrapper():
        pass

    wrapper.launches = 0
    n_threads, per_thread = 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [nvcc.count_launch(wrapper) for _ in range(per_thread)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launches == n_threads * per_thread
