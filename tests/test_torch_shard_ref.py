"""The port's sharded steps (pbrt_tpu_torch/parallel/shard.py) against the
reference's (pbrt_tpu/parallel/shard.py) on a 2-device CPU mesh
(tests/conftest.py gives JAX 8 host devices), the port on ["cpu", "cpu"]:
the same scene in both packages (torch_test_scenes.tiny_scene, the
reference dryrun's scene at or below its shapes, its spheres matte: the
specular lobes are the single-device parity tests' to hold, and cost the
reference's sharded compiles about 40 s in all), each family held to the
tolerance of the port's single-device parity test of its integrator:

- path: tests/test_torch_render.py's, rtol 2e-4, atol 2e-4;
- volpath (a homogeneous fog around the camera): tests/test_torch_wave.py's,
  rtol 1e-4, atol 1e-5;
- BDPT: tests/test_torch_bdpt.py's render, atol 1e-5;
- MLT (one depth): tests/test_torch_mlt.py's render, atol 1e-4 of the
  image's largest value;
- SPPM (one iteration): tests/test_torch_sppm.py's render, atol 1e-4 of the
  image's largest value, KMAX = 8 in both packages as there.

tests/test_torch_shard.py holds the port's steps on 1, 2 and 3 shards.
"""
import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from pbrt_tpu.device import sppm as ref_sppm
from pbrt_tpu.parallel import shard as ref_shard
from pbrt_tpu.scene.builder import compile_scene as ref_compile_scene
from pbrt_tpu_torch.device import sppm
from pbrt_tpu_torch.parallel import shard
from pbrt_tpu_torch.scene.builder import compile_scene
from test_torch_megakernel import _to_ref
from torch_test_scenes import tiny_scene
from torch_threads import one_torch_thread  # noqa: F401  (autouse: PyTorch single-threaded in this module)

DEVICES = ["cpu", "cpu"]


def _both(desc):
    return compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc)), _to_ref(desc)


def _mesh():
    return Mesh(np.array(jax.devices()[:2]), ("rays",))


# family -> (scene, the port's step, the reference's step, keyword arguments, (rtol, atol, atol scaled by the max))
CASES = {
    "path": (dict(), "render_sharded_step", dict(spp=2), (2e-4, 2e-4, False)),
    "volpath": (dict(integrator="volpath", fog=True, max_depth=2), "render_sharded_step", dict(spp=2), (1e-4, 1e-5, False)),
    "bdpt": (dict(integrator="bdpt", max_depth=1, spp=1), "render_bdpt_sharded_step", dict(spp=1), (0, 1e-5, False)),
    "mlt": (dict(integrator="mlt", max_depth=1, spp=1), "render_mlt_sharded_step",
            dict(depth=1, n_chains=8, n_mut=1, n_boot=64), (0, 1e-4, True)),
    "sppm": (dict(integrator="sppm", max_depth=2, spp=1), "render_sppm_sharded_step",
             dict(n_iters=1, n_photons=512), (0, 1e-4, True)),
}


@pytest.mark.parametrize("family", list(CASES))
def test_sharded_step_matches_reference(family, monkeypatch):
    scene_kw, step, kw, (rtol, atol, scaled) = CASES[family]
    monkeypatch.setattr(sppm, "KMAX", 8)
    monkeypatch.setattr(ref_sppm, "KMAX", 8)
    desc = tiny_scene(res=(16, 8), specular=False, **scene_kw)
    if family == "sppm":
        desc.integrator.initial_radius = 0.25
    cs, ref, desc_r = _both(desc)
    img = getattr(shard, step)(cs, desc, DEVICES, seed=3, **kw)
    img_r = np.asarray(getattr(ref_shard, step)(ref, desc_r, _mesh(), seed=3, **kw))
    assert img.shape == img_r.shape == (16 * 8, 3)
    assert np.isfinite(img).all() and img_r.mean() > 1e-4
    np.testing.assert_allclose(img, img_r, rtol=rtol, atol=atol * (np.abs(img_r).max() if scaled else 1.0))
