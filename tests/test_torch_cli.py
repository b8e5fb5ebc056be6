"""The port's command line, ``python -m pbrt_tpu_torch scene.pbrt``.

main.main([... "--device", "cpu"]) parses, compiles, renders with the plain
PyTorch twins and writes the film: the written image must equal
render.render of the port's own parse. One tiny halton + gaussian render of
a matte scene is held against the reference's pbrt_tpu.render.render of the
same file, within tests/test_torch_render.py's tier tolerance (rtol 2e-4,
atol 2e-4). --checkpoint is accepted (the wave; test_torch_wave.py
resumes one); --device cuda is refused where there is no GPU.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pbrt_tpu import render as ref_render
from pbrt_tpu.parser.api import pbrt_parse as ref_pbrt_parse
from pbrt_tpu_torch import main as cli
from pbrt_tpu_torch import render
from pbrt_tpu_torch.core.imageio import read_image
from pbrt_tpu_torch.core.options import Options
from pbrt_tpu_torch.parser.api import pbrt_parse
from test_torch_api import room_text
from torch_threads import one_torch_thread  # noqa: F401  (autouse: PyTorch single-threaded in this module)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _wavefront_only(monkeypatch):
    """Both packages skip their brute megakernels, so the brute wavefront
    renders these scenes of at most 64 prims in each."""
    monkeypatch.setenv("PBRT_TPU_NO_MEGAKERNEL", "1")
    monkeypatch.delenv("PBRT_TPU_WIDEMEGA", raising=False)


def _scene(tmp_path, **kw):
    p = tmp_path / "s.pbrt"
    p.write_text(room_text(3, **kw))
    return str(p)


@pytest.fixture(scope="module")
def main_run(tmp_path_factory):
    """The matte room rendered once by main at seed 2 (the render the
    tests below read): (scene path, written image path, main.last_run,
    the route's label)."""
    tmp_path = tmp_path_factory.mktemp("cli")
    path = _scene(tmp_path)
    out = str(tmp_path / "out.pfm")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PBRT_TPU_NO_MEGAKERNEL", "1")
        mp.delenv("PBRT_TPU_WIDEMEGA", raising=False)
        assert cli.main([path, "--outfile", out, "--device", "cpu", "--quiet", "--seed", "2"]) == 0
    return path, out, cli.main.last_run, render.LAST_PERSISTENT_TIER


def test_main_writes_the_render(main_run):
    """32x16 film cut to 24x16 by the text, 4 spp, depth 3, halton and
    gaussian: the film main writes equals render.render of the parse."""
    path, out, run, tier = main_run
    img = read_image(out)
    want = render.render(pbrt_parse(path), seed=2, device="cpu")
    assert img.shape == (16, 24, 3) and img.mean() > 0.01
    np.testing.assert_array_equal(img, want)
    assert tier == render.LAST_PERSISTENT_TIER == "torch-wavefront/plain-brute"
    assert run["outfile"] == out and run["timing"]["n_vertices"] > 0


def test_main_flags(tmp_path):
    """--cropwindow, --spp and --seed reach the render; --quick quarters the
    film and the samples; --profile writes a trace."""
    path = _scene(tmp_path, sampler="sobol", filter="mitchell")
    out = str(tmp_path / "crop.pfm")
    crop = ["0.25", "0.75", "0", "0.5"]
    assert cli.main([path, "-o", out, "--device", "cpu", "--quiet", "--cropwindow", *crop, "--spp", "2",
                     "--seed", "5", "--profile", str(tmp_path / "prof"), "--nthreads", "3"]) == 0
    want = render.render(pbrt_parse(path, Options(crop_window=(0.25, 0.75, 0.0, 0.5))), seed=5, spp=2, device="cpu")
    np.testing.assert_array_equal(read_image(out), want)
    assert not want[8:].any() and want[:8, 6:18].any()
    assert os.path.getsize(tmp_path / "prof" / "render_trace.json") > 0
    assert cli.main([path, "-o", str(tmp_path / "q.png"), "--device", "cpu", "--quiet", "--quick"]) == 0
    assert read_image(str(tmp_path / "q.png")).shape == (4, 6, 3)


def test_checkpoint_refused(tmp_path):
    assert cli.main([_scene(tmp_path), "-o", str(tmp_path / "c.pfm"), "--device", "cpu", "--quiet", "--spp", "2",
                     "--checkpoint", str(tmp_path / "k.npz")]) == 0 and render.LAST_WAVE_TIER == "torch-wave/brute"


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal where there is no GPU")
def test_no_gpu_raises_instead_of_falling_back(tmp_path):
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main([_scene(tmp_path), "-o", str(tmp_path / "x.exr")])
    assert not (tmp_path / "x.exr").exists()


def test_module_entry_point(tmp_path):
    """python -m pbrt_tpu_torch, as a subprocess: --cat prints the scene,
    and a render writes its file."""
    path = _scene(tmp_path)
    # one PyTorch thread, as in this module's own process: beside the other
    # test workers more threads only contend for the cores
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    cat = subprocess.run([sys.executable, "-m", "pbrt_tpu_torch", path, "--cat"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert cat.returncode == 0, cat.stderr
    assert 'Sampler "halton" "integer pixelsamples" [ 4 ]' in cat.stdout
    out = subprocess.run([sys.executable, "-m", "pbrt_tpu_torch", path, "--device", "cpu", "--spp", "1",
                          "-o", "m.exr"], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "Statistics:" in out.stderr and read_image(str(tmp_path / "m.exr")).shape == (16, 24, 3)


def test_cli_render_matches_reference(main_run):
    """The one reference render: halton + gaussian on the matte room at
    24x16, 4 spp, depth 3, through the reference's own parse and render."""
    path, out, _run, _tier = main_run
    want = np.asarray(ref_render.render(ref_pbrt_parse(path), seed=2))
    assert ref_render.LAST_PERSISTENT_TIER.startswith("xla-wavefront")
    got = read_image(out)
    assert want.mean() > 0.01
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
