"""The port's Fourier BSDF tables and lobe against the reference, on the CPU.

- core/fourierbsdf.py: both writers write the reference's bytes; the
  reader and integrate_catmull_rom give the reference's arrays; the
  builder's stack of one table, and of two tables of different sizes (the
  padding), equals the reference's bit for bit.
- device/fourier.py: fourier_f, fourier_pdf and fourier_sample on 256
  (wo, wi, u) triples from a numpy seed, over a rough-conductor table and
  a Lambert table (small nmu), and over the stack of both (each lane's
  table by its id). The reference is called op by op (no jit).

Tolerances. The azimuthal series sums up to MCAP = 64 terms a_k cos(k phi)
with k phi up to 200 radians, where XLA's and PyTorch's cos differ by
ulps, and the terms cancel away from the specular peak: f and pdf agree
within 1e-5 of the batch's largest value (absolute), not per lane
relative. fourier_sample inverts two CDFs by Newton-bisection, which
carries those ulps into the direction: valid flags equal, wi within 2e-4,
the pdf of each sampled direction within 2e-3 relative of the
reference's pdf of its own sample, and its f within 5e-3 relative (the
direction's error times the slope of the rough conductor's peak).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core import fourierbsdf as ref_fb
from pbrt_tpu.device import fourier as ref_fourier
from pbrt_tpu.scene.builder import _stack_fourier_tables as ref_stack
from pbrt_tpu_torch.core import fourierbsdf as fb
from pbrt_tpu_torch.device import fourier
from pbrt_tpu_torch.scene.builder import _stack_fourier_tables
from torch_threads import one_torch_thread  # noqa: F401  (autouse: PyTorch single-threaded in this module)

N = 256
WRITERS = {"rough-conductor": lambda m, path: m.write_rough_conductor_table(path, alpha=0.3, nmu=10),
           "lambert": lambda m, path: m.write_lambert_table(path, rho=0.7, nmu=8)}


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """name -> (port path, reference path) of each writer's table."""
    d = tmp_path_factory.mktemp("fourier")
    out = {}
    for name, write in WRITERS.items():
        mine, theirs = d / f"{name}.bsdf", d / f"{name}_ref.bsdf"
        write(fb, str(mine))
        write(ref_fb, str(theirs))
        out[name] = (str(mine), str(theirs))
    return out


@pytest.mark.parametrize("name", list(WRITERS))
def test_writers_write_the_reference_bytes(tables, name):
    mine, theirs = tables[name]
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", list(WRITERS))
def test_read_fourier_table_matches_reference(tables, name):
    mine = fb.read_fourier_table(tables[name][0])
    ref = ref_fb.read_fourier_table(tables[name][1])
    assert mine.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert mine[k].dtype == v.dtype, k
            np.testing.assert_array_equal(mine[k], v, err_msg=k)
        else:
            assert mine[k] == v, k
    assert fb.read_fourier_table(tables[name][0] + ".missing") is None


def test_integrate_catmull_rom_matches_reference():
    rs = np.random.RandomState(2)
    x = np.sort(rs.uniform(-1.0, 1.0, 9))
    values = rs.uniform(0.0, 2.0, (3, 9))
    np.testing.assert_array_equal(fb.integrate_catmull_rom(x, values), ref_fb.integrate_catmull_rom(x, values))


@pytest.mark.parametrize("which", ["rough-conductor", "both"])
def test_stack_matches_reference(tables, which):
    """One table, and two of different nmu and order (the padding rules)."""
    names = ["rough-conductor"] if which == "rough-conductor" else list(WRITERS)
    mine = _stack_fourier_tables([fb.read_fourier_table(tables[n][0]) for n in names])
    theirs = ref_stack([ref_fb.read_fourier_table(tables[n][1]) for n in names])
    assert mine.keys() == theirs.keys() == {"mu", "aflat", "a0", "cdf", "eta"}
    for k in mine:
        assert mine[k].dtype == np.float32, k
        np.testing.assert_array_equal(mine[k], np.asarray(theirs[k]), err_msg=k)


def _both_tables(tables, names):
    st = _stack_fourier_tables([fb.read_fourier_table(tables[n][0]) for n in names])
    return {k: torch.as_tensor(v) for k, v in st.items()}, {k: jnp.asarray(v) for k, v in st.items()}


def _lanes(seed, n_tables):
    rs = np.random.RandomState(seed)

    def unit():
        v = rs.normal(size=(N, 3))
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)

    wo, wi = unit(), unit()
    wi[: N // 2, 2] = -np.abs(wi[: N // 2, 2]) * np.sign(wo[: N // 2, 2])  # half the lanes reflect
    u = rs.uniform(0.0, 1.0, (2, N)).astype(np.float32)
    tid = rs.randint(0, n_tables, N)
    return wo, wi, u, tid


CASES = ["rough-conductor", "lambert", "both"]


def _setup(tables, case):
    names = list(WRITERS) if case == "both" else [case]
    ft, ft_r = _both_tables(tables, names)
    wo, wi, u, tid = _lanes(5 + CASES.index(case), len(names))
    return ft, ft_r, wo, wi, u, torch.as_tensor(tid), jnp.asarray(tid.astype(np.int32))


def _close_to_peak(a, b, key):
    a, b = np.asarray(a), np.asarray(b)
    assert np.abs(b).max() > 0, key
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max(), err_msg=key)


@pytest.mark.parametrize("case", CASES)
def test_fourier_f_and_pdf_match_reference(tables, case):
    ft, ft_r, wo, wi, _u, tid, tid_r = _setup(tables, case)
    f = fourier.fourier_f(ft, tid, torch.as_tensor(wo), torch.as_tensor(wi))
    f_r = ref_fourier.fourier_f(ft_r, tid_r, jnp.asarray(wo), jnp.asarray(wi))
    _close_to_peak(f.numpy(), f_r, "f")
    assert (np.asarray(f_r) > 0).any(1).mean() > 0.3
    p = fourier.fourier_pdf(ft, tid, torch.as_tensor(wo), torch.as_tensor(wi))
    p_r = ref_fourier.fourier_pdf(ft_r, tid_r, jnp.asarray(wo), jnp.asarray(wi))
    _close_to_peak(p.numpy(), p_r, "pdf")


@pytest.mark.parametrize("case", CASES)
def test_fourier_sample_matches_reference(tables, case):
    ft, ft_r, wo, _wi, u, tid, tid_r = _setup(tables, case)
    s = fourier.fourier_sample(ft, tid, torch.as_tensor(wo), *(torch.as_tensor(x) for x in u))
    s_r = ref_fourier.fourier_sample(ft_r, tid_r, jnp.asarray(wo), *(jnp.asarray(x) for x in u))
    valid = np.asarray(s_r["valid"])
    np.testing.assert_array_equal(s["valid"].numpy(), valid)
    assert valid.mean() > 0.5
    np.testing.assert_allclose(s["wi"].numpy()[valid], np.asarray(s_r["wi"])[valid], rtol=0, atol=2e-4)
    np.testing.assert_allclose(s["pdf"].numpy()[valid], np.asarray(s_r["pdf"])[valid], rtol=2e-3, atol=1e-7)
    f_r = np.asarray(s_r["f"])
    np.testing.assert_allclose(s["f"].numpy(), f_r, rtol=5e-3, atol=1e-5 * np.abs(f_r).max())
