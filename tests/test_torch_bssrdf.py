"""The port's tabulated BSSRDF against the reference, on the CPU.

- core/bssrdf.py, the host's beam-diffusion table and its spline helpers,
  is the reference's float64 NumPy arithmetic: the tables of two (g, eta)
  pairs, the effective-albedo inversion (subsurface_from_diffuse) and the
  Catmull-Rom weights are equal bit for bit.
- device/bssrdf.py against the reference's device functions called op by op
  (no jit, so XLA contracts no multiply-add): 4,096 lanes of the sss room's
  folded profile rows with radii, uniforms, directions and normals from a
  numpy seed. The spline lookups, the radial pdf and Sr equal the
  reference's bit for bit. Sw and pdf_sp take square roots, and PyTorch's
  float32 sqrt on the CPU is one ulp off the correctly rounded result on
  some inputs (XLA's and NumPy's are not): they agree within rtol 1e-6, and
  so does the inversion of the radial CDF (20 bisection-Newton steps on a
  quartic).
- the subsurface interface lobes (Fresnel reflection and diffuse
  transmission) and the exit point's adapter lobe (LOBE_SSS_ADAPTER:
  f = Sw eta^2 on the wo side, a cosine pdf) through make_bsdf, bsdf_f and
  bsdf_pdf: the reference's kinds, and f and pdf within rtol 1e-5 (the
  Fresnel terms' square roots, one ulp apart, amplified near total internal
  reflection).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core import bssrdf as ref_core
from pbrt_tpu.device import bsdf as ref_bsdf
from pbrt_tpu.device import bssrdf as ref_dev
from pbrt_tpu.device.materials import make_bsdf as ref_make_bsdf
from pbrt_tpu.scene.builder import compile_scene as ref_compile_scene
from pbrt_tpu_torch.core import bssrdf as core
from pbrt_tpu_torch.device import bsdf
from pbrt_tpu_torch.device import bssrdf as dev
from pbrt_tpu_torch.device.materials import lobe_table, make_bsdf
from pbrt_tpu_torch.scene.builder import compile_scene
from pbrt_tpu_torch.scenes import sss_room
from test_torch_megakernel import _to_ref
from torch_threads import one_torch_thread  # noqa: F401  (autouse: PyTorch single-threaded in this module)

N = 4096


@pytest.mark.parametrize("g, eta", [(0.0, 1.33), (0.3, 1.5)])
def test_beam_diffusion_table_bit_identical(g, eta):
    mine, theirs = core.compute_beam_diffusion_table(g, eta), ref_core.compute_beam_diffusion_table(g, eta)
    assert mine.keys() == theirs.keys()
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    kd = np.array([0.75, 0.55, 0.35])
    mfp = np.array([0.08, 0.05, 0.03])
    for a, b in zip(core.subsurface_from_diffuse(mine, kd, mfp), ref_core.subsurface_from_diffuse(theirs, kd, mfp)):
        np.testing.assert_array_equal(a, b)
    x = np.random.RandomState(1).uniform(-0.1, 1.1, 64)
    for a, b in zip(core.catmull_rom_weights(mine["rho_samples"], x),
                    ref_core.catmull_rom_weights(theirs["rho_samples"], x)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def rows():
    """The sss room's tables in both packages and N lanes on its two
    subsurface rows: per-lane (3, 64) profile and CDF rows, rho_eff and
    sigma_t, world radii, uniforms, a frame and exit normals."""
    desc = sss_room(8, 8, 8)
    cs, ref = compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))
    rs = np.random.RandomState(5)
    mats = np.nonzero(cs.arrays.sss_sigma_t.numpy().sum(1) > 0)[0]
    mat = mats[rs.randint(0, len(mats), N)]
    unit = rs.normal(size=(4, N, 3))
    unit /= np.linalg.norm(unit, axis=-1, keepdims=True)
    host = {"mat": mat, "u": rs.random_sample(N).astype(np.float32),
            "r": (rs.random_sample(N) * 0.3).astype(np.float32),
            "ch": rs.randint(0, 3, N), "d": (unit[0] * rs.random_sample((N, 1)) * 0.4).astype(np.float32),
            "n": unit[1].astype(np.float32), "ss": unit[2].astype(np.float32),
            "cos": rs.uniform(-1, 1, N).astype(np.float32)}
    return cs, ref, host


def _both(cs, ref, name, idx):
    return getattr(cs.arrays, name)[torch.as_tensor(idx)], jnp.asarray(np.asarray(getattr(ref.arrays, name))[idx])


def test_device_functions_match_reference_op_by_op(rows):
    cs, ref, h = rows
    prof3, prof3_r = _both(cs, ref, "sss_prof", h["mat"])
    cdf3, cdf3_r = _both(cs, ref, "sss_cdf", h["mat"])
    rho3, rho3_r = _both(cs, ref, "sss_rhoeff", h["mat"])
    sig3, sig3_r = _both(cs, ref, "sss_sigma_t", h["mat"])
    radius, radius_r = cs.arrays.sss_radius, jnp.asarray(np.asarray(ref.arrays.sss_radius))
    t = lambda x: torch.as_tensor(x)  # noqa: E731
    r, r_r = t(h["r"]), jnp.asarray(h["r"])
    ch = t(h["ch"])
    pick = lambda a: a[torch.arange(N), ch]  # noqa: E731
    pick_r = lambda a: a[jnp.arange(N), jnp.asarray(h["ch"])]  # noqa: E731

    def eq(a, b):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    eq(dev.eval_profile_row(radius, pick(prof3), r * pick(sig3)),
       ref_dev.eval_profile_row(radius_r, pick_r(prof3_r), r_r * pick_r(sig3_r)))
    eq(dev.pdf_radial(radius, pick(prof3), pick(rho3), pick(sig3), r),
       ref_dev.pdf_radial(radius_r, pick_r(prof3_r), pick_r(rho3_r), pick_r(sig3_r), r_r))
    eq(dev.sr_eval(radius, prof3, sig3, r), ref_dev.sr_eval(radius_r, prof3_r, sig3_r, r_r))

    def close(a, b):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)

    eta, eta_r = _both(cs, ref, "sss_eta", h["mat"])
    close(dev.sw_factor(eta, t(h["cos"])), ref_dev.sw_factor(eta_r, jnp.asarray(h["cos"])))
    frame = [t(x) for x in (h["ss"], h["n"], h["d"])]
    frame_r = [jnp.asarray(x) for x in (h["ss"], h["n"], h["d"])]
    close(dev.pdf_sp(radius, prof3, rho3, sig3, frame[2], frame[1], frame[0], frame[1], frame[0]),
          ref_dev.pdf_sp(radius_r, prof3_r, rho3_r, sig3_r, frame_r[2], frame_r[1], frame_r[0], frame_r[1], frame_r[0]))
    u, u_r = t(h["u"]), jnp.asarray(h["u"])
    mine = dev.sample_radial_cdf(radius, pick(prof3), pick(cdf3), pick(rho3), u)
    theirs = ref_dev.sample_radial_cdf(radius_r, pick_r(prof3_r), pick_r(cdf3_r), pick_r(rho3_r), u_r)
    close(mine, theirs)
    assert float(mine.max()) > 0.1  # the samples reach into the profile


def test_subsurface_and_adapter_lobes_match_reference(rows):
    cs, ref, h = rows
    mat = torch.as_tensor(h["mat"])
    uv, p = torch.zeros((N, 2)), torch.zeros((N, 3))
    lobes = make_bsdf(cs.arrays, cs.static, mat, None, uv, p)
    lobes_r = ref_make_bsdf(ref.arrays, ref.static, jnp.asarray(h["mat"]), jnp.asarray(uv.numpy()),
                            jnp.asarray(p.numpy()))
    kinds = lobes["kind"].numpy()
    assert set(np.unique(kinds)) == {bsdf.LOBE_NONE, bsdf.LOBE_LAMBERT_T, bsdf.LOBE_SPEC_R}
    np.testing.assert_array_equal(kinds, np.asarray(lobes_r["kind"])[:, lobe_table(cs.arrays, cs.static)["slots"]])
    rs = np.random.RandomState(7)
    wo, wi = (rs.normal(size=(N, 3)).astype(np.float32) for _ in range(2))
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    refl = torch.as_tensor(wo[:, 2] * wi[:, 2] > 0)
    eta = cs.arrays.sss_eta[mat]
    data = torch.zeros((N, 1, 14))
    data[:, 0, 3] = eta
    adapter = {"kind": torch.full((N, 1), bsdf.LOBE_SSS_ADAPTER, dtype=torch.int32), "data": data,
               "possible": (frozenset({bsdf.LOBE_SSS_ADAPTER}),), "has_beckmann": False, "has_schlick": False}
    adapter_r = {"kind": jnp.full((N, 1), ref_bsdf.LOBE_SSS_ADAPTER), "data": jnp.asarray(data.numpy()),
                 "possible": (frozenset({ref_bsdf.LOBE_SSS_ADAPTER}),)}
    for mine, theirs in ((lobes, lobes_r), (adapter, adapter_r)):
        args = (torch.as_tensor(wo), torch.as_tensor(wi))
        args_r = (jnp.asarray(wo), jnp.asarray(wi))
        f = bsdf.bsdf_f(mine, *args, refl)
        np.testing.assert_allclose(f.numpy(), np.asarray(ref_bsdf.bsdf_f(theirs, *args_r, jnp.asarray(refl.numpy()))),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(bsdf.bsdf_pdf(mine, *args).numpy(), np.asarray(ref_bsdf.bsdf_pdf(theirs, *args_r)),
                                   rtol=1e-5, atol=1e-7)
    assert float(f.max()) > 0.1  # the adapter lobe on the wo side
