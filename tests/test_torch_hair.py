"""The port's hair BSDF against the reference, on the CPU.

device/hair.py's hair_f, hair_pdf and hair_sample and the builder's
sigma_a conversions (reflectance and melanin concentration) against
pbrt_tpu's, on 512 lanes of random fiber parameters and directions from a
numpy seed; the reference is called op by op (no jit).

Tolerances. The builder's conversions are float64 NumPy in both packages:
equal. The device terms chain exp, log, sinh, asin, atan2 and the 10-term
Bessel series, whose XLA and PyTorch float32 results differ by ulps: each
of f (per channel) and pdf agrees within rtol 1e-4 of its own value plus
1e-6 of the batch's largest (the pdf's largest relative difference on
these lanes is 2.3e-5: ulps of the narrow Mp lobes' exponents at small
beta_m). Sampling maps
two uniforms through the same functions: wi within 1e-4, valid flags
equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.device import hair as ref_hair
from pbrt_tpu.scene import builder as ref_builder
from pbrt_tpu_torch.device import hair
from pbrt_tpu_torch.scene import builder
from torch_threads import one_torch_thread  # noqa: F401  (autouse: PyTorch single-threaded in this module)

N = 512


@pytest.fixture(scope="module")
def lanes():
    rs = np.random.RandomState(17)
    data = np.zeros((N, 14), np.float32)
    conc = rs.uniform(0.0, 8.0, (N, 2))
    data[:, 0:3] = [builder._hair_sigma_a_from_concentration(ce, cp) for ce, cp in conc]
    data[:, 3] = rs.uniform(1.4, 1.7, N)
    data[:, 9] = rs.uniform(0.1, 0.8, N)  # beta_m
    data[:, 10] = rs.uniform(0.1, 0.8, N)  # beta_n
    data[:, 12] = rs.uniform(0.0, 4.0, N)  # alpha, degrees
    data[:, 13] = rs.uniform(-1.0, 1.0, N)  # h

    def unit():
        v = rs.normal(size=(N, 3))
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)

    return data, unit(), unit(), rs.uniform(0.0, 1.0, (2, N)).astype(np.float32)


def _close(a, b, rtol, key):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-6 * np.abs(b).max(), err_msg=key)


def test_hair_f_and_pdf_match_reference(lanes):
    data, wo, wi, _u = lanes
    t = [torch.as_tensor(x) for x in (data, wo, wi)]
    j = [jnp.asarray(x) for x in (data, wo, wi)]
    f, f_r = hair.hair_f(*t).numpy(), np.asarray(ref_hair.hair_f(*j))
    assert (f_r > 0).all(1).mean() > 0.9
    _close(f, f_r, 1e-4, "f")
    _close(hair.hair_pdf(*t).numpy(), ref_hair.hair_pdf(*j), 1e-4, "pdf")


def test_hair_sample_matches_reference(lanes):
    data, wo, _wi, u = lanes
    s = hair.hair_sample(torch.as_tensor(data), torch.as_tensor(wo), *(torch.as_tensor(x) for x in u))
    s_r = ref_hair.hair_sample(jnp.asarray(data), jnp.asarray(wo), *(jnp.asarray(x) for x in u))
    np.testing.assert_array_equal(s["valid"].numpy(), np.asarray(s_r["valid"]))
    np.testing.assert_allclose(s["wi"].numpy(), np.asarray(s_r["wi"]), rtol=0, atol=1e-4)


@pytest.mark.parametrize("beta_n", [0.05, 0.3, 0.9])
def test_sigma_a_conversions_match_reference(beta_n):
    rs = np.random.RandomState(int(beta_n * 100))
    for c in rs.uniform(0.0, 1.2, (8, 3)):
        np.testing.assert_array_equal(builder._hair_sigma_a_from_reflectance(c, beta_n),
                                      ref_builder._hair_sigma_a_from_reflectance(c, beta_n))
    for ce, cp in rs.uniform(0.0, 8.0, (8, 2)):
        np.testing.assert_array_equal(builder._hair_sigma_a_from_concentration(ce, cp),
                                      ref_builder._hair_sigma_a_from_concentration(ce, cp))
