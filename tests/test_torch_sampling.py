"""The port's counter-based RNG, samplers and camera regeneration against
the reference's.

Hashes and sample values must be bit-exact: the port carries uint32 in
int64 and masks after every multiply, add and left shift; that holds for
the halton, sobol and maxmindist samplers and their film enumeration tables
too. Camera rays agree within atol 1e-6 (the same float32 operations in the
same order), except where a filter's sqrt, log or sin differs by an ulp
from XLA's (test_filter_offsets_match states those tolerances).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from pbrt_tpu import render as ref_render
from pbrt_tpu.device import rng as ref_rng
from pbrt_tpu.device import sampler as ref_sampler
from pbrt_tpu.device.camera import make_camera as ref_make_camera
from pbrt_tpu_torch import render
from pbrt_tpu_torch.device import rng, sampler
from pbrt_tpu_torch.device.camera import make_camera
from pbrt_tpu_torch.scenes import mesh_room
from torch_threads import one_torch_thread  # noqa: F401  (autouse: PyTorch single-threaded in this module)

SEED = 12345


def _grid():
    """(pixel, sample, dim) grid from a seed, uint32 pixels up to 2^32-1."""
    rs = np.random.RandomState(0)
    pixel = np.concatenate([rs.randint(0, 2 ** 32, 300, dtype=np.uint64),
                            [0, 1, 2 ** 31, 2 ** 32 - 1]]).astype(np.uint32)
    sample = rs.randint(0, 1 << 20, pixel.size).astype(np.uint32)
    dims = rs.randint(0, 64, pixel.size).astype(np.int32)
    return pixel, sample, dims


def _t(x):
    return torch.as_tensor(x.astype(np.int64))


def test_pcg_hash_bit_exact():
    pixel, sample, _ = _grid()
    x = pixel ^ (sample * np.uint32(2654435761))
    np.testing.assert_array_equal(rng.pcg_hash(_t(x)).numpy(), np.asarray(ref_rng.pcg_hash(jnp.asarray(x))))


def test_hash_combine_bit_exact():
    pixel, sample, dims = _grid()
    ref = np.asarray(ref_rng.hash_combine(SEED, jnp.asarray(pixel), jnp.asarray(sample), jnp.asarray(dims)))
    got = rng.hash_combine(SEED, _t(pixel), _t(sample), torch.as_tensor(dims)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind", ["zerotwosequence", "random"])
@pytest.mark.parametrize("dim_form", ["int", "tensor"])
def test_samples_bit_exact(kind, dim_form):
    pixel, sample, dims = _grid()
    for dim in ([0, 1, 5, 33] if dim_form == "int" else [dims]):
        d_ref = dim if isinstance(dim, int) else jnp.asarray(dim)
        d_port = dim if isinstance(dim, int) else torch.as_tensor(dim)
        r1 = ref_sampler.sample_1d(kind, SEED, jnp.asarray(pixel), jnp.asarray(sample), d_ref, 16)
        p1 = sampler.sample_1d(kind, SEED, _t(pixel), _t(sample), d_port, 16)
        np.testing.assert_array_equal(p1.numpy(), np.asarray(r1))
        ru, rv = ref_sampler.sample_2d(kind, SEED, jnp.asarray(pixel), jnp.asarray(sample), d_ref, 16)
        pu, pv = sampler.sample_2d(kind, SEED, _t(pixel), _t(sample), d_port, 16)
        np.testing.assert_array_equal(pu.numpy(), np.asarray(ru))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
        assert pu.dtype == torch.float32 and float(pu.max()) < 1.0


# (x_samples, y_samples, jitter) declared for 8 spp, as render_compiled
# registers them in the reference and make_persistent_fn puts them in scfg
STRATA = {"undeclared": None, "4x2": (4, 2, True), "4x2-jitter-off": (4, 2, False), "3x3-fallback": (3, 3, True)}


@pytest.mark.parametrize("strata", list(STRATA))
@pytest.mark.parametrize("dim_form", ["int", "tensor"])
def test_stratified_bit_exact(strata, dim_form, monkeypatch):
    """The stratified sampler: film and other int dims in strata (the
    declared shape when x * y == spp, else floor(sqrt(spp)) x spp // that),
    tensor dims from the random stream; against the reference with its
    module global set (and restored) to the same declaration."""
    spp = 8
    decl = STRATA[strata]
    if decl is None:
        monkeypatch.setattr(ref_sampler, "_STRATIFIED_SHAPE", None)
        monkeypatch.setattr(ref_sampler, "_STRATIFIED_JITTER", True)
    else:
        monkeypatch.setattr(ref_sampler, "_STRATIFIED_SHAPE", decl[:2])
        monkeypatch.setattr(ref_sampler, "_STRATIFIED_JITTER", decl[2])
    pixel, sample, dims = _grid()
    sample = sample % spp
    for dim in ([0, 1, 2, 7] if dim_form == "int" else [dims]):
        d_ref = dim if isinstance(dim, int) else jnp.asarray(dim)
        d_port = dim if isinstance(dim, int) else torch.as_tensor(dim)
        args_r = (SEED, jnp.asarray(pixel), jnp.asarray(sample), d_ref, spp)
        args_p = (SEED, _t(pixel), _t(sample), d_port, spp)
        np.testing.assert_array_equal(sampler.sample_1d("stratified", *args_p, strata=decl).numpy(),
                                      np.asarray(ref_sampler.sample_1d("stratified", *args_r)))
        pu, pv = sampler.sample_2d("stratified", *args_p, strata=decl)
        ru, rv = ref_sampler.sample_2d("stratified", *args_r)
        np.testing.assert_array_equal(pu.numpy(), np.asarray(ru))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
        if isinstance(dim, int) and decl is not None and not decl[2]:
            assert set(np.unique(pu.numpy() * decl[0] % 1.0)) == {0.5}  # stratum centres


def test_lowdiscrepancy_is_the_02_sequence():
    pixel, sample, _dims = _grid()
    args = (SEED, _t(pixel), _t(sample), 3, 16)
    assert torch.equal(sampler.sample_1d("lowdiscrepancy", *args), sampler.sample_1d("zerotwosequence", *args))
    for x, y in zip(sampler.sample_2d("lowdiscrepancy", *args), sampler.sample_2d("zerotwosequence", *args)):
        assert torch.equal(x, y)


def test_other_samplers_raise():
    """A sampler the port does not know raises; halton, sobol and maxmindist
    are known now."""
    zeros = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="pmj02bn"):
        sampler.sample_1d("pmj02bn", SEED, zeros, zeros, 0, 16)
    for kind in ("halton", "sobol", "maxmindist"):
        assert sampler.sample_2d(kind, SEED, zeros, zeros, 0, 16)[0].shape == (2,)


@pytest.mark.parametrize("kind", ["halton", "sobol", "maxmindist"])
@pytest.mark.parametrize("dim_form", ["int", "tensor"])
def test_ld_samples_bit_exact(kind, dim_form):
    """halton, sobol and maxmindist per-lane samples: int dimensions (the
    film pair, the lens pair and two more) and per-lane tensor dimensions.
    The sobol sampler's 1D int dimensions (Sobol dimension 512 + dim) are
    left out: the generator matrices beyond the packaged 64 are searched,
    dimension by dimension up to 512, which takes minutes in both packages,
    and no route draws them (the wavefront's bounce dimensions are
    tensors)."""
    pixel, sample, dims = _grid()
    for dim in ([0, 1, 2, 7] if dim_form == "int" else [dims]):
        d_ref = dim if isinstance(dim, int) else jnp.asarray(dim)
        d_port = dim if isinstance(dim, int) else torch.as_tensor(dim)
        args_r = (SEED, jnp.asarray(pixel), jnp.asarray(sample), d_ref, 16)
        args_p = (SEED, _t(pixel), _t(sample), d_port, 16)
        if not (kind == "sobol" and isinstance(dim, int)):
            np.testing.assert_array_equal(sampler.sample_1d(kind, *args_p).numpy(),
                                          np.asarray(ref_sampler.sample_1d(kind, *args_r)))
        for got, want in zip(sampler.sample_2d(kind, *args_p), ref_sampler.sample_2d(kind, *args_r)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert got.dtype == torch.float32 and 0.0 <= float(got.min()) and float(got.max()) < 1.0


@pytest.mark.parametrize("spp", [1, 16, 64])
def test_maxmin_matrix_matches(spp):
    k = max(int(np.ceil(np.log2(spp))), 0)
    assert [int(c) for c in sampler.maxmin_matrix(k)] == [int(c) for c in ref_sampler.maxmin_matrix(k)]


@pytest.mark.parametrize("film", [(37, 21), (300, 200)])
def test_film_enumeration_tables_bit_exact(film):
    """halton_tables and sobol_tables, and the film and lens dimensions drawn
    from them, at a small film and at one wider than halton's 128-pixel
    tile."""
    W, H = film
    spp = 16
    ys, xs = np.mgrid[0:H, 0:W]
    px, py, pids = xs.ravel(), ys.ravel(), (ys * W + xs).ravel()
    sample = np.random.RandomState(1).randint(0, 1 << 12, px.size).astype(np.uint32)
    mine, ref = sampler.halton_tables(W, H), ref_sampler.halton_tables(W, H)
    np.testing.assert_array_equal(mine["offset"].numpy(), np.asarray(ref["offset"]))
    assert {k: v for k, v in mine.items() if k != "offset"} == {k: v for k, v in ref.items() if k != "offset"}
    mine_s, ref_s = sampler.sobol_tables(W, H, spp), ref_sampler.sobol_tables(W, H, spp)
    assert mine_s == ref_s and mine_s is not None
    pairs = [
        (sampler.halton_film_jitter(mine, _t(pids), _t(sample)),
         ref_sampler.halton_film_jitter(ref, jnp.asarray(pids.astype(np.uint32)), jnp.asarray(sample))),
        (sampler.halton_dim_2d(mine, _t(pids), _t(sample), 1),
         ref_sampler.halton_dim_2d(ref, jnp.asarray(pids.astype(np.uint32)), jnp.asarray(sample), 1)),
        (sampler.sobol_film_jitter(mine_s, _t(px), _t(py), _t(sample)),
         ref_sampler.sobol_film_jitter(ref_s, jnp.asarray(px.astype(np.int32)), jnp.asarray(py.astype(np.int32)),
                                       jnp.asarray(sample))),
        (sampler.sobol_dim_2d(mine_s, _t(px), _t(py), _t(sample), 1),
         ref_sampler.sobol_dim_2d(ref_s, jnp.asarray(px.astype(np.int32)), jnp.asarray(py.astype(np.int32)),
                                  jnp.asarray(sample), 1)),
    ]
    for got, want in pairs:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


FILTER_PARAMS = {"xwidth": 2.0, "ywidth": 1.5, "alpha": 2.0, "B": 1.0 / 3.0, "C": 1.0 / 3.0, "tau": 3.0}


@pytest.mark.parametrize("name", ["box", "triangle", "gaussian", "mitchell", "sinc", "lanczossinc", "unknown"])
def test_filter_offsets_match(name):
    """filter_offset's (dx, dy, w) against the reference's, on 10^5 uniform
    pairs and the ends of [0, 1). XLA:CPU's sqrt, log and sin differ from
    PyTorch's by an ulp, so offsets agree within atol 5e-5 pixels (Winitzki's
    erfinv of the gaussian cancels near 0, amplifying that ulp; the
    triangle's sqrt gives 1 ulp of 1.0) and weights within rtol 1e-6; box
    and mitchell are bit-exact. An unknown name is the box, as in the
    reference."""
    rs = np.random.RandomState(0)
    u = rs.random_sample((2, 100_000)).astype(np.float32)
    u[:, :3] = [[0.0, np.float32(1.0 - 2 ** -24), 0.5]] * 2
    got = render.filter_offset(name, FILTER_PARAMS, torch.as_tensor(u[0]), torch.as_tensor(u[1]))
    want = ref_render.filter_offset(name, FILTER_PARAMS, jnp.asarray(u[0]), jnp.asarray(u[1]))
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None
            continue
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == np.float32
        if name in ("box", "mitchell", "unknown"):
            np.testing.assert_array_equal(g, w)
        elif i < 2:
            np.testing.assert_allclose(g, w, rtol=0, atol=5e-5)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
    assert (got[2] is None) == (name not in ("mitchell", "sinc", "lanczossinc"))


class _Static:
    tex_programs = ()


REGEN = {
    "02-box": ("zerotwosequence", "box"),
    "halton-gaussian": ("halton", "gaussian"),
    "sobol-mitchell": ("sobol", "mitchell"),
    "maxmindist-triangle": ("maxmindist", "triangle"),
    "halton-sinc": ("halton", "sinc"),
}


@pytest.mark.parametrize("lens_radius", [0.0, 0.05])
@pytest.mark.parametrize("case", list(REGEN))
def test_make_regen_matches(lens_radius, case):
    """Camera rays and filter weights of make_regen against the reference's,
    with the halton and sobol film tables where make_persistent_fn puts
    them: within atol 1e-6, 5e-6 for the gaussian's directions (its offsets
    agree within 5e-5 pixels) and rtol 1e-6 for the sinc's weights
    (test_filter_offsets_match)."""
    kind, filt = REGEN[case]
    W, H = 40, 20
    ref_desc, desc = bench._mesh_scene(8), mesh_room(8)
    for dsc in (ref_desc, desc):
        dsc.film.x_resolution, dsc.film.y_resolution = W, H
        dsc.camera.lens_radius = lens_radius
        dsc.camera.focal_distance = 4.0
    ys, xs = np.mgrid[0:H, 0:W]
    px, py, pids = xs.ravel(), ys.ravel(), (ys * W + xs).ravel()
    scfg = {"kind": kind, "spp": 16}
    fcfg = {"filter": filt, "filter_params": FILTER_PARAMS, "max_sample_luminance": float("inf")}
    s_idx = np.arange(px.size) % 16
    ref_scfg, port_scfg = dict(scfg), dict(scfg)
    if kind == "halton":
        ref_scfg["halton"], port_scfg["halton"] = ref_sampler.halton_tables(W, H), sampler.halton_tables(W, H)
    elif kind == "sobol":
        ref_scfg["sobol"] = port_scfg["sobol"] = sampler.sobol_tables(W, H, 16)
    ref_regen = ref_render.make_regen(ref_make_camera(ref_desc.camera, ref_desc.film), _Static(), ref_scfg, fcfg,
                                      jnp.asarray(px.astype(np.int32)), jnp.asarray(py.astype(np.int32)),
                                      jnp.asarray(pids.astype(np.uint32)), jnp.uint32(SEED))
    o_r, d_r, w_r, _dx, _dy = (np.asarray(x) for x in ref_regen(jnp.asarray(s_idx.astype(np.uint32))))
    regen = render.make_regen(make_camera(desc.camera, desc.film, "cpu"), port_scfg, fcfg,
                              _t(px), _t(py), _t(pids), SEED)
    o, d, w, dx, dy = (x.numpy() for x in regen(_t(s_idx)))
    assert not dx.any() and not dy.any()  # no imagemap in the scene: no differentials, as the reference's zeros
    np.testing.assert_allclose(o, o_r, atol=1e-6, rtol=0)
    np.testing.assert_allclose(d, d_r, atol=5e-6 if filt == "gaussian" else 1e-6, rtol=0)
    np.testing.assert_allclose(w, w_r, atol=1e-6, rtol=1e-6 if filt in ("mitchell", "sinc") else 0)
    assert (w != 1.0).any() == (filt in ("mitchell", "sinc"))


def _radical_inverse_early_stop(base: int, index: np.ndarray) -> np.ndarray:
    """The wide megakernel's radical inverse (csrc/megakernel_wide.cu
    radical_inverse) transcribed: float32 digit sums, the loop leaving each
    lane when its index reaches 0."""
    bf = np.float32(base)
    inv = np.float32(1.0) / bf
    idx = index.astype(np.uint64)
    rd = np.zeros(idx.shape, np.float32)
    ibn = np.ones(idx.shape, np.float32)
    live = idx != 0
    while live.any():
        q = idx // base
        rd = np.where(live, rd * bf + (idx - q * base).astype(np.float32), rd)
        ibn = np.where(live, ibn * inv, ibn)
        idx = np.where(live, q, idx)
        live = idx != 0
    return np.minimum(rd * ibn, np.float32(rng.ONE_MINUS_EPS))


def test_radical_inverse_early_stop_bit_exact():
    """The kernel's digit loop, which stops at index 0, gives the bits of
    rng.radical_inverse_dyn's 32 fixed steps for every prime base (the
    bounce dimensions of a depth-5 render use base indices up to 77) at
    every sample index below 4,096 and at 4,096 random 32-bit indices (the
    film's global halton indices, base 3)."""
    rs = np.random.RandomState(13)
    index = np.concatenate([np.arange(4096), rs.randint(0, 2 ** 32, 4096, dtype=np.int64)])
    for b in range(len(rng.PRIMES)):
        want = rng.radical_inverse_dyn(torch.full((index.size,), b), torch.as_tensor(index)).numpy()
        got = _radical_inverse_early_stop(int(rng.PRIMES[b]), index)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=f"base {rng.PRIMES[b]}")
