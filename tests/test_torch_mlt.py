"""Metropolis light transport in the port, against the reference.

- the target: _l_fn at depths 0-2 of the BDPT test scene (a matte
  floor, a sphere area light, a point light, a glass sphere; 8 x 6) on the
  bootstrap's 256 primary-sample rows of RandomState(seed + 17), against
  the reference's _l_fn: the pixels and the splats' pixels equal, L, the
  splat values and the luminance within 2e-5 absolute (test_torch_bdpt.py's
  tolerance for the same strategies);
- the bootstrap: b_d (the mean luminance) within 1e-6 relative, and the
  chains numpy picks by luminance equal;
- one mlt_chain_step at depths 1 and 2 for the 256 picked chains (their
  current state the bootstrap's evaluation of their rows) with a step's
  key: the proposal's rows within 2e-6 (the small step's log and cos
  differ by ulps between XLA and PyTorch; the large step's and every uint32
  hash are equal bit for bit), every accept decision equal, the next state
  within 2e-5, the step's film (the port's float64 index_add_ against the
  reference's float32 segment sums) within 1e-5 of its largest value;
- the whole render of tests/test_bdpt.py:56's scene (the floor and the
  lamp, 12 x 9, depth 2) with 512 chains of 16 mutations a depth (228
  mutations per pixel) from 1,536 bootstrap samples (512 a depth: the
  reference's bootstrap and chains then share one shape, so its _l_fn
  compiles once a depth; 16,384 mutations, as many as the reference
  test's 64 chains of 128) against the reference's render_mlt: within
  1e-4 of the image's largest value (the chains take the same steps; the
  films differ by float32 rounding), and render_compiled's route and work
  counts;
- the front end: python -m pbrt_tpu_torch renders a written mlt file.

The reference's _l_fn and mlt_chain_step run op by op here (its jitted
BDPT costs a minute of this CPU to compile); its render_mlt runs as it is.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.device import camera as ref_camera
from pbrt_tpu.device import lights as ref_lights
from pbrt_tpu.device import mlt as ref_mlt
from pbrt_tpu.device.materials import make_bsdf as ref_make_bsdf
from pbrt_tpu.scene.builder import compile_scene as ref_compile_scene
from pbrt_tpu_torch import main as cli
from pbrt_tpu_torch import render, scenes
from pbrt_tpu_torch.device import bdpt, camera, lights, mlt
from pbrt_tpu_torch.scene.builder import compile_scene
from pbrt_tpu_torch.scene.host import IntegratorConfig
from test_torch_bdpt import bdpt_scene
from test_torch_megakernel import _to_ref
from test_torch_sppm import _floor_lamp
from torch_threads import one_torch_thread  # noqa: F401  (autouse: PyTorch single-threaded in this module)

SEED = 5
N_BOOT = 256
N_CHAINS = N_BOOT  # the bootstrap's lane count: the reference's op-by-op kernels are compiled per shape
DEPTHS = (0, 1, 2)


def _mlt_scene():
    desc = bdpt_scene()
    desc.integrator = IntegratorConfig(kind="mlt", max_depth=3, n_chains=N_CHAINS)
    return desc


@pytest.fixture(scope="module")
def both():
    """The scene compiled by both packages, with each one's camera, power
    CDF and lobe metadata, and the bootstrap's rows per depth."""
    desc = _mlt_scene()
    cs, ref = compile_scene(desc, "cpu"), ref_compile_scene(_to_ref(desc))
    W, H = desc.film.x_resolution, desc.film.y_resolution
    cam = camera.make_camera(desc.camera, desc.film, "cpu")
    cam_r = ref_camera.make_camera(ref.description.camera, ref.description.film)
    cdf = torch.cumsum(lights.compute_power(cs.arrays, cs.static), 0)
    cdf = cdf / cdf[-1]
    cdf_r = jnp.cumsum(ref_lights.compute_power(ref.arrays, ref.static))
    cdf_r = cdf_r / cdf_r[-1]
    possible = ref_make_bsdf(ref.arrays, ref.static, jnp.zeros(1, jnp.int32), jnp.zeros((1, 2), jnp.float32),
                             jnp.zeros((1, 3), jnp.float32))["possible"]
    rstate = np.random.RandomState(SEED + 17)
    rows = {d: rstate.rand(N_BOOT, mlt.DIMS).astype(np.float32) for d in DEPTHS}
    mine = dict(cs=cs, cam=cam, cdf=cdf, ctx=bdpt._Ctx(cs.arrays, cs.static))
    theirs = dict(ref=ref, cam=cam_r, cdf=cdf_r, possible=possible)
    return W, H, mine, theirs, rows


def _l_mine(m, u, depth, W, H):
    return mlt._l_fn(m["cs"].arrays, m["cs"].static, m["ctx"], m["cam"], m["cdf"], torch.as_tensor(u), depth, W, H)


def _l_theirs(t, u, depth, W, H):
    return ref_mlt._l_fn(t["ref"].arrays, t["ref"].static, t["possible"], t["cam"], t["cdf"], jnp.asarray(u), depth,
                         W, H)


@pytest.fixture(scope="module")
def targets(both):
    """Both packages' _l_fn on every depth's bootstrap rows."""
    W, H, mine, theirs, rows = both
    return {d: (_l_mine(mine, rows[d], d, W, H), _l_theirs(theirs, rows[d], d, W, H)) for d in DEPTHS}


@pytest.mark.parametrize("depth", DEPTHS)
def test_l_fn_matches_reference(targets, depth):
    (pix, L, spx, sval, lum), (pix_r, L_r, spx_r, sval_r, lum_r) = targets[depth]
    np.testing.assert_array_equal(pix.numpy(), np.asarray(pix_r))
    np.testing.assert_array_equal(spx.numpy(), np.asarray(spx_r))
    for a, b, name in ((L, L_r, "L"), (sval, sval_r, "splats"), (lum, lum_r, "luminance")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-5, err_msg=name)
    assert (np.asarray(lum_r) > 0).any()


def _picks(lum):
    """The bootstrap's b_d and the chains picked by luminance, as
    render_mlt draws them (the rows came first from the same stream)."""
    rstate = np.random.RandomState(SEED + 17)
    for _ in DEPTHS:
        rstate.rand(N_BOOT, mlt.DIMS)
    lum = np.where(np.isfinite(lum), lum, 0.0)
    return lum.mean(), rstate.choice(N_BOOT, size=N_CHAINS, p=lum / lum.sum())


@pytest.mark.parametrize("depth", DEPTHS)
def test_bootstrap_matches_reference(targets, depth):
    (_p, _L, _s, _v, lum), (_pr, _Lr, _sr, _vr, lum_r) = targets[depth]
    b, picks = _picks(lum.double().numpy())
    b_r, picks_r = _picks(np.asarray(lum_r, np.float64))
    assert b > 0
    np.testing.assert_allclose(b, b_r, rtol=1e-6)
    np.testing.assert_array_equal(picks, picks_r)


def _rows_of(target, picks, to):
    """_l_fn's tuple at the rows picks of its input (the splats are k
    blocks of the rows)."""
    pix, L, spx, sval, lum = (np.asarray(x) for x in target)
    k = spx.shape[0] // N_BOOT
    spx = spx.reshape(k, N_BOOT)[:, picks].reshape(-1)
    sval = sval.reshape(k, N_BOOT, 3)[:, picks].reshape(-1, 3)
    return tuple(to(np.array(x)) for x in (pix[picks], L[picks], spx, sval, lum[picks]))


@pytest.mark.parametrize("depth", DEPTHS[1:])
def test_chain_step_matches_reference(both, targets, depth):
    """One mutation of the chains picked at this depth: the same rows, the
    same key, each package's own evaluation of the current state."""
    W, H, mine, theirs, rows = both
    (_p, _L, _s, _v, lum), _theirs = targets[depth]
    _b, picks = _picks(lum.double().numpy())
    u_cur = rows[depth][picks]
    key = SEED * 7919 + depth * 104729 + 3
    cs, ref = mine["cs"], theirs["ref"]
    cur = _rows_of(targets[depth][0], picks, torch.as_tensor)
    film = torch.zeros((W * H + 1, 3), dtype=torch.float64)
    u_n, nxt, acc = mlt.mlt_chain_step(cs.arrays, cs.static, mine["ctx"], mine["cam"], mine["cdf"], depth, W, H,
                                       mlt.SIGMA, mlt.P_LARGE, torch.arange(N_CHAINS), torch.as_tensor(u_cur), cur,
                                       key, film)
    cur_r = _rows_of(targets[depth][1], picks, jnp.asarray)
    u_r, nxt_r, fs_r = ref_mlt.mlt_chain_step(ref.arrays, ref.static, theirs["possible"], theirs["cam"],
                                              theirs["cdf"], depth, W, H, ref_mlt.SIGMA, ref_mlt.P_LARGE,
                                              jnp.arange(N_CHAINS, dtype=jnp.uint32), jnp.asarray(u_cur), cur_r,
                                              jnp.uint32(key))
    np.testing.assert_allclose(u_n.numpy(), np.asarray(u_r), rtol=0, atol=2e-6)
    moved = ~np.all(np.asarray(u_r) == u_cur, axis=1)
    np.testing.assert_array_equal(acc.numpy(), moved)
    assert 0 < moved.sum() < N_CHAINS
    np.testing.assert_array_equal(nxt[0].numpy(), np.asarray(nxt_r[0]))
    np.testing.assert_array_equal(nxt[2].numpy(), np.asarray(nxt_r[2]))
    for i in (1, 3, 4):
        np.testing.assert_allclose(nxt[i].numpy(), np.asarray(nxt_r[i]), rtol=0, atol=2e-5)
    fs = film[:W * H].numpy()
    fs_r = np.asarray(fs_r, np.float64)
    assert fs_r.max() > 0
    np.testing.assert_allclose(fs, fs_r, rtol=0, atol=1e-5 * fs_r.max())


def test_render_mlt_matches_reference():
    """render_compiled of the reference MLT test's scene against the
    reference's render_mlt, and the route's work counts."""
    desc = _floor_lamp(IntegratorConfig(kind="mlt", max_depth=2, mutations_per_pixel=228, n_bootstrap=1536,
                                        n_chains=512))
    cs = compile_scene(desc, "cpu")
    img = render.render_compiled(cs, seed=1)
    tm = render.render_compiled.last_timing
    img_r = ref_mlt.render_mlt(ref_compile_scene(_to_ref(desc)), seed=1)
    assert tm["tier"] == "torch-mlt/brute"
    # n_mut = 228 x 108 // (512 x 3) = 16 steps, one block, at depths 0 and 1 (depth 2 carries no light)
    assert tm["chain_steps"] == 2 * 16 and tm["mutations"] == 2 * 16 * 512
    assert 0.2 < tm["acceptance"] < 0.95 and tm["wall_s"] > 0
    assert np.isfinite(img).all() and img.mean() > 0.01
    np.testing.assert_allclose(img, img_r, rtol=0, atol=1e-4 * img_r.max())


def test_cli_renders_mlt(tmp_path):
    """python -m pbrt_tpu_torch on a written mlt file: the whole film."""
    desc = _floor_lamp(IntegratorConfig(kind="mlt", max_depth=1, mutations_per_pixel=4, n_bootstrap=512,
                                        n_chains=16))
    path = str(tmp_path / "mlt.pbrt")
    scenes.write_pbrt(desc, path, ([0, 2, 4], [0, 0.5, 0], [0, 1, 0]))
    assert cli.main([path, "--device", "cpu", "--quiet", "-o", str(tmp_path / "m.pfm")]) == 0
    assert cli.main.last_run["timing"]["tier"] == "torch-mlt/brute"
