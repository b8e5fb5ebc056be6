"""Metropolis light transport (PSSMLT over BDPT).

The port's counterpart of ``pbrt_tpu/device/mlt.py`` (src/integrators/
mlt.rs): every Markov chain is a row of a (chains, 160) array of primary
samples, mutated in bulk, and the target function is the port's BDPT
(``device/bdpt.py``) evaluated on those rows through its ``("array", u)``
sample provider: columns 0-1 give the raster position, 2-3 the lens, 4-63
the camera walk, 64-127 the light subpath (its light choice, emitted ray
and walk) and 128+ the connections' light samples.

The reference's deviations from pbrt are its semantics, kept here:

- chains are grouped per path depth, and each depth runs its own
  bootstrap and normalisation (b_d);
- the target at depth d is the full MIS-weighted BDPT estimate over every
  (s, t) with s + t - 2 = d, the t = 1 splats folded into its luminance;
- a small step is one wrapped-Gaussian perturbation of every dimension
  (not pbrt's lazily accumulated exponential form).

The mutation stream is the reference's, bit for bit: each step hashes the
key ``seed * 7919 + depth * 104729 + m`` (uint32, wrapping) with the chain
index, and every uint32 product and sum wraps mod 2^32 as the reference's
do. Acceptance is a = clip(L_new / L_old, 0, 1), and both states splat,
weighted by a / L_new and (1 - a) / L_old (expected-value splatting). The
current state's evaluation rides between steps, so a step evaluates the
proposal alone.

Host loop: a block of K steps (``PBRT_TPU_MLT_K``, 32 by default, read
where the route is built) runs with no host read: the keys are Python
integers, the film is a float64 tensor on the device that every step adds
into with ``index_add_``, and the accept count stays on the device. The
host reads the bootstrap's luminances once per depth (its chain picks are
numpy's, as the reference's are) and the film once, at the end.
"""
from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from . import rng
from .bdpt import _Ctx, connect_bdpt, connect_t1, generate_camera_subpath, generate_light_subpath
from .camera import make_camera
from .lights import compute_power

log = logging.getLogger(__name__)

SIGMA = 0.01
P_LARGE = 0.3
DIMS = 160  # primary samples per chain
LIGHT_COL = 64  # the light subpath's first column
CONNECT_COL = 128  # the connections' first column
DEFAULT_K = 32  # mutations per block


def _luminance(c):
    return 0.212671 * c[..., 0] + 0.715160 * c[..., 1] + 0.072169 * c[..., 2]


def _mul32(a, c: int):
    """a * c mod 2^32 for uint32 values a (an int64 tensor) and a constant
    c, in two 16-bit halves so that no product leaves int64."""
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & rng.MASK32


def _l_fn(sa, static, ctx, cam, power_cdf, u, depth: int, W: int, H: int):
    """The depth-d target at primary samples u (R, 160): (pixel (R,), L (R,
    3), splat pixels (k R,), splat values (k R, 3), luminance (R,)), the
    luminance L's plus that of the t = 1 splats."""
    R = u.shape[0]
    prov = ("array", u)
    max_t = depth + 2
    max_s = depth + 1
    px_f = u[:, 0] * W
    py_f = u[:, 1] * H
    px = torch.clamp(px_f.to(torch.int64), 0, W - 1)
    py = torch.clamp(py_f.to(torch.int64), 0, H - 1)
    cam_v, n_cam = generate_camera_subpath(sa, static, ctx, prov, cam, px_f, py_f, max_t)
    light_v, n_light = generate_light_subpath(sa, static, ctx, ("array", u[:, LIGHT_COL:]), 0, power_cdf, max_s, R)
    L = torch.zeros((R, 3), dtype=torch.float32, device=u.device)
    spx, sval = [], []
    for t in range(1, max_t + 1):
        s = depth + 2 - t
        if s < 0 or s > max_s or (s == 1 and t == 1):
            continue
        if t == 1:
            if s < 2:
                continue
            sp = connect_t1(sa, static, ctx, cam, cam_v, light_v, n_light, s, W, H)
            spx.append(sp["pixel"])
            sval.append(sp["value"])
        else:
            c, _w = connect_bdpt(sa, static, ctx, cam, ("array", u[:, CONNECT_COL:]), cam_v, n_cam, light_v, n_light,
                                 s, t, 0)
            L = L + c
    lum = _luminance(L)
    if spx:
        spx_c, sval_c = torch.cat(spx), torch.cat(sval)
        lum = lum + _luminance(sval_c).reshape(len(spx), R).sum(0)
    else:
        spx_c = torch.zeros(0, dtype=torch.int64, device=u.device)
        sval_c = torch.zeros((0, 3), dtype=torch.float32, device=u.device)
    return py * W + px, L, spx_c, sval_c, lum


def _propose(u_cur, chain_ids, key: int, sigma: float, p_large: float):
    """The proposal of every chain for the step key: (u_prop, key2), a large
    step (fresh uniforms) with probability p_large, else one wrapped
    Gaussian step of every dimension (mlt.rs's mutate, the reference's
    form)."""
    D = u_cur.shape[1]
    dims = torch.arange(D, dtype=torch.int64, device=u_cur.device)
    k = rng.pcg_hash((key + _mul32(chain_ids, 0x9E3779B1)) & rng.MASK32)
    u_large = rng.u32_to_float(rng.pcg_hash((_mul32(k, 2654435761)[:, None] + dims[None, :]) & rng.MASK32))
    key2 = rng.pcg_hash(k ^ 0x85EBCA6B)
    is_large = rng.u32_to_float(key2) < p_large
    ga = rng.u32_to_float(rng.pcg_hash((key2[:, None] + _mul32(dims, 0xC2B2AE35)[None, :]) & rng.MASK32))
    gb = rng.u32_to_float(rng.pcg_hash(key2[:, None] ^ _mul32(dims, 0x27D4EB2F)[None, :]))
    z = torch.sqrt(-2.0 * torch.log(torch.clamp(ga, min=1e-12))) * torch.cos(2.0 * np.pi * gb)
    u_small = u_cur + sigma * z
    u_small = u_small - torch.floor(u_small)
    return torch.where(is_large[:, None], u_large, u_small), key2


def _weights(cur, new):
    """The acceptance a = clip(L_new / L_old, 0, 1) and the step's splats,
    both states weighted (expected-value splatting): (a (R,), pixels,
    values) of the current state, weight (1 - a) / L_old, and the
    proposal, weight a / L_new, their t = 1 splats with them."""
    pix_o, L_o, spx_o, sval_o, lum_o = cur
    pix_n, L_n, spx_n, sval_n, lum_n = new
    R = pix_o.shape[0]
    a = torch.clamp(lum_n / torch.clamp(lum_o, min=1e-12), 0.0, 1.0)
    w_new = a / torch.clamp(lum_n, min=1e-12)
    w_old = (1.0 - a) / torch.clamp(lum_o, min=1e-12)
    k = spx_n.shape[0] // R if R else 0
    pixels = torch.cat([pix_n, pix_o, spx_n, spx_o])
    values = torch.cat([L_n * w_new[:, None], L_o * w_old[:, None], sval_n * w_new.repeat(k)[:, None],
                        sval_o * w_old.repeat(k)[:, None]])
    return a, pixels, values


def _splat_step(film, pixel, value):
    """Add a step's splats into the float64 film (its last row takes those
    that land nowhere)."""
    film.index_add_(0, pixel, value.to(torch.float64))


def _accept(a, key2, cur, new, u_cur, u_prop):
    """The accept decisions (R,) for acceptance a, and the next rows and
    state: (u_next, the next state, accepted)."""
    R = u_cur.shape[0]
    accept = rng.u32_to_float(rng.pcg_hash((key2 + 0x165667B1) & rng.MASK32)) < a
    k = new[2].shape[0] // R if R else 0
    acc_k = accept.repeat(k)
    nxt = tuple(torch.where(m.view((-1,) + (1,) * (x.dim() - 1)), x, y)
                for m, x, y in zip((accept, accept, acc_k, acc_k, accept), new, cur))
    return torch.where(accept[:, None], u_prop, u_cur), nxt, accept


def mlt_chain_step(sa, static, ctx, cam, cdf, depth, W, H, sigma, p_large, chain_ids, u_cur, cur, key: int, film):
    """One Metropolis mutation of every chain (the reference's
    mlt_chain_step): chain_ids (R,) the chains' global indices, cur the
    current state's evaluation (_l_fn's tuple), key the step's uint32 key
    (a Python integer). Adds the step's splats into film (float64 (W H + 1,
    3)) and returns (u_next, cur_next, accepted (R,))."""
    u_prop, key2 = _propose(u_cur, chain_ids, key, sigma, p_large)
    new = _l_fn(sa, static, ctx, cam, cdf, u_prop, depth, W, H)
    a, pixels, values = _weights(cur, new)
    _splat_step(film, pixels, values)
    return _accept(a, key2, cur, new, u_cur, u_prop)


def mlt_block(sa, static, ctx, cam, cdf, depth, W, H, sigma, p_large, chain_ids, u_cur, cur, key0: int, m0: int,
              K: int, film, accepted, trace=None):
    """K mutations of every chain, steps m0 .. m0 + K - 1 of the depth
    whose key base is key0 (the reference's K-step scan): no host read
    between them; the splats add into film, the accepted proposals into
    accepted (an int64 0-d tensor on the device). trace: a list that
    takes each step's accept decisions (R,), on the device. Returns (u,
    cur)."""
    for m in range(m0, m0 + K):
        u_cur, cur, acc = mlt_chain_step(sa, static, ctx, cam, cdf, depth, W, H, sigma, p_large, chain_ids, u_cur,
                                         cur, (key0 + m) & rng.MASK32, film)
        accepted += acc.sum()
        if trace is not None:
            trace.append(acc)
    return u_cur, cur


def _bootstrap(sa, static, ctx, cam, cdf, u_boot, depth, W, H):
    """The luminances of the bootstrap samples, read to the host (float64,
    non-finite values as 0)."""
    lum = _l_fn(sa, static, ctx, cam, cdf, u_boot, depth, W, H)[4]
    lum = lum.double().cpu().numpy()
    return np.where(np.isfinite(lum), lum, 0.0)


def render_mlt(cs, seed: int = 0, progress=None, trace=None):
    """The MLT host loop, per depth d = 0 .. max_depth: a bootstrap of
    max(n_bootstrap // (max_depth + 1), 256) samples from
    RandomState(seed + 17), b_d their mean luminance, n_chains chains
    picked by luminance, n_mut = max(mpp n_pix // (n_chains (max_depth +
    1)), 1) mutations in blocks of K (n_mut rounded up to a whole number of
    blocks), the depth's film scaled by b_d n_pix / (n_mut n_chains).
    Renders the whole film (no crop, as the reference's). Returns the (H,
    W, 3) float32 image; records ``render_mlt.last_timing`` {"seconds",
    "mutations", "chain_steps", "accepted", "acceptance", "depths": per
    depth its b, mutations, block, and the seconds of its bootstrap and of
    its chains (each span ends with the host's read of its result)}. trace:
    a list that takes every step's accept decisions (mlt_block)."""
    desc = cs.description
    sa, static = cs.arrays, cs.static
    dev = sa.device
    cam = make_camera(desc.camera, desc.film, dev)
    W, H = desc.film.x_resolution, desc.film.y_resolution
    n_pix = W * H
    ic = desc.integrator
    max_depth = max(int(ic.max_depth), 1)
    n_boot = max(int(ic.n_bootstrap) // (max_depth + 1), 256)
    n_chains = max(int(ic.n_chains), 8)
    mpp = int(ic.mutations_per_pixel)
    sigma = float(ic.sigma) or SIGMA
    p_large = float(ic.large_step_probability) or P_LARGE
    k_env = int(os.environ.get("PBRT_TPU_MLT_K", str(DEFAULT_K)))
    power = compute_power(sa, static)
    cdf = torch.cumsum(power, 0)
    cdf = cdf / torch.clamp(cdf[-1], min=1e-12)
    ctx = _Ctx(sa, static)
    rstate = np.random.RandomState(seed + 17)
    film = torch.zeros((n_pix, 3), dtype=torch.float64, device=dev)
    chain_ids = torch.arange(n_chains, dtype=torch.int64, device=dev)
    accepted = torch.zeros((), dtype=torch.int64, device=dev)
    mutations = steps = 0
    depths = []
    t0 = time.perf_counter()
    for depth in range(max_depth + 1):
        t_d = time.perf_counter()
        u_np = rstate.rand(n_boot, DIMS).astype(np.float32)
        lum = _bootstrap(sa, static, ctx, cam, cdf, torch.as_tensor(u_np, device=dev), depth, W, H)
        b_d = lum.mean()
        boot_s = time.perf_counter() - t_d
        if b_d <= 0:
            depths.append({"depth": depth, "b": 0.0, "mutations": 0, "bootstrap_s": boot_s, "chain_s": 0.0})
            continue
        picks = rstate.choice(n_boot, size=n_chains, p=lum / lum.sum())
        u_cur = torch.as_tensor(u_np[picks], device=dev)
        n_mut = max((mpp * n_pix) // (n_chains * (max_depth + 1)), 1)
        K = min(k_env, n_mut)
        n_blocks = -(-n_mut // K)
        n_mut = n_blocks * K
        cur = _l_fn(sa, static, ctx, cam, cdf, u_cur, depth, W, H)
        accum = torch.zeros((n_pix + 1, 3), dtype=torch.float64, device=dev)
        key0 = seed * 7919 + depth * 104729
        for blk in range(n_blocks):
            u_cur, cur = mlt_block(sa, static, ctx, cam, cdf, depth, W, H, sigma, p_large, chain_ids, u_cur, cur,
                                   key0, blk * K, K, accum, accepted, trace)
        mutations += n_mut * n_chains
        steps += n_mut
        film += accum[:n_pix] * (float(b_d) * n_pix / max(n_mut * n_chains, 1))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        depths.append({"depth": depth, "b": float(b_d), "mutations": n_mut, "block": K, "bootstrap_s": boot_s,
                       "chain_s": time.perf_counter() - t_d - boot_s})
        if progress:
            progress(depth + 1, max_depth + 1)
    img = film.reshape(H, W, 3).to(torch.float32).cpu().numpy()
    seconds = time.perf_counter() - t0
    n_acc = int(accepted)
    render_mlt.last_timing = {"seconds": seconds, "mutations": mutations, "chain_steps": steps, "accepted": n_acc,
                              "acceptance": n_acc / max(mutations, 1), "chains": n_chains, "depths": depths}
    log.info("mlt: %d mutations (%d chain steps of %d chains) in %.1fs", mutations, steps, n_chains, seconds)
    return img


render_mlt.last_timing = None
