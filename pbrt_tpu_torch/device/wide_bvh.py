"""Wide-BVH ray queries: the hand-written CUDA traversal kernels and their
plain PyTorch twin.

The port's counterpart of ``pbrt_tpu/device/pallas_bvh.py``. The TPU kernel
(``_traverse_kernel_impl``) walks 256-ray packets over one shared stack; the
CUDA kernel (``csrc/wide_traverse.cu``, B1) gives every ray its own stack
and keeps persistent lanes busy from a ray queue, and reads the Hopper
layout of the same tree (``tables.wnode_rec``, ``tables.wleaf_rec``,
``scene/widebvh.hopper_layout``) with the same box test, watertight
triangle test and tie rules, so hits agree with the reference up to
packet-versus-ray visit order.

The joint kernel (``csrc/wide_traverse_joint.cu``, B2, the counterpart of
``pallas_bvh._traverse_kernel_joint``) has the same contract: a group of 4
lanes walks one ray together, and a ray's results are B1's bit for bit.
The wavefront takes it when its route is built with PBRT_TPU_JOINT=1
(render.make_persistent_fn).

``wide_intersect`` launches a kernel for CUDA tensors and runs
``wide_intersect_plain`` only for CPU tensors; it never falls back from one
to the other. The plain version is the same per-ray traversal on the same
records vectorised over rays with an (R, 72) stack tensor, looping until
every stack is empty.

The kernels are compiled with nvcc at their first launch (device/nvcc.py)
and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import nvcc

STACK = 72  # stack entries (node, child mask, direction) per ray
EPS = 1e-4  # watertight test t_min (intersect.SHADOW_EPS)
ITER_CAP = 1_000_000  # pops per ray; a safety valve only
SORT_MIN_RAYS = 512  # the reference sorts only waves of >= 2 packets

KERNEL_SOURCE = nvcc.CSRC / "wide_traverse.cu"
JOINT_SOURCE = nvcc.CSRC / "wide_traverse_joint.cu"


# ---------------------------------------------------------------------------
# Build and bind (device/nvcc.py: nvcc -> shared library -> ctypes)
# ---------------------------------------------------------------------------


# o, d, t_max, n_rays, node_rec, leaf_rec, any_hit, t, idx, b1, b2, pops,
# counters, iters, queue, stream
_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]


def _bind(source, entry) -> dict:
    info = nvcc.build(source)
    fn = getattr(info["lib"], entry)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return info


def build_kernel() -> dict:
    """Compile (if needed) and load the traversal kernel library:
    {"lib", "seconds", "log", "path"} as device/nvcc.build returns it."""
    return _bind(KERNEL_SOURCE, "wide_traverse")


def build_joint_kernel() -> dict:
    """build_kernel for the cooperative traversal kernel
    (csrc/wide_traverse_joint.cu), whose C entry takes B1's arguments."""
    return _bind(JOINT_SOURCE, "wide_traverse_joint")


def joint_group_width() -> int:
    """Lanes per ray of the cooperative kernel (its GW)."""
    return build_joint_kernel()["lib"].wide_traverse_joint_group_width()


def _check_tables(tables, device):
    for name, cols in (("wnode_rec", 64), ("wleaf_rec", 16)):
        t = getattr(tables, name)
        if t is None or t.device != device or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.dim() != 2 or t.shape[1] != cols:
            raise ValueError(f"{name} must be a contiguous float32 (N, {cols}) tensor on {device}")


def _state(wrapper, dev, stream):
    """The wrapper's per-device counters and iteration sum, and its ray queue
    for this stream (zeroed once here; each launch's last block re-zeroes it)."""
    counters = wrapper.counters.get(dev)
    if counters is None:  # setdefault: a shard thread that loses the race takes the winner's tensor
        counters = wrapper.counters.setdefault(dev, torch.zeros(2, dtype=torch.int32, device=dev))
    iters = wrapper.iterations.get(dev)
    if iters is None:
        iters = wrapper.iterations.setdefault(dev, torch.zeros(1, dtype=torch.int64, device=dev))
    queue = wrapper.queues.get((dev, stream))
    if queue is None:
        queue = wrapper.queues.setdefault((dev, stream), torch.zeros(2, dtype=torch.int32, device=dev))
    return counters, iters, queue


def _launch(wrapper, fn, tables, o, d, t_max, any_hit):
    """Check the inputs, launch fn (one of the C entries) on the current
    stream and count the launch on wrapper; returns (t, idx, b1, b2, pops)."""
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"{wrapper.__name__} takes CUDA tensors")
    for name, x, shape in (("o", o, (o.shape[0], 3)), ("d", d, (o.shape[0], 3)),
                           ("t_max", t_max, (o.shape[0],))):
        if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous() or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be a contiguous float32 {shape} tensor on {dev}")
    _check_tables(tables, dev)
    R = o.shape[0]
    t = torch.empty(R, dtype=torch.float32, device=dev)
    idx = torch.empty(R, dtype=torch.int32, device=dev)
    b1 = torch.empty(R, dtype=torch.float32, device=dev)
    b2 = torch.empty(R, dtype=torch.float32, device=dev)
    pops = torch.empty(R, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    counters, iters, queue = _state(wrapper, dev, stream)
    with torch.cuda.device(dev):  # the C entry launches on the calling thread's current device
        err = fn(o.data_ptr(), d.data_ptr(), t_max.data_ptr(), R,
                 tables.wnode_rec.data_ptr(), tables.wleaf_rec.data_ptr(), int(bool(any_hit)),
                 t.data_ptr(), idx.data_ptr(), b1.data_ptr(), b2.data_ptr(), pops.data_ptr(),
                 counters.data_ptr(), iters.data_ptr(), queue.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {err}")
    nvcc.count_launch(wrapper)
    return t, idx, b1, b2, pops


def traverse_cuda(tables, o, d, t_max, any_hit: bool):
    """Launch the CUDA kernel. Returns (t, idx, b1, b2, pops): idx is the
    global prim row (closest hit) or the kernel slot (any hit), -1 on a
    miss. Adds one to ``traverse_cuda.launches`` per launch; stack overflows
    and iteration-cap hits accumulate in ``traverse_cuda.counters``, the
    warps' loop iterations in ``traverse_cuda.iterations`` (sum(pops) /
    (32 x iterations) is the share of lanes holding a ray)."""
    return _launch(traverse_cuda, build_kernel()["lib"].wide_traverse, tables, o, d, t_max, any_hit)


traverse_cuda.launches = 0
traverse_cuda.counters = {}  # device -> int32 (2,): stack overflows, iteration-cap hits
traverse_cuda.iterations = {}  # device -> int64 (1,): warp loop iterations with a pop
traverse_cuda.queues = {}  # (device, stream) -> int32 (2,): next ray id, finished blocks


def traverse_joint_cuda(tables, o, d, t_max, any_hit: bool):
    """Launch the cooperative traversal kernel (B2). Same contract and
    results as traverse_cuda; counts in ``traverse_joint_cuda.launches``,
    ``.counters`` and ``.iterations`` (sum(pops) / (32 / joint_group_width()
    x iterations) is the share of lane groups holding a ray)."""
    return _launch(traverse_joint_cuda, build_joint_kernel()["lib"].wide_traverse_joint, tables, o, d, t_max,
                   any_hit)


traverse_joint_cuda.launches = 0
traverse_joint_cuda.counters = {}  # device -> int32 (2,): stack overflows, iteration-cap hits
traverse_joint_cuda.iterations = {}  # device -> int64 (1,): warp loop iterations with a pop
traverse_joint_cuda.queues = {}  # (device, stream) -> int32 (2,): next ray id, finished blocks


# ---------------------------------------------------------------------------
# Plain PyTorch traversal (the kernel's twin)
# ---------------------------------------------------------------------------


def _ray_setup(o, d):
    """pack_rays' per-ray constants: (1/d (R,3), kz (R,), sx, sy, sz)."""
    def clamp_tiny(x):
        return torch.where(x.abs() < 1e-30, torch.where(x < 0, -1e-30, 1e-30), x)

    inv_d = 1.0 / clamp_tiny(d)
    kz = torch.argmax(d.abs(), dim=1)  # first index on ties
    k0 = kz == 0
    k1 = kz == 1

    def sel(i0, i1, i2):
        return torch.where(k0, d[:, i0], torch.where(k1, d[:, i1], d[:, i2]))

    dkx, dky, dkz = sel(1, 2, 0), sel(2, 0, 1), sel(0, 1, 2)
    inv_dkz = 1.0 / clamp_tiny(dkz)
    return inv_d, kz, -dkx * inv_dkz, -dky * inv_dkz, inv_dkz


def _bit_tables(device):
    """Lowest / highest set-bit index of every 8-bit child mask."""
    low = torch.tensor([0] + [(v & -v).bit_length() - 1 for v in range(1, 256)], device=device)
    high = torch.tensor([0] + [v.bit_length() - 1 for v in range(1, 256)], device=device)
    return low, high


def traverse_plain(tables, o, d, t_max, any_hit: bool):
    """The kernels' traversal in plain PyTorch, on any device, on the same
    Hopper records with the same stack entries; same outputs as
    traverse_cuda plus the (stack overflow, iteration cap) counts."""
    dev = o.device
    R = o.shape[0]
    nodes = tables.wnode_rec.view(-1, 8, 8)  # node -> (child, [lo, hi, meta, axis])
    metas = tables.wnode_rec.view(torch.int32).view(-1, 8, 8)[:, :, 6].to(torch.int64)
    leaves = tables.wleaf_rec.view(-1, 16, 16)  # leaf -> (row j, 16 floats)
    low_bit, high_bit = _bit_tables(dev)
    pw2 = 2 ** torch.arange(8, device=dev)
    iota16 = torch.arange(16, device=dev)

    inv_d, kz, sx, sy, sz = _ray_setup(o, d)
    dir_neg = d < 0
    stack = torch.zeros((R, STACK), dtype=torch.int64, device=dev)
    stack[:, 0] = 1 << 1  # sentinel parent 0, child 0 = the root
    sp = torch.where(t_max > 0, 1, 0).to(torch.int64)
    t_best = t_max.clone()
    idx = torch.full((R,), -1, dtype=torch.int64, device=dev)
    b1 = torch.zeros(R, dtype=torch.float32, device=dev)
    b2 = torch.zeros(R, dtype=torch.float32, device=dev)
    pops = torch.zeros(R, dtype=torch.int64, device=dev)
    overflow = 0
    capped = 0

    # every ray pops once per iteration until its stack empties, so a ray
    # still live after ITER_CAP iterations has popped ITER_CAP times
    for it in range(ITER_CAP + 1):
        act = torch.nonzero(sp > 0).squeeze(1)
        if act.numel() == 0:
            break
        if it == ITER_CAP:
            capped = act.numel()
            break
        spa = sp[act]
        top = stack[act, spa - 1]
        dirb = top & 1
        m = (top >> 1) & 255
        pn = top >> 9
        k = torch.where(dirb > 0, high_bit[m], low_bit[m])
        m2 = m & ~(1 << k)
        stack[act, spa - 1] = (pn << 9) | (m2 << 1) | dirb
        sp_pop = torch.where(m2 == 0, spa - 1, spa)
        pops[act] += 1
        e = metas[pn, k]  # the child's meta, from the parent's record

        # --- interior: 8-child slab test, push the hit mask ---
        is_int = e > 0
        ia = act[is_int]
        if ia.numel():
            ei = e[is_int]
            nid = ei & 0x1FFFFF
            box = nodes[nid]  # (A, 8, 8)
            o_i = o[ia][:, None, :]
            inv_i = inv_d[ia][:, None, :]
            t0 = (box[:, :, 0:3] - o_i) * inv_i
            t1 = (box[:, :, 3:6] - o_i) * inv_i
            tmin3 = torch.minimum(t0, t1)
            tmax3 = torch.maximum(t0, t1)
            tn = torch.maximum(torch.maximum(tmin3[..., 0], tmin3[..., 1]), tmin3[..., 2])
            tf = torch.minimum(torch.minimum(tmax3[..., 0], tmax3[..., 1]), tmax3[..., 2]) * 1.0000004
            bhit = (tn <= tf) & (tf > 0) & (tn < t_best[ia][:, None]) & (metas[nid] != 0)
            mask_new = (bhit.to(torch.int64) * pw2).sum(1)
            dir_new = dir_neg[ia].gather(1, (ei >> 21)[:, None]).squeeze(1).to(torch.int64)
            spi = sp_pop[is_int]
            push = mask_new != 0
            over = push & (spi >= STACK)
            if bool(over.any()):
                overflow += int(over.sum())
                push = push & ~over
            pr = ia[push]
            stack[pr, spi[push]] = (nid[push] << 9) | (mask_new[push] << 1) | dir_new[push]
            sp_pop[is_int] = spi + push.to(torch.int64)

        # --- leaf: watertight test of its n valid rows ---
        il = act[~is_int]
        if il.numel():
            x = ~e[~is_int]
            leaf = x >> 4
            tri = leaves[leaf]  # (A, 16, 16)
            valid = iota16 < ((x & 15) + 1)[:, None]
            ol = o[il]
            k0 = (kz[il] == 0)[:, None]
            k1 = (kz[il] == 1)[:, None]
            sxl, syl, szl = sx[il][:, None], sy[il][:, None], sz[il][:, None]

            def shear(j):
                vx = tri[:, :, 3 * j] - ol[:, 0:1]
                vy = tri[:, :, 3 * j + 1] - ol[:, 1:2]
                vz = tri[:, :, 3 * j + 2] - ol[:, 2:3]
                px = torch.where(k0, vy, torch.where(k1, vz, vx))
                py = torch.where(k0, vz, torch.where(k1, vx, vy))
                pz = torch.where(k0, vx, torch.where(k1, vy, vz))
                return px + sxl * pz, py + syl * pz, szl * pz

            x0, y0, z0 = shear(0)
            x1, y1, z1 = shear(1)
            x2, y2, z2 = shear(2)
            e0 = x1 * y2 - y1 * x2
            e1 = x2 * y0 - y2 * x0
            e2 = x0 * y1 - y0 * x1
            same = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0))
            det = e0 + e1 + e2
            dok = det != 0
            inv = 1.0 / torch.where(dok, det, 1.0)
            t = (e0 * z0 + e1 * z1 + e2 * z2) * inv
            tb = t_best[il][:, None]
            phit = valid & same & dok & (t > EPS) & (t < tb)
            tc = torch.where(phit, t, 1e30)
            tmin = tc.min(dim=1).values
            improved = tmin < torch.clamp(t_best[il], max=1e29)
            # highest row among equal t
            jwin = torch.where(tc == tmin[:, None], iota16, -1).max(dim=1).values
            win = jwin[:, None]
            if any_hit:
                new_idx = leaf * 16 + jwin  # the kernel slot oct * 8 + j
            else:
                new_idx = tri[:, :, 10].gather(1, win).squeeze(1).to(torch.int64)
            ri = il[improved]
            t_best[ri] = tmin[improved]
            idx[ri] = new_idx[improved]
            b1[ri] = (e1 * inv).gather(1, win).squeeze(1)[improved]
            b2[ri] = (e2 * inv).gather(1, win).squeeze(1)[improved]
            if any_hit:
                sp_leaf = sp_pop[~is_int]
                sp_pop[~is_int] = torch.where(improved, 0, sp_leaf)

        sp[act] = sp_pop

    return t_best, idx, b1, b2, pops, (overflow, capped)


# ---------------------------------------------------------------------------
# Coherence sort and the public query
# ---------------------------------------------------------------------------


def _morton10(q):
    """Interleave 10-bit ints (R, 3) -> 30-bit Morton codes (int64)."""
    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def coherence_keys(o, d, world_lo, world_inv_extent):
    """Sort keys grouping rays by direction octant, origin locality, then
    direction locality (pallas_bvh.coherence_keys): bits 30..28 direction
    octant, 27..12 origin Morton code, 11..0 direction Morton code; bit 31
    is left for the dead flag."""
    oc = (d[:, 0] > 0).to(torch.int64) * 4 + (d[:, 1] > 0).to(torch.int64) * 2 + (d[:, 2] > 0).to(torch.int64)
    q = torch.clamp((o - world_lo) * world_inv_extent * 1024.0, 0.0, 1023.0).to(torch.int64)
    qd = torch.clamp(d.abs() * 15.999, 0.0, 15.0).to(torch.int64)
    dm = _morton10(qd)
    return (oc << 28) | ((_morton10(q) >> 14) << 12) | (dm & 0xFFF)


def _query(traverse, tables, o, d, t_max, any_hit, sort):
    R = o.shape[0]
    t_arr = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=o.device), (R,))
    o = o.contiguous()
    d = d.contiguous()
    t_arr = t_arr.contiguous()
    perm = None
    if sort and R >= SORT_MIN_RAYS:
        lo = tables.world_center - tables.world_radius
        inv_ext = 1.0 / torch.clamp(2.0 * tables.world_radius, min=1e-20)
        keys = coherence_keys(o, d, lo, inv_ext)
        # dead lanes (t_max <= 0) sort to the back
        keys = torch.where(t_arr > 0, keys, 0xFFFFFFFF)
        perm = torch.argsort(keys, stable=True)
        o, d, t_arr = o[perm], d[perm], t_arr[perm]
    t, idx, b1, b2 = traverse(tables, o, d, t_arr, any_hit)[:4]
    if perm is not None:
        res = [torch.empty_like(x) for x in (t, idx, b1, b2)]
        for dst, src in zip(res, (t, idx, b1, b2)):
            dst[perm] = src
        t, idx, b1, b2 = res
    idx = idx.to(torch.int64)
    hit = idx >= 0
    t = torch.where(hit, t, math.inf)
    if any_hit:
        return t, idx, hit
    return t, idx, hit, b1, b2


def wide_intersect(tables, o, d, t_max, any_hit=False, sort=True, joint=False):
    """Closest-hit (or any-hit) against the wide BVH tables, with the return
    contract of pallas_bvh.wide_intersect.

    any_hit: returns (t (R,), slot (R,), hit (R,)), slot indexing
    ``tables.wslot_prim``. Closest hit: returns (t, prim (R,) global prim
    row, hit, b1, b2); t = inf and prim = -1 on a miss. ``sort`` reorders
    rays by coherence_keys before traversal and restores the order after;
    it cannot change any result.

    CUDA tensors launch the CUDA kernel (the joint kernel when ``joint``);
    CPU tensors run the plain version, the twin of both.
    """
    if o.device.type == "cuda":
        return _query(traverse_joint_cuda if joint else traverse_cuda, tables, o, d, t_max, any_hit, sort)
    if o.device.type == "cpu":
        return _query(traverse_plain, tables, o, d, t_max, any_hit, sort)
    raise ValueError(f"wide_intersect has no implementation for device {o.device}")


def wide_intersect_plain(tables, o, d, t_max, any_hit=False, sort=True):
    """wide_intersect through the plain PyTorch traversal, on any device."""
    return _query(traverse_plain, tables, o, d, t_max, any_hit, sort)
