"""The port's wide-BVH traversal against the reference's Pallas kernel.

wide_intersect_plain (the CUDA kernels' plain PyTorch twin) must return the
hits of pbrt_tpu.device.pallas_bvh.wide_intersect run in interpret mode on
the 200-triangle scene and rays of tests/test_widebvh.py, grazing misses
included, and so must traverse_plain those of the reference's joint kernel. The reference walks 256-ray packets over one stack and the port
one stack per ray, so only visit order differs: closest hits must agree
exactly in hit flag and prim, t within rtol 1e-6 and barycentrics within
atol 1e-6; any-hit queries must agree in the hit flag (the first occluder
found may differ).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.device import pallas_bvh
from pbrt_tpu.scene.widebvh import build_wide_bvh as ref_build_wide_bvh
from pbrt_tpu_torch.device import wide_bvh
from pbrt_tpu_torch.scene import widebvh
from pbrt_tpu_torch.scene.widebvh import build_wide_bvh, hopper_layout


def _tri_scene(n_side=10):
    """tests/test_widebvh.py's bumpy triangulated grid (200 triangles)."""
    rs = np.random.RandomState(7)
    xs = np.linspace(-1, 1, n_side + 1)
    zs = np.linspace(-1, 1, n_side + 1)
    gx, gz = np.meshgrid(xs, zs)
    gy = 0.3 * np.sin(3 * gx) * np.cos(2 * gz) + 0.03 * rs.rand(*gx.shape)
    verts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    idx = []
    for i in range(n_side):
        for j in range(n_side):
            a = i * (n_side + 1) + j
            b = a + 1
            c = a + n_side + 1
            d = c + 1
            idx.append([a, c, b])
            idx.append([b, c, d])
    return verts[np.asarray(idx)].astype(np.float32)


def _rays():
    """tests/test_widebvh.py's 192 rays (half of them graze the box and miss
    every triangle), tiled 3x so the coherence sort (>= 512 rays) runs."""
    R = 192
    rs = np.random.RandomState(3)
    o = np.stack([rs.uniform(-1, 1, R), np.full(R, 2.0), rs.uniform(-1, 1, R)], axis=-1).astype(np.float32)
    d = np.stack([rs.uniform(-0.3, 0.3, R), -np.ones(R), rs.uniform(-0.3, 0.3, R)], axis=-1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[R // 2:, 0] = rs.uniform(1.05, 1.4, R - R // 2)
    d[R // 2:] = np.array([0.0, -1.0, 0.0], np.float32)
    return np.tile(o, (3, 1)), np.tile(d, (3, 1))


class _Tables:
    pass


def _tables(tri):
    w = build_wide_bvh(tri.min(axis=1), tri.max(axis=1), tri[:, 0], tri[:, 1], tri[:, 2])
    lo, hi = tri.reshape(-1, 3).min(0), tri.reshape(-1, 3).max(0)
    wc = (0.5 * (lo + hi)).astype(np.float32)
    wr = np.float32(np.linalg.norm(hi - wc) + 1e-4)
    ref, port = _Tables(), _Tables()
    ref.wnode_tab, ref.wprim_tab, ref.wmeta_tab = (jnp.asarray(w.node_tab), jnp.asarray(w.prim_tab),
                                                   jnp.asarray(w.meta_tab))
    ref.world_center, ref.world_radius = jnp.asarray(wc), jnp.asarray(wr)
    st = _Tables()
    st.wide_root = w.root
    port.wnode_rec, port.wleaf_rec = (torch.as_tensor(x) for x in hopper_layout(w.node_tab, w.prim_tab, w.meta_tab))
    port.world_center, port.world_radius = torch.as_tensor(wc), torch.as_tensor(wr)
    return ref, st, port


@pytest.fixture(scope="module")
def scene():
    tri = _tri_scene()
    ref, st, port = _tables(tri)
    o, d = _rays()
    tmax = np.full(o.shape[0], np.inf, np.float32)
    return tri, ref, st, port, o, d, tmax


def test_port_tables_match_reference_builder():
    tri = _tri_scene()
    a = build_wide_bvh(tri.min(axis=1), tri.max(axis=1), tri[:, 0], tri[:, 1], tri[:, 2])
    b = ref_build_wide_bvh(tri.min(axis=1), tri.max(axis=1), tri[:, 0], tri[:, 1], tri[:, 2])
    for name in ("node_tab", "prim_tab", "meta_tab", "slot_prim"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert a.root == b.root


def _sparse_scene():
    """37 scattered triangles: a root with empty child slots, leaves of
    fewer than 16 (and some of fewer than 8) triangles."""
    rs = np.random.RandomState(11)
    c = rs.uniform(-1, 1, (37, 1, 3))
    return (c + rs.uniform(-0.1, 0.1, (37, 3, 3))).astype(np.float32)


@pytest.mark.parametrize("kind", ["grid", "sparse"])
def test_hopper_layout_round_trips(kind):
    """Every child's 8 floats and every prim row of the reference tables sit
    in the Hopper records at widebvh's offsets; the meta column holds the
    child's meta with, for a leaf, its count of valid rows, and those rows
    come first in the leaf."""
    tri = _tri_scene() if kind == "grid" else _sparse_scene()
    w = build_wide_bvh(tri.min(axis=1), tri.max(axis=1), tri[:, 0], tri[:, 1], tri[:, 2])
    node_rec, leaf_rec = hopper_layout(w.node_tab, w.prim_tab, w.meta_tab)
    nodes, rows = node_rec.reshape(-1), leaf_rec.reshape(-1)
    metas = node_rec.view(np.int32).reshape(-1)
    assert node_rec.shape == (w.n_nodes, 64) and leaf_rec.shape[1] == 16
    assert metas[widebvh.node_child_offset(0, 0) + 6] == w.root
    n_empty = n_part = 0
    for nid in range(1, w.n_nodes):
        for c in range(8):
            ref = w.node_tab[(nid // 8) * 8 + c, (nid % 8) * 16:(nid % 8) * 16 + 8]
            at = widebvh.node_child_offset(nid, c)
            np.testing.assert_array_equal(nodes[at:at + 8][[0, 1, 2, 3, 4, 5, 7]], ref[[0, 1, 2, 3, 4, 5, 7]])
            meta, hop = int(w.meta_tab[nid * 8 + c]), int(metas[at + 6])
            assert meta == int(ref[6])
            if meta >= 0:
                assert hop == meta
                n_empty += meta == 0
                continue
            o = -meta - 1
            n = int((w.prim_tab[(o // 8) * 8:(o // 8) * 8 + 8, (o % 8) * 16 + 9] > 0).sum()
                    + (w.prim_tab[((o + 1) // 8) * 8:((o + 1) // 8) * 8 + 8, ((o + 1) % 8) * 16 + 9] > 0).sum())
            assert hop < 0 and (~hop) >> 4 == o // 2 and ((~hop) & 15) + 1 == n
            n_part += n < 16
            # the leaf's rows j: its n valid rows first, then padding
            for j in range(16):
                slot = o * 8 + j
                at = widebvh.leaf_row_offset(slot)
                assert (rows[at + 9] > 0) == (j < n)
                assert slot < w.n_octets * 8 and (j >= n or w.slot_prim[slot] == int(rows[at + 10]))
    for o in range(w.n_octets):
        for k in range(8):
            at = widebvh.leaf_row_offset(o * 8 + k)
            np.testing.assert_array_equal(rows[at:at + 16], w.prim_tab[(o // 8) * 8 + k, (o % 8) * 16:(o % 8) * 16 + 16])
    assert n_part > 0
    if kind == "sparse":
        assert n_empty > 0


@pytest.mark.parametrize("any_hit", [False, True])
def test_sparse_scene_matches_pallas(any_hit):
    """The walk over empty child slots and partly filled leaves: the plain
    twin against the reference kernel (interpret mode) on rays from every
    direction through the 37-triangle scene."""
    tri = _sparse_scene()
    ref, st, port = _tables(tri)
    rs = np.random.RandomState(12)
    o = rs.uniform(-1.5, 1.5, (300, 3)).astype(np.float32)
    # two thirds aimed near a triangle's centroid, the rest anywhere
    aim = tri.mean(axis=1)[rs.randint(len(tri), size=300)] + rs.uniform(-0.05, 0.05, (300, 3))
    d = np.where((np.arange(300) % 3 == 2)[:, None], rs.normal(size=(300, 3)), aim - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(np.arange(300) % 3 == 0, 0.8, np.inf).astype(np.float32)
    out_r = [np.asarray(x) for x in pallas_bvh.wide_intersect(
        ref, st, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), any_hit=any_hit, interpret=True, sort=False)]
    out_p = [x.numpy() for x in wide_bvh.wide_intersect_plain(
        port, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax), any_hit=any_hit, sort=False)]
    hit_r = out_r[2]
    assert 20 < hit_r.sum() < len(hit_r) - 20
    np.testing.assert_array_equal(out_p[2], hit_r)
    if not any_hit:
        np.testing.assert_array_equal(out_p[1], out_r[1])
        np.testing.assert_allclose(out_p[0], out_r[0], rtol=1e-6)


@pytest.mark.parametrize("sort", [False, True])
def test_closest_hit_matches_pallas(scene, sort):
    _tri, ref, st, port, o, d, tmax = scene
    t_r, prim_r, hit_r, b1_r, b2_r = (np.asarray(x) for x in pallas_bvh.wide_intersect(
        ref, st, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), interpret=True, sort=sort))
    t_p, prim_p, hit_p, b1_p, b2_p = (x.numpy() for x in wide_bvh.wide_intersect_plain(
        port, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax), sort=sort))
    assert 50 < hit_r.sum() < len(hit_r)  # hits and grazing misses
    np.testing.assert_array_equal(hit_p, hit_r)
    np.testing.assert_array_equal(prim_p, prim_r)
    np.testing.assert_allclose(t_p, t_r, rtol=1e-6)
    np.testing.assert_allclose(b1_p[hit_r], b1_r[hit_r], atol=1e-6)
    np.testing.assert_allclose(b2_p[hit_r], b2_r[hit_r], atol=1e-6)


@pytest.mark.parametrize("sort", [False, True])
def test_any_hit_matches_pallas(scene, sort):
    _tri, ref, st, port, o, d, tmax = scene
    t_hit = np.asarray(pallas_bvh.wide_intersect(
        ref, st, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), interpret=True, sort=False)[0])
    # bounded t_max leaves the far rays unoccluded
    tmax_sh = np.where(np.isfinite(t_hit), t_hit * 0.95, 2.0).astype(np.float32)
    tmax_sh[::7] = -1.0  # dead lanes
    _t, slot_r, hit_r = (np.asarray(x) for x in pallas_bvh.wide_intersect(
        ref, st, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax_sh), any_hit=True,
        interpret=True, sort=sort))
    _t, slot_p, hit_p = (x.numpy() for x in wide_bvh.wide_intersect_plain(
        port, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax_sh), any_hit=True, sort=sort))
    np.testing.assert_array_equal(hit_p, hit_r)
    assert not hit_p[::7].any()
    assert ((slot_p >= 0) == hit_p).all()


@pytest.mark.parametrize("any_hit", [False, True])
def test_joint_kernel_matches_plain(scene, any_hit):
    """B2: the reference's joint kernel (pallas_bvh._run with joint=True, in
    interpret mode as _joint_probe runs it on the CPU) returns the hits of
    traverse_plain, the twin of both CUDA traversal kernels."""
    _tri, ref, st, port, o, d, tmax = scene
    t_hit = wide_bvh.traverse_plain(port, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax), False)[0]
    t = tmax
    if any_hit:
        # half the shadow rays end just past their closest hit, half short of it
        scale = np.where(np.arange(len(o)) % 2 == 0, 1.05, 0.95)
        t = np.where(np.isfinite(t_hit.numpy()), t_hit.numpy() * scale, 2.0).astype(np.float32)
        t[::7] = -1.0  # dead lanes
    live = jnp.where(jnp.asarray(t) > 0, 1.0, 0.0) if any_hit else None
    blocks, R, _B = pallas_bvh.pack_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), live)
    out = pallas_bvh._run(ref.wnode_tab, ref.wprim_tab, blocks, st.wide_root, any_hit, True, meta=ref.wmeta_tab,
                          joint=True)
    rows = [np.asarray(out[:, j, :]).reshape(-1)[:R] for j in range(5)]
    t_p, idx_p, b1_p, b2_p = (x.numpy() for x in wide_bvh.traverse_plain(
        port, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t), any_hit)[:4])
    hit_p = idx_p >= 0
    if any_hit:
        np.testing.assert_array_equal(hit_p, rows[1] >= 0)
        assert 0 < hit_p.sum() < len(hit_p) and not hit_p[::7].any()
        return
    hit_r = rows[2] >= 0
    assert 50 < hit_r.sum() < len(hit_r)
    np.testing.assert_array_equal(hit_p, hit_r)
    np.testing.assert_array_equal(idx_p, rows[2].astype(np.int64))
    np.testing.assert_allclose(t_p[hit_r], rows[0][hit_r], rtol=1e-6)
    np.testing.assert_allclose(b1_p[hit_r], rows[3][hit_r], atol=1e-6)
    np.testing.assert_allclose(b2_p[hit_r], rows[4][hit_r], atol=1e-6)


def test_wrapper_routes_cpu_tensors_to_plain(scene):
    _tri, _ref, _st, port, o, d, tmax = scene
    before = wide_bvh.traverse_cuda.launches
    joint_before = wide_bvh.traverse_joint_cuda.launches
    a = wide_bvh.wide_intersect(port, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax))
    b = wide_bvh.wide_intersect_plain(port, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax))
    c = wide_bvh.wide_intersect(port, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax), joint=True)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(z, y)
    assert wide_bvh.traverse_cuda.launches == before
    assert wide_bvh.traverse_joint_cuda.launches == joint_before



def test_coherence_keys_match_reference(scene):
    _tri, ref, _st, port, o, _d, _tmax = scene
    d = np.random.RandomState(4).normal(size=o.shape).astype(np.float32)  # every octant
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    inv_r = 1.0 / jnp.maximum(2.0 * ref.world_radius, 1e-20)
    inv_p = 1.0 / torch.clamp(2.0 * port.world_radius, min=1e-20)
    k_r = np.asarray(pallas_bvh.coherence_keys(jnp.asarray(o), jnp.asarray(d),
                                               ref.world_center - ref.world_radius, inv_r))
    k_p = wide_bvh.coherence_keys(torch.as_tensor(o), torch.as_tensor(d),
                                  port.world_center - port.world_radius, inv_p)
    np.testing.assert_array_equal(k_p.numpy(), k_r.astype(np.int64))
    assert len(np.unique(k_r >> 28)) == 8
