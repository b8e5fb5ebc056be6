"""Scenes and rays shared by the port's CPU and GPU tests (no JAX import:
tests/test_torch_gpu.py runs on a machine without it)."""
import dataclasses

import numpy as np
import torch

from pbrt_tpu_torch import scenes
from pbrt_tpu_torch.scene.builder import compile_scene


def small_quadric_room(kd=False):
    """quadric_room(4) at 32x16, 2 spp, compiled on the CPU: 8 instances of
    its prop, or (kd) its kd variant without instances under the
    orthographic camera."""
    if kd:
        desc = scenes.quadric_room(4, instances=False, accelerator="kdtree", prop_res=6)
        desc.camera = scenes.camera_room("orthographic").camera
    else:
        desc = scenes.quadric_room(4, instances=8, prop_res=6)
    desc.film.x_resolution, desc.film.y_resolution = 32, 16
    desc.sampler.pixel_samples = 2
    return compile_scene(desc, "cpu")


def deep_kd_room(depth: int):
    """quadric_room(4)'s kd variant with its kd-tree replaced by a chain of
    `depth` interior nodes splitting x at falling positions, each node's
    below child the next and its above child a leaf of 3 prims (the last
    one's below child a leaf too), and rays that start at the low x end of
    the tree's bounds heading +x: such a ray crosses every split and holds
    `depth` todo entries at the chain's bottom. Returns (the scene with its
    kd tables, kd walk records, kd_depth and kd_max_leaf replaced, o, d,
    t_max (R = 512: 384 such rays, 128 random), as numpy float32)."""
    from pbrt_tpu_torch.scene.arrays import kd_walk_records

    cs = small_quadric_room(kd=True)
    sa, st = cs.arrays, cs.static
    n_prims = sa.prim_kind.shape[0]
    lo, hi = sa.kd_lo.numpy(), sa.kd_hi.numpy()
    n_nodes = 2 * depth + 1
    leaves = np.arange(depth, n_nodes)
    flags = np.full(n_nodes, 3, np.int32)
    flags[:depth] = 0
    split = np.zeros(n_nodes, np.float32)
    split[:depth] = hi[0] - (np.arange(depth) + 1) * (hi[0] - lo[0]) / (depth + 1)
    above = np.zeros(n_nodes, np.int32)
    above[:depth] = depth + 1 + np.arange(depth)
    above[leaves] = 3 * np.arange(leaves.size)
    nprims = np.zeros(n_nodes, np.int32)
    nprims[leaves] = 3
    rs = np.random.RandomState(4)
    prim_ids = rs.randint(0, n_prims, 3 * leaves.size).astype(np.int32)
    node_rec, leaf_rec, kd_depth = kd_walk_records(flags, split, above, nprims, prim_ids, sa.prim_test_data.numpy(),
                                                   sa.prim_kind.numpy())
    assert kd_depth == depth
    tables = {"kd_flags": flags, "kd_split": split, "kd_above": above, "kd_nprims": nprims, "kd_prim_ids": prim_ids,
              "kd_node_rec": node_rec, "kd_leaf_rec": leaf_rec}
    arrays = dataclasses.replace(sa, **{k: torch.as_tensor(v) for k, v in tables.items()})
    static = dataclasses.replace(st, kd_depth=kd_depth, kd_max_leaf=max(st.kd_max_leaf, 3))
    R, n_deep = 512, 384
    o = rs.uniform(lo, hi, (R, 3)).astype(np.float32)
    o[:n_deep, 0] = lo[0] + 0.01 * (hi[0] - lo[0])
    d = rs.normal(size=(R, 3))
    d[:n_deep, 0] = 1.0
    d[:n_deep, 1:] *= 0.05
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return dataclasses.replace(cs, arrays=arrays, static=static), o, d, np.full(R, np.inf, np.float32)


def track_rays(cs, n, seed=0):
    """scenes.fog_box_rays(n, seed) on cs's device in its grid medium: (med,
    o, d, t_end, key), float32 but for med and key (int64)."""
    o, d, t_end, key = scenes.fog_box_rays(n, seed)
    dev = cs.arrays.device
    smoke = cs.static.media_kinds.index("heterogeneous")
    f32 = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)  # noqa: E731
    return (torch.full((n,), smoke, dtype=torch.int64, device=dev), f32(o), f32(d), f32(t_end),
            torch.as_tensor(key, device=dev))


def tiny_scene(res=(16, 8), spp=2, integrator="path", max_depth=3, fog=False, specular=True):
    """The reference's dryrun scene (__graft_entry__._tiny_scene: a matte
    floor, a mirror and a glass sphere under a distant light) in the port's
    records; fog: the camera inside a homogeneous medium
    (tests/test_shard_parity.py's volpath scene); specular=False: both
    spheres matte (the reference's compiled steps then carry no specular
    lobes, which costs them seconds to a quarter of their compile)."""
    from pbrt_tpu_torch.core.transform import Transform
    from pbrt_tpu_torch.scene.host import (
        CameraConfig, FilmConfig, HostLight, HostMaterial, HostMedium, HostPrimitive, IntegratorConfig,
        SamplerConfig, SceneDescription, ShapeRecord, Sphere, TriangleMesh,
    )

    floor = TriangleMesh(p=np.array([[-20, -1, -20], [20, -1, -20], [20, -1, 20], [-20, -1, 20]], np.float64),
                         indices=np.array([[0, 2, 1], [0, 3, 2]], np.int32),
                         uv=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64))
    matte = HostMaterial(kind="matte", params={"Kd": ("const", np.array([0.5, 0.5, 0.5]))})
    prims = [
        HostPrimitive(shape=ShapeRecord(mesh=floor),
                      material=HostMaterial(kind="matte", params={"Kd": ("const", np.array([0.6, 0.5, 0.4]))})),
        HostPrimitive(shape=ShapeRecord(sphere=Sphere(object_to_world=Transform.translate([-1.3, 0, 0]))),
                      material=HostMaterial(kind="mirror", params={"Kr": ("const", np.array([0.9, 0.9, 0.9]))})
                      if specular else matte),
        HostPrimitive(shape=ShapeRecord(sphere=Sphere(object_to_world=Transform.translate([1.3, 0, 0]))),
                      material=HostMaterial(kind="glass", params={}) if specular else matte),
    ]
    lights = [HostLight(kind="distant", from_point=np.array([0.0, 10.0, 0.0]), to_point=np.zeros(3),
                        intensity=np.array([3.14, 3.14, 3.14]))]
    desc = SceneDescription(
        primitives=prims, lights=lights,
        camera=CameraConfig(kind="perspective", camera_to_world=Transform.look_at([2, 2, 5], [0, -0.4, 0], [0, 1, 0]),
                            fov=30.0),
        film=FilmConfig(x_resolution=res[0], y_resolution=res[1]),
        sampler=SamplerConfig(kind="zerotwosequence", pixel_samples=spp),
        integrator=IntegratorConfig(kind=integrator, max_depth=max_depth))
    if fog:
        desc.media = {"fog": HostMedium(kind="homogeneous", sigma_a=np.full(3, 0.02), sigma_s=np.full(3, 0.08), g=0.2)}
        desc.camera_medium = "fog"
    return desc
