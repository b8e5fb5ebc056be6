"""The port's scene compiler against the reference's, table for table.

pbrt_tpu_torch.scene.builder.compile_scene(mesh_room(8)) must produce
exactly the tables pbrt_tpu.scene.builder.compile_scene(bench._mesh_scene(8))
produces (770 prims: wide-eligible), and the port must import without JAX.
"""
import subprocess
import sys
from dataclasses import fields
from pathlib import Path

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

import bench
from pbrt_tpu.scene.builder import compile_scene as ref_compile_scene
from pbrt_tpu_torch.scene.arrays import HOPPER_TABLES, SceneTensors, scene_tensors_from_numpy
from pbrt_tpu_torch.scene.builder import compile_scene
from pbrt_tpu_torch.scene.widebvh import hopper_layout
from pbrt_tpu_torch.scene.host import HostMaterial
from pbrt_tpu_torch.scenes import mesh_room

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def both():
    return compile_scene(mesh_room(8), "cpu"), ref_compile_scene(bench._mesh_scene(8))


@pytest.mark.parametrize("name", [f.name for f in fields(SceneTensors) if f.name not in HOPPER_TABLES])
def test_tables_bit_identical(both, name):
    cs, ref = both
    a = getattr(cs.arrays, name).numpy()
    b = np.asarray(getattr(ref.arrays, name))
    assert a.shape == b.shape
    assert a.dtype.kind == b.dtype.kind and a.dtype.itemsize == b.dtype.itemsize
    np.testing.assert_array_equal(a, b)


def test_static_matches(both):
    cs, ref = both
    assert cs.static.n_prims == ref.static.n_prims == 770
    assert ref.static.has_wide and cs.static.has_wide
    for name in ("wide_root", "n_tris", "n_lights", "n_materials", "mat_kinds_present",
                 "light_kinds", "has_area_lights"):
        mine, theirs = getattr(cs.static, name), getattr(ref.static, name)
        if isinstance(mine, tuple):
            theirs = tuple(int(x) for x in theirs)
        assert mine == theirs, name


def test_reference_tables_cross_unchanged(both):
    """scene_tensors_from_numpy fills the port from a reference scene."""
    _cs, ref = both
    arrays = {f.name: getattr(ref.arrays, f.name) for f in fields(ref.arrays)}
    static = {f.name: getattr(ref.static, f.name) for f in fields(ref.static)}
    sa, st = scene_tensors_from_numpy(arrays, static, "cpu")
    assert st.wide_root == ref.static.wide_root
    np.testing.assert_array_equal(sa.wprim_tab.numpy(), np.asarray(ref.arrays.wprim_tab))
    assert sa.prim_mat.dtype == torch.int32


def test_hopper_tables_derive_from_reference(both):
    """The wide BVH's Hopper records, which the kernels read, are
    widebvh.hopper_layout of the reference's own tables."""
    cs, ref = both
    want = hopper_layout(*(np.asarray(getattr(ref.arrays, n)) for n in ("wnode_tab", "wprim_tab", "wmeta_tab")))
    for name, rec in zip(HOPPER_TABLES, want):
        got = getattr(cs.arrays, name)
        assert got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy().view(np.int32), rec.view(np.int32))


@pytest.mark.parametrize("feature", ["material", "light", "small", "sampler"])
def test_outside_the_slice_raises(feature, monkeypatch):
    """A mirror or a point light in a wide scene is the wide megakernel's
    class: compile_scene takes it, and the wavefront route refuses it unless
    PBRT_TPU_WIDEMEGA=1. A lone panel (brute class, area light) and the
    halton sampler are refused at compile time."""
    from pbrt_tpu_torch import render
    from pbrt_tpu_torch.scene.host import HostLight

    desc = mesh_room(8)
    if feature == "material":
        desc.primitives[0].material = HostMaterial(kind="mirror")
    elif feature == "light":
        desc.lights.append(HostLight(kind="point", intensity=np.ones(3)))
    elif feature == "small":
        desc = mesh_room(1)
        desc.primitives = desc.primitives[-1:]
    else:
        desc.sampler.kind = "halton"
    if feature in ("material", "light"):
        cs = compile_scene(desc, "cpu")
        monkeypatch.delenv("PBRT_TPU_WIDEMEGA", raising=False)
        with pytest.raises(NotImplementedError, match="mirror" if feature == "material" else "point"):
            render.make_persistent_fn(cs)
        return
    with pytest.raises(NotImplementedError):
        compile_scene(desc, "cpu")


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import pbrt_tpu_torch.render, pbrt_tpu_torch.scenes, pbrt_tpu_torch.device.wide_bvh\n"
        "import pbrt_tpu_torch.device.megakernel, pbrt_tpu_torch.device.nvcc, pbrt_tpu_torch.core.spectrum\n"
        "import pbrt_tpu_torch.device.megakernel_wide\n"
        "assert not any(m == 'pbrt_tpu' or m.startswith('pbrt_tpu.') for m in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
