"""The port's scene API against the reference's: pbrt_parse, the
tessellators, the PLY reader, and compile_scene of parsed files.

``assert_same`` walks a port record and the reference's record of the same
class name field by field, so no field is skipped by hand: numpy arrays
must be equal in dtype, shape and value, Transforms by their matrices,
texture images included, material parameters as ('const', v) /
('texture', tex). The parsed scene is tests/test_torch_parser.py's file,
which uses every directive; it is parsed plainly, with --quick and with a
crop window. Scenes in the port's class compile to tables bit-identical to
the reference's compile of the reference's parse; scenes outside it are
refused with scene/builder.py's messages.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from pbrt_tpu.core.options import Options as RefOptions
from pbrt_tpu.core.transform import Transform as RefTransform
from pbrt_tpu.parser.api import pbrt_parse as ref_pbrt_parse
from pbrt_tpu.scene import host as ref_host
from pbrt_tpu.scene import ply as ref_ply
from pbrt_tpu.scene import tessellate as ref_tess
from pbrt_tpu.scene.builder import compile_scene as ref_compile_scene
from pbrt_tpu_torch.core.options import Options
from pbrt_tpu_torch.core.transform import Transform
from pbrt_tpu_torch.parser.api import pbrt_parse
from pbrt_tpu_torch.scene import host, ply, tessellate
from pbrt_tpu_torch.scene.arrays import HOPPER_TABLES, SceneTensors
from pbrt_tpu_torch.scene.builder import compile_scene
from test_torch_parser import write_scene
from torch_threads import one_torch_thread  # noqa: F401  (autouse: PyTorch single-threaded in this module)


def assert_same(got, want, path="desc"):
    """Port record `got` equals the reference's `want`, recursively."""
    if dataclasses.is_dataclass(got) and not isinstance(got, type):
        assert type(got).__name__ == type(want).__name__, path
        names = [f.name for f in dataclasses.fields(got)]
        assert names == [f.name for f in dataclasses.fields(want)], path
        for name in names:
            assert_same(getattr(got, name), getattr(want, name), f"{path}.{name}")
    elif isinstance(got, np.ndarray):
        assert isinstance(want, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(got, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{path}[{i}]")
    elif isinstance(got, dict):
        assert list(got) == list(want), path
        for k in got:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(got, float) and math.isnan(got):
        assert math.isnan(want), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


OPTIONS = {
    "plain": {},
    "quick": {"quick_render": True},
    "crop": {"crop_window": (0.25, 0.75, 0.0, 0.5), "image_file": "crop.pfm"},
}


@pytest.mark.parametrize("opts", list(OPTIONS))
def test_pbrt_parse_equal(tmp_path, opts):
    path = write_scene(tmp_path)
    got = pbrt_parse(path, Options(**OPTIONS[opts]))
    want = ref_pbrt_parse(path, RefOptions(**OPTIONS[opts]))
    assert len(got.primitives) >= 20 and len(got.lights) >= 6 and len(got.media) == 3
    assert_same(got, want)
    # the checks that the walk reached what it should
    mix = [p.material.params["Kd"][1] for p in got.primitives if p.material.kind == "uber"][0]
    assert mix.tex2[1].kind == "imagemap" and mix.tex2[1].image.shape == (6, 8, 3)
    assert any(p.shape.mesh is not None and p.shape.mesh.anim is not None for p in got.primitives)
    assert any(p.instance_transform is not None for p in got.primitives)


def test_parse_errors_match(tmp_path):
    """No WorldEnd raises; an unmatched AttributeEnd and directives in the
    wrong block log and go on, as in the reference."""
    p = tmp_path / "bad.pbrt"
    p.write_text('Camera "perspective"\nWorldBegin\nShape "sphere"\n')
    for parse in (pbrt_parse, ref_pbrt_parse):
        with pytest.raises(RuntimeError, match="no WorldEnd"):
            parse(str(p))
    p.write_text('Shape "sphere"\nWorldBegin\nCamera "orthographic"\nAttributeEnd\nShape "sphere"\nWorldEnd\n')
    assert_same(pbrt_parse(str(p)), ref_pbrt_parse(str(p)))


def _xf(m):
    return Transform.from_matrix(m), RefTransform.from_matrix(m)


def _o2w():
    return Transform.rotate(25.0, [0.3, 1.0, 0.2]) @ Transform.translate([0.5, -1.0, 2.0])


def test_tessellated_meshes_equal():
    """heightfield, loopsubdiv, curve (flat, cylinder, ribbon) and nurbs
    meshes, and the quadric tessellators of scene/host.py."""
    o2w, o2w_r = _xf(_o2w().m)
    rs = np.random.RandomState(4)
    pz = rs.random_sample(20)
    cases = [
        (tessellate.tessellate_heightfield(o2w, 5, 4, pz, False),
         ref_tess.tessellate_heightfield(o2w_r, 5, 4, pz, False)),
        (tessellate.loop_subdivide(o2w, 3, [0, 1, 2, 0, 2, 3, 0, 3, 1, 1, 3, 2],
                                   np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1.0]]), True),
         ref_tess.loop_subdivide(o2w_r, 3, [0, 1, 2, 0, 2, 3, 0, 3, 1, 1, 3, 2],
                                 np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1.0]]), True)),
    ]
    cp = rs.random_sample((4, 3))
    for ctype, norms in (("flat", None), ("cylinder", None), ("ribbon", (np.array([0, 0, 1.0]), np.array([1.0, 0, 0])))):
        cases.append((tessellate.tessellate_curve(o2w, cp, 0.1, 0.05, ctype, norms),
                      ref_tess.tessellate_curve(o2w_r, cp, 0.1, 0.05, ctype, norms)))
    knots = np.array([0, 0, 0, 1, 1, 1.0])
    grid = np.stack(np.meshgrid(np.arange(3.0), np.arange(3.0)), -1).reshape(-1, 2)
    P = np.concatenate([grid, rs.random_sample((9, 1))], -1)
    Pw = np.concatenate([P, 1.0 + rs.random_sample((9, 1))], -1).ravel()
    for p, pw in ((P, None), (None, Pw)):
        cases.append((tessellate.tessellate_nurbs(o2w, 3, 3, knots, 0.0, 1.0, 3, 3, knots, 0.0, 1.0, p, pw, False),
                      ref_tess.tessellate_nurbs(o2w_r, 3, 3, knots, 0.0, 1.0, 3, 3, knots, 0.0, 1.0, p, pw, False)))
    cases += [
        (host.tessellate_cylinder(o2w, 0.5, -0.2, 0.7, 5.0, False), ref_host.tessellate_cylinder(o2w_r, 0.5, -0.2, 0.7, 5.0, False)),
        (host.tessellate_disk(o2w, 0.1, 1.0, 0.3, 6.0, True), ref_host.tessellate_disk(o2w_r, 0.1, 1.0, 0.3, 6.0, True)),
        (host.tessellate_cone(o2w, 1.0, 0.4, 6.0, False), ref_host.tessellate_cone(o2w_r, 1.0, 0.4, 6.0, False)),
        (host.tessellate_paraboloid(o2w, 0.5, 0.0, 0.8, 6.0, False),
         ref_host.tessellate_paraboloid(o2w_r, 0.5, 0.0, 0.8, 6.0, False)),
        (host.tessellate_hyperboloid(o2w, [0.5, 0, 0], [0, 0.5, 1], 6.0, False),
         ref_host.tessellate_hyperboloid(o2w_r, [0.5, 0, 0], [0, 0.5, 1], 6.0, False)),
    ]
    for i, (got, want) in enumerate(cases):
        assert len(got.indices) > 0
        assert_same(got, want, f"case {i}")


def _ply_files(tmp_path):
    """ascii, binary little-endian and big-endian PLY files with quads, a
    pentagon, normals, uv (as s/t) and an extra element to skip."""
    rs = np.random.RandomState(9)
    p = rs.random_sample((6, 3)).astype(np.float32)
    n = rs.random_sample((6, 3)).astype(np.float32)
    st = rs.random_sample((6, 2)).astype(np.float32)
    faces = [[0, 1, 2, 3], [1, 4, 2], [0, 1, 2, 4, 5]]
    head = ("element vertex 6\nproperty float x\nproperty float y\nproperty float z\n"
            "property float nx\nproperty float ny\nproperty float nz\nproperty float s\nproperty float t\n"
            "element face 3\nproperty list uchar int vertex_indices\n"
            "element material 1\nproperty uchar r\nproperty list uchar int ids\nend_header\n")
    out = []
    a = tmp_path / "a.ply"
    body = "".join(" ".join(repr(float(v)) for v in row) + "\n" for row in np.hstack([p, n, st]))
    body += "".join(f"{len(f)} " + " ".join(map(str, f)) + "\n" for f in faces) + "7 2 1 2\n"
    a.write_text("ply\nformat ascii 1.0\ncomment made in a test\n" + head + body)
    out.append(a)
    for fmt, e in (("binary_little_endian", "<"), ("binary_big_endian", ">")):
        b = tmp_path / f"{fmt}.ply"
        data = np.hstack([p, n, st]).astype(e + "f4").tobytes()
        for f in faces:
            data += bytes([len(f)]) + np.asarray(f, e + "i4").tobytes()
        data += bytes([7, 2]) + np.array([1, 2], e + "i4").tobytes()
        b.write_bytes(f"ply\nformat {fmt} 1.0\n".encode() + head.encode() + data)
        out.append(b)
    return out


def test_read_ply_equal(tmp_path):
    for f in _ply_files(tmp_path):
        got, want = ply.read_ply(str(f)), ref_ply.read_ply(str(f))
        assert list(got) == list(want) == ["p", "n", "uv", "indices"]
        assert len(got["indices"]) == 6  # quad -> 2, triangle, pentagon -> 3
        assert_same(got, want, f.name)
    bad = tmp_path / "bad.ply"
    bad.write_text("not a ply\n")
    with pytest.raises(ValueError, match="not a PLY file"):
        ply.read_ply(str(bad))


ROOM = """
LookAt 0 2.3 3.3  0 0.2 -1  0 1 0
Camera "perspective" "float fov" [70]
Sampler "%(sampler)s" "integer pixelsamples" 4
Film "image" "integer xresolution" [24] "integer yresolution" [16]
PixelFilter "%(filter)s"
Integrator "path" "integer maxdepth" [3]
WorldBegin
AttributeBegin
  Translate -4 -1 4
  Rotate -90 1 0 0
  Scale 8 8 1
  Material "matte" "rgb Kd" [0.55 0.45 0.35]
  Shape "heightfield" "integer nu" %(nu)d "integer nv" %(nu)d "float Pz" [%(pz)s]
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [14 13.5 12.5] "bool twosided" true
  Material "matte" "rgb Kd" [0 0 0]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point P" [-1.4 3.99 -1.4  1.4 3.99 -1.4  1.4 3.99 1.4  -1.4 3.99 1.4]
AttributeEnd
%(extra)s
WorldEnd
"""

GALLERY_EXTRA = """
LightSource "distant" "point from" [0 10 0] "point to" [0 0 0] "rgb L" [3 3 3]
LightSource "spot" "point from" [0 5 3] "point to" [0 -1 0] "rgb I" [55 50 45] "float coneangle" 25
AttributeBegin
  Translate -1 0 0
  Material "metal" "float roughness" 0.08
  Shape "sphere" "float radius" 0.9
AttributeEnd
AttributeBegin
  Translate 1 0 0
  Material "glass"
  Shape "sphere" "float radius" 0.9 "float zmax" 0.5
AttributeEnd
AttributeBegin
  Material "plastic" "rgb Kd" [0.6 0.5 0.4] "rgb Ks" [0.4 0.4 0.4] "float roughness" 0.2
  Shape "sphere" "float radius" 0.5
AttributeEnd
Material "mirror"
Shape "trianglemesh" "integer indices" [0 1 2] "point P" [-2 -1 -2  2 -1 -2  0 1 -2]
"""


def room_text(nu=10, sampler="halton", filter="gaussian", extra=""):
    """An 8 x 8 terrain heightfield under a two-sided area panel, seen from
    above: 2 (nu-1)^2 + 2 triangles."""
    rs = np.random.RandomState(2)
    pz = " ".join(f"{v:.4f}" for v in rs.random_sample(nu * nu) * 0.3)
    return ROOM % {"sampler": sampler, "filter": filter, "nu": nu, "pz": pz, "extra": extra}


def _tables_equal(cs, ref, skip=()):
    """Every table equal to the reference's; prim_inst against the
    reference's in BVH order (the reference leaves it in description
    order, a fault the port fixes: ROADMAP C)."""
    for f in dataclasses.fields(SceneTensors):
        if f.name in HOPPER_TABLES or f.name in skip:
            continue
        a, b = getattr(cs.arrays, f.name), getattr(ref.arrays, f.name)
        if f.name == "prim_inst":
            b = np.asarray(b)[cs.prim_order]
        if a is None:
            assert b is None or f.name.startswith("w") and not ref.static.has_wide, f.name
            continue
        if isinstance(a, dict):  # the MIP levels of the imagemaps
            assert a.keys() == b.keys(), f.name
            for k in a:
                np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]), err_msg=k)
            continue
        b = np.asarray(b)
        assert a.numpy().dtype.itemsize == b.dtype.itemsize, f.name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f.name)
    for name in ("n_prims", "n_tris", "n_lights", "n_materials", "use_brute_force", "has_wide", "wide_root",
                 "has_infinite", "infinite_light_index", "has_env_map", "has_bump"):
        assert getattr(cs.static, name) == getattr(ref.static, name), name
    assert [vars(p) for p in cs.static.tex_programs] == [vars(p) for p in ref.static.tex_programs]


@pytest.mark.parametrize("scene", ["wide", "brute"])
def test_compiled_tables_bit_identical(tmp_path, scene):
    """A 164-triangle room (the wide class) and a brute scene of delta
    lights, triangles and full and partial spheres: the port's compile of
    its parse equals the reference's compile of the reference's parse."""
    text = room_text(10) if scene == "wide" else room_text(3, "zerotwosequence", "box", GALLERY_EXTRA)
    p = tmp_path / "s.pbrt"
    p.write_text(text)
    cs = compile_scene(pbrt_parse(str(p)), "cpu")
    ref = ref_compile_scene(ref_pbrt_parse(str(p)))
    assert cs.static.use_brute_force == (scene == "brute")
    assert cs.static.n_prims == (164 if scene == "wide" else 14)
    _tables_equal(cs, ref)


# a feature's scene, and the integrator with a host loop of its own it is
# rendered under (motion blur under mlt, a medium under sppm; bdpt's case
# meets sppm); "unknown" names an integrator neither package has, which
# keeps the refusal by name
REFUSED = {
    "motion": ('ActiveTransform EndTime\nTranslate 0 1 0\nActiveTransform All\nShape "sphere"', "mlt"),
    "medium": ('MediumInterface "m" ""\nActiveTransform EndTime\nTranslate 0 1 0\nShape "sphere"', "sppm"),
    "unknown": ("", "photonmap"),
}


def _slice_tables(tmp_path, extra="", camera=None, accelerator=None):
    """The 10-prim room with one kind of the persistent wavefront's class
    that a later slice ported (a cylinder, an instance, an alpha cutout, an
    orthographic camera, the kd-tree): the port's compile of its parse
    gives the reference's tables bit for bit (an instance makes the scene
    leave the brute route; the kd-tree is demoted to the brute route, as in
    the reference; tests/test_torch_quadrics.py holds a kd-tree's tables)."""
    text = room_text(3, "zerotwosequence", "box", extra)
    if camera is not None:
        text = text.replace('Camera "perspective"', f'Camera "{camera}"')
    if accelerator is not None:
        text = f'Accelerator "{accelerator}"\n' + text
    p = tmp_path / "s.pbrt"
    p.write_text(text)
    cs = compile_scene(pbrt_parse(str(p)), "cpu")
    ref = ref_compile_scene(ref_pbrt_parse(str(p)))
    kd = ("kd_flags", "kd_split", "kd_above", "kd_nprims", "kd_prim_ids")
    _tables_equal(cs, ref, skip=kd if accelerator == "kdtree" else ())
    for name in ("has_instances", "has_alpha", "accel_kind", "max_leaf", "light_image_keys"):
        assert getattr(cs.static, name) == getattr(ref.static, name), name
    if accelerator == "kdtree":  # a brute-force scene keeps the brute route, as in the reference
        assert cs.static.use_brute_force and cs.static.accel_kind == "bvh" and cs.arrays.kd_flags is None
    return cs


def _textured_tables(tmp_path, extra):
    """A brute scene with a textured or bump-mapped sphere: the port's
    compile of its parse gives the reference's tables bit for bit (the
    texture programs, their parameter rows, mat_tex and mat_bump)."""
    p = tmp_path / "s.pbrt"
    p.write_text(room_text(3, "zerotwosequence", "box", extra))
    cs = compile_scene(pbrt_parse(str(p)), "cpu")
    ref = ref_compile_scene(ref_pbrt_parse(str(p)))
    _tables_equal(cs, ref)
    assert cs.static.tex_programs and (cs.arrays.mat_tex >= 0).any() != cs.static.has_bump


# features this list refused until a slice ported them: each case now runs
# its counterpart, the feature compiled to the reference's tables
PORTED = {
    "infinite light": lambda tmp_path: _infinite_light_tables(tmp_path, ""),
    "texture": lambda tmp_path: _textured_tables(
        tmp_path, 'Texture "t" "spectrum" "checkerboard"\nMaterial "matte" "texture Kd" "t"\nShape "sphere"'),
    "bump": lambda tmp_path: _textured_tables(
        tmp_path, 'Texture "b" "float" "fbm"\nMaterial "matte" "texture bumpmap" "b"\nShape "sphere"'),
    "uber": lambda tmp_path: _uber_tables(tmp_path),
    "cylinder": lambda tmp_path: _slice_tables(tmp_path, 'Shape "cylinder"'),
    "instancing": lambda tmp_path: _slice_tables(
        tmp_path, 'ObjectBegin "o"\nShape "trianglemesh" "integer indices" [0 1 2] "point P" [0 0 0 1 0 0 0 1 0]\n'
                  'ObjectEnd\nTranslate 1 0 0\nObjectInstance "o"'),
    "alpha": lambda tmp_path: _slice_tables(
        tmp_path, 'Shape "trianglemesh" "integer indices" [0 1 2] "point P" [0 0 0 1 0 0 0 1 0] "float alpha" 0'),
    "orthographic": lambda tmp_path: _slice_tables(tmp_path, camera="orthographic"),
    "kdtree": lambda tmp_path: _slice_tables(tmp_path, accelerator="kdtree"),
}


def _uber_tables(tmp_path):
    """A brute scene with an uber sphere (pbrt's defaults: Kd 0.25, Ks
    0.25, roughness 0.1, eta 1.5, opacity 1) and a glossy uber one with an
    opacity below 1: the port's compile of its parse gives the reference's
    tables bit for bit, their material rows included."""
    extra = ('Material "uber"\nShape "sphere"\nAttributeBegin\nTranslate 1 0 0\n'
             'Material "uber" "rgb Kd" [0.5 0.3 0.2] "rgb Ks" [0.3 0.3 0.3] "float roughness" 0.2 '
             '"rgb opacity" [0.7 0.7 0.7] "float eta" 1.7\nShape "sphere" "float radius" 0.5\nAttributeEnd')
    p = tmp_path / "s.pbrt"
    p.write_text(room_text(3, "zerotwosequence", "box", extra))
    cs = compile_scene(pbrt_parse(str(p)), "cpu")
    ref = ref_compile_scene(ref_pbrt_parse(str(p)))
    _tables_equal(cs, ref)
    assert 6 in cs.static.mat_kinds_present  # MAT_UBER


def _infinite_light_tables(tmp_path, mapname):
    """The 164-triangle room with an infinite light (a rotated image map
    written under tmp_path when mapname is given) compiles to the
    reference's tables bit for bit: the light's row (its radiance the map's
    mean), has_infinite, has_env_map, the map, its distribution and
    world-to-light rows."""
    from pbrt_tpu_torch.core.imageio import write_image

    extra = 'LightSource "infinite" "rgb L" [0.4 0.5 0.7]'
    if mapname:
        rs = np.random.RandomState(3)
        write_image(str(tmp_path / mapname), rs.uniform(0.0, 2.0, (8, 16, 3)).astype(np.float32))
        extra = ('AttributeBegin\nRotate 40 0.2 1 0.3\nLightSource "infinite" "rgb L" [1.5 1.2 1] '
                 f'"string mapname" "{mapname}"\nAttributeEnd')
    p = tmp_path / "s.pbrt"
    p.write_text(room_text(10, extra=extra))
    cs = compile_scene(pbrt_parse(str(p)), "cpu")
    ref = ref_compile_scene(ref_pbrt_parse(str(p)))
    _tables_equal(cs, ref)
    assert cs.static.has_infinite and cs.static.has_env_map == bool(mapname)
    assert cs.static.infinite_light_index == ref.static.infinite_light_index == 0
    assert ref.static.has_env_map == bool(mapname)


@pytest.mark.parametrize("case", ["infinite light", "infinite light mapname"])
def test_parsed_infinite_lights_compile_as_reference(tmp_path, case):
    _infinite_light_tables(tmp_path, "sky.pfm" if case.endswith("mapname") else "")


@pytest.mark.parametrize("case", list(PORTED) + list(REFUSED) + ["bdpt"])
def test_refused_features_raise_builder_messages(tmp_path, case):
    """What the API builds and the port cannot render is refused by
    compile_scene, naming the feature; a feature a later slice ported runs
    its counterpart (PORTED). The motion scenes and the bdpt integrator
    compile to the reference's tables, and so do they under mlt and sppm,
    which render through their own host loops (route torch-mlt/ or
    torch-sppm/ and the query's); an integrator neither package has is
    refused by its name."""
    from test_torch_sppm import render_small

    if case in PORTED:
        PORTED[case](tmp_path)
        return
    extra, kind = REFUSED.get(case, ("", "sppm"))
    text = room_text(3, "zerotwosequence", "box", extra)
    if case == "bdpt":
        text = text.replace('Integrator "path"', 'Integrator "bdpt"')
    p = tmp_path / "s.pbrt"
    p.write_text(text)
    cs = compile_scene(pbrt_parse(str(p)), "cpu")
    _tables_equal(cs, ref_compile_scene(ref_pbrt_parse(str(p))))
    assert cs.static.has_motion == (case in ("motion", "medium"))
    p.write_text(text.replace('Integrator "path"', f'Integrator "{kind}"').replace(
        'Integrator "bdpt"', f'Integrator "{kind}"'))
    if case == "unknown":
        with pytest.raises(NotImplementedError, match="the 'photonmap' integrator"):
            compile_scene(pbrt_parse(str(p)), "cpu")
        return
    cs = compile_scene(pbrt_parse(str(p)), "cpu")
    _tables_equal(cs, ref_compile_scene(ref_pbrt_parse(str(p))))
    img, tier = render_small(pbrt_parse(str(p)), kind)
    assert tier == f"torch-{kind}/brute" and np.isfinite(img).all()


def test_parsed_panel_light_rows(tmp_path):
    """The panel's two-sided area light, from a file, gives the light rows
    of the hand-built two-sided panel of scenes.mesh_room."""
    from pbrt_tpu_torch.scenes import mesh_room

    p = tmp_path / "s.pbrt"
    p.write_text(room_text(3, "zerotwosequence", "box"))
    got = compile_scene(pbrt_parse(str(p)), "cpu").arrays
    want = compile_scene(mesh_room(1), "cpu").arrays
    assert torch.equal(got.light_kind, want.light_kind) and len(got.light_kind) == 2
    np.testing.assert_array_equal(got.light_param.numpy(), want.light_param.numpy())


@pytest.mark.parametrize("room", ["mesh_room", "material_room", "sky_meshes", "textured_room", "sphere_room"])
def test_written_rooms_compile_to_the_same_tables(tmp_path, room):
    """scenes.write_pbrt's file of a room (float64 PLY meshes with their
    normals and UVs, sphere_room's spheres as a Translate and a sphere
    Shape, a LookAt camera) parses to the room's camera and
    compiles to its tables, bit for bit (NaN padding of the wide nodes, the
    attribute table and the infinite light's row included); without a
    Sampler directive the file gets pbrt's default, halton at 16 spp."""
    from pbrt_tpu_torch import scenes

    if room == "textured_room":  # small images; the textures as Texture directives and PFM files
        desc = scenes.textured_room(8, 48, 24, 12)
    else:
        desc = scenes.sky_meshes(10, 6, 10) if room == "sky_meshes" else getattr(scenes, room)(8)
    path = str(tmp_path / "room.pbrt")
    look_at = scenes.SKY_LOOK_AT if room == "sky_meshes" else scenes.ROOM_LOOK_AT
    scenes.write_pbrt(desc, path, look_at, sampler=room == "mesh_room")
    parsed = pbrt_parse(path)
    if room in ("sky_meshes", "textured_room"):
        assert parsed.film.filter_name == "gaussian" and parsed.film.filter_params == desc.film.filter_params
    if room == "sky_meshes":
        assert [hl.kind for hl in parsed.lights] == ["infinite", "distant"]
    np.testing.assert_array_equal(parsed.camera.camera_to_world.m, desc.camera.camera_to_world.m)
    assert parsed.sampler.kind == ("zerotwosequence" if room == "mesh_room" else "halton")
    assert parsed.sampler.pixel_samples == 16 and parsed.integrator.max_depth == 5
    got, want = compile_scene(parsed, "cpu"), compile_scene(desc, "cpu")
    assert got.static == want.static
    for f in dataclasses.fields(SceneTensors):
        a, b = getattr(got.arrays, f.name), getattr(want.arrays, f.name)
        assert (a is None) == (b is None), f.name
        if isinstance(a, dict):  # the MIP levels (the imagemaps' PFM files are float32, exact)
            assert a.keys() == b.keys(), f.name
            for k in a:
                np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), err_msg=k)
        elif a is not None:
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f.name)
