"""The port's lexer, parser and --cat/--toply printer against the
reference's, on scene files written from inline texts.

``write_scene`` writes a main file that uses every directive the parser
knows (Include, ObjectBegin/End/Instance, named materials, media and
coordinate systems, ActiveTransform with motion, every texture class, shape
and light kind, spectrum, blackbody and xyz parameters) beside the files it
refers to: an included file, a binary PLY with a quad, a PNG, an EXR and an
SPD file. tests/test_torch_api.py parses the same files through the API.
Tokens, directives and printed text must be equal; the PLY files --toply
writes must be equal byte for byte.
"""
import io

import numpy as np
import pytest

from pbrt_tpu.core import imageio as ref_imageio
from pbrt_tpu.parser import catprint as ref_catprint
from pbrt_tpu.parser import lexer as ref_lexer
from pbrt_tpu.parser import parser as ref_parser
from pbrt_tpu_torch.core import imageio
from pbrt_tpu_torch.parser import catprint, lexer, parser

INCLUDED = """
# an included file: a named material, a texture and a light
MakeNamedMaterial "shiny" "string type" "plastic" "rgb Kd" [0.2 0.3 0.4] "float roughness" 0.05
Texture "checks" "spectrum" "checkerboard" "float uscale" 4 "float vscale" 4
    "rgb tex1" [1 0 0] "rgb tex2" [0 0 1] "string aamode" "none"
LightSource "spot" "point from" [0 5 0] "point to" [0 0 0] "blackbody I" [3000 2]
    "float coneangle" 40 "float conedeltaangle" 10
"""

MAIN = """
# every directive of the scene language
LookAt 0 2 8  0 0.5 0  0 1 0
Camera "perspective" "float fov" [45] "float lensradius" 0.01 "float focaldistance" 7
    "float screenwindow" [-1 1 -0.5 0.5]
Sampler "halton" "integer pixelsamples" 8
Film "image" "integer xresolution" [40] "integer yresolution" [20] "string filename" "out.exr"
    "float cropwindow" [0.1 0.9 0 1] "float scale" 1.5 "float maxsampleluminance" 20
PixelFilter "mitchell" "float B" 0.25 "float C" 0.375
Filter "gaussian" "float alpha" 3
Integrator "path" "integer maxdepth" [4] "string lightsamplestrategy" "power"
    "integer pixelbounds" [0 30 2 18]
Accelerator "bvh" "integer maxnodeprims" 2 "string splitmethod" "middle"
TransformTimes 0 1
MakeNamedMedium "fog" "string type" "homogeneous" "rgb sigma_a" [0.1 0.1 0.1] "rgb sigma_s" [0.5 0.5 0.5]
    "float g" 0.3 "float scale" 2
MakeNamedMedium "smoke" "string type" "heterogeneous" "integer nx" 2 "integer ny" 1 "integer nz" 1
    "float density" [0.5 1.5] "point p0" [0 0 0] "point p1" [1 1 1]
MakeNamedMedium "milk" "string type" "homogeneous" "string preset" "Wholemilk"
WorldBegin
CoordinateSystem "origin"
Include "included.pbrt"
AttributeBegin
  Translate 1 0 0
  Rotate 30 0 1 0
  Scale 2 1 1
  CoordinateSystem "moved"
AttributeEnd
AttributeBegin
  CoordSysTransform "moved"
  Material "matte" "spectrum Kd" [400 0.3 500 0.6 700 0.9] "float sigma" 10
  Shape "sphere" "float radius" 0.5 "float zmin" -0.3 "float zmax" 0.4 "float phimax" 300
AttributeEnd
TransformBegin
  Transform 1 0 0 0  0 1 0 0  0 0 1 0  0 0.5 0 1
  ConcatTransform 1 0 0 0  0 1 0 0  0 0 1 0  1 0 0 1
  Material "glass" "float index" 1.33
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point P" [-1 0 -1  1 0 -1  1 0 1  -1 0 1] "normal N" [0 1 0  0 1 0  0 1 0  0 1 0]
      "float uv" [0 0 1 0 1 1 0 1] "vector S" [1 0 0  1 0 0  1 0 0  1 0 0]
TransformEnd
Identity
NamedMaterial "shiny"
Shape "plymesh" "string filename" "mesh.ply"
Shape "plymesh" "string filename" "missing.ply"
Texture "img" "spectrum" "imagemap" "string filename" "tex.png" "float scale" 2 "string wrap" "clamp"
Texture "hdr" "spectrum" "imagemap" "string filename" "env.exr"
Texture "gone" "spectrum" "imagemap" "string filename" "nowhere.png"
Texture "k" "float" "constant" "float value" 0.7
Texture "sc" "spectrum" "scale" "texture tex1" "img" "rgb tex2" [0.5 0.5 0.5]
Texture "mx" "spectrum" "mix" "texture tex1" "checks" "texture tex2" "img" "texture amount" "k"
Texture "uvt" "spectrum" "uv" "string mapping" "planar" "vector v1" [1 0 0] "vector v2" [0 0 1]
Texture "bl" "float" "bilerp" "float v00" 0 "float v01" 1 "float v10" 0.5 "float v11" 0.25
Texture "dt" "spectrum" "dots" "rgb inside" [1 1 0]
Texture "fb" "float" "fbm" "integer octaves" 4 "float roughness" 0.6
Texture "wr" "float" "wrinkled"
Texture "ma" "spectrum" "marble" "float variation" 0.3 "float scale" 2
Texture "wi" "float" "windy"
Texture "odd" "float" "nosuchtexture"
Texture "weird" "vector" "constant"
Material "uber" "texture Kd" "mx" "rgb Ks" [0.1 0.1 0.1] "float uroughness" 0.2 "float vroughness" 0.3
    "float eta" 1.4 "rgb opacity" [0.9 0.9 0.9] "texture bumpmap" "fb"
Shape "disk" "float radius" 2 "float innerradius" 0.5 "float height" 0.1
Material "metal" "xyz eta" [0.2 0.9 1.1] "rgb k" [3 2.5 2] "float roughness" 0.02 "string distribution" "beckmann"
Shape "cylinder" "float radius" 0.3 "float zmin" 0 "float zmax" 1 "float phimax" 270
Material "substrate" "texture Kd" "dt"
Shape "cone" "float radius" 0.4 "float height" 0.8
Material "translucent" "texture Kd" "sc"
Shape "paraboloid" "float radius" 0.5 "float zmax" 0.7
Material "disney" "rgb color" [0.8 0.2 0.2] "float metallic" 0.5 "float sheen" 0.2
Shape "hyperboloid" "point p1" [0.5 0 0] "point p2" [0 0.5 1]
Material "subsurface" "string name" "Ketchup" "float scale" 3
Shape "__cone_tessellated" "float radius" 0.2
Material "kdsubsurface" "texture Kd" "uvt" "float eta" 1.4
Shape "heightfield" "integer nu" 3 "integer nv" 2 "float Pz" [0 0.5 0.2 0.1 0.4 0.3]
Material "fourier" "string bsdffile" "paint.bsdf"
Shape "loopsubdiv" "integer levels" 2 "integer indices" [0 1 2 0 2 3 0 3 1 1 3 2]
    "point P" [0 0 0  1 0 0  0 1 0  0 0 1]
Material "hair" "float eumelanin" 1.3
Shape "curve" "string type" "cylinder" "point P" [0 0 0  0.3 0.5 0  0.6 0.5 0  1 0 0  1.3 -0.2 0  1.6 0 0  2 0 0]
    "float width0" 0.1 "float width1" 0.02
Shape "curve" "string type" "ribbon" "point P" [0 0 0  0 0.5 0  0 1 0.5  0 1 1]
    "normal N" [0 0 1  1 0 0] "float width" 0.05
Material "mix" "string namedmaterial1" "shiny" "string namedmaterial2" "shiny" "texture amount" "checks"
Shape "nurbs" "integer nu" 3 "integer nv" 3 "integer uorder" 3 "integer vorder" 3
    "float uknots" [0 0 0 1 1 1] "float vknots" [0 0 0 1 1 1]
    "point P" [0 0 0  1 0 0  2 0 0  0 1 0  1 1 1  2 1 0  0 2 0  1 2 0  2 2 0]
Material "mix" "string namedmaterial1" "nope" "string namedmaterial2" "shiny"
Material "hair" "rgb sigma_a" [0.3 0.4 0.5]
Material "plasticky"
Shape "nurbs" "integer nu" 2 "integer nv" 2 "integer uorder" 2 "integer vorder" 2
    "float uknots" [0 0 1 1] "float vknots" [0 0 1 1] "float Pw" [0 0 0 1  1 0 0 2  0 1 0 1  1 1 1 1]
Shape "nosuchshape"
MediumInterface "fog" "smoke"
Material "matte" "texture Kd" "checks" "texture sigma" "k"
AttributeBegin
  ReverseOrientation
  AreaLightSource "diffuse" "rgb L" [4 4 4] "bool twosided" true "integer samples" 2
  Shape "trianglemesh" "integer indices" [0 1 2] "point P" [0 3 0  1 3 0  0 3 1]
    "float alpha" 0
AttributeEnd
MediumInterface "" ""
ObjectBegin "thing"
  Material "mirror" "rgb Kr" [0.8 0.8 0.8]
  Shape "trianglemesh" "integer indices" [0 1 2] "point P" [0 0 0  1 0 0  0 1 0] "texture shadowalpha" "k"
  Shape "sphere" "float radius" 0.25
ObjectEnd
AttributeBegin
  Translate 3 0 0
  ObjectInstance "thing"
AttributeEnd
ObjectInstance "thing"
ObjectInstance "nothing"
ActiveTransform EndTime
Translate 0 0.2 0
ActiveTransform All
Shape "sphere" "float radius" 0.1
Shape "trianglemesh" "integer indices" [0 1 2] "point P" [0 0 2  1 0 2  0 1 2]
ActiveTransform StartTime
ActiveTransform Sometime
Identity
LightSource "point" "point from" [0 4 0] "rgb I" [10 10 10] "rgb scale" [0.5 0.5 0.5]
LightSource "distant" "point from" [0 1 0] "point to" [0 0 0] "spectrum L" "light.spd"
LightSource "infinite" "string mapname" "env.exr" "integer samples" 4
LightSource "infinite" "rgb L" [0.1 0.1 0.1]
LightSource "goniometric" "string mapname" "tex.png" "rgb I" [2 2 2]
LightSource "projection" "string mapname" "env.exr" "float fov" 30
LightSource "nosuchlight"
AttributeEnd
WorldEnd
"""


def _write_ply_with_quad(path):
    """Binary little-endian PLY: 5 vertices with normals and uv, a quad and
    a triangle."""
    p = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0.5, 0.5, 1]], "<f4")
    n = np.tile(np.array([0, 0, 1], "<f4"), (5, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1], [0.5, 0.5]], "<f4")
    header = ("ply\nformat binary_little_endian 1.0\nelement vertex 5\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property float nx\nproperty float ny\nproperty float nz\n"
              "property float u\nproperty float v\n"
              "element face 2\nproperty list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(np.hstack([p, n, uv]).astype("<f4").tobytes())
        f.write(bytes([4]) + np.array([0, 1, 2, 3], "<i4").tobytes())
        f.write(bytes([3]) + np.array([0, 1, 4], "<i4").tobytes())


def write_scene(tmp_path):
    """Write MAIN and the files it refers to into tmp_path; returns the
    main file's path."""
    rs = np.random.RandomState(3)
    (tmp_path / "included.pbrt").write_text(INCLUDED)
    main = tmp_path / "main.pbrt"
    main.write_text(MAIN)
    _write_ply_with_quad(tmp_path / "mesh.ply")
    imageio.write_png(str(tmp_path / "tex.png"), (rs.random_sample((6, 8, 3)) * 255).astype(np.uint8))
    ref_imageio.write_exr(str(tmp_path / "env.exr"), rs.random_sample((4, 8, 3)).astype(np.float32))
    (tmp_path / "light.spd").write_text("# lambda value\n400 0.5\n550 1.0\n700 0.25\n")
    return str(main)


def test_tokens_equal(tmp_path):
    path = write_scene(tmp_path)
    for f in (path, str(tmp_path / "included.pbrt")):
        assert lexer.tokenize_file(f) == [lexer.Token(t.kind, t.value, t.line) for t in ref_lexer.tokenize_file(f)]
    with pytest.raises(lexer.LexError, match="unexpected character"):
        list(lexer.tokenize('Shape "sphere" @'))


def _directive_tuple(d):
    params = None
    if d.params is not None:
        params = (d.params.search_dir, [(k, np.asarray(v).tolist() if isinstance(v, np.ndarray) else v)
                                        for k, v in d.params.params.items()])
    return d.name, d.args, params, d.line


def test_directives_equal(tmp_path):
    path = write_scene(tmp_path)
    got = parser.parse_file(path)
    want = ref_parser.parse_file(path)
    assert len(got) == len(want) > 100
    assert [_directive_tuple(d) for d in got] == [_directive_tuple(d) for d in want]
    names = {d.name for d in got + parser.parse_file(str(tmp_path / "included.pbrt"))}
    assert names == set(parser._DISPATCH) | {"Include"}
    with pytest.raises(parser.ParseError, match="unknown directive"):
        parser.parse_tokens(list(lexer.tokenize("Bogus 1")), "x", "")


@pytest.mark.parametrize("to_ply", [False, True])
def test_cat_scene_equal(tmp_path, to_ply):
    """--cat text is equal; with --toply, the meshes of at least 500
    triangles become mesh_%05d.ply files, equal byte for byte."""
    n = 24
    xs, zs = np.meshgrid(np.arange(n + 1.0), np.arange(n + 1.0))
    p = np.stack([xs.ravel() * 0.1, np.sin(xs.ravel()) * 0.05, zs.ravel() * 0.1], -1)
    idx = [[i * (n + 1) + j, i * (n + 1) + j + 1, (i + 1) * (n + 1) + j] for i in range(n) for j in range(n)]
    idx += [[i * (n + 1) + j + 1, (i + 1) * (n + 1) + j + 1, (i + 1) * (n + 1) + j] for i in range(n) for j in range(n)]
    path = write_scene(tmp_path)
    with open(path, "a") as f:
        f.write('WorldBegin\nShape "trianglemesh" "integer indices" [%s] "point P" [%s] "point2 uv" [%s]\nWorldEnd\n'
                % (" ".join(str(i) for i in np.ravel(idx)), " ".join(repr(float(v)) for v in p.ravel()),
                   " ".join(repr(float(v)) for v in p[:, ::2].ravel())))
    outs = []
    for mod, pmod, sub in ((catprint, parser, "port"), (ref_catprint, ref_parser, "ref")):
        (tmp_path / sub).mkdir()
        buf = io.StringIO()
        n_ply = mod.cat_scene(pmod.parse_file(path), to_ply=to_ply, out=buf, ply_dir=str(tmp_path / sub))
        outs.append((buf.getvalue(), n_ply, sorted(f.name for f in (tmp_path / sub).iterdir())))
    assert outs[0] == outs[1]
    assert outs[0][1] == (1 if to_ply else 0)
    for name in outs[0][2]:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()
