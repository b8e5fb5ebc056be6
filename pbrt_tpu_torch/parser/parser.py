"""Recursive-descent parser for .pbrt directives.

The reference uses an LALRPOP LR grammar (src/commands.lalrpop
-> Vec<PBRTCommands>); the pbrt grammar is regular enough that a hand-rolled
token-stream walk is sufficient.  ``parse_file`` yields ``Directive`` records;
``parse`` drives an API object (one method per directive, reference
src/pbrtparser/pbrtparser.rs:34-84) and expands ``Include`` inline,
relative to the including scene's directory. The port's copy of
``pbrt_tpu/parser/parser.py``.
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field

from ..core.paramset import ParamSet
from .lexer import IDENT, LBRACK, NUM, RBRACK, STR, tokenize_file

log = logging.getLogger(__name__)


class ParseError(Exception):
    pass


@dataclass
class Directive:
    name: str
    args: list = field(default_factory=list)  # fixed positional args
    params: ParamSet = None
    line: int = 0


# Directives taking N fixed numeric arguments.
_NUMERIC_ARGS = {
    "Translate": 3,
    "Scale": 3,
    "Rotate": 4,
    "LookAt": 9,
    "Transform": 16,
    "ConcatTransform": 16,
    "TransformTimes": 2,
}
# Directives with no arguments.
_BARE = {
    "WorldBegin",
    "WorldEnd",
    "AttributeBegin",
    "AttributeEnd",
    "TransformBegin",
    "TransformEnd",
    "ObjectEnd",
    "Identity",
    "ReverseOrientation",
}
# Directives taking one string then a ParamSet.
_NAMED_PLUGIN = {
    "Camera",
    "Sampler",
    "Film",
    "PixelFilter",
    "Filter",
    "Integrator",
    "Accelerator",
    "Material",
    "Shape",
    "LightSource",
    "AreaLightSource",
    "MakeNamedMaterial",
    "MakeNamedMedium",
}
# Directives taking one string argument only.
_ONE_STRING = {
    "CoordinateSystem",
    "CoordSysTransform",
    "NamedMaterial",
    "ObjectBegin",
    "ObjectInstance",
    "Include",
    "ActiveTransform",
}


class _TokenStream:
    def __init__(self, tokens, filename):
        self.tokens = tokens
        self.i = 0
        self.filename = filename

    def peek(self):
        return self.tokens[self.i] if self.i < len(self.tokens) else None

    def next(self):
        t = self.peek()
        if t is None:
            raise ParseError(f"{self.filename}: unexpected end of file")
        self.i += 1
        return t

    def expect(self, kind):
        t = self.next()
        if t.kind != kind:
            raise ParseError(f"{self.filename}:{t.line}: expected {kind}, got {t.kind} {t.value!r}")
        return t


def _parse_value_list(ts):
    """Parse either a single value or '[' value* ']'."""
    t = ts.peek()
    if t is None:
        raise ParseError(f"{ts.filename}: expected parameter value")
    vals = []
    if t.kind == LBRACK:
        ts.next()
        while True:
            t = ts.next()
            if t.kind == RBRACK:
                break
            vals.append(_coerce_value(t, ts))
    else:
        vals.append(_coerce_value(ts.next(), ts))
    return vals


def _coerce_value(t, ts):
    if t.kind == NUM:
        return t.value
    if t.kind == STR:
        return t.value
    if t.kind == IDENT and t.value in ("true", "false"):
        return t.value == "true"
    raise ParseError(f"{ts.filename}:{t.line}: unexpected token {t.value!r} in value list")


def _parse_params(ts, search_dir):
    ps = ParamSet(search_dir=search_dir)
    while True:
        t = ts.peek()
        if t is None or t.kind != STR:
            break
        decl = ts.next().value
        parts = decl.split()
        if len(parts) != 2:
            raise ParseError(f"{ts.filename}:{t.line}: bad parameter declaration {decl!r}")
        decl_type, name = parts
        vals = _parse_value_list(ts)
        ps.add(decl_type, name, vals)
    return ps


def parse_tokens(tokens, filename, search_dir):
    """Token stream -> list[Directive] (one file; Include handled by caller)."""
    ts = _TokenStream(tokens, filename)
    out = []
    while ts.peek() is not None:
        t = ts.next()
        if t.kind != IDENT:
            raise ParseError(f"{filename}:{t.line}: expected directive, got {t.value!r}")
        name = t.value
        if name in _BARE:
            out.append(Directive(name, line=t.line))
        elif name in _NUMERIC_ARGS:
            n = _NUMERIC_ARGS[name]
            args = [ts.expect(NUM).value for _ in range(n)]
            out.append(Directive(name, args=args, line=t.line))
        elif name in _ONE_STRING:
            if name == "ActiveTransform":
                a = ts.next()  # All | StartTime | EndTime (bare ident)
                out.append(Directive(name, args=[a.value], line=t.line))
            else:
                s = ts.expect(STR).value
                out.append(Directive(name, args=[s], line=t.line))
        elif name in _NAMED_PLUGIN:
            s = ts.expect(STR).value
            params = _parse_params(ts, search_dir)
            out.append(Directive(name, args=[s], params=params, line=t.line))
        elif name == "Texture":
            tex_name = ts.expect(STR).value
            tex_type = ts.expect(STR).value  # "float" | "color" | "spectrum"
            tex_class = ts.expect(STR).value  # e.g. "checkerboard"
            params = _parse_params(ts, search_dir)
            out.append(Directive(name, args=[tex_name, tex_type, tex_class], params=params, line=t.line))
        elif name == "MediumInterface":
            inside = ts.expect(STR).value
            outside = ""
            nt = ts.peek()
            if nt is not None and nt.kind == STR:
                outside = ts.next().value
            out.append(Directive(name, args=[inside, outside], line=t.line))
        else:
            raise ParseError(f"{filename}:{t.line}: unknown directive {name!r}")
    return out


def parse_file(path, search_dir=None):
    if search_dir is None:
        search_dir = os.path.dirname(os.path.abspath(path))
    return parse_tokens(tokenize_file(path), path, search_dir)


# API method name per directive (reference pbrtparser.rs:37-84).
_DISPATCH = {
    "WorldBegin": "world_begin",
    "WorldEnd": "world_end",
    "AttributeBegin": "attribute_begin",
    "AttributeEnd": "attribute_end",
    "TransformBegin": "transform_begin",
    "TransformEnd": "transform_end",
    "ObjectBegin": "object_begin",
    "ObjectEnd": "object_end",
    "ObjectInstance": "object_instance",
    "Identity": "identity",
    "ReverseOrientation": "reverse_orientation",
    "Translate": "translate",
    "Scale": "scale",
    "Rotate": "rotate",
    "LookAt": "look_at",
    "Transform": "transform",
    "ConcatTransform": "concat_transform",
    "TransformTimes": "transform_times",
    "ActiveTransform": "active_transform",
    "CoordinateSystem": "coordinate_system",
    "CoordSysTransform": "coord_sys_transform",
    "Camera": "camera",
    "Sampler": "sampler",
    "Film": "film",
    "PixelFilter": "pixel_filter",
    "Filter": "pixel_filter",
    "Integrator": "integrator",
    "Accelerator": "accelerator",
    "Material": "material",
    "NamedMaterial": "named_material",
    "MakeNamedMaterial": "make_named_material",
    "MakeNamedMedium": "make_named_medium",
    "MediumInterface": "medium_interface",
    "Texture": "texture",
    "Shape": "shape",
    "LightSource": "light_source",
    "AreaLightSource": "area_light_source",
}


def parse(path, api):
    """Parse a scene file, driving the API state machine; expands Include."""
    search_dir = os.path.dirname(os.path.abspath(path))
    _parse_into(path, search_dir, api)


def _parse_into(path, search_dir, api):
    for d in parse_file(path, search_dir):
        if d.name == "Include":
            inc = d.args[0]
            inc_path = inc if os.path.isabs(inc) else os.path.join(search_dir, inc)
            _parse_into(inc_path, search_dir, api)
            continue
        method = getattr(api, _DISPATCH[d.name])
        if d.name in _NUMERIC_ARGS:
            method(*d.args)
        elif d.name in _BARE:
            method()
        elif d.params is not None:
            method(*d.args, d.params)
        else:
            method(*d.args)
