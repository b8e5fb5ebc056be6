"""Typed parameter lists for .pbrt directives (reference: core/paramset.rs).

A ``ParamSet`` stores the ``"type name" [values]`` parameters attached to a
directive, with typed ``find_one_*`` / ``find_*`` lookups, used-parameter
tracking for ``report_unused`` warnings, and conversion of spectral parameter
forms (blackbody / xyz / sampled-spectrum files) into RGB at parse time —
matching the reference's "parse spectral, render RGB" pipeline
(paramset.rs:94-441, spectrum.rs:129).

The port's copy of ``pbrt_tpu/core/paramset.py``.
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field

import numpy as np

from .spectrum import blackbody_rgb, spd_to_rgb, xyz_to_rgb

log = logging.getLogger(__name__)

# Canonical type names; parser aliases are normalized here.
_ALIASES = {
    "color": "rgb",
    "point": "point3",
    "vector": "vector3",
}

SCALAR_TYPES = {"integer", "float", "bool", "string", "texture"}
VEC2_TYPES = {"point2", "vector2"}
VEC3_TYPES = {"point3", "vector3", "normal", "rgb", "xyz"}


@dataclass
class ParamSet:
    """Heterogeneous named parameter store (paramset.rs:94)."""

    params: dict = field(default_factory=dict)  # (type, name) -> np.ndarray | list
    _used: set = field(default_factory=set)
    search_dir: str = ""

    def add(self, decl_type: str, name: str, values):
        t = _ALIASES.get(decl_type, decl_type)
        if t == "integer":
            values = np.asarray(values, dtype=np.int64)
        elif t == "float":
            values = np.asarray(values, dtype=np.float64)
        elif t == "bool":
            values = [v in (True, "true") for v in values]
        elif t in ("string", "texture"):
            values = [str(v) for v in values]
        elif t in VEC2_TYPES:
            values = np.asarray(values, dtype=np.float64).reshape(-1, 2)
        elif t in ("point3", "vector3", "normal"):
            values = np.asarray(values, dtype=np.float64).reshape(-1, 3)
        elif t == "rgb":
            values = np.asarray(values, dtype=np.float64).reshape(-1, 3)
        elif t == "xyz":
            values = xyz_to_rgb(np.asarray(values, dtype=np.float64).reshape(-1, 3))
            t = "rgb"
        elif t == "blackbody":
            # pairs of (temperature, scale) -> RGB (paramset.rs add_blackbody)
            v = np.asarray(values, dtype=np.float64).reshape(-1, 2)
            values = np.stack([blackbody_rgb(tk, sc) for tk, sc in v], axis=0)
            t = "rgb"
        elif t == "spectrum":
            values = self._load_spectrum(values)
            t = "rgb"
        else:
            raise ValueError(f"unknown parameter type '{decl_type}' for '{name}'")
        self.params[(t, name)] = values

    def _load_spectrum(self, values):
        """'spectrum' params: either inline (lambda, value) pairs or filenames."""
        if values and isinstance(values[0], str):
            rgbs = []
            for fname in values:
                path = fname if os.path.isabs(fname) else os.path.join(self.search_dir, fname)
                try:
                    data = _read_float_file(path)
                except OSError:
                    log.warning("unable to read SPD file %s; using 0.5 gray", path)
                    rgbs.append(np.array([0.5, 0.5, 0.5]))
                    continue
                arr = np.asarray(data, dtype=np.float64).reshape(-1, 2)
                rgbs.append(spd_to_rgb(arr[:, 0], arr[:, 1]))
            return np.stack(rgbs, axis=0)
        arr = np.asarray(values, dtype=np.float64).reshape(-1, 2)
        return spd_to_rgb(arr[:, 0], arr[:, 1]).reshape(1, 3)

    # -- typed lookups ------------------------------------------------------
    def _get(self, t, name):
        key = (t, name)
        if key in self.params:
            self._used.add(key)
            return self.params[key]
        return None

    def find_one_float(self, name, default):
        v = self._get("float", name)
        if v is None:
            # pbrt accepts integers where floats are expected
            v = self._get("integer", name)
        return float(v[0]) if v is not None and len(v) else float(default)

    def find_one_int(self, name, default):
        v = self._get("integer", name)
        return int(v[0]) if v is not None and len(v) else int(default)

    def find_one_bool(self, name, default):
        v = self._get("bool", name)
        return bool(v[0]) if v else bool(default)

    def find_one_string(self, name, default):
        v = self._get("string", name)
        return str(v[0]) if v else str(default)

    def find_one_filename(self, name, default=""):
        s = self.find_one_string(name, "")
        if not s:
            return default
        return s if os.path.isabs(s) else os.path.join(self.search_dir, s)

    def find_texture_name(self, name):
        v = self._get("texture", name)
        return str(v[0]) if v else None

    def find_one_point3(self, name, default):
        v = self._get("point3", name)
        return np.array(v[0]) if v is not None and len(v) else np.asarray(default, dtype=np.float64)

    def find_one_vector3(self, name, default):
        v = self._get("vector3", name)
        return np.array(v[0]) if v is not None and len(v) else np.asarray(default, dtype=np.float64)

    def find_one_normal3(self, name, default):
        v = self._get("normal", name)
        return np.array(v[0]) if v is not None and len(v) else np.asarray(default, dtype=np.float64)

    def find_one_point2(self, name, default):
        v = self._get("point2", name)
        return np.array(v[0]) if v is not None and len(v) else np.asarray(default, dtype=np.float64)

    def find_one_rgb(self, name, default):
        v = self._get("rgb", name)
        return np.array(v[0]) if v is not None and len(v) else np.asarray(default, dtype=np.float64)

    # spectrum == rgb after normalization
    find_one_spectrum = find_one_rgb

    def find_floats(self, name):
        v = self._get("float", name)
        return np.array(v) if v is not None else None

    def find_ints(self, name):
        v = self._get("integer", name)
        return np.array(v) if v is not None else None

    def find_point3s(self, name):
        v = self._get("point3", name)
        return np.array(v) if v is not None else None

    def find_vector3s(self, name):
        v = self._get("vector3", name)
        return np.array(v) if v is not None else None

    def find_normals(self, name):
        v = self._get("normal", name)
        return np.array(v) if v is not None else None

    def find_point2s(self, name):
        v = self._get("point2", name)
        return np.array(v) if v is not None else None

    def find_rgbs(self, name):
        v = self._get("rgb", name)
        return np.array(v) if v is not None else None

    def find_strings(self, name):
        v = self._get("string", name)
        return list(v) if v is not None else None

    def has(self, name):
        return any(k[1] == name for k in self.params)

    def report_unused(self, context=""):
        """Warn on parameters never consumed (paramset.rs report_unused)."""
        for key in self.params:
            if key not in self._used:
                log.warning("parameter '%s %s' unused%s", key[0], key[1], f" ({context})" if context else "")


@dataclass
class TextureParams:
    """Resolves material/texture parameters that may name textures
    (reference paramset.rs:443): geometry params override material params."""

    geom: ParamSet
    material: ParamSet
    float_textures: dict  # name -> host texture object
    spectrum_textures: dict

    def _tex_ref(self, name):
        t = self.geom.find_texture_name(name)
        if t is None:
            t = self.material.find_texture_name(name)
        return t

    def get_spectrum_texture(self, name, default_rgb):
        """Returns ('texture', obj) or ('const', rgb)."""
        tname = self._tex_ref(name)
        if tname is not None:
            if tname in self.spectrum_textures:
                return ("texture", self.spectrum_textures[tname])
            log.warning("couldn't find spectrum texture '%s' for '%s'", tname, name)
        v = self.geom.find_one_rgb(name, None if default_rgb is None else np.asarray(default_rgb))
        if ("rgb", name) in self.geom.params:
            return ("const", v)
        v = self.material.find_one_rgb(name, None if default_rgb is None else np.asarray(default_rgb))
        if ("rgb", name) in self.material.params:
            return ("const", v)
        if default_rgb is None:
            return None
        return ("const", np.asarray(default_rgb, dtype=np.float64))

    def get_float_texture(self, name, default):
        tname = self._tex_ref(name)
        if tname is not None:
            if tname in self.float_textures:
                return ("texture", self.float_textures[tname])
            log.warning("couldn't find float texture '%s' for '%s'", tname, name)
        if ("float", name) in self.geom.params:
            return ("const", self.geom.find_one_float(name, default))
        if ("float", name) in self.material.params:
            return ("const", self.material.find_one_float(name, default))
        if default is None:
            return None
        return ("const", float(default))

    def get_float_texture_or_none(self, name):
        return self.get_float_texture(name, None)

    # Plain (non-texturable) lookups: geometry first, then material.
    def find_one_float(self, name, default):
        return self.geom.find_one_float(name, self.material.find_one_float(name, default))

    def find_one_int(self, name, default):
        return self.geom.find_one_int(name, self.material.find_one_int(name, default))

    def find_one_bool(self, name, default):
        return self.geom.find_one_bool(name, self.material.find_one_bool(name, default))

    def find_one_string(self, name, default):
        return self.geom.find_one_string(name, self.material.find_one_string(name, default))

    def find_one_filename(self, name, default=""):
        return self.geom.find_one_filename(name, self.material.find_one_filename(name, default))

    def find_one_rgb(self, name, default):
        return self.geom.find_one_rgb(name, self.material.find_one_rgb(name, default))

    def report_unused(self, context=""):
        self.geom.report_unused(context)


def _read_float_file(path):
    """Whitespace/comment-tolerant float file reader (reference floatfile.rs)."""
    vals = []
    with open(path, "r") as f:
        for line in f:
            line = line.split("#", 1)[0]
            for tok in line.split():
                vals.append(float(tok))
    return vals
