"""SceneParameters: a dotted-key view of the scene's tensors.

The JAX package's `ad/params.py` (after the reference's mi.traverse):
keys such as "materials.base_color" address the tensor fields of the
Scene's dataclasses; `update` returns a new scene (the scene's
dataclasses are frozen). Static fields (tuples and ints such as
`present_types`, `grt_static`, `mf_static`) and fields the scene derives
itself (`init=False`: `env_emitter`, `wbvh`) are not parameters; an
updated scene derives them again (`Scene.__post_init__`), and a packet
scene's WideBVH is its PacketBVH's own, built once.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch


def _is_dc(x):
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def _walk(obj, prefix=""):
    out = {}
    for f in dataclasses.fields(obj):
        if not f.init:
            continue
        child = getattr(obj, f.name)
        key = f"{prefix}{f.name}"
        if _is_dc(child):
            out.update(_walk(child, key + "."))
        elif isinstance(child, torch.Tensor):
            out[key] = child
    return out


def _apply(obj, vals, prefix):
    changes = {}
    for f in dataclasses.fields(obj):
        if not f.init:
            continue
        child = getattr(obj, f.name)
        key = f"{prefix}{f.name}"
        if _is_dc(child):
            new = _apply(child, vals, key + ".")
            if new is not child:
                changes[f.name] = new
        elif key in vals and vals[key] is not child:
            changes[f.name] = vals[key]
    return dataclasses.replace(obj, **changes) if changes else obj


class SceneParameters(dict):
    """dict of dotted key -> tensor, bound to a source scene."""

    def __init__(self, scene):
        super().__init__(_walk(scene))
        self._scene = scene

    def update(self, overrides: Dict[str, Any] | None = None):
        """A new scene with this dict's (possibly modified) tensors;
        untouched fields are the source scene's own objects."""
        vals = dict(self)
        if overrides:
            vals.update(overrides)
        return _apply(self._scene, vals, "")


def traverse(scene) -> SceneParameters:
    return SceneParameters(scene)
