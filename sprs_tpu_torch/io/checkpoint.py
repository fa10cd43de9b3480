"""Checkpoints of trees of sparse matrices and tensors, the counterpart
of ``sprs_tpu/io/checkpoint.py``.

The JAX package stores a pytree's leaves through orbax and its structure
by pickling the treedef.  Here the leaves (every tensor and numpy array
of the tree, copied to the host and cut to their own storage) go into
one ``torch.save`` file, ``leaves.pt``, and the structure into a JSON
file, ``tree.json``: dicts with string or integer keys, lists, tuples,
None, Python scalars, tensors, numpy arrays and the port's formats
(:class:`CsMat`, :class:`CsVec`, :class:`DiaMat`, :class:`EllMat`,
:class:`BsrMat`, their static fields as JSON).  Loading reads the
leaves with ``torch.load(weights_only=True)`` and the structure as JSON,
so that a checkpoint runs no code: no class is unpickled.  With
``validate`` every restored :class:`CsMat` passes ``check_structure``,
so a corrupted checkpoint raises :class:`StructureError`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch

from ..errors import StructureError
from ..formats.bsr import BsrMat
from ..formats.csmat import CsMat
from ..formats.csvec import CsVec
from ..formats.dia import DiaMat
from ..formats.ell import EllMat

_FORMATS = {cls.__name__: cls for cls in (CsMat, CsVec, DiaMat, EllMat, BsrMat)}
TREE_FILE = "tree.json"
LEAVES_FILE = "leaves.pt"


def _encode(x, leaves: list):
    if x is None:
        return {"t": "none"}
    if isinstance(x, (bool, int, float, str)):
        return {"t": "value", "v": x}
    if isinstance(x, torch.Tensor):
        leaves.append(x.detach().cpu().contiguous().clone())
        return {"t": "tensor", "i": len(leaves) - 1, "device": str(x.device)}
    if isinstance(x, np.ndarray):
        leaves.append(torch.from_numpy(np.array(x, copy=True, order="C")))
        return {"t": "ndarray", "i": len(leaves) - 1}
    if type(x).__name__ in _FORMATS and type(x) is _FORMATS[type(x).__name__]:
        tensors, static = {}, {}
        for f in dataclasses.fields(x):
            v = getattr(x, f.name)
            if isinstance(v, torch.Tensor):
                tensors[f.name] = _encode(v, leaves)
            else:
                static[f.name] = list(v) if isinstance(v, tuple) else v
        return {"t": type(x).__name__, "tensors": tensors, "static": static}
    if isinstance(x, dict):
        keys = list(x)
        if not all(isinstance(k, (str, int)) and not isinstance(k, bool) for k in keys):
            raise TypeError("checkpoint dict keys must be str or int")
        return {"t": "dict", "keys": keys, "items": [_encode(x[k], leaves) for k in keys]}
    if isinstance(x, (list, tuple)):
        return {"t": type(x).__name__, "items": [_encode(v, leaves) for v in x]}
    raise TypeError(f"cannot checkpoint {type(x)}")


def save_checkpoint(path: str, tree: Any) -> None:
    """Save a tree of sparse objects, tensors and arrays under the
    directory ``path`` (created, or overwritten)."""
    leaves: list = []
    spec = _encode(tree, leaves)
    os.makedirs(path, exist_ok=True)
    torch.save(leaves, os.path.join(path, LEAVES_FILE))
    with open(os.path.join(path, TREE_FILE), "w") as f:
        json.dump(spec, f)


def _bad(msg: str) -> StructureError:
    return StructureError.size_mismatch(f"checkpoint: {msg}")


def _decode(node, leaves: list, device):
    if not isinstance(node, dict) or "t" not in node:
        raise _bad(f"malformed node {node!r}")
    t = node["t"]
    if t == "none":
        return None
    if t == "value":
        return node["v"]
    if t in ("tensor", "ndarray"):
        i = node.get("i")
        if not isinstance(i, int) or not 0 <= i < len(leaves):
            raise _bad(f"leaf index {i!r} out of range")
        leaf = leaves[i]
        if t == "ndarray":
            return leaf.numpy()
        return leaf.to(device if device is not None else node["device"])
    if t == "dict":
        return {k: _decode(v, leaves, device) for k, v in zip(node["keys"], node["items"])}
    if t in ("list", "tuple"):
        items = [_decode(v, leaves, device) for v in node["items"]]
        return items if t == "list" else tuple(items)
    if t in _FORMATS:
        fields = {k: _decode(v, leaves, device) for k, v in node["tensors"].items()}
        fields.update({k: tuple(v) if isinstance(v, list) else v
                       for k, v in node["static"].items()})
        try:
            return _FORMATS[t](**fields)
        except TypeError as e:
            raise _bad(f"{t} fields: {e}") from None
    raise _bad(f"unknown node type {t!r}")


def load_checkpoint(path: str, *, validate: bool = True, device=None) -> Any:
    """Restore a tree saved by :func:`save_checkpoint`.

    Tensors go to ``device``, or with ``device=None`` back to the device
    each was saved from; numpy arrays come back as numpy arrays.  With
    ``validate`` (default), every :class:`CsMat` in the restored tree
    passes ``check_structure``.
    """
    leaves = torch.load(os.path.join(path, LEAVES_FILE), map_location="cpu", weights_only=True)
    if not isinstance(leaves, list) or not all(isinstance(v, torch.Tensor) for v in leaves):
        raise _bad("leaves are not a list of tensors")
    with open(os.path.join(path, TREE_FILE)) as f:
        spec = json.load(f)
    tree = _decode(spec, leaves, device)
    if validate:
        for obj in _iter_csmat(tree):
            obj.check_structure()
    return tree


def _iter_csmat(tree):
    if isinstance(tree, CsMat):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _iter_csmat(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _iter_csmat(v)
