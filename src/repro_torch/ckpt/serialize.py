"""Tree <-> flat bytes serialization for checkpoint striping (port of
`repro.ckpt.serialize`).

A tree is nested dicts, tuples and lists whose leaves are tensors or numpy
arrays. It flattens to one contiguous byte buffer plus a JSON-able
manifest (paths, shapes, dtypes, offsets). The buffer is what the
erasure-coding layer stripes; the manifest is tiny and kept beside it.

The order and the bytes match the reference's, so a buffer written by one
package restores in the other: dict keys in sorted order, sequences by
index (as `jax.tree_util` flattens), path strings such as
`segments/0/0/attn/wq`, numpy dtype names, and bf16 stored as its uint16
bit pattern under the dtype name "bfloat16". `treedef_repr` is the port's
own description of the tree's structure.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Manifest:
    entries: tuple  # ((path, shape, dtype, offset, nbytes), ...)
    treedef_repr: str
    total_bytes: int

    def to_json(self) -> str:
        return json.dumps({
            "entries": [[p, list(s), d, o, n] for p, s, d, o, n in self.entries],
            "treedef": self.treedef_repr,
            "total_bytes": self.total_bytes,
        })

    @classmethod
    def from_json(cls, s: str) -> "Manifest":
        obj = json.loads(s)
        return cls(tuple((p, tuple(sh), d, o, n)
                         for p, sh, d, o, n in obj["entries"]),
                   obj["treedef"], obj["total_bytes"])


class TreeDef:
    """The structure of a tree with its leaves left out: nested dicts,
    tuples and lists, each leaf a `None` placeholder."""

    def __init__(self, skeleton: Any):
        self.skeleton = skeleton

    def __repr__(self) -> str:
        return f"TreeDef({_repr(self.skeleton)})"

    def unflatten(self, leaves: list) -> Any:
        it = iter(leaves)
        tree = _fill(self.skeleton, it)
        if next(it, None) is not None:
            raise ValueError("more leaves than the tree holds")
        return tree


def _repr(node) -> str:
    if isinstance(node, dict):
        return "{" + ", ".join(f"{k!r}: {_repr(v)}"
                               for k, v in sorted(node.items())) + "}"
    if isinstance(node, (tuple, list)):
        inner = ", ".join(_repr(v) for v in node)
        return f"({inner},)" if isinstance(node, tuple) and len(node) == 1 \
            else (f"({inner})" if isinstance(node, tuple) else f"[{inner}]")
    return "*"


def _fill(node, it):
    if isinstance(node, dict):
        return {k: _fill(node[k], it) for k in sorted(node)}
    if isinstance(node, (tuple, list)):
        return type(node)(_fill(v, it) for v in node)
    return next(it)


def _flatten(tree: Any, prefix: tuple = ()
             ) -> tuple[list[tuple[tuple, Any]], Any]:
    """-> ([(path, leaf), ...] in the reference's flatten order, skeleton)."""
    if isinstance(tree, dict):
        out, skel = [], {}
        for k in sorted(tree):
            sub, skel[k] = _flatten(tree[k], prefix + (k,))
            out += sub
        return out, skel
    if isinstance(tree, (tuple, list)):
        out, skel = [], []
        for i, v in enumerate(tree):
            sub, s = _flatten(v, prefix + (i,))
            out += sub
            skel.append(s)
        return out, type(tree)(skel)
    return [(prefix, tree)], None


def _leaf_bytes(leaf) -> tuple[tuple, str, bytes]:
    """(shape, dtype name, raw bytes) of one leaf, on the host."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return (tuple(t.shape), "bfloat16",
                    t.view(torch.int16).numpy().tobytes())
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":
            return tuple(arr.shape), "bfloat16", arr.view(np.uint16).tobytes()
    return tuple(arr.shape), str(arr.dtype), arr.tobytes()


def _leaf_nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return np.asarray(leaf).nbytes


def serialize_tree(tree: Any) -> tuple[memoryview, Manifest, TreeDef]:
    """-> (buffer, manifest, treedef). Leaves in flatten order; tensors on
    a device are copied to the host. The buffer (the reference's bytes,
    byte for byte, as a writable memoryview) is allocated once,
    uninitialised, and filled leaf by leaf, so the host holds one copy of
    the tree beside one leaf's."""
    leaves, skeleton = _flatten(tree)
    buf = np.empty(sum(_leaf_nbytes(leaf) for _, leaf in leaves), np.uint8)
    entries = []
    offset = 0
    for path, leaf in leaves:
        shape, dt, raw = _leaf_bytes(leaf)
        entries.append(("/".join(map(str, path)), shape, dt, offset,
                        len(raw)))
        buf[offset:offset + len(raw)] = np.frombuffer(raw, np.uint8)
        offset += len(raw)
    treedef = TreeDef(skeleton)
    return (memoryview(buf), Manifest(tuple(entries), repr(treedef), offset),
            treedef)


def deserialize_tree(buf: bytes | bytearray | memoryview, manifest: Manifest,
                     treedef: TreeDef) -> Any:
    """Rebuild the tree from the byte buffer, as CPU tensors. A writable
    buffer (bytearray) is shared, not copied; the caller moves the tensors
    where they are needed."""
    mv = memoryview(buf)
    leaves = []
    for _path, shape, dtype, offset, nbytes in manifest.entries:
        raw = mv[offset:offset + nbytes]
        if dtype == "bfloat16":
            arr = np.frombuffer(raw, np.int16)
        else:
            arr = np.frombuffer(raw, np.dtype(dtype))
        if not arr.flags.writeable:
            arr = arr.copy()
        t = torch.from_numpy(arr).reshape(shape)
        leaves.append(t.view(torch.bfloat16) if dtype == "bfloat16" else t)
    return treedef.unflatten(leaves)
