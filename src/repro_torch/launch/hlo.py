"""Collective traffic and the op audit of a traced step (port of
`repro.launch.hlo`).

The reference parses XLA's per-device HLO text. The port has no HLO: its
dry-run runs the step once under fake tensors on a fake process group
and records every op it dispatches on rank 0's local shards
(`TraceRecorder`, a `TorchDispatchMode`). Those are the ops a device
runs: the matmuls, the kernels' operators, and the functional collectives
(`_c10d_functional.*`) that DTensor inserts between them. What DTensor
runs on global shapes to propagate its shardings is not device work and
is left out. Each record carries the op's local FLOPs (PyTorch's FLOP
formulas, the kernel operator's own), the bytes of its inputs and
outputs, and for a collective its result bytes and the mesh dims of its
group; the enclosing module's path comes from `ModTracker`, the module
tracing that `CommDebugMode` is built on.

`collective_stats` tallies the collectives under the reference's names
(`all-gather`, `all-reduce`, `reduce-scatter`, `all-to-all`,
`collective-permute`), with per-device result bytes (for all-gather the
gathered output, for all-reduce the reduced tensor, for reduce-scatter
the scattered shard), the group size (the product of the group's mesh
dims), and cross-pod bytes: those of collectives whose group spans
device-id ranges of `pod_size`, that is, whose group includes the `pod`
dim.
"""
from __future__ import annotations

import dataclasses
import re

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_leaves

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
#: functional collective -> the reference's name
_KIND = {"all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
         "all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all"}
#: ops that move no data: views, metadata, allocation, waits
_FREE = {"view", "_unsafe_view", "reshape", "t", "transpose", "permute",
         "expand", "slice", "select", "unsqueeze", "squeeze", "alias",
         "detach", "as_strided", "split", "split_with_sizes", "chunk",
         "unbind", "empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "device", "lift_fresh",
         "wait_tensor", "_local_scalar_dense", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset", "is_same_size"}


@dataclasses.dataclass
class OpRecord:
    op: str                 # "aten.mm.default", "repro_torch.flash_..."
    flops: int              # on this device's shards
    bytes: int              # inputs + outputs; 0 for a free op
    kind: str | None = None     # a collective's reference name
    out_bytes: int = 0          # a collective's result bytes
    group: tuple = ()           # a collective's mesh dims
    group_size: int = 1
    cross_pod: bool = False
    module: str = ""            # innermost module path


@dataclasses.dataclass
class Trace:
    ops: list
    mesh_shape: dict

    def to_json(self) -> list:
        return [dataclasses.asdict(o) for o in self.ops]


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class TraceRecorder(TorchDispatchMode):
    """Records the ops dispatched on local shards (see the module
    docstring), of a step on `mesh` (or on no mesh: None). Enter it
    inside the fake mode; `trace` is the result."""

    def __init__(self, mesh, pod_size: int = 256):
        super().__init__()
        import torch.distributed as dist
        from torch.distributed._tools.mod_tracker import ModTracker
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self._groups = {}
        names = () if mesh is None else mesh.mesh_dim_names
        for i, name in enumerate(names):
            pg = mesh.get_group(i)
            ranks = dist.get_process_group_ranks(pg)
            self._groups[pg.group_name] = (
                (name,), len(ranks),
                min(ranks) // pod_size != max(ranks) // pod_size)
        self.trace = Trace([], dict(zip(names, () if mesh is None
                                        else mesh.shape)))
        self._modules = ModTracker()
        self._alltoall = 0

    def __enter__(self):
        self._modules.__enter__()
        self._patch(True)
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._patch(False)
        self._modules.__exit__(*exc)
        return out

    def _patch(self, on: bool) -> None:
        """While recording: DTensor's sharding propagation (ops on global
        shapes) is not recorded, and a shard-to-shard redistribution, which
        DTensor lowers to all-gather + chunk on a CPU-typed mesh, is
        recorded as the all-to-all that NCCL runs for it."""
        from torch.distributed.tensor import _sharding_prop, placement_types
        prop = _sharding_prop.ShardingPropagator
        name = "_propagate_tensor_meta_non_cached"
        if on:
            # both are DTensor internals: a torch without them would trace
            # global ops as device work, or miss the all-to-alls
            for owner, attr in ((prop, name),
                                (placement_types, "shard_dim_alltoall")):
                if not callable(getattr(owner, attr, None)):
                    raise RuntimeError(
                        f"this torch ({torch.__version__}) has no "
                        f"{owner.__name__}.{attr}: TraceRecorder cannot "
                        f"tell device ops from sharding propagation")
            self._saved = (getattr(prop, name),
                           placement_types.shard_dim_alltoall)
            inner, a2a = self._saved
            rec = self

            def propagate(self_, *args, **kwargs):
                # outside every mode, so on a fake mode of its own: neither
                # this recorder nor a `MemTracker` sees it
                with _disable_current_modes():
                    return inner(self_, *args, **kwargs)
            setattr(prop, name, propagate)

            def alltoall(input, *args, **kwargs):
                rec._alltoall += 1
                try:
                    return a2a(input, *args, **kwargs)
                finally:
                    rec._alltoall -= 1
            placement_types.shard_dim_alltoall = alltoall
        else:
            setattr(prop, name, self._saved[0])
            placement_types.shard_dim_alltoall = self._saved[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented            # DTensor dispatches its shards
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        name = packet.__name__
        tensors_in = [t for t in tree_leaves((args, kwargs))
                      if isinstance(t, torch.Tensor)]
        tensors_out = [t for t in tree_leaves(out)
                       if isinstance(t, torch.Tensor)]
        rec = OpRecord(op=str(func), flops=0, bytes=0)
        if packet in self._flops:
            rec.flops = int(self._flops[packet](*args, **kwargs,
                                                out_val=out))
        if name not in _FREE and not func.is_view:
            rec.bytes = (sum(map(_nbytes, tensors_in))
                         + sum(map(_nbytes, tensors_out)))
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d_functional", "_dtensor") \
                and name in _KIND:
            group = next((a for a in reversed(args) if isinstance(a, str)),
                         None)
            dims, size, cross = self._groups.get(group, (("?",), 1, False))
            rec.kind = ("all-to-all" if self._alltoall
                        and _KIND[name] == "all-gather" else _KIND[name])
            rec.out_bytes = (sum(map(_nbytes, tensors_in))
                             if rec.kind == "all-to-all"
                             else sum(map(_nbytes, tensors_out)))
            rec.group, rec.group_size, rec.cross_pod = dims, size, cross
        parents = getattr(self._modules, "parents", ())
        rec.module = max(parents, key=len) if parents else ""
        self.trace.ops.append(rec)
        return out


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_op: dict       # op -> per-device result bytes (summed)
    count_by_op: dict
    group_size_by_op: dict  # op -> max group size seen
    cross_pod_bytes: int    # result bytes of collectives spanning pods
    total_bytes: int

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def collective_stats(trace: Trace, pod_size: int = 256) -> CollectiveStats:
    """The collectives of `trace` by the reference's names. (`pod_size`
    was fixed when the trace was recorded: `TraceRecorder`.)"""
    bytes_by_op: dict[str, int] = {}
    count_by_op: dict[str, int] = {}
    gs_by_op: dict[str, int] = {}
    cross = 0
    for rec in trace.ops:
        if rec.kind is None:
            continue
        bytes_by_op[rec.kind] = bytes_by_op.get(rec.kind, 0) + rec.out_bytes
        count_by_op[rec.kind] = count_by_op.get(rec.kind, 0) + 1
        gs_by_op[rec.kind] = max(gs_by_op.get(rec.kind, 0), rec.group_size)
        if rec.cross_pod:
            cross += rec.out_bytes
    return CollectiveStats(bytes_by_op, count_by_op, gs_by_op, cross,
                           sum(bytes_by_op.values()))


#: audit names -> the ops they count (an unlisted name counts ops of that
#: name; "custom" counts the port's own kernel operators)
_OP_GROUPS = {"reshape": ("view", "_unsafe_view", "reshape"),
              "transpose": ("transpose", "permute", "t"),
              "copy": ("copy_", "clone", "_to_copy", "contiguous")}


def count_ops(trace: Trace, opcodes: tuple[str, ...]) -> dict[str, int]:
    """Op counts by audit name (reshape / transpose / copy / custom)."""
    counts = {op: 0 for op in opcodes}
    for rec in trace.ops:
        ns, name = re.match(r"([^.]+)\.([^.]+)", rec.op).groups()
        for op in opcodes:
            if op == "custom":
                counts[op] += ns == "repro_torch"
            elif name in _OP_GROUPS.get(op, (op,)):
                counts[op] += 1
    return counts
