"""Device meshes of the port (port of `repro.launch.mesh`): PyTorch
`DeviceMesh`es over a process group.

Single pod: (data=16, model=16), 256 devices.
Multi-pod:  (pod=2, data=16, model=16), 512 devices across 2 pods.

The `pod` axis is the cross-pod axis: batch parallelism only, gradients
reduced across it. `model` carries the tensor- and expert-parallel
collectives. As in the reference, a pod is a cluster of the paper's
topology and the cross-pod links are its oversubscribed cross-cluster
links.

The production meshes sit on a *fake* process group (PyTorch's `fake`
backend) of world size 256 or 512 in this one process, rank 0: the
counterpart of the reference's `--xla_force_host_platform_device_count`.
Its collectives move nothing; under fake tensors they only carry shapes,
which is what the dry-run (`launch/dryrun.py`) traces. The host mesh sits
on a real group over the devices present: NCCL on the card, gloo on the
CPU. Every group is initialised from an in-process `HashStore`, never
from the environment: nothing here opens a socket.

Functions, not module constants: importing this module initialises no
process group, and one process holds one default group, so a fake and a
real mesh never share a process.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _default_group(backend: str, world_size: int) -> None:
    """Initialise the default process group (rank 0 of `world_size`) or
    check that the one already there fits."""
    if dist.is_initialized():
        have = dist.get_backend()
        if dist.get_world_size() != world_size or (
                (backend == "fake") != (have == "fake")):
            raise RuntimeError(
                f"a {have} process group of world size "
                f"{dist.get_world_size()} is already initialised; this mesh "
                f"needs {backend} over {world_size} (run it in its own "
                f"process)")
        return
    if backend == "fake":
        # PyTorch registers its `fake` backend when this module is imported
        # (an ImportError here means a torch that moved it)
        import torch.testing._internal.distributed.fake_pg  # noqa: F401
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The (16, 16) ("data", "model") mesh, or with `multi_pod` the (2, 16,
    16) ("pod", "data", "model") one, over a fake process group."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    _default_group("fake", 256 * (2 if multi_pod else 1))
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=axes)


def make_host_mesh(model_parallel: int = 1, device: str = "cuda"):
    """A ("data", "model") mesh over the ranks of the default process
    group: the one already initialised (several processes, each with its
    own), or else a group of this process alone (NCCL on "cuda", gloo on
    "cpu")."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        _default_group("nccl" if dev.type == "cuda" else "gloo", 1)
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model parallel "
                         f"groups of {model_parallel}")
    return init_device_mesh(dev.type, (n // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))


def entry_mesh(force: bool, device: str = "cuda"):
    """The mesh the entry points (`launch.train`, `launch.serve`) run on:
    the host mesh where the default process group has several ranks, or
    where the caller asks for it (`force`, their `--mesh`); else None.
    On one device the host mesh computes the unsharded step bit for bit
    and only adds DTensor's host dispatch to every op."""
    if force or (dist.is_initialized() and dist.get_world_size() > 1):
        return make_host_mesh(device=device)
    return None
