"""AdamW's update of a fp32 DTensor parameter under a `MemTracker`
(ROADMAP C5): the dry-run traces every train step under one, and its
gradient hooks hold a weak reference to each parameter, which
`torch.utils.swap_tensors` refuses. The train step first replaces such a
parameter by a bf16 one in its module (`bf16_dtensor_parameters`), which
`adamw_update` then updates in place, as the unsharded update retypes a
plain parameter; given the fp32 DTensor itself, `adamw_update` refuses it
before touching any state. Runs in a child process: a process holds one
default process group."""
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

CHILD = r"""
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor import distribute_tensor
from torch.distributed._tools.mem_tracker import MemTracker
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               bf16_dtensor_parameters)

dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                        world_size=1)
mesh = init_device_mesh("cpu", (1,))
g = torch.Generator().manual_seed(0)
w0 = torch.randn(8, 4, generator=g)
x = torch.randn(2, 4, generator=g)
cfg = AdamWConfig(lr=1e-2)


def step(weight, xin):
    lin = torch.nn.Linear(4, 8, bias=False)
    lin.weight = torch.nn.Parameter(weight)
    state = adamw_init([lin.weight])
    with MemTracker():
        lin(xin).square().sum().backward()
        grad = lin.weight.grad
        if isinstance(lin.weight, DTensor):
            before = state["master"][0].full_tensor().clone()
            try:
                adamw_update([grad], state, cfg, [lin.weight])
            except TypeError:
                pass
            else:
                raise AssertionError("a fp32 DTensor parameter was taken")
            assert int(state["step"]) == 0
            assert torch.equal(state["master"][0].full_tensor(), before)
            assert bf16_dtensor_parameters(lin) == 1
            assert bf16_dtensor_parameters(lin) == 0
        adamw_update([grad], state, cfg, [lin.weight])
    return lin.weight, state["master"][0]


plain, _ = step(w0.clone(), x)
p, master = step(distribute_tensor(w0.clone(), mesh, [Shard(0)]),
                 distribute_tensor(x, mesh, [Replicate()]))
assert plain.dtype == torch.bfloat16
assert isinstance(p, torch.nn.Parameter) and p.requires_grad
assert (p.dtype, p.to_local().dtype, p._spec.tensor_meta.dtype) \
    == (torch.bfloat16,) * 3, p
assert p.placements == (Shard(0),)
assert torch.equal(p.full_tensor(), master.full_tensor().to(torch.bfloat16))
assert torch.equal(p.full_tensor(), plain.detach())
dist.destroy_process_group()
print("OK")
"""


def test_fp32_dtensor_parameter_updates_under_a_mem_tracker():
    got = subprocess.run([sys.executable, "-c", CHILD], capture_output=True,
                         text=True, timeout=120, cwd=REPO,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert got.returncode == 0 and got.stdout.strip() == "OK", got.stderr
