"""The port on device meshes: the shard order of its placements against
the reference's NamedSharding, `elastic_remesh`, the sharded train step
on a one-device CPU mesh (bit for bit the unsharded step's, and within
`tests/test_torch_train.py`'s tolerance of the reference's sharded step),
and four gloo processes on a (data 2, model 2) mesh against the
unsharded port. Spawned processes are joined with a timeout and killed
after it."""
import json
import logging
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import elastic_remesh, shard_state
from repro_torch.optim import AdamWConfig
from repro_torch.train import (TrainConfig, init_train_state,
                               make_train_step, train_state_from_jax,
                               train_state_to_tree)

ROOT = pathlib.Path(__file__).resolve().parents[1]
logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
    logging.ERROR)


def _env(**extra) -> dict:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu", "GLOO_SOCKET_IFNAME": "lo"}
    env.update(extra)
    return env


def _python(code: str, timeout: float, **env) -> dict:
    """Runs `code` in a fresh interpreter (killed after `timeout`); its
    last stdout line is JSON."""
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=timeout,
                       env=_env(**env), cwd=ROOT)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _flat(tree, out=None, path=""):
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, out, f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _flat(v, out, f"{path}/{i}")
    else:
        out[path] = tree
    return out


# ---------------------------------------------------------------------------
# shard order
# ---------------------------------------------------------------------------

_LEAVES = """
from repro_torch.configs import get_config
from repro_torch.models import partitioning as PT
from repro_torch.models.model import abstract_params, _block_cache_spec
import torch
MESH = PT.AbstractMesh((2, 2, 2), ("pod", "data", "model"))
cfg = get_config("llama3.2-3b", smoke=True)
flat = []
PT._tree_map_with_path(lambda p, l: flat.append(
    ("param/" + p, tuple(l.shape), PT.spec_for_param(p, tuple(l.shape),
                                                      MESH))),
    abstract_params(cfg))
cache = tuple(tuple({n: torch.empty((s.count, *shape), device="meta")
                     for n, (shape, _) in _block_cache_spec(
                         k, cfg, 8, 16).items()} for k in s.blocks)
              for s in cfg.segments)
PT._tree_map_with_path(lambda p, l: flat.append(
    ("cache/" + p, tuple(l.shape), PT._cache_spec(p, l, MESH))), cache)
for dims in ((8, 16), (8, 16, cfg.d_model)):
    flat.append((f"input/{dims}", dims, PT.input_sharding_for(MESH,
                                                              dims).spec))
"""


def test_shard_order_matches_named_sharding():
    """For every rank of a (pod 2, data 2, model 2) mesh, the index range
    of each leaf that DTensor's placements give (its local shape and
    offset) is the one the reference's NamedSharding gives that device:
    the SMOKE llama's parameters, its decode cache (batch over pod +
    data, the sequence over model) and the inputs (batch over pod +
    data)."""
    ref = _python(_LEAVES + """
import json
import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec
devices = np.array(jax.devices()[:8]).reshape(2, 2, 2)
mesh = Mesh(devices, ("pod", "data", "model"))
out = {}
for name, shape, spec in flat:
    idx = NamedSharding(mesh, PartitionSpec(*spec)).devices_indices_map(
        shape)
    out[name] = {str(d.id): [[s.indices(n)[0], s.indices(n)[1]]
                             for s, n in zip(sl, shape)]
                 for d, sl in idx.items()}
print(json.dumps(out))
""", 120, XLA_FLAGS="--xla_force_host_platform_device_count=8")
    port = _python(_LEAVES + """
import json
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor._utils import \\
    compute_local_shape_and_global_offset
from torch.testing._internal.distributed.fake_pg import FakeStore
out = {name: {} for name, _, _ in flat}
for rank in range(8):
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=8)
    mesh = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    for name, shape, spec in flat:
        local, off = compute_local_shape_and_global_offset(
            shape, mesh, PT.placements(spec, mesh))
        out[name][str(rank)] = [[o, o + n] for o, n in zip(off, local)]
    dist.destroy_process_group()
print(json.dumps(out))
""", 120)
    assert ref.keys() == port.keys()
    split_twice = [n for n in ref if any(
        len({tuple(r[d]) for r in ref[n].values()}) == 4
        for d in range(len(next(iter(ref[n].values())))))]
    assert any(n.startswith("input") for n in split_twice)
    assert any(n.startswith("cache") for n in split_twice)
    for name in ref:
        assert ref[name] == port[name], name


# ---------------------------------------------------------------------------
# one-device mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh(device="cpu")


def _state(cfg):
    gen = torch.Generator()
    gen.manual_seed(0)
    return init_train_state(cfg, gen, "cpu")


def _steps(cfg, state, mesh, tcfg, n=2):
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1), tcfg,
                           mesh=mesh)
    gen = torch.Generator()
    gen.manual_seed(1)
    losses = []
    for _ in range(n):
        tokens = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen)
        state, m = step(state, tokens, torch.roll(tokens, -1, 1))
        losses.append((float(m["loss"]), float(m["grad_norm"])))
    return losses, _flat(train_state_to_tree(state))


@pytest.mark.parametrize("seq_parallel, arch", [
    (sp, arch) for sp in (False, True)
    for arch in ("llama3.2-3b", "phi3.5-moe-42b-a6.6b")] + [
    (True, "recurrentgemma-9b"), (True, "rwkv6-7b")])
def test_sharded_step_is_the_unsharded_step_bit_for_bit(mesh, arch,
                                                        seq_parallel):
    """Two steps (accum 2, remat) on the (1, 1) CPU mesh: the losses, the
    grad norms and every leaf of the gathered state equal the unsharded
    steps' bit for bit."""
    cfg = get_config(arch, smoke=True)
    tcfg = TrainConfig(accum=2, remat="block", seq_parallel=seq_parallel)
    want_losses, want = _steps(cfg, _state(cfg), None, tcfg)
    got_losses, got = _steps(cfg, shard_state(_state(cfg), mesh), mesh,
                             tcfg)
    assert got_losses == want_losses
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k


def test_elastic_remesh_keeps_every_byte(mesh):
    """A state placed on the (1, 1) mesh, trained a step, moved onto a
    ("data",) mesh: every leaf of its tree is byte-identical, and its next
    step equals the unmoved state's."""
    from torch.distributed.device_mesh import init_device_mesh
    cfg = get_config("llama3.2-3b", smoke=True)
    tcfg = TrainConfig()
    a = shard_state(_state(cfg), mesh)
    _steps(cfg, a, mesh, tcfg, n=1)
    before = _flat(train_state_to_tree(a))
    flat_mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    b = elastic_remesh(a, flat_mesh)
    after = _flat(train_state_to_tree(b))
    assert before.keys() == after.keys()
    for k in before:
        assert torch.equal(before[k], after[k]), k
    c = shard_state(_state(cfg), mesh)
    _steps(cfg, c, mesh, tcfg, n=1)
    assert _steps(cfg, b, flat_mesh, tcfg, n=1)[0] == \
        _steps(cfg, c, mesh, tcfg, n=1)[0]


def test_training_cli_on_the_host_mesh_is_the_cli_without_it(mesh,
                                                              capsys):
    """`launch.train` with `--mesh` trains on the (1, 1) host mesh, through
    its failure drill (the degraded restore placed on the mesh again), to
    the losses of the same run without `--mesh`, which one device trains
    unsharded."""
    from repro_torch.launch import train as train_cli
    argv = ["--smoke", "--device", "cpu", "--steps", "12", "--batch", "2",
            "--seq", "32", "--ckpt-every", "4", "--fail-node", "5",
            "--fail-at", "8", "--log-every", "4"]
    want = train_cli.run(argv)
    assert "mesh=None" in capsys.readouterr().out
    got = train_cli.run(argv + ["--mesh"])
    assert "mesh={'data': 1, 'model': 1}" in capsys.readouterr().out
    assert len(got) == 12 and got == want


def test_serving_cli_on_the_host_mesh_serves_the_same_tokens(mesh):
    """`launch.serve` with `--mesh` (parameters and each batch's cache
    placed on the host mesh) serves the tokens it serves without."""
    from repro_torch.launch import serve as serve_cli
    argv = ["--arch", "llama3.2-3b", "--device", "cpu", "--batch", "2",
            "--requests", "4", "--prompt-len", "8", "--gen", "4"]
    want, got = serve_cli.run(argv), serve_cli.run(argv + ["--mesh"])
    assert len(got["tokens"]) == len(want["tokens"]) == 2
    for a, b in zip(got["tokens"], want["tokens"]):
        assert torch.equal(a, b)


def test_sharded_step_follows_the_references_sharded_step(mesh):
    """The port's step on its (1, 1) mesh and the reference's jitted step
    on a (1, 1) jax mesh with its state, inputs and activations sharded
    (seq_parallel on), from the same carried weights: five losses within
    1e-2, as `test_torch_train.py` holds the unsharded steps."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import get_config as ref_config
    from repro.launch.specs import train_state_shardings
    from repro.models.partitioning import input_sharding
    from repro.optim import AdamWConfig as RefAdamWConfig
    from repro.train import TrainConfig as RefTrainConfig
    from repro.train import init_train_state as ref_init
    from repro.train import make_train_step as ref_make
    from repro_torch.data import DataConfig, SyntheticTokenDataset

    ref_cfg, cfg = ref_config("llama3.2-3b", True), get_config(
        "llama3.2-3b", True)
    # explicit Auto axes: this jax's `make_mesh` default (Explicit) cannot
    # resolve the reference's embedding gather
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    state = ref_init(ref_cfg, jax.random.PRNGKey(0))
    host = jax.tree_util.tree_map(
        lambda a: (np.asarray(a).view(np.uint16) if a.dtype == jnp.bfloat16
                   else np.asarray(a)), (state.params, state.opt, state.step))
    port = shard_state(train_state_from_jax(cfg, host, "cpu"), mesh)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10, clip_norm=1.0)
    st_sh = train_state_shardings(state, jmesh)
    in_sh = input_sharding(jmesh, 2)
    state = jax.tree_util.tree_map(jax.device_put, state, st_sh)
    step = make_train_step(cfg, AdamWConfig(**kw),
                           TrainConfig(seq_parallel=True), mesh=mesh)
    ds = SyntheticTokenDataset(DataConfig(cfg.vocab_size, 32, 4))
    with jmesh:
        ref_step = jax.jit(ref_make(ref_cfg, RefAdamWConfig(**kw),
                                    RefTrainConfig(seq_parallel=True),
                                    mesh=jmesh),
                           in_shardings=(st_sh, in_sh, in_sh))
        for i in range(5):
            tokens, labels = ds.batch(i)
            state, want = ref_step(state, jnp.asarray(tokens),
                                   jnp.asarray(labels))
            port, got = step(port, tokens, labels)
            assert abs(float(want["loss"]) - float(got["loss"])) < 1e-2, i


# ---------------------------------------------------------------------------
# four processes
# ---------------------------------------------------------------------------

_WORKER = r"""
import json, logging, sys
import torch
import torch.distributed as dist
torch.set_num_threads(2)        # four processes share the host's cores
logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
    logging.ERROR)
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import shard_state
from repro_torch.models.model import init_params, replicating, shard_model
from repro_torch.optim import AdamWConfig
from repro_torch.train import (TrainConfig, init_train_state, loss_fn,
                               make_train_step, train_state_to_tree)

rank, store_path, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
# one of each block kind whose sharded math has hand-written gradient
# placements: attention and the row-parallel products, the MoE, the RG-LRU
# conv and scan, the WKV scan, MLA's per-head form (the rotary key every
# head reads)
ARCHS = ("llama3.2-3b", "phi3.5-moe-42b-a6.6b", "recurrentgemma-9b",
         "rwkv6-7b", "minicpm3-4b")
dist.init_process_group("gloo", store=dist.FileStore(store_path, 4),
                        rank=rank, world_size=4)
mesh = make_host_mesh(model_parallel=2, device="cpu")


def flat(tree, out, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(v, out, f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            flat(v, out, f"{path}/{i}")
    else:
        out[path] = tree
    return out


def run(arch, m):
    cfg = get_config(arch, smoke=True)
    gen = torch.Generator()
    gen.manual_seed(0)
    state = init_train_state(cfg, gen, "cpu")
    if m is not None:
        shard_state(state, m)
    init = flat(train_state_to_tree(state), {})
    data = torch.Generator()
    data.manual_seed(1)
    batches = []
    for _ in range(2):
        t = torch.randint(0, cfg.vocab_size, (4, 16), generator=data)
        batches.append((t, torch.roll(t, -1, 1)))
    # gradients in fp32: bf16 roundings that differ with the reduction
    # order switch near-tie MoE routings (tests/test_torch_moe.py)
    gen.manual_seed(0)
    model = init_params(cfg, gen, "cpu").float().requires_grad_(True)
    if m is not None:
        shard_model(model, m)
    loss, _ = loss_fn(model, *batches[0], TrainConfig(), None, m)
    loss = loss.full_tensor() if m is not None else loss
    with replicating(m):
        loss.backward()
    grads = {n: (p.grad.full_tensor() if m is not None else p.grad)
             for n, p in model.named_parameters()}
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1),
                           TrainConfig(), mesh=m)
    losses = []
    for t, l in batches:
        state, met = step(state, t, l)
        losses.append(float(met["loss"]))
    return losses, init, grads, flat(train_state_to_tree(state), {})


def rel_err(want, got):
    # max |want - got| over max |want|: each leaf against its own scale
    scale = float(want.abs().max())
    return float((want - got).abs().max()) / (scale if scale else 1.0)


out = {}
for arch in ARCHS:
    want = run(arch, None)
    got = run(arch, mesh)
    errs = {k: rel_err(want[2][k], got[2][k]) for k in want[2]}
    out[arch] = {
        "losses": got[0], "want": want[0],
        "init_equal": all(torch.equal(want[1][k], got[1][k])
                          for k in want[1]),
        "grad_err": max(errs.values()),
        "worst_leaf": max(errs, key=errs.get),
        # every rank gathers the same trained state
        "digest": float(sum(v.double().sum() + v.double().abs().sum()
                            for v in got[3].values())),
    }
with open(out_path, "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
"""


def test_four_processes_on_a_data_2_model_2_mesh(tmp_path):
    """Four gloo processes on a (data 2, model 2) CPU mesh, the SMOKE
    llama, MoE (experts split over model), recurrentgemma, rwkv6 and
    minicpm3 (MLA's heads split over model, its rotary key whole): the
    placed state gathers to the unsharded state byte for byte, the first
    batch's fp32 gradients gather to the unsharded ones within 1e-4 of
    each leaf's own max |grad| (a gradient summed over half the batch, or
    partial where it should be whole, misses by 0.5 or more), two steps'
    losses are within 1e-2 relative of the unsharded port's, and every
    rank gathers the same trained state. The gradients are taken in fp32:
    in bf16 the sharded sums round otherwise, which switches the experts
    of near-tie tokens (0.25 of max |grad| for the MoE)."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(tmp_path / "store"),
         str(tmp_path / f"out{r}.json")], env=_env(), cwd=ROOT,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=240)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        e[-3000:] for e in errs)
    outs = [json.loads((tmp_path / f"out{r}.json").read_text())
            for r in range(4)]
    for arch, res in outs[0].items():
        assert res["init_equal"], arch
        assert res["grad_err"] < 1e-4, (arch, res["worst_leaf"],
                                        res["grad_err"])
        for got, want in zip(res["losses"], res["want"]):
            assert abs(got - want) <= 1e-2 * abs(want), (arch, got, want)
        assert len({o[arch]["digest"] for o in outs}) == 1, arch
