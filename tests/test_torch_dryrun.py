"""One whole dry-run cell of the port, llama3.2-3b x train_4k on the
(16, 16) mesh of 256 fake devices, in a fresh interpreter (killed after
300 s): status ok with the reference's keys, its argument bytes the
local shard bytes that `train_state_shardings` and the input shardings
imply, and the flash kernel's operator traced once per layer and
microbatch (remat off: with it the recompute traces it again)."""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: the keys of the reference's artifact that the port writes too
#: (`lower_seconds` / `compile_seconds` are `trace_seconds`)
REF_KEYS = {"arch", "shape", "mesh", "status", "kind", "tag", "options",
            "num_devices", "memory", "cost", "collectives", "static_cost",
            "op_audit"}


def test_llama_train_4k_on_256_fake_devices():
    code = """
    import json, logging
    from repro_torch.launch.dryrun import run_cell
    r = run_cell("llama3.2-3b", "train_4k", "single", remat="none")
    # the argument bytes the shardings imply
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import (abstract_train_state,
                                          sharded_bytes,
                                          train_state_shardings)
    from repro_torch.models import partitioning as PT
    mesh = make_production_mesh(device="cpu")
    state = abstract_train_state(get_config("llama3.2-3b"))
    sh = train_state_shardings(state, mesh)
    want = 0
    for name, lst in (("params", state.params),
                      ("master", state.opt["master"]),
                      ("m", state.opt["m"]), ("v", state.opt["v"])):
        shards = sh["params"] if name == "params" else sh["opt"][name]
        want += sum(sharded_bytes(tuple(t.shape), t.dtype, s)
                    for t, s in zip(lst, shards))
    want += 2 * sharded_bytes((), torch.int32, sh["step"])
    want += 2 * sharded_bytes((256, 4096), torch.int32,
                              PT.input_sharding_for(mesh, (256, 4096)))
    r["want_argument_bytes"] = want
    print(json.dumps(r))
    """
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ,
                               "PYTHONPATH": str(ROOT / "src")}, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["status"] == "ok" and r["kind"] == "train"
    assert REF_KEYS <= r.keys()
    assert r["num_devices"] == 256
    mem = r["memory"]
    assert mem["argument_size_in_bytes"] == r["want_argument_bytes"]
    assert mem["peak_bytes_per_device"] > mem["argument_size_in_bytes"]
    layers, accum = 28, 1
    assert r["op_audit"]["custom"] == layers * accum
    assert r["options"] == {"remat": "none", "accum": 1,
                            "seq_parallel": False}
    # per device: more than the forward's 2 x 3.2e9 x 4096 tokens
    assert r["cost"]["flops"] > 2 * 3.2e9 * 4096
    coll = r["collectives"]
    assert coll["bytes_by_op"]["all-gather"] > 0     # FSDP weights
    assert coll["bytes_by_op"]["reduce-scatter"] > 0  # their gradients
    assert coll["group_size_by_op"]["all-reduce"] == 16
    assert coll["cross_pod_bytes"] == 0              # one pod
    assert r["static_cost"]["flops"] == r["cost"]["flops"]
