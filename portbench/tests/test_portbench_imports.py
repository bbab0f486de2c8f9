"""Nothing a benchmark run loads is JAX or the JAX package, and the
reference loads nothing of the program. Each check runs in a fresh
interpreter with `jax` blocked (`sys.modules["jax"] = None`), and compares
each loaded module's top-level name (before the first dot) whole:
`repro_torch` is the port, `repro` the JAX package."""
from __future__ import annotations

import json
import subprocess
import sys

from portbench_cases import ROOT

PROLOGUE = f"""
import json, sys
sys.modules["jax"] = None
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r},
                {str(ROOT / 'portbench' / 'tests')!r}]
"""
REPORT = """
tops = {n.split(".")[0] for n, m in list(sys.modules.items()) if m is not None}
print(json.dumps(sorted(tops)))
"""


def _tops(body: str) -> set[str]:
    proc = subprocess.run([sys.executable, "-c", PROLOGUE + body + REPORT],
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """The run's modules, and a whole run of a small cell on the CPU (the
    port's prefill, the check), load no jax, jaxlib, flax or repro."""
    tops = _tops("""
import importlib.util, time, torch
spec = importlib.util.spec_from_file_location("run", "portbench/run.py")
run = importlib.util.module_from_spec(spec); spec.loader.exec_module(run)
from portbench import harness
import portbench_cases as T
for kind in ("mla", "attn_moe"):
    harness.run(T.small_spec(kind), 7, 0.0, False, device=torch.device("cpu"),
                t0=time.perf_counter(), batches=2)
assert run.loaded_forbidden() == []
""")
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    tops = _tops("""
from portbench.reference import attn_moe, mla, model, precision
from portbench import check, workcount
""")
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
