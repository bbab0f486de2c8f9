"""The port's repo-invariant lint (`repro_torch.analysis.lint`): the port's
tree is clean, each rule RA001-RA008 fails a fixture in the port's idiom
and passes it waived, the kernels package is exempt, the module imports
with torch blocked, and on the fixtures the two packages share the port
and the reference find the same rules on the same lines.
"""
import pathlib
import subprocess
import sys

import pytest

from repro.analysis.lint import lint_source as ref_lint_source
from repro_torch.analysis.lint import lint_source, main

REPO = pathlib.Path(__file__).resolve().parents[1]
# the command of the port's lint over its own tree
TREE = ["src/repro_torch", *sorted(
    str(p.relative_to(REPO)) for p in REPO.glob("tests/test_torch_*.py")),
    "chip_smoke.py", *sorted(str(p.relative_to(REPO))
                             for p in REPO.glob("examples/*_torch.py")),
    "tools"]


def _rules(findings):
    return [f.rule for f in findings]


def test_the_ports_tree_is_clean(monkeypatch):
    """Acceptance: `python -m repro_torch.analysis.lint src/repro_torch
    tests/test_torch_*.py chip_smoke.py examples/*_torch.py tools` exits
    0."""
    monkeypatch.chdir(REPO)
    assert main([*TREE, "--quiet"]) == 0


def test_the_cli_runs_with_torch_blocked(tmp_path):
    """The module imports and runs with `sys.modules["torch"] = None`
    (stdlib only): clean tree 0, a finding 1, a missing path 2."""
    bad = tmp_path / "sneaky.py"
    bad.write_text("from repro_torch.kernels import xor_reduce as xrk\n"
                   "out = xrk.xor_reduce(blocks)\n")
    prog = ("import sys; sys.modules['torch'] = None; "
            "from repro_torch.analysis import lint; "
            "assert 'torch' not in [m for m in sys.modules "
            "if sys.modules[m] is not None]; "
            "sys.exit(lint.main(sys.argv[1:]))")
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}

    def run(*args):
        return subprocess.run([sys.executable, "-c", prog, *args], env=env,
                              cwd=REPO, capture_output=True, text=True)
    assert run(*TREE, "--quiet").returncode == 0
    got = run(str(bad))
    assert got.returncode == 1 and "RA001" in got.stdout
    assert run(str(tmp_path / "missing.py")).returncode == 2


# rule -> (path, failing source in the port's idiom, line of the waiver's
# finding); each source has exactly one finding of its rule
FIXTURES = {
    "RA001": ("tools/bench.py",
              "from repro_torch.kernels import gf_bitmatmul as gfk\n"
              "out = gfk.gf_bitmatmul(cols, data)\n"),
    "RA001-library": ("src/repro_torch/io/fast.py",
                      "from repro_torch.kernels import _build\n"
                      "lib = _build.library()\n"
                      "lib.repro_xor_fold(a, b, 1, 2, 3, 0, s)\n"),
    "RA001-operator": ("chip_smoke.py",
                       "import torch\n"
                       "out = torch.ops.repro_torch.flash_attention_fwd("
                       "q, k, v, True, 0)\n"),
    "RA002": ("src/repro_torch/core/codec.py",
              "import torch\n"
              "x = blocks.to(torch.float32)\n"),
    "RA002-method": ("src/repro_torch/io/backend.py",
                     "y = blocks.float()\n"),
    "RA003": ("src/repro_torch/io/engine.py",
              "plan.M[0, 0] = 7\n"),
    "RA004": ("src/repro_torch/io/engine.py",
              "from repro_torch.kernels import ops\n"
              "for it in items:\n"
              "    ops.xor_fold(it)\n"),
    "RA005": ("src/repro_torch/ckpt/stripe.py",
              "codec = StripeCodec(code, store, use_kernels=True)\n"),
    "RA006": ("src/repro_torch/sim/repair.py",
              "t = params.T_hours + size_TB\n"),
    "RA007": ("chip_smoke.py",
              "from repro_torch.kernels import flash_attention as fak\n"
              "fak.launches = 0\n"),
    "RA007-clear": ("tests/test_x.py",
                    "import repro_torch.kernels.flash_attention as fak\n"
                    "fak.mode_launches.clear()\n"),
    "RA008": ("src/repro_torch/ckpt/stripe.py",
              "from repro_torch.kernels import autotune\n"
              "g = autotune.MAX_GRID_X\n"),
    "RA008-literal": ("src/repro_torch/io/backend.py",
                      "out = gf_bitmatmul(cols, data, grid=264)\n"),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_each_rule_fails_its_fixture_and_passes_waived(name):
    path, src = FIXTURES[name]
    rule = name.split("-")[0]
    findings = lint_source(src, path)
    assert _rules(findings) == [rule], findings
    lines = src.splitlines()
    line = findings[0].line
    lines[line - 1] += f"  # repro-lint: allow={rule}"
    assert lint_source("\n".join(lines) + "\n", path) == []


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_each_fixture_exits_one(tmp_path, name):
    path, src = FIXTURES[name]
    f = tmp_path / path
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(src)
    assert main([str(f), "--quiet"]) == 1


def test_the_kernels_package_is_exempt():
    """Raw calls, counters and launch constants are the kernels package's
    own business."""
    src = ("from repro_torch.kernels import _build\n"
           "from repro_torch.kernels.autotune import MAX_GRID_X\n"
           "launches = 0\n"
           "def f(x):\n"
           "    global launches\n"
           "    _build.library().repro_xor_fold(x, MAX_GRID_X)\n"
           "    launches += 1\n"
           "    KERNEL_LAUNCHES['xor_reduce'] += 1\n"
           "    return xor_reduce(x, grid=1)\n")
    assert lint_source(src, "src/repro_torch/kernels/xor_reduce.py") == []
    assert set(_rules(lint_source(src, "src/repro_torch/io/fast.py"))) \
        == {"RA001", "RA007", "RA008"}


def test_reads_and_plans_are_not_findings():
    """Reading counters, the plain versions, planned grids and docstrings
    naming the retired spellings are all legal."""
    src = ('"""Superseded `ClusterTopology` and `use_kernels=`."""\n'
           "from repro_torch.kernels import autotune, ops\n"
           "from repro_torch.kernels import gf_bitmatmul as gfk\n"
           "plan = autotune.plan_matmul_tiles(180, 30, 1 << 20)\n"
           "n = gfk.launches + ops.KERNEL_LAUNCHES['gf_bitmatmul']\n"
           "out = gfk.gf_bitmatmul_plain(cols, data)\n"
           "ops.apply_matrix_many(M, blocks)\n"
           "grid = plan.grid_steps\n")
    assert lint_source(src, "src/repro_torch/ckpt/stripe.py") == []


def test_relative_imports_resolve_inside_the_package():
    src = ("from ..kernels import xor_reduce as xrk\n"
           "from ..kernels.ops import apply_matrix\n"
           "def f(items):\n"
           "    for it in items:\n"
           "        apply_matrix(it.M, it.blocks)\n"
           "    return xrk.xor_reduce(items[0])\n")
    assert _rules(lint_source(src, "src/repro_torch/io/engine.py")) \
        == ["RA004", "RA001"]


# fixtures both packages read the same way (rule and line): the
# reference's unit-mixing and plan-mutation sources, its waiver and loop
# cases, and the retired spellings (shim paths aside)
SHARED = {
    "unit-mixing": ("src/{pkg}/sim/anything.py",
                    "def f(duration_hours, size_TB, params):\n"
                    "    bad = duration_hours + size_TB\n"
                    "    if size_TB > params.T_hours:\n"
                    "        duration_hours -= size_TB\n"
                    "    return bad\n"),
    "unit-dataflow": ("src/{pkg}/sim/anything.py",
                      "def f(t_hours, size_TB, n):\n"
                      "    t = t_hours\n"
                      "    wrong = t + size_TB\n"
                      "    t = n\n"
                      "    fine = t + size_TB\n"
                      "    return wrong, fine\n"),
    "unit-conversions": ("src/{pkg}/sim/anything.py",
                         "def f(size_TB, bw_TB_per_hour, t_hours):\n"
                         "    hours = size_TB / bw_TB_per_hour\n"
                         "    also_TB = bw_TB_per_hour * t_hours\n"
                         "    return hours + t_hours\n"),
    "unit-scopes": ("src/{pkg}/sim/anything.py",
                    "def f(t_hours):\n"
                    "    t = t_hours\n"
                    "def g(size_TB, t):\n"
                    "    return t + size_TB\n"),
    "unit-waived": ("src/{pkg}/sim/anything.py",
                    "def f(a_hours, b_TB):\n"
                    "    return a_hours + b_TB   # repro-lint: allow=RA006\n"),
    "plan-mutation": ("src/{pkg}/io/anything.py",
                      "plan.M[0, 0] = 7\n"
                      "plan.M.setflags(write=True)\n"
                      "plan.M.setflags(write=False)\n"),
    "plan-augmented": ("src/{pkg}/io/anything.py",
                       "plan.M[1] ^= 3\n"),
    "gf-astype": ("src/{pkg}/core/gf.py",
                  "import numpy as np\n"
                  "x = np.zeros(4, dtype=np.float32)\n"
                  "y = x.astype(float)\n"),
    "floats-elsewhere": ("src/{pkg}/models/layers.py",
                         "import numpy as np\n"
                         "x = np.zeros(4, dtype=np.float32)\n"),
    "retired-names": ("src/{pkg}/sim/anything.py",
                      "from x import ClusterTopology\n"
                      "t = ClusterTopology(2, 3)\n"
                      "f(use_kernels=False)\n"),
    "counter-writes": ("src/{pkg}/io/anything.py",
                       "KERNEL_LAUNCHES['gf_bitmatmul'] += 1\n"
                       "ops.KERNEL_LAUNCHES.clear()\n"
                       "KERNEL_LAUNCHES = {}\n"
                       "n = sum(KERNEL_LAUNCHES.values())\n"),
}


@pytest.mark.parametrize("name", sorted(SHARED))
def test_the_port_and_the_reference_agree(name):
    path, src = SHARED[name]
    port = lint_source(src, path.format(pkg="repro_torch"))
    ref = ref_lint_source(src, path.format(pkg="repro"))
    assert [(f.rule, f.line) for f in port] \
        == [(f.rule, f.line) for f in ref]
