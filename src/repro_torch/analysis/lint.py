"""Repo-invariant AST lint for the port (port of `repro.analysis.lint`):
the rules generic linters can't know, over the port's own invariants.

  RA001  raw kernel invocation outside `repro_torch/kernels/` — calling
         `gf_bitmatmul` / `xor_reduce` on the kernel modules, any entry
         point of the built library (an attribute call on
         `_build.library()`, or on a name bound to it) or an operator
         `torch.ops.repro_torch.*` directly bypasses the wrappers' launch
         accounting (KERNEL_LAUNCHES) and planning (`kernels/ops.py`),
         silently breaking every launch-count acceptance test.
  RA002  float dtypes on GF arrays in GF-critical modules — GF(2^8)
         symbols are uint8 table indices; `astype(float)`, `.float()`,
         `.half()`, `.double()`, `.to(torch.float32)` or
         `dtype=torch.float32` produce numbers that LOOK plausible and
         decode garbage.
  RA003  mutation of frozen-plan numpy payloads — `plan.M[...] = v` or
         `.setflags(write=True)` defeats the sealed read-only matrices
         shared through the plan cache.
  RA004  single-item kernel ops inside host loops in the batched hot
         paths (`io/engine.py`, `io/frontend.py`, `ckpt/stripe.py`) —
         per-item `encode` / `apply_matrix` / `xor_fold` /
         `recover_single` / `apply_decode` of `repro_torch.kernels.ops`
         in a `for` re-creates the launch-per-stripe regime the batched
         engine exists to kill; use the `*_many` variants.
  RA005  retired API spellings — the `use_kernels=` keyword (pass
         `backend=`) and the `ClusterTopology` alias (use
         `repro_torch.topo.Topology`). The port never had the shims, so
         no path is exempt; a docstring that names them is not code.
  RA006  dimensional hygiene — adding, subtracting or comparing
         quantities whose names carry DIFFERENT unit suffixes (`_hours`,
         `_TB`, `_per_hour`, `_TB_per_hour`, `_Gbps`), with the
         reference's local dataflow through straight-line assignments;
         `*` and `/` erase units (the conversion idiom).
  RA007  direct mutation of the kernel launch counters outside
         `repro_torch/kernels/` — `KERNEL_LAUNCHES[...] += 1`,
         `.clear()`, and the kernel modules' own counters (`launches`,
         `plain_calls`, `fp32_launches`, `decode_launches`,
         `mode_launches`) written, rebound, cleared or `setattr`-ed: they
         are counted under each module's lock where the kernel launches
         and reset by `reset_counts()` / `reset_kernel_launch_counts()`.
         Reading them is fine.
  RA008  hard-coded launch shapes outside `repro_torch/kernels/` — the
         kernels' launch constants (`GF_TILE`, `GF_THREADS`, `THREADS`,
         `BYTES_PER_THREAD`, `MAX_GRID_X`) or a literal `grid=<int>` pin
         one shape's launch on every caller, bypassing the planner
         (`repro_torch.kernels.autotune.plan_matmul_tiles` /
         `plan_xor_tiles`). Leave `grid` unset (the ops layer plans it) or
         pass `plan.grid_steps`; non-constant values are fine.

Kernel names are resolved through the file's imports: absolute
(`from repro_torch.kernels import gf_bitmatmul as gfk`,
`import repro_torch.kernels.ops as ops`) and, inside the package,
relative ones.

Waive a finding with a comment on its line or the line above:
`# repro-lint: allow=RA001` (comma-separated rule ids) — used by the
kernel oracles and benches that call raw kernels *on purpose*.

Stdlib only (ast, pathlib, re, argparse): it runs without torch (its
package's `__init__` loads numpy, nothing heavier):

    python -m repro_torch.analysis.lint src/repro_torch tests/test_torch_*.py

exits 0 when clean, 1 on findings, 2 on a missing path.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import pathlib
import re
import sys
from collections.abc import Iterable, Sequence

KERNELS = "repro_torch.kernels"
KERNEL_PKG = "repro_torch/kernels"
#: raw entry points of the kernel modules (module path -> wrapper)
RAW_KERNELS = frozenset({f"{KERNELS}.gf_bitmatmul.gf_bitmatmul",
                         f"{KERNELS}.xor_reduce.xor_reduce"})
RAW_OPERATORS = "torch.ops.repro_torch."
LIBRARY = f"{KERNELS}._build.library"
SINGLE_ITEM_OPS = frozenset({
    "encode", "apply_matrix", "xor_fold", "recover_single", "apply_decode",
})
GF_CRITICAL = (
    "core/gf.py", "core/codec.py", "core/codes.py",
    "io/backend.py", "io/engine.py", "ckpt/stripe.py",
)
HOT_PATHS = ("io/engine.py", "io/frontend.py", "ckpt/stripe.py")
DEPRECATED_NAMES = frozenset({"ClusterTopology"})
DEPRECATED_KEYWORDS = frozenset({"use_kernels"})
LAUNCH_COUNTER_NAMES = frozenset({"KERNEL_LAUNCHES"})
#: the kernel modules' own counters, written only where they launch
KERNEL_COUNTERS = frozenset({"launches", "plain_calls", "fp32_launches",
                             "decode_launches", "mode_launches"})
COUNTER_MODULES = frozenset({f"{KERNELS}.gf_bitmatmul",
                             f"{KERNELS}.xor_reduce",
                             f"{KERNELS}.flash_attention"})
# RA008: launch constants and the keyword that must stay inside the
# kernels package (everyone else goes through the planner).
LAUNCH_CONSTANT_NAMES = frozenset({"GF_TILE", "GF_THREADS", "THREADS",
                                   "BYTES_PER_THREAD", "MAX_GRID_X"})
LAUNCH_KEYWORDS = frozenset({"grid"})
# Counter methods that mutate; reads (snapshot/sum/items) stay legal.
COUNTER_MUTATORS = frozenset({"clear", "update", "subtract", "pop",
                              "popitem", "setdefault", "__setitem__"})
FLOAT_DTYPES = frozenset({"float", "float16", "float32", "float64",
                          "double", "half", "bfloat16"})
#: tensor methods that convert to a float dtype
FLOAT_METHODS = frozenset({"float", "half", "double", "bfloat16"})
# RA006 unit vocabulary, longest suffix first (a `_TB_per_hour` name
# must not be read as `_per_hour`).
UNIT_SUFFIXES = ("_TB_per_hour", "_per_hour", "_hours", "_TB", "_Gbps")
_WAIVER_RE = re.compile(r"#\s*repro-lint:\s*allow=([A-Z0-9,\s]+)")


def _unit_of_name(name: str) -> str | None:
    """The unit a bare identifier claims: its unit suffix, or the unit
    itself when the whole name IS the unit (`hours`, `block_TB`)."""
    for suf in UNIT_SUFFIXES:
        if name.endswith(suf) or name == suf[1:]:
            return suf[1:]
    return None


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} " \
               f"{self.message}"


def _norm(path: pathlib.Path) -> str:
    return str(path).replace("\\", "/")


def _is_float_dtype(node: ast.expr) -> bool:
    """True for `float`, `torch.float32`, `np.float64`, `"float32"`, ..."""
    if isinstance(node, ast.Name):
        return node.id in FLOAT_DTYPES
    if isinstance(node, ast.Attribute):
        return node.attr in FLOAT_DTYPES
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value in FLOAT_DTYPES
    return False


def _dotted(node: ast.expr) -> list[str] | None:
    """`a.b.c` as ["a", "b", "c"]; None for anything but names and
    attributes."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return parts[::-1]


def _package_of(norm: str) -> list[str]:
    """The package a file under `repro_torch/` belongs to, for relative
    imports (`src/repro_torch/io/engine.py` -> ["repro_torch", "io"])."""
    parts = norm.split("/")
    if "repro_torch" not in parts:
        return []
    return parts[len(parts) - 1 - parts[::-1].index("repro_torch"):-1]


class _FileLinter(ast.NodeVisitor):
    def __init__(self, path: str, *, gf_critical: bool, hot_path: bool,
                 in_kernels: bool, package: Sequence[str] = ()):
        self.path = path
        self.gf_critical = gf_critical
        self.hot_path = hot_path
        self.in_kernels = in_kernels
        self.package = list(package)
        self.findings: list[Finding] = []
        self.loop_depth = 0
        # RA006 local dataflow: per-scope map of unsuffixed variable
        # name -> unit it was assigned from.
        self._unit_envs: list[dict[str, str]] = [{}]
        # local name -> the dotted path it was imported as
        self.aliases: dict[str, str] = {}
        # names bound to `_build.library()`
        self.library_handles: set[str] = set()

    # -- name resolution ------------------------------------------------------
    def _resolve(self, node: ast.expr) -> str | None:
        """The dotted path an expression names, its head resolved through
        the file's imports (`gfk.gf_bitmatmul` ->
        `repro_torch.kernels.gf_bitmatmul.gf_bitmatmul`)."""
        parts = _dotted(node)
        if parts is None:
            return None
        head = self.aliases.get(parts[0], parts[0])
        return ".".join([head, *parts[1:]])

    def _is_kernel_path(self, path: str | None) -> bool:
        return path is not None and path.startswith(KERNELS + ".")

    # -- imports --------------------------------------------------------------
    def _module_of(self, node: ast.ImportFrom) -> str:
        if not node.level:
            return node.module or ""
        base = self.package[:len(self.package) - node.level + 1] \
            if node.level <= len(self.package) else []
        return ".".join([*base, *([node.module] if node.module else [])])

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        mod = self._module_of(node)
        for alias in node.names:
            full = f"{mod}.{alias.name}"
            self.aliases[alias.asname or alias.name] = full
            if alias.name in DEPRECATED_NAMES:
                self._emit(node, "RA005",
                           f"import of retired `{alias.name}` — use "
                           f"repro_torch.topo.Topology")
            if (not self.in_kernels and mod.startswith(KERNELS)
                    and alias.name in LAUNCH_CONSTANT_NAMES):
                self._emit(node, "RA008",
                           f"import of launch constant `{alias.name}` "
                           f"outside {KERNEL_PKG}/ — launches come from "
                           f"repro_torch.kernels.autotune "
                           f"(plan_matmul_tiles / plan_xor_tiles)")
        self.generic_visit(node)

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            if alias.asname:
                self.aliases[alias.asname] = alias.name
            else:
                head = alias.name.split(".")[0]
                self.aliases[head] = head
        self.generic_visit(node)

    def _emit(self, node: ast.AST, rule: str, message: str) -> None:
        self.findings.append(Finding(self.path, node.lineno,
                                     node.col_offset, rule, message))

    # -- loops (RA004 context) ------------------------------------------------
    def visit_For(self, node: ast.For) -> None:
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    def visit_While(self, node: ast.While) -> None:
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    # -- calls (RA001-RA005, RA007, RA008) ------------------------------------
    def _is_library(self, node: ast.expr) -> bool:
        """`_build.library()` or a name bound to it."""
        if isinstance(node, ast.Name):
            return node.id in self.library_handles
        return isinstance(node, ast.Call) \
            and self._resolve(node.func) == LIBRARY

    def _raw_kernel(self, func: ast.expr) -> str | None:
        """A raw kernel entry point the call reaches, or None."""
        path = self._resolve(func)
        if path in RAW_KERNELS:
            return path.rsplit(".", 1)[1]
        if path is not None and path.startswith(RAW_OPERATORS):
            return path
        if isinstance(func, ast.Attribute) and self._is_library(func.value):
            return f"library().{func.attr}"
        return None

    def _single_item_op(self, func: ast.expr) -> str | None:
        path = self._resolve(func)
        if path is None:
            return None
        mod, _, name = path.rpartition(".")
        if name in SINGLE_ITEM_OPS and mod in (KERNELS, f"{KERNELS}.ops"):
            return name
        return None

    def visit_Call(self, node: ast.Call) -> None:
        raw = self._raw_kernel(node.func)
        if raw is not None and not self.in_kernels:
            self._emit(node, "RA001",
                       f"raw kernel call `{raw}` bypasses the launch "
                       f"accounting and planning of the wrappers — go "
                       f"through repro_torch.kernels.ops")
        op = self._single_item_op(node.func)
        if self.hot_path and self.loop_depth > 0 and op is not None:
            self._emit(node, "RA004",
                       f"single-item kernel op `{op}` inside a host loop "
                       f"on a batched hot path — use the `_many` batched "
                       f"variant")
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr == "setflags"):
            for kw in node.keywords:
                if (kw.arg == "write" and isinstance(kw.value, ast.Constant)
                        and kw.value.value is True):
                    self._emit(node, "RA003",
                               "re-enabling writes on a sealed plan "
                               "matrix — cached plans are shared; copy "
                               "instead")
        for kw in node.keywords:
            if kw.arg in DEPRECATED_KEYWORDS:
                self._emit(kw.value, "RA005",
                           f"retired `{kw.arg}=` keyword — pass "
                           f"backend=... (a name or a Backend) instead")
        if not self.in_kernels:
            self._check_counter_call(node)
            for kw in node.keywords:
                if (kw.arg in LAUNCH_KEYWORDS
                        and isinstance(kw.value, ast.Constant)
                        and isinstance(kw.value.value, int)
                        and not isinstance(kw.value.value, bool)):
                    self._emit(kw.value, "RA008",
                               f"hard-coded `{kw.arg}={kw.value.value}` "
                               f"outside {KERNEL_PKG}/ pins one shape's "
                               f"launch on every caller — leave it unset "
                               f"(the ops layer plans it) or pass "
                               f"`plan.grid_steps` from "
                               f"repro_torch.kernels.autotune")
        if self.gf_critical:
            self._check_float(node)
        self.generic_visit(node)

    def _check_float(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute):
            if func.attr == "astype" and node.args \
                    and _is_float_dtype(node.args[0]):
                self._emit(node, "RA002",
                           "float astype on a GF array — GF(2^8) symbols "
                           "are uint8 table indices")
            elif func.attr in FLOAT_METHODS and not node.args \
                    and not node.keywords:
                self._emit(node, "RA002",
                           f"`.{func.attr}()` on a GF tensor — GF(2^8) "
                           f"symbols are uint8 table indices")
            elif func.attr == "to" and node.args \
                    and _is_float_dtype(node.args[0]):
                self._emit(node, "RA002",
                           "`.to(<float dtype>)` on a GF tensor — GF(2^8) "
                           "symbols are uint8")
        for kw in node.keywords:
            if kw.arg == "dtype" and _is_float_dtype(kw.value):
                self._emit(node, "RA002",
                           "float dtype in a GF-critical module — GF(2^8) "
                           "symbols are uint8")

    # -- names and attributes (RA005, RA008) ----------------------------------
    def _is_launch_constant(self, node: ast.expr) -> bool:
        path = self._resolve(node)
        return (self._is_kernel_path(path)
                and path.rsplit(".", 1)[1] in LAUNCH_CONSTANT_NAMES)

    def visit_Name(self, node: ast.Name) -> None:
        # bare `ClusterTopology(...)` / annotations; imports are caught
        # separately so one waiver on the import line is not enough to
        # hide every downstream use
        if isinstance(node.ctx, ast.Load) and node.id in DEPRECATED_NAMES:
            self._emit(node, "RA005",
                       f"retired name `{node.id}` — use "
                       f"repro_torch.topo.Topology")
        if (not self.in_kernels and isinstance(node.ctx, ast.Load)
                and node.id in self.aliases
                and self._is_launch_constant(node)):
            self._emit(node, "RA008",
                       f"use of launch constant `{node.id}` outside "
                       f"{KERNEL_PKG}/ — plan launches with "
                       f"repro_torch.kernels.autotune instead")
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (not self.in_kernels and isinstance(node.ctx, ast.Load)
                and node.attr in LAUNCH_CONSTANT_NAMES
                and self._is_launch_constant(node)):
            self._emit(node, "RA008",
                       f"use of launch constant `{node.attr}` outside "
                       f"{KERNEL_PKG}/ — plan launches with "
                       f"repro_torch.kernels.autotune instead")
        self.generic_visit(node)

    # -- launch counters (RA007) ----------------------------------------------
    def _is_launch_counter(self, node: ast.expr) -> bool:
        """Any spelling of a launch counter: `KERNEL_LAUNCHES` bare or as
        an attribute, or a kernel module's own counter
        (`gfk.launches`, `repro_torch.kernels.flash_attention.
        mode_launches`)."""
        if isinstance(node, ast.Name) and node.id in LAUNCH_COUNTER_NAMES:
            return True
        if isinstance(node, ast.Attribute):
            if node.attr in LAUNCH_COUNTER_NAMES:
                return True
            if node.attr in KERNEL_COUNTERS:
                return self._resolve(node.value) in COUNTER_MODULES
        return False

    def _check_counter_call(self, node: ast.Call) -> None:
        func = node.func
        if (isinstance(func, ast.Attribute)
                and func.attr in COUNTER_MUTATORS
                and self._is_launch_counter(func.value)):
            self._emit(node, "RA007",
                       f"`.{func.attr}()` mutates a kernel launch counter "
                       f"outside {KERNEL_PKG}/ — use reset_counts() / "
                       f"reset_kernel_launch_counts() / launch_scope()")
        name = func.attr if isinstance(func, ast.Attribute) else \
            func.id if isinstance(func, ast.Name) else None
        if (name == "setattr" and len(node.args) >= 2
                and self._resolve(node.args[0]) in COUNTER_MODULES
                and isinstance(node.args[1], ast.Constant)
                and node.args[1].value in KERNEL_COUNTERS):
            self._emit(node, "RA007",
                       f"setattr of the kernel counter "
                       f"`{node.args[1].value}` outside {KERNEL_PKG}/ — "
                       f"counters move only where the kernel launches")

    def _check_counter_mutation(self, target: ast.expr,
                                node: ast.AST) -> None:
        # `KERNEL_LAUNCHES[...] = v` / `+= 1`, `gfk.launches = 0`,
        # `fak.mode_launches[key] += 1`, or rebinding the name
        if isinstance(target, ast.Subscript) \
                and self._is_launch_counter(target.value):
            self._emit(node, "RA007",
                       f"direct write to a kernel launch counter outside "
                       f"{KERNEL_PKG}/ — launches are counted under a "
                       f"lock where the kernel launches")
        elif isinstance(target, ast.Attribute) \
                and self._is_launch_counter(target) \
                and target.attr in KERNEL_COUNTERS:
            self._emit(node, "RA007",
                       f"write to the kernel counter `{target.attr}` "
                       f"outside {KERNEL_PKG}/ — use reset_counts()")
        elif isinstance(target, ast.Name) \
                and target.id in LAUNCH_COUNTER_NAMES:
            self._emit(node, "RA007",
                       "rebinding KERNEL_LAUNCHES outside "
                       f"{KERNEL_PKG}/ detaches every existing "
                       "accounting consumer")

    # -- assignments (RA003, RA007, library handles) ---------------------------
    def _check_plan_mutation(self, target: ast.expr, node: ast.AST) -> None:
        # `plan.M[...] = v` / `plan.M[...] ^= v`
        if (isinstance(target, ast.Subscript)
                and isinstance(target.value, ast.Attribute)
                and target.value.attr == "M"):
            self._emit(node, "RA003",
                       "in-place write to a plan's `.M` payload — "
                       "DecodePlan matrices are frozen and shared "
                       "through the cache")

    def visit_Assign(self, node: ast.Assign) -> None:
        for target in node.targets:
            self._check_plan_mutation(target, node)
            if not self.in_kernels:
                self._check_counter_mutation(target, node)
            if isinstance(target, ast.Name):
                if self._is_library(node.value):
                    self.library_handles.add(target.id)
                else:
                    self.library_handles.discard(target.id)
        self._track_unit_assign(node.targets, node.value)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._track_unit_assign([node.target], node.value)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_plan_mutation(node.target, node)
        if not self.in_kernels:
            self._check_counter_mutation(node.target, node)
        if isinstance(node.op, (ast.Add, ast.Sub)):
            self._check_unit_mix(node, node.target, node.value,
                                 op="+=" if isinstance(node.op, ast.Add)
                                 else "-=")
        self.generic_visit(node)

    # -- units (RA006) ----------------------------------------------------------
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._unit_envs.append({})
        self.generic_visit(node)
        self._unit_envs.pop()

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._unit_envs.append({})
        self.generic_visit(node)
        self._unit_envs.pop()

    def _expr_unit(self, node: ast.expr) -> str | None:
        """The unit an expression is denominated in, or None when it is
        unitless / unknown. `*` and `/` erase units on purpose, and so
        does any call whose name carries no unit suffix."""
        if isinstance(node, ast.Name):
            unit = _unit_of_name(node.id)
            if unit is not None:
                return unit
            for env in reversed(self._unit_envs):
                if node.id in env:
                    return env[node.id]
            return None
        if isinstance(node, ast.Attribute):
            return _unit_of_name(node.attr)
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Name):
                return _unit_of_name(func.id)
            if isinstance(func, ast.Attribute):
                return _unit_of_name(func.attr)
            return None
        if isinstance(node, ast.Subscript):
            return self._expr_unit(node.value)
        if isinstance(node, ast.UnaryOp):
            return self._expr_unit(node.operand)
        if (isinstance(node, ast.BinOp)
                and isinstance(node.op, (ast.Add, ast.Sub))):
            lu = self._expr_unit(node.left)
            ru = self._expr_unit(node.right)
            return lu if lu == ru else None
        return None

    def _track_unit_assign(self, targets: Sequence[ast.expr],
                           value: ast.expr) -> None:
        """Straight-line dataflow: `t = params.T_hours` gives `t` the
        hours unit until reassigned; a suffixed name's own suffix wins."""
        if len(targets) != 1 or not isinstance(targets[0], ast.Name):
            return
        name = targets[0].id
        if _unit_of_name(name) is not None:
            return
        unit = self._expr_unit(value)
        env = self._unit_envs[-1]
        if unit is not None:
            env[name] = unit
        else:
            env.pop(name, None)

    def _check_unit_mix(self, node: ast.AST, left: ast.expr,
                        right: ast.expr, *, op: str) -> None:
        lu = self._expr_unit(left)
        ru = self._expr_unit(right)
        if lu is not None and ru is not None and lu != ru:
            self._emit(node, "RA006",
                       f"`{op}` mixes {lu}- and {ru}-denominated "
                       f"quantities — convert explicitly (multiply/"
                       f"divide, or route through a conversion helper)")

    def visit_BinOp(self, node: ast.BinOp) -> None:
        if isinstance(node.op, (ast.Add, ast.Sub)):
            self._check_unit_mix(node, node.left, node.right,
                                 op="+" if isinstance(node.op, ast.Add)
                                 else "-")
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare) -> None:
        operands = [node.left] + list(node.comparators)
        for cmp_op, lhs, rhs in zip(node.ops, operands, operands[1:]):
            if isinstance(cmp_op, (ast.Lt, ast.LtE, ast.Gt, ast.GtE,
                                   ast.Eq, ast.NotEq)):
                self._check_unit_mix(node, lhs, rhs, op="comparison")
        self.generic_visit(node)


def _waived_rules(source_lines: Sequence[str], line: int) -> set[str]:
    """Waivers apply on the finding's own line or the line above (for
    calls split across lines, the comment rides the opening line)."""
    out: set[str] = set()
    for ln in (line - 1, line):
        if 1 <= ln <= len(source_lines):
            m = _WAIVER_RE.search(source_lines[ln - 1])
            if m:
                out |= {r.strip() for r in m.group(1).split(",")
                        if r.strip()}
    return out


def lint_source(source: str, path: str) -> list[Finding]:
    """Lint one file's source text; `path` scopes the rules."""
    norm = path.replace("\\", "/")
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [Finding(path, exc.lineno or 0, exc.offset or 0, "RA000",
                        f"syntax error: {exc.msg}")]
    linter = _FileLinter(
        path,
        gf_critical=any(norm.endswith(s) for s in GF_CRITICAL),
        hot_path=any(norm.endswith(s) for s in HOT_PATHS),
        in_kernels=f"{KERNEL_PKG}/" in norm,
        package=_package_of(norm))
    linter.visit(tree)
    lines = source.splitlines()
    return [f for f in linter.findings
            if f.rule not in _waived_rules(lines, f.line)]


def lint_paths(paths: Iterable[pathlib.Path]) -> list[Finding]:
    findings: list[Finding] = []
    for root in paths:
        files = sorted(root.rglob("*.py")) if root.is_dir() else [root]
        for f in files:
            findings.extend(lint_source(f.read_text(), _norm(f)))
    return sorted(findings, key=lambda f: (f.path, f.line, f.col))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Repo-invariant AST lint of the port (stdlib-only).")
    ap.add_argument("paths", nargs="+", type=pathlib.Path,
                    help="files or directories to lint")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the all-clear summary line")
    args = ap.parse_args(argv)
    for p in args.paths:
        if not p.exists():
            print(f"error: no such path {p}", file=sys.stderr)
            return 2
    findings = lint_paths(args.paths)
    for f in findings:
        print(f)
    if findings:
        print(f"{len(findings)} invariant violation(s)", file=sys.stderr)
        return 1
    if not args.quiet:
        print("repro-lint: all invariants hold")
    return 0


if __name__ == "__main__":
    sys.exit(main())
