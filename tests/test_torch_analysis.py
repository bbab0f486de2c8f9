"""The port's analysis pillars (`repro_torch.analysis`: `certificate`,
`verify`, `model`, `schedcheck`) against the reference's, on the CPU.

Certificate batches must be byte-identical, model-checker explorations
equal field by field, counterexamples found and replayed identically, and
both CLIs must exit as the reference's do. Certification and model
checking stay launch-free in the port: they load no kernel module.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro.analysis import certificate as ref_certificate
from repro.analysis import model as ref_model
from repro.analysis import schedcheck as ref_schedcheck
from repro.analysis import verify as ref_verify
from repro.core import codec as ref_codec
from repro.core import make_alrc as ref_make_alrc
from repro.core import make_olrc as ref_make_olrc
from repro.core import make_rs as ref_make_rs
from repro.core import make_ulrc as ref_make_ulrc
from repro.core import make_unilrc as ref_make_unilrc
from repro_torch import analysis
from repro_torch.analysis import certificate, model, schedcheck, verify
from repro_torch.core import code_from_state
from repro_torch.core import codec as port_codec

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _port(ref_code):
    return code_from_state(ref_code.name, ref_code.n, ref_code.k, ref_code.A,
                           ref_code.groups, ref_code.checks,
                           ref_code.block_type, ref_code.meta)


@pytest.fixture
def fresh_plan_caches():
    """Both packages' decode-plan caches empty, so that the cached-plan
    counts a certificate records depend on this test alone."""
    ref_codec.clear_plan_caches()
    port_codec.clear_plan_caches()
    yield
    ref_codec.clear_plan_caches()
    port_codec.clear_plan_caches()


def test_lazy_submodules_reachable_as_in_the_reference():
    for name in ("certificate", "lint", "model", "schedcheck", "verify"):
        assert getattr(analysis, name).__name__ == f"repro_torch.analysis.{name}"
        assert name in analysis.__all__
    assert analysis.analyze_flush is not None        # hazards, as before
    with pytest.raises(AttributeError):
        analysis.no_such_pillar                      # noqa: B018


# ---------------------------------------------------------------------------
# Symbolic verifier and certificates
# ---------------------------------------------------------------------------

def test_certify_paper_grid_bytes_identical(fresh_plan_caches):
    """At the reference test's trials and budget."""
    want = ref_certificate.dump_certificates(
        ref_verify.certify_paper_grid(trials=40, exhaustive_budget=2000))
    certs = verify.certify_paper_grid(trials=40, exhaustive_budget=2000)
    assert certificate.dump_certificates(certs) == want
    assert len(certs) == 6
    assert all(c.all_ok and c.kernel_launches == 0 for c in certs)


CODES = {
    "UniLRC(1,4)": lambda: ref_make_unilrc(1, 4),
    "ALRC": lambda: ref_make_alrc(k=12, l=3, g=3),
    "OLRC": lambda: ref_make_olrc(k=12, l=2, g=4),
    "ULRC": lambda: ref_make_ulrc(k=12, l=3, g=3),
    "RS": lambda: ref_make_rs(14, 10),
}


@pytest.mark.parametrize("name", sorted(CODES))
def test_certify_codes_identical(fresh_plan_caches, name):
    code = CODES[name]()
    port = _port(code)
    for budget in (0, 2000):
        want = ref_verify.certify(code, trials=8, exhaustive_budget=budget)
        got = verify.certify(port, trials=8, exhaustive_budget=budget)
        assert got.to_json() == want.to_json()
    for pattern in ([0], [0, 1], list(range(code.n - code.k)),
                    list(range(code.n - code.k + 1))):
        assert (verify.erasure_correctable(port, pattern)
                == ref_verify.erasure_correctable(code, pattern))
    assert (verify.optimal_lrc_distance(port)
            == ref_verify.optimal_lrc_distance(code))
    assert (port_codec.verify_erasure_tolerance(port, 2, trials=8)
            == ref_codec.verify_erasure_tolerance(code, 2, trials=8))


def test_certify_flags_broken_codes_identically(fresh_plan_caches):
    """A corrupted check row and an overclaimed distance fail the same
    claims with the same evidence in both packages."""
    code = ref_make_unilrc(1, 4)
    checks = code.checks.copy()
    checks[0, 0] ^= 1
    bad = dataclasses.replace(code, checks=checks)
    over = dataclasses.replace(code, meta=dict(code.meta, d=code.meta["d"] + 1))
    for ref_code in (bad, over):
        want = ref_verify.certify(ref_code, trials=5, exhaustive_budget=0)
        got = verify.certify(_port(ref_code), trials=5, exhaustive_budget=0)
        assert got.to_json() == want.to_json()
        assert not got.all_ok


def test_cached_decode_plans_identical(fresh_plan_caches):
    code = ref_make_unilrc(1, 4)
    port = _port(code)
    assert port_codec.cached_decode_plans(port) == ()
    for pattern in ((0, 1), tuple(code.groups[0]), (3, 9, 14), (1, 0)):
        ref_codec.decode_plan_cached(code, pattern)
        port_codec.decode_plan_cached(port, pattern)
    want = ref_codec.cached_decode_plans(code)
    got = port_codec.cached_decode_plans(port)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert (a.erased, a.sources) == (b.erased, b.sources)
        assert np.array_equal(a.M, b.M)


def test_certificates_cross_load_byte_for_byte():
    cert = ref_verify.certify(ref_make_unilrc(1, 4), trials=5,
                              exhaustive_budget=0)
    batch = ref_certificate.dump_certificates([cert, cert])
    loaded = certificate.load_certificates(batch)
    assert certificate.dump_certificates(loaded) == batch
    assert loaded[0].summary() == cert.summary()
    one = certificate.Certificate.from_json(cert.to_json(indent=2))
    assert one.to_json(indent=2) == cert.to_json(indent=2)
    assert certificate.CERTIFICATE_VERSION == ref_certificate.CERTIFICATE_VERSION


def test_certification_and_model_checking_load_no_kernel_module():
    """In a process with jax blocked: a certificate and a scheduler
    scenario check run, record zero launches, and no module of the port's
    kernel layer (nor jax, nor the reference) is loaded."""
    probe = r"""
import sys
sys.modules["jax"] = None
from repro_torch.analysis import schedcheck, verify
from repro_torch.core import make_unilrc
cert = verify.certify(make_unilrc(1, 3), trials=5, exhaustive_budget=0)
sched = schedcheck.check_scenario(schedcheck.scenario_grid()[0])
loaded = sorted(m for m in sys.modules
                if m.startswith(("repro_torch.kernels", "repro."))
                or m == "repro" or (m.startswith("jax")
                                    and sys.modules[m] is not None))
print(cert.all_ok, sched.all_ok, cert.kernel_launches,
      sched.kernel_launches, loaded)
"""
    out = subprocess.run([sys.executable, "-c", probe],
                         env=dict(os.environ, PYTHONPATH=str(SRC)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "True", "0", "0", "[]"]


# ---------------------------------------------------------------------------
# The scheduler model checker
# ---------------------------------------------------------------------------

def _explore_dict(res) -> dict:
    return {"states": res.states, "transitions": res.transitions,
            "terminals": res.terminals,
            "pruned_orderings": res.pruned_orderings,
            "max_inflight_seen": res.max_inflight_seen,
            "inversion_width": res.inversion_width,
            "admissions": res.admissions, "exhaustive": res.exhaustive,
            "ok": res.ok, "properties": res.properties,
            "violations": [(v.prop, v.detail, v.to_dict())
                           for v in res.violations]}


SCENARIOS = [s.name for s in ref_schedcheck.scenario_grid()]


def _scenario(pkg, name):
    return next(s for s in pkg.scenario_grid() if s.name == name)


@pytest.mark.parametrize("por", [True, False])
@pytest.mark.parametrize("name", SCENARIOS)
def test_sched_model_explore_identical(name, por):
    want = ref_schedcheck.build_model(_scenario(ref_schedcheck, name),
                                      por=por).explore()
    got = schedcheck.build_model(_scenario(schedcheck, name),
                                 por=por).explore()
    assert _explore_dict(got) == _explore_dict(want)
    assert got.ok
    assert model.PROPERTIES == ref_model.PROPERTIES


@pytest.mark.parametrize("name", SCENARIOS)
def test_timed_traces_and_real_runs_identical(name):
    ref_scn, scn = _scenario(ref_schedcheck, name), _scenario(schedcheck, name)
    assert scn == dataclasses.replace(scn, **dataclasses.asdict(ref_scn))
    assert (schedcheck.build_model(scn).timed_trace(scn.batch_times)
            == ref_schedcheck.build_model(ref_scn).timed_trace(
                ref_scn.batch_times))
    got_events, got_sched = schedcheck.run_real(scn)
    want_events, want_sched = ref_schedcheck.run_real(ref_scn)
    assert got_events == want_events
    assert (schedcheck.differential_check(scn)
            == ref_schedcheck.differential_check(ref_scn))
    assert got_sched.ledger.jobs == want_sched.ledger.jobs


def test_schedcheck_grid_bytes_identical():
    want = ref_certificate.dump_certificates(ref_schedcheck.check_grid())
    certs = schedcheck.check_grid()
    assert certificate.dump_certificates(certs) == want
    assert all(c.all_ok and c.kernel_launches == 0 for c in certs)


def test_broken_scenario_counterexample_found_and_replayed_identically():
    ref_scn, scn = ref_schedcheck.broken_scenario(), schedcheck.broken_scenario()
    want = ref_schedcheck.find_counterexample(ref_scn)
    got = schedcheck.find_counterexample(scn)
    assert got is not None and got.to_dict() == want.to_dict()
    assert got.detail == want.detail
    replay = schedcheck.replay_counterexample(scn, got)
    assert replay == ref_schedcheck.replay_counterexample(ref_scn, want)
    assert replay[0]
    # the safe scheduler has none, in both
    assert schedcheck.build_model(scn).explore().first_violation(
        "link_safety") is None
    cert = schedcheck.check_scenario(scn)
    assert cert.to_json() == ref_schedcheck.check_scenario(ref_scn).to_json()


# ---------------------------------------------------------------------------
# CLIs
# ---------------------------------------------------------------------------

CLI_CASES = [
    ("verify", ["--alpha", "1", "--z", "3", "--trials", "5"]),
    ("verify", ["--alpha", "1", "--z", "4", "--t", "2", "--trials", "5",
                "--exhaustive-budget", "0"]),
    ("schedcheck", ["--scenario", "skip_ahead"]),
    ("schedcheck", ["--scenario", "pipe_serial"]),
    ("schedcheck", ["--broken"]),
]


@pytest.mark.parametrize("tool,args", CLI_CASES)
def test_cli_exits_and_writes_as_the_reference(tmp_path, capsys, tool, args,
                                               fresh_plan_caches):
    ref_main = getattr(ref_verify if tool == "verify" else ref_schedcheck,
                       "main")
    port_main = getattr(verify if tool == "verify" else schedcheck, "main")
    outs = []
    for name, main in (("ref", ref_main), ("port", port_main)):
        out = tmp_path / f"{name}.json"
        extra = [] if "--broken" in args else ["--out", str(out)]
        rc = main(args + extra)
        printed = capsys.readouterr().out.replace(str(out), "OUT")
        outs.append((rc, printed, out.read_bytes() if extra else b""))
        ref_codec.clear_plan_caches()
        port_codec.clear_plan_caches()
    assert outs[1] == outs[0]
    assert outs[1][0] == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [] if "--broken" in args else ["port.json", "ref.json"])


@pytest.mark.parametrize("tool,args", [
    ("verify", []), ("verify", ["--alpha", "1"]),
    ("schedcheck", []), ("schedcheck", ["--scenario", "nope"])])
def test_cli_usage_errors_as_the_reference(capsys, tool, args):
    codes = []
    for mod in ((ref_verify, verify) if tool == "verify"
                else (ref_schedcheck, schedcheck)):
        with pytest.raises(SystemExit) as exit_:
            mod.main(args)
        codes.append((exit_.value.code, capsys.readouterr().err.split(
            "error:")[-1]))
    assert codes[1] == codes[0] and codes[0][0] == 2


def test_cli_module_entry_point(tmp_path):
    """`python -m repro_torch.analysis.verify` and `.schedcheck` run in a
    fresh process and write only `--out`."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    for tool, args in (("verify", ["--alpha", "1", "--z", "3",
                                   "--trials", "5"]),
                       ("schedcheck", ["--scenario", "mixed_tier"])):
        out = tmp_path / f"{tool}.json"
        run = subprocess.run(
            [sys.executable, "-m", f"repro_torch.analysis.{tool}", *args,
             "--out", str(out)], env=env, cwd=tmp_path, capture_output=True,
            text=True, timeout=120)
        assert run.returncode == 0, run.stderr
        assert certificate.load_certificates(out.read_text())[0].all_ok
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "schedcheck.json", "verify.json"]
