"""The port's hazards CLI (`python -m repro_torch.analysis.hazards`)
against the reference's: the same three engine workloads give the same
ops, waves and violations, and the same report. The workloads write on
the CPU here (`--device cpu`); on the card they launch the coding
kernels (chip_smoke.py).
"""
import json

from repro.analysis import hazards as ref_hazards
from repro_torch.analysis import hazards


def test_cli_matches_the_reference(tmp_path, capsys):
    out = tmp_path / "port.json"
    assert hazards.main(["--device", "cpu", "--out", str(out)]) == 0
    port_lines = capsys.readouterr().out.splitlines()
    ref_out = tmp_path / "ref.json"
    assert ref_hazards.main(["--out", str(ref_out)]) == 0
    ref_lines = capsys.readouterr().out.splitlines()
    # the verdict lines, all OK, word for word; then where each went
    assert port_lines[:-1] == ref_lines[:-1]
    assert [line.split()[0] for line in port_lines[:-1]] == ["OK"] * 3
    port = json.loads(out.read_text())["workloads"]
    ref = json.loads(ref_out.read_text())["workloads"]
    assert list(port) == ["reads+recover", "degraded+update-chain",
                          "update-fanout"]
    for name, rep in ref.items():
        assert (port[name]["ops"], port[name]["waves"],
                len(port[name]["violations"]), port[name]["ok"]) \
            == (rep["ops"], rep["waves"], len(rep["violations"]), True)
    assert port == ref


def test_workload_reports_have_the_reference_counts():
    port = hazards._workload_reports("cpu")
    ref = ref_hazards._workload_reports()
    assert {k: (r.ops, r.waves, len(r.violations)) for k, r in port.items()} \
        == {k: (r.ops, r.waves, len(r.violations)) for k, r in ref.items()}
