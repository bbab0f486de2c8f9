"""The port's example programs (`examples/*_torch.py`) on the CPU: each
runs with --device cpu to its "OK" line. `train_with_failures_torch.py`
(300 steps of a 100M-parameter model) runs on the card in
`chip_smoke.py`; here it would take minutes."""
import importlib.util
import pathlib

import pytest

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES /
                                                  f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_torch_on_the_cpu(capsys):
    _load("quickstart_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "degraded read OK; cross-cluster bytes = 0" in out
    assert "decoded 7 erasures" in out and "quickstart OK" in out


@pytest.mark.parametrize("arch", ["minicpm3-4b", "phi3.5-moe-42b-a6.6b"])
def test_serving_torch_on_the_cpu(capsys, arch):
    """The default arch (minicpm3-4b, MLA) and an MoE one: the registry
    restored degraded with zero cross-cluster bytes, the front-end's
    traffic and scrub, prefill and decode."""
    args = ["--device", "cpu", "--batch", "2", "--prompt-len", "16",
            "--gen", "4"]
    if arch != "minicpm3-4b":
        args += ["--arch", arch]
    _load("serving_torch").main(args)
    out = capsys.readouterr().out
    assert "cross-cluster bytes=0" in out and "0 parity mismatches" in out
    assert "decode:  2×3 tokens" in out and "serving OK" in out


def test_examples_default_to_the_card():
    """Without --device each example asks for the card, and without one
    it raises instead of running on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    for name in ("quickstart_torch", "serving_torch",
                 "train_with_failures_torch"):
        with pytest.raises(RuntimeError, match="CUDA"):
            _load(name).main(["--steps", "1"] if "train" in name else [])
