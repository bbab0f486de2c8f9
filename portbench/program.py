"""The system under test: the port (`repro_torch`), and nothing else.

`build` puts the benchmark's weights into the port's `Transformer` (its
arch from `get_config`, cut to the layers the configuration keeps) and
returns the prefill entry that the server runs for every batch,
`repro_torch.train.make_serve_prefill`. `Probes` times calls of the
program's functions, named by the metric readers, with CUDA events;
`tapped` keeps the arguments and results of one function's calls.
This is the only module of the benchmark that imports the port.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import sys

import torch


def _port():
    # the port lives under src/ at the root of the checkout
    from .spec import ROOT
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import repro_torch.configs
    import repro_torch.models
    import repro_torch.train
    return repro_torch


def port_config(config: dict):
    """The port's configuration of this model: its arch, cut to the layers
    the benchmark's configuration keeps."""
    rt = _port()
    from repro_torch.models.config import Segment
    cfg = rt.configs.get_config(config["arch"],
                                smoke=config.get("smoke", False))
    if len(cfg.segments) != 1 or cfg.segments[0].blocks != (
            config["block_kind"],):
        raise SystemExit(f"{config['arch']}: expected one segment of "
                         f"{config['block_kind']!r} blocks")
    cfg = dataclasses.replace(
        cfg, segments=(Segment(cfg.segments[0].blocks, config["layers"]),))
    if config["layers"] != rt.configs.get_config(config["arch"]).num_layers:
        # a cut in depth, named as the port names its cut cells
        cfg = dataclasses.replace(cfg, name=f"{cfg.name}-{config['layers']}l")
    return cfg


def build(config: dict, weights, device: torch.device):
    """-> (model, prefill): the port's model holding `weights`, and
    prefill(model, prompts) -> (last-position logits, cache)."""
    from .inputs import block_module
    rt = _port()
    cfg = port_config(config)
    c = config["config"]
    kind = block_module(config["block_kind"])
    kind.check_port(cfg, c)
    model = rt.models.Transformer(cfg, None, "meta")
    for li, block in enumerate(model.blocks):
        kind.load(block, weights.layer(li), cfg, c)
    for name, leaf in weights.top.items():
        setattr(model, name, torch.nn.Parameter(leaf, requires_grad=False))
    left = [n for n, p in model.named_parameters() if p.is_meta]
    if left:
        raise SystemExit(f"parameters not loaded: {left[:5]}")
    return model, rt.train.make_serve_prefill(cfg)


class Probes:
    """While installed, every call of each named function of the program
    is timed between two CUDA events and its tensor arguments' shapes
    kept: `calls[name]` is a list of (events, shapes, keyword arguments
    that are not tensors)."""

    def __init__(self, targets: dict[str, str]):
        self.targets = targets
        self.calls: dict[str, list] = {name: [] for name in targets}
        self._saved: list = []

    def install(self) -> None:
        _port()
        for name, target in self.targets.items():
            mod_name, attr = target.split(":")
            mod = importlib.import_module(mod_name)
            inner = getattr(mod, attr)
            self._saved.append((mod, attr, inner))
            setattr(mod, attr, self._wrap(name, inner))

    def _wrap(self, name: str, inner):
        calls = self.calls[name]

        def timed(*args, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = inner(*args, **kw)
            e1.record()
            shapes = [tuple(a.shape) for a in args
                      if isinstance(a, torch.Tensor)]
            opts = {k: v for k, v in kw.items()
                    if not isinstance(v, torch.Tensor)}
            calls.append(((e0, e1), shapes, opts))
            return out
        return timed

    def clear(self) -> None:
        for calls in self.calls.values():
            calls.clear()

    def uninstall(self) -> None:
        for mod, attr, inner in reversed(self._saved):
            setattr(mod, attr, inner)
        self._saved.clear()

    def read(self) -> dict[str, list]:
        """calls[name] as (ms, shapes, options), after a synchronise."""
        return {name: [(a.elapsed_time(b), shapes, opts)
                       for (a, b), shapes, opts in calls]
                for name, calls in self.calls.items()}


@contextlib.contextmanager
def tapped(target: str):
    """While inside, every call of the program's function `target`
    ("module:function") is kept as (arguments, result): yields that list."""
    _port()
    mod_name, attr = target.split(":")
    mod = importlib.import_module(mod_name)
    inner, calls = getattr(mod, attr), []

    def tap(*args, **kw):
        out = inner(*args, **kw)
        calls.append((args, out))
        return out
    setattr(mod, attr, tap)
    try:
        yield calls
    finally:
        setattr(mod, attr, inner)
