"""One run of one cell: set-up, warm-up, the measured window, the check.

1. The weights from the seed, on the device, loaded into the port
   (`program.build`), and the prefill entry the server runs.
2. `warmup_batches` batches of the cell's own shape (separate prompts).
3. The window: a closed loop of batches, back to back, for `seconds`;
   each batch draws its prompts on the device, runs the prefill, takes
   each prompt's first token (the argmax of its last logits) and waits for
   the device. The last batch ends the window. A sample of the batches,
   drawn from the seed, keeps its outputs for the check.
4. With `trace`, the per-layer readings: CUDA events around each prefill
   of the window and around each call of the functions the cell's metric
   readers name, then `torch.profiler` over a stretch of whole batches
   after the window.
5. The peak memory is read. For a routed block kind each kept batch runs
   again through the program with its routing tapped (`check`), and how
   that routing spread the load is printed (`blocks/<kind>.load_spread`).
   The program is freed, the weights drawn again, and the kept batches
   compared with the reference (`check`).
"""
from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time

import torch
from torch.profiler import record_function

from . import check, program
from .inputs import Prompts, Sample, Weights, block_module
from .spec import Spec, reader

STRETCH_S = 2.0         # the profiled stretch: whole batches, about this long
STRETCH_MAX = 16        # batches at most


@dataclasses.dataclass
class Readings:
    """What a per-layer metric reader reads."""
    config: dict
    traffic: dict
    batches: int
    window_s: float
    prefill_ms: list        # per batch, CUDA events around the prefill
    calls: dict             # probe -> [(ms, arg shapes, options)]
    profile: dict           # `trace.Stretch.summary()`


def _kept(prompts, logits, tokens, cache) -> dict:
    """A batch the sample keeps; its logits copied out of the whole (B, S,
    V) they are a view of."""
    return {"prompts": prompts, "logits": logits.clone(), "tokens": tokens,
            "cache": cache}


def _differ(a, b) -> int:
    """Tensors of two like trees (tuples, dicts) that differ in a bit, or
    in shape."""
    if isinstance(a, dict):
        return sum(_differ(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return sum(_differ(x, y) for x, y in zip(a, b, strict=True))
    return int(a.shape != b.shape or not torch.equal(a, b))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(spec: Spec, seed: int, seconds: float, trace: bool, *,
        device: torch.device, t0: float, batches: int | None = None,
        fault=None, numbers: dict | None = None) -> dict:
    """The result of one run (the JSON line's object, `check` last). `t0`:
    the `time.perf_counter()` reading at which the process started.
    `batches`: run at least that many batches (tests). `fault(prefill)
    -> prefill` breaks the timed path (tests). `numbers`, if given, gets
    everything the check read (calibration)."""
    config, traffic = spec.config, spec.traffic
    c = config["config"]
    B, P = traffic["batch"], traffic["prompt_len"]
    if traffic["loop"] != "closed" or traffic["gen"] != 1:
        raise SystemExit(f"traffic {traffic}: only closed-loop prefill "
                         f"(gen 1) is generated")

    phases = [("start", time.perf_counter())]
    weights = Weights(config, seed, device)
    _sync(device)
    phases.append(("weights", time.perf_counter()))
    model, prefill = program.build(config, weights, device)
    del weights
    phases.append(("load", time.perf_counter()))
    if fault is not None:
        prefill = fault(prefill)

    def step(prompts):
        logits, cache = prefill(model, prompts)
        return logits, logits.argmax(dim=-1), cache

    readers = {m["name"]: reader(m["name"]) for m in spec.per_layer} \
        if trace else {}
    probes = program.Probes({k: v for r in readers.values()
                             for k, v in r.PROBES.items()})
    if trace:
        probes.install()
    warm = Prompts(seed, "warmup", c["vocab_size"], B, P, device)
    for _ in range(traffic["warmup_batches"]):
        step(warm.next())
        _sync(device)
    del warm
    probes.clear()
    phases.append(("warm-up", time.perf_counter()))

    stream = Prompts(seed, "prompts", c["vocab_size"], B, P, device)
    sample = Sample(seed, spec.limits["check_batches"])
    profile, events = {}, []
    _sync(device)
    t_w0 = time.perf_counter()
    setup_s = t_w0 - t0
    n, t_end, ends = 0, t_w0, []
    while t_end - t_w0 < seconds or (batches and n < batches):
        with record_function("portbench.batch"):
            prompts = stream.next()
            if trace:
                e = (torch.cuda.Event(enable_timing=True),
                     torch.cuda.Event(enable_timing=True))
                e[0].record()
            logits, tokens, cache = step(prompts)
            if trace:
                e[1].record()
                events.append(e)
            _sync(device)
        t_end = time.perf_counter()
        ends.append(t_end)
        n += 1
        sample.offer(_kept, prompts, logits, tokens, cache)
        del logits, tokens, cache
    window_s = t_end - t_w0
    took = sorted(b - a for a, b in zip([t_w0] + ends, ends))
    calls = probes.read()
    probes.uninstall()
    if trace:
        # whole batches, as many as take about STRETCH_S at the window's
        # median batch time
        n_prof = min(STRETCH_MAX, max(1, math.ceil(
            STRETCH_S / max(took[len(took) // 2], 1e-3))))
        # the profiled stretch follows the window, so that the profiler's
        # own work at its end is not in the window's time
        from .trace import Stretch
        with Stretch() as stretch:
            for _ in range(n_prof):
                with record_function("portbench.batch"):
                    step(stream.next())
                    _sync(device)
        profile = stretch.summary()
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0

    per_layer = {}
    if trace:
        r = Readings(config, traffic, n, window_s,
                     [a.elapsed_time(b) for a, b in events], calls, profile)
        for m in spec.per_layer:
            value = readers[m["name"]].read(r)
            if value is not None:
                per_layer[m["name"]] = {"value": value, "unit": m["unit"]}

    # a routed block kind: each kept batch again, its routing tapped
    kept, load = sample.items(), None
    kind = block_module(config["block_kind"])
    if hasattr(kind, "TAP"):
        for item in kept:
            with program.tapped(kind.TAP) as taps:
                logits, _, cache = step(item["prompts"])
                _sync(device)
            item["replay_diff"] = _differ((logits, cache),
                                          (item["logits"], item["cache"]))
            routing = kind.routing(taps, c, config["layers"])
            if routing and routing[0]["topi"].shape[:2] != (B, P):
                routing = None
            item["routing"] = routing
            del taps, logits, cache
        if all(item["routing"] for item in kept):
            load = kind.load_spread([item["routing"] for item in kept], c)

    # the check, with the program freed and the weights drawn again
    del model, prefill, stream, sample, step
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    weights = Weights(config, seed, device)
    found = check.compare(config, weights, check.ProgramOutputs(config, kept))
    correct, shown = check.judge(found, spec.limits)
    if numbers is not None:
        numbers.update(found)
    del weights, kept
    ref_s = time.perf_counter() - t_ref

    e2e = {"prefill_tokens_s": n * B * P / window_s, "setup_s": setup_s}
    units = {m["name"]: m["unit"] for m in spec.end_to_end}
    metrics = per_layer if trace else {
        name: {"value": e2e[name], "unit": units[name]} for name in units}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    if trace:
        dev["busy_s"] = profile["busy_s"]
        dev["window_s"] = profile["window_s"]
    print(f"portbench {spec.cell} seed {seed}: {n} batches of {B} x {P} "
          f"in {window_s:.3f} s (first {1e3 * (ends[0] - t_w0):.1f} ms, "
          f"median {1e3 * took[len(took) // 2]:.1f} ms), set-up "
          f"{setup_s:.3f} s, peak {peak} B, check of {found['prompts']} "
          f"prompts in {ref_s:.3f} s", file=sys.stderr)
    print("portbench set-up: " + ", ".join(
        f"{name} {b - a:.3f} s" for (name, b), (_, a) in zip(
            phases, [("", t0)] + phases)), file=sys.stderr)
    if load is not None:
        print(f"portbench routing of the checked batches: {load}",
              file=sys.stderr)
    result = {"correct": correct, "attempted": n * B, "failed": 0,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": profile["device_ops"],
                               "idle_gaps": profile["idle_gaps"]}
    if load is not None:
        result["routing"] = load
    result["check"] = shown
    return result
