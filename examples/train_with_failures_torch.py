"""End-to-end example on the PyTorch port: train a ~100M-param llama-family
model for a few hundred steps with UniLRC-erasure-coded checkpoints,
inject a node failure mid-run, restore degraded (zero cross-cluster
traffic), reconstruct, and verify the loss curve continues where it left
off.

The port of `examples/train_with_failures.py`: it wraps the port's
launcher (`repro_torch.launch.train`), imports only `repro_torch`, and
runs on the card unless --device cpu is given. Head dim 64: on the card
every attention forward launches the bf16 flash kernel at d = 64.

Run:  PYTHONPATH=src python examples/train_with_failures_torch.py
      [--steps 300] [--device cpu]
"""
import argparse

from repro_torch.launch.train import run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # ~100M-param reduced clone of the llama3 family config: the smoke
    # config scaled up (12 layers, d=768), big enough for a real loss
    # curve
    import repro_torch.configs.llama32_3b as l3
    from repro_torch.models import ModelConfig, uniform_segments
    hundred_m = ModelConfig(
        name="llama-100m", family="dense",
        d_model=768, num_heads=12, num_kv_heads=4,
        d_ff=2048, vocab_size=8192,
        segments=uniform_segments("attn", 12),
        rope_theta=10000.0,
    )
    print(f"params: {hundred_m.param_count() / 1e6:.1f}M")
    smoke, l3.SMOKE = l3.SMOKE, hundred_m   # --smoke resolves to this
    try:
        losses = run([
            "--arch", args.arch, "--smoke",
            "--steps", str(args.steps),
            "--batch", "8", "--seq", "256",
            "--ckpt-every", str(max(10, args.steps // 3)),
            "--fail-node", "5", "--fail-at", str(args.steps * 2 // 3),
            "--straggler-node", "7",
            "--log-every", "20",
            "--device", args.device,
        ])
    finally:
        l3.SMOKE = smoke
    n = len(losses)
    first, mid, last = losses[0], losses[n // 2], losses[-1]
    print(f"\nloss: {first:.3f} -> {mid:.3f} -> {last:.3f}")
    assert last < first - 0.3, "model did not learn"
    print("train-with-failures OK")
    return losses


if __name__ == "__main__":
    main()
