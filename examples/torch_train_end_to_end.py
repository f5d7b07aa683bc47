"""End-to-end training with the PyTorch/CUDA port: platform -> snapshot ->
train a ~100M-parameter model, with checkpoints (and, with ``--kill-at``, a
restart) through the dataset manager.  The port's counterpart of
``examples/train_end_to_end.py``.

The ~100M config is the stablelm family reduced to 8 layers of width 512
(the same code path as the full config); ``--layers`` and ``--d-model`` cut
it further.  On the CUDA card by default; ``--device cpu`` trains on the CPU.

Run:  PYTHONPATH=src python examples/torch_train_end_to_end.py [--steps 200]
          [--device cpu] [--kill-at 100]
"""

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import repro_torch.configs as configs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--kill-at", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    args = ap.parse_args(argv)

    D = args.d_model
    cfg = dataclasses.replace(
        get_config("stablelm-1.6b"), n_layers=args.layers, d_model=D,
        n_heads=8, n_kv_heads=8, head_dim=D // 8, d_ff=4 * D, vocab_size=512)
    print(f"training config: {cfg.n_params() / 1e6:.1f}M params (stablelm family)")
    # register the reduced config under an arch id of its own
    configs._MODULES["stablelm-100m"] = type(
        "M", (), {"CONFIG": cfg, "smoke_config": staticmethod(lambda: cfg)})

    argv = ["--arch", "stablelm-100m", "--steps", str(args.steps),
            "--batch", "8", "--seq-len", "128", "--lr", "1e-3",
            "--checkpoint-every", str(args.checkpoint_every), "--log-every", "20",
            "--device", args.device]
    if args.kill_at:
        argv += ["--kill-at", str(args.kill_at)]
    out = train_mod.main(argv)
    assert out["improved"], "loss did not improve"
    stats = out["loader_stats"]
    print(f"loader stats: mode={stats['mode']} "
          f"wait_fraction={stats['wait_fraction']:.3f} "
          f"batches={int(stats['batches'])} "
          f"pages_streamed={int(stats['pages_streamed'])} "
          f"peak_resident_ids={int(stats['peak_resident_ids'])}")
    print("OK: end-to-end training improved the loss and checkpointed "
          "through the platform")


if __name__ == "__main__":
    main()
