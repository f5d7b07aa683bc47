"""Batched serving with the PyTorch/CUDA port: prefill a batch of prompts and
decode greedily, across three architecture families (attention KV cache,
SSM state, hybrid RG-LRU + ring window).  The port's counterpart of
``examples/serve_batched.py``.

On the CUDA card by default (the prefill runs the hand-written kernels);
``--device cpu`` runs their plain versions.

Run:  PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import serve as serve_mod  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for arch in ["stablelm-1.6b", "mamba2-1.3b", "recurrentgemma-9b"]:
        print(f"\n=== {arch} (smoke config) ===")
        out = serve_mod.main(["--arch", arch, "--smoke", "--batch", "4",
                              "--prompt-len", "32", "--gen", "16",
                              "--device", args.device])
        assert out["tokens"].shape == (4, 16)
    print("\nOK: batched serving across families")


if __name__ == "__main__":
    main()
