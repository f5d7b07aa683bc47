"""Data governance with the PyTorch/CUDA port: train on a snapshot,
checkpoint through the platform, then revoke a raw record and see every
downstream artifact, the model checkpoint included, flagged through lineage.
The port's counterpart of ``examples/governance_lineage.py``.

On the CUDA card by default; ``--device cpu`` trains on the CPU.

Run:  PYTHONPATH=src python examples/torch_governance_lineage.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import train as train_mod  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = train_mod.main(["--arch", "mamba2-1.3b", "--smoke", "--steps", "10",
                          "--batch", "4", "--seq-len", "64",
                          "--checkpoint-every", "5", "--log-every", "5",
                          "--device", args.device])
    plat = out["platform"]

    victim = plat.dataset("corpus/raw").plan(actor="auditor").record_ids()[0]
    print(f"\nrevoking raw record {victim!r} ...")
    report = plat.revoke(victim, actor="admin", reason="user deletion request")
    print(f"  versions rewritten : {len(report.affected_versions)}")
    print(f"  blobs erased       : {len(report.blobs_deleted)}")
    print(f"  snapshots flagged  : {len(report.downstream_snapshots)}")
    print(f"  checkpoints flagged: {len(report.downstream_checkpoints)}")
    print(f"  other downstream   : {len(report.downstream_other)}")
    assert report.downstream_checkpoints or report.downstream_other, \
        "training checkpoints must be reachable from the revoked record"
    print("\nOK: the checkpoint that ingested the revoked record is "
          "identified for retraining/retirement")


if __name__ == "__main__":
    main()
