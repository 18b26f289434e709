"""End-to-end driver: distributed LM training with LT-ADMM-CC on the
port, the counterpart of ``examples/train_lm_admm.py``.

Four agents with heterogeneous data shards train a transformer by local
SVRG steps and 8-bit compressed ring messages (the qwen3-0.6b smoke
config; ``--full-100m`` the full xlstm-125m config, which ``launch/train``
trains in f32), then write the consensus model to a checkpoint under the
temporary directory.  Runs on the card by default:

    PYTHONPATH=src python -m repro_torch.train_lm_admm --rounds 30
    PYTHONPATH=src python -m repro_torch.train_lm_admm --device cpu

At its initial weights xlstm-125m's sLSTM recurrence gives gradients
past 1e15, so ``--full-100m`` diverges at its first round, in the
reference as here (ROADMAP Queue 3), after drawing ~161 M parameters
and the agents' state (~57 GB in f32).
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.launch import train


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    argv = ["--arch", "xlstm-125m" if args.full_100m else "qwen3-0.6b",
            "--rounds", str(args.rounds), "--agents", "4", "--compressor",
            "qbit", "--bits", "8", "--checkpoint",
            os.path.join(tempfile.gettempdir(), "ltadmm_lm_ckpt")]
    if not args.full_100m:
        argv.append("--smoke")
    if args.device is not None:
        argv += ["--device", args.device]
    return train.main(argv)


if __name__ == "__main__":
    main()
