"""End-to-end driver: distributed LM training with LT-ADMM-CC on the
port, the counterpart of ``examples/train_lm_admm.py``.

Four agents with heterogeneous data shards train a transformer by local
SVRG steps and 8-bit compressed ring messages (the qwen3-0.6b smoke
config), then write the consensus model to a checkpoint under the
temporary directory.  Runs on the card by default:

    PYTHONPATH=src python -m repro_torch.train_lm_admm --rounds 30
    PYTHONPATH=src python -m repro_torch.train_lm_admm --device cpu
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
    if args.full_100m:
        raise NotImplementedError(
            "--full-100m trains xlstm-125m, whose mLSTM and sLSTM blocks "
            "wait for ROADMAP item 16")
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--rounds", str(args.rounds),
            "--agents", "4", "--compressor", "qbit", "--bits", "8",
            "--checkpoint",
            os.path.join(tempfile.gettempdir(), "ltadmm_lm_ckpt")]
    if args.device is not None:
        argv += ["--device", args.device]
    return train.main(argv)


if __name__ == "__main__":
    main()
