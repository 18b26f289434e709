"""Serve a small LM with batched greedy decoding (the KV/SSM-cache path;
the counterpart of ``examples/serve_lm.py``): zamba2-2.7b's smoke config,
batch 4, an 8-token prompt, 16 generated tokens, through
``repro_torch.launch.serve``.

    PYTHONPATH=src python -m repro_torch.serve_lm               # the card
    PYTHONPATH=src python -m repro_torch.serve_lm --device cpu
"""
from __future__ import annotations

import sys

from repro_torch.launch import serve

ARGV = ["--arch", "zamba2-2.7b", "--smoke", "--batch", "4",
        "--prompt-len", "8", "--gen", "16"]


def main(argv=None):
    """``launch.serve.main`` on ARGV; further arguments (``--device``)
    are passed on.  Returns the generated tokens."""
    return serve.main(ARGV + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
