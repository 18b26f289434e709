"""Perf iteration: traces one (arch x shape) with a variant stack
and prints the roofline terms, in the same fake world as the dry-run (the
counterpart of ``src/repro/launch/hillclimb.py``).

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --arch command-r-plus-104b --shape train_4k \\
        --variant '{"xent_chunks": 8}' --out results/torch_hc.jsonl
"""
from __future__ import annotations

import argparse
import json

from repro_torch.launch.dryrun import dryrun_one


def summary(rec: dict, tag: str = "") -> dict:
    """The reference's summary keys of one dry-run record."""
    return {
        "tag": tag,
        "variant": rec["variant"],
        "t_compute_s": rec["roofline"]["t_compute_s"],
        "t_memory_s": rec["roofline"]["t_memory_s"],
        "t_collective_s": rec["roofline"]["t_collective_s"],
        "dominant": rec["roofline"]["dominant"],
        "mem_v1_bytes": rec["ops"]["memory_bytes"],
        "mem_v2_bytes": rec["ops"].get("memory_bytes_w2"),
        "coll_bytes": rec["ops"]["collective_bytes"],
        "dot_flops": rec["ops"]["dot_flops"],
        "live_GB_per_dev": rec["bytes_per_device"]["total_live"] / 1e9,
        "temp_GB_per_dev": rec["bytes_per_device"]["temp"] / 1e9,
        "useful": rec["useful_fraction"],
        "compile_s": rec["compile_s"],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variant", default="{}",
                    help="JSON: xent_chunks/serve_mode/remat/n_layers/"
                         "attn_seq_shard/solver/recipe_*")
    ap.add_argument("--out", default=None)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    variant = json.loads(args.variant)
    rec = dryrun_one(args.arch, args.shape, args.multi_pod,
                     variant=variant, verbose=False)
    rec["tag"] = args.tag
    out = summary(rec, args.tag)
    print(json.dumps(out, indent=1, default=str))
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(rec, default=str) + "\n")
    return out


if __name__ == "__main__":
    main()
