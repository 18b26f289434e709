"""Serving entry point: batched greedy decoding against the KV/SSM cache (the
counterpart of ``src/repro/launch/serve.py``, flag for flag, plus
``--device``; the default is the card).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --smoke --device cpu --batch 4 --prompt-len 8 --gen 16

The prompt is prefilled token by token through the decode step, as the
reference does.  For the encoder-decoder (seamless-m4t-medium) the
"prompt" is ``--prompt-len`` source frames drawn as normals from the
weights' key; they are encoded once, and the decoder starts from token 0
at position 0 and generates ``--gen`` tokens.  Unlike the reference,
which draws f32 weights whatever the config says (and so cannot serve a
bf16 config: its f32 keys meet a bf16 cache), the weights are drawn in
``cfg.dtype``, as the reference's prefill and dry-run steps do.  Without
a card and without ``--device cpu``, ``main`` raises.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCHS
from repro_torch.core import jaxrand
from repro_torch.device import resolve_device
from repro_torch.launch.steps import build_serve, model_specs
from repro_torch.models import encdec
from repro_torch.models import transformer as tr
from repro_torch.models.common import init_params


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(arch, cfg, params, prompt, gen: int, mesh=None):
    """Greedy decoding.  Returns ``(tokens [B, gen], seconds of the
    generation loop)``.  With a ``mesh`` the decoder-only models decode
    tensor-parallel over its "model" axis and FSDP over its "data" axis
    (``steps.build_serve``): ``params`` is then the rank's shard
    (``steps.serve_shard``) and ``prompt`` the rank's rows
    (``steps.batch_rows``); every rank of the "model" axis takes the
    argmax of the gathered logits, so they keep the same tokens (ties to
    the first index, as the reference's).

    Decoder-only models: ``prompt [B, P]`` token ids are fed token by
    token through the decode step, then ``gen`` tokens are generated.
    The encoder-decoder: ``prompt [B, P, d]`` are source embeddings,
    encoded once (``encdec.encode``) into the memory whose cross K/V the
    cache holds (its length ``P + gen``); the decoder starts from token 0
    at position 0 and takes ``gen`` greedy steps (the reference's
    ``launch/serve.py`` encdec loop)."""
    if arch.kind == "encdec":
        return _generate_encdec(arch, cfg, params, prompt, gen)
    serve, init_cache = build_serve(arch, cfg, mesh)
    b, plen = prompt.shape
    dev = prompt.device
    cache = init_cache(b, plen + gen, dev)
    with torch.no_grad():
        for pos in range(plen - 1):
            _, cache = serve(params, cache, {"token": prompt[:, pos],
                                             "pos": pos})
        tokens = prompt[:, -1]
        generated = []
        sync(dev)
        t0 = time.perf_counter()
        for pos in range(plen - 1, plen - 1 + gen):
            logits, cache = serve(params, cache, {"token": tokens,
                                                  "pos": pos})
            tokens = torch.argmax(logits[:, 0], dim=-1)
            generated.append(tokens)
        out = torch.stack(generated, dim=1)
        sync(dev)
    return out, time.perf_counter() - t0


def _generate_encdec(arch, cfg, params, src, gen: int):
    serve, init_cache = build_serve(arch, cfg)
    b, plen = src.shape[0], src.shape[1]
    dev = src.device
    with torch.no_grad():
        memory = encdec.encode(params, cfg, src)
        cache = init_cache(params, memory, plen + gen)
        tokens = torch.zeros((b,), dtype=torch.long, device=dev)
        generated = []
        sync(dev)
        t0 = time.perf_counter()
        for pos in range(gen):
            logits, cache = serve(params, cache, {"token": tokens,
                                                  "pos": pos})
            tokens = torch.argmax(logits[:, 0], dim=-1)
            generated.append(tokens)
        out = torch.stack(generated, dim=1)
        sync(dev)
    return out, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    arch = ARCHS[args.arch]
    cfg = arch.make_smoke() if args.smoke else arch.make(None)
    # one key for the weights and the prompt, as the reference uses
    key = jaxrand.key(args.seed, dev)
    tree = init_params(key, model_specs(arch, cfg), dtype=cfg.dtype)
    if arch.kind == "encdec":
        params = tree
        prompt = jaxrand.normal(key, (args.batch, args.prompt_len,
                                      cfg.d_model))
    else:
        params = tr.model_params(cfg, tree)
        prompt = jaxrand.randint(key, (args.batch, args.prompt_len), 0,
                                 cfg.vocab)
    out, secs = generate(arch, cfg, params, prompt, args.gen)
    print(f"# generated {tuple(out.shape)} in {secs:.2f}s "
          f"({args.batch * args.gen / secs:.1f} tok/s, decode only) on "
          f"{dev}")
    for row in out[: min(args.batch, 4)].tolist():
        print("tokens:", " ".join(str(t) for t in row))
    return out


if __name__ == "__main__":
    main()
