"""Config registry: the assigned architectures and input shapes
(``src/repro/configs``).

``input_specs(arch_id, shape_name, n_agents)`` returns the ``meta``
stand-ins (``common.trees.meta_like``: shape and dtype, no storage) for
every model input of the traced step; the dry-run (``launch.dryrun``)
composes them with the abstract parameters and caches, so nothing is
allocated.

Train inputs carry a leading agent axis ``[A, m_local, ...]`` in
LT-ADMM-CC mode (``m_local = global_batch / A`` is each agent's local
dataset for one outer round); ``n_agents=None`` gives the flat
all-reduce-baseline layout.
"""
from __future__ import annotations

import torch

from repro_torch.common.trees import meta_like
from repro_torch.configs.archs import (  # noqa: F401
    ARCHS,
    LONG_CONTEXT_WINDOW,
    ArchDef,
)
from repro_torch.configs.shapes import SHAPES, InputShape  # noqa: F401

SRC_FRAMES_RATIO = 4  # enc-dec: source frames = seq_len // 4 (audio stub)


def _lead(shape_tuple, batch, n_agents):
    """Prepend the agent / local-batch layout to a per-example shape."""
    if n_agents is None:
        return (batch,) + shape_tuple
    if batch % n_agents:
        raise ValueError(f"global batch {batch} does not split over "
                         f"{n_agents} agents")
    return (n_agents, batch // n_agents) + shape_tuple


def input_specs(arch_id: str, shape_name: str, n_agents=None) -> dict:
    """Data inputs of the traced step (params and cache are separate):
    ``{name: meta tensor}`` with the reference's shapes and dtypes."""
    arch = ARCHS[arch_id]
    shape = SHAPES[shape_name]
    cfg = arch.make(shape_name)
    b, t = shape.global_batch, shape.seq_len
    tok = torch.int32

    if arch.kind == "encdec":
        s_src = t // SRC_FRAMES_RATIO
        if shape.kind == "train":
            return {
                "src_embeds": meta_like(
                    _lead((s_src, cfg.d_model), b, n_agents), cfg.dtype),
                "tgt_tokens": meta_like(_lead((t + 1,), b, n_agents), tok),
            }
        if shape.kind == "prefill":
            return {"src_embeds": meta_like((b, s_src, cfg.d_model),
                                            cfg.dtype),
                    "tgt_tokens": meta_like((b, t), tok)}
        # decode: the encoder memory is a precomputed input
        return {"memory": meta_like((b, s_src, cfg.d_model), cfg.dtype),
                "token": meta_like((b,), tok), "pos": meta_like((), tok)}

    if cfg.inputs_via_embeds:
        if shape.kind == "train":
            return {"embeds": meta_like(_lead((t, cfg.d_model), b, n_agents),
                                        cfg.dtype),
                    "labels": meta_like(_lead((t,), b, n_agents), tok)}
        if shape.kind == "prefill":
            return {"embeds": meta_like((b, t, cfg.d_model), cfg.dtype)}
        return {"token": meta_like((b,), tok), "pos": meta_like((), tok)}

    if shape.kind == "train":
        return {"tokens": meta_like(_lead((t + 1,), b, n_agents), tok)}
    if shape.kind == "prefill":
        return {"tokens": meta_like((b, t), tok)}
    return {"token": meta_like((b,), tok), "pos": meta_like((), tok)}
