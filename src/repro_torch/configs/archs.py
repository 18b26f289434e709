"""The ten assigned architectures as selectable configs (``--arch <id>``),
the counterpart of ``src/repro/configs/archs.py``.

Every entry cites its source.  ``make(shape)`` returns the FULL config,
``make_smoke()`` a reduced same-family variant that runs a real forward
on the CPU; the smoke configs turn remat off, as the reference's do.
Nine archs are decoder-only (``ModelConfig``); seamless-m4t-medium is the
encoder-decoder (``EncDecConfig``, ``kind="encdec"``).

Full-attention architectures get ``sliding_window=LONG_CONTEXT_WINDOW``
when instantiated for the ``long_500k`` shape (ring-buffer KV cache).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models.attention import AttnConfig, MLAConfig
from repro_torch.models.encdec import EncDecConfig
from repro_torch.models.mamba import SSMConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import ModelConfig
from repro_torch.models.xlstm import XLSTMConfig

LONG_CONTEXT_WINDOW = 4096


@dataclasses.dataclass(frozen=True)
class ArchDef:
    arch_id: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    kind: str  # lm | encdec
    source: str
    make: Callable  # (shape_name | None) -> config
    make_smoke: Callable  # () -> config
    notes: str = ""


def _sw(shape):
    """Sliding window for full-attention archs on the 500k decode shape."""
    return LONG_CONTEXT_WINDOW if shape == "long_500k" else None


def qwen3_0_6b(shape=None):
    return ModelConfig(
        name="qwen3-0.6b", n_layers=28, d_model=1024, vocab=151936,
        d_ff=3072,
        attn=AttnConfig(1024, 16, 8, 128, qk_norm=True, rope_theta=1e6,
                        sliding_window=_sw(shape)),
        tie_embeddings=True, dtype=torch.bfloat16,
    )


def qwen3_smoke():
    return ModelConfig(
        name="qwen3-smoke", n_layers=2, d_model=128, vocab=512, d_ff=256,
        attn=AttnConfig(128, 4, 2, 32, qk_norm=True), remat=False,
    )


def qwen2_1_5b(shape=None):
    return ModelConfig(
        name="qwen2-1.5b", n_layers=28, d_model=1536, vocab=151936,
        d_ff=8960,
        attn=AttnConfig(1536, 12, 2, 128, qkv_bias=True, rope_theta=1e6,
                        sliding_window=_sw(shape)),
        tie_embeddings=True, dtype=torch.bfloat16,
    )


def qwen2_smoke():
    return ModelConfig(
        name="qwen2-smoke", n_layers=2, d_model=96, vocab=512, d_ff=192,
        attn=AttnConfig(96, 6, 2, 16, qkv_bias=True), remat=False,
    )


def olmo_1b(shape=None):
    return ModelConfig(
        name="olmo-1b", n_layers=16, d_model=2048, vocab=50304, d_ff=8192,
        attn=AttnConfig(2048, 16, 16, 128, sliding_window=_sw(shape)),
        norm="nonparam_ln", tie_embeddings=True, dtype=torch.bfloat16,
    )


def olmo_smoke():
    return ModelConfig(
        name="olmo-smoke", n_layers=2, d_model=128, vocab=512, d_ff=512,
        attn=AttnConfig(128, 4, 4, 32), norm="nonparam_ln", remat=False,
    )


def command_r_plus_104b(shape=None):
    return ModelConfig(
        name="command-r-plus-104b", n_layers=64, d_model=12288,
        vocab=256000, d_ff=33792,
        attn=AttnConfig(12288, 96, 8, 128, rope_theta=75e6,
                        sliding_window=_sw(shape)),
        parallel_block=True, tie_embeddings=True, dtype=torch.bfloat16,
    )


def command_r_smoke():
    return ModelConfig(
        name="command-r-smoke", n_layers=2, d_model=256, vocab=512,
        d_ff=704, attn=AttnConfig(256, 8, 2, 32), parallel_block=True,
        remat=False,
    )


def pixtral_12b(shape=None):
    # Pixtral-12B text backbone = Mistral-Nemo-12B style decoder; the
    # pixtral-ViT frontend is a stub (patch embeddings as inputs).
    return ModelConfig(
        name="pixtral-12b", n_layers=40, d_model=5120, vocab=131072,
        d_ff=14336,
        attn=AttnConfig(5120, 32, 8, 128, rope_theta=1e6,
                        sliding_window=_sw(shape)),
        tie_embeddings=False, inputs_via_embeds=True, dtype=torch.bfloat16,
    )


def pixtral_smoke():
    return ModelConfig(
        name="pixtral-smoke", n_layers=2, d_model=128, vocab=512, d_ff=256,
        attn=AttnConfig(128, 4, 2, 32), tie_embeddings=False,
        inputs_via_embeds=True, remat=False,
    )


def granite_moe_1b(shape=None):
    return ModelConfig(
        name="granite-moe-1b-a400m", n_layers=24, d_model=1024,
        vocab=49155, pattern=("moe",),
        attn=AttnConfig(1024, 16, 8, 64, sliding_window=_sw(shape)),
        moe=MoEConfig(1024, n_experts=32, top_k=8, d_ff_expert=512),
        tie_embeddings=True, dtype=torch.bfloat16,
    )


def granite_moe_smoke():
    return ModelConfig(
        name="granite-moe-smoke", n_layers=2, d_model=128, vocab=512,
        pattern=("moe",), attn=AttnConfig(128, 4, 2, 32),
        moe=MoEConfig(128, n_experts=4, top_k=2, d_ff_expert=64),
        remat=False,
    )


def deepseek_v2_lite(shape=None):
    return ModelConfig(
        name="deepseek-v2-lite-16b", n_layers=27, d_model=2048, vocab=102400,
        pattern=("mla",),
        mla=MLAConfig(2048, 16, kv_lora_rank=512, qk_nope_dim=128,
                      qk_rope_dim=64, v_head_dim=128,
                      sliding_window=_sw(shape)),
        moe=MoEConfig(2048, n_experts=64, top_k=6, d_ff_expert=1408,
                      n_shared=2),
        first_dense=1, d_ff_first=10944, tie_embeddings=True,
        dtype=torch.bfloat16,
    )


def deepseek_smoke():
    return ModelConfig(
        name="deepseek-smoke", n_layers=2, d_model=128, vocab=512,
        pattern=("mla",),
        mla=MLAConfig(128, 4, kv_lora_rank=32, qk_nope_dim=16,
                      qk_rope_dim=8, v_head_dim=16),
        moe=MoEConfig(128, n_experts=4, top_k=2, d_ff_expert=64, n_shared=1),
        first_dense=1, d_ff_first=256, remat=False,
    )


def zamba2_2_7b(shape=None):
    # 54 Mamba2 blocks + one SHARED attention block applied every 6 blocks
    # (the reference's approximation of Zamba2's shared-block scheme).
    return ModelConfig(
        name="zamba2-2.7b", n_layers=54, d_model=2560, vocab=32000,
        pattern=("mamba",) * 6, shared_attn=True, d_ff=10240,
        attn=AttnConfig(2560, 32, 32, 80, sliding_window=_sw(shape)),
        ssm=SSMConfig(2560, d_state=64, head_dim=64),
        tie_embeddings=True, dtype=torch.bfloat16,
    )


def zamba2_smoke():
    return ModelConfig(
        name="zamba2-smoke", n_layers=2, d_model=128, vocab=512,
        pattern=("mamba",) * 2, shared_attn=True, d_ff=256,
        attn=AttnConfig(128, 4, 4, 32),
        ssm=SSMConfig(128, d_state=16, head_dim=32, chunk=32),
        remat=False,
    )


def xlstm_125m(shape=None):
    del shape  # recurrent: no windowing needed at 500k
    return ModelConfig(
        name="xlstm-125m", n_layers=12, d_model=768, vocab=50304,
        pattern=("mlstm",) * 5 + ("slstm",),  # xLSTM[7:1]-ish mix
        lstm=XLSTMConfig(768, n_heads=4), tie_embeddings=True,
        dtype=torch.bfloat16,
    )


def xlstm_smoke():
    return ModelConfig(
        name="xlstm-smoke", n_layers=2, d_model=128, vocab=512,
        pattern=("mlstm", "slstm"), lstm=XLSTMConfig(128, n_heads=2),
        remat=False,
    )


def seamless_m4t_medium(shape=None):
    # speech-encoder + text-decoder backbone; conv/mel frontend stubbed
    return EncDecConfig(
        name="seamless-m4t-medium", n_enc_layers=12, n_dec_layers=12,
        d_model=1024, vocab=256206, d_ff=4096,
        attn=AttnConfig(1024, 16, 16, 64, sliding_window=_sw(shape)),
        dtype=torch.bfloat16,
    )


def seamless_smoke():
    return EncDecConfig(
        name="seamless-smoke", n_enc_layers=2, n_dec_layers=2, d_model=128,
        vocab=512, d_ff=256, attn=AttnConfig(128, 4, 4, 32), remat=False,
    )


ARCHS = {
    a.arch_id: a
    for a in [
        ArchDef("seamless-m4t-medium", "audio", "encdec",
                "arXiv:2308.11596", seamless_m4t_medium, seamless_smoke,
                "enc-dec; audio frontend stubbed (frame embeddings)"),
        ArchDef("qwen3-0.6b", "dense", "lm", "hf:Qwen/Qwen3-8B",
                qwen3_0_6b, qwen3_smoke, "qk-norm, GQA"),
        ArchDef("olmo-1b", "dense", "lm", "arXiv:2402.00838",
                olmo_1b, olmo_smoke, "non-parametric LN"),
        ArchDef("pixtral-12b", "vlm", "lm", "hf:mistralai/Pixtral-12B-2409",
                pixtral_12b, pixtral_smoke,
                "ViT frontend stubbed (patch embeddings)"),
        ArchDef("zamba2-2.7b", "hybrid", "lm", "arXiv:2411.15242",
                zamba2_2_7b, zamba2_smoke, "Mamba2 + shared attention block"),
        ArchDef("granite-moe-1b-a400m", "moe", "lm",
                "hf:ibm-granite/granite-3.0-1b-a400m-base",
                granite_moe_1b, granite_moe_smoke, "32 experts top-8"),
        ArchDef("deepseek-v2-lite-16b", "moe", "lm", "arXiv:2405.04434",
                deepseek_v2_lite, deepseek_smoke,
                "MLA kv_lora=512; 2 shared + 64 routed top-6"),
        ArchDef("xlstm-125m", "ssm", "lm", "arXiv:2405.04517",
                xlstm_125m, xlstm_smoke, "sLSTM + mLSTM blocks"),
        ArchDef("qwen2-1.5b", "dense", "lm", "arXiv:2407.10671",
                qwen2_1_5b, qwen2_smoke, "GQA kv=2, QKV bias"),
        ArchDef("command-r-plus-104b", "dense", "lm",
                "hf:CohereForAI/c4ai-command-r-v01",
                command_r_plus_104b, command_r_smoke,
                "96H GQA kv=8, no-bias, parallel block"),
    ]
}
