"""Config for ``--arch qwen3-0.6b`` (see archs.py for the definition)."""
from repro_torch.configs.archs import qwen3_0_6b as config  # noqa: F401
from repro_torch.configs.archs import qwen3_smoke as smoke_config  # noqa: F401

ARCH_ID = "qwen3-0.6b"
