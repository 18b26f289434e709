"""Config for ``--arch qwen2-1.5b`` (see archs.py for the definition)."""
from repro_torch.configs.archs import qwen2_1_5b as config  # noqa: F401
from repro_torch.configs.archs import qwen2_smoke as smoke_config  # noqa: F401

ARCH_ID = "qwen2-1.5b"
