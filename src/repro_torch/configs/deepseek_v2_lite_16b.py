"""Config for ``--arch deepseek-v2-lite-16b`` (see archs.py for the definition)."""
from repro_torch.configs.archs import deepseek_v2_lite as config  # noqa: F401
from repro_torch.configs.archs import deepseek_smoke as smoke_config  # noqa: F401

ARCH_ID = "deepseek-v2-lite-16b"
