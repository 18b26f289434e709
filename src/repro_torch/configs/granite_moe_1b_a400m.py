"""Config for ``--arch granite-moe-1b-a400m`` (see archs.py for the definition)."""
from repro_torch.configs.archs import granite_moe_1b as config  # noqa: F401
from repro_torch.configs.archs import granite_moe_smoke as smoke_config  # noqa: F401

ARCH_ID = "granite-moe-1b-a400m"
