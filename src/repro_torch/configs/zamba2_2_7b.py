"""Config for ``--arch zamba2-2.7b`` (see archs.py for the definition)."""
from repro_torch.configs.archs import zamba2_2_7b as config  # noqa: F401
from repro_torch.configs.archs import zamba2_smoke as smoke_config  # noqa: F401

ARCH_ID = "zamba2-2.7b"
