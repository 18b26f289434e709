"""Config for ``--arch olmo-1b`` (see archs.py for the definition)."""
from repro_torch.configs.archs import olmo_1b as config  # noqa: F401
from repro_torch.configs.archs import olmo_smoke as smoke_config  # noqa: F401

ARCH_ID = "olmo-1b"
