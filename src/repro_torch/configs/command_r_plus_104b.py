"""Config for ``--arch command-r-plus-104b`` (see archs.py for the definition)."""
from repro_torch.configs.archs import command_r_plus_104b as config  # noqa: F401
from repro_torch.configs.archs import command_r_smoke as smoke_config  # noqa: F401

ARCH_ID = "command-r-plus-104b"
