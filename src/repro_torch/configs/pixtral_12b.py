"""Config for ``--arch pixtral-12b`` (see archs.py for the definition)."""
from repro_torch.configs.archs import pixtral_12b as config  # noqa: F401
from repro_torch.configs.archs import pixtral_smoke as smoke_config  # noqa: F401

ARCH_ID = "pixtral-12b"
