"""Config for ``--arch seamless-m4t-medium`` (see archs.py for the definition)."""
from repro_torch.configs.archs import seamless_m4t_medium as config  # noqa: F401
from repro_torch.configs.archs import seamless_smoke as smoke_config  # noqa: F401

ARCH_ID = "seamless-m4t-medium"
