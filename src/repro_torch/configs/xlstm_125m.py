"""Config for ``--arch xlstm-125m`` (see archs.py for the definition)."""
from repro_torch.configs.archs import xlstm_125m as config  # noqa: F401
from repro_torch.configs.archs import xlstm_smoke as smoke_config  # noqa: F401

ARCH_ID = "xlstm-125m"
