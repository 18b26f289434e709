"""Synthetic agent data (``src/repro/data``)."""
from repro_torch.data.pipeline import (  # noqa: F401
    SyntheticLMDataset,
    partition_for_agents,
)
