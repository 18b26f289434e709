"""The model zoo's serving path: GQA attention, Mamba2 and the decoder-only
assembler (``src/repro/models``).  MoE, MLA, xLSTM and the
encoder-decoder wait for ROADMAP item 16."""
from repro_torch.models import (  # noqa: F401
    attention,
    common,
    mamba,
    transformer,
)
