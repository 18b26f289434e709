"""The model zoo (``src/repro/models``): GQA and MLA attention, Mamba2,
the MoE FFN, the xLSTM blocks and the decoder-only assembler with its
training loss.  The encoder-decoder waits for ROADMAP item 16."""
from repro_torch.models import (  # noqa: F401
    attention,
    common,
    mamba,
    moe,
    transformer,
    xlstm,
)
