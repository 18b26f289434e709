"""The model zoo (``src/repro/models``): GQA and MLA attention, Mamba2,
the MoE FFN, the xLSTM blocks, the decoder-only assembler with its
training loss and the encoder-decoder."""
from repro_torch.models import (  # noqa: F401
    attention,
    common,
    encdec,
    mamba,
    moe,
    transformer,
    xlstm,
)
