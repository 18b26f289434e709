"""The model zoo (``src/repro/models``): GQA attention, Mamba2, the MoE
FFN and the decoder-only assembler with its training loss.  MLA, xLSTM
and the encoder-decoder wait for ROADMAP item 16."""
from repro_torch.models import (  # noqa: F401
    attention,
    common,
    mamba,
    moe,
    transformer,
)
