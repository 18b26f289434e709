"""Config registry: the assigned architectures and input shapes
(``src/repro/configs``).  ``input_specs``, the dry-run's abstract inputs,
waits for ROADMAP item 17."""
from repro_torch.configs.archs import (  # noqa: F401
    ARCHS,
    LONG_CONTEXT_WINDOW,
    ArchDef,
)
from repro_torch.configs.shapes import SHAPES, InputShape  # noqa: F401
