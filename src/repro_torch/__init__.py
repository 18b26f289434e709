"""PyTorch port of LT-ADMM-CC for NVIDIA Hopper (H100).

Laid out like the JAX package ``repro``, which stays the reference.  The
port imports neither JAX nor anything of ``repro``.  Entry points run on
the card (``device="cuda"``) unless the caller asks for the CPU, where
every kernel wrapper takes its plain PyTorch version.
"""
