"""Framework-free cost models of the port (``roofline``; ``engine`` and
``tiling``, the paper's cycle model and tile ranking, copied from the
reference and held equal to it; they model the paper's engine, not the
H100, and the tuner does not use them)."""
