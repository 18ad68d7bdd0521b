"""PyTorch/CUDA port of the O-POPE reproduction (the JAX package ``repro`` is
the reference). Same module layout: ``configs``, ``kernels``, ``models``,
``serve``, ``launch``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``."""
