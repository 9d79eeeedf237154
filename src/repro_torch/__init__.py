"""PyTorch/CUDA port of the ``repro`` serve path.

The package mirrors ``repro`` module for module (``configs``, ``models``,
``kernels``, ``serve``, ``launch``) and imports neither JAX nor anything of
``repro``.  Its hot-path kernels are CUDA C++ under ``csrc/``, built for
``sm_90a`` at first use (``kernels/_build.py``).
"""
