"""PyTorch/CUDA port of ``repro``: the serve path and the DeepNVM++
pipeline.

The package mirrors ``repro`` module for module (``configs``, ``core``,
``models``, ``kernels``, ``serve``, ``optim``, ``data``, ``train``,
``launch``, ``examples``, and the ``tools`` scripts) and imports
neither JAX nor anything of ``repro``.  Its hot-path kernels are CUDA C++
under ``csrc/``, built for ``sm_90a`` at first use (``kernels/_build.py``).
"""
