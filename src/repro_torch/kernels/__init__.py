"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``ops`` holds the dispatch wrappers the model, engine and cache simulator
call; ``decode_attention``, ``sampling`` and ``cache_sim`` hold each
kernel's plain version and its ctypes launcher; ``_build`` compiles
``csrc/*.cu`` at first use.
"""
