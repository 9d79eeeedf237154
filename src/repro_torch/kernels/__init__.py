"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``ops`` holds the dispatch wrappers the model and engine call;
``decode_attention`` and ``sampling`` hold each kernel's plain version and
its ctypes launcher; ``_build`` compiles ``csrc/*.cu`` at first use.
"""
