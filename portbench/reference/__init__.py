"""Plain PyTorch references of what the benchmark's cells compute, in
float32 with TF32 off, written from the architectures' equations.  They
import neither ``jax`` nor the JAX package nor anything of the program, and
take nothing the program made: the benchmark hands them the weights and
inputs it made itself, and the program's outputs only to judge them."""
