"""gridmm_tpu_torch: the PyTorch/CUDA port of gridmm_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout (config, ops, models, train, serve, utils)
and imports nothing of JAX. Entry points run on "cuda" unless the caller
passes device="cpu"; on a CUDA tensor an op with a hand-written kernel
(csrc/) always launches it, on a CPU tensor it runs its plain PyTorch
version.
"""
