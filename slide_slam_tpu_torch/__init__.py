"""PyTorch/CUDA port of slide_slam_tpu for NVIDIA Hopper (sm_90a).

A package of its own beside the JAX package, with the same subpackage and
module names; it imports torch and numpy, never jax or slide_slam_tpu.
Entry points take a `device` argument (default "cuda"); on a CPU tensor the
hand-written kernels' plain PyTorch versions run instead.
"""
