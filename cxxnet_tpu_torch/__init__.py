"""cxxnet in PyTorch on CUDA: the port of ``cxxnet_tpu`` to an NVIDIA H100.

A package of its own beside the JAX one, which stays the reference: it
imports torch and numpy, and nothing of ``jax`` or ``cxxnet_tpu``.
Node tensors are NHWC at every public function, as in the JAX package.
Entry point: ``python -m cxxnet_tpu_torch.main <conf> task=train|serve ...``.
"""
