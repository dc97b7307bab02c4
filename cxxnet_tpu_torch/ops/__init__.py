"""The port's hand-written CUDA kernels, each beside its plain version."""

from . import (fused_epilogue, fused_norm, fused_optim,  # noqa: F401
               fused_pool)                 # (register kernels)
from .fused import KERNELS, kernels_active, reset_launches

__all__ = ["KERNELS", "kernels_active", "reset_launches"]
