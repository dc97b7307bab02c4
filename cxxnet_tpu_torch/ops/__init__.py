"""The port's hand-written CUDA kernels, each beside its plain version."""

from . import (attention, fused_epilogue, fused_lrn,  # noqa: F401
               fused_norm, fused_optim, fused_pool, fused_quant,
               fused_stem)  # (register kernels)
from .fused import KERNELS, kernels_active, reset_launches

__all__ = ["KERNELS", "kernels_active", "reset_launches"]
