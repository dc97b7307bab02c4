"""Selection and launch bookkeeping of the port's hand-written kernels.

Selection contract:

* ``fused_kernels = auto`` (default) and ``fused_kernels = 1``: a layer
  hands its tensor to the kernel wrapper. The wrapper launches the CUDA
  kernel on a CUDA tensor, or raises when the kernel does not take the
  input. It computes the plain PyTorch version only for a tensor on the
  CPU, where no kernel can run.
* ``fused_kernels = 0``: the layers compute the plain versions on any
  device. An explicit choice, printed once when an engine starts.
* env ``CXXNET_FUSED_KERNELS`` overrides the config knob with the same
  values.

Nothing falls back: a build or launch failure raises.

Each kernel is a :class:`Kernel`: its CUDA source under ``csrc/``, the
C function it exports, the TPU kernel it replaces, and a plain-int count
of its launches, which grows by one where its wrapper launches it and
nowhere else.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Any, Callable, Dict, List, Tuple

import torch

from ..config import parse_fused_mode

resolve_mode = parse_fused_mode

#: dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def kernels_active(mode: str) -> bool:
    """Whether layers hand their tensors to the kernel wrappers. The
    ``CXXNET_FUSED_KERNELS`` env var wins over the config knob."""
    env = os.environ.get("CXXNET_FUSED_KERNELS", "")
    if env:
        mode = resolve_mode(env)
    return mode != "off"


class Kernel:
    """One hand-written CUDA kernel and its launch count."""

    def __init__(self, name: str, source: str, replaces: str,
                 argtypes: List[Any]):
        self.name = name
        self.source = source          # file under csrc/
        self.replaces = replaces      # file:line of the TPU kernel
        self._argtypes = argtypes
        self._fn: Callable = None
        self._errstr: Callable = None
        self._lock = threading.Lock()
        self.launches = 0

    def _bind(self) -> None:
        from . import _build
        lib = _build.load(self.source)
        fn = getattr(lib, self.name)
        fn.argtypes = self._argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, self.name + "_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._errstr = fn, err

    def launch(self, *args) -> None:
        """Call the C entry (building and loading its library on first
        use); raise on a non-zero ``cudaError_t``; count the launch."""
        if self._fn is None:
            with self._lock:
                if self._fn is None:
                    self._bind()
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(
                f"{self.name}: launch failed with cudaError {rc} "
                f"({self._errstr(rc).decode()})")
        with self._lock:
            self.launches += 1


#: every kernel of the port, by name (the op modules register theirs)
KERNELS: Dict[str, Kernel] = {}


def register(kernel: Kernel) -> Kernel:
    KERNELS[kernel.name] = kernel
    return kernel


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS.values():
        with k._lock:
            k.launches = 0


def check_cuda_input(name: str, x: torch.Tensor) -> int:
    """Validate a kernel input; returns its dtype code. Raises on what
    the kernels do not take (the wrappers never fall back)."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        "(float32, bfloat16, float16)")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    return DTYPE_CODES[x.dtype]


def stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as a C pointer value."""
    return torch.cuda.current_stream(device).cuda_stream


_sms: Dict[torch.device, int] = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card ``device``."""
    if device not in _sms:
        _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms[device]


_scratch: Dict[Tuple[torch.device, str],
               Tuple[torch.Tensor, torch.Tensor]] = {}
_scratch_lock = threading.Lock()


def split_scratch(device: torch.device, key: str, nbytes: int, tiles: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The workspace (at least ``nbytes`` bytes) and the int32 per-tile
    arrival counters (at least ``tiles``, zero) of a kernel whose CTAs
    write partials of a tile and whose last CTA to arrive adds them
    (``key``: ``q_mm``'s split of K, ``bn_bwd_sums``'s row blocks),
    cached per device and key. Each launch leaves its counters zero, and
    launches on a device are ordered by its stream."""
    with _scratch_lock:
        ws, cnt = _scratch.get((device, key), (None, None))
        if ws is None or ws.numel() < nbytes:
            ws = torch.empty(nbytes, dtype=torch.uint8, device=device)
        if cnt is None or cnt.numel() < tiles:
            cnt = torch.zeros(max(tiles, 256), dtype=torch.int32,
                              device=device)
        _scratch[(device, key)] = (ws, cnt)
        return ws, cnt


def row_blocks(n: int, c: int) -> int:
    """Row blocks of the first stage of the column sums in
    ``csrc/colsum.cuh`` (BN forward and backward, the epilogue's dbias):
    about eight CTAs per SM of the H100's 132 over the ceil(c/32)
    channel tiles, and at least 64 rows per block."""
    tiles = -(-c // 32)
    return max(1, min(max(1, 1056 // tiles), -(-n // 64)))


def colsum_depth(n: int, c: int) -> int:
    """The longest chain of f32 additions behind one column sum of
    ``csrc/colsum.cuh`` over ``n`` rows: a row lane's share of its row
    block, then the 8 lanes, then the row blocks. A sum so taken is
    within ``depth * 2**-24`` times the sum of its terms' magnitudes of
    the exact sum of its terms."""
    g = row_blocks(n, c)
    rows_per = -(-n // g)
    return -(-rows_per // 8) + 8 + g
