"""InferenceEngine: a loaded Network behind a bucket ladder of batch sizes
(the port of ``cxxnet_tpu/serve/engine.py``).

Request batches are padded up to the smallest bucket of a small ladder
(explicit ``serve_buckets``, or powers of two up to ``max_batch``), run
as one forward, and sliced back, so a dispatch only ever sees a few
batch shapes. The engine keeps an LRU of per-cell runners keyed by
``(bucket, kind, node)``, as the JAX package keys its compiled
executables; the hit/miss/evict counters feed ``/statz``.

Eval-mode rows are independent (batch_norm uses its running statistics
at eval), so zero rows padded up to the bucket cannot perturb the real
rows.

Weights are cast to the compute dtype once at load (Network.weights_for);
responses leave as float32. ``dtype = "int8"`` serves a PTQ-derived round
through the int8 kernel (``ops/fused_quant``), everything else in
float32, as version ``rNNNN-int8``; an fp engine dequantizes a quantized
round on load (:func:`negotiate_blob`).

:meth:`InferenceEngine.swap_weights` is the hot-reload primitive of the
fleet (``serve/reload.py``): it places and casts a verified round
outside the network's ``weights_lock``, then installs params, state and
the version labels under it, so a dispatch runs wholly on the old
weights or wholly on the new. An int8 engine never swaps in a plain
round, nor an fp engine a quantized one.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .. import checkpoint as ckpt
from ..config import ConfigPairs, parse_config_string, parse_policy
from ..convert import params_from_jax
from ..graph import build_graph
from ..model import Network
from ..quant import dequantize_blob, is_quantized_params
from ..resilience import failpoints
from ..telemetry.trace import TRACER
from .stats import ServingStats

# output kinds mirroring the cxxnet task modes pred / pred_raw / extract
_KINDS = ("predict", "raw", "extract")


def version_name(round_counter: int) -> str:
    """Model-version id of a checkpoint round (the ``%04d.model`` name)."""
    return "r%04d" % int(round_counter)


def negotiate_blob(blob, dtype: Optional[str]):
    """Dtype negotiation between a loaded round and the engine's serving
    dtype (the JAX package's rules):

    - ``int8`` engine + quantized round: served as it is (the int8 path);
    - ``int8`` engine + plain round: raises, since quantizing on the fly
      would skip calibration and the drift verdict;
    - fp engine + quantized round: dequantized on load (the scales folded
      back into f32 ``wmat``), served at fp cost;
    - fp engine + plain round: passed through.
    """
    want_int8 = bool(dtype) and str(dtype).lower() == "int8"
    quantized = is_quantized_params(blob["params"])
    if want_int8 and not quantized:
        raise ValueError(
            "serve_dtype=int8 but the checkpoint round is not "
            "quantized (no __quant_meta__/wmat_scale leaves); run "
            "tools/quantize.py to derive an int8 round first")
    if quantized and not want_int8:
        return dequantize_blob(blob)
    return blob


def _parse_buckets(val: Union[str, Sequence[int], None],
                   max_batch: int) -> List[int]:
    """Bucket ladder: explicit comma list, or powers of two from 1 up to
    ``max_batch``."""
    if val:
        if isinstance(val, str):
            buckets = sorted({int(x) for x in val.split(",") if x.strip()})
        else:
            buckets = sorted({int(x) for x in val})
    else:
        buckets = []
        b = 1
        while b < max_batch:
            buckets.append(b)
            b *= 2
        buckets.append(max_batch)
    if not buckets or buckets[0] < 1:
        raise ValueError(f"invalid serve buckets {buckets!r}")
    return buckets


def _to_nhwc(data: np.ndarray, layout: str) -> np.ndarray:
    """Accept (b,c,h,w) [cxxnet's convention], (b,h,w,c) or (b,k)."""
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 2:
        return data.reshape(data.shape[0], 1, 1, data.shape[1])
    if data.ndim != 4:
        raise ValueError(
            "need a 4-D (batch,channel,y,x) or 2-D (batch,features) array, "
            f"got shape {data.shape}")
    if layout.upper() == "NCHW":
        return np.transpose(data, (0, 2, 3, 1))
    if layout.upper() == "NHWC":
        return data
    raise ValueError(f"unknown layout {layout!r}")


class InferenceEngine:
    """A loaded :class:`Network` as a frozen predict service.

    ``predict`` / ``predict_raw`` / ``extract`` match the cxxnet task
    modes pred / pred_raw / extract. Thread-safe: the cell cache takes a
    lock, and forwards are re-entrant."""

    def __init__(self, net: Network,
                 buckets: Union[str, Sequence[int], None] = None,
                 max_batch: int = 64, cache_size: int = 16,
                 stats: Optional[ServingStats] = None,
                 layout: str = "NCHW",
                 dtype: Optional[str] = None):
        if net.params is None:
            raise ValueError("network has no weights: load_weights() "
                             "before wrapping")
        if net.graph.extra_data_num:
            raise ValueError("serve: graphs with extra_data are not "
                             "servable (single-input requests)")
        self.net = net
        self.stats = stats or ServingStats()
        self.layout = layout
        # serving compute dtype: the net's policy, or ``dtype`` (a round
        # trained fp32 can serve bf16; params are fp32 masters).
        # ``dtype = "int8"`` selects the quantized path: the weights must
        # be a PTQ-derived round; the int8 layers' epilogues and every
        # other layer compute in float32
        self.serve_int8 = bool(dtype) and str(dtype).lower() == "int8"
        if self.serve_int8:
            self.compute_dtype = torch.float32
        else:
            self.compute_dtype = (parse_policy(dtype).compute_dtype
                                  if dtype else net.compute_dtype)
        quantized = is_quantized_params(net.params)
        if self.serve_int8 and not quantized:
            raise ValueError(
                "serve_dtype=int8 but the loaded params are not "
                "quantized (no wmat_scale leaves); run tools/quantize.py "
                "and serve the derived round")
        if quantized and not self.serve_int8:
            raise ValueError(
                "params are int8-quantized but the engine dtype is "
                f"{dtype or 'the net policy'}; set serve_dtype=int8 or "
                "dequantize the blob first (serve.engine.negotiate_blob)")
        self.max_batch = int(max_batch)
        self.buckets = _parse_buckets(buckets, self.max_batch)
        if self.buckets[-1] > self.max_batch:
            raise ValueError(
                f"serve bucket {self.buckets[-1]} exceeds max_batch "
                f"{self.max_batch}; raise serve_max_batch or drop the "
                "bucket")
        if self.max_batch > self.buckets[-1]:
            # the batcher sizes dispatches up to max_batch
            self.buckets.append(self.max_batch)
        self.input_shape = tuple(net.graph.input_shape)  # (c, y, x)
        self._cache: "OrderedDict[tuple, object]" = OrderedDict()
        self._cache_cap = int(cache_size)
        if self._cache_cap < 1:
            raise ValueError(
                f"serve cache_size must be >= 1, got {self._cache_cap}")
        self._lock = threading.Lock()
        self.weights_digest = ""
        self.weights_version = "init"
        self.weights_round = -1
        self.stats.record_cache(size=0, capacity=self._cache_cap)
        if not net.fused:
            print("fused_kernels = 0: this engine computes the plain "
                  "PyTorch versions of the kernels", flush=True)

    @classmethod
    def from_checkpoint(cls, cfg: Union[str, ConfigPairs], model_path: str,
                        device=None, dtype: Optional[str] = None,
                        **kw) -> "InferenceEngine":
        """Build the Network of a net config, load a round into it after
        dtype negotiation (:func:`negotiate_blob`), and wrap it."""
        pairs = parse_config_string(cfg) if isinstance(cfg, str) \
            else list(cfg)
        graph = build_graph(pairs)
        net = Network(graph, pairs, device=device)
        blob = ckpt.load_for_inference(model_path)
        ckpt.check_structure(blob["meta"], graph.structure_signature())
        placed = negotiate_blob(blob, dtype)
        net.load_weights(*params_from_jax(placed["params"], placed["state"]))
        eng = cls(net, dtype=dtype, **kw)
        eng.set_provenance(blob["meta"]["round"],
                           ckpt.blob_digest(blob["meta"]))
        return eng

    def set_provenance(self, round_counter: int, digest: str = "") -> None:
        """Label the loaded weights as checkpoint round ``round_counter``:
        version ``rNNNN`` (``rNNNN-int8`` on an int8 engine)."""
        self.weights_round = int(round_counter)
        self.weights_digest = digest
        self.weights_version = version_name(round_counter) \
            + ("-int8" if self.serve_int8 else "")

    # -- shape plumbing --------------------------------------------------
    def _to_input(self, data) -> np.ndarray:
        """Accept (n, features) flat rows (NCHW element order for an image
        input), or 4-D in the engine's layout (NCHW default); returns
        NHWC float32. Raises ValueError on a non-numeric payload or a
        row width that is not the model's."""
        data = np.asarray(data)
        if data.dtype.kind not in "fiub":
            raise ValueError(
                f"request payload dtype {data.dtype} is not numeric")
        data = data.astype(np.float32, copy=False)
        c, y, x = self.input_shape
        if data.ndim == 2:
            if data.shape[1] != c * y * x:
                raise ValueError(
                    f"flat request row width {data.shape[1]} != model "
                    f"input {c}*{y}*{x}")
            if not (c == 1 and y == 1):
                return np.ascontiguousarray(
                    _to_nhwc(data.reshape(-1, c, y, x), "NCHW"))
        out = np.ascontiguousarray(_to_nhwc(data, self.layout))
        want = (y, x, c) if not (c == 1 and y == 1) else (1, 1, x)
        if out.shape[1:] != want:
            raise ValueError(
                f"request rows of shape {out.shape[1:]} (NHWC) != model "
                f"input {want}")
        return out

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (largest bucket for oversize chunks)."""
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _pad(self, rows: np.ndarray, bucket: int) -> np.ndarray:
        if rows.shape[0] == bucket:
            return rows
        pad = np.zeros((bucket - rows.shape[0],) + rows.shape[1:],
                       rows.dtype)
        return np.concatenate([rows, pad], axis=0)

    # -- cell cache ------------------------------------------------------
    def _cell(self, bucket: int, kind: str, node: Optional[str]):
        """LRU lookup of the runner of one (bucket, kind[, node]) cell."""
        key = (bucket, kind, node)
        with self._lock:
            fn = self._cache.get(key)
            if fn is not None:
                self._cache.move_to_end(key)
                self.stats.record_cache(hit=True, size=len(self._cache))
                return fn
            evicted = False
            while len(self._cache) >= self._cache_cap:
                self._cache.popitem(last=False)
                evicted = True
            fn = self._build(kind, node)
            self._cache[key] = fn
            self.stats.record_cache(hit=False, size=len(self._cache),
                                    evicted=evicted)
            return fn

    def _build(self, kind: str, node: Optional[str]):
        net = self.net
        cdt = self.compute_dtype
        if kind == "extract":
            top = node in ("top", "top[-1]")
            if not top and node not in net.graph.node_name_map:
                raise ValueError(f"unknown node name {node!r}")

            def fn(data):
                res = net(data, capture_nodes=not top, compute_dtype=cdt)
                v = res.out if top else res.nodes[node]
                return v.reshape(v.shape[0], -1).float()
        elif kind == "raw":
            def fn(data):
                out = net(data, compute_dtype=cdt).out
                return out.reshape(out.shape[0], -1).float()
        else:                                   # "predict"
            def fn(data):
                out = net(data, compute_dtype=cdt).out
                out = out.reshape(out.shape[0], -1)
                if out.shape[1] == 1:
                    return out[:, 0].float()
                return torch.argmax(out, dim=1).float()
        return fn

    # -- inference -------------------------------------------------------
    def run_padded(self, rows_nhwc: np.ndarray, kind: str,
                   node: Optional[str] = None) -> np.ndarray:
        """One device call on pre-shaped NHWC rows: pad to the bucket, run
        the cell, slice the real rows back out (the batcher's dispatch
        entry)."""
        if kind not in _KINDS:
            raise ValueError(f"unknown output kind {kind!r}")
        # a failing dispatch on demand (what trips the serve breaker)
        failpoints.check("serve.infer", RuntimeError)
        n = rows_nhwc.shape[0]
        bucket = self.bucket_for(n)
        if n > bucket:
            raise ValueError(
                f"run_padded: {n} rows exceed the largest bucket "
                f"{bucket}; chunk to max_batch first")
        with TRACER.span("serve.infer", cat="serve",
                         args={"rows": int(n), "bucket": int(bucket),
                               "kind": kind}):
            fn = self._cell(bucket, kind, node)
            data = torch.from_numpy(self._pad(rows_nhwc, bucket)).to(
                self.net.device)
            return fn(data).cpu().numpy()[:n]

    def _run(self, data, kind: str, node: Optional[str] = None
             ) -> np.ndarray:
        rows = self._to_input(data)
        outs = []
        off = 0
        while off < rows.shape[0]:       # oversize: chunk by max_batch
            chunk = rows[off:off + self.max_batch]
            outs.append(self.run_padded(chunk, kind, node))
            off += chunk.shape[0]
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)

    def predict(self, data) -> np.ndarray:
        """Class predictions (argmax; the raw value for 1-column outputs)."""
        return self._run(data, "predict")

    def predict_raw(self, data) -> np.ndarray:
        """Full top-node rows (e.g. softmax probabilities)."""
        return self._run(data, "raw")

    def extract(self, data, node_name: str) -> np.ndarray:
        """Named node activations ('top' = the final node)."""
        return self._run(data, "extract", node_name)

    # -- hot weight reload -----------------------------------------------
    def swap_weights(self, params, net_state, round_counter: int,
                     digest: str = "") -> None:
        """Replace the served weights in place with a verified round's
        ``params`` / ``net_state`` (JAX-layout numpy trees, as a
        checkpoint blob holds them; the caller has checked the structure,
        as the reload watcher does). Placement and the cast run outside
        the weights lock; params, state and the version labels change
        together under it. The runners close over the network, not its
        weights, so a swap rebuilds none."""
        if is_quantized_params(params) != self.serve_int8:
            # an int8 replica never swaps in a plain round, nor an fp
            # replica a quantized one: their layer paths differ
            raise ValueError(
                "swap_weights: params quantization does not match the "
                f"engine dtype (serve_int8={self.serve_int8}); "
                "negotiate the blob first (serve.engine.negotiate_blob)")
        net = self.net
        placed = net.place_weights(*params_from_jax(params, net_state),
                                   self.compute_dtype)
        with net.weights_lock:
            net.install_weights(placed)
            self.set_provenance(round_counter, digest)

    # -- introspection ---------------------------------------------------
    def cache_info(self) -> Dict[str, int]:
        with self._lock:
            return {"size": len(self._cache), "capacity": self._cache_cap,
                    "hits": self.stats.cache_hits,
                    "misses": self.stats.cache_misses,
                    "evictions": self.stats.cache_evictions}
