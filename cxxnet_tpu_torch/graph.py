"""Net-config graph compiler: config pairs -> static layer DAG.

The port's own copy of ``cxxnet_tpu/graph.py``: the order-sensitive
``netconfig = start .. end`` grammar compiles into a :class:`NetGraph`
that :mod:`cxxnet_tpu_torch.model` runs. Grammar:

  * ``layer[0->1] = conv:name``         explicit node indices
  * ``layer[a,b->c] = concat``          multi-input / multi-output node lists
  * ``layer[+1] = relu``                new anonymous node after previous top
  * ``layer[+1:tag] = fullc:name``      new named node ``tag``
  * ``layer[+0] = softmax``             self-loop on previous top
  * ``layer[...] = share[tag]``         weight sharing with primary layer ``tag``
  * ``layer[...] = pairtest-A-B``       side-by-side test composite
  * params after a layer line attach to that layer until the next layer line
  * ``label_vec[a,b) = name``           named label slices (loss targets)
  * ``updater = sgd|nag|adam``           the optimizer (outside layer blocks)
  * ``extra_data_num`` / ``extra_data_shape[i]`` extra input nodes

Left out on purpose: ``stem_pad_plan`` and the space-to-depth stem
rewrite of the JAX package's conv layer. Both are value-exact layout
tricks for the TPU's 128-wide matrix unit and change no output.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .config import ConfigError, ConfigPairs, Policy, parse_policy

# Layer-type names the grammar accepts (the JAX package's set; the port
# builds the subset in layers/, create_layer names the rest)
KNOWN_LAYER_TYPES = {
    "fullc", "fixconn", "bias", "softmax", "relu", "sigmoid", "tanh",
    "softplus", "flatten", "dropout", "conv", "relu_max_pooling",
    "max_pooling", "sum_pooling", "avg_pooling", "lrn", "concat", "xelu",
    "maxout", "split", "insanity", "rrelu", "insanity_max_pooling",
    "lp_loss", "l2_loss", "multi_logistic", "ch_concat", "prelu",
    "batch_norm", "batch_norm_no_ma",
    "embed", "layernorm", "mha", "ffn", "seqfc", "add", "lmloss", "moe",
    "posembed", "plugin",
}


@dataclass
class LayerSpec:
    """One connection in the DAG."""
    type: str                      # canonical layer type name
    name: str                      # layer name (auto-generated if anonymous)
    nindex_in: List[int]
    nindex_out: List[int]
    cfg: ConfigPairs = field(default_factory=list)
    # weight sharing: index of the primary layer whose params this reuses
    primary_layer_index: Optional[int] = None
    # pairtest composite: (master_type, slave_type)
    pairtest: Optional[Tuple[str, str]] = None

    @property
    def is_shared(self) -> bool:
        return self.primary_layer_index is not None

    def structure_signature(self) -> tuple:
        """Structural identity used for checkpoint-compat checks."""
        return (self.type, tuple(self.nindex_in), tuple(self.nindex_out),
                self.primary_layer_index)


_LAYER_PLUS = re.compile(r"^layer\[\+(\d+)(?::([^\]]+))?\]$")
_LAYER_ARROW = re.compile(r"^layer\[([^\]]+)->([^\]]+)\]$")
_LABEL_VEC = re.compile(r"^label_vec\[(\d+),(\d+)\)$")
_EXTRA_SHAPE = re.compile(r"^extra_data_shape\[(\d+)\]$")


class NetGraph:
    """Parsed network structure plus global (non-layer) config."""

    def __init__(self) -> None:
        self.node_names: List[str] = ["in"]
        self.node_name_map: Dict[str, int] = {"in": 0, "0": 0}
        self.layers: List[LayerSpec] = []
        self.layer_name_map: Dict[str, int] = {}
        self.defcfg: ConfigPairs = []          # global (non-layer) settings
        self.input_shape: Optional[Tuple[int, int, int]] = None  # (c, y, x)
        self.extra_data_num: int = 0
        self.extra_shapes: List[Tuple[int, int, int]] = []
        # label slicing: list of (begin, end), name -> slice index
        self.label_range: List[Tuple[int, int]] = [(0, 1)]
        self.label_name_map: Dict[str, int] = {"label": 0}
        self._label_default = True
        self.updater_type: str = "sgd"

    def _node_index(self, name: str, alloc_unknown: bool) -> int:
        if name in self.node_name_map:
            return self.node_name_map[name]
        if not alloc_unknown:
            raise ConfigError(
                f"undefined node name {name!r}: input of a layer must be the "
                f"output of an earlier layer")
        idx = len(self.node_names)
        self.node_names.append(name)
        self.node_name_map[name] = idx
        return idx

    @property
    def num_nodes(self) -> int:
        return len(self.node_names)

    def node_index(self, name: str) -> int:
        if name not in self.node_name_map:
            raise ConfigError(f"unknown node name {name!r}")
        return self.node_name_map[name]

    def label_slice(self, name: str) -> Tuple[int, int]:
        """Label columns [begin, end) of the named label field."""
        if name not in self.label_name_map:
            raise ConfigError(f"unknown label field {name!r}")
        return self.label_range[self.label_name_map[name]]

    def structure_signature(self) -> tuple:
        return tuple(l.structure_signature() for l in self.layers)


def _parse_layer_type(val: str, graph: NetGraph, cfg_layer_index: int) -> LayerSpec:
    """Parse the value side ``type[:name]`` of a layer line."""
    if ":" in val:
        ltype, lname = val.split(":", 1)
    else:
        ltype, lname = val, ""
    spec = LayerSpec(type=ltype, name=lname, nindex_in=[], nindex_out=[])
    if ltype.startswith("share"):
        m = re.match(r"^share\[([^\]]+)\]$", ltype)
        if not m:
            raise ConfigError(
                "shared layer must specify tag of layer to share with, "
                "e.g. layer[..] = share[fc1]")
        tag = m.group(1)
        if tag not in graph.layer_name_map:
            raise ConfigError(f"shared layer tag {tag!r} is not defined before")
        spec.type = "share"
        spec.primary_layer_index = graph.layer_name_map[tag]
        if lname:
            if lname in graph.layer_name_map and \
                    graph.layer_name_map[lname] != cfg_layer_index:
                raise ConfigError(f"duplicate layer name {lname!r}")
            graph.layer_name_map[lname] = cfg_layer_index
        return spec
    if ltype.startswith("pairtest-"):
        m = re.match(r"^pairtest-([^-]+)-([^-:]+)$", ltype)
        if not m:
            raise ConfigError(f"invalid pairtest layer type {ltype!r}")
        master, slave = m.group(1), m.group(2)
        for t in (master, slave):
            if t not in KNOWN_LAYER_TYPES:
                raise ConfigError(f"unknown layer type in pairtest: {t!r}")
        spec.type = "pairtest"
        spec.pairtest = (master, slave)
    elif ltype not in KNOWN_LAYER_TYPES:
        raise ConfigError(f"unknown layer type: {ltype!r}")
    if lname:
        if lname in graph.layer_name_map and \
                graph.layer_name_map[lname] != cfg_layer_index:
            raise ConfigError(f"duplicate layer name {lname!r}")
        graph.layer_name_map[lname] = cfg_layer_index
    return spec


def build_graph(cfg: ConfigPairs) -> NetGraph:
    """Compile ordered config pairs into a NetGraph: params after a layer
    line attach to that layer, everything else lands in ``defcfg``."""
    graph = NetGraph()
    netcfg_mode = 0
    cfg_top_node = 0
    for name, val in cfg:
        if name == "extra_data_num":
            num = int(val)
            for i in range(num):
                nm = f"in_{i + 1}"
                if nm not in graph.node_name_map:
                    graph.node_name_map[nm] = len(graph.node_names)
                    graph.node_names.append(nm)
            graph.extra_data_num = num
            continue
        m = _EXTRA_SHAPE.match(name)
        if m:
            dims = tuple(int(x) for x in val.split(","))
            if len(dims) != 3:
                raise ConfigError(f"extra data shape config incorrect: {val!r}")
            graph.extra_shapes.append(dims)
            continue
        if name == "input_shape":
            dims = tuple(int(x) for x in val.split(","))
            if len(dims) != 3:
                raise ConfigError(
                    "input_shape must be three integers c,y,x e.g. 1,1,784")
            graph.input_shape = dims
        if netcfg_mode != 2:
            if name == "updater":
                graph.updater_type = val
            mlv = _LABEL_VEC.match(name)
            if mlv:
                if graph._label_default:
                    graph.label_range = []
                    graph.label_name_map = {}
                    graph._label_default = False
                graph.label_range.append((int(mlv.group(1)),
                                          int(mlv.group(2))))
                graph.label_name_map[val] = len(graph.label_range) - 1
                continue
        if name == "netconfig" and val == "start":
            netcfg_mode = 1
            continue
        if name == "netconfig" and val == "end":
            netcfg_mode = 0
            continue
        if name.startswith("layer["):
            cfg_layer_index = len(graph.layers)
            spec = _parse_layer_type(val, graph, cfg_layer_index)
            mp = _LAYER_PLUS.match(name)
            ma = _LAYER_ARROW.match(name)
            if mp:
                inc = int(mp.group(1))
                tag = mp.group(2)
                if cfg_top_node < 0:
                    raise ConfigError(
                        "layer[+k] used after a layer with multiple outputs; "
                        "use layer[in->out] instead")
                spec.nindex_in = [cfg_top_node]
                if tag is not None and inc == 1:
                    spec.nindex_out = [graph._node_index(tag, True)]
                elif inc == 0:
                    spec.nindex_out = [cfg_top_node]
                else:
                    anon = f"!node-after-{cfg_top_node}"
                    spec.nindex_out = [graph._node_index(anon, True)]
            elif ma:
                for nm in ma.group(1).split(","):
                    spec.nindex_in.append(graph._node_index(nm, False))
                for nm in ma.group(2).split(","):
                    spec.nindex_out.append(graph._node_index(nm, True))
            else:
                raise ConfigError(f"invalid layer format {name!r}")
            if not spec.name:
                spec.name = f"{spec.type}_{cfg_layer_index}"
                while spec.name in graph.layer_name_map:
                    spec.name = "_" + spec.name
                graph.layer_name_map[spec.name] = cfg_layer_index
            graph.layers.append(spec)
            netcfg_mode = 2
            cfg_top_node = spec.nindex_out[0] if len(spec.nindex_out) == 1 else -1
            continue
        if netcfg_mode == 2:
            if graph.layers[-1].is_shared:
                raise ConfigError(
                    "do not set parameters on a shared layer; set them on the "
                    "primary layer")
            graph.layers[-1].cfg.append((name, val))
        else:
            graph.defcfg.append((name, val))
    if graph.extra_data_num and \
            len(graph.extra_shapes) != graph.extra_data_num:
        raise ConfigError("extra_data_shape count does not match extra_data_num")
    return graph


#: producers whose epilogue can absorb a following relu: batch_norm
#: folds it into its normalize, conv/fullc into the bias epilogue
ACT_FUSABLE_PRODUCERS = ("batch_norm", "batch_norm_no_ma", "conv", "fullc")


def act_fusion_plan(graph: NetGraph):
    """Static activation-fold plan: producer -> relu edges where the relu
    can be absorbed into the producer's epilogue.

    Returns ``(fuse_act, folded)``: ``fuse_act`` maps a producer layer
    index to the activation it applies ("relu"), ``folded`` is the set
    of relu layer indices that pass through in ``Network.forward``. A
    relu writing a new node folds only when it is the sole consumer of
    the producer's output; an in-place relu (``layer[+0]``) always
    folds. Value-preserving for every node a later layer reads."""
    consumers: Dict[int, List[int]] = {}
    for li, spec in enumerate(graph.layers):
        for ni in set(spec.nindex_in):
            consumers.setdefault(ni, []).append(li)
    fuse_act: Dict[int, str] = {}
    folded: set = set()
    for li, spec in enumerate(graph.layers):
        if spec.is_shared or spec.type not in ACT_FUSABLE_PRODUCERS:
            continue
        if len(spec.nindex_out) != 1:
            continue
        out = spec.nindex_out[0]
        later = sorted(c for c in consumers.get(out, []) if c > li)
        if not later:
            continue
        ri = later[0]
        rs = graph.layers[ri]
        if (rs.type != "relu" or rs.is_shared or rs.nindex_in != [out]
                or len(rs.nindex_out) != 1):
            continue
        if rs.nindex_out[0] != out and len(later) > 1:
            continue     # another layer reads the pre-activation node
        fuse_act[li] = "relu"
        folded.add(ri)
    return fuse_act, folded


def global_param(cfg: ConfigPairs, name: str, default: str = "") -> str:
    """Last-wins lookup of a global setting (CLI overrides come last)."""
    out = default
    for k, v in cfg:
        if k == name:
            out = v
    return out


def policy_from_config(cfg: ConfigPairs) -> Policy:
    """The :class:`~cxxnet_tpu_torch.config.Policy` named by the
    ``compute_dtype`` global (default float32)."""
    return parse_policy(global_param(cfg, "compute_dtype", "float32"))
