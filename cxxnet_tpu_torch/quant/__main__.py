"""Post-training int8 quantization of a verified round (the port of
``tools/quantize.py``).

  python -m cxxnet_tpu_torch.quant CONFIG SRC_CKPT OUT_CKPT [--json] \\
      [quant_calib_batches=4] [quant_calib_percentile=99.9] [k=v ...]

1. builds the net of the config on the device its ``dev`` names (the
   card unless ``dev = cpu``);
2. loads the source round, digest-verified, and checks its structure
   against the net;
3. calibrates one activation scale per fullc/conv/seqfc layer over
   ``quant_calib_batches`` batches of the config's ``data`` section
   (abs-max, or the ``quant_calib_percentile``);
4. writes the derived round: the same round number, its own digests,
   ``__quant_meta__`` provenance in its meta;
5. prints the drift verdict; a drift-UNSAFE round is still written (to
   inspect) but the exit code is 2.

The derived round serves as version ``rNNNN-int8`` under ``task = serve
serve_dtype = int8`` (``serve/engine.negotiate_blob``). With
``telemetry_ledger = <path>`` the calibration is a ``quant_calibrate``
event of that run ledger.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cxxnet_tpu_torch.quant",
        description="post-training int8 quantization of a round")
    ap.add_argument("config", help="training config (net + data section)")
    ap.add_argument("src", help="source round (%%04d.model)")
    ap.add_argument("out", help="output path for the quantized round")
    ap.add_argument("--json", action="store_true",
                    help="emit the drift verdict as JSON")
    ap.add_argument("overrides", nargs="*",
                    help="config overrides (key=value), e.g. "
                         "quant_calib_batches=8")
    args = ap.parse_args(argv)

    from .. import checkpoint as ckpt
    from ..config import (parse_cli_overrides, parse_config_file,
                          parse_quant_config, parse_telemetry_config,
                          split_sections)
    from ..telemetry.ledger import LEDGER, new_run_id
    from ..graph import build_graph
    from ..io import close_chain, create_iterator
    from ..model import Network
    from . import drift_verdict, quantize_blob, write_quantized_round

    cfg = parse_config_file(args.config) + parse_cli_overrides(args.overrides)
    global_cfg, sections = split_sections(cfg)
    qc = parse_quant_config(global_cfg)
    tc = parse_telemetry_config(global_cfg)
    if tc.ledger_path:
        # the quant_calibrate event lands in telemetry_ledger
        LEDGER.enable(tc.ledger_path, tc.run_id or os.environ.get(
            "CXXNET_RUN_ID") or new_run_id())
    graph = build_graph(global_cfg)
    net = Network(graph, global_cfg)
    blob = ckpt.load_for_inference(args.src)
    ckpt.check_structure(blob["meta"], graph.structure_signature())

    # calibration stream: the config's data section (the distribution
    # the model sees), capped at quant_calib_batches
    data_pairs = next((p for kind, _n, p in sections if kind == "data"),
                      None)
    if data_pairs is None:
        ap.error("config has no data section to calibrate from")
    itr = create_iterator(global_cfg + data_pairs)
    batches = (b.data for b in itertools.islice(iter(itr),
                                                qc.calib_batches))
    try:
        qblob, qm = quantize_blob(net, blob, batches, qc)
    finally:
        close_chain(itr)
        LEDGER.disable()

    write_quantized_round(args.out, graph.structure_signature(), qblob, qm)
    out_digest = ckpt.blob_digest(ckpt.verify_model(args.out))
    dv = drift_verdict(qm, qc.max_rel_err, qc.max_sat_frac)
    rc = 0 if dv["ok"] else 2
    if args.json:
        print(json.dumps({
            "src": args.src, "out": args.out,
            "source_round": qm["source_round"],
            "source_digest": qm["source_digest"],
            "out_digest": out_digest,
            "quantized_layers": qm["quantized_layers"],
            "calib": qm["calib"],
            "drift": dv, "exit_code": rc,
        }, indent=1, sort_keys=True))
        return rc
    print("quantized %s (round %s, digest %s)"
          % (args.src, qm["source_round"], qm["source_digest"]))
    print("  -> %s (digest %s, %d int8 layers, calib %d batches @ p%g)"
          % (args.out, out_digest, len(qm["quantized_layers"]),
             qm["calib"]["batches"], qm["calib"]["percentile"]))
    for r in dv["layers"]:
        print("  %-32s rel_err %8.5f  sat_frac %8.5f  %s"
              % (r["layer"], r["rel_err"], r["sat_frac"],
                 "ok" if r["ok"] else "DRIFT"))
    print(dv["line"])
    return rc


if __name__ == "__main__":
    sys.exit(main())
