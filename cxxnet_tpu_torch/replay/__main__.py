"""Replay one incident of a run ledger in this process (the port of the
JAX package's ``tools/replay.py``).

    python -m cxxnet_tpu_torch.replay <ledger> --list
    python -m cxxnet_tpu_torch.replay <ledger> [--incident N | --last]
        [--failpoints on|off] [--steps K] [--model-dir D] [--config C]
        [--out-ledger P] [--no-strict] [key=value ...]

Exit codes: 0 ``bit_exact``, 2 ``diverged_at_step``, 3
``unreproducible:<reason>`` (config drift included), 4 a bad flag or
override. (The JAX tool leaves an unknown flag to argparse, which exits
2; here 2 means a divergence only.)
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


class _Parser(argparse.ArgumentParser):
    def error(self, message):
        self.print_usage(sys.stderr)
        print(f"{self.prog}: error: {message}", file=sys.stderr)
        sys.exit(4)


def main(argv: Optional[List[str]] = None) -> int:
    ap = _Parser(
        prog="python -m cxxnet_tpu_torch.replay",
        description=__doc__.split("\n")[0],
        usage="python -m cxxnet_tpu_torch.replay <ledger> [options] "
              "[key=value ...]")
    ap.add_argument("ledger", help="run-ledger JSONL")
    ap.add_argument("--list", action="store_true",
                    help="list replayable incidents and exit")
    ap.add_argument("--incident", type=int, default=-1,
                    help="incident index (default: last)")
    ap.add_argument("--last", action="store_true",
                    help="replay the last incident (default)")
    ap.add_argument("--failpoints", choices=("on", "off"),
                    default="off",
                    help="re-arm the recorded failpoints, "
                         "step-compensated (default off)")
    ap.add_argument("--steps", type=int, default=0,
                    help="cap replay at K steps")
    ap.add_argument("--model-dir", default="",
                    help="override the snapshot's model_dir")
    ap.add_argument("--config", default="",
                    help="live config tree to drift-check against "
                         "the recorded snapshot")
    ap.add_argument("--out-ledger", default=None,
                    help="replay-event ledger (default: "
                         "<ledger>.replay.jsonl; '' disables)")
    ap.add_argument("--no-strict", action="store_true",
                    help="config drift warns instead of failing")
    ap.add_argument("overrides", nargs="*",
                    help="extra global key=value config overrides")
    args = ap.parse_args(argv)

    from ..config import parse_config_file
    from ..telemetry.ledger import read_ledger
    from . import ReconstructError, execute, list_incidents, reconstruct

    overrides = []
    for ov in args.overrides:
        if "=" not in ov:
            print("bad override (want key=value): %r" % ov,
                  file=sys.stderr)
            return 4
        k, _, v = ov.partition("=")
        overrides.append((k.strip(), v.strip()))

    if args.list:
        rows = list_incidents(read_ledger(args.ledger))
        if not rows:
            print("no replayable incidents in %s" % args.ledger)
            return 0
        for i, e in enumerate(rows):
            bits = [f"[{i}]", str(e.get("event"))]
            for k in ("round", "step", "reason", "provenance"):
                if e.get(k) not in (None, ""):
                    bits.append(f"{k}={e[k]}")
            print(" ".join(bits))
        return 0

    live_cfg = parse_config_file(args.config) if args.config else None
    incident = None if args.incident < 0 else args.incident
    try:
        plan = reconstruct(args.ledger, incident=incident,
                           model_dir=args.model_dir,
                           live_config=live_cfg,
                           strict=not args.no_strict)
    except ReconstructError as e:
        print("replay: verdict: %s" % e, file=sys.stderr)
        return 3
    out_ledger = args.out_ledger
    if out_ledger is None:
        out_ledger = args.ledger + ".replay.jsonl"
    res = execute(plan, failpoints_on=(args.failpoints == "on"),
                  max_steps=args.steps, out_ledger=out_ledger,
                  overrides=overrides)
    print(res.report(plan))
    if res.verdict == "bit_exact":
        return 0
    return 3 if res.verdict.startswith("unreproducible") else 2


if __name__ == "__main__":
    sys.exit(main())
