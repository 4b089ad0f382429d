"""CLI: ``python -m repro_torch.obs {report,validate} <artifact>`` (port
of ``repro.obs.__main__``; either package's CLI reads either's artifacts).

``report`` renders a run artifact (JSON summary or JSONL event stream)
as a text trace tree + metric summary, or re-emits it as JSON with
``--json``. ``validate`` checks the manifest schema and any required
top-level keys — the gate for ``BENCH_ebft.json``::

    python -m repro_torch.obs report BENCH_ebft.json
    python -m repro_torch.obs validate BENCH_ebft.json --require blocks phases
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.report import render_text
from repro_torch.obs.run import validate_payload
from repro_torch.obs.sinks import load_artifact


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Render and validate repro.obs/v1 run artifacts.",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("report", help="render a run artifact")
    rp.add_argument("artifact", help="JSON summary or JSONL event stream")
    rp.add_argument("--json", action="store_true",
                    help="emit the loaded payload as JSON instead of text")

    vp = sub.add_parser("validate", help="schema-check a run artifact")
    vp.add_argument("artifact")
    vp.add_argument("--require", nargs="*", default=[], metavar="KEY",
                    help="top-level keys the artifact must carry "
                         "(e.g. blocks phases)")
    vp.add_argument("--max-dispatches-per-block", type=int, default=None,
                    metavar="N",
                    help="fail if dispatch.per_block_max exceeds N")
    vp.add_argument("--require-cache-hits", action="store_true",
                    help="fail unless kernel_tuning shows a fully warm "
                         "launch-config cache: hits >= 1, zero misses/"
                         "searches/search seconds")

    args = ap.parse_args(argv)
    try:
        payload = load_artifact(args.artifact)
    except (OSError, json.JSONDecodeError) as e:
        print(f"error: cannot load {args.artifact}: {e}", file=sys.stderr)
        return 2

    if args.cmd == "report":
        try:
            if args.json:
                print(json.dumps(payload, indent=2))
            else:
                print(render_text(payload))
        except BrokenPipeError:  # report | head is the expected use
            sys.stderr.close()
        return 0

    problems = validate_payload(
        payload, require=args.require,
        max_dispatches_per_block=args.max_dispatches_per_block,
        require_cache_hits=args.require_cache_hits,
    )
    if problems:
        for p in problems:
            print(f"INVALID {args.artifact}: {p}")
        return 1
    print(f"OK {args.artifact}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
