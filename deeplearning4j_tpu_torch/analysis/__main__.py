"""CLI: ``python -m deeplearning4j_tpu_torch.analysis [paths...]``.

Exit status 0 when every finding is fixed or baselined (the state CI
gates on), 1 when unbaselined findings exist, 2 on usage errors.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import RULES, baseline_path, run_analysis


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.analysis",
        description="Framework-invariant static analysis (DL101-DL105).")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to analyze (default: the installed "
                         "deeplearning4j_tpu_torch package)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--baseline", default="default", metavar="PATH",
                    help=f"baseline file (default: {baseline_path()})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, suppressing nothing "
                         "(the full-debt view)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    ap.add_argument("--strict-baseline", action="store_true",
                    help="also fail on stale (unused) baseline entries")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, summary in sorted(RULES.items()):
            print(f"{rule}  {summary}")
        return 0

    res = run_analysis(args.paths or None,
                       baseline=None if args.no_baseline else args.baseline)

    # staleness is only meaningful on the full default run — an explicit
    # path subset cannot see most baselined files
    full_run = not args.paths
    if args.json:
        payload = res.to_json()
        if not full_run:
            payload["unused_baseline"] = []
        print(json.dumps(payload, indent=1))
    else:
        for f in res.findings:
            print(f.render())
        if res.baselined:
            print(f"# {len(res.baselined)} finding(s) baselined "
                  f"(see {baseline_path()})")
        if full_run:
            for e in res.unused_baseline:
                print(f"# stale baseline entry (matched nothing): "
                      f"{e['rule']} {e['path']} match={e.get('match')!r}")
        print(f"# {res.modules} module(s), "
              f"{len(res.findings)} unbaselined finding(s)")

    if res.findings:
        return 1
    if args.strict_baseline and full_run and res.unused_baseline:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
