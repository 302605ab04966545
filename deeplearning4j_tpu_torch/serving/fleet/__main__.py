"""Run the fleet front door: ``python -m deeplearning4j_tpu_torch.serving.fleet
--replicas http://h1:8000,http://h2:8000``.

The router process needs no card and no model: it proxies to the
serving replicas and keeps only routing state. Replicas can also be
passed as repeated ``--replicas`` flags; membership can grow at runtime
by restarting with the longer list (or programmatically via
``FleetRouter.add_replica``).
"""
from __future__ import annotations

import argparse
import logging
import sys
import time

from .router import FleetRouter, FleetServer


def _parse_replicas(values) -> list:
    urls = []
    for v in values or ():
        urls.extend(u.strip() for u in v.split(",") if u.strip())
    return urls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.serving.fleet",
        description="Front-of-fleet replica router for model serving")
    ap.add_argument("--replicas", action="append", required=True,
                    metavar="URL[,URL...]",
                    help="serving replica base URLs (repeatable or "
                         "comma-separated)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--poll-s", type=float, default=None,
                    help="replica poll cadence (DL4J_TPU_FLEET_POLL_S)")
    ap.add_argument("--retries", type=int, default=None,
                    help="failover retries (DL4J_TPU_FLEET_RETRIES)")
    ap.add_argument("--timeout-s", type=float, default=None,
                    help="per-attempt timeout (DL4J_TPU_FLEET_TIMEOUT_S)")
    ap.add_argument("--retry-budget", type=float, default=None,
                    help="failover+hedge token ratio "
                         "(DL4J_TPU_FLEET_RETRY_BUDGET)")
    ap.add_argument("--hedge-pctl", type=float, default=None,
                    help="hedge-delay latency percentile, <=0 disables "
                         "(DL4J_TPU_FLEET_HEDGE_PCTL)")
    ap.add_argument("--brownout-frac", type=float, default=None,
                    help="ready fraction below which the front door "
                         "sheds low-priority traffic "
                         "(DL4J_TPU_FLEET_BROWNOUT_FRAC)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    urls = _parse_replicas(args.replicas)
    if not urls:
        ap.error("--replicas needs at least one URL")
    router = FleetRouter(urls, poll_s=args.poll_s, retries=args.retries,
                         timeout_s=args.timeout_s,
                         retry_budget=args.retry_budget,
                         hedge_pctl=args.hedge_pctl,
                         brownout_frac=args.brownout_frac)
    server = FleetServer(router, host=args.host, port=args.port)
    port = server.start()
    print(f"fleet router on http://{args.host}:{port} "
          f"fronting {len(urls)} replicas", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
