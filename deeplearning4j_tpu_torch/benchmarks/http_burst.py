"""A burst of concurrent generate clients against ``serving.ModelServer``,
at one or more listen backlogs.

Each round sends 16 ``POST /v1/models/lm/generate`` requests (64 greedy
tokens each) at once from client threads in a process of their own, so
that the clients do not share the server's interpreter, and records each
request's TCP connect seconds, its latency and any exception. A connect
near 1 s is a SYN the kernel dropped because the accept queue was full,
and the client's first retransmission.

Usage::

    python -m deeplearning4j_tpu_torch.benchmarks.http_burst \\
        --backlogs 5,128 --rounds 12

It runs the default ``CausalLMConfig`` on the card unless ``--device
cpu`` is given, which serves the tiny configuration instead. It prints
one JSON object a round: the backlog, the round, the exceptions, the
requests not answered 200, the connects over 0.9 s, and the largest
connect and latency seconds.
"""
from __future__ import annotations

import argparse
import http.client
import json
import subprocess
import sys
import threading
import time

import numpy as np

N_CLIENTS, MAX_TOKENS = 16, 64
PROMPT_LENS = (17, 40, 64, 100, 150, 200, 333, 500)


def _request(port: int, prompt) -> dict:
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.connect()
        connect_s = time.perf_counter() - t0
        body = {"prompt": prompt, "max_tokens": MAX_TOKENS}
        conn.request("POST", "/v1/models/lm/generate",
                     json.dumps(body).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        resp.read()
        return {"connect_s": connect_s, "status": resp.status,
                "s": time.perf_counter() - t0}
    except Exception as e:
        return {"exc": f"{type(e).__name__}: {e}",
                "s": time.perf_counter() - t0}
    finally:
        conn.close()


def _clients_main():
    """The client process: the job as JSON on stdin, results on stdout."""
    job = json.load(sys.stdin)
    res = [None] * len(job["prompts"])

    def go(i):
        res[i] = _request(job["port"], job["prompts"][i])
    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(res))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    json.dump(res, sys.stdout)


def _round(port: int, prompts) -> list:
    out = subprocess.run(
        [sys.executable, "-m", __spec__.name, "--clients"],
        input=json.dumps({"port": port, "prompts": prompts}),
        capture_output=True, text=True, timeout=900, check=True)
    return json.loads(out.stdout)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backlogs", default="5,128")
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--clients", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.clients:
        return _clients_main()
    import torch

    from ..common.httpserver import QuietThreadingHTTPServer
    from ..models.causal_lm import CausalLM, CausalLMConfig
    from ..serving import ModelRegistry, ModelServer
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device; pass --device cpu")
        cfg = CausalLMConfig()
    else:
        cfg = CausalLMConfig(**{**CausalLMConfig.tiny().__dict__,
                                "max_position_embeddings": 1024})
    model = CausalLM(cfg, seed=0, device=args.device)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size,
                           PROMPT_LENS[i % len(PROMPT_LENS)]).tolist()
               for i in range(N_CLIENTS)]
    default = QuietThreadingHTTPServer.request_queue_size
    try:
        for backlog in (int(b) for b in args.backlogs.split(",")):
            QuietThreadingHTTPServer.request_queue_size = backlog
            reg = ModelRegistry(manifest_dir=None)
            srv = ModelServer(reg, host="127.0.0.1", port=0)
            port = srv.start()
            try:
                reg.deploy("lm", "v1", model, decode_slots=8,
                           decode_max_ctx=1024, decode_kv_block_size=16)
                _round(port, prompts[:1])   # the engine's first request
                for r in range(args.rounds):
                    res = _round(port, prompts)
                    connects = [x["connect_s"] for x in res
                                if "connect_s" in x]
                    print(json.dumps({
                        "backlog": backlog, "round": r,
                        "exceptions": [x["exc"] for x in res if "exc" in x],
                        "not_ok": sum(x.get("status") != 200 for x in res),
                        "connects_over_0.9s": sum(c > 0.9 for c in connects),
                        "connect_max_s": max(connects, default=None),
                        "latency_max_s": max(x["s"] for x in res)}),
                        flush=True)
            finally:
                srv.stop()
                reg.drain_all(timeout_s=30, save_manifests=False)
    finally:
        QuietThreadingHTTPServer.request_queue_size = default


if __name__ == "__main__":
    main()
