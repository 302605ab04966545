"""``python -m deeplearning4j_tpu_torch.runtime.warm_image`` — pre-bake
the kernel libraries a model's serving path runs into a relocatable
artifact directory.

Counterpart of ``deeplearning4j_tpu/runtime/warm_image.py``. An
autoscaling fleet's worst build bill comes due at the worst time: a
traffic spike spawns replica N+1, which must have the CUDA toolkit and
run ``nvcc`` for every kernel library before it serves a token. The
push-on-drain / pull-on-boot flow (``serving.lifecycle``) amortizes that
across running replicas, but a brand-new cluster or CI image has no
predecessor to inherit from. This CLI closes that gap: bake once at
image-build time, serve without a compiler forever.

The bake runs the warmup the serving path runs — for predict models the
engine's bucket ladder against an example request, for generative models
the prefill ladder x batch ladder + decode step (``DecodeEngine.warmup``)
— with the artifact store pointed at the output directory in the
**remote-store layout**, and puts every kernel library that warmup
launched into it::

    <output>/objects/<aa>/<sha>.bin|.json   content-addressed libraries
    <output>/manifests/<name>.warmup.json   warmup manifest (predict)

Because the layout is what :class:`~.compile_cache.RemoteStore` reads,
deployment is one environment variable: point ``DL4J_TPU_REMOTE_CACHE``
at the directory (baked into the image, or pushed to the bucket the
fleet mounts), and each replica's boot-time pull
(``lifecycle.restore_on_boot``) downloads the libraries; ``_build`` then
finds them and runs no compiler. Keys are content hashes of each
library's source, headers, flags and the CUDA version
(``kernels._build.store_key``), never absolute paths.

Bake on hardware matching the fleet: the libraries are built for
``sm_90a`` (Hopper). A CUDA graph cannot be written to disk, so each
replica still captures its steps at warmup; what the image saves is the
compiler. On the CPU no kernel runs: a bake there writes the manifest and
zero entries.

Example::

    python -m deeplearning4j_tpu_torch.runtime.warm_image \\
        --model myproj.models:build_lm --generative \\
        --output /artifacts/lm --name lm

where ``build_lm()`` returns a model (or ``(model, example)``).
"""
from __future__ import annotations

import argparse
import importlib
import json
import logging
import os
import sys
import time
from typing import Optional, Sequence

from ..common.environment import SystemProperties, environment
from . import compile_cache

log = logging.getLogger(__name__)


def _load_factory(spec: str):
    """``pkg.module:factory`` -> the callable."""
    mod_name, sep, attr = spec.partition(":")
    if not sep or not attr:
        raise ValueError(
            f"--model must look like pkg.module:factory, got {spec!r}")
    mod = importlib.import_module(mod_name)
    try:
        return getattr(mod, attr)
    except AttributeError:
        raise ValueError(f"{mod_name} has no attribute {attr!r}") from None


def bake(model, example=None, *, output: str, name: str = "model",
         batch_sizes: Optional[Sequence[int]] = None,
         max_batch: Optional[int] = None,
         generative: bool = False) -> dict:
    """Warm ``model``'s serving path and put the kernel libraries it
    launched into ``output`` (remote-store layout); return a bake
    summary. Programmatic core of the CLI — safe to call from build
    scripts and tests. The process's artifact-store conf is redirected at
    ``output`` for the duration and restored after.

    ``entries`` counts the kernel libraries the warmup launched, which
    ``kernels`` lists; ``payload_bytes`` is every library the image
    holds."""
    from ..kernels import _build
    from ..kernels._counts import libraries_used
    env = environment()
    saved = {p: env.property_override(p)
             for p in (SystemProperties.CACHE_DIR,
                       SystemProperties.REMOTE_CACHE,
                       SystemProperties.CACHE_TIER)}
    output = os.path.abspath(output)
    os.makedirs(output, exist_ok=True)
    engine = None
    t0 = time.perf_counter()
    try:
        # tier=remote: entries land content-addressed under
        # <output>/objects, the layout DL4J_TPU_REMOTE_CACHE consumers read
        env.set_cache_dir(output)
        env.set_remote_cache(output)
        env.set_cache_tier("remote")
        compile_cache.reset_cache()
        if compile_cache.cache() is None:
            raise RuntimeError(f"output dir {output} is not writable as "
                               "an artifact store")
        with libraries_used() as used:
            if generative:
                from .generation import DecodeEngine
                engine = DecodeEngine(model, model_name=name,
                                      device=getattr(model, "device",
                                                     "cuda"))
                buckets = engine.warmup()
            else:
                from .inference import InferenceEngine
                engine = InferenceEngine(model, max_batch=max_batch)
                if example is None:
                    raise ValueError("predict models need an example "
                                     "(--example-shape) to fix input "
                                     "shapes")
                buckets = engine.warmup(example, batch_sizes=batch_sizes)
                manifest_dir = os.path.join(output, "manifests")
                os.makedirs(manifest_dir, exist_ok=True)
                engine.save_manifest(os.path.join(
                    manifest_dir, f"{name}.warmup.json"))
        kernels = _build.publish(sorted(used))
        inv = compile_cache.inventory()
        return {"name": name, "output": output,
                "generative": bool(generative),
                "buckets": list(buckets),
                "entries": len(kernels), "kernels": kernels,
                "payload_bytes": inv.get("total_payload_bytes", 0),
                "stats": inv.get("stats", {}),
                "bake_seconds": round(time.perf_counter() - t0, 3)}
    finally:
        if engine is not None:
            try:
                engine.close(timeout_s=10.0)
            except Exception:
                log.debug("engine close after bake failed", exc_info=True)
        for prop, value in saved.items():
            if value is None:
                env.clear_property(prop)
            else:
                env.set_property(prop, value)
        compile_cache.reset_cache()


def _build_example(shape_spec: Optional[str], dtype: str):
    if not shape_spec:
        return None
    import torch
    shape = tuple(int(d) for d in shape_spec.split(",") if d.strip())
    return torch.zeros(shape, dtype=getattr(torch, dtype))


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.runtime.warm_image",
        description="Pre-bake the kernel libraries of a model's serving "
                    "path into a relocatable artifact directory "
                    "(remote-store layout; point DL4J_TPU_REMOTE_CACHE "
                    "at it).")
    p.add_argument("--model", required=True,
                   help="factory as pkg.module:callable; called with no "
                        "args, returns the model or (model, example)")
    p.add_argument("--output", required=True,
                   help="artifact directory to bake into")
    p.add_argument("--name", default="model",
                   help="model name for the warmup manifest "
                        "(default: model)")
    p.add_argument("--example-shape", default=None,
                   help="example input shape for predict models, e.g. "
                        "1,64 (batch dim irrelevant; feature shape "
                        "fixes the signature)")
    p.add_argument("--dtype", default="float32",
                   help="example dtype (default: float32)")
    p.add_argument("--batch-sizes", default=None,
                   help="comma-separated batch sizes to warm (default: "
                        "the engine's whole bucket ladder)")
    p.add_argument("--max-batch", type=int, default=None,
                   help="bucket-ladder cap (default: "
                        "DL4J_TPU_INFERENCE_MAX_BATCH)")
    p.add_argument("--generative", action="store_true",
                   help="bake a DecodeEngine ladder (prefill x batch + "
                        "decode step) instead of a predict ladder")
    args = p.parse_args(argv)

    factory = _load_factory(args.model)
    produced = factory()
    if isinstance(produced, tuple) and len(produced) == 2:
        model, example = produced
    else:
        model, example = produced, None
    if example is None:
        example = _build_example(args.example_shape, args.dtype)
    batch_sizes = None
    if args.batch_sizes:
        batch_sizes = [int(b) for b in args.batch_sizes.split(",")
                       if b.strip()]
    summary = bake(model, example, output=args.output, name=args.name,
                   batch_sizes=batch_sizes, max_batch=args.max_batch,
                   generative=args.generative)
    json.dump(summary, sys.stdout, indent=2)
    sys.stdout.write("\n")
    # zero entries is a whole bake where no hand-written kernel runs (the
    # CPU, or a network of library calls only): a failed bake raises
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via main()
    sys.exit(main())
