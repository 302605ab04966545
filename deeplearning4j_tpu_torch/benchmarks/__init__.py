"""Benchmark harnesses: the per-op sweep and its regression accounting.

Counterpart of ``deeplearning4j_tpu/benchmarks/`` (the reference's
``contrib/benchmarking_nd4j`` JMH op benches and
``contrib/performance/benchmarking/impl/FullBenchmarkSuit.cpp``).
"""
from .opbench import compare_runs, run_opbench  # noqa: F401
