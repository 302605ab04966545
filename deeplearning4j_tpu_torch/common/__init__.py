"""Cross-cutting services: the dtype system, the layered configuration,
the RNG facade, runtime telemetry (metrics registry and tracing spans),
fault injection, lock-order checking, chrome-trace profile analysis and
the HTTP building blocks. The port imports nothing from the JAX package:
each module here is its own copy."""
from .dtype import DataType
from .environment import (Environment, EnvironmentVars, SystemProperties,
                          environment)
from .metrics import (MetricsRegistry, exponential_buckets, linear_buckets,
                      registry)
from .rng import NativeRandom, get_random, set_default_seed
from .tracing import Tracer, span, tracer

__all__ = ["DataType", "Environment", "EnvironmentVars", "SystemProperties",
           "environment", "NativeRandom", "get_random", "set_default_seed",
           "MetricsRegistry", "registry", "exponential_buckets",
           "linear_buckets", "Tracer", "span", "tracer"]
