"""Process-wide plumbing copied from the JAX package: locks, metrics,
tracing, fault injection, the configuration knobs, the HTTP building
blocks and the mesh reporting helpers."""
