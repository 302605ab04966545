"""Serving runtime: the continuous-batching decode engine, its request
errors, and the serving-manifest half of the compile cache."""
