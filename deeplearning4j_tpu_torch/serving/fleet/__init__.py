"""Sharded serving fleet: scale-up over a mesh, scale-out over replicas.

Counterpart of the JAX package's ``serving/fleet/``. The two halves of
serving beyond one device:

**Scale-up** (tensor parallelism) lives in the engines, not here:
``registry.deploy(..., mesh=serving_mesh(), param_spec=...)`` shards a
version's params over the mesh's ``model`` axis (batches over ``data``,
a generative model's paged KV pool over its heads). The mesh's rank 0
leads: it takes the requests and sends every step to the other ranks,
which run it on their shards (``runtime/sharded.py``). See
:mod:`deeplearning4j_tpu_torch.common.mesh` (``serving_mesh``,
``param_shardings``) and the ``mesh``/``param_spec`` arguments of
``InferenceEngine`` / ``DecodeEngine`` / ``ModelRegistry.deploy``.

**Scale-out** (replica routing) is this package:
:class:`~.router.FleetRouter` fronts N ``ModelServer`` replicas by URL
with least-loaded dispatch (admission EWMA x backlog, polled from each
replica's ``/metrics.json``), readyz-aware membership, and the
tail-tolerance layer: budgeted failover and hedged requests drawing from
one fleet-wide :class:`~.router.RetryBudget`, outlier ejection over
actual dispatch outcomes with probe re-admission, brownout shedding by
``X-Priority`` when ready capacity drops, and consistent-hash session
affinity (``X-Session-Id`` / prompt-prefix fingerprint) that pins a chat
session's turns to the replica whose decode engine holds its KV blocks.
:class:`~.router.FleetServer` is the HTTP front door;
``python -m deeplearning4j_tpu_torch.serving.fleet --replicas ...`` runs
it standalone. The router is host code over HTTP: it needs no card.

Minimal flow::

    from deeplearning4j_tpu_torch.serving import ModelRegistry, ModelServer
    from deeplearning4j_tpu_torch.serving.fleet import (FleetRouter,
                                                        FleetServer)

    # each replica: deploy + HTTP server
    registry = ModelRegistry()
    registry.deploy("mnist", "v1", net, example=x)
    port = ModelServer(registry).start()

    # the front door
    router = FleetRouter([f"http://127.0.0.1:{port}", ...])
    front = FleetServer(router)
    front.start()                      # clients talk to this one URL

**Observability plane**: every dispatch attempt (primary / retry / hedge
/ affinity_fallback) records a ``fleet/attempt`` span under the inbound
trace context and forwards ``traceparent``, so the fleet's ``GET
/debug/trace/<id>`` stitches the front door's attempts with each
replica's server-side tree. :class:`~.aggregator.FleetAggregator` rides
the poll loop, folding each replica's ``/metrics.json`` into a bounded
ring with per-type merge semantics (counters summed with restart-reset
detection, gauges last-value-per-replica, histograms bucket-wise summed
so merged percentiles are exact); the fleet serves ``GET /metrics`` +
``/metrics.json`` (per-replica series labeled ``replica`` plus merged
series) and ``GET /fleet/signals``, the autoscaler feed.

Env knobs: ``DL4J_TPU_FLEET_POLL_S``, ``DL4J_TPU_FLEET_RETRIES``,
``DL4J_TPU_FLEET_TIMEOUT_S``, ``DL4J_TPU_FLEET_RETRY_BUDGET``,
``DL4J_TPU_FLEET_HEDGE_PCTL``, ``DL4J_TPU_FLEET_BROWNOUT_FRAC``,
``DL4J_TPU_FLEET_DEFAULT_PRIORITY``, ``DL4J_TPU_FLEET_AGG_RETENTION_S`` /
``DL4J_TPU_FLEET_AGG_MAX_SAMPLES`` (see :mod:`.router` for the telemetry
families).
"""
from .aggregator import (FleetAggregator, histogram_quantile,  # noqa: F401
                         render_prometheus_text)
from .router import (FleetRouter, FleetServer, MidStreamError,  # noqa: F401
                     NoReplicaError, Replica, RetryBudget,
                     prompt_fingerprint)
