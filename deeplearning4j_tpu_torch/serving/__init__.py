"""Model serving: the HTTP front end over the port's ``InferenceEngine``
and ``DecodeEngine``.

Counterpart of the JAX package's ``serving/`` (the multi-replica router
is ``serving.fleet``): a versioned
registry with warm-before-cutover hot swap, rollback and the
quantized-deploy divergence gate (``registry.ModelRegistry``), admission
control with deadlines and load shedding (``admission``), per-version
circuit breakers and the dispatch watchdog (``resilience``), per-model
SLOs gating ``/readyz`` (``slo``), the stdlib HTTP server
(``server.ModelServer``) and the SIGTERM drain sequence
(``lifecycle.GracefulLifecycle``)::

    from deeplearning4j_tpu_torch.models.causal_lm import (CausalLM,
                                                           CausalLMConfig)
    from deeplearning4j_tpu_torch.serving import (GracefulLifecycle,
                                                  ModelRegistry,
                                                  ModelServer)

    registry = ModelRegistry()
    registry.deploy("lm", "v1", CausalLM(CausalLMConfig()))  # warms first
    server = ModelServer(registry, port=8000)
    server.start()
    GracefulLifecycle(registry, server).install()   # SIGTERM drains
    # POST /v1/models/lm/generate {"prompt": [1, 5, 9], "max_tokens": 32}

    registry.deploy("mnist", "v1", net, example=x)   # a MultiLayerNetwork
    # POST /v1/models/mnist/predict {"inputs": [[...], ...]}
    registry.deploy("resnet", "v1", graph, example=x)  # a ComputationGraph
    # answers {"outputs": [[...]]}, one list per output vertex

    registry.deploy("qa", "v1", sd, outputs=["start_logits"],
                    example={"input_ids": ids[:1], ...})   # a SameDiff
    # POST /v1/models/qa/predict {"inputs": {"input_ids": [[...]], ...}}
    # answers {"outputs": {"start_logits": [[...]]}}

Env knobs (the JAX package's names): ``DL4J_TPU_SERVING_{MAX_CONCURRENT,
QUEUE_DEPTH,HIGH_WATER,TIMEOUT_S,DRAIN_TIMEOUT_S,RETAIN,MANIFEST_DIR}``,
``DL4J_TPU_SLO_{OBJECTIVE,LATENCY_MS,WINDOWS,READYZ}``,
``DL4J_TPU_REQUEST_RING``, ``DL4J_TPU_DEBUG_ENDPOINTS``,
``DL4J_TPU_PROFILE_DIR``, ``DL4J_TPU_FLIGHT_RECORDER_DIR``,
``DL4J_TPU_BREAKER_{THRESHOLD,PROBE_S}``,
``DL4J_TPU_AUTO_ROLLBACK{,_OPENS}``, ``DL4J_TPU_WATCHDOG_FACTOR`` and
``DL4J_TPU_QUANT{,_MAX_DIVERGENCE,_MIN_TOP1}``, and for the
``InferenceEngine`` ``DL4J_TPU_INFERENCE_{BUCKETING,MAX_BATCH}``.
"""
from ..runtime.inference import PoisonRequestError  # noqa: F401
from .admission import (AdmissionController, DeadlineExceededError,  # noqa: F401
                        ShedError)
from .lifecycle import GracefulLifecycle  # noqa: F401
from .registry import (READY, RETIRED, WARMING, ModelRegistry,  # noqa: F401
                       ModelVersion)
from .resilience import (BreakerOpenError, CircuitBreaker,  # noqa: F401
                         EngineWatchdog, HealthRegistry, health, watchdog)
from .server import ModelServer, RequestRing  # noqa: F401
from .slo import SLOTracker  # noqa: F401
