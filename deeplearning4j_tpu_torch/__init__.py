"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of deeplearning4j_tpu.

The port runs on one NVIDIA H100: plain tensor code is PyTorch, and each
Pallas TPU kernel of the JAX package becomes a CUDA C++ kernel written for
Hopper (``kernels/csrc/``), built at first use. Module paths mirror the
JAX package's, so each part has an obvious counterpart there. The port
imports neither JAX nor the JAX package.

Ported so far:

- the CausalLM serving path — ``runtime.generation``'s ``DecodeEngine``
  over ``models.causal_lm``'s paged KV pool, its int8 twin
  (``quant.transforms.quantize_model``), the paged-flash decode kernel
  and the fused int8 dequant-matmul kernel::

    from deeplearning4j_tpu_torch.models.causal_lm import (CausalLM,
                                                           CausalLMConfig)
    from deeplearning4j_tpu_torch.runtime.generation import DecodeEngine

    engine = DecodeEngine(CausalLM(CausalLMConfig(), device="cuda"))
    engine.generate_sync([1, 2, 3], max_tokens=16)

- the HTTP serving layer over it (``serving``: ``ModelRegistry``,
  ``ModelServer``, admission, SLOs, circuit breakers and the SIGTERM
  drain) and the rest of ``quant`` (``QuantSpec``, ``calibrate``, the
  ``validate`` divergence gate, the fp8 mode)::

    from deeplearning4j_tpu_torch.serving import ModelRegistry, ModelServer

    registry = ModelRegistry()
    registry.deploy("lm", "v1", CausalLM(CausalLMConfig(), device="cuda"))
    ModelServer(registry, port=8000).start()   # POST /v1/models/lm/generate

  and, over several such servers, the fleet front door
  (``serving.fleet``: ``FleetRouter``, ``FleetServer``);

- BERT masked-LM training (``models.bert``: forward, loss, backward and
  Adam) and its QA head, with the flash-attention forward, dq and dk/dv
  kernels (``kernels.flash_attention``)::

    from deeplearning4j_tpu_torch.models import bert

    cfg = bert.BertConfig.base()
    params = bert.init_params(cfg, seed=0)
    opt = bert.init_opt_state(params)
    step = bert.make_scanned_train_step(cfg, 10, use_flash=True,
                                        remat=False)
    params, opt, losses = step(params, opt, batch, 0)

- the DL4J layer API's sequential path (``nn``: the configuration DSL,
  ``MultiLayerNetwork`` training and inference, the CNN layers;
  ``learning``, ``ndarray``, ``datasets``, ``zoo``), whose int8 twin
  runs its dense layers through the dequant-matmul kernel::

    from deeplearning4j_tpu_torch.zoo import LeNet

    net = LeNet(dtype="bfloat16").init_model(device="cuda")
    net.fit(datasets, num_epochs=5)             # a list of DataSets
    probs = net.output(x)

  served through ``runtime.inference``'s ``InferenceEngine`` (bucket
  ladder, ``submit()`` micro-batcher, poison quarantine, warmup
  manifests), which ``ModelRegistry.deploy`` puts behind
  ``POST /v1/models/<name>/predict``;

- the layer API's DAG network (``nn.graph``: ``GraphBuilder``, the
  vertices, ``ComputationGraph`` training and inference with
  ``MultiDataSet``) and the graph zoo (ResNet-50, SqueezeNet,
  InceptionResNetV1, FaceNetNN4Small2), whose int8 twin sends its dense
  head through the dequant-matmul kernel and serves behind the same
  predict route::

    from deeplearning4j_tpu_torch.quant import quantize_model
    from deeplearning4j_tpu_torch.zoo import ResNet50

    net = ResNet50(dtype="bfloat16").init_model(device="cuda")
    net.fit(datasets, num_epochs=2)             # DataSets of [B, 3, 224, 224]
    probs = net.output(x)[0]                    # one entry per output vertex
    registry.deploy("resnet", "v1", quantize_model(net), example=x[:1])

- SameDiff (``autodiff``: the define-then-run graph, its namespaces,
  control flow, training, listeners and the zip format), over the op
  registry (``ops``: every op of the JAX package under its name, the
  families not ported yet listed as pending), served behind the same
  predict route with a placeholder dict a request::

    from deeplearning4j_tpu_torch.autodiff import SameDiff

    sd = SameDiff.create()                      # on the card
    x = sd.placeholder("x", (None, 4))
    y = sd.nn.softmax(x.mmul(sd.var("w", w)))
    probs = sd.output({"x": xs}, [y])[y.name]
    registry.deploy("sd", "v1", sd, outputs=[y.name], example={"x": xs})

- training parallelism on ``torch.distributed`` (``parallel``,
  ``common.mesh``, ``nn.sharding``): the mesh and its collectives, the
  sequence-parallel ring over the flash kernels, BERT's tensor, FSDP,
  sequence and pipeline steps, ``distribute`` and ``ParallelWrapper``,
  checkpoints that restore onto another mesh; every rank runs the same
  program on the same global batch::

    python -m deeplearning4j_tpu_torch.parallel.dryrun --world 8 --device cpu

Every entry point runs on the card unless the caller passes
``device="cpu"``; on the CPU each kernel's plain PyTorch version runs.
"""

from .common.config import get_environment  # noqa: E402,F401
