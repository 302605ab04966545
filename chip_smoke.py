#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
(the CausalLM, BERT-base, the layer API's LeNet, quantized MLP and
ResNet-50, a SameDiff BERT-base QA graph, the Seq2Seq LSTM,
TextGenerationLSTM and Word2Vec, YOLO2 and the convolution zoo, directly,
behind the predict route and behind the fleet front door).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without printing a result:

1. device   — refuse to run without CUDA; print ``nvidia-smi``'s card name
              and power limit.
2. build    — compile every CUDA kernel of the path from
              ``deeplearning4j_tpu_torch/kernels/csrc`` (one nvcc each, in
              parallel) and print the build seconds and what ``ptxas``
              said; a kernel that spills registers fails the phase.
3. parity   — each kernel against its plain PyTorch version on the card,
              in bf16, at the serving shapes (the paged read also at
              lengths that end on and one past a split boundary; the
              dequant-matmul at M = 8, 40, 4096 and around its
              crossovers; two calls must give the same bits) and, for
              the three flash kernels (forward, dq, dk/dv), at BERT's
              training shape (B=128, T=128, 12 heads of 64) and longest
              position (B=32, T=512), gradients against autograd
              through the plain version (tolerances below), and a
              second kernel forward and backward with the same o, lse,
              dq, dk and dv bits.
4. serve    — the full-width CausalLM (vocab 32000, hidden 768, 12 layers,
              bf16, random weights from a seed) behind
              ``DecodeEngine(slots=8, max_ctx=1024, kv_block_size=16)``:
              warmup, then 16 requests (prompts 17..700 tokens, some
              sharing a 256-token prefix, 64 new tokens each).
5. int8     — the same model's int8 twin (``quantize_model``) serving a
              few requests through the fused dequant-matmul kernel.
6. spec     — speculative decoding with a 2-layer draft of the same
              width (spec_k=4).
   serve_http — the same model behind the HTTP front door
              (``serving.ModelRegistry`` + ``ModelServer`` on 127.0.0.1):
              one greedy request alone must give the tokens a direct
              ``DecodeEngine`` of the same configuration gives alone; then
              phase 4's 16 requests at once from client threads (3
              streamed as ndjson) in a process of their own
              (``chip_smoke.py --http-clients``), timed against the direct
              engine serving the same 16 at once; then ``deploy(quantize="int8")`` of the
              twin under the default divergence gate, served if the gate
              accepts it, else the rejection is checked (v1 stays current,
              the incoming engine's pool is freed) and the twin deploys as
              ``lm:v2b`` under the explicit ``SERVE_GATE_FALLBACK``
              budget; then ``rollback("lm")`` and ``drain_all()``. Its
              own path for the launch counts: both serving kernels'
              counts start at 0 after the direct engine's runs, and each
              deploy and each run of requests between two deploys reads
              its own; v1's requests must launch the paged kernel and the
              twin's 4 requests both kernels.
   fp8      — the model's fp8 twin (``QuantSpec(mode="fp8")``): its
              ``dequant_matmul`` (activation scale and cast,
              ``torch._scaled_mm``, output scale and cast) against the same
              route with the f32-upcast plain product (``FP8_*``
              tolerances), both timed whole at M = 8 and 4096 for
              768->3072, with ``_scaled_mm`` and its output scale alone
              beside them; its logit divergence
              from the bf16 model; 4 greedy requests through a
              ``DecodeEngine``.
   checks   — one full-width ``paged_decode`` step through the kernel
              against the same step through the plain read, and the int8
              twin's logit divergence from the bf16 model.
   step     — where one full-width decode step's time goes (host clock,
              and device time by kernel from ``torch.profiler``), for the
              bf16 model and its int8 twin. A serving kernel's share sums
              every ``__global__`` function of its source; a wrapper that
              launched in the profiled steps with a share of 0 fails the
              phase.
   graphs   — the captured serving steps (``runtime/cuda_graphs.py``).
              The bf16 model, its int8 twin and the model with the spec
              phase's 2-layer draft (k = 4), each behind two engines: one
              capturing its steps, one keeping the same step bodies eager
              (``eager:reference``); each engine warmed twice with the
              census counted from 0 (it must equal ``len(ladder) *
              len(batch ladder) + 1``, +1 with the draft, and the second
              warmup add none), then serving phase 4's 16 requests, all
              queued before its loop reads the queue (so both engines
              batch alike), the census and every launch count set to 0
              just before: no new census event, the 13 greedy prompts'
              tokens identical between the two engines, the 3 sampled
              prompts' agreement printed, and the captured engine's
              launches held exactly to the step counts (the paged read
              12 a decode step, 12 + 2 x 5 a spec step; the dequant
              kernel 24 a twin's prefill or decode step), counted on
              replay (the kernels line's serving rows carry them as
              ``launches_graphs``). Then the engine's own decode step over 8 slots at
              the step phase's lengths, replayed and eager: host ms,
              device ms and busy share (bf16 and int8). Then LeNet
              (bf16) and the MLP's int8 twin through ``InferenceEngine``
              warmed over 1..128: every rung bitwise against the eager
              forward, no census event after warmup, 5 dequant launches
              a twin dispatch; and LeNet served, one ``fit`` step, served
              again: the answer must be the forward on the new params.
              (The SameDiff QA graph's signatures, captured or eager with
              their reasons, print in ``samediff_bert`` as
              ``graphs_samediff``.)
7. train    — BERT-base masked-LM training (vocab 30522, hidden 768, 12
              layers, bf16, random weights from a seed) at B=128, T=128:
              ``make_scanned_train_step(n_steps=10, use_flash=True,
              remat=False)``, captured on its first call (the step
              replayed 10 times a call, the three flash kernels inside
              its graph), then a timed call of replays whose flash
              launches must be 12 x 10 each; the same step with
              ``use_flash=False`` (kept eager) from the same params and
              batch for its first loss.
   train_step — where one replayed train step's device time goes, by
              kernel (each flash wrapper's share sums the ``__global__``
              functions of its source; a wrapper that launched with a
              share of 0 fails the phase); host ms, device ms, busy
              share, launch calls and device records a step against the
              same step kept eager (``eager="reference"``); the
              replayed params, Adam moments and losses against two
              eager runs of the same calls from the same start (bit for
              bit where those agree, else within twice their spread);
              device records equal both ways (the profiled pair taken
              again until they are), 12 flash launches of each
              kernel a step both ways; then ``make_train_step(remat=
              True)`` captured and replayed 3 calls against eager, the
              forward launched twice a layer and step. Each step's
              graph pool is released when it is done.
   parallel — (run last, after every profiler reading of the script's
              own process, whose readings it must not disturb; its
              launches go into the kernels line) training parallelism
              on ``torch.distributed``. First
              BASELINE config 5 (``ParallelWrapper``) at config 2's
              width: ResNet-50, B=128, bf16, 10 steps on a world-1 NCCL
              group (in a rank process of its own: NCCL never starts in
              the script's process), then the same batches through
              ``fit`` from the same weights: both loss trajectories, their largest difference,
              the first loss and the first update's length held
              against fit's,
              samples/s of both and the NCCL all-reduces issued (> 0).
              Then one spawn of 2 ranks sharing ``cuda:0`` over gloo
              (NCCL refuses two ranks on one device; the collectives
              stage CUDA tensors through host memory, ``transport``
              "gloo-host-staged"): BERT-base at T=512, B=8, sp=2 with the
              flash ring, 3 steps, loss and global gradient norm against
              the single-process step with the full-sequence flash
              kernel; the flash ring alone at BERT-base's heads (causal
              and not, a batch row with no live key) against
              ``flash_attention`` over the whole sequence; tp=2 and pp=2
              (1F1B, 6 layers a stage, 4 microbatches), one step each,
              against the single-process loss; ResNet-50 in f32 at world
              2 (64 rows a rank), 3 steps against ``fit`` on the same
              global batches (the first loss, the running statistics
              and the update of the first step must be the global
              batch's); a
              checkpoint saved on 2 ranks, restored
              and stepped on 1. Each leg prints its error, step ms
              (host clock), the transport and the flash launches a rank
              and step; the flash rows of the kernels line carry
              ``launches_parallel`` (the sp=2 leg's, both ranks), which
              must be > 0. Numbers from this rig are correctness and
              kernel readings, not scaling: one card.
   sharded_serve — (after parallel, in rank processes too) sharded
              serving on ``torch.distributed``. A world-1 NCCL rank
              deploys the full-width CausalLM with
              ``mesh=serving_mesh()`` behind a ``ModelServer``: every
              greedy prompt of phase 4 over HTTP, one at a time, must
              give the tokens a direct unsharded engine gives alike,
              ``/v1/models`` must list ``mesh_shape`` and
              ``"auto(model)"``; then both engines' tokens/s with those
              prompts at once. Then 2 gloo ranks on ``cuda:0`` at
              model=2 (6 of 12 heads a rank), the model given small
              random biases: teacher-forced logits (a prompt's prefill
              and ``SHARD_FORCED`` decode steps) within
              ``SHARD_LOGIT_ATOL`` of one process, and the same logits
              with ``bo`` and ``b2`` added twice beyond it; the bf16
              engine, the same with the spec phase's 2-layer draft
              (k = 4) and the int8 twin each serving 4 of phase 4's
              prompts, every launch count set to 0 just before (each
              rank's paged-read and dequant launches held to the count
              the leader's step counts give, 24 all-reduces a step
              held, the KV pool's bytes a rank held
              to half the unsharded pool's, the follower refusing
              ``generate`` and ending at the leader's ``close()``, the
              greedy-token agreement with one process reported); an f32
              model at depth 2 must give one process's greedy tokens;
              the MLP (bf16) and its int8 twin through
              ``InferenceEngine(mesh=)`` within rtol 1e-5 / atol 1e-6
              of the unsharded engine with identical argmax. The
              kernels line carries the paged read at 6 heads (Q = 1
              and 5) and the dequant kernel on a rank's ``w1`` and
              ``w2`` slices, each held against its plain version and
              timed in the script's process, with ``main_path``
              "sharded_serve" and that path's launches (both ranks).
   bert_forward — one BERT-base forward (encode + MLM head) through the
              kernel against the plain attention, B=8, T=128.
   causal   — the full-width CausalLM ``forward(use_flash=True)`` against
              ``use_flash=False``, B=4, T=1024.
   lenet    — LeNet-MNIST training through the layer API
              (``zoo.LeNet(dtype="bfloat16").init_model()``,
              ``MultiLayerNetwork.fit``) on 32 device-staged random
              batches of 128: 1 warm epoch, then 5 timed (host clock),
              samples/s, the device ms a step by kernel and the busy
              share (one more epoch under ``torch.profiler``); the loss
              (``score()``'s mean over the 32 batches) must fall from the
              first epoch to the last. Then an f32 copy of the trained
              weights: its ``output()`` on the card against the CPU's
              with TF32 switched on in the process (``LENET_F32_ATOL``),
              and, for scale, the same forward with the port's TF32 guard
              taken away.
   data     — the data pipeline (``etl/``, ``native/``, the record
              iterators). The native C++ library built with ``g++`` (its
              seconds; the phase fails without it); an IDX file of
              MNIST's training shape (60,000 x 28 x 28 u8 and its labels,
              from a seed) read by ``native.read_idx`` and by the numpy
              reader (both times, equality) and by ``parse_idx`` (the
              native route's float32); full-width LeNet (bf16, B=128)
              fitted over one epoch of it three ways after a warm epoch:
              fed by ``NativeBatchDataSetIterator(device="cuda")`` (the
              C++ ring's pinned batches, the per-step captured path), by
              the same epoch's batches pre-staged on the card
              (``ListDataSetIterator``, the epoch path) and by
              ``AsyncDataSetIterator`` over the same batches on the host;
              each with samples/s, host ms a step, the ``train/data_wait``
              share of the epoch, the time ``next()`` blocked on the ring,
              the busy share (device ms a step from the profiler over 32
              steps fed the same way) and the census (no event on a
              repeat fit, every signature captured and replayed). The card ring's epoch
              against the CPU ring's, bit for bit; the params after the
              same 3 steps ring-fed against pre-staged. Then the tabular
              path: a CSV of 20,000 rows (30 numeric columns, 2
              categorical, a label of 10 classes) through a
              ``TransformProcess`` (one-hot, a filter, a product column,
              min-max of the 30 columns from ``analyze_local``) into
              ``RecordReaderDataSetIterator(device="cuda")`` and an MLP's
              ``fit`` for 3 epochs: records/s, fit samples/s, the loss of
              each epoch (it must fall).
   graphs_train — the captured ``fit`` steps (``nn/fit_fastpath.py``
              over ``runtime/cuda_graphs.py``), cuDNN deterministic.
              LeNet (bf16, Adam, B=128), the same LeNet with dropout on
              its dense layer and TextGenerationLSTM (B=32), each as two
              networks from one seed: one replaying its captured steps,
              one running the same bodies eagerly (``eager:reference``).
              Both take the same fits over 8 staged batches: census
              ``["epoch"]`` on the first, none on a repeat, ``["train"]``
              on the per-step path (a listener); every signature of the
              replaying network ``captured``. LeNet and TextGenerationLSTM:
              host ms a step over 2 epochs, device ms, launch calls and
              device records a step (one epoch under the profiler) and
              the busy share, both ways; the device records a step must
              be equal. Both LeNets must end with the same params,
              updater state and losses bit for bit. Then ResNet-50
              (config 2, B=128) for 4 steps captured and twice eager:
              the captured params within twice the two eager runs'
              largest difference, each run's peak memory. Last, the
              memory the dropped networks held must be back.
   mlp_int8 —bench.py's quantized MLP (dense 512->2048 gelu, 3 x
              2048->2048 gelu, softmax 2048->64) at B=128 through
              ``output()`` three ways: f32, bf16 over the same params and
              the int8 twin (``quantize_model``), samples/s the median of
              5 windows of 60 calls; on a margin-filtered batch the
              twin's top-1 agreement with f32 (>= the gate's 0.99) and
              max error; ``param_bytes_of`` both; ``divergence_report``
              and ``calibrate`` on the twin. Its own main path: the
              dequant count set to 0 before the twin's timed calls, which
              must launch the kernel 5 times each.
   predict_http — the layer API behind the predict route: one
              ``ModelServer`` over a ``ModelRegistry`` serving
              ``zoo.LeNet(dtype="bfloat16")`` and the MLP's int8 twin
              (``deploy(quantize="int8")`` with a calibration batch),
              each ``InferenceEngine`` warmed over the ladder 1..128
              with a 2 ms coalescing window. 16 client processes
              (``chip_smoke.py --http-clients``) send 32 requests each,
              of 1-16 rows from seeded pools, alternating the two
              models; every answer is held against the deployed model's
              own ``output()`` on the same rows (``*_PREDICT_ATOL``), the
              twin's top-1 against its own output (1.0) and the f32
              network's (>= 0.99). Prints samples/s, client p50 / p99,
              rows per dispatch, the shape census after warmup (must be
              0), dequant launches per twin dispatch (must be 5) and
              ``launches_predict_http``: its own main path, the dequant
              count set to 0 just before the clients start. Then one
              poison request (511 features) among live twin traffic must
              get 422 with a ``trace_id`` while every live request is
              answered correctly.
   fleet    — two ``ModelServer`` replicas of the twin in this process
              behind ``FleetServer(FleetRouter(...))``: 200 predicts
              from 4 client threads through the front door, the second
              replica stopped once a third are answered; every answer
              checked as above, the front door's ``/metrics.json`` must
              hold both replicas' ``dl4j_serving_requests_total`` series
              and their merged sum. Prints fleet samples/s against one
              replica's (the same clients straight at one replica),
              attempts by kind and ejections.
   resnet50 — ResNet-50 at BASELINE config 2's width through the
              ComputationGraph (``zoo.ResNet50(num_classes=1000,
              input_shape=(3, 224, 224), dtype="bfloat16")``, stages
              [3, 4, 6, 3], ``Nesterovs(0.1, 0.9)``) on 4 device-staged
              random batches of 128: 2 epochs with a loss a step (the
              first includes cuDNN's algorithm choice), one epoch timed
              (host clock: samples/s, ms a step), one under
              ``torch.profiler`` (device ms a step by kernel, busy
              share); the losses must be finite and changing. Then an
              f32 copy of the trained weights: its B=2 ``output()`` and
              pooled features (the head's input, which one-hot softmax
              rows cannot hide) on the card against the CPU's with TF32
              switched on in the process (``RESNET_F32_ATOL``,
              ``RESNET_F32_FEATURE_RTOL``).
   resnet50_int8 — the trained network's int8 twin (``quantize_model``:
              convolution weights dequantized at use, the 2048->1000 head
              through the dequant kernel's f32 route): ``output()`` at
              every rung 1..128, one kernel launch each; top-1 agreement
              with the bf16 network, ``divergence_report`` and, at the
              head's input, the twin's error against the bf16 network;
              ``InferenceEngine.infer`` and ``output()`` host ms at each
              rung; the host ms of the bf16 network's per-dispatch param
              casts and of the twin's convolution dequantizes. Then the
              twin deployed in a ``ModelRegistry`` (max_batch 16) behind
              a ``ModelServer``: 4 client processes send 16 requests each
              of 1-4 images from a seeded pool, every answer held against
              the twin's own ``output()`` (``RESNET_PREDICT_ATOL``);
              prints samples/s (paced by the server's JSON parsing, ~1.5
              MB an image), client p50 / p99, rows a dispatch, the census
              after warmup (must be 0) and ``launches_resnet50_int8``:
              its own main path, the dequant count set to 0 just before
              the clients start (one launch a dispatch).
   transfer — the trained ResNet-50 saved with its updater state
              (``net.save``) and restored on the card
              (``ComputationGraph.load``, ``restore_model``,
              ``ResNet50.init_pretrained(path=)``): output, params,
              updater leaves, iteration and epoch bit-identical; its
              batch-norm running statistics refreshed by 20 ``NoOp``
              steps, then ``TransferLearning.GraphBuilder`` (Adam 1e-3,
              body frozen up to ``avgpool``, a 10-way head) fit by
              ``EarlyStoppingTrainer`` over a ``BenchmarkDataSetIterator``
              through a ``NormalizerStandardize`` (at most 3 epochs,
              stopping after one without improvement, a
              ``DataSetLossCalculator``, a ``LocalFileModelSaver`` and a
              ``CheckpointListener`` keeping 2): the frozen params and
              running statistics bit-identical, the head changed, the
              best model from disk equal to the copy saved, 2 zips left;
              a ``ShardedCheckpointer`` keeping 2 of 3 steps restores
              bit-identically; a fine-tune step's host and device ms by
              kernel class beside the full step's; the phase's spans
              exported (``tracing.export``) and aggregated
              (``profile_analyzer``).
   samediff_bert — a SameDiff BERT-base SQuAD fine-tune (BASELINE
              config 3): ``samediff_qa_graph`` records the QA model at
              ``BertConfig.base()`` width (108,893,186 parameters) into a
              ``SameDiff`` on the card, f32, T=384, random weights from a
              seed; ``fit`` over 8 device-staged ``MultiDataSet``s of
              B=32 under ``Adam(5e-5)``, one warm epoch, 2 timed (host
              clock: samples/s, ms a step), one under ``torch.profiler``
              (device ms a step by kernel class, busy share), peak
              memory; the first loss within 1.0 of ln 384 and the last
              epoch's mean below the first's. Then ``output()`` at B=2
              against a CPU copy of the trained weights
              (``SD_F32_ATOL``), bucketed ``output()`` at 3 and 5 rows
              against exact, ``save`` and ``SameDiff.load(device=
              "cuda")`` with the same output bits, and the graph behind
              the predict route as ``sdbert:v1`` (warmed over 1..8): 8
              client processes send 16 placeholder-dict requests each of
              1-4 sequences, every answer held against the graph's own
              ``output()`` (``SD_PREDICT_ATOL``); prints samples/s, p50 /
              p99 and the census after warmup (must be 0). The path runs
              none of the five kernels (the JAX package's SameDiff
              attention is plain XLA).
   precision — the same QA graph and batches, 4 ``fit`` steps from the
              same weights at ``matmul_precision`` "highest" and at
              "high": samples/s, device and GEMM ms a step and the GEMM
              kernels' names; TF32 GEMMs under "high" only, finite losses
              whose first values agree within 1e-2, the property and the
              TF32 flags restored.
   modelimport — BASELINE config 3 as specified: BERT-base (hidden 768,
              12 layers, 12 heads, intermediate 3072, vocab 30522,
              max_pos 512) imported from a TF1 GraphDef into a SameDiff on
              the card. The graph is ``tests/test_modelimport.py::
              build_tf1_bert``'s, committed as a skeleton
              (``tests/torch_data/bert_base_skeleton.pb``) whose 440 MB of
              weights ``tests/torch_import_cases.py::fill_graphdef``
              writes from a seed; imported at B=8, T=128 with the mask
              zeroing the last 28 positions: GraphDef MB, nodes, parse
              and map seconds, SameDiff ops, parameters; ``output()`` of
              the sequence and pooled outputs (host ms and device ms
              from the profiler a call, each the median of 5, busy
              share, peak MB); both against the same
              bytes imported on the CPU (``IMPORT_ATOL``, TF32 off);
              ``save_flatbuffers`` then ``load_samediff_fb(device=
              "cuda")``, the outputs bit for bit, file MB and seconds;
              then at small width ``OnnxRunner`` (the ONNX MLP and
              residual block) and ``GraphRunner(backend="native")`` (the
              tiny BERT GraphDef) on the card against their CPU runs. The
              imported graph runs none of the five kernels (attention is
              ``BatchMatMulV2`` and ``Softmax``).
   keras_import — Keras's ``ResNet50V2(weights=None)`` (25,613,800
              parameters) from its committed h5 skeleton
              (``tests/torch_data/resnet50v2_skeleton.h5``, no weight
              written) filled from a seed by ``tests/torch_keras_cases.py``
              (numpy and the port's HDF5 reader), imported with
              ``import_keras_model_and_weights(device="cuda")`` and run
              with ``output()`` at B=8, 224x224, NCHW, f32: h5 MB, fill /
              read / import s, vertices, layers, parameters, host and
              device ms a call (median of 5), busy share, peak MB; held to
              Keras's committed golden of the same file and to the same
              file imported on the CPU at atol and rtol 1e-4 (TF32 off),
              with the argmax rule of ``tests/test_keras_applications.py``.
              Then at small width, each on the card against the CPU: the
              TFLite MLP and CNN (committed files, against their TF
              Interpreter goldens), the zoo's LeNet as a DL4J zip through
              ``init_pretrained`` and ``OmniHub.load``, and 20 LeNet
              ``fit`` steps under ``StatsListener``s (memory and file
              storage, a ``UIServer`` on an ephemeral port read back over
              HTTP), with the listener's host ms a step against the same
              steps without its work. No kernel of the five runs here.
   seq2seq  — BASELINE config 4's Seq2Seq LSTM at bench.py's widths
              (``models.seq2seq``: vocab 8000, embed 256, hidden 512,
              f32 without TF32, B=128, S=32, ids from ``RandomState(0)``,
              Adam 1e-3), its step captured: one warm step (which
              captures), 30 timed (host clock: samples/s, ms a step),
              the phase's own peak memory; the same calls of the same
              step kept eager, twice from the same start, the replayed
              params, moments and losses against the eager ones as in
              train_step; then 3 more steps each way under
              ``torch.profiler`` (device ms a step by kernel class,
              launch calls, device records equal both ways, busy
              share); the first loss (about ln
              8000) against a CPU copy of the same weights
              (``S2S_LOSS_ATOL``), the 30th below it, the census after
              warmup (must be 0), and
              ``greedy_decode(max_len=32)`` on 8 rows token-identical to
              ``greedy_decode_recompute`` on the card.
   text_lstm — ``zoo.TextGenerationLSTM`` (2 x LSTM-256 over 77
              characters x 40 steps) through ``MultiLayerNetwork.fit`` on
              16 device-staged batches of 32 random one-hot sequences, 2
              epochs timed, 4 steps profiled; bucketed ``output()`` at 3
              rows against exact, and a ``MaskLayer``-fronted twin over the
              same weights with half of 8 sequences right-padded: its
              ``output()`` and masked ``score()`` against a CPU copy
              (``TEXT_ATOL``), each padded row held at its last valid
              step.
   word2vec — (a) bench.py's ``skipgram`` op (vocab 30000, dim 128,
              B=1024, K=5): one round against the op on a CPU copy
              (``W2V_ROUND_ATOL``, the inputs left unchanged), 200
              chained rounds (pairs/s, host and device us a round,
              launches) beside the round's byte bound; (b)
              ``Word2Vec.fit`` for one epoch of a seeded Zipf stream of
              500k tokens over 30000 words (layer 128, window 5, K=5,
              batch 2048): tokens/s, the wall split into set-up, the
              host's pair and negative generation and the device steps,
              device ms a batch; then the JAX package's planted
              two-topic corpus, skip-gram and CBOW, must cluster. The
              recurrent and NLP phases run none of the five kernels (no
              recurrent, NLP or seq2seq module of the JAX package
              reaches a ``pallas_call``).
   yolo2    — ``zoo.YOLO2`` at its published width (20 VOC classes,
              3x416x416, 5 anchors, a 125-channel 13x13 head, bf16, Adam
              1e-3): 64 seeded 375x500x3 images resized on the card by
              the port's ``resize_bilinear``, labels of 1-4 boxes an
              image; ``ComputationGraph.fit`` at B=32, one warm step and
              10 timed steps on one batch (losses must be finite and
              fall), one step profiled (device ms by kernel group, busy
              share, peak memory), the loss head's own forward and
              backward; then ``InferenceEngine(max_batch=16)`` warmed over
              its ladder answers 32 requests of 1-4 images submitted
              together, each held against ``output()`` on the same rows
              (``YOLO_SERVE_RTOL``) with a census of 0 after warmup; then
              an f32 copy on the card against the CPU on 2 images
              (``YOLO_F32_RTOL``, TF32 switched on in the process).
   zoo_cnn  — Xception (224, 1000 classes, bf16, B=64), UNet (512,
              64 base filters, f32, B=4, binary masks) and NASNet (224,
              4 blocks, 1056 penultimate filters, bf16, B=32) at their
              zoo widths: one warm step, 3 timed, one profiled, with the
              depthwise kernels' share; TinyYOLO's ``output()`` at B=32
              (bf16) and its ``fit`` refusing the YOLO2 head as the JAX
              package's does.
   ops_card — each op name of the convolution and image families (and
              ``deconv2d_bp``, ``avgpool3dnew_bp``) and of the op tail
              (bitwise, compression, segment with its 11 bp ops, the
              linear-algebra decompositions, the parity tail, strings,
              lists; ``gelu(approximate=False)``, ``cross(axis=0)``) on
              the card against a CPU copy of the same draw, at the CPU
              op tests' tolerances (``qr``, ``svd``, ``eig`` and
              ``self_adjoint_eig`` by reconstruction and invariants; the
              string ops, ``hashcode`` and ``broadcastgradientargs``,
              whose JAX results are host values, equal on the host).
   opbench  — ``benchmarks/opbench.py``'s whole-registry sweep on the
              card at N = 512 (``OPBENCH_ITERS`` calls and CUDA-graph
              replays an op): counts and names benched, skipped,
              excluded and not captured (a capture that recorded no
              kernel, a view or host work, is not timed: its kind
              ``empty_graph``), the 10 slowest ops, the
              phase's seconds, the names the JAX CPU sweep
              (``OPBENCH_cpu_baseline.json``) benched that the card did
              not, with reasons; the JSON to ``OPBENCH_OUT``. A
              registered name neither benched, skipped nor excluded, or
              an op skipped on the card that its CPU copy benches, fails
              the phase. None of these phases reaches one of the five
              kernels: no convolution, image or op-tail module of the
              JAX package reaches a ``pallas_call``.
   empty_graphs — every capture of this process's ``StepGraphs`` that
              recorded no kernel (each runs eagerly,
              ``eager:empty_graph``), with the phase printed before it.
   host_profile — ``torch.profiler`` (CPU activities, every thread)
              and a 1 kHz sampling of every thread's innermost Python
              frame over a second run of serve_http's 16 requests and a
              shorter run of predict_http's traffic: the top 10 events by
              self CPU time and the top 10 working Python functions.
8. kernels  — launches on each kernel's own main path (the serving
              phases 4-6 for the paged and dequant kernels, counts set to
              0 just before phase 4; the train phase's timed run for the
              flash kernels, counts set to 0 just before it), max error
              against the plain version, and the kernel's, plain
              version's and one PyTorch library call's device times
              (``torch.profiler``: the card's own work, not the host's
              gaps between launches) at the main path's shapes beside the
              card's bound for the same work. The dequant-matmul and
              its library call are timed with the L2 flushed before
              each call, as a decode step streams every layer's weights
              (``ms``, ``library_ms``), and also warm, with the operands
              left in L2 by the call before (``ms_warm``,
              ``library_ms_warm``). Each kernel's and library call's
              ``ms`` is the median of ``WINDOWS`` profiler windows, with
              their min and max beside it (``*_spread``). Every
              window checks that each kernel launched in its timed span
              has its device record, after a lead-in of launches that
              takes the tracer's losses (``device_ms_by_kernel``); a
              window that lost one is taken again, and a reading that
              cannot be taken whole, or an ``ms`` / ``library_ms``
              below its bound, fails the phase. The done line lists
              the windows taken again and the lead-in.
              The flash kernels are timed at the flash shapes (the
              train shape, T=512, and the ring's block shape B=8,
              T=256), and the
              forward also causal at the CausalLM's shape (B=4, T=1024,
              12 heads of 64, no mask) beside SDPA with ``is_causal``
              and a bound over the T(T+1)/2 visible pairs (a
              ``kernel_shapes`` record).
              The dequant kernel is also timed at the MLP twin's three
              shapes (M=128: 512->2048 and 2048->2048 bf16, the 2048->64
              head f32), operands warm as the twin's calls leave them,
              beside ``torch.matmul`` on a copy of the weight in the
              activation's dtype; those rows carry ``main_path``
              "mlp_int8" and that path's launches, and again at M = 1, 8,
              16 and 128 with ``main_path`` "predict_http"; every dequant
              row carries ``launches_predict_http``. The parity phase
              holds the kernel at those shapes in bf16 and f32 and at
              every rung of the predict ladder in the twin's dtypes.
              ResNet-50's head, (M, 2048, 1000) f32 at M = 1, 8, 16 and
              128, L2 flushed before each call (``ms_warm`` too), beside
              ``torch.matmul`` on an f32 copy under ``full_f32()``, rows
              with ``main_path`` "resnet50_int8" and that path's
              launches; parity holds the head at every rung in f32 and
              at those M in bf16.
   flash_backward — the whole port backward (``_flash_bwd``: the dq
              kernel with its delta prologue, then dk/dv) beside SDPA's
              whole backward, at both flash shapes.

The last line is ``{"ok": true, "device": {...}}``.

Two diagnostics run alone: ``--profiler-check [BURST_S IDLE_S]``
(whether the profiler keeps every device record of a window as the
process ages) and ``--update-sensitivity`` (how far fit's first
ResNet-50 update moves with the batch statistics' rounding).
"""
import gc
import json
import logging
import os
import re
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
FP8_FLOPS_PER_S = 1979e12
# profiler windows behind each kernel-against-library reading: the median
# is reported, with the min and max (one window now and then reads half of
# every other, as SDPA's first T=512 forward did in an earlier run)
WINDOWS = 3

# Tolerances, each with its reason:
# paged-flash decode vs plain, bf16 out: the plain read rounds the softmax
# probabilities to bf16 before the value product; the kernel keeps them
# f32 at Q = 1 and rounds them too (after its own split-local max) on the
# tensor-core path at Q > 1; with unit-scale inputs the context is O(1),
# where one bf16 ulp is 2**-7, so a few ulps of disagreement stay under
# 3e-2.
PAGED_ATOL = 3e-2
# dequant-matmul vs plain: both sum exact bf16 x int8 products in f32 (in
# another order) and round once to bf16; the result may differ by one
# bf16 ulp, a relative 2**-8, covered by rtol 1e-2 (+ atol 1e-2 near 0).
DEQ_RTOL, DEQ_ATOL = 1e-2, 1e-2
# the f32 dequant kernel: same sum in another order, f32 rounding only.
DEQ_F32_RTOL, DEQ_F32_ATOL = 1e-4, 1e-4
# one full-width paged_decode step through the kernel vs through the plain
# read, same weights and pool: the per-layer bf16 disagreement above goes
# through 12 layers and the tied head; logits are O(1).
STEP_LOGIT_ATOL = 0.25
# flash kernels vs autograd through the plain version, bf16, for o, dq,
# dk and dv alike: the kernels round p and ds to bf16 before their
# products (as the Pallas kernels do), the plain version keeps them f32,
# and each result is rounded once to bf16. Elementwise, rtol 1e-2 (about
# two bf16 ulps) plus atol 3e-2 for entries near 0 (unit-scale inputs);
# over the whole tensor, the error's RMS within 2e-2 of the reference's
# RMS, which a systematic error on some rows would break.
FLASH_ATOL, FLASH_RTOL, FLASH_REL_RMS = 3e-2, 1e-2, 2e-2
# BERT-base, flash kernels vs the plain attention branch, bf16: the two
# round the probabilities at other places; the per-layer disagreement
# goes through 12 layers and the tied head, logits are O(1). The first
# MLM loss (about ln 30522 = 10.3) is a mean over ~2,500 positions.
BERT_LOGIT_ATOL = 0.25
BERT_ARGMAX_MIN = 0.9
LOSS_ATOL = 0.02
# fp8 dequant_matmul through torch._scaled_mm vs the f32-upcast plain
# product, same fp8 operands: each fp8 x fp8 product is exact in f32; the
# two sum them in another order, and Hopper's fp8 tensor-core accumulator
# keeps fewer mantissa bits between its promotions to f32 (a relative
# ~1e-4 per partial sum); both then round once to bf16 (2**-8 relative).
# The outputs are O(1): rtol 1e-2 (two bf16 ulps) + atol 1e-2.
FP8_RTOL, FP8_ATOL = 1e-2, 1e-2
# the explicit gate budget of the int8 twin's second deploy when the
# default gate (max-abs 0.25, top-1 0.99) rejects it: with random weights
# the top two of 32000 logits sit ~0.05 apart, so int8 rounding flips
# argmaxes a trained model would keep; the twin must still stay within
# 1.0 of every logit and agree on at least half the tokens
SERVE_GATE_FALLBACK = {"quant_max_divergence": 1.0, "quant_min_top1": 0.5}
# phase 4's requests that serve_http streams (greedy ones)
HTTP_STREAMED = (2, 9, 13)

# the kernel sources of the two serving wrappers and the flash kernels
PAGED_SOURCE, DEQUANT_SOURCE = "paged_flash_decode.cu", "dequant_matmul.cu"
FLASH_FWD_SOURCE = "flash_attention_fwd.cu"
FLASH_BWD_SOURCE = "flash_attention_bwd.cu"

L_FULL, SLOTS, MAX_CTX, BS = 12, 8, 1024, 16
MB = MAX_CTX // BS
# warm_restart: each replica's engines (a short ladder: 2 prompt buckets
# x 2 batch rungs + the decode step) and the greedy prompts of the serve
# phase that fit them, WARM_TOKENS tokens each
WARM_ENGINE = {"slots": 4, "max_ctx": 256, "prompt_buckets": [64, 256],
               "prefill_batch": 2, "kv_block_size": BS}
WARM_TOKENS = 16
# BERT-base training: the bench headline's batch (bench.py bench_bert)
TRAIN_B, TRAIN_T, TRAIN_STEPS = 128, 128, 10
# calls of the remat=True BERT step: one capture, two replays
REMAT_CALLS = 3
# flash shapes held against the plain version: the train shape and
# BERT's longest position; the CausalLM's full forward runs B=CAUSAL_B
# rows of MAX_CTX tokens (the causal phase and the causal forward record)
# the train shape, BERT-base's longest position, and the sp=2 ring's
# block at T=512 (B=8, 256 positions a rank)
FLASH_SHAPES = ((128, 128), (32, 512), (8, 256))
FLASH_H, FLASH_D = 12, 64
CAUSAL_B = 4
# LeNet-MNIST training (bench.py bench_lenet, BASELINE config 1): 32
# device-staged batches of 128, one warm epoch, then LENET_EPOCHS timed
LENET_B, LENET_BATCHES, LENET_EPOCHS = 128, 32, 5
# the data phase: an IDX file of MNIST's training shape, fed to LeNet in
# batches of LENET_B; the tabular path's CSV and its MLP
DATA_N, DATA_SEED = 60_000, 22
DATA_PARITY_STEPS = 3
# steps of each feed under the profiler (an epoch's ~133k device records
# would take the profiler longer than the rest of the phase)
DATA_PROFILED = 32
TAB_ROWS, TAB_NUMERIC, TAB_CLASSES, TAB_B, TAB_EPOCHS = 20_000, 30, 10, 256, 3
TAB_STATES = (("a", "b", "c", "d"), ("x", "y", "z"))
# an f32 LeNet's output() on the card against the CPU's, same weights:
# softmax probabilities from convolutions and products summed in another
# order (f32 rounding, ~1e-6 relative on the logits); TF32 (10-bit
# mantissa) would move them by ~1e-4
LENET_F32_ATOL = 2e-5
# the quantized MLP of bench.py bench_quantized_inference: dense
# 512->2048 gelu, 3 x 2048->2048 gelu, softmax head 2048->64, B=128
MLP_IN, MLP_HIDDEN, MLP_OUT, MLP_HIDDEN_LAYERS, MLP_B = 512, 2048, 64, 4, 128
MLP_REPS = 60
# the shapes the twin's dense layers give the dequant kernel (M, K, N):
# its body runs bf16 activations, its loss head f32
MLP_SHAPES = ((MLP_B, MLP_IN, MLP_HIDDEN), (MLP_B, MLP_HIDDEN, MLP_HIDDEN),
              (MLP_B, MLP_HIDDEN, MLP_OUT))
# the JAX gate's min_top1 (DL4J_TPU_QUANT_MIN_TOP1) on the margin batch
MLP_MIN_TOP1 = 0.99
# f32 peak outside the tensor cores (H100 SXM data sheet): the f32
# dequant route's operations
F32_FLOPS_PER_S = 67e12
# the layer API's predict route (predict_http): LeNet and the MLP's int8
# twin behind one ModelServer, each InferenceEngine on the default ladder
# 1..128 with a 2 ms coalescing window; 16 client processes send 32
# requests each, of 1-16 rows drawn from seeded pools of POOL_ROWS rows
PREDICT_MAX_BATCH, PREDICT_DELAY_MS = 128, 2.0
PREDICT_LADDER = (1, 2, 4, 8, 16, 32, 64, 128)
PREDICT_CLIENTS, PREDICT_REQUESTS, PREDICT_MAX_ROWS = 16, 32, 16
POOL_ROWS = 1024
# a response against the deployed model's own output() on the same rows:
# the engine ran the rows padded into another bucket (another M) than a
# direct call, so bf16 activations round at other places. LeNet's softmax
# probabilities (~0.1 each) move by a few bf16 ulps of their logits; the
# twin's by less (its bf16 body feeds an f32 head)
LENET_PREDICT_ATOL, MLP_PREDICT_ATOL = 2e-2, 1e-2
# the dequant kernel's rows at the predict path's shapes (kernels line)
PREDICT_ROW_MS = (1, 8, 16, 128)
# the fleet phase: two replicas of the twin behind the front door, 200
# requests from FLEET_CLIENTS client threads; the second replica stops
# after the first third has been answered
FLEET_REQUESTS, FLEET_CLIENTS = 200, 4
# ResNet-50 at BASELINE config 2's width (bench.py bench_resnet50):
# 1000 classes, 3x224x224, bf16 body, Nesterovs(0.1, 0.9), B=128; fit
# over RESNET_BATCHES device-staged random batches for RESNET_EPOCHS
# epochs (one loss a step), then one epoch timed, then one profiled
RESNET_B, RESNET_BATCHES, RESNET_EPOCHS = 128, 4, 2
RESNET_SHAPE, RESNET_CLASSES = (3, 224, 224), 1000
# an f32 copy of the trained ResNet-50's output() on the card against the
# CPU's, B=2, same weights: softmax probabilities over 1000 classes after
# 53 convolutions summed in another order (f32 rounding, ~1e-5 relative
# on the logits, so ~1e-6 on probabilities of ~0.1 or less);
# TF32 (10-bit mantissa) would move the logits by ~1e-2
RESNET_F32_ATOL = 1e-4
# the same comparison on the head's input (the 2048 pooled features,
# relative to their largest): a 12-step network's running stats lag its
# weights, so at inference its activations grow through the blocks and
# its softmax saturates to one-hot rows, which hide any error; the
# features do not. f32 summed in another order through 53 convolutions
# stays near 1e-5 of the largest feature; TF32 (unit roundoff 2**-11
# against f32's 2**-24) moves each convolution by ~1e-3 and the stack's
# output by ~1e-2
RESNET_F32_FEATURE_RTOL = 1e-3
# probabilities above this count a row as saturated (reported)
SATURATED_P = 0.999
# the twin behind the predict route: a ModelRegistry with max_batch 16,
# 4 client processes of 16 requests of 1-4 images each from a seeded pool
RESNET_PREDICT_MAX_BATCH = 16
RESNET_CLIENTS, RESNET_REQUESTS, RESNET_MAX_ROWS = 4, 16, 4
RESNET_POOL_ROWS = 64
# a predict answer against the twin's own output() on the same images:
# the engine ran them padded into another bucket than a direct call, so
# cuDNN may pick other algorithms and the bf16 body rounds at other
# places; the f32 head turns that into probabilities within 1e-2
RESNET_PREDICT_ATOL = 1e-2
# ResNet-50's head as the twin gives it to the dequant kernel: x f32
# [M, 2048] (the output vertex's input stays f32), W int8 [2048, 1000]
RESNET_HEAD = (2048, 1000)
RESNET_ROW_MS = (1, 8, 16, 128)
# SameDiff BERT-base SQuAD fine-tune (BASELINE config 3): BertConfig.base()
# widths with the QA span head, recorded as a SameDiff graph; the shape of
# Devlin et al. 2019 section 4.2 and run_squad.py (B=32, max_seq_length
# 384, Adam at 5e-5), random weights from a seed; fit over SD_BATCHES
# device-staged MultiDataSets, one warm epoch then SD_EPOCHS timed
SD_B, SD_T, SD_BATCHES, SD_EPOCHS, SD_LR = 32, 384, 8, 2, 5e-5
SD_PARAMS = 108_893_186
# the first loss is about ln T (uniform start / end over 384 positions)
SD_LOSS0_ATOL = 1.0
# the graph's output() on the card against a CPU copy of the same weights,
# f32 under full_f32(): 12 layers of products summed in another order
# (f32 rounding, ~1e-6 relative on O(1) logits)
SD_F32_ATOL = 1e-4
# the predict route: a ModelRegistry with max_batch 8 (warmed over the
# ladder 1..8), 8 client processes of 16 requests of 1-4 sequences from a
# seeded pool of SD_POOL_ROWS
SD_PREDICT_MAX_BATCH, SD_CLIENTS, SD_REQUESTS, SD_MAX_ROWS = 8, 8, 16, 4
SD_POOL_ROWS = 64
# an answer against the graph's own output() on the same rows: the engine
# ran them padded into another bucket, so cuBLAS may pick other kernels
# (f32 sums in another order)
SD_PREDICT_ATOL = 1e-4
# BASELINE config 4 (deeplearning4j-nlp Seq2Seq LSTM / Word2Vec) at
# bench.py's widths: bench_seq2seq (vocab 8000, embed 256, hidden 512, f32,
# B=128, S=32, Adam 1e-3) and bench_word2vec (the skipgram op at vocab
# 30000, dim 128, B=1024, K=5, 200 chained rounds)
S2S_VOCAB, S2S_EMBED, S2S_HIDDEN, S2S_B, S2S_S, S2S_LR = (8000, 256, 512,
                                                          128, 32, 1e-3)
S2S_STEPS, S2S_PROFILED, S2S_DECODE_ROWS, S2S_DECODE_LEN = 30, 3, 8, 32
# the first loss on the card against a CPU copy of the same weights: a
# mean of 4096 f32 cross entropies (products summed in another order)
S2S_LOSS_ATOL = 1e-4
# TextGenerationLSTM (2 x LSTM-256 over 77 characters x 40 steps): 16
# device-staged batches of 32 random one-hot sequences, 2 epochs timed
TEXT_B, TEXT_BATCHES, TEXT_EPOCHS = 32, 16, 2
# steps under the profiler (~4,100 launches each)
TEXT_PROFILED = 4
# output() probabilities (~1/77 each): bucketed against exact, and the
# MaskLayer twin on the card against its CPU copy, f32 without TF32 over
# 40 recurrent steps
TEXT_ATOL = 1e-5
W2V_VOCAB, W2V_DIM, W2V_B, W2V_K, W2V_ROUNDS = 30000, 128, 1024, 5, 200
# one skipgram round on the card against the op on a CPU copy: tables of
# ~0.1 moved by lr x sums of up to 6 products
W2V_ROUND_ATOL = 1e-5
# Word2Vec.fit: one epoch of a seeded Zipf (s = 1) stream of 500k tokens
# over 30000 words, in sentences of 1000
W2V_TOKENS, W2V_SENTENCE, W2V_LAYER, W2V_WINDOW, W2V_BATCH = (500_000,
                                                              1000, 128,
                                                              5, 2048)


def qa_dims(hidden=768, layers=12, heads=12, ffn=3072, vocab=30522,
            positions=512, type_vocab=2, eps=1e-12):
    """BERT's widths (BertConfig.base() by default)."""
    return {"hidden": hidden, "layers": layers, "heads": heads, "ffn": ffn,
            "vocab": vocab, "positions": positions,
            "type_vocab": type_vocab, "eps": eps}


def qa_weights(dims, seed=0):
    """The QA model's weights as numpy f32, by variable name: normal(0,
    0.02) matrices and embeddings, layer norms at 1 / 0, biases 0 (the
    JAX package's init_params / init_qa_params layout, flattened)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    E, F = dims["hidden"], dims["ffn"]

    def dense(*shape):
        return (0.02 * rng.standard_normal(shape, dtype=np.float32))

    def zeros(n):
        return np.zeros(n, np.float32)

    w = {"emb/word": dense(dims["vocab"], E),
         "emb/pos": dense(dims["positions"], E),
         "emb/type": dense(dims["type_vocab"], E),
         "emb/ln_g": np.ones(E, np.float32), "emb/ln_b": zeros(E)}
    for i in range(dims["layers"]):
        p = f"l{i}/"
        for n in ("q", "k", "v", "o"):
            w[p + "w" + n] = dense(E, E)
            w[p + "b" + n] = zeros(E)
        w[p + "w1"], w[p + "b1"] = dense(E, F), zeros(F)
        w[p + "w2"], w[p + "b2"] = dense(F, E), zeros(E)
        for n in ("ln1", "ln2"):
            w[p + n + "_g"], w[p + n + "_b"] = np.ones(E, np.float32), zeros(E)
    w["qa/w"], w["qa/b"] = dense(E, 2), zeros(2)
    return w


def samediff_qa_graph(sd, weights, dims, T):
    """Record BERT-for-QA into ``sd`` (either package's SameDiff): the
    encoder of models/bert.py (embeddings, then per layer Q/K/V products,
    masked dot-product attention, the output product, residual + layer
    norm, the tanh-GELU FFN, residual + layer norm), the span head
    (start / end logits), and its loss, the mean of the start and end
    cross entropies over the positions the mask keeps (qa_loss). The ops
    are those a TF import of BERT gives: MatMul, BiasAdd, Reshape,
    Transpose, BatchMatMul, Softmax, LayerNorm, Gelu, the sparse softmax
    cross entropy. Placeholders: input_ids, token_type_ids,
    attention_mask ([B, T]; int32, int32, float32), start_positions and
    end_positions ([B] int32). Returns the names of start_logits,
    end_logits and loss."""
    import numpy as np
    E, H = dims["hidden"], dims["heads"]
    Dh, eps = E // H, dims["eps"]
    ids = sd.placeholder("input_ids", (None, T), "int32")
    types = sd.placeholder("token_type_ids", (None, T), "int32")
    mask = sd.placeholder("attention_mask", (None, T), "float32")
    starts = sd.placeholder("start_positions", (None,), "int32")
    ends = sd.placeholder("end_positions", (None,), "int32")
    v = {n: sd.var(n, a) for n, a in weights.items()}
    h = v["emb/word"][ids] + v["emb/pos"][0:T] + v["emb/type"][types]
    h = sd.nn.layer_norm(h, v["emb/ln_g"], v["emb/ln_b"], eps=eps)
    mask4 = mask.reshape(-1, 1, 1, T)

    def heads(x):
        return x.reshape(-1, T, H, Dh).transpose(0, 2, 1, 3)

    for i in range(dims["layers"]):
        p = f"l{i}/"
        q, k, val = (heads(h.mmul(v[p + "w" + n]) + v[p + "b" + n])
                     for n in ("q", "k", "v"))
        ctx = sd.nn.dot_product_attention(q, k, val, mask4)
        ctx = ctx.transpose(0, 2, 1, 3).reshape(-1, T, E)
        attn = ctx.mmul(v[p + "wo"]) + v[p + "bo"]
        h = sd.nn.layer_norm(h + attn, v[p + "ln1_g"], v[p + "ln1_b"],
                             eps=eps)
        inter = sd.nn.gelu(h.mmul(v[p + "w1"]) + v[p + "b1"])
        h = sd.nn.layer_norm(h + inter.mmul(v[p + "w2"]) + v[p + "b2"],
                             v[p + "ln2_g"], v[p + "ln2_b"], eps=eps)
    logits = h.mmul(v["qa/w"]) + v["qa/b"]
    start = logits[:, :, 0].rename("start_logits")
    end = logits[:, :, 1].rename("end_logits")
    big_neg = sd.constant(np.asarray(np.finfo(np.float32).min, np.float32),
                          "big_neg")
    ce = [sd.loss.sparse_softmax_cross_entropy(
        pos, sd.math.select(mask, lg, big_neg)).mean()
        for pos, lg in ((starts, start), (ends, end))]
    loss = ((ce[0] + ce[1]) * 0.5).rename("loss")
    sd.set_loss_variables("loss")
    return start.name, end.name, loss.name


def qa_param_count(sd):
    """Elements of a SameDiff graph's trainable variables."""
    return sum(int(sd.get_arr_for_var(v.name).length())
               for v in sd.trainable_variables())


def qa_batch(dims, B, T, seed=0):
    """A QA batch as numpy: token ids, segment ids (question, then
    context), a mask whose rows keep between 3/4 of T and T tokens, and
    start <= end positions inside the kept tokens."""
    import numpy as np
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, dims["vocab"], (B, T)).astype(np.int32)
    keep = rs.randint(3 * T // 4, T + 1, B)
    mask = (np.arange(T)[None, :] < keep[:, None]).astype(np.float32)
    types = (np.arange(T)[None, :] >= T // 4).astype(np.int32) \
        * mask.astype(np.int32)
    start = np.asarray([rs.randint(0, k) for k in keep], np.int32)
    end = np.asarray([rs.randint(s, k) for s, k in zip(start, keep)],
                     np.int32)
    return {"input_ids": ids, "token_type_ids": types,
            "attention_mask": mask, "start_positions": start,
            "end_positions": end}


#: the clock at import: every phase line carries its seconds since
#: (``at_s``), so a phase's time is the gap to the line before it
_T0 = time.perf_counter()


def emit(obj):
    if "phase" in obj:
        obj = {**obj, "at_s": round(time.perf_counter() - _T0, 1)}
        LAST_PHASE[0] = obj["phase"]
    print(json.dumps(obj), flush=True)


#: the name of the last phase line printed
LAST_PHASE = [None]
#: captures of this process that recorded no kernel (they run eagerly,
#: ``eager:empty_graph``), each with the phase line printed before it
EMPTY_GRAPHS = []


class EmptyGraphLog(logging.Handler):
    """Prints ``runtime/cuda_graphs.py``'s log to standard error and
    collects what it says of an empty capture into ``EMPTY_GRAPHS``."""

    def emit(self, record):
        msg = record.getMessage()
        print(msg, file=sys.stderr, flush=True)
        if "EmptyGraph" in msg:
            EMPTY_GRAPHS.append({"after_phase": LAST_PHASE[0],
                                 "message": msg[:400]})


#: profiler windows taken again (one record each): the done line reports
#: them
PROFILER_RETAKES = []
# profiler windows taken for one reading before it gives up
PROFILE_TRIES = 5
# launches at the head of every profiler window, outside its timed span:
# the tracer drops the device records of a window's first launches, more
# of them the longer the process has run outside a window (on an H100
# with torch 2.11, ``--profiler-check``: the first k of 30, k one more
# for every 15 s idle, whatever the host margin around the work);
# doubled (and kept), up to LEAD_IN_MAX, when a window still loses some
# records of its timed span
LEAD_IN, LEAD_IN_MAX = [64], 4096
# the record_function span around a window's timed calls
TIMED_SPAN = "chip_smoke/timed"


def device_ms_by_kernel(fn, iters, flush=None, counts=None):
    """{kernel name: ms per ``fn()`` call} of the card's own work
    (kernels, copies, fills) that ``torch.profiler`` records over
    ``iters`` calls, each after ``flush()`` where one is given. The calls
    run in a ``TIMED_SPAN`` after ``LEAD_IN`` launches; the reading sums
    the device records of the runtime calls in the span, and holds only
    when every kernel launch there has its record. A window that lost a
    record is recorded in ``PROFILER_RETAKES`` and taken again with the
    lead-in doubled, up to ``PROFILE_TRIES`` windows in all; then it
    raises. A launch is a kernel's or a CUDA graph's (whose kernels'
    records carry its correlation id). ``counts``, a dict, gets the
    span's device records, launch calls and device records by name per
    call."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    pad = torch.zeros(1, device="cuda")
    cpu = torch.autograd.DeviceType.CPU
    for attempt in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_IN[0]):
                pad.add_(1)
            with record_function(TIMED_SPAN):
                for _ in range(iters):
                    if flush is not None:
                        flush()
                    fn()
                torch.cuda.synchronize()
        events = prof.events()
        span = next(e.time_range for e in events
                    if e.name == TIMED_SPAN and e.device_type == cpu)
        # the CUDA runtime and driver calls made inside the span; a device
        # record carries the correlation id of the call that put it there
        calls = {e.id: e.name for e in events
                 if e.device_type == cpu and e.name.startswith("cu")
                 and span.start <= e.time_range.start <= span.end}
        device = [e for e in events if e.id in calls
                  and e.device_type == torch.autograd.DeviceType.CUDA
                  and e.name != TIMED_SPAN
                  and not getattr(e, "is_user_annotation", False)]
        launched = {i for i, n in calls.items()
                    if "LaunchKernel" in n or "GraphLaunch" in n}
        lost = launched - {e.id for e in device}
        if device and not lost:
            by_name, records = {}, {}
            for e in device:
                by_name[e.name] = by_name.get(e.name, 0.0) \
                    + e.device_time_total / 1e3 / iters
                records[e.name] = records.get(e.name, 0) + 1
            if counts is not None:
                counts.update(device_records=len(device) / iters,
                              launches=len(launched) / iters,
                              records_by_name={k: n / iters for k, n
                                               in records.items()})
            return by_name
        PROFILER_RETAKES.append({
            "fn": fn.__qualname__, "attempt": attempt,
            "lead_in": LEAD_IN[0], "launches": len(launched),
            "device_records": len(device), "lost": len(lost)})
        print(f"profiler window {attempt} over {fn.__qualname__} lost "
              f"device records: {PROFILER_RETAKES[-1]}", file=sys.stderr,
              flush=True)
        # the first launches lost (all of them where the tracer drops
        # more than the lead-in and the span together)
        LEAD_IN[0] = min(2 * LEAD_IN[0], LEAD_IN_MAX)
    raise RuntimeError(f"the profiler lost device records over "
                       f"{fn.__qualname__} in {PROFILE_TRIES} windows")


def window_records(fn, iters, margin_s):
    """One profiler window over ``iters`` calls of ``fn`` with
    ``margin_s`` of host time on either side: ({correlation id: launch
    event}, {correlation id: device record}). A kernel launch and its
    device record share the correlation id."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(margin_s)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        time.sleep(margin_s)
    launches, device = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device[e.id] = e
        elif "LaunchKernel" in e.name:
            launches[e.id] = e
    return launches, device


def window_summary(launches, device):
    """Launches, device records, matched pairs, the launch-order indices
    of launches with no device record, and the device start minus the
    launch start of matched pairs, [min, median, max] in us."""
    order = sorted(launches, key=lambda i: launches[i].time_range.start)
    lost = [n for n, i in enumerate(order) if i not in device]
    offs = sorted(device[i].time_range.start - launches[i].time_range.start
                  for i in order if i in device)
    return {"launches": len(launches), "device": len(device),
            "matched": len(order) - len(lost),
            "lost_first_last": lost[:1] + lost[-1:],
            "launch_names": sorted({launches[i].name for i in order}),
            "offset_us": offs[:1] + offs[len(offs) // 2:][:1] + offs[-1:]}


def profiler_check_main(burst_s=120.0, idle_s=120.0):
    """``chip_smoke.py --profiler-check [BURST_S IDLE_S]``: whether
    ``torch.profiler``'s windows keep every device record of a
    ``torch.matmul`` (M=128, 512->2048, bf16, 30 calls a window) as the
    process ages and as profiler sessions accumulate. One line per
    sample: the process age, the sessions so far, the host margin around
    the work and ``window_summary``; an idle sample also times the matmul
    and a ReLU through ``time_ms`` (its lead-in and the windows taken
    again so far). The last line says whether any window lost a
    record."""
    phase_device()
    import torch
    x = torch.randn(128, 512, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(512, 2048, device="cuda", dtype=torch.bfloat16)

    def fn():
        torch.matmul(x, w)
    for _ in range(10):
        fn()
    t0, sessions, lossy = time.perf_counter(), [0], []

    def sample(stage):
        for margin in (0.002, 0.02, 0.1):
            rec = window_summary(*window_records(fn, 30, margin))
            sessions[0] += 1
            rec.update(stage=stage, age_s=time.perf_counter() - t0,
                       sessions=sessions[0], margin_ms=margin * 1e3)
            if rec["matched"] < rec["launches"]:
                lossy.append(rec)
            emit(rec)
        if stage == "idle":
            emit({"stage": stage, "age_s": time.perf_counter() - t0,
                  "time_ms": time_ms(lambda: torch.relu(torch.matmul(x, w)),
                                     warm=0),
                  "lead_in": LEAD_IN[0], "retakes": len(PROFILER_RETAKES)})
    sample("start")
    end = time.perf_counter() + burst_s
    while time.perf_counter() < end:     # many short sessions
        for _ in range(100):
            rec = window_summary(*window_records(fn, 30, 0.0))
            sessions[0] += 1
            if rec["matched"] < rec["launches"]:
                lossy.append(rec)
        sample("burst")
    end = time.perf_counter() + idle_s
    while time.perf_counter() < end:     # the process ages, idle
        time.sleep(15)
        sample("idle")
    emit({"phase": "profiler_check", "sessions": sessions[0],
          "lossy_windows": len(lossy), "first_lossy": lossy[:3]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def time_ms(fn, iters=30, warm=3, flush=None):
    """Device time of one ``fn()`` call in ms, after ``warm`` calls: the
    summed duration of the work it puts on the card, over ``iters``
    calls, each after ``flush()`` where one is given, whose kernel
    (``FLUSH_KERNEL``) is left out. The gaps between launches, which the
    host sets, do not count, so a chain of library launches is timed like
    one kernel."""
    import torch
    for _ in range(warm):
        if flush is not None:
            flush()
        fn()
    torch.cuda.synchronize()
    by_name = device_ms_by_kernel(fn, iters, flush)
    return sum(v for k, v in by_name.items()
               if flush is None or FLUSH_KERNEL not in k)


def time_spread(fn, iters=30, warm=3, flush=None, windows=WINDOWS):
    """``time_ms`` over ``windows`` profiler windows of ``iters`` calls
    each: (median, [min, max]) in ms."""
    vals = sorted(time_ms(fn, iters, warm if i == 0 else 0, flush)
                  for i in range(windows))
    return vals[len(vals) // 2], [vals[0], vals[-1]]


def timed(rec, key, fn, **kw):
    """``rec[key]`` = the median of ``time_spread``, and
    ``rec[key + "_spread"]`` = its [min, max]. An ``ms`` or
    ``library_ms`` median below ``rec["bound_ms"]``, the card's least
    time for the function, raises: the reading or the bound is wrong."""
    rec[key], rec[key + "_spread"] = time_spread(fn, **kw)
    # the bound is the function's: it holds its kernel and library call
    bound = rec.get("bound_ms") if key in ("ms", "library_ms") else None
    if bound is not None and rec[key] < bound:
        raise RuntimeError(f"{key} {rec[key]} ms of {fn.__qualname__} is "
                           f"below its bound {bound} ms: {rec}")
    return rec[key]


# the kernel of l2_flusher's calls, left out of the times it precedes
FLUSH_KERNEL = "bitwise_not"


def l2_flusher():
    """A function that overwrites a 64 MB buffer, more than the card's
    50 MB L2, so that the next call reads its operands from device memory
    as a decode step reads each layer's weights (the step streams all 12
    layers' weights between two uses of one)."""
    import torch
    buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    return lambda: torch.bitwise_not(buf, out=buf)


#: the card's name and power limit, as phase_device read them
SMI = [None]


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device "
                         "(torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    SMI[0] = smi
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return smi


def phase_build():
    from deeplearning4j_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    per = _build.build()
    regs = {name: [ln.strip() for ln in _build.ptxas_report(name).splitlines()
                   if "registers" in ln or "spill" in ln]
            for name in _build.KERNELS}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "per_kernel_s": {k: round(v, 3) for k, v in per.items()},
          "ptxas": regs})
    import re
    spills = {name: [ln for ln in lines
                     if re.search(r"[1-9]\d* bytes spill (stores|loads)", ln)]
              for name, lines in regs.items()}
    if any(spills.values()):
        raise RuntimeError(f"ptxas spilled registers: {spills}")


def paged_inputs(Q, seed=0, layers=L_FULL, lengths=None, H=12):
    """A real 5-D pool [N, L, Bs, H, D] in bf16 with a permuted table
    (block 0 scratch) and mixed lengths (by default: empty, tiny,
    block-aligned, unaligned, and nearly full)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    D = 64
    N = SLOTS * MB + 1
    kp = torch.randn((N, layers, BS, H, D), generator=g, device="cuda",
                     dtype=torch.bfloat16)
    vp = torch.randn((N, layers, BS, H, D), generator=g, device="cuda",
                     dtype=torch.bfloat16)
    q = torch.randn((SLOTS, Q, H, D), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    tables = (torch.randperm(N - 1, generator=g, device="cuda") + 1).to(
        torch.int32).reshape(SLOTS, MB)
    if lengths is None:
        lengths = [0, 1, 15, 16, 100, 517, 900, MAX_CTX - Q]
    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, tables, lengths


def split_boundary_lengths(Q):
    """Slot lengths whose visible rows end exactly on a split boundary of
    the paged kernel and one row past it, for the last query row (len +
    Q rows) and the first (len + 1 rows), at the first two boundaries."""
    import importlib
    sr = importlib.import_module(
        "deeplearning4j_tpu_torch.kernels.paged_flash_decode").split_rows()
    return [sr - Q, sr - Q + 1, sr - 1, sr, 2 * sr - Q, 2 * sr - Q + 1,
            2 * sr - 1, 2 * sr]


def paged_work(Q, lengths, H=12, D=64):
    """(bytes, flops) the paged read needs for these lengths: the visible
    columns' K/V rows read once, q read and ctx written once; two
    products of 2*D flops per visible (query row, key row, head)."""
    lens = [int(x) for x in lengths]
    kv_rows = sum(min(-(-(n + Q) // BS), MB) * BS for n in lens)
    byt = 2 * kv_rows * H * D * 2 + 2 * SLOTS * Q * H * D * 2 \
        + SLOTS * MB * 4 + SLOTS * 4
    vis = sum(n + qi + 1 for n in lens for qi in range(Q))
    return byt, 4 * vis * H * D


def global_names(source):
    """The ``__global__`` functions of one source in
    ``deeplearning4j_tpu_torch/kernels/csrc``: the names under which the
    profiler records the device work of that library's launches."""
    import re
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "deeplearning4j_tpu_torch", "kernels", "csrc",
                        source)
    with open(path) as f:
        names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                           r"\s*)?(\w+)\s*\(", f.read())
    if not names:
        raise RuntimeError(f"no __global__ function found in {path}")
    return tuple(names)


def bound_ms(byt, flops, peak=BF16_FLOPS_PER_S):
    t_b, t_f = byt / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def phase_parity():
    import torch
    from deeplearning4j_tpu_torch.kernels import (paged_flash_decode,
                                                  paged_flash_decode_plain)
    from deeplearning4j_tpu_torch.quant.transforms import (
        _fused_dequant_matmul, dequant_matmul_plain, quantize_tensor)
    from deeplearning4j_tpu_torch.quant.transforms import (crossover_m,
                                                           whole_k_max_m)
    out = {"phase": "parity", "paged": [], "dequant": []}
    errs = {"paged_flash_decode": 0.0, "dequant_matmul": 0.0}
    for Q, lens in ((1, None), (5, None), (1, split_boundary_lengths(1)),
                    (5, split_boundary_lengths(5))):
        q, kp, vp, tables, lengths = paged_inputs(Q, seed=Q, lengths=lens)
        n0 = paged_flash_decode.launches
        got = paged_flash_decode(q, kp[:, 5], vp[:, 5], tables, lengths)
        ref = paged_flash_decode_plain(q, kp[:, 5], vp[:, 5], tables,
                                       lengths)
        ref32 = paged_flash_decode_plain(q.float(), kp[:, 5].float(),
                                         vp[:, 5].float(), tables, lengths)
        torch.cuda.synchronize()
        if paged_flash_decode.launches != n0 + 1:
            raise RuntimeError("paged_flash_decode did not count its launch")
        err = (got.float() - ref.float()).abs().max().item()
        err32 = (got.float() - ref32).abs().max().item()
        again = paged_flash_decode(q, kp[:, 5], vp[:, 5], tables, lengths)
        out["paged"].append({"Q": Q, "lengths": lengths.tolist(),
                             "max_abs_err": err,
                             "max_abs_err_vs_f32": err32,
                             "finite": bool(torch.isfinite(got).all()),
                             "same_bits_twice": bool(torch.equal(got,
                                                                 again))})
        if not (err <= PAGED_ATOL and torch.isfinite(got).all()
                and out["paged"][-1]["same_bits_twice"]):
            raise RuntimeError(f"paged_flash_decode Q={Q}: max abs err "
                               f"{err} > {PAGED_ATOL}, or two calls "
                               f"differ: {out['paged'][-1]}")
        errs["paged_flash_decode"] = max(errs["paged_flash_decode"], err)
        del kp, vp
    g = torch.Generator(device="cuda").manual_seed(7)
    xm, wk = crossover_m(), whole_k_max_m()
    errs["dequant_mlp"] = {}
    for dtype, rtol, atol, shapes in (
            (torch.bfloat16, DEQ_RTOL, DEQ_ATOL,
             [(8, 768, 3072), (8, 3072, 768), (40, 768, 3072),
              (40, 3072, 768), (xm - 1, 768, 3072), (xm + 1, 3072, 768),
              (xm, 1000, 3000), (wk, 768, 3072), (wk + 1, 768, 3072),
              (4096, 768, 3072), (4096, 3072, 768)] + list(MLP_SHAPES)),
            (torch.float32, DEQ_F32_RTOL, DEQ_F32_ATOL,
             [(8, 768, 3072), (100, 3072, 768)] + list(MLP_SHAPES)),
            # the predict path's bucket ladder over the twin's shapes, in
            # the twin's dtypes (bf16 body, f32 head)
            (torch.bfloat16, DEQ_RTOL, DEQ_ATOL,
             [(M, K, N) for M in PREDICT_LADDER[:-1]
              for _, K, N in MLP_SHAPES[:2]]),
            (torch.float32, DEQ_F32_RTOL, DEQ_F32_ATOL,
             [(M, K, N) for M in PREDICT_LADDER[:-1]
              for _, K, N in MLP_SHAPES[2:]]),
            # ResNet-50's 2048->1000 head (N % 16 != 0) at every rung of
            # the ladder, f32 as the twin runs it, and bf16 at the rows' M
            (torch.float32, DEQ_F32_RTOL, DEQ_F32_ATOL,
             [(M,) + RESNET_HEAD for M in PREDICT_LADDER]),
            (torch.bfloat16, DEQ_RTOL, DEQ_ATOL,
             [(M,) + RESNET_HEAD for M in RESNET_ROW_MS])):
        for M, K, N in shapes:
            w = 0.02 * torch.randn((K, N), generator=g, device="cuda")
            qt = quantize_tensor(w)
            x = torch.randn((M, K), generator=g, device="cuda").to(dtype)
            scale = qt.scale.reshape(-1)
            n0 = _fused_dequant_matmul.launches
            got = _fused_dequant_matmul(x, qt.q, scale)
            ref = dequant_matmul_plain(x, qt.q, scale)
            torch.cuda.synchronize()
            if _fused_dequant_matmul.launches != n0 + 1:
                raise RuntimeError("dequant_matmul did not count its launch")
            same = torch.equal(got, _fused_dequant_matmul(x, qt.q, scale))
            err = (got.float() - ref.float()).abs().max().item()
            ok = torch.allclose(got.float(), ref.float(), rtol=rtol,
                                atol=atol) and same
            out["dequant"].append({"dtype": str(dtype).split(".")[-1],
                                   "M": M, "K": K, "N": N,
                                   "max_abs_err": err,
                                   "same_bits_twice": bool(same),
                                   "ok": bool(ok)})
            if not ok:
                raise RuntimeError(f"dequant_matmul {dtype} {M}x{K}x{N}: "
                                   f"max abs err {err} outside rtol {rtol}"
                                   f" atol {atol}, or two calls differ")
            if (M, K, N) in MLP_SHAPES or (K, N) == RESNET_HEAD or (
                    M in PREDICT_LADDER and (MLP_B, K, N) in MLP_SHAPES):
                errs["dequant_mlp"][(M, K, N, str(dtype).split(".")[-1])] \
                    = err
            elif dtype == torch.bfloat16:
                errs["dequant_matmul"] = max(errs["dequant_matmul"], err)
    flash_parity(errs, out)
    emit(out)
    return errs


def flash_module():
    """The flash wrapper module (its launch counters live on its three
    launch functions)."""
    import importlib
    return importlib.import_module(
        "deeplearning4j_tpu_torch.kernels.flash_attention")


def flash_counters():
    fl = flash_module()
    return {"flash_attention_fwd": fl._flash_fwd,
            "flash_attention_dq": fl._flash_bwd_dq,
            "flash_attention_dkv": fl._flash_bwd_dkv}


def flash_inputs(B, T, seed):
    """bf16 q, k, v and a cotangent [B, T, 12, 64] of unit scale, and an
    all-ones int32 key mask [B, T], as BERT's batches pass one."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((B, T, FLASH_H, FLASH_D), generator=g,
                               device="cuda", dtype=torch.bfloat16)
                   for _ in range(4))
    mask = torch.ones((B, T), dtype=torch.int32, device="cuda")
    return q, k, v, do, mask


def flash_grads(fn, q, k, v, do, mask):
    """(o, dq, dk, dv) of ``fn`` with the cotangent ``do``."""
    import torch
    ts = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    o = fn(*ts, mask=mask)
    return (o.detach(),) + torch.autograd.grad(o, ts, do)


def flash_parity(errs, out):
    """The forward, dq and dk/dv kernels against autograd through the
    plain version, at the train shape and at T=512; the last batch row
    hides its last quarter of keys, so the masked path runs too. A second
    kernel forward and backward must give the same o, lse, dq, dk and dv
    bits."""
    import torch
    from deeplearning4j_tpu_torch.kernels import (flash_attention,
                                                  flash_attention_plain,
                                                  flash_attention_with_lse)
    counters = flash_counters()
    out["flash"] = []
    for name in counters:
        errs[name] = 0.0
    for i, (B, T) in enumerate(FLASH_SHAPES):
        q, k, v, do, mask = flash_inputs(B, T, seed=30 + i)
        mask[-1, T * 3 // 4:] = 0
        n0 = {n: f.launches for n, f in counters.items()}
        got = flash_grads(flash_attention, q, k, v, do, mask)
        ref = flash_grads(flash_attention_plain, q, k, v, do, mask)
        torch.cuda.synchronize()
        for n, f in counters.items():
            if f.launches != n0[n] + 1:
                raise RuntimeError(f"{n} did not count its launch")
        again = flash_grads(flash_attention, q, k, v, do, mask)
        same = {n: bool(torch.equal(a, b)) for n, a, b in
                zip(("o", "dq", "dk", "dv"), got, again)}
        with torch.no_grad():
            fwd = [flash_attention_with_lse(q, k, v, mask=mask)
                   for _ in range(2)]
        same["lse"] = bool(torch.equal(fwd[0][1], fwd[1][1]))
        del again, fwd
        names = ("o", "dq", "dk", "dv")
        got = [a.float() for a in got]
        ref = [b.float() for b in ref]
        err = [(a - b).abs().max().item() for a, b in zip(got, ref)]
        rms = [b.pow(2).mean().sqrt().item() for b in ref]
        err_rms = [(a - b).pow(2).mean().sqrt().item()
                   for a, b in zip(got, ref)]
        close = [torch.allclose(a, b, atol=FLASH_ATOL, rtol=FLASH_RTOL)
                 for a, b in zip(got, ref)]
        rec = {"B": B, "T": T,
               "max_abs_err": dict(zip(names, err)),
               "ref_rms": dict(zip(names, rms)),
               "err_rms": dict(zip(names, err_rms)),
               "ref_max_abs": {n: b.abs().max().item()
                               for n, b in zip(names, ref)},
               "finite": all(bool(torch.isfinite(a).all()) for a in got),
               "same_bits_twice": same}
        out["flash"].append(rec)
        ok = rec["finite"] and all(close) and all(same.values()) and all(
            e <= FLASH_REL_RMS * r for e, r in zip(err_rms, rms))
        if not ok:
            raise RuntimeError(f"flash kernels B={B} T={T}: {rec}")
        errs["flash_attention_fwd"] = max(errs["flash_attention_fwd"],
                                          err[0])
        errs["flash_attention_dq"] = max(errs["flash_attention_dq"], err[1])
        errs["flash_attention_dkv"] = max(errs["flash_attention_dkv"],
                                          err[2], err[3])
        del q, k, v, do, got, ref


def serve(engine, prompts, sampling, max_tokens=64, timeout=600):
    """Submit every prompt, wait for all, check each result."""
    futs = [engine.generate(p, max_tokens=max_tokens, **kw)
            for p, kw in zip(prompts, sampling)]
    res = [f.result(timeout=timeout) for f in futs]
    V = engine.model.config.vocab_size
    for p, r in zip(prompts, res):
        toks = r["tokens"]
        if len(toks) != max_tokens or r["finish_reason"] != "length":
            raise RuntimeError(f"prompt of {len(p)}: got {len(toks)} tokens "
                               f"({r['finish_reason']}), want {max_tokens}")
        if not all(0 <= t < V for t in toks):
            raise RuntimeError(f"prompt of {len(p)}: token out of vocab")
    return res


SERVE_LENS = [17, 40, 64, 100, 150, 200, 333, 500, 600, 700]


def serve_prompts(V):
    """The serve phase's 16 prompts (10 alone, 6 sharing a 256-token
    prefix) and their sampling settings (3 sampled, the rest greedy),
    from seed 0."""
    rng = np.random.RandomState(0)
    shared = rng.randint(0, V, 256).astype(np.int32)
    tails = [20, 50, 100, 200, 300, 444]
    prompts = [rng.randint(0, V, n).astype(np.int32) for n in SERVE_LENS]
    prompts += [np.concatenate([shared, rng.randint(0, V, t)]).astype(
        np.int32) for t in tails]
    sampling = [{}] * len(prompts)
    for i, kw in ((1, {"temperature": 0.8, "top_k": 50}),
                  (4, {"temperature": 1.0}),
                  (8, {"temperature": 0.7, "top_k": 8})):
        sampling[i] = kw
    return prompts, sampling


def phase_serve(model):
    import torch
    from deeplearning4j_tpu_torch.kernels import paged_flash_decode
    from deeplearning4j_tpu_torch.runtime.generation import DecodeEngine
    prompts, sampling = serve_prompts(model.config.vocab_size)
    lens = SERVE_LENS
    eng = DecodeEngine(model, slots=SLOTS, max_ctx=MAX_CTX,
                       kv_block_size=BS, device="cuda", seed=0)
    try:
        t0 = time.perf_counter()
        eng.warmup()
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        # the first shared-prefix request publishes the prefix blocks;
        # the other five attach them
        first = serve(eng, prompts[len(lens):len(lens) + 1],
                      sampling[len(lens):len(lens) + 1])
        rest = serve(eng, prompts[:len(lens)] + prompts[len(lens) + 1:],
                     sampling[:len(lens)] + sampling[len(lens) + 1:])
        wall = time.perf_counter() - t0
        stats = eng.stats()
    finally:
        eng.close(60)
    results = rest[:len(lens)] + first + rest[len(lens):]
    if stats["prefix_hits"] < 1:
        raise RuntimeError(f"prefix cache registered no hit: {stats}")
    need = L_FULL * stats["decode_steps"]
    if paged_flash_decode.launches < need:
        raise RuntimeError(f"paged kernel launched {paged_flash_decode.launches}"
                           f" times, want >= layers x decode steps = {need}")
    toks = sum(len(r["tokens"]) for r in results)
    ttft = sorted(r["ttft_s"] for r in results)
    emit({"phase": "serve", "requests": len(results), "tokens": toks,
          "warmup_s": round(t_warm, 3), "wall_s": round(wall, 3),
          "tokens_per_s": round(toks / wall, 1),
          "ttft_s_p50": ttft[len(ttft) // 2], "ttft_s_max": ttft[-1],
          "decode_steps": stats["decode_steps"],
          "prefill_dispatches": stats["prefill_dispatches"],
          "prefix_hits": stats["prefix_hits"],
          "prefix_reused_rows": stats["prefix_reused_rows"],
          "paged_launches_so_far": paged_flash_decode.launches})
    greedy = {i: results[i]["tokens"] for i in range(len(prompts))
              if not sampling[i]}
    return prompts, sampling, greedy


def phase_int8(model, prompts):
    import torch
    from deeplearning4j_tpu_torch.quant.transforms import (
        _fused_dequant_matmul, quantize_model)
    from deeplearning4j_tpu_torch.runtime.generation import DecodeEngine
    twin = quantize_model(model, device="cuda")
    n0 = _fused_dequant_matmul.launches
    eng = DecodeEngine(twin, slots=SLOTS, max_ctx=MAX_CTX, kv_block_size=BS,
                       device="cuda")
    try:
        t0 = time.perf_counter()
        eng.warmup()
        picks = [prompts[i] for i in (0, 3, 7, 12)]
        res = serve(eng, picks, [{}] * len(picks))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        eng.close(60)
    if _fused_dequant_matmul.launches <= n0:
        raise RuntimeError("the int8 twin never launched the fused kernel")
    emit({"phase": "int8", "requests": len(res),
          "precision": twin._precision, "wall_s_with_warmup": round(wall, 3),
          "dequant_launches_in_phase": _fused_dequant_matmul.launches - n0})
    return twin


def replica_serve(model, twin):
    """What a replica of the warm_restart phase serves: for the model and
    its int8 twin, a DecodeEngine on ``WARM_ENGINE``, its warmup census
    (the count after ``warmup()`` from 0) beside the ladder's
    ``len(ladder) * len(batch_ladder) + 1``, and its greedy tokens for
    the serve phase's greedy prompts that fit ``WARM_ENGINE``'s context.
    ``first_token_wall`` is the wall time of the first token served."""
    from deeplearning4j_tpu_torch.common.environment import environment
    from deeplearning4j_tpu_torch.runtime.generation import DecodeEngine
    prompts, sampling = serve_prompts(model.config.vocab_size)
    greedy = [p for p, kw in zip(prompts, sampling) if not kw
              and len(p) + WARM_TOKENS <= WARM_ENGINE["max_ctx"]]
    out = {"tokens": {}, "census": {}, "ladder_census": {},
           "prompts": len(greedy)}
    for name, m in (("bf16", model), ("int8", twin)):
        eng = DecodeEngine(m, device="cuda", **WARM_ENGINE)
        try:
            environment().reset_compile_count()
            eng.warmup()
            out["census"][name] = environment().compile_count()
            out["ladder_census"][name] = \
                len(eng.ladder) * len(eng.batch_ladder) + 1
            t_submit = time.time()
            futs = [eng.generate(p, max_tokens=WARM_TOKENS) for p in greedy]
            res = [f.result(timeout=600) for f in futs]
        finally:
            eng.close(60)
        out.setdefault("first_token_wall",
                       t_submit + min(r["ttft_s"] for r in res))
        out["tokens"][name] = [list(map(int, r["tokens"])) for r in res]
    return out


def warm_replica_main():
    """``chip_smoke.py --warm-replica``: one replica of the warm_restart
    phase, run from a copy of the package. Pulls the shared store
    (``restore_on_boot``), builds the CausalLM and its int8 twin from
    seed 0, serves them (``replica_serve``) and prints one JSON line: the
    pull, ``_build.stats()``, the kernels' launches and what it served."""
    import torch
    import deeplearning4j_tpu_torch
    from deeplearning4j_tpu_torch.kernels import _build, paged_flash_decode
    from deeplearning4j_tpu_torch.models.causal_lm import (CausalLM,
                                                           CausalLMConfig)
    from deeplearning4j_tpu_torch.quant.transforms import (
        _fused_dequant_matmul, quantize_model)
    from deeplearning4j_tpu_torch.serving.lifecycle import restore_on_boot
    torch.backends.cuda.matmul.allow_tf32 = False
    pulled = restore_on_boot()
    model = CausalLM(CausalLMConfig(), seed=0, device="cuda")
    twin = quantize_model(model, device="cuda")
    served = replica_serve(model, twin)
    print(json.dumps({"package": deeplearning4j_tpu_torch.__file__,
                      "pulled": pulled, "build": _build.stats(),
                      "launches": {
                          "paged_flash_decode": paged_flash_decode.launches,
                          "dequant_matmul": _fused_dequant_matmul.launches},
                      **served}), flush=True)


def run_replica(copy_dir, env, timeout=400):
    """Start ``chip_smoke.py --warm-replica`` from ``copy_dir`` with
    ``env``; returns (its JSON line, seconds from its start to its first
    token, its wall seconds)."""
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, os.path.join(copy_dir, "chip_smoke.py"),
         "--warm-replica"], cwd=copy_dir, env=env, capture_output=True,
        text=True, timeout=timeout)
    wall = time.time() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"replica exited {proc.returncode}: "
                           f"{proc.stderr[-4000:]}")
    rec = json.loads(lines[-1])
    return rec, rec["first_token_wall"] - t0, wall


def phase_warm_restart(model, twin):
    """Warm restart at full width: bake the serving path's kernel
    libraries (``runtime/warm_image.py``) for the CausalLM and its int8
    twin into an image; boot a fresh replica from a copy of the package
    without ``kernels/build/``, an empty local store, the image as its
    remote store and a ``CUDA_HOME`` whose ``nvcc`` always fails; it must
    build nothing, hit the store for both serving libraries, record this
    process's warmup census and serve the same greedy tokens. A cold
    replica (the same copy, ``nvcc`` reachable, no store) is timed beside
    it, for the record only."""
    import shutil
    import tempfile
    from deeplearning4j_tpu_torch.runtime.warm_image import bake
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="dl4j-warm-restart-")
    try:
        image = os.path.join(tmp, "image")
        t0 = time.perf_counter()
        summaries = [bake(m, output=image, name=name, generative=True)
                     for name, m in (("lm", model), ("lm_int8", twin))]
        bake_s = time.perf_counter() - t0
        image_bytes = sum(os.path.getsize(os.path.join(d, n))
                          for d, _, names in os.walk(image) for n in names)
        baked = sorted({k for s in summaries for k in s["kernels"]})
        if not {"paged_flash_decode", "dequant_matmul"} <= set(baked):
            raise RuntimeError(f"the bake holds {baked}: the serving "
                               "libraries are missing")
        t0 = time.perf_counter()
        ref = replica_serve(model, twin)
        ref_s = time.perf_counter() - t0
        # the replica's copy: the package without its build directory
        copy = os.path.join(tmp, "replica")
        os.makedirs(copy)
        shutil.copy(os.path.join(here, "chip_smoke.py"), copy)
        shutil.copytree(
            os.path.join(here, "deeplearning4j_tpu_torch"),
            os.path.join(copy, "deeplearning4j_tpu_torch"),
            ignore=lambda d, names: [n for n in names if n == "__pycache__"
                                     or (n == "build" and
                                         os.path.basename(d) == "kernels")])
        no_nvcc = os.path.join(tmp, "no-cuda")
        os.makedirs(os.path.join(no_nvcc, "bin"))
        with open(os.path.join(no_nvcc, "bin", "nvcc"), "w") as f:
            f.write("#!/bin/sh\necho 'no compiler on this replica' >&2\n"
                    "exit 1\n")
        os.chmod(os.path.join(no_nvcc, "bin", "nvcc"), 0o755)
        base = {k: v for k, v in os.environ.items()
                if k not in ("PYTHONPATH", "DL4J_TPU_CACHE_TIER")}
        warm, warm_ttft, warm_wall = run_replica(copy, {
            **base, "CUDA_HOME": no_nvcc,
            "DL4J_TPU_CACHE_DIR": os.path.join(tmp, "warm-cache"),
            "DL4J_TPU_REMOTE_CACHE": image})
        shutil.rmtree(os.path.join(copy, "deeplearning4j_tpu_torch",
                                   "kernels", "build"), ignore_errors=True)
        cold, cold_ttft, cold_wall = run_replica(copy, {
            **base, "DL4J_TPU_CACHE_DIR": os.path.join(tmp, "cold-cache"),
            "DL4J_TPU_REMOTE_CACHE": ""})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    b = warm["build"]
    rec = {"phase": "warm_restart", "nvidia_smi": SMI[0],
           "bake_s": bake_s, "bake_mb": image_bytes / 1e6, "ref_s": ref_s,
           "bake_kernels": baked,
           "bake_entries": [s["entries"] for s in summaries],
           "pulled": warm["pulled"], "warm_build": b,
           "warm_launches": warm["launches"],
           "census": {"parent": ref["census"], "warm": warm["census"],
                      "ladder": ref["ladder_census"]},
           "prompts": ref["prompts"],
           "tokens_same": {k: warm["tokens"][k] == ref["tokens"][k]
                           for k in ref["tokens"]},
           "warm_s_to_first_token": warm_ttft, "warm_wall_s": warm_wall,
           "cold_s_to_first_token": cold_ttft, "cold_wall_s": cold_wall,
           "cold_build": cold["build"],
           "build_s_avoided": cold["build"]["compile_seconds"]}
    emit(rec)
    fails = []
    if not warm["package"].startswith(copy):
        fails.append(f"the replica imported {warm['package']}")
    if b["compiler_runs"] or b["store_misses"] or b["store_hits"] < 2:
        fails.append(f"the warm replica's builds: {b}")
    if any(b["sources"].get(k) != "hit"
           for k in ("paged_flash_decode", "dequant_matmul")):
        fails.append(f"the serving libraries' sources: {b['sources']}")
    if not all(rec["tokens_same"].values()):
        fails.append(f"greedy tokens differ: {rec['tokens_same']}")
    if not (warm["census"] == ref["census"] == ref["ladder_census"]):
        fails.append(f"census: {rec['census']}")
    if min(warm["launches"].values()) < 1:
        fails.append(f"kernels not launched in the replica: "
                     f"{warm['launches']}")
    if cold["build"]["compiler_runs"] < 1:
        fails.append(f"the cold replica built nothing: {cold['build']}")
    if fails:
        raise RuntimeError("warm_restart: " + "; ".join(fails))
    return rec


def phase_spec(model, prompts, greedy):
    from deeplearning4j_tpu_torch.models.causal_lm import (CausalLM,
                                                           CausalLMConfig)
    from deeplearning4j_tpu_torch.runtime.generation import DecodeEngine
    # a self-speculative draft: the target's embeddings and first 2 layers
    draft = CausalLM(CausalLMConfig(num_layers=2),
                     params={"embeddings": model.params["embeddings"],
                             "layers": model.params["layers"][:2]},
                     device="cuda")
    eng = DecodeEngine(model, slots=SLOTS, max_ctx=MAX_CTX, kv_block_size=BS,
                       draft_model=draft, spec_k=4, device="cuda")
    picks = [i for i in sorted(greedy)][:4]
    try:
        eng.warmup()
        res = serve(eng, [prompts[i] for i in picks], [{}] * len(picks))
        stats = eng.stats()
    finally:
        eng.close(60)
    if stats["spec_steps"] < 1:
        raise RuntimeError(f"no speculative step ran: {stats}")
    same = sum(r["tokens"] == greedy[i] for i, r in zip(picks, res))
    emit({"phase": "spec", "requests": len(res),
          "spec_steps": stats["spec_steps"],
          "acceptance_rate": stats.get("spec_acceptance"),
          "token_identical_to_plain_greedy": f"{same}/{len(picks)}"})


def http_generate(base, prompt, kw, max_tokens=64, stream=False,
                  model="lm"):
    """One ``POST /v1/models/<model>/generate`` from a client: (status,
    the result, the ttft the client saw in s, the request's latency in
    s). A streamed request's ttft is its first token line's arrival and
    its result the ``done`` line, whose tokens must be the streamed ones;
    a plain request's ttft is the one its response reports."""
    import urllib.error
    import urllib.request
    body = {"prompt": [int(t) for t in prompt], "max_tokens": max_tokens,
            "stream": stream, **kw}
    req = urllib.request.Request(
        f"{base}/v1/models/{model}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        r = urllib.request.urlopen(req, timeout=600)
    except urllib.error.HTTPError as e:
        return e.code, {"error": e.read().decode()}, None, \
            time.perf_counter() - t0
    with r:
        if not stream:
            doc = json.loads(r.read())
            return r.status, doc, doc.get("ttft_s"), time.perf_counter() - t0
        first, toks, tail = None, [], {"error": "no done line"}
        for line in r:
            if not line.strip():
                continue
            msg = json.loads(line)
            if "token" in msg:
                if first is None:
                    first = time.perf_counter() - t0
                toks.append(msg["token"])
            else:
                tail = msg
        if tail.get("tokens") != toks:
            tail = {"error": f"streamed {toks} but done says {tail}"}
        return r.status, tail, first, time.perf_counter() - t0


def http_clients(base, requests):
    """``requests`` ({"prompt", "kw", "stream"} each) sent at once from
    client threads; returns (the ``http_generate`` results in order, the
    wall seconds from the first send to the last answer). A request that
    raises (a refused or reset connection, a torn stream) gives status
    None and its exception as the error."""
    import threading
    results = [None] * len(requests)

    def client(i):
        r = requests[i]
        t0 = time.perf_counter()
        try:
            results[i] = http_generate(base, r["prompt"], r["kw"],
                                       stream=r["stream"])
        except Exception as e:  # named in the phase's failure
            results[i] = (None, {"error": f"{type(e).__name__}: {e}"},
                          None, time.perf_counter() - t0)
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(requests))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, time.perf_counter() - t0


def http_predict(base, model, rows, timeout=120):
    """One ``POST /v1/models/<model>/predict`` of ``rows`` (a nested
    list): (status, the response document, send and answer instants on
    the host's wall clock)."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        f"{base}/v1/models/{model}/predict",
        data=json.dumps({"inputs": rows}).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.time()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read()
    try:
        doc = json.loads(body or b"{}")
    except ValueError:
        doc = {"error": body[:200].decode(errors="replace")}
    return status, doc, t0, time.time()


def predict_client(job):
    """One predict client: its requests in turn, from ``start_at`` (a
    wall-clock instant shared by every client process). A request is
    ``{"model", "lo", "rows", "cut"}``: rows ``lo:lo+rows`` of the
    model's pool, the first ``cut`` features of each. A pool saved as
    ``.npz`` is a placeholder dict: the request sends those rows of each
    of its arrays."""
    import numpy as np
    pools = {m: (dict(np.load(p)) if p.endswith(".npz") else np.load(p))
             for m, p in job["pools"].items()}
    time.sleep(max(0.0, job["start_at"] - time.time()))
    out = []
    for r in job["requests"]:
        pool = pools[r["model"]]
        rows = slice(r["lo"], r["lo"] + r["rows"])
        if isinstance(pool, dict):   # a SameDiff graph's placeholder dict
            body = {k: v[rows].tolist() for k, v in pool.items()}
        else:
            x = pool[rows]
            body = (x[..., :r["cut"]] if r.get("cut") else x).tolist()
        out.append(http_predict(job["base"], r["model"], body))
    return out


def http_clients_main():
    """``chip_smoke.py --http-clients``: the client side of serve_http
    and predict_http in a process of its own (so that the clients do not
    share the server's interpreter), reading the job as JSON on stdin
    (``{"base", "requests"}`` for generate requests, or a
    ``predict_client`` job with ``"kind": "predict"``) and writing its
    results as JSON on stdout."""
    job = json.load(sys.stdin)
    if job.get("kind") == "predict":
        json.dump({"results": predict_client(job)}, sys.stdout)
        return
    results, wall = http_clients(job["base"], job["requests"])
    json.dump({"results": results, "wall_s": wall}, sys.stdout)


def run_client_processes(jobs, timeout=900):
    """One ``--http-clients`` process per job, all started together;
    returns their parsed outputs in order (a client that fails fails the
    phase)."""
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--http-clients"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for _ in jobs]
    try:
        for p, job in zip(procs, jobs):
            p.stdin.write(json.dumps(job))
            p.stdin.close()
        outs = []
        for p in procs:
            stdout = p.stdout.read()
            p.wait(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(f"a client process failed: "
                                   f"{p.stderr.read()[-2000:]}")
            outs.append(json.loads(stdout))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def check_http(results, max_tokens, V, version=None):
    for i, (status, doc, _, _) in enumerate(results):
        toks = doc.get("tokens") or []
        if (status != 200 or "error" in doc or len(toks) != max_tokens
                or doc.get("finish_reason") != "length"
                or not all(type(t) is int and 0 <= t < V for t in toks)
                or (version is not None and doc.get("version") != version)):
            raise RuntimeError(f"HTTP request {i}: status {status}, {doc}")


def phase_serve_http(model, prompts, sampling, greedy):
    """The full-width model behind the HTTP front door. Returns the
    serving kernels' launch counts in the phase's HTTP requests and, apart,
    in its deploys (engine warmup, calibration and the divergence gate);
    the direct engine's comparison runs come first and are not counted."""
    import gc
    import urllib.request
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.kernels import paged_flash_decode
    from deeplearning4j_tpu_torch.quant import QuantizationRejectedError
    from deeplearning4j_tpu_torch.quant.transforms import \
        _fused_dequant_matmul
    from deeplearning4j_tpu_torch.runtime.generation import DecodeEngine
    from deeplearning4j_tpu_torch.serving import ModelRegistry, ModelServer
    V = model.config.vocab_size
    deploy_kw = {"decode_slots": SLOTS, "decode_max_ctx": MAX_CTX,
                 "decode_kv_block_size": BS}
    # the direct engine of the same configuration: the lone greedy
    # request first on a fresh engine, then the 16 requests at once
    eng = DecodeEngine(model, slots=SLOTS, max_ctx=MAX_CTX, kv_block_size=BS,
                       device="cuda")
    try:
        eng.warmup()
        alone = eng.generate(prompts[0], max_tokens=64).result(600)["tokens"]
        s0 = eng.stats()
        t0 = time.perf_counter()
        serve(eng, prompts, sampling)
        direct_wall = time.perf_counter() - t0
        direct = {k: eng.stats()[k] - s0[k]
                  for k in ("decode_steps", "prefill_dispatches")}
    finally:
        eng.close(60)
    del eng
    wrappers = {"paged_flash_decode": paged_flash_decode,
                "dequant_matmul": _fused_dequant_matmul}
    # the HTTP path: its launch counts start at 0 here, and each stage
    # (a deploy, or the requests between two deploys) reads its own
    for f in wrappers.values():
        f.launches = 0
    stages, mark = {}, {w: 0 for w in wrappers}

    def stage(label):
        stages[label] = {w: f.launches - mark[w]
                         for w, f in wrappers.items()}
        mark.update({w: f.launches for w, f in wrappers.items()})
    reg = ModelRegistry(manifest_dir=None)
    srv = ModelServer(reg, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{srv.start()}"
    rec = {"phase": "serve_http"}
    try:
        t0 = time.perf_counter()
        reg.deploy("lm", "v1", model, **deploy_kw)
        rec["deploy_s"] = round(time.perf_counter() - t0, 3)
        stage("deploy_v1")
        lone = http_generate(base, prompts[0], {})
        check_http([lone], 64, V, "v1")
        if lone[1]["tokens"] != alone:
            raise RuntimeError(f"a lone greedy request over HTTP gave "
                               f"{lone[1]['tokens']}, the direct engine "
                               f"{alone}")
        v1 = reg.get("lm").engine
        s0 = v1.stats()
        # the 16 requests from client threads in a process of their own
        job = {"base": base, "requests": [
            {"prompt": [int(t) for t in p], "kw": kw,
             "stream": i in HTTP_STREAMED}
            for i, (p, kw) in enumerate(zip(prompts, sampling))]}
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--http-clients"],
            input=json.dumps(job), capture_output=True, text=True,
            timeout=600)
        if out.returncode != 0:
            raise RuntimeError(f"the client process failed: {out.stderr}")
        done = json.loads(out.stdout)
        results, wall = done["results"], done["wall_s"]
        check_http(results, 64, V, "v1")
        http = {k: v1.stats()[k] - s0[k]
                for k in ("decode_steps", "prefill_dispatches")}
        toks = sum(len(r[1]["tokens"]) for r in results)
        ttft = sorted(r[2] for r in results)
        lat = sorted(r[3] for r in results)
        same = sum(results[i][1]["tokens"] == g for i, g in greedy.items())
        rec.update({
            "lone_request_matches_direct_engine": True,
            "requests": len(results), "streamed": len(HTTP_STREAMED),
            "tokens": toks, "wall_s": wall, "tokens_per_s": toks / wall,
            "direct_engine_tokens_per_s": toks / direct_wall,
            "http_over_direct_wall": wall / direct_wall,
            # more steps = the schedule; slower steps = the host
            "decode_steps": http["decode_steps"],
            "direct_engine_decode_steps": direct["decode_steps"],
            "prefill_dispatches": http["prefill_dispatches"],
            "direct_engine_prefill_dispatches":
                direct["prefill_dispatches"],
            "host_ms_per_decode_step": 1e3 * wall / http["decode_steps"],
            "direct_engine_host_ms_per_decode_step":
                1e3 * direct_wall / direct["decode_steps"],
            "client_ttft_s_p50": ttft[len(ttft) // 2],
            "client_ttft_s_max": ttft[-1],
            "client_latency_s_p50": lat[len(lat) // 2],
            "client_latency_s_max": lat[-1],
            "greedy_identical_to_serve_phase": f"{same}/{len(greedy)}"})
        stage("http_v1")
        # the same 16 requests again under the host profile (apart from
        # the timed run; their launches are a stage of their own)
        _, HOST_PROFILES["serve_http"] = host_profile(
            lambda: check_http(run_client_processes([job])[0]["results"],
                               64, V, "v1"))
        stage("http_v1_profiled")
        # the int8 twin as lm:v2, under the default gate
        calib = np.random.RandomState(1).randint(
            0, V, (4, 128)).astype(np.int32)
        gc.collect()
        mem0 = torch.cuda.memory_allocated()
        stage("before_v2")
        rejected = None
        try:
            mv = reg.deploy("lm", "v2", model, quantize="int8",
                            calibration_batch=calib, **deploy_kw)
        except QuantizationRejectedError as e:
            rejected = str(e)
        # out of the except block, so that the traceback's frames (and the
        # rejected twin and engine they hold) are gone
        rec["default_gate"] = "accepted" if rejected is None \
            else f"rejected: {rejected}"
        if rejected is not None:
            listing = json.loads(urllib.request.urlopen(
                base + "/v1/models", timeout=60).read())["models"]["lm"]
            if listing["current"] != "v1" or [
                    v["version"] for v in listing["versions"]] != ["v1"]:
                raise RuntimeError(f"a rejected deploy is visible: "
                                   f"{listing}")
            gc.collect()
            left = torch.cuda.memory_allocated() - mem0
            pool = 2 * (SLOTS * MB + 1) * L_FULL * BS * 768 * 2
            rec["rejected_deploy_bytes_left"] = left
            if left > pool // 2:
                raise RuntimeError(f"the rejected deploy left {left} bytes "
                                   f"allocated (its pool is {pool})")
            mv = reg.deploy("lm", "v2b", model, quantize="int8",
                            calibration_batch=calib, **SERVE_GATE_FALLBACK,
                            **deploy_kw)
            rec["fallback_gate"] = SERVE_GATE_FALLBACK
        rec["int8_gate"] = mv.divergence
        rec["int8_precision"] = mv.precision
        rec["int8_param_bytes"] = mv.param_bytes
        stage("deploy_v2")
        twin_res = [http_generate(base, prompts[i], {})
                    for i in (0, 3, 7, 12)]
        check_http(twin_res, 64, V, mv.version)
        rec["int8_requests"] = len(twin_res)
        stage("http_v2")
        back = reg.rollback("lm").version
        after = http_generate(base, prompts[0], {})
        check_http([after], 64, V, "v1")
        stage("http_rollback")
        rec["rollback_to"] = back
        rec["drained"] = reg.drain_all(save_manifests=False)
        if not rec["drained"]:
            raise RuntimeError("drain_all did not drain in time")
    finally:
        srv.stop()
        reg.drain_all(timeout_s=60, save_manifests=False)
    rec["launches_by_stage"] = stages
    counted = {"requests": ("http_v1", "http_v2", "http_rollback"),
               "deploys": ("deploy_v1", "deploy_v2")}
    rec["launches"] = {
        part: {w: sum(stages.get(s, {}).get(w, 0) for s in labels)
               for w in wrappers} for part, labels in counted.items()}
    emit(rec)
    if stages["http_v1"]["paged_flash_decode"] < 1:
        raise RuntimeError("v1 served its HTTP requests without the paged "
                           "decode kernel")
    for w, n in stages["http_v2"].items():
        if n < 1:
            raise RuntimeError(f"the int8 twin served its 4 HTTP requests "
                               f"without {w}")
    return rec["launches"]


def phase_fp8(model, prompts):
    """The fp8 twin: ``torch._scaled_mm`` against the f32-upcast plain
    product at the twin's 768->3072 weight, its divergence from the bf16
    model, and 4 greedy requests through a ``DecodeEngine``. Returns the
    records of the two timed shapes."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.common.metrics import registry
    from deeplearning4j_tpu_torch.kernels import paged_flash_decode
    from deeplearning4j_tpu_torch.quant import QuantSpec, divergence_report
    from deeplearning4j_tpu_torch.quant.transforms import (
        _FP8_QMAX, dequant_matmul, dequantize, fp8_matmul_plain,
        fp8_supported, quantize_model)
    from deeplearning4j_tpu_torch.runtime.generation import DecodeEngine
    if not fp8_supported("cuda"):
        raise RuntimeError("fp8_supported('cuda') is False on this card")
    twin = quantize_model(model, QuantSpec(mode="fp8"), device="cuda")
    w = twin.params["layers"][0]["mlp"]["w1"]
    K, N = w.shape
    if w.mode != "fp8" or w.q.stride() != (1, K):
        raise RuntimeError(f"fp8 w1: mode {w.mode}, strides {w.q.stride()}")
    g = torch.Generator(device="cuda").manual_seed(17)
    one = torch.ones((), dtype=torch.float32, device="cuda")
    out_scale = w.scale.reshape(-1)
    wbf = dequantize(w, torch.bfloat16)
    flush = l2_flusher()
    shapes = []
    for M in (8, 4096):
        x = torch.randn((M, K), generator=g, device="cuda",
                        dtype=torch.bfloat16)

        def plain_route():
            # what the wrapper's plain route computes, from x on
            sx = torch.clamp_min(x.abs().amax(), 1e-12) / _FP8_QMAX
            xq = (x / sx).to(torch.float8_e4m3fn)
            return fp8_matmul_plain(xq, w.q, sx, out_scale).to(x.dtype)
        with torch.no_grad():
            got = dequant_matmul(x, w)
            ref = plain_route()
        err = (got.float() - ref.float()).abs().max().item()
        if not torch.allclose(got.float(), ref.float(), rtol=FP8_RTOL,
                              atol=FP8_ATOL):
            raise RuntimeError(f"fp8 dequant_matmul M={M}: max abs err "
                               f"{err} outside rtol {FP8_RTOL} atol "
                               f"{FP8_ATOL}")
        sa = (torch.clamp_min(x.abs().amax(), 1e-12) / _FP8_QMAX).float()
        xq = (x / sa).to(torch.float8_e4m3fn)

        def kern():
            # the whole route a twin's layer runs: the activation's amax,
            # scale and fp8 cast, _scaled_mm, the output scale and cast
            dequant_matmul(x, w)

        def scaled_mm_only():
            out = torch._scaled_mm(xq, w.q, scale_a=sa, scale_b=one,
                                   out_dtype=torch.float32)
            (out[0] if isinstance(out, tuple) else out) * out_scale

        def plain():
            plain_route()

        def lib():
            torch.matmul(x, wbf)
        # the function's own bytes, as the kernel table counts them: bf16
        # x in, the fp8 weight and its f32 scales, bf16 y out
        byt = M * K * 2 + K * N + N * 4 + M * N * 2
        b_ms, b_by = bound_ms(byt, 2 * M * K * N, FP8_FLOPS_PER_S)
        rec = {"name": "dequant_matmul_fp8", "route": "torch._scaled_mm",
               "M": M, "K": K, "N": N, "max_abs_err": err,
               "plain_ms": time_ms(plain, flush=flush), "bound_ms": b_ms,
               "bound_by": b_by, "windows": WINDOWS}
        timed(rec, "ms", kern, flush=flush)
        timed(rec, "scaled_mm_and_scale_ms", scaled_mm_only, flush=flush)
        timed(rec, "library_ms", lib, flush=flush)
        shapes.append(rec)
    ids = torch.as_tensor(np.random.RandomState(5).randint(
        0, model.config.vocab_size, (1, 128)), device="cuda")
    rep = divergence_report(model, twin, ids)
    fam = registry().counter("dl4j_kernel_dispatch_total",
                             labels=("kernel", "path"))
    routed = fam.labels(kernel="dequant_matmul_fp8", path="scaled_mm")
    n_route, n_paged = routed.value(), paged_flash_decode.launches
    eng = DecodeEngine(twin, slots=SLOTS, max_ctx=MAX_CTX, kv_block_size=BS,
                       device="cuda")
    try:
        t0 = time.perf_counter()
        eng.warmup()
        picks = [prompts[i] for i in (0, 3, 7, 12)]
        res = serve(eng, picks, [{}] * len(picks))
        wall = time.perf_counter() - t0
    finally:
        eng.close(60)
    emit({"phase": "fp8", "precision": twin._precision,
          "shapes": shapes, "logit_max_abs_divergence": rep["max_abs_err"],
          "top1_agreement": rep["top1_agreement"],
          "per_token_agreement": rep["per_token_agreement"],
          "requests": len(res), "wall_s_with_warmup": round(wall, 3),
          "scaled_mm_routes_in_serving": routed.value() - n_route,
          "paged_launches_in_serving": paged_flash_decode.launches - n_paged})
    if routed.value() <= n_route:
        raise RuntimeError("the fp8 twin served without torch._scaled_mm")
    return shapes


def phase_checks(model, twin):
    """Comparisons after the main path's counts were read: one
    paged_decode step through the kernel vs through the plain read, and
    the int8 twin's divergence from the full model."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.kernels import paged_flash_decode_plain
    from deeplearning4j_tpu_torch.models import causal_lm
    g = torch.Generator(device="cuda").manual_seed(11)
    N = SLOTS * MB + 1
    cache = model.init_paged_kv_cache(N, BS)
    for t in cache.values():
        t.copy_(torch.randn(t.shape, generator=g, device="cuda"))
    tables = (torch.randperm(N - 1, generator=g, device="cuda") + 1).to(
        torch.int32).reshape(SLOTS, MB)
    lengths = torch.tensor([0, 3, 16, 77, 256, 511, 800, 1000],
                           dtype=torch.int32, device="cuda")
    toks = torch.randint(0, model.config.vocab_size, (SLOTS, 1),
                         generator=g, device="cuda", dtype=torch.int32)
    with torch.no_grad():
        c1 = {k: v.clone() for k, v in cache.items()}
        _, lk = causal_lm.paged_decode(model.params, c1, tables, toks,
                                       lengths, model.config)
        kernel_read = causal_lm.paged_flash_decode
        causal_lm.paged_flash_decode = paged_flash_decode_plain
        try:
            c2 = {k: v.clone() for k, v in cache.items()}
            _, lp = causal_lm.paged_decode(model.params, c2, tables, toks,
                                           lengths, model.config)
        finally:
            causal_lm.paged_flash_decode = kernel_read
        step_err = (lk - lp).abs().max().item()
        agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
        ids = torch.as_tensor(np.random.RandomState(5).randint(
            0, model.config.vocab_size, (1, 128)), device="cuda")
        full = model.forward(ids)
        quant = twin.forward(ids)
        div = (full - quant).abs().max().item()
        top1 = (full.argmax(-1) == quant.argmax(-1)).float().mean().item()
    emit({"phase": "checks", "paged_step_logit_max_abs_err": step_err,
          "paged_step_argmax_agree": agree,
          "int8_twin_logit_max_abs_divergence": div,
          "int8_twin_top1_agreement": top1})
    if not (step_err <= STEP_LOGIT_ATOL and torch.isfinite(lk).all()):
        raise RuntimeError(f"paged_decode kernel vs plain step: logits "
                           f"differ by {step_err} > {STEP_LOGIT_ATOL}")
    if not torch.isfinite(quant).all():
        raise RuntimeError("int8 twin produced non-finite logits")


def phase_step(model, twin):
    """Where a full-width decode step's time goes: one ``paged_decode``
    step over 8 slots at the parity lengths, for the bf16 model and its
    int8 twin. ``step_ms`` is the host clock over 10 synchronised steps;
    the device time per step, split by kernel, comes from
    ``torch.profiler`` over 5 more; the busy share is their ratio."""
    import torch
    from deeplearning4j_tpu_torch.kernels import paged_flash_decode
    from deeplearning4j_tpu_torch.models import causal_lm
    from deeplearning4j_tpu_torch.quant.transforms import \
        _fused_dequant_matmul
    names = {"paged_flash_decode": global_names(PAGED_SOURCE),
             "dequant_matmul": global_names(DEQUANT_SOURCE)}
    wrappers = {"paged_flash_decode": paged_flash_decode,
                "dequant_matmul": _fused_dequant_matmul}
    N = SLOTS * MB + 1
    g = torch.Generator(device="cuda").manual_seed(13)
    tables = (torch.randperm(N - 1, generator=g, device="cuda") + 1).to(
        torch.int32).reshape(SLOTS, MB)
    lengths = torch.tensor([0, 1, 15, 16, 100, 517, 900, 1000],
                           dtype=torch.int32, device="cuda")
    toks = torch.randint(0, model.config.vocab_size, (SLOTS, 1),
                         generator=g, device="cuda", dtype=torch.int32)
    for label, m in (("bf16", model), ("int8", twin)):
        cache = m.init_paged_kv_cache(N, BS)

        def step():
            with torch.no_grad():
                causal_lm.paged_decode(m.params, cache, tables, toks,
                                       lengths, m.config)
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / 10
        n0 = {w: f.launches for w, f in wrappers.items()}
        by_name = device_ms_by_kernel(step, 5)
        device_ms = sum(by_name.values())
        # each serving kernel's device ms per step, by __global__ function
        split = {w: {n: sum(v for k, v in by_name.items() if n in k)
                     for n in ns} for w, ns in names.items()}
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        emit({"phase": "step", "model": label, "step_ms": step_ms,
              "device_ms_per_step": device_ms,
              "device_busy_share": device_ms / step_ms,
              **{f"{w}_ms_per_step": sum(split[w].values()) for w in names},
              **{f"{w}_launches_per_step": (f.launches - n0[w]) / 5
                 for w, f in wrappers.items()},
              "serving_kernels_ms_per_step": {
                  n: v for d in split.values() for n, v in d.items() if v},
              "top_kernels_ms_per_step": [[k[:80], v] for k, v in top]})
        for w, f in wrappers.items():
            if f.launches > n0[w] and not sum(split[w].values()) > 0:
                raise RuntimeError(
                    f"{label} step: {w} launched {f.launches - n0[w]} times "
                    f"under the profiler, but no device time was found "
                    f"under its kernels' names {names[w]}")
        del cache


# the graphs phase: the draft's layers and k (as the spec phase), and the
# parity lengths the decode step is timed at (as the step phase)
GRAPH_DRAFT_LAYERS, GRAPH_K = 2, 4
GRAPH_STEP_LENGTHS = (0, 1, 15, 16, 100, 517, 900, 1000)
# LeNet (bf16) and the MLP's int8 twin through InferenceEngine, at every
# rung of the predict ladder
GRAPH_DEQUANT_PER_DISPATCH = MLP_HIDDEN_LAYERS + 1


def serve_held(engine, prompts, sampling, max_tokens=64):
    """Every request queued before the engine's loop reads its queue (its
    scheduler lock held while they go in), so that admission and batching
    follow the queue alone and two engines batch alike: the results and
    the wall seconds."""
    import torch
    t0 = time.perf_counter()
    with engine._cv:
        futs = [engine.generate(p, max_tokens=max_tokens, **kw)
                for p, kw in zip(prompts, sampling)]
    res = [f.result(timeout=600) for f in futs]
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def graph_engine_run(model, prompts, sampling, eager=False, **kw):
    """One engine over the serve phase's 16 prompts: warmed (twice, the
    census counted from 0), then serving them (the census and every
    launch count set to 0 just before). ``eager`` keeps every step eager
    (the same bodies on the same buffers, no graphs)."""
    import torch
    from deeplearning4j_tpu_torch.common.environment import environment
    from deeplearning4j_tpu_torch.kernels import paged_flash_decode
    from deeplearning4j_tpu_torch.quant.transforms import \
        _fused_dequant_matmul
    from deeplearning4j_tpu_torch.runtime.generation import DecodeEngine
    env = environment()
    eng = DecodeEngine(model, slots=SLOTS, max_ctx=MAX_CTX,
                       kv_block_size=BS, device="cuda", seed=0, **kw)
    if eager:
        eng._eager_reason = "reference"
    rec = {"formula": len(eng.ladder) * len(eng.batch_ladder) + 1
           + int(eng._spec_enabled)}
    try:
        env.reset_compile_count()
        t0 = time.perf_counter()
        eng.warmup()
        torch.cuda.synchronize()
        rec["warmup_s"] = time.perf_counter() - t0
        rec["census_warmup"] = env.compile_count()
        eng.warmup()
        rec["census_rewarm"] = env.compile_count() - rec["census_warmup"]
        s0 = eng.stats()
        env.reset_compile_count()
        paged_flash_decode.launches = 0
        _fused_dequant_matmul.launches = 0
        res, wall = serve_held(eng, prompts, sampling)
        rec["census_traffic"] = env.compile_count()
        rec["launches"] = {"paged_flash_decode": paged_flash_decode.launches,
                           "dequant_matmul": _fused_dequant_matmul.launches}
        s1 = eng.stats()
    finally:
        eng.close(60)
        env.reset_compile_count()
    toks = sum(len(r["tokens"]) for r in res)
    rec.update(tokens=[r["tokens"] for r in res], wall_s=wall,
               tokens_per_s=toks / wall,
               **{k: s1[k] - s0[k] for k in ("decode_steps", "spec_steps",
                                             "prefill_dispatches")},
               caches=sorted({g["cache"] for g in s1["graphs"]}),
               graphs=len(s1["graphs"]),
               replay_launches={g["tag"]: g["launches"]
                                for g in s1["graphs"]
                                if not g["tag"].startswith("prefill")})
    return rec


def graph_step_times(model):
    """The engine's decode step over 8 slots at the parity lengths
    (``GRAPH_STEP_LENGTHS``), replayed and eager, timed through the
    engine's own step (host arrays in, one copy to the card, the step,
    one copy back): host ms over 10 steps, device ms a step from
    ``torch.profiler`` over 5 more, the busy share their ratio. The
    kernels' counts over the 10 steps give their launches a step, and
    the trace their device records a step: ``trace_mismatches`` lists
    where a replayed step's records differ from the eager step's or the
    paged kernel's records from its count."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.kernels import paged_flash_decode
    from deeplearning4j_tpu_torch.quant.transforms import \
        _fused_dequant_matmul
    from deeplearning4j_tpu_torch.runtime.generation import DecodeEngine
    kernels = {"paged_flash_decode": (paged_flash_decode,
                                      re.compile(r"\bpaged_\w*kernel")),
               "dequant_matmul": (_fused_dequant_matmul, re.compile(
                   r"\b(dq_|dequant_matmul)\w*kernel"))}
    out = {}
    rs = np.random.RandomState(13)
    N = SLOTS * MB + 1
    tables = (rs.permutation(N - 1) + 1).astype(np.int32).reshape(SLOTS, MB)
    tokens = rs.randint(0, model.config.vocab_size, SLOTS).astype(np.int32)
    active = np.ones(SLOTS, bool)
    for label in ("replayed", "eager"):
        eng = DecodeEngine(model, slots=SLOTS, max_ctx=MAX_CTX,
                           kv_block_size=BS, device="cuda")
        if label == "eager":
            eng._eager_reason = "reference"
        try:
            eng._tables[:] = tables
            eng._tokens[:] = tokens
            eng._lengths[:] = GRAPH_STEP_LENGTHS

            def step():
                eng._run_decode(active)
            for _ in range(3):
                step()
            n0 = {k: w.launches for k, (w, _) in kernels.items()}
            t0 = time.perf_counter()
            for _ in range(10):
                step()
            step_ms = (time.perf_counter() - t0) * 1e3 / 10
            counted = {k: (w.launches - n0[k]) / 10
                       for k, (w, _) in kernels.items()}
            counts = {}
            by_name = device_ms_by_kernel(step, 5, counts=counts)
            device_ms = sum(by_name.values())
            traced = {k: sum(n for name, n in
                             counts["records_by_name"].items()
                             if pat.search(name))
                      for k, (_, pat) in kernels.items()}
            out[label] = {"step_ms": step_ms, "device_ms": device_ms,
                          "busy_share": device_ms / step_ms,
                          "device_records_per_step":
                              counts["device_records"],
                          "launch_calls_per_step": counts["launches"],
                          "launches_counted_per_step": counted,
                          "kernel_records_per_step": traced}
        finally:
            eng.close(60)
    rep, eag = out["replayed"], out["eager"]
    bad = [k for k in ("device_records_per_step", "launches_counted_per_step",
                       "kernel_records_per_step") if rep[k] != eag[k]]
    bad += [f"{label} paged records" for label, r in out.items()
            if r["kernel_records_per_step"]["paged_flash_decode"]
            != r["launches_counted_per_step"]["paged_flash_decode"]]
    out["trace_mismatches"] = bad
    return out


def graph_predict(name, net, pool):
    """``net`` through an ``InferenceEngine`` warmed over the predict
    ladder: every rung's answer bitwise against the eager forward on the
    same rows, the census after warmup (must be 0), the dequant launches
    a dispatch, and the signatures' caches."""
    import torch
    from deeplearning4j_tpu_torch.common.environment import environment
    from deeplearning4j_tpu_torch.nn.fit_fastpath import full_f32
    from deeplearning4j_tpu_torch.quant.transforms import \
        _fused_dequant_matmul
    from deeplearning4j_tpu_torch.runtime.inference import InferenceEngine
    env = environment()
    eng = InferenceEngine(net, max_batch=PREDICT_MAX_BATCH)
    rec = {"rungs": list(PREDICT_LADDER)}
    try:
        env.reset_compile_count()
        t0 = time.perf_counter()
        eng.warmup(pool[:1].cpu().numpy())
        rec["warmup_s"] = time.perf_counter() - t0
        rec["census_warmup"] = env.compile_count()
        env.reset_compile_count()
        same, launches, host_ms = [], [], []
        for n in PREDICT_LADDER:
            x = pool[:n]
            n0 = _fused_dequant_matmul.launches
            t0 = time.perf_counter()
            got = eng.infer(x).torch()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            launches.append(_fused_dequant_matmul.launches - n0)
            with torch.no_grad(), full_f32():
                want = net._forward(net._params, x, False)
            same.append(bool(torch.equal(got, want)))
        rec.update(census_traffic=env.compile_count(), bitwise=same,
                   dequant_launches=launches, infer_host_ms=host_ms,
                   caches=sorted({g["cache"]
                                  for g in eng.stats()["graphs"]}))
    finally:
        eng.close()
        env.reset_compile_count()
    emit({"phase": "graphs_predict", "model": name, **rec})
    return rec


def graph_fit_check():
    """LeNet (bf16) warmed through an ``InferenceEngine``, then one
    ``fit`` step: the next predict must be the forward on the new params
    (bitwise), not the captured old ones."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.nn.fit_fastpath import full_f32
    from deeplearning4j_tpu_torch.runtime.inference import InferenceEngine
    from deeplearning4j_tpu_torch.zoo import LeNet
    net = LeNet(dtype="bfloat16").init_model(device="cuda")
    (batch,) = zoo_batches(np.random.RandomState(7), 1, 32, (1, 28, 28), 10)
    x = batch.features.torch()[:8] if hasattr(batch.features, "torch") \
        else batch.features[:8]
    eng = InferenceEngine(net, max_batch=8)
    try:
        eng.warmup(x[:1].cpu().numpy())
        before = eng.infer(x).torch()
        net.fit(batch)
        after = eng.infer(x).torch()
        with torch.no_grad(), full_f32():
            want = net._forward(net._params, x, False)
        caps = {g["signature"]: g["captures"]
                for g in eng.stats()["graphs"]}
    finally:
        eng.close()
    return {"changed_by_fit": not torch.equal(before, after),
            "bitwise_after_fit": bool(torch.equal(after, want)),
            "captures_of_rung_8": max(c for s, c in caps.items()
                                      if "(8," in s)}


def phase_graphs(model, twin, prompts, sampling):
    """The captured serving steps (``runtime/cuda_graphs.py``; module
    docstring, ``graphs``)."""
    import torch
    from deeplearning4j_tpu_torch.models.causal_lm import (CausalLM,
                                                           CausalLMConfig)
    from deeplearning4j_tpu_torch.quant import quantize_model
    from deeplearning4j_tpu_torch.zoo import LeNet
    draft = CausalLM(CausalLMConfig(num_layers=GRAPH_DRAFT_LAYERS),
                     params={"embeddings": model.params["embeddings"],
                             "layers":
                                 model.params["layers"][:GRAPH_DRAFT_LAYERS]},
                     device="cuda")
    greedy = [i for i, kw in enumerate(sampling) if not kw]
    sampled = [i for i, kw in enumerate(sampling) if kw]
    fails, runs = [], {}
    # the spec engine serves the greedy prompts alone: a sampled rider
    # keeps every step of its batch on the plain decode step
    for name, m, kw, picks in (
            ("bf16", model, {}, range(len(prompts))),
            ("int8", twin, {}, range(len(prompts))),
            ("spec", model, {"draft_model": draft, "spec_k": GRAPH_K},
             greedy)):
        ps = [prompts[i] for i in picks]
        ss = [sampling[i] for i in picks]
        cap = graph_engine_run(m, ps, ss, **kw)
        ref = graph_engine_run(m, ps, ss, eager=True, **kw)
        at = {i: j for j, i in enumerate(picks)}
        same = sum(cap["tokens"][at[i]] == ref["tokens"][at[i]]
                   for i in greedy)
        agree = [float(np.mean([a == b for a, b in zip(
            cap["tokens"][at[i]], ref["tokens"][at[i]])]))
            for i in sampled if i in at]
        # decode_steps counts the spec steps too; a spec step's draft
        # reads k + 1 times a draft layer besides the verify's 12
        paged = L_FULL * cap["decode_steps"] \
            + GRAPH_DRAFT_LAYERS * (GRAPH_K + 1) * cap["spec_steps"]
        dequant = 2 * L_FULL * (cap["decode_steps"]
                                + cap["prefill_dispatches"]) \
            if name == "int8" else 0
        rec = {"census_formula": cap["formula"],
               "census_warmup": cap["census_warmup"],
               "census_rewarm": cap["census_rewarm"],
               "census_traffic": cap["census_traffic"],
               "greedy_identical": f"{same}/{len(greedy)}",
               "sampled_token_agreement": agree,
               "launches": cap["launches"],
               "launches_expected": {"paged_flash_decode": paged,
                                     "dequant_matmul": dequant},
               "replay_launches": cap["replay_launches"],
               "caches": cap["caches"], "reference_caches": ref["caches"],
               **{k: cap[k] for k in ("decode_steps", "spec_steps",
                                      "prefill_dispatches", "warmup_s")},
               "tokens_per_s": cap["tokens_per_s"],
               "reference_tokens_per_s": ref["tokens_per_s"],
               "reference_warmup_s": ref["warmup_s"]}
        runs[name] = rec
        emit({"phase": "graphs_decode", "model": name, **rec})
        if not (cap["census_warmup"] == cap["formula"]
                and cap["graphs"] == cap["formula"]
                and cap["census_rewarm"] == 0
                and cap["census_traffic"] == 0):
            fails.append(f"{name} census")
        if same != len(greedy):
            fails.append(f"{name} greedy tokens {same}/{len(greedy)}")
        if name == "spec" and cap["spec_steps"] < 1:
            fails.append("no spec step ran")
        if cap["caches"] != ["captured"] or \
                ref["caches"] != ["eager:reference"]:
            fails.append(f"{name} caches {cap['caches']} {ref['caches']}")
        if cap["launches"] != rec["launches_expected"]:
            fails.append(f"{name} launches {cap['launches']} against "
                         f"{rec['launches_expected']}")
        torch.cuda.empty_cache()
    steps = {}
    for name, m in (("bf16", model), ("int8", twin)):
        steps[name] = graph_step_times(m)
        emit({"phase": "graphs_step", "model": name,
              "lengths": list(GRAPH_STEP_LENGTHS), **steps[name]})
        want = {"paged_flash_decode": L_FULL,
                "dequant_matmul": 2 * L_FULL if name == "int8" else 0}
        if steps[name]["trace_mismatches"] or any(
                steps[name][label]["launches_counted_per_step"] != want
                for label in ("replayed", "eager")):
            fails.append(f"{name} step trace: {steps[name]}")
    torch.cuda.empty_cache()
    lenet = LeNet(dtype="bfloat16").init_model(device="cuda")
    mlp_twin = quantize_model(mlp_network(), device="cuda")
    rs = np.random.RandomState(3)
    predict = {
        "lenet": graph_predict("lenet", lenet, torch.from_numpy(
            rs.randn(PREDICT_MAX_BATCH, 1, 28, 28).astype(np.float32))
            .cuda()),
        "mlp_int8": graph_predict("mlp_int8", mlp_twin, torch.from_numpy(
            rs.randn(PREDICT_MAX_BATCH, MLP_IN).astype(np.float32)).cuda())}
    for name, rec in predict.items():
        if not all(rec["bitwise"]) or rec["census_traffic"] != 0 or \
                rec["census_warmup"] != len(PREDICT_LADDER) or \
                rec["caches"] != ["captured"]:
            fails.append(f"predict {name}: {rec}")
    want = GRAPH_DEQUANT_PER_DISPATCH
    if predict["mlp_int8"]["dequant_launches"] != [want] * len(
            PREDICT_LADDER):
        fails.append(f"mlp_int8 dequant launches "
                     f"{predict['mlp_int8']['dequant_launches']}")
    fit = graph_fit_check()
    emit({"phase": "graphs_fit", **fit})
    if not (fit["changed_by_fit"] and fit["bitwise_after_fit"]
            and fit["captures_of_rung_8"] >= 2):
        fails.append(f"predict after fit: {fit}")
    del lenet, mlp_twin, draft
    torch.cuda.empty_cache()
    if fails:
        raise RuntimeError(f"graphs phase failed: {fails}")
    return runs, steps, predict


GRAPHS_TRAIN_BATCHES, GRAPHS_TRAIN_EPOCHS = 8, 2
# ResNet-50 (config 2) steps, captured and in each of two eager runs
GRAPHS_RESNET_STEPS = 4


def fit_pair(make):
    """Two networks from ``make()``: one replaying its captured steps,
    one running the same step bodies eagerly (``eager:reference``)."""
    replayed, eager = make(), make()
    eager._eager_reason = "reference"
    return {"replayed": replayed, "eager": eager}


def train_state(net):
    """The params, running stats and updater state of ``net``, in order."""
    return net._state_leaves()


def bits_equal(a, b):
    """Whether two networks hold the same params, updater state and last
    loss, bit for bit."""
    import torch
    la, lb = train_state(a), train_state(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb)) \
        and a.score_value == b.score_value and a._iteration == b._iteration


def caches_of(net):
    return sorted({g["cache"] for g in net.train_graphs_report()
                   if g["tag"].split(":")[0] in ("train", "epoch")})


def train_step_times(net, batches, epochs):
    """``fit`` over ``batches``: host ms a step over ``epochs`` epochs
    (after one warm epoch, which captures), then one epoch under the
    profiler: device ms, launch calls (kernels and graphs) and device
    records a step, and the busy share."""
    import torch
    n = len(batches)
    net.fit(batches, num_epochs=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(batches, num_epochs=epochs)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (epochs * n)
    counts = {}
    by_name = device_ms_by_kernel(lambda: net.fit(batches, num_epochs=1), 1,
                                  counts=counts)
    device_ms = sum(by_name.values()) / n
    return {"step_ms": step_ms, "device_ms": device_ms,
            "busy_share": device_ms / step_ms,
            "launch_calls_per_step": counts["launches"] / n,
            "device_records_per_step": counts["device_records"] / n}


def census_of(fn):
    """The kinds of the census events ``fn()`` records."""
    from deeplearning4j_tpu_torch.common.environment import environment
    events = []
    env = environment()
    env.add_compile_listener(events.append)
    try:
        fn()
    finally:
        env.remove_compile_listener(events.append)
    return [str(k[0]).split(":")[0] for k in events]


def phase_graphs_train():
    """Captured ``fit`` steps (``nn/fit_fastpath.py`` over
    ``runtime/cuda_graphs.py``; module docstring, ``graphs_train``)."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.listeners import CollectScoresListener
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.zoo import (LeNet, ResNet50,
                                              TextGenerationLSTM)
    import weakref
    t_phase = time.perf_counter()
    fails = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # the cuBLAS workspaces torch caches a stream (earlier phases'
        # too) go first, so the reading at the end compares like with like
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
        base_alloc = torch.cuda.memory_allocated()
        rs = np.random.RandomState(21)
        lenet_batches = zoo_batches(rs, GRAPHS_TRAIN_BATCHES, LENET_B,
                                    (1, 28, 28), 10)
        zoo = TextGenerationLSTM()
        feat, T = zoo.input_shape

        def onehot(n):
            a = np.zeros((n, feat, T), np.float32)
            a[np.arange(n)[:, None], rs.randint(0, feat, (n, T)),
              np.arange(T)[None, :]] = 1.0
            return torch.from_numpy(a).cuda()
        text_batches = [DataSet(onehot(TEXT_B), onehot(TEXT_B))
                        for _ in range(TEXT_PROFILED)]
        batches_alloc = torch.cuda.memory_allocated()

        def dropout_lenet():
            conf = LeNet(dtype="bfloat16").build_conf()
            dense = next(l for l in conf.layers
                         if type(l).__name__ == "DenseLayer")
            dense.dropout = 0.5
            return MultiLayerNetwork(conf, device="cuda").init()
        models = {
            "lenet": lambda: LeNet(dtype="bfloat16").init_model(
                device="cuda"),
            "lenet_dropout": dropout_lenet,
            "text_lstm": lambda: zoo.init_model(device="cuda")}
        recs, kept, dead = {}, [], []
        for name, make in models.items():
            batches = text_batches if name == "text_lstm" else lenet_batches
            pair = fit_pair(make)
            # kept to the end of the part: a network made after another
            # was dropped could take its id(), and with it its census tags
            kept.append(pair)
            dead += [weakref.ref(n) for n in pair.values()]
            rec = {"B": TEXT_B if name == "text_lstm" else LENET_B,
                   "batches": len(batches)}
            for label, net in pair.items():
                kinds = census_of(lambda: net.fit(batches, num_epochs=1))
                again = census_of(lambda: net.fit(batches, num_epochs=1))
                rec[label] = {"census_first_fit": kinds,
                              "census_repeat_fit": again}
                if name != "lenet_dropout":
                    rec[label].update(train_step_times(
                        net, batches, GRAPHS_TRAIN_EPOCHS))
                # the per-step path (a listener): its own signature
                scores = CollectScoresListener()
                net.set_listeners(scores)
                rec[label]["census_per_step"] = census_of(
                    lambda: net.fit(batches[:2], num_epochs=1))
                net.set_listeners()
                rec[label]["per_step_scores"] = scores.scores
                rec[label]["caches"] = caches_of(net)
                rec[label]["replays"] = sum(
                    g["replays"] for g in net.train_graphs_report())
            rep, eag = rec["replayed"], rec["eager"]
            rec["bitwise_equal"] = bits_equal(pair["replayed"],
                                              pair["eager"])
            rec["per_step_scores_equal"] = \
                rep["per_step_scores"] == eag["per_step_scores"]
            recs[name] = rec
            emit({"phase": "graphs_train", "model": name, **rec})
            if rep["caches"] != ["captured"] or \
                    eag["caches"] != ["eager:reference"]:
                fails.append(f"{name} caches {rep['caches']} "
                             f"{eag['caches']}")
            if rep["census_first_fit"] != ["epoch"] or \
                    rep["census_repeat_fit"] or \
                    rep["census_per_step"] != ["train"]:
                fails.append(f"{name} census {rep['census_first_fit']} "
                             f"{rep['census_repeat_fit']} "
                             f"{rep['census_per_step']}")
            if name != "text_lstm" and not (rec["bitwise_equal"]
                                            and rec["per_step_scores_equal"]):
                fails.append(f"{name} replayed state differs from eager")
            if "device_records_per_step" in rep and \
                    rep["device_records_per_step"] != \
                    eag["device_records_per_step"]:
                fails.append(f"{name} device records a step "
                             f"{rep['device_records_per_step']} replayed, "
                             f"{eag['device_records_per_step']} eager")
        del kept, pair, net
        # ResNet-50 (config 2): captured against two eager runs
        rz = ResNet50(num_classes=RESNET_CLASSES, input_shape=RESNET_SHAPE,
                      dtype="bfloat16")
        rbatches = zoo_batches(np.random.RandomState(22),
                               GRAPHS_RESNET_STEPS, RESNET_B, RESNET_SHAPE,
                               RESNET_CLASSES)
        resnet_alloc = torch.cuda.memory_allocated()
        runs = {}
        for label in ("eager_1", "eager_2", "replayed"):
            net = rz.init_model()
            dead.append(weakref.ref(net))
            if label != "replayed":
                net._eager_reason = "reference"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            net.fit(rbatches, num_epochs=1)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            runs[label] = {
                "first_fit_s": first_s, "loss": net.score_value,
                "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
                "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
                "caches": caches_of(net),
                "state": [t.float().cpu() for t in train_state(net)]}
            # the steady state: the same steps again
            t0 = time.perf_counter()
            net.fit(rbatches, num_epochs=1)
            torch.cuda.synchronize()
            runs[label]["samples_per_s"] = GRAPHS_RESNET_STEPS * RESNET_B \
                / (time.perf_counter() - t0)
            del net
            torch.cuda.empty_cache()
        def maxdiff(a, b):
            return max(float((x - y).abs().max())
                       for x, y in zip(runs[a]["state"], runs[b]["state"]))
        spread = maxdiff("eager_1", "eager_2")
        diff = maxdiff("replayed", "eager_1")
        tol = 2 * spread
        torch.cuda.empty_cache()
        rrec = {"B": RESNET_B, "steps": GRAPHS_RESNET_STEPS,
                "eager_spread_max_abs": spread, "tol": tol,
                "replayed_vs_eager_max_abs": diff,
                **{label: {k: v for k, v in r.items() if k != "state"}
                   for label, r in runs.items()}}
        emit({"phase": "graphs_train", "model": "resnet50", **rrec})
        if runs["replayed"]["caches"] != ["captured"]:
            fails.append(f"resnet50 caches {runs['replayed']['caches']}")
        if not diff <= tol:
            fails.append(f"resnet50 replayed differs from eager by {diff} "
                         f"> {tol} (twice the eager runs' spread)")
        del runs, rbatches
        torch.cuda.empty_cache()
        # what the dropped networks held came back, with no collection:
        # every network is gone, and the allocator is where it was with
        # only the batches alive, once the cuBLAS workspaces torch cached
        # for this phase's streams are let go
        alive = sum(r() is not None for r in dead)
        after = torch.cuda.memory_allocated()
        torch._C._cuda_clearCublasWorkspaces()
        held = torch.cuda.memory_allocated() - batches_alloc
        emit({"phase": "graphs_train", "memory": {
            "allocated_before_bytes": base_alloc,
            "allocated_with_batches_bytes": batches_alloc,
            "allocated_with_resnet_batches_bytes": resnet_alloc,
            "allocated_after_drop_bytes": after,
            "cublas_workspaces_bytes": after - batches_alloc - held,
            "held_after_drop_bytes": held,
            "networks_alive_after_drop": alive,
            "reserved_after_drop_bytes": torch.cuda.memory_reserved()},
            "seconds": time.perf_counter() - t_phase})
        if held != 0 or alive:
            fails.append(f"{held} bytes still held and {alive} networks "
                         f"alive after the networks were dropped")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if fails:
        raise RuntimeError(f"graphs_train phase failed: {fails}")
    return recs


def paged_record(Q, seed, H=12):
    """The paged read at ``Q`` query rows and ``H`` heads of 64: kernel,
    plain version and SDPA over the pre-gathered view, device times
    beside the bound, and the kernel's largest error against the plain
    version (held to ``PAGED_ATOL``). Each timed call reads another
    layer's slice of the pool, so the 12-layer working set (several
    hundred MB) keeps L2 cold as in serving."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import (paged_flash_decode,
                                                  paged_flash_decode_plain)
    q, kp, vp, tables, lengths = paged_inputs(Q, seed=seed, H=H)
    views = [(kp[:, i], vp[:, i]) for i in range(L_FULL)]
    n0 = paged_flash_decode.launches
    err = (paged_flash_decode(q, *views[0], tables, lengths).float()
           - paged_flash_decode_plain(q, *views[0], tables, lengths)
           .float()).abs().max().item()
    if not err <= PAGED_ATOL:
        raise RuntimeError(f"paged_flash_decode at Q={Q}, H={H}: max error "
                           f"{err} against the plain read")
    it = iter(range(10 ** 9))

    def kern():
        k, v = views[next(it) % L_FULL]
        paged_flash_decode(q, k, v, tables, lengths)

    def plain():
        k, v = views[next(it) % L_FULL]
        paged_flash_decode_plain(q, k, v, tables, lengths)
    # the library yardstick: SDPA over the pre-gathered view
    C = MB * BS
    idx = tables.long()
    pos = lengths.long()[:, None] + torch.arange(Q, device="cuda")
    mask = (torch.arange(C, device="cuda")[None, None] <= pos[:, :, None])
    gathered = [(k[idx].reshape(SLOTS, C, H, 64).transpose(1, 2),
                 v[idx].reshape(SLOTS, C, H, 64).transpose(1, 2))
                for k, v in views]
    qt = q.transpose(1, 2)

    def lib():
        k, v = gathered[next(it) % L_FULL]
        F.scaled_dot_product_attention(qt, k, v, attn_mask=mask[:, None])
    byt, flops = paged_work(Q, lengths.tolist(), H=H)
    b_ms, b_by = bound_ms(byt, flops)
    rec = {"Q": Q, "heads": H, "max_abs_err": err,
           "plain_ms": time_ms(plain), "bound_ms": b_ms, "bound_by": b_by,
           "windows": WINDOWS}
    timed(rec, "ms", kern)
    timed(rec, "library_ms", lib)
    # the comparison's and the readings' launches are no main path's
    paged_flash_decode.launches = n0
    return rec


def dequant_record(ws, M, flush):
    """The dequant kernel at (M, K, N) of the int8 weights ``ws`` (one a
    layer, each timed call on the next one, L2 flushed before each call,
    kernel and library alike; also warm on the first), beside its plain
    version and ``torch.matmul`` on a bf16 copy, and the kernel's
    largest error against the plain version (held to ``DEQ_RTOL`` /
    ``DEQ_ATOL``)."""
    import torch
    from deeplearning4j_tpu_torch.quant.transforms import (
        _fused_dequant_matmul, dequant_matmul_plain, dequantize)
    K, N = ws[0].shape
    x = torch.randn((M, K), device="cuda", dtype=torch.bfloat16)
    wbf = [dequantize(w, torch.bfloat16) for w in ws]
    n0 = _fused_dequant_matmul.launches
    got = _fused_dequant_matmul(x, ws[0].q, ws[0].scale.reshape(-1)).float()
    want = dequant_matmul_plain(x, ws[0].q, ws[0].scale.reshape(-1)).float()
    if not torch.allclose(got, want, rtol=DEQ_RTOL, atol=DEQ_ATOL):
        raise RuntimeError(f"dequant_matmul at ({M}, {K}, {N}) against "
                           "the plain version")
    it = iter(range(10 ** 9))

    def kern():
        w = ws[next(it) % len(ws)]
        _fused_dequant_matmul(x, w.q, w.scale.reshape(-1))

    def plain():
        w = ws[next(it) % len(ws)]
        dequant_matmul_plain(x, w.q, w.scale.reshape(-1))

    def lib():
        torch.matmul(x, wbf[next(it) % len(ws)])

    def kern_warm():
        _fused_dequant_matmul(x, ws[0].q, ws[0].scale.reshape(-1))

    def lib_warm():
        torch.matmul(x, wbf[0])
    byt = M * K * 2 + K * N + N * 4 + M * N * 2
    b_ms, b_by = bound_ms(byt, 2 * M * K * N)
    rec = {"M": M, "K": K, "N": N,
           "max_abs_err": (got - want).abs().max().item(),
           "plain_ms": time_ms(plain, flush=flush),
           "ms_warm": time_ms(kern_warm),
           "library_ms_warm": time_ms(lib_warm),
           "bound_ms": b_ms, "bound_by": b_by, "windows": WINDOWS}
    timed(rec, "ms", kern, flush=flush)
    timed(rec, "library_ms", lib, flush=flush)
    _fused_dequant_matmul.launches = n0
    return rec


PAGED_ROW = {"name": "paged_flash_decode", "route": "cuda",
             "source": "deeplearning4j_tpu_torch/kernels/csrc/"
                       "paged_flash_decode.cu",
             "replaces": "deeplearning4j_tpu/kernels/"
                         "paged_flash_decode.py:138"}
DEQUANT_ROW = {"name": "dequant_matmul", "route": "cuda",
               "source": "deeplearning4j_tpu_torch/kernels/csrc/"
                         "dequant_matmul.cu",
               "replaces": "deeplearning4j_tpu/quant/transforms.py:216"}


def phase_kernels(twin, launches, errs):
    rows, shapes = [], []
    # paged read at the decode (Q=1) and spec-verify (Q=5) shapes
    for Q in (1, 5):
        rec = paged_record(Q, seed=20 + Q)
        shapes.append({"name": "paged_flash_decode", **rec})
        if Q == 1:
            rows.append({**PAGED_ROW,
                         "launches": launches["paged_flash_decode"],
                         "max_abs_err": errs["paged_flash_decode"],
                         **{k: rec[k] for k in ROW_KEYS}})
    # dequant-matmul at decode (M = 8 slots), spec verify (M = 40) and
    # prefill (M = 4 x 1024) rows, over the twin's own 12 layers' weights
    # in turn
    mlps = [lyr["mlp"] for lyr in twin.params["layers"]]
    flush = l2_flusher()
    for M in (8, 40, 4096):
        for wname in ("w1", "w2"):
            rec = dequant_record([m[wname] for m in mlps], M, flush)
            shapes.append({"name": "dequant_matmul", **rec})
            if M == 8 and wname == "w1":
                rows.append({**DEQUANT_ROW,
                             "launches": launches["dequant_matmul"],
                             "max_abs_err": errs["dequant_matmul"],
                             **{k: rec[k] for k in ROW_KEYS}})
    return rows, shapes


def sharded_kernel_rows(twin):
    """The two serving kernels at a model=2 rank's shapes (the
    sharded_serve phase's): the paged read over 6 of the 12 heads at
    Q = 1 and Q = 5 (the spec verify, k = 4), and the dequant kernel on
    a rank's slices of the twin's MLP, w1 (768, 1536) and w2 (1536,
    768) at M = 8 slots; each held against its plain version and timed
    as ``phase_kernels`` times it. The rows' launches come later, from
    the phase's rank processes."""
    from deeplearning4j_tpu_torch.quant.transforms import QuantizedTensor
    rows = []
    for Q in (1, 5):
        rec = paged_record(Q, seed=40 + Q, H=L_FULL // 2)
        rows.append({**PAGED_ROW, "main_path": "sharded_serve",
                     **{k: rec[k] for k in ROW_KEYS + ("Q", "heads",
                                                       "max_abs_err")}})
    flush = l2_flusher()
    half = twin.config.intermediate_size // 2
    for wname, cut in (("w1", (slice(None), slice(0, half))),
                       ("w2", (slice(0, half), slice(None)))):
        ws = []
        for lyr in twin.params["layers"]:
            w = lyr["mlp"][wname]
            scale = w.scale[:, cut[1]] if wname == "w1" else w.scale
            ws.append(QuantizedTensor(w.q[cut].contiguous(),
                                      scale.contiguous(), w.orig_dtype))
        rec = dequant_record(ws, SLOTS, flush)
        rows.append({**DEQUANT_ROW, "main_path": "sharded_serve",
                     **{k: rec[k] for k in ROW_KEYS + (
                         "M", "K", "N", "max_abs_err", "ms_warm",
                         "library_ms_warm")}})
    return rows


#: the timing keys a kernels-line row copies from its shape record
ROW_KEYS = ("ms", "ms_spread", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_ms_spread", "windows")


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree.clone()


def bert_batch(cfg, B, T, seed=0):
    """The bench's masked-LM batch: ids, 15 % of positions labelled, an
    all-ones attention mask."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (B, T))
    labels = np.where(rng.rand(B, T) < 0.15,
                      rng.randint(0, cfg.vocab_size, (B, T)), -100)
    return {"input_ids": torch.as_tensor(ids, device="cuda"),
            "labels": torch.as_tensor(labels, device="cuda"),
            "attention_mask": torch.ones((B, T), dtype=torch.int32,
                                         device="cuda")}


def phase_train():
    """BERT-base MLM training through the flash kernels, captured: the
    scanned step (TRAIN_STEPS steps a call) is captured on its first
    call and replayed from then on, the three flash kernels inside its
    graph. Returns the kernels' launch counts on the timed run (replays
    only) and what ``phase_train_step`` reuses."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models import bert
    cfg = bert.BertConfig.base()
    params = bert.init_params(cfg, seed=0, device="cuda")
    opt = bert.init_opt_state(params)
    # where the eager reference steps of phase_train_step start
    start = (clone_tree(params), clone_tree(opt))
    batch = bert_batch(cfg, TRAIN_B, TRAIN_T)
    step = bert.make_scanned_train_step(cfg, TRAIN_STEPS, learning_rate=1e-4,
                                        remat=False, use_flash=True)
    t0 = time.perf_counter()
    params, opt, warm = step(params, opt, batch, 0)     # runs, captures
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    before = (clone_tree(params), clone_tree(opt))
    counters = flash_counters()
    # the training path: every flash launch count starts at 0 here
    for f in counters.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt, losses = step(params, opt, batch, TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: f.launches for n, f in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    traj = losses.float().cpu().numpy()
    changed = int(np.count_nonzero(np.diff(traj)))
    # the same step through the plain attention branch, same start, run
    # eagerly (one call: nothing to replay)
    plain_step = bert.make_scanned_train_step(cfg, 1, learning_rate=1e-4,
                                              remat=False, use_flash=False)
    _, _, plain_loss = plain_step(before[0], before[1], batch, TRAIN_STEPS,
                                  eager="reference")
    plain_first = float(plain_loss[0])
    del before
    entry, = step.graphs.report()
    want = cfg.num_layers * TRAIN_STEPS
    rec = {"phase": "train", "model": "bert-base", "B": TRAIN_B,
           "T": TRAIN_T, "n_steps": TRAIN_STEPS,
           "warm_call_s": round(t_warm, 3), "wall_s": wall,
           "step_ms": wall * 1e3 / TRAIN_STEPS,
           "samples_per_s": TRAIN_STEPS * TRAIN_B / wall,
           "peak_memory_gib": peak_gb, "graph": entry,
           "warm_losses": warm.float().cpu().tolist(),
           "losses": traj.tolist(), "adjacent_changed":
               f"{changed}/{len(traj) - 1}",
           "first_loss_plain_attention": plain_first,
           "first_loss_abs_diff": abs(plain_first - float(traj[0])),
           "launches": launches}
    emit(rec)
    if entry["cache"] != "captured":
        raise RuntimeError(f"the BERT train step was not captured: {entry}")
    if not np.all(np.isfinite(traj)):
        raise RuntimeError("non-finite loss in the train trajectory")
    if changed < 0.8 * (len(traj) - 1):
        raise RuntimeError(f"loss trajectory mostly flat: {traj}")
    if abs(plain_first - float(traj[0])) > LOSS_ATOL:
        raise RuntimeError(f"first loss {traj[0]} (flash) vs {plain_first}"
                           f" (plain attention) differ by more than "
                           f"{LOSS_ATOL}")
    for n, c in launches.items():
        if c != want:
            raise RuntimeError(f"{n} launched {c} times on the train run, "
                               f"want {cfg.num_layers} layers x "
                               f"{TRAIN_STEPS} steps = {want}")
    return launches, {"step": step, "params": params, "opt": opt,
                      "batch": batch, "start": start,
                      "losses": [warm, losses], "step_ms": rec["step_ms"]}


def flash_kernel_names():
    """{wrapper: the ``__global__`` names its launches run under}, read
    from the flash sources: the forward's, and the backward's split by
    ``_dq_`` and ``_dkv_`` in the name."""
    fwd = global_names(FLASH_FWD_SOURCE)
    bwd = global_names(FLASH_BWD_SOURCE)
    names = {"flash_attention_fwd": fwd,
             "flash_attention_dq": tuple(n for n in bwd if "_dq_" in n),
             "flash_attention_dkv": tuple(n for n in bwd if "_dkv_" in n)}
    rest = set(bwd) - set(names["flash_attention_dq"]) \
        - set(names["flash_attention_dkv"])
    if rest or not all(names.values()):
        raise RuntimeError(f"flash kernel names not split by wrapper: "
                           f"{names}, left over {sorted(rest)}")
    return names


def ms_under(by_name, names):
    """The ms of ``by_name`` (profiler kernel name -> ms) whose kernel is
    one of ``names`` (a ``__global__`` function name, matched as a whole
    word of the profiler's demangled name)."""
    import re
    pats = [re.compile(r"(?<!\w)" + re.escape(n) + r"(?!\w)")
            for n in names]
    return sum(v for k, v in by_name.items() if any(p.search(k)
                                                    for p in pats))


def state_diff(a, b):
    """The largest elementwise gap between two lists of tensors (0.0
    where they are equal bit for bit)."""
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b))


def replay_check(name, replayed, eager_1, eager_2, fails):
    """The replayed state (a list of tensors: params, optimizer state,
    losses) against two eager runs from the same start: bit for bit
    where the eager runs agree bit for bit, else within twice their
    spread. Returns the record's fields; a miss goes into ``fails``."""
    import torch
    spread = state_diff(eager_1, eager_2)
    diff = state_diff(replayed, eager_1)
    same = all(torch.equal(x, y) for x, y in zip(replayed, eager_1))
    ok = same if spread == 0 else diff <= 2 * spread
    if not ok:
        fails.append(f"{name}: replayed differs from eager by {diff} "
                     f"(eager runs' spread {spread})")
    return {"bitwise_equal": same, "eager_spread_max_abs": spread,
            "replayed_vs_eager_max_abs": diff}


def step_profile(fn, steps, per_call=0):
    """Device ms, launch calls and device records a step of ``fn()``
    (``steps`` steps a call, after ``per_call`` device records a call
    that are no step's: the copies of a step's batch into its static
    buffers) from one profiler window, with the device ms by kernel."""
    counts = {}
    by_name = {k: v / steps for k, v in
               device_ms_by_kernel(fn, 1, counts=counts).items()}
    return {"device_ms": sum(by_name.values()),
            "launch_calls": counts["launches"] / steps,
            "device_records": (counts["device_records"] - per_call)
            / steps}, by_name


def profile_pair(name, replayed, eager, fails, per_call=0):
    """``step_profile`` of a replayed and an eager call (``replayed`` and
    ``eager`` are (fn, steps a call)), taken again, up to PROFILE_TRIES
    pairs, until their device records a step agree: the tracer may drop
    some records of a graph's kernels while it keeps the graph launch's
    own, a loss ``device_ms_by_kernel`` cannot see. Returns the two
    readings, each with its flash launches a step; a pair that never
    agrees goes into ``fails``."""
    counters = flash_counters()

    def take(fn, steps):
        n0 = {w: f.launches for w, f in counters.items()}
        rec, by_name = step_profile(fn, steps, per_call)
        rec["flash_launches"] = {w: (f.launches - n0[w]) / steps
                                 for w, f in counters.items()}
        return rec, by_name
    for attempt in range(PROFILE_TRIES):
        rep, eag = take(*replayed), take(*eager)
        if rep[0]["device_records"] == eag[0]["device_records"]:
            return rep, eag
        PROFILER_RETAKES.append({
            "fn": name, "attempt": attempt, "device_records":
                [rep[0]["device_records"], eag[0]["device_records"]]})
    fails.append(f"{name}: {rep[0]['device_records']} device records a "
                 f"replayed step, {eag[0]['device_records']} eager, in "
                 f"{PROFILE_TRIES} pairs of windows")
    return rep, eag


def step_state(params, opt, losses):
    """The params, the Adam moments and the losses of a run, as one list
    of tensors."""
    import torch
    from deeplearning4j_tpu_torch.models import _optim
    return _optim.tree_leaves([params, opt]) + [
        torch.cat([t.reshape(-1) for t in losses])]


# steps a call of the eager BERT step under the profiler (a profiled
# eager step records some 20,000 host events)
EAGER_PROFILED = 2


def phase_train_step(run):
    """The captured BERT-base step against the same body kept eager
    (``eager="reference"``): device time by kernel of a replayed call
    (each flash wrapper's share sums the ``__global__`` functions of its
    source; a wrapper that launched with a share of 0 fails), host ms,
    device ms, busy share, launch calls and device records a step each
    way (the eager ones over an EAGER_PROFILED-step call), the replayed
    state after phase_train's two calls against two eager runs of the
    same calls from ``start``, the flash launches held at layers a
    step; then a remat=True step, captured and replayed against eager.
    Each step's graphs are released at the end."""
    import torch
    from deeplearning4j_tpu_torch.models import bert
    cfg = bert.BertConfig.base()
    step, params, opt, batch, start, step_ms = (
        run[k] for k in ("step", "params", "opt", "batch", "start",
                         "step_ms"))
    names = flash_kernel_names()
    fails = []
    # the replayed state after phase_train's calls (0, TRAIN_STEPS)
    rep_state = [t.clone() for t in step_state(params, opt, run["losses"])]
    # the same body kept eager, twice, through the replayed state's
    # calls; the first's second call timed
    eager_step = bert.make_scanned_train_step(cfg, TRAIN_STEPS,
                                              learning_rate=1e-4,
                                              remat=False, use_flash=True)
    runs = {}
    for label in ("eager_1", "eager_2"):
        p, o = clone_tree(start[0]), clone_tree(start[1])
        losses = [eager_step(p, o, batch, 0, eager="reference")[2]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(eager_step(p, o, batch, TRAIN_STEPS,
                                 eager="reference")[2])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
        runs[label] = step_state(p, o, losses)
        if label == "eager_1":
            kept, eager_ms = (p, o), ms
        del p, o
    check = replay_check("bert train step", rep_state, runs["eager_1"],
                         runs["eager_2"], fails)
    del runs, rep_state
    # profiled: a replayed call (its graph captured in phase_train) and an
    # EAGER_PROFILED-step call of the eager step
    short = bert.make_scanned_train_step(cfg, EAGER_PROFILED,
                                         learning_rate=1e-4, remat=False,
                                         use_flash=True)
    # its first call makes its static inputs (a fill of its own)
    short(*kept, batch, 100, eager="reference")
    (replayed, by_name), (eager, eager_by_name) = profile_pair(
        "bert train step",
        (lambda: step(params, opt, batch, 100), TRAIN_STEPS),
        (lambda: short(*kept, batch, 100, eager="reference"),
         EAGER_PROFILED), fails, len(batch))
    del kept
    step.graphs.release()
    replayed.update(step_ms=step_ms, busy_share=replayed["device_ms"]
                    / step_ms)
    eager.update(step_ms=eager_ms, busy_share=eager["device_ms"] / eager_ms)
    launched, eager_launched = (replayed.pop("flash_launches"),
                                eager.pop("flash_launches"))
    split = {w: ms_under(by_name, ns) for w, ns in names.items()}
    eager_split = {w: ms_under(eager_by_name, ns) for w, ns in names.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # cuBLAS's matrix products (nvjet, cutlass and xmma kernel names)
    gemm = sum(v for k, v in by_name.items()
               if any(f in k.lower() for f in ("gemm", "nvjet", "cutlass",
                                               "xmma")))
    per_launch = {w: {"replayed": split[w] / launched[w] if launched[w]
                      else None,
                      "eager": eager_split[w] / eager_launched[w]
                      if eager_launched[w] else None} for w in names}
    want = float(cfg.num_layers)
    emit({"phase": "train_step", "step_ms": step_ms,
          "device_ms_per_step": replayed["device_ms"],
          "device_busy_share": replayed["busy_share"],
          "flash_fwd_ms_per_step": split["flash_attention_fwd"],
          "flash_dq_ms_per_step": split["flash_attention_dq"],
          "flash_dkv_ms_per_step": split["flash_attention_dkv"],
          "flash_ms_per_launch": per_launch,
          "flash_launches_per_step": launched,
          "flash_launches_per_step_eager": eager_launched,
          "flash_kernel_names": names,
          "gemm_ms_per_step": gemm,
          "kernels_seen": len(by_name),
          "top_kernels_ms_per_step": [[k[:80], v] for k, v in top],
          "replayed": replayed, "eager": eager,
          "samples_per_s_replayed": TRAIN_B * 1e3 / step_ms,
          "samples_per_s_eager": TRAIN_B * 1e3 / eager_ms, **check})
    for w, n in launched.items():
        if n > 0 and not split[w] > 0:
            fails.append(f"train step: {w} launched {n} times a step under "
                         f"the profiler, but no device time was found "
                         f"under its kernels' names {names[w]}")
        if n != want or eager_launched[w] != want:
            fails.append(f"train step: {w} launched {n} times a replayed "
                         f"step, {eager_launched[w]} eager, want {want}")
    phase_train_remat(cfg, start, batch, fails)
    if fails:
        raise RuntimeError(f"train_step phase failed: {fails}")


def phase_train_remat(cfg, start, batch, fails):
    """``make_train_step(remat=True, use_flash=True)`` at BERT-base
    B=128, T=128: REMAT_CALLS calls captured (the first) and replayed,
    against the same calls kept eager twice from ``start``; the flash
    forward launches twice a layer and step (the backward recomputes
    it), dq and dk/dv once."""
    import torch
    from deeplearning4j_tpu_torch.models import bert
    counters = flash_counters()
    runs, graph, launched = {}, None, None
    for label in ("replayed", "eager_1", "eager_2"):
        p, o = clone_tree(start[0]), clone_tree(start[1])
        step = bert.make_train_step(cfg, learning_rate=1e-4, remat=True,
                                    use_flash=True)
        eager = None if label == "replayed" else "reference"
        for f in counters.values():
            f.launches = 0
        losses = [step(p, o, batch, i, eager=eager)[2]
                  for i in range(REMAT_CALLS)]
        torch.cuda.synchronize()
        if label == "replayed":
            launched = {w: f.launches for w, f in counters.items()}
            graph, = step.graphs.report()
        runs[label] = step_state(p, o, losses)
        step.graphs.release()
        del p, o, step
    layers = cfg.num_layers * REMAT_CALLS
    want = {"flash_attention_fwd": 2 * layers, "flash_attention_dq": layers,
            "flash_attention_dkv": layers}
    check = replay_check("bert remat step", runs["replayed"],
                         runs["eager_1"], runs["eager_2"], fails)
    emit({"phase": "train_step", "remat": True, "calls": REMAT_CALLS,
          "graph": graph, "flash_launches": launched,
          "losses": runs["replayed"][-1].float().cpu().tolist(), **check})
    if graph["cache"] != "captured":
        fails.append(f"the remat step was not captured: {graph}")
    if launched != want:
        fails.append(f"remat step flash launches {launched}, want {want}")


def phase_bert_forward():
    """One BERT-base forward (encode + MLM head) at the shape of
    ``__graft_entry__.entry`` (B=8, T=128), through the flash kernel and
    through the plain attention branch, on the same weights."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models import bert
    cfg = bert.BertConfig.base()
    params = bert.init_params(cfg, seed=1, device="cuda")
    ids = torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (8, 128)), device="cuda")
    mask = torch.ones((8, 128), dtype=torch.int32, device="cuda")
    with torch.no_grad():
        out = [bert.mlm_logits(params, bert.encode(
            params, ids, None, mask, config=cfg, use_flash=uf), cfg)
            for uf in (True, False)]
    err = (out[0] - out[1]).abs().max().item()
    agree = (out[0].argmax(-1) == out[1].argmax(-1)).float().mean().item()
    emit({"phase": "bert_forward", "B": 8, "T": 128,
          "logits_shape": list(out[0].shape),
          "logit_max_abs_err": err, "argmax_agree": agree,
          "logit_max_abs": out[1].abs().max().item()})
    if not (torch.isfinite(out[0]).all() and err <= BERT_LOGIT_ATOL
            and agree >= BERT_ARGMAX_MIN):
        raise RuntimeError(f"BERT forward through the flash kernel: max "
                           f"logit err {err}, argmax agreement {agree}")


def phase_causal(model):
    """The full-width CausalLM forward through the causal flash kernel
    against its plain causal attention, B=4, T=1024."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models import causal_lm
    ids = torch.as_tensor(np.random.RandomState(3).randint(
        0, model.config.vocab_size, (CAUSAL_B, MAX_CTX)), device="cuda")
    with torch.no_grad():
        out = [causal_lm.forward(model.params, ids, model.config,
                                 use_flash=uf) for uf in (True, False)]
    err = (out[0] - out[1]).abs().max().item()
    agree = (out[0].argmax(-1) == out[1].argmax(-1)).float().mean().item()
    emit({"phase": "causal", "B": CAUSAL_B, "T": MAX_CTX,
          "logit_max_abs_err": err, "argmax_agree": agree})
    if not (torch.isfinite(out[0]).all() and err <= STEP_LOGIT_ATOL):
        raise RuntimeError(f"causal flash forward: logits differ by {err}"
                           f" > {STEP_LOGIT_ATOL}")


def flash_work(B, T, H=FLASH_H, D=FLASH_D, causal=False, mask=True):
    """(bytes, flops) of the forward, dq, dk/dv and the whole backward at
    an all-ones key mask (or none, ``mask=False``): every (query, key)
    pair is needed, or under ``causal`` the T(T+1)/2 pairs on and below
    the diagonal. Each input read once, each output written once; 2*D
    flops per pair per product (forward: 2 products, dq: 3, dk/dv: 4, as
    each kernel computes them).
    The dq kernel also reads o and writes delta (its prologue's
    rowsum(o * g)), which the dk/dv kernel reads; the whole backward
    reads q, k, v, g, o, lse and the mask and writes dq, dk and dv. Its
    function needs 5 products (S, dP, dV, dK, dQ: what SDPA's backward
    runs); that the two kernels each recompute S and dP is the design's
    cost, not the function's work, so the bound counts 5."""
    x = B * T * H * D * 2            # one bf16 [B, T, H, D] tensor
    row = B * H * T * 4              # one f32 [B, H, T] (lse, delta)
    m = B * T * 4 if mask else 0     # the int32 mask
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    return {"flash_attention_fwd": (4 * x + row + m, 2 * 2 * D * pairs),
            "flash_attention_dq": (6 * x + 2 * row + m, 3 * 2 * D * pairs),
            "flash_attention_dkv": (6 * x + 2 * row + m,
                                    4 * 2 * D * pairs),
            "flash_attention_bwd": (8 * x + row + m, 5 * 2 * D * pairs)}


def flash_rows(launches, errs):
    """Kernel, plain and library times of the three flash kernels at the
    train shape (the row) and at T=512 (a shape record), and of the whole
    port backward (``_flash_bwd``: the dq kernel with its delta prologue,
    then the dk/dv kernel) at both. The plain and library backward times
    are one whole backward (dq, dk and dv together), reported on both
    backward rows and on the whole-backward record. Then the causal
    forward at the CausalLM's shape (a shape record)."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import (
        flash_attention_with_lse_plain)
    fl = flash_module()
    rows, shapes = [], []
    for i, (B, T) in enumerate(FLASH_SHAPES):
        q, k, v, do, mask = flash_inputs(B, T, seed=40 + i)
        o, lse = fl._flash_fwd(q, k, v, mask, False, None)
        delta = fl._flash_bwd_dq(q, k, v, do, o, lse, None, mask, False,
                                 None)[1]
        kern = {
            "flash_attention_fwd":
                lambda: fl._flash_fwd(q, k, v, mask, False, None),
            "flash_attention_dq":
                lambda: fl._flash_bwd_dq(q, k, v, do, o, lse, None, mask,
                                         False, None),
            "flash_attention_dkv":
                lambda: fl._flash_bwd_dkv(q, k, v, do, lse, delta, mask,
                                          False, None),
            "flash_attention_bwd":
                lambda: fl._flash_bwd(q, k, v, mask, o, lse, do, False,
                                      None)}
        ts = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        with torch.no_grad():
            plain_fwd = time_ms(lambda: flash_attention_with_lse_plain(
                q, k, v, mask), iters=10)
        o_plain = flash_attention_with_lse_plain(*ts, mask=mask)[0]
        plain_bwd = time_ms(lambda: torch.autograd.grad(
            o_plain, ts, do, retain_graph=True), iters=10)
        del o_plain
        qt, kt, vt = (t.transpose(1, 2) for t in ts)
        am = mask.bool()[:, None, None, :]
        with torch.no_grad():
            lib_fwd = time_spread(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=am))
        o_lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)
        do_t = do.transpose(1, 2)
        lib_bwd = time_spread(lambda: torch.autograd.grad(
            o_lib, ts, do_t, retain_graph=True))
        del o_lib
        work = flash_work(B, T)
        for name, fn in kern.items():
            b_ms, b_by = bound_ms(*work[name])
            fwd = name == "flash_attention_fwd"
            lib_ms, lib_spread = lib_fwd if fwd else lib_bwd
            rec = {"plain_ms": plain_fwd if fwd else plain_bwd,
                   "library_ms": lib_ms, "library_ms_spread": lib_spread,
                   "bound_ms": b_ms, "bound_by": b_by, "windows": WINDOWS}
            timed(rec, "ms", fn)
            shapes.append({"name": name, "B": B, "T": T, **rec})
            if name == "flash_attention_bwd":
                rec["over_library"] = rec["ms"] / lib_ms
                emit({"phase": "flash_backward", "B": B, "T": T, **rec})
            elif i == 0:
                rows.append({
                    "name": name, "route": "cuda",
                    "source": "deeplearning4j_tpu_torch/kernels/csrc/"
                              + ("flash_attention_fwd.cu" if fwd
                                 else "flash_attention_bwd.cu"),
                    "replaces": "deeplearning4j_tpu/kernels/"
                                "flash_attention.py:" + {
                                    "flash_attention_fwd": "120",
                                    "flash_attention_dq": "260",
                                    "flash_attention_dkv": "287"}[name],
                    "launches": launches[name],
                    "max_abs_err": errs[name], **rec})
        del q, k, v, do, ts, o, lse, delta
    shapes.append(causal_fwd_record())
    return rows, shapes


def causal_fwd_record():
    """The forward kernel as the CausalLM's full forward calls it
    (``causal=True``, no key mask) at B=4, T=1024, 12 heads of 64: its o
    and lse against the plain version (``FLASH_*`` tolerances; lse within
    1e-4), and its time beside the plain version's and SDPA's with
    ``is_causal=True``; the bound counts the T(T+1)/2 visible pairs."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import (
        flash_attention_with_lse_plain)
    fl = flash_module()
    B, T = CAUSAL_B, MAX_CTX
    q, k, v = flash_inputs(B, T, seed=50)[:3]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    with torch.no_grad():
        o, lse = fl._flash_fwd(q, k, v, None, True, None)
        o_ref, lse_ref = flash_attention_with_lse_plain(q, k, v,
                                                        causal=True)
        o, o_ref = o.float(), o_ref.float()
        err = (o - o_ref).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        ok = (torch.allclose(o, o_ref, atol=FLASH_ATOL, rtol=FLASH_RTOL)
              and (o - o_ref).pow(2).mean().sqrt().item()
              <= FLASH_REL_RMS * o_ref.pow(2).mean().sqrt().item()
              and lse_err <= 1e-4)
        if not ok:
            raise RuntimeError(f"causal flash forward B={B} T={T}: max abs "
                               f"err {err} (o), {lse_err} (lse)")
        del o, o_ref, lse, lse_ref
        plain_ms = time_ms(lambda: flash_attention_with_lse_plain(
            q, k, v, causal=True), iters=10)
        rec = {"name": "flash_attention_fwd", "B": B, "T": T,
               "causal": True, "max_abs_err": err,
               "lse_max_abs_err": lse_err, "plain_ms": plain_ms,
               "windows": WINDOWS}
        timed(rec, "library_ms", lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        timed(rec, "ms", lambda: fl._flash_fwd(q, k, v, None, True, None))
    rec["bound_ms"], rec["bound_by"] = bound_ms(*flash_work(
        B, T, causal=True, mask=False)["flash_attention_fwd"])
    return rec

def zoo_batches(rng, n, B, in_shape, num_classes):
    """Device-resident DataSets of seeded random inputs and one-hot labels
    (bench.py ``_zoo_batches``)."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    out = []
    for _ in range(n):
        x = rng.randn(B, *in_shape).astype(np.float32)
        y = np.zeros((B, num_classes), np.float32)
        y[np.arange(B), rng.randint(0, num_classes, B)] = 1.0
        out.append(DataSet(torch.from_numpy(x).cuda(),
                           torch.from_numpy(y).cuda()))
    return out


def phase_lenet():
    """LeNet-MNIST training through ``MultiLayerNetwork.fit`` at full
    width (bf16 body), then an f32 copy's ``output()`` against the CPU's
    with TF32 allowed in the process: the port must not use it. The loss
    of an epoch is ``score()``'s mean over the 32 batches after it, and
    must fall from the first epoch to the last; the last batch's
    training loss is printed beside it."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.quant.transforms import \
        _fused_dequant_matmul
    from deeplearning4j_tpu_torch.zoo import LeNet
    net = LeNet(dtype="bfloat16").init_model(device="cuda")
    batches = zoo_batches(np.random.RandomState(0), LENET_BATCHES, LENET_B,
                          (1, 28, 28), 10)
    def mean_score():
        return float(np.mean([net.score(b) for b in batches]))

    # warm_compile before the first fit: every kernel library present or
    # from the store ("hit"), one train event, the params untouched
    from deeplearning4j_tpu_torch.common.environment import environment
    before = [t.clone() for p in net._params for t in p.values()]
    events = []
    environment().add_compile_listener(events.append)
    try:
        t0 = time.perf_counter()
        warm_label = net.warm_compile(batches[:1])
        warm_compile_s = time.perf_counter() - t0
    finally:
        environment().remove_compile_listener(events.append)
    warm_kinds = [str(k[0]).split(":")[0] for k in events]
    untouched = all(torch.equal(a, b) for a, b in zip(
        before, [t for p in net._params for t in p.values()]))
    if warm_label != "hit" or warm_kinds != ["train"] or not untouched:
        raise RuntimeError(f"warm_compile: {warm_label!r}, events "
                           f"{warm_kinds}, params untouched {untouched}")
    n0 = _fused_dequant_matmul.launches
    t0 = time.perf_counter()
    net.fit(batches, num_epochs=1)
    t_warm = time.perf_counter() - t0
    first, first_mean = net.score_value, mean_score()
    t0 = time.perf_counter()
    net.fit(batches, num_epochs=LENET_EPOCHS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    last, last_mean = net.score_value, mean_score()
    steps = LENET_EPOCHS * LENET_BATCHES
    step_ms = wall * 1e3 / steps
    # one more epoch under the profiler: device ms per step by kernel
    by_name = {k: v / LENET_BATCHES for k, v in device_ms_by_kernel(
        lambda: net.fit(batches, num_epochs=1), 1).items()}
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    conv = sum(v for k, v in by_name.items()
               if any(f in k.lower() for f in ("conv", "cudnn", "implicit",
                                               "wgrad", "dgrad", "xmma")))
    # an f32 copy of the trained weights on the card and on the CPU
    params = [{k: v.clone() for k, v in p.items()} for p in net._params]
    f32 = LeNet().init_model(device="cuda")
    f32.init(params=params)
    cpu = LeNet().init_model(device="cpu")
    cpu.init(params=[{k: v.cpu() for k, v in p.items()} for p in params])
    x = batches[0].features.torch()
    ref = cpu.output(x.cpu()).numpy()
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = f32.output(x).numpy()
        # the same forward with the port's TF32 guard taken away, to show
        # what a leak reads (run eagerly: output() replays the graph it
        # captured under the guard)
        with torch.no_grad():
            leak = f32._forward(f32._params, x, False).cpu().numpy()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    err = float(np.abs(got - ref).max())
    rec = {"phase": "lenet", "B": LENET_B, "batches": LENET_BATCHES,
           "epochs_timed": LENET_EPOCHS, "dtype": "bfloat16",
           "params": net.num_params(), "warm_epoch_s": round(t_warm, 3),
           "warm_compile": warm_label, "warm_compile_s": warm_compile_s,
           "wall_s": wall, "step_ms": step_ms,
           "samples_per_s": steps * LENET_B / wall,
           "loss_first_epoch": first, "loss_last_epoch": last,
           "mean_loss_after_first_epoch": first_mean,
           "mean_loss_after_last_epoch": last_mean,
           "device_ms_per_step": device_ms,
           "device_busy_share": device_ms / step_ms,
           "conv_ms_per_step": conv, "kernels_seen": len(by_name),
           "top_kernels_ms_per_step": [[k[:80], v] for k, v in top],
           "dequant_launches": _fused_dequant_matmul.launches - n0,
           "f32_output_vs_cpu_max_abs_err": err,
           "f32_output_vs_cpu_tol": LENET_F32_ATOL,
           "f32_output_vs_cpu_max_abs_err_tf32_unguarded":
               float(np.abs(leak - ref).max())}
    emit(rec)
    if not (np.isfinite(first_mean) and np.isfinite(last_mean)
            and last_mean < first_mean and np.isfinite(last)):
        raise RuntimeError(f"LeNet loss did not fall: mean over the 32 "
                           f"batches {first_mean} after the first epoch, "
                           f"{last_mean} after the last")
    if not err <= LENET_F32_ATOL:
        raise RuntimeError(f"f32 LeNet output on the card differs from the "
                           f"CPU's by {err} > {LENET_F32_ATOL} (TF32?)")


def write_idx(path, arr):
    """An IDX file (MNIST's container: magic 0, 0, 8 = u8, ndim; big-endian
    dims; the bytes) of the u8 array ``arr``."""
    import struct
    with open(path, "wb") as f:
        f.write(bytes([0, 0, 8, arr.ndim]))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.tobytes())


def span_seconds(name):
    """Seconds in the tracer's buffer under spans named ``name``."""
    from deeplearning4j_tpu_torch.common import tracing
    return sum(e["dur"] for e in tracing.tracer().events()
               if e["name"] == name) / 1e6


def feed_record(net, feed, steps, profiled):
    """One warm ``fit`` epoch over ``feed`` (captures), one timed with the
    tracer's ``train/data_wait`` spans, one more with the census counted
    (none may come), then ``profiled`` (DATA_PROFILED batches of the same
    shape, fed the same way) once to warm and once under the profiler:
    samples/s, host ms a step, the data-wait share of the timed epoch,
    device ms a step and the busy share, and the train graphs' report."""
    import torch
    from deeplearning4j_tpu_torch.common import tracing
    net.fit(feed, num_epochs=1)
    torch.cuda.synchronize()
    tracing.tracer().clear()
    blocked0 = getattr(feed, "blocked_s", 0.0)
    t0 = time.perf_counter()
    net.fit(feed, num_epochs=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    wait = span_seconds("train/data_wait")
    blocked = getattr(feed, "blocked_s", 0.0) - blocked0
    census = census_of(lambda: net.fit(feed, num_epochs=1))
    net.fit(profiled, num_epochs=1)
    by_name = device_ms_by_kernel(lambda: net.fit(profiled, num_epochs=1),
                                  1)
    device_ms = sum(by_name.values()) / DATA_PROFILED
    step_ms = wall * 1e3 / steps
    graphs = [g for g in net.train_graphs_report()
              if g["tag"].split(":")[0] in ("train", "epoch")]
    return {"steps": steps, "wall_s": wall,
            "samples_per_s": steps * LENET_B / wall, "step_ms": step_ms,
            "data_wait_s": wait, "data_wait_share": wait / wall,
            "ring_blocked_ms_per_step": blocked * 1e3 / steps,
            "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / step_ms,
            "census_repeat_fit": census,
            "graphs": [{k: g[k] for k in ("tag", "cache", "captures",
                                           "replays")} for g in graphs],
            "loss": net.score_value}


def tabular_csv(path, rng):
    """The tabular path's CSV: TAB_NUMERIC numeric columns of assorted
    scales, two categorical ones and a label that a linear map of them
    decides (so the loss can fall). Returns the label column."""
    x = rng.randn(TAB_ROWS, TAB_NUMERIC) * rng.uniform(0.5, 20, TAB_NUMERIC) \
        + rng.uniform(-5, 5, TAB_NUMERIC)
    cats = [rng.randint(0, len(s), TAB_ROWS) for s in TAB_STATES]
    logits = ((x - x.mean(0)) / x.std(0)) @ rng.randn(TAB_NUMERIC,
                                                       TAB_CLASSES) \
        + np.eye(len(TAB_STATES[0]))[cats[0]] @ rng.randn(
            len(TAB_STATES[0]), TAB_CLASSES)
    label = np.argmax(logits, 1)
    with open(path, "w") as f:
        f.write(",".join([f"f{i}" for i in range(TAB_NUMERIC)]
                         + ["c0", "c1", "label"]) + "\n")
        for i in range(TAB_ROWS):
            f.write(",".join(f"{v:.6g}" for v in x[i]) + ","
                    + ",".join(s[c[i]] for s, c in zip(TAB_STATES, cats))
                    + f",{label[i]}\n")
    return label


def phase_data():
    """The data pipeline on the card (module docstring, ``data``)."""
    import shutil
    import tempfile
    import torch
    from deeplearning4j_tpu_torch import etl, native
    from deeplearning4j_tpu_torch.datasets import fetchers
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import (
        AsyncDataSetIterator, ListDataSetIterator,
        NativeBatchDataSetIterator)
    from deeplearning4j_tpu_torch.datasets.record_iterator import \
        RecordReaderDataSetIterator
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.nn import (InputType, MultiLayerNetwork,
                                             NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.zoo import LeNet
    t_phase = time.perf_counter()
    fails = []
    tmp = tempfile.mkdtemp(prefix="data-")
    try:
        # 1. the native library, built here with g++
        t0 = time.perf_counter()
        ok = native.available()
        rec = {"native_available": ok,
               "native_build_s": native.build_seconds,
               "native_load_s": time.perf_counter() - t0,
               "native_library": os.path.relpath(native._lib_path())}
        if not ok:
            raise RuntimeError(f"native library did not build: "
                               f"{native.build_error()}")
        # 2. an IDX file of MNIST's training shape
        rng = np.random.RandomState(DATA_SEED)
        images = rng.randint(0, 256, (DATA_N, 28, 28)).astype(np.uint8)
        labels = rng.randint(0, 10, DATA_N).astype(np.uint8)
        img_path = os.path.join(tmp, "train-images-idx3-ubyte")
        lab_path = os.path.join(tmp, "train-labels-idx1-ubyte")
        write_idx(img_path, images)
        write_idx(lab_path, labels)
        t0 = time.perf_counter()
        x_native = native.read_idx(img_path, normalize=True)
        rec["read_idx_native_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        x_numpy = native._read_idx_py(img_path, normalize=True)
        rec["read_idx_numpy_s"] = time.perf_counter() - t0
        raw_equal = bool(np.array_equal(native.read_idx(img_path),
                                        native._read_idx_py(img_path,
                                                            False)))
        norm_diff = float(np.abs(x_native - x_numpy).max())
        parsed = fetchers.parse_idx(lab_path)
        rec.update({"idx_bytes": os.path.getsize(img_path),
                    "read_idx_equal_raw": raw_equal,
                    "read_idx_normalized_max_abs_diff": norm_diff,
                    "parse_idx_dtype": str(parsed.dtype)})
        # x * (1/255) in the C++ against x / 255 in numpy: an ulp apart
        if not raw_equal or norm_diff > 1e-7 or parsed.dtype != np.float32 \
                or not np.array_equal(parsed, labels):
            fails.append(f"IDX reads differ: raw equal {raw_equal}, "
                         f"normalized {norm_diff}, parse_idx "
                         f"{parsed.dtype}")
        x = x_native.reshape(DATA_N, 1, 28, 28)
        y = np.eye(10, dtype=np.float32)[parsed.astype(np.int64)]
        del x_numpy, images
        emit({"phase": "data", "part": "idx", **rec})

        # 3. LeNet fed three ways; the ring's epoch first, card vs CPU
        steps = DATA_N // LENET_B
        card = NativeBatchDataSetIterator(x, y, LENET_B, seed=DATA_SEED,
                                          device="cuda", drop_last=True)
        host = NativeBatchDataSetIterator(x, y, LENET_B, seed=DATA_SEED,
                                          device="cpu", drop_last=True)
        # the ring alone: the CPU ring's epoch (the C++ thread's gather
        # and ring_next's copy out of its slot), then the card's, every
        # batch kept (a fresh pinned block each)
        t0 = time.perf_counter()
        host_batches = list(host)
        ring_cpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        card_batches = list(card)
        torch.cuda.synchronize()
        ring_card_s = time.perf_counter() - t0
        ring_equal = len(card_batches) == len(host_batches) == steps and all(
            torch.equal(c.features.torch().cpu(), h.features.torch())
            and torch.equal(c.labels.torch().cpu(), h.labels.torch())
            for c, h in zip(card_batches, host_batches))
        if not ring_equal:
            fails.append("the card ring's epoch differs from the CPU's")
        n_prof = DATA_PROFILED * LENET_B
        feeds = {"ring": (card, NativeBatchDataSetIterator(
                     x[:n_prof], y[:n_prof], LENET_B, seed=DATA_SEED,
                     device="cuda", drop_last=True)),
                 "prestaged": (ListDataSetIterator(card_batches),
                               ListDataSetIterator(
                                   card_batches[:DATA_PROFILED])),
                 "async": (AsyncDataSetIterator(
                     ListDataSetIterator(host_batches), device="cuda"),
                     AsyncDataSetIterator(ListDataSetIterator(
                         host_batches[:DATA_PROFILED]), device="cuda"))}
        lenet = {}
        for name, (feed, profiled) in feeds.items():
            net = LeNet(dtype="bfloat16").init_model(device="cuda")
            lenet[name] = feed_record(net, feed, steps, profiled)
            want = "epoch" if name == "prestaged" else "train"
            g = lenet[name]["graphs"]
            # one signature a batch count on the epoch path (the profiled
            # feed's is its own), one train signature on the per-step path
            if lenet[name]["census_repeat_fit"] or not g or any(
                    e["cache"] != "captured" or not e["replays"]
                    or e["tag"].split(":")[0] != want for e in g) or \
                    len(g) != (2 if name == "prestaged" else 1) or \
                    not np.isfinite(lenet[name]["loss"]):
                fails.append(f"LeNet {name}: census "
                             f"{lenet[name]['census_repeat_fit']}, graphs "
                             f"{g}, loss {lenet[name]['loss']}")
            del net
        emit({"phase": "data", "part": "lenet", "B": LENET_B,
              "dtype": "bfloat16", "profiled_steps": DATA_PROFILED,
              "ring_cpu_epoch_s": ring_cpu_s,
              "ring_cpu_ms_per_batch": ring_cpu_s * 1e3 / steps,
              "ring_card_epoch_kept_s": ring_card_s,
              "card_ring_equals_cpu_ring": ring_equal, **lenet})
        # the params after the same 3 steps: fed by the ring (per-step
        # path) and pre-staged (epoch path) from one seed
        n = DATA_PARITY_STEPS * LENET_B
        ring = NativeBatchDataSetIterator(x[:n], y[:n], LENET_B,
                                          seed=DATA_SEED, device="cuda",
                                          drop_last=True)
        twin = NativeBatchDataSetIterator(x[:n], y[:n], LENET_B,
                                          seed=DATA_SEED, device="cuda",
                                          drop_last=True)
        twin.reset()    # fit resets once, then iter() starts the epoch
        staged = list(twin)
        nets = {}
        for name, feed in (("ring", ring), ("prestaged", staged)):
            nets[name] = LeNet(dtype="bfloat16").init_model(device="cuda")
            nets[name].fit(feed, num_epochs=1)
        a, b = train_state(nets["ring"]), train_state(nets["prestaged"])
        diff = max(float((s - t).float().abs().max()) for s, t in zip(a, b))
        parity = {"steps": DATA_PARITY_STEPS,
                  "bitwise_equal": bits_equal(nets["ring"],
                                              nets["prestaged"]),
                  "max_abs_diff": diff,
                  "loss": [nets[k].score_value for k in nets],
                  "caches": {k: caches_of(v) for k, v in nets.items()}}
        emit({"phase": "data", "part": "lenet_parity", **parity})
        if not parity["bitwise_equal"]:
            fails.append(f"ring-fed and pre-staged params differ by {diff} "
                         f"after {DATA_PARITY_STEPS} steps")
        del nets, card_batches, host_batches, feeds, staged, x, y
        free_card()

        # 5. the tabular path
        csv = os.path.join(tmp, "tabular.csv")
        t0 = time.perf_counter()
        label = tabular_csv(csv, np.random.RandomState(DATA_SEED))
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        records = list(etl.CSVRecordReader(skip_num_lines=1).initialize(
            etl.FileSplit(csv)))
        read_s = time.perf_counter() - t0
        names = [f"f{i}" for i in range(TAB_NUMERIC)]
        schema = (etl.Schema.Builder().add_columns_double(*names)
                  .add_column_categorical("c0", list(TAB_STATES[0]))
                  .add_column_categorical("c1", list(TAB_STATES[1]))
                  .add_column_integer("label").build())
        t0 = time.perf_counter()
        stats = etl.analyze_local(schema, records)
        analyze_s = time.perf_counter() - t0
        # the numbers as the CSV holds them (6 significant digits)
        parsed_num = np.array([[float(v) for v in r[:TAB_NUMERIC]]
                               for r in records])
        cut = float(np.quantile(parsed_num[:, 0], 0.99))
        b = (etl.TransformProcess.Builder(schema)
             .categorical_to_one_hot("c0", "c1")
             .filter(etl.ColumnCondition("f0", etl.ConditionOp.GreaterThan,
                                         cut)))
        for c in names:
            a = stats.analysis_for(c)
            b = (b.double_math_op(c, "Subtract", a.min)
                 .double_math_op(c, "Divide", a.max - a.min))
        tp = b.double_columns_math_op("f0_x_f1", "Multiply", "f0",
                                      "f1").build()
        t0 = time.perf_counter()
        it = RecordReaderDataSetIterator(
            etl.CollectionRecordReader(records).initialize(), TAB_B,
            label_index=tp.final_schema().index_of("label"),
            num_classes=TAB_CLASSES, transform_process=tp, device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        kept = it.total_examples()
        # the card's matrix against numpy's min-max of the same numbers:
        # the same float64 operations on both sides, then float32
        keep = parsed_num[:, 0] <= cut
        lo, hi = parsed_num.min(0), parsed_num.max(0)
        want = ((parsed_num[keep] - lo) / (hi - lo)).astype(np.float32)
        got = it._features[:, :TAB_NUMERIC].cpu().numpy()
        minmax_err = float(np.abs(got - want).max()) \
            if got.shape == want.shape else float("inf")
        label_ok = bool(np.array_equal(
            it._labels.argmax(1).cpu().numpy(), label[
                np.array([float(r[0]) for r in records]) <= cut]))
        width = it._features.shape[1]
        conf = (NeuralNetConfiguration.builder().seed(DATA_SEED)
                .updater(Adam(1e-3)).list()
                .layer(DenseLayer(n_out=256, activation="relu"))
                .layer(DenseLayer(n_out=256, activation="relu"))
                .layer(OutputLayer(n_out=TAB_CLASSES))
                .set_input_type(InputType.feed_forward(width)).build())
        mlp = MultiLayerNetwork(conf, device="cuda").init()
        # the loss of one fixed batch, before and after each epoch
        probe = DataSet(it._features[:TAB_B], it._labels[:TAB_B])
        first = mlp.score(probe)
        losses, epoch_s = [], []
        for _ in range(TAB_EPOCHS):
            t0 = time.perf_counter()
            mlp.fit(it, num_epochs=1)
            torch.cuda.synchronize()
            epoch_s.append(time.perf_counter() - t0)
            losses.append(mlp.score(probe))
        tab = {"rows": TAB_ROWS, "kept": kept, "features": width,
               "transforms": len(tp.steps), "csv_write_s": write_s,
               "csv_read_s": read_s, "csv_records_per_s": TAB_ROWS / read_s,
               "analyze_s": analyze_s,
               "iterator_build_s": build_s,
               "executor_and_vectorise_records_per_s": TAB_ROWS / build_s,
               "minmax_max_abs_err": minmax_err, "labels_equal": label_ok,
               "B": TAB_B,
               "epoch_s": epoch_s,
               "fit_samples_per_s": kept / min(epoch_s[1:]),
               "probe_loss_before": first,
               "probe_loss_after_each_epoch": losses,
               "last_step_loss": mlp.score_value,
               "caches": caches_of(mlp)}
        emit({"phase": "data", "part": "tabular", **tab})
        if not (minmax_err == 0.0 and label_ok and np.isfinite(losses).all()
                and first > losses[0] > losses[-1]):
            fails.append(f"tabular: min-max error {minmax_err}, labels "
                         f"equal {label_ok}, losses "
                         f"{first} then {losses}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "data", "seconds": time.perf_counter() - t_phase})
    if fails:
        raise RuntimeError(f"data phase failed: {fails}")


def mlp_network(device="cuda"):
    """The quantized-inference MLP of bench.py bench_quantized_inference
    (random weights from seed 0)."""
    from deeplearning4j_tpu_torch.nn import (MultiLayerNetwork,
                                             NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                         OutputLayer)
    b = NeuralNetConfiguration.builder().seed(0).list()
    b.layer(DenseLayer(n_in=MLP_IN, n_out=MLP_HIDDEN, activation="gelu"))
    for _ in range(MLP_HIDDEN_LAYERS - 1):
        b.layer(DenseLayer(n_in=MLP_HIDDEN, n_out=MLP_HIDDEN,
                           activation="gelu"))
    b.layer(OutputLayer(n_in=MLP_HIDDEN, n_out=MLP_OUT))
    return MultiLayerNetwork(b.build(), device=device).init()


def phase_mlp_int8():
    """The MLP served through ``output()`` three ways (f32, bf16 over the
    same params, the int8 twin), the twin's dense layers through the
    dequant kernel. Returns the kernel's launches on the twin's timed
    run and the twin."""
    import copy
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.kernels import dispatch_snapshot
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.quant import (calibrate,
                                                divergence_report,
                                                param_bytes_of,
                                                quantize_model)
    from deeplearning4j_tpu_torch.quant.transforms import \
        _fused_dequant_matmul
    full = mlp_network()
    bf16 = MultiLayerNetwork(copy.copy(full.conf), device="cuda")
    bf16.conf.dtype = "bfloat16"
    bf16.init(params=full._params)
    quant = quantize_model(full, device="cuda")
    # the margin-filtered batch: of 4 x B candidates the B whose f32
    # top-2 margin is largest (decisive traffic, as the bench picks it)
    cands = np.random.RandomState(0).randn(4 * MLP_B, MLP_IN).astype(
        np.float32)
    ref_c = full.output(cands).numpy()
    part = np.partition(ref_c, -2, axis=-1)
    batch = cands[np.argsort(part[:, -1] - part[:, -2])[-MLP_B:]]
    xb = torch.from_numpy(batch).cuda()
    ref = full.output(xb).numpy()
    q_out = quant.output(xb).numpy()
    top1 = float((ref.argmax(-1) == q_out.argmax(-1)).mean())

    def windows(net):
        net.output(xb)
        torch.cuda.synchronize()
        rates = []
        for _ in range(WINDOWS):
            t0 = time.perf_counter()
            for _ in range(MLP_REPS):
                out = net.output(xb)
            out.torch().sum().item()
            rates.append(MLP_B * MLP_REPS / (time.perf_counter() - t0))
        rates.sort()
        return rates[len(rates) // 2], [rates[0], rates[-1]]

    rec = {"phase": "mlp_int8", "B": MLP_B,
           "layers": f"{MLP_IN}->{MLP_HIDDEN} gelu, "
                     f"{MLP_HIDDEN_LAYERS - 1}x {MLP_HIDDEN}->{MLP_HIDDEN} "
                     f"gelu, {MLP_HIDDEN}->{MLP_OUT} softmax",
           "twin_conf_dtype": quant.conf.dtype}
    rec["f32_samples_per_s"], rec["f32_spread"] = windows(full)
    rec["bf16_samples_per_s"], rec["bf16_spread"] = windows(bf16)
    # the main path: the twin's output() calls, counted from 0
    _fused_dequant_matmul.launches = 0
    rec["int8_samples_per_s"], rec["int8_spread"] = windows(quant)
    launches = _fused_dequant_matmul.launches
    calls = 1 + WINDOWS * MLP_REPS
    rec.update({
        "int8_over_bf16": rec["int8_samples_per_s"]
        / rec["bf16_samples_per_s"],
        "dequant_launches": launches, "output_calls": calls,
        "dequant_launches_per_output": launches / calls,
        "dispatch": dispatch_snapshot().get("dequant_matmul"),
        "top1_agreement_vs_f32": top1,
        "max_abs_err_vs_f32": float(np.abs(ref - q_out).max()),
        "param_bytes_full": param_bytes_of(full),
        "param_bytes_int8": param_bytes_of(quant)})
    rep = divergence_report(full, quant, xb)
    spec = calibrate(quant, xb)
    rec["divergence_report"] = rep
    rec["calibrated_ranges"] = spec.act_ranges
    emit(rec)
    if launches != 5 * calls:
        raise RuntimeError(f"the twin launched the dequant kernel {launches}"
                           f" times in {calls} output() calls, want 5 each")
    if not (top1 >= MLP_MIN_TOP1 and np.isfinite(q_out).all()):
        raise RuntimeError(f"int8 twin top-1 agreement {top1} < "
                           f"{MLP_MIN_TOP1} against f32")
    if rep["top1_agreement"] != top1:
        raise RuntimeError(f"divergence_report top-1 {rep} disagrees with "
                           f"the phase's {top1}")
    return launches, quant


def mlp_kernel_rows(twin, launches, errs, Ms=(MLP_B,),
                    main_path="mlp_int8"):
    """The dequant kernel at the twin's three shapes for each M of
    ``Ms``, as its output() calls it (operands warm: the twin's 13.8 MB
    of int8 weights stay in the 50 MB L2 between calls), beside its plain
    version, ``torch.matmul`` on a copy of the weight in the activation's
    dtype and the bound; ``launches`` are those of ``main_path``."""
    import torch
    from deeplearning4j_tpu_torch.quant.transforms import (
        _fused_dequant_matmul, dequant_matmul_plain, dequantize)
    rows = []
    g = torch.Generator(device="cuda").manual_seed(17)
    layer_of = {(MLP_IN, MLP_HIDDEN): 0, (MLP_HIDDEN, MLP_HIDDEN): 1,
                (MLP_HIDDEN, MLP_OUT): MLP_HIDDEN_LAYERS}
    for M, ((K, N), li) in ((M, kv) for M in Ms
                            for kv in layer_of.items()):
        w = twin._params[li]["W"]
        head = li == MLP_HIDDEN_LAYERS
        dtype = torch.float32 if head else torch.bfloat16
        x = torch.randn((M, K), generator=g, device="cuda").to(dtype)
        scale = w.scale.reshape(-1)
        wd = dequantize(w, dtype)
        xb = 4 if head else 2
        byt = M * K * xb + K * N + N * 4 + M * N * xb
        b_ms, b_by = bound_ms(byt, 2 * M * K * N,
                              F32_FLOPS_PER_S if head else BF16_FLOPS_PER_S)
        rec = {"name": "dequant_matmul", "route": "cuda",
               "source": "deeplearning4j_tpu_torch/kernels/csrc/"
                         "dequant_matmul.cu",
               "replaces": "deeplearning4j_tpu/quant/transforms.py:216",
               "main_path": main_path, "M": M, "K": K, "N": N,
               "dtype": str(dtype).split(".")[-1], "launches": launches,
               "max_abs_err": errs["dequant_mlp"][
                   (M, K, N, str(dtype).split(".")[-1])],
               "plain_ms": time_ms(lambda: dequant_matmul_plain(x, w.q,
                                                                scale)),
               "bound_ms": b_ms, "bound_by": b_by, "windows": WINDOWS}
        timed(rec, "ms", lambda: _fused_dequant_matmul(x, w.q, scale))
        timed(rec, "library_ms", lambda: torch.matmul(x, wd))
        rows.append(rec)
    return rows


#: host-profile records of the HTTP windows, by phase (host_profile line)
HOST_PROFILES = {}

#: the innermost Python functions of a thread that is waiting, not
#: working (a lock, a socket, a pipe, a sleep)
_WAITING = frozenset((
    "wait", "select", "poll", "accept", "sleep", "readinto", "recv_into",
    "_recv_into", "get", "join", "_wait_for_tstate_lock", "serve_forever",
    "communicate", "_communicate", "read", "readline", "_sampler",
    "_worker", "handle_one_request", "_bootstrap_inner"))


def host_profile(fn, top=10):
    """``fn()`` under ``torch.profiler`` with CPU activities and, beside
    it, a 1 kHz sampling of every thread's innermost Python frame.
    Returns (fn's result, the record): the window's wall seconds, the
    profiler's top ``top`` events by self CPU time and their sum over
    all events, and the top ``top`` Python functions by samples among
    threads that were not waiting (``_WAITING``), with the waiting
    share. The calling thread, which only waits for the clients, is not
    sampled."""
    import collections
    import threading
    from torch.profiler import ProfilerActivity, profile
    try:
        # the server's handler and batcher threads, not only this one
        from torch.profiler import _ExperimentalConfig
        cfg = {"experimental_config":
               _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        cfg = {}
    samples = collections.Counter()
    waiting = [0, 0]
    stop = threading.Event()
    caller = threading.get_ident()  # it only waits for the clients

    def _sampler():
        me = threading.get_ident()
        while not stop.is_set():
            for tid, frame in sys._current_frames().items():
                if tid in (me, caller):
                    continue
                code = frame.f_code
                waiting[1] += 1
                if code.co_name in _WAITING:
                    waiting[0] += 1
                    continue
                samples[f"{os.path.basename(code.co_filename)}:"
                        f"{code.co_firstlineno}:{code.co_name}"] += 1
            time.sleep(0.001)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU], **cfg) as prof:
        th = threading.Thread(target=_sampler, daemon=True)
        th.start()
        try:
            out = fn()
        finally:
            stop.set()
            th.join(10)
    wall = time.perf_counter() - t0
    events = prof.key_averages()
    ranked = sorted(events, key=lambda e: e.self_cpu_time_total,
                    reverse=True)
    busy = sum(samples.values())
    return out, {
        "wall_s": wall, "profile_all_threads": bool(cfg),
        "profiler_self_cpu_ms_total":
            sum(e.self_cpu_time_total for e in events) / 1e3,
        "profiler_top_self_cpu": [
            {"name": e.key, "self_cpu_ms": e.self_cpu_time_total / 1e3,
             "calls": e.count} for e in ranked[:top]],
        "sampled_thread_frames": waiting[1],
        "sampled_waiting_share": waiting[0] / max(waiting[1], 1),
        "sampled_top_working": [
            {"function": k, "samples": n, "share_of_working": n / busy}
            for k, n in samples.most_common(top)]}


def predict_pools(mlp):
    """The seeded input pools the predict clients draw rows from: LeNet
    rows of unit normal noise (1x28x28), and MLP rows picked, of 4x as
    many candidates, by the largest top-2 margin of the f32 network
    (decisive traffic, as mlp_int8's batch)."""
    import numpy as np
    rng = np.random.RandomState(31)
    lenet_pool = rng.randn(POOL_ROWS, 1, 28, 28).astype(np.float32)
    cands = rng.randn(4 * POOL_ROWS, MLP_IN).astype(np.float32)
    ref = mlp.output(cands).numpy()
    part = np.partition(ref, -2, axis=-1)
    mlp_pool = cands[np.argsort(part[:, -1] - part[:, -2])[-POOL_ROWS:]]
    return {"lenet": lenet_pool, "mlp": np.ascontiguousarray(mlp_pool)}


def pool_outputs(net, pool):
    """``net.output`` over a whole pool, MAX_BATCH rows a call (each call
    on a rung of the ladder)."""
    import numpy as np
    return np.concatenate([net.output(pool[i:i + PREDICT_MAX_BATCH]).numpy()
                           for i in range(0, len(pool), PREDICT_MAX_BATCH)])


def check_predictions(results, requests, refs, atol, top1_refs=()):
    """Every (status, doc, t0, t1) of ``results`` against ``refs`` (the
    reference outputs of the whole pool) on the request's rows: status
    200, finite outputs of the right shape within ``atol``. Returns
    (max abs err, {name: top-1 agreement} against each array of
    ``top1_refs``)."""
    import numpy as np
    err, agree, n = 0.0, {k: 0 for k, _ in top1_refs}, 0
    for i, ((status, doc, _, _), r) in enumerate(zip(results, requests)):
        want = refs[r["lo"]:r["lo"] + r["rows"]]
        got = np.asarray(doc.get("outputs", []), np.float32)
        if status != 200 or got.shape != want.shape \
                or not np.isfinite(got).all():
            raise RuntimeError(f"predict {i} to {r['model']}: status "
                               f"{status}, shape {got.shape}: "
                               f"{str(doc)[:300]}")
        e = float(np.abs(got - want).max())
        if e > atol:
            raise RuntimeError(f"predict {i} to {r['model']}: max abs err "
                               f"{e} > {atol} against the model's own "
                               "output()")
        err = max(err, e)
        for k, ref in top1_refs:
            agree[k] += int((got.argmax(-1) == ref[r["lo"]:r["lo"]
                                                    + r["rows"]]
                             .argmax(-1)).sum())
        n += r["rows"]
    return err, {k: v / max(n, 1) for k, v in agree.items()}


def percentile(vals, q):
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(q * len(vals)))]


def phase_predict_http():
    """The layer API behind the predict route: LeNet (bf16) and the MLP's
    int8 twin deployed on one ModelRegistry behind one ModelServer, each
    InferenceEngine warmed over the ladder 1..128; 16 client processes
    of 32 requests each (1-16 rows, alternating models), every answer
    held against the deployed model's own ``output()``; then a poison
    request among live traffic. Its own main path for the dequant count
    (0 just before the client traffic). Returns (the dequant kernel's
    launches in that traffic, the twin, the f32 MLP, its pool)."""
    import tempfile
    import threading
    import numpy as np
    from deeplearning4j_tpu_torch.common.environment import environment
    from deeplearning4j_tpu_torch.quant.transforms import \
        _fused_dequant_matmul
    from deeplearning4j_tpu_torch.serving import ModelRegistry, ModelServer
    from deeplearning4j_tpu_torch.zoo import LeNet
    lenet = LeNet(dtype="bfloat16").init_model()
    mlp = mlp_network()
    pools = predict_pools(mlp)
    env = environment()
    env.reset_compile_count()
    reg = ModelRegistry(manifest_dir=None)
    srv = ModelServer(reg, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{srv.start()}"
    rec = {"phase": "predict_http", "max_batch": PREDICT_MAX_BATCH,
           "max_delay_ms": PREDICT_DELAY_MS,
           "clients": PREDICT_CLIENTS, "requests_per_client":
           PREDICT_REQUESTS}
    kw = {"max_batch": PREDICT_MAX_BATCH, "max_delay_ms": PREDICT_DELAY_MS}
    tmp = tempfile.TemporaryDirectory()
    try:
        t0 = time.perf_counter()
        reg.deploy("lenet", "v1", lenet, example=pools["lenet"][:1], **kw)
        reg.deploy("mlp", "v1", mlp, quantize="int8",
                   calibration_batch=pools["mlp"][:PREDICT_MAX_BATCH],
                   example=pools["mlp"][:1], **kw)
        rec["deploy_s"] = time.perf_counter() - t0
        twin = reg.get("mlp").engine.model
        engines = {m: reg.get(m).engine for m in ("lenet", "mlp")}
        rec["ladder"] = list(engines["mlp"].ladder)
        rec["census_after_deploys"] = env.compile_count()
        rec["int8_gate"] = reg.get("mlp").divergence
        paths = {}
        for m, pool in pools.items():
            paths[m] = os.path.join(tmp.name, f"{m}.npy")
            np.save(paths[m], pool)
        rng = np.random.RandomState(41)
        jobs = []
        for c in range(PREDICT_CLIENTS):
            reqs = []
            for j in range(PREDICT_REQUESTS):
                rows = int(rng.randint(1, PREDICT_MAX_ROWS + 1))
                reqs.append({"model": ("lenet", "mlp")[(c + j) % 2],
                             "rows": rows,
                             "lo": int(rng.randint(0, POOL_ROWS - rows + 1))})
            jobs.append({"kind": "predict", "base": base, "pools": paths,
                         "requests": reqs})
        refs = {"lenet": pool_outputs(lenet, pools["lenet"]),
                "mlp": pool_outputs(twin, pools["mlp"])}
        ref_f32 = pool_outputs(mlp, pools["mlp"])
        s0 = {m: e.stats() for m, e in engines.items()}
        c0 = env.compile_count()
        # the main path: the dequant count starts at 0 here
        _fused_dequant_matmul.launches = 0
        start = time.time() + 4.0   # every client process is up by then
        for job in jobs:
            job["start_at"] = start
        outs = run_client_processes(jobs)
        launches = _fused_dequant_matmul.launches
        census_events = env.compile_count() - c0
        s1 = {m: e.stats() for m, e in engines.items()}
        results = [r for o in outs for r in o["results"]]
        requests = [r for job in jobs for r in job["requests"]]
        wall = max(r[3] for r in results) - min(r[2] for r in results)
        lat = [r[3] - r[2] for r in results]
        rows = sum(r["rows"] for r in requests)
        by_model = {}
        for m in ("lenet", "mlp"):
            idx = [i for i, r in enumerate(requests) if r["model"] == m]
            tops = (("twin", refs["mlp"]), ("f32", ref_f32)) \
                if m == "mlp" else ()
            err, top1 = check_predictions(
                [results[i] for i in idx], [requests[i] for i in idx],
                refs[m], LENET_PREDICT_ATOL if m == "lenet"
                else MLP_PREDICT_ATOL, tops)
            d = s1[m]["dispatches"] - s0[m]["dispatches"]
            real = s1[m]["rows_real"] - s0[m]["rows_real"]
            by_model[m] = {
                "requests": len(idx), "rows": real, "dispatches": d,
                "rows_per_dispatch": real / max(d, 1),
                "requests_per_dispatch": len(idx) / max(d, 1),
                "bucket_dispatches": {
                    b: n - s0[m]["bucket_dispatches"].get(b, 0)
                    for b, n in s1[m]["bucket_dispatches"].items()
                    if n - s0[m]["bucket_dispatches"].get(b, 0)},
                "max_abs_err_vs_output": err, **{
                    f"top1_vs_{k}": v for k, v in top1.items()}}
        twin_d = by_model["mlp"]["dispatches"]
        rec.update({
            "requests": len(results), "rows": rows, "wall_s": wall,
            "samples_per_s": rows / wall,
            "requests_per_s": len(results) / wall,
            "client_latency_s_p50": percentile(lat, 0.5),
            "client_latency_s_p99": percentile(lat, 0.99),
            "by_model": by_model,
            "census_events_after_warmup": census_events,
            "census_ladder_length": len(PREDICT_LADDER),
            "launches_predict_http": launches,
            "dequant_launches_per_twin_dispatch": launches / max(twin_d, 1)})
        # a poison request (511 features for the twin's 512) among live
        # requests from client threads
        live = [{"model": "mlp", "rows": 1 + i % PREDICT_MAX_ROWS,
                 "lo": 37 * i % (POOL_ROWS - PREDICT_MAX_ROWS)}
                for i in range(24)]
        live_res = [None] * len(live)
        poison = {}

        def client(k):
            for i in range(k, len(live), 4):
                r = live[i]
                live_res[i] = http_predict(
                    base, "mlp",
                    pools["mlp"][r["lo"]:r["lo"] + r["rows"]].tolist())
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.02)
        poison["res"] = http_predict(
            base, "mlp", pools["mlp"][:3, :MLP_IN - 1].tolist())
        for t in threads:
            t.join(120)
        if any(t.is_alive() for t in threads) or None in live_res:
            raise RuntimeError("the live requests beside the poison did "
                               "not all finish")
        check_predictions(live_res, live, refs["mlp"], MLP_PREDICT_ATOL)
        status, doc, _, _ = poison["res"]
        rec["poison"] = {"status": status, "trace_id": doc.get("trace_id"),
                         "quarantined": doc.get("quarantined"),
                         "live_requests_answered": len(live_res)}
        if status != 422 or not doc.get("trace_id") \
                or doc.get("quarantined") is not True:
            raise RuntimeError(f"the poison request got {status}: {doc}")
        # the host profile of a shorter window of the same traffic
        short = [dict(job, requests=job["requests"][:8]) for job in jobs[:8]]

        def profiled():
            for job in short:
                job["start_at"] = time.time() + 3.0
            return run_client_processes(short)
        _, HOST_PROFILES["predict_http"] = host_profile(profiled)
        rec["drained"] = reg.drain_all(save_manifests=False)
    finally:
        srv.stop()
        reg.drain_all(timeout_s=60, save_manifests=False)
        tmp.cleanup()
    emit(rec)
    if census_events != 0:
        raise RuntimeError(f"{census_events} new dispatch shapes after "
                           "warmup (the ladder was warmed)")
    if launches != 5 * twin_d or twin_d < 1:
        raise RuntimeError(f"the twin launched the dequant kernel "
                           f"{launches} times in {twin_d} dispatches, "
                           "want 5 each")
    if by_model["mlp"]["top1_vs_twin"] != 1.0 \
            or by_model["mlp"]["top1_vs_f32"] < MLP_MIN_TOP1:
        raise RuntimeError(f"the twin's answers disagree on top-1: "
                           f"{by_model['mlp']}")
    return launches, twin, mlp, pools["mlp"]


def drive_predicts(base, pool, requests, on_answer=None):
    """``requests`` ({"lo", "rows"}) to ``base``'s ``mlp`` from
    FLEET_CLIENTS client threads; ``on_answer(k)`` runs once the k-th
    answer is in. Returns (results in request order, wall seconds)."""
    import threading
    results = [None] * len(requests)
    lock = threading.Lock()
    nxt, done = [0], [0]

    def client():
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= len(requests):
                return
            r = requests[i]
            results[i] = http_predict(
                base, "mlp", pool[r["lo"]:r["lo"] + r["rows"]].tolist())
            with lock:
                done[0] += 1
                k = done[0]
            if on_answer is not None:
                on_answer(k)
    threads = [threading.Thread(target=client) for _ in range(FLEET_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a fleet client did not finish")
    return results, time.perf_counter() - t0


def phase_fleet(mlp, pool):
    """Two replicas of the MLP's int8 twin (each a ModelRegistry +
    ModelServer in this process, on this card) behind
    ``FleetServer(FleetRouter(...))``: 200 predicts through the front
    door, the second replica stopped once a third are answered, every
    answer held against the twin's own ``output()``; one replica alone
    first, with the same clients, for its samples/s."""
    import urllib.request
    import numpy as np
    from deeplearning4j_tpu_torch.common.metrics import registry
    from deeplearning4j_tpu_torch.common.tracing import tracer
    from deeplearning4j_tpu_torch.serving import ModelRegistry, ModelServer
    from deeplearning4j_tpu_torch.serving.fleet import (FleetRouter,
                                                        FleetServer)
    members = []
    rec = {"phase": "fleet", "replicas": 2, "requests": FLEET_REQUESTS,
           "clients": FLEET_CLIENTS}
    front = None
    try:
        for _ in range(2):
            reg = ModelRegistry(manifest_dir=None)
            reg.deploy("mlp", "v1", mlp, quantize="int8",
                       calibration_batch=pool[:PREDICT_MAX_BATCH],
                       example=pool[:1], max_batch=PREDICT_MAX_BATCH,
                       max_delay_ms=PREDICT_DELAY_MS)
            srv = ModelServer(reg, host="127.0.0.1", port=0)
            members.append((reg, srv, f"http://127.0.0.1:{srv.start()}"))
        urls = [m[2] for m in members]
        ref = pool_outputs(members[0][0].get("mlp").engine.model, pool)
        ref_f32 = pool_outputs(mlp, pool)
        rng = np.random.RandomState(43)
        reqs = []
        for _ in range(FLEET_REQUESTS):
            rows = int(rng.randint(1, PREDICT_MAX_ROWS + 1))
            reqs.append({"model": "mlp", "rows": rows,
                         "lo": int(rng.randint(0, POOL_ROWS - rows + 1))})
        rows = sum(r["rows"] for r in reqs)
        # one replica alone, the same clients
        res, wall = drive_predicts(urls[0], pool, reqs)
        check_predictions(res, reqs, ref, MLP_PREDICT_ATOL)
        rec["one_replica_samples_per_s"] = rows / wall
        router = FleetRouter(urls)
        front = FleetServer(router, host="127.0.0.1", port=0)
        fbase = f"http://127.0.0.1:{front.start()}"
        router.poll_once()
        reg_m = registry()
        ej = reg_m.counter("dl4j_fleet_ejections_total",
                           labels=("replica", "reason"))
        ej0 = sum(c.value() for _, c in ej.children())
        stopped = {}

        def stop_second(k):
            if k == FLEET_REQUESTS // 3 and not stopped:
                stopped["at"] = k
                members[1][1].stop()
        t_win = time.perf_counter() * 1e6
        res, wall = drive_predicts(fbase, pool, reqs, stop_second)
        err, top1 = check_predictions(res, reqs, ref, MLP_PREDICT_ATOL,
                                      (("twin", ref), ("f32", ref_f32)))
        attempts = {}
        for e in tracer().events():
            if e["name"] == "fleet/attempt" and e["ts"] >= t_win:
                k = e.get("args", {}).get("kind", "")
                attempts[k] = attempts.get(k, 0) + 1
        served = {}
        for status, doc, _, _ in res:
            served[status] = served.get(status, 0) + 1
        router.poll_once()
        with urllib.request.urlopen(fbase + "/metrics.json",
                                    timeout=60) as r:
            doc = json.loads(r.read())
        # the replicas share this process's registry, so the front door's
        # own family of that name comes first; the aggregator appends, per
        # label set, one series per replica and then the merged one
        series = doc.get("dl4j_serving_requests_total", {}).get("series", [])
        per_rep, merged = {}, {}
        for sr in series:
            labels = dict(sr["labels"])
            rep = labels.pop("replica", None)
            key = json.dumps(labels, sort_keys=True)
            if rep is None:
                merged[key] = sr["value"]
            else:
                per_rep.setdefault(key, {})[rep] = sr["value"]
        merged_ok = bool(per_rep) and all(
            set(v) == set(urls) and abs(merged.get(k, -1) - sum(v.values()))
            < 1e-6 for k, v in per_rep.items())
        rec.update({
            "fleet_samples_per_s": rows / wall,
            "fleet_over_one_replica":
                rows / wall / rec["one_replica_samples_per_s"],
            "stopped_replica_after_answers": stopped.get("at"),
            "statuses": served, "attempts_by_kind": attempts,
            "failovers": sum(
                c.value() for k, c in reg_m.counter(
                    "dl4j_router_dispatch_total",
                    labels=("replica", "outcome")).children()
                if k[1] == "failover"),
            "ejections": sum(c.value() for _, c in ej.children()) - ej0,
            "max_abs_err_vs_output": err,
            **{f"top1_vs_{k}": v for k, v in top1.items()},
            "metrics_replica_series": sorted({r for v in per_rep.values()
                                              for r in v}),
            "metrics_merged_equals_sum": merged_ok})
    finally:
        if front is not None:
            front.stop()
        for reg, srv, _ in members:
            srv.stop()
            reg.drain_all(timeout_s=60, save_manifests=False)
    emit(rec)
    if not stopped or served != {200: FLEET_REQUESTS}:
        raise RuntimeError(f"the fleet did not answer every request with a "
                           f"replica stopped: {served}, {stopped}")
    if not merged_ok:
        raise RuntimeError("the front door's /metrics does not merge both "
                           "replicas' dl4j_serving_requests_total")
    if top1["twin"] != 1.0 or top1["f32"] < MLP_MIN_TOP1:
        raise RuntimeError(f"the fleet's answers disagree on top-1: {top1}")


#: substrings of a device kernel's name -> its group in a step's breakdown
#: (the first group that matches; cuDNN's and CUTLASS's convolution
#: kernels, with the layout transposes cuDNN adds around NCHW)
KERNEL_GROUPS = (
    ("convolution", ("conv", "cudnn", "implicit", "wgrad", "dgrad",
                     "xmma", "sm90", "cutlass", "nchw", "nhwc", "fprop")),
    ("gemm", ("gemm", "cublas")),
    ("reduction", ("reduce_kernel",)),
    ("copy_cast", ("copy",)),
    ("elementwise", ("elementwise",)))


# the SameDiff BERT step's kernel classes (no convolutions; cuBLAS's f32
# GEMMs carry sm90 / xmma / cutlass names)
SD_KERNEL_GROUPS = (
    ("gemm", ("gemm", "cublas", "cutlass", "xmma", "sm90")),
    ("softmax", ("softmax",)),
    ("reduction", ("reduce",)),
    ("index", ("index", "gather", "scatter", "embedding")),
    ("copy_cast", ("copy",)),
    ("elementwise", ("elementwise",)))


def kernel_group(name, groups=KERNEL_GROUPS):
    low = name.lower()
    for group, keys in groups:
        if any(k in low for k in keys):
            return group
    return "other"


def phase_resnet50():
    """ResNet-50 training through ``ComputationGraph.fit`` at BASELINE
    config 2's width (bf16 body, Nesterovs(0.1, 0.9), B=128): RESNET_EPOCHS
    epochs over RESNET_BATCHES device-staged batches with a loss a step,
    one more epoch timed (host clock), one under the profiler (device ms a
    step by kernel, busy share); then an f32 copy of the trained weights:
    its ``output()`` and pooled features on the card against the CPU's
    with TF32 switched on in the process (``RESNET_F32_ATOL``,
    ``RESNET_F32_FEATURE_RTOL``). Returns the trained network, the first
    batch's images and the phase's record."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.learning import tree_map
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.listeners import CollectScoresListener
    from deeplearning4j_tpu_torch.quant.transforms import \
        _fused_dequant_matmul
    from deeplearning4j_tpu_torch.zoo import ResNet50
    zoo = ResNet50(num_classes=RESNET_CLASSES, input_shape=RESNET_SHAPE,
                   dtype="bfloat16")
    net = zoo.init_model()
    batches = zoo_batches(np.random.RandomState(0), RESNET_BATCHES,
                          RESNET_B, RESNET_SHAPE, RESNET_CLASSES)
    n0 = _fused_dequant_matmul.launches
    scores = CollectScoresListener()
    net.set_listeners(scores)
    epoch_s = []
    for _ in range(RESNET_EPOCHS):   # the first includes cuDNN's choice
        t0 = time.perf_counter()
        net.fit(batches, num_epochs=1)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
    net.set_listeners()
    # one epoch on the staged path (no listener: the losses stay on the
    # card until it ends), the steady state, after one that captures it
    net.fit(batches, num_epochs=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(batches, num_epochs=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = wall * 1e3 / RESNET_BATCHES
    by_name = {k: v / RESNET_BATCHES for k, v in device_ms_by_kernel(
        lambda: net.fit(batches, num_epochs=1), 1).items()}
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    groups = {}
    for k, v in by_name.items():
        g = kernel_group(k)
        groups[g] = groups.get(g, 0.0) + v
    # an f32 copy of the trained weights on the card and on the CPU
    conf = ResNet50(num_classes=RESNET_CLASSES,
                    input_shape=RESNET_SHAPE).build_conf()
    params = tree_map(torch.clone, net._params)
    f32 = ComputationGraph(conf, device="cuda").init(params=params)
    cpu = ComputationGraph(conf, device="cpu").init(
        params=tree_map(lambda v: v.cpu(), params))
    x = batches[0].features.torch()[:2]
    ref = cpu.output(x.cpu())[0].numpy()
    ref_feat = cpu.feed_forward(x.cpu())["avgpool"].numpy()
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = f32.output(x)[0].numpy()
        feat = f32.feed_forward(x)["avgpool"].numpy()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    err = float(np.abs(got - ref).max())
    feat_err = float(np.abs(feat - ref_feat).max()
                     / max(float(np.abs(ref_feat).max()), 1e-30))
    losses = [float(v) for v in scores.scores]
    rec = {"phase": "resnet50", "B": RESNET_B, "batches": RESNET_BATCHES,
           "epochs": RESNET_EPOCHS, "dtype": "bfloat16",
           "updater": "Nesterovs(0.1, 0.9)",
           "params": net.num_params(), "epoch_s": epoch_s,
           "loss_per_step": losses, "wall_s_timed_epoch": wall,
           "step_ms": step_ms,
           "samples_per_s": RESNET_BATCHES * RESNET_B / wall,
           "loss_after_timed_epoch": net.score_value,
           "device_ms_per_step": device_ms,
           "device_busy_share": device_ms / step_ms,
           "ms_per_step_by_group": groups, "kernels_seen": len(by_name),
           "top_kernels_ms_per_step": [[k[:80], v] for k, v in top],
           "max_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "dequant_launches": _fused_dequant_matmul.launches - n0,
           "f32_output_vs_cpu_max_abs_err": err,
           "f32_output_vs_cpu_tol": RESNET_F32_ATOL,
           "f32_output_top1_agree_cpu": float(
               (got.argmax(-1) == ref.argmax(-1)).mean()),
           "f32_output_saturated_rows": int(
               (ref.max(-1) > SATURATED_P).sum()),
           "f32_head_input_vs_cpu_rel_err": feat_err,
           "f32_head_input_vs_cpu_rtol": RESNET_F32_FEATURE_RTOL,
           "f32_head_input_max_abs": float(np.abs(ref_feat).max())}
    emit(rec)
    if not (len(losses) == RESNET_EPOCHS * RESNET_BATCHES
            and np.isfinite(losses).all() and len(set(losses)) > 1
            and np.isfinite(net.score_value)):
        raise RuntimeError(f"ResNet-50 losses not finite and changing: "
                           f"{losses}, then {net.score_value}")
    if not (err <= RESNET_F32_ATOL
            and feat_err <= RESNET_F32_FEATURE_RTOL):
        raise RuntimeError(f"f32 ResNet-50 on the card differs from the "
                           f"CPU's: output by {err} (tol {RESNET_F32_ATOL}),"
                           f" pooled features by {feat_err} of their "
                           f"largest (tol {RESNET_F32_FEATURE_RTOL})")
    del f32, cpu, params
    # the phases after only save, load and predict with the trained
    # network: its captured training steps and their pool (the step's
    # activations) go now
    net._train_graphs().release()
    torch.cuda.empty_cache()
    return net, batches[0].features.torch(), rec


# the transfer phase: BASELINE config 2's network fine-tuned as DL4J users
# run it after training: saved, restored, its body frozen up to the pooled
# features, its 1000-way head replaced by a 10-way one, then fit with early
# stopping and checkpoints. TRANSFER_BATCHES training and TRANSFER_SCORE
# scoring batches of RESNET_B synthetic images (BenchmarkDataSetIterator,
# seeds 42 and 43) through a NormalizerStandardize fitted on the training
# set; Adam(TRANSFER_LR) on the head; at most TRANSFER_EPOCHS epochs,
# stopping after one without improvement; CheckpointListener keeping
# TRANSFER_KEEP zips
TRANSFER_CLASSES, TRANSFER_BATCHES, TRANSFER_SCORE = 10, 4, 2
TRANSFER_LR, TRANSFER_EPOCHS, TRANSFER_KEEP = 1e-3, 3, 2
# the trained network's batch-norm running statistics lag its weights
# (resnet50's pooled features reach ~6e7 at inference), so a body frozen
# as it is gives one-hot softmax rows and a head gradient of exactly 0:
# NoOp-updater steps over the training batches first refresh the running
# statistics (decay 0.9: within 0.9**20 = 12 % of the batch's) and leave
# every weight as it was
TRANSFER_RECALIBRATE = 20
# the spans the phase prints from its exported chrome trace
TRANSFER_TOP_SPANS = 10


def normalized(iterator, normalizer):
    """``iterator``'s DataSets through ``normalizer.transform``."""
    from deeplearning4j_tpu_torch.datasets import DataSetIterator

    class Normalized(DataSetIterator):
        def has_next(self):
            return iterator.has_next()

        def next(self):
            return normalizer.transform(iterator.next())

        def reset(self):
            iterator.reset()

        def batch(self):
            return iterator.batch()
    return Normalized()


def phase_transfer(net, images, full):
    """The slice's main path on ``phase_resnet50``'s trained network
    (BASELINE config 2's width, bf16 body, B=128):

    1. ``net.save(zip, save_updater=True)`` and ``ComputationGraph.load(zip,
       load_updater=True)`` on the card: the restored ``output()`` on the
       first batch, its params, updater leaves, iteration and epoch must
       equal the network's bit for bit, and ``restore_model(zip)`` and
       ``ResNet50(...).init_pretrained(path=zip)`` must give the same
       output; the file's MB and the save and load seconds are printed;
    2. the restored network's running statistics refreshed
       (TRANSFER_RECALIBRATE steps under ``NoOp``), then
       ``TransferLearning.GraphBuilder`` with Adam(TRANSFER_LR),
       ``set_feature_extractor("avgpool")``, ``n_out_replace("output",
       10)``;
    3. ``EarlyStoppingTrainer.fit`` (the data, termination, scoring and
       savers above): every frozen parameter and batch-norm running
       statistic must be bit-identical after it, the head's params must
       have changed, the losses be finite, the best model read back from
       disk must give the output of the in-memory copy taken when it was
       saved, and exactly TRANSFER_KEEP checkpoint zips must remain;
    4. a ``ShardedCheckpointer`` (keep 2) over 3 saves: the retained
       steps, and the restored graph's ``output()`` equal to the
       fine-tuned graph's;
    5. a fine-tune step's host and device ms by kernel class, busy share
       and peak memory beside ``full``'s (the whole network's step);
    6. the phase's spans exported with ``tracing.export`` into the build
       directory and read back with ``profile_analyzer.aggregate``."""
    import copy
    import shutil
    import tempfile
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.common import profile_analyzer, tracing
    from deeplearning4j_tpu_torch.datasets import (BenchmarkDataSetIterator,
                                                   DataSet,
                                                   NormalizerStandardize)
    from deeplearning4j_tpu_torch.kernels._build import BUILD_DIR
    from deeplearning4j_tpu_torch.learning import Adam, NoOp
    from deeplearning4j_tpu_torch.nn.checkpoint import ShardedCheckpointer
    from deeplearning4j_tpu_torch.nn.earlystopping import (
        DataSetLossCalculator, EarlyStoppingConfiguration,
        EarlyStoppingTrainer, LocalFileModelSaver,
        MaxEpochsTerminationCondition,
        ScoreImprovementEpochTerminationCondition)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.listeners import (CheckpointListener,
                                                       CollectScoresListener)
    from deeplearning4j_tpu_torch.nn.serde import _leaves, restore_model
    from deeplearning4j_tpu_torch.nn.transferlearning import (
        FineTuneConfiguration, TransferLearning)
    from deeplearning4j_tpu_torch.zoo import ResNet50
    t_phase = time.perf_counter()
    tracing.tracer().clear()
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="transfer-")
    rec = {"phase": "transfer", "B": RESNET_B, "classes": TRANSFER_CLASSES}

    def same(a, b):
        return len(a) == len(b) and all(torch.equal(x, y)
                                        for x, y in zip(a, b))
    try:
        # 1. the serde round trip on the card
        zpath = os.path.join(tmp, "resnet50.zip")
        with tracing.span("transfer/save"):
            t0 = time.perf_counter()
            net.save(zpath, save_updater=True)
            rec["save_s"] = time.perf_counter() - t0
        rec["zip_mb"] = os.path.getsize(zpath) / 1e6
        with tracing.span("transfer/load"):
            t0 = time.perf_counter()
            restored = ComputationGraph.load(zpath, load_updater=True)
            torch.cuda.synchronize()
            rec["load_s"] = time.perf_counter() - t0
        want = net.output(images)[0].torch()
        got = restored.output(images)[0].torch()
        by_model = restore_model(zpath).output(images)[0].torch()
        by_zoo = ResNet50(num_classes=RESNET_CLASSES,
                          input_shape=RESNET_SHAPE,
                          dtype="bfloat16").init_pretrained(
            path=zpath).output(images)[0].torch()
        rec["restore"] = {
            "output_same_bits": torch.equal(want, got),
            "updater_same_bits": same(_leaves(net._updater_state),
                                      _leaves(restored._updater_state)),
            "params_same_bits": same(_leaves(net._params),
                                     _leaves(restored._params)),
            "iteration_epoch": [restored._iteration, restored._epoch],
            "want_iteration_epoch": [net._iteration, net._epoch],
            "restore_model_same_bits": torch.equal(want, by_model),
            "init_pretrained_same_bits": torch.equal(want, by_zoo)}
        del by_model, by_zoo
        # 2. refresh the running statistics, freeze the body, replace the
        # head
        train = BenchmarkDataSetIterator(
            (RESNET_B,) + RESNET_SHAPE, TRANSFER_CLASSES, TRANSFER_BATCHES,
            seed=42)
        scoring = BenchmarkDataSetIterator(
            (RESNET_B,) + RESNET_SHAPE, TRANSFER_CLASSES, TRANSFER_SCORE,
            seed=43)
        t0 = time.perf_counter()
        norm = NormalizerStandardize().fit(train)
        rec["normalizer_fit_s"] = time.perf_counter() - t0
        staged = [norm.transform(train.next())
                  for _ in range(TRANSFER_BATCHES)]
        train.reset()
        conf = copy.deepcopy(restored.conf)
        conf.updater = NoOp()
        body = ComputationGraph(conf).init(params=restored._params)
        t0 = time.perf_counter()
        x0 = staged[0].features
        body.fit(DataSet(x0, x0.torch().new_zeros(
            (RESNET_B, RESNET_CLASSES))), num_epochs=TRANSFER_RECALIBRATE)
        torch.cuda.synchronize()
        rec["recalibrate_s"] = time.perf_counter() - t0
        body._train_graphs().release()   # its steps are done
        rec["recalibrated_weights_same_bits"] = all(
            torch.equal(v, restored._params[n][k])
            for n, p in body._params.items() for k, v in p.items()
            if not k.startswith("state_"))
        rec["pooled_features_max_abs"] = {
            "trained": float(restored.feed_forward(
                staged[0].features)["avgpool"].torch().abs().max()),
            "recalibrated": float(body.feed_forward(
                staged[0].features)["avgpool"].torch().abs().max())}
        tl = TransferLearning.GraphBuilder(body) \
            .fine_tune_configuration(FineTuneConfiguration(
                updater=Adam(TRANSFER_LR))) \
            .set_feature_extractor("avgpool") \
            .n_out_replace("output", TRANSFER_CLASSES).build()
        frozen = {n: {k: v.clone() for k, v in p.items()}
                  for n, p in tl._params.items()
                  if any(k.startswith("state_frozen__") for k in p)}
        head0 = {k: v.clone() for k, v in tl._params["output"].items()}
        rec["frozen_vertices"] = len(frozen)
        rec["trainable_params"] = tl.num_params()
        # 3. early stopping with checkpoints
        kept = {}

        class Saver(LocalFileModelSaver):
            """The file saver, also keeping the in-memory copy it wrote,
            to hold the copy read back from disk against."""

            def save_best_model(self, model, score):
                super().save_best_model(model, score)
                kept["best"] = model.clone()
        ckdir = os.path.join(tmp, "checkpoints")
        scores = CollectScoresListener()
        tl.set_listeners(scores, CheckpointListener(
            ckdir, save_every_n_epochs=1, keep_last=TRANSFER_KEEP))
        cfg = EarlyStoppingConfiguration.builder() \
            .score_calculator(DataSetLossCalculator(
                normalized(scoring, norm))) \
            .epoch_termination_conditions(
                MaxEpochsTerminationCondition(TRANSFER_EPOCHS),
                ScoreImprovementEpochTerminationCondition(1)) \
            .model_saver(Saver(os.path.join(tmp, "earlystopping"))).build()
        with tracing.span("transfer/early_stopping"):
            t0 = time.perf_counter()
            result = EarlyStoppingTrainer(cfg, tl).fit(
                normalized(train, norm))
            torch.cuda.synchronize()
            rec["early_stopping_s"] = time.perf_counter() - t0
        tl.set_listeners()
        x = norm.transform_array(images)
        best = result.get_best_model()
        frozen_same = all(torch.equal(v, tl._params[n][k])
                          for n, p in frozen.items() for k, v in p.items())
        stats_same = all(torch.equal(v, tl._params[n][k])
                         for n, p in frozen.items() for k, v in p.items()
                         if k.startswith("state_frozen__state_"))
        left = sorted(os.listdir(ckdir))
        losses = [float(v) for v in scores.scores]
        rec["early_stopping"] = {
            "termination_reason": result.termination_reason,
            "termination_details": result.termination_details,
            "best_model_epoch": result.best_model_epoch,
            "best_model_score": result.best_model_score,
            "total_epochs": result.total_epochs, "losses": losses,
            "frozen_params_same_bits": frozen_same,
            "frozen_bn_stats_same_bits": stats_same,
            "frozen_bn_stats": sum(
                1 for p in frozen.values() for k in p
                if k.startswith("state_frozen__state_")),
            "head_changed": any(not torch.equal(v, tl._params["output"][k])
                                for k, v in head0.items()),
            "best_from_disk_same_output_bits": torch.equal(
                best.output(x)[0].torch(),
                kept["best"].output(x)[0].torch()),
            "checkpoints_left": left}
        del best, kept["best"]
        # 4. the step checkpointer: 3 saves, 2 kept, a bit-exact restore
        ck = ShardedCheckpointer(os.path.join(tmp, "sharded"), keep_last=2)
        with tracing.span("transfer/sharded_checkpoint"):
            t0 = time.perf_counter()
            for step in (1, 2, 3):
                ck.save(step, tl)
            rec["sharded_save_s"] = (time.perf_counter() - t0) / 3
        fresh = TransferLearning.GraphBuilder(body) \
            .set_feature_extractor("avgpool") \
            .n_out_replace("output", TRANSFER_CLASSES).build()
        ck.restore(fresh)
        ck.close()
        rec["sharded"] = {
            "steps": ck.all_steps(),
            "output_same_bits": torch.equal(fresh.output(x)[0].torch(),
                                            tl.output(x)[0].torch()),
            "iteration_epoch": [fresh._iteration, fresh._epoch],
            "want_iteration_epoch": [tl._iteration, tl._epoch]}
        del fresh
        # 5. a fine-tune step on the staged path, beside the full step
        tl.fit(staged, num_epochs=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tl.fit(staged, num_epochs=1)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / TRANSFER_BATCHES
        by_name = {k: v / TRANSFER_BATCHES for k, v in device_ms_by_kernel(
            lambda: tl.fit(staged, num_epochs=1), 1).items()}
        device_ms = sum(by_name.values())
        groups = {}
        for k, v in by_name.items():
            g = kernel_group(k)
            groups[g] = groups.get(g, 0.0) + v
        rec["step"] = {
            "host_ms": step_ms, "samples_per_s": RESNET_B * 1e3 / step_ms,
            "device_ms": device_ms, "busy_share": device_ms / step_ms,
            "ms_by_group": groups,
            "full_step_host_ms": full["step_ms"],
            "full_step_device_ms": full["device_ms_per_step"],
            "full_ms_by_group": full["ms_per_step_by_group"],
            "device_vs_full": device_ms / full["device_ms_per_step"]}
        rec["max_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        # 6. the phase's spans, exported and read back
        trace = str(BUILD_DIR / "transfer_spans.json")
        rec["spans_exported"] = tracing.export(trace)
        agg = profile_analyzer.aggregate(profile_analyzer.load_trace(trace))
        rec["top_spans_ms"] = [
            [name, t["count"], t["total_us"] / 1e3] for name, t in sorted(
                agg.items(), key=lambda kv: -kv[1]["total_us"])
        ][:TRANSFER_TOP_SPANS]
        rec["seconds"] = time.perf_counter() - t_phase
        emit(rec)
        r, es, sh = rec["restore"], rec["early_stopping"], rec["sharded"]
        if not (r["output_same_bits"] and r["updater_same_bits"]
                and r["params_same_bits"]
                and rec["recalibrated_weights_same_bits"]
                and r["iteration_epoch"] == r["want_iteration_epoch"]
                and r["restore_model_same_bits"]
                and r["init_pretrained_same_bits"]):
            raise RuntimeError(f"the restored network differs: {r}")
        if not (es["frozen_params_same_bits"] and es["frozen_bn_stats"] > 0
                and es["frozen_bn_stats_same_bits"] and es["head_changed"]
                and losses and np.isfinite(losses).all()
                and np.isfinite(es["best_model_score"])
                and es["best_from_disk_same_output_bits"]
                and len(left) == TRANSFER_KEEP):
            raise RuntimeError(f"the fine-tune failed its checks: {es}")
        if not (sh["steps"] == [2, 3] and sh["output_same_bits"]
                and sh["iteration_epoch"] == sh["want_iteration_epoch"]):
            raise RuntimeError(f"the step checkpointer: {sh}")
        if not (np.isfinite(device_ms) and device_ms > 0):
            raise RuntimeError(f"the fine-tune step: {rec['step']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()


def resnet_check(results, requests, pool_refs, atol):
    """Each predict answer (status, doc) against the twin's own
    ``output()`` on the request's images: status 200, one output of
    [rows, 1000], finite, within ``atol``. Returns (max abs err, top-1
    agreement with those outputs)."""
    import numpy as np
    err, agree, n = 0.0, 0, 0
    for i, ((status, doc, _, _), r) in enumerate(zip(results, requests)):
        want = pool_refs[r["lo"]:r["lo"] + r["rows"]]
        outs = doc.get("outputs") or [[]]
        got = np.asarray(outs[0], np.float32)
        if status != 200 or len(outs) != 1 or got.shape != want.shape \
                or not np.isfinite(got).all():
            raise RuntimeError(f"resnet predict {i}: status {status}, "
                               f"shape {got.shape}: {str(doc)[:300]}")
        e = float(np.abs(got - want).max())
        if e > atol:
            raise RuntimeError(f"resnet predict {i}: max abs err {e} > "
                               f"{atol} against the twin's output()")
        err = max(err, e)
        agree += int((got.argmax(-1) == want.argmax(-1)).sum())
        n += r["rows"]
    return err, agree / max(n, 1)


def phase_resnet50_int8(net, images):
    """The trained ResNet-50's int8 twin (``quantize_model``: 4-D
    convolution weights dequantized at use, the 2048->1000 head through
    the dequant kernel's f32 route): ``output()`` at every rung of the
    ladder 1..128 (one kernel launch an output()), top-1 agreement with
    the bf16 network, ``divergence_report``, ``InferenceEngine.infer``
    timed at each rung; then deployed in a ModelRegistry (max_batch 16)
    behind a ModelServer and served 64 ``POST /predict`` of 1-4 images
    from 4 client processes, each answer held against the twin's own
    ``output()``. Its own main path: the dequant count set to 0 just
    before the client traffic. Returns (those launches, the twin)."""
    import tempfile
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.common.environment import environment
    from deeplearning4j_tpu_torch.quant import (divergence_report,
                                                param_bytes_of,
                                                quantize_model)
    from deeplearning4j_tpu_torch.quant.transforms import (
        _fused_dequant_matmul, dequantize)
    from deeplearning4j_tpu_torch.runtime.inference import InferenceEngine
    from deeplearning4j_tpu_torch.serving import ModelRegistry, ModelServer
    twin = quantize_model(net, device="cuda")
    env = environment()
    rec = {"phase": "resnet50_int8", "twin_conf_dtype": twin.conf.dtype,
           "precision": twin._precision,
           "param_bytes_bf16_net": param_bytes_of(net),
           "param_bytes_int8": param_bytes_of(twin)}

    def host_ms(fn, reps=5):
        """Median host ms of ``fn()`` followed by a synchronise."""
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return sorted(ts)[reps // 2]

    xb = images[:PREDICT_LADDER[-1]]
    rungs = {}
    for M in PREDICT_LADDER:
        n0 = _fused_dequant_matmul.launches
        out = twin.output(xb[:M])
        launches = _fused_dequant_matmul.launches - n0
        if launches != 1 or out[0].shape != (M, RESNET_CLASSES) \
                or not torch.isfinite(out[0].torch()).all():
            raise RuntimeError(f"twin output() at M={M}: {launches} dequant "
                               f"launches (want 1), shape {out[0].shape}")
        rungs[M] = {"dequant_launches": launches,
                    "output_host_ms": host_ms(lambda: twin.output(xb[:M]))}
    eng = InferenceEngine(twin, max_batch=PREDICT_LADDER[-1])
    for M in PREDICT_LADDER:
        rungs[M]["engine_infer_host_ms"] = host_ms(
            lambda: eng.infer(xb[:M]))
    eng.close()
    q_out = twin.output(xb)[0].numpy()
    f_out = net.output(xb)[0].numpy()
    rep = divergence_report(net, twin, xb)
    # the head's input, where one-hot softmax rows do not hide the twin's
    # int8 error (see RESNET_F32_FEATURE_RTOL)
    q_feat = twin.feed_forward(xb[:16])["avgpool"].numpy()
    f_feat = net.feed_forward(xb[:16])["avgpool"].numpy()
    # per-dispatch host work beside the kernels: the bf16 network casts
    # every floating param of its body to bf16 in each forward, and the
    # twin dequantizes each 4-D weight at use
    cast_ms = host_ms(lambda: [net._cast_layer_params(p, torch.bfloat16)
                               for n, p in net._params.items()
                               if n not in net.conf.outputs])
    convs = [p["W"] for p in twin._params.values()
             if "W" in p and getattr(p["W"], "q", None) is not None
             and p["W"].q.dim() == 4]
    deq_ms = host_ms(lambda: [dequantize(w, torch.bfloat16) for w in convs])
    rec.update({
        "rungs": rungs, "top1_agreement_vs_bf16":
            float((q_out.argmax(-1) == f_out.argmax(-1)).mean()),
        "max_abs_err_vs_bf16": float(np.abs(q_out - f_out).max()),
        "saturated_rows_bf16": int((f_out.max(-1) > SATURATED_P).sum()),
        "head_input_vs_bf16_rel_err": float(
            np.abs(q_feat - f_feat).max() / max(float(np.abs(f_feat).max()),
                                                1e-30)),
        "divergence_report": rep,
        "bf16_output_host_ms_B1": host_ms(lambda: net.output(xb[:1])),
        "bf16_param_casts_host_ms": cast_ms,
        "param_leaves_cast": sum(
            1 for n, p in net._params.items() if n not in net.conf.outputs
            for k in p if not k.startswith("state_")),
        "twin_conv_dequantize_host_ms": deq_ms,
        "twin_conv_weights_dequantized": len(convs)})
    # the predict route
    rng = np.random.RandomState(51)
    pool = rng.randn(RESNET_POOL_ROWS, *RESNET_SHAPE).astype(np.float32)
    refs = np.concatenate([twin.output(pool[i:i + RESNET_PREDICT_MAX_BATCH])
                           [0].numpy() for i in range(
                               0, RESNET_POOL_ROWS, RESNET_PREDICT_MAX_BATCH)])
    env.reset_compile_count()
    reg = ModelRegistry(manifest_dir=None)
    srv = ModelServer(reg, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{srv.start()}"
    tmp = tempfile.TemporaryDirectory()
    try:
        t0 = time.perf_counter()
        reg.deploy("resnet", "v1", twin, example=pool[:1],
                   max_batch=RESNET_PREDICT_MAX_BATCH,
                   max_delay_ms=PREDICT_DELAY_MS)
        rec["deploy_s"] = time.perf_counter() - t0
        engine = reg.get("resnet").engine
        rec["ladder"] = list(engine.ladder)
        path = os.path.join(tmp.name, "resnet.npy")
        np.save(path, pool)
        jobs = []
        for c in range(RESNET_CLIENTS):
            reqs = []
            for _ in range(RESNET_REQUESTS):
                rows = int(rng.randint(1, RESNET_MAX_ROWS + 1))
                reqs.append({"model": "resnet", "rows": rows,
                             "lo": int(rng.randint(
                                 0, RESNET_POOL_ROWS - rows + 1))})
            jobs.append({"kind": "predict", "base": base,
                         "pools": {"resnet": path}, "requests": reqs})
        s0 = engine.stats()
        c0 = env.compile_count()
        # the main path: the dequant count starts at 0 here
        _fused_dequant_matmul.launches = 0
        start = time.time() + 4.0   # every client process is up by then
        for job in jobs:
            job["start_at"] = start
        outs = run_client_processes(jobs)
        launches = _fused_dequant_matmul.launches
        census = env.compile_count() - c0
        s1 = engine.stats()
        results = [r for o in outs for r in o["results"]]
        requests = [r for job in jobs for r in job["requests"]]
        err, top1 = resnet_check(results, requests, refs,
                                 RESNET_PREDICT_ATOL)
        wall = max(r[3] for r in results) - min(r[2] for r in results)
        lat = [r[3] - r[2] for r in results]
        rows = sum(r["rows"] for r in requests)
        d = s1["dispatches"] - s0["dispatches"]
        rec.update({
            "requests": len(results), "rows": rows, "wall_s": wall,
            "samples_per_s": rows / wall,
            "client_latency_s_p50": percentile(lat, 0.5),
            "client_latency_s_p99": percentile(lat, 0.99),
            "dispatches": d,
            "rows_per_dispatch": (s1["rows_real"] - s0["rows_real"])
            / max(d, 1),
            "census_events_after_warmup": census,
            "launches_resnet50_int8": launches,
            "max_abs_err_vs_output": err, "top1_vs_output": top1,
            "request_json_mb_per_image": len(json.dumps(
                pool[:1].tolist())) / 1e6,
            "paced_by": "JSON: each 3x224x224 image is ~150k floats, "
                        "parsed by the server's one interpreter"})
        rec["drained"] = reg.drain_all(save_manifests=False)
    finally:
        srv.stop()
        reg.drain_all(timeout_s=60, save_manifests=False)
        tmp.cleanup()
    emit(rec)
    if census != 0:
        raise RuntimeError(f"{census} new dispatch shapes after warmup")
    if launches != d or d < 1:
        raise RuntimeError(f"the twin launched the dequant kernel "
                           f"{launches} times in {d} dispatches, want 1 "
                           "each")
    return launches, twin


def resnet_head_rows(twin, launches, errs):
    """The dequant kernel at ResNet-50's head, (M, 2048, 1000) f32 as the
    twin's output vertex runs it, for M in RESNET_ROW_MS, beside its plain
    version, ``torch.matmul`` on an f32 copy of the weight under
    ``full_f32()`` and the bound; the L2 flushed before each call (a
    forward streams ~50 MB of convolution weights and activations between
    two uses of the head), and also warm; ``launches`` are those of
    ``resnet50_int8``'s client traffic."""
    import torch
    from deeplearning4j_tpu_torch.nn.fit_fastpath import full_f32
    from deeplearning4j_tpu_torch.quant.transforms import (
        _fused_dequant_matmul, dequant_matmul_plain, dequantize)
    w = twin._params["output"]["W"]
    K, N = RESNET_HEAD
    if tuple(w.q.shape) != (K, N):
        raise RuntimeError(f"the twin's head is {tuple(w.q.shape)}")
    scale = w.scale.reshape(-1)
    wd = dequantize(w, torch.float32)
    flush = l2_flusher()
    g = torch.Generator(device="cuda").manual_seed(19)
    rows = []
    for M in RESNET_ROW_MS:
        x = torch.randn((M, K), generator=g, device="cuda")
        byt = M * K * 4 + K * N + N * 4 + M * N * 4
        b_ms, b_by = bound_ms(byt, 2 * M * K * N, F32_FLOPS_PER_S)

        def lib():
            with full_f32():
                torch.matmul(x, wd)
        rec = {"name": "dequant_matmul", "route": "cuda",
               "source": "deeplearning4j_tpu_torch/kernels/csrc/"
                         "dequant_matmul.cu",
               "replaces": "deeplearning4j_tpu/quant/transforms.py:216",
               "main_path": "resnet50_int8", "M": M, "K": K, "N": N,
               "dtype": "float32", "launches": launches,
               "max_abs_err": errs["dequant_mlp"][(M, K, N, "float32")],
               "plain_ms": time_ms(lambda: dequant_matmul_plain(x, w.q,
                                                                scale),
                                   flush=flush),
               "ms_warm": time_ms(lambda: _fused_dequant_matmul(x, w.q,
                                                                scale)),
               "library_ms_warm": time_ms(lib),
               "bound_ms": b_ms, "bound_by": b_by, "windows": WINDOWS,
               "l2": "flushed before each call (ms, library_ms, plain_ms)"}
        timed(rec, "ms", lambda: _fused_dequant_matmul(x, w.q, scale),
              flush=flush)
        timed(rec, "library_ms", lib, flush=flush)
        rows.append(rec)
    return rows


SD_FEATURES = ("input_ids", "token_type_ids", "attention_mask")
SD_LABELS = ("start_positions", "end_positions")


def phase_samediff_bert():
    """A SameDiff BERT-base SQuAD fine-tune (BASELINE config 3) on the
    card: the QA graph at ``BertConfig.base()`` width, T=384, f32, random
    weights from a seed (``samediff_qa_graph``); ``fit`` over SD_BATCHES
    device-staged MultiDataSets of B=32 under ``Adam(5e-5)``, one warm
    epoch, SD_EPOCHS timed (host clock), one under the profiler (device
    ms a step by kernel class, busy share); ``output()`` at B=2 against a
    CPU copy of the trained weights; bucketed ``output()`` at 3 and 5
    rows against exact; ``save`` and ``SameDiff.load(device="cuda")``
    with the same output bits; then the graph deployed as ``sdbert:v1``
    behind a ``ModelServer`` (warmed over 1..8) answering SD_CLIENTS
    client processes of SD_REQUESTS placeholder-dict requests, each held
    against the graph's own ``output()``. Returns the trained graph and
    its batches."""
    import tempfile
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
    from deeplearning4j_tpu_torch.common.environment import environment
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.serving import ModelRegistry, ModelServer
    dims = qa_dims()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sd = SameDiff.create()
    names = samediff_qa_graph(sd, qa_weights(dims, seed=0), dims, SD_T)
    outs = list(names[:2])
    rec = {"phase": "samediff_bert", "B": SD_B, "T": SD_T,
           "batches": SD_BATCHES, "dtype": "float32",
           "updater": f"Adam({SD_LR})", "ops": len(sd._ops),
           "variables": len(sd.trainable_variables()),
           "params": qa_param_count(sd),
           "build_s": time.perf_counter() - t0}
    if rec["params"] != SD_PARAMS:
        raise RuntimeError(f"the QA graph has {rec['params']} parameters, "
                           f"want {SD_PARAMS}")
    batches, host = [], []
    for i in range(SD_BATCHES):
        b = qa_batch(dims, SD_B, SD_T, seed=100 + i)
        host.append(b)
        batches.append(MultiDataSet(
            [torch.from_numpy(b[k]).cuda() for k in SD_FEATURES],
            [torch.from_numpy(b[k]).cuda() for k in SD_LABELS]))
    sd.set_training_config(TrainingConfig(
        updater=Adam(learning_rate=SD_LR),
        data_set_feature_mapping=list(SD_FEATURES),
        data_set_label_mapping=list(SD_LABELS)))
    t0 = time.perf_counter()
    warm = sd.fit(batches, num_epochs=1)
    torch.cuda.synchronize()
    rec["warm_epoch_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    timed = sd.fit(batches, num_epochs=SD_EPOCHS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = SD_EPOCHS * SD_BATCHES
    step_ms = wall * 1e3 / steps
    curves = [warm.loss_curves[0]] + list(timed.loss_curves)
    profiled = {}

    def profiled_epoch():
        profiled["h"] = sd.fit(batches, num_epochs=1)
    by_name = {k: v / SD_BATCHES
               for k, v in device_ms_by_kernel(profiled_epoch, 1).items()}
    curves.append(profiled["h"].loss_curves[0])
    device_ms = sum(by_name.values())
    groups = {}
    for k, v in by_name.items():
        g = kernel_group(k, SD_KERNEL_GROUPS)
        groups[g] = groups.get(g, 0.0) + v
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    first_loss = curves[0].losses[0]
    epoch_means = [c.mean_loss() for c in curves]
    rec.update({
        "losses_first_epoch": curves[0].losses,
        "epoch_mean_losses": epoch_means, "first_loss": first_loss,
        "ln_T": float(np.log(SD_T)), "wall_s_timed_epochs": wall,
        "step_ms": step_ms, "samples_per_s": steps * SD_B / wall,
        "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / step_ms,
        "ms_per_step_by_class": groups, "kernels_seen": len(by_name),
        "top_kernels_ms_per_step": [[k[:80], v] for k, v in top],
        "max_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    # the trained weights: output() on the card against a CPU copy
    x2 = {k: host[0][k][:2] for k in SD_FEATURES}
    cpu = SameDiff.create(device="cpu")
    cpu_w = {v.name: sd._arrays[v.name].cpu().numpy()
             for v in sd.trainable_variables()}
    samediff_qa_graph(cpu, cpu_w, dims, SD_T)
    ref = cpu.output(x2, outs)
    got = sd.output(x2, outs)
    rec["f32_output_vs_cpu_max_abs_err"] = max(
        float(np.abs(got[o].numpy() - ref[o].numpy()).max()) for o in outs)
    rec["f32_output_vs_cpu_tol"] = SD_F32_ATOL
    del cpu, cpu_w, ref
    # bucketed output() against exact
    env = environment()
    bucket_err = {}
    for n in (3, 5):
        xn = {k: host[1][k][:n] for k in SD_FEATURES}
        fn = sd.make_function(outs, tuple(sorted(xn)))
        _, pad = sd._bucketable_padding(
            fn, {k: torch.from_numpy(v).cuda() for k, v in xn.items()}, outs)
        b = sd.output(xn, outs)
        env.set_inference_bucketing(False)
        try:
            e = sd.output(xn, outs)
        finally:
            env.set_inference_bucketing(True)
        bucket_err[n] = {"bucket": pad[1] if pad else None, "max_abs_err": max(
            float(np.abs(b[o].numpy() - e[o].numpy()).max()) for o in outs)}
    rec["bucketed_vs_exact"] = bucket_err
    # save, then load on the card: the same output bits
    tmp = tempfile.TemporaryDirectory()
    try:
        path = os.path.join(tmp.name, "sdbert.sdz")
        t0 = time.perf_counter()
        sd.save(path)
        rec["save_s"] = time.perf_counter() - t0
        rec["saved_mib"] = os.path.getsize(path) / 2 ** 20
        t0 = time.perf_counter()
        loaded = SameDiff.load(path, device="cuda")
        rec["load_s"] = time.perf_counter() - t0
        a, b = sd.output(x2, outs), loaded.output(x2, outs)
        rec["load_same_bits"] = all(torch.equal(a[o].torch(), b[o].torch())
                                    for o in outs)
        del loaded
    finally:
        tmp.cleanup()
    # the predict route
    pool = qa_batch(dims, SD_POOL_ROWS, SD_T, seed=7)
    pool = {k: pool[k] for k in SD_FEATURES}
    refs = sd.output(pool, outs)
    refs = {o: refs[o].numpy() for o in outs}
    reg = ModelRegistry(manifest_dir=None)
    srv = ModelServer(reg, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{srv.start()}"
    tmp = tempfile.TemporaryDirectory()
    try:
        t0 = time.perf_counter()
        reg.deploy("sdbert", "v1", sd, outputs=outs,
                   example={k: v[:1] for k, v in pool.items()},
                   max_batch=SD_PREDICT_MAX_BATCH)
        rec["deploy_s"] = time.perf_counter() - t0
        engine = reg.get("sdbert").engine
        rec["ladder"] = list(engine.ladder)
        path = os.path.join(tmp.name, "sdbert.npz")
        np.savez(path, **pool)
        rng = np.random.RandomState(43)
        jobs = []
        for c in range(SD_CLIENTS):
            reqs = []
            for j in range(SD_REQUESTS):
                rows = int(rng.randint(1, SD_MAX_ROWS + 1))
                reqs.append({"model": "sdbert", "rows": rows, "lo": int(
                    rng.randint(0, SD_POOL_ROWS - rows + 1))})
            jobs.append({"kind": "predict", "base": base,
                         "pools": {"sdbert": path}, "requests": reqs})
        s0 = engine.stats()
        c0 = env.compile_count()
        start = time.time() + 4.0   # every client process is up by then
        for job in jobs:
            job["start_at"] = start
        client_outs = run_client_processes(jobs)
        census = env.compile_count() - c0
        s1 = engine.stats()
        results = [r for o in client_outs for r in o["results"]]
        requests = [r for job in jobs for r in job["requests"]]
        err = 0.0
        for (status, doc, _, _), r in zip(results, requests):
            if status != 200:
                raise RuntimeError(f"a predict got {status}: {doc}")
            for o in outs:
                a = np.asarray(doc["outputs"][o], np.float32)
                want = refs[o][r["lo"]:r["lo"] + r["rows"]]
                if a.shape != want.shape or not np.isfinite(a).all():
                    raise RuntimeError(f"a predict answered {o} of shape "
                                       f"{a.shape}, want {want.shape}")
                err = max(err, float(np.abs(a - want).max()))
        wall = max(r[3] for r in results) - min(r[2] for r in results)
        lat = [r[3] - r[2] for r in results]
        rows = sum(r["rows"] for r in requests)
        d = s1["dispatches"] - s0["dispatches"]
        rec["predict"] = {
            "clients": SD_CLIENTS, "requests": len(results), "rows": rows,
            "wall_s": wall, "samples_per_s": rows / wall,
            "client_latency_s_p50": percentile(lat, 0.5),
            "client_latency_s_p99": percentile(lat, 0.99),
            "dispatches": d,
            "rows_per_dispatch": (s1["rows_real"] - s0["rows_real"])
            / max(d, 1),
            "census_events_after_warmup": census,
            "max_abs_err_vs_output": err, "tol": SD_PREDICT_ATOL}
        # the graph's signatures: captured, or eager with the reason
        graphs = s1["graphs"]
        emit({"phase": "graphs_samediff", "signatures": len(graphs),
              "captured": sum(g["cache"] == "captured" for g in graphs),
              "eager": [{k: g[k] for k in ("signature", "cache", "error")}
                        for g in graphs if g["cache"] != "captured"]})
        reg.drain_all(save_manifests=False)
    finally:
        srv.stop()
        reg.drain_all(timeout_s=60, save_manifests=False)
        tmp.cleanup()
    emit(rec)
    if not (np.isfinite(first_loss)
            and abs(first_loss - np.log(SD_T)) <= SD_LOSS0_ATOL):
        raise RuntimeError(f"the first loss {first_loss} is not within "
                           f"{SD_LOSS0_ATOL} of ln {SD_T}")
    if not (all(np.isfinite(m) for m in epoch_means)
            and epoch_means[-1] < epoch_means[0]):
        raise RuntimeError(f"the mean loss did not fall: {epoch_means}")
    if rec["f32_output_vs_cpu_max_abs_err"] > SD_F32_ATOL:
        raise RuntimeError(f"output() on the card differs from the CPU's "
                           f"by {rec['f32_output_vs_cpu_max_abs_err']}")
    for n, v in bucket_err.items():
        if v["bucket"] is None or v["max_abs_err"] > SD_PREDICT_ATOL:
            raise RuntimeError(f"bucketed output() at {n} rows: {v}")
    if not rec["load_same_bits"]:
        raise RuntimeError("the loaded graph's output differs in bits")
    if census != 0 or err > SD_PREDICT_ATOL:
        raise RuntimeError(f"the predict route: {rec['predict']}")
    return sd, batches


# the modelimport phase: BERT-base from its GraphDef skeleton at B=8,
# T=128, the last 28 positions masked; card against CPU within the JAX
# package's full-size tolerance against TF (test_bert_base_full_size_
# golden): 12 layers of f32 products summed in another order
IMPORT_B, IMPORT_MASKED, IMPORT_SEED = 8, 28, 0
IMPORT_ATOL = 5e-4
IMPORT_CALLS = 5
# the small graphs on the card against the CPU: f32 products and
# convolutions in another order (TF32 off)
IMPORT_SMALL_ATOL = 2e-5


def phase_modelimport():
    """BERT-base imported from a TF GraphDef and run on the card (see the
    module docstring); every check raises on failure."""
    import tempfile
    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import torch_import_cases as cases
    from deeplearning4j_tpu_torch.interop import GraphRunner, OnnxRunner
    from deeplearning4j_tpu_torch.modelimport.samediff_fb import \
        load_samediff_fb
    from deeplearning4j_tpu_torch.modelimport.tf.importer import \
        TFGraphImporter
    outs = list(cases.OUTPUTS)
    rec = {"phase": "modelimport", "B": IMPORT_B,
           "T": cases.BERT["base"]["seq"], "masked": IMPORT_MASKED,
           "tf32": bool(torch.backends.cuda.matmul.allow_tf32
                        or torch.backends.cudnn.allow_tf32)}
    t0 = time.perf_counter()
    pb = cases.bert_graph("base", seed=IMPORT_SEED)
    rec["fill_s"] = time.perf_counter() - t0
    rec["graphdef_mb"] = len(pb) / 2 ** 20
    feeds = cases.bert_feeds("base", IMPORT_B, IMPORT_MASKED)
    shapes = {k: v.shape for k, v in feeds.items()}

    def imported(device):
        t0 = time.perf_counter()
        importer = TFGraphImporter(pb, input_shapes=shapes, outputs=outs,
                                   device=device)
        parse_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        graph = importer.import_graph()
        if device == "cuda":
            torch.cuda.synchronize()
        return importer.graph, graph, parse_s, time.perf_counter() - t0

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ir, imp, rec["parse_s"], rec["map_s"] = imported("cuda")
    rec["graphdef_nodes"] = len(ir.nodes) + len(ir.initializers) \
        + len(ir.inputs)
    rec["sd_ops"] = len(imp.sd._ops)
    rec["parameters"] = int(sum(a.size for a in ir.initializers.values()
                                if a.dtype == np.float32 and a.ndim >= 1))
    rec["static_shapes"] = len(imp.ctx._var_aval)
    del ir
    got = imp.output(feeds, outs)          # the first call captures
    host = []
    for _ in range(IMPORT_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imp.output(feeds, outs)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    rec["host_ms_per_call"] = float(np.median(host))
    rec["host_ms_calls"] = host
    windows = sorted((device_ms_by_kernel(lambda: imp.output(feeds, outs),
                                          1) for _ in range(IMPORT_CALLS)),
                     key=lambda w: sum(w.values()))
    by_name = windows[IMPORT_CALLS // 2]    # the median window
    rec["device_ms_per_call"] = sum(by_name.values())
    rec["device_ms_calls"] = [sum(w.values()) for w in windows]
    rec["device_busy_share"] = rec["device_ms_per_call"] \
        / rec["host_ms_per_call"]
    rec["top_kernels_ms_per_call"] = [
        [k[:80], v] for k, v in sorted(by_name.items(),
                                       key=lambda kv: -kv[1])[:6]]
    rec["peak_mb"] = torch.cuda.max_memory_allocated() / 2 ** 20
    rec["graphs"] = [{k: g[k] for k in ("cache", "error")}
                     for g in imp.sd.make_function(
                         [imp.outputs[o + ":0"] for o in outs],
                         tuple(sorted(imp.inputs.values())))
                     .graphs.report()]
    # the same bytes imported on the CPU
    _, cpu, _, _ = imported("cpu")
    ref = cpu.output(feeds, outs)
    del cpu
    rec["vs_cpu_max_abs_err"] = {
        o: float(np.abs(got[o].numpy() - ref[o].numpy()).max())
        for o in outs}
    rec["vs_cpu_atol"] = IMPORT_ATOL
    finite = all(np.isfinite(got[o].numpy()).all() for o in outs)
    want = {"sequence_output": (IMPORT_B, rec["T"], 768),
            "pooled_output": (IMPORT_B, 768)}
    shapes_ok = all(tuple(got[o].shape) == want[o] for o in outs)
    # the FlatBuffers round trip, loaded onto the card
    tmp = tempfile.TemporaryDirectory()
    try:
        path = os.path.join(tmp.name, "bert.fb")
        t0 = time.perf_counter()
        imp.sd.save_flatbuffers(path)
        rec["fb_save_s"] = time.perf_counter() - t0
        rec["fb_mb"] = os.path.getsize(path) / 2 ** 20
        t0 = time.perf_counter()
        loaded = load_samediff_fb(path, device="cuda")
        torch.cuda.synchronize()
        rec["fb_load_s"] = time.perf_counter() - t0
    finally:
        tmp.cleanup()
    names = [imp.outputs[o + ":0"] for o in outs]
    ph = {imp.inputs[k + ":0"]: v for k, v in feeds.items()}
    a, b = imp.sd.output(ph, names), loaded.output(ph, names)
    rec["fb_same_bits"] = all(torch.equal(a[n].torch(), b[n].torch())
                              for n in names)
    del loaded, imp, a, b, got
    torch.cuda.empty_cache()
    # small width: OnnxRunner and the native GraphRunner, card against CPU
    small = {}
    mlp, _ = cases.onnx_mlp(np.random.RandomState(0))
    block, _ = cases.onnx_residual_block(np.random.RandomState(0))
    rs = np.random.RandomState(1)
    for name, data, x in (
            ("onnx_mlp", mlp, rs.randn(4, 8).astype(np.float32)),
            ("onnx_residual_block", block,
             rs.randn(2, 8, 12, 12).astype(np.float32))):
        card = OnnxRunner(data, device="cuda").run({"x": x})["y"]
        host = OnnxRunner(data, device="cpu").run({"x": x})["y"]
        small[name] = float(np.abs(card.numpy() - host.numpy()).max())
    tiny = cases.bert_graph("tiny", seed=IMPORT_SEED)
    tfeeds = cases.bert_feeds("tiny", 2, 4)
    runs = [GraphRunner(tiny, list(tfeeds), outs,
                        {k: v.shape for k, v in tfeeds.items()},
                        backend="native", device=d).run(tfeeds)
            for d in ("cuda", "cpu")]
    small["graph_runner_tiny_bert"] = max(
        float(np.abs(runs[0][o].numpy() - runs[1][o].numpy()).max())
        for o in outs)
    rec["small_vs_cpu_max_abs_err"] = small
    rec["small_atol"] = IMPORT_SMALL_ATOL
    emit(rec)
    if rec["parameters"] != cases.BERT_BASE_PARAMS:
        raise RuntimeError(f"the GraphDef holds {rec['parameters']} "
                           f"parameters, want {cases.BERT_BASE_PARAMS}")
    if not (finite and shapes_ok):
        raise RuntimeError("the imported BERT's outputs are not finite "
                           "values of the expected shapes")
    if max(rec["vs_cpu_max_abs_err"].values()) > IMPORT_ATOL:
        raise RuntimeError(f"the card's outputs differ from the CPU's: "
                           f"{rec['vs_cpu_max_abs_err']}")
    if not rec["fb_same_bits"]:
        raise RuntimeError("the .fb round trip changed the outputs' bits")
    if max(small.values()) > IMPORT_SMALL_ATOL:
        raise RuntimeError(f"a small graph differs on the card: {small}")


# the keras_import phase: Keras's ResNet50V2 (weights=None, 25.6 M
# parameters, tests/test_keras_applications.py's stock model) from the
# committed h5 skeleton filled from a seed, imported onto the card and run
# with output() at B=8, 224 x 224, NCHW, KERAS_CALLS timed calls; held to
# Keras's committed golden of the same file and to the same file imported
# on the CPU at the JAX test's own tolerance (atol and rtol 1e-4, TF32
# off). Then at small width: the TFLite MLP and CNN (their committed
# files and TF Interpreter goldens, KERAS_TFLITE_* tolerances), the zoo's
# LeNet as a DL4J zip through init_pretrained and OmniHub, and
# KERAS_UI_STEPS LeNet fit steps under StatsListeners, each on the card
# against the CPU
KERAS_CALLS = 5
KERAS_TFLITE_ATOL, KERAS_TFLITE_RTOL = 1e-4, 1e-4
KERAS_SMALL_ATOL = 1e-5
KERAS_UI_STEPS, KERAS_UI_B = 20, 64
# the UI records of the card's steps against the CPU's: each param's l2
# and mean magnitude, relative (the same 20 Adam steps, f32, TF32 off),
# and each step's update ratio, relative
KERAS_UI_RTOL, KERAS_UI_RATIO_RTOL = 1e-3, 2e-2


def phase_keras_import():
    """The Keras h5 importer, the TFLite runner, DL4J zips, OmniHub and
    the training UI on the card (see the module docstring); one line a
    part, every check raises on failure."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import torch_keras_cases as kc
    from deeplearning4j_tpu_torch.modelimport import \
        import_keras_model_and_weights
    from deeplearning4j_tpu_torch.modelimport.keras import importer
    tf32 = bool(torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32)
    tmp = tempfile.mkdtemp(prefix="keras-import-")
    try:
        path = os.path.join(tmp, "resnet50v2.h5")
        t0 = time.perf_counter()
        kc.write_filled(path)
        rec = {"phase": "keras_import", "part": "resnet50v2",
               "B": kc.RESNET_B, "tf32": tf32,
               "fill_s": time.perf_counter() - t0,
               "h5_mb": os.path.getsize(path) / 2 ** 20}
        t0 = time.perf_counter()
        _, weights = importer._read_h5(path)
        rec["read_s"] = time.perf_counter() - t0
        del weights
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        net = import_keras_model_and_weights(path, device="cuda")
        torch.cuda.synchronize()
        rec["import_s"] = time.perf_counter() - t0
        vertices = net.conf.vertices
        rec["vertices"] = len(vertices)
        rec["layers"] = sum(1 for v in vertices.values()
                            if hasattr(v, "layer"))
        rec["parameters"] = int(sum(t.numel() for p in net._params.values()
                                    for t in p.values()))
        x = kc.resnet_batch()
        xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).cuda()
        got = net.output(xt)[0].numpy()        # the first call captures
        host = []
        for _ in range(KERAS_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net.output(xt)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        rec["host_ms_per_call"] = float(np.median(host))
        rec["host_ms_calls"] = host
        windows = sorted((device_ms_by_kernel(lambda: net.output(xt), 1)
                          for _ in range(KERAS_CALLS)),
                         key=lambda w: sum(w.values()))
        by_name = windows[KERAS_CALLS // 2]
        rec["device_ms_per_call"] = sum(by_name.values())
        rec["device_ms_calls"] = [sum(w.values()) for w in windows]
        rec["device_busy_share"] = rec["device_ms_per_call"] \
            / rec["host_ms_per_call"]
        rec["top_kernels_ms_per_call"] = [
            [k[:80], v] for k, v in sorted(by_name.items(),
                                           key=lambda kv: -kv[1])[:6]]
        rec["peak_mb"] = torch.cuda.max_memory_allocated() / 2 ** 20
        rec["graphs"] = [{k: g[k] for k in ("cache", "error")}
                         for g in net._output_fn(False).graphs.report()]
        with np.load(kc.GOLDEN) as z:
            golden = z["golden"]
        rec["vs_golden_max_abs_err"] = float(np.abs(got - golden).max())
        rec["vs_golden_max_rel_err"] = float(
            (np.abs(got - golden) / np.abs(golden).clip(1e-30)).max())
        rec["golden_top1"] = [float(v) for v in golden.max(1)]
        rec["atol"], rec["rtol"] = kc.RESNET_ATOL, kc.RESNET_RTOL
        del net
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cpu = import_keras_model_and_weights(path, device="cpu")
        rec["cpu_import_s"] = time.perf_counter() - t0
        ref = cpu.output(x.transpose(0, 3, 1, 2).copy())[0].numpy()
        del cpu
        rec["vs_cpu_max_abs_err"] = float(np.abs(got - ref).max())
        rec["vs_cpu_max_rel_err"] = float(
            (np.abs(got - ref) / np.abs(ref).clip(1e-30)).max())
        finite = bool(np.isfinite(got).all()) and got.shape == golden.shape
        emit(rec)
        if rec["parameters"] != kc.RESNET50V2_PARAMS:
            raise RuntimeError(f"the imported ResNet50V2 holds "
                               f"{rec['parameters']} parameters, want "
                               f"{kc.RESNET50V2_PARAMS}")
        if not finite:
            raise RuntimeError("the imported ResNet50V2's output is not "
                               "finite values of the golden's shape")
        if not kc.check_against_golden(got, golden):
            raise RuntimeError("a golden row's top-2 margin is inside the "
                               "tolerance: the argmax was not held")
        np.testing.assert_allclose(got, ref, atol=kc.RESNET_ATOL,
                                   rtol=kc.RESNET_RTOL)
        keras_import_small(tmp)
        keras_import_ui(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def keras_import_small(tmp):
    """The TFLite MLP and CNN, and the zoo's LeNet as a DL4J zip through
    ``init_pretrained`` and ``OmniHub``, on the card against the CPU and
    the committed goldens."""
    import hashlib
    import shutil
    import numpy as np
    import torch_keras_cases as kc
    from deeplearning4j_tpu_torch.interop import TfliteRunner
    from deeplearning4j_tpu_torch.omnihub import OmniHub
    from deeplearning4j_tpu_torch.zoo import LeNet
    rec = {"phase": "keras_import", "part": "small",
           "tflite_atol": KERAS_TFLITE_ATOL,
           "tflite_rtol": KERAS_TFLITE_RTOL, "atol": KERAS_SMALL_ATOL}
    xs, goldens = kc.tflite_inputs(), kc.tflite_goldens()
    for name, path in kc.TFLITE.items():
        runs = {}
        for device in ("cuda", "cpu"):
            r = TfliteRunner(path, device=device)
            r.run([xs[name]])                 # the first call captures
            runs[device] = r.run([xs[name]])[r.output_names[0]].numpy()
            if device == "cuda":
                rec[f"tflite_{name}_graphs"] = [
                    g["cache"] for g in r._run.graphs.report()]
        rec[f"tflite_{name}_vs_cpu"] = float(
            np.abs(runs["cuda"] - runs["cpu"]).max())
        rec[f"tflite_{name}_vs_golden"] = float(
            np.abs(runs["cuda"] - goldens[name]).max())
        np.testing.assert_allclose(runs["cuda"], goldens[name],
                                   atol=KERAS_TFLITE_ATOL,
                                   rtol=KERAS_TFLITE_RTOL)
        np.testing.assert_allclose(runs["cuda"], runs["cpu"],
                                   atol=KERAS_SMALL_ATOL, rtol=0)
    zpath = os.path.join(tmp, "lenet.zip")
    want = kc.write_dl4j_lenet_zip(zpath, seed=0)
    x = kc.lenet_batch()
    card = LeNet().init_pretrained(path=zpath, device="cuda")
    rec["dl4j_params_exact"] = all(
        np.array_equal(card._params[i][k].cpu().numpy(), v)
        for i, p in enumerate(want) for k, v in p.items())
    out = card.output(x).numpy()
    host = LeNet().init_pretrained(path=zpath, device="cpu").output(x)
    rec["dl4j_vs_cpu"] = float(np.abs(out - host.numpy()).max())
    hub_dir = os.path.join(tmp, "omnihub")
    os.makedirs(hub_dir)
    shutil.copyfile(zpath, os.path.join(hub_dir, "lenet.zip"))
    with open(zpath, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    # cache first: no fetcher is installed, so nothing can be fetched
    hub = OmniHub(hub_dir).register("lenet", "dl4j", "lenet.zip", digest)
    rec["omnihub_same_bits"] = bool(np.array_equal(
        hub.load("lenet", device="cuda").output(x).numpy(), out))
    emit(rec)
    if not rec["dl4j_params_exact"]:
        raise RuntimeError("the DL4J zip's params changed on the card")
    if rec["dl4j_vs_cpu"] > KERAS_SMALL_ATOL:
        raise RuntimeError(f"the restored LeNet differs on the card: "
                           f"{rec['dl4j_vs_cpu']}")
    if not rec["omnihub_same_bits"]:
        raise RuntimeError("OmniHub's LeNet differs from init_pretrained's")


class _NullListener:
    """Overrides ``iteration_done`` and does nothing: ``fit``'s per-step
    path without a listener's own work."""

    def iteration_done(self, model, iteration, loss=None):
        pass


def keras_import_ui(tmp):
    """KERAS_UI_STEPS LeNet fit steps on the card under two
    ``StatsListener``s (an ``InMemoryStatsStorage`` behind a ``UIServer``
    on an ephemeral port, and a ``FileStatsStorage``), read back over
    HTTP, and the same steps on the CPU from the same weights; then the
    listener's host ms a step against the per-step path without its
    work and against no listener."""
    import json as _json
    import urllib.request
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.ui import (FileStatsStorage,
                                             InMemoryStatsStorage,
                                             StatsListener, UIServer)
    from deeplearning4j_tpu_torch.zoo import LeNet
    rs = np.random.RandomState(3)
    data = []
    for _ in range(KERAS_UI_STEPS):
        x = rs.randn(KERAS_UI_B, 1, 28, 28).astype(np.float32)
        y = np.zeros((KERAS_UI_B, 10), np.float32)
        y[np.arange(KERAS_UI_B), rs.randint(0, 10, KERAS_UI_B)] = 1.0
        data.append((x, y))

    def batches(device):
        return [DataSet(torch.from_numpy(x).to(device),
                        torch.from_numpy(y).to(device)) for x, y in data]

    card = LeNet().init_model(device="cuda")
    host = LeNet().init_model(device="cpu")
    host.init(params=[{k: v.cpu().clone() for k, v in p.items()}
                      for p in card._params])
    mem = InMemoryStatsStorage()
    fpath = os.path.join(tmp, "stats.jsonl")
    server = UIServer(port=0).attach(mem)
    port = server.start()
    try:
        card._listeners = [StatsListener(mem, session_id="card",
                                         histogram_frequency=5),
                           StatsListener(FileStatsStorage(fpath),
                                         session_id="card",
                                         histogram_frequency=5)]
        card_batches = batches("cuda")
        card.fit(card_batches)
        torch.cuda.synchronize()
        base = f"http://127.0.0.1:{port}"

        def get(p):
            with urllib.request.urlopen(base + p, timeout=10) as r:
                return r.read()

        sessions = _json.loads(get("/train/sessions"))
        overview = _json.loads(get("/train/overview?sid=card"))
        metrics = _json.loads(get("/metrics.json"))
    finally:
        server.stop()
    cpu_mem = InMemoryStatsStorage()
    host._listeners = [StatsListener(cpu_mem, session_id="cpu",
                                     histogram_frequency=5)]
    host.fit(batches("cpu"))
    ups, refs = overview["updates"], cpu_mem.get_updates("cpu")
    from_file = FileStatsStorage(fpath).get_updates("card")
    err = {"l2": 0.0, "mean_mag": 0.0, "update_param_ratio": 0.0}
    for u, r in zip(ups, refs):
        for name, s in r["params"].items():
            for k in ("l2", "mean_mag"):
                err[k] = max(err[k], abs(u["params"][name][k] - s[k])
                             / max(abs(s[k]), 1e-12))
        if "update_param_ratio" in r:
            err["update_param_ratio"] = max(
                err["update_param_ratio"],
                abs(u["update_param_ratio"] - r["update_param_ratio"])
                / r["update_param_ratio"])
    static = overview["static"] or {}
    mem_ok = all(u.get("memory", {}).get("bytes_in_use", 0) > 0
                 and u["memory"]["peak_bytes_in_use"]
                 >= u["memory"]["bytes_in_use"] for u in ups)
    rec = {"phase": "keras_import", "part": "ui", "steps": KERAS_UI_STEPS,
           "B": KERAS_UI_B, "sessions": sessions,
           "updates": len(ups), "file_updates": len(from_file),
           "static": {k: static.get(k) for k in
                      ("model_class", "n_params", "backend",
                       "device_count")},
           "memory_last": ups[-1].get("memory") if ups else None,
           "memory_is_the_cards": mem_ok,
           "metrics_json_families": len(metrics),
           "vs_cpu_max_rel_err": err,
           "rtol": KERAS_UI_RTOL, "ratio_rtol": KERAS_UI_RATIO_RTOL,
           "census": [{k: g[k] for k in ("tag", "cache")}
                      for g in card.train_graphs_report()]}
    # the listener's host cost: the same steps with it, with a listener
    # doing nothing (the same per-step path) and with none (the staged
    # path); each run warmed once on the same batches first
    timing = {}
    for label, listeners in (
            ("stats_listener", [StatsListener(InMemoryStatsStorage(),
                                              session_id="t",
                                              histogram_frequency=5)]),
            ("null_listener", [_NullListener()]), ("none", [])):
        card._listeners = listeners
        card.fit(card_batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card.fit(card_batches)
        torch.cuda.synchronize()
        timing[label] = (time.perf_counter() - t0) * 1e3 / KERAS_UI_STEPS
    rec["host_ms_per_step"] = timing
    rec["listener_ms_per_step"] = timing["stats_listener"] \
        - timing["null_listener"]
    emit(rec)
    if sessions != ["card"] or len(ups) != KERAS_UI_STEPS \
            or len(from_file) != KERAS_UI_STEPS:
        raise RuntimeError(f"the UI served {sessions} with {len(ups)} "
                           f"updates ({len(from_file)} in the file), want "
                           f"['card'] with {KERAS_UI_STEPS}")
    if static.get("backend") != "cuda" or not mem_ok:
        raise RuntimeError("the records do not carry the card's backend "
                           "and memory")
    if max(err["l2"], err["mean_mag"]) > KERAS_UI_RTOL \
            or err["update_param_ratio"] > KERAS_UI_RATIO_RTOL:
        raise RuntimeError(f"the card's records differ from the CPU's: "
                           f"{err}")


# the precision phase: the samediff_bert phase's trained QA graph and
# batches, PRECISION_STEPS fit steps from the same weights at each
# matmul_precision level after one warm step at it; the first losses of
# the two levels within PRECISION_LOSS_RTOL of each other (relative): the
# same forward, f32 against TF32 products (10-bit mantissa, ~1e-3 relative
# on each product, averaged through 12 layers and a mean over 32 x 2
# cross entropies of about ln 384)
PRECISION_LEVELS = ("highest", "high")
PRECISION_STEPS, PRECISION_PROFILED = 4, 2
PRECISION_LOSS_RTOL = 1e-2


def phase_precision(sd, batches):
    """``set_property("matmul_precision", ...)`` on the SameDiff QA step
    (BASELINE config 3's shape, B=32, T=384, f32): for each level of
    PRECISION_LEVELS, from the same weights and updater state,
    PRECISION_STEPS ``fit`` steps timed (host clock) and
    PRECISION_PROFILED under ``torch.profiler`` (device ms a step, GEMM ms
    and the GEMM kernels' names). TF32 tensor-core GEMMs (``tf32`` in the
    name) must appear under "high" and none under "highest"; both loss
    trajectories must be finite and their first losses agree within
    PRECISION_LOSS_RTOL. The property is restored before the phase ends."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.common.environment import environment
    from deeplearning4j_tpu_torch.learning import tree_map
    env = environment()
    prev = env.property_override("matmul_precision")
    flags = [torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32]
    arrays0 = {k: v.clone() for k, v in sd._arrays.items()}
    updater0 = tree_map(torch.clone, sd._updater_state)
    steps = batches[:PRECISION_STEPS]
    prof = batches[PRECISION_STEPS:PRECISION_STEPS + PRECISION_PROFILED]

    def reset():
        sd._arrays.update({k: v.clone() for k, v in arrays0.items()})
        sd._updater_state = tree_map(torch.clone, updater0)
    rec = {"phase": "precision", "B": SD_B, "T": SD_T,
           "steps": PRECISION_STEPS, "levels": {}}
    try:
        for level in PRECISION_LEVELS:
            env.set_property("matmul_precision", level)
            reset()
            sd.fit(batches[:1], num_epochs=1)   # the level's first GEMMs
            reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hist = sd.fit(steps, num_epochs=1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            by_name = {k: v / len(prof) for k, v in device_ms_by_kernel(
                lambda: sd.fit(prof, num_epochs=1), 1).items()}
            gemms = {k: v for k, v in by_name.items()
                     if kernel_group(k, SD_KERNEL_GROUPS) == "gemm"}
            device_ms = sum(by_name.values())
            rec["levels"][level] = {
                "tf32_flag": torch.backends.cuda.matmul.allow_tf32,
                "losses": hist.loss_curves[0].losses,
                "samples_per_s": len(steps) * SD_B / wall,
                "host_ms_per_step": wall * 1e3 / len(steps),
                "device_ms_per_step": device_ms,
                "busy_share": device_ms / (wall * 1e3 / len(steps)),
                "gemm_ms_per_step": sum(gemms.values()),
                "gemm_kernels": sorted(
                    [[k[:120], v] for k, v in gemms.items()],
                    key=lambda kv: -kv[1])[:8],
                "tf32_gemm_kernels": sum(1 for k in gemms
                                         if "tf32" in k.lower())}
    finally:
        env.set_property("matmul_precision", "default")
        if prev is None:
            env.clear_property("matmul_precision")
        else:
            env.set_property("matmul_precision", prev)
        reset()
        del arrays0, updater0
    hi, lo = (rec["levels"][lv] for lv in PRECISION_LEVELS)
    a, b = np.asarray(hi["losses"]), np.asarray(lo["losses"])
    rec["loss_max_rel_diff"] = float(np.max(np.abs(a - b) / np.abs(a)))
    rec["first_loss_rel_diff"] = float(abs(a[0] - b[0]) / abs(a[0]))
    rec["speedup_samples_per_s"] = lo["samples_per_s"] / hi["samples_per_s"]
    rec["gemm_ms_ratio"] = hi["gemm_ms_per_step"] / lo["gemm_ms_per_step"]
    rec["flags_after"] = [torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32]
    emit(rec)
    if not (np.isfinite(a).all() and np.isfinite(b).all()
            and rec["first_loss_rel_diff"] <= PRECISION_LOSS_RTOL):
        raise RuntimeError(f"the two levels' losses: {a} / {b}")
    if hi["tf32_gemm_kernels"] or not lo["tf32_gemm_kernels"]:
        raise RuntimeError(
            f"TF32 GEMMs under 'highest': {hi['tf32_gemm_kernels']}, under "
            f"'high': {lo['tf32_gemm_kernels']}")
    if rec["flags_after"] != flags:
        raise RuntimeError(f"the TF32 flags {rec['flags_after']} were not "
                           f"restored to {flags}")


# the recurrent phases' kernel classes: cuBLAS / CUTLASS GEMMs (the f32
# kernels carry sm80 / sm90 / xmma / cutlass names), PyTorch's elementwise
# kernels, and everything else (reductions, gathers, scatters, copies)
RNN_KERNEL_GROUPS = (
    ("gemm", ("gemm", "cublas", "cutlass", "xmma", "sm80", "sm90")),
    ("elementwise", ("elementwise",)))


def rnn_profile(fn, per_call):
    """Device ms of one unit of ``fn()``'s work (``fn`` runs ``per_call``
    units: steps, batches) by kernel class, the top kernels and the
    launches a unit, from one profiler window."""
    counts = {}
    by_name = {k: v / per_call
               for k, v in device_ms_by_kernel(fn, 1, counts=counts).items()}
    groups = {}
    for k, v in by_name.items():
        g = kernel_group(k, RNN_KERNEL_GROUPS)
        groups[g] = groups.get(g, 0.0) + v
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"device_ms": sum(by_name.values()), "ms_by_class": groups,
            "top_kernels_ms": [[k[:80], v] for k, v in top],
            "launches": counts["launches"] / per_call,
            "device_records": counts["device_records"] / per_call}


def s2s_steps(step, params, opt, batch, eager=None):
    """The phase's compared calls of the Seq2Seq step on ``params``: one
    warm call (which captures, where the step is not kept eager) and
    S2S_STEPS timed, at iterations 0, 1, ... Returns the losses, the
    first loss, the warm call's seconds and the host ms a timed step."""
    import torch
    t0 = time.perf_counter()
    losses = [step(params, opt, batch, 0, eager=eager)[2]]
    first = float(losses[0])
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(1, S2S_STEPS + 1):
        losses.append(step(params, opt, batch, i, eager=eager)[2])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / S2S_STEPS
    return losses, first, warm_s, step_ms


def s2s_profiled(step, params, opt, batch, eager=None):
    """A call that runs S2S_PROFILED more steps (a profiled window's)."""
    it = [S2S_STEPS]

    def steps():
        for _ in range(S2S_PROFILED):
            it[0] += 1
            step(params, opt, batch, it[0], eager=eager)
    return steps


def phase_seq2seq():
    """BASELINE config 4's Seq2Seq LSTM at bench.py's widths (vocab 8000,
    embed 256, hidden 512, f32 without TF32, B=128, S=32, ids from
    ``RandomState(0)``, Adam 1e-3), its step captured: one warm step
    (which captures) and S2S_STEPS timed (host clock), the phase's own
    peak memory; the same calls of the same body kept eager
    (``eager="reference"``), twice from the same start, and the replayed
    params, Adam moments and losses against the eager ones (bit for bit
    where the eager runs agree, else within twice their spread); then
    S2S_PROFILED more steps replayed and eager under the profiler
    (``profile_pair``): device ms a step by kernel class, launch calls,
    device records and busy share each way. The first loss against a CPU copy of the
    same weights (near ln 8000), the last timed loss below it, the
    census after warmup 0, and ``greedy_decode`` on S2S_DECODE_ROWS rows
    token-identical to ``greedy_decode_recompute`` on the card."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.common.environment import environment
    from deeplearning4j_tpu_torch.learning import tree_map
    from deeplearning4j_tpu_torch.models import seq2seq
    from deeplearning4j_tpu_torch.nn.fit_fastpath import full_f32
    t_phase = time.perf_counter()
    c = seq2seq.Seq2SeqConfig(vocab_size=S2S_VOCAB, embed_dim=S2S_EMBED,
                              hidden=S2S_HIDDEN)
    B, S = S2S_B, S2S_S
    rng = np.random.RandomState(0)
    src = rng.randint(2, c.vocab_size, (B, S)).astype(np.int32)
    tgt = rng.randint(2, c.vocab_size, (B, S)).astype(np.int32)
    host = {"src": src, "tgt_out": tgt, "tgt_in": np.concatenate(
        [np.full((B, 1), c.bos_token, np.int32), tgt[:, :-1]], axis=1)}
    batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases left allocated, taken off the peak
    base = torch.cuda.memory_allocated()
    params = seq2seq.init_params(c, seed=0, device="cuda")
    # a copy (the train step updates params in place)
    cpu_params = tree_map(lambda t: t.to("cpu", copy=True), params)
    opt = seq2seq.init_opt_state(params)
    start = (clone_tree(params), clone_tree(opt))
    step = seq2seq.make_train_step(c, learning_rate=S2S_LR)
    env = environment()
    H, E, V = c.hidden, c.embed_dim, c.vocab_size
    flops = 3 * (2 * 2 * S * B * (E + H) * 4 * H + 2 * B * S * H * V)
    fails = []
    with full_f32():
        c0 = env.compile_count()
        losses, first, warm_s, step_ms = s2s_steps(step, params, opt, batch)
        census = env.compile_count() - c0
        max_memory = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        graph, = step.graphs.report()
        # the same body kept eager, twice from the same start
        eager_step = seq2seq.make_train_step(c, learning_rate=S2S_LR)
        runs = {"replayed": step_state(params, opt, losses)}
        for label in ("eager_1", "eager_2"):
            p, o = clone_tree(start[0]), clone_tree(start[1])
            ls, _, _, ms = s2s_steps(eager_step, p, o, batch,
                                     eager="reference")
            runs[label] = step_state(p, o, ls)
            if label == "eager_1":
                kept, eager_ms = (p, o), ms
            del p, o
        check = replay_check("seq2seq step", runs["replayed"],
                             runs["eager_1"], runs["eager_2"], fails)
        del runs, start
        (prof, by_name), (eager, _) = profile_pair(
            "seq2seq step",
            (s2s_profiled(step, params, opt, batch), S2S_PROFILED),
            (s2s_profiled(eager_step, *kept, batch, eager="reference"),
             S2S_PROFILED), fails)
        del kept
        eager.pop("flash_launches")
        eager.update(step_ms=eager_ms, busy_share=eager["device_ms"]
                     / eager_ms)
        rows = batch["src"][:S2S_DECODE_ROWS]
        t0 = time.perf_counter()
        cached = seq2seq.greedy_decode(params, rows, S2S_DECODE_LEN, c)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        naive = seq2seq.greedy_decode_recompute(params, rows,
                                                S2S_DECODE_LEN, c)
        recompute_s = time.perf_counter() - t0
    groups, top = {}, sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    for k, v in by_name.items():
        g = kernel_group(k, RNN_KERNEL_GROUPS)
        groups[g] = groups.get(g, 0.0) + v
    with torch.no_grad():
        ref = float(seq2seq.loss_fn(
            cpu_params, {k: torch.from_numpy(v) for k, v in host.items()},
            c))
    losses = [float(v) for v in torch.stack(losses[1:S2S_STEPS + 1]).cpu()]
    same = torch.equal(cached.cpu(), naive.cpu())
    rec = {"phase": "seq2seq", "vocab": V, "embed": E, "hidden": H, "B": B,
           "S": S, "dtype": "float32", "lr": S2S_LR,
           "params": sum(int(p.numel()) for p in
                         seq2seq._optim.tree_leaves(params)),
           "flops_per_step": flops, "bound_ms_f32": flops / F32_FLOPS_PER_S
           * 1e3, "warm_step_s": warm_s, "steps_timed": S2S_STEPS,
           "step_ms": step_ms, "samples_per_s": B * 1e3 / step_ms,
           "device_ms_per_step": prof["device_ms"],
           "device_busy_share": prof["device_ms"] / step_ms,
           "ms_per_step_by_class": groups,
           "launches_per_step": prof["launch_calls"],
           "device_records_per_step": prof["device_records"],
           "top_kernels_ms_per_step": [[k[:80], v] for k, v in top],
           "max_memory_gib": max_memory, "graph": graph,
           "eager": eager, **check,
           "first_loss": first, "ln_vocab": float(np.log(V)),
           "first_loss_cpu": ref, "first_loss_abs_err": abs(first - ref),
           "first_loss_tol": S2S_LOSS_ATOL, "loss_last": losses[-1],
           "losses": losses, "census_after_warmup": census - 1,
           "decode_rows": S2S_DECODE_ROWS, "decode_len": S2S_DECODE_LEN,
           "decode_token_identical": same, "decode_s": decode_s,
           "decode_recompute_s": recompute_s,
           "seconds": time.perf_counter() - t_phase}
    emit(rec)
    if graph["cache"] != "captured":
        fails.append(f"the Seq2Seq step was not captured: {graph}")
    if not (np.isfinite(first) and abs(first - ref) <= S2S_LOSS_ATOL):
        fails.append(f"the first loss {first} differs from the CPU copy's "
                     f"{ref} by more than {S2S_LOSS_ATOL}")
    if not (np.isfinite(losses[-1]) and losses[-1] < first):
        fails.append(f"the loss did not fall: {first} -> {losses}")
    if census != 1:
        fails.append(f"{census - 1} census events after warmup")
    if not same or tuple(cached.shape) != (S2S_DECODE_ROWS, S2S_DECODE_LEN):
        fails.append("the cached greedy decode is not token-identical to "
                     "the recompute loop")
    step.graphs.release()
    del params, opt, batch, step
    torch.cuda.empty_cache()
    if fails:
        raise RuntimeError(f"seq2seq phase failed: {fails}")


def phase_text_lstm():
    """``zoo.TextGenerationLSTM`` through ``MultiLayerNetwork.fit`` on
    TEXT_BATCHES device-staged batches of TEXT_B random one-hot [77, 40]
    sequences: a warm step, TEXT_EPOCHS epochs timed (host clock),
    TEXT_PROFILED steps under the profiler (device ms a step by class,
    launches, busy share).
    Bucketed ``output()`` at 3 rows against exact (TEXT_ATOL); then a
    twin with a ``MaskLayer`` in front over the same weights, half of 8
    sequences right-padded: its ``output()`` and masked ``score()`` on the
    card against a CPU copy (TEXT_ATOL), and each padded row's output
    held at its last valid step."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.common.environment import environment
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.learning import tree_map
    from deeplearning4j_tpu_torch.nn.conf.layers import MaskLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    t_phase = time.perf_counter()
    zoo = TextGenerationLSTM()
    feat, T = zoo.input_shape
    rng = np.random.RandomState(0)

    def onehot(n):
        a = np.zeros((n, feat, T), np.float32)
        a[np.arange(n)[:, None], rng.randint(0, feat, (n, T)),
          np.arange(T)[None, :]] = 1.0
        return a
    batches = [DataSet(torch.from_numpy(onehot(TEXT_B)).cuda(),
                       torch.from_numpy(onehot(TEXT_B)).cuda())
               for _ in range(TEXT_BATCHES)]
    net = zoo.init_model(device="cuda")
    t0 = time.perf_counter()
    net.fit(batches[:1], num_epochs=1)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    first = net.score_value
    # the timed and the profiled epochs are signatures of their own
    # (TEXT_BATCHES and TEXT_PROFILED batches): each captured first
    net.fit(batches, num_epochs=1)
    net.fit(batches[:TEXT_PROFILED], num_epochs=1)
    t0 = time.perf_counter()
    net.fit(batches, num_epochs=TEXT_EPOCHS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = TEXT_EPOCHS * TEXT_BATCHES
    step_ms = wall * 1e3 / steps
    prof = rnn_profile(lambda: net.fit(batches[:TEXT_PROFILED],
                                       num_epochs=1), TEXT_PROFILED)
    last = net.score_value
    # bucketed output() against exact
    env = environment()
    x3 = batches[0].features.torch()[:3]
    bucketed = net.output(x3).numpy()
    env.set_inference_bucketing(False)
    try:
        exact = net.output(x3).numpy()
    finally:
        env.set_inference_bucketing(True)
    bucket_err = float(np.abs(bucketed - exact).max())
    # the MaskLayer twin over the same weights, on the card and the CPU
    conf = zoo.build_conf()
    if conf.preprocessors:
        raise RuntimeError("TextGenerationLSTM grew preprocessors: the twin"
                           " shifts layer indices")
    conf.layers = [MaskLayer()] + conf.layers
    params = [{}] + net._params
    twin = MultiLayerNetwork(conf, device="cuda").init(
        params=tree_map(torch.clone, params))
    cpu = MultiLayerNetwork(conf, device="cpu").init(
        params=tree_map(lambda t: t.cpu(), params))
    x = batches[1].features.torch()[:8].clone()
    y = batches[1].labels.torch()[:8]
    lengths = [T, 10, T, 20, T, 30, T, 35]
    for i, n in enumerate(lengths):
        x[i, :, n:] = 0.0
    got, ref = twin.output(x).numpy(), cpu.output(x.cpu()).numpy()
    twin_err = float(np.abs(got - ref).max())
    score_card = twin.score(DataSet(x, y))
    score_cpu = cpu.score(DataSet(x.cpu(), y.cpu()))
    held = all(np.array_equal(got[i, :, n:],
                              np.repeat(got[i, :, n - 1:n], T - n, axis=1))
               for i, n in enumerate(lengths) if n < T)
    rec = {"phase": "text_lstm", "B": TEXT_B, "features": feat, "T": T,
           "batches": TEXT_BATCHES, "epochs_timed": TEXT_EPOCHS,
           "dtype": "float32", "params": net.num_params(),
           "warm_step_s": warm_s, "wall_s": wall, "step_ms": step_ms,
           "samples_per_s": steps * TEXT_B / wall,
           "device_ms_per_step": prof["device_ms"],
           "device_busy_share": prof["device_ms"] / step_ms,
           "ms_per_step_by_class": prof["ms_by_class"],
           "launches_per_step": prof["launches"],
           "top_kernels_ms_per_step": prof["top_kernels_ms"],
           "loss_after_warm_step": first, "loss_last": last,
           "bucketed_3_vs_exact_max_abs_err": bucket_err,
           "mask_twin_lengths": lengths,
           "mask_twin_vs_cpu_max_abs_err": twin_err,
           "mask_twin_score_card": score_card,
           "mask_twin_score_cpu": score_cpu,
           "mask_twin_padded_steps_hold_last_valid": held,
           "tol": TEXT_ATOL, "seconds": time.perf_counter() - t_phase}
    emit(rec)
    if not (np.isfinite(first) and np.isfinite(last)):
        raise RuntimeError(f"TextGenerationLSTM losses {first}, {last}")
    if bucket_err > TEXT_ATOL:
        raise RuntimeError(f"bucketed output() differs from exact by "
                           f"{bucket_err}")
    if twin_err > TEXT_ATOL or abs(score_card - score_cpu) > TEXT_ATOL \
            or not held:
        raise RuntimeError(f"the MaskLayer twin on the card: err "
                           f"{twin_err}, scores {score_card} / {score_cpu}, "
                           f"held {held}")
    del net, twin, batches
    torch.cuda.empty_cache()


def zipf_sentences(rng):
    """W2V_TOKENS tokens drawn with p ~ 1 / rank over W2V_VOCAB words, in
    sentences of W2V_SENTENCE."""
    import numpy as np
    p = 1.0 / np.arange(1, W2V_VOCAB + 1)
    toks = rng.choice(W2V_VOCAB, size=W2V_TOKENS, p=p / p.sum())
    words = np.asarray([f"w{i}" for i in range(W2V_VOCAB)])
    return [" ".join(words[toks[i:i + W2V_SENTENCE]])
            for i in range(0, W2V_TOKENS, W2V_SENTENCE)]


def topic_corpus(n, seed=0):
    """The JAX package's planted corpus (tests/test_nlp.py): two topics
    whose words co-occur within a topic and never across."""
    import numpy as np
    rng = np.random.RandomState(seed)
    animals = ["cat", "dog", "pet", "fur", "paw"]
    cars = ["car", "road", "drive", "wheel", "fuel"]
    return [" ".join(rng.choice(animals if rng.rand() < 0.5 else cars,
                                size=8)) for _ in range(n)]


def phase_word2vec():
    """BASELINE config 4's Word2Vec. (a) bench.py's skipgram op (vocab
    30000, dim 128, B=1024, K=5): one round on the card against the op on
    a CPU copy (W2V_ROUND_ATOL), then W2V_ROUNDS chained rounds (host
    clock: pairs/s; the profiler: device us a round, launches) beside the
    round's byte bound. (b) ``Word2Vec.fit`` of one epoch over a seeded
    Zipf stream (``zipf_sentences``): tokens/s end to end, and the wall
    split into set-up (tokenize, vocab, ids), the host's pair and
    negative generation (the same stream run alone), and the device
    steps (dispatch included); device ms a batch from the profiler.
    Then the planted two-topic corpus, skip-gram and CBOW (the JAX
    package's test settings): in-topic words nearer than cross-topic."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import nlp
    from deeplearning4j_tpu_torch.ops import nlp_ops
    t_phase = time.perf_counter()
    V, D, B, K = W2V_VOCAB, W2V_DIM, W2V_B, W2V_K
    rng = np.random.RandomState(0)
    host = [(rng.randn(V, D) * 0.1).astype(np.float32),
            (rng.randn(V, D) * 0.1).astype(np.float32),
            rng.randint(0, V, B).astype(np.int32),
            rng.randint(0, V, B).astype(np.int32),
            rng.randint(0, V, (B, K)).astype(np.int32)]
    dev = [torch.from_numpy(a).cuda() for a in host]
    got = nlp_ops.skipgram(*dev)
    ref = nlp_ops.skipgram(*[torch.from_numpy(a) for a in host])
    round_err = max(float((g.cpu() - r).abs().max()) for g, r in zip(got, ref))
    inputs_same = all(torch.equal(d.cpu(), torch.from_numpy(h))
                      for d, h in zip(dev, host))

    def chain():
        s0, s1 = dev[0], dev[1]
        for _ in range(W2V_ROUNDS):
            s0, s1, loss = nlp_ops.skipgram(s0, s1, *dev[2:])
        return loss
    chain()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = float(chain())
    chain_s = time.perf_counter() - t0
    prof = rnn_profile(lambda: nlp_ops.skipgram(*dev), 1)
    table = V * D * 4
    round_bytes = 4 * table + B * (2 + K) * 4
    op = {"vocab": V, "dim": D, "B": B, "K": K, "rounds": W2V_ROUNDS,
          "round_vs_cpu_max_abs_err": round_err, "tol": W2V_ROUND_ATOL,
          "inputs_unchanged": inputs_same, "last_loss": loss,
          "wall_s": chain_s, "pairs_per_s": W2V_ROUNDS * B / chain_s,
          "host_us_per_round": chain_s * 1e6 / W2V_ROUNDS,
          "device_us_per_round": prof["device_ms"] * 1e3,
          "us_by_class": {k: v * 1e3 for k, v in
                          prof["ms_by_class"].items()},
          "launches_per_round": prof["launches"],
          "bytes_per_round": round_bytes,
          "bound_us": round_bytes / HBM_BYTES_PER_S * 1e6}
    del dev, got
    # (b) Word2Vec.fit on the Zipf stream
    sentences = zipf_sentences(np.random.RandomState(1))
    m = (nlp.Word2Vec.builder().min_word_frequency(1).layer_size(W2V_LAYER)
         .window_size(W2V_WINDOW).negative_sample(K).batch_size(W2V_BATCH)
         .epochs(1).seed(1).iterate(sentences).build())
    t0 = time.perf_counter()
    fit_loss = m.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    sv = m._sv
    t0 = time.perf_counter()
    streams = m._token_streams()
    vocab = nlp.build_vocab(streams, 1)
    idx = [np.array([vocab.index_of(t) for t in s], np.int64)
           for s in streams]
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_batches = list(sv._sg_batches(idx, np.random.RandomState(1)))
    pairs_s = time.perf_counter() - t0
    c, x, negs = host_batches[0]
    batch_prof = rnn_profile(lambda: sv._sg_step(c, x, negs, 0.0), 1)
    n_batches = len(host_batches)
    fit = {"tokens": W2V_TOKENS, "vocab": len(m.vocab),
           "layer_size": W2V_LAYER, "window": W2V_WINDOW, "negative": K,
           "batch_size": W2V_BATCH, "batches": n_batches,
           "pairs": n_batches * W2V_BATCH, "mean_loss": fit_loss,
           "wall_s": fit_s, "tokens_per_s": W2V_TOKENS / fit_s,
           "setup_s": setup_s, "pair_generation_s": pairs_s,
           "device_steps_s": fit_s - setup_s - pairs_s,
           "host_share_setup": setup_s / fit_s,
           "host_share_pair_generation": pairs_s / fit_s,
           "device_ms_per_batch": batch_prof["device_ms"],
           "device_busy_share": batch_prof["device_ms"] * n_batches
           / (fit_s * 1e3),
           "ms_per_batch_by_class": batch_prof["ms_by_class"],
           "launches_per_batch": batch_prof["launches"]}
    del m, sv, host_batches
    # the planted two-topic corpus
    sg = (nlp.Word2Vec.builder().min_word_frequency(1).layer_size(32)
          .window_size(3).negative_sample(5).epochs(3).batch_size(512)
          .seed(42).iterate(topic_corpus(300)).build())
    sg.fit()
    cb = (nlp.Word2Vec.builder().min_word_frequency(1).layer_size(16)
          .window_size(3).use_cbow(True).epochs(2).batch_size(256).seed(1)
          .iterate(topic_corpus(150)).build())
    cb.fit()
    planted = {"skipgram_cat_dog": sg.similarity("cat", "dog"),
               "skipgram_cat_road": sg.similarity("cat", "road"),
               "skipgram_nearest_car": sg.words_nearest("car", 3),
               "cbow_cat_pet": cb.similarity("cat", "pet"),
               "cbow_cat_fuel": cb.similarity("cat", "fuel")}
    emit({"phase": "word2vec", "skipgram_op": op, "fit": fit,
          "planted": planted, "seconds": time.perf_counter() - t_phase})
    if not (round_err <= W2V_ROUND_ATOL and inputs_same
            and np.isfinite(loss)):
        raise RuntimeError(f"the skipgram op on the card: {op}")
    if not (np.isfinite(fit_loss) and fit["vocab"] > 0
            and fit["batches"] > 0):
        raise RuntimeError(f"Word2Vec.fit: {fit}")
    if not (planted["skipgram_cat_dog"] > planted["skipgram_cat_road"]
            and set(planted["skipgram_nearest_car"])
            <= {"road", "drive", "wheel", "fuel"}
            and planted["cbow_cat_pet"] > planted["cbow_cat_fuel"]):
        raise RuntimeError(f"the planted topics did not cluster: {planted}")
    torch.cuda.empty_cache()



# YOLO2 at its published width (reference YOLO2.java, the zoo's VOC
# configuration): 20 classes, 3x416x416, 5 anchors, a 125-channel 13x13
# head, bf16 body, the zoo's Adam(1e-3). YOLO_IMAGES seeded images at
# VOC's typical 375x500x3 (NHWC) are resized on the card through the
# port's resize_bilinear to 416x416, then laid out NCHW; labels are
# [B, 4 + 20, 13, 13] in the corner format, 1-4 boxes an image, each at
# the cell that holds its centre. fit at B=YOLO_B: one warm step, then
# YOLO_STEPS timed steps on the first batch repeated (a loss read each
# step), one step profiled
YOLO_B, YOLO_IMAGES, YOLO_STEPS = 32, 64, 10
YOLO_SRC_HW, YOLO_HW, YOLO_CLASSES, YOLO_GRID = (375, 500), 416, 20, 13
YOLO_MAX_BOXES = 4
# the trained network behind InferenceEngine(max_batch=YOLO_MAX_BATCH),
# warmed over its ladder: YOLO_REQUESTS requests of 1-YOLO_MAX_ROWS
# images, submitted together
YOLO_MAX_BATCH, YOLO_REQUESTS, YOLO_MAX_ROWS = 16, 32, 4
# an engine answer against output() on the same rows, relative to the
# largest head value: the engine batched the requests into other buckets
# than a direct call, so cuDNN may pick other algorithms and the bf16
# body rounds at other places (a bf16 ulp is 2**-8 of a value); the raw
# head is f32
YOLO_SERVE_RTOL = 5e-2
# an f32 copy of the trained weights: output() on the card against the
# CPU's on YOLO_F32_ROWS images, relative to the largest head value; f32
# summed in another order through 23 convolutions stays near 1e-5, TF32
# (switched on in the process; output() runs under full_f32()) would
# move it by ~1e-2
YOLO_F32_ROWS, YOLO_F32_RTOL = 2, 1e-3
# the detection, segmentation and depthwise-separable zoo at its default
# widths: (model, constructor arguments, batch); one warm step, then
# ZOO_STEPS timed steps on one seeded batch, one step profiled
ZOO_CNN = (
    ("Xception", dict(num_classes=1000, dtype="bfloat16"), 64),
    ("UNet", dict(base_filters=64), 4),
    ("NASNet", dict(num_classes=1000, num_blocks=4,
                    penultimate_filters=1056, dtype="bfloat16"), 32))
ZOO_STEPS = 3
TINY_YOLO_B = 32
# a CNN training step's kernels by group: PyTorch's own depthwise
# kernels first, then KERNEL_GROUPS
CNN_KERNEL_GROUPS = (("depthwise", ("depthwise",)),) + KERNEL_GROUPS


def grouped(by_name, groups=CNN_KERNEL_GROUPS):
    out = {}
    for k, v in by_name.items():
        g = kernel_group(k, groups)
        out[g] = out.get(g, 0.0) + v
    return out


def yolo_labels(rng, B, classes, grid, max_boxes=YOLO_MAX_BOXES):
    """[B, 4 + classes, grid, grid]: 1..max_boxes boxes an image, corners
    (x1, y1, x2, y2) in [0, 1] and a one-hot class, at the cell of the
    box's centre (a later box in the same cell replaces it)."""
    import numpy as np
    y = np.zeros((B, 4 + classes, grid, grid), np.float32)
    for b in range(B):
        for _ in range(rng.randint(1, max_boxes + 1)):
            w, h = rng.uniform(0.05, 0.5, 2)
            x1, y1 = rng.uniform(0, 1 - w), rng.uniform(0, 1 - h)
            cx = min(int((x1 + w / 2) * grid), grid - 1)
            cy = min(int((y1 + h / 2) * grid), grid - 1)
            y[b, :, cy, cx] = 0.0
            y[b, :4, cy, cx] = (x1, y1, x1 + w, y1 + h)
            y[b, 4 + rng.randint(classes), cy, cx] = 1.0
    return y


def train_record(net, ds, steps):
    """One warm step of ``net.fit`` on ``ds`` and one on the per-step
    path (each captures its signature), then ``steps`` timed steps on it
    (a loss read each step), then one step under the profiler:
    losses, samples/s, host ms a step, device ms a step by kernel group,
    the busy share and the peak memory."""
    import torch
    from deeplearning4j_tpu_torch.nn.listeners import CollectScoresListener
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    net.fit([ds], num_epochs=1)   # includes cuDNN's algorithm choice
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    # the per-step path (a listener) is a signature of its own: captured
    # before the timed steps
    net.set_listeners(CollectScoresListener())
    net.fit([ds], num_epochs=1)
    scores = CollectScoresListener()
    net.set_listeners(scores)
    t0 = time.perf_counter()
    net.fit([ds] * steps, num_epochs=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    net.set_listeners()
    counts = {}
    by_name = device_ms_by_kernel(lambda: net.fit([ds], num_epochs=1), 1,
                                  counts=counts)
    device_ms = sum(by_name.values())
    step_ms = wall * 1e3 / steps
    B = ds.features.shape[0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"B": B, "params": net.num_params(), "warm_step_s": warm_s,
            "losses": [float(v) for v in scores.scores],
            "step_ms": step_ms, "samples_per_s": steps * B / wall,
            "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / step_ms,
            "ms_per_step_by_group": grouped(by_name),
            "launches_per_step": counts.get("launches"),
            "top_kernels_ms_per_step": [[k[:80], v] for k, v in top],
            "max_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def check_losses(name, losses, steps, fall=True):
    import numpy as np
    if not (len(losses) == steps and np.isfinite(losses).all()):
        raise RuntimeError(f"{name}: losses not finite: {losses}")
    if fall and not losses[-1] < losses[0]:
        raise RuntimeError(f"{name}: the loss did not fall over {steps} "
                           f"steps on one batch: {losses}")


def phase_yolo2():
    """YOLO2 trained and served at full width (see YOLO_*)."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.common.environment import environment
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.learning import tree_map
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops import exec_op
    from deeplearning4j_tpu_torch.runtime.inference import InferenceEngine
    from deeplearning4j_tpu_torch.zoo import YOLO2
    rng = np.random.RandomState(13)
    h0, w0 = YOLO_SRC_HW
    src = torch.from_numpy(rng.rand(YOLO_IMAGES, h0, w0, 3)
                           .astype(np.float32)).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resized = exec_op("resize_bilinear", src, size=(YOLO_HW, YOLO_HW))
    images = resized.permute(0, 3, 1, 2).contiguous()
    torch.cuda.synchronize()
    resize_ms = (time.perf_counter() - t0) * 1e3
    resize_dev_ms = time_ms(lambda: exec_op("resize_bilinear", src,
                                            size=(YOLO_HW, YOLO_HW)),
                            iters=3, warm=1)
    if not (images.is_cuda and images.shape == (YOLO_IMAGES, 3, YOLO_HW,
                                                YOLO_HW)
            and bool(torch.isfinite(images).all())):
        raise RuntimeError(f"resize on the card gave {images.shape} on "
                           f"{images.device}")
    del src, resized
    labels = torch.from_numpy(yolo_labels(rng, YOLO_IMAGES, YOLO_CLASSES,
                                          YOLO_GRID)).cuda()
    zoo = YOLO2(num_classes=YOLO_CLASSES, input_shape=(3, YOLO_HW, YOLO_HW),
                dtype="bfloat16")
    net = zoo.init_model()
    head = net.conf.vertex_output_types()["detect_conv"]
    if head != (125, YOLO_GRID, YOLO_GRID):
        raise RuntimeError(f"YOLO2 head is {head}, not 125x13x13")
    batch = DataSet(images[:YOLO_B], labels[:YOLO_B])
    rec = {"phase": "yolo2", "dtype": "bfloat16", "updater": "Adam(1e-3)",
           "input": [3, YOLO_HW, YOLO_HW], "head": list(head),
           "source_images": [YOLO_IMAGES, h0, w0, 3],
           "resize_host_ms": resize_ms, "resize_device_ms": resize_dev_ms,
           "boxes": int((labels[:, :4].sum(1) > 0).sum())}
    rec.update(train_record(net, batch, YOLO_STEPS))
    # the loss head alone, forward and backward, on the step's output
    ylayer = net.conf.vertices["yolo"].layer
    out = net.output(images[:YOLO_B])[0].torch().float().requires_grad_(True)

    def loss_step():
        torch.autograd.grad(ylayer.compute_loss(labels[:YOLO_B], out), out)
    rec["loss_fwd_bwd_device_ms"] = time_ms(loss_step, iters=5, warm=1)
    emit({**rec, "part": "train"})
    check_losses("YOLO2", rec["losses"], YOLO_STEPS)
    # serving: the engine over its ladder, requests submitted together
    env = environment()
    eng = InferenceEngine(net, max_batch=YOLO_MAX_BATCH)
    t0 = time.perf_counter()
    warmed = eng.warmup(images[:1])
    warm_s = time.perf_counter() - t0
    reqs = []
    for _ in range(YOLO_REQUESTS):
        rows = int(rng.randint(1, YOLO_MAX_ROWS + 1))
        lo = int(rng.randint(0, YOLO_IMAGES - rows + 1))
        reqs.append((lo, rows))
    s0 = eng.stats()
    c0 = env.compile_count()
    t0 = time.perf_counter()
    futs = [eng.submit(images[lo:lo + rows]) for lo, rows in reqs]
    answers = [f.result()[0].numpy() for f in futs]
    wall = time.perf_counter() - t0
    census = env.compile_count() - c0
    s1 = eng.stats()
    eng.close()
    err = 0.0
    for (lo, rows), got in zip(reqs, answers):
        ref = net.output(images[lo:lo + rows])[0].numpy()
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise RuntimeError(f"engine answer {got.shape} for {rows} rows")
        err = max(err, float(np.abs(got - ref).max()
                             / max(float(np.abs(ref).max()), 1e-30)))
    rows_total = sum(r for _, r in reqs)
    rec_s = {"phase": "yolo2", "part": "serve", "max_batch": YOLO_MAX_BATCH,
             "warmed_buckets": warmed, "warmup_s": warm_s,
             "requests": len(reqs), "rows": rows_total, "wall_s": wall,
             "samples_per_s": rows_total / wall,
             "dispatches": s1["dispatches"] - s0["dispatches"],
             "census_after_warmup": census,
             "max_rel_err_vs_output": err, "rtol": YOLO_SERVE_RTOL}
    emit(rec_s)
    if census != 0 or err > YOLO_SERVE_RTOL:
        raise RuntimeError(f"YOLO2 serving: census {census} after warmup "
                           f"(want 0), answers off output() by {err} of "
                           f"the largest value (tol {YOLO_SERVE_RTOL})")
    # card against CPU: an f32 copy of the trained weights
    conf = YOLO2(num_classes=YOLO_CLASSES,
                 input_shape=(3, YOLO_HW, YOLO_HW)).build_conf()
    params = tree_map(torch.clone, net._params)
    f32 = ComputationGraph(conf, device="cuda").init(params=params)
    cpu = ComputationGraph(conf, device="cpu").init(
        params=tree_map(lambda v: v.cpu(), params))
    x = images[:YOLO_F32_ROWS]
    ref = cpu.output(x.cpu())[0].numpy()
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = f32.output(x)[0].numpy()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    f32_err = float(np.abs(got - ref).max()
                    / max(float(np.abs(ref).max()), 1e-30))
    emit({"phase": "yolo2", "part": "f32_vs_cpu", "rows": YOLO_F32_ROWS,
          "max_rel_err": f32_err, "rtol": YOLO_F32_RTOL,
          "head_max_abs": float(np.abs(ref).max())})
    if not f32_err <= YOLO_F32_RTOL:
        raise RuntimeError(f"f32 YOLO2 on the card differs from the CPU's "
                           f"by {f32_err} of the largest value (tol "
                           f"{YOLO_F32_RTOL})")
    del f32, cpu, params, net, images, labels, batch, out
    torch.cuda.empty_cache()
    return rec


def phase_zoo_cnn():
    """Xception, UNet and NASNet trained at their zoo widths, and
    TinyYOLO's output() at B=TINY_YOLO_B with fit refusing its head as
    the JAX package's does (see ZOO_CNN)."""
    import numpy as np
    import torch
    import deeplearning4j_tpu_torch.zoo as zoo
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    recs = []
    for name, kw, B in ZOO_CNN:
        model = getattr(zoo, name)(**kw)
        net = model.init_model()
        rng = np.random.RandomState(len(name))
        shape = (B,) + tuple(model.input_shape)
        x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()
        if name == "UNet":    # binary masks
            y = (torch.rand((B, 1) + shape[2:], device="cuda",
                            generator=torch.Generator("cuda").manual_seed(1))
                 > 0.5).float()
        else:
            y = torch.zeros((B, model.num_classes), device="cuda")
            y[torch.arange(B, device="cuda"), torch.from_numpy(
                rng.randint(0, model.num_classes, B)).cuda()] = 1.0
        rec = {"phase": "zoo_cnn", "model": name,
               "input": list(model.input_shape),
               "dtype": net.conf.dtype or "float32"}
        rec.update(train_record(net, DataSet(x, y), ZOO_STEPS))
        g = rec["ms_per_step_by_group"]
        rec["depthwise_share"] = g.get("depthwise", 0.0) \
            / rec["device_ms_per_step"]
        emit(rec)
        check_losses(name, rec["losses"], ZOO_STEPS, fall=False)
        recs.append(rec)
        del net, x, y
        torch.cuda.empty_cache()
    model = zoo.TinyYOLO(dtype="bfloat16")
    net = model.init_model()
    x = torch.from_numpy(np.random.RandomState(7).randn(
        TINY_YOLO_B, *model.input_shape).astype(np.float32)).cuda()
    out = net.output(x).torch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        net.output(x)
    torch.cuda.synchronize()
    out_ms = (time.perf_counter() - t0) * 1e3 / 3
    dev_ms = time_ms(lambda: net.output(x), iters=3, warm=1)
    refused = None
    try:
        net.fit(DataSet(x, torch.zeros((TINY_YOLO_B, 24, 13, 13),
                                       device="cuda")))
    except ValueError as e:
        refused = str(e)
    rec = {"phase": "zoo_cnn", "model": "TinyYOLO", "B": TINY_YOLO_B,
           "dtype": "bfloat16", "output_shape": list(out.shape),
           "output_host_ms": out_ms, "output_device_ms": dev_ms,
           "samples_per_s": TINY_YOLO_B * 1e3 / out_ms,
           "fit_refused": refused}
    emit(rec)
    if tuple(out.shape) != (TINY_YOLO_B, 125, 13, 13) or not bool(
            torch.isfinite(out).all()) or refused is None or \
            "output/loss layer" not in refused:
        raise RuntimeError(f"TinyYOLO: output {tuple(out.shape)}, fit "
                           f"refused with {refused!r}")
    del net, x, out
    torch.cuda.empty_cache()
    return recs + [rec]


# the ops of the convolution and image families on the card: each name
# once, from one seeded draw, against the same op on a CPU copy, at the
# CPU op tests' tolerances (sums 1e-5, selections 1e-6); input kinds:
# ("f", shape) normal, ("u", shape) uniform [0, 1), ("t", shape) small
# integers as floats (ties), ("b", shape) boxes, ("i", shape, hi) int32
_F, _U, _T, _B = "f", "u", "t", "b"
CARD_SUM, CARD_SEL = 1e-5, 1e-6
CARD_OPS = (
    ("conv1d", [(_F, (2, 3, 9)), (_F, (3, 3, 4)), (_F, (4,))],
     {"strides": 2}, CARD_SUM),
    ("conv3dnew", [(_F, (2, 2, 5, 6, 5)), (_F, (3, 3, 2, 2, 3))],
     {"strides": (2, 2, 1)}, CARD_SUM),
    ("conv3d", [(_F, (1, 5, 4, 5, 2)), (_F, (2, 3, 2, 2, 3))],
     {"padding": "VALID", "data_format": "NDHWC"}, CARD_SUM),
    ("depthwise_conv2d", [(_F, (2, 3, 7, 8)), (_F, (3, 3, 3, 2)),
                          (_F, (6,))], {"strides": (2, 2)}, CARD_SUM),
    ("sconv2d", [(_F, (2, 3, 7, 8)), (_F, (3, 3, 3, 2)), (_F, (1, 1, 6, 4)),
                 (_F, (4,))], {"strides": (2, 2)}, CARD_SUM),
    ("separable_conv2d", [(_F, (2, 8, 7, 3)), (_F, (3, 3, 3, 1)),
                          (_F, (1, 1, 3, 5))],
     {"padding": "VALID", "data_format": "NHWC"}, CARD_SUM),
    ("pointwise_conv2d", [(_F, (2, 3, 5, 5)), (_F, (1, 1, 3, 4))], {},
     CARD_SUM),
    ("deconv2d", [(_F, (2, 3, 4, 5)), (_F, (3, 3, 4, 3)), (_F, (4,))],
     {"strides": (2, 2), "padding": "SAME"}, CARD_SUM),
    ("deconv3d", [(_F, (1, 2, 3, 4, 3)), (_F, (2, 3, 2, 3, 2))],
     {"strides": (2, 1, 2)}, CARD_SUM),
    ("dilation2d", [(_F, (2, 7, 8, 3)), (_F, (3, 2, 3))],
     {"strides": (2, 2), "rates": (1, 2)}, CARD_SUM),
    ("maxpool3dnew", [(_F, (2, 2, 5, 6, 5))], {"kernel": (2, 2, 2)},
     CARD_SEL),
    ("maxpool3d", [(_F, (2, 2, 5, 6, 5))],
     {"kernel": (3, 3, 3), "strides": (2, 2, 2), "padding": "SAME"},
     CARD_SEL),
    ("avgpool3dnew", [(_F, (2, 2, 5, 6, 5))], {"kernel": (2, 2, 2)},
     CARD_SUM),
    ("avgpool3d", [(_F, (2, 2, 5, 6, 5))],
     {"kernel": (3, 3, 3), "strides": (2, 2, 2), "padding": "SAME",
      "include_pad": False}, CARD_SUM),
    ("max_pool_with_argmax", [(_T, (2, 6, 6, 3))],
     {"kernel": (2, 3), "strides": (2, 1)}, CARD_SEL),
    ("upsampling2d", [(_F, (2, 3, 3, 4))], {"factor_h": 2, "factor_w": 3},
     CARD_SEL),
    ("upsampling3d", [(_F, (1, 2, 2, 3, 2))], {"fd": 2, "fh": 1, "fw": 3},
     CARD_SEL),
    ("im2col", [(_F, (2, 3, 6, 7))],
     {"kh": 3, "kw": 2, "sh": 2, "sw": 1, "ph": 1, "pw": 0, "dh": 1,
      "dw": 2}, CARD_SEL),
    ("col2im", [(_F, (2, 3, 3, 2, 3, 5))],
     {"sh": 2, "sw": 1, "ph": 1, "pw": 0, "h": 6, "w": 7, "dh": 1, "dw": 2},
     CARD_SUM),
    ("extract_image_patches", [(_F, (2, 5, 5, 3))],
     {"ksizes": (2, 2), "strides": (1, 1), "rates": (1, 1),
      "padding": "SAME"}, CARD_SEL),
    ("rgb_to_yiq", [(_U, (2, 4, 5, 3))], {}, CARD_SUM),
    ("yiq_to_rgb", [(_U, (2, 4, 5, 3))], {}, CARD_SUM),
    ("rgb_to_yuv", [(_U, (2, 4, 5, 3))], {}, CARD_SUM),
    ("yuv_to_rgb", [(_U, (2, 4, 5, 3))], {}, CARD_SUM),
    ("rgb_to_grs", [(_U, (2, 4, 5, 3))], {}, CARD_SUM),
    ("rgb_to_hsv", [(_U, (2, 4, 5, 3))], {}, CARD_SEL),
    ("hsv_to_rgb", [(_U, (2, 4, 5, 3))], {}, CARD_SEL),
    ("adjust_contrast", [(_U, (2, 4, 5, 3))], {"factor": 1.7}, CARD_SUM),
    ("adjust_contrast_v2", [(_U, (4, 5, 3))], {"factor": 0.4}, CARD_SUM),
    ("adjust_saturation", [(_U, (2, 4, 5, 3))], {"factor": 0.6}, CARD_SUM),
    ("adjust_hue", [(_U, (2, 4, 5, 3))], {"delta": 0.3}, CARD_SUM),
    ("resize_bilinear", [(_F, (2, 9, 10, 3))], {"size": (4, 6)}, CARD_SUM),
    ("resize_nearest_neighbor", [(_F, (2, 4, 5, 3))],
     {"height": 7, "width": 9}, CARD_SEL),
    ("resize_bicubic", [(_F, (2, 4, 5, 3))], {"size": (7, 9)}, CARD_SUM),
    ("resize_area", [(_F, (2, 9, 10, 3))], {"size": (4, 6)}, CARD_SUM),
    ("image_resize", [(_F, (9, 10, 3))],
     {"size": (4, 6), "method": "lanczos3"}, CARD_SUM),
    ("resize_images", [(_F, (2, 4, 5, 3))],
     {"size": (7, 9), "method": "lanczos5"}, CARD_SUM),
    ("crop_and_resize", [(_F, (2, 6, 7, 3)), (_B, (3,)), ("i", (3,), 2),
                         (3, 4)], {}, CARD_SUM),
    ("non_max_suppression", [(_B, (9,)), (_T, (9,)), 4],
     {"iou_threshold": 0.3}, CARD_SEL),
    ("non_max_suppression_v3", [(_B, (7,)), (_T, (7,)), 9],
     {"iou_threshold": 0.5, "score_threshold": 0.5}, CARD_SEL),
    ("non_max_suppression_overlaps", [(_U, (8, 8)), (_T, (8,)), 3],
     {"overlap_threshold": 0.6}, CARD_SEL),
    ("draw_bounding_boxes", [(_F, (2, 6, 7, 3)), (_B, (2, 3)),
                             (_U, (3, 3))], {}, CARD_SEL),
    # one bp op of each family's module: the gradient ops autobp derives
    ("deconv2d_bp", [(_F, (2, 3, 4, 5)), (_F, (3, 3, 4, 3)), (_F, (4,)),
                     (_F, (2, 4, 8, 10))],
     {"strides": (2, 2), "padding": "SAME"}, CARD_SUM),
    ("avgpool3dnew_bp", [(_F, (2, 2, 5, 6, 5)), (_F, (2, 2, 2, 3, 2))],
     {"kernel": (2, 2, 2)}, CARD_SUM))

# the op tail (bitwise, compression, segment and its bp ops, linear
# algebra, the parity tail, strings, lists) and the keyword repairs, each
# name once, at the CPU op tests' tolerances (bits, integers and host
# values exactly, elementwise 1e-6, sums 1e-5, factorisations 1e-4); more
# input kinds: ("w", shape) int32 over the whole range, ("n", shape, lo,
# hi) small ints, ("s", shape) an int8 sign field, ("+", shape) uniform
# [0.5, 2), ("p", n, asym) symmetric positive definite plus asym times a
# non-symmetric draw, ("d", n) diagonally dominant, ("L", n, shape) a
# list of n normal draws; numpy arrays and Python values are constants
_W, _N, _S, _P, _SPD, _D, _L = "w", "n", "s", "+", "p", "d", "L"
CARD_EXACT, CARD_F32, CARD_FACTOR = 0.0, 1e-6, 1e-4
#: ids over [-2, 12) for 10 segments: negative and past-the-end ids
#: dropped, some segments empty
_SEG_IDS = np.random.RandomState(99).randint(-2, 12, 64).astype(np.int32)
_SEGMENTS = tuple(f"{p}segment_{r}" for p in ("", "unsorted_")
                  for r in ("sum", "max", "min", "prod", "mean")) + (
    "unsorted_segment_sqrt_n",)
_STRINGS = np.asarray([["a b  c", "hello world"], ["", "x,y z"]], object)
CARD_TAIL_OPS = tuple(
    [(n, [(_W, (64, 64)), (_W, (64, 64))], {}, CARD_EXACT)
     for n in ("bitwise_and", "bitwise_or", "bitwise_xor",
               "bits_hamming_distance")]
    + [("toggle_bits", [(_W, (64, 64))], {}, CARD_EXACT)]
    + [(n, [(_W, (64, 64)), (_N, (64, 64), -2, 35)], {}, CARD_EXACT)
       for n in ("shift_bits", "rshift_bits", "cyclic_shift_bits",
                 "cyclic_rshift_bits")]
    + [("encode_threshold", [(_F, (64, 64))], {"threshold": 0.5}, CARD_F32),
       ("encode_bitmap", [(_F, (64, 64))], {"threshold": 0.5}, CARD_F32),
       ("decode_threshold", [(_S, (64, 64))], {"threshold": 0.5}, CARD_F32),
       ("decode_bitmap", [(_S, (64, 64))], {"dtype": "float16"}, CARD_F32)]
    + [(n, [(_F, (64, 8)), _SEG_IDS], {"num_segments": 10}, CARD_SUM)
       for n in _SEGMENTS]
    + [(n + "_bp", [(_F, (64, 8)), _SEG_IDS, (_F, (10, 8))],
        {"num_segments": 10}, CARD_SUM) for n in _SEGMENTS]
    + [("cholesky", [(_SPD, 8, 0.3)], {}, CARD_FACTOR),
       ("qr", [(_F, (16, 8))], {}, CARD_FACTOR),
       ("svd", [(_F, (16, 8))], {}, CARD_FACTOR),
       ("matrix_inverse", [(_D, 8)], {}, CARD_SUM),
       ("matrix_determinant", [(_D, 8)], {}, CARD_SUM),
       ("log_matrix_determinant", [(_F, (8, 8))], {}, CARD_SUM),
       ("logdet", [(_SPD, 8, 0.3)], {}, CARD_FACTOR),
       ("eig", [(_F, (8, 8))], {}, CARD_FACTOR),
       ("self_adjoint_eig", [(_SPD, 8, 0.3)], {}, CARD_FACTOR),
       ("lu", [(_F, (8, 8))], {}, CARD_FACTOR),
       ("solve", [(_D, 8), (_F, (8, 3))], {}, CARD_SUM),
       ("triangular_solve", [(_D, 8), (_F, (8, 3))],
        {"lower": False, "adjoint": True}, CARD_SUM),
       ("lstsq", [(_F, (6, 10)), (_F, (6, 3))], {}, CARD_FACTOR),
       ("solve_ls", [(_F, (12, 5)), (_F, (12, 2))], {}, CARD_FACTOR),
       ("sqrtm", [(_SPD, 8, 0.0)], {}, CARD_FACTOR),
       ("cross_batched", [(_F, (16, 3)), (_F, (16, 3))], {}, CARD_F32),
       ("knn_mindistance", [(_F, (16, 3)), np.full(3, -0.5, np.float32),
                            np.full(3, 0.5, np.float32)], {}, CARD_F32)]
    + [("Assert", [np.ones(4, bool), (_F, (3,))], {}, CARD_EXACT),
       ("confusion_matrix", [np.asarray([0, 1, 5, -1, 2, 1, 2], np.int32),
                             np.asarray([0, 2, 1, 0, 2, 3, 2], np.int32)],
        {"num_classes": 3}, CARD_EXACT),
       ("fake_quant_with_min_max_vars", [(_F, (64, 64)), -1.0, 1.0], {},
        CARD_F32),
       ("fake_quant_with_min_max_vars_per_channel",
        [(_F, (64, 16)), np.linspace(-2, -0.5, 16).astype(np.float32),
         np.linspace(0.5, 2, 16).astype(np.float32)], {}, CARD_F32),
       ("compare_and_bitpack", [(_F, (16, 64)), 0.25], {}, CARD_EXACT),
       ("create_view", [(_F, (8, 8))], {}, CARD_EXACT),
       ("norm", [(_F, (64, 64))], {"mode": 0, "dims": [1]}, CARD_SUM),
       ("min_max_datatype", [(_S, (4,))], {"min_or_max": 1}, CARD_EXACT),
       ("broadcastgradientargs", [np.asarray([2, 1, 3]), np.asarray([4, 3])],
        {}, CARD_EXACT),
       ("deconv2d_tf", [np.asarray([2, 8, 8, 3], np.int32),
                        (_F, (3, 3, 3, 4)), (_F, (2, 4, 4, 4))],
        {"strides": (2, 2)}, CARD_SUM),
       ("conv2d_input_bp", [np.asarray([2, 3, 6, 6], np.int32),
                            (_F, (3, 3, 3, 4)), (_F, (2, 4, 6, 6))], {},
        CARD_SUM),
       ("ctc_beam", [(_F, (2, 6, 4)), np.asarray([6, 4], np.int32)],
        {"beam_width": 3, "top_paths": 2}, CARD_F32),
       ("print_variable", [(_F, (4,))], {"message": "ops_card: "},
        CARD_EXACT),
       ("barnes_symmetrized", [np.asarray([0, 2, 3, 5], np.int32),
                               np.asarray([1, 2, 0, 0, 1], np.int32),
                               (_P, (5,))], {}, CARD_F32),
       ("barnes_edge_forces", [(_P, (16, 16)), (_F, (16, 2))], {}, CARD_SUM),
       ("barnes_gains", [(_P, (16, 3)), (_F, (16, 3)), (_F, (16, 3))], {},
        CARD_F32),
       ("cell_contains", [(_F, (2,)), (_P, (2,)), (_F, (16, 2))], {},
        CARD_EXACT)]
    + [("split_string", [_STRINGS], {}, CARD_EXACT),
       ("compat_string_split", [_STRINGS], {"delimiter": ","}, CARD_EXACT),
       ("compat_sparse_to_dense", [np.asarray([[0, 1], [2, 0]]),
                                   np.asarray([3, 2]),
                                   np.asarray(["p", "q"], object), "-"], {},
        CARD_EXACT),
       ("hashcode", [(_F, (8, 8))], {}, CARD_EXACT)]
    + [("create_list", [], {}, CARD_EXACT),
       ("write_list", [(_L, 3, (4, 4)), (_F, (4, 4)), 4], {}, CARD_EXACT),
       ("read_list", [(_L, 3, (4, 4)), 1], {}, CARD_EXACT),
       ("pick_list", [(_L, 4, (4,)), (3, 1)], {}, CARD_EXACT),
       ("size_list", [(_L, 3, (2,))], {}, CARD_EXACT),
       ("scatter_list", [(_L, 2, (3,)), (0, 3), (_F, (2, 3))], {},
        CARD_EXACT),
       ("gather_list", [(_L, 4, (2,)), (3, 0, 3)], {}, CARD_EXACT),
       ("stack_list", [(_L, 3, (2, 2))], {}, CARD_EXACT),
       ("unstack_list", [(_F, (2, 3, 4))], {"axis": 1}, CARD_EXACT),
       ("split_list", [(_F, (6, 2)), (1, 3, 2)], {}, CARD_EXACT),
       ("clone_list", [(_L, 2, (3,))], {}, CARD_EXACT),
       ("delete_list", [(_L, 2, (3,))], {}, CARD_EXACT)]
    + [("gelu", [(_F, (64, 64))], {"approximate": False}, CARD_F32),
       ("cross", [(_F, (3, 16)), (_F, (3, 16))], {"axis": 0}, CARD_F32)])
CARD_OPS += CARD_TAIL_OPS
#: ops whose JAX result is a host value: held on the host, not on the card
CARD_HOST_OPS = ("split_string", "compat_string_split",
                 "compat_sparse_to_dense", "hashcode",
                 "broadcastgradientargs")


def card_input(rng, spec):
    import numpy as np
    if not isinstance(spec, list) and not (isinstance(spec, tuple)
                                           and isinstance(spec[0], str)):
        return spec   # a constant
    kind, shape = spec[0], spec[1]
    if kind == _F:
        return rng.randn(*shape).astype(np.float32)
    if kind == _U:
        return rng.uniform(0.0, 1.0, shape).astype(np.float32)
    if kind == _T:
        return rng.randint(0, 3, shape).astype(np.float32)
    if kind == _B:
        a, b = rng.uniform(0, 1, shape + (2,)), rng.uniform(0, 1, shape + (2,))
        return np.concatenate([np.minimum(a, b), np.maximum(a, b)],
                              -1).astype(np.float32)
    if kind == _W:
        return rng.randint(-2 ** 31, 2 ** 31 - 1, shape,
                           dtype=np.int64).astype(np.int32)
    if kind == _N:
        return rng.randint(spec[2], spec[3], shape).astype(np.int32)
    if kind == _S:
        return rng.randint(-1, 2, shape).astype(np.int8)
    if kind == _P:
        return rng.uniform(0.5, 2.0, shape).astype(np.float32)
    if kind == _SPD:
        a = rng.randn(shape, shape)
        return (a @ a.T + shape * np.eye(shape)
                + spec[2] * rng.randn(shape, shape)).astype(np.float32)
    if kind == _D:
        return (rng.randn(shape, shape) + 3 * np.eye(shape)).astype(
            np.float32)
    if kind == _L:
        return [rng.randn(*spec[2]).astype(np.float32)
                for _ in range(shape)]
    return rng.randint(0, spec[2], shape).astype(np.int32)


def card_args(a, device):
    """numpy arrays (not strings) as tensors on ``device``, inside lists
    too; everything else as it is."""
    import numpy as np
    import torch
    if isinstance(a, np.ndarray) and a.dtype != object:
        return torch.from_numpy(a).to(device)
    if isinstance(a, list):
        return [card_args(v, device) for v in a]
    return a


def beyond(got, ref, tol):
    """How far ``got`` is from ``ref`` past atol = rtol = ``tol`` (<= 0
    within), in float64 on the host."""
    import torch
    g = got.detach().cpu().to(torch.complex128 if got.is_complex()
                              else torch.float64)
    r = ref.detach().cpu().to(g.dtype)
    if g.numel() == 0:
        return 0.0
    return float(((g - r).abs() - tol * r.abs()).max())


def card_invariants(name, a, got, ref, tol):
    """For the factorisations that the libraries may give with other
    column signs or order: the largest excess over ``tol`` of the card's
    factors' reconstruction of ``a`` and of their sign-free parts against
    the CPU's."""
    import torch
    a = a.double()
    g = [t.detach().cpu() for t in got]
    r = [t.detach().cpu() for t in ref]
    if name == "qr":
        q, rr = g
        return max(beyond(q.double() @ rr.double(), a, tol),
                   beyond(rr.abs(), r[1].abs(), tol))
    if name == "svd":
        u, sv, vh = (t.double() for t in g)
        k = sv.shape[-1]
        return max(beyond(sv, r[1], tol),
                   beyond((u[:, :k] * sv) @ vh[:k], a, tol))
    if name == "self_adjoint_eig":
        w, v = (t.double() for t in g)
        sym = (a + a.T) / 2
        return max(beyond(w, r[0], tol), beyond(sym @ v, v * w, tol))
    w, v = (t.to(torch.complex128) for t in g)   # eig

    def order(x):
        return x[torch.argsort(x.real * 1e3 + x.imag)]
    return max(beyond(order(w), order(r[0].to(torch.complex128)), tol),
               beyond(a.to(torch.complex128) @ v, v * w, tol))


def phase_ops_card():
    """Each op name of the convolution and image slice and of the op tail
    (and one bp op of each family's module, every segment bp op) on the
    card and on a CPU copy of the same draw (see CARD_OPS): results on
    the card (host values, for CARD_HOST_OPS, equal on the host), dtypes
    and shapes equal, values within the CPU op tests' tolerances; the
    factorisations with free signs or order by their invariants."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.ops import exec_op

    def leaves(out):
        if isinstance(out, (tuple, list)):
            return [leaf for o in out for leaf in leaves(o)]
        return [out]

    rows, bad = [], []
    for i, (name, specs, kw, tol) in enumerate(CARD_OPS):
        rng = np.random.RandomState(i)
        args = [card_input(rng, s) for s in specs]
        cpu = [card_args(a, "cpu") for a in args]
        dev = [card_args(a, "cuda") for a in args]
        try:
            got = leaves(exec_op(name, *dev, **kw))
            ref = leaves(exec_op(name, *cpu, **kw))
            if len(got) != len(ref):
                raise RuntimeError(f"{len(got)} results against {len(ref)}")
            err = 0.0
            if name in CARD_HOST_OPS:
                for g, r in zip(got, ref):
                    if isinstance(g, torch.Tensor) or not np.array_equal(
                            np.asarray(g), np.asarray(r)):
                        raise RuntimeError(f"host value {g!r} against "
                                           f"{r!r}")
            else:
                for g, r in zip(got, ref):
                    if not isinstance(g, torch.Tensor) or not g.is_cuda \
                            or g.dtype != r.dtype or g.shape != r.shape:
                        raise RuntimeError(
                            f"{getattr(g, 'device', type(g))} "
                            f"{getattr(g, 'dtype', '')} "
                            f"{tuple(getattr(g, 'shape', ()))} against "
                            f"{r.dtype} {tuple(r.shape)}")
                if name in ("qr", "svd", "eig", "self_adjoint_eig"):
                    err = card_invariants(name, cpu[0], got, ref, tol)
                else:
                    err = max([beyond(g, r, tol) for g, r in zip(got, ref)],
                              default=0.0)
            ok = err <= tol
            rows.append([name, err, ok])
            if not ok:
                bad.append(f"{name}: off by {err} beyond rtol {tol}")
        except Exception as e:   # noqa: BLE001 (reported, then raised)
            rows.append([name, None, False])
            bad.append(f"{name}: {type(e).__name__}: {e}")
    tail = {r[0] for r in CARD_TAIL_OPS}
    emit({"phase": "ops_card", "ops": len(rows),
          "passed": sum(1 for r in rows if r[2]),
          "tail_ops": len(CARD_TAIL_OPS),
          "tail_passed": sum(1 for r in rows if r[2] and r[0] in tail),
          "worst_abs_err_beyond_rtol": max((r[1] for r in rows
                                         if r[1] is not None), default=None),
          "failures": bad})
    if bad:
        raise RuntimeError(f"ops on the card: {bad}")
    return rows


#: replays (and eager calls) an op in the opbench phase
OPBENCH_ITERS = 10
OPBENCH_OUT = os.path.join("opbench_out", "opbench_card.json")
OPBENCH_BASELINE = "OPBENCH_cpu_baseline.json"


def phase_opbench():
    """The whole-registry per-op sweep on the card at the JAX sweep's size
    (N = 512): every registered name benched, skipped or excluded; the
    names the JAX CPU sweep benched and the card did not, each with its
    reason; a name skipped on the card that its CPU copy benches fails
    the phase."""
    from deeplearning4j_tpu_torch.benchmarks.opbench import (op_us,
                                                             run_opbench,
                                                             summary)
    from deeplearning4j_tpu_torch.ops import registry
    t0 = time.perf_counter()
    out = run_opbench(n_iter=OPBENCH_ITERS, device="cuda")
    seconds = time.perf_counter() - t0
    os.makedirs(os.path.dirname(OPBENCH_OUT), exist_ok=True)
    with open(OPBENCH_OUT, "w") as f:
        json.dump(out, f, indent=1)
    for line in summary(out):
        print(line, flush=True)
    names = set(registry().names())
    unaccounted = sorted(names - set(out["results"]) - set(out["skipped"])
                         - set(out["excluded"]))
    cpu_benches = sorted(n for n in out["skipped"] if n in run_opbench(
        filter_name=n, n_iter=1, device="cpu")["results"])
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           OPBENCH_BASELINE)) as f:
        jax_names = set(json.load(f)["results"])
    not_on_card = {n: (out["skip_reasons"].get(n)
                       or ("excluded" if n in out["excluded"]
                           else "neither benched, skipped nor excluded"))
                   for n in sorted(jax_names - set(out["results"]))}
    slowest = sorted(out["results"].items(), key=lambda kv: -op_us(kv[1]))
    captured = [r for r in out["results"].values() if r["jit_us"]]
    by_category = {}
    for r in captured:
        lo, hi = by_category.get(r["category"], (r["jit_us"], r["jit_us"]))
        by_category[r["category"]] = (min(lo, r["jit_us"]),
                                      max(hi, r["jit_us"]))
    failure_kinds = {}
    for err in out["capture_failures"].values():
        kind = ("empty_graph" if err.startswith("EmptyGraph")
                else "cpu_cuda_copy" if "Cannot copy between CPU and CUDA"
                in err else "host_sync" if "capture" in err.lower()
                else "other")
        failure_kinds[kind] = failure_kinds.get(kind, 0) + 1
    def median(vals):
        return percentile(vals, 0.5) if vals else None

    emit({"phase": "opbench_totals", "captured": len(captured),
          "median_jit_us": median([r["jit_us"] for r in captured]),
          "median_eager_us_of_captured": median(
              [r["eager_us"] for r in captured]),
          "median_eager_over_jit": median(
              [r["eager_us"] / r["jit_us"] for r in captured]),
          "sum_jit_ms": round(sum(r["jit_us"] for r in captured) / 1e3, 3),
          "sum_eager_ms": round(sum(r["eager_us"] for r in
                                    out["results"].values()) / 1e3, 3),
          "jit_us_range_by_category": by_category,
          "capture_failure_kinds": failure_kinds})
    emit({"phase": "opbench", "n_iter": OPBENCH_ITERS,
          "seconds": round(seconds, 1), "device": out["device_name"],
          "nvidia_smi": out["nvidia_smi"], "n_benched": out["n_benched"],
          "n_skipped": len(out["skipped"]), "skipped": out["skip_reasons"],
          "n_excluded": len(out["excluded"]), "excluded": out["excluded"],
          "n_capture_failures": len(out["capture_failures"]),
          "capture_failures": out["capture_failures"],
          "slowest": [[n, r["jit_us"], r["eager_us"], r["category"]]
                      for n, r in slowest[:10]],
          "jax_cpu_benched": len(jax_names),
          "jax_benched_not_on_card": not_on_card,
          "unaccounted": unaccounted, "raised_on_card_only": cpu_benches,
          "json": OPBENCH_OUT})
    if unaccounted or cpu_benches:
        raise RuntimeError(f"opbench: unaccounted {unaccounted}, raised on "
                           f"the card only {cpu_benches}")
    return out



# -- the parallel phase -----------------------------------------------------

# BASELINE config 5 at config 2's width: ParallelWrapper over ResNet-50
# (bf16, Nesterovs, B=128) on a world-1 NCCL group, against fit
PAR_NCCL_STEPS = 10
# bf16 ResNet-50: the wrapper's batch-norm statistics merge through the
# group where fit takes torch.var, so the first loss may differ by a few
# bf16 ulps of an O(7) loss (0.0024 on an H100)
PAR_NCCL_FIRST_ATOL = 0.02
# the first update against fit's: in bf16 its direction is chaotic in
# the batch statistics' rounding (``--update-sensitivity``: scaling every
# batch-norm variance by 1 + 1e-7 in fit alone moves it by about its own
# length), its length is not, so config 5 holds the ratio of the first
# update's L2 norm (the momentum buffer after step 1, lr times the
# gradient) to fit's within this; a gradient at twice its scale reads 2.
# Later losses are reported, not held: at lr 0.1 on random labels they
# are chaotic (on an H100: up to 9.8 % of the loss at step 7)
PAR_UPDATE_NORM_RTOL = 0.1
# the world-2 ResNet-50 leg (f32) holds the first update's distance from
# fit's, over the length of fit's, both in L2: the sound path reads the
# batch statistics' rounding (0.018-0.019 on an H100), a
# gradient at twice its scale 1.0, per-rank batch statistics ~1.4
PAR_UPDATE_RTOL = 0.1
# the 2-rank legs: BERT-base at B=8, T=512 (sp=2: 256 positions a rank)
PAR_BERT_B, PAR_BERT_T, PAR_BERT_STEPS = 8, 512, 3
# tp=2 and pp=2 (6 layers a stage, 4 microbatches) at B=8, T=128
PAR_TP_B, PAR_TP_T, PAR_PP_MICRO = 8, 128, 4
# bf16 BERT: the sharded step rounds activations at other places (a
# row-parallel product summed over ranks after rounding, the ring's merge
# of per-block outputs); losses are O(10)
PAR_LOSS_ATOL = 0.03
PAR_GRAD_NORM_RTOL = 0.03
# the flash ring against full-sequence flash, bf16 outputs and grads:
# both merge in f32 and round once; a few bf16 ulps of the largest entry
PAR_RING_RTOL = 2e-2
# ResNet-50 at world 2 in f32 (TF32 off), its first step against fit's:
# the same products (cuDNN may pick other algorithms at 64 rows than at
# 128), the batch statistics merged over 2 ranks; per-rank statistics
# would move the first loss by ~1e-2 and the running statistics by
# ~1/sqrt(64) of their spread. The first update is held to
# PAR_UPDATE_RTOL, not tighter: it is ill-conditioned in the batch
# statistics' rounding (on the CPU at 64x64, B=32, merely summing the
# statistics' two halves apart in one process moves the update by 1.15 %
# in L2 and a beta by 5.7 %, what 2 ranks give to 4 digits); the later
# losses are reported (at Nesterovs lr 0.1 on random labels the loss
# jumps from 7.6 to ~9.4 a step)
PAR_RESNET_STEPS = 3
PAR_RESNET_FIRST_ATOL = 1e-4
PAR_RESNET_STATS_RTOL = 1e-3


def _flash_launches():
    return {n: f.launches for n, f in flash_counters().items()}


def _launch_delta(before):
    return {n: f.launches - before[n] for n, f in flash_counters().items()}


def _sync_ms(t0):
    import torch
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _grad_norm(grads):
    import torch
    from deeplearning4j_tpu_torch.models import _optim
    return float(torch.sqrt(sum(g.float().pow(2).sum()
                                for g in _optim.tree_leaves(grads))))


def par_bert_sp(rank):
    """BERT-base, sp=2, flash ring: loss and global gradient norm of one
    step against the single-process step, then 3 steps against 3."""
    import torch
    from deeplearning4j_tpu_torch.common.mesh import MeshConfig, make_mesh
    from deeplearning4j_tpu_torch.models import _optim, bert
    from deeplearning4j_tpu_torch.parallel import collectives as C
    cfg = bert.BertConfig.base()
    mesh = make_mesh(MeshConfig(seq=2), device="cuda")
    full = bert.init_params(cfg, seed=11, device="cuda")
    batch = bert_batch(cfg, PAR_BERT_B, PAR_BERT_T, seed=12)
    placed = bert.place_params(clone_tree(full), cfg, mesh)
    specs = bert._specs_of(placed)
    shard = bert._Shard(mesh, True)
    seen = {}

    def objective(p, b):
        part, seen["loss"] = bert._sharded_objective(
            p, b, cfg, mesh, True, True, specs=specs)
        return part
    _, grads = _optim.value_and_grad(objective, placed, batch)
    gnorm = _grad_norm(shard.reduce_grads(grads, specs))
    del grads
    rec = {"grad_norm": gnorm, "first_loss": float(seen["loss"]),
           "transport": C.transport(mesh.group("seq"), "cuda")}
    opt = bert.init_opt_state(placed)
    step = bert.make_train_step(cfg, mesh, learning_rate=1e-4,
                                seq_parallel=True, use_flash=True)
    before = _flash_launches()
    t0 = time.perf_counter()
    losses = [float(step(placed, opt, batch, i)[2])
              for i in range(PAR_BERT_STEPS)]
    rec["step_ms"] = _sync_ms(t0) / PAR_BERT_STEPS
    rec["launches"] = _launch_delta(before)
    rec["launches_per_step"] = {n: c / PAR_BERT_STEPS
                                for n, c in rec["launches"].items()}
    rec["losses"] = losses
    del placed, opt
    if rank == 0:
        _, g = _optim.value_and_grad(
            lambda p, b: bert.mlm_loss(p, b, cfg, use_flash=True), full,
            batch)
        rec["grad_norm_single"] = _grad_norm(g)
        del g
        ref = clone_tree(full)
        ropt = bert.init_opt_state(ref)
        rstep = bert.make_train_step(cfg, learning_rate=1e-4, remat=False,
                                     use_flash=True)
        t0 = time.perf_counter()
        # kept eager, as the mesh step it is held against (a rank
        # process sharing the card holds no graph pool)
        rec["losses_single"] = [float(rstep(ref, ropt, batch, i,
                                            eager="reference")[2])
                                for i in range(PAR_BERT_STEPS)]
        rec["step_ms_single"] = _sync_ms(t0) / PAR_BERT_STEPS
        del ref, ropt
    del full
    torch.cuda.empty_cache()
    return rec


def par_ring(rank):
    """The flash ring alone at BERT-base's heads, causal and not, batch
    row 0 with no live key, against full-sequence ``flash_attention``."""
    import torch
    from deeplearning4j_tpu_torch.common.mesh import MeshConfig, make_mesh
    from deeplearning4j_tpu_torch.kernels import flash_attention
    from deeplearning4j_tpu_torch.parallel import collectives as C
    from deeplearning4j_tpu_torch.parallel.ring_attention import \
        ring_attention
    mesh = make_mesh(MeshConfig(seq=2), device="cuda")
    B, T = PAR_BERT_B, PAR_BERT_T
    g = torch.Generator(device="cuda").manual_seed(21)
    q, k, v, do = (torch.randn((B, T, FLASH_H, FLASH_D), generator=g,
                               device="cuda", dtype=torch.bfloat16)
                   for _ in range(4))
    do[0] = 0        # the dead row's cotangent: its full-sequence softmax
    mask = torch.ones((B, T), dtype=torch.int32, device="cuda")
    mask[0] = 0      # is uniform where the ring's is empty
    out = []
    for causal in (False, True):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        before = _flash_launches()
        t0 = time.perf_counter()
        o = ring_attention(*ts, mesh, mask=mask, causal=causal,
                           use_flash=True)
        ((o.float() * do.float()).sum() / mesh.size).backward()
        grads = [C.all_reduce_raw(t.grad, "seq", mesh) for t in ts]
        rec = {"causal": causal, "ms": _sync_ms(t0),
               "launches": _launch_delta(before),
               "dead_row_zero": bool((o[0] == 0).all())}
        if rank == 0:
            rs = [t.clone().requires_grad_(True) for t in (q, k, v)]
            ref = flash_attention(*rs, mask=mask, causal=causal)
            ref_g = torch.autograd.grad(ref, rs, do)
            rec["rel_err"] = {
                n: float((a[1:].detach().float() - b[1:].detach().float())
                         .abs().max() / b[1:].detach().float().abs().max())
                for n, a, b in zip(("o", "dq", "dk", "dv"),
                                   [o.detach()] + grads,
                                   [ref] + list(ref_g))}
        out.append(rec)
    return out


def par_tp_pp(rank, ckpt_dir):
    """One tp=2 step and one pp=2 1F1B step of BERT-base against the
    single-process loss; then the tp=2 state saved on 2 ranks, restored
    onto a 1-rank mesh and stepped there."""
    import torch
    from deeplearning4j_tpu_torch.common.mesh import (MeshConfig,
                                                       gather_tree,
                                                       global_rank,
                                                       make_mesh)
    from deeplearning4j_tpu_torch.models import bert
    from deeplearning4j_tpu_torch.nn.checkpoint import ShardedCheckpointer
    cfg = bert.BertConfig.base()
    full = bert.init_params(cfg, seed=31, device="cuda")
    batch = bert_batch(cfg, PAR_TP_B, PAR_TP_T, seed=32)
    del batch["attention_mask"]          # the pipeline's stages take none
    ref_loss = None
    if rank == 0:
        ref = clone_tree(full)
        ref_loss = float(bert.make_train_step(cfg, remat=False)(
            ref, bert.init_opt_state(ref), batch, 0, eager="reference")[2])
        del ref
    recs = {}
    mesh = make_mesh(MeshConfig(tensor=2), device="cuda")
    p = bert.place_params(clone_tree(full), cfg, mesh)
    o = bert.init_opt_state(p)
    t0 = time.perf_counter()
    loss = float(bert.make_train_step(cfg, mesh)(p, o, batch, 0)[2])
    recs["tp"] = {"loss": loss, "step_ms": _sync_ms(t0),
                  "loss_single": ref_loss}
    ck = ShardedCheckpointer(ckpt_dir)
    ck.save_tree(1, {"params": p, "opt": o})
    saved = {"params": gather_tree(p), "opt": gather_tree(o)}
    del p, o
    mesh_pp = make_mesh(MeshConfig(pipe=2), device="cuda")
    pp = bert.place_pipeline_params(bert.to_pipeline_params(
        clone_tree(full), 2), mesh_pp)
    t0 = time.perf_counter()
    loss = float(bert.make_pipeline_train_step(
        cfg, mesh_pp, PAR_PP_MICRO)(pp, bert.init_opt_state(pp), batch,
                                     0)[2])
    recs["pp"] = {"loss": loss, "step_ms": _sync_ms(t0),
                  "loss_single": ref_loss, "schedule": "1f1b",
                  "layers_per_stage": cfg.num_layers // 2,
                  "microbatches": PAR_PP_MICRO}
    del pp
    # every rank builds the 1-rank mesh; rank 0 restores and steps
    mesh1 = make_mesh(MeshConfig(), devices=[0], device="cuda")
    if global_rank() == 0:
        target = {"params": bert.place_params(
            bert.init_params(cfg, seed=99, device="cuda"), cfg, mesh1)}
        target["opt"] = bert.init_opt_state(target["params"])
        state = ck.restore_tree(1, target=target)
        t0 = time.perf_counter()
        loss = float(bert.make_train_step(cfg, mesh1)(
            state["params"], state["opt"], batch, 0)[2])
        ms = _sync_ms(t0)
        ref_restored = float(bert.make_train_step(cfg, remat=False)(
            saved["params"], saved["opt"], batch, 0, eager="reference")[2])
        recs["restore"] = {"saved_on": 2, "restored_on": 1, "loss": loss,
                           "loss_single": ref_restored, "step_ms": ms}
    del saved, full
    torch.cuda.empty_cache()
    return recs


def _snapshot(net):
    """Every param leaf, running statistics apart: (stats, weights)."""
    stats, weights = {}, {}
    for n, p in net._params.items():
        for k, v in p.items():
            (stats if k.startswith("state_") else weights)[(n, k)] = \
                v.detach().clone()
    return stats, weights


def _state_leaves(net):
    """The updater state's leaves, f32 copies (after a first Nesterovs
    step, the momentum: lr times the gradient)."""
    from deeplearning4j_tpu_torch.models import _optim
    return [t.detach().float().clone()
            for t in _optim.tree_leaves(net.get_updater_state())]


def _norm(leaves):
    return sum(float((t ** 2).sum()) for t in leaves) ** 0.5


def _rel_l2(got, want):
    """|got - want| / |want| over lists of tensors, in L2."""
    return _norm([a - b for a, b in zip(got, want)]) / _norm(want)


def update_sensitivity_main():
    """``chip_smoke.py --update-sensitivity``: how far ``fit``'s first
    update on ResNet-50 (64x64, B=16, Nesterovs lr 0.1, random labels,
    TF32 off) moves when every batch-norm variance is scaled by
    1 + 1e-7, in f32 and bf16, beside a repeat with nothing changed: the
    distance from the first run's update over its length, and the ratio
    of the lengths (updates read from the momentum after step 1). The
    parallel phase's update checks are set against these."""
    phase_device()
    import torch
    from deeplearning4j_tpu_torch.nn.conf.layers import BatchNormalization
    from deeplearning4j_tpu_torch.zoo import ResNet50
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shape = (3, 64, 64)
    batch = zoo_batches(np.random.RandomState(7), 1, 16, shape, 10)
    stats = BatchNormalization._batch_stats
    out = {}
    try:
        for dtype in ("float32", "bfloat16"):
            zoo = ResNet50(num_classes=10, input_shape=shape, dtype=dtype)
            runs = {}
            for name, scale in (("base", 1.0), ("repeat", 1.0),
                                ("var_times_1_plus_1e-7", 1 + 1e-7)):
                def scaled(xf, scale=scale):
                    axis, mean, var = stats(xf)
                    return axis, mean, var * scale
                BatchNormalization._batch_stats = staticmethod(scaled)
                net = zoo.init_model()
                net.fit(batch)
                runs[name] = _state_leaves(net)
            base = runs.pop("base")
            out[dtype] = {n: {"rel_l2": _rel_l2(r, base),
                              "norm_ratio": _norm(r) / _norm(base)}
                          for n, r in runs.items()}
    finally:
        BatchNormalization._batch_stats = staticmethod(stats)
    emit({"phase": "update_sensitivity", **out})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def _update_rel_err(got, want, start):
    """|got - want| / |want - start| over every weight, in L2: how far a
    step's update is from the reference step's."""
    num = sum(float(((got[k].float() - want[k].float()) ** 2).sum())
              for k in start)
    den = sum(float(((want[k].float() - start[k].float()) ** 2).sum())
              for k in start)
    return (num / den) ** 0.5


def _max_rel_err(got, want):
    return max(float((got[key] - want[key]).abs().max()
                     / want[key].abs().max().clamp_min(1e-12))
               for key in want)


def par_resnet(rank):
    """ResNet-50 in f32 at world 2 (64 rows a rank) through
    ParallelWrapper against fit on the same global batches: the losses,
    and the running statistics and weights after the first step."""
    import torch
    from deeplearning4j_tpu_torch.common.mesh import MeshConfig, make_mesh
    from deeplearning4j_tpu_torch.nn.listeners import CollectScoresListener
    from deeplearning4j_tpu_torch.parallel.trainer import ParallelWrapper
    from deeplearning4j_tpu_torch.zoo import ResNet50
    zoo = ResNet50(num_classes=RESNET_CLASSES, input_shape=RESNET_SHAPE)
    batches = zoo_batches(np.random.RandomState(5), PAR_RESNET_STEPS,
                          RESNET_B, RESNET_SHAPE, RESNET_CLASSES)
    net = zoo.init_model()
    _, w0 = _snapshot(net)
    scores = CollectScoresListener()
    net.set_listeners(scores)
    wrapper = ParallelWrapper(net, make_mesh(MeshConfig(data=2),
                                             device="cuda"),
                              prefetch_buffer=0)
    t0 = time.perf_counter()
    wrapper.fit(batches[:1])
    first_stats, first_weights = _snapshot(net)
    wrapper.fit(batches[1:])
    rec = {"losses": [float(v) for v in scores.scores],
           "step_ms": _sync_ms(t0) / PAR_RESNET_STEPS}
    if rank == 0:
        ref = zoo.init_model()
        rs = CollectScoresListener()
        ref.set_listeners(rs)
        t0 = time.perf_counter()
        ref.fit(batches[:1])
        ref_stats, ref_weights = _snapshot(ref)
        ref.fit(batches[1:])
        rec["step_ms_single"] = _sync_ms(t0) / PAR_RESNET_STEPS
        rec["losses_single"] = [float(v) for v in rs.scores]
        rec["first_step_running_stats_max_rel_err"] = _max_rel_err(
            first_stats, ref_stats)
        rec["first_step_weights_max_rel_err"] = _max_rel_err(
            first_weights, ref_weights)
        rec["first_step_update_rel_l2_err"] = _update_rel_err(
            first_weights, ref_weights, w0)
        rec["running_stats"] = len(ref_stats)
        del ref
    del net, batches
    torch.cuda.empty_cache()
    return rec


def par_rank_legs(ckpt_dir):
    """Every 2-rank leg, in one spawn (CUDA starts once a rank)."""
    import torch
    from deeplearning4j_tpu_torch.common.mesh import global_rank
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = global_rank()
    return {"rank": rank, "bert_sp": par_bert_sp(rank),
            "ring": par_ring(rank), "tp_pp": par_tp_pp(rank, ckpt_dir),
            "resnet": par_resnet(rank)}


def par_nccl():
    """BASELINE config 5 at world 1 over NCCL, in a rank process of its
    own (NCCL never starts in the script's process, whose profiler
    windows the kernel readings need): ParallelWrapper against fit,
    ResNet-50 bf16, B=128, the same batches and weights."""
    import torch
    from deeplearning4j_tpu_torch.common.mesh import MeshConfig, make_mesh
    from deeplearning4j_tpu_torch.nn.listeners import CollectScoresListener
    from deeplearning4j_tpu_torch.parallel import collectives as C
    from deeplearning4j_tpu_torch.parallel.trainer import ParallelWrapper
    from deeplearning4j_tpu_torch.zoo import ResNet50
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    zoo = ResNet50(num_classes=RESNET_CLASSES, input_shape=RESNET_SHAPE,
                   dtype="bfloat16")
    batches = zoo_batches(np.random.RandomState(7), PAR_NCCL_STEPS,
                          RESNET_B, RESNET_SHAPE, RESNET_CLASSES)
    # the same seeded init twice: the same weights
    ref, net = zoo.init_model(), zoo.init_model()
    mesh = make_mesh(MeshConfig(), device="cuda")
    n0 = sum(n for (op, b), n in C.issued.items() if b == "nccl")
    scores = CollectScoresListener()
    net.set_listeners(scores)
    wrapper = ParallelWrapper(net, mesh, prefetch_buffer=0)
    wrapper.fit(batches[:1])            # cuDNN's algorithm choice
    m1 = _state_leaves(net)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wrapper.fit(batches[1:])
    wall = _sync_ms(t0) / 1e3
    nccl = {op: n for (op, b), n in C.issued.items() if b == "nccl"}
    transport = C.transport(mesh.group("data"), "cuda")
    rs = CollectScoresListener()
    ref.set_listeners(rs)
    ref.fit(batches[:1])
    m_ref = _state_leaves(ref)
    update = {"first_step_update_norm_ratio": _norm(m1) / _norm(m_ref),
              "first_step_update_rel_l2_err": _rel_l2(m1, m_ref)}
    del m1, m_ref
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref.fit(batches[1:])
    wall_ref = _sync_ms(t0) / 1e3
    got = [float(v) for v in scores.scores]
    want = [float(v) for v in rs.scores]
    return {"phase": "parallel_nccl", "model": "resnet50", "B": RESNET_B,
            "dtype": "bfloat16", "steps": PAR_NCCL_STEPS, "world": 1,
            "transport": transport, "losses_parallel_wrapper": got,
            "losses_fit": want,
            "max_loss_diff": max(abs(a - b) for a, b in zip(got, want)),
            "first_loss_atol": PAR_NCCL_FIRST_ATOL, **update,
            "update_norm_rtol": PAR_UPDATE_NORM_RTOL,
            "samples_per_s_parallel_wrapper":
                (PAR_NCCL_STEPS - 1) * RESNET_B / wall,
            "samples_per_s_fit":
                (PAR_NCCL_STEPS - 1) * RESNET_B / wall_ref,
            "nccl_all_reduces": nccl.get("all_reduce", 0),
            "nccl_collectives": nccl}


def check_nccl(rec):
    got, want = rec["losses_parallel_wrapper"], rec["losses_fit"]
    if len(got) != PAR_NCCL_STEPS or not np.all(np.isfinite(got)):
        raise RuntimeError(f"parallel_nccl: losses {got}")
    ratio = rec["first_step_update_norm_ratio"]
    if abs(got[0] - want[0]) > PAR_NCCL_FIRST_ATOL or \
            abs(ratio - 1.0) > PAR_UPDATE_NORM_RTOL:
        raise RuntimeError(
            f"parallel_nccl: ParallelWrapper {got} vs fit {want}, the "
            f"first update {ratio} times fit's length")
    if rec["nccl_all_reduces"] < 1 or rec["transport"] != "nccl":
        raise RuntimeError(f"parallel_nccl: {rec['nccl_all_reduces']} "
                           f"NCCL all-reduces over {rec['transport']}")


def phase_parallel():
    """The parallel phase (module docstring). Returns the flash launches
    of the sp=2 leg's 3 steps, both ranks summed."""
    import tempfile
    import torch
    from deeplearning4j_tpu_torch.parallel.launch import RankPool
    t_start = time.perf_counter()
    with RankPool(1, "cuda", timeout=900) as pool:    # NCCL, world 1
        rec = pool.run("chip_smoke:par_nccl")[0]
    emit(rec)
    check_nccl(rec)
    with tempfile.TemporaryDirectory(prefix="dl4j_par_") as td:
        with RankPool(2, "cuda", timeout=900) as pool:
            spawn_s = time.perf_counter()
            out = pool.run("chip_smoke:par_rank_legs", td)
            spawn_s = time.perf_counter() - spawn_s
    r0, r1 = out
    sp = r0["bert_sp"]
    launches = {n: r0["bert_sp"]["launches"][n] + r1["bert_sp"]["launches"][n]
                for n in r0["bert_sp"]["launches"]}
    emit({"phase": "parallel_ring", "model": "bert-base", "B": PAR_BERT_B,
          "T": PAR_BERT_T, "sp": 2, "positions_per_rank": PAR_BERT_T // 2,
          "ranks": 2, "backend": "gloo", "transport": sp["transport"],
          "losses": sp["losses"], "losses_single": sp["losses_single"],
          "max_loss_diff": max(abs(a - b) for a, b in
                               zip(sp["losses"], sp["losses_single"])),
          "first_loss": sp["first_loss"],
          "grad_norm": sp["grad_norm"],
          "grad_norm_single": sp["grad_norm_single"],
          "grad_norm_rel_diff": abs(sp["grad_norm"] - sp["grad_norm_single"])
          / sp["grad_norm_single"],
          "step_ms": sp["step_ms"], "step_ms_single": sp["step_ms_single"],
          "flash_launches_per_rank_step": {
              "rank0": r0["bert_sp"]["launches_per_step"],
              "rank1": r1["bert_sp"]["launches_per_step"]},
          "ring_alone": [{**a, "launches_rank1": b["launches"]}
                         for a, b in zip(r0["ring"], r1["ring"])],
          "spawn_and_legs_s": spawn_s})
    tpp = r0["tp_pp"]
    res = r0["resnet"]
    emit({"phase": "parallel_legs", "ranks": 2, "transport": sp["transport"],
          "tp": tpp["tp"], "pp": tpp["pp"], "restore": tpp["restore"],
          "resnet50_world2": {**res, "losses_rank1": r1["resnet"]["losses"],
                              "dtype": "float32",
                              "rows_per_rank": RESNET_B // 2,
                              "max_loss_diff": max(
                                  abs(a - b) for a, b in
                                  zip(res["losses"], res["losses_single"]))},
          "seconds": time.perf_counter() - t_start})
    fails = []
    if max(abs(a - b) for a, b in zip(sp["losses"], sp["losses_single"])) \
            > PAR_LOSS_ATOL:
        fails.append("sp=2 losses")
    if abs(sp["grad_norm"] - sp["grad_norm_single"]) > \
            PAR_GRAD_NORM_RTOL * sp["grad_norm_single"]:
        fails.append("sp=2 grad norm")
    for n, c in launches.items():
        if c < 1:
            fails.append(f"{n} never launched on the sp=2 leg")
    for rec in r0["ring"]:
        if not rec["dead_row_zero"] or max(rec["rel_err"].values()) > \
                PAR_RING_RTOL:
            fails.append(f"ring causal={rec['causal']}")
    for leg in ("tp", "pp", "restore"):
        if abs(tpp[leg]["loss"] - tpp[leg]["loss_single"]) > PAR_LOSS_ATOL:
            fails.append(f"{leg} loss")
    if abs(res["losses"][0] - res["losses_single"][0]) > \
            PAR_RESNET_FIRST_ATOL or \
            res["first_step_running_stats_max_rel_err"] > \
            PAR_RESNET_STATS_RTOL or \
            res["first_step_update_rel_l2_err"] > PAR_UPDATE_RTOL:
        fails.append("resnet50 world 2")
    if fails:
        raise RuntimeError(f"parallel phase failed: {fails}")
    torch.cuda.empty_cache()
    return launches

# -- sharded serving (the sharded_serve phase) -------------------------------

# Teacher-forced logits of the full-width CausalLM at model=2 (6 of 12
# heads a rank, 2 gloo ranks on cuda:0) against one process over the same
# weights, bf16: each layer's wo and w2 products reach the residual as two
# partial sums, each rounded to bf16 by its rank's einsum, summed in f32
# through host memory and rounded once more, where one process rounds the
# whole contraction once: about one extra bf16 ulp (2**-8 relative) a
# layer output, through 12 layers and the tied head. On an H100 the
# reading is 0.03125 (one bf16 ulp of a logit in [4, 8)) with and without
# the biases below; the limit is about 2.5x that, and bo and b2 added
# twice read 0.78125. Greedy tokens can flip where the top two logits sit
# closer than that, so the bf16 runs report token agreement; the f32 run
# at depth 2 holds it
SHARD_LOGIT_ATOL = 0.08
# std of the random biases the leg's models get (the init's are 0): a rank
# that adds bo or b2 before the all-reduce adds it twice, which zero biases
# would hide. The same logits with bo and b2 doubled in one process are
# what that fault gives the leader; the leg holds them beyond the limit
SHARD_BIAS_STD = 0.05
# decode steps teacher-forced after the prompt's prefill
SHARD_FORCED = 16
# the rig's requests: serve-phase prompts (17, 100, 500 and 256 + 200
# tokens, all greedy), SHARD_TOKENS new tokens each; the world-1 leg
# serves every greedy prompt of the serve phase
SHARD_PICKS, SHARD_TOKENS = (0, 3, 7, 13), 32
SHARD_F32_LAYERS = 2
# the spec leg's self-draft (the first layers of the model) and its k
SHARD_DRAFT_LAYERS, SHARD_K = 2, 4
# sharded predict (the MLP twin and its bf16 network): params stored over
# model=2 and gathered at use, the batch whole on both ranks: the
# reference's tolerance against the unsharded engine
SHARD_PREDICT_RTOL, SHARD_PREDICT_ATOL = 1e-5, 1e-6
SHARD_PREDICT_ROWS = (1, 8, MLP_B)


def with_biases(model, seed):
    """``model`` with every layer's biases drawn at SHARD_BIAS_STD."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    for layer in model.params["layers"]:
        for group in (layer["attn"], layer["mlp"]):
            for k, v in group.items():
                if k.startswith("b"):
                    group[k] = (SHARD_BIAS_STD * torch.randn(
                        v.shape, generator=g, device="cuda")).to(v.dtype)
    return model


def _biases_twice(params):
    """``params`` with bo and b2 doubled: what a rank of two adding them
    before the all-reduce gives."""
    layers = []
    for layer in params["layers"]:
        layer = dict(layer, attn=dict(layer["attn"]), mlp=dict(layer["mlp"]))
        layer["attn"]["bo"] = 2 * layer["attn"]["bo"]
        layer["mlp"]["b2"] = 2 * layer["mlp"]["b2"]
        layers.append(layer)
    return dict(params, layers=layers)


def _all_reduces():
    from deeplearning4j_tpu_torch.parallel import collectives as C
    return sum(n for (op, _), n in C.issued.items() if op == "all_reduce")


def _run_greedy(engine, prompts, max_tokens, together=True):
    """Greedy tokens of each prompt (all submitted at once, or one after
    another) and the wall seconds."""
    import torch
    t0 = time.perf_counter()
    if together:
        futs = [engine.generate(p, max_tokens=max_tokens) for p in prompts]
        toks = [f.result(timeout=600)["tokens"] for f in futs]
    else:
        toks = [engine.generate(p, max_tokens=max_tokens)
                .result(timeout=600)["tokens"] for p in prompts]
    torch.cuda.synchronize()
    return toks, time.perf_counter() - t0


def _delta(before, after):
    """The step counts of an engine's stats between two readings."""
    return {k: after[k] - before[k] for k in (
        "decode_steps", "prefill_dispatches", "spec_steps")}


def _rate(toks, wall, stats):
    """Tokens/s of a run and its wall over its decode steps (the spec
    steps among them; the prefills' time included)."""
    n = sum(len(t) for t in toks)
    return {"tokens": n, "wall_s": wall, "tokens_per_s": n / wall,
            "step_ms": 1e3 * wall / max(stats["decode_steps"], 1),
            "decode_steps": stats["decode_steps"],
            "prefill_dispatches": stats["prefill_dispatches"],
            "spec_steps": stats["spec_steps"]}


def shard_world1():
    """The world-1 NCCL leg, in a rank process of its own: the full-width
    CausalLM deployed with ``mesh=serving_mesh()`` behind a
    ``ModelServer``, every greedy prompt of the serve phase over HTTP
    one after another, against a direct unsharded engine serving them
    alike; then both engines' tokens/s with every greedy prompt at
    once."""
    import torch
    from deeplearning4j_tpu_torch.common.mesh import serving_mesh
    from deeplearning4j_tpu_torch.models.causal_lm import (CausalLM,
                                                           CausalLMConfig)
    from deeplearning4j_tpu_torch.parallel import collectives as C
    from deeplearning4j_tpu_torch.runtime.generation import DecodeEngine
    from deeplearning4j_tpu_torch.serving import ModelRegistry, ModelServer
    torch.backends.cuda.matmul.allow_tf32 = False
    model = CausalLM(CausalLMConfig(), seed=0, device="cuda")
    prompts, sampling = serve_prompts(model.config.vocab_size)
    greedy = [p for p, kw in zip(prompts, sampling) if not kw]
    kw = dict(slots=SLOTS, max_ctx=MAX_CTX, kv_block_size=BS)
    ref = DecodeEngine(model, device="cuda", **kw)
    try:
        ref.warmup()        # as the registry warms the deployed engine
        want, _ = _run_greedy(ref, greedy, SHARD_TOKENS, together=False)
        s0 = ref.stats()
        toks, wall = _run_greedy(ref, greedy, SHARD_TOKENS)
        ref_rate = _rate(toks, wall, _delta(s0, ref.stats()))
    finally:
        ref.close(60)
    reg = ModelRegistry(manifest_dir=None)
    mesh = serving_mesh(device="cuda")
    t0 = time.perf_counter()
    mv = reg.deploy("lm", "v1", model, mesh=mesh, decode_slots=SLOTS,
                    decode_max_ctx=MAX_CTX, decode_kv_block_size=BS)
    deploy_s = time.perf_counter() - t0
    srv = ModelServer(reg)
    port = srv.start()
    base = f"http://127.0.0.1:{port}"
    try:
        got = []
        for p in greedy:
            status, doc, _, _ = http_generate(base, p, {},
                                              max_tokens=SHARD_TOKENS)
            if status != 200:
                raise RuntimeError(f"sharded generate: {status} {doc}")
            got.append(doc["tokens"])
        import urllib.request
        with urllib.request.urlopen(f"{base}/v1/models", timeout=60) as r:
            listed = json.loads(r.read())["models"]["lm"]["versions"][0]
        eng = mv.engine
        s0 = eng.stats()
        toks, wall = _run_greedy(eng, greedy, SHARD_TOKENS)
        s1 = eng.stats()
        rate = _rate(toks, wall, _delta(s0, s1))
        caches = sorted({g["cache"] for g in s1["graphs"]})
    finally:
        srv.stop()
        reg.drain_all(60, save_manifests=False)
    return {"transport": C.transport(mesh.group("model"), "cuda"),
            "requests": len(greedy), "tokens_identical":
                sum(a == b for a, b in zip(got, want)),
            "mesh_shape": listed.get("mesh_shape"),
            "param_spec": listed.get("param_spec"),
            "deploy_with_warmup_s": deploy_s,
            "graph_caches": caches,
            "sharded": rate, "unsharded": ref_rate,
            "collectives": {f"{op}/{b}": n for (op, b), n in
                            C.issued.items()}}


def shard_forced(model, mesh, prompt, lead):
    """Teacher-forced logits (the prompt's prefill, then SHARD_FORCED
    decode steps on fixed tokens) through this rank's shard of the params
    and the pool on every rank, and on the leader through the whole ones:
    the largest logit difference and the argmax agreement."""
    import torch
    from deeplearning4j_tpu_torch.runtime import sharded

    def run(params, cache):
        T = len(prompt)
        ids = torch.as_tensor(prompt, device="cuda")[None]
        tables = torch.arange(1, MB + 1, dtype=torch.int32,
                              device="cuda")[None]
        lengths = torch.tensor([T], dtype=torch.int32, device="cuda")
        cache, lg = model.paged_prefill(params, cache, ids, tables, lengths,
                                        torch.zeros_like(lengths))
        outs = [lg]
        forced = torch.as_tensor(np.random.RandomState(5).randint(
            0, model.config.vocab_size, (SHARD_FORCED, 1, 1)), device="cuda",
            dtype=torch.int32)
        for j in range(SHARD_FORCED):
            cache, lg = model.paged_decode(params, cache, tables, forced[j],
                                           lengths + j)
            outs.append(lg[:, 0])
        return torch.cat(outs).float()
    with torch.no_grad():
        got = run(sharded.place_causal_lm(mesh, model.params),
                  sharded.shard_kv_pool(mesh, model.init_paged_kv_cache(
                      MB + 1, BS)))
        if not lead:
            return {}
        want = run(model.params, model.init_paged_kv_cache(MB + 1, BS))
        fault = run(_biases_twice(model.params),
                    model.init_paged_kv_cache(MB + 1, BS))
    return {"positions": int(got.shape[0]),
            "max_abs_logit_diff": (got - want).abs().max().item(),
            "argmax_agreement":
                (got.argmax(-1) == want.argmax(-1)).float().mean().item(),
            "atol": SHARD_LOGIT_ATOL, "bias_std": SHARD_BIAS_STD,
            "bias_twice_max_abs_logit_diff":
                (fault - want).abs().max().item()}


def shard_predict(lead):
    """The MLP (bf16 over its f32 params) and its int8 twin through
    ``InferenceEngine(mesh=serving_mesh())`` on both ranks, against the
    unsharded engine on the leader."""
    import copy
    import torch
    from deeplearning4j_tpu_torch.common.mesh import serving_mesh
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.quant import quantize_model
    from deeplearning4j_tpu_torch.quant.transforms import \
        _fused_dequant_matmul
    from deeplearning4j_tpu_torch.runtime.inference import InferenceEngine
    full = mlp_network()
    bf16 = MultiLayerNetwork(copy.copy(full.conf), device="cuda")
    bf16.conf.dtype = "bfloat16"
    bf16.init(params=full._params)
    twin = quantize_model(full, device="cuda")
    xs = [np.random.RandomState(n).randn(n, MLP_IN).astype(np.float32)
          for n in SHARD_PREDICT_ROWS]
    mesh = serving_mesh(device="cuda")
    out = {}
    for name, net in (("bf16", bf16), ("int8", twin)):
        n0 = _fused_dequant_matmul.launches
        eng = InferenceEngine(net, mesh=mesh, max_batch=MLP_B)
        if not lead:
            out[name] = {"joined": eng.join(300),
                         "dequant_launches": _fused_dequant_matmul.launches
                         - n0}
            continue
        got = [eng.infer(x).numpy() for x in xs]
        stats = eng.stats()
        eng.close(60)
        launches = _fused_dequant_matmul.launches - n0
        # every dense layer of the twin through the kernel, a dispatch
        expected = (MLP_HIDDEN_LAYERS + 1) * stats["dispatches"] \
            if name == "int8" else 0
        ref = InferenceEngine(net, max_batch=MLP_B)
        want = [ref.infer(x).numpy() for x in xs]
        ref.close(60)
        out[name] = {
            "rows": list(SHARD_PREDICT_ROWS), "dequant_launches": launches,
            "dequant_launches_expected": expected,
            "max_abs_err": max(float(np.abs(g - w).max())
                               for g, w in zip(got, want)),
            "within_tolerance": all(np.allclose(
                g, w, rtol=SHARD_PREDICT_RTOL, atol=SHARD_PREDICT_ATOL)
                for g, w in zip(got, want)),
            "argmax_identical": all((g.argmax(-1) == w.argmax(-1)).all()
                                    for g, w in zip(got, want)),
            "mesh_shape": stats["mesh_shape"],
            "param_spec": stats["param_spec"],
            "graph_caches": sorted({g["cache"] for g in stats["graphs"]})}
    return out


def shard_tp2():
    """The 2-rank leg, on every rank (gloo, ``cuda:0`` shared): the
    teacher-forced logits, then the main path (the bf16 engine, the same
    with the spec phase's 2-layer draft at k = 4, the int8 twin; every
    launch count set to 0 just before), then on the leader the same
    engines unsharded, the f32 depth-2 pair and sharded predict."""
    import torch
    from deeplearning4j_tpu_torch.common.mesh import (global_rank,
                                                      serving_mesh)
    from deeplearning4j_tpu_torch.kernels import paged_flash_decode
    from deeplearning4j_tpu_torch.models.causal_lm import (CausalLM,
                                                           CausalLMConfig)
    from deeplearning4j_tpu_torch.parallel import collectives as C
    from deeplearning4j_tpu_torch.quant.transforms import (
        _fused_dequant_matmul, quantize_model)
    from deeplearning4j_tpu_torch.runtime import sharded
    from deeplearning4j_tpu_torch.runtime.generation import DecodeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    lead = global_rank() == 0
    model = with_biases(CausalLM(CausalLMConfig(), seed=0, device="cuda"),
                        seed=2)
    twin = quantize_model(model, device="cuda")
    draft = CausalLM(CausalLMConfig(num_layers=SHARD_DRAFT_LAYERS),
                     params={"embeddings": model.params["embeddings"],
                             "layers":
                                 model.params["layers"][:SHARD_DRAFT_LAYERS]},
                     device="cuda")
    prompts, _ = serve_prompts(model.config.vocab_size)
    picks = [prompts[i] for i in SHARD_PICKS]
    mesh = serving_mesh(device="cuda")
    kw = dict(slots=SLOTS, max_ctx=MAX_CTX, kv_block_size=BS, device="cuda")
    legs = (("bf16", model, {}),
            ("spec", model, {"draft_model": draft, "spec_k": SHARD_K}),
            ("int8", twin, {}))
    out = {"rank": global_rank(),
           "transport": C.transport(mesh.group("model"), "cuda"),
           "forced": shard_forced(model, mesh, picks[2], lead), "runs": {}}
    # the main path: every launch count starts at 0 here
    paged_flash_decode.launches = 0
    _fused_dequant_matmul.launches = 0
    for name, m, extra in legs:
        a0 = _all_reduces()
        eng = DecodeEngine(m, mesh=mesh, **kw, **extra)
        rec = {"pool_bytes_per_rank": sharded.pool_bytes(eng._cache)}
        if lead:
            toks, wall = _run_greedy(eng, picks, SHARD_TOKENS)
            s = eng.stats()
            eng.close(120)
            rec.update(_rate(toks, wall, s), tokens_list=toks,
                       all_reduces=_all_reduces() - a0,
                       mesh_shape=s["mesh_shape"],
                       param_spec=s["param_spec"],
                       graph_caches=sorted({g["cache"]
                                            for g in s["graphs"]}))
            steps = s["prefill_dispatches"] + s["decode_steps"]
            rec["all_reduces_per_step"] = rec["all_reduces"] / steps \
                if name != "spec" else None
        else:
            try:
                eng.generate(picks[0], max_tokens=1)
            except RuntimeError as e:
                rec["refused"] = str(e)
            rec["joined"] = eng.join(600)
            rec["graph_caches"] = sorted({g["cache"]
                                          for g in eng.stats()["graphs"]})
        out["runs"][name] = rec
    out["launches"] = {"paged_flash_decode": paged_flash_decode.launches,
                       "dequant_matmul": _fused_dequant_matmul.launches}
    if lead:
        for name, m, extra in legs:
            eng = DecodeEngine(m, **kw, **extra)
            rec = out["runs"][name]
            rec["pool_bytes_unsharded"] = sharded.pool_bytes(eng._cache)
            try:
                eng.warmup()    # its steps captured before the timed run
                toks, wall = _run_greedy(eng, picks, SHARD_TOKENS)
                rec["unsharded"] = _rate(toks, wall, eng.stats())
            finally:
                eng.close(120)
            rec["token_agreement"] = float(np.mean(
                [a == b for x, y in zip(rec.pop("tokens_list"), toks)
                 for a, b in zip(x, y)]))
    # f32 at depth 2: identical greedy tokens, requests one at a time
    f32 = with_biases(CausalLM(CausalLMConfig(num_layers=SHARD_F32_LAYERS,
                                              dtype=torch.float32), seed=1,
                               device="cuda"), seed=3)
    eng = DecodeEngine(f32, mesh=mesh, **kw)
    if lead:
        got, _ = _run_greedy(eng, picks, SHARD_TOKENS, together=False)
        eng.close(120)
        ref = DecodeEngine(f32, **kw)
        want, _ = _run_greedy(ref, picks, SHARD_TOKENS, together=False)
        ref.close(120)
        out["f32"] = {"layers": SHARD_F32_LAYERS,
                      "tokens_identical": sum(a == b for a, b in
                                              zip(got, want)),
                      "requests": len(picks)}
    else:
        out["f32"] = {"joined": eng.join(600)}
    out["predict"] = shard_predict(lead)
    return out


def shard_expected_launches(runs):
    """Each rank's serving-kernel launches on the 2-rank leg's main path,
    from the leader's step counts: the paged read once a layer and
    decode step, the spec steps' draft k + 1 times a draft layer besides;
    the dequant kernel twice a layer (w1, w2) and prefill or decode step
    of the int8 twin."""
    bf16, spec, int8 = runs["bf16"], runs["spec"], runs["int8"]
    return {"paged_flash_decode":
                L_FULL * (bf16["decode_steps"] + spec["decode_steps"]
                          + int8["decode_steps"])
                + SHARD_DRAFT_LAYERS * (SHARD_K + 1) * spec["spec_steps"],
            "dequant_matmul":
                2 * L_FULL * (int8["prefill_dispatches"]
                              + int8["decode_steps"])}


def phase_sharded_serve():
    """The sharded_serve phase (module docstring). Returns the serving
    kernels' launches on its main path, both ranks summed."""
    import torch
    from deeplearning4j_tpu_torch.parallel.launch import RankPool
    t0 = time.perf_counter()
    with RankPool(1, "cuda", timeout=900) as pool:    # NCCL, world 1
        w1 = pool.run("chip_smoke:shard_world1")[0]
    emit({"phase": "sharded_serve_world1", "model": "causal_lm 768x12",
          **w1, "seconds": time.perf_counter() - t0})
    t1 = time.perf_counter()
    with RankPool(2, "cuda", timeout=900) as pool:
        r0, r1 = pool.run("chip_smoke:shard_tp2")
    launches = {k: r0["launches"][k] + r1["launches"][k]
                for k in r0["launches"]}
    emit({"phase": "sharded_serve", "ranks": 2, "model_parallel": 2,
          "heads_per_rank": L_FULL // 2, "transport": r0["transport"],
          "forced": r0["forced"], "runs": r0["runs"],
          "follower": {"runs": r1["runs"], "f32": r1["f32"],
                       "predict": r1["predict"]},
          "f32": r0["f32"], "predict": r0["predict"],
          "launches_by_rank": [r0["launches"], r1["launches"]],
          "launches_expected": shard_expected_launches(r0["runs"]),
          "seconds": time.perf_counter() - t1})
    fails = []
    if w1["tokens_identical"] != w1["requests"]:
        fails.append("world-1 tokens")
    if w1["mesh_shape"] != {"data": 1, "model": 1} or \
            w1["param_spec"] != "auto(model)" or w1["transport"] != "nccl":
        fails.append("world-1 listing")
    # a one-rank mesh issues no collective: its steps are captured; the
    # gloo legs' steps stay eager, and say why
    if w1["graph_caches"] != ["captured"]:
        fails.append(f"world-1 graphs {w1['graph_caches']}")
    for r in (r0, r1):
        for name, rec in list(r["runs"].items()) + list(
                r["predict"].items()):
            if rec.get("graph_caches", ["eager:gloo"]) != ["eager:gloo"]:
                fails.append(f"rank {r['rank']} {name} graphs "
                             f"{rec['graph_caches']}")
    if not r0["forced"]["max_abs_logit_diff"] <= SHARD_LOGIT_ATOL:
        fails.append("teacher-forced logits")
    if not r0["forced"]["bias_twice_max_abs_logit_diff"] > SHARD_LOGIT_ATOL:
        fails.append("the logit limit would not see bo and b2 added twice")
    for name, rec in r0["runs"].items():
        if rec["pool_bytes_per_rank"] * 2 != rec["pool_bytes_unsharded"]:
            fails.append(f"{name} pool bytes")
        if rec["all_reduces_per_step"] not in (None, 2 * L_FULL):
            fails.append(f"{name} all-reduces a step")
        if rec["mesh_shape"] != {"data": 1, "model": 2}:
            fails.append(f"{name} mesh_shape")
        f = r1["runs"][name]
        if not f["joined"] or "follower" not in f.get("refused", ""):
            fails.append(f"{name} follower")
    if r0["f32"]["tokens_identical"] != r0["f32"]["requests"]:
        fails.append("f32 tokens")
    for name, rec in r0["predict"].items():
        if not (rec["within_tolerance"] and rec["argmax_identical"]):
            fails.append(f"predict {name}")
        if not r1["predict"][name]["joined"]:
            fails.append(f"predict {name} follower")
    for name, rec in r0["predict"].items():
        want = rec["dequant_launches_expected"]
        if rec["dequant_launches"] != want or \
                r1["predict"][name]["dequant_launches"] != want:
            fails.append(f"predict {name} dequant launches "
                         f"{rec['dequant_launches']} / "
                         f"{r1['predict'][name]['dequant_launches']} "
                         f"against {want}")
    want = shard_expected_launches(r0["runs"])
    for r in (r0, r1):
        if r["launches"] != want:
            fails.append(f"rank {r['rank']} launches {r['launches']} "
                         f"against {want}")
    if fails:
        raise RuntimeError(f"sharded_serve phase failed: {fails}")
    torch.cuda.empty_cache()
    return launches


def free_card():
    """Hand the allocator's cached blocks back to the card between
    phases (a closed engine has let go of its graphs, and a dropped
    network of its own)."""
    import torch
    torch.cuda.empty_cache()


def main():
    if sys.argv[1:] == ["--http-clients"]:
        return http_clients_main()
    if sys.argv[1:] == ["--warm-replica"]:
        return warm_replica_main()
    if sys.argv[1:] == ["--update-sensitivity"]:
        return update_sensitivity_main()
    if sys.argv[1:2] == ["--profiler-check"]:
        return profiler_check_main(*map(float, sys.argv[2:4]))
    t_start = time.perf_counter()
    phase_device()
    # this run's artifact store (kernel libraries, serving manifests): a
    # directory of its own, removed at exit
    if "DL4J_TPU_CACHE_DIR" not in os.environ:
        import atexit
        import shutil
        import tempfile
        store = tempfile.mkdtemp(prefix="dl4j-cache-")
        os.environ["DL4J_TPU_CACHE_DIR"] = store
        atexit.register(shutil.rmtree, store, True)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    logging.getLogger("deeplearning4j_tpu_torch.runtime.cuda_graphs") \
        .addHandler(EmptyGraphLog())
    import torch
    # f32 comparisons run in full f32 (no TF32 in matmuls or convolutions)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from deeplearning4j_tpu_torch.kernels import paged_flash_decode
    from deeplearning4j_tpu_torch.models.causal_lm import (CausalLM,
                                                           CausalLMConfig)
    from deeplearning4j_tpu_torch.quant.transforms import \
        _fused_dequant_matmul
    phase_build()
    errs = phase_parity()
    model = CausalLM(CausalLMConfig(), seed=0, device="cuda")
    # the main path: every launch count starts at 0 here
    paged_flash_decode.launches = 0
    _fused_dequant_matmul.launches = 0
    prompts, sampling, greedy = phase_serve(model)
    twin = phase_int8(model, prompts)
    phase_spec(model, prompts, greedy)
    launches = {"paged_flash_decode": paged_flash_decode.launches,
                "dequant_matmul": _fused_dequant_matmul.launches}
    for name, n in launches.items():
        if n < 1:
            raise RuntimeError(f"kernel {name} was never launched on the "
                               "main path")
    phase_warm_restart(model, twin)
    free_card()
    http_launches = phase_serve_http(model, prompts, sampling, greedy)
    fp8_shapes = phase_fp8(model, prompts)
    free_card()
    phase_checks(model, twin)
    phase_step(model, twin)
    graph_runs = phase_graphs(model, twin, prompts, sampling)[0]
    graph_launches = {k: sum(r["launches"][k] for r in graph_runs.values())
                      for k in ("paged_flash_decode", "dequant_matmul")}
    free_card()
    train_launches, train_run = phase_train()
    launches.update(train_launches)
    phase_train_step(train_run)
    del train_run
    free_card()
    phase_bert_forward()
    phase_causal(model)
    phase_lenet()
    phase_data()
    free_card()
    phase_graphs_train()
    mlp_launches, mlp_twin = phase_mlp_int8()
    predict_launches, predict_twin, mlp_f32, mlp_pool = phase_predict_http()
    phase_fleet(mlp_f32, mlp_pool)
    del mlp_f32, mlp_pool
    free_card()
    resnet, images, resnet_rec = phase_resnet50()
    phase_transfer(resnet, images, resnet_rec)
    resnet_launches, resnet_twin = phase_resnet50_int8(resnet, images)
    if resnet_launches < 1:
        raise RuntimeError("kernel dequant_matmul was never launched on "
                           "resnet50_int8's main path")
    del resnet, images
    free_card()
    qa_graph, qa_batches = phase_samediff_bert()
    phase_precision(qa_graph, qa_batches)
    del qa_graph, qa_batches
    free_card()
    phase_modelimport()
    free_card()
    phase_keras_import()
    free_card()
    phase_seq2seq()
    phase_text_lstm()
    phase_word2vec()
    free_card()
    phase_yolo2()
    phase_zoo_cnn()
    phase_ops_card()
    free_card()
    phase_opbench()
    free_card()
    emit({"phase": "host_profile", **HOST_PROFILES})
    emit({"phase": "empty_graphs", "captures": EMPTY_GRAPHS})
    rows, shapes = phase_kernels(twin, launches, errs)
    for row in rows:
        row["launches_graphs"] = graph_launches[row["name"]]
        row["launches_serve_http"] = http_launches["requests"][row["name"]]
        row["launches_serve_http_deploys"] = \
            http_launches["deploys"][row["name"]]
    rows += mlp_kernel_rows(mlp_twin, mlp_launches, errs)
    rows += mlp_kernel_rows(predict_twin, predict_launches, errs,
                            Ms=PREDICT_ROW_MS, main_path="predict_http")
    rows += resnet_head_rows(resnet_twin, resnet_launches, errs)
    for row in rows:
        if row["name"] == "dequant_matmul":
            row["launches_predict_http"] = predict_launches
    flash, flash_shapes = flash_rows(launches, errs)
    shard_rows = sharded_kernel_rows(twin)
    # the parallel and sharded_serve phases run after every profiler
    # reading of this process (their rank processes share the card), the
    # card's memory freed
    del twin, mlp_twin, predict_twin, resnet_twin
    free_card()
    parallel_launches = phase_parallel()
    shard_launches = phase_sharded_serve()
    for row in shard_rows:
        row["launches"] = shard_launches[row["name"]]
    ring_B, ring_T = FLASH_SHAPES[-1]
    for row in flash:
        row["launches_parallel"] = parallel_launches[row["name"]]
        block = next(r for r in flash_shapes if r["name"] == row["name"]
                     and (r["B"], r["T"]) == (ring_B, ring_T))
        row["ring_block"] = {k: block[k] for k in
                             ("B", "T", "ms", "bound_ms", "bound_by",
                              "plain_ms", "library_ms")}
    emit({"phase": "kernel_shapes",
          "shapes": shapes + flash_shapes + fp8_shapes})
    emit({"kernels": flash + rows + shard_rows})
    emit({"phase": "done", "seconds": round(time.perf_counter() - t_start,
                                            1),
          "profiler_retakes": PROFILER_RETAKES,
          "profiler_lead_in": LEAD_IN[0]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
