#!/usr/bin/env python3
"""Drive torcheval_tpu_torch's eval-loop main path on one NVIDIA GPU.

Run from the root of a checkout with no arguments:

    python3 chip_smoke.py [--seed N]

It builds the CUDA kernels from ``torcheval_tpu_torch/ops/csrc/`` (one
``nvcc`` per source, into ``build/torcheval_tpu_torch/``), then runs these
phases, printing one JSON line for each:

1. ``classify``: an ImageNet-1k validation-scale stream (50,000 samples of
   1,000-class float32 logits in batches of 1,024) through
   ``toolkit.update_collection`` into micro and macro ``MulticlassAccuracy``
   and macro ``MulticlassF1Score``, with ``Mean`` over the batch loss and
   ``Throughput``; checked against a float64 oracle.
2. ``ctr_auc``: a Criteo 1TB evaluation-scale click stream (the 89,137,319
   samples MLPerf's DLRM-DCNv2 benchmark scores with AUC) in batches of
   65,536 through ``StreamingBinaryAUROC`` and ``StreamingBinaryAUPRC``
   (8192 bins, bounds (0, 1), unit weights), plus a 4-task weighted stream
   of 2^22 samples; the histograms are checked against a float64 oracle,
   the fused-AUC kernel must have launched once per update.
3. ``kernel_vs_plain``: the kernel wrapper against its plain PyTorch
   version on the same CUDA tensors, over sizes, task counts, score
   distributions, weights, bounds, NaN and empty inputs and bin counts, and
   what the kernel's float4 loads and cluster layout could break: scores
   one element off a 16-byte boundary, labels and weights broadcast over
   tasks, rows of 1 and 3 samples, 2 and 1,000 bins, every launch design
   forced at shapes where the wrapper would pick another, and the
   dispatcher op ``K1_OP`` that the streaming update launches through.
   Bitwise equal on unit weights, within rtol 1e-5 with mass conserved on
   random weights.
4. ``sync``: four ``LocalReplicaGroup`` replicas on the card, each fed a
   quarter of smaller classify and click streams; the synced results must
   equal single-stream metrics bitwise. The sync is timed three times,
   each after the card's queue has drained.
5. ``curve``: the exact curve family over growable buffers. The Criteo
   stream of phase 2 feeds ``BinaryAUROC``, ``BinaryAUPRC`` and
   ``BinaryAUROC(use_fused=True)``; the exact values are held to float64
   oracles built apart from their cumsum/trapezoid chain (Mann-Whitney over
   mid-ranks, step-wise average precision) within ``CURVE_TOL``, and the
   fused value, whose compute launches K1 once, equals the plain histogram
   AUROC of the same buffers bitwise. An ImageNet-1k validation stream of
   softmax scores feeds ``MulticlassAUROC`` and ``MulticlassAUPRC``, each
   class held to the same oracles. Each compute's wall and device time,
   its costliest kernels, the buffers' bytes and the peak allocation are
   reported, with the reverse cummin timed in one and two levels, and the
   ``use_fused`` compute's histogram timed as K1, its plain version and one
   ``torch.bincount``.
6. ``mp_sync``: two spawned ranks, one process each, joined by gloo over a
   ``FileStore``, metric state on the card: each feeds its half of phase
   4's stream to that collection plus exact ``BinaryAUROC``/``BinaryAUPRC``
   and syncs over ``MultiHostGroup``. Every synced value and state equals
   one process's stream bitwise (the loss mean within 1e-6), a subgroup of
   rank 1 leaves rank 0 untouched, and the sync is timed three times from a
   drained queue.
7. ``counters``: the counter families at published scales, each held to
   an int64/float64 oracle. ImageNet-1k validation (50,000 x 1,000, batches
   of 1,024): ``MulticlassConfusionMatrix`` bitwise, ``MulticlassPrecision``
   and ``MulticlassRecall`` at every average within 1e-6, the multiclass
   binned precision-recall curve in both ``optimization`` modes (bitwise
   equal to each other and to exact counts), ``MulticlassBinnedAUROC`` and
   ``MulticlassBinnedAUPRC``. The Criteo stream of phase 2: the binary
   binned curve and AUPRC (counters within the float32 accumulation
   bound), ``HistogramBinnedAUROC`` at 100 and 2^20 thresholds (histograms
   bitwise, AUROC within 1e-6), ``BinaryBinnedAUROC`` over the first 2^22
   samples and ``StreamingBinaryAUROC`` beside them, K1 once an update.
   OpenImages V6 validation (41,620 x 600, about two labels an image):
   ``MultilabelAccuracy`` under every criterion, ``TopKMultilabelAccuracy``
   at k = 5 with its ``topk`` bitwise to a host totalOrder oracle over rows
   with planted ties, +-0 and NaN, and the multilabel binned family. Per
   stream: update wall ms per batch (and the device time of one batch in
   each binned PRC mode), each compute's wall and device time, costliest
   kernels and peak bytes.
8. ``timing``: the kernel against its plain version and ``torch.bincount``
   at the main path's shapes (T = 1 at 65,536 and 2^24 samples, and the
   weighted 4-task batch) and at 65,536 bins, with its device time from
   the profiler, its host time per call split three ways
   (``StreamingBinaryAUROC.update``, the checked wrapper, the bare C
   launch), the least time the memory traffic needs and the share of it
   reached; then a sweep of launch designs over batch sizes at 8,192 and
   65,536 bins, which holds the wrapper's pick against the designs on the
   other side of each of its switch points (``design_choices``).
9. ``recsys``: the recommendation-eval path at published scales, each
   stream held to a float64 or integer oracle. The Criteo stream of phase
   2 (logits x ~ N(-3.5, 1.5), scores sigmoid(x)) through
   ``toolkit.update_collection`` into the DLRM eval panel:
   ``BinaryNormalizedEntropy`` on scores and on logits,
   ``ClickThroughRate``, ``WeightedCalibration`` and
   ``StreamingBinaryAUROC`` (K1 once an update; values within 1e-5
   relative, counts within ``_within_bound``, float sums within
   ``_float_bound``); a 4-task weighted stream of 2^22 samples; the
   calibration row form over 2^22 rows and 1,000 task ids, some out of
   range. MLPerf NCF on MovieLens-20M (138,493 users x 1,000 candidates,
   batches of 4,096, planted ties, NaN and wrapped or out-of-range
   targets): ``HitRate`` and ``ReciprocalRank`` at 10, bitwise against an
   int64 rank count. MS MARCO passage dev small (6,980 queries x 1,000
   BM25 candidates, rows shuffled in batches of 64 queries, with ignored
   indexes): ``RetrievalPrecision`` at 10 per query and macro, and the
   functional form, bitwise against a host totalOrder top-k. DLRM ids
   (26 features of 65,536 ids under a 40 M-row cap): ``num_collisions``
   and ``frequency_at_k`` bitwise against numpy. Per stream: update wall
   ms per batch, each compute's wall and device time, peak bytes; K1's
   launches must equal the panel's updates.
10. ``lm_eval``: the language-model eval path. ``Perplexity(ignore_index=
   -100)`` at Llama-3-8B width (vocabulary 128,256, windows of 8,192
   tokens) over a stream of 287,644 targets (WikiText-2 test under the
   GPT-2 tokenizer, as Hugging Face's fixed-length perplexity page
   counts it): 36 non-overlapping float32 windows (the last with 924 real
   targets; -1, V and V + 7 planted in the first), 8 sliding windows at
   stride 512 (7,680 targets a window ignored), 4 bfloat16 windows, and
   ``perplexity`` on one window. Logits are N(0, 1) with a margin of
   ``PPL_MARGIN`` at each target. Each stream's NLL sum is held to a
   float64 oracle (row chunks) within the bound ``_window_bound`` derives,
   the token count exactly; the update's wall and device ms, the share of
   the HBM bound (the logits read once) and peak bytes are reported.
   ``BLEUScore(n_gram=4)`` over 3,003 WMT14 newstest2014-sized pairs
   (Zipfian vocabulary of 32,000 words, seeded substitutions and
   deletions) in batches of 64 and ``bleu_score`` once: counters bitwise
   against a ``Counter`` oracle, the score within 1e-6 of float64. WER,
   WIL and WIP over 2,620 LibriSpeech test-clean-sized utterances in
   batches of 64: counts bitwise against a Python Levenshtein DP, rates
   bitwise against their float32 quotients. K1 must not launch.
11. ``image``: the image-eval path (BASELINE config 5), convolutions at
   PyTorch's default precision (cuDNN TF32). ``FrechetInceptionDistance``
   over ``FIDInceptionV3`` -- the port's InceptionV3 at full width with
   random weights from ``--seed`` -- fed 10,000 real and 10,000 generated
   3x32x32 images (CIFAR-10 test-set size, FID-10k: a cut from the
   50,000-image protocol) resized to 299x299, in batches of 250, and the
   real stream fed as both sides to a second metric (FID near 0); FID at
   ViT-L width (1,024 features) through a fixed random ViT-L/16 patch
   embedding, mean-pooled, over 10,000 + 10,000 224x224 images. The
   states are held to float64 sums of the same activations within the
   float32 summation bound, each FID to a float64 host computation of the
   same formula within a bound derived from the eigensolvers' backward
   error, and four images' features to a float64 forward of the same
   module within the conv precision's tolerance (``_feature_tol``, under
   TF32 and under float32 convs). Reported: images a second through each
   extractor and the share of the dense peak (conv FLOPs counted from the
   architecture) at TF32 and at float32 convs, the accumulate's device ms
   a batch against its bound, each compute's wall and device ms with
   ``eigh``/``eigvalsh`` split out, peak bytes. ``PeakSignalNoiseRatio``
   (auto range and ``data_range=1.0``) and ``peak_signal_noise_ratio``
   over 100 DIV2K-validation-sized pairs (3x1356x2040), and
   ``MeanSquaredError`` (weighted by a valid-depth mask and not),
   ``R2Score``, an 8-output stream (``raw_values``, ``variance_weighted``,
   adjusted R2), ``Max``, ``Min`` and ``Cat`` over 654 NYU Depth v2 test
   maps of 480x640, each within 1e-5 of float64 (``Cat`` bitwise against
   a host concatenation); ``AUC(reorder=True)`` and ``auc`` over the
   per-image PSNR. K1 must not launch.
12. ``window``: the windowed metrics over the Criteo stream of phase 2
   (1,361 batches of 65,536), through ``toolkit.update_collection`` under
   ``torch.cuda.set_sync_debug_mode("error")``, so a windowed update that
   synchronizes the host fails: ``WindowedBinaryNormalizedEntropy`` on
   scores and on logits, ``WindowedClickThroughRate``,
   ``WindowedWeightedCalibration`` and ``WindowedMeanSquaredError`` on
   (score, click) (the windowed Brier score), each with the reference's
   100-update window and a lifetime, beside their non-windowed twins; and
   ``WindowedBinaryAUROC`` at 2^20 samples (every update wraps the ring)
   and at 32,768 (every full batch overwrites it). Each windowed value is
   held within 1e-5 relative of float64 (the last 100 batches' counters;
   Mann-Whitney over the window's samples for AUROC), each ring column to
   its batch's float64 counters within ``_float_bound``, and each lifetime
   value bitwise to its twin. Four replicas, each fed a contiguous quarter,
   are synced over a ``LocalReplicaGroup``: the values against float64 over
   the union of their live columns, the states bitwise against
   ``merge_state``. The 4-task weighted stream of 2^22 samples goes
   through 4-task NE, CTR and calibration windows and a 4-task AUROC
   window of 2^18 samples (held to a weighted float64 oracle). Reported:
   update wall ms per batch beside each twin, the device time of an AUROC
   insert and of its compute over 2^20 samples, peak bytes; then the debug
   tier on the card (out-of-range targets for ``MulticlassAccuracy``,
   ``MulticlassConfusionMatrix``, ``HitRate`` and ``Perplexity``, a score
   past 1 for ``BinaryNormalizedEntropy``, an image past 1 for
   ``FrechetInceptionDistance`` must raise under ``config.debug_validation``
   and clean batches pass; a NaN batch must raise under
   ``config.validate_inputs("raise")``) and the update wall ms of
   ``MulticlassAccuracy`` and ``BinaryNormalizedEntropy`` with each knob
   off and on, updates back to back. K1 must not launch.
13. ``bucket``: shape bucketing, donated in-place updates and bucketed
   panels as CUDA-graph replays, each sub-run beside the same stream fed
   eagerly and unbucketed. The ImageNet-1k panel (micro and macro
   ``MulticlassAccuracy``, macro ``MulticlassPrecision``,
   ``MulticlassRecall`` and ``MulticlassF1Score``,
   ``MulticlassConfusionMatrix(1000)``) through ``update_collection``
   under ``config.shape_bucketing()``: 50,000 x 1,000 in batches of
   1,024 (a tail of 848), then bench.py's ``variable_batch`` schedule
   shuffled from ``--seed``, twice, the second pass under
   ``set_sync_debug_mode("error")``: states bitwise equal to the eager
   panel after every update, at most ``bucket_bound(1024)`` = 8 graph
   captures and none on the second pass, buckets replayed with two or
   more valid counts; host and device ms of a panel update, graphed
   against eager. The Criteo stream of phase 2 with its tail of 8,359:
   ``BinaryNormalizedEntropy`` and ``StreamingBinaryAUROC`` (the plain
   group, K1 once an update: 1,361), the calibration row form over 1,000
   task ids (bucketed, graphed), ``ClickThroughRate``; counters bitwise,
   calibration sums within ``_float_bound`` of float64. ``Perplexity`` at
   Llama-3-8B width over 16 batches of 8 sequences of lengths up to 1,024
   (both axes bucket): within the ``lm_eval`` bound of float64 and rtol
   1e-6 of the eager stream, captures at most the distinct buckets, peak
   bytes and the graph pool's reserved bytes. Every other masked twin
   (binary, multilabel and top-k accuracy, binary P/R/F1/CM, the five
   binned curves, MSE weighted and not, R2) graphed against eager at
   small shapes; two ``MulticlassAccuracy`` metrics on two streams with
   graphs of their own; a ``reset()`` that keeps its graphs.
14. ``elastic``: fault-tolerant sync and elastic snapshot/resume. The
   Criteo stream of phase 2 (1,361 batches of 65,536, each batch drawn
   from a seed of its own) is split into four contiguous quarters, one a
   rank of a ``ThreadWorld(4)`` (four threads on the one card), each
   feeding the DLRM panel (``BinaryNormalizedEntropy``,
   ``ClickThroughRate``, ``WeightedCalibration``, ``StreamingBinaryAUROC``
   and ``StreamingBinaryAUPRC`` at 8,192 bins on K1) and an exact
   ``BinaryAUROC`` over its first 2^22 samples (the cut: a whole quarter
   would make each snapshot about 1.6 GB over the four ranks) under
   ``ElasticSession(interval=100)``. A ``SnapshotCrashPlan`` kills rank 1
   in the middle of its shard of generation 2; its peers time out in the
   digest gather. A ``ThreadWorld(4)`` restores generation 1 (each rank
   bitwise its old state) and runs the resilience checks over it:
   ``ResilientGroup(policy="quorum")`` against the bare group (bitwise
   equal, equal gather counts, sync seconds the median of 3), rank 3 dead
   under ``quorum=0.75`` (ranks 0-2 merged bitwise, degraded, within the
   deadline plus 1 s), the ``raise`` policy (a typed
   ``SyncTimeoutError``), a corrupt payload (rank 1 dropped and counted),
   re-formation after two degraded syncs (``world_size=3``,
   ``reformed=True``). A ``ThreadWorld(2)`` restores it at world 2, fences
   the counted steps and finishes the stream: the synced panel bitwise
   equal to an in-memory oracle of the same merge order and within 1e-5
   of float64 over the whole stream; then ``corrupt_shard`` on the newest
   generation, and the restore falls back one generation and matches
   again. K1 must launch once a streaming update before and after the
   restore. Timed: drained-queue ms a batch with no session, a
   synchronous writer and ``async_writer=True``, the snapshot steps, the
   restores. Then ``launcher.launch`` runs two gloo workers (this script
   with ``--elastic-worker``), each with CUDA metrics under
   ``ElasticSession(async_writer=True)`` on ``MultiHostGroup``, synced
   through ``ResilientGroup`` with rank 1 a slow peer; a relaunch at world
   1 restores their last generation and must equal their synced merge
   bitwise. Last, phase 13's ImageNet panel under shape bucketing is
   snapshotted, restored into the same metric objects and fed on, bitwise
   equal to the eager panel, captures within ``bucket_bound``.
15. ``obs``: the observability core (``torcheval_tpu_torch.obs``). The DLRM
   panel of phase 14 (``BinaryNormalizedEntropy``, ``ClickThroughRate``,
   ``WeightedCalibration``, ``StreamingBinaryAUROC`` and
   ``StreamingBinaryAUPRC`` at 8,192 bins on K1) over 300 Criteo batches of
   65,536, three times from a drained queue a batch: recorder off,
   recorder on, and inside one ``config.observability(jsonl=...,
   chrome_trace=..., watchdog=0.5, serve=0)`` scope. Each update's states
   must equal the recorder-off stream's bitwise, the update events cover
   every metric update (one a panel call), K1 launches once a streaming
   update, and ``set_sync_debug_mode("warn")`` counts the same host syncs
   in every mode. In the same scope: phase 13's ImageNet panel as a ragged
   bucketed stream (one compile event a CUDA-graph capture, each naming
   its bucket, within ``bucket_bound``); ``ThreadWorld(4)`` ranks each with
   the panel and an exact ``BinaryAUROC`` of 2^22 samples, synced flat and
   through ``ResilientGroup(HierarchicalGroup(group_size=2))`` (bitwise
   equal; 4 node and 2 or 0 leader collectives a rank; no divergence in
   the flight rings; the ranks' N-th sync events share a flow id;
   ``gather_observability`` merges all four); a slow peer delayed 1.5 s
   past the watchdog (a ``StallEvent`` naming the collective, the
   trip-time rings naming the rank, the run completes); one snapshot a
   rank and a 4->4 restore (a ``SnapshotEvent`` and a ``RestoreEvent`` a
   rank, the recorder's step cursor the session's); ``/metrics``,
   ``/healthz``, ``/flight`` and ``/report`` over loopback (the exposition
   parses, its panel-update count equals the calls made, the admission
   source reads no armed table, the federation, plane and failover
   sections read absent, the wire source reads the default ladder, the
   server stops at scope exit); then the Chrome
   trace loads and the JSONL holds one line an event. Reported: ms a
   batch, median and mean, in each mode; host microseconds of one
   ``StreamingBinaryAUROC.update`` off and on; the sync warnings counted.
16. ``shard_quality``: sharded metric state and the data-quality layer.
   A ``MulticlassConfusionMatrix`` at ImageNet-21K-P width (the winter-21
   release: 10,450 classes, 522,500 validation images; the matrix rounded
   up to 10,452, a multiple of the shard world) fed seeded float32 logits
   of (1,024, 10,450) a batch (two -inf columns appended), and a ``HistogramBinnedAUROC`` at
   2^20 thresholds over phase 2's Criteo stream: each family sharded over
   ``ThreadWorld(4)`` ranks on the card (``ShardContext(rank, 4)``, a
   contiguous quarter of the stream a rank; the AUROC ranks adopt the
   synced state every 8 steps, so an outbox stays below the state it
   routes into) beside one replicated metric fed the whole stream. The
   synced value, the adopted one and the value after a snapshot at world
   4 restored at world 2 must each equal the replicated one bitwise; after
   the adopt every outbox is empty and a rank pins at most logical/4 + 64
   KiB; a rank's sync payload is below the replicated one.
   ``sync_states_in_jit`` and ``donated_sync_step`` over a real NCCL group
   of world 1 and over two gloo processes (``launcher.launch``), held
   bitwise to the eager merge. A ragged stream into a sharded confusion
   matrix under shape bucketing, its outbox pre-sized: bitwise equal to
   the eager stream, captures within ``bucket_bound``, none on a second
   pass. Then ``watch_inputs``: the DLRM panel's scores over 300 Criteo
   batches and phase 13's ImageNet panel as a ragged bucketed (graphed)
   stream, each beside the same panel unwatched in one loop: every state
   bitwise equal after every update, the same host syncs, the same
   captures, and the sketch's counter, histogram and register lanes
   bitwise equal to a standalone ``InputSketch`` (moments within
   ``SKETCH_MOMENT_RTOL``); a reference frozen on 20 batches and 20
   shifted ones trip a ``DriftSpec`` with one ``DriftEvent``, and the
   health server's ``/metrics`` carries the ``quality_value`` histograms
   and ``/report`` the ``[quality]`` table. Reported: update ms a batch
   sharded against replicated, sync seconds, synced compute ms, payload,
   per-rank and logical bytes, peak bytes, restore seconds; watched
   against unwatched ms a batch, host microseconds of one watched update,
   and the sketch fold's device ms and launches an update.

17. ``serving``: the serving stack (``torcheval_tpu_torch.table`` and
   ``torcheval_tpu_torch.streaming``). ``panel``: a ``TablePanel`` of
   ``ctr``, ``weighted_calibration``, ``ne`` and ``windowed_ne`` (a window
   of 4 drain epochs) keyed by one DLRM categorical feature of 590,152 rows
   (MLPerf DLRM-DCNv2's per-feature embedding size), ids
   ``floor(590,152 u^4)``, over phase 2's Criteo rows, each batch of 65,536
   split into a quarter a rank of ``ThreadWorld(4)`` and drained with
   ``toolkit.adopt_synced`` every 16 batches, beside a world-1 panel fed
   the same rows; the first 64 batches (**cut** from 1,361 for the
   smoke's time budget). Per-key CTR
   bitwise against an int64 oracle and between the worlds; every
   accumulated column (NE, calibration, the windowed ring) within
   ``_float_bound`` of float64 oracles; per-rank bytes after the adopt
   within [logical/8, logical/2]; a rank's sync payload below the world-1
   panel's. ``ncf``: ``MetricTable("hit_rate", k=10)`` keyed by user over
   MLPerf NCF (138,493 users x 1,000 candidates, batches of 4,096, phase 9's
   planted rows), every user bitwise against the int64 rank count.
   ``admission``: the panel armed with an ``AdmissionController`` under
   ``OverloadSchedule``: calm 512-row requests, then a sustained 10x QPS
   and 10x key-cardinality spike (the JAX package's bench config 19),
   drained every step: the ladder escalates, latches at ``sampled`` and
   returns to ``full``; every keep verdict equals a numpy copy of
   ``admission_keep``; a spike step's admitted keys read their full-ingest
   CTR bitwise and calibration and NE within the float32 bound; no graph
   is captured after the warm-up across the rung changes; ``/healthz``
   reads ``shedding`` and stays healthy. ``decode``: ``StreamTable`` ranks
   of ``ThreadWorld(4)`` with 10,000 requests in flight, 4,096 active rows
   a step routed to each request's owning rank, tokens over Llama-3's
   128,256-entry vocabulary, log-probs -U(0.01, 3), output lengths
   U(64, 512) (finished requests retired and replaced): ``logprob`` +
   ``token_edit`` for 200 steps with an ``ElasticSession`` snapshot at
   world 4 restored at world 2 midway, then a ragged tail down to an empty
   step; then the same plus ``ngram`` (n = 4) for 50 steps (both counts
   **cut**). 64 sampled requests bitwise equal to standalone
   ``StreamingPerplexity``, ``StreamingTokenEditStats`` and
   ``StreamingNgramOverlap`` before and after the restore; captures within
   ``bucket_bound`` while warming, then none. Reported: ingest host µs
   and device ms a rank's batch (eager and graphed, with launches), keys
   a second, drain seconds, logical, per-rank and peak bytes, the p99s,
   decode rows a second and the n-gram mirror's host µs a step. K1 0.

18. ``wan``: the quantized wire ladder, the zero-stall sync plane,
   cross-region federation and rank-loss failover, over ``ThreadWorld(4)``
   ranks on the card in two regions (``us`` = ranks 0-1, ``eu`` = 2-3),
   each rank fed a quarter of each of phase 2's Criteo batches (the first
   48: **cut** from 1,361 for the smoke's time budget) into the DLRM
   panel (``BinaryNormalizedEntropy``,
   ``ClickThroughRate``, ``WeightedCalibration``, ``StreamingBinaryAUROC``
   and ``StreamingBinaryAUPRC`` at 8,192 bins on K1), an exact
   ``BinaryAUROC`` over its samples and an ImageNet-1k
   ``MulticlassConfusionMatrix`` (256 of phase 1's images a rank a step).
   (a) ``wire``: the exact AUROC buffer, a ``WindowedBinaryAUROC`` of 2^20,
   a ``Cat``, the K1 histogram and the counters synced at ``exact``,
   ``bf16`` and ``int8`` (block 32) over 64 batches: every float state
   within its codec bound (``amax/254`` a block at int8, ``|x| 2^-8`` at
   bf16, summed over ranks), counters bitwise, AUROC-type values within
   5e-3 of the exact rung, each metric's ``wire_tier`` the rung its
   payload rode; two ``DriftSpec`` breaches of a watched window step its
   family int8 -> bf16 -> exact with a ``WireTierEvent`` each and the
   synced provenance following; the bytes each rank ships a family at each
   rung. The in-step ``compression="int8"`` sync of phase 16's 2^20-bin
   histogram AUROC (its int32 counts, exact, and the same counts as a
   float32 weighted histogram, owner-partitioned) at NCCL world 1 and over
   two spawned gloo processes, within the codec bound, with the
   quantizer's device ms. (b) ``plane``: ``SyncPlane(interval=2.0)`` over
   the world, a publish a step, three collections a rank stepped in turn
   (plane off, armed, a blocking sync every 25 steps): no gather on the
   serving group, no host sync inside ``publish``
   (``set_sync_debug_mode("error")``), a read bitwise equal to a blocking
   sync over the states published for its version, a read after
   ``reset()`` at version 0; host us of a step (p50, p99) in each arm,
   ``publish`` host us, device ms and bytes, rounds and ``rounds_behind``.
   (c) ``federation``: the regions exchange over an ``InProcessLinkBus``
   under ``ChaosLinkTransport``: healthy rounds, ``eu`` dark for
   ``partition_after + 2`` rounds, a heal; the dark read is flagged in
   ``FederationProvenance``, ``/healthz`` reads ``stale-region``, a
   re-delivered epoch is discarded, and after the heal every state equals
   the flat four-rank sync bitwise (float sums of non-integers: bitwise
   the same merge in region order, their distance to the flat fold
   reported); delta against full bytes of the confusion matrix, federate
   and bare region-sync ms. (d) ``failover``: a ``FailureDomain`` on every
   rank over ``KillGroup`` (plane and federation riding it,
   ``ElasticSession`` snapshots to a temporary directory, a keyed CTR
   ``MetricTable`` over one DLRM feature as the partitioned state, the
   ImageNet panel graphed under shape bucketing) and three kills: rank 3
   on a generation boundary mid plane round (an exact ``LossBound``,
   survivors bitwise the on-disk world-change restore), rank 3 five
   batches past a generation mid drain (the bound's steps are those five
   batches; survivors bitwise the stream without them), rank 2, the
   ``eu`` leader, mid federation exchange (leadership moves to rank 3);
   each time ``/healthz`` reads ``degraded-world``, detection issues no
   gather, and the live rejoin equals an on-disk world-change resume;
   the bucketed panel captures no graph after its warm-up. K1 launches
   once a streaming update in every arm (``k1_launches_by_arm``).

19. ``model``: the model runtime (``torcheval_tpu_torch.models``,
   ``parallel`` and ``tools``), float32 matmuls without TF32. (a)
   ``eval_step``: ``TransformerLM`` at Meta-Llama-3-8B's ``config.json``
   widths and full depth (vocabulary 128,256, d_model 4,096, 32 heads,
   d_ff 14,336, 8,192 positions, 32 layers: this repo's LayerNorm/GELU
   architecture, 6,990,340,096 parameters, 13.98 GB in bfloat16, seeded
   on the card), one warm-up step under ``FlopCounter`` and 5 timed steps,
   each a fresh (1, 8,192) window and, on its logits,
   ``perplexity_counters``, ``Perplexity`` and ``MulticlassAccuracy``:
   the FLOP count equal to the analytic 140,548,509,794,304, the counters
   bitwise to the metric state and the token count exact; then the same
   weights upcast to float32 (the bf16 copy freed) give a log-perplexity
   within ``_bf16_log_ppl_bound`` of the bf16 one. Reported: forward, metric
   and step ms (CUDA events), tokens/s, TFLOP/s and the share of the bf16
   dense peak, the metrics' share of the step, top-1 agreement, peak
   bytes. (e) ``tools``: ``get_module_summary`` of (a)'s bf16 model on its
   last window (the table, pruned to depth 2, printed on the lines before
   the phase's): 6,990,340,096 parameters, twice that in bytes, the root's
   FLOPs (a)'s, every ``Block_i`` alike, ``count_flops_backward`` twice the
   forward with nothing allocated; per-type forward ms. (b)
   ``long_context``: ``long_context_lm`` at the same widths in float32,
   4 layers (**cut** from 32), dp 2 x sp 4 over ``ThreadWorld(8)``, two
   8,192-token windows: each rank's logits within 2e-4 of the dense
   forward of its window, the counters summed over sp then dp within 1e-4
   relative of ``Perplexity`` over the dense logits, the count exact, 4 x
   4 ``ppermute`` calls a rank; ring and dense ms. (c) ``moe``:
   ``moe_apply`` at google/switch-base-8 widths (768, 3,072, 8 experts),
   one expert a rank of ``ThreadWorld(8)``, 2,048 tokens a shard, capacity
   320 (factor 1.25), token vectors sharing a seeded offset so that loads
   are uneven and tokens drop: within 1e-5 of ``moe_reference``, dropped
   tokens exactly zero; dropped share, ms, bytes exchanged. (d)
   ``pipeline``: ``pipeline_apply`` over ``ThreadWorld(4)``, two
   Llama-width float32 ``Block``s a stage, 8 microbatches of (1, 1,024,
   4,096), within 1e-6 of ``pipeline_reference``; 11 ticks, bubble 3/11,
   ms. Legs (b)-(d) also run once over a real NCCL group of world 1
   against the same oracle. K1 must not launch.

20. ``train``: training through the port (``parallel.backward``, the
   DTensor step of ``examples/train_step.py``), float32 matmuls without
   TF32. First a probe: two rank threads swap a tensor through an
   autograd ``Function`` whose backward is itself a swap, and call
   ``loss.backward()`` (each waits ``PROBE_TIMEOUT`` s on the other): on
   the card autograd runs every CUDA node on one device thread, so the
   probe reports which threads ran the nodes and whether the swap
   deadlocked; the same swap through ``_axis.ppermute`` and
   ``parallel.backward`` must give both ranks their gradients. (a)
   ``step``: ``TransformerLM`` at Meta-Llama-3-8B's widths in float32,
   ``TRAIN_LAYERS`` = 4 layers (**cut** from 32: parameters, gradients and
   two Adam moments take 16 B a parameter, 112 GB at 32 layers, 29 GB at
   4), a fixed seeded batch of ``TRAIN_BATCH`` = 2 windows of
   ``TRAIN_WINDOW`` = 2,048 tokens (**cut** from 8,192: one saved S x S
   float32 score tensor is 8.6 GB a layer a window at 8,192), its
   parameters DTensors on a dp 1 x tp 1 ``DeviceMesh`` over NCCL world 1
   placed by ``param_specs``, ``torch.optim.Adam(lr=1e-3)``: the FLOP count
   (``FlopCounter``) equal to the analytic 10,900,626,997,248 forward and
   twice that backward; step 0's loss, counters and every gradient against
   the plain step of the same model on the card (``TRAIN_LOSS_RTOL``,
   ``TRAIN_GRAD_RTOL``; ``num_correct`` and ``num_total`` exact), then one
   optimizer step and ``TRAIN_STEPS`` = 3 timed steps, the loss falling.
   Reported: step, forward, backward and optimizer ms (CUDA events,
   median), tokens/s, TFLOP/s forward plus backward and the share of the
   float32 peak, the counters' ms alone and their share of the step, peak
   bytes, the losses. (b) gradient legs, each against its dense oracle's
   ``torch.autograd`` gradients and once more over the world-1 group:
   ``ring``: ``ring_attention`` at 32 heads x 128 over ``ThreadWorld(4)``,
   one 8,192-token window, dq, dk and dv within 2e-4; ``moe``: Switch-Base-8
   widths, 8 expert threads, 2,048 tokens a shard, capacity factors 1.25
   and 0.25, the gradients of x, wg (summed over the ranks), w1 and w2
   within 1e-4 of their largest element of the float64 oracle's, plus a
   ReLU kink allowance (``_moe_kink_allowance``), and a dropped token's
   exactly zero; ``pipeline``: 4 stages
   of one Llama-width float32 ``Block`` each (**cut** from two, for the
   saved activations), 8 microbatches of (1, 1,024, 4,096), each rank's
   loss the replicated output's over 4, every parameter's gradient within
   1e-5; the ring and pipeline census: one ``backward_plan`` and a
   backward call for every hop but the last, which nothing reads. (c)
   ``examples``: the ``main`` of ``eval_panel_example``,
   ``llm_eval_example``, ``multihost_example`` (over the NCCL world-1
   group) and ``scaleout_example`` (8 rank threads) on the card, each
   marker checked; K1 launches once a ``StreamingBinaryAUROC`` update in
   ``eval_panel`` and never in the training legs or the other examples.
21. ``analysis``: the analysis layer (``torcheval_tpu_torch.analysis``),
   metric state on the card. (a) ``cli``: ``python -m
   torcheval_tpu_torch.analysis --concurrency --programs`` in-process over
   the package, JSON report: every ``.py`` file linted and swept, exit 0,
   no active lint or concurrency finding and no active error (the
   suppressed findings counted; the program arm's active warnings are
   compute host reads, listed). (b) ``families``: every fused family (the
   JAX package's ``CLASS_CASES``, the sharded, routed and quality-watched
   cases of its program sweep, the keyed table's ``ctr`` and
   ``windowed_ne`` ingest) built on the card: update, compute and merge
   verified on fake CUDA tensors with no active error, then the same
   update run for real -- its plan built on the host (host syncs counted
   as ``intake_syncs``), then applied under
   ``set_sync_debug_mode("error")`` inside ``parallel._axis.census()``
   and the dispatch recorder, the state pointers read before and after.
   One row a family; static and runtime must agree on host escapes,
   collectives and in-place writes. Two seeded faults, a plan kernel that
   calls ``.item()`` and one that all-reduces over the NCCL world-1 group,
   must each be caught both ways. (c) ``k1``: ``StreamingBinaryAUROC`` and
   ``StreamingBinaryAUPRC`` at 8,192 bins on 65,536-sample Criteo batches
   from phase 2's generator: exactly one K1 op an update in the static
   trace, one launch an update at runtime under
   ``set_sync_debug_mode("error")``, the histogram bitwise to the plain
   version's. (d) ``lockstep``: ``eager_sync_plan`` over phase 4's
   collection for 4 ranks (equal plans), a rank-divergent builder flagged,
   and the recorded plans of ring attention (phase 20's ring: 32 heads x
   128, 8,192 tokens, sp 4) and MoE (Switch-Base-8 widths, 8 experts,
   2,048 tokens a shard, capacity factor 1.25), forward and
   ``parallel.backward``, equal across ranks and equal to the
   ``_axis.census()`` counts of a real ``ThreadWorld`` run. The phase's
   seconds and the card line are reported.

Then a ``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` reports them, and, last, ``{"ok": true, "device": {...}}``.
Any failure raises, and the script exits non-zero without that last line;
without a CUDA device it exits non-zero at once.

The phase functions take ``device`` and sizes, so the CPU tests run phases
1, 2, 4 to 7 and 9 to 21 at small sizes with ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import importlib
import io
import json
import logging
import math
import multiprocessing
import os
import pickle
import re
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.error
import urllib.request
import warnings
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torcheval_tpu_torch  # noqa: E402
from torcheval_tpu_torch import analysis, config, launcher, obs, wire  # noqa: E402
from torcheval_tpu_torch.analysis import program as analysis_program  # noqa: E402
from torcheval_tpu_torch.distributed import (  # noqa: E402
    HierarchicalGroup,
    LocalReplicaGroup,
    MultiHostGroup,
    ProcessGroup,
)
from torcheval_tpu_torch.elastic import ElasticSession, _assign_shards  # noqa: E402
from torcheval_tpu_torch.metrics import (  # noqa: E402
    AUC,
    BinaryAccuracy,
    BinaryAUPRC,
    BinaryAUROC,
    BinaryBinnedAUPRC,
    BinaryBinnedAUROC,
    BinaryBinnedPrecisionRecallCurve,
    BinaryConfusionMatrix,
    BinaryF1Score,
    BinaryNormalizedEntropy,
    BinaryPrecision,
    BinaryRecall,
    BLEUScore,
    Cat,
    ClickThroughRate,
    FrechetInceptionDistance,
    HistogramBinnedAUROC,
    HitRate,
    Max,
    Mean,
    MeanSquaredError,
    Min,
    MulticlassAccuracy,
    MulticlassAUPRC,
    MulticlassAUROC,
    MulticlassBinnedAUPRC,
    MulticlassBinnedAUROC,
    MulticlassBinnedPrecisionRecallCurve,
    MulticlassConfusionMatrix,
    MulticlassF1Score,
    MulticlassPrecision,
    MulticlassRecall,
    MultilabelAccuracy,
    MultilabelBinnedAUPRC,
    MultilabelBinnedPrecisionRecallCurve,
    PeakSignalNoiseRatio,
    Perplexity,
    R2Score,
    ReciprocalRank,
    RetrievalPrecision,
    StreamingBinaryAUPRC,
    StreamingBinaryAUROC,
    Sum,
    Throughput,
    TopKMultilabelAccuracy,
    WeightedCalibration,
    WindowedBinaryAUROC,
    WindowedBinaryNormalizedEntropy,
    WindowedClickThroughRate,
    WindowedMeanSquaredError,
    WindowedWeightedCalibration,
    WordErrorRate,
    WordInformationLost,
    WordInformationPreserved,
)
from torcheval_tpu_torch.metrics import _fuse, sharded, shardspec, synclib, toolkit  # noqa: E402
from torcheval_tpu_torch.metrics.metric import MergeKind  # noqa: E402
from torcheval_tpu_torch.metrics.shardspec import ShardContext, ShardSpec  # noqa: E402
from torcheval_tpu_torch.obs import quality  # noqa: E402
from torcheval_tpu_torch.obs.sketch import InputSketch  # noqa: E402
from torcheval_tpu_torch.metrics._bucket import bucket_bound, bucket_length  # noqa: E402
from torcheval_tpu_torch.metrics.functional import (  # noqa: E402
    auc,
    bleu_score,
    frequency_at_k,
    num_collisions,
    peak_signal_noise_ratio,
    perplexity,
    retrieval_precision,
    word_error_rate,
    word_information_lost,
    word_information_preserved,
)
from torcheval_tpu_torch.metrics.functional.classification._curve_kernels import (  # noqa: E402
    _reverse_cummin,
)
from torcheval_tpu_torch.metrics.functional.classification.auprc import (  # noqa: E402
    _multiclass_auprc_compute,
)
from torcheval_tpu_torch.metrics.functional.classification.auroc import (  # noqa: E402
    _multiclass_auroc_compute,
)
from torcheval_tpu_torch.metrics.image.fid import (  # noqa: E402
    FIDInceptionV3,
    _covariance,
    _fid_accumulate,
    _frechet_distance,
    _resize_299,
)
from torcheval_tpu_torch.metrics.functional.text.perplexity import (  # noqa: E402
    _perplexity_update_jit,
)
from torcheval_tpu_torch.models import (  # noqa: E402
    TransformerLM,
    init_long_context_lm,
    init_params,
    long_context_lm,
    perplexity_counters,
)
from torcheval_tpu_torch.models.inception import FEATURE_DIM, init_inception_params  # noqa: E402
from torcheval_tpu_torch.models.transformer import Block, param_specs  # noqa: E402
from torcheval_tpu_torch.examples import (  # noqa: E402
    eval_panel_example,
    llm_eval_example,
    multihost_example,
    scaleout_example,
)
from torcheval_tpu_torch.examples import train_step as train_example  # noqa: E402
from torcheval_tpu_torch.metrics.functional.classification.accuracy import (  # noqa: E402
    _multiclass_accuracy_update,
)
from torcheval_tpu_torch.parallel import (  # noqa: E402
    _axis,
    dense_reference_attention,
    moe_apply,
    moe_reference,
    pipeline_apply,
    pipeline_reference,
    ring_attention,
)
from torcheval_tpu_torch.parallel import backward as parallel_backward  # noqa: E402
from torcheval_tpu_torch.parallel.moe import _route as _moe_route  # noqa: E402
from torcheval_tpu_torch.tools import (  # noqa: E402
    FlopCounter,
    count_flops_backward,
    get_module_summary,
    get_summary_table,
    prune_module_summary,
)
from torcheval_tpu_torch.ops import _kernels, topk  # noqa: E402
from torcheval_tpu_torch.obs.memory import memory_report  # noqa: E402
from torcheval_tpu_torch.obs.server import healthz_payload  # noqa: E402
from torcheval_tpu_torch.resilience import ResilientGroup, SyncTimeoutError  # noqa: E402
from torcheval_tpu_torch.syncplane import SyncPlane  # noqa: E402
from torcheval_tpu_torch.streaming import (  # noqa: E402
    StreamingNgramOverlap,
    StreamingPerplexity,
    StreamingTokenEditStats,
)
from torcheval_tpu_torch.table import (  # noqa: E402
    AdmissionController,
    MetricTable,
    ServingBudget,
    StreamTable,
    TablePanel,
    admission_keep,
    hash_keys,
    owner_of,
)
from torcheval_tpu_torch.utils.test_utils import (  # noqa: E402
    ChaosLinkTransport,
    FaultInjectionGroup,
    FaultSpec,
    InjectedCrash,
    KillGroup,
    KillSchedule,
    KillSpec,
    OverloadSchedule,
    SnapshotCrashPlan,
    ThreadWorld,
    corrupt_shard,
)
fa = importlib.import_module("torcheval_tpu_torch.ops.fused_auc")  # the module, not ops.fused_auc
from torcheval_tpu_torch.ops.fused_auc import (  # noqa: E402
    K1Geometry,
    _auc_from_hist,
    _auprc_from_hist,
    _histogram_cuda,
    _histogram_plain_full,
    _prepare_scores,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
NUM_BINS = 8192
IMAGENET_VAL = 50_000
CRITEO_EVAL = 89_137_319
CTR_BATCH = 65_536
# exact curve values against their float64 oracles: float32 counts are
# exact below 2^24, and past it (Criteo's negatives) a cumulative count is
# off by a few units in its last place, ~1e-7 of the area
CURVE_TOL = 1e-5
# CUPTI now and then drops every kernel of a trace, at times twice in a
# row, so an empty trace is taken again
PROFILE_ATTEMPTS = 4


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ------------------------------------------------------------------ data


def _classify_batch(gen, n, num_classes, device):
    """Logits with the true class raised by 3.5 (top-1 near ImageNet
    classifiers'), and uniform labels."""
    logits = torch.randn(n, num_classes, generator=gen, device=device)
    labels = torch.randint(0, num_classes, (n,), generator=gen, device=device)
    logits[torch.arange(n, device=device), labels] += 3.5
    return logits, labels


def _scores(gen, shape, skewed, device):
    """Scores in [0, 1]: uniform, or a skewed CTR-like logit-normal draw
    (sigmoid of N(-3.5, 1.5): median ~0.03, most mass near 0)."""
    if skewed:
        return torch.sigmoid(torch.randn(shape, generator=gen, device=device) * 1.5 - 3.5)
    return torch.rand(shape, generator=gen, device=device)


def _click_logits(gen, shape, device):
    """Criteo-like clicks: logits x ~ N(-3.5, 1.5), scores sigmoid(x),
    labels Bernoulli(score)."""
    x = torch.randn(shape, generator=gen, device=device) * 1.5 - 3.5
    s = torch.sigmoid(x)
    y = (torch.rand(shape, generator=gen, device=device) < s).to(torch.float32)
    return x, s, y


def _clicks(gen, shape, device):
    return _click_logits(gen, shape, device)[1:]


def _oracle_hist(scores, labels, weights, num_bins):
    """float64 histogram, by the port's bin rule, of scores already mapped
    to [0, 1] (as with bounds (0, 1))."""
    t, _ = scores.shape
    s = torch.nan_to_num(scores.clamp(0.0, 1.0), nan=0.0)
    bins = torch.clamp((s * num_bins).to(torch.int64), max=num_bins - 1)
    flat = (bins + torch.arange(t, device=scores.device)[:, None] * num_bins).reshape(-1)
    w = torch.ones_like(scores, dtype=torch.float64) if weights is None else weights.double()
    y = labels.double()
    pos = torch.bincount(flat, weights=(w * y).reshape(-1), minlength=t * num_bins)
    neg = torch.bincount(flat, weights=(w * (1 - y)).reshape(-1), minlength=t * num_bins)
    return torch.stack([pos.reshape(t, num_bins), neg.reshape(t, num_bins)], dim=1)


def _auc64(hist):
    return _auc_from_hist(hist.double())


def _auprc64(hist):
    return _auprc_from_hist(hist.double())


# ---------------------------------------------------------------- phases


def phase_classify(device, n=IMAGENET_VAL, num_classes=1000, batch=1024, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    cls = {
        "acc": MulticlassAccuracy(device=device),
        "acc_macro": MulticlassAccuracy(average="macro", num_classes=num_classes, device=device),
        "f1_macro": MulticlassF1Score(num_classes=num_classes, average="macro", device=device),
    }
    loss, tput = Mean(device=device), Throughput(device=device)
    losses, batch_ms = [], []
    t_start = time.perf_counter()
    for start in range(0, n, batch):
        t0 = time.perf_counter()
        b = min(batch, n - start)
        logits, labels = _classify_batch(gen, b, num_classes, device)
        batch_loss = F.cross_entropy(logits, labels)
        toolkit.update_collection(cls, logits, labels)
        loss.update(batch_loss)
        losses.append(batch_loss)
        _sync(device)
        dt = time.perf_counter() - t0
        tput.update(b, dt)
        batch_ms.append(dt * 1e3)
    seconds = time.perf_counter() - t_start

    # oracle pass: the same batches regenerated from the seed
    gen = torch.Generator(device=device).manual_seed(seed)
    preds, labels_all = [], []
    for start in range(0, n, batch):
        logits, labels = _classify_batch(gen, min(batch, n - start), num_classes, device)
        preds.append(logits.double().argmax(dim=-1))
        labels_all.append(labels)
    pred, lab = torch.cat(preds), torch.cat(labels_all)
    correct = (pred == lab).double()
    per_total = torch.bincount(lab, minlength=num_classes).double()
    per_correct = torch.bincount(lab, weights=correct, minlength=num_classes)
    per_pred = torch.bincount(pred, minlength=num_classes).double()
    seen = per_total > 0
    acc_macro = (per_correct[seen] / per_total[seen]).mean()
    prec = torch.nan_to_num(per_correct / per_pred)
    rec = torch.nan_to_num(per_correct / per_total)
    f1 = torch.nan_to_num(2 * prec * rec / (prec + rec))
    f1_mask = seen | (per_pred > 0)
    oracle = {
        "acc": float(correct.mean()),
        "acc_macro": float(acc_macro),
        "f1_macro": float(f1[f1_mask].mean()),
        "loss": float(torch.stack(losses).double().mean()),
    }
    got = {name: float(m.compute()) for name, m in cls.items()}
    got["loss"] = float(loss.compute())
    err = {k: abs(got[k] - oracle[k]) for k in oracle}
    _check(float(cls["acc"].num_correct) == float(correct.sum()), "acc counter != oracle")
    _check(float(cls["acc"].num_total) == float(n), "acc total != n")
    _check(
        torch.equal(cls["acc_macro"].num_correct.double(), per_correct),
        "per-class correct counts != oracle",
    )
    _check(
        torch.equal(cls["f1_macro"].num_prediction.double(), per_pred),
        "per-class prediction counts != oracle",
    )
    _check(all(e <= 1e-5 for e in err.values()), f"classify values off the oracle: {err}")
    _check(math.isfinite(tput.compute()) and tput.compute() > 0, "throughput not positive")
    return {
        "phase": "classify", "device": str(device), "samples": n,
        "num_classes": num_classes, "batch": batch, "values": got,
        "max_err_vs_float64": max(err.values()), "seconds": seconds,
        "samples_per_s": n / seconds, "throughput_metric": tput.compute(),
        "batch_ms_first": batch_ms[0],
        "batch_ms_median": sorted(batch_ms)[len(batch_ms) // 2],
    }


def phase_ctr_auc(device, n=CRITEO_EVAL, batch=CTR_BATCH, num_bins=NUM_BINS,
                  mt_samples=1 << 22, num_tasks=4, seed=1):
    cuda = torch.device(device).type == "cuda"
    auroc = StreamingBinaryAUROC(num_bins=num_bins, device=device)
    auprc = StreamingBinaryAUPRC(num_bins=num_bins, device=device)
    mt = StreamingBinaryAUROC(num_tasks=num_tasks, num_bins=num_bins, device=device)
    mt_batch = min(batch, mt_samples)

    _kernels.reset_launch_counts()
    gen = torch.Generator(device=device).manual_seed(seed)
    updates = 0
    for start in range(0, n, batch):
        s, y = _clicks(gen, (min(batch, n - start),), device)
        auroc.update(s, y)
        auprc.update(s, y)
        updates += 2
    for _ in range(0, mt_samples, mt_batch):
        s, y = _clicks(gen, (num_tasks, mt_batch), device)
        w = torch.rand((num_tasks, mt_batch), generator=gen, device=device)
        mt.update(s, y, w)
        updates += 1
    _sync(device)
    launches = _kernels.LAUNCHES["fused_auc_hist"]
    if cuda:
        _check(launches == updates, f"K1 launched {launches} times for {updates} updates")

    # oracle pass: the same batches regenerated from the seed
    gen = torch.Generator(device=device).manual_seed(seed)
    ref = torch.zeros((1, 2, num_bins), dtype=torch.float64, device=device)
    for start in range(0, n, batch):
        s, y = _clicks(gen, (min(batch, n - start),), device)
        ref += _oracle_hist(s[None], y[None], None, num_bins)
    ref_mt = torch.zeros((num_tasks, 2, num_bins), dtype=torch.float64, device=device)
    for _ in range(0, mt_samples, mt_batch):
        s, y = _clicks(gen, (num_tasks, mt_batch), device)
        w = torch.rand((num_tasks, mt_batch), generator=gen, device=device)
        ref_mt += _oracle_hist(s, y, w, num_bins)

    # unit weights, every bin < 2^24: the float32 state is exact
    _check(bool((ref < 2**24).all()), "a bin reached 2^24; exactness does not hold")
    _check(torch.equal(auroc.hist.double(), ref), "unit-weight histogram != float64 oracle")
    _check(torch.equal(auprc.hist, auroc.hist), "AUROC and AUPRC states differ")
    mt_rel = float(((mt.hist.double() - ref_mt).abs() / ref_mt.abs().clamp(min=1e-30)).max())
    mass_rel = float((mt.hist.double().sum() - ref_mt.sum()).abs() / ref_mt.sum())
    _check(mt_rel <= 1e-5 and mass_rel <= 1e-5, f"weighted histogram rel err {mt_rel}, mass {mass_rel}")
    values = {
        "auroc": float(auroc.compute()), "auprc": float(auprc.compute()),
        "auroc_tasks": mt.compute().tolist(),
    }
    oracle = {
        "auroc": float(_auc64(ref)[0]), "auprc": float(_auprc64(ref)[0]),
        "auroc_tasks": _auc64(ref_mt).tolist(),
    }
    err = max(
        abs(values["auroc"] - oracle["auroc"]),
        abs(values["auprc"] - oracle["auprc"]),
        max(abs(a - b) for a, b in zip(values["auroc_tasks"], oracle["auroc_tasks"])),
    )
    _check(err <= 1e-5, f"AUC values off the float64 oracle by {err}")
    return {
        "phase": "ctr_auc", "device": str(device), "samples": n, "batch": batch,
        "num_bins": num_bins, "weighted_tasks": num_tasks,
        "weighted_samples_per_task": mt_samples, "updates": updates,
        "k1_launches": launches, "values": values, "max_err_vs_float64": err,
        "weighted_hist_max_rel_err": mt_rel,
    }


def _k1_design(n, tasks, num_bins, geometry=None):
    """The geometry the wrapper picks for this shape (or ``geometry``), as
    the smoke reports it."""
    if geometry is None:
        geometry = fa._geometry(_kernels.load("fused_auc_hist"), torch.cuda.current_device(),
                                n, tasks, num_bins)
    mode = "split" if geometry.split else ("replicated" if geometry.shared else "global")
    return {"cluster": geometry.cluster, "clusters_per_task": geometry.clusters_per_task,
            "smem_bytes": geometry.smem_bytes, "mode": mode}


def _kernel_case(gen, n, tasks, skewed, weighted, bounds, num_bins, device, nan=False,
                 offset=0, broadcast=False, geometry=None, soft=0.0, via_op=False):
    """One kernel-vs-plain comparison on the same CUDA tensors.

    ``offset`` places the scores at that many elements past a 16-byte
    boundary (a view into a larger buffer, so float4 loads must not be
    taken for the head); ``broadcast`` makes labels and weights one row
    expanded over the tasks (row stride 0); ``geometry`` forces a launch
    design instead of the wrapper's choice; ``soft`` makes that share of
    the labels fractional (the unit-weight kernel counts 0/1 labels and
    adds any other label's float masses apart); ``via_op`` launches
    through the dispatcher op ``fa.K1_OP``, as the update path does,
    instead of the checked wrapper.

    Unit weights: the two must be bitwise equal. Random weights: float
    atomics add in a run-dependent order, so the kernel is held to the
    float64 histogram of the same bins (per-bin rtol 1e-5, and the total
    mass within rtol 1e-5), and its difference from the plain version must
    stay within rtol 1e-5 of the plain value plus the plain version's own
    float32 accumulation error against float64 (the plain scatter adds a
    bin's samples one after another, so a bin with tens of thousands of
    samples drifts past 1e-5 on its own)."""
    base = _scores(gen, (tasks, n), skewed, device)
    if bounds is None:
        raw = base * 80.0 - 40.0  # logit-like range, normalized per task
    else:
        lo, hi = bounds
        raw = lo + base * (hi - lo)
        raw[:, 7::101] = lo - 1.0  # a sparse few past both edges: clamped
        raw[:, 57::101] = hi + 1.0
    if nan:
        raw[:, ::97] = float("nan")
    if offset:
        buf = torch.empty(tasks * n + offset, device=device)
        buf[offset:] = raw.reshape(-1)
        raw = buf[offset:].view(tasks, n)
    rows = 1 if broadcast else tasks
    labels = (torch.rand((rows, n), generator=gen, device=device) < base[:rows]).to(torch.float32)
    if soft:
        fractional = torch.rand((rows, n), generator=gen, device=device) < soft
        labels = torch.where(fractional, torch.rand((rows, n), generator=gen, device=device), labels)
    weights = torch.rand((rows, n), generator=gen, device=device) if weighted else None
    if broadcast:
        labels = labels.expand(tasks, n)
        weights = None if weights is None else weights.expand(tasks, n)
    out = torch.zeros((tasks, 2, num_bins), dtype=torch.float32, device=device)
    before = _kernels.LAUNCHES["fused_auc_hist"]
    if via_op:
        fa.K1_OP(out, raw, labels, weights, num_bins, None if bounds is None else list(bounds))
    else:
        _histogram_cuda(out, raw, labels, weights, num_bins, bounds, geometry)
    plain = _histogram_plain_full(raw, labels, weights, num_bins, bounds)
    _sync(device)
    _check(
        _kernels.LAUNCHES["fused_auc_hist"] == before + (1 if n else 0),
        "wrapper launch count wrong",
    )
    abs_err = float((out - plain).abs().max()) if out.numel() else 0.0
    rel = plain_rel = mass = 0.0
    if weighted or soft:
        ref = _oracle_hist(_prepare_scores(raw, bounds), labels, weights, num_bins)
        scale = ref.abs().clamp(min=1e-30)
        rel = float(((out.double() - ref).abs() / scale).max())
        plain_err = (plain.double() - ref).abs()
        plain_rel = float((plain_err / scale).max())
        mass = abs(float(out.double().sum() - ref.sum())) / float(ref.sum())
        explained = (out.double() - plain.double()).abs() <= 1e-5 * plain.double().abs() + plain_err
        ok = rel <= 1e-5 and mass <= 1e-5 and bool(explained.all())
    else:
        ok = torch.equal(out, plain)
    case = {
        "n": n, "tasks": tasks, "skewed": skewed, "weighted": weighted,
        "bounds": bounds, "num_bins": num_bins, "nan": nan, "offset": offset,
        "broadcast": broadcast, "soft": soft, "via_op": via_op,
        "design": _k1_design(n, tasks, num_bins, geometry) if n else None,
        "max_abs_err": abs_err, "max_rel_err_vs_float64": rel,
        "plain_max_rel_err_vs_float64": plain_rel, "mass_rel_err": mass,
    }
    _check(ok, f"kernel != plain: {case}")
    return case


def phase_kernel_vs_plain(device, seed=2):
    gen = torch.Generator(device=device).manual_seed(seed)
    all_bounds = [(0.0, 1.0), (-3.0, 5.0), None]
    cases = []
    for n in (4097, 65_536, 1 << 24):
        for tasks in (1, 4):
            for skewed in (False, True):
                for weighted in (False, True):
                    for bounds in all_bounds:
                        cases.append(_kernel_case(gen, n, tasks, skewed, weighted,
                                                  bounds, NUM_BINS, device))
    for num_bins in (512, 65_536):
        for tasks in (1, 4):
            for weighted in (False, True):
                for bounds in all_bounds:
                    cases.append(_kernel_case(gen, 65_536, tasks, True, weighted,
                                              bounds, num_bins, device))
    for bounds in all_bounds:
        for tasks in (1, 4):
            cases.append(_kernel_case(gen, 65_536, tasks, False, False, bounds,
                                      NUM_BINS, device, nan=True))
    for tasks in (1, 4):
        cases.append(_kernel_case(gen, 0, tasks, False, False, (0.0, 1.0), NUM_BINS, device))
    # what vector loads and the cluster layout can break: tiny rows and
    # bin counts below or not a multiple of the cluster size
    for i, (n, num_bins) in enumerate((n, b) for n in (1, 3, 4097) for b in (2, 1000)):
        for tasks in (1, 4):
            for weighted in (False, True):
                cases.append(_kernel_case(gen, n, tasks, True, weighted, all_bounds[i % 3],
                                          num_bins, device))
    # scores one element past a 16-byte boundary
    for n in (4097, 65_536, 1 << 24):
        for tasks in (1, 4):
            for weighted in (False, True):
                cases.append(_kernel_case(gen, n, tasks, True, weighted, (0.0, 1.0),
                                          NUM_BINS, device, offset=1))
    # labels and weights broadcast over 4 tasks (row stride 0)
    for n, offset in ((4097, 0), (65_536, 0), (65_537, 0), (65_537, 1), (1 << 22, 0)):
        for weighted in (False, True):
            cases.append(_kernel_case(gen, n, 4, True, weighted, (0.0, 1.0), NUM_BINS,
                                      device, offset=offset, broadcast=True))
    # 65,536 bins with several clusters a task; 2^20 bins: the global variant
    for num_bins, n in ((65_536, 1 << 22), (1 << 20, 65_536)):
        for tasks in (1, 4):
            for weighted in (False, True):
                cases.append(_kernel_case(gen, n, tasks, True, weighted, (0.0, 1.0),
                                          num_bins, device))
    # fractional labels under unit weights: all of them, or a sparse few
    for n in (4097, 65_536, 1 << 22):
        for tasks in (1, 4):
            for soft in (1.0, 0.01):
                cases.append(_kernel_case(gen, n, tasks, True, False, (0.0, 1.0), NUM_BINS,
                                          device, soft=soft))
    # every design at shapes where the wrapper would pick another
    for n in (4097, 65_536, 1 << 22):
        for geometry in (K1Geometry(1, 1, 65536), K1Geometry(1, 16, 65536),
                         K1Geometry(2, 8, 65536), K1Geometry(4, 1, 65536),
                         K1Geometry(16, 1, 65536), K1Geometry(8, 5, 8192, True),
                         K1Geometry(16, 1, 4096, True), K1Geometry(16, 3, 4096, True)):
            for weighted in (False, True):
                cases.append(_kernel_case(gen, n, 4, True, weighted, (0.0, 1.0), NUM_BINS,
                                          device, geometry=geometry))
    # through the dispatcher op the streaming update launches K1 with
    for n in (4097, 65_536):
        for tasks in (1, 4):
            for weighted in (False, True):
                for bounds in all_bounds:
                    cases.append(_kernel_case(gen, n, tasks, True, weighted, bounds, NUM_BINS,
                                              device, via_op=True))
    return {
        "phase": "kernel_vs_plain", "cases": len(cases),
        "op_cases": sum(1 for c in cases if c["via_op"]),
        "bitwise_cases": sum(1 for c in cases if not (c["weighted"] or c["soft"])),
        "designs": sorted({json.dumps(c["design"], sort_keys=True) for c in cases if c["design"]}),
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "max_rel_err_vs_float64": max(c["max_rel_err_vs_float64"] for c in cases),
        "plain_max_rel_err_vs_float64": max(c["plain_max_rel_err_vs_float64"] for c in cases),
        "max_mass_rel_err": max(c["mass_rel_err"] for c in cases),
    }


def _sync_collection(device, num_classes, exact=False, windowed=False):
    """The sync phases' collection; ``exact`` adds the buffered
    ``BinaryAUROC``/``BinaryAUPRC`` over the click stream, ``windowed`` a
    ``WindowedBinaryAUROC`` (which ships its filled prefix) and a
    ``WindowedBinaryNormalizedEntropy``."""
    coll = {
        "acc": MulticlassAccuracy(device=device),
        "acc_macro": MulticlassAccuracy(average="macro", num_classes=num_classes, device=device),
        "f1_macro": MulticlassF1Score(num_classes=num_classes, average="macro", device=device),
        "loss": Mean(device=device),
        "auroc": StreamingBinaryAUROC(device=device),
        "auprc": StreamingBinaryAUPRC(device=device),
    }
    if exact:
        coll["exact_auroc"] = BinaryAUROC(device=device)
        coll["exact_auprc"] = BinaryAUPRC(device=device)
    if windowed:
        coll["window_auroc"] = WindowedBinaryAUROC(max_num_samples=1 << 22, device=device)
        coll["window_ne"] = WindowedBinaryNormalizedEntropy(device=device)
    return coll


_WINDOWED_SYNC = ("window_auroc", "window_ne")


_CLASSIFY_NAMES = ("acc", "acc_macro", "f1_macro")


def _feed_sync_stream(colls, device, seed, classify_n, num_classes, batch, ctr_n, ctr_batch):
    """Feed the sync phases' stream (classify batches, then click batches,
    from one generator) to ``colls(i)``: the collections batch ``i`` goes
    to, each updating the members it has. Returns the number of click
    batches."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for i, start in enumerate(range(0, classify_n, batch)):
        logits, labels = _classify_batch(gen, min(batch, classify_n - start), num_classes, device)
        batch_loss = F.cross_entropy(logits, labels)
        for coll in colls(i):
            toolkit.update_collection(
                {k: coll[k] for k in _CLASSIFY_NAMES if k in coll}, logits, labels)
            if "loss" in coll:
                coll["loss"].update(batch_loss)
    clicks = 0
    for i, start in enumerate(range(0, ctr_n, ctr_batch)):
        s, y = _clicks(gen, (min(ctr_batch, ctr_n - start),), device)
        for coll in colls(i):
            names = [k for k in ("auroc", "auprc", "exact_auroc", "exact_auprc") + _WINDOWED_SYNC
                     if k in coll]
            toolkit.update_collection({k: coll[k] for k in names}, s, y)
        clicks += 1
    return clicks


def phase_sync(device, classify_n=8192, num_classes=1000, batch=1024,
               ctr_n=1 << 22, ctr_batch=CTR_BATCH, world=4, seed=3):
    group = LocalReplicaGroup([torch.device(device)] * world)
    single = _sync_collection(device, num_classes)
    replicas = [_sync_collection(device, num_classes) for _ in range(world)]
    _feed_sync_stream(lambda i: (single, replicas[i % world]), device, seed,
                      classify_n, num_classes, batch, ctr_n, ctr_batch)
    # timed from a drained queue: the replicas' updates are not the sync's
    seconds = []
    for _ in range(3):
        _sync(device)
        t0 = time.perf_counter()
        synced = toolkit.get_synced_metric_collection(replicas, group)
        values = {name: m.compute() for name, m in synced.items()}
        _sync(device)
        seconds.append(time.perf_counter() - t0)
    expected = {name: m.compute() for name, m in single.items()}
    for name in ("acc", "acc_macro", "f1_macro", "auroc", "auprc"):
        for state in synced[name].state_dict():
            _check(
                torch.equal(getattr(synced[name], state), getattr(single[name], state)),
                f"synced {name}.{state} != single stream",
            )
        _check(torch.equal(values[name], expected[name]), f"synced {name} != single stream")
    loss_err = float((values["loss"] - expected["loss"]).abs())
    _check(loss_err <= 1e-6 * max(1.0, float(expected["loss"].abs())), f"loss off by {loss_err}")
    return {
        "phase": "sync", "device": str(device), "world": world,
        "classify_samples": classify_n, "ctr_samples": ctr_n,
        "values": {k: float(v) for k, v in values.items()},
        "bitwise": ["acc", "acc_macro", "f1_macro", "auroc", "auprc"],
        "loss_abs_err": loss_err, "sync_seconds": sorted(seconds)[1],
        "sync_seconds_runs": seconds,
    }


# ----------------------------------------------------------- exact curves


def _exact_oracle(scores, labels):
    """float64 exact AUROC and average precision of each row of (R, n)
    scores with 0/1 labels, from integer counts of each tie group, apart
    from the metrics' cumsum/trapezoid chain: AUROC is the Mann-Whitney
    statistic over mid-ranks, ``(R+ - P(P+1)/2) / (P N)``; average
    precision sums, over the distinct thresholds from the top, each one's
    recall step times its precision. NaN for a row without positives or
    without negatives."""
    rows, n = scores.shape
    s, order = torch.sort(scores, dim=-1)
    y = torch.gather(labels.to(torch.int64), 1, order).reshape(-1)
    new = torch.ones_like(s, dtype=torch.bool)
    new[:, 1:] = s[:, 1:] != s[:, :-1]
    new = new.reshape(-1)
    gid = torch.cumsum(new, 0) - 1  # tie groups, numbered across rows
    groups = int(gid[-1]) + 1
    cnt = torch.bincount(gid, minlength=groups)
    pos = torch.zeros(groups, dtype=torch.int64, device=s.device).index_add_(0, gid, y)
    row = torch.arange(rows, device=s.device).repeat_interleave(n)[new]
    first_gid = gid[torch.arange(rows, device=s.device) * n]
    cnt_below = torch.cumsum(cnt, 0) - cnt  # samples in lower groups (all rows)
    pos_below = torch.cumsum(pos, 0) - pos
    cnt_below = cnt_below - cnt_below[first_gid][row]  # ... of this row
    pos_below = pos_below - pos_below[first_gid][row]
    p = labels.to(torch.int64).sum(-1)
    neg = n - p
    midrank = cnt_below.double() + (cnt.double() + 1.0) / 2.0
    rank_sum = torch.zeros(rows, dtype=torch.float64, device=s.device).index_add_(
        0, row, midrank * pos.double())
    pd, nd = p.double(), neg.double()
    auroc = (rank_sum - pd * (pd + 1.0) / 2.0) / (pd * nd)
    tp = p[row] - pos_below  # samples at or above the group's threshold
    fp = neg[row] - (cnt_below - pos_below)
    ap = torch.zeros(rows, dtype=torch.float64, device=s.device).index_add_(
        0, row, pos.double() * tp.double() / (tp + fp).double()) / pd
    bad = (p == 0) | (neg == 0)
    nan = torch.full_like(auroc, float("nan"))
    return torch.where(bad, nan, auroc), torch.where(bad, nan, ap)


def _profile(fn, device, reps=1, ops=()):
    """Device time of one call of ``fn`` (every CUDA kernel's self time
    in a torch.profiler trace of ``reps`` calls, over ``reps``), its kernel
    launches a call, its five costliest kernels and, in ``op_ms``, the device time under each aten
    op named in ``ops``. A trace that shows no kernel, or no device time
    under one of ``ops``, is taken again, up to ``PROFILE_ATTEMPTS``
    traces in all, the last failing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_ATTEMPTS):
        _sync(device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            _sync(device)
        kernels, op_ms = [], dict.fromkeys(ops, 0.0)
        for evt in prof.key_averages():
            if evt.device_type == DeviceType.CUDA:
                us = getattr(evt, "self_device_time_total", None)
                if us is None:
                    us = evt.self_cuda_time_total
                kernels.append((us / 1e3 / reps, evt.count / reps, evt.key))
            elif evt.key in op_ms:
                us = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0.0)
                op_ms[evt.key] += us / 1e3 / reps
        kernels.sort(reverse=True)
        if kernels and kernels[0][0] > 0 and all(v > 0 for v in op_ms.values()):
            out = {"device_ms": sum(k[0] for k in kernels),
                   "launches": sum(k[1] for k in kernels),
                   "top_kernels": [[k[2][:80], k[0], k[1]] for k in kernels[:5]]}
            if ops:
                out["op_ms"] = op_ms
            return out
    raise AssertionError(f"profiler shows no device time (ops {list(ops)})")


def _timed_compute(metric, device):
    """One ``compute()`` from a drained queue, timed to its result."""
    _sync(device)
    t0 = time.perf_counter()
    value = metric.compute()
    _sync(device)
    return value, time.perf_counter() - t0


def _buffer_bytes(*metrics):
    return sum(getattr(m, name).numel() * getattr(m, name).element_size()
               for m in metrics for name in m._buffer_specs)


def phase_curve(device, n=CRITEO_EVAL, batch=CTR_BATCH, cls_n=IMAGENET_VAL,
                num_classes=1000, cls_batch=1024, num_bins=NUM_BINS, seed=5):
    """Exact AUROC/AUPRC over growable buffers at Criteo 1TB evaluation
    scale, plus the fused histogram AUROC on the same stream, and the
    multiclass pair over ImageNet-1k validation; each held to a float64
    oracle."""
    cuda = torch.device(device).type == "cuda"
    auroc = BinaryAUROC(device=device)
    auprc = BinaryAUPRC(device=device)
    fused = BinaryAUROC(use_fused=True, device=device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(seed)
    for start in range(0, n, batch):
        s, y = _clicks(gen, (min(batch, n - start),), device)
        for m in (auroc, auprc, fused):
            m.update(s, y)
    _sync(device)
    stream_seconds = time.perf_counter() - t0
    buffer_bytes = _buffer_bytes(auroc, auprc, fused)

    before = _kernels.LAUNCHES["fused_auc_hist"]
    values, wall = {}, {}
    for name, m in (("auroc", auroc), ("auprc", auprc), ("auroc_fused", fused)):
        values[name], wall[name] = _timed_compute(m, device)
    launches = _kernels.LAUNCHES["fused_auc_hist"] - before
    # once more: the first computes also load kernels and grow the allocator
    warm = {name: _timed_compute(m, device)[1]
            for name, m in (("auroc", auroc), ("auprc", auprc), ("auroc_fused", fused))}
    _check(launches == (1 if cuda else 0), f"the fused compute launched K1 {launches} times")
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    profiles, cummin_ms = {}, {}
    if cuda:
        for name, m in (("auroc", auroc), ("auprc", auprc), ("auroc_fused", fused)):
            profiles[name] = _profile(m.compute, device)
        # both sides of the reverse cummin's design: one sequential scan of
        # the 2^27-slot row against the two-level scan the metrics run
        row = auroc.inputs
        cummin_ms = {
            "one_level": _time_ms(lambda: torch.cummin(torch.flip(row, (-1,)), -1), device, 1),
            "two_level": _time_ms(lambda: _reverse_cummin(row), device, 5),
        }

    # the fused value against the plain histogram of the same valid samples
    inputs, targets, weights = (b[None] for b in fused._valid())
    plain_hist = _histogram_plain_full(inputs, targets, weights, num_bins, None)
    kernel_hist = fa.histogram_delta_kernel(inputs, targets, weights, num_bins, None)
    _check(torch.equal(kernel_hist, plain_hist), "fused compute's histogram != plain version")
    _check(torch.equal(values["auroc_fused"], _auc_from_hist(plain_hist)[0]),
           "fused AUROC != plain histogram AUROC")
    use_fused = {}
    if cuda:
        # the use_fused compute's histogram over the valid samples: K1
        # (with its min/max), the plain version, and one torch.bincount
        # over precomputed bin indices (binning not timed)
        bins = (torch.clamp(torch.nan_to_num(fa._prepare_scores(inputs, None), nan=0.0), 0.0, 1.0)
                * num_bins).to(torch.int64).clamp_(0, num_bins - 1).reshape(-1)
        idx2 = torch.cat([bins, bins + num_bins])
        w2 = torch.cat([(weights * targets).reshape(-1), (weights * (1.0 - targets)).reshape(-1)])
        del bins
        use_fused = {
            "samples": inputs.shape[-1],
            "kernel_ms": _time_ms(lambda: fa.histogram_delta_kernel(
                inputs, targets, weights, num_bins, None), device, 3),
            "plain_ms": _time_ms(lambda: _histogram_plain_full(
                inputs, targets, weights, num_bins, None), device, 3),
            "library_ms": _time_ms(lambda: torch.bincount(
                idx2, weights=w2, minlength=2 * num_bins), device, 3),
        }
        del idx2, w2
    del inputs, targets, weights, plain_hist, kernel_hist

    gen = torch.Generator(device=device).manual_seed(seed)
    stream = [_clicks(gen, (min(batch, n - start),), device) for start in range(0, n, batch)]
    scores = torch.cat([s for s, _ in stream])[None]
    clicks = torch.cat([y for _, y in stream])[None]
    del stream
    o_auroc, o_auprc = (float(v[0]) for v in _exact_oracle(scores, clicks))
    del scores, clicks
    err = {"auroc": abs(float(values["auroc"]) - o_auroc),
           "auprc": abs(float(values["auprc"]) - o_auprc)}
    _check(max(err.values()) <= CURVE_TOL, f"exact curve values off the float64 oracle: {err}")
    criteo = {
        "samples": n, "batch": batch, "stream_seconds": stream_seconds,
        "capacity": auroc.inputs.shape[-1], "buffer_bytes": buffer_bytes,
        "peak_bytes": peak, "values": {k: float(v) for k, v in values.items()},
        "oracle": {"auroc": o_auroc, "auprc": o_auprc}, "err_vs_float64": err,
        "fused_minus_exact": float(values["auroc_fused"]) - o_auroc,
        "compute_wall_s": wall, "compute_wall_s_warm": warm, "compute_profile": profiles,
        "reverse_cummin_ms": cummin_ms, "use_fused_histogram": use_fused,
    }
    del auroc, auprc, fused, values

    mc_auroc = MulticlassAUROC(num_classes=num_classes, device=device)
    mc_auprc = MulticlassAUPRC(num_classes=num_classes, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    probs_all, labels_all = [], []
    for start in range(0, cls_n, cls_batch):
        logits, labels = _classify_batch(gen, min(cls_batch, cls_n - start), num_classes, device)
        probs = torch.softmax(logits, dim=-1)
        mc_auroc.update(probs, labels)
        mc_auprc.update(probs, labels)
        probs_all.append(probs)
        labels_all.append(labels)
    cls_values, cls_wall, cls_profiles = {}, {}, {}
    for name, m in (("auroc_macro", mc_auroc), ("auprc_macro", mc_auprc)):
        cls_values[name], cls_wall[name] = _timed_compute(m, device)
        if cuda:
            cls_profiles[name] = _profile(m.compute, device)
    inputs, targets = mc_auroc._padded()
    per_auroc = _multiclass_auroc_compute(inputs, targets, mc_auroc._valid_mask(inputs.shape[0]))
    per_auprc = _multiclass_auprc_compute(*mc_auprc._padded())
    _check(torch.equal(torch.mean(per_auroc), cls_values["auroc_macro"])
           and torch.equal(torch.mean(per_auprc), cls_values["auprc_macro"]),
           "macro values != the mean of the per-class values")
    probs = torch.cat(probs_all)
    labels = torch.cat(labels_all)
    onehot = labels[None, :] == torch.arange(num_classes, device=device)[:, None]
    o_auroc, o_auprc = _exact_oracle(probs.T, onehot)
    scored = ~torch.isnan(o_auroc)
    _check(bool(scored.any()), "no class has both positives and negatives")
    cls_err = {
        "auroc": float((per_auroc.double() - o_auroc)[scored].abs().max()),
        "auprc": float((per_auprc.double() - o_auprc)[scored].abs().max()),
    }
    _check(max(cls_err.values()) <= CURVE_TOL,
           f"per-class curve values off the float64 oracle: {cls_err}")
    imagenet = {
        "samples": cls_n, "num_classes": num_classes, "batch": cls_batch,
        "classes_scored": int(scored.sum()),
        "values": {k: float(v) for k, v in cls_values.items()},
        "max_class_err_vs_float64": cls_err, "compute_wall_s": cls_wall,
        "compute_profile": cls_profiles,
    }
    return {"phase": "curve", "device": str(device), "k1_launches": launches,
            "criteo": criteo, "imagenet": imagenet}


# ------------------------------------------------------ multi-process sync


def _spawn_ranks(target, world, args, timeout):
    """Run ``target(rank, world, *args)`` in ``world`` spawned processes
    and wait for them all. A rank that exits non-zero, or the timeout,
    ends the others at once and raises; no process outlives the call."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(rank, world, *args)) for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise RuntimeError(f"spawned ranks exited with {codes} (timeout {timeout} s)")


def _cpu_states(state_dicts):
    return {name: {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in sd.items()}
            for name, sd in state_dicts.items()}


def _cpu_value(v):
    """A computed value on the host; a windowed metric's (lifetime,
    windowed) pair stays a tuple."""
    return tuple(t.cpu() for t in v) if isinstance(v, tuple) else v.cpu()


def _float_value(v):
    return [float(t) for t in v] if isinstance(v, tuple) else float(v)


def _same_state(a, b) -> bool:
    if isinstance(a, tuple):
        return isinstance(b, tuple) and len(a) == len(b) and all(map(_same_state, a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    return type(a) is type(b) and a == b


def _mp_rank(rank, world, device, out_dir, sizes, seed):
    """One rank of ``phase_mp_sync``: its share of the sync stream, then
    the syncs, written to ``out_dir/rank<r>.pt``."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
                            rank=rank, world_size=world)
    try:
        coll = _sync_collection(device, sizes["num_classes"], exact=True, windowed=True)
        _kernels.reset_launch_counts()
        clicks = _feed_sync_stream(
            lambda i: (coll,) if i % world == rank else (), device, seed, sizes["classify_n"],
            sizes["num_classes"], sizes["batch"], sizes["ctr_n"], sizes["ctr_batch"])
        launches = _kernels.LAUNCHES["fused_auc_hist"]
        group = MultiHostGroup()
        values = toolkit.sync_and_compute_collection(coll, group)
        state_dicts = toolkit.get_synced_state_dict_collection(coll, group)
        seconds = []
        for _ in range(3):
            _sync(device)
            t0 = time.perf_counter()
            synced = toolkit.get_synced_metric_collection(coll, group)
            for m in synced.values():
                m.compute()
            _sync(device)
            seconds.append(time.perf_counter() - t0)
        sub = group.new_subgroup([1])
        before = {name: m.state_dict() for name, m in coll.items()}
        untouched = toolkit.get_synced_metric_collection(coll, sub) is coll and all(
            _same_state(v, getattr(coll[name], k))
            for name, sd in before.items() for k, v in sd.items())
        torch.save({
            "values": {k: _cpu_value(v) for k, v in values.items()},
            "state_dicts": _cpu_states(state_dicts), "seconds": seconds,
            "launches": launches, "clicks": (clicks - rank + world - 1) // world,
            "sub_member": sub.is_member, "sub_untouched": untouched,
        }, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_mp_sync(device, classify_n=8192, num_classes=1000, batch=1024,
                  ctr_n=1 << 22, ctr_batch=CTR_BATCH, world=2, seed=6, timeout=600):
    """``world`` spawned ranks, one process each, joined by gloo over a
    ``FileStore``; metric state on ``device``. Each rank feeds its share
    (batch ``i`` to rank ``i % world``) of the ``sync`` phase's stream to
    that phase's collection plus exact ``BinaryAUROC``/``BinaryAUPRC`` and
    two windowed metrics, then syncs over a ``MultiHostGroup``. Every
    rank's synced values and state must equal one process's stream bitwise
    (the loss mean within 1e-6), and the windowed ones a one-process
    ``merge_state`` of per-rank metrics; a subgroup of rank 1 must leave
    rank 0 untouched."""
    cuda = torch.device(device).type == "cuda"
    sizes = {"classify_n": classify_n, "num_classes": num_classes, "batch": batch,
             "ctr_n": ctr_n, "ctr_batch": ctr_batch}
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        _spawn_ranks(_mp_rank, world, (str(device), out_dir, sizes, seed), timeout)
        spawn_seconds = time.perf_counter() - t0
        ranks = []
        for r in range(world):
            path = os.path.join(out_dir, f"rank{r}.pt")
            _check(os.path.exists(path), f"rank {r} wrote no result")
            ranks.append(torch.load(path, weights_only=False))

    # one process: the stream in order, and in the merged order (rank 0's
    # batches, then rank 1's, ...) that the synced buffers hold
    single = _sync_collection(device, num_classes, exact=True)
    _feed_sync_stream(lambda i: (single,), device, seed, classify_n, num_classes, batch,
                      ctr_n, ctr_batch)
    expected = {name: m.compute() for name, m in single.items()}
    merged_order = {k: _sync_collection(device, num_classes, exact=True)[k]
                    for k in ("exact_auroc", "exact_auprc")}
    per_rank = [{k: _sync_collection(device, num_classes, windowed=True)[k] for k in _WINDOWED_SYNC}
                for _ in range(world)]
    for owner in range(world):
        _feed_sync_stream(lambda i: (merged_order, per_rank[owner]) if i % world == owner else (),
                          device, seed, classify_n, num_classes, batch, ctr_n, ctr_batch)
    windowed = per_rank[0]
    for k in _WINDOWED_SYNC:
        windowed[k].merge_state([ranked[k] for ranked in per_rank[1:]])
        expected[k] = windowed[k].compute()
    states = _cpu_states({name: m.state_dict() for name, m in single.items()})
    states.update(_cpu_states({k: m.state_dict() for k, m in merged_order.items()}))
    states.update(_cpu_states({k: m.state_dict() for k, m in windowed.items()}))
    loss_err = 0.0
    for r, got in enumerate(ranks):
        for name, value in got["values"].items():
            want = _cpu_value(expected[name])
            if name == "loss":
                loss_err = max(loss_err, float((value - want).abs()))
            else:
                _check(_same_state(value, want), f"rank {r}: synced {name} != single stream")
            for k, v in got["state_dicts"][name].items():
                _check(name == "loss" or _same_state(v, states[name][k]),
                       f"rank {r}: synced state {name}.{k} != single stream")
        _check(got["sub_member"] == (r == 1), f"rank {r}: subgroup membership wrong")
        _check(got["sub_untouched"], f"rank {r}: subgroup [1] sync touched its metrics")
        if cuda:
            _check(got["launches"] == 2 * got["clicks"],
                   f"rank {r}: K1 launched {got['launches']} times for {got['clicks']} click batches")
    _check(loss_err <= 1e-6 * max(1.0, float(expected["loss"].abs())), f"loss off by {loss_err}")
    seconds = [sorted(got["seconds"])[1] for got in ranks]
    return {
        "phase": "mp_sync", "device": str(device), "world": world, "backend": "gloo",
        "classify_samples": classify_n, "ctr_samples": ctr_n,
        "values": {k: _float_value(v) for k, v in ranks[0]["values"].items()},
        "bitwise": sorted(k for k in expected if k != "loss"), "loss_abs_err": loss_err,
        "windowed_vs": "one-process merge_state of per-rank metrics",
        "sync_seconds": seconds, "sync_seconds_runs": [got["seconds"] for got in ranks],
        "k1_launches": [got["launches"] for got in ranks], "spawn_seconds": spawn_seconds,
    }


# ------------------------------------------------------------ counters


OPENIMAGES_VAL = 41_620  # OpenImages V6 validation images
OPENIMAGES_LABELS = 600  # boxable classes
AVERAGES = ("micro", "macro", "weighted", None)
CRITERIA = ("exact_match", "hamming", "overlap", "contain", "belong")


def _grid_bins(scores, grid):
    """Oracle bin of each score on a ``linspace(0, 1, T)`` grid: the last
    threshold at or below it, -1 below the grid; found from
    ``floor(score * (T - 1))`` in float64 and corrected by one exact
    float32 compare each way, apart from the metrics' searches. Checks its
    own answer."""
    t = grid.shape[0]
    j = torch.floor(scores.double() * (t - 1)).clamp(-1, t - 1).to(torch.int64)
    at = grid[j.clamp(min=0)]
    j = torch.where((j >= 0) & (at > scores), j - 1, j)
    up = grid[(j + 1).clamp(max=t - 1)]
    j = torch.where((j + 1 < t) & (up <= scores), j + 1, j)
    below = j < 0
    ok = torch.where(below, grid[0] > scores, grid[j.clamp(min=0)] <= scores)
    ok &= (j == t - 1) | (grid[(j + 1).clamp(max=t - 1)] > scores)
    _check(bool(ok.all()), "oracle grid bins inconsistent")
    return j


def _binned_oracle(bins, columns, is_target, num_t):
    """int64 (T, K, 2) histogram [negative, positive] of (N, K) oracle
    bins; bins below the grid are dropped."""
    k = bins.shape[-1] if bins.ndim == 2 else 1
    col = columns if columns is not None else torch.zeros_like(bins)
    flat = (bins * k + col) * 2 + is_target.to(torch.int64)
    flat = torch.where(bins >= 0, flat, torch.full_like(flat, num_t * k * 2))
    return torch.bincount(flat.reshape(-1), minlength=num_t * k * 2 + 1)[:-1].reshape(num_t, k, 2)


def _oracle_counters(hist):
    """(tp, fp, fn) int64 (T, K) from an int64 (T, K, 2) histogram."""
    suffix = torch.flip(torch.cumsum(torch.flip(hist, (0,)), 0), (0,))
    fp, tp = suffix[..., 0], suffix[..., 1]
    return tp, fp, hist[..., 1].sum(0, keepdim=True) - tp


def _ulp32(x):
    """float32 spacing at each |x| (float64)."""
    x32 = x.abs().to(torch.float32)
    return (torch.nextafter(x32, torch.full_like(x32, float("inf"))) - x32).double()


def _within_bound(states, oracles, updates):
    """float32 counters against exact counts: each update adds an exact
    integer and rounds by at most half an ulp of the running count, so
    ``|error| <= updates * ulp(final) / 2`` a counter. Returns (ok, max
    error, exact)."""
    ok, worst, exact = True, 0.0, True
    for state, oracle in zip(states, oracles):
        oracle = oracle.to(state.device).double()
        err = (state.double() - oracle).abs()
        ok &= bool((err <= updates * _ulp32(oracle) / 2).all())
        worst = max(worst, float(err.max()))
        exact &= bool((err == 0).all())
    return ok, worst, exact


def _binned_auroc64(tp, fp):
    """float64 binned AUROC of (T, ...) ascending-threshold counts: the
    trapezoid over the ROC points from the top threshold down, (0, 0)
    first; 0.5 without positives or negatives."""
    zero = torch.zeros_like(tp[:1])
    y = torch.cat([zero, torch.flip(tp, (0,))]).double()
    x = torch.cat([zero, torch.flip(fp, (0,))]).double()
    area = ((x[1:] - x[:-1]) * (y[1:] + y[:-1]) / 2).sum(0)
    factor = y[-1] * x[-1]
    return torch.where(factor == 0, torch.full_like(area, 0.5), area / factor.clamp(min=1))


def _binned_auprc64(tp, fp, fn):
    """float64 binned AUPRC of (T, ...) counts: recall steps from the top
    threshold down to recall 0, each times the precision at its lower end
    (precision 1 where nothing is predicted)."""
    tp, fp, fn = tp.double(), fp.double(), fn.double()
    pred = tp + fp
    precision = torch.where(pred > 0, tp / pred.clamp(min=1), torch.ones_like(tp))
    recall = tp / (tp + fn)
    recall = torch.cat([recall, torch.zeros_like(recall[:1])])
    precision = torch.cat([precision, torch.ones_like(precision[:1])])
    return torch.nan_to_num((-(recall[1:] - recall[:-1]) * precision[:-1]).sum(0), nan=0.0)


def _timed_update(timers, name, device, fn):
    """Run ``fn`` from a drained queue and add its wall ms to
    ``timers[name]``."""
    _sync(device)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    timers.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)


def _median(values):
    return sorted(values)[len(values) // 2]


def _mode_device_ms(make, inputs, targets, device):
    """Device time of one update in each ``optimization`` mode, on fresh
    metrics fed the stream's last batch (CUDA only): what the card spends,
    apart from the host's launch cost."""
    if torch.device(device).type != "cuda":
        return None
    return {mode: _profile(lambda m=make(mode): m.update(inputs, targets), device, reps=10)["device_ms"]
            for mode in ("vectorized", "memory")}


def _compute_reports(metrics, device):
    """Each metric's compute: its value, its wall time (first and warm,
    each from a drained queue), its device time and costliest kernels
    (profiler) and the peak bytes allocated during it."""
    cuda = torch.device(device).type == "cuda"
    values, report = {}, {}
    for name, m in metrics.items():
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        values[name], first = _timed_compute(m, device)
        peak = torch.cuda.max_memory_allocated(device) if cuda else None
        warm = _timed_compute(m, device)[1]
        entry = {"wall_ms_first": first * 1e3, "wall_ms_warm": warm * 1e3, "peak_bytes": peak}
        if cuda:
            entry.update(_profile(m.compute, device, reps=10))
        report[name] = entry
    return values, report


def _stream_peak(device):
    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else None


def _reset_peak(device):
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _counters_imagenet(device, n, num_classes, batch, num_t, seed):
    """ImageNet-1k validation: logits into the confusion matrix, precision
    and recall; softmax scores into the multiclass binned family."""
    cm = MulticlassConfusionMatrix(num_classes, device=device)
    prec = {str(a): MulticlassPrecision(num_classes=num_classes, average=a, device=device)
            for a in AVERAGES}
    rec = {str(a): MulticlassRecall(num_classes=num_classes, average=a, device=device)
           for a in AVERAGES}
    prc = {mode: MulticlassBinnedPrecisionRecallCurve(
        num_classes=num_classes, threshold=num_t, optimization=mode, device=device)
        for mode in ("vectorized", "memory")}
    auroc = MulticlassBinnedAUROC(num_classes=num_classes, threshold=num_t, device=device)
    auprc = MulticlassBinnedAUPRC(num_classes=num_classes, threshold=num_t, device=device)
    grid = prc["memory"].threshold
    cm_oracle = torch.zeros(num_classes * num_classes, dtype=torch.int64)
    hist = torch.zeros((num_t, num_classes, 2), dtype=torch.int64, device=device)
    timers, updates = {}, 0
    classes = torch.arange(num_classes, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    _reset_peak(device)
    for start in range(0, n, batch):
        logits, labels = _classify_batch(gen, min(batch, n - start), num_classes, device)
        probs = torch.softmax(logits, dim=-1)
        _timed_update(timers, "confusion_matrix", device, lambda: cm.update(logits, labels))
        _timed_update(timers, "precision_x4", device,
                      lambda: [m.update(logits, labels) for m in prec.values()])
        _timed_update(timers, "recall_x4", device,
                      lambda: [m.update(logits, labels) for m in rec.values()])
        for mode, m in prc.items():
            _timed_update(timers, f"binned_prc_{mode}", device, lambda m=m: m.update(probs, labels))
        _timed_update(timers, "binned_auroc_append", device, lambda: auroc.update(probs, labels))
        _timed_update(timers, "binned_auprc", device, lambda: auprc.update(probs, labels))
        updates += 1
        # oracle: int64 counts on the host and the device, apart from the metrics
        pred = logits.double().argmax(dim=-1)
        cm_oracle += torch.bincount((labels * num_classes + pred).cpu(),
                                    minlength=num_classes * num_classes)
        onehot = labels[:, None] == classes[None, :]
        hist += _binned_oracle(_grid_bins(probs, grid), classes[None, :], onehot, num_t)
    stream_peak = _stream_peak(device)

    cm_oracle = cm_oracle.reshape(num_classes, num_classes)
    _check(torch.equal(cm.confusion_matrix.cpu().to(torch.int64), cm_oracle),
           "confusion matrix != int64 oracle")
    tp_c = torch.diag(cm_oracle).double()
    pred_c, label_c = cm_oracle.sum(0).double(), cm_oracle.sum(1).double()
    seen = (label_c > 0) | (pred_c > 0)
    per = {"precision": torch.nan_to_num(tp_c / pred_c), "recall": torch.nan_to_num(tp_c / label_c)}
    want = {}
    for kind, values in per.items():
        want[f"{kind}_micro"] = tp_c.sum() / label_c.sum()
        want[f"{kind}_macro"] = values[seen].mean()
        want[f"{kind}_weighted"] = (values * label_c / label_c.sum()).sum()
        want[f"{kind}_None"] = values
    got = {f"precision_{a}": m.compute() for a, m in prec.items()}
    got.update({f"recall_{a}": m.compute() for a, m in rec.items()})
    rate_err = max(float((got[k].double().cpu() - want[k]).abs().max()) for k in want)
    _check(rate_err <= 1e-6, f"precision/recall off the float64 oracle by {rate_err}")

    modes_bitwise = all(torch.equal(getattr(prc["vectorized"], s), getattr(prc["memory"], s))
                        for s in ("num_tp", "num_fp", "num_fn"))
    _check(modes_bitwise, "vectorized and memory binned PRC counters differ")
    tp, fp, fn = _oracle_counters(hist)
    ok, count_err, exact = _within_bound(
        [prc["memory"].num_tp, prc["memory"].num_fp, prc["memory"].num_fn], [tp, fp, fn], updates)
    _check(ok, f"binned PRC counters past the accumulation bound (max error {count_err})")
    # (the confusion matrix's compute hands back its state: no kernel to time)
    values, computes = _compute_reports(
        {"precision_macro": prec["macro"], "recall_macro": rec["macro"],
         "binned_prc_vectorized": prc["vectorized"], "binned_prc_memory": prc["memory"],
         "binned_auroc": auroc, "binned_auprc": auprc}, device)
    auroc_err = abs(float(values["binned_auroc"][0]) - float(_binned_auroc64(tp, fp).mean()))
    auprc_err = abs(float(values["binned_auprc"]) - float(_binned_auprc64(tp, fp, fn).mean()))
    _check(auroc_err <= 1e-6, f"binned AUROC off the float64 oracle by {auroc_err}")
    _check(auprc_err <= CURVE_TOL, f"binned AUPRC off the float64 oracle by {auprc_err}")
    return {
        "samples": n, "num_classes": num_classes, "batch": batch, "num_thresholds": num_t,
        "updates": updates, "prc_modes_bitwise": modes_bitwise, "counters_exact": exact,
        "counter_max_err": count_err, "rate_max_err_vs_float64": rate_err,
        "binned_auroc_err_vs_float64": auroc_err, "binned_auprc_err_vs_float64": auprc_err,
        "values": {"binned_auroc_macro": float(values["binned_auroc"][0]),
                   "binned_auprc_macro": float(values["binned_auprc"]),
                   "precision_macro": float(values["precision_macro"]),
                   "recall_macro": float(values["recall_macro"])},
        "update_ms_median": {k: _median(v) for k, v in timers.items()},
        "update_ms_first": {k: v[0] for k, v in timers.items()},
        "vectorized_over_memory": _median(timers["binned_prc_vectorized"])
        / _median(timers["binned_prc_memory"]),
        "prc_update_device_ms": _mode_device_ms(
            lambda mode: MulticlassBinnedPrecisionRecallCurve(
                num_classes=num_classes, threshold=num_t, optimization=mode, device=device),
            probs, labels, device),
        "stream_peak_bytes": stream_peak, "compute": computes,
    }


def _counters_criteo(device, n, batch, buffered, hist_bins, num_t, seed):
    """The Criteo 1TB evaluation click stream into the binary binned
    family, the histogram AUROC at each of ``hist_bins`` thresholds, the
    buffered binned AUROC over its first ``buffered`` samples, and
    ``StreamingBinaryAUROC`` beside them (K1, once an update)."""
    cuda = torch.device(device).type == "cuda"
    prc = BinaryBinnedPrecisionRecallCurve(threshold=num_t, device=device)
    auprc = BinaryBinnedAUPRC(threshold=num_t, device=device)
    hists = {t: HistogramBinnedAUROC(threshold=t, device=device) for t in hist_bins}
    bauroc = BinaryBinnedAUROC(threshold=num_t, device=device)
    streaming = StreamingBinaryAUROC(num_bins=NUM_BINS, device=device)
    oracle = {t: torch.zeros((t, 1, 2), dtype=torch.int64, device=device) for t in hist_bins}
    grid = {t: h.threshold for t, h in hists.items()}
    prc_hist = torch.zeros((num_t, 1, 2), dtype=torch.int64, device=device)
    buffered_hist = torch.zeros_like(prc_hist)
    k1_ref = torch.zeros((1, 2, NUM_BINS), dtype=torch.float64, device=device)
    timers, updates = {}, 0
    _kernels.reset_launch_counts()
    _reset_peak(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for start in range(0, n, batch):
        s, y = _clicks(gen, (min(batch, n - start),), device)
        _timed_update(timers, "binned_prc", device, lambda: prc.update(s, y))
        _timed_update(timers, "binned_auprc", device, lambda: auprc.update(s, y))
        for t, h in hists.items():
            _timed_update(timers, f"hist_auroc_{t}", device, lambda h=h: h.update(s, y))
        _timed_update(timers, "streaming_auroc", device, lambda: streaming.update(s, y))
        head = max(0, min(buffered - start, s.shape[0]))
        if head:
            _timed_update(timers, "binned_auroc_append", device,
                          lambda: bauroc.update(s[:head], y[:head]))
        updates += 1
        is_pos = y > 0.5
        for t in hist_bins:
            bins = _grid_bins(s, grid[t])
            oracle[t] += _binned_oracle(bins[:, None], None, is_pos[:, None], t)
        prc_bins = _grid_bins(s, prc.threshold)
        prc_hist += _binned_oracle(prc_bins[:, None], None, is_pos[:, None], num_t)
        if head:
            buffered_hist += _binned_oracle(prc_bins[:head, None], None, is_pos[:head, None], num_t)
        k1_ref += _oracle_hist(s[None], y[None], None, NUM_BINS)
    stream_peak = _stream_peak(device)
    launches = _kernels.LAUNCHES["fused_auc_hist"]
    if cuda:
        _check(launches == updates, f"K1 launched {launches} times for {updates} streaming updates")
    _check(torch.equal(streaming.hist.double(), k1_ref), "streaming histogram != float64 oracle")

    hist_bitwise, hist_err = [], []
    values, computes = _compute_reports(
        {"binned_prc": prc, "binned_auprc": auprc, "binned_auroc_buffered": bauroc,
         **{f"hist_auroc_{t}": h for t, h in hists.items()}}, device)
    for t, h in hists.items():
        flat = torch.cat([oracle[t][:, 0, 0], oracle[t][:, 0, 1]])
        hist_bitwise.append(torch.equal(h.hist.to(torch.int64), flat))
        otp, ofp, _ = _oracle_counters(oracle[t])
        hist_err.append(abs(float(values[f"hist_auroc_{t}"][0]) - float(_binned_auroc64(otp, ofp)[0])))
    _check(all(hist_bitwise), "HistogramBinnedAUROC histogram != int64 oracle")
    _check(max(hist_err) <= 1e-6, f"HistogramBinnedAUROC off the float64 trapezoid by {hist_err}")
    tp, fp, fn = _oracle_counters(prc_hist)
    ok, count_err, exact = _within_bound(
        [prc.num_tp, prc.num_fp, prc.num_fn], [tp[:, 0], fp[:, 0], fn[:, 0]], updates)
    _check(ok, f"binned PRC counters past the accumulation bound (max error {count_err})")
    _check(all(torch.equal(getattr(prc, k), getattr(auprc, k)) for k in ("num_tp", "num_fp", "num_fn")),
           "binned AUPRC counters != binned PRC counters")
    auprc_err = abs(float(values["binned_auprc"]) - float(_binned_auprc64(tp, fp, fn)[0]))
    _check(auprc_err <= CURVE_TOL, f"binned AUPRC off the float64 oracle by {auprc_err}")
    btp, bfp, _ = _oracle_counters(buffered_hist)
    bauroc_err = abs(float(values["binned_auroc_buffered"][0]) - float(_binned_auroc64(btp, bfp)[0]))
    _check(bauroc_err <= 1e-6, f"buffered binned AUROC off the float64 oracle by {bauroc_err}")
    return {
        "samples": n, "batch": batch, "num_thresholds": num_t, "hist_thresholds": list(hist_bins),
        "buffered_samples": min(buffered, n), "updates": updates, "k1_launches": launches,
        "hist_bitwise": hist_bitwise, "hist_auroc_err_vs_float64": hist_err,
        "counters_exact": exact, "counter_max_err": count_err,
        "binned_auprc_err_vs_float64": auprc_err, "buffered_auroc_err_vs_float64": bauroc_err,
        "values": {"binned_auprc": float(values["binned_auprc"]),
                   "binned_auroc_buffered": float(values["binned_auroc_buffered"][0]),
                   **{f"hist_auroc_{t}": float(values[f"hist_auroc_{t}"][0]) for t in hist_bins}},
        "update_ms_median": {k: _median(v) for k, v in timers.items()},
        "update_ms_first": {k: v[0] for k, v in timers.items()},
        "stream_peak_bytes": stream_peak, "compute": computes,
    }


def _multilabel_batch(gen, n, num_labels, device):
    """OpenImages-like multilabel scores: about two positive labels an
    image, their scores raised, plus planted rows for top-k: a row of
    ties, a row on a coarse grid, and rows with +-0 and NaN of both
    signs."""
    targets = (torch.rand((n, num_labels), generator=gen, device=device)
               < 2.0 / num_labels).to(torch.int64)
    logits = torch.randn((n, num_labels), generator=gen, device=device) * 1.5 - 3.0
    scores = torch.sigmoid(logits + 3.5 * targets)
    scores[0] = 0.25
    scores[1] = torch.round(scores[1] * 8) / 8
    scores[2, ::7] = 0.0
    scores[2, 3::7] = -0.0
    scores[3, ::11] = float("nan")
    scores[3, 5::11] = -float("nan")
    return scores, targets


def _topk_oracle(x, k):
    """Host numpy top-k of float32 rows by IEEE totalOrder, ties by
    ascending index: a stable sort of the sign-magnitude integer keys."""
    b = x.view(np.int32).astype(np.int64)
    key = np.where(b < 0, b ^ 0x7FFFFFFF, b)
    order = np.argsort(-key, axis=-1, kind="stable")[:, :k]
    return np.take_along_axis(x, order, -1), order


def _criteria_counts(pred, target):
    """Integer counts of the rows (or, for hamming, labels) each criterion
    calls correct, from 0/1 int64 predictions."""
    wrong = (pred != target).sum(1)
    missed = (target * (1 - pred)).sum(1)
    extra = (pred * (1 - target)).sum(1)
    hit = (pred * target).sum(1)
    empty = (pred + target).sum(1) == 0
    return {
        "exact_match": int((wrong == 0).sum()), "hamming": int((pred == target).sum()),
        "overlap": int(((hit > 0) | empty).sum()), "contain": int((missed == 0).sum()),
        "belong": int((extra == 0).sum()),
    }


def _counters_openimages(device, n, num_labels, batch, num_t, k, seed):
    """OpenImages V6 validation scale: multilabel accuracy under every
    criterion, top-k multilabel accuracy (its ``topk`` held to a host
    totalOrder oracle), and the multilabel binned family."""
    acc = {c: MultilabelAccuracy(criteria=c, device=device) for c in CRITERIA}
    topk_acc = {c: TopKMultilabelAccuracy(criteria=c, k=k, device=device) for c in CRITERIA}
    prc = {mode: MultilabelBinnedPrecisionRecallCurve(
        num_labels=num_labels, threshold=num_t, optimization=mode, device=device)
        for mode in ("vectorized", "memory")}
    auprc = MultilabelBinnedAUPRC(num_labels=num_labels, threshold=num_t, device=device)
    grid = auprc.threshold
    labels = torch.arange(num_labels, device=device)
    hist = torch.zeros((num_t, num_labels, 2), dtype=torch.int64, device=device)
    acc_oracle = dict.fromkeys(CRITERIA, 0)
    topk_oracle = dict.fromkeys(CRITERIA, 0)
    timers, updates, topk_bitwise, rows = {}, 0, True, 0
    _reset_peak(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for start in range(0, n, batch):
        scores, targets = _multilabel_batch(gen, min(batch, n - start), num_labels, device)
        # the two binned modes differ on NaN by design (both packages), so
        # the binned family sees the planted NaN scores as 0
        clean = torch.nan_to_num(scores, nan=0.0)
        _timed_update(timers, "multilabel_accuracy_x5", device,
                      lambda: [m.update(scores, targets) for m in acc.values()])
        _timed_update(timers, "topk_multilabel_accuracy_x5", device,
                      lambda: [m.update(scores, targets) for m in topk_acc.values()])
        for mode, m in prc.items():
            _timed_update(timers, f"binned_prc_{mode}", device, lambda m=m: m.update(clean, targets))
        _timed_update(timers, "binned_auprc", device, lambda: auprc.update(clean, targets))
        updates += 1
        host = scores.cpu().numpy()
        tgt = targets.cpu().numpy()
        want_vals, want_idx = _topk_oracle(host, k)
        got_vals, got_idx = topk(scores, k)
        topk_bitwise &= (got_idx.cpu().numpy().astype(np.int64) == want_idx).all() and (
            got_vals.cpu().numpy().view(np.int32) == want_vals.view(np.int32)).all()
        rows += host.shape[0]
        for c, v in _criteria_counts((~(host < 0.5)).astype(np.int64), tgt).items():
            acc_oracle[c] += v
        top = np.zeros_like(tgt)
        np.put_along_axis(top, want_idx, 1, -1)
        for c, v in _criteria_counts(top, tgt).items():
            topk_oracle[c] += v
        hist += _binned_oracle(_grid_bins(clean, grid), labels[None, :], targets, num_t)
    stream_peak = _stream_peak(device)
    _check(bool(topk_bitwise), "ops.topk on the card != host totalOrder oracle")
    for name, metrics, oracle in (("accuracy", acc, acc_oracle), ("top-k accuracy", topk_acc, topk_oracle)):
        for c, m in metrics.items():
            total = rows * num_labels if c == "hamming" else rows
            ok, err, _ = _within_bound([m.num_correct, m.num_total],
                                       [torch.tensor(oracle[c]), torch.tensor(total)], updates)
            # below 2^24 the bound admits only the exact count
            _check(ok, f"{name} {c}: counters off the integer oracle by {err}")
    modes_bitwise = all(torch.equal(getattr(prc["vectorized"], s), getattr(prc["memory"], s))
                        for s in ("num_tp", "num_fp", "num_fn"))
    _check(modes_bitwise, "vectorized and memory multilabel binned PRC counters differ")
    tp, fp, fn = _oracle_counters(hist)
    ok, count_err, exact = _within_bound(
        [prc["memory"].num_tp, prc["memory"].num_fp, prc["memory"].num_fn], [tp, fp, fn], updates)
    _check(ok, f"multilabel binned PRC counters past the accumulation bound ({count_err})")
    values, computes = _compute_reports(
        {"accuracy_hamming": acc["hamming"], "topk_accuracy_overlap": topk_acc["overlap"],
         "binned_prc_vectorized": prc["vectorized"], "binned_prc_memory": prc["memory"],
         "binned_auprc": auprc}, device)
    auprc_err = abs(float(values["binned_auprc"]) - float(_binned_auprc64(tp, fp, fn).mean()))
    _check(auprc_err <= CURVE_TOL, f"multilabel binned AUPRC off the float64 oracle by {auprc_err}")
    return {
        "samples": n, "num_labels": num_labels, "batch": batch, "num_thresholds": num_t, "k": k,
        "updates": updates, "topk_oracle_bitwise": bool(topk_bitwise),
        "prc_modes_bitwise": modes_bitwise, "counters_exact": exact,
        "counter_max_err": count_err, "binned_auprc_err_vs_float64": auprc_err,
        "positives_per_image": float(hist[..., 1].sum()) / n,
        "values": {**{f"accuracy_{c}": float(m.compute()) for c, m in acc.items()},
                   **{f"topk_accuracy_{c}": float(m.compute()) for c, m in topk_acc.items()},
                   "binned_auprc_macro": float(values["binned_auprc"])},
        "update_ms_median": {k_: _median(v) for k_, v in timers.items()},
        "update_ms_first": {k_: v[0] for k_, v in timers.items()},
        "vectorized_over_memory": _median(timers["binned_prc_vectorized"])
        / _median(timers["binned_prc_memory"]),
        "prc_update_device_ms": _mode_device_ms(
            lambda mode: MultilabelBinnedPrecisionRecallCurve(
                num_labels=num_labels, threshold=num_t, optimization=mode, device=device),
            clean, targets, device),
        "stream_peak_bytes": stream_peak, "compute": computes,
    }


def phase_counters(device, imagenet_n=IMAGENET_VAL, num_classes=1000, batch=1024,
                   ctr_n=CRITEO_EVAL, ctr_batch=CTR_BATCH, ctr_buffered=1 << 22,
                   hist_bins=(100, 1 << 20), openimages_n=OPENIMAGES_VAL,
                   num_labels=OPENIMAGES_LABELS, num_thresholds=100, topk_k=5, seed=7):
    """The counter families at published scales, each held to an int64 /
    float64 oracle: ImageNet-1k validation into the confusion matrix,
    precision, recall and the multiclass binned family; the Criteo 1TB
    evaluation stream into the binary binned family, the histogram AUROC
    and ``StreamingBinaryAUROC`` (K1); OpenImages V6 validation into the
    multilabel accuracies and the multilabel binned family."""
    t0 = time.perf_counter()
    imagenet = _counters_imagenet(device, imagenet_n, num_classes, batch, num_thresholds, seed)
    criteo = _counters_criteo(device, ctr_n, ctr_batch, ctr_buffered, hist_bins, num_thresholds,
                              seed + 1)
    openimages = _counters_openimages(device, openimages_n, num_labels, batch, num_thresholds,
                                      topk_k, seed + 2)
    return {"phase": "counters", "device": str(device), "seconds": time.perf_counter() - t0,
            "imagenet": imagenet, "criteo": criteo, "openimages": openimages}


# -------------------------------------------------------- recommendation


NCF_USERS = 138_493  # MovieLens-20M users (MLPerf NCF)
NCF_CANDIDATES = 1000  # the held-out positive and 999 sampled negatives
MARCO_QUERIES = 6980  # MS MARCO passage ranking, dev small
MARCO_CANDIDATES = 1000  # the BM25 run's depth
# relevant passages a query among its BM25 candidates: P(0..3), mean 1.07
MARCO_RELEVANT = (0.08, 0.80, 0.09, 0.03)
DLRM_TABLE_ROWS = 40_000_000  # MLPerf DLRM's embedding-table cap
DLRM_SPARSE_FEATURES = 26
U32 = 2.0 ** -24  # float32 unit roundoff


def _rel_err(got, want):
    """max |got - want| / |want| over float64 tensors."""
    got, want = torch.as_tensor(got).double().cpu(), torch.as_tensor(want).double().cpu()
    return float(((got - want).abs() / want.abs().clamp(min=1e-300)).max())


def _float_bound(states, oracles, batch, updates):
    """float32 sums of non-negative float terms against their float64
    sums ``S``: each batch delta is a float32 sum of at most ``batch``
    terms, each rounded a few times (a log or a product), so it lies
    within ``(batch + 7) u`` of its terms' sum whatever the summation
    order; each add into the state rounds by at most half an ulp of the
    final value: ``|error| <= (batch + 7) u S + updates ulp(S) / 2``.
    Returns (ok, max relative error)."""
    ok, worst = True, 0.0
    for state, oracle in zip(states, oracles):
        state, oracle = state.double().cpu(), oracle.double().cpu()
        err = (state - oracle).abs()
        ok &= bool((err <= (batch + 7) * U32 * oracle + updates * _ulp32(oracle) / 2).all())
        worst = max(worst, _rel_err(state, oracle))
    return ok, worst


def _entropy64(pos, n):
    """float64 baseline entropy with the reference's float64-eps clamp."""
    r = (pos / n).clamp(2.220446049250313e-16, 1 - 2.220446049250313e-16)
    return -r * torch.log(r) - (1 - r) * torch.log1p(-r)


def _ce64(x, y, from_logits):
    """float64 per-element cross entropy of float32 inputs, by the
    reference's rules (probabilities clipped to [0, 1], logs clamped at
    -100)."""
    x, y = x.double(), y.double()
    if from_logits:
        return x.clamp(min=0) - x * y + torch.log1p(torch.exp(-x.abs()))
    p = x.clamp(0.0, 1.0)
    return -(y * torch.log(p).clamp(min=-100) + (1 - y) * torch.log1p(-p).clamp(min=-100))


def _recsys_criteo(device, n, batch, mt_samples, num_tasks, rows_n, row_tasks, seed):
    """The DLRM eval panel over the Criteo 1TB evaluation stream, a 4-task
    weighted stream, and calibration's row form over ``row_tasks`` ids."""
    panel = {
        "ne": BinaryNormalizedEntropy(device=device),
        "ne_logits": BinaryNormalizedEntropy(from_logits=True, device=device),
        "ctr": ClickThroughRate(device=device),
        "calibration": WeightedCalibration(device=device),
        "auroc": StreamingBinaryAUROC(num_bins=NUM_BINS, device=device),
    }
    on_scores = {k: panel[k] for k in ("ne", "calibration", "auroc")}
    o = {k: torch.zeros((), dtype=torch.float64, device=device)
         for k in ("ce", "ce_logits", "pos", "s")}
    timers, updates = {}, 0
    _reset_peak(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    for start in range(0, n, batch):
        x, s, y = _click_logits(gen, (min(batch, n - start),), device)
        _timed_update(timers, "scores_ne_calibration_auroc", device,
                      lambda: toolkit.update_collection(on_scores, s, y))
        _timed_update(timers, "logits_ne", device,
                      lambda: toolkit.update_collection({"ne_logits": panel["ne_logits"]}, x, y))
        _timed_update(timers, "ctr", device,
                      lambda: toolkit.update_collection({"ctr": panel["ctr"]}, y))
        updates += 1
        o["ce"] += _ce64(s, y, False).sum()
        o["ce_logits"] += _ce64(x, y, True).sum()
        o["pos"] += y.double().sum()
        o["s"] += s.double().sum()
    stream_seconds = time.perf_counter() - t0
    stream_peak = _stream_peak(device)
    o = {k: v.cpu() for k, v in o.items()}
    n64 = torch.tensor(float(n), dtype=torch.float64)

    ok, count_err, exact = _within_bound(
        [panel["ne"].num_examples, panel["ne"].num_positive, panel["ne_logits"].num_examples,
         panel["ne_logits"].num_positive, panel["ctr"].click_total, panel["ctr"].weight_total,
         panel["calibration"].weighted_target_sum],
        [n64, o["pos"], n64, o["pos"], o["pos"], n64, o["pos"]], updates)
    _check(ok, f"panel counters past the accumulation bound (max error {count_err})")
    _check(float(o["pos"]) < 2**24 and float(panel["ctr"].click_total) == float(o["pos"]),
           "click count below 2^24 not exact")
    fok, float_rel = _float_bound(
        [panel["ne"].total_entropy, panel["ne_logits"].total_entropy,
         panel["calibration"].weighted_input_sum],
        [o["ce"], o["ce_logits"], o["s"]], batch, updates)
    _check(fok, f"panel float sums past their bound (max relative error {float_rel})")
    values, computes = _compute_reports(panel, device)
    want = {
        "ne": o["ce"] / n64 / _entropy64(o["pos"], n64),
        "ne_logits": o["ce_logits"] / n64 / _entropy64(o["pos"], n64),
        "ctr": o["pos"] / n64,
        "calibration": o["s"] / o["pos"],
    }
    value_err = {k: _rel_err(values[k], v) for k, v in want.items()}
    _check(max(value_err.values()) <= 1e-5, f"panel values off float64 by {value_err}")
    # the labels are drawn from the scores: calibration within 5 sigma of 1
    cal_sigma = 1 / math.sqrt(float(o["pos"]))
    _check(abs(float(values["calibration"]) - 1) <= 5 * cal_sigma,
           f"calibration {float(values['calibration'])} is not near 1")
    _check(bool(torch.isfinite(values["auroc"]).all()), "panel AUROC not finite")

    # 4 tasks, random weights
    mt = {
        "ne": BinaryNormalizedEntropy(num_tasks=num_tasks, device=device),
        "ctr": ClickThroughRate(num_tasks=num_tasks, device=device),
        "calibration": WeightedCalibration(num_tasks=num_tasks, device=device),
    }
    mt_batch = min(batch, mt_samples)
    om = {k: torch.zeros(num_tasks, dtype=torch.float64, device=device)
          for k in ("ce", "wy", "w", "ws")}
    mt_updates = 0
    for _ in range(0, mt_samples, mt_batch):
        _, s, y = _click_logits(gen, (num_tasks, mt_batch), device)
        w = torch.rand((num_tasks, mt_batch), generator=gen, device=device)
        _timed_update(timers, "tasks_ne", device, lambda: mt["ne"].update(s, y, weight=w))
        _timed_update(timers, "tasks_ctr", device, lambda: mt["ctr"].update(y, w))
        _timed_update(timers, "tasks_calibration", device, lambda: mt["calibration"].update(s, y, w))
        mt_updates += 1
        w64 = w.double()
        om["ce"] += (w64 * _ce64(s, y, False)).sum(-1)
        om["wy"] += (w64 * y.double()).sum(-1)
        om["w"] += w64.sum(-1)
        om["ws"] += (w64 * s.double()).sum(-1)
    om = {k: v.cpu() for k, v in om.items()}
    mok, mt_rel = _float_bound(
        [mt["ne"].total_entropy, mt["ne"].num_positive, mt["ne"].num_examples,
         mt["ctr"].click_total, mt["ctr"].weight_total, mt["calibration"].weighted_input_sum,
         mt["calibration"].weighted_target_sum],
        [om["ce"], om["wy"], om["w"], om["wy"], om["w"], om["ws"], om["wy"]], mt_batch, mt_updates)
    _check(mok, f"4-task float sums past their bound (max relative error {mt_rel})")
    mt_values, mt_computes = _compute_reports(mt, device)
    mt_want = {"ne": om["ce"] / om["w"] / _entropy64(om["wy"], om["w"]),
               "ctr": om["wy"] / om["w"], "calibration": om["ws"] / om["wy"]}
    mt_err = {k: _rel_err(mt_values[k], v) for k, v in mt_want.items()}
    _check(max(mt_err.values()) <= 1e-5, f"4-task values off float64 by {mt_err}")

    # the row form: (task id, score, label, weight) rows, ids out of range dropped
    rows = WeightedCalibration(num_tasks=row_tasks, device=device)
    orow = {k: torch.zeros(row_tasks, dtype=torch.float64, device=device) for k in ("ws", "wy")}
    row_updates, dropped = 0, 0
    for start in range(0, rows_n, batch):
        m = min(batch, rows_n - start)
        _, s, y = _click_logits(gen, (m,), device)
        w = torch.rand((m,), generator=gen, device=device)
        ids = torch.randint(0, row_tasks, (m,), generator=gen, device=device)
        ids[::97] = -1 - ids[::97]  # out of range below
        ids[50::97] += row_tasks  # and above
        _timed_update(timers, "rows_calibration", device,
                      lambda: rows.update(s, y, w, task_ids=ids))
        row_updates += 1
        keep = (ids >= 0) & (ids < row_tasks)
        dropped += int((~keep).sum())
        safe = torch.where(keep, ids, torch.zeros_like(ids))
        w64 = torch.where(keep, w.double(), torch.zeros_like(w, dtype=torch.float64))
        orow["ws"].index_add_(0, safe, w64 * s.double())
        orow["wy"].index_add_(0, safe, w64 * y.double())
    orow = {k: v.cpu() for k, v in orow.items()}
    rok, rows_rel = _float_bound(
        [rows.weighted_input_sum, rows.weighted_target_sum], [orow["ws"], orow["wy"]], batch,
        row_updates)
    _check(rok, f"row-form sums past their bound (max relative error {rows_rel})")
    rows_value, rows_wall = _timed_compute(rows, device)
    _check(rows_value.shape == (row_tasks,), "row-form calibration is empty: a task has no positive")
    rows_err = _rel_err(rows_value, orow["ws"] / orow["wy"])
    _check(rows_err <= 1e-5, f"row-form calibration off float64 by {rows_err}")
    return {
        "samples": n, "batch": batch, "panel_updates": updates, "stream_seconds": stream_seconds,
        "values": {k: float(v) for k, v in values.items()},
        "value_rel_err_vs_float64": value_err, "counters_exact": exact,
        "counter_max_err": count_err, "float_state_max_rel_err": float_rel,
        "tasks": {"samples_per_task": mt_samples, "num_tasks": num_tasks, "updates": mt_updates,
                  "values": {k: v.tolist() for k, v in mt_values.items()},
                  "value_rel_err_vs_float64": mt_err, "float_state_max_rel_err": mt_rel,
                  "compute": mt_computes},
        "rows": {"rows": rows_n, "num_tasks": row_tasks, "updates": row_updates,
                 "dropped_ids": dropped, "value_rel_err_vs_float64": rows_err,
                 "float_state_max_rel_err": rows_rel, "compute_wall_ms": rows_wall * 1e3,
                 "calibration_range": [float(rows_value.min()), float(rows_value.max())]},
        "update_ms_median": {k: _median(v) for k, v in timers.items()},
        "update_ms_first": {k: v[0] for k, v in timers.items()},
        "panel_update_ms_median": sum(_median(timers[k]) for k in
                                      ("scores_ne_calibration_auroc", "logits_ne", "ctr")),
        "stream_peak_bytes": stream_peak, "compute": computes,
    }


def _ncf_batch(gen, users, candidates, device):
    """One batch of NCF evaluation: each user's N(0, 1) scores for its
    held-out positive and 999 negatives, the positive raised by 2.6 (a
    hit rate at 10 near MLPerf NCF's 0.635 target), with planted rows: all
    tied, NaN scores, NaN at the target, coarse ties, and targets wrapped
    (in [-C, 0)) or out of range."""
    scores = torch.randn((users, candidates), generator=gen, device=device)
    target = torch.randint(0, candidates, (users,), generator=gen, device=device)
    rows = torch.arange(users, device=device)
    scores[rows, target] += 2.6
    if users >= 10:
        scores[0] = 0.25
        scores[1, ::7] = float("nan")
        scores[2, target[2]] = float("nan")
        scores[3] = torch.round(scores[3] * 2) / 2
        target[4] = -1
        target[5] = -candidates
        target[6] = candidates
        target[7] = -candidates - 1
        target[8] = 5 * candidates
        target[9] = target[9] - candidates  # the same item, wrapped
    return scores, target


def _recsys_ncf(device, users, candidates, batch, k, seed):
    """MLPerf NCF evaluation on MovieLens-20M: ``HitRate`` and
    ``ReciprocalRank`` at k over every user's candidates, bitwise against
    an int64 strictly-greater count."""
    hr, rr = HitRate(k=k, device=device), ReciprocalRank(k=k, device=device)
    timers, ranks = {}, []
    _reset_peak(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for start in range(0, users, batch):
        scores, target = _ncf_batch(gen, min(batch, users - start), candidates, device)
        _timed_update(timers, "hit_rate", device, lambda: hr.update(scores, target))
        _timed_update(timers, "reciprocal_rank", device, lambda: rr.update(scores, target))
        # oracle: the wrap / out-of-range rule on the host, the count on the card
        t = target.cpu().numpy()
        t = np.where(t < 0, t + candidates, t)
        ok = (t >= 0) & (t < candidates)
        picked = scores[torch.arange(len(t), device=device),
                        torch.from_numpy(np.where(ok, t, 0)).to(device)]
        picked = torch.where(torch.from_numpy(ok).to(device), picked,
                             torch.full_like(picked, float("nan")))
        ranks.append((scores > picked[:, None]).sum(-1, dtype=torch.int64).cpu().numpy())
    stream_peak = _stream_peak(device)
    rank = np.concatenate(ranks)
    want_hr = (rank < k).astype(np.float32)
    with np.errstate(divide="ignore"):
        want_rr = np.where(rank >= k, np.float32(0),
                           np.float32(1) / (rank + 1).astype(np.float32)).astype(np.float32)
    values, computes = _compute_reports({"hit_rate": hr, "reciprocal_rank": rr}, device)
    got_hr, got_rr = values["hit_rate"].cpu().numpy(), values["reciprocal_rank"].cpu().numpy()
    _check(got_hr.dtype == np.float32 and got_hr.tobytes() == want_hr.tobytes(),
           "hit rates != the int64 rank oracle")
    _check(got_rr.dtype == np.float32 and got_rr.tobytes() == want_rr.tobytes(),
           "reciprocal ranks != the int64 rank oracle")
    return {
        "users": users, "candidates": candidates, "batch": batch, "k": k,
        "updates": len(ranks), "bitwise": True,
        "values": {f"hr@{k}": float(want_hr.mean()), f"mrr@{k}": float(want_rr.mean())},
        "update_ms_median": {k_: _median(v) for k_, v in timers.items()},
        "update_ms_first": {k_: v[0] for k_, v in timers.items()},
        "stream_peak_bytes": stream_peak, "compute": computes,
    }


def _marco_run(gen, queries, candidates, device):
    """An MS MARCO dev-small BM25 run: BM25-like scores for each query's
    candidates (N(10, 2)), 0 to 3 relevant passages a query
    (``MARCO_RELEVANT``) raised by 4 (precision at 10 near BM25's on that
    set); every 50th query scored on a coarse grid (ties across the top
    10) and one query with NaN scores."""
    scores = torch.randn((queries, candidates), generator=gen, device=device) * 2 + 10
    cut = torch.tensor(np.cumsum(MARCO_RELEVANT)[:-1], dtype=torch.float32, device=device)
    count = torch.bucketize(torch.rand(queries, generator=gen, device=device), cut, right=True)
    slots = torch.randint(0, candidates, (queries, len(MARCO_RELEVANT) - 1), generator=gen,
                          device=device)
    relevant = torch.zeros((queries, candidates), device=device)
    for j in range(slots.shape[1]):
        rows = torch.nonzero(count > j)[:, 0]
        relevant[rows, slots[rows, j]] = 1.0
    scores += 4.0 * relevant
    scores[::50] = torch.round(scores[::50])
    scores[min(7, queries - 1), ::100] = float("nan")
    return scores, relevant


def _precision_oracle(x, rel, k):
    """Host precision @ k of each row: the relevant count in the top k by
    ``_topk_oracle``'s stable totalOrder, times the float32 reciprocal of
    k (as the metric divides); and the top-k scores."""
    values, order = _topk_oracle(x, k)
    top_rel = np.take_along_axis(rel, order, -1)
    return top_rel.sum(-1).astype(np.float32) * (np.float32(1) / np.float32(k)), values


def _recsys_marco(device, queries, candidates, batch, k, seed):
    """MS MARCO passage ranking, dev small: rows of ``batch`` queries at a
    time, shuffled, with a few rows of indexes outside the query range,
    into ``RetrievalPrecision`` per query and macro; then the functional
    form over the whole score matrix. Bitwise against a host oracle."""
    metrics = {
        "per_query": RetrievalPrecision(k=k, num_queries=queries, device=device),
        "macro": RetrievalPrecision(k=k, num_queries=queries, avg="macro", device=device),
    }
    gen = torch.Generator(device=device).manual_seed(seed)
    scores, relevant = _marco_run(gen, queries, candidates, device)
    host_scores, host_rel = scores.cpu().numpy(), relevant.cpu().numpy()
    want = np.zeros(queries, np.float32)
    want_top = np.zeros((queries, min(k, candidates)), np.float32)
    timers, updates, junk = {}, 0, 0
    _reset_peak(device)
    for q0 in range(0, queries, batch):
        q1 = min(q0 + batch, queries)
        qs = torch.arange(q0, q1, device=device).repeat_interleave(candidates)
        cs = torch.arange(candidates, device=device).repeat(q1 - q0)
        extra = 10  # rows whose index is outside [0, queries): ignored
        x = torch.cat([scores[qs, cs], torch.rand(extra, generator=gen, device=device)])
        y = torch.cat([relevant[qs, cs], torch.ones(extra, device=device)])
        idx = torch.cat([qs, torch.tensor([-1, queries] * (extra // 2), device=device)])
        perm = torch.randperm(x.shape[0], generator=gen, device=device)
        x, y, idx = x[perm], y[perm], idx[perm]
        _timed_update(timers, "retrieval_precision_x2", device,
                      lambda: toolkit.update_collection(metrics, x, y, idx))
        updates += 1
        junk += extra
        # oracle: each query's rows in the order they were fed
        host_idx, host_c = idx.cpu().numpy(), torch.cat(
            [cs, torch.zeros(extra, dtype=cs.dtype, device=device)])[perm].cpu().numpy()
        real = np.flatnonzero((host_idx >= 0) & (host_idx < queries))
        real = real[np.argsort(host_idx[real], kind="stable")]
        fed_q = host_idx[real].reshape(q1 - q0, candidates)
        fed_c = host_c[real].reshape(q1 - q0, candidates)
        want[q0:q1], want_top[q0:q1] = _precision_oracle(
            host_scores[fed_q, fed_c], host_rel[fed_q, fed_c], k)
    stream_peak = _stream_peak(device)
    values, computes = _compute_reports(metrics, device)
    got = values["per_query"].cpu().numpy()
    _check(got.dtype == np.float32 and got.tobytes() == want.tobytes(),
           "per-query precision @ k != host oracle")
    state_top = torch.stack(list(metrics["per_query"].topk)).cpu().numpy()
    _check(state_top.view(np.int32).tobytes() == want_top.view(np.int32).tobytes(),
           "per-query top-k buffers != host oracle")
    macro_err = _rel_err(values["macro"], want.astype(np.float64).mean())
    _check(macro_err <= 1e-5, f"macro precision off float64 by {macro_err}")

    _sync(device)
    t0 = time.perf_counter()
    functional = retrieval_precision(scores, relevant, k=k, num_tasks=queries)
    _sync(device)
    functional_ms = (time.perf_counter() - t0) * 1e3
    want_f, _ = _precision_oracle(host_scores, host_rel, k)
    got_f = functional.cpu().numpy()
    _check(got_f.dtype == np.float32 and got_f.tobytes() == want_f.tobytes(),
           "functional precision @ k != host oracle")
    cuda = torch.device(device).type == "cuda"
    return {
        "queries": queries, "candidates": candidates, "batch_queries": batch, "k": k,
        "updates": updates, "ignored_rows": junk, "bitwise": True,
        "relevant_per_query": float(host_rel.sum()) / queries,
        "values": {f"p@{k}_macro": float(values["macro"]),
                   f"p@{k}_functional_mean": float(want_f.mean())},
        "update_ms_median": {k_: _median(v) for k_, v in timers.items()},
        "update_ms_first": {k_: v[0] for k_, v in timers.items()},
        "stream_peak_bytes": stream_peak, "compute": computes,
        "functional_wall_ms_first": functional_ms,
        "functional_profile": _profile(
            lambda: retrieval_precision(scores, relevant, k=k, num_tasks=queries), device, 3)
        if cuda else None,
    }


def _recsys_ids(device, n, features, k, seed):
    """DLRM sparse ids: one ``n``-sample batch of ``features`` categorical
    features, ids ``floor(DLRM_TABLE_ROWS * u^4)`` (a heavy head); per
    feature ``num_collisions`` and ``frequency_at_k`` of each id's
    in-batch frequency, bitwise against numpy's unique counts."""
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand((features, n), generator=gen, device=device, dtype=torch.float64)
    ids = torch.floor(DLRM_TABLE_ROWS * u**4).to(torch.int64)
    host = ids.cpu().numpy()
    timers, distinct, singletons = {}, [], []
    for f in range(features):
        got = {}
        _timed_update(timers, "num_collisions", device,
                      lambda: got.update(c=num_collisions(ids[f])))
        freq = (got["c"] + 1).to(torch.float32) / n
        _timed_update(timers, "frequency_at_k", device,
                      lambda: got.update(f=frequency_at_k(freq, k)))
        _, inverse, counts = np.unique(host[f], return_inverse=True, return_counts=True)
        want = (counts[inverse] - 1).astype(np.int32)
        want_freq = (want + 1).astype(np.float32) / np.float32(n)
        want_fk = (want_freq < np.float32(k)).astype(np.float32)
        c, fk = got["c"].cpu().numpy(), got["f"].cpu().numpy()
        _check(c.dtype == np.int32 and c.tobytes() == want.tobytes(),
               f"feature {f}: num_collisions != numpy unique counts")
        _check(freq.cpu().numpy().tobytes() == want_freq.tobytes(), f"feature {f}: frequencies differ")
        _check(fk.dtype == np.float32 and fk.tobytes() == want_fk.tobytes(),
               f"feature {f}: frequency_at_k != numpy")
        distinct.append(len(counts))
        singletons.append(float((want == 0).mean()))
    return {
        "samples": n, "features": features, "table_rows": DLRM_TABLE_ROWS, "k": k,
        "bitwise": True, "distinct_ids_per_feature": [min(distinct), max(distinct)],
        "singleton_share": [min(singletons), max(singletons)],
        "update_ms_median": {k_: _median(v) for k_, v in timers.items()},
    }


def phase_recsys(device, ctr_n=CRITEO_EVAL, ctr_batch=CTR_BATCH, mt_samples=1 << 22,
                 num_tasks=4, rows_n=1 << 22, row_tasks=1000, ncf_users=NCF_USERS,
                 ncf_candidates=NCF_CANDIDATES, ncf_batch=4096, marco_queries=MARCO_QUERIES,
                 marco_candidates=MARCO_CANDIDATES, marco_batch=64, id_n=CTR_BATCH,
                 id_features=DLRM_SPARSE_FEATURES, k=10, seed=8):
    """The recommendation-eval path at published scales: the DLRM eval
    panel (normalized entropy on scores and on logits, CTR, calibration,
    streaming AUROC through K1) over the Criteo 1TB evaluation stream,
    with a 4-task weighted stream and calibration's row form; MLPerf NCF's
    hit rate and MRR at 10 over MovieLens-20M; MS MARCO dev-small
    precision at 10; DLRM id collisions and frequencies. K1 counts are
    zeroed at the start and read at the end: every launch is a panel
    update's."""
    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    _kernels.reset_launch_counts()
    criteo = _recsys_criteo(device, ctr_n, ctr_batch, mt_samples, num_tasks, rows_n,
                            row_tasks, seed)
    ncf = _recsys_ncf(device, ncf_users, ncf_candidates, ncf_batch, k, seed + 1)
    marco = _recsys_marco(device, marco_queries, marco_candidates, marco_batch, k, seed + 2)
    ids = _recsys_ids(device, id_n, id_features, 1e-4, seed + 3)
    launches = _kernels.LAUNCHES["fused_auc_hist"]
    if cuda:
        _check(launches == criteo["panel_updates"],
               f"K1 launched {launches} times for {criteo['panel_updates']} panel updates")
    return {"phase": "recsys", "device": str(device), "seconds": time.perf_counter() - t0,
            "k1_launches": launches, "criteo": criteo, "ncf": ncf, "msmarco": marco,
            "dlrm_ids": ids}


# ------------------------------------------------------------- lm eval

LLAMA3_VOCAB = 128_256  # Meta-Llama-3-8B config.json: vocab_size
LLAMA3_CONTEXT = 8192  # and max_position_embeddings
# WikiText-2 (raw) test set under the GPT-2 tokenizer, as Hugging Face's
# "Perplexity of fixed-length models" page counts it: a stand-in count
WIKITEXT2_TEST_TOKENS = 287_644
SLIDING_STRIDE = 512  # that page's sliding-window stride
WMT14_NEWSTEST = 3003  # WMT14 En-De newstest2014 sentence pairs
LIBRISPEECH_TEST_CLEAN = 2620  # LibriSpeech test-clean utterances
TEXT_VOCAB = 32_000
IGNORE = -100  # Hugging Face's label ignore index
# logit margin planted at every real target over N(0, 1) logits: at
# V = 128,256 the target's probability is about e^10 / (e^10 + V e^0.5),
# a perplexity near 10
PPL_MARGIN = 10.0
U_BF16 = 2.0 ** -8  # bfloat16 unit roundoff


def _lm_window(gen, vocab, context, real, margin, dtype, device):
    """One (1, context, vocab) window of N(0, 1) logits with ``margin``
    added at each real target; targets uniform over the vocabulary in the
    positions of the slice ``real``, ``IGNORE`` elsewhere."""
    x = torch.randn((1, context, vocab), generator=gen, device=device)
    t = torch.full((1, context), IGNORE, dtype=torch.int64, device=device)
    rows = torch.arange(context, device=device)[real]
    t[0, rows] = torch.randint(0, vocab, (rows.numel(),), generator=gen, device=device)
    x[0, rows, t[0, rows]] += margin
    return (x if dtype == torch.float32 else x.to(dtype)), t


def _clip_index64(t, vocab):
    """The JAX package's ``take_along_axis(mode="clip")`` index, written
    apart from the port's: negatives wrap once, then clamp to [0, V-1]."""
    return torch.where(t < 0, t + vocab, t).clamp(0, vocab - 1)


def _nll_oracle(x, t, rows, chunk):
    """float64 sums over the window's rows ``rows`` (a slice), in chunks
    of ``chunk`` rows: the NLL, the count of kept targets, and
    ``sum(|x_t - m| + |log s| + |log p_t|)`` for the bound."""
    vocab = x.shape[-1]
    x2, t2 = x.reshape(-1, vocab)[rows], t.reshape(-1)[rows]
    nll = torch.zeros((), dtype=torch.float64, device=x.device)
    mags = torch.zeros((), dtype=torch.float64, device=x.device)
    for lo in range(0, x2.shape[0], chunk):
        xc, tc = x2[lo:lo + chunk].double(), t2[lo:lo + chunk]
        keep = tc != IGNORE
        m = xc.amax(-1, keepdim=True)
        log_s = torch.log(torch.exp(xc - m).sum(-1))
        shifted = xc.gather(1, _clip_index64(tc, vocab)[:, None])[:, 0] - m[:, 0]
        lp = shifted - log_s
        nll -= torch.where(keep, lp, 0.0).sum()
        mags += torch.where(keep, shifted.abs() + log_s.abs() + lp.abs(), 0.0).sum()
        del xc
    return nll, int((t2 != IGNORE).sum()), mags


def _window_bound(mags, nll, kept, vocab, dtype):
    """What one window's batch sum may be off by. Per token, the log-
    softmax rounds the shift, the log and the difference (each to within
    2 u_d of its magnitude, with CUDA's 1-ulp logf), the exps (2 ulps each,
    6 u_d in all with the rounding of their sum in a half dtype) and sums
    ``vocab`` positive terms in float32 (``(vocab - 1) u32`` relative,
    whatever the order): ``2 u_d (|x_t - m| + |log s| + |log p_t|) + 6 u_d
    + (vocab - 1) u32``. The batch sum adds ``kept`` terms in float32
    (``(kept - 1) u32`` of the NLL) and, in a half dtype, rounds to it
    once (``u_d`` of the NLL)."""
    u_d = U32 if dtype == torch.float32 else U_BF16
    bound = 2 * u_d * mags + (6 * u_d + (vocab - 1) * U32) * kept + max(kept - 1, 0) * U32 * nll
    if dtype != torch.float32:
        bound += u_d * nll
    return bound


def _ppl_float64(nll64, kept, bound):
    """The float64 perplexity and what the float32 one may be off by: the
    NLL bound over the count, plus the quotient's and exp's roundings."""
    ppl64 = math.exp(nll64 / kept)
    return ppl64, ppl64 * math.expm1(bound / kept + 4 * U32 * max(1.0, nll64 / kept))


def _ppl_stream(name, device, gen, windows, make_window, dtype, vocab, chunk, plant=False):
    """Feed ``windows`` windows to ``Perplexity(ignore_index=IGNORE)``,
    each update timed from a drained queue and held against the float64
    oracle; returns the last window and the report."""
    metric = Perplexity(ignore_index=IGNORE, device=device)
    timers = {}
    nll64, kept, bound = 0.0, 0, 0.0
    _reset_peak(device)
    for w in range(windows):
        x, t, real = make_window(w)
        if plant and w == 0:
            # out-of-range targets: the run goes on, each read as JAX's gather reads it
            t[0, real.start:real.start + 3] = torch.tensor([-1, vocab, vocab + 7], device=device)
        _timed_update(timers, name, device, lambda: metric.update(x, t))
        n, k, mags = _nll_oracle(x, t, real, chunk)
        nll64 += float(n)
        kept += k
        bound += float(_window_bound(mags, n, k, vocab, dtype))
    peak = _stream_peak(device)
    bound += windows * _ulp32(torch.tensor(nll64)).item() / 2  # the state's adds
    got = float(metric.sum_log_probs)
    _check(int(metric.num_total) == kept,
           f"{name}: num_total {int(metric.num_total)} != {kept} kept targets")
    _check(abs(got - nll64) <= bound, f"{name}: NLL sum {got} vs float64 {nll64}, bound {bound}")
    ppl64, ppl_bound = _ppl_float64(nll64, kept, bound)
    ppl = float(metric.compute())
    _check(abs(ppl - ppl64) <= ppl_bound, f"{name}: perplexity {ppl} vs float64 {ppl64}")
    report = {
        "windows": windows, "dtype": str(dtype).split(".")[-1], "targets": kept,
        "perplexity": ppl, "perplexity_float64": ppl64,
        "nll_rel_err_vs_float64": abs(got - nll64) / nll64, "nll_rel_bound": bound / nll64,
        "update_ms_median": _median(timers[name]), "update_ms_first": timers[name][0],
        "stream_peak_bytes": peak,
    }
    return (x, t), report


def _update_device(x, t, device):
    """One window update on the card, on a scratch metric (the measured
    stream is untouched): its time by CUDA events over back-to-back
    updates (the card, not the host, paces them), the share of the HBM
    bound that time reaches (the logits read once at 3.35 TB/s), the
    profiler's costliest kernels with their launches an update (CUPTI
    has dropped records of these traces, so its sum may fall short), and
    the update's peak bytes."""
    if torch.device(device).type != "cuda":
        return {}
    scratch = Perplexity(ignore_index=IGNORE, device=device)
    _sync(device)
    before = torch.cuda.memory_allocated(device)
    _reset_peak(device)
    scratch.update(x, t)
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device)
    event_ms = _time_ms(lambda: scratch.update(x, t), device, reps=5)
    prof = _profile(lambda: scratch.update(x, t), device, reps=3)
    logit_bytes = x.numel() * x.element_size()
    bound_ms = logit_bytes / HBM_BYTES_PER_S * 1e3
    return {"event_ms": event_ms, "hbm_bound_ms": bound_ms,
            "hbm_bound_share": bound_ms / event_ms, "logit_bytes": logit_bytes,
            "profile_device_ms": prof["device_ms"], "top_kernels": prof["top_kernels"],
            "update_peak_bytes": peak, "update_extra_bytes": peak - before}


def _lm_perplexity(device, vocab, context, tokens, stride, sliding_windows, bf16_windows,
                   margin, chunk, seed):
    """Perplexity at Llama-3-8B width: the non-overlapping stream over
    ``tokens`` targets (the last window short, padded with ``IGNORE``,
    three targets planted out of range), the sliding-window stream, the
    bfloat16 stream and the functional form on one window."""
    gen = torch.Generator(device=device).manual_seed(seed)
    full = math.ceil(tokens / context)
    last_real = tokens - (full - 1) * context

    def plain(w, dtype=torch.float32):
        real = slice(0, context if w < full - 1 else last_real)
        return (*_lm_window(gen, vocab, context, real, margin, dtype, device), real)

    def sliding(w):
        real = slice(context - stride, context)
        return (*_lm_window(gen, vocab, context, real, margin, torch.float32, device), real)

    # a stream's last window is freed before the next stream starts, so
    # each peak holds one window's logits
    out = {}
    out["nonoverlapping"] = _ppl_stream(
        "nonoverlapping", device, gen, full, plain, torch.float32, vocab, chunk, plant=True)[1]
    _check(out["nonoverlapping"]["targets"] == tokens, "non-overlapping target count")
    window, out["sliding"] = _ppl_stream(
        "sliding", device, gen, sliding_windows, sliding, torch.float32, vocab, chunk)
    _check(out["sliding"]["targets"] == sliding_windows * stride, "sliding target count")
    out["sliding"]["update_device"] = _update_device(*window, device)
    del window
    window, out["bf16"] = _ppl_stream(
        "bf16", device, gen, bf16_windows, lambda w: plain(0, torch.bfloat16), torch.bfloat16,
        vocab, chunk)
    out["bf16"]["update_device"] = _update_device(*window, device)
    del window

    # the functional form on one full window, beside its oracle
    x, t, real = plain(0)
    out["nonoverlapping"]["update_device"] = _update_device(x, t, device)
    _reset_peak(device)
    _sync(device)
    t0 = time.perf_counter()
    ppl = float(perplexity(x, t, ignore_index=IGNORE))
    wall_ms = (time.perf_counter() - t0) * 1e3
    n, k, mags = _nll_oracle(x, t, real, chunk)
    ppl64, ppl_bound = _ppl_float64(float(n), k, float(_window_bound(mags, n, k, vocab,
                                                                     torch.float32)))
    _check(abs(ppl - ppl64) <= ppl_bound, f"functional perplexity {ppl} vs float64 {ppl64}")
    out["functional"] = {"perplexity": ppl, "perplexity_float64": ppl64,
                         "rel_err_vs_float64": abs(ppl - ppl64) / ppl64, "wall_ms": wall_ms,
                         "peak_bytes": _stream_peak(device)}
    for name in ("nonoverlapping", "sliding", "bf16"):
        _check(3.0 <= out[name]["perplexity"] <= 30.0,
               f"{name}: perplexity {out[name]['perplexity']} outside [3, 30]")
    return out


def _zipf_sentences(rng, n, vocab, sub, dele, lo=5, hi=60):
    """``n`` reference sentences of ``lo`` to ``hi`` tokens drawn from a
    Zipfian (s = 1) vocabulary of ``vocab`` words, and for each a
    hypothesis made from it by substituting each token with probability
    ``sub`` (a fresh Zipfian draw) and deleting it with probability
    ``dele``: token lists, both."""
    p = 1.0 / np.arange(1, vocab + 1)
    cdf = np.cumsum(p / p.sum())
    lengths = rng.integers(lo, hi + 1, n)
    total = int(lengths.sum())
    draw = np.minimum(np.searchsorted(cdf, rng.random(total)), vocab - 1)
    fresh = np.minimum(np.searchsorted(cdf, rng.random(total)), vocab - 1)
    swap, drop = rng.random(total) < sub, rng.random(total) < dele
    hyp_ids = np.where(swap, fresh, draw)
    refs, hyps, start = [], [], 0
    for length in lengths:
        span = slice(start, start + length)
        refs.append([f"w{i}" for i in draw[span]])
        hyps.append([f"w{i}" for i in hyp_ids[span][~drop[span]]])
        start += length
    return refs, hyps


def _ngram_oracle(hyps, refs, n_gram):
    """Clipped matches and possible matches per order, and the summed
    hypothesis and reference lengths, by ``collections.Counter``."""
    from collections import Counter

    matches, possible = [0] * n_gram, [0] * n_gram
    for h, r in zip(hyps, refs):
        for n in range(1, n_gram + 1):
            hc = Counter(tuple(h[i:i + n]) for i in range(len(h) - n + 1))
            rc = Counter(tuple(r[i:i + n]) for i in range(len(r) - n + 1))
            matches[n - 1] += sum(min(c, rc[g]) for g, c in hc.items())
            possible[n - 1] += max(len(h) - n + 1, 0)
    return matches, possible, sum(map(len, hyps)), sum(map(len, refs))


def _bleu64(matches, possible, hyp_len, ref_len):
    geo = math.exp(sum(0.25 * math.log(m / p) for m, p in zip(matches, possible)))
    return geo * (1.0 if hyp_len > ref_len else math.exp(1 - ref_len / hyp_len))


def _lm_bleu(device, pairs, vocab, batch, seed):
    """BLEU at WMT14 En-De newstest2014 scale: ``BLEUScore(n_gram=4)`` in
    batches of ``batch`` and ``bleu_score`` once over the set; counters
    bitwise against a ``Counter`` oracle, the score within 1e-6 of
    float64."""
    rng = np.random.default_rng(seed)
    refs, hyps = _zipf_sentences(rng, pairs, vocab, sub=0.3, dele=0.08)
    hyp_s, ref_s = [" ".join(h) for h in hyps], [[" ".join(r)] for r in refs]
    metric, timers = BLEUScore(n_gram=4, device=device), {}
    for lo in range(0, pairs, batch):
        _timed_update(timers, "bleu", device,
                      lambda: metric.update(hyp_s[lo:lo + batch], ref_s[lo:lo + batch]))
    matches, possible, hyp_len, ref_len = _ngram_oracle(hyps, refs, 4)
    _check(metric.input_len == hyp_len and metric.target_len == ref_len,
           "BLEU lengths != the Counter oracle")
    for got, want, what in ((metric.matches_by_order, matches, "matches"),
                            (metric.possible_matches_by_order, possible, "possible matches")):
        want = np.asarray(want, dtype=np.float32)
        _check(got.cpu().numpy().tobytes() == want.tobytes(), f"BLEU {what} != the Counter oracle")
    score64 = _bleu64(matches, possible, hyp_len, ref_len)
    values, computes = _compute_reports({"bleu": metric}, device)
    _sync(device)
    t0 = time.perf_counter()
    functional = bleu_score(hyp_s, ref_s, n_gram=4, device=device)
    _sync(device)
    functional_ms = (time.perf_counter() - t0) * 1e3
    for what, got in (("BLEUScore", values["bleu"]), ("bleu_score", functional)):
        _check(abs(float(got) - score64) <= 1e-6, f"{what} {float(got)} vs float64 {score64}")
    _check(0.2 <= score64 <= 0.4, f"BLEU {score64} outside [0.2, 0.4]")
    return {"pairs": pairs, "batch": batch, "vocab": vocab, "hypothesis_tokens": hyp_len,
            "reference_tokens": ref_len, "bleu": float(values["bleu"]), "bleu_float64": score64,
            "abs_err_vs_float64": abs(float(values["bleu"]) - score64), "counters_bitwise": True,
            "update_ms_median": _median(timers["bleu"]), "compute": computes,
            "functional_ms": functional_ms}


def _levenshtein(a, b):
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i]
        for j, y in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (x != y)))
        prev = cur
    return prev[-1]


def _lm_word_rates(device, utterances, vocab, batch, seed):
    """WER, WIL and WIP at LibriSpeech test-clean scale, classes in
    batches of ``batch`` and the functional forms once: counts bitwise
    against a pure-Python Levenshtein DP, each rate bitwise against the
    float32 quotients of those counts."""
    rng = np.random.default_rng(seed)
    refs, hyps = _zipf_sentences(rng, utterances, vocab, sub=0.1, dele=0.05)
    hyp_s, ref_s = [" ".join(h) for h in hyps], [" ".join(r) for r in refs]
    metrics = {"wer": WordErrorRate(device=device), "wil": WordInformationLost(device=device),
               "wip": WordInformationPreserved(device=device)}
    timers = {}
    for lo in range(0, utterances, batch):
        for name, m in metrics.items():
            _timed_update(timers, name, device,
                          lambda: m.update(hyp_s[lo:lo + batch], ref_s[lo:lo + batch]))
    errors = sum(_levenshtein(h, r) for h, r in zip(hyps, refs))
    hyp_len, ref_len = sum(map(len, hyps)), sum(map(len, refs))
    correct = sum(max(len(h), len(r)) for h, r in zip(hyps, refs)) - errors
    states = {"wer": {"errors": errors, "total": ref_len},
              "wil": {"correct_total": correct, "target_total": ref_len, "preds_total": hyp_len},
              "wip": {"correct_total": correct, "target_total": ref_len, "input_total": hyp_len}}
    for name, want in states.items():
        for state, value in want.items():
            _check(getattr(metrics[name], state) == value,
                   f"{name}.{state} {getattr(metrics[name], state)} != the DP's {value}")
    f = np.float32
    c, t, h = f(correct), f(ref_len), f(hyp_len)
    want = {"wer": f(errors) / t, "wil": f(1) - (c / t) * (c / h), "wip": (c / t) * (c / h)}
    values, computes = _compute_reports(metrics, device)
    functional = {}
    for name, fn in (("wer", word_error_rate), ("wil", word_information_lost),
                     ("wip", word_information_preserved)):
        _sync(device)
        t0 = time.perf_counter()
        functional[name] = fn(hyp_s, ref_s, device=device)
        _sync(device)
        computes[name]["functional_ms"] = (time.perf_counter() - t0) * 1e3
    for name, w in want.items():
        for what, got in (("class", values[name]), ("functional", functional[name])):
            got = got.cpu().numpy()
            _check(got.dtype == np.float32 and got.tobytes() == np.asarray(w).tobytes(),
                   f"{name} ({what}) {got} != the float32 quotient {w}")
    return {"utterances": utterances, "batch": batch, "vocab": vocab, "bitwise": True,
            "errors": errors, "reference_words": ref_len, "hypothesis_words": hyp_len,
            "values": {k: float(v) for k, v in want.items()},
            "update_ms_median": {k: _median(v) for k, v in timers.items()},
            "compute": computes}


def phase_lm_eval(device, vocab=LLAMA3_VOCAB, context=LLAMA3_CONTEXT,
                  tokens=WIKITEXT2_TEST_TOKENS, stride=SLIDING_STRIDE, sliding_windows=8,
                  bf16_windows=4, margin=PPL_MARGIN, chunk=1024, pairs=WMT14_NEWSTEST,
                  utterances=LIBRISPEECH_TEST_CLEAN, text_vocab=TEXT_VOCAB, text_batch=64,
                  seed=9):
    """The language-model eval path: ``Perplexity`` at Llama-3-8B width
    over a WikiText-2-sized stream (non-overlapping and sliding windows,
    float32 and bfloat16 logits, out-of-range targets planted) and the
    functional form; BLEU at WMT14 newstest2014 scale; WER, WIL and WIP at
    LibriSpeech test-clean scale. K1 counts are zeroed at the start and
    read at the end: none of this launches it."""
    t0 = time.perf_counter()
    _kernels.reset_launch_counts()
    ppl = _lm_perplexity(device, vocab, context, tokens, stride, sliding_windows, bf16_windows,
                         margin, chunk, seed)
    bleu = _lm_bleu(device, pairs, text_vocab, text_batch, seed + 1)
    words = _lm_word_rates(device, utterances, text_vocab, text_batch, seed + 2)
    launches = _kernels.LAUNCHES["fused_auc_hist"]
    _check(launches == 0, f"K1 launched {launches} times in lm_eval")
    return {"phase": "lm_eval", "device": str(device), "seconds": time.perf_counter() - t0,
            "k1_launches": launches, "vocab": vocab, "context": context, "margin": margin,
            "perplexity": ppl, "bleu": bleu, "word_rates": words}


# ------------------------------------------------------------- image eval

CIFAR10_TEST = 10_000  # CIFAR-10 test images: FID-10k against as many generated
CIFAR10_SIZE = 32
FID_BATCH = 250
VIT_L_WIDTH = 1024  # ViT-L/16 hidden width
VIT_SIZE = 224
VIT_PATCH = 16
DIV2K_VALID = 100  # DIV2K validation pairs
DIV2K_HW = (1356, 2040)  # DIV2K's 2K frame (2040 wide)
NYU_TEST = 654  # NYU Depth v2 test split (Eigen et al.)
NYU_HW = (480, 640)
PSNR_NOISE = 0.05
DEPTH_ERROR = 0.3  # metres, the depth predictions' seeded error
INVALID_DEPTH = 0.05  # share of pixels without a depth reading
IMAGE_TOL = 1e-5  # PSNR, regression and AUC values against float64, relative
# Limits on the float32 FID's distance from two of ``_fid_witnesses``,
# and on the FID of one stream fed twice, relative to tr S1 + tr S2: set
# from the image phase's readings on an NVIDIA H100 80GB HBM3 (700 W),
# where InceptionV3 reads 5.1e-3 and 5.6e-3 (float64 compute), 5.8e-3 and
# 6.3e-3 (CPU float32) and 4.3e-3 (twice), and the ViT-L stand-in 2.7e-5
# and 1.4e-5. Each limit is at least twice the largest reading, on the
# card at full size or on the CPU at the tests' small sizes (there the
# twice-fed stream reads 9.9e-3 and ViT-L 1.5e-4), and at least 50 times
# under the trace.
FID_LIMITS = {
    "inception": {"float64_compute_of_float32_states": 2e-2, "cpu_float32": 2e-2, "twice": 2e-2},
    "vit_l": {"float64_compute_of_float32_states": 5e-4, "cpu_float32": 5e-4},
}
# the longest chain of convolutions through InceptionV3 (stem 5, Mixed_5*
# 3 each, Mixed_6a 3, Mixed_6b-e 5 each, Mixed_7a 4, Mixed_7b-c 3 each)
INCEPTION_CONV_DEPTH = 47
# H100 SXM dense peaks (NVIDIA data sheet): TF32 tensor cores, float32
PEAK_FLOPS = {"tf32": 495e12, "float32": 67e12}
# operand rounding of a convolution's products: TF32 keeps 10 mantissa
# bits (2^-11 for each of the two operands)
CONV_INPUT_U = {"tf32": 2.0 ** -10, "float32": 0.0}


def _conv_precision(device):
    cuda = torch.device(device).type == "cuda"
    return "tf32" if cuda and torch.backends.cudnn.allow_tf32 else "float32"


def _feature_tol(precision, depth, k_max):
    """What pooled features may be off from a float64 forward, relative to
    their largest magnitude: each conv rounds its operands (TF32: 2^-10 a
    product) and sums ``k`` products in float32 (about ``sqrt(k) u``); the
    errors of ``depth`` convs in a chain add as a random walk, and a
    factor 10 covers the largest of the features against the typical one
    and the layers' gains."""
    return 10 * math.sqrt(depth) * (CONV_INPUT_U[precision] + math.sqrt(k_max) * U32)


class _PatchEmbedMean(torch.nn.Module):
    """ViT-L/16's patch embedding -- a 16x16 stride-16 conv from 3 to 1,024
    channels at 224x224 -- mean-pooled over the 196 patches: a fixed random
    stand-in for ViT-L features (no ViT-L runs)."""

    def __init__(self, width, gen):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, width, VIT_PATCH, stride=VIT_PATCH)
        fan_in = 3 * VIT_PATCH * VIT_PATCH
        with torch.no_grad():
            self.conv.weight.copy_(torch.randn(self.conv.weight.shape, generator=gen) / fan_in ** 0.5)
            self.conv.bias.copy_(torch.randn(self.conv.bias.shape, generator=gen) * 0.02)

    def forward(self, x):
        return self.conv(x).mean(dim=(2, 3))


_FID_STATES = ("real_sum", "real_cov_sum", "num_real_images", "fake_sum", "fake_cov_sum",
               "num_fake_images")


class _Tap:
    """A forward hook on the extractor: float64 sums of every batch of
    float32 activations it hands the metric -- the sum, A^T A, and their
    magnitudes' (|A| sums, |A|^T |A|) for the bound -- under the current
    ``key`` (None: not recorded)."""

    def __init__(self, module):
        self.key, self.sums, self.last = None, {}, None
        self._handle = module.register_forward_hook(self._hook)

    def _hook(self, module, inputs, output):
        self.last = output
        if self.key is None:
            return
        a = output.detach().double()
        m = a.abs()
        s = self.sums.setdefault(self.key, [0, 0.0, 0.0, 0.0, 0.0])
        s[0] += a.shape[0]
        s[1] = s[1] + a.sum(0)
        s[2] = s[2] + a.T @ a
        s[3] = s[3] + m.sum(0)
        s[4] = s[4] + m.T @ m

    def remove(self):
        self._handle.remove()


def _fid_state_check(metric, tap, keys, batch):
    """Each float32 state against the float64 sum of the same activations:
    a batch's delta is a float32 sum of ``batch`` products (within
    ``(batch - 1) u`` of the sum of their magnitudes, whatever the order),
    and each of the ``updates`` adds into the state rounds once more:
    ``|error| <= (batch - 1 + updates) u sum|terms|``. Returns (ok, max
    error relative to the magnitudes)."""
    ok, worst = True, 0.0
    for side, key in zip(("real", "fake"), keys):
        n, s64, c64, abs_s, abs_c = tap.sums[key]
        updates = -(-n // batch)
        count = int(getattr(metric, f"num_{side}_images"))
        ok &= count == n
        for state, want, mag in ((getattr(metric, f"{side}_sum"), s64, abs_s),
                                 (getattr(metric, f"{side}_cov_sum"), c64, abs_c)):
            err = (state.double() - want).abs()
            ok &= bool((err <= (batch - 1 + updates) * U32 * mag).all())
            worst = max(worst, float((err / mag.clamp(min=1e-300)).max()))
    return ok, worst


def _fid_of_moments64(m1, s1, m2, s2):
    """FID in float64 numpy from two means and covariances, by the
    real-symmetric formula of ``_frechet_distance``; with the eigenvalues
    of ``sqrt(S1) S2 sqrt(S1)``."""
    w, v = np.linalg.eigh((s1 + s1.T) / 2)
    root = (v * np.sqrt(np.clip(w, 0, None))) @ v.T
    inner = root @ s2 @ root
    lam = np.linalg.eigvalsh((inner + inner.T) / 2)
    fid = (float(np.sum((m1 - m2) ** 2)) + float(np.trace(s1) + np.trace(s2))
           - 2 * float(np.sum(np.sqrt(np.clip(lam, 0, None)))))
    return fid, lam


def _fid64(real, fake):
    """FID from float64 sufficient statistics, on the host in numpy, by the
    same real-symmetric formula; with ``tr S1 + tr S2`` and a worst-case
    bound on the float32 value's error, reported beside the checks that
    hold it (``FID_LIMITS``). The bound: every float32 step (the
    covariances, sqrt(S1), the product, each eigensolver) is backward
    stable to ``d u`` of the second moments' spectral norms, so each
    eigenvalue of ``sqrt(S1) S2 sqrt(S1)`` moves by at most ``delta = 4 d u
    |E1| |E2|``
    (Weyl), and its square root by at most ``sqrt(l + delta) -
    sqrt(l - delta)``; the traces and the mean term move by ``4 d u`` of
    the second moments' traces. On mean-dominated features ``|E1| |E2|``
    is huge and the bound exceeds the trace."""
    stats = []
    for n, s, c, _, _ in (real, fake):
        s, c = s.cpu().numpy(), c.cpu().numpy()
        mean = s / n
        stats.append((mean, (c - n * np.outer(mean, mean)) / (n - 1), c / n))
    (m1, s1, e1), (m2, s2, e2) = stats
    d = m1.shape[0]
    fid, lam = _fid_of_moments64(m1, s1, m2, s2)
    mean_sq = float(np.sum((m1 - m2) ** 2))
    trace = float(np.trace(s1) + np.trace(s2))
    moments = float(np.trace(e1) + np.trace(e2))
    norms = float(np.linalg.eigvalsh(e1)[-1]) * float(np.linalg.eigvalsh(e2)[-1])

    def bound(c):
        delta = c * U32 * norms
        spread = np.sqrt(lam.clip(0) + delta) - np.sqrt(np.clip(lam - delta, 0, None))
        return 2 * float(spread.sum()) + c * U32 * (moments + mean_sq)

    # p(d) = 4 d is the worst case; LAPACK's users' guide estimates its
    # eigensolvers' errors with p(d) = 1
    return fid, trace, bound(4 * d), {"second_moments_over_trace": moments / trace,
                                      "approx_bound_rel_trace": bound(4) / trace}


def _fid_witnesses(states):
    """The FID of the float32 ``states`` by three other routes, which place
    the error of the float32 compute: ``float64_compute_of_float32_states``
    (the same function in float64: what the states' rounding alone
    costs), ``float32_covariances_float64_rest`` (the function's own
    float32 covariances, where ``E - mu mu^T`` cancels, and the rest in
    float64 on the host) and ``cpu_float32`` (the same float32 function
    on the CPU, where the JAX package computes it)."""
    real_sum, real_cov_sum, num_real, fake_sum, fake_cov_sum, num_fake = states
    moments = (*_covariance(real_sum, real_cov_sum, num_real.to(torch.float32)),
               *_covariance(fake_sum, fake_cov_sum, num_fake.to(torch.float32)))
    return {
        "float64_compute_of_float32_states": float(_frechet_distance(*(t.double() for t in states))),
        "float32_covariances_float64_rest": _fid_of_moments64(
            *(t.double().cpu().numpy() for t in moments))[0],
        "cpu_float32": float(_frechet_distance(*(t.cpu() for t in states))),
    }


def _feature_check(extractor, forward64, images, depth, k_max, device):
    """A few images' features against a float64 forward of the same module
    on the same device, under the card's default conv precision and under
    float32 convs; each within ``_feature_tol`` of its precision."""
    with torch.no_grad():
        want = forward64(images.double())
    out = {}
    for precision, allow in (("default", True), ("float32", False)):
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=allow):
            used = _conv_precision(device)
            with torch.no_grad():
                got = extractor(images).double()
        err = float((got - want).abs().max() / want.abs().max())
        tol = _feature_tol(used, depth, k_max)
        _check(err <= tol, f"features under {used} convs off by {err} of their scale, tol {tol}")
        out[precision] = {"conv_precision": used, "rel_err_vs_float64": err, "tol": tol}
    return out


def _conv_flops(module, images):
    """FLOPs of one forward counted from the architecture: every conv's
    2 * C_in/groups * k_h * k_w multiply-adds an output element (batch
    norm, pooling and the resize are not counted)."""
    flops = [0]

    def hook(m, inputs, output):
        kh, kw = m.kernel_size
        flops[0] += 2 * output.numel() * (m.in_channels // m.groups) * kh * kw

    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.no_grad():
            module(images)
    finally:
        for h in handles:
            h.remove()
    return flops[0]


def _extractor_rate(extractor, images, device):
    """Images a second through the extractor (CUDA events over a batch)
    and the share of the dense peak its conv FLOPs reach, under the
    default conv precision and under float32 convs. Card only."""
    if torch.device(device).type != "cuda":
        return None
    flops = _conv_flops(extractor, images)
    out = {"flops_per_image": flops / images.shape[0]}
    for precision, allow in (("default", True), ("float32", False)):
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=allow):
            used = _conv_precision(device)
            ms = _time_ms(lambda: extractor(images), device, reps=5)
        out[precision] = {"conv_precision": used, "batch_ms": ms,
                          "images_per_s": images.shape[0] / ms * 1e3,
                          "peak_share": flops / (ms * 1e-3) / PEAK_FLOPS[used]}
    return out


def _accumulate_timing(acts, device):
    """Device ms of one batch's accumulate (sum, A^T A and count into the
    states) on a scratch metric, its bound (the activations read once, the
    states read and written once, or the float32 matmul at the dense
    peak) and ``torch.addmm`` into the covariance as the library call.
    Card only."""
    if torch.device(device).type != "cuda":
        return None
    b, d = acts.shape
    scratch = FrechetInceptionDistance(model=torch.nn.Identity(), feature_dim=d, device=device)
    plan = (_fid_accumulate, ("real_sum", "real_cov_sum", "num_real_images"), (acts,), ())
    ms = _time_ms(lambda: scratch._apply_update_plan(plan), device, reps=20)
    cov = torch.zeros((d, d), device=device)
    library_ms = _time_ms(lambda: torch.addmm(cov, acts.T, acts, out=cov), device, reps=20)
    bytes_ms = (4 * b * d + 2 * 4 * (d * d + d)) / HBM_BYTES_PER_S * 1e3
    flops_ms = 2 * b * d * d / PEAK_FLOPS["float32"] * 1e3
    return {"device_ms": ms, "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "operations" if flops_ms > bytes_ms else "bytes",
            "library_ms_addmm": library_ms}


def _compute_timing(metric, device):
    """One compute's wall ms (first and warm, from a drained queue) and,
    on the card, its device ms by CUDA events and, from one profiler
    trace, its device time split into ``linalg_eigh``, ``linalg_eigvalsh``
    and the rest, with the peak bytes it allocates."""
    _reset_peak(device)
    value, first = _timed_compute(metric, device)
    out = {"wall_ms_first": first * 1e3, "wall_ms_warm": _timed_compute(metric, device)[1] * 1e3,
           "peak_bytes": _stream_peak(device)}
    if torch.device(device).type != "cuda":
        return value, out
    out["event_ms"] = _time_ms(metric.compute, device, reps=3)
    prof = _profile(metric.compute, device, ops=("aten::linalg_eigh", "aten::linalg_eigvalsh"))
    out["profile"] = prof["device_ms"]
    out["eigh_ms"] = prof["op_ms"]["aten::linalg_eigh"]
    out["eigvalsh_ms"] = prof["op_ms"]["aten::linalg_eigvalsh"]
    out["rest_ms"] = out["profile"] - out["eigh_ms"] - out["eigvalsh_ms"]
    return value, out


def _fid_stream(name, device, metric, extractor, make_batch, n, batch, limits, twice=False):
    """Feed ``n`` real and ``n`` generated images in batches of ``batch``
    (``make_batch(real, size)``) to ``metric``, and, with ``twice``, the
    real stream as both sides to a second metric on the same extractor;
    float64 sums of the activations ride along. Checks the states and the
    FID values against float64 and against ``_fid_witnesses`` within
    ``limits`` (relative to ``tr S1 + tr S2``), and returns the report."""
    tap = _Tap(extractor)
    other = (FrechetInceptionDistance(model=metric.model, feature_dim=metric.real_sum.numel(),
                                      device=device) if twice else None)
    _reset_peak(device)
    _sync(device)
    t0 = time.perf_counter()
    for lo in range(0, n, batch):
        size = min(batch, n - lo)
        real, fake = make_batch(True, size), make_batch(False, size)
        tap.key = "real"
        metric.update(real, is_real=True)
        tap.key = "fake"
        metric.update(fake, is_real=False)
        if other is not None:
            tap.key = "twice_real"
            other.update(real, is_real=True)
            tap.key = "twice_fake"
            other.update(real, is_real=False)
    tap.key = None
    _sync(device)
    seconds = time.perf_counter() - t0
    stream_peak = _stream_peak(device)
    acts = tap.last
    tap.remove()
    report = {"images": n, "batch": batch, "stream_seconds": seconds,
              "stream_images_per_s": (4 if twice else 2) * n / seconds,
              "stream_peak_bytes": stream_peak}
    for label, m, keys in (("fid", metric, ("real", "fake")),
                           ("twice", other, ("twice_real", "twice_fake"))):
        if m is None:
            continue
        ok, state_err = _fid_state_check(m, tap, keys, batch)
        _check(ok, f"{name} {label}: FID states off their float64 sums beyond the float32 bound")
        fid64, trace, bound, extra = _fid64(tap.sums[keys[0]], tap.sums[keys[1]])
        value, timing = _compute_timing(m, device)
        fid = float(value)
        err = abs(fid - fid64)
        _check(math.isfinite(fid) and value.shape == (), f"{name} {label}: FID {value}")
        _check(err <= bound, f"{name} {label}: FID {fid} vs float64 {fid64}, bound {bound}")
        witnesses = _fid_witnesses(tuple(getattr(m, a) for a in _FID_STATES))
        off = {k: abs(fid - v) / trace for k, v in witnesses.items()}
        for key in ("float64_compute_of_float32_states", "cpu_float32"):
            _check(off[key] <= limits[key], f"{name} {label}: FID {fid} vs {key} {witnesses[key]}: "
                   f"{off[key]} of the trace, limit {limits[key]}")
        report[label] = {"value": fid, "float64": fid64, "trace_sum": trace,
                         "err_rel_trace": err / trace, "bound_rel_trace": bound / trace,
                         **witnesses, "off_rel_trace": off,
                         "states_err_rel_trace": abs(witnesses[
                             "float64_compute_of_float32_states"] - fid64) / trace,
                         "state_err_rel": state_err, "compute": timing, **extra}
    _check(report["fid"]["value"] > 1e-3 * report["fid"]["trace_sum"],
           f"{name}: the two image sets' FID {report['fid']['value']} is not far from 0")
    if twice:
        twice_rel = abs(report["twice"]["value"]) / report["twice"]["trace_sum"]
        _check(twice_rel <= limits["twice"],
               f"{name}: one stream twice, FID {twice_rel} of the trace, limit {limits['twice']}")
    report["accumulate"] = _accumulate_timing(acts.detach().clone(), device)
    return report


def _image_fid(device, n, batch, size, vit_n, vit_batch, vit_size, vit_width, feature_images,
               seed):
    """FID on the default architecture (InceptionV3 at random seeded
    weights behind ``FIDInceptionV3``) over CIFAR-10-sized images, and at
    ViT-L width through a caller-supplied extractor."""
    gen = torch.Generator(device=device).manual_seed(seed)
    weights = init_inception_params(torch.Generator().manual_seed(seed))
    extractor = FIDInceptionV3(weights)
    metric = FrechetInceptionDistance(model=extractor, feature_dim=FEATURE_DIM, device=device)
    _check(not extractor.training and not any(m.training for m in extractor.modules()),
           "FIDInceptionV3 left training mode on")

    def cifar(real, count):
        x = torch.rand((count, 3, size, size), generator=gen, device=device)
        return x if real else x * x  # generated: a darker, skewed distribution

    report = {"conv_precision": _conv_precision(device),
              "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
              "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    inception = _fid_stream("inception", device, metric, extractor, cifar, n, batch,
                            FID_LIMITS["inception"], twice=True)
    sample = cifar(True, feature_images)
    k_max = max(m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                for m in extractor.modules() if isinstance(m, torch.nn.Conv2d))
    model64 = copy.deepcopy(extractor.model).double()
    inception["features"] = _feature_check(
        extractor, lambda x: model64(_resize_299(x)), sample, INCEPTION_CONV_DEPTH, k_max, device)
    del model64
    inception["extractor"] = _extractor_rate(extractor, cifar(True, batch), device)
    report["inception"] = inception

    vit = _PatchEmbedMean(vit_width, torch.Generator().manual_seed(seed + 1)).to(device)
    vit_metric = FrechetInceptionDistance(model=vit, feature_dim=vit_width, device=device)

    def frames(real, count):
        x = torch.rand((count, 3, vit_size, vit_size), generator=gen, device=device)
        return x if real else 0.25 + 0.5 * x  # generated: a narrower range

    report["vit_l"] = _fid_stream("vit_l", device, vit_metric, vit, frames, vit_n, vit_batch,
                                  FID_LIMITS["vit_l"])
    vit64 = copy.deepcopy(vit).double()
    report["vit_l"]["features"] = _feature_check(
        vit, vit64, frames(True, feature_images), 1, 3 * VIT_PATCH * VIT_PATCH, device)
    report["vit_l"]["extractor"] = _extractor_rate(vit, frames(True, vit_batch), device)
    return report


def _image_psnr(device, pairs, hw, seed):
    """PSNR at DIV2K validation scale: ``pairs`` (1, 3, H, W) targets in
    [0, 1] and restorations with seeded N(0, PSNR_NOISE^2) noise, into
    ``PeakSignalNoiseRatio`` with the auto range and with ``data_range=1.0``,
    and ``peak_signal_noise_ratio`` on the last pair; each held to float64.
    Returns the report and the per-image float64 PSNR at range 1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    auto = PeakSignalNoiseRatio(device=device)
    fixed = PeakSignalNoiseRatio(data_range=1.0, device=device)
    timers = {}
    sse64, n, lo, hi, per_image = 0.0, 0, math.inf, -math.inf, []
    for _ in range(pairs):
        target = torch.rand((1, 3) + hw, generator=gen, device=device)
        restored = target + PSNR_NOISE * torch.randn((1, 3) + hw, generator=gen, device=device)
        _timed_update(timers, "auto", device, lambda: auto.update(restored, target))
        _timed_update(timers, "fixed", device, lambda: fixed.update(restored, target))
        sse = float(((restored.double() - target.double()) ** 2).sum())
        sse64 += sse
        n += target.numel()
        lo, hi = min(lo, float(target.min())), max(hi, float(target.max()))
        per_image.append(10 * math.log10(target.numel() / sse))
    one = float(peak_signal_noise_ratio(restored, target))
    want_one = 10 * math.log10((float(target.max()) - float(target.min())) ** 2 / (sse / target.numel()))
    want_auto = 10 * math.log10((hi - lo) ** 2 / (sse64 / n))
    want_fixed = 10 * math.log10(1.0 / (sse64 / n))
    ok, count_err, _ = _within_bound([auto.num_observations], [torch.tensor(float(n))], pairs)
    _check(ok, f"psnr: num_observations off {n} by {count_err}")
    errs = {"auto": _rel_err(auto.compute(), want_auto), "fixed": _rel_err(fixed.compute(), want_fixed),
            "functional": _rel_err(one, want_one)}
    _check(max(errs.values()) <= IMAGE_TOL, f"psnr: relative errors {errs}")
    _check(float(auto.data_range) == hi - lo, "psnr: auto data_range is not max - min of the targets")
    report = {"pairs": pairs, "shape": [1, 3, *hw], "auto": float(auto.compute()),
              "fixed": float(fixed.compute()), "functional": one, "rel_err_vs_float64": errs,
              "update_ms_median": {k: _median(v) for k, v in timers.items()}}
    return report, per_image


def _image_depth(device, maps, hw, outputs, seed):
    """Regression at NYU Depth v2 test scale: ``maps`` depth maps (metres
    in [0.5, 10), ``INVALID_DEPTH`` of the pixels without a reading) and
    predictions off by seeded N(0, DEPTH_ERROR^2) error, flattened to
    pixels: ``MeanSquaredError`` weighted by the valid mask and unweighted,
    ``R2Score``; a second stream of ``outputs`` outputs (each map's pixels
    in rows of ``outputs``) into ``MeanSquaredError`` and ``R2Score`` with
    ``raw_values``, ``R2Score`` with ``variance_weighted`` and adjusted R2;
    ``Max``, ``Min`` and ``Cat`` over the depth. Each held to float64 (Cat
    bitwise to a host concatenation)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    regressors = 4
    m = {
        "mse_weighted": MeanSquaredError(device=device),
        "mse": MeanSquaredError(device=device),
        "r2": R2Score(device=device),
        "mse_raw": MeanSquaredError(multioutput="raw_values", device=device),
        "r2_raw": R2Score(multioutput="raw_values", device=device),
        "r2_variance_adjusted": R2Score(multioutput="variance_weighted",
                                        num_regressors=regressors, device=device),
    }
    mx, mn, cat = Max(device=device), Min(device=device), Cat(device=device)
    z = lambda *s: torch.zeros(s, dtype=torch.float64, device=device)  # noqa: E731
    o = {"w_sse": z(), "w": z(), "sse": z(), "y": z(), "yy": z(),
         "col_sse": z(outputs), "col_y": z(outputs), "col_yy": z(outputs)}
    timers, host, pixels = {}, [], hw[0] * hw[1]
    for _ in range(maps):
        depth = 0.5 + 9.5 * torch.rand(pixels, generator=gen, device=device)
        valid = torch.rand(pixels, generator=gen, device=device) >= INVALID_DEPTH
        depth = torch.where(valid, depth, torch.zeros_like(depth))
        pred = depth + DEPTH_ERROR * torch.randn(pixels, generator=gen, device=device)
        w = valid.to(torch.float32)
        rows, rows_t = pred.reshape(-1, outputs), depth.reshape(-1, outputs)
        _timed_update(timers, "mse_weighted", device,
                      lambda: m["mse_weighted"].update(pred, depth, sample_weight=w))
        _timed_update(timers, "mse", device, lambda: m["mse"].update(pred, depth))
        _timed_update(timers, "r2", device, lambda: m["r2"].update(pred, depth))
        for name in ("mse_raw", "r2_raw", "r2_variance_adjusted"):
            _timed_update(timers, name, device, lambda k=name: m[k].update(rows, rows_t))
        _timed_update(timers, "max", device, lambda: mx.update(depth))
        _timed_update(timers, "min", device, lambda: mn.update(depth))
        _timed_update(timers, "cat", device, lambda: cat.update(depth))
        d64, p64 = depth.double(), pred.double()
        e2 = (d64 - p64) ** 2
        o["w_sse"] += (e2 * w.double()).sum()
        o["w"] += w.double().sum()
        o["sse"] += e2.sum()
        o["y"] += d64.sum()
        o["yy"] += (d64 * d64).sum()
        o["col_sse"] += e2.reshape(-1, outputs).sum(0)
        o["col_y"] += d64.reshape(-1, outputs).sum(0)
        o["col_yy"] += (d64 * d64).reshape(-1, outputs).sum(0)
        host.append(depth.cpu().numpy())
    o = {k: v.cpu() for k, v in o.items()}
    n, rows_n = float(maps * pixels), float(maps * pixels // outputs)
    tss = o["yy"] - o["y"] ** 2 / n
    col_tss = o["col_yy"] - o["col_y"] ** 2 / rows_n
    col_r2 = 1 - o["col_sse"] / col_tss
    vw = (col_r2 * col_tss).sum() / col_tss.sum()
    want = {
        "mse_weighted": o["w_sse"] / o["w"], "mse": o["sse"] / n, "r2": 1 - o["sse"] / tss,
        "mse_raw": o["col_sse"] / rows_n, "r2_raw": col_r2,
        "r2_variance_adjusted": 1 - (1 - vw) * (rows_n - 1) / (rows_n - regressors - 1),
    }
    values = {k: metric.compute() for k, metric in m.items()}
    errs = {k: _rel_err(values[k], want[k]) for k in m}
    _check(max(errs.values()) <= IMAGE_TOL, f"depth: relative errors {errs}")
    ok, count_err, _ = _within_bound([m["r2"].num_obs, m["r2_raw"].num_obs],
                                     [torch.tensor(n), torch.tensor(rows_n)], maps)
    _check(ok, f"depth: R2 num_obs off by {count_err}")
    flat = np.concatenate(host)
    _check(float(mx.compute()) == float(flat.max()) and float(mn.compute()) == float(flat.min()),
           "depth: Max/Min differ from the host's")
    _check(np.array_equal(cat.compute().cpu().numpy(), flat), "depth: Cat differs from np.concatenate")
    return {"maps": maps, "shape": list(hw), "outputs": outputs, "pixels": int(n),
            "values": {k: (v.tolist() if v.ndim else float(v)) for k, v in values.items()},
            "rel_err_vs_float64": errs, "num_obs_err": count_err,
            "max": float(mx.compute()), "min": float(mn.compute()),
            "cat_bytes": cat.inputs.numel() * cat.inputs.element_size(), "cat_bitwise": True,
            "update_ms_median": {k: _median(v) for k, v in timers.items()}}


def _image_auc(device, per_image, seed):
    """``AUC(reorder=True)`` over four updates and ``auc`` once, both
    integrating the per-image PSNR against a seeded x, held to a float64
    trapezoid over the stable ascending order of x."""
    gen = torch.Generator(device=device).manual_seed(seed)
    y = torch.tensor(per_image, dtype=torch.float32, device=device)
    x = torch.rand(y.shape, generator=gen, device=device)
    metric = AUC(device=device)
    for part in torch.arange(y.numel(), device=device).chunk(4):
        metric.update(x[part], y[part])
    xs, ys = x.double().cpu().numpy(), y.double().cpu().numpy()
    order = np.argsort(xs, kind="stable")
    want = float(np.sum(np.diff(xs[order]) * (ys[order][1:] + ys[order][:-1]) / 2))
    got = {"class": float(metric.compute()[0]), "functional": float(auc(x, y, reorder=True)[0])}
    errs = {k: _rel_err(v, want) for k, v in got.items()}
    _check(max(errs.values()) <= IMAGE_TOL, f"auc: relative errors {errs}")
    return {"points": y.numel(), "values": got, "float64": want, "rel_err_vs_float64": errs}


def phase_image(device, fid_images=CIFAR10_TEST, fid_batch=FID_BATCH, cifar_size=CIFAR10_SIZE,
                vit_images=CIFAR10_TEST, vit_batch=FID_BATCH, vit_size=VIT_SIZE,
                vit_width=VIT_L_WIDTH, feature_images=4, psnr_pairs=DIV2K_VALID, psnr_hw=DIV2K_HW,
                depth_maps=NYU_TEST, depth_hw=NYU_HW, depth_outputs=8, seed=10):
    """The image-eval path (BASELINE config 5): FID on InceptionV3 at full
    width over CIFAR-10-test-sized sets (10,000 real against 10,000
    generated, a cut from the 50,000-image protocol), FID at ViT-L width
    through a patch-embedding extractor, PSNR at DIV2K validation scale,
    regression at NYU Depth v2 test scale, and the aggregation metrics on
    those streams. Conv precision is PyTorch's default (cuDNN TF32 on a
    card), set here through ``torch.backends.cudnn.flags``. K1 counts are
    zeroed at the start and read at the end: none of this launches it."""
    t0 = time.perf_counter()
    _kernels.reset_launch_counts()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        fid = _image_fid(device, fid_images, fid_batch, cifar_size, vit_images, vit_batch,
                         vit_size, vit_width, feature_images, seed)
    psnr, per_image = _image_psnr(device, psnr_pairs, tuple(psnr_hw), seed + 1)
    depth = _image_depth(device, depth_maps, tuple(depth_hw), depth_outputs, seed + 2)
    area = _image_auc(device, per_image, seed + 3)
    launches = _kernels.LAUNCHES["fused_auc_hist"]
    _check(launches == 0, f"K1 launched {launches} times in image")
    return {"phase": "image", "device": str(device), "seconds": time.perf_counter() - t0,
            "k1_launches": launches, "fid": fid, "psnr": psnr, "depth": depth, "auc": area}


# ------------------------------------------------------------------ windows

WINDOW_UPDATES = 100  # the reference's max_num_updates default
WINDOW_TOL = 1e-5  # windowed values against float64, relative
# NE, NE on logits, CTR, calibration and the Brier score: the counter
# windows and their non-windowed twins, by name
_WINDOW_TWINS = (("ne", "BinaryNormalizedEntropy"), ("ne_logits", "BinaryNormalizedEntropy"),
                 ("ctr", "ClickThroughRate"), ("calibration", "WeightedCalibration"),
                 ("brier", "MeanSquaredError"))
# per-batch float64 counters: ce, ce on logits, clicks, samples, scores, squared errors
_W_CE, _W_CE_LOGITS, _W_POS, _W_N, _W_S, _W_SQ = range(6)


def _counter_windows(device, window, lifetime=True, tasks=1):
    kw = dict(num_tasks=tasks, max_num_updates=window, enable_lifetime=lifetime, device=device)
    out = {"ne": WindowedBinaryNormalizedEntropy(**kw),
           "ctr": WindowedClickThroughRate(**kw),
           "calibration": WindowedWeightedCalibration(**kw)}
    if tasks == 1:
        out["ne_logits"] = WindowedBinaryNormalizedEntropy(from_logits=True, **kw)
        out["brier"] = WindowedMeanSquaredError(**kw)
    return out


def _window_updates(colls, x, s, y):
    """Each collection's members, through ``toolkit.update_collection``
    on the arguments their class takes: (scores, clicks), (logits,
    clicks) or clicks alone."""
    for coll in colls:
        on_scores = {k: m for k, m in coll.items() if k not in ("ne_logits", "ctr")}
        toolkit.update_collection(on_scores, s, y)
        if "ne_logits" in coll:
            toolkit.update_collection({"ne_logits": coll["ne_logits"]}, x, y)
        if "ctr" in coll:
            toolkit.update_collection({"ctr": coll["ctr"]}, y)


def _batch_counters(x, s, y):
    """float64 counters of one batch, in ``_W_*`` order."""
    return torch.stack([_ce64(s, y, False).sum(), _ce64(x, y, True).sum(), y.double().sum(),
                        torch.full((), float(y.numel()), dtype=torch.float64, device=y.device),
                        s.double().sum(), (s.double() - y.double()).square().sum()])


def _window_values64(c):
    """float64 NE (scores, logits), CTR, calibration and Brier of summed
    counters ``c`` (``_W_*`` order)."""
    n, pos = c[_W_N], c[_W_POS]
    h = _entropy64(pos, n)
    return {"ne": c[_W_CE] / n / h, "ne_logits": c[_W_CE_LOGITS] / n / h, "ctr": pos / n,
            "calibration": c[_W_S] / pos, "brier": c[_W_SQ] / n}


def _rings_vs_counters(windows, counters, updates, batch):
    """Every ring column against the float64 counters of the batch it
    holds (column ``i % window`` holds batch ``i``), within
    ``_float_bound``; the window covers the last ``window`` batches."""
    window = windows["ne"].max_num_updates
    first = max(0, updates - window)
    cols = torch.arange(first, updates) % window
    c = counters[first:updates].T.cpu()  # (6, live columns)
    pairs = [("ne", "total_entropy", _W_CE), ("ne", "num_examples", _W_N),
             ("ne", "num_positive", _W_POS), ("ne_logits", "total_entropy", _W_CE_LOGITS),
             ("ctr", "click_total", _W_POS), ("ctr", "weight_total", _W_N),
             ("calibration", "weighted_input_sum", _W_S),
             ("calibration", "weighted_target_sum", _W_POS),
             ("brier", "sum_squared_error", _W_SQ), ("brier", "sum_weight", _W_N)]
    states = [getattr(windows[k], f"windowed_{name}")[0, cols.to(windows[k].device)]
              for k, name, _ in pairs]
    return _float_bound(states, [c[i] for _, _, i in pairs], batch, 1)


def _weighted_auroc64(scores, labels, weights):
    """float64 exact AUROC of each row of (R, n) weighted samples, apart
    from the metrics' cumsum/trapezoid chain: each tie group's positive
    weight times the negative weight below it plus half its own, over the
    product of the row's positive and negative weights."""
    rows, n = scores.shape
    s, order = torch.sort(scores, dim=-1)
    y = torch.gather(labels.double(), 1, order)
    w = torch.gather(weights.double(), 1, order)
    new = torch.ones_like(s, dtype=torch.bool)
    new[:, 1:] = s[:, 1:] != s[:, :-1]
    new = new.reshape(-1)
    gid = torch.cumsum(new, 0) - 1
    groups = int(gid[-1]) + 1
    gp = torch.zeros(groups, dtype=torch.float64, device=s.device).index_add_(
        0, gid, (w * y).reshape(-1))
    gn = torch.zeros(groups, dtype=torch.float64, device=s.device).index_add_(
        0, gid, (w * (1 - y)).reshape(-1))
    row = torch.arange(rows, device=s.device).repeat_interleave(n)[new]
    first_gid = gid[torch.arange(rows, device=s.device) * n]
    below = torch.cumsum(gn, 0) - gn
    below = below - below[first_gid][row]
    num = torch.zeros(rows, dtype=torch.float64, device=s.device).index_add_(
        0, row, gp * (below + gn / 2))
    wpos = (w * y).sum(-1)
    wneg = (w * (1 - y)).sum(-1)
    return num / (wpos * wneg)


def _tail(batches, k):
    """The last ``k`` samples of a list of (tasks, n) batches."""
    return torch.cat(batches, dim=-1)[..., -k:]


def _keep_tail(batches, k):
    """Drop the oldest batches that the last ``k`` samples do not reach."""
    while len(batches) > 1 and sum(b.shape[-1] for b in batches[1:]) >= k:
        batches.pop(0)


def _window_stream(device, n, batch, window, wrap_cap, over_cap, world, seed):
    """The Criteo stream through the counter windows, two AUROC windows,
    their non-windowed twins and ``world`` replicas of the windows, each
    fed a contiguous share of the batches. The windowed updates run under
    ``torch.cuda.set_sync_debug_mode("error")``: any host synchronization
    in them raises."""
    cuda = torch.device(device).type == "cuda"
    windows = _counter_windows(device, window)
    windows["auroc_wrap"] = WindowedBinaryAUROC(max_num_samples=wrap_cap, device=device)
    windows["auroc_over"] = WindowedBinaryAUROC(max_num_samples=over_cap, device=device)
    twins = {"ne": BinaryNormalizedEntropy(device=device),
             "ne_logits": BinaryNormalizedEntropy(from_logits=True, device=device),
             "ctr": ClickThroughRate(device=device),
             "calibration": WeightedCalibration(device=device),
             "brier": MeanSquaredError(device=device)}
    replicas = []
    for _ in range(world):
        rep = _counter_windows(device, window)
        rep["auroc_wrap"] = WindowedBinaryAUROC(max_num_samples=wrap_cap, device=device)
        replicas.append(rep)
    updates = -(-n // batch)
    owner = [i * world // updates for i in range(updates)]
    counters = torch.zeros((updates, 6), dtype=torch.float64, device=device)
    recent_s, recent_y, replica_tail = [], [], [None] * world
    mine_s, mine_y = [], []  # the current replica's latest samples
    gen = torch.Generator(device=device).manual_seed(seed)
    if cuda:  # the debug mode must catch a readback here, or its silence proves nothing
        torch.cuda.set_sync_debug_mode("error")
        try:
            bool(counters.sum() > 0)
            caught = False
        except RuntimeError:
            caught = True
        finally:
            torch.cuda.set_sync_debug_mode(0)
        _check(caught, "sync debug mode let a readback through")
    _reset_peak(device)
    t0 = time.perf_counter()
    for i, start in enumerate(range(0, n, batch)):
        x, s, y = _click_logits(gen, (min(batch, n - start),), device)
        if cuda:
            torch.cuda.set_sync_debug_mode("error")
        try:
            _window_updates((windows, replicas[owner[i]]), x, s, y)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
        _window_updates((twins,), x, s, y)
        counters[i] = _batch_counters(x, s, y)
        for kept, v in ((recent_s, s), (recent_y, y), (mine_s, s), (mine_y, y)):
            kept.append(v[None])
            _keep_tail(kept, wrap_cap)
        if i + 1 == updates or owner[i + 1] != owner[i]:
            replica_tail[owner[i]] = (_tail(mine_s, wrap_cap), _tail(mine_y, wrap_cap))
            mine_s, mine_y = [], []
    _sync(device)
    seconds = time.perf_counter() - t0
    return {"windows": windows, "twins": twins, "replicas": replicas, "owner": owner,
            "counters": counters, "updates": updates, "seconds": seconds,
            "peak_bytes": _stream_peak(device), "tail": (_tail(recent_s, wrap_cap),
                                                         _tail(recent_y, wrap_cap)),
            "replica_tail": replica_tail}


def _window_checks(st, batch, window, wrap_cap, over_cap):
    """The stream's windowed values against float64 oracles, the rings
    against their batches' counters and the lifetimes against their twins."""
    windows, twins, counters, updates = st["windows"], st["twins"], st["counters"], st["updates"]
    live = counters[max(0, updates - window):updates].sum(0).cpu()
    want = _window_values64(live)
    lifetime_want = _window_values64(counters.sum(0).cpu())
    values, err, lifetime_err, lifetime_bitwise = {}, {}, {}, {}
    for name, _ in _WINDOW_TWINS:
        lifetime, windowed = windows[name].compute()
        values[name] = float(windowed)
        err[name] = _rel_err(windowed, want[name])
        lifetime_err[name] = _rel_err(lifetime, lifetime_want[name])
        twin = twins[name].compute()
        lifetime_bitwise[name] = bool(torch.equal(lifetime.reshape(twin.shape), twin))
        _check(lifetime_bitwise[name], f"lifetime {name} {lifetime} != its twin {twin}")
    ok, ring_rel = _rings_vs_counters(windows, counters, updates, batch)
    _check(ok, f"ring columns past their float32 bound (max relative error {ring_rel})")
    s, y = st["tail"]
    for name, cap in (("auroc_wrap", wrap_cap), ("auroc_over", over_cap)):
        got = windows[name].compute()
        oracle = _exact_oracle(s[:, -cap:], y[:, -cap:])[0][0]
        values[name] = float(got)
        err[name] = _rel_err(got, oracle)
    _check(max(err.values()) <= WINDOW_TOL, f"windowed values off float64 by {err}")
    _check(max(lifetime_err.values()) <= WINDOW_TOL, f"lifetime values off float64 by {lifetime_err}")
    return {"values": values, "value_rel_err_vs_float64": err,
            "lifetime_rel_err_vs_float64": lifetime_err, "lifetime_bitwise_vs_twin": lifetime_bitwise,
            "ring_column_max_rel_err": ring_rel}


def _window_replica_sync(st, device, window, wrap_cap):
    """``sync_and_compute`` over the replicas on a ``LocalReplicaGroup``:
    the values against float64 over the union of the replicas' live
    columns (and live samples), the states bitwise against ``merge_state``
    on the same metrics."""
    replicas, counters, owner = st["replicas"], st["counters"], st["owner"]
    world = len(replicas)
    group = LocalReplicaGroup([torch.device(device)] * world)
    t0 = time.perf_counter()
    values = toolkit.sync_and_compute_collection(replicas, group)
    _sync(device)
    sync_seconds = time.perf_counter() - t0
    synced = toolkit.get_synced_metric_collection(replicas, group)
    live = torch.zeros(6, dtype=torch.float64)
    for r in range(world):
        mine = [i for i, o in enumerate(owner) if o == r][-window:]
        live += counters[mine].sum(0).cpu()
    want = _window_values64(live)
    scores = torch.cat([t[0] for t in st["replica_tail"]], dim=-1)
    labels = torch.cat([t[1] for t in st["replica_tail"]], dim=-1)
    want["auroc_wrap"] = _exact_oracle(scores, labels)[0][0]
    err, states_bitwise = {}, True
    for name, m in synced.items():
        merged = copy.deepcopy(replicas[0][name]).merge_state([rep[name] for rep in replicas[1:]])
        for k, v in merged.state_dict().items():
            states_bitwise &= _same_state(m.state_dict()[k], v)
        value = values[name][1] if isinstance(values[name], tuple) else values[name]
        err[name] = _rel_err(value, want[name])
    _check(states_bitwise, "synced window states != merge_state of the replicas")
    _check(max(err.values()) <= WINDOW_TOL, f"synced windows off float64 by {err}")
    return {"world": world, "value_rel_err_vs_float64": err, "states_bitwise_vs_merge": True,
            "sync_seconds": sync_seconds,
            "merged_columns": synced["ne"].windowed_total_entropy.shape[1],
            "merged_samples": synced["auroc_wrap"].inputs.shape[1]}


def _window_tasks(device, mt_samples, num_tasks, batch, window, cap, seed):
    """The 4-task weighted stream through the NE, CTR and calibration
    windows and a 4-task AUROC window, against float64."""
    windows = _counter_windows(device, window, tasks=num_tasks)
    auroc = WindowedBinaryAUROC(num_tasks=num_tasks, max_num_samples=cap, device=device)
    mt_batch = min(batch, mt_samples)
    om = {k: torch.zeros(num_tasks, dtype=torch.float64, device=device)
          for k in ("ce", "wy", "w", "ws")}
    seen = ([], [], [])  # the latest scores, labels and weights
    gen = torch.Generator(device=device).manual_seed(seed)
    updates = 0
    for _ in range(0, mt_samples, mt_batch):
        _, s, y = _click_logits(gen, (num_tasks, mt_batch), device)
        w = torch.rand((num_tasks, mt_batch), generator=gen, device=device)
        windows["ne"].update(s, y, weight=w)
        windows["ctr"].update(y, w)
        windows["calibration"].update(s, y, w)
        auroc.update(s, y, w)
        updates += 1
        if updates > mt_samples // mt_batch - window:  # the window's batches
            w64 = w.double()
            om["ce"] += (w64 * _ce64(s, y, False)).sum(-1)
            om["wy"] += (w64 * y.double()).sum(-1)
            om["w"] += w64.sum(-1)
            om["ws"] += (w64 * s.double()).sum(-1)
        for kept, v in zip(seen, (s, y, w)):
            kept.append(v)
            _keep_tail(kept, cap)
    om = {k: v.cpu() for k, v in om.items()}
    want = {"ne": om["ce"] / om["w"] / _entropy64(om["wy"], om["w"]),
            "ctr": om["wy"] / om["w"], "calibration": om["ws"] / om["wy"]}
    err = {k: _rel_err(windows[k].compute()[1], v) for k, v in want.items()}
    s, y, w = (_tail(kept, cap) for kept in seen)
    err["auroc"] = _rel_err(auroc.compute(), _weighted_auroc64(s, y, w))
    _check(max(err.values()) <= WINDOW_TOL, f"4-task windows off float64 by {err}")
    return {"num_tasks": num_tasks, "samples_per_task": mt_samples, "updates": updates,
            "auroc_capacity": cap, "value_rel_err_vs_float64": err}


def _update_ms(make, args, device, reps):
    """Median wall ms of ``reps`` updates of a fresh ``make()`` on
    ``args``, each from a drained queue."""
    m, timers = make(), {}
    m.update(*args)  # first call apart
    for _ in range(reps):
        _timed_update(timers, "u", device, lambda: m.update(*args))
    return _median(timers["u"])


def _pipelined_ms(make, args, device, reps):
    """Wall ms an update over ``reps`` back-to-back updates of a fresh
    ``make()`` with one synchronize at the end, as an eval loop enqueues
    them: a readback inside an update stalls the host until the card has
    caught up, which a drained queue would hide."""
    m = make()
    m.update(*args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        m.update(*args)
    _sync(device)
    return (time.perf_counter() - t0) * 1e3 / reps


def _window_timing(device, batch, window, wrap_cap, over_cap, reps, seed):
    """Update wall ms per Criteo batch of each windowed class beside its
    twin, and the device time of a ``WindowedBinaryAUROC`` insert and of
    its compute over ``wrap_cap`` samples."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x, s, y = _click_logits(gen, (batch,), device)
    make = {
        "ne": (lambda: WindowedBinaryNormalizedEntropy(max_num_updates=window, device=device),
               lambda: BinaryNormalizedEntropy(device=device), (s, y)),
        "ne_logits": (lambda: WindowedBinaryNormalizedEntropy(
            from_logits=True, max_num_updates=window, device=device),
            lambda: BinaryNormalizedEntropy(from_logits=True, device=device), (x, y)),
        "ctr": (lambda: WindowedClickThroughRate(max_num_updates=window, device=device),
                lambda: ClickThroughRate(device=device), (y,)),
        "calibration": (lambda: WindowedWeightedCalibration(max_num_updates=window, device=device),
                        lambda: WeightedCalibration(device=device), (s, y)),
        "brier": (lambda: WindowedMeanSquaredError(max_num_updates=window, device=device),
                  lambda: MeanSquaredError(device=device), (s, y)),
        "auroc_wrap": (lambda: WindowedBinaryAUROC(max_num_samples=wrap_cap, device=device),
                       None, (s, y)),
        "auroc_over": (lambda: WindowedBinaryAUROC(max_num_samples=over_cap, device=device),
                       None, (s, y)),
    }
    update_ms = {}
    for name, (windowed, twin, args) in make.items():
        update_ms[name] = {"windowed": _update_ms(windowed, args, device, reps),
                           "twin": None if twin is None else _update_ms(twin, args, device, reps)}
    report = {"update_ms_median": update_ms, "reps": reps}
    if torch.device(device).type == "cuda":
        full = WindowedBinaryAUROC(max_num_samples=wrap_cap, device=device)
        while full.total_samples < wrap_cap:
            full.update(s, y)
        report["auroc_insert"] = _profile(lambda: full.update(s, y), device, reps=10)
        report["auroc_compute"] = _profile(full.compute, device, reps=3)
        report["auroc_compute_samples"] = wrap_cap
    return report


def _debug_tier(device, num_classes, batch, ctr_batch, vocab, tokens, fid_images, reps, seed):
    """Under ``config.debug_validation()`` each ported value check raises
    on a planted bad batch on ``device`` and passes a clean one; under
    ``config.validate_inputs("raise")`` a NaN batch raises. Then the price
    of the readbacks: update wall ms with the knobs off and on, updates
    back to back."""
    gen = torch.Generator(device=device).manual_seed(seed)
    logits, labels = _classify_batch(gen, batch, num_classes, device)
    bad_labels = labels.clone()
    bad_labels[batch // 2] = num_classes
    _, s, y = _click_logits(gen, (ctr_batch,), device)
    bad_s = s.clone()
    bad_s[ctr_batch // 3] = 1.5
    nan_s = s.clone()
    nan_s[ctr_batch // 4] = float("nan")
    ppl_x = torch.randn((1, tokens, vocab), generator=gen, device=device)
    ppl_t = torch.randint(0, vocab, (1, tokens), generator=gen, device=device)
    bad_t = ppl_t.clone()
    bad_t[0, tokens // 2] = vocab
    images = torch.rand((fid_images, 3, 32, 32), generator=gen, device=device)
    bad_images = images.clone()
    bad_images[0, 1, 2, 3] = 1.5
    extractor = FIDInceptionV3(weights=init_inception_params(torch.Generator().manual_seed(seed)))
    cases = {
        "MulticlassAccuracy": (lambda t: MulticlassAccuracy(
            num_classes=num_classes, average="macro", device=device).update(logits, t),
            labels, bad_labels),
        "MulticlassConfusionMatrix": (lambda t: MulticlassConfusionMatrix(
            num_classes, device=device).update(logits, t), labels, bad_labels),
        "HitRate": (lambda t: HitRate(k=10, device=device).update(logits, t), labels, bad_labels),
        "Perplexity": (lambda t: Perplexity(ignore_index=IGNORE, device=device).update(ppl_x, t),
                       ppl_t, bad_t),
        "BinaryNormalizedEntropy": (lambda v: BinaryNormalizedEntropy(device=device).update(v, y),
                                    s, bad_s),
        "FrechetInceptionDistance": (lambda v: FrechetInceptionDistance(
            model=extractor, device=device).update(v, True), images, bad_images),
    }
    raised = {}
    with config.debug_validation():
        for name, (fn, clean, bad) in cases.items():
            fn(clean)
            try:
                fn(bad)
                raised[name] = False
            except ValueError:
                raised[name] = True
    _check(all(raised.values()), f"debug tier did not raise on the card: {raised}")
    with config.validate_inputs("raise"):
        BinaryNormalizedEntropy(device=device).update(s, y)
        WindowedBinaryNormalizedEntropy(device=device).update(s, y)
        for make in (BinaryNormalizedEntropy, WindowedBinaryNormalizedEntropy):
            try:
                make(device=device).update(nan_s, y)
                raised[f"nan_{make.__name__}"] = False
            except ValueError:
                raised[f"nan_{make.__name__}"] = True
    _check(all(raised.values()), f"validate_inputs did not raise on the card: {raised}")
    knobs = {"off": lambda: config.debug_validation(False),
             "debug_validation": config.debug_validation,
             "validate_inputs_raise": lambda: config.validate_inputs("raise")}
    makes = {"MulticlassAccuracy": (lambda: MulticlassAccuracy(
                 num_classes=num_classes, average="macro", device=device), (logits, labels)),
             "BinaryNormalizedEntropy": (lambda: BinaryNormalizedEntropy(device=device), (s, y))}
    # each knob twice, in the order A B C C B A: a drift over the
    # measurement falls on every knob alike
    price = {knob: {name: [] for name in makes} for knob in knobs}
    for knob in list(knobs) + list(knobs)[::-1]:
        with knobs[knob]():
            for name, (make, args) in makes.items():
                price[knob][name].append(_pipelined_ms(make, args, device, reps))
    return {"raised": raised, "update_ms_pipelined": price, "reps": reps,
            "shapes": {"MulticlassAccuracy": [batch, num_classes],
                       "BinaryNormalizedEntropy": [ctr_batch],
                       "Perplexity": [1, tokens, vocab], "FrechetInceptionDistance": [
                           fid_images, 3, 32, 32]}}


def phase_window(device, n=CRITEO_EVAL, batch=CTR_BATCH, window=WINDOW_UPDATES, wrap_cap=1 << 20,
                 over_cap=32768, world=4, mt_samples=1 << 22, num_tasks=4, mt_cap=1 << 18,
                 num_classes=1000, cls_batch=1024, vocab=LLAMA3_VOCAB, tokens=1024,
                 fid_images=2, reps=30, seed=12):
    """The windowed metrics at Criteo 1TB scale (see the module
    docstring), the debug tier on the card and the price of its
    readbacks. K1 counts are zeroed at the start and read at the end:
    none of this launches it."""
    t0 = time.perf_counter()
    _kernels.reset_launch_counts()
    st = _window_stream(device, n, batch, window, wrap_cap, over_cap, world, seed)
    checks = _window_checks(st, batch, window, wrap_cap, over_cap)
    sync = _window_replica_sync(st, device, window, wrap_cap)
    stream_seconds, stream_peak = st["seconds"], st["peak_bytes"]
    del st
    tasks = _window_tasks(device, mt_samples, num_tasks, batch, window, mt_cap, seed + 1)
    timing = _window_timing(device, batch, window, wrap_cap, over_cap, reps, seed + 2)
    debug = _debug_tier(device, num_classes, cls_batch, batch, vocab, tokens, fid_images, reps,
                        seed + 3)
    launches = _kernels.LAUNCHES["fused_auc_hist"]
    _check(launches == 0, f"K1 launched {launches} times in window")
    return {"phase": "window", "device": str(device), "seconds": time.perf_counter() - t0,
            "k1_launches": launches, "samples": n, "batch": batch, "window_updates": window,
            "auroc_capacity": {"wrap": wrap_cap, "over": over_cap},
            "stream_seconds": stream_seconds, "stream_peak_bytes": stream_peak,
            "criteo": checks, "replica_sync": sync, "tasks": tasks, "timing": timing,
            "debug_tier": debug}


# ------------------------------------------------------------ bucket (A3b)

# bench.py's variable_batch schedule (a ragged stream at ImageNet width)
VARIABLE_BATCH = (1024,) * 4 + (1000, 737, 512, 499, 100, 64, 33, 17, 7, 3)
PPL_SEQS = 8  # sequences a variable-length perplexity batch
PPL_MAX_LEN = 1024
PPL_BATCHES = 16
TWIN_SIZES = (4096, 3000, 17, 4096, 1, 2049)


@contextlib.contextmanager
def _no_host_sync(on):
    """Raise on any host synchronization inside (CUDA only)."""
    if on:
        torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        if on:
            torch.cuda.set_sync_debug_mode(0)


def _captures():
    return _fuse.graph_stats()["captures"]


def _same_states(a, b):
    """Every state of metric ``a`` bitwise equal to ``b``'s."""
    sa, sb = a.state_dict(), b.state_dict()
    return all(torch.equal(sa[k], sb[k]) for k in sa)


def _pool_reserved_bytes():
    """Bytes the captured graphs' memory pools hold, from a memory
    snapshot's segments (``None`` where the snapshot names no pool)."""
    if not torch.cuda.is_available():
        return None
    pools = {tuple(h) for h in _fuse.graph_pools()}
    total, named = 0, False
    for seg in torch.cuda.memory_snapshot():
        pid = seg.get("segment_pool_id")
        if pid is None:
            continue
        named = True
        if tuple(pid) in pools:
            total += seg["total_size"]
    return total if named else None


def _panel_timing(make, args, device, reps):
    """One panel update graphed (bucketed) against eager (unbucketed), on
    fresh panels: host ms an update enqueued back to back (no synchronize
    in the loop) and device ms an update (CUDA events)."""
    if torch.device(device).type != "cuda":
        return None
    out = {}
    for name, bucketed in (("eager", False), ("graphed", True), ("eager_again", False)):
        panel = make()
        with config.shape_bucketing(bucketed):
            fn = lambda: toolkit.update_collection(panel, *args)  # noqa: E731
            fn()
            out[name] = {"host_ms": _host_ms(fn, device, reps), "device_ms": _time_ms(fn, device, reps)}
    return out


def _classify_panel(device, num_classes):
    return {
        "acc": MulticlassAccuracy(device=device),
        "acc_macro": MulticlassAccuracy(average="macro", num_classes=num_classes, device=device),
        "precision": MulticlassPrecision(num_classes=num_classes, average="macro", device=device),
        "recall": MulticlassRecall(num_classes=num_classes, average="macro", device=device),
        "f1": MulticlassF1Score(num_classes=num_classes, average="macro", device=device),
        "cm": MulticlassConfusionMatrix(num_classes, device=device),
    }


def _bucket_classify(device, n, num_classes, batch, variable, reps, seed):
    """The ImageNet-1k panel through ``update_collection`` under
    ``config.shape_bucketing()`` (one CUDA-graph replay an update), beside
    the same panel fed the same batches eagerly and unbucketed: the
    validation stream (full batches and its short tail), then the
    ``variable_batch`` schedule shuffled from ``seed`` twice, states
    compared after every update of the schedule, the second pass under
    ``set_sync_debug_mode("error")``."""
    cuda = torch.device(device).type == "cuda"
    graphed, eager = _classify_panel(device, num_classes), _classify_panel(device, num_classes)
    gen = torch.Generator(device=device).manual_seed(seed)
    schedule = [int(v) for v in np.random.default_rng(seed).permutation(variable)]
    timers = {}

    def feed(m, check_sync=False):
        x, y = _classify_batch(gen, m, num_classes, device)
        with config.shape_bucketing(), _no_host_sync(cuda and check_sync):
            if check_sync:
                toolkit.update_collection(graphed, x, y)
            else:
                _timed_update(timers, "graphed", device,
                              lambda: toolkit.update_collection(graphed, x, y))
        _timed_update(timers, "eager", device, lambda: toolkit.update_collection(eager, x, y))
        return all(_same_states(graphed[k], eager[k]) for k in graphed)

    _kernels.reset_launch_counts()
    c0 = _captures()
    for start in range(0, n, batch):
        feed(min(batch, n - start))
    stream_bitwise = all(_same_states(graphed[k], eager[k]) for k in graphed)
    first = [feed(m) for m in schedule]
    captures_first = _captures() - c0
    c1 = _captures()
    second = [feed(m, check_sync=True) for m in schedule]
    captures_second = _captures() - c1
    launches = _kernels.LAUNCHES["fused_auc_hist"]
    # buckets that saw two valid counts, each update of them bitwise right
    by_bucket = {}
    for m, ok in zip(schedule + schedule, first + second):
        by_bucket.setdefault(bucket_length(m), set()).add((m, ok))
    two_counts = {b: sorted(m for m, _ in v) for b, v in by_bucket.items()
                  if len({m for m, _ in v}) >= 2}
    _check(stream_bitwise, "bucketed classify stream differs from the eager stream")
    _check(all(first) and all(second), "a bucketed update differs from its eager twin")
    _check(two_counts, "no bucket was replayed with two valid counts")
    bound = bucket_bound(batch)
    if cuda:
        _check(0 < captures_first <= bound, f"{captures_first} captures for the panel (bound {bound})")
        _check(captures_second == 0, f"the second pass captured {captures_second} graphs")
    else:
        _check(captures_first == captures_second == 0, "a CPU panel captured a graph")
    _check(launches == 0, f"K1 launched {launches} times in the classify panel")
    ragged = next(v for v in variable if v != batch)
    timing = {
        "full_batch": _panel_timing(lambda: _classify_panel(device, num_classes),
                                    _classify_batch(gen, batch, num_classes, device), device, reps),
        "ragged_batch": _panel_timing(lambda: _classify_panel(device, num_classes),
                                      _classify_batch(gen, ragged, num_classes, device),
                                      device, reps),
        "ragged_size": ragged,
    }
    return {"samples": n, "batch": batch, "schedule": schedule, "stream_bitwise": stream_bitwise,
            "schedule_updates_bitwise": all(first) and all(second),
            "buckets_with_two_counts": {str(k): v for k, v in two_counts.items()},
            "captures_first_pass": captures_first, "captures_second_pass": captures_second,
            "capture_bound": bound, "second_pass_sync_checked": cuda, "k1_launches": launches,
            "update_ms_median": {k: _median(v) for k, v in timers.items()}, "timing": timing}


def _bucket_criteo(device, n, batch, row_tasks, seed):
    """The DLRM panel over the Criteo 1TB evaluation stream with its real
    tail: ``BinaryNormalizedEntropy`` and ``StreamingBinaryAUROC`` (K1)
    in one ``update_collection`` (no masked twin: the plain group, eager),
    the calibration row form over ``row_tasks`` ids in another (bucketed:
    one graph replay an update), ``ClickThroughRate`` alone, beside the
    same metrics fed unbucketed."""
    cuda = torch.device(device).type == "cuda"

    def make():
        return ({"ne": BinaryNormalizedEntropy(device=device),
                 "auroc": StreamingBinaryAUROC(num_bins=NUM_BINS, device=device)},
                {"calibration": WeightedCalibration(num_tasks=row_tasks, device=device)},
                ClickThroughRate(device=device))

    (plain_g, rows_g, ctr_g), (plain_e, rows_e, ctr_e) = make(), make()
    o = {k: torch.zeros(row_tasks, dtype=torch.float64, device=device) for k in ("ws", "wy")}
    gen = torch.Generator(device=device).manual_seed(seed)
    _kernels.reset_launch_counts()
    k1, updates, c0, timers = 0, 0, _captures(), {}
    for start in range(0, n, batch):
        m = min(batch, n - start)
        _, s, y = _click_logits(gen, (m,), device)
        w = torch.rand((m,), generator=gen, device=device) + 0.5
        # 1,000 tasks and ids past them, which every update drops
        ids = torch.randint(0, row_tasks + row_tasks // 50, (m,), generator=gen, device=device)
        before = _kernels.LAUNCHES["fused_auc_hist"]
        # odd full batches replay under the sync check; even ones are timed
        checked = cuda and updates % 2 == 1 and m == batch
        with config.shape_bucketing(), _no_host_sync(checked):
            toolkit.update_collection(plain_g, s, y)
            if checked:
                toolkit.update_collection(rows_g, s, y, w, task_ids=ids)
            else:
                _timed_update(timers, "rows_graphed", device,
                              lambda: toolkit.update_collection(rows_g, s, y, w, task_ids=ids))
            ctr_g.update(y)
        k1 += _kernels.LAUNCHES["fused_auc_hist"] - before
        toolkit.update_collection(plain_e, s, y)
        _timed_update(timers, "rows_eager", device,
                      lambda: toolkit.update_collection(rows_e, s, y, w, task_ids=ids))
        ctr_e.update(y)
        keep = ids < row_tasks
        o["ws"].index_add_(0, ids[keep], (w * s)[keep].double())
        o["wy"].index_add_(0, ids[keep], (w * y)[keep].double())
        updates += 1
    captures = _captures() - c0
    counters_bitwise = (all(_same_states(plain_g[k], plain_e[k]) for k in plain_g)
                        and _same_states(ctr_g, ctr_e))
    cal_g, cal_e = rows_g["calibration"], rows_e["calibration"]
    sums = ("weighted_input_sum", "weighted_target_sum")
    ok_g, err_g = _float_bound([getattr(cal_g, k) for k in sums], [o["ws"], o["wy"]], batch, updates)
    ok_e, err_e = _float_bound([getattr(cal_e, k) for k in sums], [o["ws"], o["wy"]], batch, updates)
    rel = max(_rel_err(getattr(cal_g, k), getattr(cal_e, k)) for k in sums)
    _check(counters_bitwise, "NE / AUROC / CTR states differ from the unbucketed run")
    _check(ok_g and ok_e, f"calibration sums past the float32 bound ({err_g}, {err_e})")
    _check(k1 == (updates if cuda else 0), f"K1 launched {k1} times for {updates} panel updates")
    if cuda:
        _check(0 < captures <= 2, f"{captures} captures for the calibration rows (two buckets)")
    return {"samples": n, "batch": batch, "tail": n - (updates - 1) * batch, "updates": updates,
            "row_tasks": row_tasks, "k1_launches": k1, "captures": captures,
            "counters_bitwise": counters_bitwise, "calibration_rel_err_vs_float64": err_g,
            "calibration_rel_err_eager_vs_float64": err_e,
            "calibration_graphed_vs_eager_rel": rel,
            "rows_update_ms_median": {k: _median(v) for k, v in timers.items()}}


def _bucket_perplexity(device, vocab, seqs, max_len, batches, chunk, reps, seed):
    """``Perplexity`` at Llama-3-8B width over variable-length batches of
    ``seqs`` sequences, each padded with ``IGNORE`` to the batch's
    longest (from ``seed``: the batch's longest uniform in [1, max_len],
    the others uniform up to it; the last batch three sequences short):
    both the batch and the sequence axis bucket.
    Held to the float64 oracle within the bound of the ``lm_eval`` phase
    and to the same stream fed eagerly within rtol 1e-6."""
    cuda = torch.device(device).type == "cuda"
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    graphed = Perplexity(ignore_index=IGNORE, device=device)
    eager = Perplexity(ignore_index=IGNORE, device=device)
    nll64, kept, bound, buckets, timers = 0.0, 0, 0.0, set(), {}
    c0 = _captures()
    reserved0 = torch.cuda.memory_reserved(device) if cuda else None
    _reset_peak(device)
    for b in range(batches):
        rows = seqs if b < batches - 1 else max(1, seqs - 3)
        s = int(rng.integers(1, max_len + 1))
        lengths = np.append(s, rng.integers(1, s + 1, rows - 1))
        x = torch.randn((rows, s, vocab), generator=gen, device=device)
        t = torch.full((rows, s), IGNORE, dtype=torch.int64, device=device)
        for i, length in enumerate(lengths.tolist()):
            t[i, :length] = torch.randint(0, vocab, (length,), generator=gen, device=device)
            x[i, torch.arange(length, device=device), t[i, :length]] += PPL_MARGIN
        buckets.add((bucket_length(rows), bucket_length(s)))
        with config.shape_bucketing():
            _timed_update(timers, "graphed", device, lambda: graphed.update(x, t))
        _timed_update(timers, "eager", device, lambda: eager.update(x, t))
        n_, k_, mags = _nll_oracle(x, t, slice(None), chunk)
        nll64 += float(n_)
        kept += k_
        bound += float(_window_bound(mags, n_, k_, vocab, torch.float32))
        del x, t
    peak = _stream_peak(device)
    pool_bytes = _pool_reserved_bytes() if cuda else None
    reserved = torch.cuda.memory_reserved(device) - reserved0 if cuda else None
    captures = _captures() - c0
    bound += batches * _ulp32(torch.tensor(nll64)).item() / 2
    got, got_e = float(graphed.sum_log_probs), float(eager.sum_log_probs)
    _check(int(graphed.num_total) == int(eager.num_total) == kept, "perplexity token counts")
    _check(abs(got - nll64) <= bound, f"graphed NLL {got} vs float64 {nll64}, bound {bound}")
    ppl64, ppl_bound = _ppl_float64(nll64, kept, bound)
    ppl, ppl_e = float(graphed.compute()), float(eager.compute())
    _check(abs(ppl - ppl64) <= ppl_bound, f"graphed perplexity {ppl} vs float64 {ppl64}")
    _check(abs(ppl - ppl_e) <= 1e-6 * abs(ppl_e), f"graphed perplexity {ppl} vs eager {ppl_e}")
    if cuda:
        _check(0 < captures <= len(buckets), f"{captures} captures for {len(buckets)} buckets")
    timing = None
    if cuda:  # one full-length batch, graphed against eager, on fresh metrics
        x = torch.randn((seqs, max_len, vocab), generator=gen, device=device)
        t = torch.randint(0, vocab, (seqs, max_len), generator=gen, device=device)
        timing = {}
        for name, bucketed in (("eager", False), ("graphed", True)):
            m = Perplexity(ignore_index=IGNORE, device=device)
            with config.shape_bucketing(bucketed):
                m.update(x, t)
                timing[name] = {"device_ms": _time_ms(lambda: m.update(x, t), device, reps),
                                "host_ms": _host_ms(lambda: m.update(x, t), device, reps)}
            del m
        del x, t
    return {"batches": batches, "seqs": seqs, "max_len": max_len, "vocab": vocab,
            "targets": kept, "perplexity": ppl, "perplexity_eager": ppl_e,
            "perplexity_float64": ppl64, "rel_err_vs_float64": abs(ppl - ppl64) / ppl64,
            "rel_bound_vs_float64": ppl_bound / ppl64, "rel_err_vs_eager": abs(ppl - ppl_e) / ppl_e,
            "buckets": sorted(buckets), "captures": captures, "stream_peak_bytes": peak,
            "graph_pool_reserved_bytes": pool_bytes, "reserved_growth_bytes": reserved,
            "update_ms_median": {k: _median(v) for k, v in timers.items()},
            "full_batch_timing": timing}


def _bucket_streams(device, num_classes, batch, sizes, seed):
    """Two ``MulticlassAccuracy`` metrics updated on two streams with
    batches of the same buckets: each gets graphs of its own (a graph is
    keyed on its live states), each matches its eager twin bitwise, and a
    ``reset()`` under donation keeps the states, so its graphs replay
    without a new capture."""
    if torch.device(device).type != "cuda":
        return None
    gen = torch.Generator(device=device).manual_seed(seed)
    streams = [torch.cuda.Stream(device), torch.cuda.Stream(device)]
    make = lambda: MulticlassAccuracy(average="macro", num_classes=num_classes,  # noqa: E731
                                      device=device)
    graphed, eager = [make(), make()], [make(), make()]
    c0 = _captures()
    for m in sizes:
        for i, stream in enumerate(streams):
            x, y = _classify_batch(gen, m, num_classes, device)
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream), config.shape_bucketing():
                graphed[i].update(x, y)
            torch.cuda.current_stream(device).wait_stream(stream)
            eager[i].update(x, y)
    torch.cuda.synchronize(device)
    captures = _captures() - c0
    buckets = len({bucket_length(m) for m in sizes})
    own = all(_same_states(g, e) for g, e in zip(graphed, eager))
    apart = not torch.equal(graphed[0].num_correct, graphed[1].num_correct)
    ids = id(graphed[0].num_correct)
    graphed[0].reset()
    eager[0].reset()
    c1 = _captures()
    x, y = _classify_batch(gen, sizes[0], num_classes, device)
    streams[0].wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(streams[0]), config.shape_bucketing():  # the graph's own stream
        graphed[0].update(x, y)
    torch.cuda.current_stream(device).wait_stream(streams[0])
    eager[0].update(x, y)
    after_reset = {"captures": _captures() - c1, "same_tensor": id(graphed[0].num_correct) == ids,
                   "bitwise": _same_states(graphed[0], eager[0])}
    _check(captures == 2 * buckets, f"{captures} captures for two metrics x {buckets} buckets")
    _check(own and apart, "two metrics on two streams shared or crossed their states")
    _check(after_reset["captures"] == 0 and after_reset["same_tensor"] and after_reset["bitwise"],
           f"reset under donation: {after_reset}")
    return {"sizes": list(sizes), "captures": captures, "bitwise_vs_eager": own,
            "after_reset": after_reset}


def _twin_panels(device, num_classes, num_t):
    """Every remaining masked twin, one panel an input kind. The binary
    panel also holds ``BinaryNormalizedEntropy`` (no twin), so one
    ``update_collection`` call forms both groups."""
    return {
        "binary": {
            "accuracy": BinaryAccuracy(device=device),
            "precision": BinaryPrecision(device=device),
            "recall": BinaryRecall(device=device),
            "f1": BinaryF1Score(device=device),
            "confusion_matrix": BinaryConfusionMatrix(device=device),
            "binned_prc": BinaryBinnedPrecisionRecallCurve(threshold=num_t, device=device),
            "ne": BinaryNormalizedEntropy(device=device),
        },
        "multilabel": {
            "accuracy": MultilabelAccuracy(criteria="hamming", device=device),
            "topk_accuracy": TopKMultilabelAccuracy(criteria="overlap", k=3, device=device),
            "binned_vectorized": MultilabelBinnedPrecisionRecallCurve(
                num_labels=num_classes, threshold=num_t, device=device),
            "binned_memory": MultilabelBinnedPrecisionRecallCurve(
                num_labels=num_classes, threshold=num_t, optimization="memory", device=device),
        },
        "multiclass": {
            "binned_vectorized": MulticlassBinnedPrecisionRecallCurve(
                num_classes=num_classes, threshold=num_t, device=device),
            "binned_memory": MulticlassBinnedPrecisionRecallCurve(
                num_classes=num_classes, threshold=num_t, optimization="memory", device=device),
        },
        "regression": {"mse": MeanSquaredError(device=device), "r2": R2Score(device=device)},
        "weighted": {"mse": MeanSquaredError(device=device)},
    }


def _twin_batch(kind, gen, m, num_classes, device):
    if kind == "binary":
        s = torch.rand((m,), generator=gen, device=device)
        return (s, (torch.rand((m,), generator=gen, device=device) < s).to(torch.int64)), {}
    if kind == "multilabel":
        return (torch.rand((m, num_classes), generator=gen, device=device),
                torch.randint(0, 2, (m, num_classes), generator=gen, device=device)), {}
    if kind == "multiclass":
        x, y = _classify_batch(gen, m, num_classes, device)
        return (torch.softmax(x, -1), y), {}
    x = torch.rand((m,), generator=gen, device=device)
    y = torch.rand((m,), generator=gen, device=device)
    if kind == "weighted":
        return (x, y), {"sample_weight": torch.rand((m,), generator=gen, device=device) + 0.5}
    return (x, y), {}


def _bucket_twins(device, sizes, num_classes, num_t, seed):
    """Each remaining masked twin on the card at small shapes: its panel
    bucketed (graphed) against the same panel eager, counters bitwise and
    the regression sums within the float32 bound of float64."""
    graphed, eager = _twin_panels(device, num_classes, num_t), _twin_panels(device, num_classes, num_t)
    gen = torch.Generator(device=device).manual_seed(seed)
    o = {k: torch.zeros((), dtype=torch.float64, device=device)
         for k in ("se", "n", "t2", "t", "wse", "w")}
    c0 = _captures()
    for m in sizes:
        for kind in graphed:
            args, kwargs = _twin_batch(kind, gen, m, num_classes, device)
            with config.shape_bucketing():
                toolkit.update_collection(graphed[kind], *args, **kwargs)
            toolkit.update_collection(eager[kind], *args, **kwargs)
            if kind in ("regression", "weighted"):
                x, y = (a.double() for a in args)
            if kind == "regression":
                o["se"] += ((y - x) ** 2).sum()
                o["n"] += m
                o["t2"] += (y ** 2).sum()
                o["t"] += y.sum()
            elif kind == "weighted":
                w = kwargs["sample_weight"].double()
                o["wse"] += (w * (y - x) ** 2).sum()
                o["w"] += w.sum()
    captures = _captures() - c0
    bitwise = {f"{kind}.{name}": _same_states(graphed[kind][name], eager[kind][name])
               for kind in ("binary", "multilabel", "multiclass") for name in graphed[kind]}
    reg, wreg = graphed["regression"], graphed["weighted"]["mse"]
    b = max(sizes)
    ok, err = _float_bound(
        [reg["mse"].sum_squared_error, reg["mse"].sum_weight, reg["r2"].sum_squared_obs,
         reg["r2"].sum_obs, reg["r2"].sum_squared_residual, reg["r2"].num_obs,
         wreg.sum_squared_error, wreg.sum_weight],
        [o["se"], o["n"], o["t2"], o["t"], o["se"], o["n"], o["wse"], o["w"]], b, len(sizes))
    eok, eerr = _float_bound(
        [eager["regression"]["mse"].sum_squared_error, eager["regression"]["r2"].sum_obs,
         eager["weighted"]["mse"].sum_squared_error],
        [o["se"], o["t"], o["wse"]], b, len(sizes))
    _check(all(bitwise.values()), f"graphed twins differ from eager: {bitwise}")
    _check(ok and eok, f"regression sums past the float32 bound ({err}, {eerr})")
    return {"sizes": list(sizes), "num_classes": num_classes, "thresholds": num_t,
            "captures": captures, "counters_bitwise": bitwise,
            "regression_rel_err_vs_float64": err}


def phase_bucket(device, classify_n=IMAGENET_VAL, num_classes=1000, batch=1024,
                 variable=VARIABLE_BATCH, ctr_n=CRITEO_EVAL, ctr_batch=CTR_BATCH, row_tasks=1000,
                 vocab=LLAMA3_VOCAB, seqs=PPL_SEQS, max_len=PPL_MAX_LEN, ppl_batches=PPL_BATCHES,
                 chunk=1024, twin_sizes=TWIN_SIZES, twin_classes=20, twin_thresholds=100,
                 reps=30, seed=13):
    """Shape bucketing with its mask-aware twins, donated in-place updates
    and bucketed panels as CUDA-graph replays (see the module
    docstring). K1 runs only in the Criteo part, once an update."""
    t0 = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    if cuda:  # the debug mode must catch a readback, or its silence proves nothing
        probe = torch.zeros(1, device=device)
        try:
            with _no_host_sync(True):
                bool(probe.sum() > 0)
            caught = False
        except RuntimeError:
            caught = True
        _check(caught, "sync debug mode let a readback through")
    classify = _bucket_classify(device, classify_n, num_classes, batch, variable, reps, seed)
    criteo = _bucket_criteo(device, ctr_n, ctr_batch, row_tasks, seed + 1)
    ppl = _bucket_perplexity(device, vocab, seqs, max_len, ppl_batches, chunk, max(2, reps // 10),
                             seed + 2)
    twins = _bucket_twins(device, twin_sizes, twin_classes, twin_thresholds, seed + 3)
    streams = _bucket_streams(device, num_classes, batch, (batch, variable[5], variable[-1]),
                              seed + 4)
    return {"phase": "bucket", "device": str(device), "seconds": time.perf_counter() - t0,
            "graph_stats": _fuse.graph_stats(), "classify": classify, "criteo": criteo,
            "perplexity": ppl, "twins": twins, "streams": streams}


# ------------------------------------------------------------- elastic

ELASTIC_WORLD = 4
ELASTIC_INTERVAL = 100
EXACT_PER_RANK = 1 << 22  # the exact AUROC's samples a rank: ~50 MB of buffers
SYNC_DEADLINE = 2.0  # ResilientGroup(timeout=...) of the elastic phase, seconds
MP_WORLD = 2
_STREAMING = ("auroc", "auprc")  # K1 once each an update


def _elastic_panel(device, num_bins=NUM_BINS):
    """The DLRM eval panel of the elastic phase, plus an exact AUROC whose
    buffers give a snapshot real bytes."""
    return {
        "ne": BinaryNormalizedEntropy(device=device),
        "ctr": ClickThroughRate(device=device),
        "calibration": WeightedCalibration(device=device),
        "auroc": StreamingBinaryAUROC(num_bins=num_bins, device=device),
        "auprc": StreamingBinaryAUPRC(num_bins=num_bins, device=device),
        "exact": BinaryAUROC(device=device),
    }


def _elastic_batch(device, seed, index, n, batch):
    """Batch ``index`` of the Criteo stream, drawn from a seed of its own
    so any rank (or thread) can draw any batch."""
    gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + index)
    return _clicks(gen, (min(batch, n - index * batch),), device)


def _elastic_feed(panel, s, y, exact):
    toolkit.update_collection({k: panel[k] for k in ("ne", "calibration") + _STREAMING}, s, y)
    toolkit.update_collection({"ctr": panel["ctr"]}, y)
    if exact:
        panel["exact"].update(s, y)


def _clone_panel(panel):
    return {k: toolkit.clone_metric(m) for k, m in panel.items()}


def _merged(panels):
    """``panels[0]`` merged with the rest in order, as a rank-ordered sync
    folds them (into clones)."""
    out = _clone_panel(panels[0])
    for k, m in out.items():
        m.merge_state([p[k] for p in panels[1:]])
    return out


def _same_panel(a, b):
    """Every metric's logical state (``_sync_state_dict``: a buffer's valid
    prefix, whatever its capacity) bitwise equal between two panels."""
    for k in b:
        sa, sb = a[k]._sync_state_dict(), b[k]._sync_state_dict()
        if sa.keys() != sb.keys() or not all(_same_state(sa[n], sb[n]) for n in sb):
            return False
    return True


class _CountingGroup(ProcessGroup):
    """Counts the gathers issued through it, forwarding each to ``inner``."""

    def __init__(self, inner):
        self._inner, self.object_gathers, self.array_gathers = inner, 0, 0

    world_size = property(lambda self: self._inner.world_size)
    rank = property(lambda self: self._inner.rank)
    ranks = property(lambda self: self._inner.ranks)

    def new_subgroup(self, ranks):
        return self._inner.new_subgroup(ranks)

    def allgather_object(self, obj):
        self.object_gathers += 1
        return self._inner.allgather_object(obj)

    def allgather_array(self, x):
        self.array_gathers += 1
        return self._inner.allgather_array(x)


def _shard_bytes(directory, generation):
    gen_dir = os.path.join(directory, f"gen-{generation:08d}")
    return sorted(os.path.getsize(os.path.join(gen_dir, f)) for f in os.listdir(gen_dir)
                  if f.startswith("shard-"))


def _device_state_bytes(panel):
    """Bytes of one ``state_dict()`` clone of the panel on the card: what
    a snapshot holds there until its host copy is done."""
    return sum(v.numel() * v.element_size() for m in panel.values()
               for v in m.state_dict().values()
               if isinstance(v, torch.Tensor) and v.device.type == "cuda")


def _resilience_checks(g, panel, old, deadline):
    """One rank of the resilience sub-phase over restored world-4 state:
    returns its records. ``old`` holds every rank's state for the oracles."""
    out = {}
    bare, wrapped = _CountingGroup(g), _CountingGroup(g)
    rg = ResilientGroup(wrapped, timeout=deadline, policy="quorum")
    secs = {"bare": [], "resilient": []}
    got = {}
    for name, group in (("bare", bare), ("resilient", rg)) * 3:
        t0 = time.perf_counter()
        got[name] = toolkit.get_synced_metric_collection(panel, group)
        secs[name].append(time.perf_counter() - t0)
    out["happy_bitwise"] = _same_panel(got["resilient"], got["bare"]) and _same_panel(
        got["bare"], _merged(old))
    out["gathers"] = {"bare": [bare.object_gathers, bare.array_gathers],
                      "resilient": [wrapped.object_gathers, wrapped.array_gathers]}
    out["sync_seconds"] = {k: _median(v) for k, v in secs.items()}
    out["happy_provenance"] = list(got["resilient"]["ne"].sync_provenance.ranks)

    dead = FaultInjectionGroup(g, dead_ranks={3})
    if g.rank == 3:  # the dying rank still joins the exchanges it sends into
        toolkit.get_synced_metric_collection(panel, g)
    else:
        rg = ResilientGroup(dead, timeout=deadline, policy="quorum", quorum=0.75)
        t0 = time.perf_counter()
        synced = toolkit.get_synced_metric_collection(panel, rg)
        out["dead_seconds"] = time.perf_counter() - t0
        prov = synced["ne"].sync_provenance
        out["dead_provenance"] = [list(prov.ranks), prov.world_size, prov.degraded]
        out["dead_bitwise"] = _same_panel(synced, _merged(old[:3]))
        out["dead_health"] = rg.health.as_dict()
    if g.rank == 3:
        g.allgather_object(None)  # its metadata, then it is gone
    else:
        rg = ResilientGroup(FaultInjectionGroup(g, dead_ranks={3}), timeout=deadline,
                            retries=0, policy="raise")
        t0 = time.perf_counter()
        try:
            toolkit.get_synced_metric_collection(panel, rg)
            out["raise_error"] = None
        except SyncTimeoutError as e:
            out["raise_error"] = type(e).__name__
        out["raise_seconds"] = time.perf_counter() - t0

    chaos = FaultInjectionGroup(g, [FaultSpec(call=1, kind="corrupt", rank=1)], seed=g.rank)
    rg = ResilientGroup(chaos, timeout=deadline, policy="quorum", quorum=0.75)
    synced = toolkit.get_synced_metric_collection(panel, rg)
    out["corrupt_provenance"] = list(synced["ne"].sync_provenance.ranks)
    out["corrupt_counted"] = rg.health.corrupt_payloads
    out["corrupt_bitwise"] = _same_panel(synced, _merged([old[0], old[2], old[3]]))

    if g.rank == 3:
        for _ in range(2):
            toolkit.get_synced_metric_collection(panel, g)
    else:
        rg = ResilientGroup(FaultInjectionGroup(g, dead_ranks={3}), timeout=deadline,
                            policy="quorum", quorum=0.75, reform_after=2)
        provs = []
        for _ in range(3):
            synced = toolkit.get_synced_metric_collection(panel, rg)
            p = synced["ne"].sync_provenance
            provs.append([list(p.ranks), p.world_size, p.degraded, p.reformed])
        out["reform_provenance"] = provs
        out["reform_bitwise"] = _same_panel(synced, _merged(old[:3]))
        out["reforms"] = rg.health.reforms
    return out


def _elastic_timing(device, seed, n, batch, steps, interval, exact_steps, directory):
    """Drained-queue wall ms per batch of the panel with no session, a
    synchronous writer and the async writer (world of one), the snapshot
    steps' ms, the async drain, the shard bytes and the clone's device
    bytes."""
    out = {}
    for mode in ("none", "sync", "async"):
        panel = _elastic_panel(device)
        d = os.path.join(directory, f"timing-{mode}")
        session = (None if mode == "none" else
                   ElasticSession(panel, d, interval=interval, async_writer=mode == "async"))
        ms, snap_ms = [], []
        for step in range(steps):
            s, y = _elastic_batch(device, seed, step, n, batch)
            _sync(device)
            t0 = time.perf_counter()
            _elastic_feed(panel, s, y, step < exact_steps)
            if session is not None:
                session.step_done(step)
            _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
            if session is not None and (step + 1) % interval == 0:
                snap_ms.append(ms[-1])
        row = {"ms_per_batch_median": _median(ms), "ms_per_batch_mean": sum(ms) / len(ms),
               "batches": steps}
        if session is not None:
            t0 = time.perf_counter()
            session.close()
            row["close_ms"] = (time.perf_counter() - t0) * 1e3
            row["snapshot_step_ms"] = snap_ms
            row["shard_bytes"] = _shard_bytes(d, session.snapshots_written - 1)
        out[mode] = row
    out["clone_device_bytes"] = _device_state_bytes(panel)
    return out


def _elastic_worker(config_json):
    """One process of the elastic phase's launcher step, started by
    ``launcher.launch`` as ``chip_smoke.py --elastic-worker <json>``:
    first launch (world 2), its contiguous share of a short stream under
    ``ElasticSession(async_writer=True)`` on ``MultiHostGroup`` (the
    dedicated snapshot communicator), then a sync through
    ``ResilientGroup`` with rank 1 a slow peer; relaunch (world 1),
    restore and read the restored panel. Writes its result with
    ``torch.save``."""
    cfg = json.loads(config_json)
    rank = launcher.init_from_env(timeout=120.0)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    try:
        group = MultiHostGroup()
        panel = _elastic_panel(device)
        session = ElasticSession(panel, cfg["dir"], process_group=group,
                                 interval=cfg["interval"], async_writer=True)
        restored = session.restore()
        _kernels.reset_launch_counts()
        fed = 0
        if restored is None:
            mine = _assign_shards(cfg["batches"], group.world_size)[group.rank]
            for step, index in enumerate(mine):
                s, y = _elastic_batch(device, cfg["seed"], index, cfg["n"], cfg["batch"])
                _elastic_feed(panel, s, y, step < cfg["exact_steps"])
                session.step_done(step)
                fed += 1
        session.close()
        result = {"restored": None if restored is None else list(restored.assigned_ranks),
                  "restored_step": None if restored is None else restored.step,
                  "fed": fed, "launches": _kernels.LAUNCHES["fused_auc_hist"],
                  "dedicated_comm": session._comm is not group}
        if group.world_size > 1:
            inner = group if rank == 0 else FaultInjectionGroup(
                group, [FaultSpec(call=0, kind="delay", seconds=cfg["slow_seconds"])])
            rg = ResilientGroup(inner, timeout=cfg["slow_deadline"] if rank else 60.0,
                                retries=2, policy="raise", backoff_base=0.05)
            t0 = time.perf_counter()
            synced = toolkit.get_synced_metric_collection(panel, rg)
            result["sync_seconds"] = time.perf_counter() - t0
            result["timeouts"] = rg.health.timeouts
            result["calls"] = inner.calls if rank else None
        else:
            synced = panel
        result["states"] = _cpu_states({k: m.state_dict() for k, m in synced.items()})
        result["values"] = {k: _cpu_value(m.compute()) for k, m in synced.items()}
        torch.save(result, os.path.join(cfg["dir"], f"{cfg['tag']}-rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _elastic_processes(device, seed, n, batch, steps, interval, exact_steps, timeout):
    """Two gloo workers through ``launcher.launch``, then a relaunch at
    world 1 that restores their last committed generation."""
    nb = MP_WORLD * steps
    with tempfile.TemporaryDirectory() as d:
        cfg = {"dir": d, "seed": seed, "n": min(n, nb * batch), "batch": batch,
               "batches": nb, "interval": interval, "exact_steps": exact_steps,
               "slow_seconds": 0.5, "slow_deadline": 0.25}
        t0 = time.perf_counter()
        launcher.launch(os.path.abspath(__file__),
                        ["--elastic-worker", json.dumps(dict(cfg, tag="first"))],
                        nproc=MP_WORLD, timeout=timeout)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        launcher.launch(os.path.abspath(__file__),
                        ["--elastic-worker", json.dumps(dict(cfg, tag="again"))],
                        nproc=1, timeout=timeout)
        again_s = time.perf_counter() - t0
        first = [torch.load(os.path.join(d, f"first-rank{r}.pt"), weights_only=False)
                 for r in range(MP_WORLD)]
        again = torch.load(os.path.join(d, "again-rank0.pt"), weights_only=False)
    for r, got in enumerate(first):
        _check(got["restored"] is None and got["fed"] == steps, f"worker {r} did not run fresh")
        _check(got["dedicated_comm"], f"worker {r}: the async writer shares the sync group")
        _check(got["launches"] == len(_STREAMING) * steps, f"worker {r}: K1 launched {got['launches']}")
        for k in got["values"]:
            _check(_same_state(got["values"][k], first[0]["values"][k]), f"workers disagree on {k}")
    _check(first[1]["timeouts"] >= 1 and first[1]["calls"] == 2,
           f"slow peer: {first[1]['timeouts']} timeouts, {first[1]['calls']} gathers")
    _check(again["restored"] == list(range(MP_WORLD)) and again["restored_step"] == steps,
           f"relaunch restored {again['restored']} at {again['restored_step']}")
    for k, v in first[0]["values"].items():
        _check(_same_state(again["values"][k], v), f"relaunch {k} != the 2-process merge")
        for name, state in first[0]["states"][k].items():
            _check(_same_state(again["states"][k][name], state),
                   f"relaunch state {k}.{name} != the 2-process merge")
    return {"world": MP_WORLD, "steps_a_worker": steps, "interval": interval,
            "launch_seconds": first_s, "relaunch_seconds": again_s,
            "sync_seconds": [got["sync_seconds"] for got in first],
            "slow_peer_timeouts": first[1]["timeouts"], "bitwise": sorted(first[0]["values"])}


def _elastic_bucket(device, directory, n, num_classes, batch, variable, seed):
    """The ImageNet-1k panel of the bucket phase under shape bucketing:
    snapshot, one more batch, restore into the same metric objects (the
    batch is undone), then the rest of the stream and the variable
    schedule, states bitwise equal to the eager panel after every update."""
    cuda = torch.device(device).type == "cuda"
    graphed, eager = _classify_panel(device, num_classes), _classify_panel(device, num_classes)
    gen = torch.Generator(device=device).manual_seed(seed)

    def feed(panels, m):
        x, y = _classify_batch(gen, m, num_classes, device)
        with config.shape_bucketing():
            toolkit.update_collection(graphed, x, y)
        if "eager" in panels:
            toolkit.update_collection(eager, x, y)
        return _same_panel(graphed, eager)

    sizes = [min(batch, n - start) for start in range(0, n, batch)]
    half = len(sizes) // 2
    ok = [feed(("eager",), m) for m in sizes[:half]]
    session = ElasticSession(graphed, directory, interval=10**9)
    session.snapshot()
    session.close()
    feed((), batch)  # into the graphed panel only: the restore must undo it
    c0 = _captures()
    session = ElasticSession(graphed, directory)
    restored = session.restore()
    session.close()
    restored_bitwise = _same_panel(graphed, eager)
    schedule = [int(v) for v in np.random.default_rng(seed).permutation(variable)]
    ok += [feed(("eager",), m) for m in sizes[half:] + schedule]
    captures = _captures() - c0
    bound = bucket_bound(batch)
    _check(restored is not None and restored_bitwise, "the restore did not give back the snapshot")
    _check(all(ok), "a bucketed update after the restore differs from its eager twin")
    if cuda:
        _check(0 < captures <= bound, f"{captures} captures after the restore (bound {bound})")
    return {"samples": n, "restored_at_batch": half, "updates_bitwise": len(ok),
            "captures_after_restore": captures, "capture_bound": bound}


def phase_elastic(device, n=CRITEO_EVAL, batch=CTR_BATCH, num_bins=NUM_BINS, world=ELASTIC_WORLD,
                  interval=ELASTIC_INTERVAL, exact_per_rank=EXACT_PER_RANK, crash_timeout=10.0,
                  deadline=SYNC_DEADLINE, timing_steps=100, timing_interval=25, mp_steps=32,
                  mp_interval=8, mp_timeout=300, classify_n=IMAGENET_VAL // 2, num_classes=1000,
                  cls_batch=1024, variable=VARIABLE_BATCH, seed=14):
    """Fault-tolerant sync and elastic snapshot/resume over the Criteo
    stream (see the module docstring)."""
    t0 = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    batches = -(-n // batch)
    shards = _assign_shards(batches, world)  # contiguous batch ranges a rank
    steps = max(len(sh) for sh in shards)
    exact_steps = exact_per_rank // batch
    restore_step = 2 * interval  # generation 1 commits at step 2 * interval
    _check(3 * interval <= min(len(sh) for sh in shards), "the stream is too short for 3 snapshots")

    def batch_of(index):
        return _elastic_batch(device, seed, index, n, batch)

    def run_steps(panel, session, rank_batches, start):
        """Steps ``start..steps`` of the given old ranks' batches, each
        step feeding them in old-rank order; returns batches fed."""
        fed = 0
        for step in range(start, steps):
            if not session.fence(step):
                continue
            for sh in rank_batches:
                if step < len(sh):
                    _elastic_feed(panel, *batch_of(sh[step]), step < exact_steps)
                    fed += 1
            session.step_done(step)
        return fed

    out = {"phase": "elastic", "device": str(device), "samples": n, "batch": batch,
           "world": world, "interval": interval, "exact_samples_a_rank": exact_steps * batch}
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "bundle")
        # 1. world 4; rank 1 dies in the middle of its shard of generation 2
        plan = SnapshotCrashPlan("mid-shard", at_snapshot=2, rank=1)
        fed = [0] * world
        _kernels.reset_launch_counts()

        def body_crash(g):
            panel = _elastic_panel(device, num_bins)
            session = ElasticSession(panel, d, process_group=g, interval=interval, fault_hook=plan)
            try:
                for step, index in enumerate(shards[g.rank]):
                    _elastic_feed(panel, *batch_of(index), step < exact_steps)
                    fed[g.rank] += 1
                    session.step_done(step, payload={"next_batch": index + 1})
            except InjectedCrash:
                return "crash"
            except TimeoutError:  # its peers, blocked in the digest gather
                return "timeout"
            return "done"

        # the rank threads by hand: ThreadWorld.run would bound the whole
        # run by the gathers' deadline, which here must stay short
        t1 = time.perf_counter()
        views = ThreadWorld(world, timeout=crash_timeout).views
        ends = [None] * world
        threads = [threading.Thread(target=lambda r=r: ends.__setitem__(r, body_crash(views[r])))
                   for r in range(world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        out["crash_run_seconds"] = time.perf_counter() - t1
        launches_before = _kernels.LAUNCHES["fused_auc_hist"]
        _check(plan.crashed and ends == ["timeout", "crash"] + ["timeout"] * (world - 2),
               f"crash run ended {ends}")
        _check(all(f == 3 * interval for f in fed), f"batches fed before the crash: {fed}")

        # the in-memory oracle: every old rank's panel at the restored step,
        # then the world-2 continuation in the restore's merge order, and
        # float64 sums of the whole stream
        ref = torch.zeros((1, 2, num_bins), dtype=torch.float64, device=device)
        o = {k: torch.zeros((), dtype=torch.float64, device=device) for k in ("ce", "pos", "s")}
        exact_s, exact_y = [], []

        def oracle_feed(panel, index, exact):
            s, y = batch_of(index)
            _elastic_feed(panel, s, y, exact)
            ref.add_(_oracle_hist(s[None], y[None], None, num_bins))
            o["ce"] += _ce64(s, y, False).sum()
            o["pos"] += y.double().sum()
            o["s"] += s.double().sum()
            if exact:
                exact_s.append(s)
                exact_y.append(y)

        old = []
        for r in range(world):
            panel = _elastic_panel(device, num_bins)
            for step in range(restore_step):
                oracle_feed(panel, shards[r][step], step < exact_steps)
            old.append(panel)
        assign2 = _assign_shards(world, 2)
        new = []
        for ranks in assign2:
            panel = _merged([old[r] for r in ranks])
            for step in range(restore_step, steps):
                for r in ranks:
                    if step < len(shards[r]):
                        oracle_feed(panel, shards[r][step], step < exact_steps)
            new.append(panel)
        final = _merged(new)

        # 2. restore at world 4 (the same world), then the resilience checks
        def body_same(g):
            panel = _elastic_panel(device, num_bins)
            session = ElasticSession(panel, d, process_group=g, interval=interval)
            t = time.perf_counter()
            restored = session.restore()
            seconds = time.perf_counter() - t
            same = _same_panel(panel, old[g.rank])
            checks = _resilience_checks(g, panel, old, deadline)
            session.close()
            return restored, seconds, same, checks

        res4 = ThreadWorld(world).run(body_same)
        for r, (restored, _, same, _) in enumerate(res4):
            _check(restored.generation == 1 and restored.step == restore_step
                   and restored.assigned_ranks == (r,) and same,
                   f"rank {r}: world-{world} restore {restored}, bitwise {same}")
            _check(restored.payload == {"next_batch": shards[r][restore_step - 1] + 1},
                   f"rank {r}: payload {restored.payload}")
        rec = [c for _, _, _, c in res4]
        for r, c in enumerate(rec):
            _check(c["happy_bitwise"], f"rank {r}: resilient sync != bare sync != merge")
            _check(c["gathers"]["bare"] == c["gathers"]["resilient"],
                   f"rank {r}: collective counts {c['gathers']}")
            _check(c["corrupt_provenance"] == [0, 2, 3] and c["corrupt_bitwise"],
                   f"rank {r}: corrupt payload kept ranks {c['corrupt_provenance']}")
            _check(c["corrupt_counted"] == 1, f"rank {r}: corrupt payloads counted {c['corrupt_counted']}")
            if r == world - 1:
                continue
            _check(c["dead_provenance"] == [[0, 1, 2], world, True] and c["dead_bitwise"],
                   f"rank {r}: dead-rank quorum {c['dead_provenance']}")
            _check(c["dead_seconds"] <= deadline + 1.0, f"rank {r}: dead-rank sync took {c['dead_seconds']}")
            _check(c["raise_error"] == "SyncTimeoutError" and c["raise_seconds"] <= deadline + 1.0,
                   f"rank {r}: raise policy {c['raise_error']} after {c['raise_seconds']} s")
            p = c["reform_provenance"]
            _check(p[0][2] and not p[0][3] and p[1][3] and p[2] == [[0, 1, 2], 3, False, True]
                   and c["reforms"] == 1 and c["reform_bitwise"], f"rank {r}: re-formation {p}")
        out["resilience"] = {
            "sync_seconds": {k: [c["sync_seconds"][k] for c in rec] for k in ("bare", "resilient")},
            "gathers": rec[0]["gathers"], "dead_rank_seconds": [c["dead_seconds"] for c in rec[:3]],
            "raise_seconds": [c["raise_seconds"] for c in rec[:3]],
            "deadline": deadline, "quorum": 0.75,
            "dead_provenance": rec[0]["dead_provenance"],
            "corrupt_provenance": rec[0]["corrupt_provenance"],
            "reform_provenance": rec[0]["reform_provenance"],
            "dead_health": rec[0]["dead_health"],
        }
        out["restore_seconds_same_world"] = max(s for _, s, _, _ in res4)

        # 3. restore at world 2, fence, finish; then fall back past a
        # corrupt newest shard and finish again
        _kernels.reset_launch_counts()

        def body_small(g):
            panel = _elastic_panel(device, num_bins)
            session = ElasticSession(panel, d, process_group=g, interval=interval)
            t = time.perf_counter()
            restored = session.restore()  # warns on a skipped generation
            seconds = time.perf_counter() - t
            fed = run_steps(panel, session, [shards[r] for r in restored.assigned_ranks],
                            restored.step)
            session.close()
            synced = toolkit.get_synced_metric_collection(panel, g)
            return restored, seconds, fed, synced

        def committed():
            return sorted(int(x[4:]) for x in os.listdir(d) if x.startswith("gen-")
                          and os.path.exists(os.path.join(d, x, "MANIFEST.json")))

        results = []
        for attempt in ("restore", "fallback"):
            if attempt == "fallback":
                newest = committed()[-1]
                corrupt_shard(d, newest, rank=0, seed=seed)
            got = ThreadWorld(2).run(body_small)
            for j, (restored, _, _, synced) in enumerate(got):
                _check(restored.generation == 1 and restored.world_size == world
                       and restored.step == restore_step
                       and restored.assigned_ranks == assign2[j],
                       f"{attempt}: rank {j} restored {restored}")
                _check(_same_panel(synced, final), f"{attempt}: rank {j} synced panel != oracle")
            if attempt == "fallback":  # the corrupt generation was quarantined
                _check(newest not in committed(), f"generation {newest} left after the fallback")
            results.append(got)
        launches_after = _kernels.LAUNCHES["fused_auc_hist"]
        fed_after = sum(f for got in results for _, _, f, _ in got)
        out["restore_seconds_4_to_2"] = max(s for _, s, _, _ in results[0])
        out["restore_seconds_fallback"] = max(s for _, s, _, _ in results[1])
        if cuda:
            _check(launches_before == len(_STREAMING) * sum(fed),
                   f"K1 launched {launches_before} times before the restore")
            _check(launches_after == len(_STREAMING) * fed_after,
                   f"K1 launched {launches_after} times after it, {fed_after} batches")
        out["k1_launches"] = {"before_restore": launches_before, "after_restore": launches_after,
                              "streaming_updates": [len(_STREAMING) * sum(fed),
                                                    len(_STREAMING) * fed_after]}

        # the whole-stream float64 oracle
        synced = results[0][0][3]
        n64 = torch.tensor(float(n), dtype=torch.float64, device=device)
        es, ey = torch.cat(exact_s), torch.cat(exact_y)
        want = {"ne": o["ce"] / n64 / _entropy64(o["pos"], n64), "ctr": o["pos"] / n64,
                "calibration": o["s"] / o["pos"], "auroc": _auc64(ref)[0],
                "auprc": _auprc64(ref)[0], "exact": _exact_oracle(es[None], ey[None])[0][0]}
        _check(torch.equal(synced["auroc"].hist.double(), ref), "streaming histogram != float64")
        errs = {k: _rel_err(synced[k].compute().reshape(-1)[0], v) for k, v in want.items()}
        _check(max(errs.values()) <= CURVE_TOL, f"elastic values off float64: {errs}")
        out["values"] = {k: float(synced[k].compute().reshape(-1)[0]) for k in want}
        out["rel_err_vs_float64"] = errs
        out["shard_bytes"] = _shard_bytes(d, 1)

        # 4. timing, the launcher, the bucketed panel
        out["timing"] = _elastic_timing(device, seed, n, batch, timing_steps, timing_interval,
                                        exact_steps, tmp)
        if mp_steps:
            out["processes"] = _elastic_processes(device, seed, n, batch, mp_steps, mp_interval,
                                                  min(exact_steps, mp_steps), mp_timeout)
        out["bucket"] = _elastic_bucket(device, os.path.join(tmp, "bucket"), classify_n,
                                        num_classes, cls_batch, variable, seed + 1)
    out["seconds"] = time.perf_counter() - t0
    return out


OBS_BATCHES = 300  # Criteo batches of the DLRM panel a timing mode
OBS_WATCHDOG = 0.5  # the phase's stall-watchdog deadline, seconds
OBS_SLOW_PEER = 1.5  # the slow peer's injected delay, seconds (>> the deadline)
OBS_RANK_BATCHES = 64  # Criteo batches a rank of the four-rank sync: 2^22 samples


@contextlib.contextmanager
def _sync_warnings(cuda, counts, key):
    """Count the host synchronizations ``torch.cuda.set_sync_debug_mode
    ("warn")`` reports inside (CUDA only) into ``counts[key]``."""
    if not cuda:
        yield
        return
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)
    hits = [w for w in caught if "synchroniz" in str(w.message)]
    counts[key] = counts.get(key, 0) + len(hits)
    where = counts.setdefault("where", {})
    for w in hits:
        site = f"{os.path.basename(w.filename)}:{w.lineno}"
        where[site] = where.get(site, 0) + 1


def _new_events(rec, total_before):
    """The events recorded since the log's ``total`` read ``total_before``
    (``tail(0)`` would be every retained event)."""
    new = rec.log.total - total_before
    return rec.log.tail(new) if new > 0 else []


def _obs_panel(device, num_bins):
    """The DLRM eval panel (``_elastic_panel`` without its exact AUROC)."""
    panel = _elastic_panel(device, num_bins)
    del panel["exact"]
    return panel


def _flat_states(panel):
    """Every state of a panel, cloned (``state_dict``), in a fixed order."""
    return [v for k in sorted(panel) for _, v in sorted(panel[k].state_dict().items())]


def _obs_stream(device, seed, n, batch, batches, num_bins, syncs, mode, oracle=None):
    """The DLRM panel over ``batches`` Criteo batches, each update timed
    from a drained queue. Without ``oracle`` every update's states are kept
    (the recorder-off reference); with one, every update must equal it
    bitwise. Returns (ms a batch, states or None, K1 launches)."""
    cuda = torch.device(device).type == "cuda"
    panel = _obs_panel(device, num_bins)
    ms, kept = [], []
    before = _kernels.LAUNCHES["fused_auc_hist"]
    for i in range(batches):
        s, y = _elastic_batch(device, seed, i, n, batch)
        _sync(device)
        t0 = time.perf_counter()
        with _sync_warnings(cuda, syncs, mode):
            _elastic_feed(panel, s, y, False)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        states = _flat_states(panel)
        if oracle is None:
            kept.append(states)
        else:
            _check(all(torch.equal(a, b) for a, b in zip(states, oracle[i])),
                   f"{mode}: the panel after update {i} differs from the recorder-off stream")
    launches = _kernels.LAUNCHES["fused_auc_hist"] - before
    if cuda:
        _check(launches == len(_STREAMING) * batches,
               f"{mode}: K1 launched {launches} times for {batches} batches")
    return ms, (kept if oracle is None else None), launches


def _update_host_us(device, seed, batch, reps):
    """Host microseconds of one ``StreamingBinaryAUROC.update`` call (no
    synchronize around it), median over ``reps`` calls, recorder off and
    on, interleaved."""
    s, y = _elastic_batch(device, seed, 0, batch, batch)
    metric = StreamingBinaryAUROC(num_bins=NUM_BINS, device=device)
    times = {"off": [], "on": []}
    for i in range(reps):
        for mode in ("off", "on"):
            with config.observability(mode == "on"):
                t0 = time.perf_counter()
                metric.update(s, y)
                times[mode].append((time.perf_counter() - t0) * 1e6)
        if i % 16 == 15:
            _sync(device)
    _sync(device)
    return {k: _median(v) for k, v in times.items()}


def _prometheus_families(text):
    """{family: type} of a text exposition; every sample line must parse."""
    families = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            families[name] = kind
        elif line:
            _check(re.match(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? \S+$", line) is not None,
                   f"unparseable exposition line {line!r}")
            float(line.rsplit(" ", 1)[1])
    return families


def _http_get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:  # /healthz answers 503 when unhealthy
        return e.code, e.read().decode()


def _obs_ranks(device, seed, n, batch, rank_batches, num_bins, world, calls):
    """Four rank threads, each with its DLRM panel and an exact
    ``BinaryAUROC`` over its samples, synced flat and through
    ``ResilientGroup(HierarchicalGroup(group_size=2))``."""

    def body(g):
        panel, exact = _obs_panel(device, num_bins), BinaryAUROC(device=device)
        for i in range(rank_batches):
            s, y = _elastic_batch(device, seed, g.rank * rank_batches + i, n, batch)
            _elastic_feed(panel, s, y, False)
            exact.update(s, y)
        calls[g.rank] = 2 * rank_batches
        coll = dict(panel, exact=exact)
        t0 = time.perf_counter()
        flat = toolkit.get_synced_metric_collection(coll, ResilientGroup(g, timeout=120.0))
        flat_s = time.perf_counter() - t0
        hg = HierarchicalGroup(g, group_size=2)
        t0 = time.perf_counter()
        hier = toolkit.get_synced_metric_collection(coll, ResilientGroup(hg, timeout=120.0))
        hier_s = time.perf_counter() - t0
        merged = obs.gather_observability(g)
        return (_same_panel(hier, flat), hg.node_collectives, hg.leader_collectives,
                merged["ranks"], sorted(merged["per_rank"]), flat_s, hier_s)

    return ThreadWorld(world, timeout=120.0).run(body)


def _obs_slow_peer(world, wd):
    """One rank's third collective delayed past the watchdog deadline;
    returns the ranks' results and the watchdog's FIRST trip (when the
    slow rank resumes, its peers' next collective may still be older than
    the deadline and trip it again, replacing ``last_trip``)."""

    def body(g):
        faults = [FaultSpec(2, "delay", seconds=OBS_SLOW_PEER)] if g.rank == 2 else []
        rg = ResilientGroup(FaultInjectionGroup(g, faults), timeout=30.0, policy="quorum")
        for i in range(4):
            rg.allgather_object({"rank": g.rank, "i": i})
        return True

    box = {}

    def run():
        try:
            box["out"] = ThreadWorld(world, timeout=30.0).run(body)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["error"] = e

    trips0 = wd.trips
    t = threading.Thread(target=run)
    t.start()
    while t.is_alive():
        if wd.trips > trips0 and "trip" not in box:
            box["trip"] = wd.last_trip
        time.sleep(0.005)
    t.join()
    if "error" in box:
        raise box["error"]
    return box["out"], box.get("trip")


def _obs_elastic(device, seed, n, batch, num_bins, world, directory, calls):
    """One snapshot a rank at world 4, then a 4->4 restore."""

    def write(g):
        panel = _obs_panel(device, num_bins)
        session = ElasticSession(panel, directory, process_group=g, interval=10**9)
        for step in range(2):
            _elastic_feed(panel, *_elastic_batch(device, seed, 4 * step + g.rank, n, batch), False)
            session.step_done(step)
        calls[g.rank] = 4
        session.snapshot()
        session.close()
        return session._cursor

    def read(g):
        session = ElasticSession(_obs_panel(device, num_bins), directory, process_group=g,
                                 interval=10**9)
        restored = session.restore()
        session.close()
        return restored.step, obs.recorder().step_cursor

    return ThreadWorld(world, timeout=60.0).run(write), ThreadWorld(world, timeout=60.0).run(read)


def phase_obs(device, n=CRITEO_EVAL, batch=CTR_BATCH, batches=OBS_BATCHES, num_bins=NUM_BINS,
              rank_batches=OBS_RANK_BATCHES, world=4, num_classes=1000, variable=VARIABLE_BATCH,
              host_reps=200, watchdog=OBS_WATCHDOG, seed=15):
    """The observability core on the card (see the module docstring)."""
    t0 = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    rec = obs.recorder()
    out = {"phase": "obs", "device": str(device), "batches": batches, "batch": batch}
    syncs = {}
    # one throwaway update first, counted apart: the process's first
    # counted region reports a one-time synchronization that is no
    # update's (it does not recur in any later stream)
    first = {}
    with _sync_warnings(cuda, first, "first"):
        _elastic_feed(_obs_panel(device, num_bins), *_elastic_batch(device, seed, 0, n, batch),
                      False)
    _sync(device)

    # the recorder-off reference, then the recorder alone
    off_ms, oracle, off_launches = _obs_stream(device, seed, n, batch, batches, num_bins, syncs,
                                               "off")
    rec.reset()
    obs.hist.reset()
    with config.observability():
        on_ms, _, on_launches = _obs_stream(device, seed, n, batch, batches, num_bins, syncs, "on",
                                            oracle)
        on_events = rec.log.tail()
    on_updates = [e for e in on_events if e.kind == "update"]
    _check(len(on_updates) == 2 * batches, f"on: {len(on_updates)} update events, {2 * batches} calls")
    _check(sum(e.fused for e in on_updates) == 5 * batches,
           "on: the update events do not cover every metric update")

    with tempfile.TemporaryDirectory() as tmp:
        jsonl, chrome = os.path.join(tmp, "events.jsonl"), os.path.join(tmp, "trace.json")
        calls = {"armed": 0, "imagenet": 0}
        with config.observability(jsonl=jsonl, chrome_trace=chrome, watchdog=watchdog, serve=0):
            rec.reset()
            obs.hist.reset()
            srv, wd = obs.current_server(), obs.current_watchdog()
            _check(srv is not None and wd is not None, "the scope armed no server or watchdog")
            # 1. the DLRM panel, armed
            armed_ms, _, armed_launches = _obs_stream(device, seed, n, batch, batches, num_bins,
                                                      syncs, "armed", oracle)
            calls["armed"] = 2 * batches
            armed_updates = [e for e in rec.log.tail() if e.kind == "update"]
            _check(len(armed_updates) == 2 * batches and
                   sum(e.fused for e in armed_updates) == 5 * batches,
                   "armed: one update event a panel update, covering every metric")
            _check(syncs.get("on", 0) == syncs.get("off", 0) == syncs.get("armed", 0),  # noqa: E501
                   f"the recorder changed the host syncs an update makes: {syncs}")

            # 2. the ImageNet panel under shape bucketing, a ragged stream
            gen = torch.Generator(device=device).manual_seed(seed)
            schedule = [int(v) for v in np.random.default_rng(seed).permutation(variable)]
            panel = _classify_panel(device, num_classes)
            c0, e0 = _captures(), rec.log.total
            with config.shape_bucketing():
                for m in schedule:
                    toolkit.update_collection(panel, *_classify_batch(gen, m, num_classes, device))
            calls["imagenet"] = len(schedule)
            captures = _captures() - c0
            compiles = [e for e in _new_events(rec, e0) if e.kind == "compile"]
            buckets = sorted({bucket_length(m) for m in schedule})
            bound = bucket_bound(max(schedule))
            _check(len(compiles) == captures <= bound,
                   f"{len(compiles)} compile events, {captures} captures (bound {bound})")
            if cuda:
                _check(sorted(e.bucket for e in compiles) == buckets,
                       f"captures attributed to buckets {[e.bucket for e in compiles]}, "
                       f"the stream's are {buckets}")
                _check(all(e.site == "torcheval.update_collection" for e in compiles),
                       "a capture is attributed to another site")
            out["imagenet"] = {"schedule": schedule, "captures": captures, "bound": bound,
                               "compile_events": [[e.bucket, e.seconds] for e in compiles]}

            # 3. four ranks, flat and hierarchical sync
            obs.FLIGHT.reset()
            e0 = rec.log.total
            rank_calls = {}
            ranks = _obs_ranks(device, seed + 1, n, batch, rank_batches, num_bins, world,
                               rank_calls)
            for r, (same, node, leader, merged, per_rank, _, _) in enumerate(ranks):
                _check(same, f"rank {r}: the hierarchical sync differs from the flat one")
                _check((node, leader) == (4, 2 if r % 2 == 0 else 0),
                       f"rank {r}: {node} node and {leader} leader collectives")
                _check(merged == per_rank == list(range(world)),
                       f"rank {r}: gather_observability merged {merged}")
            diff = obs.diff_flight_rings(obs.FLIGHT.per_rank())
            _check(diff.diverged_rank is None,
                   f"the ranks' flight rings diverge: {diff.format()}")
            flows = {}
            for e in _new_events(rec, e0):
                if e.kind == "sync":
                    flows.setdefault(e.rank, []).append(e.flow)
            _check(len(flows) == world and len({tuple(v) for v in flows.values()}) == 1
                   and len(next(iter(flows.values()))) == 2,
                   f"the ranks' sync flow ids differ: {flows}")
            out["sync"] = {"exact_samples_a_rank": rank_batches * batch,
                           "flat_seconds": [x[5] for x in ranks],
                           "hierarchical_seconds": [x[6] for x in ranks],
                           "node_collectives": [x[1] for x in ranks],
                           "leader_collectives": [x[2] for x in ranks], "flows": flows}

            # 4. a slow peer past the watchdog deadline
            obs.FLIGHT.reset()
            e0, trips0 = rec.log.total, wd.trips
            done, trip = _obs_slow_peer(world, wd)
            _check(all(done), "the slow-peer run did not complete")
            stalls = [e for e in _new_events(rec, e0) if e.kind == "stall"]
            _check(stalls and stalls[0].op == "allgather_object" and stalls[0].rank == 2
                   and trip is not None,
                   f"stall events {[(e.op, e.rank) for e in stalls]} for rank 2's slow collective")
            slow = obs.diff_flight_rings(trip["flight"])
            _check(slow.stalled_rank == 2, f"the trip-time rings name rank {slow.stalled_rank}")
            out["slow_peer"] = {"trips": wd.trips - trips0, "stall_events": len(stalls),
                                "stall_rank": stalls[0].rank,
                                "stall_age_seconds": stalls[0].age_seconds,
                                "diff_stalled_rank": slow.stalled_rank,
                                "diff_stalled_seq": slow.stalled_seq}

            # 5. snapshot and restore
            e0 = rec.log.total
            el_calls = {}
            written, restored = _obs_elastic(device, seed + 2, n, batch, num_bins, world,
                                             os.path.join(tmp, "bundle"), el_calls)
            events = _new_events(rec, e0)
            for kind in ("snapshot", "restore"):
                got = sorted(e.rank for e in events if e.kind == kind)
                _check(got == list(range(world)), f"{kind} events from ranks {got}")
            _check(all(step == cursor == written[0] for step, cursor in restored),
                   f"step cursors after the restore: {restored}, sessions at {written}")

            # 6. the health server (the watchdog re-arms at its first poll
            # after the stall clears)
            deadline = time.monotonic() + 10 * watchdog
            while wd.tripped and time.monotonic() < deadline:
                time.sleep(watchdog / 10)
            status, health = _http_get(srv.url + "/healthz")
            health = json.loads(health)
            _check(status == 200 and health["status"] == "ok",
                   f"/healthz {status}: {health['status']}, watchdog {health['watchdog']}")
            _, metrics = _http_get(srv.url + "/metrics")
            _, flight = _http_get(srv.url + "/flight")
            _, report = _http_get(srv.url + "/report")
            families = _prometheus_families(metrics)
            json.loads(flight)
            made = (calls["armed"] + calls["imagenet"] + sum(rank_calls.values())
                    + sum(el_calls.values()))
            count = re.search(r'torcheval_tpu_latency_seconds_count\{op="update/update_collection"\} (\S+)',
                              metrics)
            _check(count is not None and int(float(count.group(1))) == made,
                   f"/metrics counts {count and count.group(1)} panel updates, {made} were made")
            _check(all(health[k] == {"armed": 0} for k in ("federation", "syncplane", "failover"))
                   and not health["admission"]["shedding"],
                   "an unarmed federation, plane or failure domain does not read absent")
            _check(not any(re.match(r"torcheval_tpu_quality_", f) for f in families),
                   "a closed input watch exported a family")
            # the wire ladder's source: exact by default, block 32, no caps
            _check(re.search(r"^torcheval_tpu_wire_block_size 32$", metrics, re.M) is not None
                   and re.search(r"^torcheval_tpu_wire_fallback_families 0$", metrics, re.M)
                   is not None, "the wire source does not read the default ladder")
            # the admission source (ported in PR 13's slice) reads no armed table
            _check(re.search(r"^torcheval_tpu_admission_armed 0$", metrics, re.M) is not None,
                   "the admission source reads an armed table")
            _check(report.startswith("torcheval_tpu observability report"), "bad /report")
            url, recorded = srv.url, rec.log.total
            out["server"] = {"healthz_status": status, "status": health["status"],
                             "families": len(families), "update_calls": made}
        try:
            urllib.request.urlopen(url + "/healthz", timeout=2)
            stopped = False
        except OSError:
            stopped = True
        _check(stopped and obs.current_server() is None, "the server outlived its scope")
        # 7. the files written at scope exit
        with open(chrome) as f:
            trace = json.load(f)
        with open(jsonl) as f:
            lines = [line for line in f if line.strip()]
        _check(len(lines) == recorded, f"{len(lines)} JSONL lines for {recorded} events")
        _check(len(trace["traceEvents"]) > 0, "an empty Chrome trace")
        out["files"] = {"jsonl_lines": len(lines), "trace_records": len(trace["traceEvents"])}

    # the recorder-off stream again: the first stream also pays the
    # process's warm-up, so the modes are read against both
    again_ms, _, _ = _obs_stream(device, seed, n, batch, batches, num_bins, syncs, "off_again",
                                 oracle)
    _check(syncs.get("off_again", 0) == syncs.get("off", 0), f"host syncs differ: {syncs}")
    out["timing"] = {mode: {"ms_median": _median(v), "ms_mean": sum(v) / len(v)}
                     for mode, v in (("off", off_ms), ("on", on_ms), ("armed", armed_ms),
                                     ("off_again", again_ms))}
    out["update_host_us"] = _update_host_us(device, seed, batch, host_reps)
    out["sync_warnings"] = dict(syncs, first_update=first.get("first", 0))
    out["k1_launches"] = {"off": off_launches, "on": on_launches, "armed": armed_launches,
                          "streaming_updates": len(_STREAMING) * batches}
    out["seconds"] = time.perf_counter() - t0
    return out


# ------------------------------------------------------- shard_quality

IMAGENET21K_CLASSES = 10_450  # ImageNet-21K-P, winter-21 release (Ridnik et al. 2021)
IMAGENET21K_VAL = 522_500
SQ_WORLD = 4
SQ_BATCHES = 300  # Criteo batches of the watched DLRM panel
SQ_THRESHOLDS = 1 << 20
# the JAX package's per-rank bound (bench.py): a rank pins at most
# logical/world plus this much once its outbox is drained
SHARD_SLACK_BYTES = 64 * 1024
SKETCH_BINS = 64
# watched against standalone sketch moments: float32 sums over another
# reduction shape (a bucketed pad), relative to each moment
SKETCH_MOMENT_RTOL = 1e-5


def _payload_bytes(sd):
    return sum(v.numel() * v.element_size() if isinstance(v, torch.Tensor) else 8
               for v in sd.values())


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def _quarters(nb, world):
    """Contiguous batch-index ranges, one a rank."""
    q = -(-nb // world)
    return [range(r * q, min((r + 1) * q, nb)) for r in range(world)]


def _shard_stream(device, make, batch_of, nb, world, restore_world, seed, directory, timing_batches,
                  drain_every=None):
    """One sharded family at a published scale: a replicated metric fed
    the whole stream (the oracle), ``world`` ``ThreadWorld`` ranks each fed
    a contiguous quarter into a sharded instance and synced, snapshotted,
    adopted; then a ``ThreadWorld(restore_world)`` restore. Every synced
    value must equal the oracle's bitwise. ``drain_every``: every rank
    adopts the synced state every that many steps of the stream (the
    drain that keeps an outbox, which grows with the samples, below the
    state it routes into)."""
    from torcheval_tpu_torch.obs.memory import logical_state_bytes, per_rank_state_bytes

    out = {}
    _reset_peak(device)
    oracle = make(None)
    for i in range(nb):
        oracle.update(*batch_of(i))
    want = _first(oracle.compute()).clone()
    replicated_payload = _payload_bytes(oracle._sync_state_dict())
    quarters = _quarters(nb, world)

    steps = max(len(q) for q in quarters)

    def ranks(g):
        m = make(ShardContext(g.rank, world))
        mine = list(quarters[g.rank])
        drains = 0
        for k in range(steps):
            if k < len(mine):
                m.update(*batch_of(mine[k]))
            if drain_every and (k + 1) % drain_every == 0 and k + 1 < steps:
                toolkit.adopt_synced(m, g)  # every rank, in step
                drains += 1
        _sync(device)
        payload = _payload_bytes(m._sync_state_dict())
        outbox = sum(int(getattr(m, n.obh)) for n in m._routed_states.values())
        t0 = time.perf_counter()
        synced = toolkit.get_synced_metric(m, g)
        value, compute_s = _timed_compute(synced, device)
        sync_s = time.perf_counter() - t0 - compute_s
        _check(torch.equal(_first(value), want), f"rank {g.rank}: synced value != the oracle")
        session = ElasticSession({"m": m}, directory, process_group=g, interval=10**9)
        session.snapshot()
        session.close()
        adopted = toolkit.adopt_synced(m, g)
        _check(torch.equal(_first(adopted.compute()), want), f"rank {g.rank}: adopted value")
        _check(m._shard_rank == g.rank and m._shard_world == world
               and all(int(getattr(m, n.obh)) == 0 for n in m._routed_states.values()),
               f"rank {g.rank}: adopt_synced left an outbox or a foreign shard")
        logical = sum(logical_state_bytes(m).values())
        per_rank = sum(per_rank_state_bytes(m).values())
        _check(per_rank <= logical // world + SHARD_SLACK_BYTES,
               f"rank {g.rank}: {per_rank} bytes, logical {logical} over {world}")
        _check(payload < replicated_payload,
               f"rank {g.rank}: a {payload}-byte sync payload, replicated {replicated_payload}")
        _sync(device)
        return {"sync_s": sync_s, "compute_ms": compute_s * 1e3, "payload": payload,
                "outbox_entries": outbox, "per_rank": per_rank, "logical": logical,
                "drains": drains}

    per = ThreadWorld(world, timeout=600.0).run(ranks)

    def restore(g):
        m = make(ShardContext(g.rank, restore_world))
        session = ElasticSession({"m": m}, directory, process_group=g, interval=10**9)
        t0 = time.perf_counter()
        session.restore()
        seconds = time.perf_counter() - t0
        session.close()
        _check(m._shard_world == restore_world and m._shard_rank == g.rank,
               f"restored rank {g.rank} holds shard {m._shard_rank} of {m._shard_world}")
        value = toolkit.sync_and_compute(m, g)
        _check(torch.equal(_first(value), want), f"restored rank {g.rank}: value != the oracle")
        return seconds

    restore_s = ThreadWorld(restore_world, timeout=600.0).run(restore)
    out["peak_bytes"] = _stream_peak(device)

    # update ms a batch, sharded against replicated, interleaved from a
    # drained queue (rank 0's shard; the replicated metric fresh)
    sh, rep = make(ShardContext(0, world)), make(None)
    ms = {"sharded": [], "replicated": []}
    for i in range(timing_batches):
        args = batch_of(i)
        order = (("sharded", sh), ("replicated", rep)) if i % 2 == 0 else (("replicated", rep), ("sharded", sh))
        for name, m in order:
            _sync(device)
            t0 = time.perf_counter()
            m.update(*args)
            _sync(device)
            ms[name].append((time.perf_counter() - t0) * 1e3)
    out.update({
        "batches": nb, "world": world, "drains_a_rank": per[0]["drains"],
        "update_ms_median": {k: _median(v) for k, v in ms.items()},
        "sync_seconds": [p["sync_s"] for p in per],
        "synced_compute_ms": [p["compute_ms"] for p in per],
        "payload_bytes": {"sharded": [p["payload"] for p in per], "replicated": replicated_payload},
        "outbox_entries": [p["outbox_entries"] for p in per],
        "per_rank_bytes": [p["per_rank"] for p in per], "logical_bytes": per[0]["logical"],
        "restore_world": restore_world, "restore_seconds": restore_s,
    })
    return out


def _shard_bucket(device, num_classes, world, variable, seed):
    """A ragged stream into one rank's sharded confusion matrix under
    shape bucketing (one CUDA-graph replay an update on the card), the
    outbox pre-sized so no growth step adds a capture: bitwise equal to
    the same stream fed eagerly, captures within ``bucket_bound``, none on
    the second pass."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    schedule = [int(v) for v in rng.permutation(variable)] * 2
    batches = [_classify_batch(gen, m, num_classes, device) for m in schedule]
    eager = MulticlassConfusionMatrix(num_classes, device=device, shard=ShardContext(0, world))
    graphed = MulticlassConfusionMatrix(num_classes, device=device, shard=ShardContext(0, world))
    shardspec.ensure_outbox_capacity(graphed, "confusion_matrix", sum(schedule) + max(schedule))
    counts, half = [], len(schedule) // 2
    for k, (x, y) in enumerate(batches):
        eager.update(x, y)
        c0 = _captures()
        with config.shape_bucketing():
            graphed.update(x, y)
        counts.append(_captures() - c0)
        _check(torch.equal(eager.confusion_matrix, graphed.confusion_matrix),
               f"bucketed sharded update {k} differs from eager")
    cnt = int(eager.confusion_matrix__obh)
    _check(int(graphed.confusion_matrix__obh) == cnt == int(graphed.confusion_matrix__obn),
           "the device cursor and its host mirror disagree")
    _check(torch.equal(eager.confusion_matrix__obi[:cnt], graphed.confusion_matrix__obi[:cnt]),
           "the bucketed outbox differs from the eager one")
    bound = bucket_bound(max(schedule))
    _check(sum(counts) <= bound and sum(counts[half:]) == 0,
           f"{sum(counts)} captures (bound {bound}), {sum(counts[half:])} on the second pass")
    return {"schedule": schedule[:half], "captures": sum(counts), "bound": bound,
            "outbox_capacity": int(graphed.confusion_matrix__obi.shape[0])}


def _sync_case(rank, world, device, group, seed, num_classes=64, steps=3, n=512):
    """``sharded.sync_states_in_jit`` (SUM, MAX, EXTEND with a valid
    bound, an owner-partitioned SUM) and ``donated_sync_step`` (a
    replicated and an owner-partitioned carry) on this rank's states over
    ``group``, each held bitwise to the eager merge (``merge_state`` in
    rank order) of every rank's metrics, rebuilt here from their seeds."""

    def rank_metrics(r):
        gen = torch.Generator(device=device).manual_seed(seed * 7919 + r)
        acc, mx = MulticlassAccuracy(device=device), Max(device=device)
        cm = MulticlassConfusionMatrix(num_classes, device=device)
        batches = []
        for _ in range(steps):
            x, y = _classify_batch(gen, n, num_classes, device)
            acc.update(x, y)
            cm.update(x, y)
            mx.update(x.reshape(-1))
            batches.append((x, y))
        buf = torch.full((64, 2), -1.0, device=device)
        buf[: 5 + 3 * r] = torch.arange(2 * (5 + 3 * r), dtype=torch.float32,
                                        device=device).reshape(-1, 2) + 100 * r
        return {"acc": acc, "max": mx, "cm": cm}, batches, buf

    mine, batches, buf = rank_metrics(rank)
    states = {"num_correct": mine["acc"].num_correct, "num_total": mine["acc"].num_total,
              "max": mine["max"].max, "buf": buf, "cm": mine["cm"].confusion_matrix}
    specs = {"num_correct": MergeKind.SUM, "num_total": MergeKind.SUM, "max": MergeKind.MAX,
             "buf": MergeKind.EXTEND, "cm": MergeKind.SUM}
    bound = 5 + 3 * (world - 1)
    _sync(device)
    t0 = time.perf_counter()
    synced = sharded.sync_states_in_jit(states, group, specs, extend_valid={"buf": bound},
                                        shard_specs={"cm": ShardSpec(0)})
    _sync(device)
    seconds = time.perf_counter() - t0

    others = [rank_metrics(r) for r in range(world)]
    merged = {}
    for k in mine:
        target = toolkit.clone_metric(others[0][0][k])
        target.merge_state([o[0][k] for o in others[1:]])
        merged[k] = target
    rows = num_classes // world
    own = slice(rank * rows, (rank + 1) * rows)
    keep = 1 << (bound - 1).bit_length()
    want = {"num_correct": merged["acc"].num_correct, "num_total": merged["acc"].num_total,
            "max": merged["max"].max, "cm": merged["cm"].confusion_matrix[own],
            "buf": torch.cat([o[2][:keep] for o in others])}
    for k, v in want.items():
        _check(torch.equal(synced[k], v), f"sync_states_in_jit {k} != the eager merge")

    step = sharded.donated_sync_step(lambda x, y: {"n": torch.full((1,), float(y.numel()), device=device),
                                                   "mx": x.amax().reshape(1)},
                                     group, {"n": MergeKind.SUM, "mx": MergeKind.MAX})
    cm_step = sharded.donated_sync_step(
        lambda x, y: {"cm": MulticlassConfusionMatrix(num_classes, device=device).update(x, y).confusion_matrix},
        group, {"cm": MergeKind.SUM}, shard_specs={"cm": ShardSpec(0)})
    carry = {"n": torch.zeros(1, device=device), "mx": torch.full((1,), -math.inf, device=device)}
    cm_carry = {"cm": torch.zeros((rows, num_classes), dtype=torch.int32, device=device)}
    tensor = carry["n"]
    for x, y in batches:
        carry = step(carry, x, y)
        cm_carry = cm_step(cm_carry, x, y)
    _check(carry["n"] is tensor and float(carry["n"]) == float(steps * n * world),
           "the donated carry was not updated in place")
    _check(torch.equal(carry["mx"], merged["max"].max.reshape(1)), "donated MAX carry")
    _check(torch.equal(cm_carry["cm"], want["cm"]), "donated owner-partitioned carry")
    return {"rank": rank, "world": world, "seconds": seconds, "bitwise": sorted(want) + ["carry"]}


def _shard_worker(config_json):
    """One gloo process of the shard_quality phase (``chip_smoke.py
    --shard-worker <json>``, started by ``launcher.launch``): ``_sync_case``
    on CPU tensors over ``MultiHostGroup``; writes its result with
    ``torch.save``."""
    cfg = json.loads(config_json)
    rank = launcher.init_from_env(timeout=120.0)
    try:
        group = MultiHostGroup()
        result = _sync_case(rank, group.world_size, torch.device("cpu"), group, cfg["seed"])
        torch.save(result, os.path.join(cfg["dir"], f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _in_step_sync(device, seed, mp):
    """``sync_states_in_jit`` over a real NCCL group of world 1 (the card;
    NCCL refuses two ranks on one card) and, with ``mp``, over two gloo
    processes through ``launcher.launch``."""
    out = {}
    if torch.device(device).type == "cuda":
        _check(not dist.is_initialized(), "torch.distributed is already initialized")
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{launcher.free_port()}",
                                rank=0, world_size=1)
        try:
            out["nccl_world1"] = _sync_case(0, 1, device, dist.group.WORLD, seed)
        finally:
            dist.destroy_process_group()
    if mp:
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            launcher.launch(os.path.abspath(__file__),
                            ["--shard-worker", json.dumps({"dir": d, "seed": seed})],
                            nproc=MP_WORLD, timeout=300)
            got = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                   for r in range(MP_WORLD)]
        out["gloo_world2"] = {"launch_seconds": time.perf_counter() - t0,
                              "sync_seconds": [g["seconds"] for g in got],
                              "bitwise": got[0]["bitwise"]}
    return out


def _sketch_lanes_check(what, watched, standalone):
    """The watched sketch's counter, histogram and register lanes bitwise
    equal to a standalone ``InputSketch`` over the same stream; the
    moments within ``SKETCH_MOMENT_RTOL``."""
    for name in ("hist", "counts", "registers"):
        _check(torch.equal(getattr(watched, name), getattr(standalone, name)),
               f"{what}: the watched {name} lane differs from the standalone sketch")
    a, b = watched.moments.double().cpu(), standalone.moments.double().cpu()
    _check(a[0] == b[0] and a[3] == b[3] and a[4] == b[4]
           and torch.allclose(a[1:3], b[1:3], rtol=SKETCH_MOMENT_RTOL, atol=0.0),
           f"{what}: moments {a.tolist()} against {b.tolist()}")


def _metric_states_equal(a, b):
    """Every state of ``a`` (the unwatched metric) bitwise in ``b``."""
    return all(torch.equal(v, getattr(b, k)) if isinstance(v, torch.Tensor) else v == getattr(b, k)
               for k, v in a.state_dict().items())


def _quality_dlrm(device, seed, n, batch, batches, num_bins, syncs):
    """The DLRM panel with its scores watched (``watch_inputs`` on the
    ``ne`` member: 65,536 sketched elements a batch) beside the same panel
    unwatched, in one interleaved loop from a drained queue: every metric
    state bitwise equal after every update, the same host syncs, the
    sketch lanes equal to a standalone ``InputSketch``."""
    cuda = torch.device(device).type == "cuda"
    plain, watched = _obs_panel(device, num_bins), _obs_panel(device, num_bins)
    watch = quality.watch_inputs(watched["ne"], bounds=(0.0, 1.0), num_bins=SKETCH_BINS,
                                 label="dlrm_scores")
    standalone = InputSketch(bounds=(0.0, 1.0), num_bins=SKETCH_BINS, device=device)
    # one throwaway update first, counted apart: a process's first counted
    # region reports a one-time synchronization that is no update's
    with _sync_warnings(cuda, syncs, "dlrm_first"):
        _elastic_feed(_obs_panel(device, num_bins), *_elastic_batch(device, seed, 0, n, batch), False)
    _sync(device)
    ms = {"unwatched": [], "watched": []}
    for i in range(batches):
        s, y = _elastic_batch(device, seed, i, n, batch)
        order = (("unwatched", plain), ("watched", watched))
        for name, panel in (order if i % 2 == 0 else order[::-1]):
            _sync(device)
            t0 = time.perf_counter()
            with _sync_warnings(cuda, syncs, f"dlrm_{name}"):
                _elastic_feed(panel, s, y, False)
            _sync(device)
            ms[name].append((time.perf_counter() - t0) * 1e3)
        standalone.update(s)
        for k in plain:
            _check(_metric_states_equal(plain[k], watched[k]),
                   f"batch {i}: the watched panel's {k} differs from the unwatched one")
    _sketch_lanes_check("dlrm", watch.sketch("dlrm_scores/0"), standalone)
    _check(syncs.get("dlrm_watched", 0) == syncs.get("dlrm_unwatched", 0),
           f"watching changed the host syncs: {syncs}")
    return watch, {"batches": batches, "sketched_elements_a_batch": batch,
                   "ms_median": {k: _median(v) for k, v in ms.items()},
                   "ms_mean": {k: sum(v) / len(v) for k, v in ms.items()}}


def _quality_host_and_fold(device, seed, batch, reps):
    """Host microseconds of one ``BinaryNormalizedEntropy.update`` watched
    and unwatched (no synchronize around it, interleaved), and on the card
    the sketch fold's device ms and kernel launches an update: profiled
    standalone (``InputSketch.update``) and as the difference of a watched
    and an unwatched update."""
    s, y = _elastic_batch(device, seed, 0, batch, batch)
    plain = BinaryNormalizedEntropy(device=device)
    watched = BinaryNormalizedEntropy(device=device)
    watch = quality.watch_inputs(watched, bounds=(0.0, 1.0), num_bins=SKETCH_BINS, label="host_us")
    times = {"unwatched": [], "watched": []}
    for i in range(reps):
        for name, m in (("unwatched", plain), ("watched", watched)):
            t0 = time.perf_counter()
            m.update(s, y)
            times[name].append((time.perf_counter() - t0) * 1e6)
        if i % 16 == 15:
            _sync(device)
    _sync(device)
    out = {"host_us_median": {k: _median(v) for k, v in times.items()}}
    if torch.device(device).type == "cuda":
        sk = InputSketch(bounds=(0.0, 1.0), num_bins=SKETCH_BINS, device=device)
        fold = _profile(lambda: sk.update(s), device, reps=20)
        prof = {name: _profile(lambda m=m: m.update(s, y), device, reps=20)
                for name, m in (("unwatched", plain), ("watched", watched))}
        out["fold"] = {"standalone_device_ms": fold["device_ms"],
                       "standalone_launches": fold["launches"],
                       "top_kernels": fold["top_kernels"],
                       "watched_minus_unwatched_device_ms":
                           prof["watched"]["device_ms"] - prof["unwatched"]["device_ms"],
                       "watched_minus_unwatched_launches":
                           prof["watched"]["launches"] - prof["unwatched"]["launches"],
                       "elements": int(s.numel())}
    watch.close()
    return out


def _quality_imagenet(device, seed, num_classes, variable, syncs):
    """Phase 13's ImageNet panel as a ragged stream under shape bucketing
    (on the card, one CUDA-graph replay an update), its ``acc`` member's
    logits watched, beside the same panel unwatched: states bitwise equal
    after every update, the same captures (within ``bucket_bound``, none
    on the second pass) and host syncs, lanes equal to a standalone
    sketch."""
    cuda = torch.device(device).type == "cuda"
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    schedule = [int(v) for v in rng.permutation(variable)] * 2
    plain, watched = _classify_panel(device, num_classes), _classify_panel(device, num_classes)
    watch = quality.watch_inputs(watched["acc"], bounds=(-8.0, 8.0), num_bins=SKETCH_BINS,
                                 label="imagenet_logits")
    standalone = InputSketch(bounds=(-8.0, 8.0), num_bins=SKETCH_BINS, device=device)
    captures = {"unwatched": [], "watched": []}
    half = len(schedule) // 2
    for k, m in enumerate(schedule):
        x, y = _classify_batch(gen, m, num_classes, device)
        for name, panel in (("unwatched", plain), ("watched", watched)):
            c0 = _captures()
            with config.shape_bucketing(), _sync_warnings(cuda, syncs, f"imagenet_{name}"):
                toolkit.update_collection(panel, x, y)
            captures[name].append(_captures() - c0)
        standalone.update(x)
        for key in plain:
            _check(_metric_states_equal(plain[key], watched[key]),
                   f"update {k}: the watched ImageNet panel's {key} differs")
    bound = bucket_bound(max(schedule))
    got = {k: sum(v) for k, v in captures.items()}
    _check(got["watched"] == got["unwatched"] <= bound,
           f"captures watched {got['watched']}, unwatched {got['unwatched']} (bound {bound})")
    _check(sum(captures["watched"][half:]) == 0, "the watched panel captured on the second pass")
    _check(syncs.get("imagenet_watched", 0) == syncs.get("imagenet_unwatched", 0),
           f"watching changed the host syncs: {syncs}")
    _sketch_lanes_check("imagenet", watch.sketch("imagenet_logits/0"), standalone)
    return watch, {"schedule": schedule[:half], "captures": got, "bound": bound}


def _quality_drift(device, seed, n, batch, ref_batches):
    """``freeze_reference`` after ``ref_batches`` Criteo score batches,
    then as many shifted ones (sqrt of each score): one ``Monitor.check``
    must trip the ``DriftSpec`` and record one ``DriftEvent``; the health
    server's ``/metrics`` then carries the ``quality_value`` histogram
    family and ``/report`` the ``[quality]`` table."""
    mean = Mean(device=device)
    watch = quality.watch_inputs(mean, bounds=(0.0, 1.0), num_bins=SKETCH_BINS, label="drift_scores")
    rec = obs.recorder()
    out = {}
    with config.observability(serve=0, slos=[]):
        srv = obs.current_server()
        for i in range(ref_batches):
            mean.update(_elastic_batch(device, seed, i, n, batch)[0])
        watch.freeze_reference()
        watch.add_drift(quality.DriftSpec(min_count=batch))
        for i in range(ref_batches, 2 * ref_batches):
            mean.update(torch.sqrt(_elastic_batch(device, seed, i, n, batch)[0]))
        e0 = rec.log.total
        raised = obs.Monitor(cooldown=0.0).check()
        drifts = [e for e in _new_events(rec, e0) if e.kind == "drift"]
        _check(len(drifts) == 1 and drifts[0].series == "drift_scores/0" and drifts[0].breach,
               f"drift events {[(e.series, e.breach) for e in drifts]}")
        _check(any(r["name"] == "quality/drift_scores/0" for r in raised), "no drift alert raised")
        _, metrics = _http_get(srv.url + "/metrics")
        _, report = _http_get(srv.url + "/report")
        families = _prometheus_families(metrics)
        _check(families.get("torcheval_tpu_quality_value") == "histogram",
               "/metrics has no quality_value histogram family")
        _check("[quality]" in report and "drift_scores/0" in report, "/report has no [quality] table")
        out = {"scores": watch.score("drift_scores/0"), "breach": drifts[0].breach,
               "alerts": sorted(r["alert"] for r in raised if r["name"].startswith("quality/"))}
    watch.close()
    return out


def phase_shard_quality(device, cm_n=IMAGENET21K_VAL, num_classes=IMAGENET21K_CLASSES,
                        cm_batch=1024, ctr_n=CRITEO_EVAL, ctr_batch=CTR_BATCH,
                        thresholds=SQ_THRESHOLDS, world=SQ_WORLD, restore_world=2,
                        timing_batches=20, bucket_classes=1000, variable=VARIABLE_BATCH,
                        quality_batches=SQ_BATCHES, num_bins=NUM_BINS, host_reps=200,
                        drift_batches=20, auroc_drain_every=8, mp=True, seed=16):
    """Sharded state and the data-quality layer on the card (see the
    module docstring)."""
    t0 = time.perf_counter()
    out = {"phase": "shard_quality", "device": str(device)}
    k1 = _kernels.LAUNCHES["fused_auc_hist"]
    with tempfile.TemporaryDirectory() as tmp:
        # the matrix is sized to the shard world (the JAX package's rule:
        # round the configuration up, never pad silently); the logits'
        # extra columns are -inf, so those classes never occur
        width = -(-num_classes // world) * world

        def cm_batch_of(i):
            gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + i)
            x, y = _classify_batch(gen, min(cm_batch, cm_n - i * cm_batch), num_classes, device)
            return F.pad(x, (0, width - num_classes), value=-math.inf), y

        out["confusion_matrix"] = _shard_stream(
            device, lambda ctx: MulticlassConfusionMatrix(width, device=device, shard=ctx),
            cm_batch_of, -(-cm_n // cm_batch), world, restore_world, seed,
            os.path.join(tmp, "cm"), timing_batches)
        out["confusion_matrix"].update(num_classes=num_classes, matrix_width=width)
        out["histogram_auroc"] = _shard_stream(
            device, lambda ctx: HistogramBinnedAUROC(threshold=thresholds, device=device, shard=ctx),
            lambda i: _elastic_batch(device, seed + 1, i, ctr_n, ctr_batch),
            -(-ctr_n // ctr_batch), world, restore_world, seed + 1,
            os.path.join(tmp, "auroc"), timing_batches, drain_every=auroc_drain_every)
        out["histogram_auroc"]["thresholds"] = thresholds
    out["in_step_sync"] = _in_step_sync(device, seed + 2, mp)
    out["bucket"] = _shard_bucket(device, bucket_classes, world, variable, seed + 3)

    syncs = {}
    watches = []
    try:
        watch, out["dlrm"] = _quality_dlrm(device, seed + 4, ctr_n, ctr_batch, quality_batches,
                                           num_bins, syncs)
        watches.append(watch)
        out["host_and_fold"] = _quality_host_and_fold(device, seed + 5, ctr_batch, host_reps)
        watch, out["imagenet"] = _quality_imagenet(device, seed + 6, bucket_classes, variable, syncs)
        watches.append(watch)
        out["drift"] = _quality_drift(device, seed + 7, ctr_n, ctr_batch, drift_batches)
    finally:
        for watch in watches:
            watch.close()
    out["sync_warnings"] = {k: v for k, v in syncs.items() if k != "where"}
    out["k1_launches"] = _kernels.LAUNCHES["fused_auc_hist"] - k1
    if torch.device(device).type == "cuda":
        want = len(_STREAMING) * (2 * quality_batches + 1)  # two panels and the warm-up
        _check(out["k1_launches"] == want, f"K1 launched {out['k1_launches']} times, want {want}")
    out["seconds"] = time.perf_counter() - t0
    return out


# ------------------------------------------------------------ 17. serving

SERVING_WORLD = 4
# the categorical feature of 590,152 rows in MLPerf DLRM-DCNv2's per-feature
# embedding sizes (torchrec examples/dlrm dlrm_main.py,
# --num_embeddings_per_feature)
DLRM_FEATURE_ROWS = 590_152
SERVING_BATCHES = 64  # Criteo batches of the keyed panel: cut from 1,361 for the phase budget
SERVING_DRAIN_EVERY = 16
SERVING_WINDOW = 4  # drain epochs of the panel's windowed NE member
SERVING_MEMBERS = ("ctr", "weighted_calibration", "ne",
                   ("windowed_ne", "windowed_ne", {"window": SERVING_WINDOW}))
DECODE_REQUESTS = 10_000  # requests in flight (the JAX package's decode acceptance size)
DECODE_ACTIVE = 4096  # decode rows a step
DECODE_STEPS = 200  # logprob + token_edit arm: cut for the phase budget
NGRAM_STEPS = 50  # the same plus ngram (n = 4): cut for the phase budget
DECODE_SAMPLED = 64  # requests held to standalone metrics
DECODE_LEN = (64, 512)  # output lengths, U(64, 512)
# ragged active-set sizes of the decode tail, ending in an empty step
DECODE_TAIL = (1900, 1000, 600, 200, 100, 50, 20, 9, 3, 0)
_MASK64 = (1 << 64) - 1


@contextlib.contextmanager
def _quiet_world1_syncs():
    """World-1 adopts drain every step here; the toolkit's "world size is
    1" warning would print once each."""
    log = logging.getLogger("torcheval_tpu_torch.metrics.toolkit")
    level = log.level
    log.setLevel(logging.ERROR)
    try:
        yield
    finally:
        log.setLevel(level)


def _splitmix64_np(x):
    """splitmix64 over uint64 numpy values (wrapping products)."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(_MASK64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _keep_np(hashed, epoch, p):
    """The admission keep verdict written out anew: a key is kept for the
    whole drain epoch when ``splitmix64(hash ^ splitmix64(epoch)) <
    p * 2^64``."""
    if p >= 1.0:
        return np.ones(hashed.shape, bool)
    if p <= 0.0:
        return np.zeros(hashed.shape, bool)
    with np.errstate(over="ignore"):
        salt = _splitmix64_np(np.asarray([int(epoch) & _MASK64], np.uint64))[0]
        z = _splitmix64_np(hashed ^ salt)
    return z < np.uint64(min(int(p * 2.0**64), _MASK64))


def _ids_of_hashes(hashes, universe):
    """The integer keys in ``[0, universe)`` behind table key hashes."""
    all_h = hash_keys(np.arange(universe, dtype=np.int64))
    order = np.argsort(all_h, kind="stable")
    pos = np.searchsorted(all_h[order], hashes)
    _check(bool(np.all(all_h[order][np.minimum(pos, universe - 1)] == hashes)),
           "a table key is not one of the stream's ids")
    return order[pos]


def _serving_batch(device, seed, i, batch, rows):
    """One Criteo batch keyed by a DLRM categorical feature: ids
    ``floor(rows * u^4)`` (phase 9's heavy head), clicks and sigmoid
    scores of N(-3.5, 1.5) logits (phase 2's stream)."""
    gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + i)
    u = torch.rand((batch,), generator=gen, device=device, dtype=torch.float64)
    ids = torch.floor(rows * u**4).to(torch.int64)
    _, s, y = _click_logits(gen, (batch,), device)
    return ids, s, y


def _panel_bundle(s, y):
    return {"ctr": (y,), "weighted_calibration": (s, y), "ne": (s, y), "windowed_ne": (s, y)}


def _panel_oracle_states(t):
    """The accumulated columns of a drained panel, by key id (float64)."""
    n = int(t.n_keys)
    cols = {}
    for f in ("ctr__click", "ctr__weight", "weighted_calibration__weighted_input",
              "weighted_calibration__weighted_target", "ne__total_entropy", "ne__num_examples",
              "ne__num_positive"):
        cols[f] = getattr(t, f"col_{f}")[:n]
    for f in ("total_entropy", "num_examples", "num_positive"):
        cols[f"windowed_ne__{f}"] = getattr(t, f"ring_windowed_ne__{f}")[:n].sum(-1)
    return cols


def _serving_panel(device, rows, batch, batches, world, drain_every, seed):
    """The keyed DLRM panel over ``ThreadWorld(world)`` ranks (a quarter of
    each batch a rank) beside one world-1 panel fed the same rows, drained
    every ``drain_every`` batches, held to integer and float64 oracles."""
    _reset_peak(device)
    panels = [TablePanel(SERVING_MEMBERS, shard=ShardContext(r, world), device=device)
              for r in range(world)]
    single = TablePanel(SERVING_MEMBERS, device=device)
    epochs = -(-batches // drain_every)
    cnt = torch.zeros(rows, dtype=torch.int64, device=device)
    clk = torch.zeros(rows, dtype=torch.int64, device=device)
    s64 = torch.zeros(rows, dtype=torch.float64, device=device)
    ce64 = torch.zeros(rows, dtype=torch.float64, device=device)
    ep_cnt = torch.zeros((epochs, rows), dtype=torch.int64, device=device)
    ep_clk = torch.zeros((epochs, rows), dtype=torch.int64, device=device)
    ep_ce = torch.zeros((epochs, rows), dtype=torch.float64, device=device)
    host_us, drain_s, payload, logical, world1_s = [], [], {}, None, 0.0
    quarter = -(-batch // world)
    _sync(device)
    t0 = time.perf_counter()
    merged = None
    for i in range(batches):
        ids, s, y = _serving_batch(device, seed, i, batch, rows)
        keys = ids.cpu().numpy()
        for r, p in enumerate(panels):
            sl = slice(r * quarter, min((r + 1) * quarter, batch))
            t_in = time.perf_counter()
            p.ingest(keys[sl], **_panel_bundle(s[sl], y[sl]))
            host_us.append((time.perf_counter() - t_in) * 1e6)
        t_w1 = time.perf_counter()
        single.ingest(keys, **_panel_bundle(s, y))
        world1_s += time.perf_counter() - t_w1
        e = i // drain_every
        yi = y.to(torch.int64)
        ce = _ce64(s, y, False)
        for acc, v in ((cnt, torch.ones_like(ids)), (clk, yi), (s64, s.double()), (ce64, ce)):
            acc.index_add_(0, ids, v)
        ep_cnt[e].index_add_(0, ids, torch.ones_like(ids))
        ep_clk[e].index_add_(0, ids, yi)
        ep_ce[e].index_add_(0, ids, ce)
        if (i + 1) % drain_every == 0 or i + 1 == batches:
            payload = {"ranks": [_payload_bytes(p._sync_state_dict()) for p in panels],
                       "world1": _payload_bytes(single._sync_state_dict())}
            _sync(device)
            t_d = time.perf_counter()
            merged = ThreadWorld(world, timeout=600.0).run(
                lambda g: toolkit.adopt_synced(panels[g.rank], g))[0]
            _sync(device)
            drain_s.append(time.perf_counter() - t_d)
            toolkit.adopt_synced(single)
    _sync(device)
    stream_s = time.perf_counter() - t0
    peak = _stream_peak(device)

    # per-key values and states against the oracles and the world-1 panel
    mv, sv = merged.compute(), single.compute()
    _check(np.array_equal(mv.keys, sv.keys), "world-4 and world-1 key sets differ")
    ids_of_key = torch.from_numpy(_ids_of_hashes(mv.keys, rows)).to(device)
    want_ctr = clk[ids_of_key].to(torch.float32) / (
        cnt[ids_of_key].to(torch.float32) + torch.finfo(torch.float32).tiny)
    _check(torch.equal(mv.values["ctr"], want_ctr), "per-key CTR != the int64 oracle")
    _check(torch.equal(mv.values["ctr"], sv.values["ctr"]), "world-4 CTR != the world-1 panel's")
    # the windowed member covers each key's last SERVING_WINDOW epochs with traffic
    has = ep_cnt[:, ids_of_key] > 0
    from_end = torch.flip(torch.cumsum(torch.flip(has.to(torch.int64), [0]), 0), [0])
    in_window = has & (from_end <= SERVING_WINDOW)
    win = {
        "total_entropy": (ep_ce[:, ids_of_key] * in_window).sum(0),
        "num_examples": (ep_cnt[:, ids_of_key] * in_window).sum(0).double(),
        "num_positive": (ep_clk[:, ids_of_key] * in_window).sum(0).double(),
    }
    oracle = {
        "ctr__click": clk[ids_of_key].double(), "ctr__weight": cnt[ids_of_key].double(),
        "weighted_calibration__weighted_input": s64[ids_of_key],
        "weighted_calibration__weighted_target": clk[ids_of_key].double(),
        "ne__total_entropy": ce64[ids_of_key], "ne__num_examples": cnt[ids_of_key].double(),
        "ne__num_positive": clk[ids_of_key].double(),
    }
    oracle.update({f"windowed_ne__{k}": v for k, v in win.items()})
    # one batch delta a rank's ingest or outbox batch, one add a carrier
    updates = 2 * batches * world
    errs = {}
    for name, table in (("world4", merged), ("world1", single)):
        cols = _panel_oracle_states(table)
        ok, worst = _float_bound([cols[k] for k in oracle], [oracle[k] for k in oracle],
                                 quarter if name == "world4" else batch, updates)
        _check(ok, f"{name} panel columns outside the float32 summation bound")
        errs[name] = worst
    wc64 = s64[ids_of_key] / clk[ids_of_key].double()
    pos = clk[ids_of_key] > 0
    ne64 = (ce64[ids_of_key] / cnt[ids_of_key]) / _entropy64(clk[ids_of_key].double(), cnt[ids_of_key].double())
    value_err = {
        "calibration": _rel_err(mv.values["weighted_calibration"][pos], wc64[pos]),
        "ne": _rel_err(mv.values["ne"], ne64),
        "calibration_world4_vs_world1": _rel_err(mv.values["weighted_calibration"][pos],
                                                 sv.values["weighted_calibration"][pos]),
        "ne_world4_vs_world1": _rel_err(mv.values["ne"], sv.values["ne"]),
    }
    # bytes after the last adopt, and the payload of a rank before it
    reports = [memory_report({"p": p})["p"] for p in panels]
    logical = reports[0]["logical_bytes"]
    per_rank = [rep["per_rank_bytes"] for rep in reports]
    for b in per_rank:
        _check(logical / (2 * world) <= b <= 2 * logical / world,
               f"per-rank bytes {b} outside [logical/{2 * world}, 2 logical/{world}] of {logical}")
    _check(max(payload["ranks"]) < payload["world1"], "a rank's sync payload is not below world 1's")
    for p in panels:
        _check(int(p.out_h) == 0 and int(p._owner_rank) == panels.index(p), "a rank did not drain")

    # one rank's ingest: device time and launches, eager and graphed
    timing = None
    if torch.device(device).type == "cuda":
        ids, s, y = _serving_batch(device, seed, batches, batch, rows)
        keys = ids.cpu().numpy()[:quarter]
        bundle = _panel_bundle(s[:quarter], y[:quarter])
        tp = TablePanel(SERVING_MEMBERS, shard=ShardContext(0, world), device=device)
        timing = {}
        for mode, fn in (("eager", lambda: tp.update(keys, **bundle)),
                         ("graphed", lambda: tp.ingest(keys, **bundle))):
            fn()
            timing[mode] = {"host_ms": _host_ms(fn, device, 20), "event_ms": _time_ms(fn, device, 20),
                            **_profile(fn, device, reps=5)}
    return {
        "rows": rows, "batch": batch, "batches": batches, "cut_from": -(-CRITEO_EVAL // batch),
        "world": world, "drain_every": drain_every, "keys": int(mv.keys.size),
        "ingest_host_us_median": _median(host_us), "ingest_host_us_p99": float(np.percentile(host_us, 99)),
        "keys_per_s": batches * batch / (sum(host_us) / 1e6), "stream_s": stream_s, "drain_s": drain_s,
        "world1_ingest_s": world1_s,
        "logical_bytes": logical, "per_rank_bytes": per_rank, "payload_bytes": payload,
        "peak_bytes": peak, "columns_max_rel_err": errs, "value_max_rel_err": value_err,
        "ctr_bitwise": True, "ingest": timing,
    }


def _serving_ncf(device, users, candidates, batch, k, seed):
    """``MetricTable("hit_rate", k=k)`` keyed by user over MLPerf NCF's
    evaluation, every user's hit rate bitwise against an int64 rank count."""
    t = MetricTable("hit_rate", k=k, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    want, walls = np.zeros(users, np.float32), []
    for start in range(0, users, batch):
        n = min(batch, users - start)
        scores, target = _ncf_batch(gen, n, candidates, device)
        t0 = time.perf_counter()
        t.ingest(np.arange(start, start + n), scores, target)
        _sync(device)
        walls.append((time.perf_counter() - t0) * 1e3)
        tt = target.cpu().numpy()
        tt = np.where(tt < 0, tt + candidates, tt)
        ok = (tt >= 0) & (tt < candidates)
        picked = scores[torch.arange(n, device=device), torch.from_numpy(np.where(ok, tt, 0)).to(device)]
        picked = torch.where(torch.from_numpy(ok).to(device), picked, torch.full_like(picked, float("nan")))
        rank = (scores > picked[:, None]).sum(-1, dtype=torch.int64).cpu().numpy()
        want[start:start + n] = (rank < k).astype(np.float32)
    tv = t.compute()
    _check(tv.keys.size == users, "NCF table lost users")
    got = tv.values.cpu().numpy()
    _check(got.dtype == np.float32 and got.tobytes() == want[_ids_of_hashes(tv.keys, users)].tobytes(),
           "per-user hit rates != the int64 rank oracle")
    return {"users": users, "candidates": candidates, "batch": batch, "k": k, "bitwise": True,
            f"hr@{k}": float(want.mean()), "ingest_ms_median": _median(walls),
            "ingest_ms_first": walls[0]}


def _admission_calls(batch, chunk, device):
    """One scheduled step as ``chunk``-row requests (the QPS multiplier
    is more requests, not bigger ones), payloads on the device."""
    p = torch.from_numpy(batch.kwargs["preds"]).to(device)
    y = torch.from_numpy(batch.kwargs["targets"]).to(device)
    n = batch.keys.shape[0]
    return [(batch.keys[s:s + chunk], p[s:s + chunk], y[s:s + chunk]) for s in range(0, n, chunk)]


def _serving_admission(device, calm_steps, spike_steps, tail_steps, rows, keyspace, seed):
    """The keyed panel armed with an ``AdmissionController`` under a
    sustained 10x QPS and 10x key-cardinality spike in ``rows``-row
    requests, drained every step (the JAX package's bench config 19)."""
    budget = ServingBudget(max_keys=keyspace, max_outbox=4 * keyspace)

    def controller():
        return AdmissionController(budget, sample_p=0.1, floor_p=0.01, check_every=1,
                                   cooldown_drains=2, enter_pressure=0.9, exit_pressure=0.1)

    panel = TablePanel(SERVING_MEMBERS, device=device, admission=controller())
    probe = None
    sched = {
        "calm": OverloadSchedule.sustained(calm_steps, 1.0, base_rows=rows, base_keys=keyspace,
                                           seed=seed, family="weighted_calibration"),
        "prefix": OverloadSchedule.sustained(4, 10.0, cardinality=10.0, base_rows=rows,
                                             base_keys=keyspace, seed=seed + 1,
                                             family="weighted_calibration"),
        "spike": OverloadSchedule.sustained(spike_steps, 10.0, cardinality=10.0, base_rows=rows,
                                            base_keys=keyspace, seed=seed + 2,
                                            family="weighted_calibration"),
        "tail": OverloadSchedule.sustained(tail_steps, 1.0, base_rows=rows, base_keys=keyspace,
                                           seed=seed + 3, family="weighted_calibration"),
    }
    walls = {k: [] for k in sched}
    rungs = {k: [] for k in sched}
    captures = {k: 0 for k in sched}
    keep_checks = 0
    shedding_seen = False
    try:
        for name, schedule in sched.items():
            if name == "spike":
                _warm_admitted_buckets(panel, 10 * keyspace, rows, device)
            for b in schedule.batches():
                c0 = _captures()
                calls = _admission_calls(b, rows, device)
                for keys, p, y in calls:
                    hashed = hash_keys(keys)
                    frac = panel.admission.sampled_fraction(int(panel.admission_rung))
                    want = _keep_np(hashed, int(panel.epoch), frac)
                    got = admission_keep(hashed, int(panel.epoch), frac)
                    _check(np.array_equal(got, want), "admission_keep != its numpy copy")
                    before = int(panel.admitted_rows_total)
                    t0 = time.perf_counter()
                    panel.ingest(keys, ctr=(y,), weighted_calibration=(p, y), ne=(p, y),
                                 windowed_ne=(p, y))
                    _sync(device)
                    walls[name].append((time.perf_counter() - t0) * 1e6)
                    _check(int(panel.admitted_rows_total) - before == int(want.sum()),
                           "the ingest kept other rows than the verdict")
                    keep_checks += 1
                if name == "spike" and b.step == 1:
                    # the probe's fresh panels capture their own graphs
                    c_probe = _captures()
                    probe = _admission_probe(b, calls, panel, controller(), device)
                    c0 += _captures() - c_probe
                toolkit.adopt_synced(panel)
                rungs[name].append(int(panel.admission_rung))
                captures[name] += _captures() - c0
                if int(panel.admission_rung) > 0:
                    health = healthz_payload()
                    _check(health["status"] == "shedding" and health["healthy"],
                           f"/healthz reads {health['status']} while shedding")
                    shedding_seen = True
    finally:
        panel.disarm_admission()
    _check(max(rungs["prefix"]) == 1, f"the spike prefix did not escalate: {rungs['prefix']}")
    _check(set(rungs["spike"]) == {1}, f"the ladder did not latch at sampled: {rungs['spike']}")
    _check(rungs["tail"][-1] == 0, f"the ladder did not return to full: {rungs['tail']}")
    _check(shedding_seen, "/healthz never read shedding")
    if torch.device(device).type == "cuda":
        _check(captures["spike"] == 0 and captures["tail"] == 0,
               f"captures across the rung changes: {captures}")
    unloaded = float(np.percentile(walls["calm"][len(walls["calm"]) // 5:], 99))
    overloaded = float(np.percentile(walls["spike"], 99))
    return {
        "rows": rows, "keyspace": keyspace, "qps_multiplier": 10.0, "cardinality_multiplier": 10.0,
        "steps": {k: len(v) for k, v in rungs.items()}, "rungs": rungs, "captures": captures,
        "keep_checks": keep_checks, "unloaded_p99_us": unloaded, "overloaded_p99_us": overloaded,
        "p99_ratio": overloaded / unloaded, "shed_rows_total": int(panel.shed_rows_total),
        "admitted_rows_total": int(panel.admitted_rows_total),
        "transitions": int(panel.admission_transitions), "admitted_keys_check": probe,
    }


def _warm_admitted_buckets(panel, space, rows, device):
    """Capture every bucket an armed request can land in, at the latched
    rung and the spiked slot capacity, before the spike is measured: the
    verdict is a pure function of (key, epoch, p), so requests of exactly
    ``m`` admitted rows can be made (the JAX package's bench warms the same
    way). The rows repeat keys the panel already holds, so the warm-up adds
    no key and no occupancy pressure."""
    keys = np.arange(space, dtype=np.int64)
    hashed = hash_keys(keys)
    frac = panel.admission.sampled_fraction(int(panel.admission_rung))
    admitted = keys[_keep_np(hashed, int(panel.epoch), frac) & np.isin(hashed, panel._keys)]
    _check(admitted.size > 0, "no held key is admitted at the latched rung")
    for m in (8, 16, 32, 64, 128, 256, 512, rows):
        if m > rows:
            continue
        chosen = np.resize(admitted, m)
        half = torch.full((m,), 0.5, device=device)
        panel.ingest(chosen, ctr=(half,), weighted_calibration=(half, half), ne=(half, half),
                     windowed_ne=(half, half))


def _admission_probe(b, calls, panel, ctrl, device):
    """One spike step into a fresh panel armed at the latched rung and an
    unarmed panel: every admitted key's ratio metrics equal its full-ingest
    values for that epoch (CTR bitwise; calibration and NE within the
    float32 bound of two reweighted sums)."""
    armed = TablePanel(SERVING_MEMBERS, device=device, admission=ctrl)
    full = TablePanel(SERVING_MEMBERS, device=device)
    try:
        armed.admission_rung = int(panel.admission_rung)
        armed.epoch = int(b.step)
        full.epoch = int(b.step)
        for keys, p, y in calls:
            bundle = dict(ctr=(y,), weighted_calibration=(p, y), ne=(p, y), windowed_ne=(p, y))
            armed.ingest(keys, **bundle)
            full.ingest(keys, **bundle)
        a, f = armed.compute(), full.compute()
        pos = np.searchsorted(f.keys, a.keys)
        _check(bool(np.all(f.keys[pos] == a.keys)), "an admitted key is missing from the full panel")
        idx = torch.from_numpy(pos).to(device)
        _check(torch.equal(a.values["ctr"], f.values["ctr"][idx]), "admitted CTR != full-ingest CTR")
        rows_of = full.col_ctr__weight[idx].double()
        tol = 4 * (rows_of + 8) * U32
        errs = {}
        for alias in ("weighted_calibration", "ne"):
            got, want = a.values[alias].double(), f.values[alias][idx].double()
            rel = (got - want).abs() / want.abs().clamp(min=1e-30)
            _check(bool((rel <= tol).all()), f"admitted {alias} outside the float32 bound")
            errs[alias] = float(rel.max())
        return {"admitted_keys": int(a.keys.size), "keys": int(f.keys.size), "ctr_bitwise": True,
                "max_rel_err": errs}
    finally:
        armed.disarm_admission()


class _DecodePool:
    """Requests in flight: ids, output lengths U(64, 512) and progress;
    a finished request is replaced by a new one."""

    def __init__(self, rng, requests, sampled, min_sampled_len):
        self.rng = rng
        self.ids = np.arange(requests, dtype=np.int64)
        self.length = rng.integers(DECODE_LEN[0], DECODE_LEN[1] + 1, requests)
        self.pos = np.zeros(requests, np.int64)
        self.next_id = requests
        long = np.flatnonzero(self.length >= min_sampled_len)
        self.sampled = set(self.ids[rng.choice(long, sampled, replace=False)].tolist())

    def per_rank(self, m, world):
        """Slots of ``m`` in-flight requests owned by each rank."""
        owners = owner_of(hash_keys(self.ids), world)
        return np.concatenate([self.rng.choice(np.flatnonzero(owners == r), m, replace=False)
                               for r in range(world)])

    def step(self, active, vocab, act=None):
        """One decode step of ``active`` random in-flight requests (or the
        slots ``act``): a token each, finished requests replaced."""
        if act is None:
            act = self.rng.choice(self.ids.size, min(active, self.ids.size), replace=False)
        n = act.size
        hyp = self.rng.integers(0, vocab, n).astype(np.int32)
        ref = np.where(self.rng.random(n) < 0.7, hyp, self.rng.integers(0, vocab, n)).astype(np.int32)
        lp = (-self.rng.uniform(0.01, 3.0, n)).astype(np.float32)
        rid = self.ids[act].copy()
        self.pos[act] += 1
        done = act[self.pos[act] >= self.length[act]]
        finished = self.ids[done].copy()
        k = done.size
        self.ids[done] = np.arange(self.next_id, self.next_id + k)
        self.next_id += k
        self.length[done] = self.rng.integers(DECODE_LEN[0], DECODE_LEN[1] + 1, k)
        self.pos[done] = 0
        return rid, hyp, ref, lp, finished


def _decode_step(tables, world, rid, hyp, ref, lp, finished):
    """Route each request's row to its owning rank (per-request rank
    affinity: the outboxes stay empty), ingest, retire finished ones."""
    owners = owner_of(hash_keys(rid), world)
    for r in range(world):
        sel = owners == r
        tables[r].ingest(rid[sel], step_tokens=hyp[sel], logprobs=lp[sel], ref_tokens=ref[sel])
    if finished.size:
        fo = owner_of(hash_keys(finished), world)
        for r in range(world):
            if (fo == r).any():
                tables[r].finish(finished[fo == r])


def _feed_oracles(oracles, rid, hyp, ref, lp):
    for i in np.flatnonzero(np.isin(rid, list(oracles))):
        oracles[int(rid[i])]["fed"] = True
        for name, m in oracles[int(rid[i])].items():
            if name == "fed":
                continue
            if name == "logprob":
                m.update(torch.from_numpy(lp[i:i + 1]))
            else:
                m.update(torch.from_numpy(hyp[i:i + 1]), torch.from_numpy(ref[i:i + 1]))


def _check_sampled(tables, oracles, world, what):
    """Every sampled request that has decoded a token: its keyed values on
    its owning rank (rows go to the owner, so its slot holds the whole
    stream) bitwise equal to its standalone metrics. Returns how many were
    held."""
    fed = sorted(rid for rid, o in oracles.items() if o.get("fed"))
    _check(bool(fed), f"{what}: no sampled request decoded a token")
    owners = owner_of(hash_keys(np.asarray(fed, np.int64)), world)
    for r in range(world):
        mine = [rid for rid, o in zip(fed, owners) if o == r]
        if not mine:
            continue
        pv = tables[r].compute()
        hashes = hash_keys(np.asarray(mine, np.int64))
        pos = np.searchsorted(pv.keys, hashes)
        _check(bool(np.all(pv.keys[np.minimum(pos, pv.keys.size - 1)] == hashes)),
               f"{what}: a sampled request is missing from its owner's table")
        for alias, values in pv.values.items():
            got = values[torch.from_numpy(pos).to(values.device)]
            want = []
            for rid in mine:
                v = oracles[rid][alias].compute()
                want.append(v.error_rate if alias == "token_edit" else
                            v.overlap if alias == "ngram" else v)
            want = torch.stack([w.reshape(()) for w in want]).to(got.device)
            _check(torch.equal(got, want), f"{what}: {alias} != the standalone metrics")
    return len(fed)


def _warm_decode(pool, tables, world, active, vocab, oracles):
    """Capture each rank's buckets: one step of every request in flight
    (so the slots reach the capacity the stream keeps: a capture is tied
    to the slot tensors), then steps of exactly ``m`` requests a rank, for
    every bucket a step's share can land in."""
    top = bucket_length(int(1.25 * active / world) + 1)
    sizes = [None] + [1 << b for b in range(3, top.bit_length())]
    for m in sizes:
        act = np.arange(pool.ids.size) if m is None else pool.per_rank(m, world)
        rid, hyp, ref, lp, fin = pool.step(0, vocab, act=act)
        _decode_step(tables, world, rid, hyp, ref, lp, fin)
        _feed_oracles(oracles, rid, hyp, ref, lp)


def _serving_decode(device, requests, active, steps, ngram_steps, sampled, world, restore_world,
                    drain_every, vocab, seed, directory):
    """A ``StreamTable`` over ``requests`` in-flight decode streams (two
    arms: logprob + token_edit, then the same plus ngram), 64 sampled
    requests held bitwise to standalone metrics, an elastic restore
    4 -> 2 midway, captures counted after each world's warm-up."""
    rng = np.random.default_rng(seed)
    members = ("logprob", "token_edit")
    pool = _DecodePool(rng, requests, sampled, min_sampled_len=steps + 2 * 17 + len(DECODE_TAIL) + 1)
    tables = [StreamTable(members=members, shard=ShardContext(r, world), device=device)
              for r in range(world)]
    oracles = {rid: {"logprob": StreamingPerplexity(device=device),
                     "token_edit": StreamingTokenEditStats(device=device)} for rid in pool.sampled}
    out = {"requests": requests, "active": active, "vocab": vocab, "sampled": sampled}
    cap = {"warm": 0, "steady": 0, "steady_steps": []}
    split = dict.fromkeys(("ingest", "oracles", "drains", "checks", "restore"), 0.0)
    half = steps // 2
    cur_world, rows, t_loop = world, 0, 0.0
    checked = {}
    for s in range(steps):
        if s == half:
            t_c = time.perf_counter()
            checked["before_restore"] = _check_sampled(tables, oracles, cur_world, "before the restore")
            split["checks"] += time.perf_counter() - t_c

            def snap(g):
                ElasticSession({"t": tables[g.rank]}, directory, process_group=g,
                               interval=10**9).snapshot()

            t_c = time.perf_counter()
            ThreadWorld(world, timeout=600.0).run(snap)
            tables = [StreamTable(members=members, shard=ShardContext(r, restore_world), device=device)
                      for r in range(restore_world)]
            t_r = time.perf_counter()
            ThreadWorld(restore_world, timeout=600.0).run(
                lambda g: ElasticSession({"t": tables[g.rank]}, directory, process_group=g,
                                         interval=10**9).restore())
            out["restore_seconds"] = time.perf_counter() - t_r
            split["restore"] += time.perf_counter() - t_c
            cur_world = restore_world
        if s in (0, half):
            c0 = _captures()
            _warm_decode(pool, tables, cur_world, active, vocab, oracles)
            cap["warm"] += _captures() - c0
        c0 = _captures()
        rid, hyp, ref, lp, fin = pool.step(active, vocab)
        t1 = time.perf_counter()
        _decode_step(tables, cur_world, rid, hyp, ref, lp, fin)
        t2 = time.perf_counter()
        t_loop += t2 - t1
        rows += rid.size
        _feed_oracles(oracles, rid, hyp, ref, lp)
        t3 = time.perf_counter()
        if (s + 1) % drain_every == 0:
            ThreadWorld(cur_world, timeout=600.0).run(lambda g: toolkit.adopt_synced(tables[g.rank], g))
        split["ingest"] += t2 - t1
        split["oracles"] += t3 - t2
        split["drains"] += time.perf_counter() - t3
        if _captures() != c0:
            cap["steady_steps"].append([s, _captures() - c0])
        cap["steady"] += _captures() - c0
    _sync(device)
    out["logprob_token_edit"] = {"steps": steps, "rows": rows, "rows_per_s": rows / t_loop}
    # the ragged tail: fresh active-set sizes down to an empty step
    c0 = _captures()
    for n in DECODE_TAIL:
        rid, hyp, ref, lp, fin = pool.step(n, vocab)
        _decode_step(tables, cur_world, rid, hyp, ref, lp, fin)
        _feed_oracles(oracles, rid, hyp, ref, lp)
    cap["tail"] = _captures() - c0
    t_c = time.perf_counter()
    checked["after_restore"] = _check_sampled(tables, oracles, cur_world, "after the restore")
    split["checks"] += time.perf_counter() - t_c
    out["captures"] = cap
    out["checked"] = checked
    out["host_split_s"] = split
    if torch.device(device).type == "cuda":
        # a rank's rows a step never exceed the requests in flight
        bound = bucket_bound(requests) * (world + restore_world)
        _check(cap["warm"] <= bound, f"decode captured {cap['warm']} graphs warming, bound {bound}")
        _check(cap["steady"] == 0 and cap["tail"] == 0, f"captures after the warm-up: {cap}")

    # arm 2: the same members plus ngram (n = 4), a fresh pool
    rng = np.random.default_rng(seed + 1)
    members = ("logprob", "token_edit", "ngram")
    pool = _DecodePool(rng, requests, sampled, min_sampled_len=ngram_steps + 1)
    tables = [StreamTable(members=members, n_gram=4, shard=ShardContext(r, world), device=device)
              for r in range(world)]
    mirror_s = [0.0]
    for t in tables:
        observe = t._observe_step

        def timed(*args, _observe=observe):
            t0 = time.perf_counter()
            _observe(*args)
            mirror_s[0] += time.perf_counter() - t0

        t._observe_step = timed
    oracles = {rid: {"logprob": StreamingPerplexity(device=device),
                     "token_edit": StreamingTokenEditStats(device=device),
                     "ngram": StreamingNgramOverlap(n_gram=4, device=device)} for rid in pool.sampled}
    rows, t_loop = 0, 0.0
    for s in range(ngram_steps):
        rid, hyp, ref, lp, fin = pool.step(active, vocab)
        t0 = time.perf_counter()
        _decode_step(tables, world, rid, hyp, ref, lp, fin)
        t_loop += time.perf_counter() - t0
        rows += rid.size
        _feed_oracles(oracles, rid, hyp, ref, lp)
    _sync(device)
    sampled_ids = np.asarray(sorted(oracles), np.int64)
    fo = owner_of(hash_keys(sampled_ids), world)
    for r in range(world):
        tables[r].finish(sampled_ids[fo == r])
    for m in oracles.values():
        m["ngram"].finish()
    checked["ngram"] = _check_sampled(tables, oracles, world, "ngram arm")
    out["logprob_token_edit_ngram"] = {
        "steps": ngram_steps, "rows": rows, "rows_per_s": rows / t_loop,
        "ngram_mirror_host_us_per_step": mirror_s[0] * 1e6 / ngram_steps,
    }
    return out


def phase_serving(device, rows=DLRM_FEATURE_ROWS, batch=CTR_BATCH, batches=SERVING_BATCHES,
                  world=SERVING_WORLD, drain_every=SERVING_DRAIN_EVERY, ncf_users=NCF_USERS,
                  ncf_candidates=NCF_CANDIDATES, ncf_batch=4096, calm_steps=40, spike_steps=48,
                  tail_steps=8, request_rows=512, keyspace=2048, requests=DECODE_REQUESTS,
                  active=DECODE_ACTIVE, decode_steps=DECODE_STEPS, ngram_steps=NGRAM_STEPS,
                  sampled=DECODE_SAMPLED, decode_drain_every=100, vocab=LLAMA3_VOCAB, seed=17):
    """The serving stack on the card (see the module docstring). Cuts:
    the panel runs the first ``SERVING_BATCHES`` of the 1,361 Criteo
    batches, the decode arms ``DECODE_STEPS`` and ``NGRAM_STEPS`` steps;
    no width or key cardinality is cut."""
    t0 = time.perf_counter()
    out = {"phase": "serving", "device": str(device)}
    k1 = _kernels.LAUNCHES["fused_auc_hist"]
    with _quiet_world1_syncs():
        out["panel"] = _serving_panel(device, rows, batch, batches, world, drain_every, seed)
        out["ncf"] = _serving_ncf(device, ncf_users, ncf_candidates, ncf_batch, 10, seed + 1)
        out["admission"] = _serving_admission(device, calm_steps, spike_steps, tail_steps,
                                              request_rows, keyspace, seed + 2)
    with tempfile.TemporaryDirectory() as tmp:
        out["decode"] = _serving_decode(device, requests, active, decode_steps, ngram_steps, sampled,
                                        world, 2, decode_drain_every, vocab, seed + 3, tmp)
    out["k1_launches"] = _kernels.LAUNCHES["fused_auc_hist"] - k1
    _check(out["k1_launches"] == 0, f"the serving phase launched K1 {out['k1_launches']} times")
    out["seconds"] = time.perf_counter() - t0
    return out


# ------------------------------------------------------------------ 18. wan

WAN_WORLD = 4
WAN_REGIONS = (("us", (0, 1)), ("eu", (2, 3)))
WAN_BATCHES = 48  # Criteo batches: cut from 1,361 for the phase budget, as `serving` is
WAN_CLS_ROWS = 256  # ImageNet rows a rank a step: a quarter of phase 1's 1,024
WAN_WINDOW = 1 << 20  # the WindowedBinaryAUROC of phase 12
WAN_WIRE_BATCHES = 64  # arm (a): fills the window (64 x 16,384 = 2^20 a rank)
WAN_PLANE_INTERVAL = 2.0
WAN_BLOCKING_EVERY = 16  # three blocking syncs a rank over the 48 steps, as 25 gave over 96
WAN_FED_ROUNDS = 12  # arm (c): 4 batches a round
WAN_PARTITION_AFTER = 2
WAN_FAIL_STEPS = 20  # arm (d)
# |value at a lossy rung - value at the exact rung| of an AUROC-type value:
# the JAX package's acceptance tolerance for the lossy rungs
WAN_LOSSY_TOL = 5e-3
WAN_BLOCK = 32
WAN_HIST_BINS = SQ_THRESHOLDS  # phase 16's 2^20-threshold HistogramBinnedAUROC


def _wan_panel(device, num_bins, classes, exact=True):
    """A rank's collection: the DLRM panel (K1 under the streaming AUROC
    and AUPRC), an exact ``BinaryAUROC`` and an ImageNet-1k confusion
    matrix (the mostly-static dense state deltas exist for)."""
    panel = _elastic_panel(device, num_bins)
    if not exact:
        del panel["exact"]
    panel["cm"] = MulticlassConfusionMatrix(classes, device=device)
    return panel


def _wan_quarter(device, seed, i, n, batch, world, rank):
    """Rank ``rank``'s quarter of Criteo batch ``i`` (phase 2's stream)."""
    s, y = _elastic_batch(device, seed, i, n, batch)
    q = -(-s.numel() // world)
    return s[rank * q:(rank + 1) * q], y[rank * q:(rank + 1) * q]


def _wan_images(device, seed, i, rank, rows, classes):
    gen = torch.Generator(device=device).manual_seed((seed * 1_000_003 + i) * 8 + rank)
    return _classify_batch(gen, rows, classes, device)


def _wan_feed(panel, device, seed, i, n, batch, world, rank, cls_rows, classes):
    s, y = _wan_quarter(device, seed, i, n, batch, world, rank)
    _elastic_feed(panel, s, y, "exact" in panel)
    x, t = _wan_images(device, seed + 1, i, rank, cls_rows, classes)
    panel["cm"].update(x, t)
    return int(s.numel())


def _np_states(metric):
    """A metric's sync payload as host numpy (a list state concatenated)."""
    return {k: _as_np(v) for k, v in metric._sync_state_dict().items()}


def _as_np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, (list, tuple)):
        return np.concatenate([np.asarray(_as_np(x)).reshape(-1) for x in v]) if v else np.zeros(0)
    return np.asarray(v)


def _wan_value(m):
    v = m.compute()
    return _as_np(v[0] if isinstance(v, tuple) else v).astype(np.float64)


def _wire_bound(rung, rank_states):
    """The stated bound of one merged state at ``rung``: the sum over ranks
    of each rank's codec bound (a sum adds them, a concatenation keeps the
    largest): ``amax(block) / 254`` at int8, ``|x| * 2^-8`` at bf16."""
    total = 0.0
    for a in rank_states:
        a = np.asarray(a, np.float32).reshape(-1)
        a = a[np.isfinite(a)]
        if a.size == 0:
            continue
        if rung == "int8":
            total += wire.int8_error_bound(a, WAN_BLOCK)
        elif rung == "bf16":
            total += float(np.abs(a).max()) * 2.0**-8
    return total


def _wan_wire(device, seed, n, batch, steps, world, num_bins, classes, window):
    """Arm (a): each family at each rung over ``ThreadWorld(world)``, the
    breach fallback, and the bytes each rank sends."""
    tw = ThreadWorld(world, timeout=600.0)
    colls, rank_states = {}, {}
    fams = ("exact", "window", "cat", "auroc", "ctr", "cm")

    def feed(g):
        c = {"exact": BinaryAUROC(device=device),
             "window": WindowedBinaryAUROC(max_num_samples=window, device=device),
             "cat": Cat(device=device),
             "auroc": StreamingBinaryAUROC(num_bins=num_bins, device=device),
             "ctr": ClickThroughRate(device=device),
             "cm": MulticlassConfusionMatrix(classes, device=device)}
        for i in range(steps):
            s, y = _wan_quarter(device, seed, i, n, batch, world, g.rank)
            toolkit.update_collection({"auroc": c["auroc"]}, s, y)
            c["exact"].update(s, y)
            c["window"].update(s, y)
            c["cat"].update(s)
            c["ctr"].update(y)
            x, t = _wan_images(device, seed + 1, i, g.rank, WAN_CLS_ROWS, classes)
            c["cm"].update(x, t)
        colls[g.rank] = c
        rank_states[g.rank] = {k: _np_states(m) for k, m in c.items()}

    tw.run(feed)

    def sync(g):
        synced = toolkit.get_synced_metric_collection(colls[g.rank], g)
        return {k: (_wan_value(m), _np_states(m), m.sync_provenance.wire_tier)
                for k, m in synced.items()}

    out = {"rungs": {}, "bytes": {}}
    results = {}
    for rung in wire.RUNGS:
        with config.wire_ladder_mode(rung):
            t0 = time.perf_counter()
            got = tw.run(sync)
            seconds = time.perf_counter() - t0
        _check(all(got[r].keys() == got[0].keys() for r in range(world)), "ranks synced differently")
        for r in range(1, world):
            for k in fams:
                _check(got[r][k][0].tobytes() == got[0][k][0].tobytes(),
                       f"rank {r} computed {k} differently at {rung}")
        results[rung] = got[0]
        out["rungs"][rung] = {"sync_s": seconds,
                              "wire_tier": {k: got[0][k][2] for k in fams}}
        # the bytes each rank ships of each family at this rung
        per = {}
        for k in fams:
            sent = []
            for r in range(world):
                states = {"m": colls[r][k]._sync_state_dict()}
                order = synclib.metrics_traversal_order(states)
                sent.append(int(synclib._pack_rank_states(states, order, rung)[1].size))
            per[k] = sent
        out["bytes"][rung] = per
    exact = results["exact"]
    errs = {}
    for rung in ("bf16", "int8"):
        res = results[rung]
        errs[rung] = {}
        for k in fams:
            for name, want in exact[k][1].items():
                got_s = res[k][1][name]
                if not isinstance(want, np.ndarray) or not np.issubdtype(want.dtype, np.floating):
                    _check(np.array_equal(np.asarray(got_s), np.asarray(want)),
                           f"integer state {k}.{name} changed at {rung}")
                    continue
                if got_s.shape != want.shape:
                    raise AssertionError(f"{k}.{name} shape {got_s.shape} != {want.shape} at {rung}")
                fin = np.isfinite(want)
                _check(np.array_equal(fin, np.isfinite(got_s)), f"{k}.{name} finiteness at {rung}")
                err = float(np.max(np.abs(got_s[fin].astype(np.float64) - want[fin]), initial=0.0))
                bound = _wire_bound(rung, [rank_states[r][k][name] for r in range(world)])
                slack = 4 * float(np.spacing(np.float32(np.max(np.abs(want[fin]), initial=0.0))))
                _check(err <= bound + slack,
                       f"{k}.{name} at {rung}: error {err} above its bound {bound}")
                errs[rung][f"{k}.{name}"] = [err, bound]
            # counters stay bitwise; values within the stated tolerance
            if k in ("ctr", "cm"):
                _check(res[k][0].tobytes() == exact[k][0].tobytes(), f"{k} changed at {rung}")
            else:
                d = float(np.max(np.abs(res[k][0] - exact[k][0]), initial=0.0))
                _check(d <= WAN_LOSSY_TOL, f"{k} value moved {d} at {rung}")
                errs[rung][f"{k}.value"] = d
        for k in fams:
            # a family rides the rung when a float payload of 1 KiB or more
            # carries it; integer counters and small payloads stay exact
            big = any(isinstance(v, np.ndarray) and np.issubdtype(v.dtype, np.floating)
                      and v.nbytes >= 1024 for v in rank_states[0][k].values())
            want_tier = rung if big else "exact"
            _check(res[k][2] == want_tier, f"{k} rode {res[k][2]} at {rung}, want {want_tier}")
    out["errors"] = errs
    total = {rung: sum(sum(v) for v in out["bytes"][rung].values()) for rung in wire.RUNGS}
    out["int8_reduction"] = total["exact"] / total["int8"]
    out["bf16_reduction"] = total["exact"] / total["bf16"]

    # the measured error budget: two drift breaches of a watched windowed
    # AUROC step its family int8 -> bf16 -> exact, a WireTierEvent each,
    # and the synced provenance of the ranks' windows follows
    watched = WindowedBinaryAUROC(max_num_samples=window, device=device)
    # the windowed plan's arguments are (column, scores, labels, weights)
    watch = quality.watch_inputs(watched, args=(1,), bounds=(0.0, 1.0), num_bins=SKETCH_BINS,
                                 label="wan_wire")
    rec = obs.recorder()
    tiers, events = [], []
    try:
        with config.wire_ladder_mode("*=exact,WindowedBinaryAUROC=int8"), \
                config.observability(slos=[]):
            for i in range(4):
                watched.update(*_elastic_batch(device, seed + 2, i, n, batch))
            watch.freeze_reference()
            watch.add_drift(quality.DriftSpec(min_count=batch))
            for i in range(4, 8):
                s, y = _elastic_batch(device, seed + 2, i, n, batch)
                watched.update(torch.sqrt(s), y)
            for _ in range(2):
                e0 = rec.log.total
                obs.Monitor(cooldown=0.0).check()
                events += [(e.family, e.prev_tier, e.tier) for e in _new_events(rec, e0)
                           if e.kind == "wire_tier"]
                got = tw.run(lambda g: toolkit.get_synced_metric_collection(
                    {"window": colls[g.rank]["window"]}, g)["window"].sync_provenance.wire_tier)
                tiers.append(got[0])
    finally:
        watch.close()
        wire.LADDER.reset()
    _check(events == [("WindowedBinaryAUROC", "int8", "bf16"),
                      ("WindowedBinaryAUROC", "bf16", "exact")], f"wire tier events {events}")
    _check(tiers == ["bf16", "exact"], f"the synced provenance read {tiers}")
    out["fallback"] = {"events": events, "wire_tier": tiers}
    return out


def _quantizer_calls():
    """Wrap ``wire.quantize_blockwise_jit`` so the in-step sync's quantizer
    calls can be counted (the quantizer is plain torch ops, no kernel of
    the port's own)."""
    calls = [0]
    real = wire.quantize_blockwise_jit

    def counted(x, block):
        calls[0] += 1
        return real(x, block)

    return calls, real, counted


def _wan_hist_case(rank, world, device, group, seed, thresholds, n, steps):
    """The in-step int8 sync of phase 16's histogram AUROC over ``group``:
    its int32 counts (exact at every rung) and the same counts as a
    float32 weighted histogram (unit weights), both owner-partitioned and
    reduce-scattered at ``compression="int8"``."""
    m = HistogramBinnedAUROC(threshold=thresholds, device=device)
    for i in range(steps):
        s, y = _elastic_batch(device, seed, i, CRITEO_EVAL, n)
        q = -(-s.numel() // world)
        m.update(s[rank * q:(rank + 1) * q], y[rank * q:(rank + 1) * q])
    hist = m.hist
    states = {"hist": hist, "hist_f": hist.to(torch.float32)}
    specs = {"hist": MergeKind.SUM, "hist_f": MergeKind.SUM}
    shard = {"hist": ShardSpec(0), "hist_f": ShardSpec(0)}
    calls, real, counted = _quantizer_calls()
    sharded.wirelib.quantize_blockwise_jit = counted
    try:
        _sync(device)
        t0 = time.perf_counter()
        synced = sharded.sync_states_in_jit(states, group, specs, compression="int8",
                                            shard_specs=shard)
        _sync(device)
        seconds = time.perf_counter() - t0
    finally:
        sharded.wirelib.quantize_blockwise_jit = real
    exact = sharded.sync_states_in_jit(states, group, specs, shard_specs=shard)
    _check(torch.equal(synced["hist"], exact["hist"]), "the int32 counts changed at int8")
    rows = hist.numel() // world
    # every rank's block for this owner bounds the sum's error; this rank
    # holds its own contribution only, so each is bounded by the largest
    # count any rank could put there: the gathered exact sum
    bound = world * wire.int8_error_bound(exact["hist_f"].cpu().numpy(), WAN_BLOCK)
    err = float((synced["hist_f"].double() - exact["hist_f"].double()).abs().max())
    _check(err <= bound, f"int8 histogram error {err} above {bound}")
    return {"rank": rank, "world": world, "seconds": seconds, "max_abs_err": err, "bound": bound,
            "quantizer_calls": calls[0], "counts_bitwise": True,
            "bytes_exact": int(rows * 4 * world),
            "bytes_int8": int(wire.int8_wire_bytes(rows, WAN_BLOCK) * world)}


def _wan_hist_rank(rank, world, out_dir, seed, thresholds, n, steps):
    """One spawned gloo rank of the in-step int8 sync (CPU tensors)."""
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
                            rank=rank, world_size=world)
    try:
        res = _wan_hist_case(rank, world, torch.device("cpu"), None, seed, thresholds, n, steps)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _wan_in_step(device, seed, thresholds, n, steps, mp):
    """The in-step int8 sync at NCCL world 1 (the card) and gloo world 2
    (two spawned processes), with the quantizer's device time on the
    card."""
    out = {}
    if torch.device(device).type == "cuda":
        _check(not dist.is_initialized(), "torch.distributed is already initialized")
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{launcher.free_port()}",
                                rank=0, world_size=1)
        try:
            out["nccl_world1"] = _wan_hist_case(0, 1, device, dist.group.WORLD, seed, thresholds,
                                                n, steps)
        finally:
            dist.destroy_process_group()
        x = torch.rand(2 * thresholds, device=device)
        out["quantizer"] = {"elements": x.numel(),
                            "device_ms": _time_ms(lambda: wire.quantize_blockwise_jit(x, WAN_BLOCK),
                                                  device, 20)}
    if mp:
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            _spawn_ranks(_wan_hist_rank, 2, (d, seed, thresholds, n, steps), 300)
            got = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False) for r in range(2)]
        out["gloo_world2"] = {"spawn_seconds": time.perf_counter() - t0,
                              "sync_seconds": [g["seconds"] for g in got],
                              "max_abs_err": max(g["max_abs_err"] for g in got),
                              "bound": got[0]["bound"],
                              "quantizer_calls": [g["quantizer_calls"] for g in got]}
    return out


def _pct(values, q):
    return float(np.percentile(np.asarray(values), q)) if values else None


def _wan_covering_version(plane, gen, interval):
    """The first retained merged version whose round took this rank's
    publish ``gen`` (or a later one), waiting for the plane thread."""
    deadline = time.monotonic() + 10 * interval + 60.0
    while True:
        hits = [v for v, rec in plane.retained().items() if rec.generation >= gen]
        if hits:
            return min(hits)
        _check(time.monotonic() < deadline, f"plane: no round took publish {gen}")
        time.sleep(0.05)


def _wan_wait_version(plane, version, interval):
    deadline = time.monotonic() + 10 * interval + 60.0
    while plane.version < version:
        _check(time.monotonic() < deadline, f"plane: version {plane.version} < {version}")
        time.sleep(0.05)


def _wan_plane(device, seed, n, batch, steps, world, num_bins, classes, interval, blocking_every):
    """Arm (b): ``SyncPlane(interval=...)`` over the ranks, a publish a
    step. Three collections a rank, stepped in turn: plane off, plane
    armed, and a blocking sync every ``blocking_every`` steps."""
    cuda = torch.device(device).type == "cuda"
    tw = ThreadWorld(world, timeout=600.0)
    lat = {"off": {}, "armed": {}, "blocking": {}}
    pub_us, pub_bytes, gathers, extra = {}, {}, {}, {}
    checks, covers = {}, {}
    barrier = threading.Barrier(world)

    def body(g):
        colls = {arm: _wan_panel(device, num_bins, classes) for arm in lat}
        counting = _CountingGroup(g)
        plane = SyncPlane(colls["armed"], counting, interval=interval, policy="raise")
        for arm in lat:
            lat[arm][g.rank] = []
        pub_us[g.rank] = []
        try:
            for i in range(steps):
                order = ("off", "armed", "blocking") if i % 2 == 0 else ("blocking", "armed", "off")
                for arm in order:
                    t0 = time.perf_counter()
                    _wan_feed(colls[arm], device, seed, i, n, batch, world, g.rank, WAN_CLS_ROWS,
                              classes)
                    if arm == "armed":
                        tp = time.perf_counter()
                        plane.publish()
                        pub_us[g.rank].append((time.perf_counter() - tp) * 1e6)
                    if arm == "blocking" and (i + 1) % blocking_every == 0:
                        toolkit.sync_and_compute_collection(colls[arm], g)
                    lat[arm][g.rank].append((time.perf_counter() - t0) * 1e6)
            gathers[g.rank] = counting.object_gathers + counting.array_gathers
            stale = plane.staleness()
            rounds = plane.rounds
            # the oracle: one more publish, frozen copies of what it holds,
            # and a round that covers it (the thread may run it, or this)
            frozen = {k: toolkit.clone_metric(m) for k, m in colls["armed"].items()}
            gen = plane.publish()
            barrier.wait()
            # a round merges each rank's publish as that rank's plane
            # thread found it when the round began, so the round that took
            # this rank's last publish may still hold an older one of a
            # peer's: read only at a version that took every rank's
            covers[g.rank] = _wan_covering_version(plane, gen, interval)
            barrier.wait()
            _wan_wait_version(plane, max(covers.values()), interval)
            read = plane.read()
            oracle = toolkit.get_synced_metric_collection(frozen, g)
            same = all(_wan_value(read[k]).tobytes() == _wan_value(oracle[k]).tobytes()
                       and _same_panel({k: read[k]}, {k: oracle[k]}) for k in frozen)
            version = read["ne"].sync_provenance.version
            colls["armed"]["ctr"].reset()
            cold = plane.read(["ctr"])["ctr"].sync_provenance.version
            checks[g.rank] = (same, version, cold, read["ne"].sync_provenance.ranks)
            extra[g.rank] = {"rounds": rounds, "rounds_behind": stale["rounds_behind"],
                             "round_errors": plane.round_errors}
            pub_bytes[g.rank] = sum(_payload_bytes(m._sync_state_dict())
                                    for m in colls["armed"].values())
        finally:
            plane.close()

    tw.run(body)
    for r in range(world):
        same, version, cold, ranks = checks[r]
        _check(same, f"rank {r}: the plane read at version {version} != the blocking sync")
        _check(version >= 1 and tuple(ranks) == tuple(range(world)), f"rank {r} read {version}")
        _check(cold == 0, f"rank {r}: a read after reset() served version {cold}")
        _check(gathers[r] == 0, f"rank {r}: {gathers[r]} gathers on the serving group")
        _check(extra[r]["round_errors"] == 0, f"rank {r}: plane rounds failed")
    # no host sync inside publish, and its device time (one rank's plane
    # over the same collection, on this thread)
    solo = _wan_panel(device, num_bins, classes)
    _wan_feed(solo, device, seed, 0, n, batch, world, 0, WAN_CLS_ROWS, classes)
    publish_device_ms = None
    with SyncPlane(solo) as p:
        p.publish()
        with _no_host_sync(cuda):
            p.publish()
        if cuda:
            publish_device_ms = _time_ms(p.publish, device, 10)
        t0 = time.perf_counter()
        p.run_round()
        world1_round_s = time.perf_counter() - t0
    out = {
        "steps": steps, "interval_s": interval, "blocking_every": blocking_every,
        "host_us": {arm: {"p50": _pct(sum(v.values(), []), 50), "p99": _pct(sum(v.values(), []), 99)}
                    for arm, v in lat.items()},
        "publish_host_us": {"p50": _pct(sum(pub_us.values(), []), 50),
                            "p99": _pct(sum(pub_us.values(), []), 99)},
        "publish_device_ms": publish_device_ms, "publish_bytes": pub_bytes[0],
        "rounds": [extra[r]["rounds"] for r in range(world)],
        "rounds_behind": [extra[r]["rounds_behind"] for r in range(world)],
        "world1_round_s": world1_round_s,
        "serving_gathers": [gathers[r] for r in range(world)],
        "read_bitwise_to_blocking": True,
    }
    off = out["host_us"]["off"]["p99"]
    out["armed_over_off_p99"] = out["host_us"]["armed"]["p99"] / off if off else None
    out["blocking_over_off_p99"] = out["host_us"]["blocking"]["p99"] / off if off else None
    return out


def _wan_federation(device, seed, n, batch, steps, world, num_bins, classes, rounds,
                    partition_after):
    """Arm (c): two regions over a chaos-wrapped ``InProcessLinkBus``:
    healthy rounds, ``eu`` dark for ``partition_after + 2`` rounds, a heal
    and settling rounds; the merged result against a flat sync of the same
    stream."""
    import torcheval_tpu_torch.federation as fedmod
    from torcheval_tpu_torch.federation import Federation, InProcessLinkBus

    tw = ThreadWorld(world, timeout=600.0)
    panels = {r: _wan_panel(device, num_bins, classes) for r in range(world)}
    captured = []

    class Tap(InProcessLinkBus):
        def post(self, src, dst, blob):
            if not captured and src == "us" and pickle.loads(blob).get("kind") in ("full", "delta"):
                captured.append(blob)
            super().post(src, dst, blob)

    chaos = ChaosLinkTransport(Tap())
    feds = {}
    dark_from, heal_at = 2, 2 + partition_after + 2
    settle = 3
    total = rounds + settle
    per_round = -(-steps // rounds)
    provs, fed_ms, bare_ms, health = {}, [], [], {}
    cm_delta = {}
    tw.run(lambda g: feds.__setitem__(g.rank, Federation(
        g, WAN_REGIONS, transport=chaos, partition_after=partition_after)))
    merged = {}
    step = 0
    for rnd in range(total):
        if rnd == dark_from:
            chaos.partition_both("us", "eu")
        if rnd == heal_at:
            chaos.heal_both("us", "eu")
        if rnd < rounds:
            for _ in range(per_round):
                if step < steps:
                    for r in range(world):
                        _wan_feed(panels[r], device, seed, step, n, batch, world, r, WAN_CLS_ROWS,
                                  classes)
                    step += 1
        if rnd == heal_at + 1 and captured:
            # a re-delivered pre-partition epoch: the ledger discards it
            chaos._inner.post("us", "eu", captured[0])

        def body(g):
            fed = feds[g.rank]
            for name, ranks in WAN_REGIONS:
                if g.rank in ranks:
                    t0 = time.perf_counter()
                    merged[g.rank] = fed.federate(panels[g.rank])
                    if g.rank == ranks[0]:
                        _sync(device)
                        fed_ms.append((time.perf_counter() - t0) * 1e3)
                g.allgather_object(None)  # the regions take turns
            provs[(g.rank, rnd)] = fed.last_provenance
            if rnd == total - 1:
                _sync(device)
                t0 = time.perf_counter()
                toolkit.get_synced_metric_collection(panels[g.rank], fed.region_group)
                _sync(device)
                bare_ms.append((time.perf_counter() - t0) * 1e3)

        tw.run(body)
        if rnd == heal_at - 1:
            with fedmod._CURRENT_LOCK:
                fedmod._CURRENT = feds[0]
            health["dark"] = healthz_payload()
        if rnd in (0, 1):
            # the confusion matrix alone: as the wire packs it (sparse while
            # mostly zero) and as its raw int64 bytes
            cm = merged[0]["cm"]
            states = {"cm": cm._sync_state_dict()}
            order = synclib.metrics_traversal_order(states)
            cm_delta[rnd] = (synclib._pack_rank_states(states, order, "exact")[1],
                             _as_np(cm.confusion_matrix).view(np.uint8).reshape(-1))
    with fedmod._CURRENT_LOCK:
        fedmod._CURRENT = feds[0]
    health["healed"] = healthz_payload()
    # the quorum read while dark
    mid = provs[(0, heal_at - 1)]
    _check(mid.degraded and mid.merged_regions == ("us",), f"dark-round provenance {mid}")
    eu = next(s for s in mid.regions if s.name == "eu")
    _check(eu.dark and eu.staleness_epochs > partition_after, f"eu while dark: {eu}")
    _check(health["dark"]["status"] == "stale-region" and not health["dark"]["healthy"],
           f"/healthz read {health['dark']['status']} while eu was dark")
    _check(health["healed"]["status"] == "ok", f"/healthz read {health['healed']['status']} healed")
    last = provs[(0, total - 1)]
    _check(not last.degraded, "the healed read is still degraded")
    dup = feds[2].link_health("us").duplicates
    _check(dup >= 1, "the re-delivered epoch was not discarded")
    # after the heal every rank holds the same merge, equal to the flat
    # sync of the stream: bitwise where no float sum is reordered, and
    # float sums bitwise to the same merge in region order
    flat = tw.run(lambda g: toolkit.get_synced_metric_collection(panels[g.rank], g))[0]
    regional = []
    for _, ranks in WAN_REGIONS:
        m = _clone_panel(panels[ranks[0]])
        for k, v in m.items():
            v.merge_state([panels[r][k] for r in ranks[1:]])
        regional.append(m)
    tree = _merged(regional)
    reordered = {}
    for r in range(world):
        got = merged[r]
        for k in flat:
            sa, sf, st = got[k]._sync_state_dict(), flat[k]._sync_state_dict(), tree[k]._sync_state_dict()
            for name in sf:
                _check(_same_state(sa[name], st[name]), f"rank {r} {k}.{name} != region-order merge")
                if _same_state(sa[name], sf[name]):
                    continue
                # only a float sum of non-integers may differ: the two-level
                # fold adds in another order than the flat one
                a, b = _as_np(sa[name]), _as_np(sf[name])
                fin = np.isfinite(b)
                _check(np.issubdtype(b.dtype, np.floating) and not np.array_equal(b[fin], np.round(b[fin])),
                       f"rank {r} {k}.{name} != the flat sync")
                a, b = a[fin].astype(np.float64), b[fin].astype(np.float64)
                reordered[f"{k}.{name}"] = max(reordered.get(f"{k}.{name}", 0.0), float(
                    np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30), initial=0.0)))
    full, raw = cm_delta[1]
    delta = fedmod.encode_delta(cm_delta[0][0], full)
    raw_delta = fedmod.encode_delta(cm_delta[0][1], raw)
    h = feds[0].link_health("eu")
    out = {
        "rounds": total, "dark_rounds": heal_at - dark_from, "partition_after": partition_after,
        "dark_provenance": {"merged_regions": list(mid.merged_regions),
                            "eu_staleness": eu.staleness_epochs},
        "healthz_dark": health["dark"]["status"], "duplicates_discarded": dup,
        "float_sums_rel_to_flat": reordered,
        "cm_full_bytes": int(full.size),
        "cm_delta_bytes": None if delta is None else int(delta["idx"].nbytes + delta["words"].nbytes),
        "cm_raw_bytes": int(raw.size),
        "cm_raw_delta_bytes": (None if raw_delta is None
                               else int(raw_delta["idx"].nbytes + raw_delta["words"].nbytes)),
        "link": h.as_dict(),
        "federate_ms": {"p50": _pct(fed_ms, 50), "max": max(fed_ms)},
        "region_sync_ms": {"p50": _pct(bare_ms, 50)},
    }
    for fed in feds.values():
        fed.close()
    return out


def _table_values(table):
    """``{key hash: value}`` of a table's keys (``as_dict`` would key by the
    original keys only as far as the table's capped repr map reaches)."""
    res = table.compute()
    return dict(zip(np.asarray(res.keys).tolist(), _as_np(res.values).tolist()))


def _wan_table(device, rank, world):
    return MetricTable("ctr", shard=ShardContext(rank, world), device=device)


def _wan_restore(tables_of, directory, group, device):
    """Fresh tables of ``group``'s world restored from the newest
    generation in ``directory``: the on-disk world-change oracle."""
    fresh = _wan_table(device, group.rank, group.world_size)
    sess = ElasticSession({"t": fresh}, directory, process_group=group, interval=10**9)
    _check(sess.restore() is not None, "no generation to restore")
    sess.close()
    return fresh


def _wan_failover(device, seed, n, batch, steps, world, num_bins, classes, rows, directory):
    """Arm (d): a ``FailureDomain`` on every rank over ``KillGroup``, with
    a sync plane and a federation riding it, a keyed CTR table (one DLRM
    categorical feature, phase 17's ids) as the partitioned state, and
    three kills, each followed by recovery and a live rejoin."""
    from torcheval_tpu_torch.failover import FailureDomain
    from torcheval_tpu_torch.federation import Federation, InProcessLinkBus
    import torcheval_tpu_torch.failover as fomod

    # visits: plane-round one a step; drain-commit at DRAIN; federation-
    # exchange at FED. Kill 1 lands on the generation of step 3, before
    # step 4 ingests; kill 2 five batches (steps 7-11) past the generation
    # of step 6; kill 3 at the eu leader's exchange of step 15
    drain_steps, fed_steps, snap_steps = (3, 6, 11, 13), (5, 10, 15, 18), (3, 6, 13)
    kills = [KillSpec("plane-round", at=4, rank=3), KillSpec("drain-commit", at=2, rank=3),
             KillSpec("federation-exchange", at=2, rank=2)]
    schedule = KillSchedule(kills, world=world, timeout=300.0)
    tw = ThreadWorld(world, timeout=600.0)
    bus = InProcessLinkBus()
    tables = {r: _wan_table(device, r, world) for r in range(world)}
    panels = {r: _wan_panel(device, num_bins, classes, exact=False) for r in range(world)}
    bucketed = {r: _classify_panel(device, classes) for r in range(world)}
    doms, sessions, counting, rg = {}, {}, {}, {}
    rec = {"recover_s": [], "rejoin_s": [], "poll_gathers": [], "survivors": {}, "health": {},
           "resume": {}}
    lock = threading.Lock()
    bar = threading.Barrier(world)
    resume_dir = os.path.join(directory, "resume")
    os.makedirs(resume_dir, exist_ok=True)
    fed_dir = os.path.join(directory, "fed")
    os.makedirs(fed_dir, exist_ok=True)

    def setup(g):
        counting[g.rank] = _CountingGroup(g)
        rg[g.rank] = ResilientGroup(KillGroup(counting[g.rank], schedule), timeout=60.0,
                                    retries=0, policy="quorum", quorum=0.5)
        sessions[g.rank] = ElasticSession({"t": tables[g.rank]}, fed_dir, process_group=rg[g.rank],
                                          interval=10**9, fault_hook=schedule.fault_hook)
        plane = SyncPlane(panels[g.rank], rg[g.rank], policy="quorum", quorum=0.5)
        fed = Federation(rg[g.rank], WAN_REGIONS, transport=bus, policy="quorum", quorum=0.5)
        doms[g.rank] = FailureDomain({"t": tables[g.rank]}, rg[g.rank], session=sessions[g.rank],
                                     plane=plane, federation=fed, detect_after=2)

    tw.run(setup)

    def recover(g, killed):
        """The recovery epoch and the live rejoin, inside the step that
        saw the kill (``killed``: this rank is the victim)."""
        dom = doms[g.rank]
        k = len(schedule.killed) - 1
        if not killed:
            for _ in range(2):  # quorum syncs feed the missing streak
                toolkit.sync_and_compute(tables[g.rank], rg[g.rank])
            before = counting[g.rank].object_gathers + counting[g.rank].array_gathers
            dead = dom.poll()
            rec["poll_gathers"].append(counting[g.rank].object_gathers
                                       + counting[g.rank].array_gathers - before)
            t0 = time.perf_counter()
            loss = dom.recover()
            rec["recover_s"].append(time.perf_counter() - t0)
            fed = dom.federation
            leaders = (fed.my_region.name, fed.is_leader, tuple(fed.my_region.ranks))
            mine = _table_values(tables[g.rank])
            if k == 0:
                # bitwise the on-disk world-change restore of the same
                # generation; then a world-3 snapshot the rejoin is held to
                oracle = _wan_restore(tables, fed_dir, dom.group, device)
                same = _table_values(oracle) == mine
                sess3 = ElasticSession({"t": tables[g.rank]}, resume_dir, process_group=dom.group,
                                       interval=10**9)
                sess3.snapshot()
                sess3.close()
            else:
                same = None
            synced = dom.drain()["t"]
            with lock:
                rec["survivors"].setdefault(k, {})[g.rank] = (
                    dead, loss, leaders, same, _table_values(synced),
                    synced.sync_provenance.loss)
            if g.rank == 0:
                with fomod._CURRENT_LOCK:
                    fomod._CURRENT = dom
                rec["health"][k] = healthz_payload()
                schedule.revive(dead[0])
        bar.wait(300.0)
        t0 = time.perf_counter()
        if killed:
            dom.rejoin(dead_ranks=(g.rank,))
        else:
            dom.rejoin()
        rec["rejoin_s"].append(time.perf_counter() - t0)
        bar.wait(300.0)
        if k == 0:
            resumed = _wan_restore(tables, resume_dir, rg[g.rank], device)
            with lock:
                rec["resume"][g.rank] = (
                    _table_values(resumed) == _table_values(tables[g.rank]))

    def guarded(g, fn):
        try:
            fn()
        except InjectedCrash:
            recover(g, True)
            return
        if schedule.dead_ranks():
            recover(g, False)

    poll_us, plain_us, panel_caps = [], [], []
    for step in range(steps):
        def pre(g):
            dom = doms[g.rank]

            def work():
                dom.plane.publish()
                schedule.check("plane-round", g.rank)
                if not schedule.dead_ranks():
                    dom.plane.run_round()

            guarded(g, work)

        tw.run(pre)
        # this thread: every rank's ingest (the table's graphed ingest and
        # the bucketed ImageNet panel capture one thread at a time), the
        # DLRM panel on K1, and the poll's host cost
        ids, s, y = _serving_batch(device, seed, step, batch, rows)
        keys = ids.cpu().numpy()
        q = -(-batch // world)
        for r in range(world):
            sl = slice(r * q, min((r + 1) * q, batch))
            t0 = time.perf_counter()
            tables[r].ingest(keys[sl], y[sl])
            t1 = time.perf_counter()
            doms[r].poll()
            t2 = time.perf_counter()
            plain_us.append((t1 - t0) * 1e6)
            poll_us.append((t2 - t0) * 1e6)
            _elastic_feed(panels[r], s[sl], y[sl], False)
            x, t = _wan_images(device, seed + 1, step, r, WAN_CLS_ROWS, classes)
            c0 = _captures()
            with config.shape_bucketing():
                toolkit.update_collection(bucketed[r], x, t)
            if step > 0:
                panel_caps.append(_captures() - c0)

        def post(g):
            dom, sess = doms[g.rank], sessions[g.rank]

            def work():
                sess.step_done()
                if step in drain_steps:
                    schedule.check("drain-commit", g.rank)
                    if schedule.dead_ranks():
                        return
                    dom.drain()
                if step in fed_steps:
                    schedule.check("federation-exchange", g.rank)
                    if schedule.dead_ranks():
                        return
                    dom.federation.federate(panels[g.rank])
                if step in snap_steps:
                    sess.snapshot()

            guarded(g, work)

        tw.run(post)
    for dom in doms.values():
        dom.plane.close()
        dom.federation.close()
        dom.close()
    for sess in sessions.values():
        sess.close()
    return rec, {"poll_us": poll_us, "plain_us": plain_us, "panel_caps": panel_caps}


def _wan_failover_checks(device, seed, batch, world, rows, rec, host):
    """The failover arm's enforced checks (module docstring) and record."""
    q = -(-batch // world)
    surv = rec["survivors"]
    _check(sorted(surv) == [0, 1, 2], f"recoveries {sorted(surv)}")
    victims = {0: 3, 1: 3, 2: 2}
    losses = {}
    for k, by_rank in surv.items():
        _check(sorted(by_rank) == [r for r in range(world) if r != victims[k]],
               f"kill {k}: survivors {sorted(by_rank)}")
        for r, (dead, loss, leaders, same, _, prov_loss) in by_rank.items():
            _check(dead == (victims[k],), f"kill {k}: rank {r} detected {dead}")
            _check(prov_loss == loss, f"kill {k}: rank {r}'s provenance lost its LossBound")
        first = by_rank[min(by_rank)][1]
        _check(all(v[1] == first for v in by_rank.values()), f"kill {k}: the bounds differ")
        losses[k] = first
        h = rec["health"][k]
        _check(h["status"] == "degraded-world" and h["healthy"],
               f"kill {k}: /healthz read {h['status']}")
    _check(losses[0].exact, f"the boundary kill's bound {losses[0]} is not exact")
    _check(all(v[3] for v in surv[0].values()),
           "the survivors' states != the on-disk world-change restore")
    _check(losses[1].steps == 5 and losses[1].epochs == 0 and losses[1].generation >= 0,
           f"the second kill's bound {losses[1]}")
    lost_samples = losses[1].steps * q
    # the survivors' drained values after kill 2: the stream through step
    # 11 without the victim's batches since its generation (steps 7-11)
    oracle = MetricTable("ctr", device=device)
    for step in range(12):
        ids, _, y = _serving_batch(device, seed, step, batch, rows)
        keys = ids.cpu().numpy()
        for r in range(world):
            if r == victims[1] and step >= 7:
                continue
            sl = slice(r * q, min((r + 1) * q, batch))
            oracle.ingest(keys[sl], y[sl])
    toolkit.adopt_synced(oracle)
    want = _table_values(oracle)
    for r, v in surv[1].items():
        _check(v[4] == want, f"rank {r}'s values after kill 2 != the stream without the lost batches")
    leaders = {r: v[2] for r, v in surv[2].items()}
    _check(leaders[3] == ("eu", True, (3,)) and leaders[0] == ("us", True, (0, 1)),
           f"federation leadership after the eu leader's loss: {leaders}")
    _check(sorted(rec["resume"]) == list(range(world)) and all(rec["resume"].values()),
           "the rejoin != the on-disk world-change resume")
    _check(all(g == 0 for g in rec["poll_gathers"]), f"detection issued {rec['poll_gathers']} gathers")
    _check(all(c == 0 for c in host["panel_caps"]),
           f"the bucketed panel captured {sum(host['panel_caps'])} graphs after its warm-up")
    return {
        "kills": [{"victim": victims[k], "loss": {"ranks": list(losses[k].ranks),
                                                  "steps": losses[k].steps,
                                                  "epochs": losses[k].epochs,
                                                  "generation": losses[k].generation,
                                                  "exact": losses[k].exact}} for k in sorted(losses)],
        "kill2_lost_samples": lost_samples,
        "eu_leader_after_kill3": 3,
        "recover_s": rec["recover_s"], "rejoin_s": rec["rejoin_s"],
        "poll_gathers": sum(rec["poll_gathers"]),
        "panel_captures_after_warmup": sum(host["panel_caps"]),
        "poll_over_plain_p99": _pct(host["poll_us"], 99) / _pct(host["plain_us"], 99),
        "poll_us_p99": _pct(host["poll_us"], 99), "plain_us_p99": _pct(host["plain_us"], 99),
    }


def phase_wan(device, n=CRITEO_EVAL, batch=CTR_BATCH, batches=WAN_BATCHES, world=WAN_WORLD,
              num_bins=NUM_BINS, classes=1000, window=WAN_WINDOW, wire_batches=WAN_WIRE_BATCHES,
              interval=WAN_PLANE_INTERVAL, blocking_every=WAN_BLOCKING_EVERY,
              fed_rounds=WAN_FED_ROUNDS, partition_after=WAN_PARTITION_AFTER,
              fail_steps=WAN_FAIL_STEPS, rows=DLRM_FEATURE_ROWS, hist_bins=WAN_HIST_BINS,
              hist_steps=4, mp=True, seed=18):
    """The wire ladder, the sync plane, the federation and failover on the
    card (see the module docstring). Cuts: the plane and federation arms
    run the first ``WAN_BATCHES`` of the 1,361 Criteo batches, the wire
    arm ``WAN_WIRE_BATCHES``, the failover arm ``WAN_FAIL_STEPS``; no
    width is cut."""
    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    out = {"phase": "wan", "device": str(device)}
    k1_total = _kernels.LAUNCHES["fused_auc_hist"]
    launches = {}

    def arm(name, fn, streaming):
        k1 = _kernels.LAUNCHES["fused_auc_hist"]
        res = fn()
        launches[name] = _kernels.LAUNCHES["fused_auc_hist"] - k1
        if cuda:
            _check(launches[name] == streaming,
                   f"{name}: K1 launched {launches[name]} times for {streaming} streaming updates")
        return res

    with _quiet_world1_syncs():
        out["wire"] = arm("wire", lambda: _wan_wire(device, seed, n, batch, wire_batches, world,
                                                    num_bins, classes, window),
                          world * wire_batches)
        out["wire"]["in_step"] = _wan_in_step(device, seed + 4, hist_bins, batch, hist_steps, mp)
        # three collections a rank, two streaming metrics each, and the
        # solo publish check's one update
        out["plane"] = arm("plane", lambda: _wan_plane(device, seed, n, batch, batches, world,
                                                       num_bins, classes, interval, blocking_every),
                           2 * (3 * world * batches + 1))
        out["federation"] = arm("federation", lambda: _wan_federation(
            device, seed, n, batch, batches, world, num_bins, classes, fed_rounds, partition_after),
            2 * world * batches)
        with tempfile.TemporaryDirectory() as tmp:
            rec, host = arm("failover", lambda: _wan_failover(
                device, seed + 5, n, batch, fail_steps, world, num_bins, classes, rows, tmp),
                2 * world * fail_steps)
        out["failover"] = _wan_failover_checks(device, seed + 5, batch, world, rows, rec, host)
    out["k1_launches"] = _kernels.LAUNCHES["fused_auc_hist"] - k1_total
    out["k1_launches_by_arm"] = launches
    out["seconds"] = time.perf_counter() - t0
    return out


LLAMA3_8B = {  # Meta-Llama-3-8B config.json: hidden_size, attention heads, intermediate_size, layers
    "vocab_size": LLAMA3_VOCAB, "d_model": 4096, "n_heads": 32, "d_ff": 14_336,
    "max_len": LLAMA3_CONTEXT, "n_layers": 32,
}
LLAMA3_WIDTH_PARAMS = 6_990_340_096  # this repo's architecture at those widths (GELU MLP: 2 matrices)
LLAMA3_WIDTH_FLOPS = 140_548_509_794_304  # one (1, 8,192) forward: matmuls + dense attention
BF16_U = 2.0 ** -8  # bfloat16 unit roundoff (8 bits of precision)
MODEL_STEPS = 5  # timed eval steps of leg (a), after one warm-up step
LONG_CONTEXT_LAYERS = 4  # leg (b): **cut** from 32 (ring blocks on eight threads of one card)
SWITCH_BASE_8 = {"d_model": 768, "d_ff": 3072, "experts": 8}  # google/switch-base-8 config.json
MOE_TOKENS = 2048  # tokens a shard of leg (c)
MOE_CAPACITY = 320  # 2,048 / 8 experts x capacity factor 1.25
MOE_SKEW = 0.15  # a shared offset of the token vectors: uneven expert loads, so tokens drop
PIPE_STAGES, PIPE_BLOCKS, PIPE_MICRO, PIPE_LEN = 4, 2, 8, 1024
LONG_TOL = 2e-4  # tests/parallel/test_long_context.py
LONG_PPL_RTOL = 1e-4
MOE_TOL = 1e-5  # tests/parallel/test_moe.py
PIPE_TOL = 1e-6  # tests/parallel/test_pipeline.py
MODEL_RANK_TIMEOUT = 120.0  # seconds a rank thread waits on its peers before failing


def _lm_params(vocab_size, d_model, n_heads, d_ff, max_len, n_layers):
    """Parameters of ``TransformerLM``: two embeddings, per block two
    LayerNorms, four d x d attention kernels and the two MLP matrices, a
    final LayerNorm and the head."""
    block = 4 * d_model + 4 * d_model * d_model + 2 * d_model * d_ff
    return (vocab_size + max_len) * d_model + n_layers * block + 2 * d_model + d_model * vocab_size


def _lm_flops(vocab_size, d_model, n_heads, d_ff, max_len, n_layers, seq, batch=1):
    """Analytic FLOPs of one forward: every matmul (2 m n k: q, k, v, out,
    the MLP's two, the head) and dense attention (QK^T and PV over the full
    S x S, 4 S^2 d a layer; the causal mask saves none)."""
    tokens = batch * seq
    matmul = 2 * tokens * (n_layers * (4 * d_model ** 2 + 2 * d_model * d_ff) + d_model * vocab_size)
    return matmul + n_layers * 4 * batch * seq * seq * d_model


def _bf16_log_ppl_bound(n_layers, logits_absmax, nll_mean):
    """How far the bfloat16 forward's log-perplexity may sit from the
    float32 forward of the same weights, to first order: the longest path
    rounds each activation R = 14 L + 4 times to bf16 (per block the two
    LayerNorms, q/k/v, the scaled query, scores, the mask, softmax, PV,
    out, two residual adds, the MLP's two matmuls and GELU; then the final
    LayerNorm, head and log-softmax), each at most ``u`` relative,
    compounding as a random walk: the logits move by at most
    sqrt(R) u max|z|, and a token's NLL by at most twice that. The window's
    NLL sum is itself rounded to bf16 once more (u relative)."""
    r = 14 * n_layers + 4
    return 2.0 * math.sqrt(r) * BF16_U * logits_absmax + BF16_U * nll_mean


class _Clock:
    """CUDA events on the card, a synchronized host clock on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.device = device
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def ms(self, i, j):
        if self.cuda:
            return self.marks[i].elapsed_time(self.marks[j])
        return (self.marks[j] - self.marks[i]) * 1e3


def _wall_ms(fn, device):
    _sync(device)
    t0 = time.perf_counter()
    res = fn()
    _sync(device)
    return res, (time.perf_counter() - t0) * 1e3


def _max_err(got, want):
    return float((got.to(torch.float64) - want.to(torch.float64)).abs().max())


def _within(got, want, tol):
    """``assert_allclose(atol=tol, rtol=tol)``: |a - b| <= tol + tol |b|."""
    return bool(((got - want).abs() <= tol + tol * want.abs()).all())


def _model_window(gen, vocab, window, device):
    tokens = torch.randint(0, vocab, (1, window + 1), generator=gen, device=device)
    return tokens[:, :-1], tokens[:, 1:]


def _model_eval(device, gen, widths, window, steps):
    """Leg (a): ``TransformerLM`` in bfloat16, one warm-up step under
    ``FlopCounter`` and ``steps`` timed steps, each a forward over a fresh
    window and the three metric updates on its logits."""
    vocab = widths["vocab_size"]
    model = TransformerLM(**widths, device=device, dtype=torch.bfloat16)
    init_params(model, gen)
    n_params = sum(p.numel() for p in model.parameters())
    _check(n_params == _lm_params(**widths), f"eval_step: {n_params} parameters")
    ppl = Perplexity(device=device)
    acc = MulticlassAccuracy(device=device)
    sums = {"sum_log_probs": torch.zeros((), device=device),
            "num_total": torch.zeros((), device=device)}

    def metrics(logits, targets):
        counters = perplexity_counters(logits, targets)
        for k in sums:
            sums[k] = sums[k] + counters[k]
        ppl.update(logits, targets)
        acc.update(logits.reshape(-1, vocab), targets.reshape(-1))

    _reset_peak(device)
    fc = FlopCounter(model)
    inputs, targets = _model_window(gen, vocab, window, device)
    logits = fc.run(inputs)
    metrics(logits, targets)
    flops = fc.flop_counts[""]
    _check(flops == _lm_flops(**widths, seq=window),
           f"eval_step: FlopCounter reads {flops} FLOPs, not {_lm_flops(**widths, seq=window)}")
    _check(len({fc.flop_counts[f"Block_{i}"] for i in range(widths["n_layers"])}) == 1,
           "eval_step: the blocks' FLOPs differ")
    forward_ms, metric_ms, step_ms = [], [], []
    for _ in range(steps):
        del logits
        inputs, targets = _model_window(gen, vocab, window, device)
        clock = _Clock(device)
        clock.mark()
        logits = model(inputs)
        clock.mark()
        metrics(logits, targets)
        clock.mark()
        _sync(device)
        forward_ms.append(clock.ms(0, 1))
        metric_ms.append(clock.ms(1, 2))
        step_ms.append(clock.ms(0, 2))
    peak = _stream_peak(device)
    total = (steps + 1) * window
    _check(torch.equal(ppl.sum_log_probs, sums["sum_log_probs"]),
           "eval_step: perplexity counters differ from Perplexity's state")
    _check(int(ppl.num_total) == total and float(sums["num_total"]) == total,
           f"eval_step: token count {int(ppl.num_total)}, {float(sums['num_total'])} != {total}")
    cuda = torch.device(device).type == "cuda"
    fwd = _median(forward_ms)
    profiles = {}
    if cuda:  # where the step's device time goes, on fresh metrics
        profiles["forward"] = _profile(lambda: model(inputs), device,
                                       ops=("aten::mm", "aten::bmm", "aten::where", "aten::softmax"))
        profiles["forward"]["busy_share"] = profiles["forward"]["device_ms"] / fwd
        profiles["metrics"] = _profile(lambda: (
            perplexity_counters(logits, targets),
            Perplexity(device=device).update(logits, targets),
            MulticlassAccuracy(device=device).update(logits.reshape(-1, vocab),
                                                     targets.reshape(-1))), device)
    out = {
        "widths": widths, "dtype": "bfloat16", "parameters": n_params,
        "parameter_bytes": 2 * n_params, "window": window, "steps": steps,
        "flops_forward": flops, "flops_analytic": _lm_flops(**widths, seq=window),
        "forward_ms": forward_ms, "forward_ms_median": fwd,
        "metric_update_ms": metric_ms, "metric_update_ms_median": _median(metric_ms),
        "step_ms_median": _median(step_ms),
        "bridge_share": _median(metric_ms) / _median(step_ms),
        "tokens_per_s": window / (_median(step_ms) / 1e3),
        "tflops_per_s": flops / (fwd / 1e3) / 1e12 if cuda else None,
        "perplexity": float(ppl.compute()), "accuracy": float(acc.compute()),
        "peak_bytes": peak, "profile": profiles,
    }
    # the last window, kept for the float32 check
    last = (inputs, targets, logits.argmax(dim=-1),
            float(_perplexity_update_jit(logits, targets, None)[0]))
    return model, out, last


def _model_tools(device, model, inputs, widths):
    """Leg (e): ``get_module_summary`` of leg (a)'s bf16 model on its last
    window, FLOPs and timing, and ``count_flops_backward`` on fakes."""
    _reset_peak(device)
    summary, wall = _wall_ms(lambda: get_module_summary(model, (inputs,), num_timing_iters=3),
                             device)
    n_params = _lm_params(**widths)
    flops = _lm_flops(**widths, seq=inputs.shape[1])
    _check(summary.num_parameters == n_params, f"tools: {summary.num_parameters} parameters")
    _check(summary.size_bytes == 2 * n_params, f"tools: {summary.size_bytes} bytes")
    _check(summary.flops_forward == flops, f"tools: root forward {summary.flops_forward} FLOPs")
    blocks = [summary.submodule_summaries[f"Block_{i}"] for i in range(widths["n_layers"])]
    _check(len({b.flops_forward for b in blocks}) == 1, "tools: the blocks' FLOPs differ")
    by_type = {}

    def walk(s):
        if s.forward_elapsed_time_ms >= 0:
            row = by_type.setdefault(s.module_type, {"calls": 0, "ms": 0.0})
            row["calls"] += 1
            row["ms"] += s.forward_elapsed_time_ms
        for sub in s.submodule_summaries.values():
            walk(sub)

    walk(summary)
    before = torch.cuda.memory_allocated(device) if torch.device(device).type == "cuda" else 0
    params = dict(model.named_parameters())
    backward = count_flops_backward(
        lambda p, t: torch.func.functional_call(model, p, (t,)), params, inputs)
    after = torch.cuda.memory_allocated(device) if torch.device(device).type == "cuda" else 0
    _check(after == before, f"tools: counting the backward allocated {after - before} bytes")
    _check(backward == summary.flops_backward == 2 * flops,
           f"tools: backward {backward}, summary {summary.flops_backward}, not 2 x {flops}")
    prune_module_summary(summary, max_depth=2)
    print(get_summary_table(summary), flush=True)
    return {
        "num_parameters": summary.num_parameters, "size_bytes": summary.size_bytes,
        "flops_forward": summary.flops_forward, "flops_backward": summary.flops_backward,
        "block_flops": blocks[0].flops_forward, "forward_ms_root": summary.forward_elapsed_time_ms,
        "forward_ms_by_type": by_type, "summary_wall_ms": wall,
        "count_flops_backward": backward, "backward_bytes_allocated": after - before,
        "peak_bytes": _stream_peak(device),
    }


def _model_float32_check(device, model, last, n_layers):
    """Leg (a)'s float32 witness: the bf16 weights upcast in place (the
    bf16 copy freed as each tensor converts), TF32 off, one forward of the
    last window; its perplexity against the bf16 one within
    ``_bf16_log_ppl_bound``, and the top-1 agreement."""
    inputs, targets, bf16_top1, bf16_nll = last
    model.float()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    logits = model(inputs)
    nll, count = _perplexity_update_jit(logits, targets, None)
    n = int(count)
    bound = _bf16_log_ppl_bound(n_layers, float(logits.abs().amax()), float(nll) / n)
    diff = abs(bf16_nll / n - float(nll) / n)
    _check(diff <= bound, f"eval_step: bf16 log-perplexity off float32 by {diff} > {bound}")
    return {
        "perplexity_float32": math.exp(float(nll) / n), "perplexity_bf16": math.exp(bf16_nll / n),
        "log_ppl_diff": diff, "log_ppl_bound": bound,
        "top1_agreement": float((logits.argmax(dim=-1) == bf16_top1).float().mean()),
        "tf32": torch.backends.cuda.matmul.allow_tf32,
    }


def _subgroups(g, rows, cols):
    """Every rank builds every row's and every column's subgroup, in the
    same order; returns (its row group, its column group)."""
    row_groups = [g.new_subgroup([r * cols + c for c in range(cols)]) for r in range(rows)]
    col_groups = [g.new_subgroup([r * cols + c for r in range(rows)]) for c in range(cols)]
    return row_groups[g.rank // cols], col_groups[g.rank % cols]


def _model_long_context(device, gen, widths, n_layers, dp, sp, window, nccl):
    """Leg (b): ``long_context_lm`` in float32, dp x sp over a
    ``ThreadWorld``, two windows, against the dense forward."""
    _reset_peak(device)
    vocab = widths["vocab_size"]
    params = init_long_context_lm(
        gen, vocab_size=vocab, d_model=widths["d_model"], n_heads=widths["n_heads"],
        n_layers=n_layers, d_ff=widths["d_ff"], max_len=widths["max_len"], device=device)
    tokens = torch.randint(0, vocab, (dp, window), generator=gen, device=device)
    targets = torch.randint(0, vocab, (dp, window), generator=gen, device=device)
    blk = window // sp

    def rank(g):
        sp_g, dp_g = _subgroups(g, dp, sp)
        row, col = g.rank // sp, g.rank % sp
        cut = (slice(row, row + 1), slice(col * blk, (col + 1) * blk))
        with _axis.census() as calls:
            logits = long_context_lm(params, tokens[cut], group=sp_g)
            counters = perplexity_counters(logits, targets[cut])
            counters = {k: _axis.psum(_axis.psum(c, sp_g), dp_g) for k, c in counters.items()}
        return logits, counters, dict(calls)

    world = dp * sp
    ThreadWorld(world, timeout=MODEL_RANK_TIMEOUT).run(rank)  # warm-up: each thread's cuBLAS handle
    res, ring_ms = _wall_ms(lambda: ThreadWorld(world, timeout=MODEL_RANK_TIMEOUT).run(rank), device)
    ring_errs, dense_ms = [], []
    ppl = Perplexity(device=device)
    for row in range(dp):
        dense, ms = _wall_ms(lambda: long_context_lm(params, tokens[row:row + 1]), device)
        dense_ms.append(ms)
        ppl.update(dense, targets[row:row + 1])
        for col in range(sp):
            got = res[row * sp + col][0]
            want = dense[:, col * blk:(col + 1) * blk]
            ring_errs.append(_max_err(got, want))
            _check(_within(got, want, LONG_TOL),
                   f"long_context: rank {row * sp + col} off the dense forward by {ring_errs[-1]}")
        if nccl and row == 0:
            world1 = long_context_lm(params, tokens[:1], group=dist.group.WORLD)
            nccl_err = _max_err(world1, dense)
            _check(_within(world1, dense, LONG_TOL), f"long_context: world 1 off by {nccl_err}")
        del dense
    expected = float(ppl.compute())
    for logits, counters, _ in res:
        got = math.exp(float(counters["sum_log_probs"] / counters["num_total"]))
        _check(abs(got / expected - 1) <= LONG_PPL_RTOL,
               f"long_context: sharded perplexity {got} against {expected}")
        _check(float(counters["num_total"]) == dp * window, "long_context: token count")
    hops = [calls.get("ppermute", 0) for _, _, calls in res]
    _check(hops == [n_layers * sp] * (dp * sp), f"long_context: ppermute calls {hops}")
    return {
        "layers": n_layers, "dp": dp, "sp": sp, "window": window, "tokens_per_rank": blk,
        "ring_forward_ms": ring_ms, "dense_forward_ms": dense_ms,
        "max_abs_err": max(ring_errs), "tol": LONG_TOL,
        "perplexity": got, "perplexity_dense": expected,
        "ppermute_calls_per_rank": hops[0], "psum_calls_per_rank": res[0][2].get("psum", 0),
        "nccl_world1_max_abs_err": nccl_err if nccl else None,
        "peak_bytes": _stream_peak(device),
    }


def _model_moe(device, gen, d_model, d_ff, experts, tokens, capacity, nccl):
    """Leg (c): ``moe_apply`` at Switch-Base-8 widths, one expert a rank of
    ``ThreadWorld(experts)``, against ``moe_reference``."""
    _reset_peak(device)
    wg = torch.randn((d_model, experts), generator=gen, device=device) * d_model ** -0.5
    skew = torch.randn((d_model,), generator=gen, device=device) * MOE_SKEW
    x = torch.randn((experts * tokens, d_model), generator=gen, device=device) + skew
    w1 = torch.randn((experts, d_model, d_ff), generator=gen, device=device) * d_model ** -0.5
    w2 = torch.randn((experts, d_ff, d_model), generator=gen, device=device) * d_ff ** -0.5

    def rank(g):
        with _axis.census() as calls:
            y = moe_apply(x[g.rank * tokens:(g.rank + 1) * tokens], wg, w1[g.rank], w2[g.rank],
                          group=g, capacity=capacity)
        return y, dict(calls)

    ThreadWorld(experts, timeout=MODEL_RANK_TIMEOUT).run(rank)  # warm-up
    res, ms = _wall_ms(lambda: ThreadWorld(experts, timeout=MODEL_RANK_TIMEOUT).run(rank), device)
    got = torch.cat([y for y, _ in res])
    want, ref_ms = _wall_ms(lambda: moe_reference(x, wg, w1, w2, num_shards=experts,
                                                  capacity=capacity), device)
    err = _max_err(got, want)
    _check(_within(got, want, MOE_TOL), f"moe: off the reference by {err}")
    keep = torch.cat([_moe_route(s, wg)[2] < capacity for s in x.chunk(experts)])
    dropped = int((~keep).sum())
    _check(dropped > 0, "moe: no token overflowed its expert's capacity")
    _check(bool((got[~keep] == 0).all()) and bool((want[~keep] == 0).all()),
           "moe: a dropped token's output is not exactly zero")
    _check(all(c == {"all_to_all": 2} for _, c in res), "moe: collectives")
    if nccl:
        one = moe_apply(x[:tokens], wg[:, :1], w1[0], w2[0], group=dist.group.WORLD,
                        capacity=capacity)
        ref1 = moe_reference(x[:tokens], wg[:, :1], w1[:1], w2[:1], num_shards=1,
                             capacity=capacity)
        nccl_err = _max_err(one, ref1)
        _check(_within(one, ref1, MOE_TOL), f"moe: world 1 off by {nccl_err}")
    per_rank = 2 * experts * capacity * d_model * x.element_size()
    return {
        "d_model": d_model, "d_ff": d_ff, "experts": experts, "tokens_per_shard": tokens,
        "capacity": capacity, "dropped": dropped, "dropped_share": dropped / x.shape[0],
        "ms": ms, "reference_ms": ref_ms, "max_abs_err": err, "tol": MOE_TOL,
        "bytes_exchanged_per_rank": per_rank,
        "bytes_crossing_ranks_per_rank": per_rank * (experts - 1) // experts,
        "nccl_world1_max_abs_err": nccl_err if nccl else None,
        "peak_bytes": _stream_peak(device),
    }


def _model_pipeline(device, gen, widths, stages, blocks, micro, length, nccl):
    """Leg (d): ``pipeline_apply`` over ``ThreadWorld(stages)``, each stage
    ``blocks`` float32 ``Block``s at ``widths``, against
    ``pipeline_reference``."""
    _reset_peak(device)
    d_model, n_heads, d_ff = widths["d_model"], widths["n_heads"], widths["d_ff"]

    def stage_module(dev):
        return torch.nn.Sequential(*[Block(d_model, n_heads, d_ff, device=dev)
                                     for _ in range(blocks)])

    stage_states = []
    for _ in range(stages):
        m = stage_module(device)
        init_params(m, gen)
        stage_states.append(m.state_dict())
        del m
    stacked = {k: torch.stack([s[k] for s in stage_states]) for k in stage_states[0]}
    del stage_states
    def stage_fn_of(template):
        # functional_call swaps the template's parameters while it runs:
        # one template a thread
        return lambda p, a: torch.func.functional_call(template, p, (a,))

    stage_fn = stage_fn_of(stage_module("meta"))
    x = torch.randn((micro, 1, length, d_model), generator=gen, device=device)

    def rank(g):
        fn = stage_fn_of(stage_module("meta"))
        with _axis.census() as calls:
            y = pipeline_apply(fn, {k: v[g.rank] for k, v in stacked.items()}, x, group=g)
        return y, dict(calls)

    res, ms = _wall_ms(lambda: ThreadWorld(stages, timeout=MODEL_RANK_TIMEOUT).run(rank), device)
    want, ref_ms = _wall_ms(lambda: pipeline_reference(stage_fn, stacked, x), device)
    errs = [_max_err(y, want) for y, _ in res]
    _check(all(_within(y, want, PIPE_TOL) for y, _ in res), f"pipeline: off by {max(errs)}")
    ticks = micro + stages - 1
    _check(all(c == {"ppermute": ticks, "psum": 1} for _, c in res), "pipeline: collectives")
    if nccl:
        one = pipeline_apply(stage_fn, {k: v[0] for k, v in stacked.items()}, x,
                             group=dist.group.WORLD)
        ref1 = pipeline_reference(stage_fn, {k: v[:1] for k, v in stacked.items()}, x)
        nccl_err = _max_err(one, ref1)
        _check(_within(one, ref1, PIPE_TOL), f"pipeline: world 1 off by {nccl_err}")
    return {
        "stages": stages, "blocks_per_stage": blocks, "microbatches": micro,
        "microbatch_shape": [1, length, d_model],
        "parameter_bytes": sum(v.numel() * v.element_size() for v in stacked.values()),
        "ticks": ticks, "bubble": (stages - 1) / ticks, "ms": ms, "reference_ms": ref_ms,
        "max_abs_err": max(errs), "tol": PIPE_TOL,
        "nccl_world1_max_abs_err": nccl_err if nccl else None,
        "peak_bytes": _stream_peak(device),
    }


@contextlib.contextmanager
def _world1_group(device):
    """A real ``torch.distributed`` group of world 1 for the phase's
    distributed legs: NCCL on the card (which refuses two ranks on one
    device), gloo on the CPU."""
    _check(not dist.is_initialized(), "torch.distributed is already initialized")
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://localhost:{launcher.free_port()}",
                            rank=0, world_size=1)
    try:
        yield backend
    finally:
        dist.destroy_process_group()


def phase_model(device, widths=None, window=LLAMA3_CONTEXT, steps=MODEL_STEPS,
                long_layers=LONG_CONTEXT_LAYERS, dp=2, sp=4, moe=None, moe_tokens=MOE_TOKENS,
                moe_capacity=MOE_CAPACITY, pp=PIPE_STAGES, pp_blocks=PIPE_BLOCKS,
                micro=PIPE_MICRO, micro_len=PIPE_LEN, seed=19):
    """The model runtime on the card (see the module docstring). Cuts: the
    long-context leg runs ``LONG_CONTEXT_LAYERS`` of 32 layers; the
    pipeline leg eight Llama-width blocks; no width is cut."""
    widths = dict(LLAMA3_8B if widths is None else widths)
    moe = dict(SWITCH_BASE_8 if moe is None else moe)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        _check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for float32 matmuls")
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    k1 = _kernels.LAUNCHES["fused_auc_hist"]
    out = {"phase": "model", "device": str(device)}
    with torch.no_grad(), _world1_group(device) as backend:
        model, out["eval_step"], last = _model_eval(device, gen, widths, window, steps)
        out["tools"] = _model_tools(device, model, last[0], widths)
        out["eval_step"]["float32"] = _model_float32_check(device, model, last,
                                                           widths["n_layers"])
        del model, last
        if cuda:
            torch.cuda.empty_cache()
        out["long_context"] = _model_long_context(device, gen, widths, long_layers, dp, sp,
                                                  window, nccl=True)
        out["moe"] = _model_moe(device, gen, moe["d_model"], moe["d_ff"], moe["experts"],
                                moe_tokens, moe_capacity, nccl=True)
        out["pipeline"] = _model_pipeline(device, gen, widths, pp, pp_blocks, micro, micro_len,
                                          nccl=True)
        out["world1_backend"] = backend
    out["k1_launches"] = _kernels.LAUNCHES["fused_auc_hist"] - k1
    _check(out["k1_launches"] == 0, "model: K1 launched")
    out["seconds"] = time.perf_counter() - t0
    return out



TRAIN_LAYERS = 4  # phase 20's training step: **cut** from 32 (16 B a parameter with Adam)
TRAIN_BATCH, TRAIN_WINDOW = 2, 2048  # **cut** from 8,192 positions (saved S x S scores)
TRAIN_STEPS = 3  # timed steps after one warm-up step
FP32_DENSE_PEAK = 67e12  # H100 SXM float32 FLOP/s outside the tensor cores (NVIDIA data sheet)
# the DTensor step against the plain step on the same card, same kernels at
# dp 1 x tp 1: the loss and the NLL sum within TRAIN_LOSS_RTOL; each
# gradient within TRAIN_GRAD_RTOL of its largest element (the embedding's
# scatter-add accumulates in no fixed order)
TRAIN_LOSS_RTOL = 1e-6
TRAIN_GRAD_RTOL = 1e-5
GRAD_RING_TOKENS = 8192  # leg (b) ring: one Llama window over sp 4
GRAD_RING_SP = 4
GRAD_MOE_FACTORS = (1.25, 0.25)  # capacity factors: 320 and 64 tokens of 2,048 a shard
GRAD_PIPE_STAGES, GRAD_PIPE_MICRO, GRAD_PIPE_LEN = 4, 8, 1024  # one Block a stage: **cut** from two
RING_GRAD_TOL = 2e-4  # tests/parallel/test_ring_attention.py::test_ring_attention_grads_flow
MOE_GRAD_TOL = 1e-4  # tests/parallel/test_moe.py::test_moe_grads_flow, of the largest element
PIPE_GRAD_TOL = 1e-5  # tests/parallel/test_pipeline.py::test_pipeline_grads_flow
PROBE_TIMEOUT = 5.0  # seconds the probe's rank threads wait on each other


class _BackwardExchange(torch.autograd.Function):
    """The probe's collective: a swap of two ranks whose backward swaps
    the cotangents back, inside autograd's own backward node."""

    @staticmethod
    def forward(ctx, g, x, threads):
        ctx.g, ctx.threads = g, threads
        return g.exchange_tensors(x.detach())[1 - g.rank].clone()

    @staticmethod
    def backward(ctx, ct):
        ctx.threads.append(threading.get_ident())
        return None, ctx.g.exchange_tensors(ct.contiguous())[1 - ctx.g.rank].clone(), None


def _train_probe(device):
    """Two rank threads, one swap each, ``loss.backward()``: does a
    collective inside autograd's backward node run on the rank's thread,
    and does it deadlock? Then the same swap through ``_axis.ppermute`` and
    ``parallel.backward``, which must give both ranks their gradients."""
    threads = []
    res = {}

    def node(g):
        x = torch.full((4,), float(g.rank + 1), device=device, requires_grad=True)
        loss = (_BackwardExchange.apply(g, x, threads) * (g.rank + 2)).sum()
        t0 = time.perf_counter()
        try:
            loss.backward()
            got = {"ok": True, "grad": x.grad.tolist()}
        except TimeoutError as e:  # the finding, not a failure of the phase
            got = {"ok": False, "error": f"TimeoutError: {e}"}
        got.update(seconds=time.perf_counter() - t0, thread=threading.get_ident())
        res[g.rank] = got

    ThreadWorld(2, timeout=PROBE_TIMEOUT).run(node)
    _sync(device)
    rank_threads = {r["thread"] for r in res.values()}

    def tape(g):
        x = torch.full((4,), float(g.rank + 1), device=device, requires_grad=True)
        y = _axis.ppermute(x, g, [(0, 1), (1, 0)])
        parallel_backward((y * (g.rank + 2)).sum())
        return x.grad.tolist()

    taped = ThreadWorld(2, timeout=MODEL_RANK_TIMEOUT).run(tape)
    _check(taped == [[3.0] * 4, [2.0] * 4], f"probe: parallel.backward gave {taped}")
    return {
        "autograd_node": {str(r): {k: v for k, v in res[r].items() if k != "thread"}
                          for r in sorted(res)},
        "deadlocked": not all(r["ok"] for r in res.values()),
        "backward_threads": len(set(threads)),
        "backward_on_rank_threads": all(t in rank_threads for t in threads),
        "parallel_backward_grads": taped,
    }


def _grad_close(got, want, rtol):
    """Each tensor within ``rtol`` of its largest element."""
    errs = {k: _max_err(got[k], want[k]) for k in want}
    bad = {k: e for k, e in errs.items() if e > rtol * float(want[k].abs().max())}
    return max(errs.values()), bad


def _train_step_leg(device, gen, widths, layers, batch, window, steps):
    """Leg (a): the dp x tp training step at dp 1 x tp 1 over the world-1
    group, against the same model's plain step on the card."""
    cuda = torch.device(device).type == "cuda"
    _reset_peak(device)
    w = dict(widths, n_layers=layers)
    model = TransformerLM(**w, device=device)
    init_params(model, gen)
    n_params = sum(p.numel() for p in model.parameters())
    seqs = torch.randint(0, w["vocab_size"], (batch, window + 1), generator=gen, device=device)
    tokens, targets = seqs[:, :-1].contiguous(), seqs[:, 1:].contiguous()
    fc = FlopCounter(model)
    fc.run(tokens, backward=True)  # the logits are dropped at once
    flops_fwd, flops_bwd = fc.flop_counts[""], fc.flop_counts_backward[""]
    analytic = _lm_flops(**w, seq=window, batch=batch)
    _check(flops_fwd == analytic, f"train: FlopCounter reads {flops_fwd} forward FLOPs, not {analytic}")
    _check(flops_bwd == 2 * flops_fwd, f"train: backward {flops_bwd} FLOPs, not 2 x {flops_fwd}")

    # the plain step's loss, counters and gradients
    loss, counters = train_example.loss_and_metrics(model, tokens, targets)
    train_example.backward(model, loss)
    plain = {"loss": float(loss.detach()), "counters": {k: float(v) for k, v in counters.items()},
             "grads": {k: p.grad for k, p in model.named_parameters()}}
    del loss, counters
    for p in model.parameters():
        p.grad = None

    # the same model as DTensors on a dp 1 x tp 1 mesh
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh(torch.device(device).type, (1, 1), mesh_dim_names=("dp", "tp"))
    train_example.shard_model(model, mesh)
    specs = param_specs(model)
    placements = {k: tuple(str(q) for q in p.placements) for k, p in model.named_parameters()}
    _check(all(placements[k] == tuple(str(q) for q in train_example.placements(specs[k]))
               for k in specs), "train: placements differ from param_specs")
    opt = torch.optim.Adam(model.parameters(), lr=train_example.LR)
    dp_group = mesh.get_group("dp")
    d_tokens, d_targets = (train_example.shard_batch(t, mesh) for t in (tokens, targets))

    def step(clock=None):
        opt.zero_grad(set_to_none=True)
        if clock:
            clock.mark()
        loss, counters = train_example.loss_and_metrics(model, d_tokens, d_targets, dp_group)
        if clock:
            clock.mark()
        train_example.backward(model, loss)
        if clock:
            clock.mark()
        return train_example.global_loss(loss, dp_group), counters

    loss, counters = step()
    got = {"loss": float(loss), "counters": {k: float(v) for k, v in counters.items()}}
    _check(abs(got["loss"] - plain["loss"]) <= TRAIN_LOSS_RTOL * abs(plain["loss"]),
           f"train: DTensor loss {got['loss']} against plain {plain['loss']}")
    _check(got["counters"]["num_total"] == plain["counters"]["num_total"] == batch * window,
           f"train: num_total {got['counters']['num_total']}, not {batch * window}")
    _check(got["counters"]["num_correct"] == plain["counters"]["num_correct"],
           f"train: num_correct {got['counters']['num_correct']} against "
           f"{plain['counters']['num_correct']}")
    _check(abs(got["counters"]["sum_log_probs"] - plain["counters"]["sum_log_probs"])
           <= TRAIN_LOSS_RTOL * abs(plain["counters"]["sum_log_probs"]), "train: sum_log_probs")
    grads = {k: p.grad.full_tensor() for k, p in model.named_parameters()}
    grad_err, bad = _grad_close(grads, plain["grads"], TRAIN_GRAD_RTOL)
    _check(not bad, f"train: gradients off the plain step: {bad}")
    del grads, plain
    opt.step()
    losses = [got["loss"]]
    fwd_ms, bwd_ms, opt_ms, step_ms = [], [], [], []
    _reset_peak(device)
    for _ in range(steps):
        clock = _Clock(device)
        loss, counters = step(clock)
        opt.step()
        clock.mark()
        _sync(device)
        fwd_ms.append(clock.ms(0, 1))
        bwd_ms.append(clock.ms(1, 2))
        opt_ms.append(clock.ms(2, 3))
        step_ms.append(clock.ms(0, 3))
        losses.append(float(loss))
        _check(float(counters["num_total"]) == batch * window, "train: num_total")
    peak = _stream_peak(device)
    _check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
           f"train: the loss did not fall over the steps: {losses}")
    # the counters alone, on the last step's logits (CUDA events / host clock)
    with torch.no_grad():
        logits = model(d_tokens).redistribute(placements=(Shard(0), Replicate())).to_local()
        flat_t = targets.reshape(-1)

        def count():
            _multiclass_accuracy_update(logits.reshape(-1, w["vocab_size"]), flat_t, "micro", None, 1)
            nll = -torch.take_along_dim(F.log_softmax(logits, dim=-1), targets[..., None], dim=-1)
            return nll.sum()

        counter_ms = _median([_wall_ms(count, device)[1] for _ in range(3)])
        del logits
    step_med = _median(step_ms)
    fb_ms = _median(fwd_ms) + _median(bwd_ms)
    return {
        "widths": w, "dtype": "float32", "parameters": n_params, "batch": batch, "window": window,
        "mesh": {"dp": 1, "tp": 1}, "steps": steps, "losses": losses,
        "loss_plain_step0": got["loss"], "grad_max_abs_err": grad_err,
        "counters_step0": got["counters"],
        "step_ms": step_ms, "step_ms_median": step_med, "forward_ms_median": _median(fwd_ms),
        "backward_ms_median": _median(bwd_ms), "optimizer_ms_median": _median(opt_ms),
        "tokens_per_s": batch * window / (step_med / 1e3),
        "flops_forward": flops_fwd, "flops_backward": flops_bwd,
        "tflops_per_s": (flops_fwd + flops_bwd) / (fb_ms / 1e3) / 1e12 if cuda else None,
        "fp32_peak_share": (flops_fwd + flops_bwd) / (fb_ms / 1e3) / FP32_DENSE_PEAK if cuda else None,
        "counters_ms": counter_ms, "counters_share_of_step": counter_ms / step_med,
        "peak_bytes": peak,
    }


def _grads_of(tensors):
    return [t.grad for t in tensors]


def _grad_ring(device, gen, heads, head_dim, tokens, sp):
    """Leg (b) ring: ``ring_attention`` over ``ThreadWorld(sp)`` and over
    the world-1 group, dq, dk, dv against the dense oracle's."""
    _reset_peak(device)
    q, k, v = (torch.randn((1, tokens, heads, head_dim), generator=gen, device=device)
               for _ in range(3))
    dense = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (dense_reference_attention(*dense) ** 2).sum().backward()
    want = _grads_of(dense)
    del dense
    blk = tokens // sp

    def rank(g):
        cut = slice(g.rank * blk, (g.rank + 1) * blk)
        mine = [t[:, cut].clone().requires_grad_(True) for t in (q, k, v)]
        with _axis.census() as calls:
            out = ring_attention(*mine, group=g, causal=True)
            parallel_backward((out ** 2).sum())
        return _grads_of(mine), dict(calls)

    res, ms = _wall_ms(lambda: ThreadWorld(sp, timeout=MODEL_RANK_TIMEOUT).run(rank), device)
    errs = []
    for i, name in enumerate("qkv"):
        got = torch.cat([r[0][i] for r in res], dim=1)
        errs.append(_max_err(got, want[i]))
        _check(_within(got, want[i], RING_GRAD_TOL), f"ring grads: d{name} off by {errs[-1]}")
    # the last hop is wasted: nothing reads it, so it moves nothing back
    _check(all(c == {"ppermute": sp, "backward_plan": 1, "ppermute_bwd": sp - 1} for _, c in res),
           "ring grads: census")
    del res
    mine = [t.clone().requires_grad_(True) for t in (q, k, v)]
    parallel_backward((ring_attention(*mine, group=dist.group.WORLD) ** 2).sum())
    world1 = max(_max_err(g, w) for g, w in zip(_grads_of(mine), want))
    _check(all(_within(g, w, RING_GRAD_TOL) for g, w in zip(_grads_of(mine), want)),
           f"ring grads: world 1 off by {world1}")
    return {"tokens": tokens, "heads": heads, "head_dim": head_dim, "sp": sp, "ms": ms,
            "max_abs_err": {"dq": errs[0], "dk": errs[1], "dv": errs[2]}, "tol": RING_GRAD_TOL,
            "nccl_world1_max_abs_err": world1, "peak_bytes": _stream_peak(device)}


def _moe_reference_grads(args, dtype, **kw):
    """The gradients of ``sum(moe_reference(*args) ** 2)`` in ``dtype``."""
    dense = [t.to(dtype).clone().requires_grad_(True) for t in args]
    (moe_reference(*dense, **kw) ** 2).sum().backward()
    return _grads_of(dense)


def _moe_kink_allowance(x, wg, w1, w2, num_shards, capacity):
    """How far a float32 gradient of ``sum(moe_apply(...) ** 2)`` may
    legitimately sit from the float64 one, element by element, for x and
    w1: a ReLU expert's gradient jumps where a pre-activation h crosses
    zero, and a float32 h lies within ``d u sum_k |x_k w_kj|`` of the exact
    one (the dot-product error bound, u = 2^-24), so a hidden unit that
    close to zero may be on or off. Flipping unit j of token t moves
    dx_t by |dh_tj| |w1_:j| and dw1_:j by |x_t| |dh_tj|, dh the cotangent
    of the unit's output. In float64, with the float32 routing."""
    d = x.shape[1]
    u = 2.0 ** -24
    allow_x = torch.zeros(x.shape, dtype=torch.float64, device=x.device)
    allow_w1 = torch.zeros(w1.shape, dtype=torch.float64, device=x.device)
    x64, w1_64, w2_64 = x.double(), w1.double(), w2.double()
    for i, shard in enumerate(x.chunk(num_shards)):
        expert, _, position = _moe_route(shard, wg)
        gate = torch.softmax(shard.double() @ wg.double(), dim=-1).gather(1, expert[:, None])
        base = i * shard.shape[0]
        for e in range(w1.shape[0]):
            rows = torch.nonzero((expert == e) & (position < capacity)).squeeze(1)
            if not rows.numel():
                continue
            xs = x64[base + rows]
            h = xs @ w1_64[e]
            y = gate[rows] * (torch.relu(h) @ w2_64[e])
            dh = gate[rows] * ((2 * y) @ w2_64[e].T)
            near = h.abs() <= d * u * (xs.abs() @ w1_64[e].abs())
            flips = torch.where(near, dh.abs(), 0.0)
            allow_x[base + rows] += flips @ w1_64[e].abs().T
            allow_w1[e] += xs.abs().T @ flips
    return allow_x, allow_w1


def _moe_grad_errs(what, got, want32, want64, allow):
    """Each gradient against the float64 oracle, element by element:
    within ``MOE_GRAD_TOL`` of the largest element, plus, for x and w1,
    the ReLU kink allowance (``_moe_kink_allowance``). The float32
    oracle's own distance is reported beside."""
    errs = {}
    for name, a, b, c, extra in zip(("x", "wg", "w1", "w2"), got, want32, want64,
                                     (allow[0], 0.0, allow[1], 0.0)):
        diff = (a.double() - c).abs()
        base = MOE_GRAD_TOL * float(c.abs().max())
        errs[name] = {"vs_float64": float(diff.max()), "vs_float32_oracle": _max_err(a, b),
                      "float32_oracle_vs_float64": _max_err(b, c), "tol_of_max": base,
                      "past_tol_of_max": int((diff > base).sum())}
        _check(bool((diff <= base + extra).all()),
               f"{what}: d{name} {errs[name]['vs_float64']} off float64, past "
               f"{base} plus the kink allowance")
    return errs


def _grad_moe(device, gen, d_model, d_ff, experts, tokens, factors):
    """Leg (b) MoE: ``moe_apply`` over ``ThreadWorld(experts)`` at each
    capacity factor, and over the world-1 group: the gradients of x, wg
    (summed over the ranks), w1 and w2 against ``moe_reference``'s in
    float64 (``_moe_grad_errs``), the float32 oracle's beside; a dropped
    token's cotangent exactly zero."""
    _reset_peak(device)
    wg = torch.randn((d_model, experts), generator=gen, device=device) * d_model ** -0.5
    skew = torch.randn((d_model,), generator=gen, device=device) * MOE_SKEW
    x = torch.randn((experts * tokens, d_model), generator=gen, device=device) + skew
    w1 = torch.randn((experts, d_model, d_ff), generator=gen, device=device) * d_model ** -0.5
    w2 = torch.randn((experts, d_ff, d_model), generator=gen, device=device) * d_ff ** -0.5
    out = {"d_model": d_model, "d_ff": d_ff, "experts": experts, "tokens_per_shard": tokens,
           "tol": MOE_GRAD_TOL, "factors": {}}
    for factor in factors:
        capacity = int(tokens / experts * factor)
        kw = dict(num_shards=experts, capacity=capacity)
        want64 = _moe_reference_grads((x, wg, w1, w2), torch.float64, **kw)
        want = _moe_reference_grads((x, wg, w1, w2), torch.float32, **kw)

        def rank(g):
            cut = slice(g.rank * tokens, (g.rank + 1) * tokens)
            mine = [t.clone().requires_grad_(True) for t in (x[cut], wg, w1[g.rank], w2[g.rank])]
            parallel_backward((moe_apply(*mine, group=g, capacity=capacity) ** 2).sum())
            return _grads_of(mine)

        res, ms = _wall_ms(lambda: ThreadWorld(experts, timeout=MODEL_RANK_TIMEOUT).run(rank),
                           device)
        got = [torch.cat([r[0] for r in res]), sum(r[1] for r in res),
               torch.stack([r[2] for r in res]), torch.stack([r[3] for r in res])]
        allow = _moe_kink_allowance(x, wg, w1, w2, experts, capacity)
        errs = _moe_grad_errs(f"moe grads at {factor}", got, want, want64, allow)
        keep = torch.cat([_moe_route(s, wg)[2] < capacity for s in x.chunk(experts)])
        dropped = int((~keep).sum())
        _check(dropped > 0 and bool((got[0][~keep] == 0).all()),
               f"moe grads at {factor}: {dropped} dropped, a dropped token's cotangent not zero")
        out["factors"][str(factor)] = {"capacity": capacity, "dropped": dropped,
                                       "dropped_share": dropped / x.shape[0], "ms": ms,
                                       "errors": errs}
        del res, got, want, want64
    capacity = int(tokens / experts * factors[0])
    one = (x[:tokens], wg[:, :1], w1[:1], w2[:1])
    mine = [t.clone().requires_grad_(True) for t in (x[:tokens], wg[:, :1], w1[0], w2[0])]
    parallel_backward((moe_apply(*mine, group=dist.group.WORLD, capacity=capacity) ** 2).sum())
    kw = dict(num_shards=1, capacity=capacity)
    want64, want = (_moe_reference_grads(one, dt, **kw) for dt in (torch.float64, torch.float32))
    got = _grads_of(mine)
    got[2:] = [got[2][None], got[3][None]]
    allow = _moe_kink_allowance(*one, 1, capacity)
    out["nccl_world1"] = _moe_grad_errs("moe grads at world 1", got, want, want64, allow)
    out["peak_bytes"] = _stream_peak(device)
    return out


def _grad_pipeline(device, gen, widths, stages, micro, length):
    """Leg (b) GPipe: ``pipeline_apply`` over ``ThreadWorld(stages)``, one
    float32 Llama-width ``Block`` a stage, each rank's loss the replicated
    output's divided by the stage count; every parameter's gradient against
    ``pipeline_reference``'s, and over the world-1 group."""
    _reset_peak(device)
    d_model, n_heads, d_ff = widths["d_model"], widths["n_heads"], widths["d_ff"]
    states = []
    for _ in range(stages):
        m = Block(d_model, n_heads, d_ff, device=device)
        init_params(m, gen)
        states.append(m.state_dict())
        del m
    stacked = {k: torch.stack([s[k] for s in states]) for k in states[0]}
    del states
    x = torch.randn((micro, 1, length, d_model), generator=gen, device=device)

    def stage_fn_of(template):
        return lambda p, a: torch.func.functional_call(template, p, (a,))

    dense = {k: v.clone().requires_grad_(True) for k, v in stacked.items()}
    (pipeline_reference(stage_fn_of(Block(d_model, n_heads, d_ff, device="meta")), dense, x)
     ** 2).sum().backward()
    want = {k: v.grad for k, v in dense.items()}
    del dense

    def rank(g):
        fn = stage_fn_of(Block(d_model, n_heads, d_ff, device="meta"))
        mine = {k: v[g.rank].clone().requires_grad_(True) for k, v in stacked.items()}
        with _axis.census() as calls:
            y = pipeline_apply(fn, mine, x, group=g)
            parallel_backward((y ** 2).sum() / stages)
        return {k: v.grad for k, v in mine.items()}, dict(calls)

    res, ms = _wall_ms(lambda: ThreadWorld(stages, timeout=MODEL_RANK_TIMEOUT).run(rank), device)
    got = {k: torch.stack([r[0][k] for r in res]) for k in want}
    err = max(_max_err(got[k], want[k]) for k in want)
    _check(all(_within(got[k], want[k], PIPE_GRAD_TOL) for k in want),
           f"pipeline grads: off by {err}")
    ticks = micro + stages - 1
    _check(all(c == {"ppermute": ticks, "psum": 1, "backward_plan": 1,
                     "ppermute_bwd": ticks - 1, "psum_bwd": 1} for _, c in res),
           "pipeline grads: census")
    del res, got
    fn = stage_fn_of(Block(d_model, n_heads, d_ff, device="meta"))
    mine = {k: v[0].clone().requires_grad_(True) for k, v in stacked.items()}
    parallel_backward((pipeline_apply(fn, mine, x, group=dist.group.WORLD) ** 2).sum())
    ref = {k: v[:1].clone().requires_grad_(True) for k, v in stacked.items()}
    (pipeline_reference(fn, ref, x) ** 2).sum().backward()
    world1 = max(_max_err(mine[k].grad, ref[k].grad[0]) for k in ref)
    _check(all(_within(mine[k].grad, ref[k].grad[0], PIPE_GRAD_TOL) for k in ref),
           f"pipeline grads: world 1 off by {world1}")
    return {"stages": stages, "blocks_per_stage": 1, "microbatches": micro,
            "microbatch_shape": [1, length, d_model], "ticks": ticks, "ms": ms,
            "max_abs_err": err, "tol": PIPE_GRAD_TOL, "nccl_world1_max_abs_err": world1,
            "peak_bytes": _stream_peak(device)}


def _train_examples(device, scaleout_world):
    """Leg (c): the four examples' ``main`` on ``device``, each marker
    checked; K1 once a streaming update in ``eval_panel`` and never in the
    others; ``multihost`` over the world-1 group."""
    dev = str(device)
    out, launches = {}, {}
    runs = [
        ("eval_panel", eval_panel_example, ["--device", dev], "eval panel done"),
        ("llm_eval", llm_eval_example, ["--device", dev], "long-context perplexity="),
        ("multihost", multihost_example, ["--device", dev], "done"),
        ("scaleout", scaleout_example, ["--device", dev, "--world", str(scaleout_world)],
         "scaleout done"),
    ]
    for name, module, argv, marker in runs:
        k1 = _kernels.LAUNCHES["fused_auc_hist"]
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            res = module.main(argv)
        _sync(device)
        seconds = time.perf_counter() - t0
        launches[name] = _kernels.LAUNCHES["fused_auc_hist"] - k1
        _check(marker in printed.getvalue(), f"{name}: no {marker!r} in its output")
        out[name] = {"seconds": seconds, "result": res, "k1_launches": launches[name]}
    _check(out["multihost"]["result"]["world_size"] == 1, "multihost: not at world 1")
    return out, launches


def phase_train(device, widths=None, layers=TRAIN_LAYERS, batch=TRAIN_BATCH, window=TRAIN_WINDOW,
                steps=TRAIN_STEPS, ring_tokens=GRAD_RING_TOKENS, ring_sp=GRAD_RING_SP,
                moe=None, moe_tokens=MOE_TOKENS, moe_factors=GRAD_MOE_FACTORS,
                pp=GRAD_PIPE_STAGES, micro=GRAD_PIPE_MICRO, micro_len=GRAD_PIPE_LEN,
                scaleout_world=8, seed=20):
    """Training through the port on the card (see the module docstring).
    Cuts: the training step runs ``TRAIN_LAYERS`` of 32 layers over
    ``TRAIN_BATCH`` windows of ``TRAIN_WINDOW`` positions; the GPipe leg
    one block a stage; no width is cut."""
    widths = dict(LLAMA3_8B if widths is None else widths)
    moe = dict(SWITCH_BASE_8 if moe is None else moe)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        _check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for float32 matmuls")
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    k1 = _kernels.LAUNCHES["fused_auc_hist"]
    out = {"phase": "train", "device": str(device)}
    out["probe"] = _train_probe(device)
    with _world1_group(device) as backend:
        out["step"] = _train_step_leg(device, gen, widths, layers, batch, window, steps)
        if cuda:
            torch.cuda.empty_cache()
        out["ring"] = _grad_ring(device, gen, widths["n_heads"],
                                 widths["d_model"] // widths["n_heads"], ring_tokens, ring_sp)
        out["moe"] = _grad_moe(device, gen, moe["d_model"], moe["d_ff"], moe["experts"],
                               moe_tokens, moe_factors)
        out["pipeline"] = _grad_pipeline(device, gen, widths, pp, micro, micro_len)
        out["k1_launches_training"] = _kernels.LAUNCHES["fused_auc_hist"] - k1
        _check(out["k1_launches_training"] == 0, "train: K1 launched in the training legs")
        if cuda:
            torch.cuda.empty_cache()
        out["examples"], launches = _train_examples(device, scaleout_world)
        out["world1_backend"] = backend
    streaming = out["examples"]["eval_panel"]["result"]["streaming_updates"]
    if cuda:
        _check(launches == {"eval_panel": streaming, "llm_eval": 0, "multihost": 0, "scaleout": 0},
               f"examples: K1 launches {launches}, not {streaming} in eval_panel alone")
    out["k1_launches"] = _kernels.LAUNCHES["fused_auc_hist"] - k1
    out["k1_streaming_updates"] = streaming
    out["seconds"] = time.perf_counter() - t0
    return out

# ------------------------------------------------------------ 21. analysis

ANALYSIS_WARM = 3  # settling updates before the guarded one
ANALYSIS_K1_UPDATES = 4  # leg (c): Criteo batches each streaming metric takes
ANALYSIS_SYNC_WORLD = 4  # leg (d): ThreadWorld ranks of the eager sync plan
K1_OP = "torcheval_tpu_torch.fused_auc_hist_.default"
_WATCHABLE = ("MulticlassAccuracy", "MeanSquaredError", "Mean", "MulticlassConfusionMatrix",
              "WindowedMeanSquaredError")


class _Family(NamedTuple):
    make: Any  # () -> metric
    args: tuple
    kwargs: dict


def _analysis_families(device, seed):
    """Every fused family of the sweep, by name: the JAX package's
    ``CLASS_CASES`` (``tests/metrics/test_no_host_sync.py``), the sharded,
    routed and quality-watched cases of
    ``tests/analysis/test_program_families.py``, and the keyed table's
    ingest families, at those files' shapes, inputs on ``device``."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    x2 = t(rng.random((64, 5)).astype(np.float32))
    t1 = t(rng.integers(0, 5, 64).astype(np.int32))
    xb = t(rng.random(64).astype(np.float32))
    tb = t(rng.integers(0, 2, 64).astype(np.float32))
    lg = t(rng.normal(size=(2, 8, 16)).astype(np.float32))
    tg = t(rng.integers(0, 16, (2, 8)).astype(np.int32))
    xc = torch.clamp(x2 + 0.01, 0, 1)
    x16, t16 = (t(rng.integers(0, 16, 64).astype(np.int32)) for _ in range(2))
    tbi = t(rng.integers(0, 2, 64).astype(np.int32))
    ctr = t(rng.integers(0, 2, (8, 16)).astype(np.float32))
    ctw = t(rng.uniform(0.5, 2.0, (8, 16)).astype(np.float32))
    task_ids = t(rng.integers(0, 8, 64).astype(np.int32))
    d = dict(device=device)
    fams = {
        "MulticlassAccuracy": _Family(lambda: MulticlassAccuracy(**d), (x2, t1), {}),
        "MulticlassF1Score": _Family(
            lambda: MulticlassF1Score(num_classes=5, average="macro", **d), (x2, t1), {}),
        "Mean": _Family(lambda: Mean(**d), (xb,), {}),
        "Sum": _Family(lambda: Sum(**d), (xb,), {}),
        "MeanSquaredError": _Family(lambda: MeanSquaredError(**d), (xb, tb), {}),
        "R2Score": _Family(lambda: R2Score(**d), (xb, tb), {}),
        "Perplexity": _Family(lambda: Perplexity(**d), (lg, tg), {}),
        "MulticlassConfusionMatrix": _Family(
            lambda: MulticlassConfusionMatrix(num_classes=5, **d), (x2, t1), {}),
        "ClickThroughRate": _Family(lambda: ClickThroughRate(**d), (tb, xb), {}),
        "WeightedCalibration": _Family(lambda: WeightedCalibration(**d), (xb, tb), {}),
        "PeakSignalNoiseRatio": _Family(lambda: PeakSignalNoiseRatio(**d), (x2, xc), {}),
        "MulticlassBinnedAUPRC": _Family(
            lambda: MulticlassBinnedAUPRC(num_classes=5, threshold=20, **d), (x2, t1), {}),
        "BinaryBinnedPrecisionRecallCurve": _Family(
            lambda: BinaryBinnedPrecisionRecallCurve(threshold=20, **d), (xb, tb), {}),
        "WindowedMeanSquaredError": _Family(
            lambda: WindowedMeanSquaredError(max_num_updates=4, **d), (xb, tb), {}),
        "WindowedClickThroughRate": _Family(
            lambda: WindowedClickThroughRate(max_num_updates=4, **d), (tb, xb), {}),
        "WindowedBinaryAUROC": _Family(
            lambda: WindowedBinaryAUROC(max_num_samples=128, **d), (xb, tb), {}),
        "MulticlassConfusionMatrix[sharded]": _Family(
            lambda: MulticlassConfusionMatrix(16, shard=ShardContext(1, 4), **d), (x16, t16), {}),
        "HistogramBinnedAUROC": _Family(
            lambda: HistogramBinnedAUROC(threshold=32, **d), (xb, tbi), {}),
        "HistogramBinnedAUROC[sharded]": _Family(
            lambda: HistogramBinnedAUROC(threshold=32, shard=ShardContext(1, 4), **d),
            (xb, tbi), {}),
        "WindowedClickThroughRate[sharded]": _Family(
            lambda: WindowedClickThroughRate(num_tasks=8, max_num_updates=4,
                                             shard=ShardContext(1, 4), **d), (ctr, ctw), {}),
        "WeightedCalibration[routed]": _Family(
            lambda: WeightedCalibration(num_tasks=8, shard=ShardContext(1, 4), **d),
            (xb, tb, 1.0), {"task_ids": task_ids}),
    }
    for name in _WATCHABLE:
        base = fams[name]

        def watched(make=base.make):
            metric = make()
            quality.watch_inputs(metric, bounds=(0.0, 1.0))
            return metric

        fams[f"{name}[watched]"] = _Family(watched, base.args, base.kwargs)
    keys = rng.integers(0, 64, 64)
    fams["MetricTable[ctr]"] = _Family(
        lambda: MetricTable("ctr", shard=ShardContext(1, 4), **d),
        (keys, rng.integers(0, 2, 64).astype(np.float32)), {})
    fams["MetricTable[windowed_ne]"] = _Family(
        lambda: MetricTable("windowed_ne", shard=ShardContext(1, 4), **d),
        (keys, rng.uniform(0.05, 0.95, 64).astype(np.float32),
         rng.integers(0, 2, 64).astype(np.float32)), {})
    return fams


class _ItemFault(Mean):
    """Seeded fault: a plan kernel that reads its batch sum back with
    ``.item()``."""

    def _update_plan(self, input, *, weight=1.0):
        x = self._input_float(input)

        def item_kernel(x):
            s = x.sum()
            keep = 1.0 if s.item() >= 0 else 0.0
            return s * keep, torch.full((), float(x.numel()), device=x.device)

        return (item_kernel, ("weighted_sum", "weights"), (x,))


class _AllReduceFault(Mean):
    """Seeded fault: a plan kernel that all-reduces its batch sum over the
    world-1 ``torch.distributed`` group."""

    def _update_plan(self, input, *, weight=1.0):
        x = self._input_float(input)

        def all_reduce_kernel(x):
            s = x.sum()
            dist.all_reduce(s)
            return s, torch.full((), float(x.numel()), device=x.device)

        return (all_reduce_kernel, ("weighted_sum", "weights"), (x,))


def _state_ptrs(metric):
    out = {}
    for name in metric._state_name_to_default:
        value = getattr(metric, name)
        tensors = [value] if isinstance(value, torch.Tensor) else (
            list(value) if isinstance(value, list) else
            list(value.values()) if isinstance(value, dict) else [])
        out[name] = tuple(x.untyped_storage().data_ptr() for x in tensors)
    return out


def _static_verdict(metric, fam):
    """The verifier's verdict on one family: update, compute and merge on
    fake tensors of the metric's device."""
    rep = analysis.verify_metric_update(metric, *fam.args, **fam.kwargs)
    errors = [] if rep is None else [f for f in rep.active if f.severity == "error"]
    comp = analysis.verify_metric_compute(metric)
    merge = analysis.verify_metric_merge(metric)
    errors += [f for r in (comp, merge) for f in r.active if f.severity == "error"]
    donated = bool(rep is not None and rep.donated_params)
    return {
        "errors": [f.format() for f in errors],
        "rules": sorted({f.rule for f in errors}),
        "host_escapes": list(rep.host_escapes) if rep is not None else [],
        "collectives": list(rep.collectives) if rep is not None else [],
        "in_place": (donated and not any(f.rule == "donated-not-aliased" for f in rep.findings))
        if donated else None,
        "k1_ops": rep.count(K1_OP) if rep is not None else 0,
        "ops": len(rep.ops) if rep is not None else 0,
        "compute_warnings": [f.rule for f in comp.active if f.severity == "warning"],
    }


def _runtime_verdict(metric, fam, cuda, warm=ANALYSIS_WARM):
    """The same update for real: ``warm`` settling updates, then the plan
    built on the host (the intake: its host syncs counted with
    ``set_sync_debug_mode("warn")``) and applied under
    ``set_sync_debug_mode("error")`` (on the CPU: the dispatch recorder's
    host-escape rule), inside ``parallel._axis.census()`` and the c10d
    recorder, with the state pointers read before and after."""
    for _ in range(warm):
        metric._apply_update_plan(metric._update_plan(*fam.args, **fam.kwargs))
    counts = {}
    with _sync_warnings(cuda, counts, "intake"):
        plan = metric._update_plan(*fam.args, **fam.kwargs)
    _sync(metric.device)
    before = _state_ptrs(metric)
    trace = analysis_program._Trace(None)
    error = None
    with _axis.census() as calls, trace as rec:
        if cuda:
            torch.cuda.set_sync_debug_mode("error")
        try:
            metric._apply_update_plan(plan)
        except RuntimeError as e:
            frames = [f for f in traceback.extract_tb(e.__traceback__)
                      if "torcheval_tpu_torch" in f.filename or f.filename.endswith("chip_smoke.py")]
            site = f" at {os.path.relpath(frames[-1].filename)}:{frames[-1].lineno}" if frames else ""
            error = str(e).strip().splitlines()[0] + site
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
    if error is not None and not cuda:
        raise RuntimeError(error)
    _sync(metric.device)
    after = _state_ptrs(metric)
    syncs = (1 if error is not None else 0) if cuda else len(rec.escapes)
    return {
        "syncs": syncs,
        "sync": error if cuda else [f"{op} at {w}" for op, w in rec.escapes],
        "intake_syncs": counts.get("intake", 0),
        "collectives": [n for n, _ in rec.collectives] + [f"parallel.{k}" for k in calls],
        "in_place": before == after,
    }


def _verdicts_agree(static, runtime):
    """Static and runtime verdicts on one family agree: a host escape iff a
    runtime sync, the same collectives, and a donated program written in
    place iff the state pointers held."""
    escapes = bool(static["host_escapes"])
    disagree = []
    if escapes != bool(runtime["syncs"]):
        disagree.append(f"host escapes {static['host_escapes']} vs {runtime['syncs']} runtime syncs")
    if sorted(static["collectives"]) != sorted(runtime["collectives"]):
        disagree.append(f"collectives {static['collectives']} vs {runtime['collectives']}")
    if static["in_place"] is not None and not escapes and static["in_place"] != runtime["in_place"]:
        disagree.append(f"in place {static['in_place']} vs pointers held {runtime['in_place']}")
    return disagree


def _analysis_cli(device):
    """Leg (a): the CLI in-process over the port, JSON report."""
    from torcheval_tpu_torch.analysis.__main__ import main as analysis_main

    pkg = os.path.dirname(os.path.abspath(torcheval_tpu_torch.__file__))
    files = sum(1 for root, dirs, names in os.walk(pkg) if "__pycache__" not in root
                for n in names if n.endswith(".py"))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "report.json")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = analysis_main(["--concurrency", "--programs", "--report", "json",
                                "--output", path, pkg])
        seconds = time.perf_counter() - t0
        with open(path) as f:
            report = json.load(f)
    findings = report["findings"]
    active = [f for f in findings if not f["suppressed"]]
    by_tool = {tool: sum(1 for f in active if f["tool"] == tool)
               for tool in ("lint", "concurrency", "program", "lockstep")}
    _check(rc == 0, f"analysis CLI exited {rc}")
    _check(by_tool["lint"] == 0 and by_tool["concurrency"] == 0,
           f"active lint/concurrency findings: {[f for f in active if f['tool'] in ('lint', 'concurrency')]}")
    errors = [f for f in active if f["severity"] == "error"]
    _check(not errors, f"active errors: {errors}")
    programs = report["checked"] - 2 * files
    _check(programs > 0, f"the CLI checked {report['checked']} for {files} files: no program")
    return {
        "rc": rc, "seconds": seconds, "py_files": files, "linted": files, "swept": files,
        "programs": programs, "checked": report["checked"],
        "active": len(active), "active_errors": len(errors),
        "active_warnings": sorted(f"{f['path']}: {f['rule']}" for f in active),
        "suppressed": sum(1 for f in findings if f["suppressed"]),
        "suppressed_by_tool": {tool: sum(1 for f in findings if f["suppressed"] and f["tool"] == tool)
                               for tool in ("lint", "concurrency")},
    }


def _analysis_sweep(device, seed):
    """Leg (b): static against runtime over every fused family."""
    cuda = torch.device(device).type == "cuda"
    rows = []
    for name, fam in _analysis_families(device, seed).items():
        metric = fam.make()
        try:
            static = _static_verdict(metric, fam)
            # donation as on the card (the CPU default is off)
            with config.update_donation(True):
                runtime = _runtime_verdict(metric, fam, cuda)
        finally:
            for watch in quality.active_watches():
                watch.close()
        disagree = _verdicts_agree(static, runtime)
        rows.append({"family": name, "static": static, "runtime": runtime, "agree": not disagree,
                     "disagree": disagree})
    failed = [(r["family"], r["static"]["errors"], r["disagree"], r["runtime"]["sync"])
              for r in rows if r["static"]["errors"] or r["disagree"]]
    _check(not failed, f"{len(failed)} of {len(rows)} families with static errors or "
                       f"disagreements: {failed}")
    return rows


def _analysis_faults(device, seed):
    """Leg (b), seeded faults: each caught statically and at runtime."""
    cuda = torch.device(device).type == "cuda"
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand((64,), generator=gen, device=device)
    fam = _Family(None, (x,), {})
    out = {}
    with _world1_group(device) as backend:
        dist.all_reduce(torch.ones((1,), device=device))  # the communicator, set up outside
        for name, cls, rule in (("item", _ItemFault, "host-callback"),
                                ("all_reduce", _AllReduceFault, "collective-census")):
            static = _static_verdict(cls(device=device), fam)
            runtime = _runtime_verdict(cls(device=device), fam, cuda, warm=0 if name == "item" else 1)
            caught_static = rule in static["rules"]
            caught_runtime = bool(runtime["syncs"]) if name == "item" else bool(runtime["collectives"])
            _check(caught_static and caught_runtime,
                   f"seeded {name} fault: static {static['rules']}, runtime {runtime}")
            out[name] = {"static": static["rules"], "static_detail": static["errors"][:1],
                         "runtime": runtime, "backend": backend}
    return out


def _analysis_k1(device, seed, n=CTR_BATCH, num_bins=NUM_BINS, updates=ANALYSIS_K1_UPDATES):
    """Leg (c): K1 through the verifier. ``StreamingBinaryAUROC`` and
    ``StreamingBinaryAUPRC`` on Criteo batches from phase 2's generator:
    one K1 op an update in the static trace, one launch an update at
    runtime, the histogram bitwise to the plain version's, no host sync."""
    cuda = torch.device(device).type == "cuda"
    gen = torch.Generator(device=device).manual_seed(seed)
    batches = [_clicks(gen, (n,), device) for _ in range(updates)]
    out = {}
    for name, cls in (("auroc", StreamingBinaryAUROC), ("auprc", StreamingBinaryAUPRC)):
        metric = cls(num_bins=num_bins, device=device)
        rep = analysis.verify_metric_update(metric, *batches[0])
        _check(rep is not None and rep.ok, f"K1 {name}: static report {rep and rep.format_text()}")
        ops = rep.count(K1_OP)
        _check(ops == (1 if cuda else 0), f"K1 {name}: {ops} K1 ops in the static trace")
        launches = []
        for s, y in batches:
            before = _kernels.LAUNCHES["fused_auc_hist"]
            with _no_host_sync(cuda):
                metric.update(s, y)
            launches.append(_kernels.LAUNCHES["fused_auc_hist"] - before)
        _check(launches == [1 if cuda else 0] * updates, f"K1 {name}: launches {launches}")
        plain = torch.zeros((1, 2, num_bins), dtype=torch.float32, device=device)
        for s, y in batches:
            plain += _histogram_plain_full(s[None], y[None], None, num_bins, (0.0, 1.0))
        _check(torch.equal(metric.hist, plain), f"K1 {name}: histogram != plain version")
        out[name] = {"static_k1_ops": ops, "static_ops": len(rep.ops), "launches": launches,
                     "bitwise_to_plain": True}
    out.update(samples=n, num_bins=num_bins, updates=updates, sync_debug="error" if cuda else None)
    return out


def _analysis_lockstep(device, seed, num_classes, classify_n, ctr_n, ring, moe):
    """Leg (d): lockstep plans on the card."""
    out = {}
    coll = _sync_collection(device, num_classes)
    _feed_sync_stream(lambda i: (coll,), device, seed, classify_n, num_classes,
                      min(1024, classify_n), ctr_n, min(CTR_BATCH, ctr_n))
    plans = {r: analysis.eager_sync_plan(coll, world_size=ANALYSIS_SYNC_WORLD, rank=r)
             for r in range(ANALYSIS_SYNC_WORLD)}
    rep = analysis.check_eager_lockstep(plans, name="<phase 4 collection>")
    _check(rep.ok and len(set(plans.values())) == 1, f"eager sync plans differ: {rep.format_text()}")
    out["eager_sync_plan"] = list(plans[0])

    def divergent(rank):
        group = analysis.PlanRecordingGroup(2, rank)

        def program(x):
            y = _axis.psum(x, group)
            return _axis.psum(y, group) if rank == 0 else y

        return program

    rep = analysis.verify_rank_lockstep(divergent, range(2), torch.ones((8,), device=device),
                                        name="<rank-divergent builder>")
    rules = sorted({f.rule for f in rep.active})
    _check("rank-divergent-collective" in rules, f"rank-divergent builder not flagged: {rules}")
    out["divergent_builder"] = rules

    gen = torch.Generator(device=device).manual_seed(seed)
    sp, tokens, heads, head_dim = ring["sp"], ring["tokens"], ring["heads"], ring["head_dim"]
    q, k, v = (torch.randn((1, tokens, heads, head_dim), generator=gen, device=device)
               for _ in range(3))
    blk = tokens // sp

    def ring_program(group, rank):
        def program(q, k, v):
            cut = slice(rank * blk, (rank + 1) * blk)
            mine = [t[:, cut].clone().requires_grad_(True) for t in (q, k, v)]
            out = ring_attention(*mine, group=group, causal=True)
            parallel_backward((out ** 2).sum())
        return program

    e, d_model, d_ff, n = moe["experts"], moe["d_model"], moe["d_ff"], moe["tokens"]
    capacity = int(n / e * moe["factor"])
    wg = torch.randn((d_model, e), generator=gen, device=device) * d_model ** -0.5
    x = torch.randn((e * n, d_model), generator=gen, device=device)
    w1 = torch.randn((e, d_model, d_ff), generator=gen, device=device) * d_model ** -0.5
    w2 = torch.randn((e, d_ff, d_model), generator=gen, device=device) * d_ff ** -0.5

    def moe_program(group, rank):
        def program(x, wg, w1, w2):
            cut = slice(rank * n, (rank + 1) * n)
            mine = [t.clone().requires_grad_(True) for t in (x[cut], wg, w1[rank], w2[rank])]
            parallel_backward((moe_apply(*mine, group=group, capacity=capacity) ** 2).sum())
        return program

    for name, world, make, args in (("ring", sp, ring_program, (q, k, v)),
                                    ("moe", e, moe_program, (x, wg, w1, w2))):
        rep = analysis.verify_rank_lockstep(
            lambda r: make(analysis.PlanRecordingGroup(world, r), r), range(world), *args,
            name=f"<{name}>", check_structure=False)
        _check(rep.ok, f"{name}: rank plans differ: {rep.format_text()}")
        plan = analysis.collective_plan(make(analysis.PlanRecordingGroup(world, 0), 0), *args)
        recorded = dict(collections.Counter(op.name.split(".", 1)[1] for op in plan))

        def rank(g, make=make, args=args):
            with _axis.census() as calls:
                make(g, g.rank)(*args)
            return dict(calls)

        real = ThreadWorld(world, timeout=MODEL_RANK_TIMEOUT).run(rank)
        _check(all(c == recorded for c in real), f"{name}: recorded plan {recorded} != census {real}")
        out[name] = {"world": world, "plan": [op.name for op in plan], "census": real[0],
                     "ranks_equal": True}
    out["ring"].update(tokens=tokens, heads=heads, head_dim=head_dim)
    out["moe"].update(d_model=d_model, d_ff=d_ff, tokens_per_shard=n, capacity=capacity)
    return out


def phase_analysis(device, seed=21, num_classes=1000, classify_n=2048, ctr_n=CTR_BATCH,
                   k1_n=CTR_BATCH, ring=None, moe=None):
    """Phase 21: the analysis layer over the port, metric state on
    ``device`` (module docstring)."""
    t0 = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    ring = ring or dict(sp=GRAD_RING_SP, tokens=GRAD_RING_TOKENS, heads=LLAMA3_8B["n_heads"],
                        head_dim=LLAMA3_8B["d_model"] // LLAMA3_8B["n_heads"])
    moe = moe or dict(SWITCH_BASE_8, tokens=MOE_TOKENS, factor=GRAD_MOE_FACTORS[0])
    k1 = _kernels.LAUNCHES["fused_auc_hist"]
    out = {"phase": "analysis", "device": str(device)}
    legs = (
        ("cli", lambda: _analysis_cli(device)),
        ("families", lambda: _analysis_sweep(device, seed)),
        ("faults", lambda: _analysis_faults(device, seed + 1)),
        ("k1", lambda: _analysis_k1(device, seed + 2, n=k1_n)),
        ("lockstep", lambda: _analysis_lockstep(device, seed + 3, num_classes, classify_n, ctr_n,
                                                ring, moe)),
    )
    failures = []
    for name, leg in legs:  # every leg runs; the phase fails after them all
        t_leg = time.perf_counter()
        try:
            out[name] = leg()
        except AssertionError as e:
            failures.append(f"{name}: {e}")
        out.setdefault("leg_seconds", {})[name] = time.perf_counter() - t_leg
    out["families_checked"] = len(out.get("families", ()))
    out["k1_launches"] = _kernels.LAUNCHES["fused_auc_hist"] - k1
    out["seconds"] = time.perf_counter() - t0
    if cuda:
        out["card"] = _card_line()
    _check(not failures, "analysis: " + " | ".join(failures))
    return out


def _time_ms(fn, device, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / reps


def _host_ms(fn, device, reps):
    """Host time per call with no synchronize in the loop: what enqueuing
    one call costs the CPU (validation, ctypes call, launch)."""
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize(device)
    return seconds * 1e3 / reps


def _device_ms(fn, device, reps, kernel_name="fused_auc_hist_kernel"):
    """Device time per launch of the kernels named ``kernel_name`` from a
    torch.profiler (CUPTI) trace. A trace that shows none is taken again,
    up to ``PROFILE_ATTEMPTS`` traces in all, the last failing."""
    from torch.profiler import ProfilerActivity, profile

    seen = []
    for _ in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize(device)
        total_us, count = 0.0, 0
        for evt in prof.key_averages():
            if kernel_name in evt.key:
                total_us += getattr(evt, "device_time_total", 0.0) or getattr(evt, "cuda_time_total", 0.0)
                count += evt.count
        if count > 0 and total_us > 0:
            return total_us / 1e3 / count
        seen = [(e.key[:60], e.count) for e in prof.key_averages()][:12]
    raise AssertionError(f"profiler shows no device time for {kernel_name}; it saw {seen}")


def _bare_launch(out, s, y, w, num_bins, bounds, device):
    """The C launch alone, its arguments built once: what one launch costs
    the host below the wrapper (ctypes call, cudaLaunchKernelEx). Not
    counted in ``_kernels.LAUNCHES``: it is no wrapper launch."""
    lib = _kernels.load("fused_auc_hist")
    tasks, n = s.shape
    g = fa._geometry(lib, torch.cuda.current_device(), n, tasks, num_bins)
    args = fa._pack_launch(out, s, y, w, num_bins, bounds, g)
    stream = torch.cuda.current_stream(device).cuda_stream

    def launch():
        code = lib.tev_fused_auc_hist(args, stream)
        if code:
            _kernels.check(lib, code, "bare fused_auc_hist launch")
    return launch


def _timing_row(gen, n, tasks, skewed, weighted, device, num_bins=NUM_BINS):
    s = _scores(gen, (tasks, n), skewed, device)
    y = (torch.rand((tasks, n), generator=gen, device=device) < s).to(torch.float32)
    w = torch.rand((tasks, n), generator=gen, device=device) if weighted else None
    hist = torch.zeros((tasks, 2, num_bins), dtype=torch.float32, device=device)
    bins = torch.clamp((s * num_bins).to(torch.int64), max=num_bins - 1)
    bins = (bins + torch.arange(tasks, device=device)[:, None] * num_bins).reshape(-1)
    idx2 = torch.cat([bins, bins + tasks * num_bins])
    ww = torch.ones_like(s) if w is None else w
    w2 = torch.cat([(ww * y).reshape(-1), (ww * (1.0 - y)).reshape(-1)])
    reps = 200 if n <= CTR_BATCH else 20
    bounds = (0.0, 1.0)

    def launch():
        _histogram_cuda(hist, s, y, w, num_bins, bounds)

    metric = StreamingBinaryAUROC(num_tasks=tasks, num_bins=num_bins, device=device)
    us, uy, uw = (s[0], y[0], None) if tasks == 1 else (s, y, w)

    before = _kernels.LAUNCHES["fused_auc_hist"]
    kernel_ms = _time_ms(launch, device, reps)
    _check(_kernels.LAUNCHES["fused_auc_hist"] == before + reps + 3, "timing launch count")
    host = {
        "update": _host_ms(lambda: metric.update(us, uy, uw), device, reps),
        "wrapper": _host_ms(launch, device, reps),
        "c_launch": _host_ms(_bare_launch(hist, s, y, w, num_bins, bounds, device), device, reps),
    }
    device_ms = _device_ms(launch, device, reps)
    plain_ms = _time_ms(lambda: hist.add_(_histogram_plain_full(s, y, w, num_bins, bounds)),
                        device, reps)
    library_ms = _time_ms(
        lambda: torch.bincount(idx2, weights=w2, minlength=2 * tasks * num_bins), device, reps)
    # scores + labels (+ weights) read once, unit weights implicit; the
    # histogram read and written once (accumulate form)
    nbytes = (12 if weighted else 8) * tasks * n + 2 * 8 * tasks * num_bins
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {
        "n": n, "tasks": tasks, "num_bins": num_bins,
        "scores": "skewed" if skewed else "uniform", "weighted": weighted,
        "design": _k1_design(n, tasks, num_bins),
        "kernel_ms": kernel_ms, "kernel_device_ms": device_ms,
        "kernel_host_ms_per_call": host["wrapper"], "host_ms_per_call": host,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "bytes": nbytes,
        "bound_share_device": bound_ms / device_ms, "bound_share_events": bound_ms / kernel_ms,
        "reps": reps,
    }


def _design_name(g):
    """``rep_cCxK`` (replicated), ``split_cCxK``: K clusters of C CTAs a
    task; ``global_xK``: K blocks of the global-memory variant."""
    if not g.shared:
        return f"global_x{g.clusters_per_task}"
    return f"{'split' if g.split else 'rep'}_c{g.cluster}x{g.clusters_per_task}"


def _design_sweep(gen, device, full=False):
    """Device time of launch designs over batch sizes (T = 1, unit
    weights): at 8,192 bins, replicated clusters of 1 to 16 CTAs in counts
    from one a task to a full card, and the split layout; at 65,536 bins,
    the split layout against the global-memory variant. Sets the
    geometry's switch points. Forced geometries go through the checked
    wrapper like any other launch; the wrapper's own pick is timed first
    and marked ``picked``. ``full`` sweeps every batch size and design;
    the default keeps, at the smallest and largest batch, the designs on
    each side of the wrapper's switch points."""
    lib = _kernels.load("fused_auc_hist")
    dev = torch.cuda.current_device()
    active = fa._device_occupancy(lib, dev)
    rows = []

    def run(n, num_bins, skewed, designs):
        s = _scores(gen, (1, n), skewed, device)
        y = (torch.rand((1, n), generator=gen, device=device) < s).to(torch.float32)
        hist = torch.zeros((1, 2, num_bins), dtype=torch.float32, device=device)
        pick = fa._geometry(lib, dev, n, 1, num_bins)
        for g in [pick] + [g for g in designs if g != pick]:
            ms = _device_ms(lambda: _histogram_cuda(hist, s, y, None, num_bins, (0.0, 1.0), g),
                            device, 30 if n <= (1 << 20) else 10)
            rows.append({"n": n, "num_bins": num_bins, "scores": "skewed" if skewed else "uniform",
                         "design": _design_name(g), "picked": g == pick, "cluster": g.cluster,
                         "split": g.split, "clusters_per_task": g.clusters_per_task,
                         "device_ms": ms})

    sizes = (1 << 16, 1 << 18, 1 << 20, 1 << 24) if full else (1 << 16, 1 << 24)
    for n in sizes:
        designs = []
        for c in (1, 2, 4, 8, 16):
            most = active(c, 8 * NUM_BINS)
            for ctas in (8, 16, 32, 64, 128, c * most):
                k = ctas // c
                if 1 <= k <= most and (k == 1 or 4 * c * k * fa._THREADS <= n):
                    if full or ctas in (32, c * most):
                        designs.append(K1Geometry(c, k, 8 * NUM_BINS))
        split_most = active(8, NUM_BINS)
        designs += [K1Geometry(8, 1, NUM_BINS, True), K1Geometry(8, split_most, NUM_BINS, True)]
        for skewed in (True, False) if n == 1 << 24 else (True,):
            run(n, NUM_BINS, skewed, designs)
    big = 65_536
    for n in (1 << 16, 1 << 20, 1 << 24) if full else (1 << 16, 1 << 24):
        designs = []
        for c in (8, 16) if full else (8,):
            smem = 8 * big // c
            most = active(c, smem)
            designs += [K1Geometry(c, most, smem, True)]
            if full:
                designs += [K1Geometry(c, 1, smem, True)]
        most = active(1, 0)
        designs += [K1Geometry(1, k, 0) for k in ((4, 16, most) if full else (most,))]
        run(n, big, True, designs)
    return rows


def _design_choices(sweep):
    """For each swept shape: the wrapper's pick and the fastest design it
    passed over, with their device times."""
    out = []
    for key in dict.fromkeys((r["n"], r["num_bins"], r["scores"]) for r in sweep):
        group = [r for r in sweep if (r["n"], r["num_bins"], r["scores"]) == key]
        pick = next(r for r in group if r["picked"])
        other = min((r for r in group if not r["picked"]), key=lambda r: r["device_ms"])
        out.append({"n": key[0], "num_bins": key[1], "scores": key[2],
                    "pick": pick["design"], "pick_ms": pick["device_ms"],
                    "best_other": other["design"], "best_other_ms": other["device_ms"]})
    return out


def phase_timing(device, seed=4, full_sweep=False):
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = []
    for n, tasks, skewed, weighted in (
        (CTR_BATCH, 1, False, False),
        (CTR_BATCH, 1, True, False),
        (CTR_BATCH, 4, True, True),  # the weighted multi-task stream's shape
        (1 << 24, 1, False, False),
        (1 << 24, 1, True, False),
    ):
        rows.append(_timing_row(gen, n, tasks, skewed, weighted, device))
    # 65,536 bins: the global-memory variant below 16 samples a bin, the
    # split layout above
    for n in (CTR_BATCH, 1 << 24):
        rows.append(_timing_row(gen, n, 1, True, False, device, num_bins=65_536))
    sweep = _design_sweep(gen, device, full_sweep)
    return {"phase": "timing", "card": _card_line(), "rows": rows,
            "design_choices": _design_choices(sweep), "design_sweep": sweep,
            "library_call": "torch.bincount over precomputed bin indices (binning not timed)"}


# ------------------------------------------------------------------ main


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def _ptxas_summary(log: str):
    """Registers, spills and barriers of each kernel in an ``-Xptxas -v``
    log, by mangled name."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            out[name] = []
        elif name and ("registers" in line or "spill" in line):
            out[name].append(line.strip())
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--sweep", action="store_true",
                        help="time every launch design over every batch size in the timing phase")
    parser.add_argument("--elastic-worker", help=argparse.SUPPRESS)
    parser.add_argument("--shard-worker", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if args.elastic_worker is not None:  # one process of the elastic phase's launcher step
        _elastic_worker(args.elastic_worker)
        return 0
    if args.shard_worker is not None:  # one gloo process of the shard_quality phase
        _shard_worker(args.shard_worker)
        return 0
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    built = _kernels.build_all()
    _emit({"phase": "build", "built": built, "seconds": time.perf_counter() - t0,
           "ptxas": _ptxas_summary(_kernels.build_log("fused_auc_hist"))})

    _kernels.reset_launch_counts()
    _emit(phase_classify(device, seed=args.seed))
    _check(_kernels.LAUNCHES["fused_auc_hist"] == 0, "classify launched K1")
    ctr = phase_ctr_auc(device, seed=args.seed + 1)
    _emit(ctr)
    kvp = phase_kernel_vs_plain(device, seed=args.seed + 2)
    _emit(kvp)
    _emit(phase_sync(device, seed=args.seed + 3))
    curve = phase_curve(device, seed=args.seed + 5)
    _emit(curve)
    _emit(phase_mp_sync(device, seed=args.seed + 6))
    counters = phase_counters(device, seed=args.seed + 7)
    _emit(counters)
    timing = phase_timing(device, seed=args.seed + 4, full_sweep=args.sweep)
    _emit(timing)
    recsys = phase_recsys(device, seed=args.seed + 8)
    _emit(recsys)
    lm_eval = phase_lm_eval(device, seed=args.seed + 9)
    _emit(lm_eval)
    image = phase_image(device, seed=args.seed + 10)
    _emit(image)
    window = phase_window(device, seed=args.seed + 11)
    _emit(window)
    bucket = phase_bucket(device, seed=args.seed + 13)
    _emit(bucket)
    elastic = phase_elastic(device, seed=args.seed + 14)
    _emit(elastic)
    obs_phase = phase_obs(device, seed=args.seed + 15)
    _emit(obs_phase)
    shard_quality = phase_shard_quality(device, seed=args.seed + 16)
    _emit(shard_quality)
    serving = phase_serving(device, seed=args.seed + 17)
    _emit(serving)
    wan = phase_wan(device, seed=args.seed + 18)
    _emit(wan)
    model = phase_model(device, seed=args.seed + 19)
    _emit(model)
    train = phase_train(device, seed=args.seed + 20)
    _emit(train)
    analysis_phase = phase_analysis(device, seed=args.seed + 21)
    _emit(analysis_phase)

    rows = [r for r in timing["rows"] if r["num_bins"] == NUM_BINS]
    main_row = next(r for r in rows
                    if r["n"] == CTR_BATCH and r["tasks"] == 1 and r["scores"] == "skewed")
    big = [r for r in rows if r["n"] == 1 << 24]
    _emit({"kernels": [{
        "name": "fused_auc_hist",
        "route": "cuda",
        "source": "torcheval_tpu_torch/ops/csrc/fused_auc_hist.cu",
        "replaces": "torcheval_tpu/ops/fused_auc.py:164",
        "launches": ctr["k1_launches"],
        "launches_use_fused": curve["k1_launches"],
        "launches_counters": counters["criteo"]["k1_launches"],
        "launches_recsys": recsys["k1_launches"],
        "launches_lm_eval": lm_eval["k1_launches"],
        "launches_image": image["k1_launches"],
        "launches_window": window["k1_launches"],
        "launches_bucket_classify": bucket["classify"]["k1_launches"],
        "launches_bucket_criteo": bucket["criteo"]["k1_launches"],
        "launches_elastic": elastic["k1_launches"],
        "launches_obs": obs_phase["k1_launches"],
        "launches_shard_quality": shard_quality["k1_launches"],
        "launches_serving": serving["k1_launches"],
        "launches_wan": wan["k1_launches"],
        "launches_model": model["k1_launches"],
        "launches_train": train["k1_launches"],
        "launches_train_training_legs": train["k1_launches_training"],
        "launches_train_eval_panel": train["examples"]["eval_panel"]["k1_launches"],
        "launches_analysis": analysis_phase["k1_launches"],
        "launches_analysis_k1_leg": {k: sum(v["launches"]) for k, v in analysis_phase["k1"].items()
                                     if isinstance(v, dict)},
        "use_fused_histogram": curve["criteo"]["use_fused_histogram"],
        "max_abs_err": kvp["max_abs_err"],
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main_row["library_ms"],
        "device_ms": main_row["kernel_device_ms"],
        "design": main_row["design"],
        "design_2_24": big[0]["design"],
        "bound_share_2_24": {r["scores"]: r["bound_share_device"] for r in big},
        "design_choices": [
            [c["n"], c["num_bins"], c["scores"], c["pick"], c["pick_ms"],
             c["best_other"], c["best_other_ms"]] for c in timing["design_choices"]],
    }]})
    print(_card_line(), flush=True)
    _emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
