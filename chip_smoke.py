#!/usr/bin/env python3
"""Drive mxnet_tpu_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. setup: torch/CUDA versions, the card's name and power limit, the
   build of every CUDA kernel from ``mxnet_tpu_torch/ops/csrc`` (one
   ``nvcc`` per source, all started together) and the NVRTC library
   that RTC loads (path and version on the build line);
2. each kernel against its plain PyTorch version on the same card
   tensors, within the stated tolerances, then timed with CUDA events
   beside the plain version and one PyTorch library call: the forward
   K2 at the serving and training shapes (the latter also as the LM's
   strided q/k/v views, which it must read in place, allocating only o
   and lse), in both of its bf16 block shapes, at ragged, Tq != Tk and
   f32 shapes and on operands the wrapper copies first; the backward K3
   (dQ) and K4 (dK/dV) at the training shape (also as the LM's strided
   q/k/v and transposed dO, read in place: the two calls must allocate
   dq, dk and dv and nothing else), a ragged shape (causal and not) and
   an f32 shape, each call giving the same bits twice, with the one-term
   form's errors beside and a check that the limit rejects outputs 5%
   off on the back half of a causal head;
3. gradients: one training step's gradients through the kernels
   against the same step with the plain attention under autograd, per
   parameter tensor, at 2 layers of the flagship's full width;
4. serving: ``Engine.generate`` at the full width of the flagship LM
   (bench_lm.py's width, random seeded weights on the card), two
   2048-token prompts through the context-parallel Ulysses prefill (K2,
   once per layer) and two short prompts through the paged path; the
   kernel counts are zeroed just before and read just after, and the
   outputs are held against the plain ``transformer.forward``;
5. sampled and speculative serving: the same flagship LM (its tail
   layers' ``wo``/``w2`` scaled by 0.005) behind ``Engine(spec=True,
   spec_k=4)`` with bench_serve.py's 1-layer draft: two 2048-token
   prompts through the Ulysses prefill (one sampled at temperature 0.8,
   top-p 0.95) and a 5-token (temperature 1.0, top-k 50) and a 37-token
   (greedy) prompt through the paged path, 32 new tokens each; checks
   that the card's threefry keys, bits and uniforms equal the host's
   (64 triples at V = 32000), that every draw ran on the card, that the
   greedy rows agree with ``forward``, that a fresh engine replays the
   streams and other seeds change them, that 65,536 draws from one row
   lie within total variation 0.03 of ``filter_dist``, that K2 launched
   24 times and that drafts were accepted; prints tokens/s and TTFT
   beside the same requests without speculation, the accept rate, the
   sampler's and the draft turn's and verify's ms;
6. training: ``ShardedTrainer`` over ``loss_fn`` at bench_lm.py's
   configuration (12 layers, d_model 1024, seq 1024, batch 16, Adam
   1e-4; 184,862,720 parameters), one warm-up and 4 timed steps on a
   fixed seeded batch; the counts are zeroed just before and read just
   after (12 launches each of K2, K3 and K4 per step), the step-0 loss
   is checked against ln(vocab) and the loss must fall;
7. the row-softmax kernel K1 against its plain version at the Symbol
   paths' shapes ([64, 10], [128, 1000] f32), at [128, 1000] scaled by
   50, [1000, 1001] f16, [4096, 32000] bf16, [8, 2097152] f32 (8 MB
   rows, past the TPU kernel's fallback), [3, 1], the LSTM's [1920,
   200] f32, bench.py's [128, 1000] bf16, Inception-BN's [256, 1000]
   f32, train_cifar10's [128, 10] f32, Faster R-CNN's [32, 3] f32 and
   the ``.rec`` fit's [256, 4] f32,
   each timed beside the plain version, ``torch.softmax`` and its bytes
   bound;
8. the Symbol path, LeNet: the canonical ``FeedForward.fit`` of the
   verify recipe on ``gpu(0)`` (MNISTIter 1024 synthetic digits, batch
   64, 3 epochs, lr 0.1, momentum 0.9, Xavier), which must score > 0.9
   on the 512-digit validation set; K1's count is zeroed just before
   and read just after;
9. the Symbol path, ResNet-50 at bench.py's width (batch 128,
   3x224x224, 1000 classes, f32, conv7 stem): first one bound Executor
   step's gradients with SoftmaxOutput through K1 against the same step
   through the plain softmax, per tensor (relative L2 <= 1e-3); then
   ``FeedForward.fit`` with SGD lr 0.05, momentum 0.9 (the default
   initializer, Uniform(0.01)) on an NDArrayIter
   of 4 seeded batches for 2 epochs, on the per-batch loop
   (``MXNET_SCAN_TRAIN=0``: the callback reads its executor), printing
   per-batch ms (synchronised, first batch excluded), img/s, peak memory
   and each batch's cross-entropy (finite, step 0 within 0.5 of ln 1000);
10. the Module API: ``examples/module/mnist_mlp.py``'s three workflows
   (explicit Module, SequentialModule, a Python loss through
   ``backward(out_grads=...)``) at its defaults, each to validation
   accuracy > 0.9; LeNet's canonical recipe through ``Module.fit``
   (score > 0.9); ``BucketingModule`` at buckets 10 and 20 over one
   storage on the card; a ``Monitor`` over one LeNet batch, every tap
   finite; K1's count zeroed just before and read just after;
11. ResNet-50 through ``Module.fit`` at phase 9's widths and batches, one
   epoch (the per-batch loop too), its warm step and img/s printed
   beside FeedForward's;
12. bench.py's ResNet-50 leg (``phase_resnet_bench``): the s2d stem
   through ``make_symbol_train_step`` with bf16 products, SGD 0.05 /
   0.9, batch 128, bench.py's 16 seeded batches on the card; one warm
   ``step.loop`` of 16 and three timed windows of two loops (ms a step,
   img/s median/min/max, peak memory, conv/FC TFLOP/s), then conv7 in
   bf16 and s2d in f32 (one warm and one timed loop each); checks the
   bf16 and the f32 step 0 from the same state (``BENCH_BF16_LIMITS``),
   the f32 conv7 step against an Executor step plus ``torch.optim.SGD``
   (relative L2 1e-4 a tensor), finite heads and parameters, and K1
   once a step (its count zeroed just before, read just after);
13. the scanned fit (``phase_resnet_scanned_fit``):
   ``FeedForward(get_resnet(1000, 50), compute_dtype="bfloat16").fit``
   at phase 9's batches and epochs and ``Module.fit`` with
   ``MXNET_COMPUTE_DTYPE=bfloat16`` for one epoch, ``MXNET_SCAN_TRAIN``
   at its default; each must build its scanned trainer; cross-entropy
   finite, step 0 within 0.5 of ln 1000; K1 once a step; ms a step and
   img/s beside phase 9's;
14. the LSTM language model over bucketing (baseline config #3):
   examples/rnn_torch/lstm_bucketing.py's recipe at its defaults (2
   layers of 200, embed 200, batch 32, buckets 10-60, 5 epochs of the
   synthetic corpus: 300 batches) through ``FeedForward(symbol=sym_gen)
   .fit``; epoch 5's train perplexity below epoch 1's and below half the
   corpus's unigram perplexity; K1 launched once a batch (its count
   zeroed just before and read just after); every bucket on one
   parameter and gradient storage on the card; an executor at dropout
   0.5 whose masks on the card equal the host's for the same keys;
   prints ms a batch by bucket, non-pad tokens/s, peak memory, the busy
   share of the last epoch and the ms of a forward+backward at dropout
   0.5 against 0;
15. SSD (baseline config #5, ``phase_ssd``):
   examples/ssd_torch/train_net.py's ``main`` at its defaults (512
   synthetic 3x64x64 images, 3 classes, batch 32, 25 epochs, SGD 0.1 /
   0.9, wd 5e-4, Xavier) through ``Module.fit`` on the scanned fit, then
   its detection module over 128 held-out images: held-out mAP@0.5 >
   0.25, the anchor classifier's foreground accuracy > 0.2 on a training
   batch after the fit, the scanned trainer built, the CrossEntropy
   falling from the first epoch to the last, every output finite, K1
   launched 0 times; prints ms a step, img/s, peak memory, the detection
   forward's ms and device launches and the mAP; then every op of the
   slice (the MultiBox ops on crafted ties and an image without ground
   truth, ROIPooling, SpatialTransformer, Correlation, WarpCTC,
   SVMOutput, the regression outputs, MakeLoss, smooth_l1) on the card
   against the same op on the host;
16. Inception-BN at examples/image-classification_torch/
   train_imagenet.py's defaults (``phase_inception_bn``: ``--network
   inception-bn --synthetic``, 2048 seeded 3x224x224 images, 1000
   classes, batch 256, SGD 0.1 / 0.9, wd 1e-5, Xavier(in, 2.34)) through
   the example's ``train_model.fit`` and the scanned ``FeedForward.fit``
   for 4 epochs (32 steps; the last profiled): every step's
   cross-entropy finite, the parameters changed, K1 once a step; prints
   ms a step, img/s, peak memory, the busy share and device ms a step by
   layer kind; then the first step at batch 8 on the card against the
   host (``phase_inception_bn_grad_check``); ``train_cifar10.py``'s
   defaults for 3 epochs (``phase_cifar10``: validation accuracy > 0.95,
   K1 once a training and a validation batch); every zoo net the slice
   adds (AlexNet, VGG-16 with and without BatchNorm, GoogLeNet,
   Inception-v3, U-Net, the MLP) one step at batch 2 on the card
   against the host, and every op of the slice (``ZOO_OP_CASES``,
   ``rrelu``'s draws bit-equal) on the card against the host
   (``phase_zoo``);
   mirroring (``phase_mirror``): one Executor step of Inception-BN at
   train_imagenet.py's width (batch 256, 3x224x224, 1000 classes)
   unmirrored and under ``MXNET_BACKWARD_DO_MIRROR=1`` from one set of
   parameters, outputs, gradients and BatchNorm statistics bit-equal
   (else within relative L2 1e-6, the reason recorded), the mirrored
   peak memory lower, K1 once a step; examples/memcost_torch/
   lstm_memcost.py at its defaults; train_cifar10.py ``--mirror`` for
   one epoch through the scanned fit (a mirror plan, finite parameters,
   K1 once a training and a validation batch);
   the Predictor (``phase_predictor``): Inception-BN's checkpoint through
   ``Predictor.from_checkpoint`` at batch 32, outputs bit-equal to
   ``FeedForward.predict``, a partial output and ``reshape`` to batch 8;
   ``export_compiled`` loaded by ``load_compiled`` in a fresh process
   that builds no Symbol (outputs bit-equal, K1 launched inside the
   exported program; cold load, first batch and ms a batch);
   ``test_utils.check_consistency`` of LeNet and Inception-BN-small over
   the card and the host; a profiler trace around two Predictor calls
   holding the scope and K1;
   the RecordIO pipeline (``phase_recordio``): a seeded folder of
   2,560 + 256 JPEGs (4 classes of stripes, 300-500 px a side) in a
   temporary directory, packed by tools/torch_im2rec.py ``--resize 256``
   into ``train.rec``/``val.rec`` (every record read back equal to the
   bytes packed), then train_imagenet.py at its defaults (ResNet-50,
   batch 256, lr 0.1, ``kv-store device``) for 2 epochs from the
   ``.rec`` through ``ImageRecordIter`` (rand crop, mirror, HLS jitter,
   the ImageNet mean) under ``PrefetchingIter``: each batch's labels
   equal the ``.lst``'s for its records and, in epoch 1, its data
   finite and within the mean's range, its images showing their label's
   stripes; K1 once a training and a validation batch; prints img/s and
   the busy share of epoch 2's training window, with the same example
   on ``--synthetic`` timed the same way beside it; then one step on the
   first ``.rec`` batch (batch 8) on the card against the host;
17. Faster R-CNN through the host bridges (``phase_rcnn``):
   examples/rcnn_torch/train_end2end.py at its defaults (16 synthetic
   3x128x128 images, batch 1, 30 epochs, SGD 5e-3 / 0.9, wd 5e-4,
   Xavier) through the per-batch ``Module.fit``, its proposal and
   proposal_target CustomOps on the host between the card's ops, then
   detection through the test symbol: the example's asserts (rpn_acc >
   0.8, mean IoU > 0.3, mAP > 0.2), K1 once a step at [32, 3] (480);
   train_alternate.py at its defaults (its asserts; K1 once a step of
   its RCNN head's scanned fits, 216); one train step on the card
   against the host with the CustomOps' outputs made equal, and three
   runs of it on the card byte-equal; prints ms a step, the host ops'
   ms a step and the busy share of the last epoch;
   then the host-bridge examples (``phase_host_bridges``: DEC with
   Adam, numpy-ops' ``FeedForward``, the torch example, each to its own
   gate; a Custom op, a NumpyOp, TorchModule, TorchCriterion and the 31
   ``mx.th`` functions on the card against the host) and every
   optimizer's updates on the card against the host
   (``phase_optimizers``);
18. RTC (K5): the CUDA C bodies of ``RTC_BODIES`` compiled by NVRTC and
   pushed through ``mx.rtc.Rtc`` on ``gpu(0)``, each held against its
   plain PyTorch twin; the real-size body (a*b + c over 2^26 elements,
   f32 and bf16) timed beside its twin, ``torch.addcmul`` and its bytes
   bound; the cold NVRTC compile and a cached push's host time; a body
   with a syntax error must raise;
19. the matmul with column statistics (K6) against its plain version at
   the probe's four shapes (ResNet-50's 1x1 convolutions at batch 128 as
   matmuls), a ragged M and a nonzero-mean x (the limit must reject a sum
   with one row tile dropped); then the probe's path,
   ``tools/torch_probe_matmul_stats.py``'s ``run`` (its checks against
   the unfused matmul-then-statistics sequence, K6, plain,
   ``torch.matmul`` and sequence times), K6's count zeroed just before
   and read just after;
20. the kvstore (``phase_kvstore``): the semantics of the JAX package's
   kvstore tests on four card contexts against four host contexts (one
   pair, a push from every context, a list of keys, a custom updater,
   SGD-momentum through ``set_optimizer`` for three pushes; the sums
   bit-equal, the updates within 1e-6; a one-value push owns its
   storage), and tools/torch_bandwidth.py's device leg;
21. data parallelism (``phase_data_parallel``): config #2 as
   train_imagenet.py writes it, ``--network resnet --synthetic
   --kv-store device`` at full width (batch 256, 224^2, 1000 classes,
   f32) over every card, or two contexts on the one card, for one epoch
   of 8 steps through the per-batch loop and the kvstore (every step's
   cross-entropy finite, the parameters changed, K1 once a context and
   step, img/s); a 2-context ResNet-50 step at batch 8 against the
   host's; LeNet's canonical fit and mnist_mlp's ``Module.fit`` over
   the contexts; a ``multi_device`` line says which cards and contexts
   ran;
22. model parallelism (``phase_model_parallel``): config #4,
   examples/model-parallel-lstm_torch/lstm_ptb.py at its defaults, its
   groups over the cards (the map printed; perplexity falling from
   epoch 1 to 2; K1 once a step), and one step of the 4-way
   partitioned LSTM against the unpartitioned one (1e-4/1e-5);
23. dist (``phase_dist``): ``tools/torch_launch.py -n 2`` on the card
   starts two ranks, each running tests/torch_nightly/dist_sync_kvstore.py
   (the exact dist_sync arithmetic) and dist_lenet.py (sharded LeNet,
   accuracy > 0.9 on each rank, weights equal across ranks), then the
   bandwidth tool's dist-leg worker; the backend the store's rule chose
   is printed;
24. the serving fleet (``phase_fleet``), at the flagship's width and
   phase 4's engine geometry: (A) two Engines behind ``ReplicaServer``s
   and a ``Router`` on loopback sockets serve 8 requests (one 2048-token
   prompt through the cp prefill, five short greedy prompts, two
   sampled), byte-equal to a lone Engine, then again with the replica
   holding the long prompt stopped mid-decode (its streams redelivered
   byte-equal; K2 36 times); (B) two ``python -m
   mxnet_tpu_torch.serving.fleet.replica`` processes at the demo size,
   one SIGKILLed with a stream in flight (every stream byte-equal to the
   seeded demo engine here), the other SIGTERMed (it drains, leaves,
   exits 0); (C) version 1 from two LM trainer steps at batch 4, seq 1024
   (K2, K3, K4 24 times each) published by a ``WeightPublisher``, synced
   by an engine under ``MXNET_WSYNC=1`` between steps while four
   streams run (the sync's seconds and bytes, the longest decode gap
   across the swap), its streams then equal to a cold engine's on
   version 1, a non-finite and a reshaped set refused with the live
   fingerprints unchanged, and after ``rollback_weights`` version 0's;
   (D) leg A again under ``MXNET_TELEMETRY=1`` with a journal and the
   HTTP server: ``/metrics`` holds ``TELEMETRY_CATALOG``, ``/servingz``
   the live request table, every journal line parses, and one engine's
   decode step time with telemetry off and on;
25. the training guardian (``phase_guardian``, ``MXNET_GUARDIAN=1``):
   (A) ResNet-50 at bench.py's configuration (batch 128, 224^2, bf16,
   the s2d stem) through the scanned ``FeedForward.fit`` (K = 4): a
   clean guarded fit bit-equal to the unguarded one from the same seed
   (ms a step both ways: the sentinel's cost); ``grad.nan`` and
   ``loss.spike`` armed once each, the guardian's counters equal to
   ``GUARD_PREDICTED_II`` and every weight finite; three consecutive
   poisoned steps rolling back, the restored state bit-equal to the
   ring snapshot; (B) the same model through the per-batch
   ``Module.fit``, a step whose every update draws ``grad.nan`` leaving
   weights and momenta bit-equal;
26. mxprof (``phase_mxprof``, ``MXNET_PROF=1`` with telemetry, a journal
   and the HTTP server): the flagship Engine (the cp prefill, K2) and
   leg A's fit; ``/profilez`` holds both paths' step breakdowns, every
   program's analytic FLOPs and the derived MFU;
   ``tools/torch_telemetry_report.py`` renders the journal; mxprof's
   cost on decode tokens/s and the fit's ms a step;
27. the guardian's vote (``phase_guardian_vote``): two gloo ranks on the
   card through ``tools/torch_launch.py``, one rank's NaN gradient
   making both skip;
28. the compile layer and the compile/transfer verifier
   (``phase_compile``): K1 and K2 at the phase's shapes against their
   plain versions; (A) bench.py's ResNet-50 through
   ``make_symbol_train_step`` under ``MXNET_COMPILE_OPT=1`` (fold,
   layout, fuse, precision), ``MXNET_COMPILE_VERIFY=1`` and
   ``MXNET_JIT_VERIFY=1`` beside the same step without them: the JAX
   package's pass report on the graph, no fallback, no host
   synchronisation, 8 losses from the same state within 2%, ms a step
   and peak memory of
   both, a one-step profile of each by layer kind with the convolution
   kernels' names; (B) the tuner under ``MXNET_COMPILE_TUNE=1`` and a
   fresh cache directory: trials on the first bind, none and the same
   layouts in a second process; (C) the Predictor on Inception-BN at
   batch 32, unfolded, with fold and fuse (bit-equal) and with every
   pass (1e-3); (D) the flagship Engine under ``MXNET_JIT_VERIFY=1``, 8
   requests: no unexpected recompile, every decode step's D2H ledger the
   token vector, the negative controls caught and raised; (E) the
   persistent cubin cache over three processes: a miss, a hit without
   NVRTC, a corrupt entry counted and recompiled;
29. a JSON line ``{"kernels": [...]}`` with each kernel's launches on the
   main paths, error, times and bound;
30. the last line: ``{"ok": true, "device": {...}}``.

TF32 is off for matrix products and cuDNN convolutions in every phase
(set once in ``main``), so f32 work runs in full f32.

Without CUDA, or run from a directory that lacks the package, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from unittest import mock

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

FLAGSHIP = dict(vocab_size=32000, num_layers=12, d_model=1024, num_heads=8,
                d_ff=4096, max_seq_len=4096, dtype="bfloat16")
# bench_lm.py:69-78, 97-104: the training configuration
TRAIN = dict(FLAGSHIP, max_seq_len=1024)
TRAIN_BATCH = 16
TRAIN_SHAPE = (TRAIN_BATCH, 8, 1024, 128)   # attention [B, H, T, D]


def log(obj):
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=20):
    """Device time of ``fn``: ``iters`` calls captured in one CUDA graph
    and replayed, so the host's launch cost, which hides a microsecond
    kernel behind :func:`cuda_ms`, drops out."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()   # warm: allocator and library state outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_pairs(tq, tk, causal):
    """Visible (query, key) pairs of one head (top-left causal rule)."""
    return sum(min(i + 1, tk) for i in range(tq)) if causal else tq * tk


def attention_flops(b, h, tq, tk, d, causal, products=2):
    """Operations on these inputs: ``products`` products of 2*d per
    visible pair (forward 2: S, PV; K3 3: S, dP, dQ; K4 4: S, dP, dV,
    dK)."""
    return 2.0 * products * b * h * d * attention_pairs(tq, tk, causal)


# kernel -> (products, [Tq, D] tensors, [Tk, D] tensors, f32 [Tq] rows)
# read once or written once: K2 reads Q, K, V and writes O and lse; K3
# reads Q, dO, K, V, lse, D and writes dQ; K4 reads Q, dO, K, V, lse, D
# and writes dK, dV
WORK = {"flash_fwd": (2, 2, 2, 1), "flash_bwd_dq": (3, 3, 2, 2),
        "flash_bwd_dkv": (4, 2, 4, 2)}


def bound_ms(kernel, b, h, tq, tk, d, causal, elem_bytes, peak):
    """Least time for ``kernel`` on these inputs: the larger of its
    operations over the type's peak and its bytes over the memory
    rate; returns (ms, "operations" or "bytes")."""
    products, nq, nk, stats = WORK[kernel]
    flops = attention_flops(b, h, tq, tk, d, causal, products)
    nbytes = (elem_bytes * b * h * (nq * tq * d + nk * tk * d)
              + 4 * stats * b * h * tq)
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def model_flops_per_token(cfg, seq_len):
    """bench_lm.py:61-65: matmul FLOPs per trained token (forward and
    backward), attention at 12*T*d per layer with no causal discount."""
    d, L, V, T = cfg.d_model, cfg.num_layers, cfg.vocab_size, seq_len
    return 3 * (L * 24 * d * d + 2 * d * V) + L * 12 * T * d


def closeness(got, want, tol):
    """``got`` against ``want`` under the limit, per element,
    |got - want| <= tol * (rms(want) + |want|), and
    ||got - want|| <= tol * ||want||. Returns the max abs error, the
    worst ratio of an element's error to its limit (``elem``, <= 1 to
    pass) and the relative L2 error (``rel_l2``, <= tol to pass).

    The limit follows each entry, not the largest: under the causal
    mask a head's rows differ some 30x in size (|dq| falls as
    1/sqrt(row)), so a limit scaled by the largest entry is as large as
    a typical late row. bf16, tol 1e-2: kernel and plain version each
    round their output to bf16, whose step is 2^-8 to 2^-7 of the value,
    so they differ by at most one step (<= 0.78e-2 |want|) beside the
    kernel's error before rounding, which the hi + lo terms keep near
    2^-16; the rms term (1.3 to 2.6 bf16 steps at the rms) covers
    entries near zero, where dS cancels. f32, tol 1e-4: summation order
    only."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    lim = tol * (w.pow(2).mean().sqrt() + w.abs())
    return {"abs": diff.max().item(),
            "elem": (diff / lim.clamp_min(1e-30)).max().item(),
            "rel_l2": ((g - w).norm() / w.norm().clamp_min(1e-30)).item()}


def within(c, tol):
    return c["elem"] <= 1.0 and c["rel_l2"] <= tol


def ptxas_instances(text):
    """Each kernel instance of an ``nvcc -Xptxas -v`` log with its
    registers and spilled bytes: [{"kernel", "registers", "spill_stores",
    "spill_loads"}]."""
    out = []
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            out.append({"kernel": m.group(1), "registers": None,
                        "spill_stores": None, "spill_loads": None})
        elif out:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                out[-1]["spill_stores"] = int(m.group(1))
                out[-1]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[-1]["registers"] = int(m.group(1))
    return out


def phase_setup():
    import torch

    from mxnet_tpu_torch.ops import _build, _nvrtc

    log("torch %s cuda %s python %s" % (torch.__version__,
                                        torch.version.cuda,
                                        sys.version.split()[0]))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi: %s" % smi.stderr.strip()
    log(card)
    secs = _build.build_all()
    t0 = time.perf_counter()
    _nvrtc._load()
    log({"phase": "build", "seconds": secs,
         "libraries": {n: {"seconds": v["seconds"],
                           "instances": ptxas_instances(v["ptxas"]),
                           "ptxas": v["ptxas"].splitlines()}
                       for n, v in _build.build_log.items()},
         "nvrtc": {"path": _nvrtc.info["nvrtc_path"],
                   "version": _nvrtc.info["nvrtc_version"],
                   "include": _nvrtc.info["include"],
                   "load_ms": (time.perf_counter() - t0) * 1e3}})
    return card


def _kernel_inputs(shape, dtype, tk, layout, seed):
    """q, k, v on the card: ``plain`` contiguous tensors; ``lm`` the
    transformer's views (chunks of one [B, T, 3HD] product, reshaped to
    heads and transposed), which K2 reads in place; ``copy`` a q that
    starts 2 bytes off 16 and a k with 264-byte rows, which the wrapper
    copies first."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    b, h, t, d = shape
    tk = t if tk is None else tk

    def randn(*s):
        return torch.randn(s, generator=g, device="cuda").to(dtype)

    if layout == "lm":
        return tuple(x.reshape(b, t, h, d).transpose(1, 2)
                     for x in randn(b, t, 3 * h * d).chunk(3, dim=-1))
    if layout == "copy":
        return (randn(b, h, t, d + 8)[..., 1:d + 1],
                randn(b, h, tk, d + 4)[..., :d], randn(b, h, tk, d))
    return randn(b, h, t, d), randn(b, h, tk, d), randn(b, h, tk, d)


# K2's cases: (shape, dtype, causal, Tk or None, layout, variant); the
# training shape in the LM's strided layout last: it is the main path's
FWD_CASES = [((1, 8, 2048, 128), "bfloat16", True, None, "plain", 0),
             ((1, 8, 2048, 128), "bfloat16", True, None, "plain", 1),
             ((2, 4, 2000, 64), "bfloat16", True, None, "plain", 0),
             ((2, 4, 2000, 64), "bfloat16", False, None, "plain", 0),
             ((2, 4, 2000, 64), "bfloat16", True, None, "plain", 2),
             ((1, 2, 100, 64), "bfloat16", True, 150, "plain", 0),
             ((1, 4, 300, 128), "bfloat16", True, None, "copy", 0),
             ((1, 8, 384, 128), "float32", True, None, "plain", 0),
             (TRAIN_SHAPE, "bfloat16", True, None, "plain", 0),
             (TRAIN_SHAPE, "bfloat16", True, None, "lm", 0)]


def phase_kernels():
    """Flash forward (K2) on the card against attention_reference, in
    both of the bf16 kernel's block shapes (``variant`` 1: 128 query rows
    a block, 2: 64; 0: chosen by the grid), on contiguous tensors, on the
    LM's strided views (read in place: the call must allocate o and lse
    and nothing else) and on operands the wrapper copies first."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops.flash_attention import (attention_reference,
                                                     flash_attention_fwd,
                                                     tma_strides)

    def block(nbytes):   # the caching allocator's booking
        return -(-nbytes // 512) * 512

    results = []
    for shape, dtype_name, causal, tk, layout, variant in FWD_CASES:
        dtype = getattr(torch, dtype_name)
        q, k, v = _kernel_inputs(shape, dtype, tk, layout, len(results))
        in_place = all(tma_strides(x) is not None for x in (q, k, v))
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        got = flash_attention_fwd(q, k, v, causal=causal, variant=variant)
        # before the last case's o and lse are let go
        new_bytes = torch.cuda.memory_allocated() - mem0
        o, lse = got
        o_ref, lse_ref = attention_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        tol_o = 2e-2 if dtype == torch.bfloat16 else 1e-4
        tol_c = 1e-2 if dtype == torch.bfloat16 else 1e-4
        close = closeness(o, o_ref, tol_c)
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, causal=causal,
                                                 variant=variant))
        # device time alone: the wrapper's host cost (tensor maps, checks)
        # hides a short kernel behind cuda_ms
        dev_ms = graph_ms(lambda: flash_attention_fwd(
            q, k, v, causal=causal, variant=variant))
        plain_ms = cuda_ms(
            lambda: attention_reference(q, k, v, causal=causal))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal))
        b, h, t, d = shape
        tk_ = t if tk is None else tk
        bf16 = dtype == torch.bfloat16
        bound, by = bound_ms("flash_fwd", b, h, t, tk_, d, causal,
                             2 if bf16 else 4,
                             PEAK_BF16 if bf16 else PEAK_F32)
        rec = {"phase": "kernel_check", "kernel": "flash_fwd",
               "shape": list(shape), "tk": tk_, "dtype": dtype_name,
               "causal": causal, "layout": layout, "variant": variant,
               "read_in_place": in_place, "new_device_bytes": new_bytes,
               "max_abs_err": err_o,
               "max_abs_err_lse": err_lse, "tol": tol_o, "tol_lse": 1e-3,
               "closeness": close, "tol_closeness": tol_c,
               "ms": ms, "graph_ms": dev_ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
               "achieved_tflops": attention_flops(b, h, t, tk_, d, causal)
               / (dev_ms * 1e-3) / 1e12}
        log(rec)
        if not (err_o <= tol_o and err_lse <= 1e-3
                and within(close, tol_c)):
            raise AssertionError("flash_fwd disagrees with its plain "
                                 "version at %s: %r" % (shape, rec))
        if layout == "lm" and not (
                in_place and new_bytes == block(o.numel() * 2)
                + block(lse.numel() * 4)):
            raise AssertionError("the LM's views were not read in place: "
                                 "%r" % rec)
        results.append(rec)
    return results


# K3/K4's cases: (shape, dtype, causal, layout); the training shape in
# the LM's strided layout last: it is the main path's
BWD_CASES = [(TRAIN_SHAPE, "bfloat16", True, "plain"),
             ((2, 4, 2000, 64), "bfloat16", True, "plain"),
             ((2, 4, 2000, 64), "bfloat16", False, "plain"),
             ((1, 8, 384, 128), "float32", True, "plain"),
             (TRAIN_SHAPE, "bfloat16", True, "lm")]


def _bwd_inputs(shape, dtype, layout, seed):
    """q, k, v as :func:`_kernel_inputs` makes them, and dO: for ``lm``
    the head-transposed gradient of ``o.transpose(1, 2).reshape(B, T,
    HD)``, which K3 and K4 read in place like the LM's q, k, v; for
    ``plain`` a contiguous tensor."""
    import torch

    b, h, t, d = shape
    q, k, v = _kernel_inputs(shape, dtype, None, layout, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1000)
    do = torch.randn(b, t, h * d, generator=g, device="cuda").to(
        dtype).reshape(b, t, h, d).transpose(1, 2)
    return q, k, v, (do if layout == "lm" else do.contiguous())


def phase_bwd_kernels():
    """Flash backward K3 and K4 on the card against
    attention_bwd_reference, per output within :func:`closeness`'s limit
    (tol 1e-2 bf16, 1e-4 f32). At the training shape the same limit must
    reject the plain outputs made 5% low on the back half of the query
    rows (dq) or of the keys (dk, dv). On the LM's strided views the two
    kernel calls must ask for dq, dk and dv and nothing else at any
    moment, flash_attention_bwd (which decides what to copy) for no more
    than its D = rowsum(dO * O) pass alone asks for, and two calls must
    give the same bits. Times: CUDA events around the wrapper and
    CUDA-graph device times."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import flash_attention as fa

    def peak_new_bytes(fn):
        """fn's result and the most bytes beyond those held before that
        it asked of the caching allocator at any moment, unrounded: a
        copy made and freed inside fn counts."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_stats()["requested_bytes.all.current"]
        out = fn()
        torch.cuda.synchronize()
        return out, (torch.cuda.memory_stats()["requested_bytes.all.peak"]
                     - before)

    results = []
    for shape, dtype_name, causal, layout in BWD_CASES:
        dtype = getattr(torch, dtype_name)
        q, k, v, do = _bwd_inputs(shape, dtype, layout, 10 + len(results))
        b, h, t, d = shape
        scale = 1.0 / d ** 0.5
        o, lse = fa.attention_reference(q, k, v, causal=causal)
        dcap = (do.float() * o.float()).sum(-1)
        want = fa.attention_bwd_reference(q, k, v, o, lse, do,
                                          causal=causal)
        bf16 = dtype == torch.bfloat16
        tol = 1e-2 if bf16 else 1e-4

        def run():
            return (fa.flash_bwd_dq(q, k, v, do, lse, dcap, causal,
                                    scale),) + fa.flash_bwd_dkv(
                q, k, v, do, lse, dcap, causal, scale)

        got = None   # the last case's outputs, freed before counting
        got, new_bytes = peak_new_bytes(run)
        again = run()
        torch.cuda.synchronize()
        same_bits = all(torch.equal(a, c) for a, c in zip(got, again))
        del again
        names = ("dq", "dk", "dv")
        err = {n: closeness(a, w, tol) for n, a, w in zip(names, got, want)}
        for n, w in zip(names, want):
            wf = w.float()
            err[n].update(max_plain=wf.abs().max().item(),
                          rms_plain=wf.pow(2).mean().sqrt().item(),
                          rms_plain_back_half=wf[:, :, t // 2:].pow(
                              2).mean().sqrt().item())
        rec = {"phase": "kernel_check", "kernel": "flash_bwd",
               "shape": list(shape), "dtype": dtype_name, "causal": causal,
               "layout": layout,
               "read_in_place": all(fa.tma_strides(x) is not None
                                    for x in (q, k, v, do)),
               "new_device_bytes": new_bytes, "same_bits": same_bits,
               "err": err, "tol": tol}
        if layout == "lm":
            # the wrapper's own temporaries are D's f32 pass; a copy of
            # q, k, v or dO would be held through it and add its bytes
            _, d_bytes = peak_new_bytes(
                lambda: (do.float() * o.float()).sum(-1))
            full, full_bytes = peak_new_bytes(
                lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                               causal=causal))
            rec.update(bwd_new_device_bytes=full_bytes,
                       d_pass_new_device_bytes=d_bytes,
                       bwd_same_bits=all(torch.equal(a, c)
                                         for a, c in zip(full, got)))
            del full
        if len(results) == 0:
            bad = {}
            for n, w in zip(names, want):
                wrong = w.clone()
                wrong[:, :, t // 2:] *= 0.95
                bad[n] = closeness(wrong, w, tol)
            rec["limit_rejects_5pct_back_half"] = bad
            if any(within(c, tol) for c in bad.values()):
                raise AssertionError("the limit passes outputs 5%% off on "
                                     "the back half: %r" % bad)
        calls = {"dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, dcap,
                                               causal, scale),
                 "dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, dcap,
                                                 causal, scale)}
        ms = {n: cuda_ms(f) for n, f in calls.items()}
        dev_ms = {n: graph_ms(f) for n, f in calls.items()}
        plain_ms = cuda_ms(lambda: fa.attention_bwd_reference(
            q, k, v, o, lse, do, causal=causal), iters=5)
        qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            out, (qr, kr, vr), do, retain_graph=True))
        peak = PEAK_BF16 if bf16 else PEAK_F32
        for n, kname in (("dq", "flash_bwd_dq"), ("dkv", "flash_bwd_dkv")):
            bound, by = bound_ms(kname, b, h, t, t, d, causal,
                                 2 if bf16 else 4, peak)
            flops = attention_flops(b, h, t, t, d, causal, WORK[kname][0])
            rec[n] = {"ms": ms[n], "graph_ms": dev_ms[n], "bound_ms": bound,
                      "bound_by": by,
                      "achieved_tflops": flops / (dev_ms[n] * 1e-3) / 1e12}
        rec.update({"plain_bwd_ms": plain_ms, "sdpa_bwd_ms": lib_ms})
        log(rec)
        if not all(within(e, tol) for e in err.values()):
            raise AssertionError("flash backward disagrees with its plain "
                                 "version at %s: %r" % (shape, rec))
        if not same_bits:
            raise AssertionError("flash backward gave other bits on a "
                                 "second call: %r" % rec)
        if layout == "lm" and not (
                rec["read_in_place"] and new_bytes == sum(
                    x.numel() * x.element_size() for x in got)
                and full_bytes == d_bytes and rec["bwd_same_bits"]):
            raise AssertionError("the LM's views were not read in place: "
                                 "%r" % rec)
        results.append(rec)
        del qr, kr, vr, out
    return results


def _train_batch(cfg, batch, seed=0):
    import numpy as np

    rng = np.random.RandomState(seed)
    # seq + 1 tokens a row: loss_fn shifts them for next-token targets
    return {"tokens": rng.randint(0, cfg.vocab_size,
                                  (batch, cfg.max_seq_len + 1)).astype(
                                      np.int32)}


def phase_grad_check(device="cuda", model_kw=dict(TRAIN, num_layers=2),
                     batch=TRAIN_BATCH):
    """One step's gradients through the kernels (K2/K3/K4 inside
    FlashAttention) against the same loss with the plain attention under
    autograd, per parameter tensor, at 2 layers of the full width:
    ||g - g_plain|| <= 5e-2 ||g_plain||. The paths differ only where
    they round to bf16 (steps of 2^-8, about 1.1e-3 rms relative per
    rounding), and the difference compounds from the attention down to
    the first layer's weights: on the CPU, where both paths are plain
    PyTorch and differ only in the backward's formula, the same check
    at 2 layers of width 128 gives up to 6.4e-3. A wrong gradient is off
    by O(1)."""
    import torch

    from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                    init_params, loss_fn)
    from mxnet_tpu_torch.ops.flash_attention import attention_reference

    cfg = TransformerConfig(**model_kw)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(1),
                         device)
    data = _train_batch(cfg, batch, seed=1)

    def grads(attn_fn):
        p = _tree_map(lambda t: t.detach().clone().requires_grad_(), params)
        loss = loss_fn(cfg, attn_fn=attn_fn)(p, data, None)
        loss.backward()
        return loss.item(), [t.grad.float() for t in _leaves(p)]

    l_k, g_k = grads(None)
    l_p, g_p = grads(
        lambda q, k, v: attention_reference(q, k, v, causal=True)[0])
    rel = [((a - b).norm() / b.norm().clamp_min(1e-30)).item()
           for a, b in zip(g_k, g_p)]
    rec = {"phase": "grad_check", "layers": cfg.num_layers,
           "batch": batch, "seq": cfg.max_seq_len, "loss": l_k,
           "loss_plain": l_p, "tensors": len(rel), "max_rel_l2": max(rel),
           "rel_l2": rel, "tol_rel_l2": 5e-2}
    log(rec)
    if not (abs(l_k - l_p) <= 1e-2 and max(rel) <= 5e-2):
        raise AssertionError("kernel gradients disagree with the plain "
                             "attention's: %r" % rec)
    return rec


def phase_training(device="cuda", model_kw=TRAIN, batch=TRAIN_BATCH,
                   steps=5):
    """The training path: ShardedTrainer over loss_fn with Adam 1e-4,
    one warm-up step and ``steps - 1`` timed steps on a fixed batch.
    ``device``/``model_kw``/``batch`` let a CPU rehearsal run the same
    code at a tiny size. Returns the launch counts."""
    import math

    import torch

    from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                    init_params, loss_fn)
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.parallel import ShardedTrainer

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    cfg = TransformerConfig(**model_kw)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    n_params = sum(t.numel() for t in _leaves(params))
    data = _train_batch(cfg, batch)
    trainer = ShardedTrainer(loss_fn(cfg), params,
                             lambda ps: torch.optim.Adam(ps, lr=1e-4))
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sync()
    fa.flash_attention.launches = 0
    fa.flash_bwd_dq.launches = 0
    fa.flash_bwd_dkv.launches = 0
    losses, secs = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(trainer.step(data).item())
        sync()
        secs.append(time.perf_counter() - t0)
    counts = {"flash_fwd": fa.flash_attention.launches,
              "flash_bwd_dq": fa.flash_bwd_dq.launches,
              "flash_bwd_dkv": fa.flash_bwd_dkv.launches}

    step_s = sum(secs[1:]) / len(secs[1:])
    tokens = batch * cfg.max_seq_len
    flops = model_flops_per_token(cfg, cfg.max_seq_len) * tokens
    rec = {"phase": "training", "params": n_params, "batch": batch,
           "seq": cfg.max_seq_len, "optimizer": "adam 1e-4",
           "steps": steps, "losses": losses, "step_s": secs,
           "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
           "model_tflop_per_step": flops / 1e12,
           "mfu": flops / step_s / PEAK_BF16 if device == "cuda" else None,
           "launches": counts,
           "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                           if device == "cuda" else None)}
    log(rec)
    expected = cfg.num_layers * steps if device == "cuda" else 0
    if any(n != expected for n in counts.values()):
        raise AssertionError("training launched %r, expected %d each"
                             % (counts, expected))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("non-finite loss: %r" % losses)
    if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
        raise AssertionError("step-0 loss %g is not within 0.5 of ln(%d)"
                             % (losses[0], cfg.vocab_size))
    if not losses[-1] < losses[0]:
        raise AssertionError("loss did not fall: %r" % losses)
    return counts


def phase_serving(device="cuda", model_kw=FLAGSHIP, long_len=2048):
    """The main path; ``device``/``model_kw``/``long_len`` let a CPU
    rehearsal run the same code at a tiny size."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                    forward, init_params)
    from mxnet_tpu_torch.ops.flash_attention import (attention_reference,
                                                     flash_attention)
    from mxnet_tpu_torch.parallel import create_mesh
    from mxnet_tpu_torch.serving import Engine, ServingConfig, cp_prefill_kv

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    cfg = TransformerConfig(**model_kw)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    n_params = sum(t.numel() for t in _leaves(params))
    mesh = create_mesh((1,), ("seq",), devices=[device])
    scfg = ServingConfig(mesh=mesh, cp_kind="ulysses",
                         cp_min_tokens=long_len, block_size=16,
                         num_blocks=512, max_batch=8, prefill_chunk=64)
    eng = Engine(params, cfg, scfg, device=device)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (long_len, long_len, 5, 37)]
    new = 16

    sync()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new_tokens=new)
    sync()
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    stats = eng.stats()
    ttfts, _ = eng.latency_samples()

    expected = 2 * cfg.num_layers if device == "cuda" else 0
    if launches != expected:
        raise AssertionError("flash_fwd launched %d times on the serving "
                             "path, expected %d" % (launches, expected))
    if [len(s) for s in outs] != [new] * len(prompts):
        raise AssertionError("stream lengths %r" % [len(s) for s in outs])
    if stats["cp_prefills"] != 2:
        raise AssertionError("cp prefills: %d" % stats["cp_prefills"])

    def plain_attn(q, k, v):
        return attention_reference(q, k, v, causal=True)[0]

    checks = []
    with torch.no_grad():
        unembed = params["embed"].float().T
        for i, (p, s) in enumerate(zip(prompts, outs)):
            # teacher-forced plain forward over prompt + stream
            seq = np.concatenate([p, np.asarray(s[:-1], np.int32)])
            ref = forward(params, seq[None], cfg, attn_fn=plain_attn)[0]
            ref = ref[len(p) - 1:].float()
            if not torch.isfinite(ref).all():
                raise AssertionError("non-finite reference logits")
            top2 = ref.topk(2, dim=-1).values
            gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
            arg = ref.argmax(dim=-1).cpu().numpy()
            rec = {"prompt_len": int(len(p)), "first_token": int(s[0]),
                   "ref_argmax0": int(arg[0]), "top2_gap0": float(gap[0])}
            if len(p) >= scfg.cp_min_tokens:
                _, _, x_last = cp_prefill_kv(params, cfg, p, mesh,
                                             kind="ulysses")
                cp_logits = x_last @ unembed
                diff = (cp_logits - ref[0]).abs().max().item()
                rec["cp_logits_max_abs_diff"] = diff
                if not diff <= 5e-2:
                    raise AssertionError("cp logits differ from forward "
                                         "by %g > 5e-2" % diff)
                if gap[0] > diff and int(s[0]) != int(arg[0]):
                    raise AssertionError("cp first token %d != forward "
                                         "argmax %d (gap %g > diff %g)"
                                         % (s[0], arg[0], gap[0], diff))
            # the rest of the stream: where forward's top-2 gap is wide
            # (> 0.25, far above bf16 path differences) the engine's
            # greedy token must be forward's argmax
            wide = gap > 0.25
            bad = int(np.sum(wide & (np.asarray(s) != arg)))
            rec.update({"tokens_checked": int(wide.sum()),
                        "mismatches_at_wide_gap": bad,
                        "agree_all": int(np.sum(np.asarray(s) == arg))})
            log(dict(phase="serving_check", **rec))
            if bad:
                raise AssertionError("stream %d disagrees with forward at "
                                     "%d wide-gap positions" % (i, bad))
            checks.append(rec)
    tokens = sum(len(s) for s in outs)
    log({"phase": "serving", "params": n_params, "prompts":
         [int(len(p)) for p in prompts], "max_new_tokens": new,
         "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
         "ttft_s": ttfts, "ttft_p50_s": stats["ttft_p50_s"],
         "token_latency_p50_s": stats["token_latency_p50_s"],
         "steps": stats["steps"], "flash_fwd_launches": launches,
         "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                         if device == "cuda" else None)})
    return launches


# the sampled + speculative serving leg: bench_serve.py:264-290's draft
# (the first DRAFT_LAYERS layers, shared embeddings; the target's tail
# wo/w2 scaled by DRAFT_RESID, bench_serve.py:318-319) and its requests:
# (prompt length or "long", sampling kwargs)
DRAFT_LAYERS = 1
DRAFT_RESID = 0.005
SAMPLED_REQUESTS = [("long", dict(temperature=0.8, top_p=0.95, seed=1)),
                    ("long", {}),
                    (5, dict(temperature=1.0, top_k=50, seed=2)),
                    (37, {})]
SAMPLER_TV = 0.03   # total variation of 65,536 draws from filter_dist's


def sampler_bits_check(device, V=32000, n=64):
    """Threefry keys, bits and uniforms for ``n`` (seed, position, salt)
    triples on ``device`` against the host's: equal bit for bit (the CPU
    tests hold the host's equal to JAX's); Gumbels within 2 ulp of
    max(|g|, 1)."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import threefry as tf

    rng = np.random.RandomState(3)
    seed = np.concatenate([[0, 2 ** 32 - 1], rng.randint(
        0, 2 ** 32, n - 2, dtype=np.uint64)]).astype(np.uint32)
    pos = rng.randint(0, 2 ** 31, n).astype(np.int64)
    salt = rng.randint(0, 4, n)

    def draws(dev):
        k = tf.fold_in(tf.fold_in(tf.prng_key(seed, dev), pos), salt)
        return [t.cpu() for t in (k, tf.random_bits(k, V),
                                  tf.uniform(k, V), tf.gumbel(k, V))]

    dk, dbits, du, dg = draws(device)
    hk, hbits, hu, hg = draws("cpu")
    if not (torch.equal(dk, hk) and torch.equal(dbits, hbits)
            and torch.equal(du.view(torch.int32), hu.view(torch.int32))):
        raise AssertionError("threefry keys, bits or uniforms on %s differ "
                             "from the host's" % device)
    spacing = np.spacing(np.maximum(hg.abs().numpy(), 1))
    ulp = float(np.max(np.abs((dg - hg).double().numpy()) / spacing))
    if not ulp <= 2.0:
        raise AssertionError("Gumbels on %s differ from the host's by %g "
                             "ulp > 2" % (device, ulp))
    return {"triples": n, "V": V, "keys_bits_uniforms_equal": True,
            "gumbel_max_ulp": ulp}


def sampler_distribution(device, V=32000, rows=65536, chunk=4096):
    """``sample_tokens`` over one fixed logits row, batched as ``rows``
    rows with seeds 0..rows-1 at one position (temperature 0.8, top_k
    50), in calls of ``chunk`` rows; the total variation between the
    draws' frequencies and ``filter_dist``'s probabilities."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.serving import sampling as samp

    g = torch.Generator(device=device).manual_seed(5)
    row = torch.randn(1, V, generator=g, device=device) * 2
    counts = torch.zeros(V, dtype=torch.int64, device=device)
    with torch.no_grad():
        for c0 in range(0, rows, chunk):
            n = min(chunk, rows - c0)
            tok, _ = samp.sample_tokens(
                row.expand(n, V), np.full(n, 0.8, np.float32),
                np.full(n, 50), np.ones(n, np.float32),
                np.arange(c0, c0 + n, dtype=np.uint32), np.full(n, 7),
                samp.SALT_TARGET)
            counts += torch.bincount(tok.long(), minlength=V)
        _, probs = samp.filter_dist(row, [0.8], [50], [1.0])
    freq = counts.double() / rows
    tv = 0.5 * float((freq - probs[0].double()).abs().sum())
    if not tv <= SAMPLER_TV:
        raise AssertionError("sampler total variation %g > %g"
                             % (tv, SAMPLER_TV))
    return {"rows": rows, "calls": -(-rows // chunk), "V": V, "tv": tv,
            "support": int((counts > 0).sum())}


def phase_serving_sampled(device="cuda", model_kw=FLAGSHIP, long_len=2048,
                          new=32, card=None, dist_rows=65536,
                          dist_chunk=4096, bits_v=32000):
    """Sampled and speculative serving on the main path: the flagship LM
    with bench_serve.py's 1-layer draft behind ``Engine(spec=True)``,
    two ``long_len`` prompts through the Ulysses cp prefill (K2) and two
    short ones, one of each pair sampled. ``device``/``model_kw`` and
    the sizes let a CPU rehearsal run the same code small."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import threefry as tf
    from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                    forward, init_params)
    from mxnet_tpu_torch.ops.flash_attention import (attention_reference,
                                                     flash_attention)
    from mxnet_tpu_torch.parallel import create_mesh
    from mxnet_tpu_torch.serving import Engine, ServingConfig
    from mxnet_tpu_torch.serving import sampling as samp

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    bits = sampler_bits_check(device, V=bits_v)
    log(dict(phase="serving_sampled_bits", **bits))

    cfg = TransformerConfig(**model_kw)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    # bench_serve.make_draft: the tail layers' residual writes scaled,
    # the draft the first layers with shared embeddings
    for lp in params["layers"][DRAFT_LAYERS:]:
        lp["wo"] = lp["wo"] * DRAFT_RESID
        lp["w2"] = lp["w2"] * DRAFT_RESID
    draft = {"embed": params["embed"], "pos_embed": params["pos_embed"],
             "layers": params["layers"][:DRAFT_LAYERS],
             "ln_f": params["ln_f"]}
    dcfg = TransformerConfig(**dict(model_kw, num_layers=DRAFT_LAYERS))
    mesh = create_mesh((1,), ("seq",), devices=[device])
    rng = np.random.RandomState(1)
    requests = [(rng.randint(0, cfg.vocab_size, (
        long_len if n == "long" else n,)).astype(np.int32), kw)
                for n, kw in SAMPLED_REQUESTS]

    def engine(spec):
        scfg = ServingConfig(spec=spec, spec_k=4, mesh=mesh,
                             cp_kind="ulysses", cp_min_tokens=long_len,
                             block_size=16, num_blocks=512, max_batch=8,
                             prefill_chunk=64)
        if not spec:
            return Engine(params, cfg, scfg, device=device)
        return Engine(params, cfg, scfg, draft_params=draft, draft_cfg=dcfg,
                      device=device)

    def serve(eng, reqs):
        sync()
        t0 = time.perf_counter()
        hs = [eng.submit(p, max_new_tokens=new, **kw) for p, kw in reqs]
        eng.run_until_idle()
        outs = [h.result(timeout=60) for h in hs]
        sync()
        wall = time.perf_counter() - t0
        ttfts, _ = eng.latency_samples()
        toks = sum(len(s) for s in outs)
        if [len(s) for s in outs] != [new] * len(reqs):
            raise AssertionError("stream lengths %r" % [len(s) for s in outs])
        return outs, {"tokens": toks, "wall_s": wall,
                      "tokens_per_s": toks / wall, "ttft_s": ttfts,
                      "steps": eng.stats()["steps"]}

    # the main path: counts zeroed just before, read just after
    eng = engine(True)
    sync()
    flash_attention.launches = 0
    tf.threefry2x32.calls.clear()
    outs, spec_run = serve(eng, requests)
    launches = flash_attention.launches
    draws = dict(tf.threefry2x32.calls)
    stats = eng.stats()
    expected = 2 * cfg.num_layers if on_card else 0
    if launches != expected:
        raise AssertionError("flash_fwd launched %d times on the sampled "
                             "serving path, expected %d"
                             % (launches, expected))
    if set(draws) != {torch.device(device).type}:
        raise AssertionError("threefry draws ran on %r, not %s"
                             % (draws, device))
    if stats["cp_prefills"] != 2:
        raise AssertionError("cp prefills: %d" % stats["cp_prefills"])
    if not (stats["spec_turns"] > 0 and stats["spec_tokens_accepted"] > 0):
        raise AssertionError("no speculative acceptance: %r" % {
            k: stats[k] for k in ("spec_turns", "spec_tokens_drafted",
                                  "spec_tokens_accepted")})

    def plain_attn(q, k, v):
        return attention_reference(q, k, v, causal=True)[0]

    checks = []
    with torch.no_grad():
        for i, ((p, kw), s) in enumerate(zip(requests, outs)):
            if kw:
                continue
            # greedy rows: forward's argmax wherever its top-2 gap is
            # wide (phase_serving's rule)
            seq = np.concatenate([p, np.asarray(s[:-1], np.int32)])
            ref = forward(params, seq[None], cfg, attn_fn=plain_attn)[0]
            ref = ref[len(p) - 1:].float()
            if not torch.isfinite(ref).all():
                raise AssertionError("non-finite reference logits")
            top2 = ref.topk(2, dim=-1).values
            gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
            arg = ref.argmax(dim=-1).cpu().numpy()
            wide = gap > 0.25
            bad = int(np.sum(wide & (np.asarray(s) != arg)))
            rec = {"prompt_len": int(len(p)),
                   "tokens_checked": int(wide.sum()),
                   "mismatches_at_wide_gap": bad,
                   "agree_all": int(np.sum(np.asarray(s) == arg))}
            log(dict(phase="serving_sampled_check", **rec))
            if bad:
                raise AssertionError("greedy stream %d disagrees with "
                                     "forward at %d wide-gap positions"
                                     % (i, bad))
            checks.append(rec)

    # a fresh engine replays the sampled streams; other seeds change one.
    # Plain (spec off) engines on the same requests alternate with these
    # two warm spec runs, so each spec run has a warm plain run before it
    plain_outs, plain_a = serve(engine(False), requests)
    replay, replay_run = serve(engine(True), requests)
    if replay != outs:
        raise AssertionError("a fresh spec engine did not replay the "
                             "streams: %r" % [a == b for a, b in
                                              zip(replay, outs)])
    _, plain_b = serve(engine(False), requests)
    reseeded = [(p, dict(kw, seed=kw["seed"] + 100) if kw else kw)
                for p, kw in requests]
    other, other_run = serve(engine(True), reseeded)
    sampled_rows = [i for i, (_, kw) in enumerate(requests) if kw]
    if all(other[i] == outs[i] for i in sampled_rows):
        raise AssertionError("other seeds gave the same sampled streams")

    dist = sampler_distribution(device, V=cfg.vocab_size, rows=dist_rows,
                                chunk=dist_chunk)
    log(dict(phase="serving_sampled_distribution", **dist))

    timing = {}
    if on_card:
        g = torch.Generator(device=device).manual_seed(6)
        logits = torch.randn(8, cfg.vocab_size, generator=g,
                             device=device) * 2
        pos = torch.arange(8, device=device) + 2048
        seeds = np.arange(8, dtype=np.uint32)
        for name, temp in (("sampled", 0.8), ("greedy", 0.0)):
            timing["sampler_%s_ms" % name] = cuda_ms(
                lambda: samp.sample_tokens(
                    logits, np.full(8, temp, np.float32), np.full(8, 50),
                    np.ones(8, np.float32), seeds, pos, samp.SALT_TARGET))
        # one draft turn and one verify at B = 4 (inactive rows: their
        # writes land in the scratch block), sampled and all-greedy
        B, K = 4, eng.cfg.spec_k
        bt = np.zeros((B, eng.model.max_blocks), np.int32)
        act = np.zeros(B, bool)
        start = np.full(B, long_len, np.int32)
        ks = np.full(B, K, np.int32)
        for name, temp in (("sampled", 0.8), ("greedy", 0.0)):
            kw = dict(temperature=np.full(B, temp, np.float32),
                      top_p=np.full(B, 0.95, np.float32),
                      seed=np.arange(B, dtype=np.uint32))

            def turn():
                return eng.draft_model.draft_turn(
                    eng.draft_params, eng.draft_pool.k, eng.draft_pool.v,
                    np.zeros((B, 1), np.int32), start, np.ones(B, np.int32),
                    bt, act, ks, K, **kw)

            d, q = turn()
            timing["draft_turn_%s_ms" % name] = cuda_ms(turn, iters=10)
            timing["verify_%s_ms" % name] = cuda_ms(
                lambda: eng.model.verify(
                    eng.params, eng.pool.k, eng.pool.v,
                    np.zeros((B, 1), np.int32), d, q, start, 1 + ks, bt,
                    act, **kw), iters=10)
    log({"phase": "serving_sampled", "card": card,
         "requests": [{"prompt_len": int(len(p)), **kw}
                      for p, kw in requests],
         "max_new_tokens": new, "spec_k": eng.cfg.spec_k,
         "draft_layers": DRAFT_LAYERS, "draft_resid": DRAFT_RESID,
         "spec": spec_run, "spec_warm": [replay_run, other_run],
         "plain_warm": [plain_a, plain_b],
         # smoke-level only: 4 requests, 4 x new tokens a run
         "spec_over_plain_warm_smoke": [
             s["tokens_per_s"] / p["tokens_per_s"]
             for s, p in ((replay_run, plain_a), (other_run, plain_b))],
         "plain_equal_on_greedy_rows": [
             plain_outs[i] == outs[i]
             for i, (_, kw) in enumerate(requests) if not kw],
         "spec_turns": stats["spec_turns"],
         "spec_tokens_drafted": stats["spec_tokens_drafted"],
         "spec_tokens_accepted": stats["spec_tokens_accepted"],
         "accept_rate": stats["spec_accept_rate"],
         # over every row of a turn, not per request
         "accepted_per_engine_turn": (stats["spec_tokens_accepted"]
                                      / stats["spec_turns"]),
         "threefry_calls": draws, "flash_fwd_launches": launches,
         "timing": timing, "peak_mem_gb": (
             torch.cuda.max_memory_allocated() / 1e9 if on_card else None)})
    return launches


# the row-softmax kernel K1: (shape, dtype name, input scale)
SOFTMAX_CASES = [((64, 10), "float32", 1.0), ((128, 1000), "float32", 1.0),
                 ((128, 1000), "float32", 50.0),
                 ((1000, 1001), "float16", 1.0),
                 ((4096, 32000), "bfloat16", 1.0),
                 ((8, 2097152), "float32", 1.0), ((3, 1), "float32", 1.0),
                 ((1920, 200), "float32", 1.0),   # the LSTM's T = 60 bucket
                 ((128, 1000), "bfloat16", 1.0),  # bench.py's bf16 step
                 ((256, 1000), "float32", 1.0),   # Inception-BN's fit
                 ((128, 10), "float32", 1.0),     # train_cifar10's fit
                 ((32, 3), "float32", 1.0),       # Faster R-CNN's head
                 ((256, 4), "float32", 1.0)]      # ResNet-50 from the .rec
SOFTMAX_OPS = 5   # f32 operations an element: max, subtract, exp, sum, divide


def softmax_bound_ms(n, c, elem_bytes):
    """Least time for a row softmax: x read once and y written once at
    the memory rate, against 5 f32 operations an element at the f32
    peak; returns (ms, "bytes" or "operations")."""
    t_bytes = 2.0 * n * c * elem_bytes / PEAK_BYTES
    t_ops = SOFTMAX_OPS * n * c / PEAK_F32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_softmax_kernel():
    """K1 on the card against softmax_reference under :func:`closeness`
    (tol 1e-4 f32: summation order only; 1e-2 bf16/f16: both round
    their output to the type, one step apart at most). Times: ``ms`` and
    ``library_ms`` (``torch.softmax``) by CUDA events around 20 calls
    from the host, ``graph_ms``/``library_graph_ms`` from a CUDA graph of
    20 calls (device time alone)."""
    import torch

    from mxnet_tpu_torch.ops.softmax import (fused_softmax, softmax_reference,
                                             variant)

    results = []
    for shape, dtype_name, scale in SOFTMAX_CASES:
        dtype = getattr(torch, dtype_name)
        g = torch.Generator(device="cuda").manual_seed(20 + len(results))
        x = (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)
        y = fused_softmax(x)
        want = softmax_reference(x)
        torch.cuda.synchronize()
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        close = closeness(y, want, tol)
        elem = x.element_size()
        bound, by = softmax_bound_ms(shape[0], shape[1], elem)
        rec = {"phase": "kernel_check", "kernel": "softmax",
               "shape": list(shape), "dtype": dtype_name, "scale": scale,
               "variant": variant(shape[1], x.element_size()),
               "max_abs_err": close["abs"], "closeness": close, "tol": tol,
               "ms": cuda_ms(lambda: fused_softmax(x)),
               "plain_ms": cuda_ms(lambda: softmax_reference(x)),
               "library_ms": cuda_ms(lambda: torch.softmax(x, dim=-1)),
               "graph_ms": graph_ms(lambda: fused_softmax(x)),
               "library_graph_ms": graph_ms(
                   lambda: torch.softmax(x, dim=-1)),
               "bound_ms": bound, "bound_by": by,
               "bytes": 2 * shape[0] * shape[1] * elem}
        rec["achieved_tb_s"] = rec["bytes"] / (rec["ms"] * 1e-3) / 1e12
        log(rec)
        if not (y.dtype == dtype and y.shape == x.shape
                and within(close, tol)):
            raise AssertionError("softmax kernel disagrees with its plain "
                                 "version at %s: %r" % (shape, rec))
        results.append(rec)
        del x, y, want
    softmax_edges()
    return results


def softmax_edges():
    """K1's edge cases on the card, each against softmax_reference:
    37 rows (no multiple of any variant's rows a block) at the widths on
    both sides of every variant boundary, in f32, bf16 and f16 (tolerances
    as in :func:`phase_softmax_kernel`); and rows with some -inf, all
    -inf, a NaN and a +inf at widths of every variant, which must give the
    plain version's NaN pattern and its values elsewhere."""
    import torch

    from mxnet_tpu_torch.ops import softmax as sm

    worst, cases, bad = 0.0, 0, []
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        elem = torch.tensor([], dtype=dtype).element_size()
        v = 16 // elem
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        limits = list(sm.SCALAR_CAPACITY) + [cap * v + v - 1
                                             for cap in sm.VECTOR_CAPACITY]
        widths = sorted({1, 2, 10, 31, 32, 33}
                        | {c + d for c in limits for d in (0, 1)})
        g = torch.Generator(device="cuda").manual_seed(60)
        for c in widths:
            x = torch.randn(37, c, generator=g, device="cuda").to(dtype)
            close = closeness(sm.fused_softmax(x), sm.softmax_reference(x),
                              tol)
            worst = max(worst, close["elem"])
            cases += 1
            if not within(close, tol):
                bad.append(("width", str(dtype), c, close))
        for c in (10, 1000, 10000, 20000, 40000):
            x = torch.randn(6, c, generator=g, device="cuda").to(dtype)
            x[1, ::3] = float("-inf")
            x[2] = float("-inf")
            x[3, c // 2] = float("nan")
            x[4, c - 1] = float("inf")
            y, want = sm.fused_softmax(x), sm.softmax_reference(x)
            nan = torch.isnan(want.float())
            ok = ~nan.any(dim=1)
            cases += 1
            if not (torch.equal(torch.isnan(y.float()), nan)
                    and within(closeness(y[ok], want[ok], tol), tol)):
                bad.append(("inf_nan", str(dtype), c))
    torch.cuda.synchronize()
    log({"phase": "kernel_edges", "kernel": "softmax", "cases": cases,
         "worst_elem": worst, "failed": [repr(b) for b in bad]})
    if bad:
        raise AssertionError("softmax kernel fails edge cases: %r" % bad)


# K6, the matmul with column statistics: (M, K, N, mean of x) beside the
# probe's four shapes (tools/torch_probe_matmul_stats.py SHAPES): a ragged
# M, and shape C with x = randn + 0.5, whose column sums are far from zero,
# so a dropped or doubled row tile moves them well past the limit; then
# edges: one row (twice, on two seeds), M not a multiple of 64, K of 16
# and 48, N of 8, 72, 200 (136 pads to 256 with a slab of w never
# loaded).
MATMUL_STATS_EXTRA = [(1000, 64, 256, 0.0), (128 * 28 * 28, 512, 128, 0.5),
                      (1, 64, 256, 0.0), (1, 64, 256, 0.5),
                      (8447, 64, 136, 0.5),
                      (777, 16, 128, 0.5), (999, 48, 64, 0.5),
                      (1000, 64, 8, 0.5), (1000, 64, 72, 0.5),
                      (3000, 128, 200, 0.5)]


def matmul_stats_bound_ms(m, k, n):
    """Least time for K6 on [m, k] x [k, n] bf16: x and w read once, y
    (bf16) and s, s2 (f32) written once at the memory rate, against
    2*m*k*n operations at the bf16 tensor-core peak; returns (ms, "bytes"
    or "operations")."""
    t_bytes = (2.0 * (m * k + k * n + m * n) + 8.0 * n) / PEAK_BYTES
    t_ops = 2.0 * m * k * n / PEAK_BF16
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def matmul_stats_limits(x, w):
    """The limits on K6's s and s2, [1, N] each, against its plain
    version's. Both sides take f32 sums of the same exact products, over
    k for each acc and over rows for s, in other orders, and an f32 sum
    errs in proportion to the sum of its terms' sizes: for s that is the
    column's sum over rows and k of |x_ik w_kj|, however far the signed
    terms cancel; s2's terms move by 2 |acc| times acc's error. The
    limit is 1e-5 of each."""
    xf, wf = x.float(), w.float()
    size = xf.abs() @ wf.abs()   # each acc's sum of |products|
    return (1e-5 * size.sum(0, keepdim=True),
            1e-5 * (2.0 * (xf @ wf).abs() * size).sum(0, keepdim=True))


def matmul_stats_check(got, want, x, w):
    """K6's ``(y, s, s2)`` against its plain version's: y under
    :func:`closeness` (tol 1e-2: both round the f32 acc to bf16 once, one
    step apart at most); s and s2 per column within
    :func:`matmul_stats_limits`. Returns each output's max abs error and
    worst ratio to its limit, and ``ok``."""
    y, s, s2 = got
    yr, sr, s2r = want
    lim_s, lim_s2 = matmul_stats_limits(x, w)
    ds, ds2 = (s - sr).abs(), (s2 - s2r).abs()
    out = {"y": closeness(y, yr, 1e-2),
           "s": {"abs": ds.max().item(),
                 "elem": (ds / lim_s.clamp_min(1e-30)).max().item()},
           "s2": {"abs": ds2.max().item(),
                  "elem": (ds2 / lim_s2.clamp_min(1e-30)).max().item()}}
    out["worst"] = max(out["y"]["elem"], out["y"]["rel_l2"] / 1e-2,
                       out["s"]["elem"], out["s2"]["elem"])
    out["ok"] = (y.dtype == yr.dtype and y.shape == yr.shape
                 and s.shape == sr.shape and s2.shape == s2r.shape
                 and out["worst"] <= 1.0)
    return out


def load_probe():
    """``tools/torch_probe_matmul_stats.py``, K6's entry point, as a
    module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "torch_probe_matmul_stats.py")
    spec = importlib.util.spec_from_file_location("torch_probe_matmul_stats",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_matmul_stats(device="cuda", probe_shapes=None, extra=None):
    """K6 on the card against matmul_stats_reference under
    :func:`matmul_stats_check` at the probe's four shapes and
    MATMUL_STATS_EXTRA (inputs seeded on the device), and against itself
    (the same bits on a second call), with a check that the limit on s
    rejects the plain s with one 64-row tile (``ROW_TILE``) dropped at
    each nonzero-mean shape; then the probe's path (``run`` of
    ``tools/torch_probe_matmul_stats.py``: its checks against the unfused
    sequence, two calls of K6 a shape) with K6's count zeroed just before
    and read just after, and then the probe's times (a second ``run``,
    whose timing launches, graph captures among them, are not counted).
    ``probe_shapes`` and ``extra`` shrink it for a CPU rehearsal, where
    the kernel is its plain version."""
    import torch

    from mxnet_tpu_torch.ops import matmul_stats as ms

    probe = load_probe()
    probe_shapes = probe.SHAPES if probe_shapes is None else probe_shapes
    extra = MATMUL_STATS_EXTRA if extra is None else extra
    cases = [(m, k, n, 0.0) for m, k, n in probe_shapes] + list(extra)
    checks = []
    for i, (m, k, n, mean) in enumerate(cases):
        g = torch.Generator(device=device).manual_seed(40 + i)
        x = (torch.randn(m, k, generator=g, device=device) + mean).to(
            torch.bfloat16)
        w = (torch.randn(k, n, generator=g, device=device) * 0.05).to(
            torch.bfloat16)
        got = ms.matmul_stats(x, w)
        again = ms.matmul_stats(x, w)
        want = ms.matmul_stats_reference(x, w)
        _sync(device)
        rec = {"phase": "kernel_check", "kernel": "matmul_stats",
               "shape": [m, k, n], "x_mean": mean,
               "plan": ms.plan(m, k, n) if device != "cuda" else ms.plan(
                   m, k, n, ms.sm_count(x.device)),
               "check": matmul_stats_check(got, want, x, w),
               "same_bits": all(torch.equal(a, b)
                                for a, b in zip(got, again))}
        if mean:
            acc_top = (x[:ms.ROW_TILE].float() @ w.float()).sum(
                0, keepdim=True)
            dropped = matmul_stats_check(
                (want[0], want[1] - acc_top, want[2]), want, x, w)
            rec["limit_rejects_dropped_tile"] = dropped["s"]
            if dropped["ok"]:
                raise AssertionError("the limit on s passes a sum with a "
                                     "row tile dropped: %r" % dropped)
        log(rec)
        if not (rec["check"]["ok"] and rec["same_bits"]):
            raise AssertionError("matmul_stats kernel disagrees with its "
                                 "plain version, or with itself on a second "
                                 "call, at %s: %r" % (cases[i], rec))
        checks.append(rec)
        del x, w, got, again, want

    _sync(device)
    ms.matmul_stats.launches = 0
    records = probe.run(device, probe_shapes, timed=False)
    _sync(device)
    launches = ms.matmul_stats.launches
    rec = {"phase": "probe_matmul_stats", "launches": launches,
           "shapes": [r["shape"] for r in records]}
    log(rec)
    if device == "cuda" and launches == 0:
        raise AssertionError("the probe's path did not launch matmul_stats")
    records = probe.run(device, probe_shapes)
    return {"checks": checks, "probe": records, "launches": launches}


def _sync(device):
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def _ctx(device):
    import mxnet_tpu_torch as mx

    return mx.gpu(0) if device == "cuda" else mx.cpu()


def phase_lenet(device="cuda"):
    """The verify recipe's canonical LeNet fit on the device; returns
    K1's launches in it."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import softmax as sm

    mx.random.seed(0)
    train = mx.io.MNISTIter(batch_size=64, num_synthetic=1024, seed=1)
    val = mx.io.MNISTIter(batch_size=64, num_synthetic=512, seed=2,
                          shuffle=False)
    model = mx.FeedForward(mx.models.get_lenet(), ctx=_ctx(device),
                           num_epoch=3, learning_rate=0.1, momentum=0.9,
                           initializer=mx.initializer.Xavier())
    _sync(device)
    sm.fused_softmax.launches = 0
    t0 = time.perf_counter()
    model.fit(X=train, eval_data=val)
    score = model.score(val)
    _sync(device)
    wall = time.perf_counter() - t0
    launches = sm.fused_softmax.launches
    rec = {"phase": "lenet", "score": score, "wall_s": wall,
           "batches": 3 * 16, "softmax_launches": launches}
    log(rec)
    if not score > 0.9:
        raise AssertionError("LeNet scored %g <= 0.9" % score)
    if device == "cuda" and launches == 0:
        raise AssertionError("the LeNet fit never launched K1")
    return launches


def symbol_products(sym, **shapes):
    """(forward, training) FLOPs of a graph's convolutions and FC
    layers at ``shapes``: 2 operations a multiply-add; training adds
    each layer's weight gradient and each input gradient but the first
    layer's (the data takes no gradient)."""
    import numpy as np

    arg_shapes, _, _ = sym.infer_shape(**shapes)
    arg = dict(zip(sym.list_arguments(), arg_shapes))
    internals = sym.get_internals()
    _, out_shapes, _ = internals.infer_shape(**shapes)
    out = dict(zip(internals.list_outputs(), out_shapes))
    layers = []
    for n in sym.nodes:
        if n.is_variable or n.op.name not in ("Convolution",
                                              "FullyConnected"):
            continue
        w = arg["%s_weight" % n.name]
        o = out["%s_output" % n.name]
        cols = np.prod(o) // o[1] if n.op.name == "Convolution" else o[0]
        layers.append(2.0 * cols * np.prod(w))
    fwd = sum(layers)
    return fwd, fwd + sum(layers) + sum(layers[1:])


def _resnet_inputs(batch, image, classes, n_batches=1, seed=0):
    import numpy as np

    rng = np.random.RandomState(seed)
    x = rng.rand(n_batches * batch, 3, image, image).astype(np.float32)
    y = rng.randint(0, classes, n_batches * batch).astype(np.float32)
    return x, y


def phase_resnet_grad_check(device="cuda", batch=128, image=224,
                            classes=1000):
    """One bound ResNet-50 Executor step with SoftmaxOutput through K1
    against the same step through softmax_reference, every parameter
    gradient within relative L2 1e-3. The two steps differ only in the
    softmax's summation order (1e-7 relative on the probabilities),
    which the backward carries through 50 layers of BatchNorm-normalised
    convolutions; a wrong kernel is off by O(1)."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import loss as loss_mod
    from mxnet_tpu_torch.ops.softmax import softmax_reference

    sym = mx.models.get_resnet(num_classes=classes, num_layers=50)
    inputs = ("data", "softmax_label")
    req = {n: ("null" if n in inputs else "write")
           for n in sym.list_arguments()}
    exe = sym.simple_bind(_ctx(device), grad_req=req,
                          data=(batch, 3, image, image),
                          softmax_label=(batch,))
    mx.random.seed(1)
    init = mx.initializer.Xavier()
    for name, arr in exe.arg_dict.items():
        if name not in inputs:
            init(name, arr)
    x, y = _resnet_inputs(batch, image, classes, seed=1)
    exe.arg_dict["data"][:] = x
    exe.arg_dict["softmax_label"][:] = y

    def grads():
        exe.forward(is_train=True)
        exe.backward()
        return {n: g._data.detach().clone()
                for n, g in exe.grad_dict.items() if g is not None}

    g_kernel = grads()
    fused = loss_mod.fused_softmax
    loss_mod.fused_softmax = softmax_reference
    try:
        g_plain = grads()
    finally:
        loss_mod.fused_softmax = fused
    rel = {n: ((g_kernel[n].float() - g_plain[n].float()).norm()
               / g_plain[n].float().norm().clamp_min(1e-30)).item()
           for n in g_plain}
    worst = max(rel, key=rel.get)
    rec = {"phase": "resnet_grad_check", "batch": batch, "image": image,
           "tensors": len(rel), "max_rel_l2": rel[worst], "worst": worst,
           "tol_rel_l2": 1e-3}
    log(rec)
    if not rel[worst] <= 1e-3:
        raise AssertionError("ResNet-50 gradients through K1 disagree with "
                             "the plain softmax's: %r" % rec)
    del exe, g_kernel, g_plain
    return rec


def phase_resnet_fit(device="cuda", batch=128, image=224, classes=1000,
                     n_batches=4, epochs=2):
    """``FeedForward.fit`` of ResNet-50 at bench.py's width: SGD lr 0.05,
    momentum 0.9, FeedForward's default initializer (Uniform(0.01), whose
    near-zero logits put the step-0 cross-entropy at ln(classes); Xavier's
    put it near ln(classes) + 1), NDArrayIter over ``n_batches`` seeded
    batches for ``epochs`` epochs. Returns its record (K1's launches in
    ``softmax_launches``)."""
    import math

    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import softmax as sm

    x, y = _resnet_inputs(batch, image, classes, n_batches, seed=0)
    it = mx.io.NDArrayIter(x, y, batch_size=batch)
    mx.random.seed(0)
    model = mx.FeedForward(mx.models.get_resnet(classes, 50),
                           ctx=_ctx(device), num_epoch=epochs,
                           learning_rate=0.05, momentum=0.9)
    stamps, losses = [], []

    def on_batch(param):
        ex = param.locals["executor_manager"].curr_execgrp.train_execs[0]
        prob = ex.outputs[0]._data.float()
        lab = ex.arg_dict["softmax_label"]._data.long()
        ce = -torch.log(prob.gather(1, lab[:, None]).clamp_min(1e-30))
        losses.append(ce.mean().item())   # a sync: the step has finished
        stamps.append(time.perf_counter())

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _sync(device)
    sm.fused_softmax.launches = 0
    t0 = time.perf_counter()
    # the per-batch loop (MXNET_SCAN_TRAIN=0): on_batch reads its executor
    with mock.patch.dict(os.environ, MXNET_SCAN_TRAIN="0"):
        model.fit(X=it, batch_end_callback=on_batch)
    _sync(device)
    launches = sm.fused_softmax.launches
    steps = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    step_ms = 1e3 * sum(steps[1:]) / len(steps[1:])
    _, train_flops = symbol_products(
        model.symbol, data=(batch, 3, image, image), softmax_label=(batch,))
    n_params = sum(v.size for v in model.arg_params.values())
    rec = {"phase": "resnet_fit", "batch": batch, "image": image,
           "classes": classes, "batches": len(steps),
           "optimizer": "sgd lr 0.05 momentum 0.9",
           "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                    "cudnn": torch.backends.cudnn.allow_tf32},
           "cudnn_benchmark": torch.backends.cudnn.benchmark,
           "step_ms": [1e3 * s for s in steps],
           "mean_step_ms_after_first": step_ms,
           "img_per_s": batch / (step_ms * 1e-3),
           "params": n_params,
           "conv_fc_tflop_per_step": train_flops / 1e12,
           "conv_fc_tflop_s": train_flops / (step_ms * 1e-3) / 1e12,
           "cross_entropy": losses, "softmax_launches": launches,
           "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                           if device == "cuda" else None)}
    log(rec)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("non-finite cross-entropy: %r" % losses)
    if abs(losses[0] - math.log(classes)) > 0.5:
        raise AssertionError("step-0 cross-entropy %g is not within 0.5 of "
                             "ln(%d)" % (losses[0], classes))
    expected = n_batches * epochs if device == "cuda" else 0
    if launches != expected:
        raise AssertionError("the ResNet-50 fit launched K1 %d times, "
                             "expected %d" % (launches, expected))
    return rec


# K5: the CUDA C bodies that phase_rtc pushes through mx.rtc.Rtc, each
# beside its plain twin in PyTorch: name -> (body, twin). The first three
# are tests/unittest/test_rtc.py's cases; "mul_add" is the real-size body
# (f32 and bf16, computed in f32 and rounded once)
RTC_BODIES = {
    "abc": ("y[threadIdx.x] = expf(x[threadIdx.x] * 5.0f);",
            lambda x: (x * 5.0).exp()),
    "axpb": ("const int i = threadIdx.x;\n"
             "if (i < a_dims[0] * a_dims[1]) out[i] = a[i] * b[i] + 1.0f;",
             lambda a, b: a * b + 1.0),
    "rowscale": ("const int i = blockIdx.x;\n"
                 "for (int j = 0; j < x_dims[1]; ++j)\n"
                 "  y[i * x_dims[1] + j] = x[i * x_dims[1] + j]"
                 " * (float)(i + 1);",
                 lambda x: x * (1.0 + _arange_like(x)[:, None])),
    "mul_add": ("for (long long i = blockIdx.x * (long long)blockDim.x"
                " + threadIdx.x; i < out_dims[0];\n"
                "     i += (long long)gridDim.x * blockDim.x)\n"
                "  out[i] = (float)a[i] * (float)b[i] + (float)c[i];",
                lambda a, b, c: (a.float() * b.float() + c.float()).to(
                    a.dtype)),
}
RTC_N = 1 << 26          # the real-size body's elements
RTC_BLOCK = 256
RTC_GRID = 132 * 8       # one wave: 8 blocks of 256 threads on each SM


def _arange_like(x):
    import torch

    return torch.arange(x.shape[0], dtype=x.dtype, device=x.device)


def rtc_bound_ms(n, elem_bytes):
    """Least time for out = a*b + c over n elements: a, b, c read once
    and out written once at the memory rate, against 2 f32 operations
    an element at the f32 peak; returns (ms, "bytes" or "operations")."""
    t_bytes = 4.0 * n * elem_bytes / PEAK_BYTES
    t_ops = 2.0 * n / PEAK_F32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_rtc():
    """K5: every body of RTC_BODIES through ``mx.rtc.Rtc`` on ``gpu(0)``,
    held against its plain twin under :func:`closeness` (tol 1e-4 f32:
    expf and the fused multiply-add against torch's exp, mul and add;
    1e-2 bf16: both round the f32 result to bf16 once). The launch count
    is zeroed just before the pushes and read just after; then the
    real-size body is timed beside its twin and ``torch.addcmul``, the
    cold NVRTC compile of each body and the host's wall time of a cached
    push at [10] are read, and a body with a syntax error must raise."""
    import numpy as np
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.ops import _nvrtc

    ctx = mx.gpu(0)
    rng = np.random.RandomState(30)

    def arr(a, dtype="float32"):
        return mx.nd.array(a, ctx=ctx, dtype=dtype)

    def kernel(name, ins, outs):
        return mx.rtc.Rtc(name, ins, outs, RTC_BODIES[name][0])

    # (label, body, Rtc, inputs, outputs, grid, block, tol)
    cases = []
    x = arr(rng.rand(10))
    cases.append(("abc", "abc", kernel("abc", [("x", x)],
                                       [("y", arr(np.zeros(10)))]),
                  [x], [arr(np.zeros(10))], (1, 1, 1), (10, 1, 1), 1e-4))
    a, b = arr(rng.rand(3, 4)), arr(rng.rand(3, 4))
    k = kernel("axpb", [("a", a), ("b", b)], [("out", arr(np.zeros((3, 4))))])
    cases.append(("axpb", "axpb", k, [a, b], [arr(np.zeros((3, 4)))],
                  (1, 1, 1), (12, 1, 1), 1e-4))
    # the reference's contract: the same kernel on other arrays
    cases.append(("axpb_again", "axpb", k, [arr(rng.rand(3, 4)), b],
                  [arr(np.zeros((3, 4)))], (1, 1, 1), (12, 1, 1), 1e-4))
    x = arr(rng.rand(4, 2))
    cases.append(("rowscale", "rowscale",
                  kernel("rowscale", [("x", x)],
                         [("y", arr(np.zeros((4, 2))))]),
                  [x], [arr(np.zeros((4, 2)))], (4, 1, 1), (1, 1, 1), 1e-4))
    g = torch.Generator(device="cuda").manual_seed(31)
    big = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        ins = [mx.nd.NDArray(torch.randn(RTC_N, generator=g, device="cuda")
                             .to(dtype)) for _ in range(3)]
        out = mx.nd.NDArray(torch.zeros(RTC_N, device="cuda", dtype=dtype))
        k = kernel("mul_add", list(zip("abc", ins)), [("out", out)])
        label = "mul_add_" + str(dtype).split(".")[1]
        cases.append((label, "mul_add", k, ins, [out], (RTC_GRID, 1, 1),
                      (RTC_BLOCK, 1, 1), tol))
        big[label] = (k, ins, out)

    compile_ms = {}
    for label, _, k, *_ in cases:
        if label == "axpb_again":
            continue
        t0 = time.perf_counter()
        k._compile(0)
        compile_ms[label] = (time.perf_counter() - t0) * 1e3
    log({"phase": "rtc_build", "nvrtc": _nvrtc.info["nvrtc_path"],
         "nvrtc_version": _nvrtc.info["nvrtc_version"], "arch": _nvrtc.ARCH,
         "compile_ms": compile_ms, "compiles": rtc.compiles})

    torch.cuda.synchronize()
    rtc.launches = 0
    for _, _, k, ins, outs, grid, block, _ in cases:
        k.push(ins, outs, grid, block)
    torch.cuda.synchronize()
    launches = rtc.launches

    checks = {}
    for label, body, _, ins, outs, _, _, tol in cases:
        want = RTC_BODIES[body][1](*[t._data for t in ins])
        close = closeness(outs[0]._data, want, tol)
        checks[label] = dict(close, tol=tol)
        if not within(close, tol):
            raise AssertionError("rtc body %s disagrees with its plain twin: "
                                 "%r" % (label, close))
    if launches != len(cases):
        raise AssertionError("rtc launched %d times for %d pushes"
                             % (launches, len(cases)))

    timing = {}
    for label, (k, ins, out) in big.items():
        a_, b_, c_ = (t._data for t in ins)
        twin = RTC_BODIES["mul_add"][1]
        bound, by = rtc_bound_ms(RTC_N, a_.element_size())
        timing[label] = {
            "ms": cuda_ms(lambda: k.push(ins, [out], (RTC_GRID, 1, 1),
                                         (RTC_BLOCK, 1, 1))),
            "plain_ms": cuda_ms(lambda: twin(a_, b_, c_)),
            "library_ms": cuda_ms(lambda: torch.addcmul(c_, a_, b_)),
            "bound_ms": bound, "bound_by": by,
            "bytes": 4 * RTC_N * a_.element_size()}
        timing[label]["achieved_tb_s"] = (timing[label]["bytes"]
                                          / (timing[label]["ms"] * 1e-3)
                                          / 1e12)
    _, _, k, ins, outs, grid, block, _ = cases[0]
    k.push(ins, outs, grid, block)
    torch.cuda.synchronize()
    reps = 1000
    t0 = time.perf_counter()
    for _ in range(reps):
        k.push(ins, outs, grid, block)
    push_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()

    bad = mx.rtc.Rtc("bad", [("x", ins[0])], [("y", outs[0])],
                     "y[0] = x[0] +;")
    try:
        bad.push(ins, outs)
    except mx.MXNetError as exc:
        syntax_error = str(exc).splitlines()[-1][:200]
    else:
        raise AssertionError("a body with a syntax error compiled")
    rec = {"phase": "rtc", "launches": launches, "checks": checks,
           "timing": timing, "compile_ms": compile_ms,
           "cached_push_host_us": push_us,
           "syntax_error": syntax_error, "compiles": rtc.compiles}
    log(rec)
    return rec


def _mlp_symbol(hidden_layers):
    """examples/module/mnist_mlp.py's nets: ``hidden_layers`` FC+relu of
    the given widths, then fc2 10 and SoftmaxOutput."""
    import mxnet_tpu_torch as mx

    net = mx.sym.Variable("data")
    for i, h in enumerate(hidden_layers):
        net = mx.sym.Activation(mx.sym.FullyConnected(
            net, num_hidden=h, name="fc%d" % (i + 1)), act_type="relu")
    return mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        net, num_hidden=10, name="fc2"), name="softmax")


def _mnist_iters(batch, n_train, n_val):
    import mxnet_tpu_torch as mx

    train = mx.io.MNISTIter(batch_size=batch, num_synthetic=n_train,
                            seed=1, flat=True)
    val = mx.io.MNISTIter(batch_size=batch, num_synthetic=n_val, seed=2,
                          flat=True, shuffle=False)
    return train, val


def mnist_explicit(ctx, epochs=3, batch=100, n_train=2000, n_val=1000):
    """examples/module/mnist_mlp.py's explicit Module workflow (fc1 128,
    relu, fc2 10, SoftmaxOutput; SGD 0.1, momentum 0.9); returns the
    validation accuracy."""
    import mxnet_tpu_torch as mx

    train, val = _mnist_iters(batch, n_train, n_val)
    mod = mx.module.Module(_mlp_symbol([128]), context=ctx)
    mod.bind(data_shapes=train.provide_data,
             label_shapes=train.provide_label)
    mod.init_params(mx.initializer.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9})
    metric = mx.metric.Accuracy()
    for _ in range(epochs):
        train.reset()
        metric.reset()
        for b in train:
            mod.forward(b, is_train=True)
            mod.update_metric(metric, b.label)
            mod.backward()
            mod.update()
    return dict(mod.score(val, mx.metric.Accuracy()))["accuracy"]


def mnist_sequential(ctx, epochs=3, batch=100, n_train=2000, n_val=1000):
    """The example's SequentialModule workflow (fc1 64 + relu | fc2 10 +
    SoftmaxOutput, auto_wiring, take_labels; SGD 0.1)."""
    import mxnet_tpu_torch as mx

    train, val = _mnist_iters(batch, n_train, n_val)
    net1 = mx.sym.Activation(mx.sym.FullyConnected(
        mx.sym.Variable("data"), num_hidden=64, name="fc1"),
        act_type="relu")
    net2 = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        mx.sym.Variable("data"), num_hidden=10, name="fc2"),
        name="softmax")
    mod = mx.module.SequentialModule()
    mod.add(mx.module.Module(net1, label_names=(), context=ctx))
    mod.add(mx.module.Module(net2, context=ctx), take_labels=True,
            auto_wiring=True)
    mod.bind(data_shapes=train.provide_data,
             label_shapes=train.provide_label)
    mod.init_params(mx.initializer.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    for _ in range(epochs):
        train.reset()
        for b in train:
            mod.forward(b, is_train=True)
            mod.backward()
            mod.update()
    metric = mx.metric.Accuracy()
    val.reset()
    for b in val:
        mod.forward(b, is_train=False)
        mod.update_metric(metric, b.label)
    return metric.get()[1]


def mnist_python_loss(ctx, epochs=3, batch=100, n_train=2000, n_val=1000):
    """The example's Python-loss workflow: raw logits (fc1 64, relu, fc2
    10), the softmax cross-entropy gradient computed in numpy and fed
    back through ``backward(out_grads=...)``; SGD 0.5."""
    import numpy as np

    import mxnet_tpu_torch as mx

    train, val = _mnist_iters(batch, n_train, n_val)
    net = mx.sym.FullyConnected(mx.sym.Activation(mx.sym.FullyConnected(
        mx.sym.Variable("data"), num_hidden=64, name="fc1"),
        act_type="relu"), num_hidden=10, name="fc2")

    def softmax_ce_grad(scores, labels):
        e = np.exp(scores - scores.max(1, keepdims=True))
        p = e / e.sum(1, keepdims=True)
        p[np.arange(len(labels)), labels.astype(int)] -= 1.0
        return p / len(labels)

    feat = mx.module.Module(net, label_names=(), context=ctx)
    feat.bind(data_shapes=train.provide_data, inputs_need_grad=False,
              for_training=True)
    feat.init_params(mx.initializer.Xavier())
    feat.init_optimizer(optimizer="sgd",
                        optimizer_params={"learning_rate": 0.5})
    for _ in range(epochs):
        train.reset()
        for b in train:
            feat.forward(b, is_train=True)
            scores = feat.get_outputs()[0].asnumpy()
            g = softmax_ce_grad(scores, b.label[0].asnumpy())
            feat.backward(out_grads=[mx.nd.array(g, ctx=ctx)])
            feat.update()
    val.reset()
    correct = total = 0
    for b in val:
        feat.forward(b, is_train=False)
        pred = feat.get_outputs()[0].asnumpy().argmax(1)
        correct += (pred == b.label[0].asnumpy()).sum()
        total += len(pred)
    return float(correct / total)


def phase_module(device="cuda", n_train=2000, n_val=1000, batch=100,
                 epochs=3):
    """The Module API on the device: examples/module/mnist_mlp.py's three
    workflows at its defaults (MNISTIter(flat=True), 2000/1000 synthetic
    digits, batch 100, 3 epochs), each to validation accuracy > 0.9;
    LeNet's canonical recipe through ``Module.fit`` (score > 0.9);
    bucketing's sym_gen at buckets 10 and 20 (one storage on the card,
    an update through one bucket seen by the other); a Monitor over one
    LeNet batch (every tap finite). K1's count is zeroed just before and
    read just after; returns it."""
    import numpy as np

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import softmax as sm

    ctx = _ctx(device)

    def lenet_fit():
        train = mx.io.MNISTIter(batch_size=64, num_synthetic=1024, seed=1)
        val = mx.io.MNISTIter(batch_size=64, num_synthetic=512, seed=2,
                              shuffle=False)
        mod = mx.module.Module(mx.models.get_lenet(), context=ctx)
        mod.fit(train, eval_data=val, num_epoch=3,
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                initializer=mx.initializer.Xavier())
        return dict(mod.score(val, "acc"))["accuracy"], mod

    def bucketing():
        def sym_gen(seq_len):
            data = mx.sym.Variable("data")
            emb = mx.sym.Embedding(data, input_dim=20, output_dim=8,
                                   name="emb")
            bn = mx.sym.BatchNorm(mx.sym.sum(emb, axis=(1,)), name="bn")
            out = mx.sym.FullyConnected(bn, num_hidden=2, name="out")
            return (mx.sym.SoftmaxOutput(out, name="softmax"), ("data",),
                    ("softmax_label",))

        d = mx.io.DataDesc
        mod = mx.module.BucketingModule(sym_gen, default_bucket_key=10,
                                        context=ctx)
        mod.bind(data_shapes=[d("data", (4, 10))],
                 label_shapes=[d("softmax_label", (4,))])
        mod.init_params()
        mod.init_optimizer(optimizer_params={"learning_rate": 0.5,
                                             "momentum": 0.9})
        rng = np.random.RandomState(3)
        seen = []
        for step in range(6):
            key = (10, 20)[step % 2]
            x = rng.randint(0, 20, (4, key)).astype(np.float32)
            b = mx.io.DataBatch(
                data=[mx.nd.array(x, ctx=ctx)],
                label=[mx.nd.array((x[:, 0] >= 10).astype(np.float32),
                                   ctx=ctx)], pad=0, index=None,
                bucket_key=key, provide_data=[d("data", (4, key))],
                provide_label=[d("softmax_label", (4,))])
            mod.forward(b)
            mod.backward()
            mod.update()
            seen.append(mod._buckets[10]._execs[0].arg_dict[
                "out_weight"].asnumpy())
        m10 = mod._buckets[10]._execs[0]
        m20 = mod._buckets[20]._execs[0]
        names = ("emb_weight", "bn_gamma", "bn_beta", "out_weight",
                 "out_bias")
        shared = all(m20.arg_dict[n] is m10.arg_dict[n]
                     and m20.grad_dict[n] is m10.grad_dict[n]
                     and m20.arg_dict[n]._data.data_ptr()
                     == m10.arg_dict[n]._data.data_ptr()
                     and m20.arg_dict[n]._data.device.type == (
                         "cuda" if device == "cuda" else "cpu")
                     for n in names)
        shared &= all(m20.aux_dict[n] is m10.aux_dict[n]
                      for n in ("bn_moving_mean", "bn_moving_var"))
        # every step, through either bucket, moved the one weight
        moved = all(not np.array_equal(p, q) for p, q in zip(seen, seen[1:]))
        out = mod.get_outputs()[0].asnumpy()
        return {"shared_storage": bool(shared), "updates_seen": bool(moved),
                "finite": bool(np.isfinite(out).all())}

    def monitor(mod):
        it = mx.io.MNISTIter(batch_size=64, num_synthetic=64, seed=2,
                             shuffle=False)
        mon = mx.Monitor(1, nan_aware=True)
        mod.install_monitor(mon)
        mon.tic()
        mod.forward(next(iter(it)), is_train=False)
        taps = mon.toc()
        finite = all(np.isfinite(float(v)) for _, _, v in taps)
        return {"taps": len(taps), "names": [k for _, k, _ in taps][:12],
                "finite": finite and not mon.nonfinite}

    # the example's seed, for the weights (mx.random) and for the
    # training iterators' shuffles (numpy's global generator)
    mx.random.seed(0)
    np.random.seed(0)
    _sync(device)
    sm.fused_softmax.launches = 0
    t0 = time.perf_counter()
    sizes = dict(epochs=epochs, batch=batch, n_train=n_train, n_val=n_val)
    acc = {"explicit": mnist_explicit(ctx, **sizes),
           "sequential": mnist_sequential(ctx, **sizes),
           "python_loss": mnist_python_loss(ctx, **sizes)}
    lenet_score, lenet_mod = lenet_fit()
    buckets = bucketing()
    mon = monitor(lenet_mod)
    _sync(device)
    wall = time.perf_counter() - t0
    launches = sm.fused_softmax.launches
    rec = {"phase": "module", "val_acc": acc, "lenet_module_score":
           lenet_score, "bucketing": buckets, "monitor": mon,
           "wall_s": wall, "softmax_launches": launches}
    log(rec)
    if not min(acc.values()) > 0.9:
        raise AssertionError("mnist_mlp workflows: %r" % acc)
    if not lenet_score > 0.9:
        raise AssertionError("LeNet Module.fit scored %g" % lenet_score)
    if not all(buckets.values()):
        raise AssertionError("bucketing: %r" % buckets)
    if not (mon["finite"] and mon["taps"] > 0):
        raise AssertionError("monitor: %r" % mon)
    if device == "cuda" and launches == 0:
        raise AssertionError("the Module path never launched K1")
    return launches


def phase_resnet_module_fit(device="cuda", batch=128, image=224,
                            classes=1000, n_batches=4, epochs=1,
                            feedforward=None):
    """ResNet-50 (conv7 stem) at phase_resnet_fit's widths through
    ``Module.fit``: SGD lr 0.05, momentum 0.9, the default initializer
    (Uniform(0.01)), the same seeded batches, one epoch. Prints the mean
    warm step and img/s beside ``feedforward`` (phase_resnet_fit's
    record from the same run). Returns K1's launches."""
    import math

    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import softmax as sm

    x, y = _resnet_inputs(batch, image, classes, n_batches, seed=0)
    it = mx.io.NDArrayIter(x, y, batch_size=batch)
    mx.random.seed(0)
    mod = mx.module.Module(mx.models.get_resnet(classes, 50),
                           context=_ctx(device))
    stamps, losses = [], []

    def on_batch(param):
        ex = mod._execs[0]
        prob = ex.outputs[0]._data.float()
        lab = ex.arg_dict["softmax_label"]._data.long()
        ce = -torch.log(prob.gather(1, lab[:, None]).clamp_min(1e-30))
        losses.append(ce.mean().item())   # a sync: the step has finished
        stamps.append(time.perf_counter())

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _sync(device)
    sm.fused_softmax.launches = 0
    t0 = time.perf_counter()
    # the per-batch loop (MXNET_SCAN_TRAIN=0): on_batch reads its executor
    with mock.patch.dict(os.environ, MXNET_SCAN_TRAIN="0"):
        mod.fit(it, num_epoch=epochs, batch_end_callback=on_batch,
                optimizer_params={"learning_rate": 0.05, "momentum": 0.9})
    _sync(device)
    launches = sm.fused_softmax.launches
    steps = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    step_ms = 1e3 * sum(steps[1:]) / len(steps[1:])
    rec = {"phase": "resnet_module_fit", "batch": batch, "image": image,
           "classes": classes, "batches": len(steps),
           "optimizer": "sgd lr 0.05 momentum 0.9",
           "step_ms": [1e3 * s for s in steps],
           "mean_step_ms_after_first": step_ms,
           "img_per_s": batch / (step_ms * 1e-3),
           "feedforward_mean_step_ms_after_first": (
               feedforward or {}).get("mean_step_ms_after_first"),
           "feedforward_img_per_s": (feedforward or {}).get("img_per_s"),
           "cross_entropy": losses, "softmax_launches": launches,
           "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                           if device == "cuda" else None)}
    log(rec)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("non-finite cross-entropy: %r" % losses)
    if abs(losses[0] - math.log(classes)) > 0.5:
        raise AssertionError("step-0 cross-entropy %g is not within 0.5 of "
                             "ln(%d)" % (losses[0], classes))
    expected = n_batches * epochs if device == "cuda" else 0
    if launches != expected:
        raise AssertionError("the ResNet-50 Module fit launched K1 %d times, "
                             "expected %d" % (launches, expected))
    return launches


# phase_resnet_bench's bf16 against f32 limits on the first step, from the
# same state: ResNet-50 v1 at its He initialisation is chaotic in its
# backward: the deep layers' bf16 and f32 updates are nearly uncorrelated
# (relative L2 1.31-1.35 overall at batch 4-16, image 64-224, on the CPU;
# PERF.md §6), so only the head's updates, the cross-entropy and the
# update's size are held. This phase on the CPU at batch 8, image 224,
# scan_k 1 (batch 4, image 64): per-sample |dCE| mean 0.143 (0.406), max
# 0.316 (1.090) nats; fc1_weight 0.107 (0.353), fc1_bias 0.0091 (0.042);
# norm ratio 0.993 (0.973); the limits hold from batch 8, image 128 up
BENCH_BF16_LIMITS = {"ce_mean": 0.5, "ce_max": 1.5, "fc1_weight": 0.35,
                     "fc1_bias": 0.05, "norm_ratio": (0.8, 1.25)}


def _bench_batches(steps, batch, image, classes, dtype, device):
    """bench.py:127-133's seeded batches, moved to the device once."""
    import numpy as np
    import torch

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(steps, batch, 3, image, image)
                         .astype(np.float32)).to(dtype)
    y = torch.from_numpy(rng.randint(0, classes, (steps, batch))
                         .astype(np.float32))
    return {"data": x.to(device), "softmax_label": y.to(device)}


def _ce(prob, label):
    """Per-sample cross-entropy of SoftmaxOutput's probabilities."""
    import torch

    p = prob.float().gather(-1, label.long().unsqueeze(-1)).squeeze(-1)
    return -torch.log(p.clamp_min(1e-30))


def _finite(tensors):
    import torch

    return bool(torch.stack([torch.isfinite(t).all() for t in tensors])
                .all())


def _rel(a, b):
    return float((a.float() - b.float()).norm()
                 / b.float().norm().clamp_min(1e-30))


def _bench_loops(step, state, batches, key, loops, device, no_sync=False):
    """Run ``loops`` calls of ``step.loop`` back to back, fenced by a
    4-byte copy to the host at the end; returns (state, seconds, every
    head output of every step finite). ``no_sync`` (on a card): the
    loops run under ``torch.cuda.set_sync_debug_mode("error")``, so a
    host synchronisation inside them raises."""
    import torch

    guard = no_sync and device == "cuda"
    t0 = time.perf_counter()
    outs = []
    if guard:
        torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(loops):
            state, o = step.loop(state, batches, key)
            outs.append(o[0])
    finally:
        if guard:
            torch.cuda.set_sync_debug_mode("default")
    last = outs[-1].reshape(-1)
    last[:4 // last.element_size()].cpu()     # the fence: 4 bytes
    dt = time.perf_counter() - t0
    return state, dt, _finite(outs)


def phase_resnet_bench(device="cuda", batch=128, image=224, classes=1000,
                       scan_k=16, windows=3, loops_per_window=2):
    """bench.py's ResNet-50 leg (bench.py:110-125) through the port:
    ``get_resnet(1000, 50, stem="s2d")``, ``make_symbol_train_step`` with
    its default SGD 0.05 / 0.9 and ``compute_dtype="bfloat16"``, batch
    128, 16 seeded batches (bf16 images, f32 labels) on the card, one warm
    ``loop`` of 16 then ``windows`` timed windows of ``loops_per_window``
    loops, each fenced by a 4-byte copy; then conv7 in bf16 and s2d in
    f32, one warm and one timed loop each. Checks: the bf16 and f32 s2d
    steps from the same state at step 0 (``BENCH_BF16_LIMITS``); no host
    synchronisation inside the warm bf16 loop (the sync debug mode set
    to raise); the f32
    conv7 step against one bound Executor forward/backward plus
    ``torch.optim.SGD`` from the same parameters (relative L2 1e-4 a
    tensor); every head finite at every step and every parameter after
    every loop (a non-finite value does not leave SGD's momentum); K1
    launched once a step (its count zeroed just before the phase and read
    just after). Returns the record (``softmax_launches``)."""
    import statistics

    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import threefry
    from mxnet_tpu_torch.ops import softmax as sm
    from mxnet_tpu_torch.parallel import make_symbol_train_step

    ctx = _ctx(device)
    dev = ctx.torch_device
    shapes = {"data": (batch, 3, image, image), "softmax_label": (batch,)}
    key = threefry.prng_key(0, device="cpu")
    on_card = device == "cuda"
    syms = {stem: mx.models.get_resnet(classes, 50, stem=stem, image=image)
            for stem in ("s2d", "conv7")}
    flops = {stem: symbol_products(s, **shapes)[1]
             for stem, s in syms.items()}
    rec = {"phase": "resnet_bench", "batch": batch, "image": image,
           "classes": classes, "scan_k": scan_k,
           "optimizer": "torch.optim.SGD lr 0.05 momentum 0.9",
           "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                    "cudnn": torch.backends.cudnn.allow_tf32},
           "cudnn_benchmark": torch.backends.cudnn.benchmark}
    steps = 0
    _sync(device)
    sm.fused_softmax.launches = 0

    # -- step 0 of s2d in bf16 and in f32, from the same state
    b16 = _bench_batches(scan_k, batch, image, classes, torch.bfloat16, dev)
    step16, st16 = make_symbol_train_step(syms["s2d"], shapes, ctx=ctx,
                                          compute_dtype="bfloat16")
    step32, st32 = make_symbol_train_step(syms["s2d"], shapes, ctx=ctx)
    p0 = {n: p.clone() for n, p in st16["params"].items()}
    same_start = all(torch.equal(p0[n], p) for n, p in st32["params"].items())
    first = {k: v[0] for k, v in b16.items()}
    st16, o16 = step16(st16, first, key)
    st32, o32 = step32(st32, dict(first, data=first["data"].float()), key)
    steps += 2
    ce16, ce32 = _ce(o16[0], first["softmax_label"]), _ce(
        o32[0], first["softmax_label"])
    d16 = {n: st16["params"][n] - p0[n] for n in p0}
    d32 = {n: st32["params"][n] - p0[n] for n in p0}
    g16 = torch.cat([d16[n].reshape(-1) for n in p0])
    g32 = torch.cat([d32[n].reshape(-1) for n in p0])
    by_stage = {}
    for stage in ("conv0", "stage1", "stage2", "stage3", "stage4", "fc1"):
        names = [n for n in p0 if n.startswith(stage)]
        by_stage[stage] = _rel(torch.cat([d16[n].reshape(-1) for n in names]),
                               torch.cat([d32[n].reshape(-1) for n in names]))
    dce = (ce16 - ce32).abs()
    step0 = {"same_start": same_start,
             "head_dtypes": [str(o16[0].dtype), str(o32[0].dtype)],
             "ce_f32_mean": float(ce32.mean()),
             "ce_bf16_mean": float(ce16.mean()),
             "ce_mean": float(dce.mean()), "ce_max": float(dce.max()),
             "fc1_weight": _rel(d16["fc1_weight"], d32["fc1_weight"]),
             "fc1_bias": _rel(d16["fc1_bias"], d32["fc1_bias"]),
             "norm_ratio": float(g16.norm() / g32.norm()),
             "cosine": float(torch.nn.functional.cosine_similarity(
                 g16.float(), g32.float(), dim=0)),
             "update_rel_l2": _rel(g16, g32),
             "update_rel_l2_by_stage": by_stage,
             "finite": _finite(list(o16) + list(o32) + list(d16.values())
                               + list(d32.values())),
             "limits": BENCH_BF16_LIMITS}
    rec["bf16_vs_f32_step0"] = step0
    del p0, d16, d32, g16, g32

    # -- bench.py's leg: s2d, bf16, 16-step loops
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    st16, _, fin_warm = _bench_loops(step16, st16, b16, key, 1, device,
                                     no_sync=True)
    steps += scan_k
    win = []
    fin = fin_warm
    for _ in range(windows):
        st16, dt, ok = _bench_loops(step16, st16, b16, key,
                                    loops_per_window, device)
        win.append(dt / (loops_per_window * scan_k))
        fin &= ok
        steps += loops_per_window * scan_k
    fin &= _finite(st16["params"].values())
    img = [batch / s for s in win]
    rec["s2d_bf16"] = {
        "step_ms": [1e3 * s for s in win],
        "img_per_s_median": statistics.median(img),
        "img_per_s_min": min(img), "img_per_s_max": max(img),
        "conv_fc_tflop_per_step": flops["s2d"] / 1e12,
        "conv_fc_tflop_s": flops["s2d"] / statistics.median(win) / 1e12,
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if on_card else None),
        "finite": fin}
    del step16, st16, o16

    # -- s2d in f32 (carrying on from step 0), one warm and one timed loop
    b32 = {k: (v.float() if k == "data" else v) for k, v in b16.items()}
    del b16
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    st32, _, ok1 = _bench_loops(step32, st32, b32, key, 1, device)
    st32, dt, ok2 = _bench_loops(step32, st32, b32, key, 1, device)
    steps += 2 * scan_k
    rec["s2d_f32"] = {
        "step_ms": 1e3 * dt / scan_k, "img_per_s": batch * scan_k / dt,
        "conv_fc_tflop_s": flops["s2d"] * scan_k / dt / 1e12,
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if on_card else None),
        "finite": ok1 and ok2 and _finite(st32["params"].values())}
    del step32, st32, o32

    # -- conv7 in bf16, one warm and one timed loop
    b16 = {k: (v.to(torch.bfloat16) if k == "data" else v)
           for k, v in b32.items()}
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    step7, st7 = make_symbol_train_step(syms["conv7"], shapes, ctx=ctx,
                                        compute_dtype="bfloat16")
    st7, _, ok1 = _bench_loops(step7, st7, b16, key, 1, device)
    st7, dt, ok2 = _bench_loops(step7, st7, b16, key, 1, device)
    steps += 2 * scan_k
    rec["conv7_bf16"] = {
        "step_ms": 1e3 * dt / scan_k, "img_per_s": batch * scan_k / dt,
        "conv_fc_tflop_s": flops["conv7"] * scan_k / dt / 1e12,
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if on_card else None),
        "finite": ok1 and ok2 and _finite(st7["params"].values())}
    del step7, st7, b16
    if on_card:
        torch.cuda.empty_cache()

    # -- the f32 conv7 step against Executor forward/backward + SGD
    step7, st7 = make_symbol_train_step(syms["conv7"], shapes, ctx=ctx)
    p0 = {n: p.clone() for n, p in st7["params"].items()}
    aux0 = [a.clone() for a in st7["aux"]]
    first = {k: v[0] for k, v in b32.items()}
    st7, _ = step7(st7, first, key)
    steps += 1
    fused = {n: p.clone() for n, p in st7["params"].items()}
    del step7, st7, b32
    sym = syms["conv7"]
    req = {n: ("null" if n in shapes else "write")
           for n in sym.list_arguments()}
    exe = sym.simple_bind(ctx, grad_req=req, **shapes)
    for n, p in p0.items():
        exe.arg_dict[n][:] = p
    for a, v in zip(exe.aux_arrays, aux0):
        a[:] = v
    exe.arg_dict["data"][:] = first["data"]
    exe.arg_dict["softmax_label"][:] = first["softmax_label"]
    exe.forward(is_train=True)
    exe.backward()
    steps += 1
    ws = [p0[n] for n in p0]
    opt = torch.optim.SGD(ws, lr=0.05, momentum=0.9)
    for n, w in zip(p0, ws):
        w.grad = exe.grad_dict[n]._data
    opt.step()
    rel = {n: _rel(fused[n], p0[n]) for n in p0}
    worst = max(rel, key=rel.get)
    rec["conv7_f32_vs_executor"] = {"tensors": len(rel),
                                    "max_rel_l2": rel[worst], "worst": worst,
                                    "tol_rel_l2": 1e-4}
    del exe, fused, p0, opt, ws
    _sync(device)
    launches = sm.fused_softmax.launches
    rec["steps"] = steps
    rec["softmax_launches"] = launches
    log(rec)

    lim = BENCH_BF16_LIMITS
    if not (same_start and step0["finite"]
            and step0["head_dtypes"] == ["torch.bfloat16", "torch.float32"]):
        raise AssertionError("step 0: %r" % step0)
    lo, hi = lim["norm_ratio"]
    if not (step0["ce_mean"] <= lim["ce_mean"]
            and step0["ce_max"] <= lim["ce_max"]
            and step0["fc1_weight"] <= lim["fc1_weight"]
            and step0["fc1_bias"] <= lim["fc1_bias"]
            and lo <= step0["norm_ratio"] <= hi
            and step0["update_rel_l2"] > 0):
        raise AssertionError("the bf16 step 0 is off the f32 one: %r"
                             % step0)
    for leg in ("s2d_bf16", "s2d_f32", "conv7_bf16"):
        if not rec[leg]["finite"]:
            raise AssertionError("non-finite head or parameter in %s: %r"
                                 % (leg, rec[leg]))
    if not rel[worst] <= 1e-4:
        raise AssertionError("the f32 fused step disagrees with the "
                             "Executor step: %r"
                             % rec["conv7_f32_vs_executor"])
    expected = steps if on_card else 0
    if launches != expected:
        raise AssertionError("the bench phase launched K1 %d times, "
                             "expected %d (one a step)" % (launches,
                                                           expected))
    return rec


def phase_resnet_scanned_fit(device="cuda", batch=128, image=224,
                             classes=1000, n_batches=4, epochs=2,
                             feedforward=None):
    """The scanned fit on the card: ``FeedForward(get_resnet(1000, 50),
    compute_dtype="bfloat16").fit`` at phase_resnet_fit's batches and
    epochs (one tail chunk of 4 an epoch at the default K = 8), then
    ``Module.fit`` with ``MXNET_COMPUTE_DTYPE=bfloat16`` for one epoch,
    both with ``MXNET_SCAN_TRAIN`` unset (its default, on). Asserts that
    each built its scanned trainer; checks the cross-entropy (finite,
    step 0 within 0.5 of ln(classes)) and K1's launches (once a step);
    prints ms a step and img/s (the second epoch, FeedForward) beside
    ``feedforward``, phase_resnet_fit's f32 per-batch record. Returns
    the record (``softmax_launches``)."""
    import math

    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import softmax as sm
    from mxnet_tpu_torch.parallel import fit_trainer

    x, y = _resnet_inputs(batch, image, classes, n_batches, seed=0)
    built = []
    real = fit_trainer.make_fit_trainer

    def spy(*a, **kw):
        built.append(real(*a, **kw))
        return built[-1]

    fit_trainer.make_fit_trainer = spy
    rec = {"phase": "resnet_scanned_fit", "batch": batch, "image": image,
           "classes": classes, "batches": n_batches,
           "optimizer": "sgd lr 0.05 momentum 0.9",
           "compute_dtype": "bfloat16"}
    try:
        with mock.patch.dict(os.environ):
            for k in ("MXNET_SCAN_TRAIN", "MXNET_TRAIN_SCAN_K",
                      "MXNET_COMPUTE_DTYPE"):
                os.environ.pop(k, None)   # the defaults: scanned, K = 8
            it = mx.io.NDArrayIter(x, y, batch_size=batch)
            mx.random.seed(0)
            model = mx.FeedForward(mx.models.get_resnet(classes, 50),
                                   ctx=_ctx(device), num_epoch=epochs,
                                   learning_rate=0.05, momentum=0.9,
                                   compute_dtype="bfloat16")
            ce, stamps = [], []

            def on_batch(param):
                ce.append(float(param.eval_metric.get()[1]))

            def on_epoch(*_):
                _sync(device)
                stamps.append(time.perf_counter())

            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            _sync(device)
            sm.fused_softmax.launches = 0
            t0 = time.perf_counter()
            model.fit(X=it, eval_metric="ce", batch_end_callback=on_batch,
                      epoch_end_callback=on_epoch)
            _sync(device)
            ff_launches = sm.fused_softmax.launches
            epoch_s = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
            warm = epoch_s[-1] / n_batches
            rec["feedforward"] = {
                "trainer_built": len(built) == 1, "epoch_s": epoch_s,
                "step_ms_last_epoch": 1e3 * warm,
                "img_per_s_last_epoch": batch / warm,
                "cross_entropy": ce, "softmax_launches": ff_launches,
                "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                                if device == "cuda" else None)}
            del model
            if device == "cuda":
                torch.cuda.empty_cache()

            with mock.patch.dict(os.environ,
                                 MXNET_COMPUTE_DTYPE="bfloat16"):
                it = mx.io.NDArrayIter(x, y, batch_size=batch)
                mx.random.seed(0)
                mod = mx.module.Module(mx.models.get_resnet(classes, 50),
                                       context=_ctx(device))
                mce = []
                _sync(device)
                sm.fused_softmax.launches = 0
                t0 = time.perf_counter()
                mod.fit(it, num_epoch=1, eval_metric="ce",
                        batch_end_callback=lambda p: mce.append(
                            float(p.eval_metric.get()[1])),
                        optimizer_params={"learning_rate": 0.05,
                                          "momentum": 0.9})
                _sync(device)
                wall = time.perf_counter() - t0
                mod_launches = sm.fused_softmax.launches
            rec["module"] = {"trainer_built": len(built) == 2,
                             "epoch_s": wall, "cross_entropy": mce,
                             "softmax_launches": mod_launches}
            del mod
    finally:
        fit_trainer.make_fit_trainer = real
    ff = feedforward or {}
    rec["f32_per_batch_mean_step_ms_after_first"] = ff.get(
        "mean_step_ms_after_first")
    rec["f32_per_batch_img_per_s"] = ff.get("img_per_s")
    rec["softmax_launches"] = ff_launches + mod_launches
    log(rec)
    for leg, runs in (("feedforward", epochs), ("module", 1)):
        r = rec[leg]
        if not r["trainer_built"]:
            raise AssertionError("%s.fit did not build its scanned trainer"
                                 % leg)
        if not all(math.isfinite(v) for v in r["cross_entropy"]):
            raise AssertionError("non-finite cross-entropy: %r" % r)
        if abs(r["cross_entropy"][0] - math.log(classes)) > 0.5:
            raise AssertionError("%s step-0 cross-entropy %g is not within "
                                 "0.5 of ln(%d)"
                                 % (leg, r["cross_entropy"][0], classes))
        expected = n_batches * runs if device == "cuda" else 0
        if r["softmax_launches"] != expected:
            raise AssertionError("the %s scanned fit launched K1 %d times, "
                                 "expected %d" % (leg, r["softmax_launches"],
                                                  expected))
    return rec


# the LSTM language model over bucketing (baseline config #3):
# examples/rnn_torch/lstm_bucketing.py's recipe at its defaults
LSTM_EXAMPLE = os.path.join("examples", "rnn_torch", "lstm_bucketing.py")


def _lstm_example():
    """examples/rnn_torch/lstm_bucketing.py as a module (its directory
    goes on the path for its ``bucket_io``)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        LSTM_EXAMPLE)
    spec = importlib.util.spec_from_file_location("lstm_bucketing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def unigram_perplexity(sentences):
    """exp of the mean negative log unigram probability of every next
    token (each sentence's tokens after its first): the perplexity of a
    model that learns the token counts and nothing of the order."""
    import numpy as np

    counts = np.bincount(np.concatenate([s[1:] for s in sentences]))
    counts = counts[counts > 0].astype(np.float64)
    total = counts.sum()
    return float(np.exp(-(counts * np.log(counts / total)).sum() / total))


def device_busy(prof):
    """(summed ms, busy ms) of the card's activity that ``prof`` traced:
    every kernel, copy and set's duration summed, and the union of their
    intervals. Reads the profiler's raw events, which an epoch of the
    unrolled LSTM's thousands of launches a batch makes cheap enough."""
    import torch

    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA)
    summed = sum(b - a for a, b in spans)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a >= end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return summed / 1e6, busy / 1e6, len(spans)


def lstm_dropout_check(device, args, vocab):
    """One executor of ``lstm_unroll(dropout=0.5)`` at bucket 10 and the
    example's width on the device, under ``random.seed(7)``:
    every Dropout node's mask (its output's nonzeros, read as one Group
    with the loss) must equal ``bernoulli(fold_in(key, serial), 0.5)``
    drawn on the host from the same chain key, bit for bit, and keep
    within 4 sigma of half; then the ms of one forward+backward of the
    loss at dropout 0.5 against dropout 0, the price of the eager int64
    threefry draws."""
    import numpy as np
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import threefry
    from mxnet_tpu_torch.models.lstm import lstm_unroll

    seq_len, seed = 10, 7
    ctx = _ctx(device)
    L, H, E, B = (args.num_lstm_layer, args.num_hidden, args.num_embed,
                  args.batch_size)
    shapes = {"data": (B, seq_len), "softmax_label": (B, seq_len)}
    shapes.update({"l%d_init_%s" % (i, s): (B, H) for i in range(L)
                   for s in "ch"})

    def symbol(p):
        return lstm_unroll(L, seq_len, vocab, num_hidden=H, num_embed=E,
                           num_label=vocab, dropout=p, ignore_label=0)

    loss = symbol(0.5)
    internals = loss.get_internals()
    names = [n for n in internals.list_outputs() if n.startswith("dropout")]
    group = mx.sym.Group([loss] + [internals[n] for n in names])
    arg_shapes, _, _ = group.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    values = {n: (rng.randint(1, vocab, s) if n in ("data", "softmax_label")
                  else rng.randn(*s) * 0.1).astype(np.float32)
              for n, s in zip(group.list_arguments(), arg_shapes)}
    exe = group.simple_bind(ctx, grad_req="null", **shapes)
    for n, v in values.items():
        exe.arg_dict[n][:] = v
    mx.random.seed(seed)
    key = mx.random.next_key()
    mx.random.seed(seed)
    calls = dict(threefry.threefry2x32.calls)
    exe.forward(is_train=True)
    card = [o.asnumpy() != 0 for o in exe.outputs[1:]]
    serials = exe._rng_serials
    host = [threefry.bernoulli(threefry.fold_in(key, s), 0.5,
                               o.shape).numpy()
            for s, o in zip(serials, exe.outputs[1:])]
    dev_type = "cuda" if device == "cuda" else "cpu"
    mask_calls = (threefry.threefry2x32.calls.get(dev_type, 0)
                  - calls.get(dev_type, 0))
    same = (len(card) == len(host) == len(names) == seq_len + 1
            and all(np.array_equal(a, b) for a, b in zip(card, host)))
    kept = [float(m.mean()) for m in card]
    sigma = [float(np.sqrt(0.25 / m.size)) for m in card]

    def step_ms(p):
        sym = symbol(p)
        req = {n: ("null" if n in shapes else "write")
               for n in sym.list_arguments()}
        ex = sym.simple_bind(ctx, grad_req=req, **shapes)
        for n in sym.list_arguments():
            ex.arg_dict[n][:] = values[n]

        def step():
            ex.forward(is_train=True)
            ex.backward()

        if device == "cuda":
            return cuda_ms(step, iters=10, warmup=2)
        step()
        t0 = time.perf_counter()
        step()
        return 1e3 * (time.perf_counter() - t0)

    rec = {"seq_len": seq_len, "seed": seed, "dropout_nodes": len(card),
           "serials": serials, "masks_equal_host": bool(same),
           "threefry_calls_on_device": mask_calls,
           "kept_share": kept, "kept_sigma": sigma,
           "fwd_bwd_ms_dropout_0.5": step_ms(0.5),
           "fwd_bwd_ms_dropout_0": step_ms(0.0)}
    del exe
    if not same:
        raise AssertionError("the card's dropout masks differ from the "
                             "host's for the same keys: %r" % rec)
    if any(abs(k - 0.5) > 4 * s for k, s in zip(kept, sigma)):
        raise AssertionError("a dropout mask keeps %r, beyond 4 sigma of "
                             "0.5" % kept)
    if device == "cuda" and mask_calls == 0:
        raise AssertionError("no threefry draw ran on the card")
    return rec


def lstm_batch_parts(em, data, args, device):
    """Where one training batch of the longest bucket spends its time,
    after the fit, through the fit's executor manager: the ms of loading
    the batch, the forward, the backward, the optimizer's updates (a
    fresh SGD of the recipe's settings) and the metric, each part
    synchronised, the mean of 5 batches after a warm one."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.model import _update_params

    data.reset()
    batch = next(b for b in data if b.bucket_key == max(args.buckets))
    updater = mx.optimizer.get_updater(mx.optimizer.create(
        "sgd", rescale_grad=1.0 / args.batch_size, learning_rate=args.lr,
        momentum=0.9, wd=0.00001))
    metric = mx.metric.Perplexity(ignore_label=0)
    steps = (("load", lambda: em.load_data_batch(batch)),
             ("forward", lambda: em.forward(is_train=True)),
             ("backward", em.backward),
             ("update", lambda: _update_params(
                 em.param_arrays, em.grad_arrays, updater, 1)),
             ("metric", lambda: em.update_metric(metric, batch.label)))
    reps = 5
    ms = {name: 0.0 for name, _ in steps}
    for rep in range(reps + 1):
        for name, fn in steps:
            t = time.perf_counter()
            fn()
            _sync(device)
            if rep:
                ms[name] += 1e3 * (time.perf_counter() - t) / reps
    return {"bucket": batch.bucket_key, "ms": ms, "total_ms": sum(ms.values())}


def phase_lstm_bucketing(device="cuda", argv=()):
    """The LSTM language model over bucketing (baseline config #3):
    examples/rnn_torch/lstm_bucketing.py's recipe at its defaults (2
    layers, 200 hidden, 200 embed, batch 32, buckets 10-60, SGD lr 0.1,
    momentum 0.9, wd 1e-5, Xavier("in", 2.34), 5 epochs, the synthetic
    Markov corpus of seed 0) through ``FeedForward(symbol=sym_gen).fit``
    with ``Perplexity(ignore_label=0)`` on the device, ``np.random`` and
    ``mx.random`` seeded first. Checks: epoch 5's train perplexity (the metric at the
    epoch's end) below epoch 1's and below half the corpus's unigram
    perplexity; K1 (SoftmaxOutput's forward) launched once a batch,
    its count zeroed just before ``fit`` and read just after; every
    bucket's executor on one parameter and gradient storage, every array
    on the device; the Dropout check of :func:`lstm_dropout_check`.
    Prints ms a batch by bucket (synchronised, each bucket's first batch
    excluded, the profiled last epoch too), non-pad tokens/s, peak memory,
    the device's busy share over the last epoch (``torch.profiler``, the
    card's activity over the mean wall of the unprofiled epochs after the
    first) and :func:`lstm_batch_parts`. Returns its record (K1's
    launches in ``softmax_launches``)."""
    import numpy as np
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import softmax as sm

    ex = _lstm_example()
    args = ex.parse_args(list(argv))
    ctx = _ctx(device)
    np.random.seed(0)    # the iterator's batch order
    mx.random.seed(0)    # the initial weights, whatever ran before
    with ctx:   # the iterator makes its batches on the current context
        data, sym_gen, model = ex.build(args, ctx=ctx)
        import bucket_io

        floor = unigram_perplexity(bucket_io.synthetic_corpus())
        per_epoch = len(data.batches)
        epochs = args.num_epochs
        nonpad = sum(int((lab != 0).sum()) for _, _, lab in data.batches)
        stamps, ppl, seen = [], {}, {}
        prof = None
        if device == "cuda" and epochs > 1:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA])

        def on_batch(param):
            _sync(device)
            stamps.append((param.epoch, param.nbatch,
                           param.locals["data_batch"].bucket_key,
                           time.perf_counter()))
            ppl[param.epoch] = param.eval_metric.get()[1]
            seen["em"] = param.locals["executor_manager"]
            if prof is not None and param.nbatch == per_epoch:
                if param.epoch == epochs - 2:
                    prof.start()
                elif param.epoch == epochs - 1:
                    prof.stop()

        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _sync(device)
        sm.fused_softmax.launches = 0
        t0 = time.perf_counter()
        model.fit(X=data, eval_metric=mx.metric.Perplexity(ignore_label=0),
                  batch_end_callback=on_batch, kvstore=args.kv_store)
        _sync(device)
        wall = time.perf_counter() - t0
        launches = sm.fused_softmax.launches
    peak = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" \
        else None

    prev = [t0] + [s[3] for s in stamps[:-1]]
    batches = [(e, k, t - p) for (e, _, k, t), p in zip(stamps, prev)]
    first = {}
    for i, (e, k, _) in enumerate(batches):
        first.setdefault(k, i)
    profiled = epochs - 1 if prof is not None else None
    by_bucket = {}
    for i, (e, k, s) in enumerate(batches):
        if i != first[k] and e != profiled:
            by_bucket.setdefault(k, []).append(1e3 * s)
    epoch_s = [sum(s for e, _, s in batches if e == ep)
               for ep in range(epochs)]
    plain = [epoch_s[ep] for ep in range(1, epochs) if ep != profiled]
    plain_epoch_s = sum(plain) / len(plain) if plain else epoch_s[0]
    busy = None
    if prof is not None:
        summed_ms, busy_ms, events = device_busy(prof)
        busy = {"epoch": profiled, "device_events": events,
                "device_ms": summed_ms, "device_busy_ms": busy_ms,
                "profiled_epoch_s": epoch_s[profiled],
                "unprofiled_epoch_s": plain_epoch_s,
                "busy_share": busy_ms / 1e3 / plain_epoch_s,
                "busy_share_of_profiled_wall":
                    busy_ms / 1e3 / epoch_s[profiled]}

    em = seen["em"]
    default = em.execgrp.train_execs[0]
    dev_type = "cuda" if device == "cuda" else "cpu"
    shared = True
    on_device = True
    for key, grp in em.execgrp_bucket.items():
        exe = grp.train_execs[0]
        for n in em.param_names:
            shared &= (exe.arg_dict[n]._data.data_ptr()
                       == default.arg_dict[n]._data.data_ptr()
                       and exe.grad_dict[n]._data.data_ptr()
                       == default.grad_dict[n]._data.data_ptr())
        arrays = exe.arg_arrays + [g for g in exe.grad_arrays if g is not None]
        on_device &= all(a._data.device.type == dev_type for a in arrays)
    ppl_list = [float(ppl[e]) for e in range(epochs)]
    rec = {"phase": "lstm_bucketing", "example": LSTM_EXAMPLE,
           "layers": args.num_lstm_layer, "hidden": args.num_hidden,
           "embed": args.num_embed, "batch": args.batch_size,
           "buckets": args.buckets, "vocab": data.vocab_size,
           "epochs": epochs, "batches": len(batches),
           "batches_per_bucket": {k: sum(1 for _, kk, _ in batches if kk == k)
                                  // epochs for k in sorted(first)},
           "params": int(sum(v.size for v in model.arg_params.values())),
           "train_perplexity": ppl_list, "unigram_perplexity": floor,
           "perplexity_limit": floor / 2, "wall_s": wall,
           "epoch_s": epoch_s,
           "ms_per_batch_by_bucket": {k: sum(v) / len(v)
                                      for k, v in sorted(by_bucket.items())},
           "ms_per_batch_by_bucket_range": {
               k: [min(v), max(v)] for k, v in sorted(by_bucket.items())},
           "nonpad_tokens_per_epoch": nonpad,
           "nonpad_tokens_per_s": nonpad / plain_epoch_s,
           "peak_mem_gb": peak, "busy": busy,
           "softmax_launches": launches,
           "buckets_share_storage": bool(shared),
           "arrays_on_device": bool(on_device),
           "bucket_executors": sorted(em.execgrp_bucket)}
    with ctx:
        rec["batch_parts"] = lstm_batch_parts(em, data, args, device)
    del em, seen, model
    rec["dropout"] = lstm_dropout_check(device, args, data.vocab_size)
    log(rec)
    if not all(np.isfinite(ppl_list)):
        raise AssertionError("non-finite perplexity: %r" % ppl_list)
    if not (ppl_list[-1] < ppl_list[0] and ppl_list[-1] < floor / 2):
        raise AssertionError(
            "the last epoch's perplexity %g is not below the first's %g "
            "and half the unigram perplexity %g"
            % (ppl_list[-1], ppl_list[0], floor / 2))
    expected = per_epoch * epochs if device == "cuda" else 0
    if launches != expected:
        raise AssertionError("the LSTM fit launched K1 %d times, expected "
                             "%d" % (launches, expected))
    if not (shared and on_device
            and rec["bucket_executors"] == sorted(args.buckets)):
        raise AssertionError("buckets not on one storage on the device: "
                             "%r" % rec)
    return rec


# SSD (baseline config #5): examples/ssd_torch/train_net.py at its defaults
SSD_EXAMPLE = os.path.join("examples", "ssd_torch", "train_net.py")
SSD_RTOL, SSD_ATOL = 1e-4, 1e-5   # the op checks, card against host (f32)
SSD_FG_ACC = 0.2   # tests/train/test_baselines.py:166-204's tripwire
SSD_MAP = 0.25     # the example's own gate (train_net.py:130)


def _ssd_example():
    """examples/ssd_torch/train_net.py as a module; its directory goes on
    the path for its ``symbol_ssd`` and ``evaluate``."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        SSD_EXAMPLE)
    if os.path.dirname(path) not in sys.path:
        sys.path.insert(0, os.path.dirname(path))
    spec = importlib.util.spec_from_file_location("ssd_train_net", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ssd_anchors(hw=(4, 4), sizes=(0.3, 0.5), ratios=(1, 2, 0.5)):
    import numpy as np
    import torch

    from mxnet_tpu_torch.ops import registry

    op = registry.get("MultiBoxPrior")
    p = op.parse_params({"sizes": sizes, "ratios": ratios, "clip": True})
    out, _ = op.apply(p, [torch.zeros((1, 1) + tuple(hw))])
    return out[0].numpy().astype(np.float32)


def _ssd_boxes(rng, n):
    import numpy as np

    w, h = rng.uniform(0.1, 0.6, n), rng.uniform(0.1, 0.6, n)
    x1, y1 = rng.uniform(0, 1 - w), rng.uniform(0, 1 - h)
    return np.stack([x1, y1, x1 + w, y1 + h], axis=1).astype(np.float32)


def ssd_op_case(name):
    """One op check of this slice: ``(op, params, inputs, diff, exact)``:
    seeded numpy inputs, the indices of the inputs to differentiate and,
    for each output, the columns of its last axis that must be exactly
    equal (``"all"``, a slice, or None for close only)."""
    import numpy as np

    rng = np.random.RandomState(sum(map(ord, name)))
    f32 = np.float32
    if name.startswith("MultiBoxTarget"):
        # duplicate anchors and duplicate ground truth: exact IoU ties in
        # the flattened argmax; tied mining scores (all-zero logits)
        anchors = _ssd_anchors(sizes=(0.4, 0.4), ratios=(1, 2))
        A = anchors.shape[1]
        B, L, C = 4, 3, 4
        lab = -np.ones((B, L, 5), f32)
        for b, k in enumerate([2, 3, 1, 0]):   # image 3: no ground truth
            lab[b, :k, 0] = rng.randint(0, C - 1, k)
            lab[b, :k, 1:] = _ssd_boxes(rng, k)
        lab[1, 1] = lab[1, 0]
        lab[0, 0, 1:] = anchors[0, 5]
        lab[2, 0, 1:] = anchors[0, 20]
        cls = rng.randn(B, C, A).astype(f32)
        if name == "MultiBoxTarget_mining_ties":
            cls[:] = 0.0
            cls[:, :, ::5] = 1.0
        params = {"overlap_threshold": 0.5, "negative_mining_ratio": 3,
                  "negative_mining_thresh": 0.5, "ignore_label": -1}
        return ("MultiBoxTarget", params, [anchors, lab, cls], [],
                [None, "all", "all"])
    if name.startswith("MultiBoxDetection"):
        anchors = _ssd_anchors(sizes=(0.3, 0.6))
        A = anchors.shape[1]
        logits = rng.randn(3, 4, A).astype(f32) * 2
        logits[:, :, ::3] = 0.0                  # score ties
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        prob = (e / e.sum(axis=1, keepdims=True)).astype(f32)
        loc = (rng.randn(3, A * 4) * 0.5).astype(f32)
        params = {"nms_threshold": 0.45, "threshold": 0.2,
                  "force_suppress": name.endswith("force")}
        return ("MultiBoxDetection", params, [prob, loc, anchors], [0, 1],
                [slice(0, 2)])
    if name == "ROIPooling":
        data = np.maximum(rng.randn(2, 3, 16, 16), 0).astype(f32)
        rois = np.array([[0, 0, 0, 15, 15], [1, 2.5, 3.5, 9.5, 7.5],
                         [1, 10, 4, 11, 5], [0, -4, -4, 3, 3],
                         [-1, 6, 6, 30, 30]], f32)
        return ("ROIPooling", {"pooled_size": (3, 2), "spatial_scale": 0.5},
                [data, rois], [0], [None])
    if name == "SpatialTransformer":
        data = rng.randn(3, 2, 9, 11).astype(f32)
        loc = (np.array([1, 0, 0, 0, 1, 0], f32)
               + rng.randn(3, 6) * 0.3).astype(f32)
        return ("SpatialTransformer", {"target_shape": (7, 6)}, [data, loc],
                [0, 1], [None])
    if name == "Correlation":
        a, b = rng.randn(2, 2, 3, 8, 9).astype(f32)
        return ("Correlation", {"kernel_size": 3, "max_displacement": 2,
                                "stride2": 2, "pad_size": 2}, [a, b], [0, 1],
                [None])
    if name == "WarpCTC":
        T, A = 9, 6
        lab = np.array([[1, 1, 2, 0], [3, 0, 3, 4], [0, 0, 0, 0]], f32)
        data = (rng.randn(T * 3, A) * 1.5).astype(f32)
        return ("WarpCTC", {"input_length": T, "label_length": 4},
                [data, lab.reshape(-1)], [0], [None])
    if name.startswith("SVMOutput"):
        return ("SVMOutput", {"use_linear": name.endswith("l1"),
                              "margin": 0.5},
                [rng.randn(6, 5).astype(f32),
                 np.array([0, 4, 2, 2, 1, 3], f32)], [0], [None])
    if name.endswith("RegressionOutput"):
        return (name, {"grad_scale": 0.5}, [rng.randn(5, 3).astype(f32),
                                            rng.randn(5, 3).astype(f32)],
                [0], [None])
    if name == "MakeLoss":
        x = np.abs(rng.randn(4, 6)).astype(f32)
        x[:, ::2] = 0.0
        return ("MakeLoss", {"normalization": "valid", "grad_scale": 0.7},
                [x], [0], [None])
    if name == "smooth_l1":
        return ("smooth_l1", {"scalar": 1.0},
                [(rng.randn(4, 7) * 1.5).astype(f32)], [0], [None])
    raise KeyError(name)


SSD_OP_CASES = ("MultiBoxTarget_ties", "MultiBoxTarget_mining_ties",
                "MultiBoxDetection", "MultiBoxDetection_force",
                "ROIPooling", "SpatialTransformer", "Correlation", "WarpCTC",
                "SVMOutput_l2", "SVMOutput_l1", "LinearRegressionOutput",
                "LogisticRegressionOutput", "MAERegressionOutput",
                "MakeLoss", "smooth_l1")


def _op_run(op, params, inputs, diff, device, key=None):
    import numpy as np
    import torch

    xs = [torch.tensor(x, device=device, requires_grad=True)
          for x in inputs]
    if key is not None:
        key = key.to(device)
    outs, _ = op.apply(params, xs, [], True, key)
    grads = []
    if diff:
        rng = np.random.RandomState(7)
        cots = [torch.tensor(rng.randn(*o.shape).astype(np.float32),
                             device=device).to(o.dtype) for o in outs]
        live = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
        grads = [None] * len(diff)
        if live:   # an output without a gradient: BlockGrad, argmax
            grads = torch.autograd.grad([o for o, _ in live],
                                        [xs[k] for k in diff],
                                        [c for _, c in live],
                                        allow_unused=True)
        grads = [torch.zeros_like(xs[k]) if g is None else g
                 for k, g in zip(diff, grads)]
    return ([o.detach().cpu().numpy() for o in outs],
            [g.cpu().numpy() for g in grads],
            [o.requires_grad for o in outs])


def ssd_op_check(name, device="cuda"):
    """The op of case ``name`` on ``device`` against the same op on the
    host, on the same inputs: forward and the gradients of one seeded
    cotangent within rtol 1e-4 and atol 1e-5, the case's exact columns
    (``cls_target``, ``loc_mask``, detection ids, scores and row order)
    bit-equal. Raises AssertionError; returns the errors."""
    import numpy as np

    from mxnet_tpu_torch.ops import registry

    opname, params, inputs, diff, exact = ssd_op_case(name)
    op = registry.get(opname)
    p = op.parse_params(dict(params))
    outs_d, grads_d, req = _op_run(op, p, inputs, diff, device)
    outs_h, grads_h, _ = _op_run(op, p, inputs, diff, "cpu")
    rec = {"op": opname, "case": name, "max_abs_err": 0.0, "exact": []}
    for k, (a, b) in enumerate(zip(outs_d, outs_h)):
        ex = exact[k] if k < len(exact) else None
        if ex is not None:
            sl = (Ellipsis, ex) if isinstance(ex, slice) else Ellipsis
            if not np.array_equal(a[sl], b[sl]):
                raise AssertionError("%s: output %d differs on the card "
                                     "from the host" % (name, k))
            rec["exact"].append(k)
    for a, b in zip(outs_d + grads_d, outs_h + grads_h):
        if a.shape != b.shape or not np.all(np.isfinite(a)):
            raise AssertionError("%s: shape or finiteness" % name)
        err = float(np.abs(a - b).max()) if a.size else 0.0
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if not np.allclose(a, b, rtol=SSD_RTOL, atol=SSD_ATOL):
            raise AssertionError("%s: card and host differ by %g"
                                 % (name, err))
    if opname == "MultiBoxTarget" and any(req):
        raise AssertionError("MultiBoxTarget's outputs carry a gradient")
    if opname == "MultiBoxTarget":
        cls_t = outs_h[2]
        rec["targets"] = {"positive": int((cls_t > 0).sum()),
                          "negative": int((cls_t == 0).sum()),
                          "ignored": int((cls_t < 0).sum())}
    return rec


def phase_ssd(device="cuda", argv=()):
    """SSD (baseline config #5): examples/ssd_torch/train_net.py's ``main``
    at its defaults (512 synthetic 3x64x64 images, 3 classes, batch 32,
    25 epochs, SGD 0.1, momentum 0.9, wd 5e-4, Xavier) through
    ``Module.fit`` with ``MXNET_SCAN_TRAIN`` at its default (the scanned
    fit, K = 8), then its detection module over 128 held-out images.
    Checks: the example's own gate (held-out mAP@0.5 > 0.25, asserted in
    ``main`` and here); after the fit, the foreground accuracy of the
    anchor classifier on one training batch > 0.2 (the tripwire of
    tests/train/test_baselines.py:166-204); that the fit built its
    scanned trainer; that ``MultiBoxMetric``'s CrossEntropy fell from the
    first epoch to the last; every output finite; K1 launched 0 times
    (its count zeroed just before ``main``, read just after). Then every
    op of :data:`SSD_OP_CASES` on the device against the host
    (:func:`ssd_op_check`). Prints ms a step (median and range over the
    epochs after the first, each epoch's wall over its batches), img/s,
    peak memory, the detection forward's ms (median of 5, synchronised)
    and its device launches (``torch.profiler``), the mAP. Returns the
    record (K1's launches in ``softmax_launches``)."""
    import numpy as np
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import softmax as sm
    from mxnet_tpu_torch.parallel import fit_trainer

    ex = _ssd_example()
    argv = list(argv) + (["--ctx", "cpu"] if device == "cpu" else [])
    seen = {"built": 0, "ce": [], "smoothl1": [], "stamps": []}
    real_make = fit_trainer.make_fit_trainer
    real_fit = mx.module.Module.fit
    real_eval = ex.evaluate_detections

    def make(*a, **kw):
        seen["built"] += 1
        return real_make(*a, **kw)

    prof = None
    if device == "cuda":
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])

    def fit(self, train_data, **kw):
        seen["module"], seen["train"] = self, train_data
        metric = kw["eval_metric"]
        epochs = kw["num_epoch"]

        def on_epoch(epoch, *_):
            _sync(device)
            seen["stamps"].append(time.perf_counter())
            (ce, sl1) = metric.get()[1]
            seen["ce"].append(float(ce))
            seen["smoothl1"].append(float(sl1))
            if prof is not None and epochs > 2:   # the last epoch
                if epoch == epochs - 2:
                    prof.start()
                elif epoch == epochs - 1:
                    prof.stop()

        kw["epoch_end_callback"] = on_epoch
        _sync(device)
        seen["t0"] = time.perf_counter()
        return real_fit(self, train_data, **kw)

    def evaluate(det, X, Y, batch_size, num_classes, **kw):
        seen["det"], seen["held_out"] = det, (X, Y)
        seen["map"] = real_eval(det, X, Y, batch_size, num_classes, **kw)
        return seen["map"]

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with mock.patch.dict(os.environ), \
            mock.patch.object(sys, "argv", ["train_net.py"] + argv), \
            mock.patch.object(fit_trainer, "make_fit_trainer", make), \
            mock.patch.object(mx.module.Module, "fit", fit), \
            mock.patch.object(ex, "evaluate_detections", evaluate):
        for k in ("MXNET_SCAN_TRAIN", "MXNET_TRAIN_SCAN_K",
                  "MXNET_COMPUTE_DTYPE", "MXNET_EXAMPLE_SMOKE",
                  "MXNET_ENFORCE_DETERMINISM"):
            os.environ.pop(k, None)   # the defaults: scanned, K = 8
        args = ex.parse_args()
        _sync(device)
        sm.fused_softmax.launches = 0
        t0 = time.perf_counter()
        ex.main()
        _sync(device)
        wall = time.perf_counter() - t0
        launches = sm.fused_softmax.launches
    peak = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" \
        else None

    per_epoch = -(-args.num_examples // args.batch_size)
    epoch_s = [b - a for a, b in zip([seen["t0"]] + seen["stamps"][:-1],
                                     seen["stamps"])]
    plain = epoch_s[1:-1] if prof is not None else epoch_s[1:]
    steps_ms = sorted(1e3 * s / per_epoch for s in plain or epoch_s)
    step_ms = steps_ms[len(steps_ms) // 2]
    busy = None
    if prof is not None:
        summed_ms, busy_ms, events = device_busy(prof)
        plain_s = sum(plain) / len(plain)
        busy = {"epoch": args.num_epochs - 1, "device_events": events,
                "device_ms": summed_ms, "device_busy_ms": busy_ms,
                "profiled_epoch_s": epoch_s[-1],
                "unprofiled_epoch_s": plain_s,
                "busy_share": busy_ms / 1e3 / plain_s,
                "device_events_per_step": events / per_epoch}

    # the tripwire: one training batch through the trained module
    mod, train = seen["module"], seen["train"]
    with _ctx(device):
        train.reset()
        batch = next(iter(train))
        mod.forward(batch, is_train=False)
        cls_prob, loc_loss, cls_label = [o.asnumpy()
                                         for o in mod.get_outputs()]
    pred = cls_prob.argmax(axis=1)
    fg = cls_label > 0
    fg_acc = float((pred[fg] == cls_label[fg]).mean()) if fg.any() else 0.0

    # the detection forward: ms and device launches
    det = seen["det"]
    Xe = seen["held_out"][0]
    with _ctx(device):
        xb = mx.io.DataBatch(data=[mx.nd.array(Xe[:args.batch_size])],
                             label=None)
        det.forward(xb, is_train=False)
        _sync(device)
        det_ms = []
        for _ in range(5):
            t = time.perf_counter()
            det.forward(xb, is_train=False)
            out = det.get_outputs()[0]
            _sync(device)
            det_ms.append(1e3 * (time.perf_counter() - t))
        det_events = None
        if device == "cuda":
            with profile(activities=[ProfilerActivity.CUDA]) as det_prof:
                det.forward(xb, is_train=False)
                _sync(device)
            det_events = device_busy(det_prof)[2]
        det_out = out.asnumpy()
    det_ms.sort()

    ops = [ssd_op_check(name, device) for name in SSD_OP_CASES]
    rec = {"phase": "ssd", "example": SSD_EXAMPLE,
           "examples": args.num_examples, "image": args.image,
           "classes": args.num_classes, "batch": args.batch_size,
           "epochs": args.num_epochs, "batches_per_epoch": per_epoch,
           "lr": args.lr, "scanned_trainer_built": seen["built"],
           "anchors": int(cls_prob.shape[2]),
           "params": int(sum(v.size for v in mod.get_params()[0].values())),
           "wall_s": wall, "epoch_s": epoch_s,
           "step_ms_median": step_ms,
           "step_ms_range": [steps_ms[0], steps_ms[-1]],
           "img_per_s": args.batch_size / step_ms * 1e3,
           "peak_mem_gb": peak, "busy": busy,
           "cross_entropy_by_epoch": seen["ce"],
           "smoothl1_by_epoch": seen["smoothl1"],
           "fg_accuracy": fg_acc, "fg_anchors": int(fg.sum()),
           "map": seen["map"],
           "detection_forward_ms_median": det_ms[len(det_ms) // 2],
           "detection_forward_ms_range": [det_ms[0], det_ms[-1]],
           "detection_forward_device_launches": det_events,
           "detections_kept_first_image": int((det_out[0, :, 0] >= 0).sum()),
           "softmax_launches": launches, "op_checks": ops}
    log(rec)
    finite = all(np.all(np.isfinite(a)) for a in
                 (cls_prob, loc_loss, cls_label, det_out,
                  np.array(seen["ce"] + seen["smoothl1"])))
    if not finite:
        raise AssertionError("SSD: a non-finite output")
    if seen["built"] != 1:
        raise AssertionError("SSD's Module.fit built its scanned trainer "
                             "%d times, expected once" % seen["built"])
    if not seen["map"] > SSD_MAP:
        raise AssertionError("SSD: held-out mAP %g <= %g"
                             % (seen["map"], SSD_MAP))
    if not fg_acc > SSD_FG_ACC:
        raise AssertionError("SSD: foreground accuracy %g <= %g"
                             % (fg_acc, SSD_FG_ACC))
    if not (len(seen["ce"]) > 1 and seen["ce"][-1] < seen["ce"][0]):
        raise AssertionError("SSD: CrossEntropy did not fall: %r"
                             % seen["ce"])
    if launches != 0:
        raise AssertionError("SSD launched K1 %d times, expected 0"
                             % launches)
    return rec


# -- Inception-BN, the rest of ops/nn.py and ops/tensor.py, the model zoo,
# examples/image-classification_torch ---------------------------------------
IC_DIR = os.path.join("examples", "image-classification_torch")
NET_TOL = 1e-3       # a whole net on the card against the host (f32)
CIFAR_VAL_ACC = 0.95  # train_cifar10's synthetic set, after 3 epochs


def _ic_example(script):
    """(train_model, ``script``) of examples/image-classification_torch,
    each loaded by path under a name of its own; the script's ``import
    train_model`` gets this directory's."""
    import importlib.util

    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), IC_DIR)

    def load(fname, name):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(d, fname))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    tm = load("train_model.py", "ic_train_model")
    saved = sys.modules.get("train_model")
    sys.modules["train_model"] = tm
    try:
        ex = load(script, "ic_" + script[:-3])
    finally:
        if saved is None:
            sys.modules.pop("train_model", None)
        else:
            sys.modules["train_model"] = saved
    return tm, ex


def _rand(*shape, seed=0, scale=1.0, shift=0.0):
    import numpy as np

    return (np.random.RandomState(seed).randn(*shape) * scale
            + shift).astype(np.float32)


def _labels(n, high, seed=0):
    import numpy as np

    return np.random.RandomState(seed).randint(0, high, n).astype(np.float32)


def zoo_op_cases():
    """Every op of the slice on seeded inputs: name -> (op, params,
    inputs, differentiated inputs, key seed or None, outputs that must be
    bit-equal)."""
    import numpy as np

    x = _rand(2, 6, 5, 4, scale=2.0)
    pos = np.abs(_rand(3, 4, seed=1)) + 0.5
    r = _rand(3, 4, 5, seed=3)
    a, b = _rand(3, 1, 4, seed=1), _rand(1, 5, 4, seed=2)
    cases = {
        "LeakyReLU_leaky": ("LeakyReLU", {}, [x], (0,), None, ()),
        "LeakyReLU_elu": ("LeakyReLU", {"act_type": "elu"}, [x], (0,), None,
                          ()),
        "LeakyReLU_prelu": ("LeakyReLU", {"act_type": "prelu"},
                            [x, np.abs(_rand(6, seed=1))], (0, 1), None, ()),
        "LeakyReLU_rrelu_train": ("LeakyReLU", {"act_type": "rrelu"}, [x],
                                  (0,), 5, (0,)),
        "Deconvolution": ("Deconvolution", {
            "kernel": (4, 4), "stride": (2, 2), "pad": (1, 1), "adj": (1, 1),
            "num_filter": 3}, [x, _rand(6, 3, 4, 4, seed=1),
                               _rand(3, seed=2)], (0, 1, 2), None, ()),
        "Deconvolution_target_group": ("Deconvolution", {
            "kernel": (3, 3), "target_shape": (6, 5), "num_filter": 4,
            "num_group": 2, "no_bias": True},
            [x, _rand(6, 2, 3, 3, seed=1)], (0, 1), None, ()),
        "Deconvolution_3d": ("Deconvolution", {
            "kernel": (2, 2, 2), "stride": (2, 2, 2), "num_filter": 2},
            [_rand(1, 3, 3, 4, 2), _rand(3, 2, 2, 2, 2, seed=1),
             _rand(2, seed=2)], (0, 1, 2), None, ()),
        "InstanceNorm": ("InstanceNorm", {}, [x, _rand(6, seed=1),
                                              _rand(6, seed=2)],
                         (0, 1, 2), None, ()),
        "LRN": ("LRN", {"nsize": 5}, [x], (0,), None, ()),
        "ElementWiseSum": ("ElementWiseSum", {"num_args": 3},
                           [x, _rand(*x.shape, seed=1),
                            _rand(*x.shape, seed=2)], (0, 1, 2), None, ()),
        "Cast": ("Cast", {"dtype": "float16"}, [x], (0,), None, ()),
        "BlockGrad": ("BlockGrad", {}, [x], (0,), None, ()),
        "UpSampling_nearest_concat": ("UpSampling", {
            "scale": 2, "sample_type": "nearest", "num_args": 2},
            [x, _rand(*x.shape, seed=1)], (0, 1), None, ()),
        "UpSampling_nearest_sum": ("UpSampling", {
            "scale": 3, "sample_type": "nearest", "num_args": 2,
            "multi_input_mode": "sum"}, [x, _rand(*x.shape, seed=1)],
            (0, 1), None, ()),
        "UpSampling_bilinear": ("UpSampling", {
            "scale": 2, "sample_type": "bilinear"},
            [x, _rand(6, 1, 4, 4, seed=1)], (0, 1), None, ()),
        "Crop_h_w": ("Crop", {"num_args": 1, "h_w": (3, 2),
                              "offset": (1, 1)}, [x], (0,), None, ()),
        "Crop_like_center": ("Crop", {"num_args": 2, "center_crop": True},
                             [x, _rand(2, 1, 3, 3)], (0,), None, ()),
        "IdentityAttachKLSparseReg": ("IdentityAttachKLSparseReg", {
            "penalty": 0.5}, [_rand(8, 5)], (0,), None, ()),
    }
    for mode in ("instance", "channel", "spatial"):
        cases["L2Normalization_" + mode] = ("L2Normalization",
                                            {"mode": mode}, [x], (0,),
                                            None, ())
    for name in ("abs", "ceil", "cos", "exp", "floor", "round", "sign",
                 "sin", "square", "negative", "_neg", "tanh_op"):
        cases[name] = (name, {}, [_rand(3, 4, scale=3.0)], (0,), None, ())
    for name in ("log", "rsqrt", "sqrt"):
        cases[name] = (name, {}, [pos], (0,), None, ())
    for name in ("plus", "minus", "mul", "maximum", "minimum", "equal",
                 "greater", "lesser"):
        cases["broadcast_" + name] = ("broadcast_" + name, {}, [a, b], (0, 1),
                                      None, ())
    cases["broadcast_div"] = ("broadcast_div", {}, [a, np.abs(b) + 0.5],
                              (0, 1), None, ())
    cases["broadcast_power"] = ("broadcast_power", {}, [np.abs(a) + 0.5, b],
                                (0, 1), None, ())
    for name in ("max", "max_axis", "min", "min_axis", "mean"):
        cases[name] = (name, {"axis": (1,)}, [r], (0,), None, ())
    cases["norm"] = ("norm", {}, [r], (0,), None, ())
    for name in ("argmax", "argmin"):
        cases[name] = (name, {"axis": 2}, [r], (), None, (0,))
    cases["argmax_channel"] = ("argmax_channel", {}, [r], (), None, (0,))
    cases["clip"] = ("clip", {"a_min": -0.5, "a_max": 0.7}, [r], (0,), None,
                     ())
    cases["broadcast_axis"] = ("broadcast_axis", {"axis": (1,),
                                                  "size": (5,)}, [a], (0,),
                               None, ())
    cases["broadcast_to"] = ("broadcast_to", {"shape": (0, 5, 4)}, [a], (0,),
                             None, ())
    cases["dot"] = ("dot", {"transpose_a": True},
                    [_rand(5, 4), _rand(5, 3, seed=1)], (0, 1), None, ())
    cases["batch_dot"] = ("batch_dot", {"transpose_b": True},
                          [_rand(2, 4, 5), _rand(2, 3, 5, seed=1)], (0, 1),
                          None, ())
    cases["expand_dims"] = ("expand_dims", {"axis": -1}, [r], (0,), None, ())
    cases["flip"] = ("flip", {"axis": 1}, [r], (0,), None, ())
    cases["slice_axis"] = ("slice_axis", {"axis": 2, "begin": 1, "end": -1},
                           [r], (0,), None, ())
    cases["crop_nd"] = ("crop_nd", {"begin": (0, 1, 2), "end": (2, 3, 5)},
                        [r], (0,), None, ())
    cases["softmax_cross_entropy"] = ("softmax_cross_entropy", {},
                                      [_rand(6, 5, scale=2.0),
                                       _labels(6, 5)], (0,), None, ())
    cases["element_mask"] = ("element_mask", {}, [r, _labels(3, 2)], (0,),
                             None, ())
    cases["choose_element_0index"] = ("choose_element_0index", {},
                                      [_rand(4, 5), _labels(4, 5)], (0,),
                                      None, ())
    cases["fill_element_0index"] = ("fill_element_0index", {},
                                    [_rand(4, 5), _labels(4, 5, seed=1),
                                     _rand(4, seed=2)], (0, 2), None, ())
    return cases


ZOO_OP_CASES = tuple(sorted(zoo_op_cases()))


def zoo_op_check(name, device="cuda"):
    """The op of case ``name`` on ``device`` against the same op on the
    host, on the same inputs (a random op under the same key): forward
    and the gradients of one seeded cotangent within rtol 1e-4 and atol
    1e-5 (SSD_RTOL, SSD_ATOL), the case's exact outputs (``rrelu``'s
    training draws, the argument ops) bit-equal. Raises AssertionError;
    returns the errors."""
    import numpy as np

    from mxnet_tpu_torch import threefry
    from mxnet_tpu_torch.ops import registry

    opname, params, inputs, diff, seed, exact = zoo_op_cases()[name]
    op = registry.get(opname)
    p = op.parse_params(dict(params))
    key = None if seed is None else threefry.prng_key(seed, device="cpu")
    outs_d, grads_d, _ = _op_run(op, p, inputs, diff, device, key)
    outs_h, grads_h, _ = _op_run(op, p, inputs, diff, "cpu", key)
    rec = {"op": opname, "case": name, "max_abs_err": 0.0,
           "exact": list(exact)}
    for k in exact:
        if not np.array_equal(outs_d[k], outs_h[k]):
            raise AssertionError("%s: output %d differs on the card from "
                                 "the host" % (name, k))
    for a, b in zip(outs_d + grads_d, outs_h + grads_h):
        if a.shape != b.shape or a.dtype != b.dtype \
                or not np.all(np.isfinite(a)):
            raise AssertionError("%s: shape, dtype or finiteness" % name)
        a, b = a.astype(np.float64), b.astype(np.float64)
        err = float(np.abs(a - b).max()) if a.size else 0.0
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if not np.allclose(a, b, rtol=SSD_RTOL, atol=SSD_ATOL):
            raise AssertionError("%s: card and host differ by %g"
                                 % (name, err))
    return rec


def zoo_params(sym, shapes, seed):
    """Seeded numpy parameters of a Symbol graph: He-scaled weights,
    gammas near 1, small biases and betas, data in [0, 1), labels of the
    head's classes; the aux states at their initial values."""
    import numpy as np

    rng = np.random.RandomState(seed)
    arg_shapes, out_shapes, aux_shapes = sym.infer_shape(**shapes)
    args = {}
    for name, s in zip(sym.list_arguments(), arg_shapes):
        if name == "data":
            args[name] = rng.rand(*s).astype(np.float32)
        elif name.endswith("label"):
            args[name] = rng.randint(0, out_shapes[0][1], s).astype(
                np.float32)
        elif name.endswith("weight"):
            fan_in = int(np.prod(s[1:])) if len(s) > 1 else s[0]
            args[name] = (rng.randn(*s) * np.sqrt(2.0 / fan_in)).astype(
                np.float32)
        elif name.endswith("gamma"):
            args[name] = (1 + 0.1 * rng.randn(*s)).astype(np.float32)
        else:
            args[name] = (0.1 * rng.randn(*s)).astype(np.float32)
    aux = {n: (np.zeros(s) if n.endswith("mean") else np.ones(s)).astype(
        np.float32) for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def net_step(sym, shapes, args, aux, device, seed=0):
    """One bound executor's training forward and backward on ``device``
    from numpy parameters, random nodes under ``random.seed(seed)``:
    (outputs, gradients, aux states) as numpy."""
    import mxnet_tpu_torch as mx

    exe = sym.simple_bind(_ctx(device), grad_req="write", **shapes)
    for n, v in args.items():
        exe.arg_dict[n][:] = v
    for n, v in aux.items():
        exe.aux_dict[n][:] = v
    mx.random.seed(seed)
    exe.forward(is_train=True)
    exe.backward()
    grads = {n: g.asnumpy() for n, g in exe.grad_dict.items()
             if g is not None and n != "data" and not n.endswith("label")}
    return ([o.asnumpy() for o in exe.outputs], grads,
            {n: a.asnumpy() for n, a in exe.aux_dict.items()})


def _grad_rel(got, want, scale):
    """Relative L2 error of each gradient whose rms is above 1e-3 of
    ``scale`` (a bias before a BatchNorm has a zero gradient, up to
    rounding)."""
    import numpy as np

    return {n: float(np.linalg.norm(got[n] - want[n])
                     / np.linalg.norm(want[n]))
            for n in want if np.sqrt(np.mean(np.square(want[n])))
            > 1e-3 * scale}


def net_closeness(got, want, nudged):
    """A net's step on the card (``got``) against the host (``want``):
    the outputs' :func:`closeness` at NET_TOL, and the worst relative L2
    error over the gradients that do not vanish, held to the larger of
    NET_TOL and twice the worst gap between ``got`` and ``nudged``, the
    same step on the card from parameters nudged by 1e-6 relative. A
    deep net's gradient is that sensitive to f32 rounding: a max-pool
    window whose two largest entries lie within rounding of each other
    sends its gradient to either, and BatchNorm's one-pass variance
    cancels, so the card's and the host's sums, each right to f32, part
    by as much as such a nudge makes them part (VGG-16's first
    convolution 2e-3, Inception-BN's betas 3e-2, on the H100)."""
    import numpy as np
    import torch

    outs = [closeness(torch.from_numpy(a), torch.from_numpy(b), NET_TOL)
            for a, b in zip(got[0], want[0])]
    g, w = got[1], want[1]
    scale = float(np.sqrt(np.mean(np.concatenate(
        [np.square(v).ravel() for v in w.values()])))) if w else 0.0
    rel = _grad_rel(g, w, scale)
    chaos = _grad_rel(nudged[1], g, scale)
    worst = max(rel, key=rel.get) if rel else None
    limit = max(NET_TOL, 2 * max(chaos.values(), default=0.0))
    finite = all(np.all(np.isfinite(v)) for v in
                 list(got[0]) + list(g.values()) + list(got[2].values()))
    return {"outputs_elem": max(c["elem"] for c in outs),
            "outputs_rel_l2": max(c["rel_l2"] for c in outs),
            "grads_checked": len(rel), "grads_vanishing": len(w) - len(rel),
            "max_grad_rel_l2": rel[worst] if rel else 0.0,
            "worst_grad": worst,
            "nudged_max_grad_rel_l2": max(chaos.values(), default=0.0),
            "grad_limit": limit, "finite": finite,
            "ok": finite and all(within(c, NET_TOL) for c in outs)
            and (not rel or rel[worst] <= limit)}


def nudge(args, skip=("data",)):
    """``args`` with every parameter times (1 + 1e-6 N(0, 1)), seeded;
    the data and labels as they are."""
    import numpy as np

    rng = np.random.RandomState(99)
    return {k: v if k in skip or k.endswith("label") else
            (v * (1 + 1e-6 * rng.randn(*v.shape))).astype(v.dtype)
            for k, v in args.items()}


ZOO_NETS = {   # name -> (build, input shape at batch 2)
    "alexnet": (lambda mx: mx.models.get_alexnet(), (2, 3, 224, 224)),
    "vgg16": (lambda mx: mx.models.get_vgg(), (2, 3, 224, 224)),
    "vgg16_bn": (lambda mx: mx.models.get_vgg(batch_norm=True),
                 (2, 3, 224, 224)),
    "googlenet": (lambda mx: mx.models.get_googlenet(), (2, 3, 224, 224)),
    "inception_v3": (lambda mx: mx.models.get_inception_v3(),
                     (2, 3, 299, 299)),
    "unet": (lambda mx: mx.models.get_unet(), (2, 3, 64, 64)),
    "mlp": (lambda mx: mx.models.get_mlp(), (2, 784)),
}


def zoo_net_check(name, device="cuda"):
    """The zoo net ``name`` of :data:`ZOO_NETS`, one training forward and
    backward at batch 2 and its own input size on ``device`` against the
    port on the host, from the same seeded parameters and Dropout keys,
    beside the same step on ``device`` from nudged parameters
    (:func:`net_closeness`). Raises AssertionError; returns the
    record."""
    import mxnet_tpu_torch as mx

    build, dshape = ZOO_NETS[name]
    with mx.NameManager():
        sym = build(mx)
    label = [n for n in sym.list_arguments() if n.endswith("label")][0]
    _, out_shapes, _ = sym.infer_shape(data=dshape)
    shapes = {"data": dshape, label: out_shapes[0][:1] + out_shapes[0][2:]}
    args, aux = zoo_params(sym, shapes, seed=7)
    t0 = time.perf_counter()
    got = net_step(sym, shapes, args, aux, device)
    _sync(device)
    card_s = time.perf_counter() - t0
    want = net_step(sym, shapes, args, aux, "cpu")
    nudged = net_step(sym, shapes, nudge(args), aux, device)
    rec = dict(net_closeness(got, want, nudged), net=name,
               input=list(dshape),
               params=int(sum(v.size for k, v in args.items()
                              if k != "data" and k != label)),
               device_step_s=card_s)
    if not rec["ok"]:
        raise AssertionError("%s on the card differs from the host: %r"
                             % (name, rec))
    return rec


def phase_zoo(device="cuda", nets=None):
    """Every zoo net that the slice adds on the card against the host
    (:func:`zoo_net_check`), then every op of the slice
    (:func:`zoo_op_check`)."""
    recs = [zoo_net_check(name, device) for name in nets or ZOO_NETS]
    ops = [zoo_op_check(name, device) for name in ZOO_OP_CASES]
    out = {"phase": "zoo", "nets": recs, "op_cases": len(ops),
           "op_max_abs_err": max(o["max_abs_err"] for o in ops),
           "ops": sorted({o["op"] for o in ops})}
    log(out)
    return out


def phase_inception_bn_grad_check(device="cuda", batch=8, image=224):
    """The first step of Inception-BN at batch ``batch`` on the card
    against the port's host run of the same step from the same seeded
    parameters, beside the card's step from nudged parameters
    (:func:`net_closeness`: outputs at NET_TOL, the gradients that do
    not vanish within the larger of NET_TOL and twice the nudge's gap;
    f32, cuDNN's algorithms and the host's sum in other orders)."""
    import mxnet_tpu_torch as mx

    with mx.NameManager():
        sym = mx.models.get_inception_bn(num_classes=1000)
    shapes = {"data": (batch, 3, image, image), "softmax_label": (batch,)}
    args, aux = zoo_params(sym, shapes, seed=11)
    got = net_step(sym, shapes, args, aux, device)
    want = net_step(sym, shapes, args, aux, "cpu")
    nudged = net_step(sym, shapes, nudge(args), aux, device)
    rec = dict(net_closeness(got, want, nudged),
               phase="inception_bn_grad_check",
               batch=batch, image=image, tol=NET_TOL,
               aux_max_abs_err=max(float(abs(got[2][n] - want[2][n]).max())
                                   for n in want[2]))
    log(rec)
    if not rec["ok"]:
        raise AssertionError("Inception-BN's step on the card differs from "
                             "the host's: %r" % rec)
    return rec


KIND_FWD = {"Convolution": "convolution", "BatchNorm": "batchnorm",
            "Activation": "activation", "Pooling": "pooling",
            "Concat": "concat", "FullyConnected": "fully_connected",
            "SoftmaxOutput": "softmax_output", "Flatten": "other"}
KIND_BWD = (("Convolution", "convolution"), ("BNTrainNorm", "batchnorm"),
            ("Relu", "activation"), ("Pool", "pooling"), ("Cat", "concat"),
            ("Split", "concat"), ("Slice", "concat"),
            ("SoftmaxOutput", "softmax_output"), ("Mm", "fully_connected"),
            ("Addmm", "fully_connected"))


def kernel_kind(event, kernel):
    """The layer kind and direction that a profiled CUDA kernel belongs
    to: K1 by name, host-to-device copies by name, else the nearest
    ``mx::<op>`` range (forward) or autograd node (backward) above the
    op that launched it, else ``other``."""
    if "softmax_narrow" in kernel or "softmax_wide" in kernel:
        return "softmax_kernel_K1"
    if "HtoD" in kernel:
        return "input_copy_h2d"
    e = event
    while e is not None:
        name = e.name
        if name.startswith("mx::"):
            return KIND_FWD.get(name[4:], "other") + "_fwd"
        if name.startswith("autograd::engine::evaluate_function: "):
            fn = name.split(": ", 1)[1]
            for tag, kind in KIND_BWD:
                if tag in fn:
                    return kind + "_bwd"
            return "other_bwd"
        if name.startswith("Optimizer.") or "sgd" in name.lower() \
                or name.startswith("aten::_foreach"):
            return "sgd_update"
        e = e.cpu_parent
    return "other"


def device_time_by_kind(prof, steps):
    """Device ms a step by :func:`kernel_kind`, from a profile with CPU
    and CUDA activities and ``mx::<op>`` ranges."""
    by = {}
    for e in prof.events():
        for k in getattr(e, "kernels", ()):
            kind = kernel_kind(e, k.name)
            by[kind] = by.get(kind, 0.0) + k.duration / 1e3 / steps
    return dict(sorted(by.items(), key=lambda kv: -kv[1]))


def phase_inception_bn(device="cuda", argv=(), synthetic=None):
    """Inception-BN at examples/image-classification_torch/
    train_imagenet.py's defaults (``--network inception-bn
    --synthetic``: the example's 2048 seeded 3x224x224 images, 1000
    classes, batch 256, SGD lr 0.1, momentum 0.9, wd 1e-5, Xavier(in,
    2.34), lr x0.1 every 30 epochs) through its ``train_model.fit`` and
    the scanned ``FeedForward.fit``, for 4 epochs (32 steps): the first
    epoch warms, epochs 2 and 3 are timed, the last is profiled
    (``torch.profiler``, op forwards labelled ``mx::<op>``). The
    metric is the example's accuracy with a cross-entropy beside it, so
    each step's probabilities reach the host and its loss is read there.
    Checks: every step's cross-entropy finite, the parameters changed
    from the first epoch's end to the last's and finite, the scanned
    trainer built once, K1 launched once a step (its count zeroed just
    before, read just after). ``synthetic`` replaces the example's data
    (a CPU rehearsal at a small size). Returns the record (K1's launches
    in ``softmax_launches``)."""
    import math

    import numpy as np
    import torch

    import mxnet_tpu_torch as mx

    argv = (["--network", "inception-bn", "--synthetic", "--num-epochs",
             "4"] + list(argv))
    seen = {"ce": []}

    def on_batch(param):
        loc = param.locals
        prob = loc["host_outs"][0][loc["k"]]
        lab = loc["b"]["softmax_label"]
        lab = lab.cpu().numpy() if hasattr(lab, "cpu") else np.asarray(lab)
        p = prob[np.arange(len(lab)), lab.astype(np.int64)]
        seen["ce"].append(float(-np.log(np.maximum(p, 1e-30)).mean()))

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    run = _imagenet_run(
        device, argv, lambda args: mx.models.get_inception_bn(
            num_classes=args.num_classes),
        on_batch=on_batch, synthetic=synthetic, label_ops=True)
    args, net, model, prof = run["args"], run["net"], run["model"], \
        run["prof"]
    launches, epoch_s = run["launches"], run["epoch_s"]
    peak = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" \
        else None
    steps_per_epoch = args.num_examples // args.batch_size
    timed = epoch_s[1:-1] if prof is not None else epoch_s[1:]
    timed = timed or epoch_s
    step_ms = 1e3 * sum(timed) / len(timed) / steps_per_epoch
    rec = {"phase": "inception_bn", "example": IC_DIR + "/train_imagenet.py",
           "network": args.network, "batch": args.batch_size,
           "images": args.num_examples, "classes": args.num_classes,
           "epochs": args.num_epochs, "steps_per_epoch": steps_per_epoch,
           "lr": args.lr, "kv_store": args.kv_store,
           "scanned_trainer_built": run["built"], "wall_s": run["wall_s"],
           "epoch_s": epoch_s, "step_ms": step_ms,
           "img_per_s": args.batch_size / step_ms * 1e3,
           "params": int(sum(v.size for v in model.arg_params.values())),
           "peak_mem_gb": peak, "cross_entropy": seen["ce"],
           "softmax_launches": launches}
    if device == "cuda":
        _, train_flops = symbol_products(
            net, data=(args.batch_size, 3, 224, 224),
            softmax_label=(args.batch_size,))
        summed_ms, busy_ms, events = device_busy(prof)
        plain_s = sum(timed) / len(timed)
        rec.update({
            "conv_fc_tflop_per_step": train_flops / 1e12,
            "conv_fc_tflop_s": train_flops / (step_ms * 1e-3) / 1e12,
            "busy": {"epoch": args.num_epochs - 1, "device_events": events,
                     "device_ms": summed_ms, "device_busy_ms": busy_ms,
                     "profiled_epoch_s": epoch_s[-1],
                     "unprofiled_epoch_s": plain_s,
                     "busy_share": busy_ms / 1e3 / plain_s,
                     "device_events_per_step": events / steps_per_epoch},
            "device_ms_per_step_by_kind": device_time_by_kind(
                prof, steps_per_epoch)})
    log(rec)
    first, last = run["params"][0], run["params"][-1]
    if not (len(seen["ce"]) == args.num_epochs * steps_per_epoch
            and all(math.isfinite(v) for v in seen["ce"])):
        raise AssertionError("Inception-BN: a step's cross-entropy is not "
                             "finite, or missing: %r" % seen["ce"])
    if not all(np.all(np.isfinite(v)) for v in last.values()):
        raise AssertionError("Inception-BN: non-finite parameters")
    if all(np.array_equal(first[k], last[k]) for k in first):
        raise AssertionError("Inception-BN: the parameters did not change")
    if run["built"] != 1:
        raise AssertionError("Inception-BN's fit built its scanned trainer "
                             "%d times, expected once" % run["built"])
    expected = args.num_epochs * steps_per_epoch if device == "cuda" else 0
    if launches != expected:
        raise AssertionError("Inception-BN launched K1 %d times, expected %d"
                             % (launches, expected))
    return rec


def _cifar10_run(device, argv):
    """examples/image-classification_torch/train_cifar10.py's
    ``--synthetic`` fit with ``argv`` through ``train_model.fit``, as its
    ``__main__`` runs it (``--mirror`` sets ``MXNET_BACKWARD_DO_MIRROR=1``
    for the fit): the record (validation accuracy a epoch, ms a step,
    img/s, peak memory, K1's launches, which must be one a training and
    a validation batch on the card) and the scanned trainers built."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import softmax as sm

    tm, ex = _ic_example("train_cifar10.py")
    argv = (["--synthetic"] + list(argv)
            + (["--ctx", "cpu"] if device == "cpu" else []))
    seen = {"val": {}, "stamps": [], "trainers": []}
    real_fit = mx.FeedForward.fit
    real_trainer = mx.parallel.fit_trainer.FitTrainer.__init__

    def fit(self, X, **kw):
        def on_eval(param):
            seen["val"][param.epoch] = param.eval_metric.get()[1]

        def on_epoch(epoch, *_):
            _sync(device)
            seen["stamps"].append(time.perf_counter())

        kw["eval_batch_end_callback"] = on_eval
        kw["epoch_end_callback"] = on_epoch
        _sync(device)
        seen["t0"] = time.perf_counter()
        return real_fit(self, X, **kw)

    def trainer(self, *a, **kw):
        real_trainer(self, *a, **kw)
        seen["trainers"].append(self)

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(sys, "argv", ["train_cifar10.py"] + argv), \
            mock.patch.object(mx.FeedForward, "fit", fit), \
            mock.patch.object(mx.parallel.fit_trainer.FitTrainer,
                              "__init__", trainer), \
            mock.patch.dict(os.environ):
        for k in ("MXNET_SCAN_TRAIN", "MXNET_TRAIN_SCAN_K",
                  "MXNET_COMPUTE_DTYPE", "MXNET_BACKWARD_DO_MIRROR",
                  "MXNET_BACKWARD_MIRROR_STEP",
                  "MXNET_BACKWARD_MIRROR_PATTERN"):
            os.environ.pop(k, None)
        args = ex.parse_args()
        if args.mirror:   # what the script's __main__ does
            os.environ["MXNET_BACKWARD_DO_MIRROR"] = "1"
        net = mx.models.get_inception_bn_small(num_classes=10)
        sm.fused_softmax.launches = 0
        tm.fit(args, net, ex.get_iterator)
        _sync(device)
        launches = sm.fused_softmax.launches
    steps = args.num_examples // args.batch_size
    epoch_s = [b - a for a, b in zip([seen["t0"]] + seen["stamps"][:-1],
                                     seen["stamps"])]
    timed = epoch_s[1:] or epoch_s
    step_ms = 1e3 * sum(timed) / len(timed) / steps
    val = [seen["val"][e] for e in sorted(seen["val"])]
    val_batches = 1024 // args.batch_size
    rec = {"example": IC_DIR + "/train_cifar10.py", "argv": argv,
           "network": args.network, "batch": args.batch_size,
           "epochs": args.num_epochs, "steps_per_epoch": steps,
           "val_accuracy": val, "epoch_s": epoch_s,
           "step_ms_with_epoch_end": step_ms,
           "img_per_s": args.batch_size / step_ms * 1e3,
           "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                           if device == "cuda" else None),
           "softmax_launches": launches}
    expected = (args.num_epochs * (steps + val_batches)
                if device == "cuda" else 0)
    if launches != expected:
        raise AssertionError("train_cifar10 launched K1 %d times, expected "
                             "%d" % (launches, expected))
    return rec, seen["trainers"]


def phase_cifar10(device="cuda", argv=()):
    """examples/image-classification_torch/train_cifar10.py at its
    defaults (``--synthetic``: Inception-BN-28-small, the example's 4096
    training and 1024 validation 3x28x28 images with class rows, batch
    128, SGD lr 0.05, momentum 0.9, wd 1e-5, Xavier(in, 2.34)) for 3
    epochs through the scanned ``FeedForward.fit``: validation accuracy
    after the last epoch > CIFAR_VAL_ACC (the port's two host runs:
    0.887 and 0.603 after the first epoch, 1.0 after the second and the
    third), K1 launched once a training and a validation batch.
    Prints each epoch's validation accuracy, ms a step and img/s."""
    rec, _ = _cifar10_run(device, ["--num-epochs", "3"] + list(argv))
    rec = dict(rec, phase="cifar10")
    log(rec)
    val = rec["val_accuracy"]
    if not (val and val[-1] > CIFAR_VAL_ACC):
        raise AssertionError("train_cifar10: validation accuracy %r, not "
                             "> %g after %d epochs"
                             % (val, CIFAR_VAL_ACC, rec["epochs"]))
    return rec


# -- the RecordIO image pipeline: im2rec, ImageRecordIter, PrefetchingIter,
# train_imagenet.py from a packed .rec ---------------------------------------
RECORDIO_CLASSES = 4      # stripes along x or y, of two periods
RECORDIO_PERIODS = (12, 40)   # px in the original image: classes 0-1, 2-3
RECORDIO_TRAIN = 2560     # 10 batches of train_imagenet.py's 256
RECORDIO_VAL = 256      # one validation batch
RECORDIO_CROSSINGS = 32   # zero crossings across 224 px between periods
RECORDIO_MEAN = (123.68, 116.779, 103.939)   # train_imagenet.py's mean
RECORDIO_PATTERN_MISS = 0.01  # share of augmented images read as another class


def make_image_folder(root, n, classes=RECORDIO_CLASSES, seed=0,
                      sides=(300, 501), threads=None):
    """``n`` seeded JPEGs under ``root/class<c>/<i>.jpg``, ImageNet-like
    sizes (each side 300-500 px): image ``i`` is class ``i % classes``,
    stripes that vary along x (even classes) or y (odd), of period
    ``RECORDIO_PERIODS[c >= 2]`` px, in a random tint with pixel noise.
    Random crop, mirror and HLS jitter keep a class's stripes, so
    :func:`pattern_class` reads the class back from an augmented
    image."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    rng = np.random.RandomState(seed)
    specs = [(i, i % classes, int(rng.randint(*sides)),
              int(rng.randint(*sides)), rng.uniform(120, 230, 3),
              rng.uniform(0, 2 * np.pi), int(rng.randint(1 << 30)))
             for i in range(n)]
    for c in range(classes):
        os.makedirs(os.path.join(root, "class%d" % c), exist_ok=True)

    def write(spec):
        i, c, h, w, tint, phase, noise_seed = spec
        period = RECORDIO_PERIODS[c >= 2]
        along = np.arange(w if c % 2 == 0 else h, dtype=np.float32)
        wave = 0.6 + 0.3 * np.sin(2 * np.pi * along / period + phase)
        wave = wave[None, :] if c % 2 == 0 else wave[:, None]
        img = np.broadcast_to(wave, (h, w))[:, :, None] * tint[None, None]
        img = img + np.random.RandomState(noise_seed).randn(h, w, 3) * 12
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            os.path.join(root, "class%d" % c, "%05d.jpg" % i), quality=90)

    with ThreadPoolExecutor(threads or os.cpu_count()) as pool:
        list(pool.map(write, specs))
    return n


def pattern_class(chw):
    """The class of :func:`make_image_folder` that an image (C, H, W,
    any mean subtracted) shows: the axis its stripes vary along, and
    their period from the zero crossings of the mean profile along it."""
    import numpy as np

    gray = np.asarray(chw, np.float64).mean(axis=0)
    gx = np.abs(np.diff(gray, axis=1)).mean()
    gy = np.abs(np.diff(gray, axis=0)).mean()
    along_x = gx > gy
    profile = gray.mean(axis=0 if along_x else 1)
    sign = np.sign(profile - profile.mean())
    crossings = int(np.count_nonzero(sign[1:] != sign[:-1]))
    return (0 if along_x else 1) + (0 if crossings > RECORDIO_CROSSINGS
                                    else 2)


def pil_resize_signature():
    """PIL's version, whether its default ``Image.resize`` filter (the
    one ``ImageRecordIter`` uses) is BICUBIC, and the first 16 hex digits
    of the SHA-256 of a default resize of a seeded 300x500 image to
    224x224: equal digits on two machines mean the same filter and the
    same results."""
    import hashlib

    import numpy as np
    import PIL
    from PIL import Image

    img = Image.fromarray((np.random.RandomState(0).rand(300, 500, 3)
                           * 255).astype(np.uint8))
    out = img.resize((224, 224))
    return {"version": PIL.__version__,
            "default_is_bicubic": out.tobytes() == img.resize(
                (224, 224), Image.BICUBIC).tobytes(),
            "sha256_16": hashlib.sha256(out.tobytes()).hexdigest()[:16]}


def _load_tool(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_" + name, os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "tools",
            name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pack_image_folder(prefix, root, threads=None):
    """``tools/torch_im2rec.py`` at train_imagenet's packing: ``--list
    --recursive`` (folder names become labels, the list shuffled), then
    ``--resize 256`` (shorter side) into ``prefix.rec``/``.idx``.
    Returns the tool module and the seconds the pack took."""
    tool = _load_tool("torch_im2rec")
    t0 = time.perf_counter()
    for extra in (["--list", "--recursive"],
                  ["--resize", "256", "--num-thread",
                   str(threads or os.cpu_count())]):
        with mock.patch.object(sys, "argv", ["torch_im2rec.py", *extra,
                                             prefix, root]):
            if tool.main() != 0:
                raise AssertionError("torch_im2rec failed on %s" % root)
    return tool, time.perf_counter() - t0


def check_packed_records(tool, prefix, root, threads=None):
    """Every record of ``prefix.rec``, read back in file order with the
    port's reader, equals the bytes the tool packs for its ``.lst`` line
    (re-encoded here: PIL's encoder is deterministic), and the ``.idx``
    finds each record by its id. Returns ({id: label}, the ids in file
    order)."""
    import argparse
    from concurrent.futures import ThreadPoolExecutor

    from mxnet_tpu_torch import recordio

    items = list(tool.read_list(prefix + ".lst"))
    args = argparse.Namespace(center_crop=False, resize=256,
                              encoding=".jpg", quality=95)
    with ThreadPoolExecutor(threads or os.cpu_count()) as pool:
        want = list(pool.map(lambda it: tool._encode_one(it, root, args)[1],
                             items))
    reader = recordio.MXRecordIO(prefix + ".rec", "r")
    got = []
    while True:
        s = reader.read()
        if s is None:
            break
        got.append(s)
    reader.close()
    if got != want:
        bad = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                   min(len(got), len(want)))
        raise AssertionError("%s.rec: %d records against %d packed, first "
                             "difference at record %d"
                             % (prefix, len(got), len(want), bad))
    indexed = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                         "r")
    for (idx, _, _), rec in list(zip(items, got))[::97]:
        if indexed.read_idx(idx) != rec:
            raise AssertionError("%s.idx: record %d read back wrong"
                                 % (prefix, idx))
    indexed.close()
    labels = {idx: lab[0] for idx, lab, _ in items}
    ids = [recordio.unpack(s)[0].id for s in got]
    if ids != [idx for idx, _, _ in items]:
        raise AssertionError("%s.rec: ids out of the .lst order" % prefix)
    return labels, ids


def _imagenet_run(device, argv, build_net, on_batch=None, synthetic=None,
                  label_ops=False, trace=True):
    """examples/image-classification_torch/train_imagenet.py through its
    ``train_model.fit`` under ``argv`` (the fit switches at their
    defaults: scanned, K = 8), ``build_net(args)`` its network, the
    metric accuracy with a cross-entropy beside it.

    Each epoch's training window runs from the end of the previous
    epoch's validation (the example's ``val.rec``; without one, from the
    previous epoch's end) to its end; on the card ``torch.profiler``
    traces the last epoch's window, with the host and each op's forward
    labelled ``mx::<op>`` when ``label_ops``. K1's count is zeroed just
    before the fit and read just after. ``synthetic`` replaces the
    example's in-memory data; ``trace=False`` profiles nothing. Returns
    a dict: ``args``, ``net``,
    ``model``, ``launches``, ``wall_s``, ``epoch_s`` (epoch end to epoch
    end, validation included), ``train_s`` (the training windows),
    ``built`` (scanned trainers built), ``params`` (the first and the
    last epoch's end parameters) and ``prof``."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import registry
    from mxnet_tpu_torch.ops import softmax as sm
    from mxnet_tpu_torch.parallel import fit_trainer

    tm, ex = _ic_example("train_imagenet.py")
    argv = list(argv) + (["--ctx", "cpu"] if device == "cpu" else [])
    seen = {"built": 0, "stamps": [], "starts": [], "params": []}
    real_make = fit_trainer.make_fit_trainer
    real_fit = mx.FeedForward.fit
    real_apply = registry.OpDef.apply
    prof = None
    if device == "cuda" and trace:
        from torch.profiler import (ProfilerActivity, profile,
                                    record_function)

        prof = profile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if label_ops else []))

        def labelled_apply(self, *a, **k):
            with record_function("mx::" + self.name):
                return real_apply(self, *a, **k)

    def make(*a, **kw):
        seen["built"] += 1
        return real_make(*a, **kw)

    def start_window(last):
        seen["starts"].append(time.perf_counter())
        if prof is not None and last:
            if label_ops:
                registry.OpDef.apply = labelled_apply
            prof.start()

    def fit(self, X, **kw):
        epochs = self.num_epoch
        val = kw.get("eval_data")
        resets = [0]
        if val is not None:
            real_reset = val.reset

            def reset():
                # the validation loop resets its iterator before and
                # after it: the second ends the validation
                real_reset()
                resets[0] += 1
                if resets[0] == 2:
                    start_window(len(seen["stamps"]) == epochs - 1)

            val.reset = reset

        def on_epoch(epoch, symbol, arg, aux):
            _sync(device)
            seen["stamps"].append(time.perf_counter())
            seen["params"].append({k: v.asnumpy() for k, v in arg.items()})
            if len(seen["params"]) > 2:
                seen["params"].pop(1)
            if prof is not None and epoch == epochs - 1:
                prof.stop()
                registry.OpDef.apply = real_apply
            resets[0] = 0
            if val is None and epoch < epochs - 1:
                start_window(epoch == epochs - 2)

        kw["epoch_end_callback"] = on_epoch
        kw["eval_metric"] = mx.metric.create(["acc", "ce"])
        _sync(device)
        seen["t0"] = time.perf_counter()
        start_window(epochs == 1)
        return real_fit(self, X, **kw)

    patches = [mock.patch.object(sys, "argv", ["train_imagenet.py"] + argv),
               mock.patch.object(fit_trainer, "make_fit_trainer", make),
               mock.patch.object(mx.FeedForward, "fit", fit),
               mock.patch.dict(os.environ)]
    if synthetic is not None:
        patches.append(mock.patch.object(ex, "_synthetic", synthetic))
    try:
        for pt in patches:
            pt.start()
        for k in ("MXNET_SCAN_TRAIN", "MXNET_TRAIN_SCAN_K",
                  "MXNET_COMPUTE_DTYPE"):
            os.environ.pop(k, None)   # the defaults: scanned, K = 8
        args = ex.parse_args()
        net = build_net(args)
        t0 = time.perf_counter()
        sm.fused_softmax.launches = 0
        model = tm.fit(args, net, ex.get_iterator, batch_end_callback=on_batch)
        _sync(device)
        launches = sm.fused_softmax.launches
        wall = time.perf_counter() - t0
    finally:
        registry.OpDef.apply = real_apply
        for pt in reversed(patches):
            pt.stop()
    stamps = seen["stamps"]
    return {"args": args, "net": net, "model": model, "launches": launches,
            "wall_s": wall, "built": seen["built"], "prof": prof,
            "params": seen["params"],
            "epoch_s": [b - a for a, b in zip([seen["t0"]] + stamps[:-1],
                                              stamps)],
            "train_s": [b - a for a, b in zip(seen["starts"], stamps)]}


def phase_recordio(device="cuda", n_train=RECORDIO_TRAIN, n_val=RECORDIO_VAL,
                   argv=(), step_batch=8, synthetic=None):
    """train_imagenet.py at its defaults (ResNet-50, batch 256, 3x224x224,
    lr 0.1, ``kv-store device``) from a packed RecordIO file, 2 epochs.

    A seeded image folder of :func:`make_image_folder` (``n_train`` and
    ``n_val`` images of 4 classes, 300-500 px a side) is made in a
    temporary directory and packed by ``tools/torch_im2rec.py --resize
    256`` into ``train.rec`` and ``val.rec``; every record read back
    equals the bytes packed (:func:`check_packed_records`). The example
    then trains with ``--data-dir`` there, ``--num-classes 4`` and
    ``--num-examples n_train`` through ``ImageRecordIter`` (rand crop,
    mirror, HLS jitter 36/50/50, the ImageNet mean) under
    ``PrefetchingIter`` and the scanned ``FeedForward.fit``, validating
    on ``val.rec`` after each epoch. Every batch's labels are held, as
    the fit stages it, against the ``.lst`` labels of the records it
    holds (the iterator keeps the file order: the example does not
    shuffle). In the first epoch only, each batch's data is also held:
    finite, within what the mean allows, and at most
    RECORDIO_PATTERN_MISS of its images showing another class's stripes
    (:func:`pattern_class`; a pipeline that parts data from labels
    misreads three in four). The second epoch is the timed one: its
    window (:func:`_imagenet_run`) holds its training steps alone, the
    callback there only compares labels and reads the cross-entropy
    (its seconds are printed), and the card's busy share is taken over
    that window. PIL's version and a hash of its default
    ``Image.resize`` (the iterator's filter) on a seeded image are
    printed. Every step's cross-entropy is finite and the parameters
    change and stay finite; K1 runs once a training and a validation
    batch. Beside it: the same example with ``--synthetic`` (2048 seeded
    images in memory, 2 epochs, no validation), timed the same way, and
    one step at batch ``step_batch`` on the first ``.rec`` batch on the
    card against the host (:func:`net_closeness`). ``synthetic``
    replaces the example's in-memory data (a CPU rehearsal at a small
    size). The iterator's own rate is ``tools/torch_bench_io.py``'s."""
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch

    import mxnet_tpu_torch as mx

    def resnet50(args):
        return mx.models.get_resnet(num_classes=args.num_classes,
                                    num_layers=50)

    tmp = tempfile.mkdtemp(prefix="mx_recordio_")
    try:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        t0 = time.perf_counter()
        labels, ids, pack_s = {}, {}, {}
        for split, n, seed in (("train", n_train, 1), ("val", n_val, 2)):
            root = os.path.join(tmp, "images", split)
            make_image_folder(root, n, seed=seed)
            prefix = os.path.join(data, split)
            tool, pack_s[split] = pack_image_folder(prefix, root)
            labels[split], ids[split] = check_packed_records(tool, prefix,
                                                             root)
        prepare_s = time.perf_counter() - t0
        train_rec = os.path.join(data, "train.rec")
        rec_bytes = os.path.getsize(train_rec)

        seen = {"ce": [], "batches": 0, "label_bad": 0, "pattern_miss": 0,
                "images": 0, "range": [math.inf, -math.inf], "finite": True,
                "callback_s": {}}
        mean = np.asarray(RECORDIO_MEAN, np.float32)[:, None, None]

        def on_batch(param):
            t = time.perf_counter()
            loc = param.locals
            b, k = loc["b"], loc["k"]
            lab = np.asarray(b["softmax_label"])
            n = len(lab)
            start = (param.nbatch - 1) * n
            want = [labels["train"][i] for i in ids["train"][start:start + n]]
            seen["label_bad"] += int(np.count_nonzero(lab != np.asarray(want)))
            seen["batches"] += 1
            prob = loc["host_outs"][0][k]
            p = prob[np.arange(n), lab.astype(np.int64)]
            seen["ce"].append(float(-np.log(np.maximum(p, 1e-30)).mean()))
            if param.epoch == 0:
                x = np.asarray(b["data"])
                seen["finite"] &= bool(np.all(np.isfinite(x)))
                lo, hi = float((x + mean).min()), float((x + mean).max())
                seen["range"] = [min(seen["range"][0], lo),
                                 max(seen["range"][1], hi)]
                seen["pattern_miss"] += sum(pattern_class(x[j]) != int(lab[j])
                                            for j in range(n))
                seen["images"] += n
            seen["callback_s"][param.epoch] = seen["callback_s"].get(
                param.epoch, 0.0) + time.perf_counter() - t

        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        run = _imagenet_run(
            device, ["--data-dir", data, "--num-classes",
                     str(RECORDIO_CLASSES), "--num-examples", str(n_train),
                     "--num-epochs", "2"] + list(argv), resnet50,
            on_batch=on_batch)
        args, launches, train_s = run["args"], run["launches"], run["train_s"]
        peak = (torch.cuda.max_memory_allocated() / 1e9
                if device == "cuda" else None)
        B = args.batch_size
        steps = n_train // B
        val_batches = n_val // B
        first, last = run["params"][0], run["params"][-1]
        rec = {"phase": "recordio",
               "example": IC_DIR + "/train_imagenet.py",
               "network": args.network, "batch": B, "lr": args.lr,
               "kv_store": args.kv_store, "classes": RECORDIO_CLASSES,
               "images": {"train": n_train, "val": n_val},
               "prepare_s": prepare_s, "pack_s": pack_s,
               "train_rec_mb": rec_bytes / 1e6,
               "records_checked": len(ids["train"]) + len(ids["val"]),
               "epochs": args.num_epochs, "steps_per_epoch": steps,
               "scanned_trainer_built": run["built"],
               "epoch_s": run["epoch_s"], "train_s": train_s,
               "img_per_s_by_epoch": [steps * B / s for s in train_s],
               "img_per_s": steps * B / train_s[-1],
               "callback_s_by_epoch": [seen["callback_s"].get(e, 0.0)
                                       for e in range(args.num_epochs)],
               "batches_held": seen["batches"],
               "label_mismatches": seen["label_bad"],
               "images_pattern_checked": seen["images"],
               "pattern_miss_share": seen["pattern_miss"]
               / max(seen["images"], 1),
               "data_range_plus_mean": seen["range"],
               "cross_entropy": seen["ce"], "peak_mem_gb": peak,
               "softmax_launches": launches}
        if run["prof"] is not None:
            _, busy_ms, events = device_busy(run["prof"])
            rec["busy"] = {"epoch": args.num_epochs - 1,
                           "device_busy_ms": busy_ms,
                           "device_events": events,
                           "window_s": train_s[-1],
                           "busy_share": busy_ms / 1e3 / train_s[-1]}
        rec["pil"] = pil_resize_signature()
        log(rec)
        if seen["batches"] != args.num_epochs * steps:
            raise AssertionError("recordio: %d batches staged, expected %d"
                                 % (seen["batches"], args.num_epochs * steps))
        if seen["label_bad"]:
            raise AssertionError("recordio: %d labels differ from the .lst"
                                 % seen["label_bad"])
        if seen["images"] != steps * B:
            raise AssertionError("recordio: %d images checked in the first "
                                 "epoch, expected %d"
                                 % (seen["images"], steps * B))
        if not (seen["finite"] and seen["range"][0] >= -1e-3
                and seen["range"][1] <= 255 + 1e-3):
            raise AssertionError("recordio: data not finite or outside "
                                 "[-mean, 255 - mean]: %r" % seen["range"])
        if rec["pattern_miss_share"] > RECORDIO_PATTERN_MISS:
            raise AssertionError("recordio: %.4f of the images show another "
                                 "class than their label"
                                 % rec["pattern_miss_share"])
        if not all(math.isfinite(v) for v in seen["ce"]):
            raise AssertionError("recordio: a step's cross-entropy is not "
                                 "finite: %r" % seen["ce"])
        if not all(np.all(np.isfinite(v)) for v in last.values()):
            raise AssertionError("recordio: non-finite parameters")
        if all(np.array_equal(first[k], last[k]) for k in first):
            raise AssertionError("recordio: the parameters did not change")
        expected = (args.num_epochs * (steps + val_batches)
                    if device == "cuda" else 0)
        if launches != expected:
            raise AssertionError("recordio launched K1 %d times, expected %d"
                                 % (launches, expected))

        # the same example on its in-memory synthetic data
        srun = _imagenet_run(
            device, ["--synthetic", "--num-classes", str(RECORDIO_CLASSES),
                     "--num-epochs", "2"] + list(argv), resnet50,
            synthetic=synthetic)
        sargs, strain_s = srun["args"], srun["train_s"]
        ssteps = sargs.num_examples // sargs.batch_size
        srec = {"phase": "recordio_synthetic", "batch": sargs.batch_size,
                "images": sargs.num_examples, "steps_per_epoch": ssteps,
                "epoch_s": srun["epoch_s"], "train_s": strain_s,
                "img_per_s_by_epoch": [ssteps * sargs.batch_size / s
                                       for s in strain_s],
                "img_per_s": ssteps * sargs.batch_size / strain_s[-1],
                "softmax_launches": srun["launches"]}
        if srun["prof"] is not None:
            _, busy_ms, events = device_busy(srun["prof"])
            srec["busy"] = {"device_busy_ms": busy_ms,
                            "device_events": events,
                            "window_s": strain_s[-1],
                            "busy_share": busy_ms / 1e3 / strain_s[-1]}
        srec["rec_slowdown"] = srec["img_per_s"] / rec["img_per_s"]
        log(srec)
        sexpected = sargs.num_epochs * ssteps if device == "cuda" else 0
        if srun["launches"] != sexpected:
            raise AssertionError("recordio --synthetic launched K1 %d times, "
                                 "expected %d" % (srun["launches"], sexpected))

        # one step on the first .rec batch, card against host
        it = mx.io.ImageRecordIter(
            path_imgrec=train_rec, mean_r=RECORDIO_MEAN[0],
            mean_g=RECORDIO_MEAN[1], mean_b=RECORDIO_MEAN[2],
            data_shape=(3, 224, 224), batch_size=step_batch, rand_crop=True,
            rand_mirror=True, random_h=36, random_s=50, random_l=50)
        batch0 = it.next()
        with mx.NameManager():
            sym = mx.models.get_resnet(num_classes=RECORDIO_CLASSES,
                                       num_layers=50)
        shapes = {"data": (step_batch, 3, 224, 224),
                  "softmax_label": (step_batch,)}
        pargs, aux = zoo_params(sym, shapes, seed=13)
        pargs["data"] = batch0.data[0].asnumpy()
        pargs["softmax_label"] = batch0.label[0].asnumpy()
        got = net_step(sym, shapes, pargs, aux, device)
        want = net_step(sym, shapes, pargs, aux, "cpu")
        nudged = net_step(sym, shapes, nudge(pargs), aux, device)
        grad = dict(net_closeness(got, want, nudged),
                    phase="recordio_grad_check", batch=step_batch,
                    tol=NET_TOL)
        log(grad)
        if not grad["ok"]:
            raise AssertionError("ResNet-50's step on the first .rec batch "
                                 "on the card differs from the host's: %r"
                                 % grad)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["synthetic"] = srec
    rec["grad_check"] = grad
    return rec


# -- Faster R-CNN through the host bridges, DEC, numpy-ops, the torch plugin
# and the optimizers ---------------------------------------------------------
RCNN_DIR = os.path.join("examples", "rcnn_torch")
RCNN_NAMES = ("proposal", "proposal_target", "rcnn_utils", "symbol_rcnn",
              "eval_map", "train_end2end", "train_alternate")
RCNN_INPUTS = ("data", "im_info", "gt_boxes", "label", "bbox_target",
               "bbox_weight")
HOST_TOL = 1e-4   # card against host under closeness(), f32
_examples = {}


def _example_modules(dirname, names):
    """The modules ``names`` of an example directory, imported with the
    directory first on ``sys.path`` (once a process; they stay in
    ``sys.modules``, where the example's own imports find them)."""
    import importlib

    if dirname not in _examples:
        d = os.path.join(os.path.dirname(os.path.abspath(__file__)), dirname)
        if d not in sys.path:
            sys.path.insert(0, d)
        _examples[dirname] = {n: importlib.import_module(n) for n in names}
    return _examples[dirname]


def _np_close(got, want, tol=HOST_TOL):
    import numpy as np
    import torch

    return closeness(torch.from_numpy(np.asarray(got, np.float32)),
                     torch.from_numpy(np.asarray(want, np.float32)), tol)


def _run_main(fn, argv, script):
    """Run an example's ``main`` under ``argv`` with the fit switches at
    their defaults, its stdout captured; returns (stdout, seconds)."""
    import contextlib
    import io

    buf = io.StringIO()
    with mock.patch.object(sys, "argv", [script] + list(argv)), \
            mock.patch.dict(os.environ), contextlib.redirect_stdout(buf):
        for k in ("MXNET_SCAN_TRAIN", "MXNET_TRAIN_SCAN_K",
                  "MXNET_COMPUTE_DTYPE", "MXNET_EXAMPLE_SMOKE",
                  "MXNET_ENFORCE_DETERMINISM"):
            os.environ.pop(k, None)
        t0 = time.perf_counter()
        try:
            fn()
        finally:
            out = buf.getvalue()
            print(out, end="", flush=True)
    return out, time.perf_counter() - t0


def rcnn_params(seed=5):
    """Xavier-scaled (uniform, avg, magnitude 3) seeded numpy weights and
    zero biases for Faster R-CNN's train symbol."""
    import numpy as np

    net = _example_modules(RCNN_DIR, RCNN_NAMES)["symbol_rcnn"].get_train(
        num_classes=3)
    shapes, _, _ = net.infer_shape(data=(1, 3, 128, 128), im_info=(1, 3),
                                   gt_boxes=(1, 3, 5))
    rng = np.random.RandomState(seed)
    out = {}
    for n, s in zip(net.list_arguments(), shapes):
        if n in RCNN_INPUTS:
            continue
        if n.endswith("_bias"):
            out[n] = np.zeros(s, np.float32)
            continue
        fan = (s[1] + s[0]) * int(np.prod(s[2:])) / 2.0
        out[n] = rng.uniform(-1, 1, s).astype(np.float32) * np.float32(
            np.sqrt(3.0 / fan))
    return out


def _rcnn_step(device, params):
    """One ``forward_backward`` of the train symbol on the first image of
    ``DetectionIter(2)``: the five heads and the parameters' gradients
    as numpy."""
    import mxnet_tpu_torch as mx

    ex = _example_modules(RCNN_DIR, RCNN_NAMES)
    ctx = _ctx(device)
    with ctx:
        it = ex["train_end2end"].DetectionIter(2)
        batch = it.next()
        mod = mx.module.Module(ex["symbol_rcnn"].get_train(num_classes=3),
                               context=ctx,
                               data_names=("data", "im_info", "gt_boxes"),
                               label_names=("label", "bbox_target",
                                            "bbox_weight"))
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params(arg_params=mx.model.params_from_numpy(
            params, ctx=ctx)[0], aux_params={})
        mod.forward_backward(batch)
        outs = [o.asnumpy() for o in mod.get_outputs()]
        grads = {n: g.asnumpy()
                 for n, g in mod._execs[0].grad_dict.items()
                 if g is not None and n in params}
    return outs, grads


def rcnn_grad_check(device="cuda"):
    """Faster R-CNN's train step on ``device`` against the host, with the
    two CustomOps' outputs made equal: the device run records what each
    CustomOp's forward wrote, and the host run replays it in place of
    its own forward (a near-tie among proposal scores could otherwise
    pick other rois on the two sides). Every head and parameter
    gradient under :func:`closeness` at HOST_TOL."""
    ex = _example_modules(RCNN_DIR, RCNN_NAMES)
    ops = (ex["proposal"].ProposalOperator,
           ex["proposal_target"].ProposalTargetOperator)
    params = rcnn_params()
    recorded = []

    def recording(real):
        def forward(self, is_train, req, in_data, out_data, aux):
            real(self, is_train, req, in_data, out_data, aux)
            recorded.append([o.asnumpy().copy() for o in out_data])
        return forward

    def replay(self, is_train, req, in_data, out_data, aux):
        for o, v in zip(out_data, recorded.pop(0)):
            o[:] = v

    with mock.patch.object(ops[0], "forward", recording(ops[0].forward)), \
            mock.patch.object(ops[1], "forward", recording(ops[1].forward)):
        got = _rcnn_step(device, params)
    n_custom = len(recorded)
    with mock.patch.object(ops[0], "forward", replay), \
            mock.patch.object(ops[1], "forward", replay):
        want = _rcnn_step("cpu", params)
    heads = [_np_close(g, w) for g, w in zip(got[0], want[0])]
    grads = {n: _np_close(got[1][n], want[1][n]) for n in want[1]}
    rec = {"phase": "rcnn_grad_check", "custom_forwards": n_custom,
           "heads_rel_l2": [h["rel_l2"] for h in heads],
           "max_grad_rel_l2": max(c["rel_l2"] for c in grads.values()),
           "max_grad_err_to_limit": max(c["elem"] for c in grads.values()),
           "tol": HOST_TOL}
    log(rec)
    bad = [i for i, h in enumerate(heads) if not within(h, HOST_TOL)] + [
        n for n, c in grads.items() if not within(c, HOST_TOL)]
    if n_custom != 2 or bad:
        raise AssertionError("Faster R-CNN on the card disagrees with the "
                             "host at %s: %r" % (bad, rec))
    return rec


def rcnn_repeat_check(device="cuda", repeats=3):
    """Faster R-CNN's train step run ``repeats`` times on ``device`` from
    the same parameters and image, each in a Module of its own (so each
    proposal_target draws from a fresh ``RandomState(0)``): every head
    and every parameter gradient must be byte-equal to the first run's.
    cuDNN's atomic-summing backward algorithms would break it
    (``base.deterministic_grads``)."""
    params = rcnn_params()
    runs = [_rcnn_step(device, params) for _ in range(repeats)]
    first = runs[0]
    differ = sorted({
        "head%d" % i for outs, _ in runs[1:]
        for i, (a, b) in enumerate(zip(first[0], outs))
        if a.tobytes() != b.tobytes()} | {
        n for _, grads in runs[1:] for n in first[1]
        if first[1][n].tobytes() != grads[n].tobytes()})
    rec = {"phase": "rcnn_repeat_check", "repeats": repeats,
           "tensors": len(first[0]) + len(first[1]), "differ": differ}
    log(rec)
    if differ:
        raise AssertionError("Faster R-CNN's step is not reproducible on "
                             "%s: %s differ" % (device, differ))
    return rec


def phase_rcnn(device="cuda", argv=(), alternate_argv=()):
    """Faster R-CNN at examples/rcnn_torch/train_end2end.py's defaults (16
    synthetic 3x128x128 images, batch 1, 30 epochs, SGD 5e-3 / 0.9, wd
    5e-4, Xavier) through the per-batch ``Module.fit`` (the scanned
    trainer refuses a graph with host ops): the proposal and
    proposal_target CustomOps run on the host between the card's ops;
    then detection through the test symbol, mean IoU and VOC07 mAP. The
    example's own asserts must hold (rpn_acc > 0.8, mean IoU > 0.3, mAP
    > 0.2); K1 (rcnn_cls_prob's [32, 3] SoftmaxOutput) once a step, its
    count zeroed just before ``main`` and read just after. Then
    train_alternate.py at its defaults (its asserts: rpn > 0.8, rcnn >
    0.6; its RCNN head trains on the scanned fit, K1 once a step),
    :func:`rcnn_grad_check` and :func:`rcnn_repeat_check`. Prints ms a
    step (the median of the epochs between the first and the profiled
    last), the host ops' ms a step, the busy share of the last epoch and
    each epoch's metrics."""
    import re

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import registry as reg
    from mxnet_tpu_torch.ops import softmax as sm

    ex = _example_modules(RCNN_DIR, RCNN_NAMES)
    te = ex["train_end2end"]
    ctx_args = ["--ctx", "cpu"] if device == "cpu" else []
    seen = {"stamps": [], "metrics": [], "host_s": []}
    real_fit = mx.module.Module.fit
    real_map = ex["eval_map"].evaluate_map
    host_s = [0.0]
    real_host = reg._HostOpFn.forward, reg._HostOpFn.backward

    def timed(fn):
        def run(*a):
            t = time.perf_counter()
            try:
                return fn(*a)
            finally:
                host_s[0] += time.perf_counter() - t
        return staticmethod(run)

    prof = None
    if device == "cuda":
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])

    def fit(self, train_data, **kw):
        metric, epochs = kw["eval_metric"], kw["num_epoch"]

        def on_epoch(epoch, *_):
            _sync(device)
            seen["stamps"].append(time.perf_counter())
            seen["metrics"].append(dict(zip(*metric.get())))
            seen["host_s"].append(host_s[0])
            if prof is not None and epochs > 2:
                if epoch == epochs - 2:
                    prof.start()
                elif epoch == epochs - 1:
                    prof.stop()

        kw["epoch_end_callback"] = on_epoch
        _sync(device)
        seen["t0"] = time.perf_counter()
        return real_fit(self, train_data, **kw)

    def evaluate_map(*a, **kw):
        seen["map"] = real_map(*a, **kw)
        return seen["map"]

    with mock.patch.object(mx.module.Module, "fit", fit), \
            mock.patch.object(ex["eval_map"], "evaluate_map", evaluate_map), \
            mock.patch.object(reg._HostOpFn, "forward", timed(real_host[0])), \
            mock.patch.object(reg._HostOpFn, "backward",
                              timed(real_host[1])):
        _sync(device)
        sm.fused_softmax.launches = 0
        out, wall = _run_main(te.main, list(argv) + ctx_args,
                              "train_end2end.py")
        _sync(device)
        launches = sm.fused_softmax.launches
    m = re.search(r"mean-IoU\(top1\)=([0-9.]+)", out)
    miou = float(m.group(1)) if m else None
    n_img = int(_argv_value(argv, "--num-images", 16))
    epochs = int(_argv_value(argv, "--epochs", 30))
    epoch_s = [b - a for a, b in zip([seen["t0"]] + seen["stamps"][:-1],
                                     seen["stamps"])]
    host_epoch = [b - a for a, b in zip([0.0] + seen["host_s"][:-1],
                                        seen["host_s"])]
    plain = list(range(1, len(epoch_s) - (1 if prof is not None else 0)))
    plain = plain or list(range(len(epoch_s)))
    steps_ms = sorted(1e3 * epoch_s[e] / n_img for e in plain)
    host_ms = sorted(1e3 * host_epoch[e] / n_img for e in plain)
    busy = None
    if prof is not None:
        summed_ms, busy_ms, events = device_busy(prof)
        plain_s = sum(epoch_s[e] for e in plain) / len(plain)
        busy = {"epoch": epochs - 1, "device_events": events,
                "device_events_per_step": events / n_img,
                "device_ms": summed_ms, "device_busy_ms": busy_ms,
                "profiled_epoch_s": epoch_s[-1],
                "unprofiled_epoch_s": plain_s,
                "busy_share": busy_ms / 1e3 / plain_s}

    # train_alternate at its defaults: K1 once a step of its RCNN head's
    # two scanned fits (12 images, 12 + 6 epochs)
    alt = ex["train_alternate"]
    sm.fused_softmax.launches = 0
    alt_out, alt_wall = _run_main(alt.main, list(alternate_argv) + ctx_args,
                                  "train_alternate.py")
    _sync(device)
    alt_launches = sm.fused_softmax.launches
    alt_images = int(_argv_value(alternate_argv, "--num-images", 12))
    rcnn_epochs = int(_argv_value(alternate_argv, "--rcnn-epochs", 12))
    alt_expected = (alt_images * (rcnn_epochs + rcnn_epochs // 2)
                    if device == "cuda" else 0)

    check = rcnn_grad_check(device)
    repeat = rcnn_repeat_check(device)
    rec = {"phase": "rcnn", "example": RCNN_DIR + "/train_end2end.py",
           "images": n_img, "epochs": epochs, "image": te.IMAGE,
           "wall_s": wall, "epoch_s": epoch_s,
           "step_ms_median": steps_ms[len(steps_ms) // 2],
           "step_ms_range": [steps_ms[0], steps_ms[-1]],
           "host_op_ms_per_step_median": host_ms[len(host_ms) // 2],
           "busy": busy, "metrics_by_epoch": seen["metrics"],
           "mean_iou": miou, "map": seen.get("map"),
           "softmax_launches": launches,
           "alternate": {"wall_s": alt_wall,
                         "softmax_launches": alt_launches,
                         "expected": alt_expected,
                         "ok": "ok: alternating" in alt_out},
           "grad_check": check, "repeat_check": repeat}
    log(rec)
    expected = n_img * epochs if device == "cuda" else 0
    if launches != expected:
        raise AssertionError("Faster R-CNN launched K1 %d times, expected "
                             "%d" % (launches, expected))
    if alt_launches != alt_expected:
        raise AssertionError("train_alternate launched K1 %d times, "
                             "expected %d" % (alt_launches, alt_expected))
    if "ok: rcnn end-to-end" not in out or "ok: alternating" not in alt_out:
        raise AssertionError("a Faster R-CNN example did not finish")
    return rec


def _argv_value(argv, flag, default):
    argv = list(argv)
    return argv[argv.index(flag) + 1] if flag in argv else default


def host_bridge_checks(device="cuda"):
    """The host bridges on ``device`` against the host: a graph with a
    Custom op (two inputs, a keyword argument) and a NumpyOp loss head,
    TorchModule (an MLP, a Conv1d) under a TorchCriterion, and the 31
    ``mx.th`` functions; outputs and gradients under :func:`closeness`
    at HOST_TOL."""
    import numpy as np

    import mxnet_tpu_torch as mx

    _register_smoke_ops()

    def run(dev, net, vals):
        ctx = _ctx(dev)
        args = {n: mx.nd.array(v, ctx=ctx) for n, v in vals.items()}
        grads = {n: mx.nd.zeros(v.shape, ctx=ctx) for n, v in vals.items()
                 if n not in ("data", "label")}
        exe = net.bind(ctx, args, args_grad=grads)
        outs = [o.asnumpy() for o in exe.forward(is_train=True)]
        exe.backward()
        return outs, {n: g.asnumpy() for n, g in grads.items()}

    nets = {}
    with mx.NameManager():
        d = mx.sym.Variable("data")
        fc = mx.sym.FullyConnected(d, num_hidden=16, name="fc")
        aff = mx.sym.Custom(data=fc, gamma=mx.sym.Variable("gamma"),
                            op_type="smoke_affine", factor="0.5", name="aff")
        nets["custom_numpy_op"] = (_SMOKE_OPS["lsm"](
            data=mx.sym.FullyConnected(mx.sym.Activation(
                aff, act_type="tanh"), num_hidden=10, name="fc2"),
            label=mx.sym.Variable("label"), name="lsm"), (32, 20))
    for mstr, shape in (("torch.nn.Sequential(torch.nn.Linear(20, 32), "
                         "torch.nn.ReLU(), torch.nn.Linear(32, 10))",
                         (32, 20)),
                        ("torch.nn.Conv1d(4, 10, 3)", (32, 4, 7))):
        with mx.NameManager():
            tm = mx.sym.TorchModule(mx.sym.Variable("data"),
                                    module_string=mstr, name="tm")
            lab = mx.sym.Variable("label")
            nets[mstr.split("(")[0].split(".")[-1]] = (mx.sym.TorchCriterion(
                mx.sym.Flatten(tm), lab, module_string="torch.nn.MSELoss()",
                name="crit"), shape)
    rng = np.random.RandomState(3)
    checks = {}
    for name, (net, shape) in nets.items():
        shapes, out_shapes, _ = net.infer_shape(data=shape)
        vals = {}
        for n, s in zip(net.list_arguments(), shapes):
            vals[n] = (rng.randint(0, 10, s).astype(np.float32)
                       if n == "label" and name == "custom_numpy_op"
                       else rng.randn(*s).astype(np.float32) * 0.5)
        got, want = run(device, net, vals), run("cpu", net, vals)
        cl = [_np_close(g, w) for g, w in zip(got[0], want[0])] + [
            _np_close(got[1][n], want[1][n]) for n in want[1]]
        checks[name] = {"rel_l2": max(c["rel_l2"] for c in cl),
                        "elem": max(c["elem"] for c in cl),
                        "ok": all(within(c, HOST_TOL) for c in cl)}
    th = {}
    for fname, arity in sorted(mx.torch_plugin._TH_FUNCS.items()):
        shapes = ([(64,), (64,)] if fname == "dot" else
                  [(32, 48), (48, 16)] if fname == "mm" else [(32, 48)] * arity)
        vals = [rng.uniform(0.2, 0.9, s).astype(np.float32) for s in shapes]
        res = [getattr(mx.th, fname)(*[mx.nd.array(v, ctx=_ctx(dev))
                                       for v in vals]).asnumpy()
               for dev in (device, "cpu")]
        th[fname] = _np_close(res[0], res[1])
    checks["th"] = {"functions": len(th),
                    "rel_l2": max(c["rel_l2"] for c in th.values()),
                    "ok": all(within(c, HOST_TOL) for c in th.values())}
    return checks


_SMOKE_OPS = {}


def _register_smoke_ops():
    """A Custom op and a NumpyOp for :func:`host_bridge_checks`
    (registered once a process)."""
    import numpy as np

    import mxnet_tpu_torch as mx

    if _SMOKE_OPS:
        return

    class Affine(mx.operator.CustomOp):
        def __init__(self, factor):
            self.factor = np.float32(factor)

        def forward(self, is_train, req, in_data, out_data, aux):
            d, g = in_data[0].asnumpy(), in_data[1].asnumpy()
            self.assign(out_data[0], req[0], d * g[None, :] * self.factor)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            og = out_grad[0].asnumpy()
            d, g = in_data[0].asnumpy(), in_data[1].asnumpy()
            self.assign(in_grad[0], req[0], og * g[None, :] * self.factor)
            self.assign(in_grad[1], req[1], (og * d).sum(0) * self.factor)

    @mx.operator.register("smoke_affine")
    class AffineProp(mx.operator.CustomOpProp):
        def __init__(self, factor="1.0"):
            super().__init__(need_top_grad=True)
            self.factor = float(factor)

        def list_arguments(self):
            return ["data", "gamma"]

        def infer_shape(self, in_shape):
            return [in_shape[0], [in_shape[0][1]]], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Affine(self.factor)

    class LogSoftmax(mx.operator.NumpyOp):
        def __init__(self):
            super().__init__(False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]]

        def forward(self, in_data, out_data):
            x = in_data[0] - in_data[0].max(axis=1, keepdims=True)
            out_data[0][:] = x - np.log(np.exp(x).sum(axis=1, keepdims=True))

        def backward(self, out_grad, in_data, out_data, in_grad):
            lab = in_data[1].astype(int)
            in_grad[0][:] = np.exp(out_data[0])
            in_grad[0][np.arange(len(lab)), lab] -= 1.0

    _SMOKE_OPS["lsm"] = LogSoftmax()


def phase_host_bridges(device="cuda"):
    """The three host-bridge examples at their defaults on ``device``,
    each to its own gate: examples/dec_torch/dec_clustering.py (DEC with
    Adam, the DECLoss NumpyOp on the host: cluster accuracy > 0.9 and no
    worse than the k-means start), examples/numpy-ops_torch/
    numpy_softmax.py (a NumpyOp log-softmax head through
    ``FeedForward``'s per-batch loop: validation accuracy > 0.9) and
    examples/torch_torch/torch_module_mnist.py (a TorchModule layer on
    the card: validation accuracy > 0.9, ``mx.th``); then
    :func:`host_bridge_checks`. Prints each example's wall time and
    reading."""
    import re

    checks = {}
    for name, d, script, pattern in (
            ("dec", "dec_torch", "dec_clustering.py", r"-> DEC ([0-9.]+)"),
            ("numpy_ops", "numpy-ops_torch", "numpy_softmax.py",
             r"val acc ([0-9.]+)"),
            ("torch_module", "torch_torch", "torch_module_mnist.py",
             r"val accuracy ([0-9.]+)")):
        mod = _example_modules(os.path.join("examples", d),
                               (script[:-3],))[script[:-3]]
        out, wall = _run_main(mod.main, ["--ctx", "cpu"] if device == "cpu"
                              else [], script)
        m = re.search(pattern, out)
        checks[name] = {"wall_s": wall,
                        "reading": float(m.group(1)) if m else None}
        if not (m and float(m.group(1)) > 0.9):
            raise AssertionError("%s: %r" % (script, out[-500:]))
    bridges = host_bridge_checks(device)
    rec = {"phase": "host_bridges", "examples": checks,
           "card_against_host": bridges}
    log(rec)
    if bridges and not all(c["ok"] for c in bridges.values()):
        raise AssertionError("a host bridge on the card disagrees with the "
                             "host: %r" % bridges)
    return rec


OPTIMIZER_CASES = {"sgd": dict(momentum=0.9), "ccsgd": dict(momentum=0.9),
                   "nag": dict(momentum=0.9), "sgld": {}, "adam": {},
                   "adagrad": {}, "rmsprop": {}, "adadelta": {}, "test": {}}


def optimizer_updates(name, device, shape=(1024, 1024), steps=3):
    """``steps`` updates of optimizer ``name`` on ``device`` (wd, rescale,
    clip, a FactorScheduler), from seeded numpy weights and gradients;
    the weight and state after each as numpy."""
    import numpy as np

    import mxnet_tpu_torch as mx

    rng = np.random.RandomState(11)
    w0 = rng.randn(*shape).astype(np.float32)
    grads = [rng.randn(*shape).astype(np.float32) * 2 for _ in range(steps)]
    mx.random.seed(7)
    opt = mx.optimizer.create(
        name, learning_rate=0.05, wd=0.01, rescale_grad=0.5,
        clip_gradient=0.8, param_idx2name={0: "fc_weight"},
        lr_scheduler=mx.lr_scheduler.FactorScheduler(step=2, factor=0.5),
        **OPTIMIZER_CASES[name])
    ctx = _ctx(device)
    w = mx.nd.array(w0, ctx=ctx)
    state = opt.create_state(0, w)
    trail = []
    for g in grads:
        opt.update(0, w, mx.nd.array(g, ctx=ctx), state)
        leaves = ([] if state is None else list(state)
                  if isinstance(state, tuple) else [state])
        trail.append([w.asnumpy()] + [s.asnumpy() for s in leaves])
    return trail


def phase_optimizers(device="cuda"):
    """Every optimizer's three updates of a [1024, 1024] weight on the
    card against the same updates on the host (SGLD's noise from the
    same threefry keys, drawn on the card): each weight and state under
    :func:`closeness` at HOST_TOL."""
    res = {}
    for name in sorted(OPTIMIZER_CASES):
        got = optimizer_updates(name, device)
        want = optimizer_updates(name, "cpu")
        cl = [_np_close(g, w) for gs, ws in zip(got, want)
              for g, w in zip(gs, ws)]
        res[name] = {"max_abs_err": max(c["abs"] for c in cl),
                     "rel_l2": max(c["rel_l2"] for c in cl),
                     "ok": all(within(c, HOST_TOL) for c in cl)}
    rec = {"phase": "optimizers", "tol": HOST_TOL, "by_optimizer": res}
    log(rec)
    if not all(r["ok"] for r in res.values()):
        raise AssertionError("an optimizer on the card disagrees with the "
                             "host: %r" % res)
    return rec


# -- slice 16: mirroring (gradient checkpointing) and the Predictor --------
MIRROR_ENV = ("MXNET_BACKWARD_DO_MIRROR", "MXNET_BACKWARD_MIRROR_PATTERN",
              "MXNET_BACKWARD_MIRROR_STEP")
MIRROR_TOL = 1e-6   # relative L2 a tensor, where cuDNN parts the two steps
PREDICT_TOL = 1e-4  # the Predictor at another batch, and its internal head
MEMCOST_DIR = os.path.join("examples", "memcost_torch")
MEMCOST_LINE = re.compile(r"mirror=(\w+)\s+remat_segments=(\d+)\s+"
                          r"saved_residual_MB=([\d.]+)")


def _inception_bn_net(mx, classes=1000):
    with mx.NameManager():
        return mx.models.get_inception_bn(num_classes=classes)


def mirror_step(sym, shapes, args, aux, device, mirror, seed=0, steps=2):
    """``steps`` Executor training steps (forward, backward) of ``sym``
    bound with ``MXNET_BACKWARD_DO_MIRROR`` set to 1 or unset (the other
    mirror variables unset), from numpy parameters, Dropout keys under
    ``random.seed(seed)``: the last step's outputs, gradients and the
    aux states after it as numpy, with the last step's ms, the card's
    peak memory over it (the peak statistics reset just before; the
    first step warms cuDNN and the allocator) and K1's launches in it."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import softmax as sm

    with mock.patch.dict(os.environ):
        for k in MIRROR_ENV:
            os.environ.pop(k, None)
        if mirror:
            os.environ["MXNET_BACKWARD_DO_MIRROR"] = "1"
        exe = sym.simple_bind(_ctx(device), grad_req="write", **shapes)
    for n, v in args.items():
        exe.arg_dict[n][:] = v
    for n, v in aux.items():
        exe.aux_dict[n][:] = v
    cuda = device == "cuda"
    mx.random.seed(seed)
    for _ in range(steps - 1):
        exe.forward(is_train=True)
        exe.backward()
    _sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        bound = torch.cuda.memory_allocated()
    sm.fused_softmax.launches = 0
    t0 = time.perf_counter()
    exe.forward(is_train=True)
    exe.backward()
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    launches = sm.fused_softmax.launches
    peak = torch.cuda.max_memory_allocated() if cuda else None
    out = {"outputs": [o.asnumpy() for o in exe.outputs],
           "grads": {n: g.asnumpy() for n, g in exe.grad_dict.items()
                     if n not in shapes},
           "aux": {n: a.asnumpy() for n, a in exe.aux_dict.items()},
           "ms": ms, "softmax_launches": launches,
           "segments": sum(1 for it in exe._plan if it[0] == "seg"),
           "peak_gb": peak / 1e9 if cuda else None,
           "peak_above_bound_gb": (peak - bound) / 1e9 if cuda else None}
    del exe
    if cuda:
        torch.cuda.empty_cache()
    return out


def mirror_compare(got, want):
    """Every output, gradient and aux state of ``got`` against ``want``:
    bit-equal, or else within relative L2 MIRROR_TOL a tensor."""
    import numpy as np

    pairs = [("output%d" % i, a, b) for i, (a, b) in
             enumerate(zip(got["outputs"], want["outputs"]))]
    for part in ("grads", "aux"):
        pairs += [(n, got[part][n], want[part][n]) for n in want[part]]
    unequal = {n: float(np.linalg.norm(a - b)
                        / max(np.linalg.norm(b), 1e-30))
               for n, a, b in pairs if not np.array_equal(a, b)}
    return {"tensors": len(pairs), "bit_equal": not unequal,
            "unequal": len(unequal),
            "max_rel_l2": max(unequal.values(), default=0.0),
            "worst": max(unequal, key=unequal.get) if unequal else None,
            "ok": all(v <= MIRROR_TOL for v in unequal.values())}


def _memcost(device):
    """examples/memcost_torch/lstm_memcost.py's ``main`` at its defaults
    (seq-len 64, batch 32, 2 layers of 256) on ``device``: its two lines,
    parsed."""
    import io
    from contextlib import redirect_stdout

    ex = _example_modules(MEMCOST_DIR, ["lstm_memcost"])["lstm_memcost"]
    argv = ["lstm_memcost.py", "--device", "gpu" if device == "cuda"
            else "cpu"]
    buf = io.StringIO()
    with mock.patch.object(sys, "argv", argv), mock.patch.dict(os.environ), \
            redirect_stdout(buf):
        for k in MIRROR_ENV:
            os.environ.pop(k, None)
        ex.main()
    lines = buf.getvalue().strip().splitlines()
    parsed = [MEMCOST_LINE.search(line) for line in lines]
    if len(parsed) != 2 or not all(parsed):
        raise AssertionError("lstm_memcost printed %r" % lines)
    return lines, [{"mirror": m.group(1) == "True",
                    "remat_segments": int(m.group(2)),
                    "saved_mb": float(m.group(3))} for m in parsed]


def phase_mirror(device="cuda", batch=256, image=224, cifar_argv=()):
    """Mirroring (gradient checkpointing) in the executor:

    - one Executor training step of Inception-BN at train_imagenet.py's
      defaults (batch 256, 3x224x224, 1000 classes, f32) from one set of
      seeded parameters, unmirrored and then under
      ``MXNET_BACKWARD_DO_MIRROR=1`` (each the second of two steps, the
      first a warm-up): outputs, every gradient and the BatchNorm moving
      statistics bit-equal (else within relative L2 MIRROR_TOL, the
      reason recorded); the mirrored step's peak memory below the
      unmirrored one's; K1 once a step;
    - examples/memcost_torch/lstm_memcost.py at its defaults: mirroring
      cuts the bytes saved for backward;
    - train_cifar10.py ``--mirror`` for one epoch through the scanned
      fit: its trainer runs a mirror plan, its parameters stay finite,
      K1 once a training and a validation batch."""
    import numpy as np
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import softmax as sm

    sym = _inception_bn_net(mx)
    shapes = {"data": (batch, 3, image, image), "softmax_label": (batch,)}
    args, aux = zoo_params(sym, shapes, seed=13)
    plain = mirror_step(sym, shapes, args, aux, device, False)
    mirrored = mirror_step(sym, shapes, args, aux, device, True)
    cmp = mirror_compare(mirrored, plain)
    sm.fused_softmax.launches = 0
    lines, memcost = _memcost(device)
    memcost_launches = sm.fused_softmax.launches
    for line in lines:
        log(line)
    cifar, trainers = _cifar10_run(device, ["--num-epochs", "1", "--mirror"]
                                   + list(cifar_argv))
    finite = all(bool(torch.isfinite(p).all()) for t in trainers
                 for p in list(t.params.values()) + list(t.aux))
    rec = {"phase": "mirror", "batch": batch, "image": image,
           "segments": mirrored["segments"], "compare": cmp,
           "unmirrored": {k: plain[k] for k in (
               "ms", "peak_gb", "peak_above_bound_gb", "softmax_launches")},
           "mirrored": {k: mirrored[k] for k in (
               "ms", "peak_gb", "peak_above_bound_gb", "softmax_launches")},
           "peak_ratio": (mirrored["peak_gb"] / plain["peak_gb"]
                          if device == "cuda" else None),
           "memcost": memcost, "memcost_softmax_launches": memcost_launches,
           "cifar10_mirror": dict(cifar, trainers=len(trainers),
                                  mirror_plan=[t._run.__self__._remat
                                               for t in trainers],
                                  params_finite=finite),
           "softmax_launches": (plain["softmax_launches"]
                                + mirrored["softmax_launches"])}
    if not cmp["bit_equal"]:
        rec["compare"]["reason"] = (
            "cuDNN picked other algorithms for the recompute than for the "
            "forward" if cmp["ok"] else "the mirrored step differs")
    log(rec)
    if not cmp["ok"]:
        raise AssertionError("the mirrored Inception-BN step differs from "
                             "the unmirrored one: %r" % cmp)
    if not (np.all(np.isfinite(plain["outputs"][0]))
            and mirrored["segments"] > 0):
        raise AssertionError("mirror: no segments or non-finite outputs")
    if device == "cuda" and not mirrored["peak_gb"] < plain["peak_gb"]:
        raise AssertionError("mirroring did not lower the peak: %r vs %r"
                             % (mirrored["peak_gb"], plain["peak_gb"]))
    if device == "cuda" and (plain["softmax_launches"],
                             mirrored["softmax_launches"]) != (1, 1):
        raise AssertionError("K1 launched %d and %d times in the two steps"
                             % (plain["softmax_launches"],
                                mirrored["softmax_launches"]))
    base, mir = memcost
    if not (base["remat_segments"] == 0 and mir["remat_segments"] > 0
            and mir["saved_mb"] < base["saved_mb"]):
        raise AssertionError("lstm_memcost: mirroring saved nothing: %r"
                             % memcost)
    if not (trainers and all(rec["cifar10_mirror"]["mirror_plan"])
            and finite):
        raise AssertionError("train_cifar10 --mirror: %r"
                             % rec["cifar10_mirror"])
    return rec


_LOAD_COMPILED_CHILD = r"""
import json, sys, time
import numpy as np
import torch
from mxnet_tpu_torch import predictor, symbol
from mxnet_tpu_torch.ops import registry, softmax as sm


def refuse(*a, **k):
    raise AssertionError("load_compiled built a Symbol or read the registry")


symbol.Symbol.__init__ = refuse
registry.get = refuse
torch.backends.cuda.matmul.allow_tf32 = False   # as main() sets them
torch.backends.cudnn.allow_tf32 = False
sync = torch.cuda.synchronize if torch.cuda.is_available() else (
    lambda: None)
d, runs = sys.argv[1], int(sys.argv[2])
blob = open(d + "/model.mxtc", "rb").read()
x = np.load(d + "/x.npy")
sm.fused_softmax.launches = 0
t0 = time.perf_counter()
c = predictor.load_compiled(blob)
sync()
load_ms = (time.perf_counter() - t0) * 1e3
t0 = time.perf_counter()
c.forward(data=x)
out = c.get_output(0)
first_ms = (time.perf_counter() - t0) * 1e3
ms = []
for _ in range(runs):
    t0 = time.perf_counter()
    c.forward(data=x)
    sync()
    ms.append((time.perf_counter() - t0) * 1e3)
np.save(d + "/out.npy", out)
print(json.dumps({"load_ms": load_ms, "first_ms": first_ms,
                  "ms_per_batch": sorted(ms)[len(ms) // 2],
                  "ms_min": min(ms), "ms_max": max(ms),
                  "launches": sm.fused_softmax.launches}))
"""


def bias_before_batchnorm(sym):
    """The biases of the convolutions whose output goes straight into a
    BatchNorm: their gradient is zero but for rounding (the BatchNorm
    takes the batch mean out), so a relative comparison of two devices'
    values of it compares rounding noise alone."""
    nodes = json.loads(sym.tojson())["nodes"]
    out = []
    for n in nodes:
        if n["op"] != "BatchNorm":
            continue
        src = nodes[n["inputs"][0][0]]
        if src["op"] == "Convolution":
            out += [nodes[i]["name"] for i, _ in src["inputs"]
                    if nodes[i]["name"].endswith("_bias")]
    return sorted(out)


def phase_predictor(device="cuda", batch=32, small=8, image=224, runs=10):
    """The Predictor on Inception-BN at full width (1000 classes,
    3x224x224, seeded parameters and moving statistics saved with
    ``save_checkpoint``):

    - ``Predictor.from_checkpoint`` on ``device`` at batch ``batch``:
      outputs bit-equal to ``FeedForward.predict`` on the same batch;
      partial outputs (``global_pool``) against the internal head bound
      alone (PREDICT_TOL); ``reshape`` to ``small`` against the first
      rows (PREDICT_TOL: cuDNN picks per shape);
    - ``export_compiled``, then ``load_compiled`` in a fresh process
      that builds no Symbol and reads no op registry: outputs bit-equal
      to the Predictor's, and K1 launched there (inside the exported
      program); its cold load, first batch and ms a batch;
    - ``test_utils.check_consistency`` of LeNet and Inception-BN-small
      over ``[gpu(0), cpu()]`` at the helper's own tolerances, every
      gradient but those of the biases a BatchNorm follows
      (:func:`bias_before_batchnorm`: zero but for rounding);
    - ``profiler`` around two Predictor calls: the trace holds the
      scope's name and a K1 launch.
    Prints the Predictor's and the exported program's ms a batch."""
    import json
    import shutil
    import tempfile

    import numpy as np
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import softmax as sm

    ctx = _ctx(device)
    sym = _inception_bn_net(mx)
    shapes = {"data": (batch, 3, image, image), "softmax_label": (batch,)}
    args, aux = zoo_params(sym, shapes, seed=17)
    rng = np.random.RandomState(18)
    aux = {n: (0.1 * rng.randn(*v.shape) if n.endswith("mean")
               else 0.5 + rng.rand(*v.shape)).astype(np.float32)
           for n, v in aux.items()}
    tmp = tempfile.mkdtemp(prefix="mx_predictor_")
    try:
        prefix = os.path.join(tmp, "inception-bn")
        mx.model.save_checkpoint(
            prefix, 1, sym,
            {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in args.items()
             if k not in shapes},
            {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in aux.items()},
            sync=True)
        x = args["data"]
        dshape = {"data": x.shape}

        sm.fused_softmax.launches = 0
        pred = mx.Predictor.from_checkpoint(prefix, 1, ctx=ctx,
                                            input_shapes=dshape)
        pred.forward(data=x)
        out = pred.get_output(0)
        launches = sm.fused_softmax.launches
        ff = mx.FeedForward.load(prefix, 1, ctx=ctx).predict(
            mx.io.NDArrayIter(x, batch_size=batch))
        same_as_predict = bool(np.array_equal(ff, out))

        head = "global_pool"
        part = mx.Predictor.from_checkpoint(prefix, 1, ctx=ctx,
                                            input_shapes=dshape,
                                            output_names=[head])
        part.forward(data=x)
        _, sargs, saux = mx.model.load_checkpoint(prefix, 1)
        inner = sym.get_internals()[head + "_output"]
        exe = inner.simple_bind(ctx, grad_req="null", data=x.shape)
        exe.copy_params_from(sargs, saux, allow_extra_params=True)
        exe.forward(is_train=False, data=x)
        part_close = _np_close(part.get_output(0), exe.outputs[0].asnumpy(),
                               PREDICT_TOL)
        del exe, part

        pred.reshape({"data": (small,) + x.shape[1:]})
        pred.forward(data=x[:small])
        small_close = _np_close(pred.get_output(0), out[:small], PREDICT_TOL)
        small_shape = pred.get_output_shape(0)
        pred.reshape(dshape)

        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            pred.forward(data=x)
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
        times.sort()

        t0 = time.perf_counter()
        blob = pred.export_compiled()
        export_s = time.perf_counter() - t0
        with open(os.path.join(tmp, "model.mxtc"), "wb") as f:
            f.write(blob)
        np.save(os.path.join(tmp, "x.npy"), x)
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=root)
        if device != "cuda":
            env["CUDA_VISIBLE_DEVICES"] = ""
        child = subprocess.run(
            [sys.executable, "-c", _LOAD_COMPILED_CHILD, tmp, str(runs)],
            cwd=root, env=env, capture_output=True, text=True, timeout=600)
        if child.returncode != 0:
            raise AssertionError("load_compiled in a fresh process failed:"
                                 "\n%s" % child.stderr[-4000:])
        loaded = json.loads(child.stdout.strip().splitlines()[-1])
        exported_out = np.load(os.path.join(tmp, "out.npy"))
        exported_same = bool(np.array_equal(exported_out, out))
        exported_close = _np_close(exported_out, out, PREDICT_TOL)

        consistency = {}
        for name, build, dshape_c in (
                ("lenet", lambda: mx.models.get_lenet(), (8, 1, 28, 28)),
                ("inception_bn_small",
                 lambda: mx.models.get_inception_bn_small(num_classes=10),
                 (8, 3, 28, 28))):
            np.random.seed(21)
            with mx.NameManager():
                net = build()
            skip = bias_before_batchnorm(net)
            mx.test_utils.check_consistency(
                net, [{"ctx": ctx, "data": dshape_c},
                      {"ctx": mx.cpu(), "data": dshape_c}],
                grad_req={n: "null" if n in skip else "write"
                          for n in net.list_arguments()})
            consistency[name] = {"held": True, "gradients_not_taken": skip}

        mx.profiler.profiler_set_config(filename=os.path.join(tmp, "trace"))
        mx.profiler.profiler_set_state("run")
        with mx.profiler.scope("predictor-batch"):
            for _ in range(2):
                pred.forward(data=x)
                pred.get_output(0)
        mx.profiler.profiler_set_state("stop")
        with open(mx.profiler.last_trace()) as f:
            events = json.load(f)["traceEvents"]
        scope_seen = any(e.get("name") == "predictor-batch" for e in events)
        k1_seen = sum(1 for e in events if e.get("cat") == "kernel"
                      and "softmax" in e.get("name", ""))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    rec = {"phase": "predictor", "batch": batch, "image": image,
           "classes": 1000, "softmax_launches": launches,
           "exported_softmax_launches": loaded["launches"],
           "same_as_feedforward_predict": same_as_predict,
           "partial_head": head, "partial_closeness": part_close,
           "reshape_shape": list(small_shape),
           "reshape_closeness": small_close,
           "predictor_ms_per_batch": times[len(times) // 2],
           "predictor_ms_min_max": [times[0], times[-1]],
           "export_s": export_s, "artifact_mb": len(blob) / 1e6,
           "exported": loaded, "exported_same_as_predictor": exported_same,
           "exported_closeness": exported_close,
           "consistency": consistency, "profiler_scope": scope_seen,
           "profiler_k1_kernels": k1_seen}
    log(rec)
    cuda = device == "cuda"
    checks = {
        "outputs finite": bool(np.all(np.isfinite(out))),
        "Predictor = FeedForward.predict": same_as_predict,
        "partial head": within(part_close, PREDICT_TOL),
        "reshape": (small_shape == (small, 1000)
                    and within(small_close, PREDICT_TOL)),
        "exported = Predictor": exported_same,
        "K1 in the Predictor": launches == (1 if cuda else 0),
        "K1 in the exported program": loaded["launches"] == (
            runs + 1 if cuda else 0),
        "profiler scope": scope_seen,
        "profiler K1": k1_seen >= 2 if cuda else True}
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError("predictor: %s failed: %r" % (failed, rec))
    return rec


# -- the kvstore, data and model parallelism, dist -----------------------------
KV_SHAPE = (64, 33)
KV_KEYS = [5, 7, 11]
KV_CONTEXTS = 4          # push from N contexts
KV_UPDATE_RTOL = 1e-6    # set_optimizer's updates, card against host
MP_RTOL, MP_ATOL = 1e-4, 1e-5   # group2ctx against the unpartitioned net
DP_NUM_EPOCHS = 1        # train_imagenet.py --kv-store device: 8 steps
LSTM_PTB = "examples/model-parallel-lstm_torch/lstm_ptb.py"
DIST_TIMEOUT = 300       # s, each launched job


def card_contexts(device, n):
    """``n`` contexts on ``device``: the cards ``gpu(i % cards)`` (a
    context repeats when there are fewer cards than ``n``), or ``n``
    host contexts."""
    import torch

    import mxnet_tpu_torch as mx

    if device == "cpu":
        return [mx.cpu(i) for i in range(n)]
    cards = torch.cuda.device_count()
    return [mx.gpu(i % cards) for i in range(n)]


def dp_contexts(device):
    """The data-parallel contexts: every card when there are two or
    more, else two contexts on the one card (two host contexts on the
    CPU)."""
    import torch

    cards = torch.cuda.device_count() if device == "cuda" else 0
    return card_contexts(device, cards if cards >= 2 else 2)


def kvstore_cases(mx, contexts, seed=0, shape=KV_SHAPE):
    """The semantics of tests/unittest/test_kvstore.py on ``contexts``
    with seeded random values, for either package (``mx``): each case's
    pulled arrays as numpy. ``single``: one pair; ``multi``: a push from
    every context; ``list``: three keys at once; ``updater``: a custom
    updater, two pushes; ``sgd_momentum``: ``set_optimizer`` with SGD
    (lr 0.1, momentum 0.9, wd 1e-4), three pushes; ``own_storage``: a
    one-value push, pulled before and after the pushed array is written
    in place."""
    import numpy as np

    rng = np.random.RandomState(seed)

    def vals(ctxs):
        return [mx.nd.array(rng.rand(*shape).astype(np.float32), ctx=c)
                for c in ctxs]

    def fresh():
        kv = mx.kvstore.create("local")
        kv.init(3, mx.nd.zeros(shape, contexts[0]))
        kv.init(KV_KEYS, [mx.nd.zeros(shape, contexts[0])] * len(KV_KEYS))
        return kv

    def pull(kv, key, ctxs):
        outs = [mx.nd.empty(shape, c) for c in ctxs]
        kv.pull(key, out=outs)
        return [o.asnumpy() for o in outs]

    out = {}
    kv = fresh()
    kv.push(3, vals(contexts[:1])[0])
    out["single"] = pull(kv, 3, contexts[:1])
    kv = fresh()
    kv.push(3, vals(contexts))
    out["multi"] = pull(kv, 3, contexts)
    kv = fresh()
    kv.push(KV_KEYS, [vals(contexts) for _ in KV_KEYS])
    out["list"] = [a for k in KV_KEYS for a in pull(kv, k, contexts)]
    kv = fresh()

    def updater(key, recv, local):
        local += recv

    kv._set_updater(updater)
    v = vals(contexts)
    kv.push(3, v)
    kv.push(3, v)
    out["updater"] = pull(kv, 3, contexts)
    kv = mx.kvstore.create("local")
    kv.init(0, vals(contexts[:1])[0])
    kv.set_optimizer(mx.optimizer.create(
        "sgd", learning_rate=0.1, momentum=0.9, wd=1e-4,
        rescale_grad=1.0 / len(contexts)))
    for _ in range(3):
        kv.push(0, vals(contexts))
    out["sgd_momentum"] = pull(kv, 0, contexts)
    kv = fresh()
    v = vals(contexts[:1])[0]
    kv.push(3, v)
    before = pull(kv, 3, contexts[:1])
    v[:] = 0.0
    out["own_storage"] = before + pull(kv, 3, contexts[:1])
    return out


def kvstore_check(got, want):
    """Card (``got``) against host (``want``) cases: the sums bit-equal,
    the updates within KV_UPDATE_RTOL; raises AssertionError; returns
    the worst update error."""
    import numpy as np

    worst = 0.0
    for name, w in want.items():
        for a, b in zip(got[name], w):
            if name == "sgd_momentum":
                err = float(np.max(np.abs(a - b) / np.maximum(np.abs(b),
                                                               1e-30)))
                worst = max(worst, err)
                if not np.allclose(a, b, rtol=KV_UPDATE_RTOL, atol=0):
                    raise AssertionError("kvstore %s: rel err %g > %g"
                                         % (name, err, KV_UPDATE_RTOL))
            elif not np.array_equal(a, b):
                raise AssertionError("kvstore %s: not bit-equal, max abs "
                                     "err %g" % (name, np.abs(a - b).max()))
    o = got["own_storage"]
    if not np.array_equal(o[0], o[1]):
        raise AssertionError("kvstore: an in-place write to a pushed "
                             "array changed the store")
    return worst


def phase_kvstore(device="cuda", size_mb=64):
    """The kvstore's cases (:func:`kvstore_cases`) on ``KV_CONTEXTS``
    card contexts against the same on host contexts (sums bit-equal,
    updates within KV_UPDATE_RTOL, the store's own storage), then
    tools/torch_bandwidth.py's device leg (every card; with one, its
    note and 0.0)."""
    import argparse

    import mxnet_tpu_torch as mx

    ctxs = card_contexts(device, KV_CONTEXTS)
    got = kvstore_cases(mx, ctxs)
    want = kvstore_cases(mx, [mx.cpu(i) for i in range(KV_CONTEXTS)])
    worst = kvstore_check(got, want)
    bw = _load_tool("torch_bandwidth").run_device(argparse.Namespace(
        ctx="gpu" if device == "cuda" else "cpu", num_devices=2,
        size_mb=size_mb, iters=10, warmup=2, repeats=3))
    rec = {"phase": "kvstore", "contexts": [str(c) for c in ctxs],
           "cases": sorted(got), "shape": list(KV_SHAPE),
           "sgd_momentum_max_rel_err": worst, "bandwidth_device": bw}
    log(rec)
    return rec


def dp_step(sym, shapes, args, aux, contexts, seed=0):
    """One data-parallel training step of ``sym`` over ``contexts``: an
    executor a context on its slice of the batch, forward and backward,
    the gradients summed through a ``device`` kvstore. (outputs
    concatenated, summed gradients, aux states averaged) as numpy."""
    import numpy as np

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.executor_manager import _split_input_slice

    slices = _split_input_slice(shapes["data"][0], [1] * len(contexts))
    exes = []
    for c, sl in zip(contexts, slices):
        sub = {k: (sl.stop - sl.start,) + tuple(v[1:])
               for k, v in shapes.items()}
        exe = sym.simple_bind(c, grad_req="write", **sub)
        for n, v in args.items():
            exe.arg_dict[n][:] = v[sl] if n in shapes else v
        for n, v in aux.items():
            exe.aux_dict[n][:] = v
        exes.append(exe)
    mx.random.seed(seed)
    for exe in exes:
        exe.forward(is_train=True)
        exe.backward()
    kv = mx.kvstore.create("device")
    grads = {}
    for i, n in enumerate(k for k in args if k not in shapes):
        kv.init(i, exes[0].arg_dict[n])
        kv.push(i, [e.grad_dict[n] for e in exes])
        out = mx.nd.zeros(exes[0].grad_dict[n].shape, mx.cpu())
        kv.pull(i, out=out)
        grads[n] = out.asnumpy()
    outs = [np.concatenate([e.outputs[j].asnumpy() for e in exes])
            for j in range(len(exes[0].outputs))]
    auxs = {n: sum(e.aux_dict[n].asnumpy() for e in exes) / len(exes)
            for n in aux}
    return outs, grads, auxs


def _dp_fit_checks(device, contexts):
    """LeNet's canonical fit over ``contexts`` with ``kvstore="device"``
    (score > 0.9) and mnist_mlp's ``Module.fit`` over them with
    ``local`` and ``device`` (validation accuracy > 0.9): records."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import softmax as sm

    recs = []
    mx.random.seed(0)
    train = mx.io.MNISTIter(batch_size=64, num_synthetic=1024, seed=1)
    val = mx.io.MNISTIter(batch_size=64, num_synthetic=512, seed=2,
                          shuffle=False)
    with contexts[0]:
        model = mx.FeedForward(mx.models.get_lenet(), ctx=contexts,
                               num_epoch=3, learning_rate=0.1, momentum=0.9,
                               initializer=mx.initializer.Xavier())
        sm.fused_softmax.launches = 0
        model.fit(X=train, eval_data=val, kvstore="device")
        score = model.score(val)
    _sync(device)
    recs.append({"fit": "lenet FeedForward", "kvstore": "device",
                 "score": score, "softmax_launches":
                 sm.fused_softmax.launches})
    if not score > 0.9:
        raise AssertionError("LeNet over %s scored %g <= 0.9"
                             % (contexts, score))
    for kind in ("local", "device"):
        mx.random.seed(0)
        train, val = _mnist_iters(100, 2000, 1000)
        with contexts[0]:
            mod = mx.module.Module(_mlp_symbol([128]), context=contexts)
            sm.fused_softmax.launches = 0
            mod.fit(train, eval_data=val, num_epoch=3, kvstore=kind,
                    optimizer_params={"learning_rate": 0.1,
                                      "momentum": 0.9},
                    initializer=mx.initializer.Xavier())
            acc = dict(mod.score(val, "acc"))["accuracy"]
        _sync(device)
        recs.append({"fit": "mnist_mlp Module", "kvstore": kind,
                     "update_on_kvstore": mod._update_on_kvstore,
                     "val_accuracy": acc,
                     "softmax_launches": sm.fused_softmax.launches})
        if not acc > 0.9:
            raise AssertionError("Module.fit over %s, kvstore %s: accuracy "
                                 "%g <= 0.9" % (contexts, kind, acc))
    return recs


def phase_data_parallel(device="cuda", argv=(), synthetic=None,
                        check_batch=8, check_image=224, check_classes=1000):
    """Config #2 as train_imagenet.py writes it: ``--network resnet
    --synthetic --kv-store device`` (ResNet-50, batch 256, 224^2, 1000
    classes, f32) over :func:`dp_contexts` for one epoch of 8 steps
    through ``train_model.fit`` and the per-batch loop, the gradients
    summed and the optimizer run in the kvstore. Checks: every step's
    cross-entropy finite, the parameters changed and finite, K1 once a
    context and step. Then a 2-context step at ``check_batch`` on the
    card against the host's 2-context step from the same parameters
    (:func:`net_closeness`), LeNet's canonical fit and mnist_mlp's
    ``Module.fit`` over the contexts (:func:`_dp_fit_checks`). Prints
    ``{"multi_device": {"cards": n, "contexts": [...]}}``; returns the
    record (K1's launches on the paths in ``softmax_launches`` and
    ``fits``)."""
    import math

    import numpy as np
    import torch

    import mxnet_tpu_torch as mx

    ctxs = dp_contexts(device)
    cards = torch.cuda.device_count() if device == "cuda" else 0
    log({"multi_device": {"cards": cards,
                          "contexts": [str(c) for c in ctxs],
                          "route": "one executor a card" if cards >= 2
                          else "two executors on one device"}})
    seen = {"ce": [], "stamps": [], "first": None}

    def on_batch(param):
        loc = param.locals
        if seen["first"] is None:
            seen["first"] = {k: v.asnumpy()
                             for k, v in loc["arg_params"].items()}
        grp = loc["executor_manager"].curr_execgrp
        lab = loc["data_batch"].label[0].asnumpy().astype(np.int64)
        ce = []
        for exe, sl in zip(grp.train_execs, grp.slices):
            prob = exe.outputs[0].asnumpy()
            lb = lab[sl]
            ce.append(-np.log(np.maximum(
                prob[np.arange(len(lb)), lb], 1e-30)))
        seen["ce"].append(float(np.concatenate(ce).mean()))
        seen["stamps"].append(time.perf_counter())

    argv = (["--network", "resnet", "--synthetic", "--kv-store", "device",
             "--num-devices", str(len(ctxs)), "--num-epochs",
             str(DP_NUM_EPOCHS)] + list(argv))
    run = _imagenet_run(
        device, argv, lambda args: mx.models.get_resnet(
            num_classes=args.num_classes, num_layers=50),
        on_batch=on_batch, synthetic=synthetic, trace=False)
    args, model, launches = run["args"], run["model"], run["launches"]
    steps = args.num_examples // args.batch_size * args.num_epochs
    st = seen["stamps"]
    warm_ms = 1e3 * (st[-1] - st[0]) / (len(st) - 1) if len(st) > 1 \
        else None
    rec = {"phase": "data_parallel", "example": IC_DIR + "/train_imagenet.py",
           "argv": argv, "contexts": [str(c) for c in ctxs],
           "batch": args.batch_size, "epochs": args.num_epochs,
           "steps": steps, "wall_s": run["wall_s"],
           "epoch_s": run["epoch_s"], "scanned_trainer_built": run["built"],
           "img_per_s_epoch": steps * args.batch_size / sum(run["epoch_s"]),
           "step_ms_after_first": warm_ms,
           "img_per_s_after_first": (args.batch_size / warm_ms * 1e3
                                     if warm_ms else None),
           "cross_entropy": seen["ce"], "softmax_launches": launches}
    last = {k: v.asnumpy() for k, v in model.arg_params.items()}
    if not (len(seen["ce"]) == steps
            and all(math.isfinite(v) for v in seen["ce"])):
        raise AssertionError("data parallel ResNet-50: a step's "
                             "cross-entropy is not finite, or missing: %r"
                             % seen["ce"])
    if not all(np.all(np.isfinite(v)) for v in last.values()):
        raise AssertionError("data parallel ResNet-50: non-finite "
                             "parameters")
    if all(np.array_equal(seen["first"][k], last[k]) for k in last):
        raise AssertionError("data parallel ResNet-50: the parameters "
                             "did not change")
    if run["built"]:
        raise AssertionError("data parallel ResNet-50 built a scanned "
                             "trainer: the kvstore path did not run")
    expected = len(ctxs) * steps if device == "cuda" else 0
    if launches != expected:
        raise AssertionError("data parallel ResNet-50 launched K1 %d times, "
                             "expected %d" % (launches, expected))
    # one 2-context step at check_batch against the host
    with mx.NameManager():
        sym = mx.models.get_resnet(num_classes=check_classes, num_layers=50)
    shapes = {"data": (check_batch, 3, check_image, check_image),
              "softmax_label": (check_batch,)}
    params, aux = zoo_params(sym, shapes, seed=11)
    two = ctxs[:2]
    got = dp_step(sym, shapes, params, aux, two)
    want = dp_step(sym, shapes, params, aux, [mx.cpu(0), mx.cpu(1)])
    nudged = dp_step(sym, shapes, nudge(params), aux, two)
    rec["step_check"] = dict(net_closeness(got, want, nudged),
                             batch=check_batch, contexts=[str(c)
                                                          for c in two])
    rec["fits"] = _dp_fit_checks(device, ctxs)
    log(rec)
    if not rec["step_check"]["ok"]:
        raise AssertionError("the 2-context ResNet-50 step on the card "
                             "differs from the host's: %r"
                             % rec["step_check"])
    return rec


def mp_grad_check(mx, mp_ctxs, sp_ctx, num_layers=4, seq_len=32,
                  vocab=200, num_hidden=200, num_embed=128, batch=32,
                  seed=5):
    """One training step of the model-parallel LSTM over ``mp_ctxs``
    (``lstm_group2ctx``) against the same net unpartitioned on
    ``sp_ctx`` from the same seeded parameters: outputs and the
    gradients of l0_i2h_weight, embed_weight and cls_weight within
    MP_RTOL/MP_ATOL, and each argument's context its group's. Raises;
    returns the worst errors."""
    import numpy as np

    from mxnet_tpu_torch.models.lstm import lstm_group2ctx, lstm_unroll

    net_mp = lstm_unroll(num_layers, seq_len, vocab, num_hidden, num_embed,
                         vocab, group2ctx_layers=True)
    net_sp = lstm_unroll(num_layers, seq_len, vocab, num_hidden, num_embed,
                         vocab, group2ctx_layers=False)
    shapes = {"data": (batch, seq_len), "softmax_label": (batch, seq_len)}
    for i in range(num_layers):
        shapes["l%d_init_c" % i] = shapes["l%d_init_h" % i] = (batch,
                                                               num_hidden)
    g2c = lstm_group2ctx(num_layers, mp_ctxs)
    exe_mp = net_mp.simple_bind(mp_ctxs[0], group2ctx=g2c, **shapes)
    exe_sp = net_sp.simple_bind(sp_ctx, **shapes)
    for name, arr in exe_mp.arg_dict.items():
        group = [n for n in net_mp.nodes if n.is_variable
                 and n.name == name][0].attrs.get("ctx_group")
        want_ctx = g2c.get(group, mp_ctxs[0])
        if arr.context != want_ctx:
            raise AssertionError("group2ctx: %s on %s, its group %s on %s"
                                 % (name, arr.context, group, want_ctx))
    rng = np.random.RandomState(seed)
    vals = {k: rng.uniform(-0.1, 0.1, v.shape).astype("f")
            for k, v in exe_sp.arg_dict.items()}
    vals["data"] = rng.randint(0, vocab, shapes["data"]).astype("f")
    vals["softmax_label"] = rng.randint(0, vocab, shapes["data"]).astype(
        "f")
    for exe in (exe_sp, exe_mp):
        for k, v in exe.arg_dict.items():
            v[:] = vals[k]
        exe.forward(is_train=True)
        exe.backward()
    errs = {}
    pairs = [("outputs", exe_mp.outputs[0], exe_sp.outputs[0])] + [
        (k, exe_mp.grad_dict[k], exe_sp.grad_dict[k])
        for k in ("l0_i2h_weight", "embed_weight", "cls_weight")]
    for k, a, b in pairs:
        a, b = a.asnumpy(), b.asnumpy()
        errs[k] = float(np.max(np.abs(a - b)))
        if not np.allclose(a, b, rtol=MP_RTOL, atol=MP_ATOL):
            raise AssertionError("group2ctx LSTM %s: max abs err %g"
                                 % (k, errs[k]))
    return {"max_abs_err": errs,
            "group2ctx": {k: str(v) for k, v in g2c.items()},
            "outputs_context": str(exe_mp.outputs[0].context)}


def phase_model_parallel(device="cuda", argv=(), check=None):
    """Config #4: examples/model-parallel-lstm_torch/lstm_ptb.py at its
    defaults (4 layers, 200 hidden, 128 embed, seq 32, batch 32, lr 0.5,
    2 epochs, the synthetic corpus), its groups on every card when there
    are four or more, else on what exists. Checks: the perplexity falls
    from epoch 1 to 2, K1 once a step; then :func:`mp_grad_check` at the
    example's sizes (``check`` overrides them), the groups over four
    contexts against one. Prints the group map; returns the record."""
    import importlib.util

    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import softmax as sm

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        LSTM_PTB)
    spec = importlib.util.spec_from_file_location("mp_lstm_ptb", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    argv = (["--ctx", "gpu" if device == "cuda" else "cpu"]
            + list(argv))
    mx.random.seed(0)
    _sync(device)
    sm.fused_softmax.launches = 0
    t0 = time.perf_counter()
    res = ex.main(argv)
    _sync(device)
    wall = time.perf_counter() - t0
    launches = sm.fused_softmax.launches
    cards = torch.cuda.device_count() if device == "cuda" else 0
    ppl = res["perplexity"]
    rec = {"phase": "model_parallel", "example": LSTM_PTB, "argv": argv,
           "cards": cards, "group2ctx": res["group2ctx"],
           "perplexity": ppl, "samples_per_s": res["samples_per_s"],
           "batches": res["batches"], "wall_s": wall,
           "softmax_launches": launches}
    mp = card_contexts(device, 4)
    rec["grad_check"] = mp_grad_check(mx, mp, mp[0], **dict(check or {}))
    log(rec)
    if not (len(ppl) >= 2 and ppl[1] < ppl[0]):
        raise AssertionError("model-parallel LSTM: perplexity did not fall "
                             "from epoch 1 to 2: %r" % ppl)
    expected = res["batches"] if device == "cuda" else 0
    if launches != expected:
        raise AssertionError("model-parallel LSTM launched K1 %d times, "
                             "expected %d" % (launches, expected))
    return rec


def dist_worker(ctx, size_mb):
    """One rank of ``phase_dist``: tests/torch_nightly/dist_sync_kvstore.py
    and dist_lenet.py, then tools/torch_bandwidth.py's dist-leg worker,
    in one process (one start and one rendezvous for the three)."""
    import argparse
    import importlib.util

    root = os.path.dirname(os.path.abspath(__file__))
    for name in ("dist_sync_kvstore", "dist_lenet"):
        spec = importlib.util.spec_from_file_location(
            "nightly_" + name,
            os.path.join(root, "tests", "torch_nightly", name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.main(["--ctx", ctx])
    _load_tool("torch_bandwidth")._dist_worker(argparse.Namespace(
        ctx=ctx, size_mb=size_mb, iters=10, warmup=2, repeats=3))


def phase_dist(device="cuda", workers=2, size_mb=64):
    """``tools/torch_launch.py -n 2`` on the card, each rank running
    :func:`dist_worker`: the counterparts of
    tests/nightly/dist_sync_kvstore.py (the exact dist_sync arithmetic,
    the (1200, 1200) key, the bucketed multi-key push) and
    tests/nightly/dist_lenet.py (rank-sharded MNISTIter, accuracy > 0.9
    on each rank, parameters equal across ranks), then the bandwidth
    tool's dist leg (rank 0 prints it). Prints the backend the store's
    rule chose; returns the record."""
    ctx = "gpu" if device == "cuda" else "cpu"
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-c",
           "import chip_smoke; chip_smoke.dist_worker(%r, %r)"
           % (ctx, size_mb)]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "tools", "torch_launch.py"),
         "-n", str(workers), "--timeout", str(DIST_TIMEOUT - 30), "--"]
        + cmd, cwd=root, capture_output=True, text=True,
        timeout=DIST_TIMEOUT)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError("the dist ranks exited %d:\n%s\n%s" % (
            proc.returncode, proc.stdout[-4000:], proc.stderr[-4000:]))
    lines = [json.loads(x) for x in proc.stdout.splitlines()
             if x.startswith("{")]
    sync = [x["dist_sync_kvstore"] for x in lines
            if "dist_sync_kvstore" in x]
    lenet = [x["dist_lenet"] for x in lines if "dist_lenet" in x]
    bw = [x for x in lines if x.get("metric") == "comm_dist_allreduce_fp32"]
    rec = {"phase": "dist", "workers": workers,
           "backend": sorted({r["backend"] for r in sync + lenet}),
           "dist_sync_kvstore": sync, "dist_lenet": lenet,
           "bandwidth_dist": bw, "wall_s": wall}
    log(rec)
    if len(sync) != workers or len(lenet) != workers or len(bw) != 1:
        raise AssertionError("dist: expected a line from each of %d ranks "
                             "and one bandwidth record: %r"
                             % (workers, rec))
    return rec


# the serving fleet (phase_fleet). Leg A's requests: one long_len prompt
# (the Ulysses cp prefill, K2 once a layer), five short greedy prompts
# and two sampled ones, each (prompt length or "long", sampling kwargs)
FLEET_REQUESTS = [("long", {}), (5, {}), (37, {}), (12, {}), (64, {}),
                  (23, {}), (9, dict(temperature=0.8, top_p=0.95, seed=1)),
                  (17, dict(temperature=1.0, top_k=50, seed=2))]
# phase_serving's engine geometry
FLEET_SERVING = dict(block_size=16, num_blocks=512, max_batch=8,
                     prefill_chunk=64)
FLEET_DEMO_SEED = 7
# the serving.*, wsync.* and fleet.* metrics the JAX package emits for
# leg D's scenario (tests/test_torch_telemetry.py holds this set to the
# JAX package's at a tiny size)
TELEMETRY_CATALOG = (
    "fleet.queue_depth", "fleet.redeliveries_total",
    "fleet.replica_evictions_total", "fleet.replicas_alive",
    "fleet.replicas_registered_total", "fleet.requests_completed",
    "fleet.requests_total", "fleet.tokens_per_s", "fleet.ttft_s",
    "serving.decode_batch_size", "serving.decode_step_s",
    "serving.kv_pool_hwm_blocks", "serving.kv_pool_utilization",
    "serving.queue_depth", "serving.requests_admitted",
    "serving.requests_completed", "serving.token_latency_s",
    "serving.tokens_per_s", "serving.ttft_s", "serving.ttft_sync_s",
    "wsync.acks_total", "wsync.apply_secs", "wsync.bytes_fetched_total",
    "wsync.current_version", "wsync.published_version",
    "wsync.rollbacks_total", "wsync.tensors_fetched_total",
    "wsync.versions_applied_total", "wsync.versions_published_total")


def _fleet_prompts(vocab, long_len, requests=FLEET_REQUESTS, seed=0):
    import numpy as np

    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, (long_len if n == "long" else n,))
             .astype(np.int32), kw) for n, kw in requests]


def _engine_streams(eng, reqs, new, timeout=600):
    """The streams of ``reqs`` on one engine (its background loop, or
    driven here when it has none)."""
    hs = [eng.submit(p, max_new_tokens=new, **kw) for p, kw in reqs]
    if eng._thread is None:
        eng.run_until_idle()
    return [h.result(timeout=timeout) for h in hs]


def _fleet_serve(router, reqs, new, kill=None, timeout=300, pace=0.01):
    """Submit ``reqs`` through ``router`` and collect the streams,
    driving the router's pump from this thread every ``pace`` seconds
    (``Router.start``'s loop polls without pause, and beside engines in
    the same process it holds the GIL that their every torch call gives
    up and retakes: PERF.md §5). With ``kill(router, entry)``, it is
    called once the first request has streamed two tokens through the
    router (it stops that request's replica mid-decode); returns the
    streams and what ``kill`` said."""
    streams = [router.submit(p, max_new_tokens=new, **kw) for p, kw in reqs]
    killed = None
    deadline = time.monotonic() + timeout
    while any(s.rid in router._requests for s in streams):
        router.step()
        if kill is not None and killed is None:
            ent = router._requests.get(streams[0].rid)
            if ent is not None and ent.replica and len(ent.tokens) >= 2:
                killed = kill(router, ent)
        if time.monotonic() > deadline:
            raise AssertionError("fleet streams unfinished after %d s"
                                 % timeout)
        time.sleep(pace)
    if kill is not None and killed is None:
        raise AssertionError("the first request finished before the kill")
    outs = [s.result(timeout=timeout) for s in streams]
    bad = [s.status for s in streams if s.status != "finished"]
    if bad:
        raise AssertionError("fleet streams ended %r" % bad)
    return outs, killed


def _fleet(engines, names=("rep0", "rep1")):
    """ReplicaServers on loopback around started engines, registered with
    a Router (on loopback too) through its fleet_register RPC."""
    from mxnet_tpu_torch.serving.fleet import (FleetClient, ReplicaServer,
                                               Router)

    router = Router(bind=("127.0.0.1", 0), health_interval=0.05)
    host, port = router.serve()
    reps = []
    for name, eng in zip(names, engines):
        eng.start()
        rep = ReplicaServer(eng, name=name, bind=("127.0.0.1", 0))
        rhost, rport = rep.start()
        FleetClient("%s:%d" % (host, port)).register(
            name=name, addr="%s:%d" % (rhost, rport))
        reps.append(rep)
    return router, reps


def _kill_replica(reps, engines):
    """The leg's kill: stop the engine serving the request (mid-decode)
    and close its server, so the router's next poll fails."""
    def kill(router, ent):
        i = [r.name for r in reps].index(ent.replica)
        engines[i].stop()
        unfinished = len(engines[i].sched.active) + len(engines[i].sched.queue)
        reps[i].close()
        return {"replica": ent.replica, "router_tokens": len(ent.tokens),
                "unfinished_on_replica": unfinished}
    return kill


def _close_fleet(router, reps, engines):
    router.close()
    for rep, eng in zip(reps, engines):
        rep.close()
        eng.stop()


# a stream parts from the reference only at a decision within the bf16
# noise of the engines' batch-dependent products, and agrees with the
# plain forward wherever its margin is wider (phase_serving's 0.25)
FLEET_MARGIN = {"bfloat16": 0.25, "float32": 1e-3}


def _decisions(params, cfg, prompt, stream, kw):
    """The plain forward's choice and its margin at each position of
    ``stream``, teacher-forced on prompt + stream: the gap between the
    best and second-best score, the f32 logits for a greedy request and
    the filtered, scaled logits plus that position's Gumbel noise (the
    engine's draw) for a sampled one."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import threefry as tf
    from mxnet_tpu_torch.models.transformer import forward
    from mxnet_tpu_torch.ops.flash_attention import attention_reference
    from mxnet_tpu_torch.serving import sampling as samp

    seq = np.concatenate([prompt, np.asarray(stream[:-1], np.int32)])
    with torch.no_grad():
        logits = forward(params, seq[None], cfg, attn_fn=lambda q, k, v:
                         attention_reference(q, k, v, causal=True)[0])
        logits = logits[0, len(prompt) - 1:].float()
    n, V = logits.shape
    if kw.get("temperature", 0.0) > 0:
        masked, _ = samp.filter_dist(
            logits, np.full(n, kw["temperature"], np.float32),
            np.full(n, kw.get("top_k", 0), np.int64),
            np.full(n, kw.get("top_p", 1.0), np.float32))
        keys = samp.fold_keys(np.full(n, kw.get("seed", 0), np.uint32),
                              np.arange(len(prompt), len(prompt) + n),
                              samp.SALT_TARGET, logits.device)
        logits = masked + tf.gumbel(keys, V)
    top2 = logits.topk(2, dim=-1)
    return (top2.indices[:, 0].cpu().numpy(),
            (top2.values[:, 0] - top2.values[:, 1]).cpu().numpy())


def stream_agreement(params, cfg, reqs, want, got, margin):
    """Each fleet stream against the reference stream of the same
    request: equal, or parting first where the reference's decision
    margin is at most ``margin`` (a near-tie: an engine's products
    depend on its batch, so two schedules round differently); and the
    stream agrees with the plain forward wherever the forward's margin
    is wider than ``margin``. Returns per-stream records; raises on a
    stream that breaks either rule."""
    import numpy as np

    recs = []
    for (prompt, kw), w, g in zip(reqs, want, got):
        rec = {"prompt_len": int(len(prompt)), "sampled":
               kw.get("temperature", 0.0) > 0, "equal": g == w}
        if len(g) != len(w):
            raise AssertionError("stream length %d, reference %d"
                                 % (len(g), len(w)))
        if g != w:
            part = next(i for i, (a, b) in enumerate(zip(w, g)) if a != b)
            _, m_ref = _decisions(params, cfg, prompt, w, kw)
            rec.update(parted_at=part, margin_at_part=float(m_ref[part]))
        pred, m = _decisions(params, cfg, prompt, g, kw)
        wide = m > margin
        rec["wide_checked"] = int(wide.sum())
        rec["wide_mismatches"] = int(np.sum(wide & (pred != np.asarray(g))))
        recs.append(rec)
        if rec["wide_mismatches"] or rec.get("margin_at_part", 0.0) > margin:
            raise AssertionError("fleet stream breaks the agreement rule: "
                                 "%r" % rec)
    return recs


def _fp_all(params):
    from mxnet_tpu_torch.wsync import common as wc

    return {k: wc.fingerprint(v) for k, v in wc.flatten_params(params).items()}


def _http_get(port, path):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                    timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def fleet_processes(device, root, n_requests=12, new=60, timeout=180):
    """Leg B: two ``python -m mxnet_tpu_torch.serving.fleet.replica``
    processes at the demo size on ``device``, registered with a router in
    this process; the first is SIGKILLed while one of its streams is in
    flight, every stream completes byte-equal to the same seeded demo
    engine here, then the second is SIGTERMed: it drains, leaves the
    fleet and exits 0."""
    import signal

    import numpy as np

    from mxnet_tpu_torch.serving.fleet import Router
    from mxnet_tpu_torch.serving.fleet.replica import build_demo_engine

    t0 = time.perf_counter()
    router = Router(bind=("127.0.0.1", 0), health_interval=0.05)
    host, port = router.serve()
    env = dict(os.environ, PYTHONPATH=root)
    procs = {}
    try:
        for name in ("proc0", "proc1"):
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "mxnet_tpu_torch.serving.fleet.replica",
                 "--router", "%s:%d" % (host, port), "--name", name,
                 "--seed", str(FLEET_DEMO_SEED), "--device", str(device)],
                cwd=root, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        ref_eng = build_demo_engine(FLEET_DEMO_SEED, device)
        rng = np.random.RandomState(3)
        reqs = [(rng.randint(0, ref_eng.model_cfg.vocab_size,
                             (int(rng.randint(5, 21)),)).astype(np.int32),
                 {} if i % 3 else dict(temperature=0.9, seed=i))
                for i in range(n_requests)]
        want = _engine_streams(ref_eng, reqs, new)
        deadline = time.monotonic() + timeout
        while len(router._replicas) < 2:
            for name, p in procs.items():
                if p.poll() is not None:
                    raise AssertionError("replica %s exited %d: %s" % (
                        name, p.returncode, p.communicate()[1][-2000:]))
            if time.monotonic() > deadline:
                raise AssertionError("replicas never registered")
            time.sleep(0.05)
        up_s = time.perf_counter() - t0
        router.start()
        streams = [router.submit(p, max_new_tokens=new, **kw)
                   for p, kw in reqs]
        while True:   # a stream of proc0's with tokens, not finished
            with router._lock:
                live = [e for e in router._requests.values()
                        if e.replica == "proc0" and 0 < len(e.tokens) < new]
            if live:
                break
            if time.monotonic() > deadline:
                raise AssertionError("no stream in flight on proc0")
            time.sleep(0.0005)
        procs["proc0"].send_signal(signal.SIGKILL)
        killed_streamed = len(live[0].tokens)
        got = [s.result(timeout=timeout) for s in streams]
        rc0 = procs["proc0"].wait(timeout=60)
        stats = router.stats()
        procs["proc1"].send_signal(signal.SIGTERM)
        out1, err1 = procs["proc1"].communicate(timeout=120)
        rc1 = procs["proc1"].returncode
        left = router.stats()["left"]
    finally:
        router.close()
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    agree = stream_agreement(ref_eng.params, ref_eng.model_cfg, reqs, want,
                             got, FLEET_MARGIN[ref_eng.model_cfg.dtype])
    rec = {"leg": "B", "replica_processes": 2, "requests": n_requests,
           "max_new_tokens": new, "startup_s": up_s,
           "streams_equal": sum(r["equal"] for r in agree),
           "parted": [r for r in agree if not r["equal"]],
           "killed_stream_tokens_at_sigkill": killed_streamed,
           "proc0_rc": rc0, "proc1_rc": rc1, "evictions": stats["evictions"],
           "redelivered": stats["redelivered"], "left": left,
           "statuses": sorted({s.status for s in streams}),
           "seconds": time.perf_counter() - t0}
    log(dict(phase="fleet_processes", **rec))
    if rc0 != -signal.SIGKILL or rc1 != 0:
        raise AssertionError("replica exit codes %r, %r: %s"
                             % (rc0, rc1, err1[-2000:]))
    if stats["evictions"] != 1 or not stats["redelivered"] or left != 1:
        raise AssertionError("router saw %r, left %d" % (stats, left))
    if "fleet replica proc1 listening" not in out1:
        raise AssertionError("proc1 printed %r" % out1[-500:])
    return rec


def fleet_wsync(device, cfg, params, scfg, reqs, new, trainer_batch=4,
                trainer_seq=1024, swap_new=1024):
    """Leg C: version 1 from two steps of the LM trainer over the serving
    weights, published by a WeightPublisher on loopback; a serving engine
    built under MXNET_WSYNC=1 syncs it between steps while streams run.
    Its streams then equal a cold engine's on version 1, and after
    rollback_weights version 0's; a non-finite and a reshaped set are
    refused with the live fingerprints unchanged."""
    import threading

    import numpy as np
    import torch

    from mxnet_tpu_torch.models.transformer import loss_fn
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.parallel import ShardedTrainer
    from mxnet_tpu_torch.serving import Engine
    from mxnet_tpu_torch.wsync.publisher import WeightPublisher

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    trained = _tree_map(lambda t: t.detach().clone(), params)
    trainer = ShardedTrainer(loss_fn(cfg), trained,
                             lambda ps: torch.optim.Adam(ps, lr=1e-4))
    rng = np.random.RandomState(4)
    data = {"tokens": rng.randint(0, cfg.vocab_size,
                                  (trainer_batch, trainer_seq + 1))
            .astype(np.int32)}
    sync()
    fa.flash_attention.launches = 0
    fa.flash_bwd_dq.launches = 0
    fa.flash_bwd_dkv.launches = 0
    losses = [trainer.step(data).item() for _ in range(2)]
    sync()
    train_counts = {"flash_fwd": fa.flash_attention.launches,
                    "flash_bwd_dq": fa.flash_bwd_dq.launches,
                    "flash_bwd_dkv": fa.flash_bwd_dkv.launches}
    v1 = _tree_map(lambda t: t.detach(), trainer.params)
    del trainer
    pub = WeightPublisher(bind=("127.0.0.1", 0))
    host, port = pub.start()
    serving_k2 = 0
    try:
        with mock.patch.dict(os.environ, {
                "MXNET_WSYNC": "1",
                "MXNET_WSYNC_PUBLISHER": "%s:%d" % (host, port),
                "MXNET_WSYNC_POLL_WAIT": "0.2"}):
            eng = Engine(params, cfg, scfg, device=device)
        sub = eng._wsync_sub
        if sub is None:
            raise AssertionError("MXNET_WSYNC=1 started no subscriber")
        sync()
        fa.flash_attention.launches = 0
        # the compared runs are driven here, each on an idle engine, so
        # hot and cold engines batch them alike (a batch's products
        # round by its shape)
        v0_streams = _engine_streams(eng, reqs, new)
        eng.start()
        # streams that run across the swap: every token's arrival time
        arrivals = []
        bg = [eng.submit(np.arange(5 + i, dtype=np.int32) % cfg.vocab_size,
                         max_new_tokens=swap_new) for i in range(4)]

        def consume(h, out):
            for _ in h.tokens():
                out.append(time.monotonic())

        threads = []
        for h in bg:
            arrivals.append([])
            threads.append(threading.Thread(target=consume,
                                            args=(h, arrivals[-1])))
            threads[-1].start()
        while not all(len(a) >= 8 for a in arrivals):
            time.sleep(0.001)
        t_pub = time.perf_counter()
        pub.publish(v1)
        publish_s = time.perf_counter() - t_pub
        deadline = time.monotonic() + 300
        while eng.weight_version() != 1:
            if time.monotonic() > deadline:
                raise AssertionError("version 1 never landed: %r" % sub.last)
            time.sleep(0.001)
        sync_rec = dict(sub.last)
        t_swap = eng._sync_mark_until - eng._sync_ttft_window
        while not all(sum(1 for t in a if t > t_swap) >= 20
                      for a in arrivals):
            if any(len(a) >= swap_new for a in arrivals):
                raise AssertionError("a stream ended before the swap + 20 "
                                     "tokens: raise swap_new")
            time.sleep(0.001)
        for h in bg:
            h.cancel()
        for th in threads:
            th.join(timeout=60)
        eng.stop()
        eng.run_until_idle()
        gaps_across, gaps_other = [], []
        for a in arrivals:
            for x, y in zip(a, a[1:]):
                (gaps_across if x <= t_swap <= y else gaps_other).append(y - x)
        hot_v1 = _engine_streams(eng, reqs, new)
        fps_v1 = _fp_all(eng.params)
        # the gates: a non-finite set and a reshaped one, both refused
        refused = {}
        for version, what in ((2, "nonfinite"), (3, "reshaped")):
            bad = _tree_map(lambda t: t, v1)
            if what == "nonfinite":
                w1 = bad["layers"][-1]["w1"].clone()
                w1.view(-1)[w1.numel() // 2] = float("nan")
                bad["layers"][-1]["w1"] = w1
            else:
                bad["embed"] = bad["embed"][:-1]
            pub.publish(bad, version=version)
            deadline = time.monotonic() + 120
            while not any(a[0] == version for a in pub.acks()):
                if time.monotonic() > deadline:
                    raise AssertionError("no ack for version %d" % version)
                time.sleep(0.002)
            refused[what] = [a[2] for a in pub.acks() if a[0] == version][0]
        fps_after = _fp_all(eng.params)
        version_after = eng.weight_version()
        rollback = eng.rollback_weights()
        rolled = _engine_streams(eng, reqs, new)
        sync()
        serving_k2 += fa.flash_attention.launches
        sub.stop()
        del eng
        cold = Engine(v1, cfg, scfg, device=device)
        sync()
        fa.flash_attention.launches = 0
        cold_v1 = _engine_streams(cold, reqs, new)
        sync()
        serving_k2 += fa.flash_attention.launches
        del cold
    finally:
        pub.close()
    nbytes = sync_rec["bytes"]
    rec = {"leg": "C", "trainer_steps": 2, "trainer_batch": trainer_batch,
           "trainer_seq": trainer_seq, "losses": losses,
           "launches_training": train_counts, "publish_s": publish_s,
           "sync_s": sync_rec["secs"], "sync_tensors": sync_rec["fetched"],
           "sync_bytes": nbytes,
           "sync_gb_per_s": nbytes / sync_rec["secs"] / 1e9,
           "max_decode_gap_across_swap_ms": 1e3 * max(gaps_across),
           "decode_gaps_across_swap": len(gaps_across),
           "max_decode_gap_other_ms": 1e3 * max(gaps_other),
           "median_decode_gap_ms": 1e3 * float(np.median(gaps_other)),
           "refused": refused, "rollback": rollback,
           "fingerprints_unchanged": fps_after == fps_v1,
           "version_after_refusals": version_after,
           "hot_equals_cold_v1": hot_v1 == cold_v1,
           "rollback_equals_v0": rolled == v0_streams,
           "v1_changes_streams": hot_v1 != v0_streams,
           "launches_serving_k2": serving_k2,
           "seconds": time.perf_counter() - t0}
    log(dict(phase="fleet_wsync", **rec))
    if hot_v1 != cold_v1:
        raise AssertionError("hot-swapped streams differ from a cold engine "
                             "on version 1")
    if rolled != v0_streams:
        raise AssertionError("streams after rollback differ from version 0")
    if hot_v1 == v0_streams:
        raise AssertionError("version 1 did not change the streams")
    if not (all(v.startswith("rejected:") for v in refused.values())
            and fps_after == fps_v1 and version_after == 1):
        raise AssertionError("a bad set was not refused cleanly: %r"
                             % refused)
    if not gaps_across:
        raise AssertionError("no stream ran across the swap")
    return rec


def fleet_telemetry(device, cfg, params, scfg, reqs, new, steps_new=32):
    """Leg D: leg A's fleet (two replicas, one killed mid-decode) and a
    weight sync, run with MXNET_TELEMETRY=1, a journal and the HTTP
    server on a free port: /metrics holds TELEMETRY_CATALOG, /servingz
    the live request table, every journal line parses; the decode step
    time of one engine with telemetry off and on."""
    import tempfile

    import numpy as np
    import torch

    from mxnet_tpu_torch import telemetry as tel
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.serving import Engine
    from mxnet_tpu_torch.telemetry.export import _prom_name
    from mxnet_tpu_torch.wsync.publisher import WeightPublisher
    from mxnet_tpu_torch.wsync.subscriber import WeightSubscriber

    def step_ms(eng):
        hs = [eng.submit(np.arange(3 + i, 40 + i, dtype=np.int32)
                         % cfg.vocab_size, max_new_tokens=steps_new)
              for i in range(8)]
        eng.step()   # the prefill
        times = []
        while True:
            t = time.perf_counter()
            if not eng.step():
                break
            times.append(time.perf_counter() - t)
        for h in hs:
            h.result(timeout=60)
        return 1e3 * float(np.median(times)), len(times)

    t0 = time.perf_counter()
    timing = Engine(params, cfg, scfg, device=device)
    step_ms(timing)   # warm
    off_ms, n_steps = step_ms(timing)
    tmp = tempfile.mkdtemp(prefix="fleet_telemetry_")
    journal = os.path.join(tmp, "journal.jsonl")
    with mock.patch.dict(os.environ, {
            "MXNET_TELEMETRY": "1", "MXNET_TELEMETRY_JOURNAL": journal,
            "MXNET_TELEMETRY_HTTP": "127.0.0.1:0",
            "MXNET_WSYNC_TTFT_WINDOW": "30"}):
        tel.reset()
        tel.reload()
        try:
            port = tel.server.port()
            on_ms, _ = step_ms(timing)
            engines = [Engine(params, cfg, scfg, device=device)
                       for _ in range(2)]
            pub = WeightPublisher(bind=("127.0.0.1", 0))
            host, pport = pub.start()
            try:
                pub.publish(params)
                sub = WeightSubscriber(engines[0], "%s:%d" % (host, pport))
                if sub.sync_once(wait=60.0) != 1:
                    raise AssertionError("leg D's sync did not apply")
            finally:
                pub.close()
            router, reps = _fleet(engines)
            scraped = {}

            def kill(router, ent):
                code, body = _http_get(port, "/servingz")
                scraped["servingz"] = (code, json.loads(body))
                return _kill_replica(reps, engines)(router, ent)

            if device == "cuda":
                torch.cuda.synchronize()
            fa.flash_attention.launches = 0
            outs, killed = _fleet_serve(router, reqs, new, kill=kill)
            if device == "cuda":
                torch.cuda.synchronize()
            k2 = fa.flash_attention.launches
            engines[0].rollback_weights()
            code, metrics = _http_get(port, "/metrics")
            tel.flush(mark="exit")
            _close_fleet(router, reps, engines)
            del engines
        finally:
            tel.reset()
    tel.reload()   # the environment restored: telemetry off, no server
    lines = open(journal).read().splitlines()
    recs = [json.loads(line) for line in lines if line.strip()]
    missing = [n for n in TELEMETRY_CATALOG
               if not re.search(r"^%s(_bucket|_count|\{| )" % _prom_name(n),
                                metrics, re.M)]
    sz_code, sz = scraped["servingz"]
    table = [r for e in sz["engines"] for r in e["requests"]]
    rec = {"leg": "D", "metrics_status": code,
           "catalog": len(TELEMETRY_CATALOG), "catalog_missing": missing,
           "servingz_status": sz_code, "servingz_engines": len(sz["engines"]),
           "servingz_requests": len(table),
           "journal_lines": len(lines), "journal_kinds": sorted(
               {r["kind"] for r in recs}),
           "decode_step_ms_telemetry_off": off_ms,
           "decode_step_ms_telemetry_on": on_ms, "decode_steps": n_steps,
           "killed": killed, "launches_k2": k2,
           "seconds": time.perf_counter() - t0}
    log(dict(phase="fleet_telemetry", **rec))
    if code != 200 or missing:
        raise AssertionError("/metrics lacks %r" % missing)
    if sz_code != 200 or not table:
        raise AssertionError("/servingz showed no live request")
    if len(recs) != len(lines) or not {"meta", "span", "metrics",
                                       "wsync"} <= set(rec["journal_kinds"]):
        raise AssertionError("journal kinds %r" % rec["journal_kinds"])
    return dict(rec, outs=outs)


def phase_fleet(device="cuda", model_kw=FLAGSHIP, long_len=2048, new=48,
                cd_new=16, trainer_seq=1024, swap_new=1024):
    """The serving fleet on the card (``phase_fleet``): leg A, two
    flagship Engines behind ReplicaServers and a Router on loopback,
    byte-equal to a lone Engine, and again through a replica killed
    mid-decode; leg B, replica processes (``fleet_processes``); leg C,
    live weight sync (``fleet_wsync``); leg D, telemetry
    (``fleet_telemetry``). ``device``/``model_kw``/``long_len`` let a CPU
    rehearsal run the same code small. Returns the K2/K3/K4 counts."""
    import torch

    from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                    init_params)
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.parallel import create_mesh
    from mxnet_tpu_torch.serving import Engine, ServingConfig

    root = os.path.dirname(os.path.abspath(__file__))

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    cfg = TransformerConfig(**model_kw)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    mesh = create_mesh((1,), ("seq",), devices=[device])
    scfg = ServingConfig(mesh=mesh, cp_kind="ulysses", cp_min_tokens=long_len,
                         **FLEET_SERVING)
    reqs = _fleet_prompts(cfg.vocab_size, long_len)
    per_long = cfg.num_layers if device == "cuda" else 0
    # predicted K2 launches (one long prompt a run, once a layer): leg A 1
    # + 2 (the killed replica's prefill and the survivor's redelivery);
    # leg C 2 training steps + 4 serving runs; leg D 2 (a kill)
    predicted = {"fleet_in_process": 3 * per_long,
                 "fleet_wsync_training": 2 * per_long,
                 "fleet_wsync_serving": 4 * per_long,
                 "fleet_telemetry": 2 * per_long}

    # -- leg A ---------------------------------------------------------
    lone = Engine(params, cfg, scfg, device=device)
    want = _engine_streams(lone, reqs, new)
    del lone
    engines = [Engine(params, cfg, scfg, device=device) for _ in range(2)]
    router, reps = _fleet(engines)
    try:
        sync()
        fa.flash_attention.launches = 0
        ta = time.perf_counter()
        round1, _ = _fleet_serve(router, reqs, new)
        round1_s = time.perf_counter() - ta
        ta = time.perf_counter()
        round2, killed = _fleet_serve(router, reqs, new,
                                      kill=_kill_replica(reps, engines))
        round2_s = time.perf_counter() - ta
        sync()
        k2_a = fa.flash_attention.launches
        stats = router.stats()
    finally:
        _close_fleet(router, reps, engines)
    del engines
    margin = FLEET_MARGIN[cfg.dtype]
    agree1 = stream_agreement(params, cfg, reqs, want, round1, margin)
    agree2 = stream_agreement(params, cfg, reqs, want, round2, margin)
    rec_a = {"leg": "A", "requests": len(reqs), "max_new_tokens": new,
             "round_s": round1_s, "round_kill_s": round2_s,
             "streams_equal": sum(r["equal"] for r in agree1),
             "streams_equal_after_kill": sum(r["equal"] for r in agree2),
             "parted": [r for r in agree1 + agree2 if not r["equal"]],
             "wide_checked": sum(r["wide_checked"]
                                 for r in agree1 + agree2),
             "killed": killed,
             "evictions": stats["evictions"],
             "redelivered": stats["redelivered"], "launches_k2": k2_a,
             "launches_k2_predicted": predicted["fleet_in_process"]}
    log(dict(phase="fleet_in_process", **rec_a))
    if killed["unfinished_on_replica"] < 1:
        raise AssertionError("the kill found nothing in flight: %r" % killed)
    if stats["evictions"] != 1 or stats["redelivered"] < 1:
        raise AssertionError("router saw %r" % stats)
    if k2_a != predicted["fleet_in_process"]:
        raise AssertionError("K2 launched %d times in leg A, predicted %d"
                             % (k2_a, predicted["fleet_in_process"]))
    if device == "cuda":
        torch.cuda.empty_cache()

    rec_b = fleet_processes(device, root)
    c_reqs = [reqs[0], reqs[1], reqs[2], reqs[6]]
    rec_c = fleet_wsync(device, cfg, params, scfg, c_reqs, cd_new,
                        trainer_seq=trainer_seq, swap_new=swap_new)
    if device == "cuda":
        torch.cuda.empty_cache()
    rec_d = fleet_telemetry(device, cfg, params, scfg, reqs, new)
    agree_d = stream_agreement(params, cfg, reqs, want, rec_d.pop("outs"),
                               FLEET_MARGIN[cfg.dtype])
    log({"phase": "fleet_telemetry_streams",
         "streams_equal": sum(r["equal"] for r in agree_d),
         "parted": [r for r in agree_d if not r["equal"]]})
    got = {"fleet_in_process": k2_a,
           "fleet_wsync_training": rec_c["launches_training"]["flash_fwd"],
           "fleet_wsync_serving": rec_c["launches_serving_k2"],
           "fleet_telemetry": rec_d["launches_k2"]}
    if got != predicted:
        raise AssertionError("K2 launches %r, predicted %r"
                             % (got, predicted))
    for k in ("flash_bwd_dq", "flash_bwd_dkv"):
        if rec_c["launches_training"][k] != 2 * per_long:
            raise AssertionError("%s launched %d times in leg C"
                                 % (k, rec_c["launches_training"][k]))
    out = {"k2": got, "k3": rec_c["launches_training"]["flash_bwd_dq"],
           "k4": rec_c["launches_training"]["flash_bwd_dkv"],
           "seconds": time.perf_counter() - t0}
    log(dict(phase="fleet", **out))
    return out


# the training guardian and mxprof: legs A-D. ResNet-50 at
# bench.py's configuration (batch 128, 224^2, bf16, the s2d stem) through
# the scanned FeedForward.fit, K = GUARD_SCAN_K
GUARD_SCAN_K = 4
GUARD_BATCHES = 8        # an epoch; A(i) and leg C run 2 epochs
# leg A(ii): one grad.nan (step 3) and one loss.spike (step 8, the last)
# over 8 steps with MXNET_GUARDIAN_WARMUP=4 (the spike is the 7th
# loss.spike draw: grad.nan's fire skips that step's)
GUARD_SPEC_II = "grad.nan:error:skip=2:count=1;loss.spike:error:skip=6:count=1"
GUARD_PREDICTED_II = {"nonfinite_steps": 1, "skipped_steps": 1,
                      "anomaly_steps": 1, "rollbacks": 0, "steps": 8}
# leg A(iii): MXNET_GUARDIAN_MAX_SKIPS (3) consecutive poisoned steps,
# 5-7 of 8: the rollback to the ring's one snapshot (step 0)
GUARD_SPEC_III = "grad.nan:error:skip=4:count=3"
GUARD_PREDICTED_III = {"nonfinite_steps": 3, "skipped_steps": 3,
                       "anomaly_steps": 0, "rollbacks": 1}
GUARD_ENV = ("MXNET_GUARDIAN", "MXNET_GUARDIAN_WARMUP",
             "MXNET_GUARDIAN_MAX_SKIPS", "MXNET_GUARDIAN_SNAPSHOT_STEPS",
             "MXNET_GUARDIAN_GRADNORM_MAX", "MXNET_GUARDIAN_FF_BATCHES",
             "MXNET_FAULT_SPEC", "MXNET_SCAN_TRAIN", "MXNET_TRAIN_SCAN_K",
             "MXNET_COMPUTE_DTYPE", "MXNET_PROF", "MXNET_TELEMETRY",
             "MXNET_TELEMETRY_JOURNAL", "MXNET_TELEMETRY_HTTP")


def _host_params(params):
    return {k: v._data.detach().to("cpu", copy=True)
            for k, v in params.items()}


def _bench_fit(device, x, y, batch, image, classes, epochs, env,
               spec=None, on_trainer=None):
    """One ``FeedForward(get_resnet(classes, 50, stem="s2d"),
    compute_dtype="bfloat16").fit`` from seed 0 over ``x``/``y`` with the
    scanned trainer, under ``env``; ``spec`` arms the fault points.
    Returns (arg_params on the host, epoch seconds, the guardian or
    None, K1 launches, the trainer)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import softmax as sm
    from mxnet_tpu_torch.parallel import fit_trainer
    from mxnet_tpu_torch.resilience import faults, guardian

    guards, trainers = [], []
    real_make, real_create = (fit_trainer.make_fit_trainer,
                              guardian.TrainingGuardian.create)

    def make(*a, **kw):
        trainers.append(real_make(*a, **kw))
        if on_trainer is not None:
            on_trainer(trainers[-1])
        return trainers[-1]

    def create(cls, *a, **kw):
        guards.append(real_create.__func__(cls, *a, **kw))
        return guards[-1]

    fit_trainer.make_fit_trainer = make
    guardian.TrainingGuardian.create = classmethod(create)
    faults.clear()
    try:
        with mock.patch.dict(os.environ):
            for k in GUARD_ENV:
                os.environ.pop(k, None)
            os.environ["MXNET_TRAIN_SCAN_K"] = str(GUARD_SCAN_K)
            os.environ.update(env)
            if spec:
                faults.inject(spec)
            mx.random.seed(0)
            model = mx.FeedForward(
                mx.models.get_resnet(classes, 50, stem="s2d", image=image),
                ctx=_ctx(device), num_epoch=epochs, learning_rate=0.05,
                momentum=0.9, compute_dtype="bfloat16")
            stamps = []

            def on_epoch(*_):
                _sync(device)
                stamps.append(time.perf_counter())

            _sync(device)
            sm.fused_softmax.launches = 0
            t0 = time.perf_counter()
            model.fit(X=mx.io.NDArrayIter(x, y, batch_size=batch),
                      eval_metric="acc", epoch_end_callback=on_epoch)
            _sync(device)
            launches = sm.fused_softmax.launches
    finally:
        faults.clear()
        fit_trainer.make_fit_trainer = real_make
        guardian.TrainingGuardian.create = real_create
    if len(trainers) != 1:
        raise AssertionError("the fit built %d scanned trainers"
                             % len(trainers))
    epoch_s = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    return (_host_params(model.arg_params), epoch_s, guards[0], launches,
            trainers[0])


def _chunk_ms(device, guard, x, y, batch, image, classes, reps=3):
    """The sentinel's cost where it runs: one ``FitTrainer`` (bench
    configuration, K = GUARD_SCAN_K) with ``MXNET_GUARDIAN`` = ``guard``,
    a chunk staged on the device once, two warm ``run_chunk`` calls,
    then ``reps`` timed: ms a step to return (dispatch) and to the
    card's end."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import fit_trainer

    K = GUARD_SCAN_K
    sym = mx.models.get_resnet(classes, 50, stem="s2d", image=image)
    shapes = {"data": (batch, 3, image, image), "softmax_label": (batch,)}
    with mock.patch.dict(os.environ, MXNET_GUARDIAN=guard):
        mx.random.seed(0)
        exe = sym.simple_bind(_ctx(device), grad_req="null", **shapes)
        init = mx.initializer.Xavier()
        args = {}
        for n, a in exe.arg_dict.items():
            if n not in shapes:
                init(n, a)
                args[n] = a
        opt = mx.optimizer.create("sgd", learning_rate=0.05, momentum=0.9,
                                  rescale_grad=1.0 / batch)
        tr = fit_trainer.make_fit_trainer(
            sym, _ctx(device), shapes, opt, args, dict(exe.aux_dict),
            sorted(args), compute_dtype="bfloat16")
    staged = tr.stage_chunk([{"data": x[i * batch:(i + 1) * batch],
                              "softmax_label": y[i * batch:(i + 1) * batch]}
                             for i in range(K)])
    for _ in range(2):
        tr.run_chunk(staged)
        _sync(device)
    out = []
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        tr.run_chunk(staged)
        t1 = time.perf_counter()
        _sync(device)
        out.append([1e3 * (t1 - t0) / K, 1e3 * (time.perf_counter() - t0) / K])
    del tr, exe
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def _guard_counts(g):
    return {"nonfinite_steps": g.nonfinite_steps,
            "skipped_steps": g.skipped_steps,
            "anomaly_steps": g.anomaly_steps, "rollbacks": g.rollbacks,
            "steps": g.step}


def guardian_scanned(device="cuda", batch=128, image=224, classes=1000,
                     n_batches=GUARD_BATCHES):
    """Leg A: the guarded scanned fit. (i) clean: 2 epochs unguarded,
    guarded, guarded, unguarded from seed 0, bit-equal weights, ms a step
    of epoch 2 each; then the sentinel's cost in ``run_chunk`` alone
    (:func:`_chunk_ms`, off, on, on, off); (ii) ``GUARD_SPEC_II``: the counters
    equal ``GUARD_PREDICTED_II``, every weight finite; (iii)
    ``GUARD_SPEC_III``: ``GUARD_PREDICTED_III``, and the trainer's state
    right after the rollback bit-equal to the ring snapshot it
    restored (parameters, optimizer states, aux)."""
    import math

    import torch

    x, y = _resnet_inputs(batch, image, classes, n_batches, seed=0)
    rec = {"leg": "A", "batch": batch, "image": image, "classes": classes,
           "stem": "s2d", "compute_dtype": "bfloat16", "K": GUARD_SCAN_K,
           "batches_an_epoch": n_batches}
    runs = {"off": [], "on": []}
    l_i = 0
    for turn in ("off", "on", "on", "off"):
        w, ep, g, k1, _ = _bench_fit(
            device, x, y, batch, image, classes, 2,
            {"MXNET_GUARDIAN": "1"} if turn == "on" else {})
        runs[turn].append((w, ep, g))
        l_i += k1
    plain = runs["off"][0][0]
    guarded, g1 = runs["on"][0][0], runs["on"][0][2]
    unequal = sorted(k for k in plain if not torch.equal(plain[k],
                                                         guarded[k]))
    unequal += sorted(k for w, _, _ in runs["off"][1:] + runs["on"][1:]
                      for k in plain if not torch.equal(plain[k], w[k]))
    step_ms = {t: [1e3 * r[1][-1] / n_batches for r in runs[t]]
               for t in runs}
    chunk = {"off": [], "on": []}
    for turn in ("off", "on", "on", "off"):
        chunk[turn] += _chunk_ms(device, "1" if turn == "on" else "0", x, y,
                                 batch, image, classes)
    rec["i"] = {"bit_equal": not unequal, "unequal": unequal[:8],
                "counters": _guard_counts(g1),
                "guardian_off": all(r[2] is None for r in runs["off"]),
                "fit_step_ms_epoch2": step_ms,
                "fit_sentinel_ms_a_step": (sum(step_ms["on"])
                                           - sum(step_ms["off"])) / 2,
                "chunk_ms_a_step_dispatch_end": chunk,
                "chunk_sentinel_ms_a_step": (
                    sum(r[1] for r in chunk["on"])
                    - sum(r[1] for r in chunk["off"])) / len(chunk["on"]),
                "step_ms_epoch2_off": sum(step_ms["off"]) / 2}

    w, _, g2, l_ii, _ = _bench_fit(
        device, x, y, batch, image, classes, 1,
        {"MXNET_GUARDIAN": "1", "MXNET_GUARDIAN_WARMUP": "4"},
        spec=GUARD_SPEC_II)
    nonfinite = sorted(k for k, v in w.items()
                       if not torch.isfinite(v.float()).all())
    rec["ii"] = {"spec": GUARD_SPEC_II, "counters": _guard_counts(g2),
                 "predicted": GUARD_PREDICTED_II, "nonfinite": nonfinite}

    restored = []

    def on_trainer(tr):
        real = tr.restore_state

        def restore_state(snap):
            real(snap)
            host = tr.snapshot_state()
            same = all(torch.equal(host["params"][k], v)
                       for k, v in snap["params"].items())
            same = same and all(torch.equal(a, b) for a, b in
                                zip(host["aux"], snap["aux"]))
            same = same and all(torch.equal(a, b) for sa, sb in
                                zip(host["opt_states"], snap["opt_states"])
                                for a, b in zip(sa, sb))
            restored.append(same)

        tr.restore_state = restore_state

    w3, _, g3, l_iii, _ = _bench_fit(
        device, x, y, batch, image, classes, 1, {"MXNET_GUARDIAN": "1"},
        spec=GUARD_SPEC_III, on_trainer=on_trainer)
    rec["iii"] = {"spec": GUARD_SPEC_III, "counters": _guard_counts(g3),
                  "predicted": GUARD_PREDICTED_III,
                  "restored_bit_equal": restored,
                  "finite": all(torch.isfinite(v.float()).all().item()
                                for v in w3.values())}
    rec["softmax_launches"] = l_i + l_ii + l_iii
    log(dict(phase="guardian_scanned", **rec))
    if unequal:
        raise AssertionError("leg A(i): the guarded fit's weights differ "
                             "from the unguarded fit's: %s" % unequal[:8])
    if not rec["i"]["guardian_off"] \
            or rec["i"]["counters"]["skipped_steps"] \
            or rec["i"]["counters"]["anomaly_steps"] \
            or rec["i"]["counters"]["steps"] != 2 * n_batches:
        raise AssertionError("leg A(i) counters: %r" % rec["i"])
    got = {k: rec["ii"]["counters"][k] for k in GUARD_PREDICTED_II}
    if got != GUARD_PREDICTED_II or nonfinite:
        raise AssertionError("leg A(ii): counters %r, predicted %r; "
                             "non-finite %r" % (got, GUARD_PREDICTED_II,
                                                nonfinite))
    got = {k: rec["iii"]["counters"][k] for k in GUARD_PREDICTED_III}
    if got != GUARD_PREDICTED_III or restored != [True] \
            or not rec["iii"]["finite"]:
        raise AssertionError("leg A(iii): counters %r (predicted %r), "
                             "restored bit-equal %r" % (
                                 got, GUARD_PREDICTED_III, restored))
    expected = (8 * n_batches + 2 * n_batches) if device == "cuda" else 0
    if rec["softmax_launches"] != expected:
        raise AssertionError("leg A launched K1 %d times, expected %d"
                             % (rec["softmax_launches"], expected))
    if not all(math.isfinite(v) for t in step_ms.values() for v in t):
        raise AssertionError("leg A(i) timing: %r" % rec["i"])
    return rec


def guardian_per_batch(device="cuda", batch=128, image=224, classes=1000,
                       steps=3):
    """Leg B: the same model (f32: the per-batch loop trains in the
    parameters' dtype) through ``Module.fit`` with ``MXNET_SCAN_TRAIN=0``
    and ``MXNET_GUARDIAN=1``: K1 through the executor once a step; every
    parameter update of step 2 draws ``grad.nan`` (one draw an update),
    and its weights and momenta after it are bit-equal to step 1's."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import softmax as sm
    from mxnet_tpu_torch.resilience import faults

    sym = mx.models.get_resnet(classes, 50, stem="s2d", image=image)
    n_params = len([a for a in sym.list_arguments()
                    if a not in ("data", "softmax_label")])
    spec = "grad.nan:error:skip=%d:count=%d" % (n_params, n_params)
    x, y = _resnet_inputs(batch, image, classes, steps, seed=1)
    after, moms = [], []
    with mock.patch.dict(os.environ):
        for k in GUARD_ENV:
            os.environ.pop(k, None)
        os.environ.update(MXNET_SCAN_TRAIN="0", MXNET_GUARDIAN="1")
        faults.clear()
        faults.inject(spec)
        try:
            mx.random.seed(0)
            mod = mx.module.Module(sym, context=_ctx(device))

            def on_batch(param):
                args, _ = mod.get_params()
                after.append(_host_params(args))
                moms.append({i: s._data.detach().to("cpu", copy=True)
                             for i, s in mod._updater.states.items()})

            _sync(device)
            sm.fused_softmax.launches = 0
            t0 = time.perf_counter()
            mod.fit(mx.io.NDArrayIter(x, y, batch_size=batch),
                    num_epoch=1, eval_metric="acc",
                    batch_end_callback=on_batch,
                    optimizer_params={"learning_rate": 0.05,
                                      "momentum": 0.9})
            _sync(device)
            wall = time.perf_counter() - t0
            launches = sm.fused_softmax.launches
        finally:
            faults.clear()
    moved = sorted(k for k in after[0]
                   if not torch.equal(after[0][k], after[1][k]))
    mom_moved = sorted(i for i in moms[0]
                       if not torch.equal(moms[0][i], moms[1][i]))
    changed3 = sum(not torch.equal(after[1][k], after[2][k])
                   for k in after[1])
    rec = {"leg": "B", "batch": batch, "image": image, "steps": steps,
           "params": n_params, "spec": spec, "wall_s": wall,
           "step2_params_moved": moved[:8], "step2_momenta_moved":
           mom_moved[:8], "step3_params_changed": changed3,
           "softmax_launches": launches}
    log(dict(phase="guardian_per_batch", **rec))
    if moved or mom_moved:
        raise AssertionError("leg B: step 2's poisoned update landed on "
                             "%r / momenta %r" % (moved[:8], mom_moved[:8]))
    if not changed3:
        raise AssertionError("leg B: step 3 did not update")
    if launches != (steps if device == "cuda" else 0):
        raise AssertionError("leg B launched K1 %d times, expected %d"
                             % (launches, steps))
    return rec


def phase_guardian(device="cuda", **kw):
    """Legs A and B (the guardian on the scanned and per-batch fits)."""
    return {"A": guardian_scanned(device, **kw),
            "B": guardian_per_batch(device, **{
                k: v for k, v in kw.items() if k != "n_batches"})}


def phase_mxprof(device="cuda", model_kw=FLAGSHIP, long_len=2048, new=16,
                 batch=128, image=224, classes=1000,
                 n_batches=GUARD_BATCHES, fit_off=None):
    """Leg C: MXNET_PROF=1 and MXNET_TELEMETRY=1 with the HTTP server
    and a journal. The flagship serving Engine (phase_serving's: two
    ``long_len`` prompts through the Ulysses cp prefill, K2 once a layer
    each, and two short ones) serves its prompts with prof off and then
    on (the first prof-on pass attributes each bucket's program, the
    second is timed and counted); then leg A's unguarded bench fit for 2
    epochs with prof on.
    ``/profilez`` must hold the ``serve.decode``, ``serve.prefill`` and
    ``train.scanned`` step breakdowns, every program its analytic FLOPs,
    and a derived MFU; ``tools/torch_telemetry_report.py`` renders the
    journal (exit 0, the profiling section). mxprof's cost, telemetry on
    throughout: the median decode step of 8 short requests with prof
    off, on, on, off; the fit's ms a step against ``fit_off`` (leg
    A(i)'s unguarded epoch 2)."""
    import tempfile

    import numpy as np
    import torch

    from mxnet_tpu_torch import telemetry as tel
    from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                    init_params)
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.parallel import create_mesh
    from mxnet_tpu_torch.serving import Engine, ServingConfig

    cfg = TransformerConfig(**model_kw)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    mesh = create_mesh((1,), ("seq",), devices=[device])
    scfg = ServingConfig(mesh=mesh, cp_kind="ulysses",
                         cp_min_tokens=long_len, block_size=16,
                         num_blocks=512, max_batch=8, prefill_chunk=64)
    eng = Engine(params, cfg, scfg, device=device)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (long_len, long_len, 5, 37)]

    def serve():
        _sync(device)
        t = time.perf_counter()
        outs = eng.generate(prompts, max_new_tokens=new)
        _sync(device)
        return sum(len(s) for s in outs) / (time.perf_counter() - t)

    def decode_ms(steps_new=32):
        hs = [eng.submit(np.arange(3 + i, 40 + i, dtype=np.int32)
                         % cfg.vocab_size, max_new_tokens=steps_new)
              for i in range(8)]
        eng.step()   # the prefill
        times = []
        while True:
            t = time.perf_counter()
            if not eng.step():
                break
            times.append(time.perf_counter() - t)
        for h in hs:
            h.result(timeout=60)
        return 1e3 * float(np.median(times))

    def prof_switch(on):
        if on:
            os.environ["MXNET_PROF"] = "1"
        else:
            os.environ.pop("MXNET_PROF", None)
        tel.prof.reload()

    serve()                      # warm
    decode_ms()
    tps_off = serve()
    tmp = tempfile.mkdtemp(prefix="mxprof_")
    journal = os.path.join(tmp, "journal.jsonl")
    x, y = _resnet_inputs(batch, image, classes, n_batches, seed=0)
    env = {"MXNET_PROF": "1", "MXNET_TELEMETRY": "1",
           "MXNET_TELEMETRY_JOURNAL": journal,
           "MXNET_TELEMETRY_HTTP": "127.0.0.1:0"}
    with mock.patch.dict(os.environ, env):
        tel.reset()
        tel.reload()
        try:
            port = tel.server.port()
            decode = {}
            prof_switch(False)
            decode["off_1"] = decode_ms()
            prof_switch(True)
            serve()     # each bucket's first step is attributed, not timed
            decode_ms()
            decode["on_1"] = decode_ms()
            _sync(device)
            fa.flash_attention.launches = 0
            tps_on = serve()
            k2 = fa.flash_attention.launches
            decode["on_2"] = decode_ms()
            prof_switch(False)
            decode["off_2"] = decode_ms()
            prof_switch(True)
            _, fit_s, _, k1, _ = _bench_fit(device, x, y, batch, image,
                                            classes, 2, env)
            code, body = _http_get(port, "/profilez")
            tel.flush(mark="exit")
        finally:
            tel.reset()
    tel.reload()    # the environment restored: prof and telemetry off
    del eng
    prof = json.loads(body)
    steps = prof["steps"]
    report = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tools", "torch_telemetry_report.py"),
         journal], capture_output=True, text=True, timeout=120)
    rec = {"leg": "C", "profilez_status": code,
           "paths": {p: {k: s[k] for k in ("count", "batches", "total_s",
                                            "phase_share", "bound",
                                            "bound_votes")}
                     for p, s in steps.items()},
           "programs": [{k: r.get(k) for k in ("site", "flops", "calls",
                                               "device_secs", "memory")}
                        for r in prof["programs"]],
           "derived": prof["derived"], "hbm": prof["hbm"],
           "config_key": prof["config_key"],
           "serve_tokens_per_s_telemetry_prof_off": tps_off,
           "serve_tokens_per_s_telemetry_prof_on": tps_on,
           "decode_step_ms_telemetry_on": decode,
           "fit_step_ms_epoch2_prof_on": 1e3 * fit_s[-1] / n_batches,
           "fit_step_ms_epoch2_prof_off": fit_off,
           "report_rc": report.returncode,
           "report_profiling": "-- profiling (mxprof) --" in report.stdout,
           "report_tail": report.stdout.split(
               "-- profiling (mxprof) --")[-1][:1500],
           "launches_k1": k1, "launches_k2": k2}
    log(dict(phase="mxprof", **rec))
    need = {"serve.decode", "serve.prefill", "train.scanned"}
    if code != 200 or not need <= set(steps):
        raise AssertionError("/profilez %d lacks %r" % (
            code, sorted(need - set(steps))))
    if not prof["programs"] or not all(
            (r.get("flops") or 0) > 0 for r in prof["programs"]):
        raise AssertionError("a program without analytic flops: %r"
                             % rec["programs"])
    if not prof["derived"].get("mfu"):
        raise AssertionError("no derived MFU: %r" % prof["derived"])
    if report.returncode != 0 or not rec["report_profiling"] \
            or "train.scanned" not in rec["report_tail"]:
        raise AssertionError("torch_telemetry_report: rc %d\n%s\n%s" % (
            report.returncode, report.stdout[-2000:], report.stderr[-2000:]))
    if device == "cuda" and (k2 != 2 * cfg.num_layers
                             or k1 != 2 * n_batches):
        raise AssertionError("leg C launched K2 %d times (expected %d), "
                             "K1 %d (expected %d)" % (
                                 k2, 2 * cfg.num_layers, k1, 2 * n_batches))
    return rec


def vote_worker(ctx, out_dir):
    """One rank of leg D (its record written to ``out_dir/<rank>.json``): a ``dist_sync`` store and a TrainingGuardian
    over it; four guarded steps whose gradient is NaN on rank 1 at step
    1 and on rank 0 at step 2. Both ranks must skip steps 1 and 2 (the
    vote is one all-reduce of the flag) and update at 0 and 3."""
    import numpy as np

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.resilience.guardian import TrainingGuardian

    kv = mx.kvstore.create("dist_sync")
    rank = kv.rank
    dev = mx.gpu(0) if ctx == "gpu" else mx.cpu()
    guard = TrainingGuardian(kvstore=kv)
    updated, t0 = [], time.perf_counter()
    for s in range(4):
        g = np.full((1024, 1024), 0.01, np.float32)
        if (s, rank) in ((1, 1), (2, 0)):
            g[5, 5] = np.nan
        grad = mx.nd.array(g, ctx=dev)
        guard.guard_batch(lambda s=s: updated.append(s),
                          grad_arrays_fn=lambda grad=grad: [grad])
    with open(os.path.join(out_dir, "%d.json" % rank), "w") as f:
        json.dump({"rank": rank, "world": kv.num_workers,
                   "updated": updated, "skipped_steps": guard.skipped_steps,
                   "nonfinite_steps": guard.nonfinite_steps,
                   "backend": mx.kvstore.backend(),
                   "ms_a_step": 1e3 * (time.perf_counter() - t0) / 4}, f)


def phase_guardian_vote(device="cuda", workers=2):
    """Leg D: :func:`vote_worker` on two gloo ranks through
    ``tools/torch_launch.py`` on the one card (as ``phase_dist`` runs its
    ranks): every rank updates at steps 0 and 3 only, skips 2 steps and
    counts its own non-finite step."""
    import tempfile

    ctx = "gpu" if device == "cuda" else "cpu"
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = tempfile.mkdtemp(prefix="guardian_vote_")
    cmd = [sys.executable, "-c",
           "import chip_smoke; chip_smoke.vote_worker(%r, %r)"
           % (ctx, out_dir)]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "tools", "torch_launch.py"),
         "-n", str(workers), "--timeout", str(DIST_TIMEOUT - 30), "--"]
        + cmd, cwd=root, capture_output=True, text=True,
        timeout=DIST_TIMEOUT)
    if proc.returncode != 0:
        raise AssertionError("the vote ranks exited %d:\n%s\n%s" % (
            proc.returncode, proc.stdout[-4000:], proc.stderr[-4000:]))
    votes = []
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name)) as f:
            votes.append(json.load(f))
    rec = {"leg": "D", "workers": workers, "ranks": votes,
           "wall_s": time.perf_counter() - t0}
    log(dict(phase="guardian_vote", **rec))
    if sorted(v["rank"] for v in votes) != list(range(workers)) or any(
            v["updated"] != [0, 3] or v["skipped_steps"] != 2
            or v["nonfinite_steps"] != 1 or v["world"] != workers
            for v in votes):
        raise AssertionError("leg D: %r" % votes)
    return rec


# -- the compile layer and the compile/transfer verifier (phase_compile) -------
COMPILE_STEPS = 8          # leg A: steps a loop, timed and compared
# leg A: each step's mean cross-entropy from the same state, rewritten
# against unrewritten: within max(ATOL, RTOL x the loss) nats
COMPILE_LOSS_ATOL = 0.05
COMPILE_LOSS_RTOL = 0.02
# leg A: the JAX package's pass report on bench.py's ResNet-50 graph
# (tests/test_torch_compile.py holds the port's equal to it on the CPU)
COMPILE_RESNET50_REPORT = {"fold": 0, "layout": 53, "fuse": 16,
                           "precision": 0}
COMPILE_PREDICT_TOL = 1e-3  # leg C: all passes against the unfolded batch
COMPILE_CACHE_BODY = "mul_add"
COMPILE_ENV = ("MXNET_COMPILE_OPT", "MXNET_COMPILE_PASSES",
               "MXNET_COMPILE_CACHE_DIR", "MXNET_COMPILE_TUNE",
               "MXNET_COMPILE_VERIFY", "MXNET_COMPILE_MATMUL_PREC",
               "MXNET_JIT_VERIFY")

# the layer kind of a kernel in leg A's profile: the nearest ``mx::<op>``
# range (forward) or autograd node (backward)
COMPILE_KIND_FWD = {
    "Convolution": "convolution", "_mxc_conv_nhwc": "convolution",
    "BatchNorm": "batchnorm", "_mxc_bn_nhwc": "batchnorm",
    "Pooling": "pooling", "_mxc_pool_nhwc": "pooling",
    "_mxc_to_nhwc": "layout_transpose", "_mxc_to_nchw": "layout_transpose",
    "Activation": "elementwise", "_plus": "elementwise",
    "FullyConnected": "fully_connected", "SoftmaxOutput": "softmax_output",
    "transpose": "s2d_stem", "Reshape": "s2d_stem", "Pad": "s2d_stem"}
COMPILE_KIND_BWD = (("Convolution", "convolution"),
                    ("BNTrainNorm", "batchnorm"), ("Pool", "pooling"),
                    ("Relu", "elementwise"), ("Add", "elementwise"),
                    ("Threshold", "elementwise"), ("Permute", "layout"),
                    ("Clone", "layout"), ("SoftmaxOutput", "softmax_output"),
                    ("Mm", "fully_connected"), ("Addmm", "fully_connected"))


class _Env:
    """Set environment variables for a block and restore them after,
    re-reading the compile layer's and the verifier's switches."""

    def __init__(self, **env):
        self.env = env

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in COMPILE_ENV}
        for k in COMPILE_ENV:
            os.environ.pop(k, None)
        os.environ.update(self.env)
        _compile_reload()
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        _compile_reload()


def _compile_reload():
    from mxnet_tpu_torch import compile as mxc
    from mxnet_tpu_torch.analysis import compile_verify as cv

    mxc.reload()
    cv.reload()


def _compile_kind(event, kernel):
    if "softmax_narrow" in kernel or "softmax_wide" in kernel:
        return "softmax_kernel_K1"
    e = event
    while e is not None:
        name = e.name
        if name.startswith("mx::"):
            return COMPILE_KIND_FWD.get(name[4:], "other") + "_fwd"
        if name.startswith("autograd::engine::evaluate_function: "):
            fn = name.split(": ", 1)[1]
            for tag, kind in COMPILE_KIND_BWD:
                if tag in fn:
                    return kind + "_bwd"
            return "other_bwd"
        if name.startswith("Optimizer.") or name.startswith("aten::_foreach"):
            return "sgd_update"
        e = e.cpu_parent
    return "other"


def _step_profile(step, state, batch, key):
    """One training step under ``torch.profiler`` with every op's forward
    in an ``mx::<op>`` range: device ms by layer kind, the convolution
    kernels' names by device ms, and the kernels' count."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from mxnet_tpu_torch.ops import registry

    apply = registry.OpDef.apply

    def labelled(self, *a, **k):
        with record_function("mx::" + self.name):
            return apply(self, *a, **k)

    registry.OpDef.apply = labelled
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(state, batch, key)
            torch.cuda.synchronize()
    finally:
        registry.OpDef.apply = apply
    by, conv, n = {}, {}, 0
    for e in prof.events():
        for k in getattr(e, "kernels", ()):
            kind = _compile_kind(e, k.name)
            ms = k.duration / 1e3
            by[kind] = by.get(kind, 0.0) + ms
            n += 1
            if kind.startswith("convolution"):
                conv[k.name] = conv.get(k.name, 0.0) + ms
    top = sorted(conv.items(), key=lambda kv: -kv[1])[:6]
    return {"device_ms_by_kind": dict(sorted(by.items(),
                                             key=lambda kv: -kv[1])),
            "device_ms": sum(by.values()), "kernels": n,
            "conv_kernels_top": [[name[:160], ms] for name, ms in top]}


def _loop_timed(step, state, batches, key, device):
    """One ``step.loop`` over ``batches``: (state, outs, ms a step by CUDA
    events around it, peak allocated GB during it)."""
    import torch

    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
    else:
        w0 = time.perf_counter()
    state, outs = step.loop(state, batches, key)
    k = next(iter(batches.values())).shape[0]
    if device == "cuda":
        t1.record()
        t1.synchronize()
        return (state, outs, t0.elapsed_time(t1) / k,
                torch.cuda.max_memory_allocated() / 1e9)
    return state, outs, 1e3 * (time.perf_counter() - w0) / k, None


def _copy_train_state(dst, src):
    """Write ``src``'s parameters, SGD momenta and aux states into
    ``dst``'s tensors, in place."""
    import torch

    with torch.no_grad():
        for n, p in src["params"].items():
            q = dst["params"][n]
            q.copy_(p)
            m = src["opt_state"].state.get(p, {}).get("momentum_buffer")
            if m is not None:
                dst["opt_state"].state.setdefault(q, {})[
                    "momentum_buffer"] = m.clone()
        for a, b in zip(dst["aux"], src["aux"]):
            a.copy_(b)


def _no_sync_loop(step, state, batches, key, device):
    """``step.loop`` with the sync debug mode at ``error`` on a card: a
    host synchronisation inside the K steps raises."""
    import torch

    if device == "cuda":
        torch.cuda.set_sync_debug_mode("error")
    try:
        return step.loop(state, batches, key)
    finally:
        if device == "cuda":
            torch.cuda.set_sync_debug_mode("default")


def compile_leg_a(device="cuda", batch=128, image=224, classes=1000,
                  steps=COMPILE_STEPS, expect=COMPILE_RESNET50_REPORT):
    """Leg A: bench.py's ResNet-50 (s2d stem, bf16, SGD 0.05 / 0.9, batch
    128) through ``make_symbol_train_step`` under ``MXNET_COMPILE_OPT=1``
    (all four passes), ``MXNET_COMPILE_VERIFY=1`` (the bind checks the
    rewritten graph against the unrewritten one on the card) and
    ``MXNET_JIT_VERIFY=1`` (the loop is the verifier's
    ``symbol_trainer.loop`` boundary), beside the same step without
    them, both from the same seeded state on the same batches and keys.
    Checks: the pass report is the JAX package's on this graph
    (``expect``; ``tests/test_torch_compile.py``), no fallback warning,
    no host synchronisation inside either loop (sync debug mode
    ``error``), and over ``steps`` batches the rewritten step's mean
    cross-entropy, run from a copy of the unrewritten trajectory's state
    at each step, within max(COMPILE_LOSS_ATOL, COMPILE_LOSS_RTOL x the
    loss) nats of the unrewritten step's (the layout pass reorders the
    convolutions' and BatchNorm's reductions, and bf16 activations round
    by that order; two trajectories would not do: at bench.py's lr the
    first steps blow the loss up to the clamp and back, so rounding
    differences grow without bound between them), every head and parameter finite, no unexpected
    recompile, K1 once a step. Prints ms a step (CUDA events over a loop
    of ``steps``; plain, rewritten, plain, rewritten), peak memory of
    each, and a one-step profile of each by layer kind with the
    convolution kernels' names."""
    import logging

    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import compile as mxc
    from mxnet_tpu_torch import threefry
    from mxnet_tpu_torch.analysis import compile_verify as cv
    from mxnet_tpu_torch.ops import softmax as sm
    from mxnet_tpu_torch.parallel import make_symbol_train_step

    ctx = _ctx(device)
    dev = ctx.torch_device
    shapes = {"data": (batch, 3, image, image), "softmax_label": (batch,)}
    sym = mx.models.get_resnet(classes, 50, stem="s2d", image=image)
    key = threefry.prng_key(0, device="cpu")
    batches = _bench_batches(steps, batch, image, classes, torch.bfloat16,
                             dev)
    labels = batches["softmax_label"]
    warned = []

    class _Catch(logging.Handler):
        def emit(self, record):
            warned.append(record.getMessage())

    log_c = logging.getLogger("mxnet_tpu_torch.compile")
    handler = _Catch(level=logging.WARNING)
    log_c.addHandler(handler)
    rec = {"leg": "A", "batch": batch, "image": image, "steps": steps}
    try:
        step_p, st_p = make_symbol_train_step(sym, shapes, ctx=ctx,
                                              compute_dtype="bfloat16")
        with _Env(MXNET_COMPILE_OPT="1", MXNET_COMPILE_VERIFY="1",
                  MXNET_JIT_VERIFY="1"):
            cv.reset()
            t0 = time.perf_counter()
            step_o, st_o = make_symbol_train_step(sym, shapes, ctx=ctx,
                                                  compute_dtype="bfloat16")
            rec["bind_s_with_verify"] = time.perf_counter() - t0
            report = mxc.last_report()
            rec["report"] = report
            same_start = all(torch.equal(st_o["params"][n], p)
                             for n, p in st_p["params"].items())
            _sync(device)
            sm.fused_softmax.launches = 0
            # the losses compared: each step from the same state
            keys = threefry.split(key, steps)
            lp, lo = [], []
            for k in range(steps):
                b = {n: v[k] for n, v in batches.items()}
                _copy_train_state(st_o, st_p)
                st_o, (po,) = step_o(st_o, b, keys[k])
                st_p, (pp,) = step_p(st_p, b, keys[k])
                lo.append(float(_ce(po, labels[k]).mean()))
                lp.append(float(_ce(pp, labels[k]).mean()))
            st_o, o_o = _no_sync_loop(step_o, st_o, batches, key, device)
            st_p, o_p = _no_sync_loop(step_p, st_p, batches, key, device)
            run_steps = 4 * steps
            times = {"plain": [], "passes": []}
            peak = {}
            for name in ("plain", "passes", "plain", "passes"):
                step, st = ((step_p, st_p) if name == "plain"
                            else (step_o, st_o))
                st, _, ms, gb = _loop_timed(step, st, batches, key, device)
                times[name].append(ms)
                peak[name] = gb
                run_steps += steps
            if device == "cuda":
                first = {k: v[0] for k, v in batches.items()}
                rec["profile"] = {
                    "plain": _step_profile(step_p, st_p, first, key),
                    "passes": _step_profile(step_o, st_o, first, key)}
                run_steps += 2
            _sync(device)
            launches = sm.fused_softmax.launches
            unexpected = cv.unexpected()
            boundaries = cv.summary()["boundaries"]
    finally:
        log_c.removeHandler(handler)
    diff = [abs(a - b) for a, b in zip(lo, lp)]
    limit = [max(COMPILE_LOSS_ATOL, COMPILE_LOSS_RTOL * abs(b)) for b in lp]
    finite = _finite(list(o_p) + list(o_o) + list(st_p["params"].values())
                     + list(st_o["params"].values()))
    rec.update({
        "same_start": same_start, "losses_plain": lp, "losses_passes": lo,
        "loss_abs_diff": diff, "loss_limit": limit,
        "ms_a_step": times,
        "ms_a_step_ratio": min(times["passes"]) / min(times["plain"]),
        "peak_mem_gb": peak, "fallback_warnings": warned,
        "k1_launches": launches, "steps_run": run_steps,
        "unexpected_recompiles": len(unexpected),
        "boundaries": boundaries, "finite": finite})
    log(dict(phase="compile", **rec))
    want_k1 = run_steps if device == "cuda" else 0
    checks = {
        "the JAX package's pass report": all(
            report.get(k) == v for k, v in expect.items()),
        "no fallback": not warned,
        "same starting state": same_start,
        "losses": all(d <= m for d, m in zip(diff, limit)),
        "finite": finite,
        "no unexpected recompile": not unexpected,
        "loop boundary": boundaries.get("symbol_trainer.loop", {}).get(
            "compiles") == 1,
        "K1 once a step": launches == want_k1}
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError("compile leg A: %s failed: %r" % (failed, rec))
    return rec


def compile_leg_b(device="cuda", batch=128, image=224, classes=1000):
    """Leg B: the tuner. Under ``MXNET_COMPILE_TUNE=1`` and a fresh
    ``MXNET_COMPILE_CACHE_DIR`` the first bind of leg A's graph times
    each contested convolution's two layouts once (and the FC's two
    accumulations) on the card and stores the winners; a second process
    binds the same graph with the same directory and must time nothing
    and rewrite the same convolutions to NHWC. Prints the trials, their
    seconds, how many convolutions chose NHWC, the stored timings' range
    and the FC's kernels under both accumulation choices
    (:func:`_fc_precision_kernels`)."""
    import shutil
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import compile as mxc
    from mxnet_tpu_torch.compile import autotune

    ctx = _ctx(device)
    shapes = {"data": (batch, 3, image, image), "softmax_label": (batch,)}
    sym = mx.models.get_resnet(classes, 50, stem="s2d", image=image)
    tmp = tempfile.mkdtemp(prefix="mx_tune_")
    env = {"MXNET_COMPILE_OPT": "1", "MXNET_COMPILE_TUNE": "1",
           "MXNET_COMPILE_CACHE_DIR": tmp}
    try:
        with _Env(**env):
            trials0, secs0 = autotune.TRIALS, autotune.TRIAL_SECS
            t0 = time.perf_counter()
            exe = sym.simple_bind(ctx, grad_req="null", **shapes)
            bind_s = time.perf_counter() - t0
            trials = autotune.TRIALS - trials0
            trial_s = autotune.TRIAL_SECS - secs0
            report = mxc.last_report()
            nhwc = sorted(n.name for n in exe._exec_symbol.nodes
                          if not n.is_variable
                          and n.op.name == "_mxc_conv_nhwc")
            convs = sum(1 for n in sym.nodes if not n.is_variable
                        and n.op.name == "Convolution")
            db = autotune.TuningDB(os.path.join(tmp, "tuning.json"))
            entries = db._load()
            del exe
        root = os.path.dirname(os.path.abspath(__file__))
        child_env = dict(os.environ, PYTHONPATH=root, **env)
        if device != "cuda":
            child_env["CUDA_VISIBLE_DEVICES"] = ""
        child = subprocess.run(
            [sys.executable, "-c", _TUNE_CHILD % (root, device, batch,
                                                  image, classes)],
            cwd=root, env=child_env, capture_output=True, text=True,
            timeout=600)
        if child.returncode != 0:
            raise AssertionError("leg B's second process failed:\n%s"
                                 % child.stderr[-4000:])
        second = json.loads(child.stdout.strip().splitlines()[-1])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    kinds = {}
    for k, v in entries.items():
        kind = k.split("|", 1)[0]
        kinds.setdefault(kind, {}).setdefault(v["choice"], 0)
        kinds[kind][v["choice"]] += 1
    ratios = [v["timings"]["nchw"] / v["timings"]["nhwc"]
              for k, v in entries.items() if k.startswith("conv_layout|")
              and len(v.get("timings", {})) == 2]
    rec = {"leg": "B", "trials": trials, "trial_s": trial_s,
           "bind_s": bind_s, "report": report, "convs": convs,
           "convs_nhwc": len(nhwc), "db_choices": kinds,
           "db_backend": sorted({v["backend"] for v in entries.values()}),
           "conv_nchw_over_nhwc_s": [min(ratios), max(ratios)]
           if ratios else None,
           "matmul_prec_timings_s": [v["timings"] for k, v in entries.items()
                                     if k.startswith("matmul_prec|")],
           "fc_precision_kernels": _fc_precision_kernels(device, batch,
                                                         classes),
           "second_process": {k: v for k, v in second.items()
                              if k != "nhwc"}}
    log(dict(phase="compile", **rec))
    checks = {"trials": trials > 0,
              "every contested conv in the db": sum(
                  kinds.get("conv_layout", {}).values()) > 0,
              "second process: no trials": second["trials"] == 0,
              "second process: the same layouts": second["nhwc"] == nhwc}
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError("compile leg B: %s failed: %r" % (failed, rec))
    return rec


def _fc_precision_kernels(device, batch, classes, hidden=2048):
    """The FullyConnected of bench.py's ResNet-50 in the dtype its step
    computes in (bf16, [batch, 2048] x [classes, 2048]^T) under the
    precision pass's two choices: the stock ``torch.matmul`` ('f32':
    f32 accumulation) and ``precision.fast_matmul`` ('fast': cuBLAS's
    reduced-precision reduction allowed for the call): each one's
    kernels by name (None where the profiler gave none) and ms a call
    (CUDA events, 20 calls); raises if the 'fast' call leaves the
    process's flag changed."""
    if device != "cuda":
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.compile.precision import fast_matmul

    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    g = torch.Generator(device="cuda").manual_seed(42)
    x = torch.randn(batch, hidden, generator=g, device="cuda").to(
        torch.bfloat16)
    w = torch.randn(classes, hidden, generator=g, device="cuda").to(
        torch.bfloat16)
    out = {}
    for name, fn in (("f32", lambda: torch.matmul(x, w.t())),
                     ("fast", lambda: fast_matmul(x, w))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        cuda = torch.autograd.DeviceType.CUDA
        names = sorted({k.name for e in prof.events()
                        for k in getattr(e, "kernels", ())}
                       | {e.name for e in prof.events()
                          if e.device_type == cuda})
        # None: the profiler returned no kernel for the call ("not
        # measured"), which a process that profiled before can see
        out[name] = {"kernels": [n[:160] for n in names] or None,
                     "ms": cuda_ms(fn)}
    out["same_kernels"] = (out["f32"]["kernels"] == out["fast"]["kernels"]
                           if out["f32"]["kernels"]
                           and out["fast"]["kernels"] else None)
    # the process's flag, which the 'fast' call sets and restores
    out["process_allows_bf16_reduced_precision_reduction"] = flag
    if torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            != flag:
        raise AssertionError("fast_matmul left the process's flag changed")
    return out


_TUNE_CHILD = r"""
import json, sys
sys.path.insert(0, %r)
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.compile import autotune
device, batch, image, classes = %r, %d, %d, %d
ctx = mx.gpu(0) if device == "cuda" else mx.cpu()
sym = mx.models.get_resnet(classes, 50, stem="s2d", image=image)
exe = sym.simple_bind(ctx, grad_req="null", data=(batch, 3, image, image),
                      softmax_label=(batch,))
print(json.dumps({"trials": autotune.TRIALS,
                  "report": mx.compile.last_report(),
                  "nhwc": sorted(n.name for n in exe._exec_symbol.nodes
                                 if not n.is_variable
                                 and n.op.name == "_mxc_conv_nhwc")}))
"""


def compile_leg_c(device="cuda", batch=32, image=224, runs=10):
    """Leg C: the Predictor on Inception-BN at batch ``batch``
    (``phase_predictor``'s seeded checkpoint) with the frozen-parameter
    fold: unfolded (the layer off), under ``MXNET_COMPILE_PASSES=fold,
    fuse`` (outputs bit-equal to the unfolded Predictor's) and under all
    four passes (within COMPILE_PREDICT_TOL); each one's ms a batch
    (median of ``runs``, synchronised) and K1 once a forward."""
    import shutil
    import tempfile

    import numpy as np

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import compile as mxc
    from mxnet_tpu_torch.ops import softmax as sm

    ctx = _ctx(device)
    sym = _inception_bn_net(mx)
    shapes = {"data": (batch, 3, image, image), "softmax_label": (batch,)}
    args, aux = zoo_params(sym, shapes, seed=17)
    rng = np.random.RandomState(18)
    aux = {n: (0.1 * rng.randn(*v.shape) if n.endswith("mean")
               else 0.5 + rng.rand(*v.shape)).astype(np.float32)
           for n, v in aux.items()}
    tmp = tempfile.mkdtemp(prefix="mx_compile_pred_")
    out, rec = {}, {"leg": "C", "batch": batch, "image": image}
    try:
        prefix = os.path.join(tmp, "inception-bn")
        mx.model.save_checkpoint(
            prefix, 1, sym,
            {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in args.items()
             if k not in shapes},
            {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in aux.items()},
            sync=True)
        x = args["data"]
        for name, env in (("unfolded", {}),
                          ("fold_fuse", {"MXNET_COMPILE_OPT": "1",
                                         "MXNET_COMPILE_PASSES": "fold,fuse"}),
                          ("all_passes", {"MXNET_COMPILE_OPT": "1"})):
            with _Env(**env):
                pred = mx.Predictor.from_checkpoint(
                    prefix, 1, ctx=ctx, input_shapes={"data": x.shape})
                report = mxc.last_report() if env else None
            sm.fused_softmax.launches = 0
            pred.forward(data=x)
            out[name] = pred.get_output(0)
            launches = sm.fused_softmax.launches
            times = []
            for _ in range(runs):
                t0 = time.perf_counter()
                pred.forward(data=x)
                pred.get_output(0)
                _sync(device)
                times.append((time.perf_counter() - t0) * 1e3)
            times.sort()
            rec[name] = {"report": report, "k1_launches": launches,
                         "ms_per_batch": times[len(times) // 2],
                         "ms_min_max": [times[0], times[-1]],
                         "nodes": sum(1 for n in pred._exe._nodes
                                      if not n.is_variable)}
            del pred
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["fold_fuse_bit_equal"] = bool(np.array_equal(out["fold_fuse"],
                                                     out["unfolded"]))
    rec["all_passes_max_abs_err"] = float(np.max(np.abs(
        out["all_passes"] - out["unfolded"])))
    rec["tol"] = COMPILE_PREDICT_TOL
    log(dict(phase="compile", **rec))
    want_k1 = 1 if device == "cuda" else 0
    checks = {
        "finite": all(np.all(np.isfinite(o)) for o in out.values()),
        "fold + fuse bit-equal": rec["fold_fuse_bit_equal"],
        "all passes within tol": rec["all_passes_max_abs_err"]
        <= COMPILE_PREDICT_TOL,
        "all passes rewrote": rec["all_passes"]["report"]["layout"] > 0,
        "K1 once a forward": all(rec[n]["k1_launches"] == want_k1
                                 for n in out)}
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError("compile leg C: %s failed: %r" % (failed, rec))
    return rec


def compile_leg_d(device="cuda", model_kw=FLAGSHIP, long_len=2048, new=16):
    """Leg D: the flagship serving ``Engine`` (``phase_serving``'s: the
    Ulysses prefill of a ``long_len`` prompt through K2) under
    ``MXNET_JIT_VERIFY=1``, 8 requests of mixed lengths, ``new`` tokens
    each. Checks: no unexpected recompile, no D2H violation, every decode
    step's ledger exactly 4 bytes a lane of its batch bucket (the token
    vector), K2 once a layer for the long prompt (its count zeroed just
    before and read just after); negative controls inside
    ``expecting_violations``: a dispatch of a decode bucket's program at
    an off-bucket chunk is caught naming the tokens argument, and a
    region over its budget is caught with its site; outside, the same
    off-bucket dispatch raises ``JitVerifyError`` naming the argument."""
    import contextlib

    import numpy as np
    import torch

    from mxnet_tpu_torch.analysis import compile_verify as cv
    from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                    init_params)
    from mxnet_tpu_torch.ops.flash_attention import flash_attention
    from mxnet_tpu_torch.parallel import create_mesh
    from mxnet_tpu_torch.serving import Engine, ServingConfig
    from mxnet_tpu_torch.serving import sampling as samp_mod

    cfg = TransformerConfig(**model_kw)
    rng = np.random.RandomState(3)
    lens = [long_len, 5, 37, 120, 300, 9, 64, 17]
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in lens]
    regions = []
    inner = cv.d2h_region

    @contextlib.contextmanager
    def region(name, budget_bytes=None):
        with inner(name, budget_bytes=budget_bytes) as r:
            yield r
        if r is not None:
            regions.append((name, budget_bytes, r["bytes"]))

    rec = {"leg": "D", "prompts": lens, "max_new_tokens": new}
    with _Env(MXNET_JIT_VERIFY="1"):
        cv.reset()
        cv.d2h_region = region
        try:
            params = init_params(cfg, torch.Generator(
                device=device).manual_seed(0), device)
            mesh = create_mesh((1,), ("seq",), devices=[device])
            scfg = ServingConfig(mesh=mesh, cp_kind="ulysses",
                                 cp_min_tokens=long_len, block_size=16,
                                 num_blocks=512, max_batch=8,
                                 prefill_chunk=64)
            eng = Engine(params, cfg, scfg, device=device)
            _sync(device)
            flash_attention.launches = 0
            t0 = time.perf_counter()
            outs = eng.generate(prompts, max_new_tokens=new)
            _sync(device)
            wall = time.perf_counter() - t0
            launches = flash_attention.launches
        finally:
            cv.d2h_region = inner
        unexpected, violations = cv.unexpected(), cv.d2h_violations()
        summary = cv.summary()
        # negative controls: a decode bucket's program at a chunk the
        # bucket does not hold, and a region with too small a budget
        m = eng.model
        dev = eng.pool.k.device

        def dispatch(B, C):
            fn = m._compiled(("step", B, 1))
            with torch.no_grad():
                fn(eng.params, eng.pool.k, eng.pool.v,
                   torch.zeros((B, C), dtype=torch.int64, device=dev),
                   *m._batch(B, dev, [0], [1],
                             np.zeros((1, m.max_blocks), np.int64), [False]),
                   m._sampling_arrays(B, 1, None, None, None, None),
                   samp_mod.SALT_TARGET)

        lo, hi = m.batch_buckets[0], m.batch_buckets[-1]
        with cv.expecting_violations() as caught:
            dispatch(lo, 1)          # the bucket's own chunk: no compile
            dispatch(lo, 3)
            with cv.d2h_region("serve.decode_step.too_tight",
                               budget_bytes=1):
                m.step(eng.params, eng.pool.k, eng.pool.v,
                       np.zeros((1, 1), np.int64), np.zeros((1,), np.int64),
                       np.ones((1,), np.int64),
                       np.zeros((1, m.max_blocks), np.int64),
                       np.zeros((1,), bool))
            dispatch(hi, 1)
        raised = None
        try:
            dispatch(hi, 2)
        except cv.JitVerifyError as e:
            raised = str(e)
    decode = [(b, n) for name, b, n in regions if name == "serve.decode_step"]
    tokens = sum(len(s) for s in outs)
    rec.update({
        "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
        "k2_launches": launches, "unexpected_recompiles": len(unexpected),
        "d2h_violations": len(violations),
        "boundaries": summary["boundaries"], "groups": summary["groups"],
        "decode_steps": len(decode),
        "decode_bytes_per_step": sorted({n for _, n in decode}),
        "decode_budgets": sorted({b for b, _ in decode}),
        "d2h_sites": summary["d2h_sites"],
        "caught": [{k: v for k, v in c.items() if k != "sites"}
                   for c in caught],
        "raised": raised})
    log(dict(phase="compile", **rec))
    want_k2 = cfg.num_layers if device == "cuda" else 0
    checks = {
        "streams": [len(s) for s in outs] == [new] * len(prompts),
        "no unexpected recompile": not unexpected,
        "no D2H violation": not violations,
        "decode ledger = the token vector": bool(decode) and all(
            n == b for b, n in decode),
        "K2 once a layer": launches == want_k2,
        "off-bucket caught": any(
            c["event"] == "unexpected_recompile"
            and any(d.startswith("arg[3]: shape") for d in c["diff"])
            for c in caught),
        "over-budget region caught": any(
            c["event"] == "d2h_over_budget" for c in caught),
        "off-bucket raises": raised is not None and "arg[3]: shape" in raised}
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError("compile leg D: %s failed: %r" % (failed, rec))
    return rec


_CACHE_CHILD = r"""
import json, sys, time
import torch
sys.path.insert(0, %r)
import chip_smoke
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import rtc
from mxnet_tpu_torch.compile import jit_cache
from mxnet_tpu_torch.ops import _nvrtc
torch.backends.cuda.matmul.allow_tf32 = False
n = chip_smoke.RTC_N
body, plain = chip_smoke.RTC_BODIES[%r]
g = torch.Generator(device="cuda").manual_seed(31)
ctx = mx.gpu(0)
a, b, c = (mx.nd.NDArray(torch.rand(n, generator=g, device="cuda"), ctx)
           for _ in range(3))
out = mx.nd.zeros((n,), ctx=ctx)
k = mx.rtc.Rtc(%r, [("a", a), ("b", b), ("c", c)], [("out", out)], body)
rtc.launches = 0
t0 = time.perf_counter()
k.push([a, b, c], [out], grid_dims=(chip_smoke.RTC_GRID, 1, 1),
       block_dims=(chip_smoke.RTC_BLOCK, 1, 1))
torch.cuda.synchronize()
first_ms = 1e3 * (time.perf_counter() - t0)
close = chip_smoke.closeness(out._data, plain(a._data, b._data, c._data),
                             1e-4)
print(json.dumps(dict(jit_cache.stats(), nvrtc=_nvrtc.COMPILES,
                      launches=rtc.launches, first_push_ms=first_ms,
                      closeness=close, dir=jit_cache.active_dir())))
"""


def compile_leg_e(device="cuda"):
    """Leg E: the persistent cubin cache. Three processes push
    RTC_BODIES' real-size body (K5, f32 [2^26]) under one fresh
    ``MXNET_COMPILE_CACHE_DIR``: the first compiles it with NVRTC (one
    miss), the second loads the cubin (one hit, no NVRTC compile); one
    byte of the entry is flipped, and the third counts one corrupt
    entry, recompiles (one miss) and still agrees with the body's plain
    twin (tol 1e-4), as every process must. Prints each process's first
    push (compile or load included)."""
    import shutil
    import tempfile

    if device != "cuda":
        return {"leg": "E", "skipped": "CUDA C bodies run on a card only",
                "launches": 0}
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="mx_cubins_")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MXNET_COMPILE")}
    env.update(PYTHONPATH=root, MXNET_COMPILE_CACHE_DIR=tmp)

    def child():
        proc = subprocess.run(
            [sys.executable, "-c", _CACHE_CHILD % (
                root, COMPILE_CACHE_BODY, COMPILE_CACHE_BODY)],
            cwd=root, env=env, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise AssertionError("leg E's process failed:\n%s"
                                 % proc.stderr[-4000:])
        return json.loads(proc.stdout.strip().splitlines()[-1])

    try:
        runs = [child(), child()]
        entries = [p for p in os.listdir(runs[0]["dir"])
                   if p.endswith("-cubin")]
        path = os.path.join(runs[0]["dir"], entries[0])
        with open(path, "rb") as f:
            raw = bytearray(f.read())
        raw[len(raw) // 2] ^= 0x10
        with open(path, "wb") as f:
            f.write(bytes(raw))
        runs.append(child())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = {"leg": "E", "body": COMPILE_CACHE_BODY, "n": RTC_N,
           "entries": len(entries),
           "processes": [{k: v for k, v in r.items() if k != "dir"}
                         for r in runs],
           "launches": sum(r["launches"] for r in runs)}
    log(dict(phase="compile", **rec))
    first, second, third = runs
    checks = {
        "first: one miss, one NVRTC compile": (
            first["misses"], first["hits"], first["nvrtc"]) == (1, 0, 1),
        "second: one hit, no NVRTC compile": (
            second["hits"], second["misses"], second["nvrtc"]) == (1, 0, 0),
        "third: one corrupt entry, recompiled": (
            third["corrupt"], third["misses"], third["nvrtc"]) == (1, 1, 1),
        "each agrees with the plain twin": all(
            within(r["closeness"], 1e-4) for r in runs),
        "one launch each": [r["launches"] for r in runs] == [1, 1, 1]}
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError("compile leg E: %s failed: %r" % (failed, rec))
    return rec


def compile_kernel_checks(device="cuda"):
    """K1 and K2 at this phase's shapes against their plain versions
    (under :func:`closeness`, bf16 tol 1e-2), outside the counted
    windows: K1 at [128, 1000] bf16 (leg A's heads), K2 at [1, 8, 2048,
    128] bf16 causal (leg D's prefill). K5 is held in each leg-E
    process."""
    import torch

    from mxnet_tpu_torch.ops.flash_attention import (attention_reference,
                                                     flash_attention_fwd)
    from mxnet_tpu_torch.ops.softmax import fused_softmax, softmax_reference

    if device != "cuda":
        return {}
    g = torch.Generator(device="cuda").manual_seed(40)
    x = (torch.randn(128, 1000, generator=g, device="cuda") * 3).to(
        torch.bfloat16)
    k1 = closeness(fused_softmax(x), softmax_reference(x), 1e-2)
    q, k, v = _kernel_inputs((1, 8, 2048, 128), torch.bfloat16, None,
                             "plain", 41)
    o, _ = flash_attention_fwd(q, k, v, causal=True)
    k2 = closeness(o, attention_reference(q, k, v, causal=True)[0], 1e-2)
    rec = {"k1_128x1000_bf16": k1, "k2_1x8x2048x128_bf16": k2}
    log(dict(phase="compile_kernel_checks", **rec))
    if not (within(k1, 1e-2) and within(k2, 1e-2)):
        raise AssertionError("compile phase kernel checks: %r" % rec)
    return rec


def phase_compile(device="cuda", **kw):
    """The compile layer and the compile/transfer verifier on the card:
    legs A-E (see each ``compile_leg_*``) and the kernels of their path
    held against their plain versions. Returns the legs' records."""
    legs = {}
    t0 = time.perf_counter()
    legs["kernels"] = compile_kernel_checks(device)
    for name, fn in (("A", compile_leg_a), ("B", compile_leg_b),
                     ("C", compile_leg_c), ("D", compile_leg_d),
                     ("E", compile_leg_e)):
        t1 = time.perf_counter()
        legs[name] = fn(device, **kw.get(name, {}))
        legs[name]["leg_s"] = time.perf_counter() - t1
        if device == "cuda":
            import torch

            torch.cuda.empty_cache()
    log({"phase": "compile", "legs_s": {k: v.get("leg_s") for k, v in
                                        legs.items() if k != "kernels"},
         "total_s": time.perf_counter() - t0})
    return legs


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "mxnet_tpu_torch")):
        print("chip_smoke: mxnet_tpu_torch not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_s = {}

    def _timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        phase_s[name] = time.perf_counter() - t0
        return out

    card = _timed("setup", phase_setup)
    fwd_checks = _timed("kernels", phase_kernels)
    bwd_checks = _timed("bwd_kernels", phase_bwd_kernels)
    _timed("grad_check", phase_grad_check)
    torch.cuda.empty_cache()
    serving = _timed("serving", phase_serving)
    torch.cuda.empty_cache()
    serving_sampled = _timed("serving_sampled", phase_serving_sampled,
                             card=card)
    torch.cuda.empty_cache()
    training = _timed("training", phase_training)
    torch.cuda.empty_cache()
    softmax_checks = _timed("softmax_kernel", phase_softmax_kernel)
    lenet = _timed("lenet", phase_lenet)
    _timed("resnet_grad_check", phase_resnet_grad_check)
    torch.cuda.empty_cache()
    resnet_ff = _timed("resnet_fit", phase_resnet_fit)
    resnet = resnet_ff["softmax_launches"]
    torch.cuda.empty_cache()
    module = _timed("module", phase_module)
    resnet_module = _timed("resnet_module_fit", phase_resnet_module_fit,
                           feedforward=resnet_ff)
    torch.cuda.empty_cache()
    resnet_bench = _timed("resnet_bench",
                          phase_resnet_bench)["softmax_launches"]
    torch.cuda.empty_cache()
    resnet_scanned = _timed("resnet_scanned_fit", phase_resnet_scanned_fit,
                            feedforward=resnet_ff)["softmax_launches"]
    torch.cuda.empty_cache()
    lstm = _timed("lstm_bucketing", phase_lstm_bucketing)["softmax_launches"]
    torch.cuda.empty_cache()
    ssd = _timed("ssd", phase_ssd)["softmax_launches"]
    torch.cuda.empty_cache()
    inception_bn = _timed("inception_bn",
                          phase_inception_bn)["softmax_launches"]
    torch.cuda.empty_cache()
    _timed("inception_bn_grad_check", phase_inception_bn_grad_check)
    torch.cuda.empty_cache()
    cifar10 = _timed("cifar10", phase_cifar10)["softmax_launches"]
    torch.cuda.empty_cache()
    mirror = _timed("mirror", phase_mirror)
    torch.cuda.empty_cache()
    predictor = _timed("predictor", phase_predictor)
    torch.cuda.empty_cache()
    recordio = _timed("recordio", phase_recordio)
    recordio_launches = recordio["softmax_launches"]
    recordio_synthetic = recordio["synthetic"]["softmax_launches"]
    torch.cuda.empty_cache()
    _timed("zoo", phase_zoo)
    torch.cuda.empty_cache()
    rcnn_rec = _timed("rcnn", phase_rcnn)
    rcnn = rcnn_rec["softmax_launches"]
    rcnn_alternate = rcnn_rec["alternate"]["softmax_launches"]
    torch.cuda.empty_cache()
    _timed("host_bridges", phase_host_bridges)
    _timed("optimizers", phase_optimizers)
    torch.cuda.empty_cache()
    rtc = _timed("rtc", phase_rtc)
    torch.cuda.empty_cache()
    mm_stats = _timed("matmul_stats", phase_matmul_stats)
    torch.cuda.empty_cache()
    _timed("kvstore", phase_kvstore)
    dp = _timed("data_parallel", phase_data_parallel)
    dp_fits = {"%s_%s" % (f["fit"].split()[0], f["kvstore"]):
               f["softmax_launches"] for f in dp["fits"]}
    torch.cuda.empty_cache()
    mp = _timed("model_parallel", phase_model_parallel)
    torch.cuda.empty_cache()
    _timed("dist", phase_dist)
    torch.cuda.empty_cache()
    fleet = _timed("fleet", phase_fleet)
    torch.cuda.empty_cache()
    guard = _timed("guardian", phase_guardian)
    torch.cuda.empty_cache()
    mxprof = _timed("mxprof", phase_mxprof, fit_off=guard["A"]["i"][
        "step_ms_epoch2_off"])
    torch.cuda.empty_cache()
    _timed("guardian_vote", phase_guardian_vote)
    torch.cuda.empty_cache()
    comp = _timed("compile", phase_compile)
    log({"phase_seconds": phase_s,
         "phases_total_s": sum(phase_s.values())})
    fwd_main = fwd_checks[-1]   # the training shape, the LM's views
    bwd_main = bwd_checks[-1]   # the training shape, the LM's views
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:93",
        "launches": (serving + serving_sampled + training["flash_fwd"]
                     + sum(fleet["k2"].values()) + mxprof["launches_k2"]
                     + comp["D"]["k2_launches"]),
        "launches_by_path": {"serving": serving,
                             "serving_sampled": serving_sampled,
                             "training": training["flash_fwd"],
                             **fleet["k2"],
                             "mxprof_serving": mxprof["launches_k2"],
                             "compile_jit_verify_serving": comp["D"][
                                 "k2_launches"]},
        "max_abs_err": max(c["max_abs_err"] for c in fwd_checks),
        "shape": fwd_main["shape"], "layout": fwd_main["layout"],
        "ms": fwd_main["ms"], "graph_ms": fwd_main["graph_ms"],
        "plain_ms": fwd_main["plain_ms"], "bound_ms": fwd_main["bound_ms"],
        "bound_by": fwd_main["bound_by"],
        "library_ms": fwd_main["library_ms"],
        "serving_shape": {k: fwd_checks[0][k] for k in (
            "shape", "ms", "graph_ms", "plain_ms", "bound_ms",
            "library_ms")}}]
    for name, n, line, outs, fk in (("flash_bwd_dq", "dq", 145, ("dq",),
                                     "k3"),
                                    ("flash_bwd_dkv", "dkv", 185,
                                     ("dk", "dv"), "k4")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/ops/csrc/flash_bwd.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:%d" % line,
            "launches": training[name] + fleet[fk],
            "launches_by_path": {"training": training[name],
                                 "fleet_wsync_training": fleet[fk]},
            "max_abs_err": max(c["err"][o]["abs"] for c in bwd_checks
                               for o in outs),
            "max_err_to_limit": max(c["err"][o]["elem"] for c in bwd_checks
                                    for o in outs),
            "max_rel_l2_to_limit": max(c["err"][o]["rel_l2"] / c["tol"]
                                       for c in bwd_checks for o in outs),
            "shape": bwd_main["shape"], "layout": bwd_main["layout"],
            "ms": bwd_main[n]["ms"], "graph_ms": bwd_main[n]["graph_ms"],
            "achieved_tflops": bwd_main[n]["achieved_tflops"],
            # the plain version and SDPA compute dq, dk and dv together
            "plain_ms": bwd_main["plain_bwd_ms"],
            "bound_ms": bwd_main[n]["bound_ms"],
            "bound_by": bwd_main[n]["bound_by"],
            "library_ms": bwd_main["sdpa_bwd_ms"]})
    def sm_case(shape, dtype):
        return next(c for c in softmax_checks
                    if c["shape"] == list(shape) and c["dtype"] == dtype
                    and c["scale"] == 1.0)

    sm_main = sm_case((128, 1000), "float32")    # ResNet-50's f32 fits
    sm_lstm = sm_case((1920, 200), "float32")    # the LSTM's T = 60
    sm_bench = sm_case((128, 1000), "bfloat16")  # bench.py's bf16 step
    sm_incbn = sm_case((256, 1000), "float32")   # Inception-BN's fit
    sm_rcnn = sm_case((32, 3), "float32")        # Faster R-CNN's head
    sm_rec = sm_case((256, RECORDIO_CLASSES), "float32")   # the .rec fit
    kernels.append({
        "name": "softmax", "route": "cuda",
        "source": "mxnet_tpu_torch/ops/csrc/softmax.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:517",
        "launches": (lenet + resnet + module + resnet_module + lstm
                     + resnet_bench + resnet_scanned + ssd + inception_bn
                     + cifar10 + recordio_launches + recordio_synthetic
                     + rcnn + rcnn_alternate + mirror["softmax_launches"]
                     + mirror["memcost_softmax_launches"]
                     + mirror["cifar10_mirror"]["softmax_launches"]
                     + predictor["softmax_launches"]
                     + predictor["exported_softmax_launches"]
                     + dp["softmax_launches"] + sum(dp_fits.values())
                     + mp["softmax_launches"]
                     + guard["A"]["softmax_launches"]
                     + guard["B"]["softmax_launches"]
                     + mxprof["launches_k1"]
                     + comp["A"]["k1_launches"]
                     + sum(comp["C"][n]["k1_launches"] for n in (
                         "unfolded", "fold_fuse", "all_passes"))),
        "launches_by_path": {"lenet_fit": lenet, "resnet50_fit": resnet,
                             "module": module,
                             "resnet50_module_fit": resnet_module,
                             "lstm_bucketing": lstm,
                             "resnet50_bench": resnet_bench,
                             "resnet50_scanned_fit": resnet_scanned,
                             "ssd": ssd, "inception_bn": inception_bn,
                             "cifar10": cifar10,
                             "recordio": recordio_launches,
                             "recordio_synthetic": recordio_synthetic,
                             "rcnn": rcnn,
                             "rcnn_alternate": rcnn_alternate,
                             "inception_bn_mirror": mirror[
                                 "softmax_launches"],
                             "lstm_memcost": mirror[
                                 "memcost_softmax_launches"],
                             "cifar10_mirror": mirror["cifar10_mirror"][
                                 "softmax_launches"],
                             "predictor": predictor["softmax_launches"],
                             "predictor_exported": predictor[
                                 "exported_softmax_launches"],
                             "resnet50_data_parallel": dp[
                                 "softmax_launches"],
                             **{"data_parallel_" + k: v
                                for k, v in dp_fits.items()},
                             "lstm_model_parallel": mp[
                                 "softmax_launches"],
                             "guardian_scanned": guard["A"][
                                 "softmax_launches"],
                             "guardian_per_batch": guard["B"][
                                 "softmax_launches"],
                             "mxprof_fit": mxprof["launches_k1"],
                             "compile_resnet50_bench": comp["A"][
                                 "k1_launches"],
                             **{"compile_predictor_" + n: comp["C"][n][
                                 "k1_launches"] for n in (
                                 "unfolded", "fold_fuse", "all_passes")}},
        "max_abs_err": max(c["max_abs_err"] for c in softmax_checks),
        "max_err_to_limit": max(c["closeness"]["elem"]
                                for c in softmax_checks),
        "shape": sm_main["shape"], "variant": sm_main["variant"],
        "ms": sm_main["ms"], "graph_ms": sm_main["graph_ms"],
        "events_minus_graph_ms": sm_main["ms"] - sm_main["graph_ms"],
        "plain_ms": sm_main["plain_ms"], "bound_ms": sm_main["bound_ms"],
        "bound_by": sm_main["bound_by"],
        "library_ms": sm_main["library_ms"],
        "library_graph_ms": sm_main["library_graph_ms"],
        "lstm_shape": {k: sm_lstm[k] for k in (
            "shape", "variant", "ms", "graph_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_graph_ms")},
        "bench_shape": {k: sm_bench[k] for k in (
            "shape", "dtype", "variant", "ms", "graph_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "library_graph_ms")},
        "inception_bn_shape": {k: sm_incbn[k] for k in (
            "shape", "dtype", "variant", "ms", "graph_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "library_graph_ms")},
        "rcnn_shape": {k: sm_rcnn[k] for k in (
            "shape", "dtype", "variant", "ms", "graph_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "library_graph_ms")},
        "recordio_shape": {k: sm_rec[k] for k in (
            "shape", "dtype", "variant", "ms", "graph_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "library_graph_ms")}})
    f32, bf16 = (rtc["timing"]["mul_add_" + t]
                 for t in ("float32", "bfloat16"))
    kernels.append({
        "name": "rtc", "route": "cuda",
        "source": "mxnet_tpu_torch/rtc.py",
        "bodies": "chip_smoke.py RTC_BODIES (CUDA C, compiled by NVRTC)",
        "replaces": "mxnet_tpu/rtc.py:107",
        "launches": rtc["launches"] + comp["E"]["launches"],
        "launches_by_path": {"rtc": rtc["launches"],
                             "compile_cubin_cache": comp["E"]["launches"]},
        "max_abs_err": max(c["abs"] for c in rtc["checks"].values()),
        "max_err_to_limit": max(c["elem"] for c in rtc["checks"].values()),
        "shape": [RTC_N], "dtype": "float32", "ms": f32["ms"],
        "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
        "bfloat16": {k: bf16[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "library_ms")},
        "nvrtc_compile_ms": rtc["compile_ms"]["mul_add_float32"],
        "cached_push_host_us": rtc["cached_push_host_us"]})
    probe_a = mm_stats["probe"][0]   # shape A, the probe's first
    kernels.append({
        "name": "matmul_stats", "route": "cuda",
        "source": "mxnet_tpu_torch/ops/csrc/matmul_stats.cu",
        "replaces": "tools/probe_matmul_stats.py:36",
        "launches": mm_stats["launches"],
        "launches_by_path": {"probe": mm_stats["launches"]},
        "max_abs_err": max(c["check"]["y"]["abs"]
                           for c in mm_stats["checks"]),
        "max_abs_err_s": max(c["check"]["s"]["abs"]
                             for c in mm_stats["checks"]),
        "max_abs_err_s2": max(c["check"]["s2"]["abs"]
                              for c in mm_stats["checks"]),
        "max_err_to_limit": max(c["check"]["worst"]
                                for c in mm_stats["checks"]),
        "shape": probe_a["shape"], "dtype": "bfloat16", "ms": probe_a["ms"],
        "graph_ms": probe_a["graph_ms"],
        "plain_ms": probe_a["plain_ms"], "bound_ms": probe_a["bound_ms"],
        "bound_by": probe_a["bound_by"], "library_ms": probe_a["matmul_ms"],
        "library": "torch.matmul without the statistics: a floor, not the "
                   "same function",
        "sequence_ms": probe_a["sequence_ms"],
        "same_bits": all(c["same_bits"] for c in mm_stats["checks"]),
        "by_shape": [{k: r[k] for k in (
            "shape", "ms", "graph_ms", "plain_ms", "matmul_ms",
            "matmul_graph_ms", "sequence_ms", "bound_ms", "bound_share",
            "graph_bound_share", "kernel_device_ms")}
                     for r in mm_stats["probe"]]})
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
