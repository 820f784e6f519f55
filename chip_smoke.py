#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port (``tensorflowonspark_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py [--seed 0]

Phases, each of which fails the run loudly (nothing falls back to the CPU):

1. device: the card's name and, from ``nvidia-smi``, its power limit;
2. build: every kernel source compiled by ``nvcc`` from the checkout
   (``ops/csrc/flash_attention_fwd.cu`` and ``flash_attention_bwd.cu``, at
   once) into ``build/torch_kernels/``, with each kernel's ptxas report;
   then ``cuobjdump -sass`` must show wgmma (``HGMMA``) and TMA loads
   (``UTMALDG``) in every bf16 K1, K2 and K3 kernel; and the native
   TFRecord codec (``native/tfrecord.cc``) compiled by ``g++`` into
   ``build/torch_native/`` (no pure-Python fallback here);
3. kernels: the forward (K1) and the dQ (K2) and dK/dV (K3) backward
   kernels each held against their plain PyTorch versions on the card, at
   the main paths' shapes (BERT's and the decoder's causal one) and at
   edge cases (single TMA tiles, boxes that
   overhang ragged edges, D = 128, and head dims 8, 16 and 96 zero-padded
   to the kernels' 64 or 128, each call counting one launch), then timed
   (the padded head dims too, against SDPA) beside their bound, their
   plain version and the one PyTorch call that computes the same function
   (a yardstick only; the port never calls it), kernel and yardstick in
   turns behind a sleep that hides the host's enqueue
   (``tensorflowonspark_tpu_torch/devtime.py``); each wrapper's host cost
   a call is printed too;
4. model gradients: one full-width BERT-base QA batch, backward through
   the kernels against backward through the plain versions, same weights,
   at three seeds; each half (forward kernel, backward kernels) alone; and
   a planted fault (dK zeroed) that the gate must reject;
5. inference main path: ``TPUCluster.run`` + ``cluster.inference`` serving
   64 SQuAD-shaped rows through full-width BERT-base QA (bf16, random
   weights from ``--seed``) in one worker process; the worker's forward
   launches must be 12 per batch, and its logits must agree with the same
   weights run in this process with the plain attention;
6. training main path: ``TPUCluster.run`` + ``cluster.train`` fine-tuning
   full-width BERT-base QA for 8 steps (AdamW, dropout 0.1) in one worker
   that checkpoints into ``model_dir`` and writes the serving export;
   each kernel must launch 12 times a step, and every step's loss and the
   checkpoint's final weights must agree with a replay in this process
   through the plain attention (forward and backward) from the same seed,
   batches and generators, where a replay with dK zeroed must not; the
   replay's live state (model, AdamW moments, step), checkpointed sync and
   async, restores on the CPU bit for bit;
6b. export serving path: ``cluster.inference`` of the 64 rows through the
   chief's export (``bert_inference`` with ``export_dir``): 12 K1 launches
   a batch inside the exported program, and logits that agree with the
   eager model of the checkpoint's weights (:data:`EXPORT_TOL`), where an
   export whose attention zeroes V must not; the exported and eager
   batch's times, in turns;
7. ResNet-50 on the card against the CPU: one train-mode forward and
   backward of full-width ResNet-50 at 224 px, batch 8 (bf16 convolutions,
   channels_last, cuDNN) against the port's float32 path on the CPU (which
   the CPU tests hold against flax), same weights (flax's initial kernels,
   BatchNorm scales from U(0.5, 1.5), each block's last from U(0.05, 0.15)
   so that no block's branch is silenced), at three seeds: logits,
   loss, gradients and the updated BatchNorm buffers; a planted fault (the
   strided 3x3 convolutions padded (1, 1), PyTorch's default, instead of
   flax's SAME (0, 1)) must fall outside the gate;
8. ResNet-50 training main path from TFRecords, with a resume: the
   worker's 1024-image uint8 shard written as TFRecords with ``dfutil``
   (a decoded batch equals the array batch byte for byte); ``TPUCluster.run``
   of ``resnet_train.map_fun`` in ``InputMode.TENSORFLOW``, one worker, full
   width, batch 128, 224 px, SGD momentum: 4 steps into ``model_dir``, then
   a new cluster that restores step 4 and trains steps 5-8; every step's
   loss and the final checkpoint's weights and BatchNorm buffers must agree
   with an unbroken replay in this process over the same records, the
   buffers must have moved, and a resume from a checkpoint stripped of its
   momentum must fall outside the gate; a live ResNet-50 + SGD state,
   checkpointed on the card sync and async, restores on the CPU bit for
   bit, and the worker's checkpoint holds its step, input position and
   momentum;
9. MNIST driver-fed path from TFRecords: the driver reads 4096 rows back
   with ``loadTFRecords`` and ``cluster.train`` feeds them through
   ``mnist_train.map_fun`` in one worker: every row consumed, the loss
   falls, the shared-memory transport carried the feed; the chief's
   export serves on the card within 1e-5 of the eager model, and so does
   an export that a process without a card wrote (and the card's export on
   the CPU);
10. the bench: ``python -m tensorflowonspark_tpu_torch.bench_resnet``'s
   measurement, its JSON line printed on a line of its own (run last, after
   11 and 12);
11. BASELINE config 3 through the ML pipeline, as its users run it:
   ``TFEstimator(bert_squad.train_fn).fit(df)`` over phase 6's rows (the
   port's ``examples/bert/bert_squad.py``, full-width BERT-base, bf16, the
   flash kernels, one worker) with 12 launches of each kernel a step, every
   step's loss and the checkpoint's weights within :data:`TRAIN_TOL` of
   phase 6's plain-attention replay; then ``TFModel.transform`` of the 64
   inference rows in 4 partitions on the driver, one thread a partition,
   on the card: 12 K1 launches a batch counted on the driver, logits
   bit-identical to the export's signature called in one thread and within
   :data:`EXPORT_TOL` of the eager model of the checkpoint's weights, where
   a model whose input mapping swaps the mask and the token types must
   not be; rows/s with the partitions run at once and in one partition;
12. the Estimator under ``run_with_recovery`` with one lost worker: BERT QA
   at full width (hidden 768, 12 heads, T = 384, batch 16) cut to
   :data:`RECOVERY_LAYERS` layers, ``InputMode.TENSORFLOW``, rows read from
   TFRecords written with ``dfutil`` (``Dataset.from_examples``),
   ``train_and_evaluate(TrainSpec(max_steps=8), EvalSpec(steps=2,
   throttle_steps=4))`` with a save every 4 steps; the worker exits after
   step 6 and the relaunch restores step 4 and its input position
   (``input_state/4.json``): one classified crash, the relaunch starts at
   step 4, the event files hold train/loss at steps 1-8 and eval/loss at 4
   and 8, every step's loss and the final weights within
   :data:`TRAIN_TOL` of an unbroken in-process replay through the plain
   attention, where an Estimator that restarts the input at batch 0
   (``checkpoint_input_state=False``) must not be; detection latency,
   restart-to-first-step, the checkpoints' seconds and the goodput;
13. the decoder family's main path: the port's ``examples/gpt/gpt_tiny.py``
   flow (``Estimator`` + ``train_and_evaluate``, Adam 1e-4, an eval every 4
   steps) at GPT-124M-class width (vocab 32000, hidden 768, 12 layers, 12
   heads, FFN 3072, 1024 positions, bf16 compute on float32 parameters),
   batch 8 at T = 1024 on the "+1" corpus, 8 steps, the flash kernels
   causal: each kernel 12 times a training step (K1 also at each eval
   batch), every step's loss and the final weights within
   :data:`GPT_TRAIN_TOL` of a replay in this process through the plain
   attention (same weights, batches and Adam), where an attention that
   drops ``causal=True`` and one with dK zeroed must not be; then the
   chunked LM-head loss (``tied_softmax_xent``, chunk 4096) against logits
   + cross-entropy on the trained weights, in the loss and the gradients
   of ``tok_emb`` and the final hidden states (:data:`XENT_TOL`);
13b. the llama-class variant (RoPE, RMSNorm, SwiGLU, 4 K/V heads for 12,
   a 512-token window) at the same width, cut to
   ``LLAMA_VARIANT["num_layers"]`` layers, under the same kind of gate
   (dK zeroed and the window dropped must fail);
14. generation on phase 13's weights: in float32, the cached greedy decode,
   the int8 KV cache, a rolling window and the paged pool against the
   full forward's argmax rollout without a cache, and ``lookup_generate``
   and ``beam_generate`` with one beam against it too; the bf16 prefill
   against the full forward through the kernels (:data:`PREFILL_TOL`);
   ``quantize_params`` halving the quantized weights' bytes; the int8
   export (``quantize_params``' default leaves in int8, the rest in bf16)
   reloaded on the card, its logits bit-identical to the eager int8
   model, its variables within :data:`EXPORT_BYTES_SLACK` of the share
   its parameter bytes give of the bf16 export's; then ``bench_gpt_decode``'s JSON line (bf16, int8,
   int8 + int8 KV and lookup decode tok/s);
15. BASELINE config 4: the port's ``examples/wide_deep/wide_deep_criteo.py``
   through ``TPUCluster.run`` (one worker, ``InputMode.TENSORFLOW``, 26
   categorical and 13 dense features, ``vocab_size`` 1,298,561 a feature:
   the Criteo Kaggle total of 33.76M table rows, embed 16, MLP (256, 128,
   64), batch 8192, 4 steps of dense optax adagrad, a checkpoint at step
   4); those 4 steps replayed by the port's float32 path on the
   CPU: every loss, the MLP and the touched table rows within
   :data:`WIDE_DEEP_TOL`, untouched rows bit for bit their initial values,
   where ``torch.optim.Adagrad``'s semantics on the card must not be; then
   ``build_sparse_embedding_train_step`` (adagrad) on one table holding all
   26 Kaggle vocabularies end to end (33,762,577 x 16), held to a CPU replay
   (:data:`SPARSE_TOL`), where writes that let the last duplicate id win
   must not be; then ``bench_embedding``'s JSON line;
16. Inception-v3 at full width: one train-mode step at 299 px, batch 2,
   aux head, BatchNorm scales from U(0.5, 1.5), on the card in float32 and
   in bf16 against the port's float32 CPU path (logits, aux logits, loss,
   gradients, BatchNorm buffers; :data:`INCEPTION_TOL`), where the 1x7 /
   7x1 kernels with their axes swapped must not be; then the port's
   ``inception_imagenet.py`` through ``TPUCluster.run``, 4 steps of 32 at
   299 px (bf16, aux loss 0.3, RMSProp under the decay): finite losses,
   every RMSProp momentum moved; images/s and FLOP share;
17. U-Net at its default widths (64, 128, 256, 512), 256 px: the same
   card-against-CPU gate at batch 1 (:data:`UNET_TOL`; the transposed
   kernels without flax's flip must fail), then the port's
   ``unet_segmentation.py`` through ``TPUCluster.run``, 6 steps of 8;
18. BERT-base sequence classification (T 128, batch 32, 3 classes, dropout
   0.1, AdamW) with ``remat=True``, 8 steps through the flash kernels (K1
   24 times a step: 12 in the forward, 12 in the recomputation; K2 and K3
   12): every loss and the final weights within :data:`TRAIN_TOL` of a
   plain-attention replay, where a remat whose recomputation draws fresh
   dropout masks must not be; remat's gradients equal no remat's from the
   same generator (:data:`REMAT_TOL`; the fresh-mask remat must not); step
   time and peak memory with and without remat;
19. the serving engine on phase 13's weights (run after phases 15-18): the
   port's ``ContinuousBatcher`` at GPT-124M-class width, 4 slots, 12
   staggered requests of 8-200 tokens (four on one 64-token prefix) with
   budgets of 8-48; in float32 with TF32 off every stream equal to a solo
   ``greedy_generate`` under seven regimes — dense, paged (16 tokens a page,
   prefix hits), ``prefill_chunk`` 64, ``decode_block_steps`` 8,
   ``speculative_k`` 4 on 8 repetitive requests (acceptance), a 2-layer
   ``DraftModel``, and the 12-layer model as its own ``DraftModel`` over
   the whole history (every proposal accepted) — and a sampled request
   (T 0.8, top_p 0.9) the same alone and in company, where a skipped rewind after the bucketed prefill and a
   scatter into a permuted slot must not be; in bf16, dense and paged
   against solo bf16 greedy, every stream's first divergence must come at a
   float32 top-two margin within :data:`SERVE_TIE_TOL`, where the skipped
   rewind must not;
20. the cluster path: the port's ``examples/gpt/cluster_serving.py`` through
   ``TPUCluster.run`` + ``cluster.inference``, one worker hosting the batcher
   at GPT-124M-class width in float32, 32 requests, 8 slots: every result
   back in order and equal to the driver's solo greedy; rows/s and
   tokens/s; then ``bench_batcher``'s JSON line (steady, bursty, blocked,
   speculative and static tok/s, occupancy, calls);
21. the online tier on phase 13's weights (float32): ``ServingCluster.run``
   with 2 replicas and a warm standby, every site captured, 24 requests
   from 4 clients, replica 1 killed: every stream equal to solo greedy, a
   requeue, the standby promoted and serving (a promotion that rebinds the
   weights instead of copying them, a captured batcher promoted in this
   process, must change a stream);
22. the rest of the tier on the same weights: tier A, a ``ModelRegistry``
   (v1, and v2 = v1 plus a seeded adapter delta), one captured replica and
   the autoscaler (min 1, max 2): a burst must scale it up, ``rollout("gpt",
   "v2")`` under traffic must promote (streams before it equal v1's solo
   greedy, during it v1's or v2's, after it v2's), then the driver is
   crashed mid-stream and ``resume_driver`` rebinds its port (the
   ``failover_wait`` clients' streams exact, the journal owing nothing, the
   heal seconds printed), where a swap whose payload drops the delta must
   change a stream and a resume that requeues nothing must lose a request;
   tier B, ``disagg={"prefill": 1, "decode": 1}`` with paged KV on 12
   requests: every stream exact, a handoff a request, no prefill on the
   decode replica, where a session seated one position off (a prefill and a
   decode batcher in this process) must change a stream;
23. the batch and continual planes: (a) 256 SQuAD-shaped rows written by
   ``dfutil`` as 8 TFRecord shards, scored by phase 6's checkpoint
   (BERT-base QA, bf16, K1) through ``BatchJob`` in one worker that
   ``TFOS_CHAOS`` kills at its 5th predict batch and ``run_with_recovery``
   relaunches: no committed shard scored again, the parts committed before
   the kill unchanged, every row back in manifest order and within
   :data:`EXPORT_TOL` of this process's K1 scoring (a predict_fn that swaps
   the mask and the token types must not be), K1 12 times a predict batch
   in the workers; (b) on phase 22's tier A, before its driver crash,
   ``ContinualPipeline.run`` of a trainer that fine-tunes phase 13's
   weights 4 steps (B 8 x T 1024, the last block and ``ln_f``, K1-K3) and
   publishes the adapter delta, an offline eval of it over 64 held-out
   rows (a ``GridSearch`` trial, K1) and a canary rollout: the candidate
   promoted and journaled stage by stage, every stream after it equal to
   solo float32 greedy over ``apply_adapter(v1, delta)``, the delta the
   trainer's checkpoint less v1 leaf for leaf; the delta times -8 must end
   ``rejected_offline`` and never load, where an eval that ignores the
   candidate must pass it; phase 22's crash then resumes onto the promoted
   version, and a pipeline rebuilt there settles nothing;
24. sequence parallelism through the reference's front door: one
   ``HostAgent`` on localhost with a random authkey and
   ``TFCluster.run(None, map_fun, args, 2, 0, True,
   InputMode.TENSORFLOW, logdir, backend=AgentBackend(...))``: two workers
   in a gloo group (they share the one card; NCCL takes one rank a device)
   and a ``{dp: 1, sp: 2}`` mesh train the long-context LM of
   ``examples/long_context/ring_lm.py`` at full BERT-base width (vocab
   30522, hidden 768, 12 layers, 12 heads, FFN 3072) at B 1 x T 4096, 2048
   positions a rank, bf16 on float32 parameters, Adam 1e-4: 4 steps with
   Ulysses (K1 at [1, 4096, 6, 64] causal, K2 and K3 in the backward, each
   12 times a step on each rank) and 4 with ring attention, from the same
   seeded weights and data, each held to :data:`LONG_CONTEXT_TOL` against
   an unsharded run in this process (plain causal attention over the whole
   sequence) and with both ranks' parameters the same bit for bit, where
   an exchange that swaps the head halves, a ring that masks by local
   positions and a step that skips the ``sp`` gradient sum must not be; the chief's losses come back equal from its
   ``SummaryWriter`` event file, its profiled step's trace names K1, and
   ``cluster.tensorboard_url()`` is printed (``None`` without the
   ``tensorboard`` package);
25. pipeline and expert parallelism: a second ``HostAgent`` and
   ``TFCluster.run(None, ...)`` of two workers in a gloo group on the card:
   GPT-124M (phase 13's widths, bf16 on float32, the flash kernels causal)
   cut into ``pp`` 2 stages of six ``DecoderBlock``s (a
   ``torch.func.functional_call`` stage function over the stacked
   blocks), B 8 x T 1024 in 4 microbatches of 2, Adam 1e-4: 2 steps of
   GPipe (``PipelineStrategy.build_train_step``, remat) and 2 of 1F1B
   (``pipeline_value_and_grad``, its ``dx`` backpropagated into the
   embedding), each held to :data:`PIPELINE_TOL` against the unpipelined
   model trained in this process over the plain attention, both ranks'
   replicated parameters the same bit for bit, K1-K3 48 / 24 / 24 times a
   step on each rank and a hop a tick each way, where replicated gradients
   summed over ``pp`` and a dropped backward hop must not be; then
   ``examples/moe/switch_lm.py``'s model at Switch-Base-8's widths (d_model
   768, d_ff 3072, 8 experts, top-1, capacity 1.25, vocab 32128) over
   ``ep`` 2, T 512, B 16, float32, 3 steps held to :data:`MOE_TOL` against
   the same model in this process with every expert local, each rank's
   rows routed on their own, where a return exchange sent to the wrong
   shard must not be;
26. mesh-sharded serving (on phase 25's agent): 26a, ``TFCluster.run(None,
   ..., InputMode.SPARK, backend=AgentBackend(...))`` of two ranks that form
   one gang's gloo world (``serving.sharded.build_gang_mesh``) and cut
   phase 13's weights (float32) into Megatron tp 2 shards
   (``default_shard_params``; int8 through ``ops.shard_quantized``): phase
   19's 12 requests (budgets cut to 16 tokens) through
   ``ContinuousBatcher(..., tp=...)`` in 4 slots, plain, paged with a
   prefix hit, speculative with the 2-layer draft (itself tp-sharded), and
   int8, every stream equal on both ranks to the tp ``greedy_generate``
   token for token and to the unsharded solo greedy under phase 19's tie
   rule; a decode step timed beside the one-card batcher's, with the
   collectives and host-staged bytes a step, the same step behind the
   gang's barrier, and each collective alone at the step's shapes; layer
   0's row-parallel sum dropped on one rank must change a stream, and a
   member that acks
   without stepping must make the leader raise ``GangShardLost`` within
   the group's 5 s timeout.  26b, ``ServingCluster.run(tier_builder, 2,
   mesh={"tp": 2}, replace_failed=True)``: two gangs of two workers on the
   card serve the same requests to 2 streaming clients while
   ``TFOS_CHAOS`` kills executor 1 (gang 0's member) at its 4th step; every
   stream equals 26a's tp oracle, one ``replica_dead`` names shards
   ``[0, 1]``, a request is requeued, nothing is lost, and the cold
   replacement gang serves 4 more requests exactly.

``python3 chip_smoke.py --calibrate-slice9`` only logs phases 15-18's gate
readings at three seeds (the examples and the bench at the first);
``--calibrate-serving`` trains phase 13's model at three seeds and logs
phase 19's readings on each; ``--calibrate-continual`` trains it at three
seeds and logs phase 23b's offline-gate readings (v1's, the fine-tuned
candidate's and the bad candidate's eval loss) on each;
``--calibrate-long-context`` logs phase 24's readings at three seeds,
``--calibrate-parallel`` phase 25's, and ``--calibrate-sharded`` trains
phase 13's model at ``--seed`` and logs phase 26's at phase 19's whole
budgets.

Each phase's seconds are printed.  The ResNet, MNIST, Wide&Deep,
Inception-v3 and U-Net paths run none of the repo's hand-written kernels
(their convolutions and GEMMs are cuDNN's and cuBLAS's), nor do the serving
paths of phases 19-22 and 26 (cached decode is PyTorch's); the summary's
``launches_by_path`` shows each kernel's launches on every path, and
``launches`` is phase 18's (this slice's path through the kernels).  The
summary's times, bound and yardsticks are at phase 18's shape ([32, 128,
12, 64] bf16, key padding), with the decoder's causal shape under
``gpt_shape``, the BERT QA shape under ``bert_shape``, phase 24's under
``ulysses_shape`` and phase 25's microbatch under ``pipeline_shape``.  The line before the last is the card's name and
power limit; the line before that is the ``{"kernels": [...]}`` summary;
the last line is ``{"ok": true, "device": {...}}``.
Exits non-zero, with no result line, without a CUDA card or outside a
checkout.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

H100_HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
H100_BF16_FLOPS = 989e12            # dense bf16 tensor-core peak
BERT_LAYERS = 12
KERNEL_REPS = 30
ROWS, BATCH_SIZE = 64, 16           # the main path's requests

TRAIN_STEPS, TRAIN_LR, TRAIN_DROPOUT = 8, 3e-5, 0.1   # bert_squad.py's defaults
SEQ_LEN = 384
#: the training gate, against the plain-attention replay: each step's
#: loss |diff|; ||w - w_plain|| / ||w_plain - w0|| of the final weights
#: over the parameters (max and median); for the zero-in-theory
#: parameters, max |w - w_plain| in units of lr x steps.  Their gradient
#: is noise, and Adam's |m_hat / sqrt(v_hat)| is at most 1.000-1.028 over
#: steps 1-8 (Cauchy-Schwarz on the moment weights), so two such runs
#: differ by at most 2 x 8.087 / 8 = 2.022.  Sound readings at seeds 0-2
#: reach 0.0043 / 0.123 / 0.043 / 1.81; a zeroed dK reads a max of 1.0
#: and losses within 0.0047, which the loss alone cannot tell (PERF.md,
#: "Gate calibration")
TRAIN_TOL = {"loss": 2e-2, "max": 0.35, "median": 0.08, "noise": 2.03}

#: the bf16 K1, K2 and K3 kernels, which must show wgmma and TMA in SASS
#: (at D = 64 and 128 each)
HOPPER_KERNELS = ("flash_fwd_tma_kernel", "flash_dq_tma_kernel", "flash_dkv_tma_kernel")
HOPPER_DESIGN = "tma+wgmma"

FLASH_SOURCE = "tensorflowonspark_tpu_torch/ops/csrc/flash_attention_fwd.cu"
FLASH_REPLACES = "tensorflowonspark_tpu/ops/flash_attention.py:107"  # _fwd_kernel
BWD_SOURCE = "tensorflowonspark_tpu_torch/ops/csrc/flash_attention_bwd.cu"
DQ_REPLACES = "tensorflowonspark_tpu/ops/flash_attention.py:198"     # _dq_kernel
DKV_REPLACES = "tensorflowonspark_tpu/ops/flash_attention.py:238"    # _dkv_kernel
#: backward tolerance relative to each gradient's largest magnitude: bf16
#: dK/dV rounds p and ds to bf16 for its tensor-core products where the
#: plain version keeps f32 (2^-9 a term), and outputs round to bf16 (2^-8);
#: float32 keeps every value in f32 (another summation order only)
BWD_REL_TOL = {"bfloat16": 2e-2, "float32": 1e-5}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def sass_counts(libs: dict) -> dict:
    """``{kernel: {"HGMMA": n, "UTMALDG": n, "HMMA": n}}`` for every
    kernel of the built libraries, read from ``cuobjdump -sass`` (found
    beside ``nvcc``); a kernel is named by its source name and template
    arguments, e.g. ``flash_fwd_tma_kernel<64>``."""
    from tensorflowonspark_tpu_torch.ops.flash_attention import find_nvcc

    cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    counts = {}
    for so in libs.values():
        sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                              check=True, timeout=120).stdout
        for chunk in sass.split("Function : ")[1:]:
            mangled = chunk.split("\n", 1)[0].strip()
            m = re.search(r"(flash_[a-z]+_[a-z0-9]+_kernel)I((?:Li\d+E)+)E", mangled)
            key = f"{m[1]}<{','.join(re.findall(r'\d+', m[2]))}>" if m else mangled
            counts[key] = {op: chunk.count(op) for op in ("HGMMA", "UTMALDG", "HMMA")}
    return counts


def check_sass(libs: dict) -> dict:
    """Every bf16 K1, K2 and K3 kernel must issue wgmma (``HGMMA``) and
    TMA loads (``UTMALDG``) in its SASS.  Returns the counts of each
    kernel."""
    counts = sass_counts(libs)
    for key, c in sorted(counts.items()):
        log(f"  sass: {key}: HGMMA {c['HGMMA']}, UTMALDG {c['UTMALDG']}, HMMA {c['HMMA']}")
    hopper = {k: c for k, c in counts.items() if k.startswith(HOPPER_KERNELS)}
    missing = [k for k, c in hopper.items() if not (c["HGMMA"] and c["UTMALDG"])]
    if len(hopper) != 2 * len(HOPPER_KERNELS) or missing:
        raise SystemExit(f"the bf16 K1/K2/K3 kernels lack wgmma or TMA in SASS: "
                         f"{missing or hopper}")
    return counts


# ----------------------------------------------------------------- kernels

def flash_cases(seed: int):
    """(name, B, Tq, Tk, H, D, dtype, key lengths or None, causal, window,
    atol).  Every shape a path of the smoke gives the kernels is here: the
    first is BERT-base at T=384 in batches of 16, with ragged key padding
    and one fully masked row; the second BERT-base classification's (phase
    18, this slice's main path: batch 32 at T = 128); the next three are the
    decoder's (phase 13's causal training shape; phase 13b's windowed one;
    phase 14's prefill and export)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    bert_lens = [int(x) for x in rng.integers(192, 385, 16)]
    bert_lens[5] = 0                                   # a fully masked row
    cls_lens = [int(x) for x in rng.integers(64, 129, 32)]
    bf16, f32 = torch.bfloat16, torch.float32
    return [
        ("bert_bf16", 16, 384, 384, 12, 64, bf16, bert_lens, False, None, 2e-2),
        # BERT-base sequence classification (phase 18): one 128-row tile
        # with key padding (lengths 64..128)
        ("bert_cls_bf16", 32, 128, 128, 12, 64, bf16, cls_lens, False, None, 2e-2),
        # the decoder's training shape (phase 13): GPT-124M-class, causal
        ("gpt_causal_bf16", 8, 1024, 1024, 12, 64, bf16, None, True, None, 2e-2),
        # the llama-class variant's (phase 13b): the GQA repeat before the
        # kernels leaves 12 heads; a 512-token window at T = 1024
        ("llama_window_bf16", 8, 1024, 1024, 12, 64, bf16, None, True, 512, 2e-2),
        # generation's (phase 14): the bf16 full forward at the prompt
        ("gen_causal_bf16", 4, 32, 32, 12, 64, bf16, None, True, None, 2e-2),
        # the long-context LM's Ulysses arm (phase 24): after the exchange
        # each of the two sp ranks holds the whole sequence and 6 of 12 heads
        ("ulysses_causal_bf16", 1, 4096, 4096, 6, 64, bf16, None, True, None, 2e-2),
        # phase 25's pipelined GPT-124M: one microbatch of 2 rows, causal
        ("pipeline_mb_causal_bf16", 2, 1024, 1024, 12, 64, bf16, None, True, None, 2e-2),
        ("bert_f32", 16, 384, 384, 12, 64, f32, bert_lens, False, None, 2e-5),
        ("causal_window_d128", 2, 512, 512, 8, 128, bf16, None, True, 128, 2e-2),
        ("tq_ne_tk", 4, 100, 300, 12, 64, bf16, [300, 250, 17, 299], False, None, 2e-2),
        ("ragged_37", 4, 37, 37, 12, 64, f32, [37, 30, 1, 36], True, None, 2e-5),
        # one TMA box each way; boxes overhanging both ragged edges
        ("single_tile", 1, 64, 64, 1, 64, bf16, None, False, None, 2e-2),
        ("single_tile_d128", 1, 64, 64, 1, 128, bf16, None, False, None, 2e-2),
        ("ragged_129_257", 3, 129, 257, 12, 64, bf16, [257, 0, 130], False, None, 2e-2),
        ("d128_padding", 4, 384, 384, 12, 128, bf16, [384, 200, 1, 333], False, None, 2e-2),
        # head dims the kernels take zero-padded to 64 or 128
        ("head_dim_8", 4, 128, 128, 4, 8, bf16, [128, 100, 0, 7], False, None, 2e-2),
        ("head_dim_16", 2, 200, 200, 12, 16, f32, [200, 150], True, None, 2e-5),
        ("head_dim_96", 4, 384, 384, 12, 96, bf16, [384, 200, 1, 333], False, None, 2e-2),
    ]


#: the cases timed beside their bound, plain version and SDPA: phase 18's
#: classification shape (the summary's top level), the decoder's causal
#: shape (``gpt_shape``), the BERT QA shape of the earlier slices
#: (``bert_shape``), the long-context Ulysses shape (``ulysses_shape``) and
#: the pipeline's microbatch (``pipeline_shape``)
MAIN_CASE, GPT_CASE, BERT_CASE = "bert_cls_bf16", "gpt_causal_bf16", "bert_bf16"
ULYSSES_CASE, PIPELINE_CASE = "ulysses_causal_bf16", "pipeline_mb_causal_bf16"
#: plain versions at the GPT, Ulysses and pipeline shapes take milliseconds a
#: call: fewer samples
PLAIN_REPS = {MAIN_CASE: KERNEL_REPS, GPT_CASE: 5, BERT_CASE: KERNEL_REPS, ULYSSES_CASE: 3,
              PIPELINE_CASE: 5}

#: the padded head dims timed against SDPA, at BERT-base's batch and length
PADDED_HEAD_DIMS = (16, 96)


def make_inputs(B, Tq, Tk, H, D, dtype, lens, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(B, T, H, D, device="cuda", generator=g).to(dtype)
               for T in (Tq, Tk, Tk))
    mask = None
    if lens is not None:
        mask = (torch.arange(Tk, device="cuda")[None, :]
                < torch.tensor(lens, device="cuda")[:, None])
    return q, k, v, mask


def check_flash(seed: int) -> dict:
    """Hold the flash forward against its plain version in every case; time
    it at the main path's shape.  Returns the kernel's summary entry."""
    import torch
    import torch.nn.functional as F

    from tensorflowonspark_tpu_torch.devtime import host_us, time_in_turns, time_ms
    from tensorflowonspark_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_reference)

    timed = {}
    for i, (name, B, Tq, Tk, H, D, dtype, lens, causal, window, atol) in \
            enumerate(flash_cases(seed)):
        q, k, v, mask = make_inputs(B, Tq, Tk, H, D, dtype, lens, seed + i)
        before = flash_attention_fwd_launches()
        out, lse = flash_attention_fwd(q, k, v, mask=mask, causal=causal, window=window)
        torch.cuda.synchronize()
        if flash_attention_fwd_launches() != before + 1:
            raise SystemExit(f"flash case {name} did not launch the forward kernel once")
        want, want_lse = flash_attention_reference(q, k, v, mask=mask, causal=causal,
                                                   window=window)
        err = (out.float() - want.float()).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        ok = (torch.isfinite(out).all().item()
              and torch.allclose(out.float(), want.float(), atol=atol, rtol=1e-5)
              and torch.allclose(lse, want_lse, atol=atol, rtol=1e-5))
        if lens is not None and 0 in lens:
            row = lens.index(0)
            ok = ok and bool((out[row] == 0).all()) and bool((lse[row] == 1e30).all())
        log(f"flash {name}: B={B} Tq={Tq} Tk={Tk} H={H} D={D} {str(dtype)[6:]} "
            f"causal={causal} window={window}: max|out-plain|={err:.3g} "
            f"max|lse-plain|={lse_err:.3g} atol={atol} -> {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise SystemExit(f"flash kernel disagrees with its plain version in {name}")
        if name not in PLAIN_REPS:
            continue
        # a timed shape: the kernel and SDPA in turns, the plain version
        sdpa_kw = {"is_causal": True} if causal else {}
        if lens is not None:  # SDPA returns NaN on a fully masked row: give it its keys
            sdpa_mask = mask.clone()
            sdpa_mask[[i for i, n in enumerate(lens) if n == 0]] = True
            sdpa_kw = {"attn_mask": sdpa_mask[:, None, None, :]}
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kernel = lambda: flash_attention_fwd(q, k, v, mask=mask, causal=causal)  # noqa: E731
        turns = time_in_turns({"kernel": kernel, "sdpa": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, **sdpa_kw)}, KERNEL_REPS)
        kernel_ms, library_ms = turns["kernel"], turns["sdpa"]
        plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, mask=mask, causal=causal),
                           PLAIN_REPS[name])
        elt = q.element_size()
        bytes_moved = (3 * B * Tk * H * D * elt + B * Tq * H * D * elt   # q k v in, out
                       + B * H * Tq * 4 + (B * Tk if mask is not None else 0))  # lse, mask
        flops = 2 * 2 * B * H * D * visible_pairs(Tq, Tk, causal)   # two products
        timed[name] = {
            "max_abs_err": err, "tolerance": atol, "ms": kernel_ms, "plain_ms": plain_ms,
            "host_us": host_us(kernel), "library_timed": "in turns with the kernel",
            **bound(bytes_moved, flops), "library_ms": library_ms,
            "shape": f"B={B} T={Tq} H={H} D={D} bf16" + (" causal" if causal else ""),
            "achieved_tflops": flops / (kernel_ms * 1e-3) / 1e12,
        }
    return {"name": "flash_attention_fwd", "route": "cuda", "source": FLASH_SOURCE,
            "replaces": FLASH_REPLACES, "design": HOPPER_DESIGN, "launches": None,
            **timed[MAIN_CASE], "gpt_shape": timed[GPT_CASE], "bert_shape": timed[BERT_CASE],
            "ulysses_shape": timed[ULYSSES_CASE], "pipeline_shape": timed[PIPELINE_CASE]}


def visible_pairs(Tq: int, Tk: int, causal: bool) -> int:
    """(query, key) pairs a (batch, head) computes: all of them, or under
    causal masking (Tq == Tk) the lower triangle, T(T+1)/2: the work the
    kernels' causal trim leaves, which the bound counts."""
    return Tq * (Tq + 1) // 2 if causal and Tq == Tk else Tq * Tk


def flash_attention_fwd_launches() -> int:
    from tensorflowonspark_tpu_torch.ops import flash_attention

    return flash_attention.launches


def time_padded_head_dims(seed: int) -> dict:
    """The kernels at head dims they take zero-padded (``D`` in
    :data:`PADDED_HEAD_DIMS`, BERT-base's batch, length, heads and key
    padding, bf16), in turns with SDPA: forward against SDPA's forward,
    dQ + dK/dV against SDPA's backward.  ``{D: {name: ms}}``."""
    import torch
    import torch.nn.functional as F

    from tensorflowonspark_tpu_torch.devtime import time_in_turns
    from tensorflowonspark_tpu_torch.ops.flash_attention import (
        _delta, flash_attention_dkv, flash_attention_dq, flash_attention_fwd)

    lens = flash_cases(seed)[0][7]
    out = {}
    for D in PADDED_HEAD_DIMS:
        q, k, v, mask = make_inputs(16, SEQ_LEN, SEQ_LEN, 12, D, torch.bfloat16, lens, seed)
        g = torch.randn_like(q)
        o, lse = flash_attention_fwd(q, k, v, mask=mask)
        delta = _delta(o, g)
        sdpa_mask = mask.clone()                     # SDPA: NaN on a fully masked row
        sdpa_mask[lens.index(0)] = True
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=sdpa_mask[:, None, None, :])
        gt = g.transpose(1, 2)
        turns = time_in_turns({
            "fwd": lambda: flash_attention_fwd(q, k, v, mask=mask),
            "sdpa_fwd": lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=sdpa_mask[:, None, None, :]),
            "dq": lambda: flash_attention_dq(q, k, v, mask, g, lse, delta),
            "dkv": lambda: flash_attention_dkv(q, k, v, mask, g, lse, delta),
            "sdpa_bwd": lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), gt,
                                                    retain_graph=True)}, KERNEL_REPS)
        out[D] = {"padded_to": 64 if D <= 64 else 128, **turns,
                  "bwd": turns["dq"] + turns["dkv"]}
    return out


def bound(bytes_moved: int, flops: int) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the bf16 tensor-core peak."""
    bytes_ms = bytes_moved / H100_HBM_BYTES_PER_S * 1e3
    ops_ms = flops / H100_BF16_FLOPS * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": bytes_moved, "flops": flops}


def check_flash_bwd(seed: int) -> list[dict]:
    """Hold the dQ and dK/dV kernels against the plain backward in every
    case of :func:`flash_cases` (both fed the kernel forward's ``out`` and
    ``lse``); time each kernel at the main path's shape.  Returns the two
    kernels' summary entries."""
    import torch
    import torch.nn.functional as F

    from tensorflowonspark_tpu_torch.devtime import host_us, time_in_turns, time_ms
    from tensorflowonspark_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_reference, flash_attention_dkv,
        flash_attention_dkv_reference, flash_attention_dq, flash_attention_dq_reference,
        flash_attention_fwd)

    timed = {}
    for i, (name, B, Tq, Tk, H, D, dtype, lens, causal, window, _) in \
            enumerate(flash_cases(seed)):
        q, k, v, mask = make_inputs(B, Tq, Tk, H, D, dtype, lens, seed + 100 + i)
        g = torch.randn(q.shape, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(seed + i)).to(dtype)
        out, lse = flash_attention_fwd(q, k, v, mask=mask, causal=causal, window=window)
        before = (flash_attention_bwd.launches_dq, flash_attention_bwd.launches_dkv)
        got = flash_attention_bwd(q, k, v, mask, out, lse, g, causal=causal, window=window)
        torch.cuda.synchronize()
        if (flash_attention_bwd.launches_dq, flash_attention_bwd.launches_dkv) != tuple(
                n + 1 for n in before):
            raise SystemExit(f"flash case {name} did not launch each backward kernel once")
        want = flash_attention_bwd_reference(q, k, v, mask, out, lse, g, causal=causal,
                                             window=window)
        rel = BWD_REL_TOL[str(dtype)[6:]]
        errs, tols, ok = {}, {}, True
        for gname, a, b in zip(("dq", "dk", "dv"), got, want):
            errs[gname] = (a.float() - b.float()).abs().max().item()
            tols[gname] = rel * b.float().abs().max().item()
            ok = ok and bool(torch.isfinite(a).all()) and errs[gname] <= tols[gname]
        if lens is not None and 0 in lens:
            ok = ok and all(bool((a[lens.index(0)] == 0).all()) for a in got)
        log(f"flash bwd {name}: B={B} Tq={Tq} Tk={Tk} H={H} D={D} {str(dtype)[6:]} "
            f"causal={causal} window={window}: "
            + ", ".join(f"max|{n}-plain|={errs[n]:.3g} (tol {tols[n]:.3g})" for n in errs)
            + (" fully masked row all 0" if lens is not None and 0 in lens else "")
            + f" -> {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise SystemExit(f"flash backward kernels disagree with the plain version in {name}")
        if name not in PLAIN_REPS:
            continue
        # a timed shape: each kernel, the plain backward and SDPA's
        delta = (out.float() * g.float()).sum(-1).transpose(1, 2).contiguous()
        sdpa_kw = {"is_causal": True} if causal else {}
        if lens is not None:  # SDPA: NaN on a fully masked row
            sdpa_mask = mask.clone()
            sdpa_mask[[i for i, n in enumerate(lens) if n == 0]] = True
            sdpa_kw = {"attn_mask": sdpa_mask[:, None, None, :]}
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)
        gt = g.transpose(1, 2)
        dq_fn = lambda: flash_attention_dq(q, k, v, mask, g, lse, delta, causal)  # noqa: E731
        dkv_fn = lambda: flash_attention_dkv(q, k, v, mask, g, lse, delta, causal)  # noqa: E731
        turns = time_in_turns({"dq": dq_fn, "dkv": dkv_fn, "sdpa": lambda: torch.autograd.grad(
            sdpa_out, (qt, kt, vt), gt, retain_graph=True)}, KERNEL_REPS)
        dq_plain_ms = time_ms(lambda: flash_attention_dq_reference(
            q, k, v, mask, g, lse, delta, causal), PLAIN_REPS[name])
        dkv_plain_ms = time_ms(lambda: flash_attention_dkv_reference(
            q, k, v, mask, g, lse, delta, causal), PLAIN_REPS[name])
        elt = q.element_size()
        tensor = B * Tq * H * D * elt                # one of q, k, v, dO, dq, dk, dv
        rows = 2 * B * H * Tq * 4 + (B * Tk if mask is not None else 0)  # lse, delta, mask
        prod = 2 * B * H * D * visible_pairs(Tq, Tk, causal)  # one T x T x D product
        common = {"tolerance": rel, "tolerance_relative_to": "max |plain gradient|",
                  "library_ms": turns["sdpa"], "library_timed": "in turns with both kernels",
                  "shape": f"B={B} T={Tq} H={H} D={D} bf16" + (" causal" if causal else ""),
                  "library_note": "scaled_dot_product_attention backward: dq, dk and dv "
                                  "in one call; compare with dq ms + dkv ms"}
        timed[name] = (
            {"max_abs_err": errs["dq"], "ms": turns["dq"], "plain_ms": dq_plain_ms,
             "host_us": host_us(dq_fn), **common, **bound(5 * tensor + rows, 3 * prod),
             "achieved_tflops": 3 * prod / (turns["dq"] * 1e-3) / 1e12},
            {"max_abs_err": max(errs["dk"], errs["dv"]), "ms": turns["dkv"],
             "plain_ms": dkv_plain_ms, "host_us": host_us(dkv_fn), **common,
             **bound(6 * tensor + rows, 4 * prod),
             "achieved_tflops": 4 * prod / (turns["dkv"] * 1e-3) / 1e12})
    return [{"name": kname, "route": "cuda", "source": BWD_SOURCE, "replaces": replaces,
             "design": HOPPER_DESIGN, "launches": None, **timed[MAIN_CASE][j],
             "gpt_shape": timed[GPT_CASE][j], "bert_shape": timed[BERT_CASE][j],
             "ulysses_shape": timed[ULYSSES_CASE][j], "pipeline_shape": timed[PIPELINE_CASE][j]}
            for j, (kname, replaces) in enumerate((("flash_attention_dq", DQ_REPLACES),
                                                   ("flash_attention_dkv", DKV_REPLACES)))]


# ------------------------------------------------------------ model grads

#: the model-gradient gates, against the plain forward and backward: the
#: loss's |diff|; ||g - g_plain|| / ||g_plain|| over the parameters (max
#: and median); and, for the zero-in-theory gradients, max ||g - g_plain||
#: over the largest ||g_plain||.  Through all three kernels the error is
#: mostly K1's forward rounding carried through the bf16 model; the
#: backward kernels alone (under the plain forward) are held tighter.
#: Sound readings at seeds 0-2 reach 0.0036 / 0.085 / 0.0185 / 1.2e-5
#: (kernels) and 0.016 / 0.0066 / 6.1e-7 (backward alone); a zeroed dK
#: reads a max of 1.0 and a median of 0.013-0.023 (PERF.md, "Gate
#: calibration").  The max carries that fault: the median barely sees it
GRAD_TOL = {"loss": 1e-2, "max": 0.1, "median": 2e-2, "noise": 1e-3}
BWD_GRAD_TOL = {"max": 0.05, "median": 0.015, "noise": 1e-4}
GRAD_SEEDS = 3                     # weights and batch from --seed and the next two


def attention_fn(fwd: str, bwd: str, dk_scale: float = 1.0):
    """An ``attention_fn`` (BERT's, with a mask, or GPT's, causal with a
    window) whose forward is K1 (``"kernel"``) or its plain version
    (``"plain"``) and whose backward is K2 + K3 or the plain backward.
    ``dk_scale`` scales dK: 0 plants a fault (the keys get no gradient)
    that every gradient and weight gate must catch."""
    import torch

    from tensorflowonspark_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_reference, flash_attention_fwd,
        flash_attention_reference)

    forward = {"kernel": flash_attention_fwd, "plain": flash_attention_reference}[fwd]
    backward = {"kernel": flash_attention_bwd, "plain": flash_attention_bwd_reference}[bwd]

    class Attention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, mask, causal, window):
            out, lse = forward(q, k, v, mask, causal=causal, window=window)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.args = (mask, causal, window)
            return out

        @staticmethod
        def backward(ctx, grad_out):
            q, k, v, out, lse = ctx.saved_tensors
            mask, causal, window = ctx.args
            dq, dk, dv = backward(q, k, v, mask, out, lse, grad_out, causal=causal,
                                  window=window)
            return dq, dk * dk_scale, dv, None, None, None

    return lambda q, k, v, mask=None, causal=False, window=None: Attention.apply(
        q, k, v, mask, causal, window)


def grad_readings(grads: dict, plain: dict) -> dict:
    """``grads`` against ``plain`` as :data:`GRAD_TOL` reads them."""
    import numpy as np

    rel = {n: ((grads[n] - g).norm() / g.norm()).item()
           for n, g in plain.items() if not zero_in_theory(n)}
    top = max(g.norm().item() for g in plain.values())
    worst = max(rel, key=rel.get)
    return {"max": rel[worst], "worst": worst, "median": float(np.median(list(rel.values()))),
            "params": len(rel),
            "noise": max((grads[n] - g).norm().item() / top
                         for n, g in plain.items() if zero_in_theory(n))}


def within(readings: dict, tol: dict) -> bool:
    return all(readings[k] <= tol[k] for k in tol)


def check_model_grads(seed: int) -> None:
    """One BERT-base QA batch of 16 x 384 in bf16, the SQuAD loss's
    gradients through the kernels against those through the plain
    forward and plain backward, from the same weights, at ``GRAD_SEEDS``
    seeds.  Also prints the error of each half alone (kernel forward with
    the plain backward, and the reverse), and fails unless a planted fault
    (dK zeroed) falls outside the gate."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch import bert_inference as bi
    from tensorflowonspark_tpu_torch import bert_train as bt
    from tensorflowonspark_tpu_torch.models.bert import init_params

    fault_name = "kernels with dK x 0 (planted fault)"
    variants = {"kernels": "flash",
                "kernel fwd + plain bwd": attention_fn("kernel", "plain"),
                "plain fwd + kernel bwd": attention_fn("plain", "kernel"),
                fault_name: attention_fn("kernel", "kernel", dk_scale=0.0)}
    gates = {"kernels": GRAD_TOL, "plain fwd + kernel bwd": BWD_GRAD_TOL}
    sound, fault = [], None
    for s in range(seed, seed + GRAD_SEEDS):
        rows = bt.make_train_rows(BATCH_SIZE, SEQ_LEN, bi.BERT_BASE["vocab_size"], s)
        batch = bt.pad_batch([np.stack([r[c] for r in rows]) for c in range(5)], BATCH_SIZE)
        batch = tuple(torch.from_numpy(a).cuda() for a in batch)
        args = {"config": bi.BERT_BASE, "state_dict": init_params(bi.qa_config(bi.BERT_BASE), s)}

        def run(attention):
            model = bi.build_model(args, torch.device("cuda"), attention)
            loss = bt.squad_loss(model, batch)
            loss.backward()
            return loss.item(), {n: p.grad for n, p in model.named_parameters()}

        plain_loss, plain = run("reference")
        for name, attention in variants.items():
            if name == fault_name and s != seed:
                continue
            loss, grads = run(attention)
            r = {"loss": abs(loss - plain_loss), **grad_readings(grads, plain)}
            del grads
            log(f"model gradients, seed {s}, {name} vs plain (BERT-base QA, {BATCH_SIZE} x "
                f"{SEQ_LEN}, bf16): loss {loss:.6f} vs {plain_loss:.6f} (|diff| {r['loss']:.3g}"
                f"); ||g-g_plain||/||g_plain|| over {r['params']} parameters: max "
                f"{r['max']:.4g} ({r['worst']}), median {r['median']:.4g}; zero-in-theory: "
                f"max ||g-g_plain|| / largest ||g_plain|| {r['noise']:.3g}")
            if name in gates:
                sound.append((name, s, within(r, gates[name])))
            elif name == fault_name:
                fault = r
    for name, tol in gates.items():
        log(f"model-gradient gate for {name} {tol}: within it at "
            f"{sum(ok for n, _, ok in sound if n == name)} of {GRAD_SEEDS} seeds")
    log(f"planted fault {'outside' if not within(fault, GRAD_TOL) else 'INSIDE'} the "
        f"gate for kernels")
    if not all(ok for _, _, ok in sound):
        raise SystemExit("model gradients through the kernels disagree with the plain run")
    if within(fault, GRAD_TOL):
        raise SystemExit("the model-gradient gate does not see a zeroed dK")


def zero_in_theory(name: str, layers: int = BERT_LAYERS) -> bool:
    """Parameters whose gradient is zero in exact arithmetic and rounding
    noise in bf16: the QA-head bias and the last LayerNorm bias (the
    start/end softmax gradients sum to zero over positions) and the key
    biases (softmax ignores a per-row shift).  ``layers``: the model's
    depth."""
    return (name in ("qa_head.bias", f"bert.layers.{layers - 1}.ln_mlp.bias")
            or name.endswith("attn.key.bias"))


# --------------------------------------------------------------- main path

def run_main_path(seed: int, card: str, rows_n: int, batch_size: int) -> int:
    """Serve ``rows_n`` rows through the port's cluster; check the worker
    went through the kernel and agrees with the plain-attention run.
    Returns the worker's kernel launches."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch import bert_inference as bi
    from tensorflowonspark_tpu_torch.ops import flash_attention

    seq_len = 384
    rows = bi.make_rows(rows_n, seq_len, bi.BERT_BASE["vocab_size"], seed)
    n_batches = math.ceil(rows_n / batch_size)
    torch.cuda.empty_cache()

    zero_launch_counts()                 # counts start at 0 for the main path
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as wd:
        t0 = time.perf_counter()
        results, stats = bi.run_inference(rows, bi.BERT_BASE, seed=seed,
                                          batch_size=batch_size, num_workers=1,
                                          device="cuda", working_dir=wd, timeout=600)
        wall = time.perf_counter() - t0
    launches = sum(s["launches"] for s in stats)
    log(f"main path: {len(results)} rows served in {wall:.2f} s wall "
        f"(cluster boot, weights, {n_batches} batches, shutdown); worker kernel "
        f"launches={launches} (expected {BERT_LAYERS} x {n_batches} = "
        f"{BERT_LAYERS * n_batches}); driver launches={flash_attention.launches}")
    if len(results) != rows_n:
        raise SystemExit(f"main path returned {len(results)} of {rows_n} rows")
    if launches != BERT_LAYERS * n_batches:
        raise SystemExit("the main path did not go through the flash kernel once "
                         "per layer and batch")

    st = stats[0]
    steady = st["batch_ms"][1:] or st["batch_ms"]
    med = statistics.median(steady)
    shares = [a / b for a, b in zip(st["attention_ms"], st["batch_ms"])][1:]
    log(f"main path on {card}: median batch {med:.2f} ms over batches 2..{n_batches} "
        f"(first, with warm-up: {st['batch_ms'][0]:.2f} ms) = {batch_size / med * 1e3:.1f} "
        f"rows/s steady; end to end {rows_n / wall:.1f} rows/s; attention share of "
        f"a batch {statistics.median(shares or [0.0]):.3f} (CUDA events around "
        f"each call, host gaps included; per batch attention ms "
        f"{[round(x, 3) for x in st['attention_ms']]})")

    # the same weights and rows in this process, plain attention, on the card
    model = bi.build_model({"config": bi.BERT_BASE, "seed": seed}, torch.device("cuda"),
                           attention="reference")
    want_s, want_e = [], []
    with torch.inference_mode():
        for i in range(0, rows_n, batch_size):
            batch = [np.stack([r[c] for r in rows[i:i + batch_size]]) for c in range(3)]
            s, e = bi.forward_batch(model, batch, batch_size, "cuda")
            want_s.append(s)
            want_e.append(e)
    want_s, want_e = np.concatenate(want_s), np.concatenate(want_e)
    got_s = np.stack([r[0] for r in results])
    got_e = np.stack([r[1] for r in results])
    if got_s.shape != (rows_n, seq_len) or not (np.isfinite(got_s).all()
                                                 and np.isfinite(got_e).all()):
        raise SystemExit(f"bad logits: shape {got_s.shape}, finite "
                         f"{np.isfinite(got_s).all()} {np.isfinite(got_e).all()}")
    if flash_attention.launches != 0:
        raise SystemExit("the plain-attention run launched the kernel")
    err = max(np.abs(got_s - want_s).max(), np.abs(got_e - want_e).max())
    real = np.stack([r[1] for r in rows]).astype(bool)         # attention masks
    span = lambda lg: np.where(real, lg, -np.inf).argmax(axis=1)  # noqa: E731
    agree = float(np.mean((span(got_s) == span(want_s)) & (span(got_e) == span(want_e))))
    logit_atol, span_share = 0.1, 0.9
    log(f"main path vs plain attention (same weights, bf16): max|logit diff|={err:.4g} "
        f"(atol {logit_atol}; logit std {want_s.std():.3g}); identical argmax spans "
        f"{agree:.3f} (need >= {span_share})")
    if not (err <= logit_atol and agree >= span_share):
        raise SystemExit("the served logits disagree with the plain-attention run")
    return launches


#: the flash-attention kernels' names, as the summary line and the
#: workers' launch counts name them
KERNEL_NAMES = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv")


def zero_launch_counts() -> None:
    from tensorflowonspark_tpu_torch.ops.flash_attention import (flash_attention,
                                                                 flash_attention_bwd)

    flash_attention.launches = 0
    flash_attention_bwd.launches_dq = flash_attention_bwd.launches_dkv = 0


def run_training_path(seed: int, card: str, wd: str) -> tuple[dict, dict, dict]:
    """Fine-tune full-width BERT-base QA for ``TRAIN_STEPS`` steps through
    the port's cluster, checkpointing into ``<wd>/bert_model`` and
    exporting to ``<wd>/bert_export``; check each kernel launched 12 times
    a step and that every step's loss and the checkpoint's final weights
    agree with a plain-attention replay in this process
    (:data:`TRAIN_TOL`), and that the same gate rejects a replay through
    the kernels with dK zeroed; then checkpoint the replay's live state
    (sync and async) and restore it on the CPU bit for bit.  Returns the
    worker's launches of each kernel, the final weights (CPU) and the
    plain-attention replay (``losses``, final weights ``w_plain`` and
    initial ones ``w0``, on the card), which phase 11 reuses."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch import bert_inference as bi
    from tensorflowonspark_tpu_torch import bert_train as bt
    from tensorflowonspark_tpu_torch.checkpoint import restore_checkpoint
    from tensorflowonspark_tpu_torch.parallel import DataParallelStrategy

    rows = bt.make_train_rows(TRAIN_STEPS * BATCH_SIZE, SEQ_LEN,
                              bi.BERT_BASE["vocab_size"], seed)
    model_dir = os.path.join(wd, "bert_model")
    torch.cuda.empty_cache()
    zero_launch_counts()                   # counts start at 0 for the main path
    t0 = time.perf_counter()
    stats, weights = bt.run_training(
        rows, bi.BERT_BASE, seed=seed, batch_size=BATCH_SIZE, steps=TRAIN_STEPS,
        lr=TRAIN_LR, dropout=TRAIN_DROPOUT, num_workers=1, device="cuda",
        model_dir=model_dir, export_dir=os.path.join(wd, "bert_export"),
        working_dir=os.path.join(wd, "bert_train"), timeout=600)
    wall = time.perf_counter() - t0
    saved = restore_checkpoint(model_dir)
    if not (saved["step"] == TRAIN_STEPS and set(saved["optim"]["state"]) == set(weights)
            and all(set(s) == {"step", "exp_avg", "exp_avg_sq"}
                    for s in saved["optim"]["state"].values())):
        raise SystemExit("the worker's BERT checkpoint lacks its step or AdamW moments")
    st = stats[0]
    launches = st["launches"]
    want = BERT_LAYERS * TRAIN_STEPS
    log(f"training path: {len(st['losses'])} steps of {BATCH_SIZE} x {SEQ_LEN} in "
        f"{wall:.2f} s wall (cluster boot, weights, steps, shutdown); worker launches "
        f"{launches} (expected {BERT_LAYERS} x {TRAIN_STEPS} = {want} each); driver "
        f"launches {bt.kernel_launches()}")
    if len(st["losses"]) != TRAIN_STEPS or any(n != want for n in launches.values()):
        raise SystemExit("the training path did not go through every kernel once per "
                         "layer and step")
    if not all(math.isfinite(x) for x in st["losses"]):
        raise SystemExit(f"non-finite training loss: {st['losses']}")

    steady = st["step_ms"][1:]
    med = statistics.median(steady)
    cfg = bi.BERT_BASE
    hid, ffn, L = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_layers"]
    tokens = BATCH_SIZE * SEQ_LEN
    dense_params = L * (4 * hid * hid + 2 * hid * ffn) + 2 * hid
    # 6 N per token for the dense products (forward 2, backward 4), and the
    # attention's two T x T x D products a layer, also x3 for the backward
    flops = 6 * dense_params * tokens + 3 * L * 2 * (2 * BATCH_SIZE * SEQ_LEN * SEQ_LEN * hid)
    rate = flops / (med * 1e-3)
    log(f"training path on {card}: median step {med:.2f} ms over steps 2..{TRAIN_STEPS} "
        f"(first, with warm-up: {st['step_ms'][0]:.2f} ms; all {[round(x, 2) for x in st['step_ms']]}) "
        f"= {1e3 / med:.2f} steps/s, {tokens / med * 1e3:.0f} tokens/s; model "
        f"{flops / 1e12:.3f} TFLOP a step = {rate / 1e12:.1f} TFLOP/s = "
        f"{rate / H100_BF16_FLOPS:.4f} of 989 TFLOP/s")

    # the same steps in this process through the plain attention, forward
    # and backward (and then through the kernels with a planted fault): same
    # weights, batches and per-step generators
    def replay(attention):
        strategy = DataParallelStrategy("cuda", seed=seed)
        state = strategy.init_state(bt.build_train_model(
            {"config": cfg, "seed": seed, "dropout": TRAIN_DROPOUT},
            torch.device("cuda"), attention), bt.adamw(TRAIN_LR))
        w0 = {n: t.detach().clone() for n, t in state.module.state_dict().items()}
        step = strategy.build_train_step(bt.squad_loss)
        losses = []
        for i in range(TRAIN_STEPS):
            part = rows[i * BATCH_SIZE:(i + 1) * BATCH_SIZE]
            batch = bt.pad_batch([np.stack([r[c] for r in part]) for c in range(5)],
                                 BATCH_SIZE)
            state, metrics = step(state, strategy.shard_batch(batch))
            losses.append(float(metrics["loss"]))
        return losses, w0, state

    plain, w0, live = replay("reference")
    w_plain = live.module.state_dict()
    if any(bt.kernel_launches().values()):
        raise SystemExit("the plain-attention replay launched a kernel")
    readings = {"kernels (worker)": (st["losses"], {n: t.cuda() for n, t in weights.items()})}
    fault_name = "kernels with dK x 0 (planted fault)"
    fault_losses, _, fault_state = replay(attention_fn("kernel", "kernel", dk_scale=0.0))
    readings[fault_name] = (fault_losses, fault_state.module.state_dict())
    del fault_state
    log(f"training path, plain-attention replay: losses {[round(x, 5) for x in plain]}")
    verdict = {}
    for name, (losses, w) in readings.items():
        r = weight_readings(w, w_plain, w0)
        r["loss"] = max(abs(a - b) for a, b in zip(losses, plain))
        verdict[name] = within(r, TRAIN_TOL)
        log(f"training path, {name} vs the replay: losses {[round(x, 5) for x in losses]} "
            f"(max |diff| {r['loss']:.4g}); final weights ||w-w_plain||/||w_plain-w0|| over "
            f"{r['params']} parameters: max {r['max']:.4g} ({r['worst']}), median "
            f"{r['median']:.4g}; zero-in-theory: max |w-w_plain| {r['noise']:.3g} x lr x "
            f"steps")
    worker_ok = verdict["kernels (worker)"]
    log(f"training gate {TRAIN_TOL}: worker {'within' if worker_ok else 'OUTSIDE'}; "
        f"planted fault {'outside' if not verdict[fault_name] else 'INSIDE'}")
    if not worker_ok:
        raise SystemExit("the trained weights or losses disagree with the plain-attention "
                         "replay")
    if verdict[fault_name]:
        raise SystemExit("the training gate does not see a zeroed dK")
    check_checkpoint("BERT-base + AdamW", live.state_dict(), os.path.join(wd, "bert_live"))
    del live
    return launches, weights, {"losses": plain, "w_plain": w_plain, "w0": w0}


def _leaves(tree, path=()):
    """``(path, leaf)`` pairs of a nested dict/list, dict keys as strings
    (as a restore without a target gives them)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def check_checkpoint(what: str, live: dict, prefix: str) -> dict:
    """Save the live training state ``live`` (tensors on the card) through
    a ``CheckpointManager``, sync and then async, and restore each on the
    CPU with no target: every leaf must equal the live one bit for bit
    (tensors in dtype and value, the step, the input position).  Logs and
    returns the MB, the seconds until ``save`` returns and until the save
    is durable, and the restore's seconds."""
    import torch

    from tensorflowonspark_tpu_torch.checkpoint import CheckpointManager, restore_checkpoint

    want = dict(_leaves(live))
    mb = sum(t.numel() * t.element_size() for t in want.values() if torch.is_tensor(t)) / 1e6
    step = int(live["step"])
    readings = {"MB": mb}
    for mode in ("sync", "async"):
        path = f"{prefix}_{mode}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mngr = CheckpointManager(path, async_save=mode == "async")
        mngr.save(step, live)
        returned = time.perf_counter() - t0
        mngr.close()
        durable = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = dict(_leaves(restore_checkpoint(path)))
        restore_s = time.perf_counter() - t0
        bad = [p for p, t in want.items() if p not in got or (
            (got[p].dtype != t.dtype or not torch.equal(got[p], t.cpu()))
            if torch.is_tensor(t) else got[p] != t)]
        if bad or set(got) != set(want):
            raise SystemExit(f"{what}: the {mode} checkpoint does not restore bit for bit "
                             f"on the CPU: {bad[:4] or sorted(set(got) ^ set(want))[:4]}")
        readings[mode] = {"save_returns_s": returned, "durable_s": durable,
                          "restore_s": restore_s}
        log(f"checkpoint {what}, {mode}: {mb:.1f} MB ({len(want)} leaves), save returns in "
            f"{returned:.3f} s, durable in {durable:.3f} s ({mb / durable:.0f} MB/s); "
            f"restore on the CPU {restore_s:.3f} s ({mb / restore_s:.0f} MB/s); every leaf "
            f"bit for bit")
    return readings


def run_export_serving(seed: int, card: str, wd: str, weights: dict) -> int:
    """Serve the 64 inference rows through ``cluster.inference`` from the
    chief's export (``<wd>/bert_export``): K1 12 times a batch inside the
    exported program, and logits against the eager model of the same
    weights within :data:`EXPORT_TOL`, which an export whose attention
    zeroes V must fail; time the exported and the eager batch in turns
    and an export of BERT-base.  Returns the worker's K1 launches."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch import bert_inference as bi
    from tensorflowonspark_tpu_torch import bert_train as bt
    from tensorflowonspark_tpu_torch.checkpoint import ExportedModel
    from tensorflowonspark_tpu_torch.ops import flash_attention

    export_dir = os.path.join(wd, "bert_export")
    rows = bi.make_rows(ROWS, SEQ_LEN, bi.BERT_BASE["vocab_size"], seed)
    n_batches = math.ceil(ROWS / BATCH_SIZE)
    torch.cuda.empty_cache()
    zero_launch_counts()                   # counts start at 0 for the main path
    t0 = time.perf_counter()
    results, stats = bi.run_inference(rows, export_dir=export_dir, batch_size=BATCH_SIZE,
                                      num_workers=1, device="cuda",
                                      working_dir=os.path.join(wd, "bert_serve"), timeout=600)
    wall = time.perf_counter() - t0
    launches = stats[0]["launches"]
    log(f"export serving path: {len(results)} rows served from the export in {wall:.2f} s "
        f"wall (cluster boot, export load, {n_batches} batches, shutdown); worker K1 "
        f"launches {launches} (expected {BERT_LAYERS} x {n_batches} = "
        f"{BERT_LAYERS * n_batches}); median batch {statistics.median(stats[0]['batch_ms'][1:]):.2f} ms")
    if len(results) != ROWS or launches != BERT_LAYERS * n_batches:
        raise SystemExit("the exported program did not serve every row through K1 once per "
                         "layer and batch")
    got = (np.stack([r[0] for r in results]), np.stack([r[1] for r in results]))

    eager = bi.build_model({"config": bi.BERT_BASE, "state_dict": weights},
                           torch.device("cuda"), "flash")
    batches = [[np.stack([r[c] for r in rows[i:i + BATCH_SIZE]]) for c in range(3)]
               for i in range(0, ROWS, BATCH_SIZE)]

    def score(model):
        with torch.inference_mode():
            outs = [bi.forward_batch(model, b, BATCH_SIZE, "cuda") for b in batches]
        return tuple(np.concatenate([o[j] for o in outs]) for j in range(2))

    want = score(eager)
    masks = np.stack([r[1] for r in rows]).astype(bool)
    sound = export_readings(got, want, masks)

    fault_model = bi.build_model(
        {"config": bi.BERT_BASE, "state_dict": weights}, torch.device("cuda"),
        lambda q, k, v, mask=None: flash_attention(q, k, torch.zeros_like(v), mask=mask))
    t0 = time.perf_counter()
    bt.export(os.path.join(wd, "bert_export_fault"), fault_model, SEQ_LEN)
    export_s = time.perf_counter() - t0
    fault = export_readings(score(ExportedModel.load(os.path.join(wd, "bert_export_fault"))),
                            want, masks)
    for name, r in (("export (worker)", sound), ("export with V zeroed (planted fault)", fault)):
        log(f"export serving, {name} vs the eager model (same weights): max|logit diff| / "
            f"max|logit| {r['logits']:.3g}; identical argmax spans {r['spans']:.3f}")
    log(f"export gate {EXPORT_TOL}: worker {'within' if within_export(sound) else 'OUTSIDE'}; "
        f"planted fault {'outside' if not within_export(fault) else 'INSIDE'}; exporting "
        f"BERT-base (trace on the CPU, 440 MB of weights) took {export_s:.2f} s")
    if not within_export(sound):
        raise SystemExit("the exported program's logits disagree with the eager model")
    if within_export(fault):
        raise SystemExit("the export gate does not see an attention with V zeroed")

    exported = ExportedModel.load(export_dir)
    batch = batches[0]
    turns = {"eager": [], "export": []}
    for r in range(2 * EXPORT_TIMING_ROUNDS):
        for name in (("eager", "export") if r % 2 == 0 else ("export", "eager")):
            model = eager if name == "eager" else exported
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                bi.forward_batch(model, batch, BATCH_SIZE, "cuda")   # ends in .cpu(): synced
            turns[name].append((time.perf_counter() - t0) * 1e3)
    log(f"BERT-base inference batch ({BATCH_SIZE} x {SEQ_LEN}) on {card}, host clock to the "
        f"logits on the host, in turns, {2 * EXPORT_TIMING_ROUNDS} each: exported "
        f"{statistics.median(turns['export'][2:]):.3f} ms, eager "
        f"{statistics.median(turns['eager'][2:]):.3f} ms (medians after 2 warm-up calls)")
    return launches


#: the export gate, exported program against the eager model with the same
#: weights: max |logit diff| over max |logit| (start and end), and the share
#: of rows whose argmax spans are identical.  Both run the same operations
#: and kernels, so the sound reading is ~0; V zeroed changes every logit
EXPORT_TOL = {"logits": 1e-2, "spans": 0.99}
EXPORT_TIMING_ROUNDS = 10


def export_readings(got, want, masks) -> dict:
    """``got`` (start, end logits) against ``want`` as :data:`EXPORT_TOL`
    reads them, spans over the real tokens ``masks``."""
    import numpy as np

    span = lambda lg: np.where(masks, lg, -np.inf).argmax(axis=1)  # noqa: E731
    top = max(np.abs(want[0]).max(), np.abs(want[1]).max())
    err = max(np.abs(got[0] - want[0]).max(), np.abs(got[1] - want[1]).max())
    spans = float(np.mean((span(got[0]) == span(want[0])) & (span(got[1]) == span(want[1]))))
    return {"logits": err / top, "spans": spans}


def within_export(r: dict) -> bool:
    return r["logits"] <= EXPORT_TOL["logits"] and r["spans"] >= EXPORT_TOL["spans"]


def weight_readings(w: dict, w_plain: dict, w0: dict, zero: set | None = None,
                    lr_steps: float = TRAIN_LR * TRAIN_STEPS) -> dict:
    """Final weights ``w`` against the replay's ``w_plain`` (both from
    ``w0``) as :data:`TRAIN_TOL` reads them.  A zero-in-theory parameter
    (``zero``; default BERT's, :func:`zero_in_theory`) moves by Adam's
    noise-driven steps in both runs, so it is held only to Adam's bound, in
    units of ``lr x steps``."""
    import numpy as np

    if zero is None:
        layers = 1 + max(int(n.split(".")[2]) for n in w_plain if n.startswith("bert.layers."))
        zero = {n for n in w_plain if zero_in_theory(n, layers)}
    rel = {n: ((w[n] - p).norm() / (p - w0[n]).norm()).item()
           for n, p in w_plain.items() if n not in zero}
    worst = max(rel, key=rel.get)
    return {"max": rel[worst], "worst": worst, "median": float(np.median(list(rel.values()))),
            "params": len(rel),
            "noise": max(((w[n] - w_plain[n]).abs().max().item() for n in zero), default=0.0)
            / lr_steps}


# ------------------------------------------------------------------ ResNet

#: the ResNet-50 card-vs-CPU gates: max |logit diff| over max |logit|; the
#: loss's |diff|; ||g - g_cpu|| / ||g_cpu|| over the parameters (max and
#: median); max |g| where the CPU gradient is 0 (none at the gate's
#: scales); and for the BatchNorm buffers after the step, ||b - b_cpu|| /
#: ||b_cpu - b0|| (max).  Set from the readings of ``--calibrate-resnet``
#: at seeds 0-2, batches 8 and 2 (PERF.md, "Gate calibration" of the
#: ResNet slice): sound bf16 runs reach 0.0053 / 0.0010 / 0.347 / 0.252 /
#: 0 / 0.0054, float32 ones 5.2e-7 / 9.5e-7 / 0.0076 / 0.0028 / 0 / 3.3e-6;
#: the planted fault reads 0.064 / 0.0033 / 1.46 / 0.84 / 0 / 0.24 at
#: batch 8, outside every bound but the loss's
RESNET_TOL = {"logits": 2e-2, "loss": 5e-3, "max": 0.6, "median": 0.4, "zero": 1e-6,
              "buffers": 0.03}
RESNET_F32_TOL = {"logits": 1e-5, "loss": 1e-5, "max": 0.05, "median": 1e-2, "zero": 1e-6,
                  "buffers": 1e-4}
RESNET_GATE_BATCH, RESNET_IMAGE = 8, 224
#: the gate's BatchNorm scales: U(0.5, 1.5), each block's last U(0.05,
#: 0.15).  Every gradient is live, and the residual path still dominates
#: as it does in training from flax's zero init; with every scale from
#: U(0.5, 1.5) the BatchNorm-ReLU stacks at init make the step chaotic
#: (bf16 gradients read a median of 1.28 against float32, float32 on the
#: card 0.015-0.02 against the CPU), and no tolerance separates a fault
RESNET_GATE_SCALES = (0.5, 1.5, 0.05, 0.15)
#: the regimes ``--calibrate-resnet`` reads, at batches 8 and 2
RESNET_CALIBRATION_SCALES = ((0.5, 1.5), (0.5, 1.5, 0.2, 0.4), RESNET_GATE_SCALES)
#: the ResNet-50 training gate, against the in-process replay (the same
#: batches; cuDNN autotunes its algorithms in each process, so the bf16
#: roundings differ): each step's loss |diff|; ||w - w_replay|| /
#: ||w_replay - w0|| over the parameters and BatchNorm buffers (max and
#: median).  Seeds 0 / 1 / 2 read 0.00019 / 0.71 / 0.147, 0.00016 / 0.67 /
#: 0.124 and 0.00037 / 0.87 / 0.136: the gradients' ~17% bf16 noise
#: compounds over 8 steps; two batches of the same run differ in loss by
#: 0.04-0.29, and a chief that saved its initial weights reads 1.0
RESNET_TRAIN = {"batch_size": 128, "image_size": 224, "steps": 8, "num_samples": 1024}
RESNET_TRAIN_TOL = {"loss": 1e-2, "max": 1.5, "median": 0.3}
MNIST_ROWS, MNIST_BATCH = 4096, 64


def resnet_step_readings(sd: dict, x, y, device: str, dtype):
    """One train-mode forward and backward of ResNet-50 with weights
    ``sd`` on ``device`` (``dtype`` convolutions, float32 BatchNorm;
    channels_last on the card).  Returns ``(logits, loss, grads,
    buffers)`` on the CPU in float32."""
    import torch
    import torch.nn.functional as F

    from tensorflowonspark_tpu_torch.models import resnet

    model = resnet.ResNet50(dtype=dtype, norm_dtype=torch.float32)
    model.load_state_dict(sd)
    model = model.to(device)
    x = x.to(device)
    if device == "cuda":
        model = model.to(memory_format=torch.channels_last)
        x = x.contiguous(memory_format=torch.channels_last)
    logits = model(x, train=True)
    loss = F.cross_entropy(logits, y.to(device))
    loss.backward()
    return (logits.detach().float().cpu(), loss.item(),
            {n: p.grad.float().cpu() for n, p in model.named_parameters()},
            {n: b.float().cpu() for n, b in model.named_buffers()})


def resnet_gate(card_run, cpu_run, b0: dict) -> dict:
    """The card's step against the CPU's as :data:`RESNET_TOL` reads it."""
    import numpy as np

    logits, loss, grads, bufs = card_run
    ref_logits, ref_loss, ref_grads, ref_bufs = cpu_run
    rel = {n: ((grads[n] - g).norm() / g.norm()).item() for n, g in ref_grads.items()
           if g.norm() > 0}
    worst = max(rel, key=rel.get)
    brel = {n: ((bufs[n] - b).norm() / (b - b0[n]).norm()).item() for n, b in ref_bufs.items()}
    bworst = max(brel, key=brel.get)
    return {"logits": ((logits - ref_logits).abs().max() / ref_logits.abs().max()).item(),
            "loss": abs(loss - ref_loss), "max": rel[worst], "worst": worst,
            "median": float(np.median(list(rel.values()))), "params": len(rel),
            "zero": max((grads[n].abs().max().item() for n in ref_grads if n not in rel),
                        default=0.0),
            "buffers": brel[bworst], "worst_buffer": bworst}


def check_resnet_grads(seed: int, batch: int = RESNET_GATE_BATCH,
                       scales: tuple = RESNET_GATE_SCALES, gate: bool = True) -> None:
    """Full-width ResNet-50 with flax's initial kernels from the seed and
    BatchNorm scales drawn as ``scales`` says (``resnet.init_params``; at
    flax's init each block's last scale of 0 silences its branch, and with
    it every convolution but the stem and the shortcuts), one train-mode
    step at ``RESNET_IMAGE`` px, batch ``batch``: the card with bf16
    convolutions (:data:`RESNET_TOL`) and with float32 ones
    (:data:`RESNET_F32_TOL`) against the port's float32 path on the CPU,
    at ``GRAD_SEEDS`` seeds; a planted fault (symmetric padding of the
    strided 3x3 convolutions, bf16) must fall outside the bf16 gate.  With
    ``gate`` false it only logs the readings (``--calibrate-resnet``)."""
    from unittest import mock

    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.models import resnet

    fault_name = "card bf16, strided 3x3 padded (1, 1) (planted fault)"
    gates = {"card bf16": RESNET_TOL, "card float32": RESNET_F32_TOL}
    fault, sound = None, []
    for s in range(seed, seed + GRAD_SEEDS):
        sd = resnet.init_params(resnet.ResNet50(), s, scales)
        rng = np.random.default_rng([s, 2])
        x = torch.from_numpy(rng.standard_normal(
            (batch, 3, RESNET_IMAGE, RESNET_IMAGE), np.float32))
        y = torch.from_numpy(rng.integers(0, 1000, batch).astype(np.int64))
        b0 = {n: t.clone() for n, t in sd.items() if "running" in n}
        t0 = time.perf_counter()
        cpu = resnet_step_readings(sd, x, y, "cpu", torch.float32)
        cpu_s = time.perf_counter() - t0
        runs = {"card bf16": resnet_step_readings(sd, x, y, "cuda", torch.bfloat16),
                "card float32": resnet_step_readings(sd, x, y, "cuda", torch.float32)}
        if s == seed:
            with mock.patch.object(resnet, "same_padding",
                                   lambda size, k, stride: ((k - 1) // 2, (k - 1) // 2)):
                runs[fault_name] = resnet_step_readings(sd, x, y, "cuda", torch.bfloat16)
        for name, run in runs.items():
            r = resnet_gate(run, cpu, b0)
            log(f"ResNet-50 step, scales {scales}, seed {s}, {name} vs the CPU float32 path ({batch}"
                f" x {RESNET_IMAGE} px; CPU {cpu_s:.1f} s): loss {run[1]:.6f} vs {cpu[1]:.6f} "
                f"(|diff| {r['loss']:.3g}); max|logit diff|/max|logit| {r['logits']:.4g}; "
                f"||g-g_cpu||/||g_cpu|| over {r['params']} parameters: max {r['max']:.4g} "
                f"({r['worst']}), median {r['median']:.4g}; max |g| where g_cpu = 0: "
                f"{r['zero']:.3g}; BatchNorm buffers ||b-b_cpu||/||b_cpu-b0||: max "
                f"{r['buffers']:.4g} ({r['worst_buffer']})")
            if name == fault_name:
                fault = r
            else:
                sound.append((name, within(r, gates[name])))
    for name, tol in gates.items():
        log(f"ResNet-50 gate for {name} {tol}: within it at "
            f"{sum(ok for n, ok in sound if n == name)} of {GRAD_SEEDS} seeds")
    log(f"planted fault {'outside' if not within(fault, RESNET_TOL) else 'INSIDE'} the bf16 "
        f"gate")
    if not gate:
        return
    if not all(ok for _, ok in sound):
        raise SystemExit("ResNet-50 on the card disagrees with the port's CPU path")
    if within(fault, RESNET_TOL):
        raise SystemExit("the ResNet-50 gate does not see symmetric strided padding")


def resnet_train_readings(losses, replay, weights: dict, w_replay: dict, w0: dict) -> dict:
    """A run against the replay as :data:`RESNET_TRAIN_TOL` reads it:
    each step's loss |diff|, and ``||w - w_replay|| / ||w_replay - w0||``
    over the parameters and BatchNorm buffers (max and median)."""
    import numpy as np

    rel = {}
    for n, w in w_replay.items():
        moved, diff = ((t - w0[n]).float().norm().item() for t in (w, weights[n]))
        rel[n] = (weights[n] - w).float().norm().item() / moved if moved else float(diff > 0)
    worst = max(rel, key=rel.get)
    return {"loss": max(abs(a - b) for a, b in zip(losses, replay)), "max": rel[worst],
            "worst": worst, "median": float(np.median(list(rel.values()))),
            "tensors": len(rel)}


def run_resnet_training(seed: int, card: str, wd: str) -> dict:
    """ResNet-50 from TFRecords with a resume, at full width: write the
    worker's uint8 shard as TFRecords (a decoded batch must equal the array
    batch byte for byte), train 4 steps through ``TPUCluster.run`` into a
    ``model_dir``, resume in a new cluster for steps 5-8, and hold the
    losses and the final checkpoint to an unbroken replay in this process
    over the same records (:data:`RESNET_TRAIN_TOL`); a resume from the
    step-4 checkpoint without its momentum must fall outside the gate.
    Also checkpoints a live ResNet-50 + SGD state on the card and restores
    it on the CPU bit for bit.  Returns the resumed worker's launches of
    each kernel."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch import resnet_train as rt
    from tensorflowonspark_tpu_torch.checkpoint import restore_checkpoint

    data_dir = os.path.join(wd, "resnet_records")
    args = {**RESNET_TRAIN, "model": "ResNet50", "seed": seed, "device": "cuda",
            "data_dir": data_dir}
    batch, steps, classes = RESNET_TRAIN["batch_size"], RESNET_TRAIN["steps"], 1000
    t0 = time.perf_counter()
    records = rt.write_tfrecords(args, data_dir, 1, classes)
    write_s = time.perf_counter() - t0
    mb = sum(os.path.getsize(os.path.join(data_dir, f)) for f in os.listdir(data_dir)) / 1e6
    t0 = time.perf_counter()
    decoded = list(rt.examples(args, 0, 1, classes))
    read_s = time.perf_counter() - t0
    images, labels = rt.uint8_shard(args, 0, 1, classes)
    log(f"TFRecords (ResNet-50 shard, {records} records of 224x224x3 uint8 + label, "
        f"{mb:.1f} MB): written in {write_s:.3f} s ({mb / write_s:.0f} MB/s, "
        f"{records / write_s:.0f} records/s); read and decoded in {read_s:.3f} s "
        f"({mb / read_s:.0f} MB/s, {records / read_s:.0f} records/s)")
    got_x = np.stack([x for x, _ in decoded[:batch]])
    got_y = np.array([y for _, y in decoded[:batch]])
    if not (got_x.tobytes() == images[:batch].tobytes() and np.array_equal(got_y, labels[:batch])
            and len(decoded) == len(images)):
        raise SystemExit("a decoded TFRecord batch differs from the array batch")
    del decoded

    model_dir = os.path.join(wd, "resnet_model")

    def run(name, **kw):
        t0 = time.perf_counter()
        stats, weights = rt.run_training({**args, **kw}, 1, working_dir=os.path.join(wd, name),
                                         timeout=600)
        return stats[0], weights, time.perf_counter() - t0

    torch.cuda.empty_cache()
    first, _, wall1 = run("resnet_first", steps=steps // 2, model_dir=model_dir)
    saved = restore_checkpoint(model_dir)                 # the worker's, on the CPU
    params = [n for n, _ in rt.build_model(args).named_parameters()]
    if not (saved["step"] == steps // 2 and saved["data"] == {"elements_consumed": steps // 2}
            and sorted(saved["optim"]["state"]) == sorted(params)
            and all("momentum_buffer" in s for s in saved["optim"]["state"].values())):
        raise SystemExit("the worker's ResNet-50 checkpoint lacks its step, input position "
                         "or momentum")
    zero_launch_counts()                   # counts start at 0 for the main path
    second, weights, wall2 = run("resnet_second", model_dir=model_dir)
    if (first["first_step"], len(first["losses"]), second["first_step"],
            len(second["losses"])) != (0, steps // 2, steps // 2, steps // 2):
        raise SystemExit(f"the resumed run did not train steps {steps // 2 + 1}-{steps}")
    if second["device"] != "cuda" or not all(math.isfinite(x) for x in
                                             first["losses"] + second["losses"]):
        raise SystemExit("the ResNet-50 runs did not train on the card")
    log(f"ResNet-50 from TFRecords: steps 1-{steps // 2} in {wall1:.2f} s wall, resumed steps "
        f"{steps // 2 + 1}-{steps} in {wall2:.2f} s wall (cluster boot, restore, steps, "
        f"checkpoint, shutdown) on {second['device']}; worker launches of the repo's kernels "
        f"{second['launches']}")
    step_ms = first["step_ms"][1:] + second["step_ms"][1:]
    med = statistics.median(step_ms)
    log(f"ResNet-50 training path on {card}: median step {med:.3f} ms over both runs' steps "
        f"after their first (first steps, with cuDNN autotuning: {first['step_ms'][0]:.1f} / "
        f"{second['step_ms'][0]:.1f} ms) = {batch / med * 1e3:.1f} img/s")

    w0 = rt.build_model(args).state_dict()
    replay, w_replay = rt.train_in_process(args, 1, "cuda")
    losses = first["losses"] + second["losses"]
    sound = resnet_train_readings(losses, replay, weights, w_replay, w0)
    # the planted fault resumes in this process (no third cluster boot: cut
    # for time), from the step-4 checkpoint stripped of its momentum
    fault_losses, fault_w = rt.train_in_process(
        args, 1, "cuda", restored={**saved, "optim": {**saved["optim"], "state": {}}})
    fault = resnet_train_readings(first["losses"] + fault_losses, replay, fault_w,
                                  w_replay, w0)
    buffers = [n for n in w_replay if "running" in n]
    unmoved = [n for n in buffers if torch.equal(weights[n], w0[n])]
    log(f"ResNet-50 replay (unbroken, same records): losses {[round(x, 5) for x in replay]}")
    for name, r, ls in (("resumed run", sound, losses),
                        ("resumed without momentum in this process (planted fault)", fault,
                         first["losses"] + fault_losses)):
        log(f"ResNet-50 {name} vs the replay: losses {[round(x, 5) for x in ls]} (max |diff| "
            f"{r['loss']:.4g}); final weights and buffers ||w-w_replay||/||w_replay-w0|| over "
            f"{r['tensors']} tensors: max {r['max']:.4g} ({r['worst']}), median "
            f"{r['median']:.4g}")
    log(f"ResNet-50 resume gate {RESNET_TRAIN_TOL}: resumed run "
        f"{'within' if within(sound, RESNET_TRAIN_TOL) else 'OUTSIDE'}; planted fault "
        f"{'outside' if not within(fault, RESNET_TRAIN_TOL) else 'INSIDE'}; BatchNorm "
        f"buffers moved: {len(buffers) - len(unmoved)} of {len(buffers)}")
    if not within(sound, RESNET_TRAIN_TOL):
        raise SystemExit(f"the resumed ResNet-50 run disagrees with its replay "
                         f"{RESNET_TRAIN_TOL}")
    if within(fault, RESNET_TRAIN_TOL):
        raise SystemExit("the resume gate does not see a resume without momentum")
    if unmoved:
        raise SystemExit(f"BatchNorm buffers did not move: {unmoved[:4]}")

    # a live state on the card: 2 steps of the same records, then checkpointed
    state, step = rt.strategy_state(args, torch.device("cuda"))
    data = rt.batches({**args, "steps": 2}, 0, 1, classes)
    for b in data:
        state, _ = step(state, tuple(t.cuda() for t in b))
    check_checkpoint("ResNet-50 + SGD momentum", rt.checkpoint_state(state, 2),
                     os.path.join(wd, "resnet_live"))
    del state
    return second["launches"]


def run_mnist_training(seed: int, card: str, wd: str) -> dict:
    """Write ``MNIST_ROWS`` synthetic rows as TFRecords, read them back in
    the driver with ``loadTFRecords`` and feed them through
    ``cluster.train`` into ``mnist_train.map_fun`` (one worker on the
    card): every row consumed, the loss falls, the shared-memory transport
    negotiated.  The chief's export must serve on the card within
    :data:`MNIST_EXPORT_TOL` of the eager model, and so must an export
    written by a process that sees no card; the card's export must serve on
    the CPU.  Returns the worker's launches of each kernel."""
    import subprocess

    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch import mnist_train as mt
    from tensorflowonspark_tpu_torch.checkpoint import ExportedModel

    images, labels = mt.synthetic_mnist(MNIST_ROWS, seed)
    data_dir = os.path.join(wd, "mnist_records")
    t0 = time.perf_counter()
    mt.write_tfrecords(images, labels, data_dir, num_partitions=4)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = mt.rows_from_tfrecords(data_dir)
    read_s = time.perf_counter() - t0
    if not all(np.array_equal(x, images[i]) and y == labels[i] for i, (x, y) in enumerate(rows)):
        raise SystemExit("the MNIST rows read back from TFRecords differ from the arrays")
    log(f"TFRecords (MNIST, {MNIST_ROWS} records of 784 floats + label): written in "
        f"{write_s:.3f} s ({MNIST_ROWS / write_s:.0f} records/s); loadTFRecords into a "
        f"DataFrame and rows in {read_s:.3f} s ({MNIST_ROWS / read_s:.0f} records/s)")
    export_dir, model_dir = os.path.join(wd, "mnist_export"), os.path.join(wd, "mnist_model")
    zero_launch_counts()                   # counts start at 0 for the main path
    t0 = time.perf_counter()
    stats, weights = mt.run_training(rows, seed=seed, batch_size=MNIST_BATCH, num_workers=1,
                                     device="cuda", model_dir=model_dir, export_dir=export_dir,
                                     working_dir=os.path.join(wd, "mnist_train"), timeout=600)
    wall = time.perf_counter() - t0
    st = stats[0]
    losses = st["losses"]
    first, last = float(np.mean(losses[:8])), float(np.mean(losses[-8:]))
    log(f"MNIST driver-fed path on {card}: {st['rows']} of {MNIST_ROWS} rows in "
        f"{len(losses)} steps of {MNIST_BATCH}, {wall:.2f} s wall ({MNIST_ROWS / wall:.0f} "
        f"rows/s end to end, checkpoint and export included; median step "
        f"{statistics.median(st['step_ms']):.3f} ms) on {st['device']}; loss, mean of the first "
        f"8 steps {first:.4f}, of the last 8 {last:.4f}; shm connections {st['shm_conns']}; "
        f"worker launches of the repo's kernels {st['launches']}")
    if st["rows"] != MNIST_ROWS or st["device"] != "cuda":
        raise SystemExit("the MNIST path did not consume every fed row on the card")
    if not (all(math.isfinite(x) for x in losses) and last < 0.5 * first):
        raise SystemExit(f"the MNIST loss did not fall: {first} -> {last}")
    if st["shm_conns"] < 1:
        raise SystemExit("the MNIST feed did not go through the shared-memory transport")

    # an export written by a process that sees no card
    cpu_export = os.path.join(wd, "mnist_export_cpu")
    code = ("import sys, torch\n"
            "from tensorflowonspark_tpu_torch import mnist_train as mt\n"
            "from tensorflowonspark_tpu_torch.checkpoint import restore_checkpoint\n"
            "assert not torch.cuda.is_available()\n"
            "model = mt.build_model({'state_dict': restore_checkpoint(sys.argv[1])['model']})\n"
            "mt.export(sys.argv[2], model)\n")
    proc = subprocess.run([sys.executable, "-c", code, model_dir, cpu_export],
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, capture_output=True,
                          text=True, timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise SystemExit(f"the CPU process could not write the MNIST export:\n{proc.stderr}")
    x = images[:MNIST_BATCH]
    readings = {}
    for device in ("cuda", "cpu"):
        model = mt.build_model({"state_dict": weights}).to(device)
        with torch.no_grad():
            want = torch.softmax(model(torch.from_numpy(x).to(device)), -1).cpu()
        for name, d in (("chief's export (a card process)", export_dir),
                        ("export written without a card", cpu_export)):
            exported = ExportedModel.load(d, device=device)
            probs = exported(image=x[..., None])["prob"]
            if probs.device.type != device:
                raise SystemExit(f"the MNIST export served on {probs.device}, not {device}")
            readings[(name, device)] = (probs.cpu() - want).abs().max().item()
    log("MNIST exports against the eager model's probabilities (same weights, "
        f"{MNIST_BATCH} rows): " + "; ".join(f"{n} served on {dev}: max |diff| {err:.3g}"
                                             for (n, dev), err in readings.items())
        + f" (tolerance {MNIST_EXPORT_TOL})")
    if max(readings.values()) > MNIST_EXPORT_TOL:
        raise SystemExit("an MNIST export disagrees with the eager model")
    return st["launches"]


#: the MNIST exports against the eager model: max |probability diff|.  The
#: same float32 operations (no TF32) run on both sides
MNIST_EXPORT_TOL = 1e-5


# --------------------------------------------------- pipeline and recovery

#: phase 11's transform scores ``ROWS`` rows in this many partitions, one
#: driver thread each (``TFModel`` runs at most 8 at once)
TRANSFORM_PARTITIONS = 4
TRANSFORM_TIMING_ROUNDS = 3


def _bert_squad_args(seed: int, export_dir: str, config: dict, device: str):
    """The port's ``bert_squad`` example flags for the QA model ``config``
    at ``SEQ_LEN`` with the flash kernels, as phase 6 trains it."""
    from tensorflowonspark_tpu_torch.examples.bert import bert_squad

    flags = ["--bf16"] if config["dtype"] == "bfloat16" else []
    flags += ["--cpu"] if device == "cpu" else []
    return bert_squad.parser().parse_args(flags + [
        "--vocab_size", str(config["vocab_size"]), "--hidden_size", str(config["hidden_size"]),
        "--num_layers", str(config["num_layers"]), "--num_heads", str(config["num_heads"]),
        "--max_position_embeddings", str(config["max_position_embeddings"]),
        "--seq_len", str(SEQ_LEN), "--lr", str(TRAIN_LR), "--dropout", str(TRAIN_DROPOUT),
        "--seed", str(seed), "--export_dir", export_dir, "--flash"])


def run_pipeline_path(seed: int, card: str, wd: str, replay: dict, cfg=None,
                      device: str = "cuda") -> dict:
    """BASELINE config 3 as its users run it: ``TFEstimator(bert_squad.
    train_fn).fit(df)`` over phase 6's rows (same seed, batches and step
    generators) in one worker on the card, then ``TFModel.transform`` of
    the 64 inference rows on the driver from the chief's export, one thread
    a partition.  Gates: 12 launches of each kernel a step; every step's
    loss and the checkpoint's final weights within :data:`TRAIN_TOL` of
    phase 6's plain-attention ``replay``; 12 K1 launches a transform batch,
    counted on the driver; the transform's logits bit-identical to the
    export's signature called in one thread, and within :data:`EXPORT_TOL`
    of the eager model of the checkpoint's weights, where a model whose
    input mapping swaps the attention mask and the token types must fall
    outside.  Returns the launches of each kernel in the fit (the
    worker's) and in the transform (the driver's).  ``cfg`` (default
    BERT-base) and ``device`` exist for a rehearsal on the CPU at a tiny
    width, where the plain versions run and nothing is launched."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch import bert_inference as bi
    from tensorflowonspark_tpu_torch import bert_train as bt
    from tensorflowonspark_tpu_torch import pipeline as pl
    from tensorflowonspark_tpu_torch.checkpoint import restore_checkpoint
    from tensorflowonspark_tpu_torch.dataframe import DataFrame, Row
    from tensorflowonspark_tpu_torch.examples.bert import bert_squad
    from tensorflowonspark_tpu_torch.ops import flash_attention

    cfg = cfg or bi.BERT_BASE
    layers = cfg["num_layers"] if device == "cuda" else 0   # launches a step or batch
    cols = ("input_ids", "attention_mask", "token_type_ids", "start_position", "end_position")
    rows = bt.make_train_rows(TRAIN_STEPS * BATCH_SIZE, SEQ_LEN, cfg["vocab_size"], seed)
    df = DataFrame([Row(_fields=cols, _values=list(r)) for r in rows],
                   num_partitions=TRANSFORM_PARTITIONS)
    model_dir, export_dir = os.path.join(wd, "pipe_model"), os.path.join(wd, "pipe_export")
    estimator = (pl.TFEstimator(bert_squad.train_fn,
                                _bert_squad_args(seed, export_dir, cfg, device), device=device)
                 .setClusterSize(1).setBatchSize(BATCH_SIZE).setSteps(TRAIN_STEPS).setEpochs(1)
                 .setModelDir(model_dir).setExportDir(export_dir)
                 .setInputMapping(bert_squad.INPUT_MAPPING)
                 .setOutputMapping(bert_squad.OUTPUT_MAPPING))
    zero_launch_counts()                   # counts start at 0 for the main path
    t0 = time.perf_counter()
    model = estimator.fit(df)
    fit_s = time.perf_counter() - t0
    with open(os.path.join(model_dir, "train_stats", "0.json")) as f:
        st = json.load(f)
    weights = restore_checkpoint(model_dir)["model"]
    want = layers * TRAIN_STEPS
    med = statistics.median(st["step_ms"][1:])
    log(f"pipeline path: TFEstimator.fit of {len(st['losses'])} steps of {BATCH_SIZE} x "
        f"{SEQ_LEN} in {fit_s:.2f} s wall (cluster boot, weights, steps, checkpoint, export, "
        f"shutdown) on {st['device']}; median step {med:.2f} ms over steps 2..{TRAIN_STEPS} "
        f"on {card}; worker launches {st['launches']} (expected {layers} x "
        f"{TRAIN_STEPS} = {want} each)")
    if len(st["losses"]) != TRAIN_STEPS or any(n != want for n in st["launches"].values()):
        raise SystemExit("TFEstimator.fit did not go through every kernel once per layer "
                         "and step")
    r = weight_readings({n: t.to(device) for n, t in weights.items()}, replay["w_plain"],
                        replay["w0"])
    r["loss"] = max(abs(a - b) for a, b in zip(st["losses"], replay["losses"]))
    ok = within(r, TRAIN_TOL)
    log(f"pipeline path vs phase 6's plain-attention replay: losses "
        f"{[round(x, 5) for x in st['losses']]} (max |diff| {r['loss']:.4g}); final weights "
        f"max {r['max']:.4g} ({r['worst']}), median {r['median']:.4g}; zero-in-theory "
        f"{r['noise']:.3g} x lr x steps; gate {TRAIN_TOL}: {'within' if ok else 'OUTSIDE'}")
    if not ok:
        raise SystemExit("TFEstimator.fit's losses or weights disagree with the replay")

    # TFModel.transform on the driver, on the card, from threads
    infer = bi.make_rows(ROWS, SEQ_LEN, cfg["vocab_size"], seed)
    in_cols = list(bert_squad.INPUT_MAPPING)

    def frame(parts):
        return DataFrame([Row(_fields=in_cols, _values=list(r)) for r in infer],
                         num_partitions=parts)

    def spans(out) -> tuple:
        got = out.collect()
        return (np.stack([np.asarray(x.pred_start) for x in got]),
                np.stack([np.asarray(x.pred_end) for x in got]))

    df_64 = frame(TRANSFORM_PARTITIONS)
    zero_launch_counts()
    t0 = time.perf_counter()
    got = spans(model.transform(df_64))
    first_s = time.perf_counter() - t0
    launches = flash_attention.launches
    n_batches = ROWS // BATCH_SIZE
    log(f"pipeline transform: {ROWS} rows in {TRANSFORM_PARTITIONS} partitions on the "
        f"driver ({TRANSFORM_PARTITIONS} threads) in {first_s:.2f} s (export load included); "
        f"driver K1 launches {launches} (expected {layers} x {n_batches} = "
        f"{layers * n_batches})")
    if launches != layers * n_batches:
        raise SystemExit("TFModel.transform did not go through K1 once per layer and batch")
    if got[0].shape != (ROWS, SEQ_LEN) or not (np.isfinite(got[0]).all()
                                               and np.isfinite(got[1]).all()):
        raise SystemExit(f"bad transform logits: shape {got[0].shape}")
    sig = pl._load_model_cached(export_dir, "serve", device).signature()
    direct = [sig(**{c: np.stack([r[i] for r in infer[b:b + BATCH_SIZE]])
                     for i, c in enumerate(in_cols)}) for b in range(0, ROWS, BATCH_SIZE)]
    direct = tuple(np.concatenate([pl._to_numpy(d[k]) for d in direct])
                   for k in bert_squad.SERVE_OUTPUTS)
    identical = all(np.array_equal(a, b) for a, b in zip(got, direct))
    eager = bi.build_model({"config": cfg, "state_dict": weights}, torch.device(device), "flash")
    with torch.inference_mode():
        outs = [bi.forward_batch(eager, [np.stack([r[c] for r in infer[b:b + BATCH_SIZE]])
                                         for c in range(3)], BATCH_SIZE, device)
                for b in range(0, ROWS, BATCH_SIZE)]
    want_eager = tuple(np.concatenate([o[j] for o in outs]) for j in range(2))
    masks = np.stack([r[1] for r in infer]).astype(bool)
    sound = export_readings(got, want_eager, masks)
    swapped = model.copy({"input_mapping": {"input_ids": "input_ids",
                                            "attention_mask": "token_type_ids",
                                            "token_type_ids": "attention_mask"}})
    fault = export_readings(spans(swapped.transform(df_64)), want_eager, masks)
    for name, rr in (("transform (4 threads)", sound),
                     ("transform with the mask and token types swapped (planted fault)", fault)):
        log(f"pipeline {name} vs the eager model of the checkpoint's weights: max|logit "
            f"diff| / max|logit| {rr['logits']:.3g}; identical argmax spans {rr['spans']:.3f}")
    log(f"pipeline transform vs the signature called in one thread: "
        f"{'bit-identical' if identical else 'DIFFERENT'}; export gate {EXPORT_TOL}: "
        f"transform {'within' if within_export(sound) else 'OUTSIDE'}, planted fault "
        f"{'outside' if not within_export(fault) else 'INSIDE'}")
    if not identical:
        raise SystemExit("TFModel.transform's logits differ from a one-thread call of the "
                         "same export")
    if not within_export(sound):
        raise SystemExit("TFModel.transform's logits disagree with the eager model")
    if within_export(fault):
        raise SystemExit("the transform gate does not see swapped input columns")

    turns = {TRANSFORM_PARTITIONS: [], 1: []}
    frames = {TRANSFORM_PARTITIONS: df_64, 1: frame(1)}
    for r in range(2 * TRANSFORM_TIMING_ROUNDS):
        for parts in ((TRANSFORM_PARTITIONS, 1) if r % 2 == 0 else (1, TRANSFORM_PARTITIONS)):
            t0 = time.perf_counter()
            spans(model.transform(frames[parts]))
            turns[parts].append(ROWS / (time.perf_counter() - t0))
    log(f"pipeline transform rows/s on {card}, warm, in turns ({2 * TRANSFORM_TIMING_ROUNDS} "
        f"each, {ROWS} rows of {SEQ_LEN}, batch {BATCH_SIZE}): {TRANSFORM_PARTITIONS} "
        f"partitions run concurrently {statistics.median(turns[TRANSFORM_PARTITIONS]):.1f} "
        f"(all {[round(x, 1) for x in turns[TRANSFORM_PARTITIONS]]}); one partition "
        f"{statistics.median(turns[1]):.1f} (all {[round(x, 1) for x in turns[1]]})")
    del eager
    return {"fit": st["launches"], "transform": launches}


#: phase 12's depth: full BERT-base width (hidden 768, 12 heads, T = 384,
#: batch 16), 4 of its 12 layers, so that two cluster boots, 8 steps, two
#: eval rounds and two in-process replays fit the run's time limit
RECOVERY_LAYERS = 4
RECOVERY = {"max_steps": 8, "save_every": 4, "throttle": 4, "eval_steps": 2, "kill_after": 6}


def recovery_input_fn(pattern: str):
    """``input_fn`` of phase 12: the SQuAD rows of the TFRecord files
    ``pattern`` (``Dataset.from_examples``) in batches of ``BATCH_SIZE``,
    as the step takes them (``bert_train.pad_batch``)."""
    from tensorflowonspark_tpu_torch import bert_train as bt
    from tensorflowonspark_tpu_torch.data import Dataset

    cols = ("input_ids", "attention_mask", "token_type_ids", "start_position", "end_position")

    def input_fn():
        return (Dataset.from_examples(pattern)
                .map(lambda ex: tuple(ex[c] for c in cols))
                .batch(BATCH_SIZE, drop_remainder=True)
                .map(lambda b: bt.pad_batch(b, BATCH_SIZE)))

    return input_fn


def recovery_estimator(args: dict, model_dir: str, loss_fn, device,
                       checkpoint_input_state: bool = True):
    """Phase 12's ``Estimator``: BERT QA of ``args["config"]`` (weights and
    dropout generators from ``args["seed"]``), AdamW, a save every
    ``RECOVERY["save_every"]`` steps, train scalars every step."""
    from tensorflowonspark_tpu_torch import bert_train as bt
    from tensorflowonspark_tpu_torch.estimator import Estimator
    from tensorflowonspark_tpu_torch.parallel import DataParallelStrategy

    model = bt.build_train_model({"config": args["config"], "seed": args["seed"],
                                  "dropout": TRAIN_DROPOUT}, device, args["attention"])
    return Estimator(model, loss_fn, bt.adamw(TRAIN_LR), model_dir,
                     strategy=DataParallelStrategy(device, seed=args["seed"]),
                     eval_metrics_fn=bt.squad_metrics,
                     save_every_steps=RECOVERY["save_every"], log_every_steps=1,
                     checkpoint_input_state=checkpoint_input_state)


def recovery_specs(data_dir: str):
    """Phase 12's ``(TrainSpec, EvalSpec)`` over the TFRecords under
    ``data_dir`` (``train/`` and ``eval/``)."""
    from tensorflowonspark_tpu_torch.estimator import EvalSpec, TrainSpec

    return (TrainSpec(recovery_input_fn(os.path.join(data_dir, "train", "part-*")),
                      RECOVERY["max_steps"]),
            EvalSpec(recovery_input_fn(os.path.join(data_dir, "eval", "part-*")),
                     steps=RECOVERY["eval_steps"], throttle_steps=RECOVERY["throttle"]))


def recovery_train_fn(args: dict, ctx) -> None:
    """Phase 12's worker: ``train_and_evaluate`` of :func:`recovery_estimator`
    from the TFRecords under ``args["data_dir"]``.  The first attempt
    (no sentinel file yet) writes the sentinel with its clock and exits
    with ``os._exit(1)`` as step ``kill_after + 1`` begins, i.e. after step
    ``kill_after``; the save at ``save_every`` is durable by then (the
    train round that made it waited for it).  Appends its start step to
    ``resume.<id>``, each checkpoint's save-returns and durable seconds to
    ``ckpt_times.jsonl``, and writes ``recovery_stats.<id>.json`` (goodput,
    the flash kernels' launches) when it finishes."""
    from tensorflowonspark_tpu_torch import bert_train as bt
    from tensorflowonspark_tpu_torch.estimator import train_and_evaluate
    from tensorflowonspark_tpu_torch.util import resolve_device, strict_matmul_precision

    device = resolve_device(args["device"])
    strict_matmul_precision()
    wd = ctx.working_dir
    sentinel = os.path.join(wd, "killed")
    holder = {}

    def loss_fn(model, batch, rng=None):
        if holder["est"].global_step == RECOVERY["kill_after"] and not os.path.exists(sentinel):
            with open(sentinel, "w") as f:
                f.write(repr(time.time()))
            os._exit(1)
        return bt.squad_loss(model, batch, rng)

    launches0 = bt.kernel_launches()
    est = recovery_estimator(args, args["model_dir"], loss_fn, device)
    holder["est"] = est
    with open(os.path.join(wd, f"resume.{ctx.executor_id}"), "a") as f:
        f.write(f"{est.global_step}\n")
    times = os.path.join(wd, "ckpt_times.jsonl")
    save, wait, pending = est._ckpt.save, est._ckpt.wait, []

    def timed_save(step, state, force=False):
        t0 = time.perf_counter()
        saved = save(step, state, force)
        if saved:
            pending.append((step, t0, time.perf_counter() - t0))
        return saved

    def timed_wait():
        wait()
        with open(times, "a") as f:
            for step, t0, returned in pending:
                f.write(json.dumps({"step": step, "save_returns_s": returned,
                                    "durable_s": time.perf_counter() - t0}) + "\n")
        pending.clear()

    est._ckpt.save, est._ckpt.wait = timed_save, timed_wait
    with est:
        final = train_and_evaluate(est, *recovery_specs(args["data_dir"]))
    with open(os.path.join(wd, f"recovery_stats.{ctx.executor_id}.json"), "w") as f:
        json.dump({"final": final, "goodput": est.goodput(), "device": str(device),
                   "launches": {k: n - launches0[k]
                                for k, n in bt.kernel_launches().items()}}, f)


def read_event_scalars(summary_dir: str) -> tuple[dict, dict]:
    """``{(tag, step): value}`` over the event files of ``summary_dir``,
    later files (a relaunch's) overriding earlier ones, and ``{(tag,
    step): (file index, wall time)}`` of each kept value."""
    from tensorflowonspark_tpu_torch.observability import read_scalars

    values, origin = {}, {}
    for i, name in enumerate(sorted(os.listdir(summary_dir))):
        if name.startswith("events.out.tfevents."):
            for wall, step, tag, value in read_scalars(os.path.join(summary_dir, name)):
                values[(tag, step)] = value
                origin[(tag, step)] = (i, wall)
    return values, origin


def run_estimator_recovery(seed: int, card: str, wd: str, cfg=None,
                           device: str = "cuda") -> dict:
    """The Estimator under ``run_with_recovery`` with one lost worker, at
    full BERT-base width and :data:`RECOVERY_LAYERS` layers: write the
    train and eval rows as TFRecords (``dfutil``), run
    :func:`recovery_train_fn` in one worker (``InputMode.TENSORFLOW``); its
    first attempt dies after step 6, the relaunch restores step 4 and its
    input position and trains steps 5-8.  Gates: the latest step is 8 and
    the relaunch started at 4; one classified ``crash`` event; train/loss
    at steps 1-8 (5 from the relaunch) and eval/loss at 4 and 8 in the
    event files; every step's loss and the final weights within
    :data:`TRAIN_TOL` of an unbroken in-process replay through the plain
    attention over the same records, where an in-process Estimator that
    restarts the input at batch 0 after step 4 (``checkpoint_input_state=
    False``) must fall outside; no shared-memory segment left behind.
    Returns the relaunched worker's launches of each kernel.  ``cfg``
    (default BERT-base cut to :data:`RECOVERY_LAYERS` layers) and
    ``device`` exist for a rehearsal on the CPU at a tiny width."""
    import torch

    from tensorflowonspark_tpu_torch import bert_inference as bi
    from tensorflowonspark_tpu_torch import bert_train as bt
    from tensorflowonspark_tpu_torch import dfutil
    from tensorflowonspark_tpu_torch.checkpoint import CheckpointManager, restore_checkpoint
    from tensorflowonspark_tpu_torch.cluster import InputMode, run_with_recovery
    from tensorflowonspark_tpu_torch.dataframe import DataFrame
    from tensorflowonspark_tpu_torch.estimator import train_and_evaluate
    from tensorflowonspark_tpu_torch.observability import EventLog
    from tensorflowonspark_tpu_torch.parallel import DataParallelStrategy
    from tensorflowonspark_tpu_torch.shm import SEG_PREFIX

    cfg = cfg or {**bi.BERT_BASE, "num_layers": RECOVERY_LAYERS}
    layers = cfg["num_layers"] if device == "cuda" else 0   # launches a step or batch
    steps = RECOVERY["max_steps"]
    data_dir = os.path.join(wd, "recovery_records")
    cols = ("input_ids", "attention_mask", "token_type_ids", "start_position", "end_position")
    for name, n, s in (("train", steps * BATCH_SIZE, seed),
                       ("eval", RECOVERY["eval_steps"] * BATCH_SIZE, seed + 1)):
        rows = bt.make_train_rows(n, SEQ_LEN, cfg["vocab_size"], s)
        dfutil.saveAsTFRecords(DataFrame([dict(zip(cols, r)) for r in rows]),
                               os.path.join(data_dir, name))
    shm_before = {n for n in os.listdir("/dev/shm") if n.startswith(SEG_PREFIX)}
    job_dir, model_dir = os.path.join(wd, "recovery_job"), os.path.join(wd, "recovery_model")
    args = {"config": cfg, "seed": seed, "attention": "flash", "device": device,
            "data_dir": data_dir, "model_dir": model_dir}
    zero_launch_counts()                   # counts start at 0 for the main path
    attempts = []
    t0 = time.perf_counter()
    run_with_recovery(recovery_train_fn, args, 1, max_restarts=1, backoff_base=0.1,
                      input_mode=InputMode.TENSORFLOW, working_dir=job_dir,
                      reservation_timeout=600, shutdown_timeout=900,
                      on_restart=lambda attempt, exc, kind: attempts.append(kind))
    wall = time.perf_counter() - t0
    with open(os.path.join(job_dir, "recovery_stats.0.json")) as f:
        st = json.load(f)
    with open(os.path.join(job_dir, "resume.0")) as f:
        starts = [int(x) for x in f.read().split()]
    with open(os.path.join(job_dir, "killed")) as f:
        killed_at = float(f.read())
    with open(os.path.join(job_dir, "ckpt_times.jsonl")) as f:
        ckpts = [json.loads(line) for line in f]
    crashes = [e for e in EventLog.read(os.path.join(job_dir, "health_events.jsonl"))
               if e["kind"] == "crash"]
    with CheckpointManager(model_dir) as mngr:
        latest = mngr.latest_step()
    values, origin = read_event_scalars(os.path.join(model_dir, "tensorboard"))
    train_steps = sorted(s for tag, s in values if tag == "train/loss")
    eval_steps = sorted(s for tag, s in values if tag == "eval/loss")
    relaunch_file = origin[("train/loss", steps)][0]
    first_step_wall = min(w for (tag, s), (i, w) in origin.items()
                          if tag == "train/loss" and i == relaunch_file)
    detect = crashes[0]["t"] - killed_at if crashes else float("nan")
    shm_left = {n for n in os.listdir("/dev/shm") if n.startswith(SEG_PREFIX)} - shm_before
    log(f"recovery path: run_with_recovery of the Estimator (BERT QA, hidden "
        f"{cfg['hidden_size']}, {cfg['num_layers']} layers, T {SEQ_LEN}, batch {BATCH_SIZE}) in "
        f"{wall:.2f} s wall on {st['device']}; restarts {attempts}; attempts started at "
        f"steps {starts}; latest step {latest}; crash events {len(crashes)}; relaunched "
        f"worker launches {st['launches']}; shm segments left {sorted(shm_left)}")
    log(f"recovery path on {card}: detection latency {detect:.3f} s (the worker's exit to the "
        f"classified crash event); restart to first step {first_step_wall - crashes[0]['t']:.3f} "
        f"s (the event to the relaunch's first completed step, its train/loss event); "
        f"checkpoints {ckpts}")
    log(f"recovery path goodput (the relaunched worker's Estimator): {st['goodput']}")
    train_launches = layers * (steps - RECOVERY["save_every"])
    want = {"flash_attention_fwd": train_launches + layers * RECOVERY["eval_steps"],
            "flash_attention_dq": train_launches, "flash_attention_dkv": train_launches}
    if not (latest == steps and starts == [0, RECOVERY["save_every"]] and attempts == ["crash"]
            and len(crashes) == 1):
        raise SystemExit("the Estimator did not relaunch once from its step-4 checkpoint "
                         "after one classified crash")
    if train_steps != list(range(1, steps + 1)) or eval_steps != [RECOVERY["throttle"], steps] \
            or origin[("train/loss", RECOVERY["save_every"] + 1)][0] != relaunch_file:
        raise SystemExit(f"the event files lack a curve point: train {train_steps}, eval "
                         f"{eval_steps}")
    if st["launches"] != want:
        raise SystemExit(f"the relaunched worker's kernel launches {st['launches']} are not "
                         f"{want}")
    if shm_left:
        raise SystemExit(f"the relaunch left shared-memory segments: {sorted(shm_left)}")

    # an unbroken in-process replay through the plain attention, one pass
    # over the same records with the same generators
    device = torch.device(device)
    strategy = DataParallelStrategy(device, seed=seed)
    state = strategy.init_state(bt.build_train_model(
        {"config": cfg, "seed": seed, "dropout": TRAIN_DROPOUT}, device, "reference"),
        bt.adamw(TRAIN_LR))
    w0 = {n: t.detach().clone() for n, t in state.module.state_dict().items()}
    step = strategy.build_train_step(bt.squad_loss)
    plain = []
    for b in recovery_specs(data_dir)[0].input_fn():
        state, m = step(state, strategy.shard_batch(b))
        plain.append(float(m["loss"]))
    w_plain = state.module.state_dict()
    losses = [values[("train/loss", s)] for s in range(1, steps + 1)]
    weights = {n: t.to(device) for n, t in restore_checkpoint(model_dir)["model"].items()}

    # the planted fault: the same relaunch in process, without the input position
    fault_dir = os.path.join(wd, "recovery_fault")
    train_spec, eval_spec = recovery_specs(data_dir)
    with recovery_estimator(args, fault_dir, bt.squad_loss, device) as est:
        est.train(train_spec.input_fn, RECOVERY["save_every"])
    with recovery_estimator(args, fault_dir, bt.squad_loss, device,
                            checkpoint_input_state=False) as est:
        train_and_evaluate(est, train_spec, eval_spec)
    fvalues, _ = read_event_scalars(os.path.join(fault_dir, "tensorboard"))
    fault_losses = [fvalues[("train/loss", s)] for s in range(1, steps + 1)]
    fault_w = {n: t.to(device) for n, t in restore_checkpoint(fault_dir)["model"].items()}
    verdict = {}
    for name, ls, w in (("relaunched worker", losses, weights),
                        ("input restarted at batch 0 (planted fault)", fault_losses, fault_w)):
        r = weight_readings(w, w_plain, w0)
        r["loss"] = max(abs(a - b) for a, b in zip(ls, plain))
        verdict[name] = within(r, TRAIN_TOL)
        log(f"recovery path, {name} vs the unbroken replay: losses {[round(x, 5) for x in ls]} "
            f"(max |diff| {r['loss']:.4g}); final weights max {r['max']:.4g} ({r['worst']}), "
            f"median {r['median']:.4g}; zero-in-theory {r['noise']:.3g} x lr x steps")
    log(f"recovery path, replay losses {[round(x, 5) for x in plain]}; gate {TRAIN_TOL}: "
        f"relaunch {'within' if verdict['relaunched worker'] else 'OUTSIDE'}, planted fault "
        f"{'outside' if not verdict['input restarted at batch 0 (planted fault)'] else 'INSIDE'}")
    if not verdict["relaunched worker"]:
        raise SystemExit("the relaunched Estimator's losses or weights disagree with the "
                         "unbroken replay")
    if verdict["input restarted at batch 0 (planted fault)"]:
        raise SystemExit("the recovery gate does not see an input restarted at batch 0")
    del state, w_plain, w0, weights, fault_w
    return st["launches"]



# ----------------------------------------------------------- the decoder

#: phase 13: ``bench.py::bench_gpt_decode``'s GPT-124M-class widths trained
#: through the port's ``examples/gpt/gpt_tiny.py`` flow (Estimator,
#: train_and_evaluate, Adam :data:`GPT_LR`, an eval every 4 steps), bf16
#: compute on float32 parameters, the flash kernels causal
GPT_WIDTH = {"vocab": 32000, "hidden": 768, "num_layers": 12, "num_heads": 12,
             "seq_len": 1024, "max_position_embeddings": 1024, "batch_size": 8}
GPT_STEPS = 8
#: Adam's rate: gpt_tiny's own (:data:`GPT_TINY_LR`) suits its tiny default
#: width; at this width from the 0.02 init it drives the loss up and the
#: run chaotic, so the gate could not tell a fault (``--calibrate-gpt``
#: reads both; PERF.md, "GPT gate")
GPT_LR, GPT_TINY_LR = 1e-4, 3e-3
#: phase 13b: the llama-class variant at the same width, cut to 4 layers
#: for time (three replays at full width besides the run)
LLAMA_VARIANT = {"arch": "llama", "num_layers": 4, "num_kv_heads": 4, "sliding_window": 512}
#: phase 13's gate against the plain-attention replay (same weights,
#: batches, Adam): every step's loss, and the final weights as
#: ||w - w_plain|| / ||w_plain - w0|| (max and median over the parameters)
#: with the zero-in-theory ones (the key biases of a learned-position
#: model) in units of lr x steps.  Sound readings at seeds 0-2 reach loss
#: 2.4e-4, max 0.125, median 0.0385, noise 1.40 x lr x steps; dK zeroed
#: reads a max of 1 (loss 1.0e-3-5.0e-3), the dropped causal mask a loss of
#: 0.072-0.117 and a median of 0.84-0.87 (PERF.md, "GPT gate").
GPT_TRAIN_TOL = {"loss": 1e-3, "max": 0.3, "median": 0.08, "noise": 2.03}
#: the chunked LM-head loss against logits + cross-entropy, float32 on the
#: card: |loss diff| / loss and ||g - g_dense|| / ||g_dense|| for the
#: gradients of tok_emb and of the final hidden states
XENT_CHUNK, XENT_TOL = 4096, 1e-4
#: phase 14: bf16 prefill logits (the decode path's dense attention over
#: the cache) against the full forward (the flash kernels), as max |diff| /
#: max |logit|
PREFILL_TOL = 3e-2
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 32, 24
#: the int8 export's variables over the bf16 export's may exceed the share
#: its parameter bytes give (int8 leaves and scales, the rest bf16) by this
#: much: the files' own overhead
EXPORT_BYTES_SLACK = 0.01


def gpt_args(seed: int, model_dir: str, **over):
    """``gpt_tiny``'s flags for phase 13 (or 13b with ``over``)."""
    return argparse.Namespace(**{**GPT_WIDTH, "max_steps": GPT_STEPS, "lr": GPT_LR,
                                 "arch": "gpt2",
                                 "chunked_xent": False, "model_dir": model_dir, "seed": seed,
                                 "num_kv_heads": None, "sliding_window": None, "bf16": True,
                                 "flash": True, "cpu": False, **over})


def no_causal_attention(q, k, v, causal=False, window=None):
    """The planted fault of phase 13: the kernels without ``causal`` (and
    ``window``), so every token sees the future — on the "+1" corpus the
    next token itself."""
    from tensorflowonspark_tpu_torch.ops import flash_attention

    return flash_attention(q, k, v)


def no_window_attention(q, k, v, causal=False, window=None):
    """The planted fault of phase 13b: the kernels causal but without the
    window, so a query past the window's length sees every earlier key."""
    from tensorflowonspark_tpu_torch.ops import flash_attention

    return flash_attention(q, k, v, causal=causal)


def gpt_replay(cfg, batches: list, seed: int, attention_fn, device, lr: float) -> dict:
    """The training steps of ``batches`` in this process: the same initial
    weights (``seed``), Adam at ``lr`` and loss as the Estimator's run,
    through ``attention_fn``.  ``{"losses", "w0", "w"}``."""
    import dataclasses

    import torch

    from tensorflowonspark_tpu_torch.examples.gpt import gpt_tiny
    from tensorflowonspark_tpu_torch.parallel.strategy import adam

    model = gpt_tiny.build_model(dataclasses.replace(cfg, attention_fn=attention_fn),
                                 seed).to(device)
    w0 = {n: t.detach().clone() for n, t in model.state_dict().items()}
    opt = adam(lr)(model.parameters())
    losses = []
    for ids in batches:
        opt.zero_grad(set_to_none=True)
        loss = gpt_tiny.next_token_loss(model, ids)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return {"losses": [float(x) for x in losses], "w0": w0,
            "w": {n: t.detach() for n, t in model.state_dict().items()}}


def gpt_step_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one training step, 2 a multiply-add, x3 for forward
    and backward: the dense products (the tied LM head included) and the
    attention's two products over the pairs the causal (or windowed) mask
    leaves."""
    hid, ffn, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    kv = (cfg.num_kv_heads or cfg.num_heads) * cfg.head_dim
    mlp = (3 if cfg.mlp == "swiglu" else 2) * hid * ffn
    dense = L * (2 * hid * hid + 2 * hid * kv + mlp) + cfg.vocab_size * hid
    W = cfg.sliding_window or seq
    pairs = sum(min(t + 1, W) for t in range(seq))
    return 3 * (2 * dense * batch * seq + L * 2 * 2 * batch * hid * pairs)


def run_gpt_training(seed: int, card: str, wd: str, variant: dict | None = None,
                     device: str = "cuda", width: dict | None = None, gate: bool = True,
                     lr: float = GPT_LR) -> dict:
    """Phase 13 (``variant`` None) or 13b: ``gpt_tiny.train`` at full width
    on the card, each flash kernel 12 (L) times a training step (K1 also at
    each eval batch), every step's loss and the final weights within
    :data:`GPT_TRAIN_TOL` of the plain-attention replay while the planted
    faults fall outside; phase 13 also holds the chunked LM-head loss to
    logits + cross-entropy.  ``width`` and ``device="cpu"`` rehearse it
    at a tiny size (no launches there); ``lr`` other than :data:`GPT_LR`
    only with ``gate`` false (``--calibrate-gpt``).  Returns the launches, the step
    time and the trained weights and config."""
    import torch

    from tensorflowonspark_tpu_torch.examples.gpt import gpt_tiny
    from tensorflowonspark_tpu_torch.ops import flash_attention_plain
    from tensorflowonspark_tpu_torch.ops.flash_attention import (flash_attention,
                                                                 flash_attention_bwd)

    name = "llama" if variant else "gpt2"
    args = gpt_args(seed, os.path.join(wd, f"gpt_{name}_{seed}_{lr:g}"),
                    **{**(width or {}), **(variant or {}), "lr": lr})
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    zero_launch_counts()                   # counts start at 0 for this path
    t0 = time.perf_counter()
    out = gpt_tiny.train(args, dev)
    wall = time.perf_counter() - t0
    launches = {"flash_attention_fwd": flash_attention.launches,
                "flash_attention_dq": flash_attention_bwd.launches_dq,
                "flash_attention_dkv": flash_attention_bwd.launches_dkv}
    cfg, L = out["cfg"], out["cfg"].num_layers
    steps = len(out["losses"])
    want = ({"flash_attention_fwd": L * (steps + out["eval_batches"]),
             "flash_attention_dq": L * steps, "flash_attention_dkv": L * steps}
            if dev.type == "cuda" else dict.fromkeys(launches, 0))
    log(f"{name} training at Adam {lr:g} ({L} layers, hidden {cfg.hidden_size}, {cfg.num_heads} heads"
        f"{', ' + str(cfg.num_kv_heads) + ' K/V heads' if cfg.num_kv_heads else ''}, window "
        f"{cfg.sliding_window}, B={args.batch_size} T={args.seq_len} V={args.vocab}): {steps} "
        f"steps + {out['eval_batches']} eval batches in {wall:.2f} s wall (weights, steps, "
        f"evals, checkpoints); eval loss {out['final']['loss']:.4f}; launches {launches} "
        f"(expected {want})")
    if steps != GPT_STEPS or launches != want:
        raise SystemExit(f"the {name} training path did not launch every kernel once a layer "
                         "and step (K1 also a layer and eval batch)")
    if not all(math.isfinite(x) for x in out["losses"]):
        raise SystemExit(f"non-finite {name} training loss: {out['losses']}")
    med = statistics.median(out["step_ms"][1:])
    tokens = args.batch_size * args.seq_len
    flops = gpt_step_flops(cfg, args.batch_size, args.seq_len)
    log(f"{name} training on {card}: median step {med:.2f} ms (step starts 2..{steps}; all "
        f"{[round(x, 2) for x in out['step_ms']]}) = {tokens / med * 1e3:.0f} tokens/s; model "
        f"{flops / 1e12:.3f} TFLOP a step = {flops / (med * 1e-3) / 1e12:.1f} TFLOP/s = "
        f"{flops / (med * 1e-3) / H100_BF16_FLOPS:.4f} of 989 TFLOP/s")

    # the same batches in this process through the plain attention, and
    # through the kernels with each planted fault
    plain = gpt_replay(cfg, out["batches"], seed, flash_attention_plain, dev, lr)
    if dev.type == "cuda" and (flash_attention.launches, flash_attention_bwd.launches_dq) != (
            launches["flash_attention_fwd"], launches["flash_attention_dq"]):
        raise SystemExit("the plain-attention replay launched a kernel")
    readings = {"kernels (Estimator)": (out["losses"], out["params"])}
    faults = {"dK x 0 (planted fault)": attention_fn("kernel", "kernel", dk_scale=0.0)}
    if not variant:
        faults["no causal mask (planted fault)"] = no_causal_attention
    if cfg.sliding_window:
        faults["window dropped (planted fault)"] = no_window_attention
    for fname, fn in faults.items():
        r = gpt_replay(cfg, out["batches"], seed, fn, dev, lr)
        readings[fname] = (r["losses"], r["w"])
    log(f"{name} plain-attention replay: losses {[round(x, 5) for x in plain['losses']]}")
    verdict = {}
    for rname, (losses, w) in readings.items():
        # with learned positions the key biases are zero in theory (softmax
        # ignores a shift of every score of a row); RoPE rotates them
        zero = {n for n in plain["w"]
                if cfg.pos_encoding == "learned" and n.endswith("attn.key.bias")}
        r = weight_readings(w, plain["w"], plain["w0"], zero, lr * GPT_STEPS)
        r["loss"] = max(abs(a - b) for a, b in zip(losses, plain["losses"]))
        verdict[rname] = within(r, GPT_TRAIN_TOL)
        log(f"{name} training, {rname} vs the replay: losses {[round(x, 5) for x in losses]} "
            f"(max |diff| {r['loss']:.4g}); final weights ||w-w_plain||/||w_plain-w0|| over "
            f"{r['params']} parameters: max {r['max']:.4g} ({r['worst']}), median "
            f"{r['median']:.4g}; zero-in-theory: max |w-w_plain| {r['noise']:.3g} x lr x steps")
    ok = verdict["kernels (Estimator)"] and not any(verdict[f] for f in faults)
    log(f"{name} training gate {GPT_TRAIN_TOL}: " + "; ".join(
        f"{k} {'within' if v else 'outside'}" for k, v in verdict.items()))
    if gate and not ok:
        raise SystemExit(f"the {name} training gate failed: the Estimator's run must be "
                         "within it and every planted fault outside")
    del plain, readings
    if not variant:
        check_chunked_xent(out["params"], cfg, out["batches"][-1], dev)
    return {"launches": launches, "step_ms": med, "tokens_per_s": tokens / med * 1e3,
            "mfu": flops / (med * 1e-3) / H100_BF16_FLOPS, "params": out["params"],
            "cfg": cfg, "args": args}


def check_chunked_xent(params: dict, cfg, ids, device) -> None:
    """``tied_softmax_xent`` (chunk :data:`XENT_CHUNK`) against the logits
    and ``F.cross_entropy`` on the trained weights and one batch: the loss
    and the gradients of ``tok_emb`` and of the final hidden states."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from tensorflowonspark_tpu_torch.models.gpt import _model
    from tensorflowonspark_tpu_torch.ops import tied_softmax_xent

    with torch.no_grad():
        h = _model(dataclasses.replace(cfg, attention_fn=None), params).hidden(ids)
    h = h[:, :-1].detach().requires_grad_()
    table = params["tok_emb.weight"].detach().requires_grad_()
    labels = ids[:, 1:]
    dense = F.cross_entropy((h @ table.T).reshape(-1, cfg.vocab_size), labels.reshape(-1))
    g_dense = torch.autograd.grad(dense, (h, table))
    chunked = tied_softmax_xent(h, table, labels, chunk_size=XENT_CHUNK).mean()
    g_chunked = torch.autograd.grad(chunked, (h, table))
    r = {"loss": abs(chunked.item() - dense.item()) / dense.item(),
         **{what: ((a - b).norm() / b.norm()).item()
            for what, a, b in zip(("d hidden", "d tok_emb"), g_chunked, g_dense)}}
    log(f"chunked LM-head loss (chunk {XENT_CHUNK}, {-(-cfg.vocab_size // XENT_CHUNK)} chunks, "
        f"ragged last) vs logits + cross-entropy, float32 on the trained weights: loss "
        f"{chunked.item():.6f} vs {dense.item():.6f}; relative: " +
        ", ".join(f"{k} {v:.3g}" for k, v in r.items()) + f" (tolerance {XENT_TOL})")
    if not all(v <= XENT_TOL for v in r.values()):
        raise SystemExit("the chunked LM-head loss disagrees with logits + cross-entropy")


def _greedy_rollout(model, prompt, n: int):
    """Argmax rollout of the full forward, no cache: the reference every
    cached decode must reproduce."""
    import torch

    ids = prompt
    with torch.no_grad():
        for _ in range(n):
            ids = torch.cat([ids, model(ids)[:, -1].argmax(-1, keepdim=True)], dim=1)
    return ids


def _paged_greedy(cfg, params, prompt, n: int):
    """Greedy decode through the paged pool: each row owns consecutive
    pages (its block table written as a batcher would), then prefill and
    single-token steps."""
    import torch

    from tensorflowonspark_tpu_torch.models.gpt import _model, init_cache

    B, pt = prompt.shape[0], cfg.kv_page_tokens
    need = -(-(prompt.shape[1] + n) // pt)
    cache = init_cache(cfg, params, B)
    for lc in cache["layers"]:
        for r in range(B):
            lc["block_table"][r, :need] = torch.arange(r * need, (r + 1) * need)
    model = _model(cfg, params)
    ids = prompt
    with torch.no_grad():
        tok = model(prompt, cache=cache)[:, -1].argmax(-1)
        for _ in range(n):
            ids = torch.cat([ids, tok[:, None]], dim=1)
            tok = model(tok[:, None], cache=cache)[:, -1].argmax(-1)
    return ids


def _export_bytes(export_dir: str) -> int:
    vdir = os.path.join(export_dir, "variables")
    return sum(os.path.getsize(os.path.join(vdir, f)) for f in os.listdir(vdir))


def check_gpt_generation(seed: int, card: str, wd: str, trained: dict,
                         device: str = "cuda") -> dict:
    """Phase 14 on phase 13's trained weights: cached decodes against the
    full forward's argmax rollout in float32 (greedy, int8 KV, a rolling
    window, the paged pool), lookup and beam(1) against greedy, the bf16
    prefill against the full forward through the kernels, int8 weights'
    bytes, and the int8 export against the eager int8 model.  Returns the
    kernels' launches (the export check runs K1)."""
    import dataclasses

    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.checkpoint import ExportedModel, export_model
    from tensorflowonspark_tpu_torch.models import gpt
    from tensorflowonspark_tpu_torch.ops import quantize_params, tree_nbytes
    from tensorflowonspark_tpu_torch.ops.flash_attention import (flash_attention,
                                                                 flash_attention_bwd)
    from tensorflowonspark_tpu_torch.ops.quant import _QuantArray

    cfg, params = trained["cfg"], trained["params"]
    dev = torch.device(device)
    zero_launch_counts()
    rng = np.random.default_rng(seed + 14)
    V = cfg.vocab_size
    ramp = np.arange(GEN_PROMPT)[None, :]
    prompt = torch.from_numpy((rng.integers(0, V, (GEN_BATCH, 1)) + ramp) % V).to(dev)
    f32 = dataclasses.replace(cfg, dtype=torch.float32, attention_fn=None)
    want = _greedy_rollout(gpt._model(f32, params), prompt, GEN_NEW)
    windowed = dataclasses.replace(f32, sliding_window=GEN_PROMPT // 4)
    want_w = _greedy_rollout(gpt._model(windowed, params), prompt, GEN_NEW)
    pages = dict(per_row_positions=True, kv_page_tokens=16,
                 kv_pool_pages=GEN_BATCH * cfg.max_position_embeddings // 16)
    runs = {
        "greedy (KV cache)": (gpt.greedy_generate(f32, params, prompt, GEN_NEW), want),
        "int8 KV cache": (gpt.greedy_generate(dataclasses.replace(f32, kv_cache_int8=True),
                                              params, prompt, GEN_NEW), want),
        f"rolling window {windowed.sliding_window}": (gpt.greedy_generate(
            dataclasses.replace(windowed, rolling_kv_cache=True), params, prompt, GEN_NEW),
            want_w),
        "paged pool": (_paged_greedy(dataclasses.replace(f32, **pages), params, prompt,
                                     GEN_NEW), want),
        "beam_generate, 1 beam": (gpt.beam_generate(f32, params, prompt, GEN_NEW, num_beams=1),
                                  want),
    }
    lookup, stats = gpt.lookup_generate(f32, params, prompt, GEN_NEW, draft_len=8,
                                        return_stats=True)
    runs["lookup_generate (draft 8)"] = (lookup, want)
    log(f"generation, float32 on {card}: {GEN_BATCH} rows, prompt {GEN_PROMPT}, {GEN_NEW} new "
        f"tokens; full-forward rollout row 0: {want[0, GEN_PROMPT:].tolist()}")
    bad = []
    for rname, (got, ref) in runs.items():
        same = torch.equal(got, ref)
        log(f"generation, {rname}: {'equal to' if same else 'DIFFERS from'} the full forward's "
            f"argmax rollout" + (f" ({stats['forwards']} verify forwards for {GEN_NEW} tokens)"
                                 if rname.startswith("lookup") else ""))
        bad += [] if same else [rname]
    if bad:
        raise SystemExit(f"cached decoding differs from the full forward: {bad}")

    # bf16: the prefill (dense attention over the cache) against the full
    # forward through the flash kernels
    with torch.no_grad():
        model = gpt._model(cfg, params)
        full = model(prompt)
        pre = model(prompt, cache=gpt.init_cache(cfg, params, GEN_BATCH))
    rel = ((pre - full).abs().max() / full.abs().max()).item()
    log(f"prefill (bf16, cache path) vs full forward (bf16, flash kernels): max |diff| / max "
        f"|logit| {rel:.4g} (tolerance {PREFILL_TOL})")
    if not rel <= PREFILL_TOL:
        raise SystemExit("the bf16 prefill disagrees with the full forward")

    # int8 weights: the quantized leaves' bytes against the same leaves in bf16
    q = quantize_params(params)
    qnames = [n for n, v in q.items() if isinstance(v, _QuantArray)]
    int8_bytes = sum(q[n].nbytes for n in qnames)
    bf16_bytes = sum(params[n].numel() * 2 for n in qnames)
    log(f"quantize_params: {len(qnames)} Linear weights, {int8_bytes} bytes int8 with scales "
        f"vs {bf16_bytes} bf16 = {int8_bytes / bf16_bytes:.4f}x; whole tree "
        f"{tree_nbytes(q)} vs {tree_nbytes(params)} float32")
    if not int8_bytes <= 0.51 * bf16_bytes:
        raise SystemExit("int8 weights do not halve the bytes of the bf16 ones")

    # the int8 export against eager: quantize_params' default leaves (the
    # Linear weights) int8, the rest (the tied table among them) bf16
    qe = {n: v if isinstance(v, _QuantArray) else v.to(torch.bfloat16) for n, v in q.items()}
    ids = prompt[:2]
    with torch.device("meta"):
        skeleton = gpt.GPT(cfg)
    serve = lambda p, x: gpt.bind(skeleton, p)(x)  # noqa: E731
    t0 = time.perf_counter()
    d8 = export_model(os.path.join(wd, "gpt_int8_export"), serve, qe, [ids.cpu()])
    export_s = time.perf_counter() - t0
    d16 = export_model(os.path.join(wd, "gpt_bf16_export"), serve,
                       {n: t.to(torch.bfloat16) for n, t in params.items()}, [ids.cpu()])
    before = flash_attention.launches
    with torch.no_grad():
        eager = gpt._model(cfg, {n: v.to(dev) for n, v in qe.items()})(ids)
    got = next(iter(ExportedModel.load(d8, device=dev)(ids).values()))
    k1 = flash_attention.launches - before
    ratio = _export_bytes(d8) / _export_bytes(d16)
    # what the parameters alone give: int8 leaves with their scales, the
    # rest bf16, over every parameter in bf16
    share = (int8_bytes + sum(v.numel() * 2 for n, v in params.items() if n not in qnames)) / (
        sum(v.numel() * 2 for v in params.values()))
    same = torch.equal(got, eager)
    log(f"int8 export: {export_s:.1f} s; logits {'bit-identical to' if same else 'DIFFER from'} "
        f"the eager int8 model (max |diff| {(got - eager).abs().max().item():.3g}); K1 launches "
        f"{k1} (eager + exported); variables {_export_bytes(d8)} bytes vs the bf16 export's "
        f"{_export_bytes(d16)} = {ratio:.4f}x, the parameter bytes' share {share:.4f}x "
        f"(slack {EXPORT_BYTES_SLACK})")
    if not same or not ratio <= share + EXPORT_BYTES_SLACK or (
            dev.type == "cuda" and k1 != 2 * cfg.num_layers):
        raise SystemExit("the int8 export is not bit-identical to eager int8, stores more than "
                         "its int8 parameters, or did not run K1 once a layer")
    return {"flash_attention_fwd": flash_attention.launches,
            "flash_attention_dq": flash_attention_bwd.launches_dq,
            "flash_attention_dkv": flash_attention_bwd.launches_dkv}



# ---------------------------------------------------- the serving engine (slice 10)

#: phase 19: the batcher's slots and knobs at GPT-124M-class width
SERVE_SLOTS, SERVE_PAGE, SERVE_CHUNK, SERVE_BLOCK, SERVE_SPEC_K = 4, 16, 64, 8, 4
#: the 2-layer draft: the trained model's embeddings, ``ln_f`` and first
#: layers, over the trailing window of each row
SERVE_DRAFT_LAYERS, SERVE_DRAFT_WINDOW = 2, 64
#: the self-draft: the target itself over a window that holds every
#: request's whole history (prompt <= 264 + budget <= 48 tokens), so its
#: cache-less forward sees what the target's cached verify sees and every
#: proposal must be accepted
SERVE_SELF_DRAFT_WINDOW = 320
SERVE_SAMPLED = {"temperature": 0.8, "top_p": 0.9, "seed": 1234}
#: the bf16 gate: each bf16 stream's first divergence from the solo bf16
#: ``greedy_generate`` must come where the float32 full forward's top two
#: logits on the solo stream up to that token lie within this margin (a
#: near-tie that bf16 rounding may flip).  ``--calibrate-serving`` at seeds
#: 0-2, dense and paged: sound divergences at margins 0.0002-0.0049 (2-4 of
#: 12 streams a run); the skipped rewind's largest 0.16-0.44 (PERF.md, "Serving gate")
SERVE_TIE_TOL = 0.03
#: phase 20: ``examples/gpt/cluster_serving.py`` through one worker at
#: GPT-124M-class width, float32
CLUSTER_SERVING = {"requests": 32, "slots": 8, "max_prompt": 64, "max_new": 24}


def serving_schedules(seed: int, vocab: int) -> tuple[list, list]:
    """Phase 19's traffic, ``[(arrival step, prompt, budget)]``: 12 requests
    of 8-200 tokens (buckets 8 to 256), four of them on one 64-token prefix
    that arrive apart (so paged admissions hit it), budgets 8-48, staggered;
    and 8 repetitive requests (a 3-6 token pattern tiled) for speculation."""
    import numpy as np

    rng = np.random.default_rng(seed + 19)
    prefix = rng.integers(0, vocab, 64)
    lengths = (8, 13, 30, 9, 100, 40, 150, 3, 200, 21, 70, 47)
    shared = {3, 5, 7, 10}                 # 64-token prefix + these lengths
    arrivals = (0, 0, 0, 2, 4, 9, 12, 16, 20, 24, 30, 36)
    main = []
    for i, (t, at) in enumerate(zip(lengths, arrivals)):
        tail = rng.integers(0, vocab, t)
        prompt = np.concatenate([prefix, tail]) if i in shared else tail
        main.append((at, prompt.astype(np.int32), int(rng.integers(8, 49))))
    rep = []
    for i in range(8):
        pattern = rng.integers(0, vocab, int(rng.integers(3, 7)))
        prompt = np.tile(pattern, 32)[:int(rng.integers(24, 97))]
        rep.append((2 * i, prompt.astype(np.int32), int(rng.integers(16, 49))))
    return main, rep


def drive_batcher(b, schedule) -> list:
    """Submit each request ``(arrival step, prompt, budget[, sampling
    kwargs])`` at its arrival step, step until every one has finished; the
    token streams in schedule order."""
    todo = sorted(range(len(schedule)), key=lambda i: schedule[i][0])
    rids, steps = {}, 0
    while todo or b.load()["total"]:
        while todo and schedule[todo[0]][0] <= steps:
            i = todo.pop(0)
            _, prompt, budget, *kw = schedule[i]
            rids[i] = b.submit(prompt, budget, **(kw[0] if kw else {}))
        b.step()
        steps += 1
    res = b.run()
    return [res[rids[i]] for i in range(len(schedule))]


def solo_streams(cfg, params, schedule) -> list:
    from tensorflowonspark_tpu_torch.models.gpt import greedy_generate

    return [greedy_generate(cfg, params, p[None, :], n)[0, len(p):].cpu().numpy()
            for _, p, n in schedule]


def top2_margin(model, prompt, stream, j: int) -> float:
    """The float32 full forward's top-two logit gap at the position that
    picks ``stream[j]`` (prompt + the solo stream's first ``j`` tokens)."""
    import numpy as np
    import torch

    ids = torch.from_numpy(np.concatenate([prompt, stream[:j]]).astype(np.int64))
    dev = next(iter(model.parameters())).device
    with torch.no_grad():
        top = torch.topk(model(ids[None].to(dev))[0, -1].float(), 2).values
    return (top[0] - top[1]).item()


def tie_readings(streams, solo, schedule, model32) -> list:
    """``(request, first divergence or None, top-two margin there)`` of each
    stream against its solo run."""
    import numpy as np

    out = []
    for i, (got, want) in enumerate(zip(streams, solo)):
        diff = np.flatnonzero(got != want)
        j = int(diff[0]) if diff.size else None
        out.append((i, j, None if j is None else top2_margin(model32, schedule[i][1], want, j)))
    return out


def check_serving(seed: int, card: str, trained: dict, gate: bool = True,
                  capture=None) -> dict:
    """Phase 19 on phase 13's trained weights (it runs on their device): the
    ``ContinuousBatcher`` at full width in float32 (TF32 off) under seven
    regimes — dense, paged (16 tokens a page, prefix hits), chunked prefill
    (64), decode blocks (8), prompt-lookup speculation (k 4, repetitive
    prompts), a 2-layer ``DraftModel``, and the model as its own
    ``DraftModel`` (every proposal accepted) — each stream equal to a solo
    ``greedy_generate``; a
    sampled request the same alone and in company; a skipped rewind and a
    scatter into a permuted slot must differ.  Each regime runs again with
    its sites captured as CUDA graphs (``serving/aot.py``): every stream
    equal to the eager batcher's token for token, no failed capture, one
    capture a site used; a replay whose token buffer is not refilled must
    differ.  Then bf16, dense and paged,
    against solo bf16 greedy under the tie gate (:data:`SERVE_TIE_TOL`),
    which the skipped rewind must fail.  With ``gate`` false it only logs
    the readings (``--calibrate-serving``); ``capture`` is the capture
    cache's test seam, for a rehearsal on the CPU.  Returns the kernels' launches
    (the serving path runs none)."""
    import dataclasses

    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.models import gpt, serving
    from tensorflowonspark_tpu_torch.models.serving import ContinuousBatcher, DraftModel
    from tensorflowonspark_tpu_torch.ops.flash_attention import (flash_attention,
                                                                 flash_attention_bwd)
    from tensorflowonspark_tpu_torch.serving.aot import AOTExecutableCache

    cfg, params = trained["cfg"], trained["params"]
    f32 = dataclasses.replace(cfg, dtype=torch.float32, attention_fn=None)
    main, rep = serving_schedules(seed, cfg.vocab_size)
    zero_launch_counts()
    t0 = time.perf_counter()
    want = solo_streams(f32, params, main)
    want_rep = solo_streams(f32, params, rep)
    log(f"serving, float32 on {card}: {len(main)} requests (prompts "
        f"{[len(p) for _, p, _ in main]}, budgets {[n for _, _, n in main]}) and {len(rep)} "
        f"repetitive ones; solo greedy oracles in {time.perf_counter() - t0:.1f} s")
    draft_params = {n: t for n, t in params.items() if not n.startswith("layers.") or
                    int(n.split(".")[1]) < SERVE_DRAFT_LAYERS}

    def drafts():
        """The 2-layer draft and the self-draft (fresh ones for each
        batcher: a draft captures into its first batcher's cache)."""
        return (DraftModel(dataclasses.replace(f32, num_layers=SERVE_DRAFT_LAYERS),
                           draft_params, window=SERVE_DRAFT_WINDOW),
                DraftModel(f32, params, window=SERVE_SELF_DRAFT_WINDOW))
    regimes = {"dense": ({}, main, want),
               f"paged ({SERVE_PAGE} tokens a page)": ({"kv_page_tokens": SERVE_PAGE}, main, want),
               f"prefill_chunk {SERVE_CHUNK}": ({"prefill_chunk": SERVE_CHUNK}, main, want),
               f"decode_block_steps {SERVE_BLOCK}": ({"decode_block_steps": SERVE_BLOCK}, main,
                                                     want),
               f"speculative_k {SERVE_SPEC_K} (repetitive)": ({"speculative_k": SERVE_SPEC_K},
                                                               rep, want_rep),
               f"{SERVE_DRAFT_LAYERS}-layer DraftModel, k {SERVE_SPEC_K}": (
                   {"speculative_k": SERVE_SPEC_K}, main, want),
               f"{cfg.num_layers}-layer self-draft, k {SERVE_SPEC_K}": (
                   {"speculative_k": SERVE_SPEC_K,
                    "speculative_window": SERVE_SELF_DRAFT_WINDOW}, main, want)}
    bad = []
    captured = {}

    def batcher(name, kw, cache=None):
        b = ContinuousBatcher(f32, params, max_batch=SERVE_SLOTS, aot_cache=cache, **kw)
        draft, self_draft = drafts()
        if "Draft" in name:
            b.set_draft(draft)
        elif "self-draft" in name:
            b.set_draft(self_draft)
        return b

    for name, (kw, sched, oracle) in regimes.items():
        b = batcher(name, kw)
        t0 = time.perf_counter()
        streams = drive_batcher(b, sched)
        wall = time.perf_counter() - t0
        same = sum(np.array_equal(g, w) for g, w in zip(streams, oracle))
        extra = ""
        if b.spec_k:
            extra = (f"; acceptance {b.spec_accepted}/{b.spec_proposed}, "
                     f"{b.draft_dispatches} draft calls")
        if b._pages is not None:
            extra = f"; prefix {b.prefix_stats()}"
        log(f"serving {name}: {same}/{len(sched)} streams equal solo greedy; "
            f"{sum(map(len, streams)) / wall:.1f} tok/s, {b.prefill_dispatches} prefill / "
            f"{b.decode_dispatches} decode calls ({b.decode_steps} steps){extra}")
        ok = same == len(sched)
        if b._pages is not None:
            ok &= b.prefix_stats()["hit"] > 0
        if b.spec_k and "Draft" not in name:
            ok &= b.spec_accepted > 0
        if "self-draft" in name:      # the target agrees with itself everywhere
            ok &= 0 < b.spec_accepted == b.spec_proposed
        bad += [] if ok else [name]
        # the same traffic with every site captured as a CUDA graph
        cache = AOTExecutableCache(None, capture=capture)
        cb = batcher(name, kw, cache)
        t0 = time.perf_counter()
        cstreams = drive_batcher(cb, sched)
        cwall = time.perf_counter() - t0
        sites = [x for x in (cb._step, cb._step_sample, *cb._prefill_jit.values(),
                             *(cb._draft_model._propose.values() if cb._draft_model else ()))
                 if x.calls]
        same = sum(np.array_equal(g, w) for g, w in zip(cstreams, streams))
        stats = cache.stats()
        captured[name] = {"equal": same, "of": len(sched), "tok_s": sum(map(len, cstreams)) / cwall,
                          "eager_tok_s": sum(map(len, streams)) / wall, **stats,
                          "sites": len(sites)}
        log(f"serving {name}, captured: {same}/{len(sched)} streams equal the eager batcher's; "
            f"{captured[name]['tok_s']:.1f} tok/s (eager {captured[name]['eager_tok_s']:.1f}, "
            f"first calls and captures included); {stats['compiles']} captures for "
            f"{len(sites)} sites used, {stats['errors']} errors, {stats['loads']} loads")
        if same != len(sched) or stats["errors"] or stats["compiles"] != len(sites):
            bad.append(f"{name}, captured")
    # a sampled request: alone, and in the company of the main schedule
    sampled = (3, main[4][1], 24, SERVE_SAMPLED)
    s_alone, = drive_batcher(ContinuousBatcher(f32, params, max_batch=SERVE_SLOTS), [sampled])
    *streams, s_company = drive_batcher(ContinuousBatcher(f32, params, max_batch=SERVE_SLOTS),
                                        main + [sampled])
    company_exact = all(np.array_equal(g, w) for g, w in zip(streams, want))
    same_sampled = np.array_equal(s_alone, s_company)
    log(f"serving, a sampled request ({SERVE_SAMPLED}): "
        f"{'the same' if same_sampled else 'DIFFERENT'} alone and in company "
        f"({s_alone[:8].tolist()}...; greedy would give {want[4][:8].tolist()}...); its "
        f"company equal to solo greedy: {company_exact}")
    bad += [] if same_sampled and company_exact else ["sampled"]

    # planted faults: both must change some stream
    def skipped_rewind(b):
        serving.rewind_cache = lambda cache, position: cache
        return b

    def permuted_slot(b):
        scatter = b._scatter_rows
        b._scatter_rows = lambda rows, slots: scatter(
            rows, [(s + 1) % b.max_batch if s < b.max_batch else s for s in slots])
        return b

    def unrefilled_tokens(b):
        b._step.refill = lambda leaves: None      # the token buffer keeps the capture's
        return b

    faults = {"skipped rewind (planted fault)": skipped_rewind,
              "scatter into a permuted slot (planted fault)": permuted_slot,
              "captured, the step's token buffer not refilled (planted fault)":
                  unrefilled_tokens}
    for name, plant in faults.items():
        cache = AOTExecutableCache(None, capture=capture) if "captured" in name else None
        try:
            streams = drive_batcher(plant(ContinuousBatcher(f32, params, max_batch=SERVE_SLOTS,
                                                            aot_cache=cache)), main)
        finally:
            serving.rewind_cache = gpt.rewind_cache
        same = sum(np.array_equal(g, w) for g, w in zip(streams, want))
        log(f"serving {name}: {same}/{len(main)} streams equal solo greedy")
        bad += [name] if same == len(main) else []

    # bf16: dense and paged against solo bf16 greedy, tie-aware
    model32 = gpt._model(f32, params)
    want16 = solo_streams(cfg, params, main)
    for name, kw, plant in (("bf16 dense", {}, None),
                            ("bf16 paged", {"kv_page_tokens": SERVE_PAGE}, None),
                            ("bf16 dense, skipped rewind (planted fault)", {}, skipped_rewind)):
        b = ContinuousBatcher(cfg, params, max_batch=SERVE_SLOTS, **kw)
        try:
            streams = drive_batcher(plant(b) if plant else b, main)
        finally:
            serving.rewind_cache = gpt.rewind_cache
        r = tie_readings(streams, want16, main, model32)
        div = [(i, j, m) for i, j, m in r if j is not None]
        within = all(m <= SERVE_TIE_TOL for _, _, m in div)
        log(f"serving {name}: {len(main) - len(div)}/{len(main)} streams identical to solo bf16 "
            f"greedy; first divergences (request, token, float32 top-two margin): "
            f"{[(i, j, round(m, 5)) for i, j, m in div]} -> {'within' if within else 'OUTSIDE'} "
            f"{SERVE_TIE_TOL}")
        bad += [] if within == (plant is None) else [name]
    launches = {"flash_attention_fwd": flash_attention.launches,
                "flash_attention_dq": flash_attention_bwd.launches_dq,
                "flash_attention_dkv": flash_attention_bwd.launches_dkv}
    log(f"serving gate: {'passed' if not bad else 'FAILED: ' + ', '.join(bad)}; kernel "
        f"launches on the serving path {launches} (the cached decode is PyTorch)")
    if gate and bad:
        raise SystemExit(f"the serving engine's gate failed: {bad}")
    return {**launches, "captured": captured, "main": main, "solo": want}


def run_cluster_serving(seed: int, card: str, wd: str, device: str = "cuda",
                        width: dict | None = None) -> dict:
    """Phase 20: the port's ``examples/gpt/cluster_serving.py`` through
    ``TPUCluster.run`` + ``cluster.inference``, one worker hosting a
    ``ContinuousBatcher`` at GPT-124M-class width in float32, 32 requests,
    8 slots: every result back in order and equal to the driver's solo
    greedy oracle.  ``width`` and ``device="cpu"`` rehearse it at a tiny
    size.  Returns the kernels' launches in the worker (none): each
    worker reports its process's counts, which start at 0."""
    from tensorflowonspark_tpu_torch.examples.gpt import cluster_serving as cs

    c = CLUSTER_SERVING
    args = {"vocab": GPT_WIDTH["vocab"], "hidden": GPT_WIDTH["hidden"],
            "num_layers": GPT_WIDTH["num_layers"], "num_heads": GPT_WIDTH["num_heads"],
            "max_position_embeddings": GPT_WIDTH["max_position_embeddings"],
            "intermediate_size": 4 * GPT_WIDTH["hidden"], **(width or {}),
            "slots": c["slots"], "seed": seed, "bf16": False, "device": device}
    reqs = cs.make_requests(c["requests"], args["vocab"], seed, c["max_prompt"], c["max_new"])
    worker_env = {"OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""} if device == "cpu" \
        else None
    t0 = time.perf_counter()
    results, stats, seconds = cs.serve(args, reqs, 1, worker_env=worker_env,
                                       working_dir=os.path.join(wd, "cluster_serving"))
    wall = time.perf_counter() - t0
    import torch

    want = cs.oracle(args, reqs, torch.device(device))
    same = sum(list(g) == w for g, w in zip(results, want))
    tokens = sum(len(r) for r in results)
    st = stats[0]
    log(f"cluster serving on {card}: {len(results)} of {len(reqs)} results in order, {same} equal "
        f"to the driver's solo greedy; inference {seconds:.2f} s = {len(results) / seconds:.1f} "
        f"rows/s, {tokens / seconds:.1f} tokens/s end to end (the worker's weights and CUDA "
        f"start included; {wall:.1f} s with the cluster's boot and shutdown); worker, first "
        f"submit to last result: {st['serve_s']:.2f} s = {len(results) / st['serve_s']:.1f} "
        f"rows/s, {tokens / st['serve_s']:.1f} tokens/s, {st['prefill_dispatches']} prefill / "
        f"{st['decode_dispatches']} decode calls; shm connections {st['shm_conns']}, "
        f"{st['device']}")
    if len(results) != len(reqs) or same != len(reqs):
        raise SystemExit("the cluster serving path lost, reordered or changed a request")
    return {k: sum(w["launches"][k] for w in stats) for k in KERNEL_NAMES}


#: phase 21: the online tier on phase 13's weights — replicas, one warm
#: standby, 24 requests from 4 concurrent clients with phase 19's prompt
#: lengths (8-200 tokens) and budgets (8-48), replica 1 SIGKILLed at its
#: decode step ``kill_at_step`` (``TFOS_CHAOS``).  The planted fault runs
#: in this process for time: a warm standby's captured batcher promoted,
#: ``fault_requests`` of the requests
SERVING_TIER = {"replicas": 2, "standbys": 1, "slots": 4, "clients": 4, "requests": 24,
                "kill_at_step": 8, "fault_requests": 6}


def tier_requests(seed: int, vocab: int, n: int) -> list:
    """``n`` requests ``(prompt list, budget)``: phase 19's prompt lengths
    in turn, random tokens and budgets 8-48 from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed + 21)
    lengths = (8, 13, 30, 9, 100, 40, 150, 3 + 64, 200, 21, 70, 47)
    return [(rng.integers(0, vocab, lengths[i % len(lengths)]).tolist(),
             int(rng.integers(8, 49))) for i in range(n)]


def tier_builder(args: dict):
    """The tier's model in each worker: phase 13's configuration (float32)
    and its trained weights, saved by :func:`run_serving_tier`."""
    import torch

    return args["tier_cfg"], torch.load(args["tier_weights"], map_location="cpu",
                                        weights_only=True)


def rebinding_load_params(self, params):
    """Phase 21's planted fault: a ``load_params`` that binds new tensors in
    the model instead of copying into the captured storage, so a promoted
    standby's captured sites keep reading the storage its unload zeroed."""
    import torch

    from tensorflowonspark_tpu_torch.models import gpt

    self._stale = self._bound_params()     # the storage the captures read stays
    params = {n: torch.as_tensor(v).to(self.device) for n, v in params.items()}
    gpt.bind(self.model, params)
    self.params = params


def check_promotion_in_process(trained: dict, tier: dict, slots: int, n: int) -> dict:
    """Phase 21's planted fault in this process on the card (no second
    tier: cut for time): a warm standby's posture — a captured batcher
    (``AOTExecutableCache``) whose warm-up sweep captured its sites, then
    ``unload_params`` — promoted by ``load_params`` of phase 13's weights,
    once as the port copies them into the captured storage and once by
    :func:`rebinding_load_params`, then serving ``n`` of the tier's
    requests.  Returns the streams equal to solo greedy in each."""
    import types

    import numpy as np

    from tensorflowonspark_tpu_torch.models.serving import ContinuousBatcher
    from tensorflowonspark_tpu_torch.serving.aot import AOTExecutableCache
    from tensorflowonspark_tpu_torch.serving.standby import _warm_batcher

    f32 = serving_config(trained)
    reqs = list(zip(tier["requests"], tier["solo"]))[:n]
    out = {}
    for name, load in (("sound", None), ("rebinding promotion", rebinding_load_params)):
        b = ContinuousBatcher(f32, trained["params"], max_batch=slots,
                              aot_cache=AOTExecutableCache(None))
        _warm_batcher(b)
        b.unload_params()
        if load is not None:
            b.load_params = types.MethodType(load, b)
        b.load_params(trained["params"])
        rids = {b.submit(np.asarray(p), budget): k for k, ((p, budget), _) in enumerate(reqs)}
        results = b.run()
        out[name] = sum([int(t) for t in results[r]] == reqs[k][1] for r, k in rids.items())
        out[f"{name} captures"] = b.aot_stats()
        del b
    return out


def run_serving_tier(seed: int, card: str, wd: str, trained: dict, device: str = "cuda",
                     worker_env: dict | None = None) -> dict:
    """Phase 21: ``ServingCluster.run`` (the port's ``examples/gpt/
    online_serving.py``) with :data:`SERVING_TIER`'s replicas and warm
    standby on the card, every site captured as a CUDA graph (the
    standby's in its warm-up sweep), float32 with TF32 off, behind the TCP
    frontend: every stream equal to a solo ``greedy_generate`` in this
    process, a requeue, a standby promotion whose standby then served, no
    failed capture on any replica, and every replica that served reporting
    its kernel launches.  A promotion that rebinds the weights instead of copying them
    into the captured storage (:func:`rebinding_load_params`, in this
    process: :func:`check_promotion_in_process`) must change a stream.
    ``device="cpu"`` rehearses it (no captures there, and no fault check).  Returns
    the kernels' launches on the sound run (none), summed over the
    replicas' heartbeat-carried counts, and the tier's readings."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.examples.gpt import online_serving
    from tensorflowonspark_tpu_torch.models.gpt import greedy_generate

    c = SERVING_TIER
    f32 = serving_config(trained)
    params = trained["params"]
    path = os.path.join(wd, "tier_weights.pt")
    torch.save({n: t.detach().cpu() for n, t in params.items()}, path)
    args = {"tier_cfg": f32, "tier_weights": path}
    reqs = tier_requests(seed, f32.vocab_size, c["requests"])
    t0 = time.perf_counter()
    want = [greedy_generate(f32, params, np.asarray([p]), n)[0, len(p):].tolist()
            for p, n in reqs]
    log(f"serving tier: {len(reqs)} requests (prompts {[len(p) for p, _ in reqs]}, budgets "
        f"{[n for _, n in reqs]}); solo greedy oracles in {time.perf_counter() - t0:.1f} s")
    readings, bad, launches = {}, [], None
    for name, builder, n, replicas, kill_node in (
            ("sound", tier_builder, c["requests"], c["replicas"], 1),):
        zero_launch_counts()   # the driver's; each worker's start at 0 with its process
        t0 = time.perf_counter()
        out = online_serving.run(args, reqs[:n], replicas=replicas, slots=c["slots"],
                                 clients=c["clients"], warm_standbys=c["standbys"],
                                 kill_at_step=c["kill_at_step"], kill_node=kill_node,
                                 graphs=device == "cuda", device=device, builder=builder,
                                 worker_env=worker_env,
                                 working_dir=os.path.join(wd, f"tier_{len(readings)}"))
        secs = time.perf_counter() - t0
        m = out["metrics"]
        same = sum(out["results"].get(i) == want[i] for i in range(n))
        aot = {eid: {k: online_serving.counter(node, "tfos_replica_aot_resolves_total",
                                               outcome=k) for k in ("compile", "error", "load")}
               for eid, node in out["nodes"].items()}
        served = {eid: r["served"] for eid, r in m["replicas"].items()}
        # the replicas' own kernel launches (heartbeat-carried); every
        # replica that served must report them
        counted = {eid: {k: online_serving.counter(node, "tfos_replica_kernel_launches_total",
                                                   kernel=k) for k in KERNEL_NAMES}
                   for eid, node in out["nodes"].items()
                   if "tfos_replica_kernel_launches_total" in (node.get("metrics") or {})}
        run_launches = {k: int(sum(c[k] for c in counted.values())) for k in KERNEL_NAMES}
        ttft = sorted(out["ttft"].values())
        e2e = sorted(out["e2e"].values())
        tokens = sum(len(r) for r in out["results"].values())
        readings[name] = {
            "seconds": secs, "equal": same, "of": n, "requeued": m["requeued"],
            "promotions": m.get("standby", {}).get("promotions", {}),
            "heal_s": m.get("standby", {}).get("heal", {}).get("max_secs"), "aot": aot,
            "served": served, "standby_served": sum(v for e, v in served.items()
                                                    if int(e) >= replicas),
            "launches": run_launches, "launches_from": sorted(counted),
            "ttft_p50_s": ttft[len(ttft) // 2] if ttft else None,
            "e2e_p50_s": e2e[len(e2e) // 2] if e2e else None,
            "tok_s": tokens / out["wall"]}
        log(f"serving tier, {name}, on {card}: {same}/{n} streams equal solo greedy in "
            f"{secs:.1f} s (boot, warm-up, traffic, shutdown); traffic {out['wall']:.2f} s, "
            f"{readings[name]['tok_s']:.1f} tok/s, TTFT p50 {readings[name]['ttft_p50_s']}, "
            f"end to end p50 {readings[name]['e2e_p50_s']}; requeued {m['requeued']}, "
            f"promotions {readings[name]['promotions']}, heal {readings[name]['heal_s']} s; "
            f"served by replica {readings[name]['served']} (the promoted standby "
            f"{readings[name]['standby_served']}); captures by replica {aot}; kernel launches "
            f"{run_launches}, reported by replicas {sorted(counted)}")
        captured_ok = device != "cuda" or (
            all(a["error"] == 0 for a in aot.values())
            and all(aot.get(e, {}).get("compile", 0) > 0
                    for e, r in m["replicas"].items() if r["alive"]))
        launches = run_launches
        reported = all(e in counted for e, v in served.items() if v)
        if same != n or m["requeued"] < 1 or not readings[name]["promotions"] \
                or not readings[name]["standby_served"] or not captured_ok \
                or not reported:
            bad.append(name)
    if device == "cuda":
        t0 = time.perf_counter()
        n = c["fault_requests"]
        promo = readings["promotion in this process"] = check_promotion_in_process(
            trained, {"requests": reqs, "solo": want}, c["slots"], n)
        log(f"serving tier, a warm standby promoted in this process (captured, {n} requests, "
            f"{time.perf_counter() - t0:.1f} s): {promo}")
        if promo["sound"] != n:
            bad.append("a promotion that copies into the captured storage")
        if promo["rebinding promotion"] == n:
            bad.append("a rebinding promotion (planted fault) changed no stream")
    log(f"serving tier gate: {'passed' if not bad else 'FAILED: ' + ', '.join(bad)}")
    if bad:
        raise SystemExit(f"the serving tier's gate failed: {bad}")
    return {**launches, "tier": readings, "requests": reqs, "solo": want}


# ---------------------------- phase 22: the rest of the tier (slice 12)

#: phase 22, tier A: one replica of phase 13's weights (v1) with the
#: autoscaler at min 1 and max 2, a burst that scales it up, a canary
#: rollout to v2 (v1 plus a seeded adapter delta) with traffic flowing,
#: then the driver crashed mid-stream and resumed from its journal on the
#: same port.  ``pool`` requests (phase 19's prompt lengths, budgets 16-32)
#: feed the burst (all at once: more than one replica's slots and
#: overcommit hold, so the queue grows) and the traffic;
#: ``crash_requests`` of ``crash_budget`` tokens stream through the crash
ROLLOUT_TIER = {"slots": 4, "pool": 8, "burst": 16, "clients": 4,
                "crash_requests": 4, "crash_budget": 96, "failover_wait": 60.0,
                "autoscale": {"min_replicas": 1, "max_replicas": 2, "interval": 0.05,
                              "up_queue_per_replica": 2.0, "up_consecutive": 1,
                              "up_cooldown": 0.0, "down_consecutive": 10 ** 6,
                              "down_cooldown": 3600.0},
                "policy": {"steps": (50, 100), "bake_secs": 2.0, "min_samples": 2,
                           "max_e2e_ratio": None}}
#: phase 22, tier B: a disaggregated tier of one prefill and one decode
#: replica (paged KV) serving phase 21's first ``requests`` requests
DISAGG_TIER = {"disagg": {"prefill": 1, "decode": 1}, "page_tokens": 16, "requests": 12,
               "slots": 4, "clients": 4}


def rollout_delta(cfg, seed: int) -> dict:
    """v2's adapter delta over v1 (state-dict names): a seeded shift of the
    final norm's bias and a small one of the last layer's query weights —
    enough to change most greedy streams."""
    import numpy as np

    rng = np.random.default_rng(seed + 22)
    h, last = cfg.hidden_size, cfg.num_layers - 1
    return {"ln_f.bias": (0.5 * rng.standard_normal(h)).astype(np.float32),
            f"layers.{last}.attn.query.weight":
                (0.02 * rng.standard_normal((h, h))).astype(np.float32)}


def rollout_registry(delta: dict):
    """The tier's catalog: ``gpt@v1`` (:func:`tier_builder`) and ``gpt@v2``,
    an adapter version over it with ``delta``, its offline eval passed.  A
    resumed driver registers the same builders again."""
    from tensorflowonspark_tpu_torch.serving import ModelRegistry

    reg = ModelRegistry()
    reg.register("gpt", "v1", tier_builder)
    reg.register("gpt", "v2", base=("gpt", "v1"), adapter=delta)
    reg.record_eval("gpt", "v2", {"planted": True}, passed=True)
    return reg


def resumed_registry(delta: dict, version: str, payload: dict):
    """A resumed driver's catalog after phase 23b: :func:`rollout_registry`'s
    versions and the promoted candidate ``version``, an adapter over v1
    with ``payload`` (re-registered by the operator, as every builder is;
    the journal restores its state and eval verdict)."""
    reg = rollout_registry(delta)
    reg.register("gpt", version, base=("gpt", "v1"), adapter=payload)
    return reg


def stream_clients(address, authkey, jobs: list, clients: int, timeout: float,
                   failover_wait: float = 0.0, stop=None) -> tuple[list, list]:
    """Stream ``jobs`` (``(index, prompt, budget)``) through ``clients``
    threads, each with its own ``ServeClient``; with ``stop`` (an Event) the
    clients loop over their jobs until it is set.  Returns the threads
    (started) and the record list they append to as each request starts:
    ``{"i", "tokens", "t0", "t1", "deltas": [(epoch, n)], "error"}``, filled
    as its stream arrives (``t1`` None until it ends)."""
    import threading

    from tensorflowonspark_tpu_torch.serving import ServeClient

    out: list = []

    def client(cid):
        try:
            with ServeClient(address, authkey, timeout=timeout,
                             failover_wait=failover_wait) as c:
                while True:
                    for i, prompt, budget in jobs[cid::clients]:
                        rec = {"i": i, "tokens": [], "deltas": [], "error": None,
                               "t0": time.time(), "t1": None}
                        out.append(rec)
                        try:
                            for d in c.generate_stream(prompt, budget, timeout=timeout):
                                rec["deltas"].append((time.time(), len(d)))
                                rec["tokens"].extend(d)
                        except Exception as e:  # a lost request is a reading, not a crash
                            rec["error"] = f"{type(e).__name__}: {e}"
                        rec["t1"] = time.time()
                        if stop is not None and stop.is_set():
                            return
                    if stop is None:
                        return
        except Exception as e:
            out.append({"i": None, "error": f"{type(e).__name__}: {e}", "tokens": [],
                        "deltas": [], "t0": time.time(), "t1": time.time()})

    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(clients)]
    for t in threads:
        t.start()
    return threads, out


def skipping_adopt(self, state):
    """Phase 22's planted resume fault: ``ReplicaScheduler.adopt`` over a
    journal whose accepted-but-uncommitted requests are left out, so the
    resumed driver requeues nothing."""
    import copy

    from tensorflowonspark_tpu_torch.serving.scheduler import ReplicaScheduler

    st = copy.copy(state)
    st.admitted = {r: a for r, a in state.admitted.items() if r in state.committed}
    return ReplicaScheduler._sound_adopt(self, st)


def crash_and_resume(serving, jobs, want, c: dict, registry, timeout: float,
                     model: tuple = ("gpt", "v2")):
    """Stream ``jobs`` with ``failover_wait`` clients, crash the driver once
    every client holds a token, and resume it from the journal on the same
    port, labelled ``model`` (the version serving).  Returns the resumed tier and the readings: streams equal to
    ``want``, errors, the heal seconds (the crash to the first token a
    client reads after ``resume_driver`` returned: frames the dead driver
    sent before the crash may still sit in a client's socket, so an earlier
    token proves nothing), ``resume_driver``'s own seconds, and the
    journal's unfinished count."""
    from tensorflowonspark_tpu_torch.serving import ControlPlaneJournal, resume_driver

    jpath = serving.journal.path
    threads, out = stream_clients(serving.address, serving.authkey, jobs, len(jobs), timeout,
                                  failover_wait=c["failover_wait"])
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not (
            len(out) == len(jobs) and all(r["tokens"] for r in out)):
        time.sleep(0.002)
    t_crash = time.time()
    held = sorted(len(r["tokens"]) for r in out)
    serving.crash()
    resumed = resume_driver(serving.cluster, journal_path=jpath, address=serving.address,
                            max_batch=c["slots"], model=model, registry=registry,
                            crashed_at=t_crash, client_timeout=timeout)
    t_resumed = time.time()
    resume_s = t_resumed - t_crash
    for t in threads:
        t.join(timeout)
    # the dead driver's requests still decode on the replicas (their
    # messages miss the new scheduler and drop): wait for the replicas to
    # report an empty batcher, so nothing stale streams into a shutdown
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and any(
            rep["alive"] and rep["reported_load"]
            for rep in resumed.scheduler.metrics()["replicas"].values()):
        time.sleep(0.05)
    first_after = min((t for r in out for t, _ in r["deltas"] if t > t_resumed), default=None)
    # a commit is journaled before its DONE reaches the client: the joined
    # clients' commits are on disk
    return resumed, {
        "held_at_crash": held, "resume_s": resume_s,
        "heal_s": None if first_after is None else first_after - t_crash,
        "equal": sum(r["error"] is None and r["tokens"] == want[r["i"]] for r in out),
        "of": len(jobs), "errors": [r["error"] for r in out if r["error"]],
        "unfinished": len(ControlPlaneJournal.replay(jpath).unfinished),
        "requeued": len(resumed.resume_state.unfinished)}


def tier_launches(nodes: dict) -> tuple[dict, list]:
    """The kernels' launches summed over the replicas' heartbeat-carried
    counts, and the replicas that reported them."""
    from tensorflowonspark_tpu_torch.examples.gpt import online_serving

    counted = {eid: {k: online_serving.counter(node, "tfos_replica_kernel_launches_total",
                                               kernel=k) for k in KERNEL_NAMES}
               for eid, node in nodes.items()
               if "tfos_replica_kernel_launches_total" in (node.get("metrics") or {})}
    return ({k: int(sum(c[k] for c in counted.values())) for k in KERNEL_NAMES},
            sorted(counted))


def run_rollout_tier(seed: int, card: str, wd: str, trained: dict, tier: dict,
                     device: str = "cuda", worker_env: dict | None = None,
                     timeout: float = 300.0, continual: dict | None = None) -> dict:
    """Phase 22, tier A (:data:`ROLLOUT_TIER`): ``ServingCluster.run`` with a
    ``ModelRegistry`` (``gpt@v1`` phase 13's weights, ``gpt@v2`` v1 plus
    :func:`rollout_delta`), one captured replica and the autoscaler; a burst
    must scale it up (a ``scale_up`` event); ``rollout("gpt", "v2")`` under
    traffic must promote, every stream done before it started equal to solo
    greedy under v1, every one during it to v1's or v2's, every one after
    it to v2's; then phase 23b's continual loop promotes a fine-tuned
    candidate on this tier (:func:`run_continual_loop`; ``continual``
    overrides :data:`CONTINUAL` for a rehearsal); then the driver is
    crashed mid-stream and ``resume_driver`` rebinds its port: the
    ``failover_wait`` clients ride through, every stream equal to the
    candidate's solo greedy, the journal holds no accepted request without
    a commit, and a ``ContinualPipeline.resume()`` on the resumed tier
    settles nothing (the candidate's ``continual_done`` is journaled).  Planted faults on the resumed tier: a hot
    swap whose payload drops the adapter delta (v1 under v2's label) must
    change a stream; a resume that requeues nothing must lose a request."""
    import numpy as np

    from tensorflowonspark_tpu_torch.continual import ContinualPipeline
    from tensorflowonspark_tpu_torch.models.gpt import greedy_generate
    from tensorflowonspark_tpu_torch.observability import EventLog
    from tensorflowonspark_tpu_torch.serving import (ControlPlaneJournal, RolloutPolicy,
                                                     ServingCluster, apply_adapter,
                                                     rollout as rollout_mod, scheduler)

    c = ROLLOUT_TIER
    f32 = serving_config(trained)
    v1 = trained["params"]
    delta = rollout_delta(f32, seed)
    v2 = apply_adapter(v1, delta)
    rng = np.random.default_rng(seed + 220)
    pool = [(p, int(rng.integers(16, 33))) for p, _ in tier["requests"][:c["pool"]]]
    crash = [(p, c["crash_budget"]) for p, _ in tier["requests"][c["pool"]:][:c["crash_requests"]]]
    t0 = time.perf_counter()
    solo = {v: [greedy_generate(f32, w, np.asarray([p]), n)[0, len(p):].tolist()
                for p, n in pool] for v, w in (("v1", v1), ("v2", v2))}
    del v2
    differ = sum(a != b for a, b in zip(solo["v1"], solo["v2"]))
    log(f"rollout tier: {len(pool)} pooled requests, v2 changes {differ} of their greedy "
        f"streams; {len(crash)} crash requests of {c['crash_budget']} tokens; solo greedy "
        f"oracles in {time.perf_counter() - t0:.1f} s")
    if not differ:
        raise SystemExit("rollout tier: the v2 delta changes no greedy stream")
    path = os.path.join(wd, "tier_weights.pt")
    args = {"tier_cfg": f32, "tier_weights": path}
    twd = os.path.join(wd, "rollout_tier")
    r, bad = {}, []
    t_boot = time.perf_counter()
    serving = ServingCluster.run(
        None, 1, max_batch=c["slots"], replica_args=args, model=("gpt", "v1"),
        registry=rollout_registry(delta), autoscale=dict(c["autoscale"]),
        aot_cache=device == "cuda", device=device, worker_env=worker_env, working_dir=twd,
        reservation_timeout=timeout, client_timeout=timeout)
    live = serving      # the tier in charge: each resume replaces it
    try:
        r["boot_s"] = time.perf_counter() - t_boot
        jobs = [(i % len(pool), *pool[i % len(pool)]) for i in range(c["burst"])]
        t0 = time.perf_counter()
        threads, burst = stream_clients(serving.address, serving.authkey, jobs,
                                        len(jobs), timeout)
        for t in threads:
            t.join(timeout)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and (
                len(serving.scheduler.alive_replicas()) < 2
                or serving.autoscaler.scale_ups < 1):
            time.sleep(0.1)
        # until the scaled-up replica has served, keep the pool's requests flowing
        pre = list(burst)
        while time.monotonic() < deadline and not all(
                rep["served"] for rep in serving.scheduler.metrics()["replicas"].values()):
            threads, more = stream_clients(serving.address, serving.authkey,
                                           [(i, *pool[i]) for i in range(len(pool))],
                                           c["clients"], timeout)
            for t in threads:
                t.join(timeout)
            pre += more
        r["scale_up_s"] = time.perf_counter() - t0
        events = EventLog.read(os.path.join(twd, "serving_events.jsonl"))
        r["scale_up_events"] = [e.get("reason") for e in events if e["kind"] == "scale_up"]
        r["pre_equal"] = sum(x["error"] is None and x["tokens"] == solo["v1"][x["i"]]
                             for x in pre)
        r["pre_of"] = len(pre)
        # the rollout, traffic flowing
        import threading

        stop = threading.Event()
        t_start = time.time()
        threads, during = stream_clients(serving.address, serving.authkey,
                                         [(i, *pool[i]) for i in range(len(pool))],
                                         c["clients"], timeout, stop=stop)
        ctl = serving.rollout("gpt", "v2", policy=RolloutPolicy(**c["policy"]))
        t_promoted = time.time()
        stop.set()
        for t in threads:
            t.join(timeout)
        r["rollout_s"] = t_promoted - t_start
        r["rollout_state"] = ctl.state
        r["rollout_steps"] = [(s["percent"], s["ok"], s.get("reason"),
                               (s.get("canary") or {}).get("completed")) for s in ctl.steps_taken]
        r["during_v1_or_v2"] = sum(x["error"] is None and x["tokens"] in
                                   (solo["v1"][x["i"]], solo["v2"][x["i"]]) for x in during)
        r["during_of"] = len(during)
        r["during_v2"] = sum(x["tokens"] == solo["v2"][x["i"]] != solo["v1"][x["i"]]
                             for x in during)
        threads, post = stream_clients(serving.address, serving.authkey,
                                       [(i, *pool[i]) for i in range(len(pool))],
                                       c["clients"], timeout)
        for t in threads:
            t.join(timeout)
        r["post_equal"] = sum(x["error"] is None and x["tokens"] == solo["v2"][x["i"]]
                              for x in post)
        r["post_of"] = len(post)
        r["versions"] = serving.scheduler.model_versions("gpt")
        # phase 23b: the continual loop promotes a fine-tuned candidate here
        t0 = time.perf_counter()
        r["continual"] = run_continual_loop(seed, card, wd, serving, trained, pool, solo["v2"],
                                            c["policy"], device, worker_env, timeout, continual)
        r["continual_s"] = time.perf_counter() - t0
        served = ("gpt", r["continual"]["version"])
        payload = r["continual"].pop("payload")
        cand = apply_adapter(v1, payload)
        solo_crash = [greedy_generate(f32, cand, np.asarray([p]), n)[0, len(p):].tolist()
                      for p, n in crash]
        del cand
        # the driver crashed mid-stream, resumed from its journal on the same port
        jobs = [(i, *crash[i]) for i in range(len(crash))]
        resumed, r["crash"] = crash_and_resume(serving, jobs, solo_crash, c,
                                               resumed_registry(delta, served[1], payload),
                                               timeout, model=served)
        live = resumed
        # a pipeline rebuilt on the resumed tier finds nothing open
        r["continual_resume"] = ContinualPipeline(resumed, "gpt",
                                                  base_builder=tier_builder).resume()
        # planted fault 1: the hot swap's payload drops the adapter delta
        sound_payload = rollout_mod.ModelVersion.swap_payload

        def dropping_payload(self):
            p = sound_payload(self)
            p.pop("adapter", None)
            return p

        rollout_mod.ModelVersion.swap_payload = dropping_payload
        try:
            resumed.swap_replica_model(0, "gpt", "v2")
        finally:
            rollout_mod.ModelVersion.swap_payload = sound_payload
        resumed.scheduler.mark_draining(1, reason="planted fault: route to replica 0")
        threads, fault = stream_clients(resumed.address, resumed.authkey,
                                        [(i, *pool[i]) for i in range(len(pool))],
                                        c["clients"], timeout)
        for t in threads:
            t.join(timeout)
        r["fault_dropped_delta"] = {"equal": sum(x["tokens"] == solo["v2"][x["i"]]
                                                 for x in fault), "of": len(fault)}
        # planted fault 2: a resume that requeues nothing
        scheduler.ReplicaScheduler._sound_adopt = scheduler.ReplicaScheduler.adopt
        scheduler.ReplicaScheduler.adopt = skipping_adopt
        try:
            live, r["fault_no_requeue"] = crash_and_resume(
                resumed, jobs, solo_crash, c, resumed_registry(delta, served[1], payload),
                timeout, model=served)
        finally:
            scheduler.ReplicaScheduler.adopt = scheduler.ReplicaScheduler._sound_adopt
            del scheduler.ReplicaScheduler._sound_adopt
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and len(
                tier_launches(live.metrics()["nodes"])[1]) < 2:
            time.sleep(0.2)
        r["launches"], r["launches_from"] = tier_launches(live.metrics()["nodes"])
    finally:
        if live._shutdown_done:     # crashed, and no resume took over
            live.cluster.shutdown(timeout=timeout)
        else:
            live.shutdown(timeout=timeout)
    r["journal_records"] = len(ControlPlaneJournal.read_records(
        os.path.join(twd, "control_plane.jsonl")))
    cr = r["crash"]
    ok = {"scale_up": bool(r["scale_up_events"]),
          "pre": r["pre_equal"] == r["pre_of"],
          "promoted": r["rollout_state"] == "promoted",
          "during": r["during_v1_or_v2"] == r["during_of"],
          "post": r["post_equal"] == r["post_of"] and r["versions"] == {"v2": [0, 1]},
          "crash": cr["equal"] == cr["of"] and not cr["errors"] and cr["unfinished"] == 0
                   and cr["requeued"] >= 1 and min(cr["held_at_crash"]) < c["crash_budget"],
          "resumed pipeline settles nothing": r["continual_resume"] == {},
          "launches": not any(r["launches"].values()) and r["launches_from"] == [0, 1]}
    faults = {"dropped delta changes a stream":
                  r["fault_dropped_delta"]["equal"] < r["fault_dropped_delta"]["of"],
              "no requeue loses a request": r["fault_no_requeue"]["unfinished"] > 0}
    log(f"rollout tier on {card}: boot {r['boot_s']:.1f} s; burst of {c['burst']} -> scale_up "
        f"in {r['scale_up_s']:.1f} s ({r['scale_up_events']}); before the rollout "
        f"{r['pre_equal']}/{r['pre_of']} streams equal v1's solo greedy; rollout "
        f"{r['rollout_state']} in {r['rollout_s']:.1f} s, steps {r['rollout_steps']}, "
        f"{r['during_v1_or_v2']}/{r['during_of']} streams during it equal v1's or v2's "
        f"({r['during_v2']} v2's); after it {r['post_equal']}/{r['post_of']} equal v2's, "
        f"versions {r['versions']}; driver crash with streams holding {cr['held_at_crash']} "
        f"tokens (serving {served[1]}): resume_driver {cr['resume_s']:.2f} s, heal (the crash to the first token "
        f"after the resume) {cr['heal_s']} s, requeued {cr['requeued']}, {cr['equal']}/{cr['of']} streams "
        f"exact, errors {cr['errors']}, unfinished in the journal {cr['unfinished']} "
        f"({r['journal_records']} records); kernel launches {r['launches']} from replicas "
        f"{r['launches_from']}; phase 23b's continual loop {r['continual_s']:.1f} s on this "
        f"tier; a pipeline rebuilt on the resumed tier settled {r['continual_resume']}")
    log(f"rollout tier planted faults: a swap dropping the delta: "
        f"{r['fault_dropped_delta']['equal']}/{r['fault_dropped_delta']['of']} equal v2's; "
        f"a resume that requeues nothing: unfinished {r['fault_no_requeue']['unfinished']}, "
        f"client errors {len(r['fault_no_requeue']['errors'])}")
    bad = [k for k, v in ok.items() if not v] + [k for k, v in faults.items() if not v]
    log(f"rollout tier gate: {'passed' if not bad else 'FAILED: ' + ', '.join(bad)}")
    if bad:
        raise SystemExit(f"the rollout tier's gate failed: {bad}")
    return r


def check_handoff_in_process(trained: dict, tier: dict, page_tokens: int, n: int) -> dict:
    """Phase 22's smallest disaggregated tier, in this process on the card:
    a prefill-only batcher hands ``n`` of phase 21's requests to a decode
    batcher (paged KV, eager), once as the port seats them and once with
    the session seated one position off (planted fault).  Returns the
    streams equal to solo greedy in each."""
    import numpy as np

    from tensorflowonspark_tpu_torch.models.serving import ContinuousBatcher

    f32 = serving_config(trained)
    reqs = list(zip(tier["requests"], tier["solo"]))[:n]
    out = {}
    for name, shift in (("sound", 0), ("seated one position off", 1)):
        pre = ContinuousBatcher(f32, trained["params"], max_batch=4,
                                kv_page_tokens=page_tokens, prefill_only=True)
        dec = ContinuousBatcher(f32, trained["params"], max_batch=4,
                                kv_page_tokens=page_tokens)
        if shift:
            seat = dec._seat_pages_device
            dec._seat_pages_device = (lambda slot, rows, ids, kv, counter:
                                      seat(slot, rows, ids, kv, counter + shift))
        order = {pre.submit(np.asarray(p), budget): k
                 for k, ((p, budget), _) in enumerate(reqs)}
        adopted = {}
        while len(adopted) < len(reqs):
            pre.step()
            for brid, session in pre.take_sessions():
                adopted[dec.adopt_session(session)] = order[brid]
        results = dec.run()
        out[name] = sum([int(t) for t in results[d]] == reqs[k][1]
                        for d, k in adopted.items())
        del pre, dec
    return out


def run_disagg_tier(seed: int, card: str, wd: str, trained: dict, tier: dict,
                    device: str = "cuda", worker_env: dict | None = None,
                    timeout: float = 300.0) -> dict:
    """Phase 22, tier B (:data:`DISAGG_TIER`): ``ServingCluster.run(disagg=
    {"prefill": 1, "decode": 1})``, paged KV, both replicas captured, phase
    21's first requests from 4 clients: every stream equal to solo greedy,
    one handoff a request, the decode replica with 0 prefill dispatches and
    a session adopted a request (no prompt position computed again), no
    kernel launch.  The planted fault (a session seated one position off)
    runs in :func:`check_handoff_in_process`, the smallest tier that shows
    it, and must change a stream."""
    from tensorflowonspark_tpu_torch.examples.gpt import online_serving
    from tensorflowonspark_tpu_torch.serving import ServingCluster

    c = DISAGG_TIER
    f32 = serving_config(trained)
    args = {"tier_cfg": f32, "tier_weights": os.path.join(wd, "tier_weights.pt")}
    reqs, want = tier["requests"][:c["requests"]], tier["solo"][:c["requests"]]
    t0 = time.perf_counter()
    serving = ServingCluster.run(
        tier_builder, 2, max_batch=c["slots"], replica_args=args, disagg=dict(c["disagg"]),
        batcher_kwargs={"kv_page_tokens": c["page_tokens"]}, aot_cache=device == "cuda",
        device=device, worker_env=worker_env, working_dir=os.path.join(wd, "disagg_tier"),
        reservation_timeout=timeout, client_timeout=timeout)
    try:
        boot = time.perf_counter() - t0
        t1 = time.perf_counter()
        threads, out = stream_clients(serving.address, serving.authkey,
                                      [(i, *reqs[i]) for i in range(len(reqs))],
                                      c["clients"], timeout)
        for t in threads:
            t.join(timeout)
        wall = time.perf_counter() - t1
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            nodes = serving.metrics()["nodes"]
            if online_serving.counter(nodes.get(1, {}), "tfos_replica_sessions_total",
                                      direction="adopted") >= len(reqs) \
                    and online_serving.counter(nodes.get(0, {}), "tfos_replica_sessions_total",
                                               direction="exported") >= len(reqs):
                break
            time.sleep(0.2)
        m = serving.metrics()
    finally:
        serving.shutdown(timeout=timeout)
    nodes = m["nodes"]
    cnt = online_serving.counter
    launches, reported = tier_launches(nodes)
    r = {"boot_s": boot, "traffic_s": wall, "equal": sum(
             x["error"] is None and x["tokens"] == want[x["i"]] for x in out), "of": len(reqs),
         "handoffs": m["handoffs"], "roles": {e: rep["role"] for e, rep in m["replicas"].items()},
         "decode_prefill_dispatches": cnt(nodes.get(1, {}),
                                          "tfos_replica_prefill_dispatches_total"),
         "adopted": cnt(nodes.get(1, {}), "tfos_replica_sessions_total", direction="adopted"),
         "exported": cnt(nodes.get(0, {}), "tfos_replica_sessions_total", direction="exported"),
         "aot_errors": sum(cnt(n, "tfos_replica_aot_resolves_total", outcome="error")
                           for n in nodes.values()),
         "launches": launches, "launches_from": reported,
         "ttft": sorted(x["deltas"][0][0] - x["t0"] for x in out if x["deltas"])}
    t0 = time.perf_counter()
    r["in_process"] = check_handoff_in_process(trained, tier, c["page_tokens"], 4)
    r["in_process_s"] = time.perf_counter() - t0
    log(f"disagg tier on {card}: boot {boot:.1f} s; {r['equal']}/{r['of']} streams equal solo "
        f"greedy in {wall:.2f} s of traffic; handoffs {r['handoffs']}, sessions exported "
        f"{r['exported']} / adopted {r['adopted']}, prefill dispatches on the decode replica "
        f"{r['decode_prefill_dispatches']}, roles {r['roles']}, capture errors "
        f"{r['aot_errors']}; TTFT p50 {r['ttft'][len(r['ttft']) // 2]:.4f} s; kernel launches "
        f"{launches} from replicas {reported}; in this process (4 requests, eager): "
        f"{r['in_process']} streams equal solo greedy, {r['in_process_s']:.1f} s")
    ok = (r["equal"] == r["of"] and r["handoffs"] == r["of"] and r["adopted"] == r["of"]
          and r["exported"] == r["of"] and r["decode_prefill_dispatches"] == 0
          and r["aot_errors"] == 0 and not any(launches.values()) and reported == [0, 1]
          and r["in_process"]["sound"] == 4)
    fault_caught = r["in_process"]["seated one position off"] < 4
    log(f"disagg tier gate: {'passed' if ok else 'FAILED'}; planted fault (a session seated "
        f"one position off) {'changed a stream' if fault_caught else 'NOT CAUGHT'}")
    if not ok or not fault_caught:
        raise SystemExit("the disaggregated tier's gate failed")
    return r


def run_rest_of_tier(seed: int, card: str, wd: str, trained: dict, tier: dict,
                     device: str = "cuda", worker_env: dict | None = None) -> dict:
    """Phase 22: tier A (:func:`run_rollout_tier`) then tier B
    (:func:`run_disagg_tier`); the launches of both, summed."""
    a = run_rollout_tier(seed, card, wd, trained, tier, device, worker_env)
    b = run_disagg_tier(seed, card, wd, trained, tier, device, worker_env)
    return {**{k: a["launches"][k] + b["launches"][k] for k in KERNEL_NAMES},
            "rollout": a, "disagg": b}


# -------------------- phase 24: sequence parallelism through the front door

#: phase 24's model: the long-context LM of ``examples/long_context/
#: ring_lm.py`` at full BERT-base width (hidden 768, 12 layers, 12 heads,
#: FFN 3072, BERT's vocabulary) with 4096 positions, bf16 compute on float32
#: parameters, no dropout
LONG_CONTEXT = {"vocab_size": 30522, "hidden_size": 768, "num_layers": 12, "num_heads": 12,
                "intermediate_size": 3072, "max_position_embeddings": 4096,
                "dropout_rate": 0.0, "dtype": "bfloat16"}
#: its run: B 1 x T 4096 over sp = 2 (2048 positions a rank), Adam 1e-4,
#: ``steps`` steps of each sound arm and ``fault_steps`` of each planted fault
LONG_CONTEXT_RUN = {"seq_len": 4096, "batch_size": 1, "sp": 2, "lr": 1e-4, "steps": 4,
                    "fault_steps": 2}
#: the arms one two-worker cluster trains in turn from the same seeded
#: weights and data: (name, sp_impl, planted fault or None, steps key,
#: Ulysses' inner attention: "kernel" (K1-K3) or "plain" (their plain
#: versions))
LONG_CONTEXT_ARMS = (("ulysses", "ulysses", None, "steps", "kernel"),
                     ("ring", "ring", None, "steps", "kernel"),
                     ("swapped_heads", "ulysses", "swapped_heads", "fault_steps", "kernel"),
                     ("local_positions", "ring", "local_positions", "fault_steps", "kernel"),
                     ("no_sp_grad_sum", "ulysses", "no_sp_grad_sum", "fault_steps", "kernel"))
#: ``--calibrate-long-context`` reads these as well: Ulysses over the
#: kernels' plain versions, sound and with its two faults
LONG_CONTEXT_CALIBRATION_ARMS = LONG_CONTEXT_ARMS + (
    ("ulysses_plain", "ulysses", None, "steps", "plain"),
    ("swapped_heads_plain", "ulysses", "swapped_heads", "fault_steps", "plain"),
    ("no_sp_grad_sum_plain", "ulysses", "no_sp_grad_sum", "fault_steps", "plain"))
#: the gate, against the unsharded oracle on the card (plain causal
#: attention over the whole sequence, same weights, data and Adam): each
#: step's |loss diff|; ||w - w_oracle|| / ||w_oracle - w0|| over the
#: parameters the oracle moved (max and median) but the key biases, whose
#: gradient is zero in theory (a shift of every key by one vector moves no
#: softmax) and held, as in phase 6, to Adam's noise bound in units of lr
#: x steps; the parameters the oracle did not move (``type_emb``: no token
#: types) must not move.  Set from ``--calibrate-long-context`` at seeds
#: 0-2: the sound arms (Ulysses over K1-K3 or their plain versions, the
#: ring) read up to 2.6e-4 / 0.098 / 0.049 / 1.13, about half of each
#: limit; the planted faults read at least 0.96 (max) and 0.21 (median;
#: the ring masking by local positions, whose losses alone stay within
#: 6.5e-4), and the other two 0.83 (PERF.md, "Gate calibration").  Both
#: ranks' parameters must also be the same (:func:`replica_drift` 0): at
#: seeds 0-2 every sound arm and the two attention faults read 0, the
#: skipped ``sp`` sum 1.99-2
LONG_CONTEXT_TOL = {"loss": 1e-3, "max": 0.2, "median": 0.1, "noise": 2.03}


def long_context_batches(seed: int, run: dict, vocab: int) -> list:
    from tensorflowonspark_tpu_torch.examples.long_context import ring_lm

    return ring_lm.make_batches(seed, run["steps"], run["batch_size"], run["seq_len"], vocab)


def long_context_oracle(seed: int, cfg: dict, run: dict, path: str, device: str) -> dict:
    """One process trains the model unsharded (plain causal attention over
    the whole sequence, float32 scores) ``steps`` steps; saves the initial
    state dict (the workers start from it), each step's loss and the
    parameters after ``fault_steps`` and ``steps`` to ``path``, and frees
    the card before the cluster boots."""
    import functools

    import torch

    from tensorflowonspark_tpu_torch.examples.long_context import ring_lm
    from tensorflowonspark_tpu_torch.parallel.ring_attention import reference_attention
    from tensorflowonspark_tpu_torch.parallel.strategy import adam

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model = ring_lm.build_model(cfg, functools.partial(reference_attention, causal=True),
                                seed=seed)
    w0 = {n: t.clone() for n, t in model.state_dict().items()}
    model = model.to(device)
    opt = adam(run["lr"])(model.parameters())
    loss_fn = ring_lm.lm_loss(None, run["seq_len"])
    losses, snaps = [], {}
    for i, b in enumerate(long_context_batches(seed, run, cfg["vocab_size"])):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, {"ids": torch.as_tensor(b["ids"], device=device)})
        loss.backward()
        opt.step()
        losses.append(loss.item())
        if i + 1 in (run["fault_steps"], run["steps"]):
            snaps[i + 1] = {n: p.detach().float().cpu().clone()
                            for n, p in model.named_parameters()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if device == "cuda" else 0.0
    torch.save({"losses": losses, "w": snaps, "w0": w0}, path)
    del model, opt, loss
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "peak_gib": peak}


def long_context_readings(losses: list, w: dict, oracle: dict, w0: dict, lr: float) -> dict:
    """An arm's losses and parameters against the oracle's at the same
    step, as :data:`LONG_CONTEXT_TOL` reads them (all three on one device)."""
    import numpy as np

    want = oracle["losses"][:len(losses)]
    w_or = oracle["w"][len(losses)]
    moved = {n for n, p in w_or.items() if (p - w0[n]).norm().item() > 0}
    zero = {n for n in moved if n.endswith("attn.key.bias")}
    rel = {n: ((w[n] - w_or[n]).norm() / (w_or[n] - w0[n]).norm()).item()
           for n in moved - zero}
    worst = max(rel, key=rel.get)
    return {"loss": max(abs(a - b) for a, b in zip(losses, want)), "max": rel[worst],
            "worst": worst, "median": float(np.median(list(rel.values()))),
            "noise": max(((w[n] - w_or[n]).abs().max().item() for n in zero), default=0.0)
            / (lr * len(losses)),
            "unmoved": max(((w[n] - w0[n]).abs().max().item() for n in w_or
                            if n not in moved), default=0.0)}


def replica_drift(a: dict, b: dict) -> float:
    """The largest relative difference between two ranks' parameter
    digests (each leaf's float64 sum and norm); 0.0 when the replicas hold
    the same model bit for bit, as summed gradients and the same Adam
    steps leave them."""
    if a.keys() != b.keys():
        return float("inf")
    return max((abs(x - y) / max(abs(x), abs(y), 1e-30)
                for n in a for x, y in zip(a[n], b[n]) if x != y), default=0.0)


def within_long_context(r: dict) -> bool:
    return (r["loss"] <= LONG_CONTEXT_TOL["loss"] and r["max"] <= LONG_CONTEXT_TOL["max"]
            and r["median"] <= LONG_CONTEXT_TOL["median"]
            and r["noise"] <= LONG_CONTEXT_TOL["noise"] and r["unmoved"] == 0.0)


def _planted(fault: str | None):
    """A context that plants ``fault`` in this process's port modules (the
    worker's own copies) and takes it out again."""
    import contextlib
    import importlib

    import torch

    # the modules (the package exports functions of the same names)
    ring_attention = importlib.import_module("tensorflowonspark_tpu_torch.parallel.ring_attention")
    ulysses = importlib.import_module("tensorflowonspark_tpu_torch.parallel.ulysses")

    @contextlib.contextmanager
    def plant():
        if fault == "swapped_heads":
            orig = ulysses._seq_to_heads

            def swapped(qkv, group):
                out = orig(qkv, group)
                h = out.shape[3] // 2
                return torch.cat([out[:, :, :, h:], out[:, :, :, :h]], dim=3)
            ulysses._seq_to_heads = swapped
            try:
                yield
            finally:
                ulysses._seq_to_heads = orig
        elif fault == "local_positions":
            orig = ring_attention._global_positions
            ring_attention._global_positions = lambda block, length: torch.arange(length)
            try:
                yield
            finally:
                ring_attention._global_positions = orig
        else:
            yield
    return plant()


def long_context_worker(args, ctx) -> None:
    """Phase 24's map_fun, on each of the two agent-launched workers: join
    the gloo group (two ranks share the one card), build the ``{dp: 1, sp:
    2}`` mesh, train every arm of :data:`LONG_CONTEXT_ARMS` from the same
    weights and data, and write the results into the working dir (the
    chief also its readings against the oracle, the Ulysses arm's losses
    through ``SummaryWriter`` into the TensorBoard logdir, and its second
    step under ``ctx.profile_trace()``)."""
    import contextlib
    import functools
    import json
    import time

    import torch

    from tensorflowonspark_tpu_torch.examples.long_context import ring_lm
    from tensorflowonspark_tpu_torch.observability import SummaryWriter
    from tensorflowonspark_tpu_torch.ops.flash_attention import (flash_attention,
                                                                 flash_attention_bwd,
                                                                 flash_attention_plain)
    from tensorflowonspark_tpu_torch.parallel import MeshStrategy, comm, make_mesh
    from tensorflowonspark_tpu_torch.parallel.strategy import adam

    if args["device"] == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("this worker sees no card: it does not train on the CPU")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    # NCCL takes one rank a device: the two ranks that share one card join
    # a gloo group, by the caller's choice; the arithmetic stays on the card
    ctx.initialize_distributed(device, backend="gloo")
    cfg, run = args["cfg"], args["run"]
    out = {"rank": ctx.executor_id, "arms": {}}
    try:
        mesh = make_mesh(dp=1, sp=run["sp"], device_type=device.type)
        t0 = time.perf_counter()
        oracle = torch.load(args["oracle"], mmap=True)
        w0 = oracle["w0"]                          # the oracle's initial state dict
        if ctx.is_chief:                           # its readings run on the card
            oracle = {"losses": oracle["losses"],
                      "w": {k: {n: p.to(device) for n, p in ws.items()}
                            for k, ws in oracle["w"].items()}}
            w0_dev = {n: p.to(device) for n, p in w0.items()}
        out["load_s"] = time.perf_counter() - t0
        batches = long_context_batches(args["seed"], run, cfg["vocab_size"])

        class NoSpGradSum(MeshStrategy):
            grad_axes = ("dp", "fsdp")

        for name, impl, fault, steps_key, inner in args["arms"]:
            n = run[steps_key]
            with _planted(fault):
                t_setup = time.perf_counter()
                strategy = (NoSpGradSum if fault == "no_sp_grad_sum" else MeshStrategy)(
                    mesh=mesh, device=device)
                t_strategy = time.perf_counter()
                attention = ring_lm.attention_fn(mesh, impl)
                if inner == "plain":
                    attention = functools.partial(attention, attn_fn=flash_attention_plain)
                model = ring_lm.build_model(cfg, attention,
                                            {k: v.clone() for k, v in w0.items()})
                t_model = time.perf_counter()
                state = strategy.init_state(model, adam(run["lr"]))
                step = strategy.build_train_step(ring_lm.lm_loss(strategy, run["seq_len"]))
                zero_launch_counts()
                losses = []
                t0 = time.perf_counter()
                for i, b in enumerate(batches[:n]):
                    traced = name == "ulysses" and i == 1 and ctx.is_chief
                    with ctx.profile_trace() if traced else contextlib.nullcontext():
                        state, metrics = step(state, strategy.shard_batch(b))
                        losses.append(float(metrics["loss"]))
                seconds = time.perf_counter() - t0
                arm = {"losses": losses, "seconds": seconds, "steps": n,
                       "setup_s": t0 - t_setup,
                       "setup_split": {"strategy": t_strategy - t_setup,
                                       "model": t_model - t_strategy,
                                       "state": t0 - t_model},
                       "launches": {"flash_attention_fwd": flash_attention.launches,
                                    "flash_attention_dq": flash_attention_bwd.launches_dq,
                                    "flash_attention_dkv": flash_attention_bwd.launches_dkv}}
                if device.type == "cuda":
                    arm["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
                    torch.cuda.reset_peak_memory_stats(device)
                # each replica's parameters, leaf by leaf: the ranks must hold
                # the same model after the broadcast, the summed gradients
                # and their own Adam steps
                arm["digest"] = {k: [p.detach().double().sum().item(),
                                     p.detach().double().norm().item()]
                                 for k, p in state.module.named_parameters()}
                if ctx.is_chief:
                    w = {k: p.detach().float() for k, p in state.module.named_parameters()}
                    arm["readings"] = long_context_readings(losses, w, oracle, w0_dev,
                                                            run["lr"])
                    if name == "ulysses":
                        with SummaryWriter(ctx.tensorboard_logdir) as sw:
                            for i, v in enumerate(losses):
                                sw.scalar("train/loss", v, i + 1)
                out["arms"][name] = arm
                del state, model, step
                if device.type == "cuda":
                    torch.cuda.empty_cache()
        out["host_staged"] = dict(comm.HOST_STAGED)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(ctx.working_dir, f"long_context.{ctx.executor_id}.json"), "w") as f:
        json.dump(out, f)


def run_long_context(seed: int, card: str, wd: str, cfg: dict | None = None,
                     run: dict | None = None, device: str = "cuda", gate: bool = True,
                     arms=LONG_CONTEXT_ARMS) -> dict:
    """Phase 24: the oracle in this process, then one ``HostAgent`` on
    localhost with a random authkey (its workers forked from this process's
    fork server, which never touches CUDA) and, in the reference's call
    shape, ``TFCluster.run(None, map_fun, args, 2, 0, True,
    InputMode.TENSORFLOW, logdir, backend=AgentBackend(...))``: two workers
    train every arm of :data:`LONG_CONTEXT_ARMS`.  Gated (with
    ``gate``): the sound arms within :data:`LONG_CONTEXT_TOL` of the
    oracle with both ranks' parameters the same (:func:`replica_drift`
    0), each planted fault outside on either count, K1-K3 12 times a step
    on each rank in the Ulysses arm, the event file's scalars equal to its losses and
    the profiled step's trace naming K1.  Returns the launches and the
    stages' seconds."""
    import json
    import secrets

    from tensorflowonspark_tpu_torch import TFCluster
    from tensorflowonspark_tpu_torch.agent import AgentBackend, HostAgent
    from tensorflowonspark_tpu_torch.cluster import InputMode
    from tensorflowonspark_tpu_torch.observability import (_trace_files, read_scalars,
                                                          trace_kernel_names)

    cfg = cfg or LONG_CONTEXT
    run = {**LONG_CONTEXT_RUN, **(run or {})}
    lwd = os.path.join(wd, f"long_context_{seed}")
    os.makedirs(lwd, exist_ok=True)
    stage = {}
    t0 = time.perf_counter()
    oracle_path = os.path.join(lwd, "oracle.pt")
    oracle = long_context_oracle(seed, cfg, run, oracle_path, device)
    stage["oracle"] = time.perf_counter() - t0
    log(f"phase 24 oracle (plain causal attention, T {run['seq_len']}, one process): losses "
        f"{[round(x, 5) for x in oracle['losses']]}, peak {oracle['peak_gib']:.1f} GiB, "
        f"{stage['oracle']:.1f} s")
    t0 = time.perf_counter()
    key = secrets.token_bytes(16)
    agent = HostAgent(port=0, authkey=key, bind_host="127.0.0.1",
                      log_dir=os.path.join(lwd, "agent_logs"))
    addr = agent.start()
    stage["agent start"] = time.perf_counter() - t0
    logdir = os.path.join(lwd, "tensorboard")
    args = {"seed": seed, "cfg": cfg, "run": run, "oracle": oracle_path, "device": device,
            "arms": arms}
    worker_env = ({"OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""} if device == "cpu"
                  else {})
    try:
        log("phase 24: the two sp ranks share the one card, so they join a gloo group "
            "(NCCL takes one rank a device); K1-K3, the GEMMs and the loss run on the card")
        t0 = time.perf_counter()
        cluster = TFCluster.run(None, long_context_worker, args, 2, 0, True,
                                InputMode.TENSORFLOW, logdir, reservation_timeout=300,
                                backend=AgentBackend([addr], authkey=key, worker_env=worker_env),
                                working_dir=lwd)
        stage["boot"] = time.perf_counter() - t0
        url = cluster.tensorboard_url()
        log(f"phase 24: cluster.tensorboard_url() = {url!r}"
            + (" (no tensorboard package on this machine)" if url is None else ""))
        t0 = time.perf_counter()
        cluster.shutdown(timeout=1200)
        stage["train"] = time.perf_counter() - t0
    finally:
        agent.stop()
    ranks = []
    for r in range(2):
        with open(os.path.join(lwd, f"long_context.{r}.json")) as f:
            ranks.append(json.load(f))
    chief = ranks[0]
    stage["workers' oracle load"] = chief["load_s"]
    for name, arm in chief["arms"].items():
        stage[f"arm {name}"] = arm["setup_s"] + arm["seconds"]
    failures = []
    for name, impl, fault, _, inner in arms:
        arm = chief["arms"][name]
        r = arm["readings"]
        drift = replica_drift(arm["digest"], ranks[1]["arms"][name]["digest"])
        ok = within_long_context(r) and drift == 0.0
        log(f"phase 24 seed {seed} {name} ({impl}, {inner}{', fault' if fault else ''}, "
            f"{arm['steps']} steps, {arm['seconds']:.2f} s after {arm['setup_s']:.2f} s of "
            f"setup {({k: round(v, 2) for k, v in arm['setup_split'].items()})}): losses "
            f"{[round(x, 5) for x in arm['losses']]}; |loss diff| {r['loss']:.3g}, max "
            f"{r['max']:.3g} ({r['worst']}), median {r['median']:.3g}, noise "
            f"{r['noise']:.3g}, unmoved {r['unmoved']:.3g}, replica drift {drift:.3g}; peak "
            f"{arm.get('peak_gib', 0):.1f} GiB; launches rank 0 {arm['launches']}, rank 1 "
            f"{ranks[1]['arms'][name]['launches']} -> {'within' if ok else 'OUTSIDE'} "
            f"{LONG_CONTEXT_TOL}")
        if ok == bool(fault):
            failures.append(f"{name} {'passed' if fault else 'failed'} the gate")
    for rank in ranks:
        log(f"phase 24 rank {rank['rank']}: collectives copied to the host (gloo takes no "
            f"send/recv on CUDA tensors): {rank['host_staged']}")
    launches = {k: sum(rank["arms"]["ulysses"]["launches"][k] for rank in ranks)
                for k in KERNEL_NAMES}
    if device == "cuda":
        steps = chief["arms"]["ulysses"]["steps"]
        per_rank = [rank["arms"]["ulysses"]["launches"] for rank in ranks]
        if any(v != 12 * steps for lr in per_rank for v in lr.values()):
            failures.append(f"the Ulysses arm's launches a rank are {per_rank}, not 12 a step")
        scalars = [v for path in sorted(os.listdir(logdir)) if "tfevents" in path
                   for _, _, tag, v in read_scalars(os.path.join(logdir, path))
                   if tag == "train/loss"]
        if [round(v, 6) for v in scalars] != [round(v, 6) for v in
                                             chief["arms"]["ulysses"]["losses"]]:
            failures.append(f"the event file's losses {scalars} are not the arm's")
        traces = _trace_files(logdir)
        k1 = sorted({n for t in traces for n in trace_kernel_names(t)
                     if "flash_fwd" in n})
        log(f"phase 24: {len(traces)} trace(s) of the profiled step; K1 in it: {k1}")
        if not traces or not any("flash_fwd_tma_kernel" in n for n in k1):
            failures.append("the profiled step's trace does not name K1")
    log("phase 24 seconds: " + "; ".join(f"{k} {v:.1f}" for k, v in stage.items()))
    if gate and failures:
        raise SystemExit("phase 24: " + "; ".join(failures))
    if failures:
        log("phase 24 (not gated): " + "; ".join(failures))
    return {"launches": launches, "stages": stage, "arms": chief["arms"]}


# ------------------------- phase 25: pipeline and expert parallelism

#: phase 25's pipeline model: phase 13's GPT-124M-class widths (vocab 32000,
#: hidden 768, 12 layers of 12 heads, FFN 3072, 1024 positions), bf16 on
#: float32 parameters, no dropout, the flash kernels causal; its 12 blocks
#: cut into ``pp`` stages; B 8 x T 1024 in ``microbatches`` of 2, Adam at
#: phase 13's rate, ``steps`` steps of each arm, sound or planted fault
PIPELINE = {"pp": 2, "microbatches": 4, "lr": GPT_LR, "steps": 2}
#: the pipeline arms, trained in turn from the same seeded weights and data:
#: (name, schedule, planted fault or None)
PIPELINE_ARMS = (("gpipe", "gpipe", None), ("1f1b", "1f1b", None),
                 ("pp_grad_sum", "gpipe", "pp_grad_sum"),
                 ("no_backward_hop", "1f1b", "no_backward_hop"))
#: the MoE arm: ``examples/moe/switch_lm.py`` at the published widths of
#: Switch-Base-8 (Fedus et al. 2021, ``google/switch-base-8``: d_model 768,
#: d_ff 3072, 8 experts, top-1, capacity factor 1.25, vocab 32128) at the
#: example's depth (one attention sublayer of its 4 heads, one MoE FFN, the
#: embedding tied as the head), float32 as the example; T 512, B 16 (8 a
#: rank) over ``ep`` 2 (4 experts a rank), Adam 1e-4
SWITCH_BASE_8 = {"vocab": 32128, "hidden": 768, "num_experts": 8, "top_k": 1,
                 "capacity_factor": 1.25, "ep": 2, "seq_len": 512, "batch_size": 16,
                 "aux_weight": 0.01, "lr": 1e-4, "steps": 3, "fault_steps": 2}
MOE_ARMS = (("moe", None), ("wrong_shard", "wrong_shard"))
#: the gates against the unpipelined (unsharded) oracle in this process:
#: each step's |loss diff| and, over the parameters the oracle moved, ||w -
#: w_oracle|| / ||w_oracle - w0|| (max, median, and max over the replicated
#: parameters), the key biases (zero in theory) in units of lr x steps
#: (Adam's bound); the parameters the oracle did not move must not move.
#: Set from ``--calibrate-parallel`` at seeds 0-2 (PERF.md, "Gate
#: calibration"): the sound pipeline arms read up to 7.5e-5 / 0.139 / 0.070
#: / 0.085 / 1.86 (bf16 kernels against the float32 plain attention); the
#: replicated gradients summed over pp read at least 2.6e-4 / 0.258 (the
#: tied table) / - / 0.258, the dropped backward hop 6.3e-4 / 1 / 0.42 / 1.
#: The MoE reads up to 9.5e-7 / 8.1e-6 / 5.1e-7 (float32, the sums in
#: another order), its return exchange sent to the wrong shard at least
#: 5.8e-5 / 1.08 / 0.395
PIPELINE_TOL = {"loss": 1.5e-4, "max": 0.2, "median": 0.1, "replicated": 0.15, "noise": 2.03}
MOE_TOL = {"loss": 1e-5, "max": 1e-3, "median": 1e-4}


def pipeline_batches(seed: int, steps: int, width: dict) -> list:
    """The first ``steps`` batches of gpt_tiny's "+1" corpus at ``width``
    (``{"ids": [B, T] int32}``), as the oracle and the workers draw them."""
    import itertools

    from tensorflowonspark_tpu_torch.examples.gpt import gpt_tiny

    return list(itertools.islice(gpt_tiny.corpus(argparse.Namespace(**width, seed=seed))(),
                                 steps))


def pipelined_gpt(cfg, sd: dict, pp: int):
    """A stage-stacked GPT over ``sd`` (a ``GPT`` state dict): ``tok_emb``,
    ``pos_emb`` and ``ln_f`` replicated, and ``stages``, ``num_layers / pp``
    DecoderBlock-shaped modules whose parameters stack the stages' blocks
    (stage ``s`` runs layers ``s * per .. (s + 1) * per - 1``)."""
    import dataclasses

    import torch
    from torch import nn

    from tensorflowonspark_tpu_torch.models.gpt import GPT, DecoderBlock

    per = cfg.num_layers // pp
    with torch.device("meta"):
        model = GPT(dataclasses.replace(cfg, num_layers=0))
        blocks = nn.ModuleList(DecoderBlock(cfg) for _ in range(per))
    model.load_state_dict({k: v for k, v in sd.items() if not k.startswith("layers.")},
                          assign=True)
    for i, block in enumerate(blocks):
        for name, _ in list(block.named_parameters()):
            owner, _, attr = name.rpartition(".")
            stacked = torch.stack([sd[f"layers.{s * per + i}.{name}"] for s in range(pp)])
            setattr(block.get_submodule(owner), attr, nn.Parameter(stacked))
    model.stages = blocks
    return model


def gpt_stage_fn(cfg, per: int):
    """``stage_fn(params, x)``: ``per`` decoder blocks through
    ``torch.func.functional_call`` over one stage's parameters (names
    ``"<block>.<parameter>"``)."""
    import torch

    from tensorflowonspark_tpu_torch.models.gpt import DecoderBlock

    with torch.device("meta"):
        template = DecoderBlock(cfg)

    def stage_fn(params, x):
        blocks = [{} for _ in range(per)]
        for name, p in params.items():
            i, _, rest = name.partition(".")
            blocks[int(i)][rest] = p
        for block in blocks:
            x = torch.func.functional_call(template, block, (x,))
        return x

    return stage_fn


def oracle_layer_name(name: str, stage: int, per: int) -> str:
    """A pipelined model's parameter name in the GPT's state dict."""
    if not name.startswith("stages."):
        return name
    _, i, rest = name.split(".", 2)
    return f"layers.{stage * per + int(i)}.{rest}"


def parallel_oracles(seed: int, gpt_cfg, width: dict, moe: dict, path: str,
                     device: str) -> dict:
    """The unsharded runs in this process, saved to ``path`` for the
    workers: the GPT unpipelined (gpt_tiny's model over phase 13's plain
    attention, the batches of :func:`pipeline_batches`, Adam) for
    ``steps``, and the Switch LM with every expert local, each step's loss
    the mean over the two ranks' blocks of rows, each block routed on its
    own (``tests/test_moe.py``'s construction)."""
    import torch

    from tensorflowonspark_tpu_torch.examples.moe import switch_lm
    from tensorflowonspark_tpu_torch.ops import flash_attention_plain
    from tensorflowonspark_tpu_torch.parallel.strategy import adam

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ids = [torch.as_tensor(b["ids"], device=device).long()
           for b in pipeline_batches(seed, PIPELINE["steps"], width)]
    gpt = gpt_replay(gpt_cfg, ids, seed, flash_attention_plain, torch.device(device),
                     PIPELINE["lr"])
    out = {"gpt": {"losses": gpt["losses"],
                   "w": {n: t.float().cpu() for n, t in gpt["w"].items()}}}
    del gpt
    gpt_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    args = argparse.Namespace(**{**moe, "ep": 1})
    model = switch_lm.build_model(args, seed=seed).to(device)
    w0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = adam(moe["lr"])(model.parameters())
    loss_fn = switch_lm.lm_loss(moe["aux_weight"])
    losses = []
    for b in switch_lm.make_batches(seed, moe["steps"], moe["batch_size"], moe["seq_len"],
                                    moe["vocab"]):
        ids = torch.as_tensor(b["ids"], device=device)
        opt.zero_grad(set_to_none=True)
        loss = sum(loss_fn(model, {"ids": block}) for block in ids.chunk(moe["ep"])) / moe["ep"]
        loss.backward()
        opt.step()
        losses.append(loss.item())
    out["moe"] = {"losses": losses, "w0": {n: t.cpu() for n, t in w0.items()},
                  "w": {n: p.detach().cpu() for n, p in model.named_parameters()}}
    del model, opt, w0
    torch.save(out, path)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if device == "cuda" else 0.0
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"gpt_losses": out["gpt"]["losses"], "moe_losses": losses, "gpt_s": gpt_s,
            "moe_s": time.perf_counter() - t0, "peak_gib": peak}


def rank_readings(w: dict, w_or: dict, w0: dict) -> dict:
    """This rank's parameters ``w`` against the oracle's ``w_or`` (both
    from ``w0``, by the oracle's names): each moved parameter's relative
    distance, the zero-in-theory key biases' largest step apart, and the
    largest move of a parameter the oracle left alone."""
    moved = {n for n in w if (w_or[n] - w0[n]).norm().item() > 0}
    zero = {n for n in moved if n.endswith("attn.key.bias")}
    return {"rel": {n: ((w[n] - w_or[n]).norm() / (w_or[n] - w0[n]).norm()).item()
                    for n in moved - zero},
            "zero": max(((w[n] - w_or[n]).abs().max().item() for n in zero), default=0.0),
            "unmoved": max(((w[n] - w0[n]).abs().max().item() for n in w if n not in moved),
                           default=0.0)}


def merge_readings(ranks: list, losses: list, oracle_losses: list, lr_steps: float,
                   replicated) -> dict:
    """The ranks' :func:`rank_readings` as one gate reading; ``replicated``
    also the largest over the parameters ``replicated(name)`` names."""
    import numpy as np

    rel = {}
    for r in ranks:
        rel.update(r["rel"])
    worst = max(rel, key=rel.get)
    return {"loss": max(abs(a - b) for a, b in zip(losses, oracle_losses)),
            "max": rel[worst], "worst": worst, "median": float(np.median(list(rel.values()))),
            "replicated": max(v for n, v in rel.items() if replicated(n)),
            "noise": max(r["zero"] for r in ranks) / lr_steps,
            "unmoved": max(r["unmoved"] for r in ranks)}


def _planted_parallel(fault: str | None):
    """A context that plants a pipeline or MoE fault in this process's port
    modules and takes it out again."""
    import contextlib
    import importlib

    import torch

    pipeline = importlib.import_module("tensorflowonspark_tpu_torch.parallel.pipeline")
    moe = importlib.import_module("tensorflowonspark_tpu_torch.parallel.moe")
    from tensorflowonspark_tpu_torch.parallel import comm

    @contextlib.contextmanager
    def plant():
        if fault == "no_backward_hop":
            orig = pipeline._hop

            def forward_only(x, group, offset):
                return orig(x, group, offset) if offset > 0 else torch.zeros_like(x)
            pipeline._hop = forward_only
            try:
                yield
            finally:
                pipeline._hop = orig
        elif fault == "wrong_shard":
            orig = moe._from_experts

            def wrong(x, group):           # each rank's outputs go one shard over
                return comm.all_to_all_exchange(x.roll(1, dims=0), group, 0, 0)
            moe._from_experts = wrong
            try:
                yield
            finally:
                moe._from_experts = orig
        else:
            yield
    return plant()


def _digest(params: dict) -> dict:
    return {n: [p.detach().double().sum().item(), p.detach().double().norm().item()]
            for n, p in params.items()}


def _kernel_launches() -> dict:
    from tensorflowonspark_tpu_torch.ops.flash_attention import (flash_attention,
                                                                 flash_attention_bwd)

    return {"flash_attention_fwd": flash_attention.launches,
            "flash_attention_dq": flash_attention_bwd.launches_dq,
            "flash_attention_dkv": flash_attention_bwd.launches_dkv}


def _pipeline_arm(args, device, w0: dict, oracle: dict, schedule: str, fault) -> dict:
    """One pipeline arm on this rank: the stage-stacked GPT from ``w0``,
    ``steps`` GPipe steps through ``PipelineStrategy.build_train_step`` or
    1F1B steps through ``pipeline_value_and_grad`` (its ``dx``
    backpropagated into the embedding), and this rank's readings."""
    import torch
    import torch.nn.functional as F

    from tensorflowonspark_tpu_torch.parallel import PipelineStrategy, comm
    from tensorflowonspark_tpu_torch.parallel.pipeline import (_broadcast_from, _coalesced,
                                                               pipeline_value_and_grad)
    from tensorflowonspark_tpu_torch.parallel.strategy import MeshStrategy, adam

    cfg, run, pp = args["gpt_cfg"], args["pipeline"], args["pipeline"]["pp"]
    per = cfg.num_layers // pp
    n = run["steps"]
    batches = pipeline_batches(args["seed"], n, args["width"])

    class SumOverPP(PipelineStrategy):
        """The planted fault: replicated gradients summed over ``pp``."""

        def _reduce_gradients(self, model):
            trained = [p for p in self._replicated if p.requires_grad]
            for p in trained:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            _coalesced([p.grad for p in trained],
                       lambda flat: comm.all_reduce(flat, self._pp_group))
            MeshStrategy._reduce_gradients(self, model)

    with _planted_parallel(fault):
        t_setup = time.perf_counter()
        strat = (SumOverPP if fault == "pp_grad_sum" else PipelineStrategy)(
            gpt_stage_fn(cfg, per), num_stages=pp, num_microbatches=run["microbatches"],
            device=device)
        state = strat.init_state(pipelined_gpt(cfg, {k: v.clone() for k, v in w0.items()}, pp),
                                 adam(run["lr"]))
        model = state.module
        V = cfg.vocab_size

        def embed(ids):
            x = F.embedding(ids, model.tok_emb.weight).to(cfg.dtype)
            return x + model.pos_emb[:ids.shape[1]].to(cfg.dtype)

        def xent(h, table, ids):
            logits = torch.einsum("bth,vh->btv", h.float(), table.float())
            return F.cross_entropy(logits[:, :-1].reshape(-1, V), ids[:, 1:].reshape(-1))

        def gpipe_loss(model, batch):
            h = strat.apply(strat.split(model)[0], embed(batch["ids"]))
            return xent(model.ln_f(h), model.tok_emb.weight, batch["ids"])

        def head_fn(hp, y, ids):
            h = torch.func.functional_call(model.ln_f, {"weight": hp["ln_f.weight"],
                                                        "bias": hp["ln_f.bias"]}, (y,))
            return xent(h, hp["tok_emb.weight"], ids)

        def one_f_one_b(state, batch):
            ids = batch["ids"]
            state.optimizer.zero_grad(set_to_none=True)
            stages, head = strat.split(model)
            x = embed(ids)
            loss, d_stages, d_head, dx = pipeline_value_and_grad(
                strat.mesh, strat.stage_fn, head_fn, stages, head, x.detach(), ids,
                num_microbatches=run["microbatches"])
            x.backward(dx)                          # the embedding's part
            for k, p in stages.items():
                p.grad = d_stages[k]
            for k, p in head.items():
                p.grad = d_head[k] if p.grad is None else p.grad + d_head[k]
            state.optimizer.step()
            return state, {"loss": loss}

        step = strat.build_train_step(gpipe_loss) if schedule == "gpipe" else one_f_one_b
        staged0 = comm.HOST_STAGED["send_recv"]
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
        zero_launch_counts()
        losses, step_s = [], []
        t0 = time.perf_counter()
        for b in batches:
            ids = torch.as_tensor(b["ids"], device=device).long()
            ts = time.perf_counter()
            state, metrics = step(state, {"ids": ids})
            losses.append(float(metrics["loss"]))
            step_s.append(time.perf_counter() - ts)
        seconds = time.perf_counter() - t0
        launches = _kernel_launches()
        hops = comm.HOST_STAGED["send_recv"] - staged0
    stage = strat.mesh.get_local_rank("pp")
    w = {oracle_layer_name(k, stage, per): p.detach().float()[0] if k.startswith("stages.")
         else p.detach().float() for k, p in model.named_parameters()}
    ref = {k: oracle["w"][k].to(device) for k in w}
    w0r = {k: w0[k].to(device) for k in w}
    mb_bytes = (args["width"]["batch_size"] // run["microbatches"]) * args["width"]["seq_len"] \
        * cfg.hidden_size * torch.finfo(cfg.dtype).bits // 8
    ticks = run["microbatches"] + (pp - 1) * (1 if schedule == "gpipe" else 2)
    out = {"losses": losses, "step_s": step_s, "seconds": seconds, "steps": n,
           "setup_s": t0 - t_setup, "launches": launches, "hops": hops,
           "hops_expected": 2 * ticks * n if device.type == "cuda" else 0,
           "hop_bytes_a_step": 2 * ticks * mb_bytes,
           # idle ticks of a stage over all: (S-1)/(M+S-1) GPipe, (2S-2)/(M+2S-2) 1F1B
           "bubble": (ticks - run["microbatches"]) / ticks,
           "digest": _digest({k: p for k, p in model.named_parameters()
                              if not k.startswith("stages.")}),
           "readings": rank_readings(w, ref, w0r)}
    if device.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    del state, model, strat, w, ref, w0r
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _moe_arm(args, device, oracle: dict, fault) -> dict:
    """The Switch LM over the ``{ep: 2}`` mesh on this rank: MeshStrategy
    with the expert rules, each rank its 8 rows of a batch."""
    import torch

    from tensorflowonspark_tpu_torch.examples.moe import switch_lm
    from tensorflowonspark_tpu_torch.parallel import MeshStrategy, comm, make_mesh
    from tensorflowonspark_tpu_torch.parallel.strategy import adam

    moe = args["moe"]
    n = moe["steps"] if fault is None else moe["fault_steps"]
    with _planted_parallel(fault):
        t_setup = time.perf_counter()
        mesh = make_mesh(ep=moe["ep"], dp=1, device_type=device.type)
        strat = MeshStrategy(mesh=mesh, rules=switch_lm.expert_rules(), device=device)
        state = strat.init_state(switch_lm.build_model(argparse.Namespace(**moe), mesh,
                                                       seed=args["seed"]), adam(moe["lr"]))
        step = strat.build_train_step(switch_lm.lm_loss(moe["aux_weight"]))
        staged0 = dict(comm.HOST_STAGED)
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
        losses, step_s = [], []
        t0 = time.perf_counter()
        for b in switch_lm.make_batches(args["seed"], n, moe["batch_size"], moe["seq_len"],
                                        moe["vocab"]):
            rows = strat.shard_batch(switch_lm.rows_block(mesh, b))
            ts = time.perf_counter()
            state, metrics = step(state, rows)
            losses.append(float(metrics["loss"]))
            step_s.append(time.perf_counter() - ts)
        seconds = time.perf_counter() - t0
    ep_rank, experts = mesh.get_local_rank("ep"), moe["num_experts"] // moe["ep"]
    w, ref, w0 = {}, {}, {}
    for k, p in state.module.named_parameters():
        w[k] = p.detach().float()
        cut = slice(ep_rank * experts, (ep_rank + 1) * experts) if k in ("moe.win", "moe.wout") \
            else slice(None)
        ref[k], w0[k] = (oracle[s][k][cut].to(device) for s in ("w", "w0"))
    out = {"losses": losses, "step_s": step_s, "seconds": seconds, "steps": n,
           "setup_s": t0 - t_setup, "experts_here": experts,
           "digest": _digest({k: p for k, p in state.module.named_parameters()
                              if k not in ("moe.win", "moe.wout")}),
           "readings": rank_readings(w, ref, w0)}
    if device.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    del state, strat, w, ref, w0
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def parallel_worker(args, ctx) -> None:
    """Phase 25's map_fun, on each of the two agent-launched workers: join
    the gloo group (both ranks share the one card), train every pipeline
    arm of :data:`PIPELINE_ARMS` over ``pp`` 2 and every MoE arm of
    :data:`MOE_ARMS` over ``ep`` 2, and write the results into the working
    dir."""
    import torch

    from tensorflowonspark_tpu_torch.examples.gpt import gpt_tiny
    from tensorflowonspark_tpu_torch.parallel import comm
    from tensorflowonspark_tpu_torch.util import strict_matmul_precision

    if args["device"] == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("this worker sees no card: it does not train on the CPU")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    strict_matmul_precision()                # float32 products as the oracle's (no TF32)
    ctx.initialize_distributed(device, backend="gloo")
    out = {"rank": ctx.executor_id, "arms": {}}
    try:
        t0 = time.perf_counter()
        oracle = torch.load(args["oracle"], mmap=True)
        w0 = gpt_tiny.build_model(args["gpt_cfg"], args["seed"]).state_dict()
        out["load_s"] = time.perf_counter() - t0
        for name, schedule, fault in PIPELINE_ARMS:
            out["arms"][name] = _pipeline_arm(args, device, w0, oracle["gpt"], schedule, fault)
        del w0
        for name, fault in MOE_ARMS:
            out["arms"][name] = _moe_arm(args, device, oracle["moe"], fault)
        out["host_staged"] = dict(comm.HOST_STAGED)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(ctx.working_dir, f"parallel.{ctx.executor_id}.json"), "w") as f:
        json.dump(out, f)


@contextlib.contextmanager
def host_agent(log_dir: str):
    """One ``HostAgent`` on localhost with a random authkey, for the length
    of the block: ``(address, authkey)``."""
    import secrets

    from tensorflowonspark_tpu_torch.agent import HostAgent

    key = secrets.token_bytes(16)
    agent = HostAgent(port=0, authkey=key, bind_host="127.0.0.1", log_dir=log_dir)
    addr = agent.start()
    try:
        yield addr, key
    finally:
        agent.stop()


def run_parallel_training(seed: int, card: str, wd: str, agent=None, width: dict | None = None,
                          moe: dict | None = None, device: str = "cuda",
                          gate: bool = True) -> dict:
    """Phase 25: the oracles in this process, then one ``HostAgent`` on
    localhost (``agent``'s ``(address, authkey)``, else one started here)
    and ``TFCluster.run(None, parallel_worker, args, 2, 0, False,
    InputMode.TENSORFLOW, backend=AgentBackend(...))``: two workers train
    GPT-124M over ``pp`` 2 (GPipe and 1F1B, two planted faults) and
    Switch-Base-8 over ``ep`` 2 (one planted fault).  Gated (with
    ``gate``): each sound arm within its tolerance of the oracle with both
    ranks' replicated parameters the same bit for bit, each fault outside,
    K1-K3 48 / 24 / 24 times a step on each pipeline rank and a hop a tick
    each way.  Returns the launches and the stages' seconds."""
    from tensorflowonspark_tpu_torch import TFCluster
    from tensorflowonspark_tpu_torch.agent import AgentBackend
    from tensorflowonspark_tpu_torch.cluster import InputMode
    from tensorflowonspark_tpu_torch.examples.gpt import gpt_tiny

    width = {**GPT_WIDTH, **(width or {})}
    moe = {**SWITCH_BASE_8, **(moe or {})}
    gpt_cfg = gpt_tiny.model_config(gpt_args(seed, wd, **width))
    pwd = os.path.join(wd, f"parallel_{seed}")
    os.makedirs(pwd, exist_ok=True)
    stage = {}
    t0 = time.perf_counter()
    oracle_path = os.path.join(pwd, "oracle.pt")
    oracle = parallel_oracles(seed, gpt_cfg, width, moe, oracle_path, device)
    stage["oracles"] = time.perf_counter() - t0
    log(f"phase 25 oracles in one process: GPT unpipelined (plain attention, "
        f"{PIPELINE['steps']} steps) losses {[round(x, 5) for x in oracle['gpt_losses']]} in "
        f"{oracle['gpt_s']:.1f} s; Switch LM, every expert local, losses "
        f"{[round(x, 5) for x in oracle['moe_losses']]} in {oracle['moe_s']:.1f} s; peak "
        f"{oracle['peak_gib']:.1f} GiB")
    args = {"seed": seed, "gpt_cfg": gpt_cfg, "width": width, "pipeline": PIPELINE,
            "moe": moe, "oracle": oracle_path, "device": device}
    worker_env = ({"OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""} if device == "cpu"
                  else {})
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if agent is None:
            agent = stack.enter_context(host_agent(os.path.join(pwd, "agent_logs")))
        cluster = TFCluster.run(None, parallel_worker, args, 2, 0, False,
                                InputMode.TENSORFLOW, reservation_timeout=300,
                                backend=AgentBackend([agent[0]], authkey=agent[1],
                                                     worker_env=worker_env),
                                working_dir=pwd)
        stage["boot"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cluster.shutdown(timeout=1200)
        stage["train"] = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(pwd, f"parallel.{r}.json")) as f:
            ranks.append(json.load(f))
    stage["workers' setup"] = ranks[0]["load_s"]
    failures = []
    per_step = {"flash_attention_fwd": 48, "flash_attention_dq": 24, "flash_attention_dkv": 24}
    for name, schedule, fault in PIPELINE_ARMS:
        arms = [rank["arms"][name] for rank in ranks]
        stage[f"arm {name}"] = arms[0]["setup_s"] + arms[0]["seconds"]
        r = merge_readings([a["readings"] for a in arms], arms[0]["losses"],
                           oracle["gpt_losses"], PIPELINE["lr"] * arms[0]["steps"],
                           lambda n: not n.startswith("layers."))
        drift = replica_drift(arms[0]["digest"], arms[1]["digest"])
        ok = (within(r, PIPELINE_TOL) and r["unmoved"] == 0.0 and drift == 0.0
              and arms[0]["losses"] == arms[1]["losses"])
        want = ({k: v * arms[0]["steps"] for k, v in per_step.items()} if device == "cuda"
                else dict.fromkeys(per_step, 0))
        log(f"phase 25 seed {seed} {name} ({schedule}{', fault' if fault else ''}, pp "
            f"{PIPELINE['pp']}, M {PIPELINE['microbatches']}, bubble {arms[0]['bubble']:.3f}, "
            f"{arms[0]['steps']} steps): losses {[round(x, 5) for x in arms[0]['losses']]}; "
            f"step s rank 0 {[round(x, 3) for x in arms[0]['step_s']]}, rank 1 "
            f"{[round(x, 3) for x in arms[1]['step_s']]} after {arms[0]['setup_s']:.2f} s of "
            f"setup; hops {arms[0]['hops']} a rank ({arms[0]['hop_bytes_a_step'] / 1e6:.2f} MB "
            f"a rank a step); peak {arms[0].get('peak_gib', 0):.1f} / "
            f"{arms[1].get('peak_gib', 0):.1f} GiB; |loss diff| {r['loss']:.3g}, max "
            f"{r['max']:.3g} ({r['worst']}), median {r['median']:.3g}, replicated "
            f"{r['replicated']:.3g}, noise {r['noise']:.3g}, "
            f"unmoved {r['unmoved']:.3g}, replica drift {drift:.3g}; launches rank 0 "
            f"{arms[0]['launches']}, rank 1 {arms[1]['launches']} -> "
            f"{'within' if ok else 'OUTSIDE'} {PIPELINE_TOL}")
        if ok == bool(fault):
            failures.append(f"{name} {'passed' if fault else 'failed'} the gate")
        if fault is None and any(a["launches"] != want for a in arms):
            failures.append(f"{name}: launches {[a['launches'] for a in arms]}, not {want}")
        if fault is None and any(a["hops"] != a["hops_expected"] for a in arms):
            failures.append(f"{name}: {[a['hops'] for a in arms]} hops copied to the host, "
                            f"not {arms[0]['hops_expected']}")
    for name, fault in MOE_ARMS:
        arms = [rank["arms"][name] for rank in ranks]
        stage[f"arm {name}"] = arms[0]["setup_s"] + arms[0]["seconds"]
        r = merge_readings([a["readings"] for a in arms], arms[0]["losses"],
                           oracle["moe_losses"], moe["lr"] * arms[0]["steps"],
                           lambda n: n not in ("moe.win", "moe.wout"))
        drift = replica_drift(arms[0]["digest"], arms[1]["digest"])
        ok = (within(r, MOE_TOL) and r["unmoved"] == 0.0 and drift == 0.0
              and arms[0]["losses"] == arms[1]["losses"])
        log(f"phase 25 seed {seed} {name} (Switch-Base-8 widths, ep {moe['ep']}, "
            f"{arms[0]['experts_here']} experts a rank{', fault' if fault else ''}, "
            f"{arms[0]['steps']} steps): losses {[round(x, 5) for x in arms[0]['losses']]}; "
            f"step s rank 0 {[round(x, 3) for x in arms[0]['step_s']]}, rank 1 "
            f"{[round(x, 3) for x in arms[1]['step_s']]} after {arms[0]['setup_s']:.2f} s of "
            f"setup; peak {arms[0].get('peak_gib', 0):.1f} / {arms[1].get('peak_gib', 0):.1f} "
            f"GiB; |loss diff| {r['loss']:.3g}, max {r['max']:.3g} ({r['worst']}), median "
            f"{r['median']:.3g}, replicated {r['replicated']:.3g}, unmoved {r['unmoved']:.3g}, "
            f"replica drift {drift:.3g} -> "
            f"{'within' if ok else 'OUTSIDE'} {MOE_TOL}")
        if ok == bool(fault):
            failures.append(f"{name} {'passed' if fault else 'failed'} the gate")
    for rank in ranks:
        log(f"phase 25 rank {rank['rank']}: collectives copied to the host (gloo takes no "
            f"send/recv on CUDA tensors): {rank['host_staged']}")
    launches = {k: sum(rank["arms"][name]["launches"][k] for rank in ranks
                       for name, _, fault in PIPELINE_ARMS if fault is None)
                for k in KERNEL_NAMES}
    log("phase 25 seconds: " + "; ".join(f"{k} {v:.1f}" for k, v in stage.items()))
    if gate and failures:
        raise SystemExit("phase 25: " + "; ".join(failures))
    if failures:
        log("phase 25 (not gated): " + "; ".join(failures))
    return {"launches": launches, "stages": stage,
            "arms": {name: ranks[0]["arms"][name] for name in ranks[0]["arms"]}}


# ------------------------------------ phase 26: mesh-sharded serving (slice 16)

#: phase 26: a tp 2 gang of GPT-124M (phase 13's weights, float32) on the
#: card, its two ranks in one gloo world; 4 slots; phase 19's 12 requests
#: with their budgets cut to ``max_new`` tokens (cut for time: a gang's
#: decode step is ~0.1 s on one H100, and the tp oracle decodes each
#: request alone, its 12 prompt lengths all differing; ``--calibrate-
#: sharded`` keeps phase 19's budgets); the gang's collectives time out
#: after ``step_timeout`` s (``serve_gang_step_timeout``), the planted
#: ack-without-step fault's after ``fault_timeout``; the dropped
#: row-parallel sum is ``fault_layer``'s MLP, over ``fault_requests``
#: requests (the near-init model barely feels half of one MLP output: on
#: the card one stream of the first 4 changed); 26b's two gangs serve
#: ``clients`` streams and lose member executor 1 at its ``kill_at_step``-th
#: step, then ``after_heal`` requests follow the heal (a cold replacement
#: gang); a decode step is timed over ``decode_steps`` steps, and each
#: collective at its shapes over ``collective_reps`` calls
SHARDED = {"tp": 2, "slots": 4, "max_new": 16, "step_timeout": 60.0, "fault_timeout": 5.0,
           "fault_requests": 12, "fault_layer": 0, "clients": 2, "kill_at_step": 4,
           "decode_steps": 8, "collective_reps": 20, "after_heal": 4}


def _collective_counter():
    """Patch ``torch.distributed.all_reduce`` / ``all_gather`` in this
    process to count calls and the bytes each copies through the host
    (gloo stages a CUDA tensor's input to the host and its output back):
    returns ``(counts, undo)``."""
    import torch.distributed as dist

    counts = {"calls": 0, "bytes": 0}
    ar, ag = dist.all_reduce, dist.all_gather

    def all_reduce(t, *a, **k):
        counts["calls"] += 1
        counts["bytes"] += 2 * t.numel() * t.element_size()
        return ar(t, *a, **k)

    def all_gather(parts, t, *a, **k):
        counts["calls"] += 1
        counts["bytes"] += (1 + len(parts)) * t.numel() * t.element_size()
        return ag(parts, t, *a, **k)

    dist.all_reduce, dist.all_gather = all_reduce, all_gather

    def undo():
        dist.all_reduce, dist.all_gather = ar, ag
    return counts, undo


def decode_step_readings(b, prompts, steps: int) -> dict:
    """A decode step of ``b`` with every slot decoding: the median ms of
    ``steps`` steps (each ends in the host read of its tokens), and the
    collectives and host-staged bytes a step."""
    for p in prompts:
        b.submit(p, steps + 4)
    while b._pending or b._inflight is not None or b.decode_steps == 0:
        b.step()
    counts, undo = _collective_counter()
    times = []
    try:
        for _ in range(steps):
            t0 = time.perf_counter()
            b.step()
            times.append(time.perf_counter() - t0)
    finally:
        undo()
    b.run()
    return {"ms": statistics.median(times) * 1e3, "rows": len(prompts),
            "collectives": counts["calls"] / steps, "bytes": counts["bytes"] / steps}


def barrier_step_readings(b, barrier, prompts, steps: int) -> dict:
    """A decode step of gang leader ``b`` as the tier's serve loop drives
    it: the step descriptor posted to every member before the step (which
    replays it on its own batcher), the members' acks and token digests
    collected after it.  The median ms of ``steps`` steps with every slot
    decoding (the leader's host clock, post to last ack)."""
    deltas = {}

    def on_token(brid, tok):
        deltas.setdefault(brid, []).append(int(tok))

    barrier.hello()
    for p in prompts:
        b.submit(p, steps + 4, on_token=on_token)
        barrier.mirror({"prompt": p, "max_new_tokens": steps + 4})
    seq = 0

    def step():
        nonlocal seq
        seq += 1
        for brid in barrier.step(b, seq):
            b.result(brid, pop=True)
        barrier.collect(seq, 0, dict(deltas))
        deltas.clear()

    while b._pending or b._inflight is not None or b.decode_steps == 0:
        step()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step()
        times.append(time.perf_counter() - t0)
    return {"ms": statistics.median(times) * 1e3, "rows": len(prompts)}


def collective_readings(tp, device, rows: int, hidden: int, vocab: int, reps: int) -> dict:
    """The median ms of one gang collective at a decode step's shapes: the
    all-reduce of ``[rows, 1, hidden]`` float32 (the lookup's and each
    row-parallel sum) and the all-gather of this rank's ``[rows, 1, vocab /
    tp]`` logits, each over ``reps`` calls ended by a device sync.  Three
    ways: gloo on the card's tensors (the path the model takes: gloo stages
    them through host memory), the same staged by hand (a copy down, gloo on
    the host tensor, a copy up), and gloo on host tensors alone."""
    import torch
    import torch.distributed as dist

    def reduce(x):
        dist.all_reduce(x, group=tp.group)

    def gather(x):
        dist.all_gather([torch.empty_like(x) for _ in range(tp.size)], x, group=tp.group)

    def staged(fn):
        def run(x):
            h = x.cpu()
            fn(h)
            x.copy_(h)
        return run

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = {}
    for name, fn, width in (("all_reduce", reduce, hidden), ("all_gather", gather,
                                                              vocab // tp.size)):
        for way, dev, call in (("card", device, fn), ("staged", device, staged(fn)),
                               ("host", torch.device("cpu"), fn)):
            x = torch.ones((rows, 1, width), device=dev)
            times = []
            for _ in range(reps + 2):
                sync()
                t0 = time.perf_counter()
                call(x)
                sync()
                times.append(time.perf_counter() - t0)
            out[f"{name} {way}"] = statistics.median(times[2:]) * 1e3
    return out


def _dropped_row_sum(layer):
    """Phase 26's planted fault on one rank: ``layer``'s row-parallel
    product still joins its all-reduce (the ranks stay in step) but keeps
    this rank's partial sum."""
    from tensorflowonspark_tpu_torch.models import gpt
    from tensorflowonspark_tpu_torch.parallel import comm

    import torch.nn.functional as F

    row = gpt._row

    def planted(lin, x, dtype, tp):
        if lin is not layer:
            return row(lin, x, dtype, tp)
        y = F.linear(x.to(dtype), gpt._weight(lin, dtype))
        comm.reduce_from_group(y, tp.group)
        return y + lin.bias.to(dtype)
    return planted, row


def sharded_serving_worker(args, ctx) -> None:
    """Phase 26a's map_fun, on each of the two agent-launched ranks: join
    the gang's gloo world (``serving.sharded.build_gang_mesh``, both ranks
    on the one card), cut phase 13's weights into this rank's tp shards
    (``default_shard_params``; int8 through ``shard_quantized``), compute
    the tp ``greedy_generate`` oracle of every request, serve the schedule
    through the batcher under each regime, time a decode step, then the two
    planted faults, and write the results into the working dir."""
    import dataclasses
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.bert_train import kernel_launches
    from tensorflowonspark_tpu_torch.models import gpt
    from tensorflowonspark_tpu_torch.models.serving import ContinuousBatcher, DraftModel
    from tensorflowonspark_tpu_torch.ops import quantize_params
    from tensorflowonspark_tpu_torch.parallel.mesh import axis_group
    from tensorflowonspark_tpu_torch.serving.replica import on_device
    from tensorflowonspark_tpu_torch.serving.sharded import (GangBarrier, GangShardLost,
                                                             GangSpec, _member_loop,
                                                             build_gang_mesh,
                                                             default_shard_params)
    from tensorflowonspark_tpu_torch.util import strict_matmul_precision

    c = SHARDED
    if args["device"] == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("this worker sees no card: it does not serve on the CPU")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    strict_matmul_precision()
    rank = ctx.executor_id
    out = {"rank": rank, "regimes": {}}
    t0 = time.perf_counter()
    mesh = build_gang_mesh(GangSpec({"tp": c["tp"]}), ctx, device_type=device.type,
                           step_timeout=c["step_timeout"])
    tp = gpt.TensorParallel(axis_group(mesh, "tp"))
    out["world_s"] = time.perf_counter() - t0
    cfg = args["cfg"]
    whole = torch.load(args["weights"], map_location="cpu", weights_only=True)

    def shard(c_, p):
        return on_device(default_shard_params(c_, p, mesh), device)

    params = {"float32": shard(cfg, whole), "int8": shard(cfg, quantize_params(whole))}
    dcfg = dataclasses.replace(cfg, num_layers=SERVE_DRAFT_LAYERS)
    draft = shard(dcfg, {n: t for n, t in whole.items() if not n.startswith("layers.")
                         or int(n.split(".")[1]) < SERVE_DRAFT_LAYERS})
    out["shard_shapes"] = {n: list(v.shape) for n, v in params["float32"].items()
                           if n.startswith(("tok_emb", "layers.0."))}
    out["setup_s"] = time.perf_counter() - t0
    sched = [(at, np.asarray(p, np.int64), n) for at, p, n in args["schedule"]]
    t0 = time.perf_counter()
    oracle = {k: [gpt.greedy_generate(cfg, v, p[None, :], n, tp=tp)[0, len(p):].cpu().numpy()
                  for _, p, n in sched] for k, v in params.items()}
    out["oracle"] = {k: [s.tolist() for s in v] for k, v in oracle.items()}
    out["oracle_s"] = time.perf_counter() - t0
    regimes = {"plain": ("float32", {}), "paged": ("float32", {"kv_page_tokens": SERVE_PAGE}),
               "draft": ("float32", {"speculative_k": SERVE_SPEC_K}), "int8": ("int8", {})}
    for name, (kind, kw) in regimes.items():
        t0 = time.perf_counter()
        b = ContinuousBatcher(cfg, params[kind], max_batch=c["slots"], tp=tp, **kw)
        if name == "draft":
            b.set_draft(DraftModel(dcfg, draft, window=SERVE_DRAFT_WINDOW, tp=tp))
        streams = drive_batcher(b, sched)
        out["regimes"][name] = {
            "streams": [s.tolist() for s in streams], "seconds": time.perf_counter() - t0,
            "equal_tp_oracle": sum(np.array_equal(s, w) for s, w in zip(streams, oracle[kind])),
            "prefix": b.prefix_stats(), "spec": [b.spec_accepted, b.spec_proposed],
            "draft_dispatches": b.draft_dispatches,
            "dispatches": [b.prefill_dispatches, b.decode_dispatches, b.decode_steps]}
    rows = [p for _, p, _ in sched[:c["slots"]]]
    out["step"] = decode_step_readings(
        ContinuousBatcher(cfg, params["float32"], max_batch=c["slots"], tp=tp), rows,
        c["decode_steps"])
    # the same step behind the gang's barrier, as the tier serves it
    member = next(x for x in ctx.cluster_info if x["executor_id"] == 1)
    b = ContinuousBatcher(cfg, params["float32"], max_batch=c["slots"], tp=tp)
    if rank == 1:
        _member_loop(args, ctx, 0, 1, b)
    else:
        barrier = GangBarrier([member], boot_timeout=60.0, step_timeout=c["step_timeout"])
        try:
            out["barrier_step"] = barrier_step_readings(b, barrier, rows, c["decode_steps"])
        finally:
            barrier.stop()
    out["collectives"] = collective_readings(tp, device, c["slots"], cfg.hidden_size,
                                             cfg.vocab_size, c["collective_reps"])
    out["launches"] = kernel_launches()
    # planted fault 1: one layer's row-parallel sum dropped on rank 1
    n = c["fault_requests"]
    b = ContinuousBatcher(cfg, params["float32"], max_batch=c["slots"], tp=tp)
    if rank == 1:
        gpt._row, row = _dropped_row_sum(b.model.layers[c["fault_layer"]].mlp_down)
    try:
        streams = drive_batcher(b, sched[:n])
    finally:
        if rank == 1:
            gpt._row = row
    out["dropped_row_sum"] = {
        "equal_tp_oracle": sum(np.array_equal(s, w) for s, w in zip(streams, oracle["float32"])),
        "of": n, "streams": [s.tolist() for s in streams]}
    # planted fault 2: the member acks each step without stepping; the
    # leader's step must raise GangShardLost within the group's timeout
    step = datetime.timedelta(seconds=c["fault_timeout"])
    for group in {dist.group.WORLD, tp.group}:
        dist.distributed_c10d._set_pg_timeout(step, group)
    b = ContinuousBatcher(cfg, params["float32"], max_batch=c["slots"], tp=tp)
    if rank == 1:
        b.step = lambda: []
        _member_loop(args, ctx, 0, 1, b)
    else:
        barrier = GangBarrier([member], boot_timeout=60.0, step_timeout=c["fault_timeout"])
        _, p, budget = sched[0]
        item = {"prompt": p, "max_new_tokens": budget}
        try:
            barrier.hello()
            b.submit(p, budget)
            barrier.mirror(item)
            t0 = time.perf_counter()
            try:
                barrier.step(b, 1)
                out["ack_without_step"] = {"raised": None, "seconds": time.perf_counter() - t0}
            except GangShardLost as e:
                out["ack_without_step"] = {"raised": f"{type(e).__name__}: {e}"[:400],
                                           "seconds": time.perf_counter() - t0}
        finally:
            barrier.stop()
    # the world is broken on purpose now: no teardown collective
    with open(os.path.join(ctx.working_dir, f"sharded.{rank}.json"), "w") as f:
        json.dump(out, f)


def _events(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def run_sharded_serving(seed: int, card: str, wd: str, trained: dict, serving: dict,
                        agent=None, device: str = "cuda", worker_env: dict | None = None,
                        gate: bool = True, max_new: int | None = SHARDED["max_new"]) -> dict:
    """Phase 26 on phase 13's weights (float32), phase 19's schedule
    (``serving["main"]``, budgets cut to ``max_new``; ``None`` keeps them)
    and its solo greedy streams (``serving["solo"]``, cut alike).

    26a: ``TFCluster.run(None, sharded_serving_worker, args, 2, 0, False,
    InputMode.SPARK, backend=AgentBackend(...))`` on ``agent`` (phase 25's,
    else one started here): both ranks' streams under each regime equal
    the tp ``greedy_generate`` oracle exactly, and the unsharded solo greedy
    (float32; int8 against the unsharded int8 greedy in this process) under
    phase 19's tie rule (:data:`SERVE_TIE_TOL`); the dropped row-parallel
    sum must change a stream, the ack-without-step member must make the
    leader raise ``GangShardLost`` within ``fault_timeout`` (+ 5 s).  The
    one-card batcher's decode step is timed here, beside the gang's, the
    gang's behind its barrier and each of its collectives.

    26b: ``ServingCluster.run(tier_builder, 2, mesh={"tp": 2},
    replace_failed=True)``: two gangs (4 workers on the card), ``clients``
    streams of the schedule's requests with executor 1 (gang 0's member)
    killed at its ``kill_at_step``-th step, then ``after_heal`` requests
    once the cold replacement gang has registered: every stream equal to
    26a's tp oracle, one ``replica_dead`` naming shards ``[0, 1]``, a
    requeue, nothing lost, and the healed gang serving.  Returns the
    kernels' launches (none: the serving path is PyTorch's) and the
    readings."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch import TFCluster
    from tensorflowonspark_tpu_torch.agent import AgentBackend
    from tensorflowonspark_tpu_torch.cluster import InputMode
    from tensorflowonspark_tpu_torch.models import gpt
    from tensorflowonspark_tpu_torch.models.serving import ContinuousBatcher
    from tensorflowonspark_tpu_torch.ops import quantize_params
    from tensorflowonspark_tpu_torch.serving import ServingCluster

    c = SHARDED
    f32 = serving_config(trained)
    params = trained["params"]
    # the budgets cut to max_new: a greedy rollout's first tokens are the
    # shorter rollout, so the solo streams cut alike stay the oracle
    main = [(at, p, n if max_new is None else min(n, max_new))
            for at, p, n in serving["main"]]
    solo = [s[:n] for s, (_, _, n) in zip(serving["solo"], main)]
    swd = os.path.join(wd, f"sharded_{seed}")
    os.makedirs(swd, exist_ok=True)
    path = os.path.join(swd, "weights.pt")
    torch.save({n: t.detach().cpu() for n, t in params.items()}, path)
    stage, bad = {}, []
    # 26a
    args = {"cfg": f32, "weights": path, "device": device,
            "schedule": [(at, p.tolist(), n) for at, p, n in main]}
    worker_env = dict(worker_env or {})
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if agent is None:
            agent = stack.enter_context(host_agent(os.path.join(swd, "agent_logs")))
        cluster = TFCluster.run(None, sharded_serving_worker, args, 2, 0, False,
                                InputMode.SPARK, reservation_timeout=300,
                                backend=AgentBackend([agent[0]], authkey=agent[1],
                                                     worker_env=worker_env),
                                working_dir=swd)
        stage["26a boot"] = time.perf_counter() - t0
        files = [os.path.join(swd, f"sharded.{r}.json") for r in range(2)]
        deadline = time.monotonic() + 900
        while not all(map(os.path.exists, files)) and time.monotonic() < deadline:
            time.sleep(0.2)
        cluster.shutdown(timeout=120)
    stage["26a ranks"] = time.perf_counter() - t0 - stage["26a boot"]
    ranks = []
    for f in files:
        with open(f) as fh:
            ranks.append(json.load(fh))
    r0 = ranks[0]
    oracle = r0["oracle"]
    for k in ("setup_s", "world_s", "oracle_s"):
        stage[f"26a {k}"] = r0[k]
    if any(r["oracle"] != oracle for r in ranks):
        bad.append("the ranks' tp oracles differ")
    qparams = quantize_params(params)
    model32, model8 = gpt._model(f32, params), gpt._model(f32, qparams)
    t0 = time.perf_counter()
    solo8 = solo_streams(f32, qparams, main)
    stage["26a int8 solo oracle"] = time.perf_counter() - t0
    for name in ("plain", "paged", "draft", "int8"):
        kind = "int8" if name == "int8" else "float32"
        regs = [r["regimes"][name] for r in ranks]
        streams = [np.asarray(s) for s in regs[0]["streams"]]
        exact = all(rg["equal_tp_oracle"] == len(main) for rg in regs) \
            and regs[0]["streams"] == regs[1]["streams"]
        ties = tie_readings(streams, solo8 if kind == "int8" else solo, main,
                            model8 if kind == "int8" else model32)
        div = [(i, j, m) for i, j, m in ties if j is not None]
        within = all(m <= SERVE_TIE_TOL for _, _, m in div)
        ok = exact and within
        if name == "paged":
            ok &= regs[0]["prefix"]["hit"] > 0
        if name == "draft":
            ok &= regs[0]["draft_dispatches"] > 0
        stage[f"26a {name}"] = regs[0]["seconds"]
        log(f"phase 26a {name} (tp {c['tp']}, {kind}, {c['slots']} slots) on {card}: "
            f"{regs[0]['equal_tp_oracle']}/{regs[1]['equal_tp_oracle']} of {len(main)} streams "
            f"(rank 0 / rank 1) equal the tp greedy_generate; {len(main) - len(div)}/"
            f"{len(main)} identical to the unsharded solo greedy, first divergences (request, "
            f"token, top-two margin) {[(i, j, round(m, 5)) for i, j, m in div]} -> "
            f"{'within' if within else 'OUTSIDE'} {SERVE_TIE_TOL}; {regs[0]['seconds']:.2f} s; "
            f"prefill/decode calls/steps {regs[0]['dispatches']}, prefix {regs[0]['prefix']}, "
            f"spec {regs[0]['spec']}, draft calls {regs[0]['draft_dispatches']}")
        if not ok:
            bad.append(f"26a {name}")
    # the one-card batcher's decode step on the same rows, beside the gang's
    one = decode_step_readings(ContinuousBatcher(f32, params, max_batch=c["slots"]),
                               [p for _, p, _ in main[:c["slots"]]], c["decode_steps"])
    step, coll = r0["step"], r0["collectives"]
    log(f"phase 26a decode step, {step['rows']} rows, on {card}: tp {c['tp']} gang "
        f"{step['ms']:.3f} ms (rank 1 {ranks[1]['step']['ms']:.3f}), behind the gang's "
        f"barrier {r0['barrier_step']['ms']:.3f} ms, one card {one['ms']:.3f} ms (eager, "
        f"this process); the gang's collectives {step['collectives']:.1f} a step "
        f"({step['collectives'] / step['rows']:.2f} a token), {step['bytes'] / 1e6:.4f} MB a "
        f"step through host memory ({step['bytes'] / step['rows'] / 1e3:.2f} KB a token)")
    log(f"phase 26a one collective at the step's shapes on {card}, median of "
        f"{c['collective_reps']} (ms; gloo on the card's tensors / staged by hand / on host "
        f"tensors): all-reduce [{c['slots']}, 1, {f32.hidden_size}] "
        f"{coll['all_reduce card']:.3f} / {coll['all_reduce staged']:.3f} / "
        f"{coll['all_reduce host']:.3f}; all-gather [{c['slots']}, 1, "
        f"{f32.vocab_size // c['tp']}] {coll['all_gather card']:.3f} / "
        f"{coll['all_gather staged']:.3f} / {coll['all_gather host']:.3f}; a step's "
        f"{step['collectives'] - 1:.0f} all-reduces and one all-gather on the card's tensors "
        f"{(step['collectives'] - 1) * coll['all_reduce card'] + coll['all_gather card']:.3f} "
        f"ms of its {step['ms']:.3f}")
    fault = [r["dropped_row_sum"] for r in ranks]
    log(f"phase 26a planted fault, layer {c['fault_layer']}'s row-parallel sum dropped on "
        f"rank 1: {fault[0]['equal_tp_oracle']}/{fault[0]['of']} streams equal the tp oracle "
        f"(the ranks' streams {'equal' if fault[0]['streams'] == fault[1]['streams'] else 'differ'})")
    if fault[0]["equal_tp_oracle"] == fault[0]["of"]:
        bad.append("26a: a dropped row-parallel sum (planted fault) changed no stream")
    ack = r0.get("ack_without_step") or {}
    log(f"phase 26a planted fault, a member that acks without stepping: the leader "
        f"{'raised ' + ack['raised'] if ack.get('raised') else 'did NOT raise'} after "
        f"{ack.get('seconds', float('nan')):.2f} s (group timeout {c['fault_timeout']} s)")
    if not (ack.get("raised") or "").startswith("GangShardLost") \
            or ack["seconds"] > c["fault_timeout"] + 5:
        bad.append("26a: an ack without a step did not raise GangShardLost in time")
    launches = {k: sum(int(r["launches"][k]) for r in ranks) for k in KERNEL_NAMES}
    # 26b
    reqs = [(p.tolist(), n) for _, p, n in main]
    want = {i: oracle["float32"][i] for i in range(len(reqs))}
    env = {**worker_env, "TFOS_CHAOS": f"kill node=1 at_step={c['kill_at_step']}"}
    twd = os.path.join(swd, "tier")
    t0 = time.perf_counter()
    tier = ServingCluster.run(tier_builder, 2, max_batch=c["slots"],
                              replica_args={"tier_cfg": f32, "tier_weights": path},
                              mesh={"tp": c["tp"]}, replace_failed=True, device=device,
                              worker_env=env, working_dir=twd, reservation_timeout=600,
                              client_timeout=600)
    boot = stage["26b gang boot"] = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        threads, recs = stream_clients(tier.address, tier.authkey,
                                       [(i, p, n) for i, (p, n) in enumerate(reqs)],
                                       c["clients"], 600)
        for t in threads:
            t.join(600)
        stage["26b traffic"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        while not any(e["kind"] == "replica_replaced"
                      for e in _events(os.path.join(twd, "serving_events.jsonl"))) \
                and time.perf_counter() - t0 < 300:
            time.sleep(0.2)
        stage["26b heal wait"] = time.perf_counter() - t0
        after = [(len(reqs) + k, *reqs[k]) for k in range(c["after_heal"])]
        want.update({i: oracle["float32"][k] for k, (i, _, _) in enumerate(after)})
        threads, recs2 = stream_clients(tier.address, tier.authkey, after, c["clients"], 600)
        for t in threads:
            t.join(600)
        m = tier.metrics()
        dead = tier.scheduler.dead_replicas()
        nodes = m.get("nodes", {})
    finally:
        t0 = time.perf_counter()
        tier.shutdown(timeout=300)
        stage["26b shutdown"] = time.perf_counter() - t0
    recs += recs2
    errors = [r["error"] for r in recs if r["error"]]
    equal = sum(r["tokens"] == want[r["i"]] for r in recs if r["i"] is not None)
    events = _events(os.path.join(twd, "serving_events.jsonl"))
    died = [e for e in events if e["kind"] == "replica_dead"]
    replaced = [e for e in events if e["kind"] == "replica_replaced"]
    healed = replaced[0]["replacement"] if replaced else None
    t_kill = None
    for root, _, names in os.walk(twd):
        if "chaos.1.0" in names:
            with open(os.path.join(root, "chaos.1.0")) as f:
                t_kill = float(f.read())
    requeued = [e["t"] for e in events if e["kind"] == "request_requeued"]
    started = [e["t"] for e in events if e["kind"] == "heal_started"]
    readings = {
        "boot_s": boot, "equal": equal, "of": len(recs), "errors": errors,
        "requeued": m["requeued"], "dead": sorted(dead),
        "replica_dead": [(e["replica"], e.get("shards")) for e in died],
        "kill_to_dead_s": None if t_kill is None or not died else died[0]["t"] - t_kill,
        "kill_to_requeue_s": None if t_kill is None or not requeued else requeued[0] - t_kill,
        "heal_s": replaced[0]["t"] - started[0] if replaced and started else None,
        "healed": healed, "served": {e: r["served"] for e, r in m["replicas"].items()}}
    # each gang leader's barrier (post to last ack: the step, its token
    # flush and the members' acks), from its heartbeat
    barrier = {}
    for eid, node in nodes.items():
        for _, h in ((node.get("metrics") or {}).get("tfos_gang_barrier_seconds")
                     or {}).get("samples", []):
            if h["count"]:
                barrier[eid] = (h["count"], h["sum"], h["sum"] / h["count"] * 1e3)
    readings["barrier"] = barrier
    counted, reported = tier_launches(nodes)
    log(f"phase 26b ServingCluster.run(mesh={{'tp': {c['tp']}}}), 2 gangs on {card}: gang "
        f"boot {boot:.1f} s; {equal}/{len(recs)} streams equal 26a's tp oracle "
        f"({len(reqs)} + {c['after_heal']} after the heal), errors {errors}; requeued "
        f"{m['requeued']}; dead executors {sorted(dead)}; replica_dead events "
        f"{readings['replica_dead']}; kill to dead {readings['kill_to_dead_s']} s, to the "
        f"first requeue {readings['kill_to_requeue_s']} s; heal (cold gang {healed}, "
        f"heal_started to replica_replaced) {readings['heal_s']} s; served by gang "
        f"{readings['served']}; each leader's barriers (count, s, mean ms: every step, "
        f"prefills too) {barrier} beside 26a's {r0['barrier_step']['ms']:.3f} ms decode step "
        f"behind the barrier; kernel launches {counted} reported by {reported}")
    if equal != len(recs) or errors or m["requeued"] < 1 or sorted(dead) != [0, 1] \
            or readings["replica_dead"] != [(0, [0, 1])] or healed is None \
            or not readings["served"].get(healed):
        bad.append("26b")
    launches = {k: launches[k] + counted[k] for k in KERNEL_NAMES}
    log("phase 26 seconds: " + "; ".join(f"{k} {v:.1f}" for k, v in stage.items()))
    log(f"phase 26 gate: {'passed' if not bad else 'FAILED: ' + ', '.join(bad)}; kernel "
        f"launches on the sharded serving path {launches}")
    if gate and bad:
        raise SystemExit(f"phase 26: {bad}")
    return {"launches": launches, "stages": stage, "tier": readings, "step": step,
            "barrier_step": r0["barrier_step"], "collectives": coll, "one_card_step": one}


# ------------------------------ phase 23: the batch and continual planes

#: phase 23a: BASELINE config 3's scoring half as bulk offline inference
#: (``BatchJob``): ``rows`` SQuAD-shaped rows at T 384 written by ``dfutil``
#: as ``shards`` TFRecord parts, phase 6's checkpoint (BERT-base QA) scoring
#: them in batches of ``batch_size`` in one worker that a ``TFOS_CHAOS``
#: plan kills at its ``kill_at_step``-th predict batch and
#: ``run_with_recovery`` relaunches (``scripts/bench_batch.py::
#: bench_resume``'s settings)
BATCH_PLANE = {"rows": 256, "shards": 8, "batch_size": 16, "kill_at_step": 5}
#: phase 23b, on phase 22's tier A once v2 serves (``scripts/
#: bench_continual.py::continual_loop_scenario``'s stages on real models):
#: a trainer fine-tunes phase 13's weights ``steps`` steps (B x T
#: ``batch_size`` x ``seq_len`` of the "+1" corpus, Adam ``lr``, only the
#: last block and ``ln_f``) and publishes the step's adapter delta; the
#: offline gate scores it over ``eval_rows`` held-out rows in
#: ``eval_shards`` array shards, ``eval_batch`` rows a predict batch; the
#: rollout takes phase 22's policy; the bad candidate is the healthy delta
#: times ``bad_scale``
CONTINUAL = {"steps": 4, "batch_size": 8, "seq_len": 1024, "lr": 1e-4, "eval_rows": 64,
             "eval_shards": 8, "eval_batch": 8, "bad_scale": -8.0}
#: the offline gate: a candidate passes when its mean next-token loss over
#: the held-out rows is at most v1's (the same predict_fn in this process)
#: plus this margin, in nats; readings at seeds 0-2 in PERF.md ("Phase 23")
CONTINUAL_MARGIN = 0.02


def batch_plane_stats(stats_dir: str) -> dict:
    """The scoring workers' predict batches and K1 launches, summed over
    their processes (the killed one's last write included)."""
    from tensorflowonspark_tpu_torch.gpt_continual import read_stats

    st = read_stats(stats_dir, "batch_stats")
    return {"processes": len(st), "batches": sum(s["batches"] for s in st),
            "launches": sum(s["launches"] for s in st),
            "per_batch": sorted({n for s in st for n in s["batch_launches"]}),
            "build_s": [s["build_s"] for s in st],
            "batch_ms": [statistics.median(s["batch_ms"]) for s in st]}


def run_batch_plane(seed: int, card: str, wd: str, cfg: dict | None = None,
                    device: str = "cuda", worker_env: dict | None = None,
                    timeout: float = 600.0) -> dict:
    """Phase 23a (:data:`BATCH_PLANE`): ``BatchJob`` over a
    ``ShardManifest.from_tfrecords`` of ``dfutil``-written rows, phase 6's
    checkpoint (``<wd>/bert_model``) built once a worker on the card
    (``bert_inference.batch_model_builder``) and scoring through K1
    (``batch_predict``); the only worker SIGKILLed at a predict batch and
    relaunched.  Gates: a shard committed before the kill; no committed
    shard assigned again (``ProgressLedger.replay``); every part committed
    before the kill the same bytes after the resume; ``read_results`` in
    manifest order, every row; every row within :data:`EXPORT_TOL` of this
    process's scoring of the same records with the same weights through
    K1, where a scoring that swaps the mask and the token types must not
    be; K1 12 (L) times a predict batch in the workers.
    ``cfg`` and ``device="cpu"`` rehearse it at a tiny width (no launches
    there).  Returns the workers' launches and the readings."""
    import hashlib

    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch import bert_inference as bi
    from tensorflowonspark_tpu_torch import dfutil, tfrecord
    from tensorflowonspark_tpu_torch.batch import BatchJob, ProgressLedger, ShardManifest
    from tensorflowonspark_tpu_torch.chaos import fired_at
    from tensorflowonspark_tpu_torch.dataframe import DataFrame

    c, cfg = BATCH_PLANE, cfg or bi.BERT_BASE
    layers = cfg["num_layers"] if device == "cuda" else 0
    rows = bi.make_rows(c["rows"], SEQ_LEN, cfg["vocab_size"], seed + 23)
    src, out_dir = os.path.join(wd, "batch_records"), os.path.join(wd, "batch_out")
    stats_dir, job_wd = os.path.join(wd, "batch_stats"), os.path.join(wd, "batch_job")
    os.makedirs(stats_dir, exist_ok=True)
    t0 = time.perf_counter()
    dfutil.saveAsTFRecords(DataFrame([dict(zip(bi.INPUT_COLUMNS, r)) for r in rows],
                                     num_partitions=c["shards"]), src)
    manifest = ShardManifest.from_tfrecords(os.path.join(src, "part-r-*"))
    write_s = time.perf_counter() - t0
    if len(manifest) != c["shards"]:
        raise SystemExit(f"batch plane: {len(manifest)} shards, not {c['shards']}")
    args = {"config": cfg, "model_dir": os.path.join(wd, "bert_model"), "device": device}
    job = BatchJob(manifest, out_dir, bi.batch_predict, model_builder=bi.batch_model_builder,
                   batch_size=c["batch_size"], prefetch=1,
                   predict_args={**args, "stats_dir": stats_dir})
    before_resume = {}

    def digest(key):
        with open(os.path.join(out_dir, "parts", f"{key}.tfrecord"), "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    def snapshot(attempt, exc, kind):
        # the parts the ledger holds committed when the relaunch begins
        before_resume.update({k: digest(k) for k in ProgressLedger.replay(out_dir).committed})

    t_start = time.time()
    summary = job.run(num_workers=1, max_restarts=2, reassign_dead=False, backoff_base=0.2,
                      on_restart=snapshot, working_dir=job_wd,
                      worker_env={**(worker_env or {}),
                                  "TFOS_CHAOS": f"kill node=0 at_step={c['kill_at_step']}"},
                      reservation_timeout=timeout, shutdown_timeout=timeout)
    wall = time.time() - t_start
    replay = ProgressLedger.replay(out_dir)
    attempts = [e["t"] for e in replay.events if e.get("event") == "attempt"]
    dones = [e["t"] for e in replay.events if e.get("event") == "done"]
    killed = fired_at(job_wd, 0)
    committed_before = sorted(replay.done_at_attempt(2))
    after = {k: digest(k) for k in before_resume}
    results = job.results()
    got = np.stack([np.frombuffer(b, np.float32) for b in results])
    st = batch_plane_stats(stats_dir)

    # the same records and weights in this process, through K1, in the
    # job's groups (each shard's records in batches of batch_size)
    model = bi.batch_model_builder({**args, "batch_size": c["batch_size"]})
    records = [list(tfrecord.read_records(s.path)) for s in manifest]

    groups = [recs[i:i + c["batch_size"]] for recs in records
              for i in range(0, len(recs), c["batch_size"])]
    want = np.stack([np.frombuffer(b, np.float32) for g in groups
                     for b in bi.batch_predict(model, g, None)])
    swapped = []            # the planted fault: the mask and the token types swapped
    for g in groups:
        ids, mask, types = bi.decode_rows(g)
        with torch.inference_mode():
            swapped.append(np.concatenate(bi.forward_batch(
                model["model"], [ids, types, mask], model["batch_size"], model["device"]), 1))
    swapped = np.concatenate(swapped)
    masks = np.concatenate([bi.decode_rows(recs)[1] for recs in records]).astype(bool)
    T = masks.shape[1]
    split = lambda x: (x[:, :T], x[:, T:])  # noqa: E731
    sound, fault = ({k: float(v) for k, v in export_readings(split(x), split(want),
                                                             masks).items()}
                    for x in (got, swapped))
    max_diff = float(np.abs(got - want).max()) if got.shape == want.shape else float("inf")
    del model
    if device == "cuda":
        torch.cuda.empty_cache()
    r = {"write_s": write_s, "wall_s": wall, "attempts": replay.attempts,
         "committed_before": committed_before, "reprocessed": replay.reprocessed_committed,
         "summary": summary, "rows": len(results), "max_diff": max_diff, "sound": sound,
         "fault": fault, "parts_same": sum(after[k] == v for k, v in before_resume.items()),
         "parts_of": len(before_resume), "stats": st,
         "boot_s": attempts[0] - t_start if attempts else None,
         "to_kill_s": killed - attempts[0] if killed and attempts else None,
         "relaunch_s": attempts[1] - killed if killed and len(attempts) > 1 else None,
         "finish_s": dones[-1] - attempts[-1] if dones and attempts else None}
    scored_after = sum(1 for e in replay.events if e.get("event") == "done"
                       and attempts and e["t"] > attempts[-1]) * (c["rows"] // c["shards"])
    r["rows_per_s"] = c["rows"] / wall
    r["steady_rows_per_s"] = scored_after / r["finish_s"] if r["finish_s"] else None
    ok = {"killed and relaunched": replay.attempts == 2 and killed is not None,
          "committed before the kill": len(committed_before) >= 1,
          "no committed shard again": replay.reprocessed_committed == []
                                      and summary.get("skipped_committed")
                                      == len(committed_before),
          "parts kept their bytes": r["parts_same"] == r["parts_of"] >= 1,
          "every row in manifest order": got.shape == (c["rows"], 2 * SEQ_LEN),
          "finite": bool(np.isfinite(got).all()),
          "logits": within_export(sound),
          "launches": st["batches"] >= c["rows"] // c["batch_size"]
                      and st["launches"] == layers * st["batches"]
                      and st["per_batch"] == [layers] and st["processes"] == 2}
    log(f"batch plane on {card}: {c['rows']} rows in {c['shards']} TFRecord shards "
        f"(dfutil, {write_s:.2f} s); BatchJob with one worker killed at predict batch "
        f"{c['kill_at_step']}: {replay.attempts} attempts, committed before the kill "
        f"{committed_before}, reprocessed {replay.reprocessed_committed}, summary "
        f"{summary}; {r['parts_same']}/{r['parts_of']} parts committed before the kill "
        f"kept their bytes; boot {r['boot_s']} s, first dispatch to the kill "
        f"{r['to_kill_s']} s, kill to the relaunch's dispatch {r['relaunch_s']} s, the "
        f"relaunch to its last commit {r['finish_s']} s; {wall:.1f} s in all = "
        f"{r['rows_per_s']:.1f} rows/s through the plane (boots included), "
        f"{r['steady_rows_per_s']} rows/s after the relaunch; worker K1 launches "
        f"{st['launches']} over {st['batches']} predict batches in {st['processes']} "
        f"processes (per batch {st['per_batch']}, expected [{layers}]); each worker's "
        f"model build {st['build_s']} s, median predict call {st['batch_ms']} ms (Example "
        f"decode, forward, logits to the host)")
    log(f"batch plane vs this process's K1 scoring (same weights and records): max |diff| "
        f"{max_diff:.3g} (bit-identical: {max_diff == 0.0}); export gate {EXPORT_TOL}: "
        f"sound {sound}, mask and token types swapped (planted fault) {fault}")
    bad = [k for k, v in ok.items() if not v]
    if within_export(fault):
        bad.append("the swapped mask and token types fall inside the gate")
    log(f"batch plane gate: {'passed' if not bad else 'FAILED: ' + ', '.join(bad)}")
    if bad:
        raise SystemExit(f"the batch plane's gate failed: {bad}")
    return {"flash_attention_fwd": st["launches"], "flash_attention_dq": 0,
            "flash_attention_dkv": 0, **r}


def ignoring_candidate_predict(model, records, trial_params):
    """Phase 23b's planted fault: the eval predict_fn scoring the base,
    whatever ``trial_params["continual_candidate"]`` holds."""
    from tensorflowonspark_tpu_torch import gpt_continual

    return gpt_continual.eval_predict(model, records, None)


def swap_count(events_path: str) -> int:
    """Hot swaps the tier's event log records (done and failed)."""
    from tensorflowonspark_tpu_torch.observability import EventLog

    return sum(e["kind"] in ("model_swapped", "model_swap_failed")
               for e in EventLog.read(events_path))


def run_continual_loop(seed: int, card: str, wd: str, serving, trained: dict, pool: list,
                       solo_v2: list, policy: dict, device: str = "cuda",
                       worker_env: dict | None = None, timeout: float = 300.0,
                       width: dict | None = None) -> dict:
    """Phase 23b (:data:`CONTINUAL`) on a live tier whose ``gpt@v2`` serves
    ``pool``: ``ContinualPipeline(serving, "gpt", base_builder=tier_builder,
    eval_spec=OfflineEval(...)).run(gpt_continual.trainer_fn, ...)`` with
    traffic flowing.  Gates: ``step-<steps>`` ends ``promoted``; the journal
    holds its candidate, ``offline_eval`` and ``rollout`` stages and
    ``continual_done promoted`` in that order; every stream during the
    rollout equals v2's or the candidate's solo greedy and every one after
    it the candidate's (``apply_adapter(v1, delta)`` in float32, this
    process); the promoted delta is the trainer's step checkpoint less v1,
    leaf for leaf and digest for digest; the kernels launch 12 / 1 / 1 (K1 /
    K2 / K3) a training step and K1 12 an eval batch, counted in the
    workers.  Then the healthy delta times ``bad_scale`` must end
    ``rejected_offline`` with no swap and no version change; in this
    process, over the same held-out rows, the sound eval must reject it and
    an eval predict_fn that ignores the candidate must pass it.  ``width`` overrides :data:`CONTINUAL` for a rehearsal on the
    CPU.  Returns the readings, the workers' launches and the promoted
    ``version`` with its ``payload``."""
    import threading

    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch import gpt_continual as gc
    from tensorflowonspark_tpu_torch.batch import ShardManifest
    from tensorflowonspark_tpu_torch.checkpoint import restore_checkpoint
    from tensorflowonspark_tpu_torch.continual import (CONTINUAL_QUEUES, ContinualPipeline,
                                                       OfflineEval, Publication, diff_params,
                                                       payload_digest)
    from tensorflowonspark_tpu_torch.models.gpt import greedy_generate
    from tensorflowonspark_tpu_torch.serving import RolloutPolicy, apply_adapter
    from tensorflowonspark_tpu_torch.serving.journal import ControlPlaneJournal

    c = {**CONTINUAL, **(width or {})}
    f32, v1 = serving_config(trained), trained["params"]
    layers = f32.num_layers if device == "cuda" else 0
    twd = os.path.dirname(serving.journal.path)
    stats_dir = os.path.join(wd, "continual_stats")
    os.makedirs(stats_dir, exist_ok=True)
    base_args = {"continual_base_builder": tier_builder, "tier_cfg": f32,
                 "tier_weights": os.path.join(wd, "tier_weights.pt"), "device": device}
    rows = gc.plus_one_rows(c["eval_rows"], c["seq_len"], f32.vocab_size, seed + 231)
    shards = np.split(rows, c["eval_shards"])

    # v1's loss through the same predict_fn, in this process, on the card
    t0 = time.perf_counter()
    model = gc.eval_model_builder(base_args)
    v1_losses = [gc.row_losses(gc.eval_predict(model, s, None)) for s in shards]
    reference = float(np.mean(v1_losses))
    reference_s = time.perf_counter() - t0
    scorer = gc.loss_scorer(reference, CONTINUAL_MARGIN)
    spec = OfflineEval(
        manifest=ShardManifest.from_arrays(shards),
        output_dir=os.path.join(wd, "continual_eval"), predict_fn=gc.eval_predict,
        scorer=scorer, num_workers=1,
        job_kwargs={"batch_size": c["eval_batch"], "model_builder": gc.eval_model_builder,
                    "predict_args": {**base_args, "stats_dir": stats_dir}},
        run_kwargs={"worker_env": worker_env, "max_restarts": 0,
                    "working_dir": os.path.join(wd, "continual_eval_wd"),
                    "reservation_timeout": timeout, "shutdown_timeout": timeout})
    pipe = ContinualPipeline(serving, "gpt", base_builder=tier_builder, eval_spec=spec,
                             policy=RolloutPolicy(**policy))
    stages = ("ingest", "offline_eval", "rollout")
    stage0 = {k: pipe._h_stage.labels(stage=k).fold()["sum"] for k in stages}
    arrived = {}
    process = pipe.process

    def timed_process(pub):
        arrived[pub.version] = time.time()      # the collector's poll just returned it
        return process(pub)

    pipe.process = timed_process
    rollout, during = pipe._rollout, []

    def rollout_under_traffic(version):
        # the canary's gates read live requests: clients stream while it runs
        stop = threading.Event()
        threads, recs = stream_clients(serving.address, serving.authkey,
                                       [(i, *pool[i]) for i in range(len(pool))],
                                       len(pool) // 2, timeout, stop=stop)
        try:
            return rollout(version)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout)
            during.extend(recs)

    pipe._rollout = rollout_under_traffic
    train_args = {**base_args, "model_id": "gpt", "model_dir": os.path.join(wd, "continual_model"),
                  "steps": c["steps"], "batch_size": c["batch_size"], "seq_len": c["seq_len"],
                  "lr": c["lr"], "seed": seed + 232, "stats_dir": stats_dir}
    events = os.path.join(twd, "serving_events.jsonl")
    t_run = time.perf_counter()
    outcomes = pipe.run(gc.trainer_fn, train_args, 1, queues=CONTINUAL_QUEUES,
                        max_restarts=0, poll_interval=0.2,
                        worker_env={**(worker_env or {}), "TFOS_PUBLISH_DRAIN_SECS": "600"},
                        working_dir=os.path.join(wd, "continual_train"),
                        reservation_timeout=timeout, shutdown_timeout=timeout)
    run_s = time.perf_counter() - t_run
    pipe.process, pipe._rollout = process, rollout
    version = f"step-{c['steps']}"
    stage_s = {k: pipe._h_stage.labels(stage=k).fold()["sum"] - stage0[k] for k in stages}
    pub = pipe.load_publication(version)
    if pub is None:
        raise SystemExit(f"continual loop: no stored publication of {version} "
                         f"(outcomes {outcomes})")
    [trainer] = gc.read_stats(stats_dir, "trainer")
    evals = gc.read_stats(stats_dir, "eval_stats")

    # the candidate's oracle: apply_adapter(v1, delta) in float32, here
    cand = apply_adapter(v1, pub.payload)
    solo_cand = [greedy_generate(f32, cand, np.asarray([p]), n)[0, len(p):].tolist()
                 for p, n in pool]
    threads, post = stream_clients(serving.address, serving.authkey,
                                   [(i, *pool[i]) for i in range(len(pool))], 4, timeout)
    for t in threads:
        t.join(timeout)
    saved = restore_checkpoint(train_args["model_dir"])["model"]     # its one step
    v1_cpu = {n: t.detach().cpu() for n, t in v1.items()}
    want_delta = diff_params(v1_cpu, saved)
    delta_ok = set(want_delta) == set(pub.payload) and all(
        np.array_equal(want_delta[n], pub.payload[n]) for n in want_delta) \
        and payload_digest(want_delta) == pub.digest
    trainable = gc.trainable_prefixes(f32)
    recs = [(x["kind"], x.get("stage") or x.get("outcome"))
            for x in ControlPlaneJournal.read_records(serving.journal.path)
            if x["kind"].startswith("continual_") and x.get("version") == version]
    r = {"outcomes": {f"{m}@{v}": o for (m, v), o in outcomes.items()}, "run_s": run_s,
         "reference_loss": reference, "reference_s": reference_s, "stage_s": stage_s,
         "eval": pipe.registry.version("gpt", version).eval_metrics,
         "nbytes": pub.nbytes, "leaves": len(pub.payload),
         "values": int(sum(a.size for a in pub.payload.values())),
         "transfer_s": arrived.get(version, float("nan")) - trainer["published_at"],
         "trainer": trainer, "journal": recs, "delta_is_checkpoint_less_v1": delta_ok,
         "during_of": len(during),
         "during_v2_or_cand": sum(x["error"] is None and x["tokens"] in
                                  (solo_v2[x["i"]], solo_cand[x["i"]]) for x in during),
         "during_cand": sum(x["tokens"] == solo_cand[x["i"]] != solo_v2[x["i"]]
                            for x in during),
         "cand_differs": sum(a != b for a, b in zip(solo_v2, solo_cand)),
         "post_equal": sum(x["error"] is None and x["tokens"] == solo_cand[x["i"]]
                           for x in post), "post_of": len(post),
         "versions": serving.scheduler.model_versions("gpt")}
    del cand

    # the bad candidate: the healthy delta times bad_scale, a new label
    bad_payload = {n: (c["bad_scale"] * a).astype(a.dtype) for n, a in pub.payload.items()}
    bad = Publication(model="gpt", version=f"{version}-x{c['bad_scale']:g}", flavor="adapter",
                      step=pub.step, payload=bad_payload, serve_args={}, metadata={},
                      digest=payload_digest(bad_payload), src=0, seq=pub.seq + 1)
    swaps0, versions0 = swap_count(events), serving.scheduler.model_versions("gpt")
    t0 = time.perf_counter()
    r["bad_outcome"] = pipe.process(bad)
    r["bad_s"] = time.perf_counter() - t0
    r["bad_eval"] = pipe.registry.version("gpt", bad.version).eval_metrics
    r["bad_swaps"] = swap_count(events) - swaps0
    r["bad_versions_same"] = serving.scheduler.model_versions("gpt") == versions0
    evals = gc.read_stats(stats_dir, "eval_stats")
    # the same held-out rows and scorer in this process: the sound eval must
    # reject the bad candidate, and one that ignores it (the planted fault)
    # scores the base and so passes it
    trial = {"continual_candidate": {"version": bad.version, "flavor": "adapter",
                                     "payload": bad_payload}}
    r["sound_eval"], sound_pass = scorer([b for s in shards
                                          for b in gc.eval_predict(model, s, trial)])
    r["fault_eval"], fault_pass = scorer([b for s in shards
                                          for b in ignoring_candidate_predict(model, s, trial)])
    del model
    if device == "cuda":
        torch.cuda.empty_cache()
    per_step = trainer["launches"]
    r["launches"] = {
        "trainer": {k: sum(s[k] for s in per_step) for k in gc.KERNELS},
        "eval": {k: sum(e["launches"][k] for e in evals) for k in gc.KERNELS},
        "eval_batches": sum(e["batches"] for e in evals)}
    want_step = {"flash_attention_fwd": layers, "flash_attention_dq": min(layers, 1),
                 "flash_attention_dkv": min(layers, 1)}
    ok = {"promoted": outcomes == {("gpt", version): "promoted"},
          "journal": recs == [("continual_candidate", None), ("continual_stage", "offline_eval"),
                              ("continual_stage", "rollout"), ("continual_done", "promoted")],
          "during": r["during_v2_or_cand"] == r["during_of"] >= 1,
          "post": r["post_equal"] == r["post_of"] and r["versions"] == {version: [0, 1]},
          "delta": delta_ok and all(n.startswith(trainable) for n in pub.payload),
          "candidate changes a stream": r["cand_differs"] >= 1,
          "trainer launches": all(s == want_step for s in per_step),
          "eval launches": r["launches"]["eval_batches"] == 2 * c["eval_shards"]
                           and r["launches"]["eval"]["flash_attention_fwd"]
                           == layers * r["launches"]["eval_batches"],
          "bad rejected offline": r["bad_outcome"] == "rejected_offline",
          "bad never loaded": r["bad_swaps"] == 0 and r["bad_versions_same"]}
    log(f"continual loop on {card}: outcomes {r['outcomes']} in {run_s:.1f} s (trainer boot, "
        f"{c['steps']} steps, publication, offline eval, rollout); stage seconds {stage_s}; "
        f"v1's eval loss {reference:.5f} ({reference_s:.1f} s in this process), the "
        f"candidate's {r['eval']}; publication {r['nbytes']} bytes ({r['values']} float32 "
        f"values in {r['leaves']} leaves), transfer {r['transfer_s']:.3f} s; trainer losses "
        f"{[round(x, 5) for x in trainer['losses']]}, step ms "
        f"{[round(x, 1) for x in trainer['step_ms']]}, save and publish "
        f"{trainer['save_and_publish_s']:.2f} s, its CUDA context and v1's load "
        f"{trainer['load_s']} s; the eval workers' {[e['load_s'] for e in evals]} s, "
        f"median predict call {[statistics.median(e['batch_ms']) for e in evals]} ms; journal {recs}; delta = the checkpoint less v1 "
        f"leaf for leaf: {delta_ok}; {r['during_v2_or_cand']}/{r['during_of']} streams during "
        f"the loop equal v2's or the candidate's ({r['during_cand']} the candidate's), "
        f"{r['post_equal']}/{r['post_of']} after it the candidate's (it changes "
        f"{r['cand_differs']} of {len(pool)}), versions {r['versions']}; launches "
        f"{r['launches']} (a training step {per_step[0] if per_step else None})")
    log(f"continual loop, bad candidate (x{c['bad_scale']:g}): {r['bad_outcome']} in "
        f"{r['bad_s']:.1f} s, eval {r['bad_eval']}, swaps {r['bad_swaps']}, versions "
        f"unchanged {r['bad_versions_same']}; on the {c['eval_rows']} held-out rows in this "
        f"process: sound eval {r['sound_eval']} (passed {sound_pass}), an eval ignoring the "
        f"candidate (planted fault) {r['fault_eval']} (passed {fault_pass})")
    failed = [k for k, v in ok.items() if not v]
    if sound_pass:
        failed.append("the sound eval in this process passes the bad candidate")
    if not fault_pass:
        failed.append("the eval that ignores the candidate rejects it")
    log(f"continual loop gate: {'passed' if not failed else 'FAILED: ' + ', '.join(failed)}")
    if failed:
        raise SystemExit(f"the continual loop's gate failed: {failed}")
    r["version"], r["payload"] = version, pub.payload
    return r


def continual_readings(seed: int, trained: dict, wd: str, device: str = "cuda",
                       width: dict | None = None) -> dict:
    """Phase 23b's offline-gate readings, in this process
    (``--calibrate-continual``): the held-out rows' mean eval loss under v1
    (phase 13's weights ``trained``), under the candidate the trainer's
    steps make from it, and under the bad candidate (its delta times
    ``bad_scale``), through the phase's own ``finetune`` and
    ``eval_predict``."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch import gpt_continual as gc
    from tensorflowonspark_tpu_torch.continual import diff_params

    c = {**CONTINUAL, **(width or {})}
    f32 = serving_config(trained)
    path = os.path.join(wd, "tier_weights.pt")
    torch.save({n: t.detach().cpu() for n, t in trained["params"].items()}, path)
    args = {"continual_base_builder": tier_builder, "tier_cfg": f32, "tier_weights": path,
            "device": device}
    rows = gc.plus_one_rows(c["eval_rows"], c["seq_len"], f32.vocab_size, seed + 231)
    train = gc.plus_one_rows(c["steps"] * c["batch_size"], c["seq_len"], f32.vocab_size,
                             seed + 232)
    model = gc.eval_model_builder(args)
    out = gc.finetune(f32, model["base"], np.split(train, c["steps"]), c["lr"],
                      model["device"])
    delta = diff_params(model["base"], out["model"].state_dict())
    del out

    def loss(payload):
        trial = None if payload is None else {"continual_candidate": {
            "version": str(id(payload)), "flavor": "adapter", "payload": payload}}
        return float(np.mean([gc.row_losses(gc.eval_predict(model, s, trial))
                              for s in np.split(rows, c["eval_shards"])]))

    r = {"v1": loss(None), "candidate": loss(delta),
         "bad": loss({n: c["bad_scale"] * a for n, a in delta.items()})}
    r["candidate_minus_v1"], r["bad_minus_v1"] = r["candidate"] - r["v1"], r["bad"] - r["v1"]
    log(f"continual gate readings, seed {seed}: eval loss v1 {r['v1']:.5f}, candidate "
        f"{r['candidate']:.5f} ({r['candidate_minus_v1']:+.5f}), bad x{c['bad_scale']:g} "
        f"{r['bad']:.5f} ({r['bad_minus_v1']:+.5f}); margin {CONTINUAL_MARGIN}")
    return r


def serving_config(trained: dict):
    """Phase 13's configuration as the tier serves it: float32, no kernel."""
    import dataclasses

    import torch

    return dataclasses.replace(trained["cfg"], dtype=torch.float32, attention_fn=None)


# ------------------------------------------------- the other models (slice 9)

#: the 26 categorical vocabularies of Criteo Kaggle (the DLRM repository's
#: Kaggle loader); they sum to 33,762,577 rows
CRITEO_KAGGLE_VOCABS = (1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
                        8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
                        286181, 105, 142572)
#: phase 15's dense run: the JAX example takes one vocab for all 26
#: features, so 1,298,561 rows each gives the Kaggle total (33.76M rows,
#: 2.2 GB of float32 embeddings at 16 wide); the replay on the CPU covers
#: the first ``replay_steps`` (the worker checkpoints there too); 4
#: steps, not 8, for time (the steps after the replay's end, and their
#: 2.2 GB checkpoint, were gated by nothing)
WIDE_DEEP = {"vocab_size": 1_298_561, "embed_dim": 16, "batch_size": 8192, "steps": 4,
             "lr": 0.05, "save_every": 4, "replay_steps": 4}
#: the Wide&Deep gates against the CPU replay (float32 both sides, no TF32):
#: each step's loss, relative; ||w - w_cpu|| / ||w_cpu - w0|| of the MLP's
#: parameters (max) and of each table over the rows the batches touched
#: (max); rows no batch touched must equal their initial value bit for
#: bit.  The sparse step: the touched rows of the table and of the adagrad
#: slot likewise.  Readings at seeds 0-2 and the planted faults: PERF.md
WIDE_DEEP_TOL = {"loss": 1e-4, "mlp": 1e-2, "rows": 1e-2}
SPARSE_TOL = {"loss": 1e-4, "rows": 1e-3, "slot": 1e-3}
SPARSE = {"batch_size": 8192, "steps": 8, "embed_dim": 16, "lr": 0.05}


def wide_deep_args(seed: int, model_dir: str, cfg: dict, device: str):
    return argparse.Namespace(cluster_size=1, num_ps=1, batch_size=cfg["batch_size"],
                              steps=cfg["steps"], lr=cfg["lr"], vocab_size=cfg["vocab_size"],
                              embed_dim=cfg["embed_dim"], seed=seed,
                              save_every=cfg["save_every"], model_dir=model_dir,
                              cpu=device == "cpu", device=device)


def wide_deep_readings(w: dict, w_cpu: dict, w0: dict, touched: list) -> dict:
    """``w`` against the CPU replay's ``w_cpu`` (both from ``w0``), as
    :data:`WIDE_DEEP_TOL` reads them; ``touched[i]``: feature ``i``'s rows."""
    import torch

    mlp, rows, untouched_equal = {}, {}, True
    for name, ref in w_cpu.items():
        got, start = w[name].cpu(), w0[name]
        if name.startswith(("wide.", "emb.")):
            i = int(name.split(".")[1])
            t = torch.zeros(ref.shape[0], dtype=torch.bool)
            t[torch.from_numpy(touched[i])] = True
            rows[name] = ((got[t] - ref[t]).norm() / (ref[t] - start[t]).norm()).item()
            untouched_equal &= torch.equal(got[~t], start[~t])
        else:
            mlp[name] = ((got - ref).norm() / (ref - start).norm()).item()
    return {"mlp": max(mlp.values()), "mlp_worst": max(mlp, key=mlp.get),
            "rows": max(rows.values()), "rows_worst": max(rows, key=rows.get),
            "untouched_equal": untouched_equal}


def run_wide_deep(seed: int, card: str, wd: str, cfg: dict | None = None,
                  device: str = "cuda", gate: bool = True) -> dict:
    """BASELINE config 4, dense: the port's ``wide_deep_criteo.main_fun``
    through ``TPUCluster.run`` (one worker, ``InputMode.TENSORFLOW``) at the
    Criteo Kaggle total of table rows (:data:`WIDE_DEEP`), checkpointing at
    ``replay_steps`` and at the end; then the same batches replayed by the
    port's float32 path on the CPU, and the card again with
    ``torch.optim.Adagrad`` (the planted fault), each against the replay
    (:data:`WIDE_DEEP_TOL`).  Returns the run's numbers."""
    import itertools

    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.checkpoint import restore_checkpoint
    from tensorflowonspark_tpu_torch.cluster import InputMode, TPUCluster
    from tensorflowonspark_tpu_torch.examples.wide_deep import wide_deep_criteo as wdc
    from tensorflowonspark_tpu_torch.models.wide_deep import WideDeep

    cfg = cfg or WIDE_DEEP
    model_dir = os.path.join(wd, "wide_deep_model")
    args = wide_deep_args(seed, model_dir, cfg, device)
    rows = cfg["vocab_size"] * wdc.NUM_CATEGORICAL
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cluster = TPUCluster.run(wdc.main_fun, args, 1, input_mode=InputMode.TENSORFLOW,
                             reservation_timeout=600, working_dir=os.path.join(wd, "wide_deep"))
    cluster.shutdown(timeout=900)
    wall = time.perf_counter() - t0
    with open(os.path.join(cluster.working_dir, "wide_deep_stats.0.json")) as f:
        st = json.load(f)
    if len(st["losses"]) != cfg["steps"] or not all(map(math.isfinite, st["losses"])):
        raise SystemExit(f"Wide&Deep losses: {st['losses']}")
    steady = statistics.median(st["step_ms"][1:])
    out = {"rows": rows, "step_ms": steady, "examples_per_s": cfg["batch_size"] / steady * 1e3,
           "peak_MB": (st["peak_bytes"] or 0) / 1e6, "wall_s": wall, "losses": st["losses"]}
    log(f"Wide&Deep (dense) through TPUCluster.run on {st['device']}: {cfg['steps']} steps of "
        f"{cfg['batch_size']} over {rows:,} table rows x ({cfg['embed_dim']} + 1), "
        f"{wall:.1f} s wall; median step {steady:.2f} ms over steps 2..{cfg['steps']} "
        f"(all {[round(x, 2) for x in st['step_ms']]}) = {1e3 / steady:.1f} steps/s, "
        f"{out['examples_per_s']:,.0f} examples/s; peak memory {out['peak_MB']:,.0f} MB; losses "
        f"{[round(x, 5) for x in st['losses']]}")

    # the replay on the CPU, float32, over the first replay_steps batches
    n = cfg["replay_steps"]
    batches = list(itertools.islice(wdc.batches(args, 17), n))
    touched = [np.unique(np.concatenate([c[:, i] for _, c, _ in batches]))
               for i in range(wdc.NUM_CATEGORICAL)]
    t0 = time.perf_counter()
    model = wdc.build_model(args, torch.device("cpu"))
    w0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    replay = wdc.train(model, args, torch.device("cpu"), batches)
    w_cpu = {k: v.detach() for k, v in model.state_dict().items()}
    del model
    log(f"Wide&Deep CPU replay of {n} steps: {time.perf_counter() - t0:.1f} s; losses "
        f"{[round(x, 5) for x in replay['losses']]}")
    saved = restore_checkpoint(model_dir, step=n)["model"]

    def fault_run():
        with torch.device("meta"):
            fmodel = WideDeep([args.vocab_size] * wdc.NUM_CATEGORICAL, args.embed_dim)
        fmodel = fmodel.to_empty(device=device)
        fmodel.load_state_dict(w0)                   # the replay's start, copied
        fstats = wdc.train(fmodel, args, torch.device(device), batches,
                           optimizer_fn=lambda p: torch.optim.Adagrad(p, lr=args.lr))
        return fstats["losses"], {k: v.detach().cpu() for k, v in fmodel.state_dict().items()}

    verdicts = {}
    for name, (losses, w) in (("card (worker)", (st["losses"][:n], saved)),
                              ("card, torch.optim.Adagrad (planted fault)", fault_run())):
        r = wide_deep_readings(w, w_cpu, w0, touched)
        r["loss"] = max(abs(a - b) / abs(b) for a, b in zip(losses, replay["losses"]))
        verdicts[name] = within(r, WIDE_DEEP_TOL) and r["untouched_equal"]
        log(f"Wide&Deep gate, {name} vs the CPU replay: loss {r['loss']:.3g}; MLP max "
            f"{r['mlp']:.3g} ({r['mlp_worst']}); touched rows max {r['rows']:.3g} "
            f"({r['rows_worst']}); untouched rows bit-identical {r['untouched_equal']}")
        out[name] = r
    del w_cpu, w0, saved
    _gate(gate, "Wide&Deep", WIDE_DEEP_TOL, verdicts)
    return out


def _gate(gate: bool, what: str, tol: dict, verdicts: dict) -> None:
    """Fail unless every sound run is within ``tol`` and every planted
    fault (a name with "fault") outside it; only log with ``gate=False``."""
    sound = [ok for name, ok in verdicts.items() if "fault" not in name]
    faults = [ok for name, ok in verdicts.items() if "fault" in name]
    log(f"{what} gate {tol}: sound runs {'within' if all(sound) else 'OUTSIDE'}; planted "
        f"faults {'outside' if not any(faults) else 'INSIDE'}")
    if gate and not all(sound):
        raise SystemExit(f"{what}: the card disagrees with the CPU replay")
    if gate and any(faults):
        raise SystemExit(f"{what}: the gate does not see the planted fault")


def _last_duplicate_wins(table, acc, local, g, lr, eps, optimizer):
    """The planted fault: adagrad rows written with ``index_put_`` without
    ``accumulate``, so of duplicate ids one write wins."""
    import torch

    local = local.reshape(-1)
    g = g.reshape(local.shape[0], -1).to(table.dtype)
    acc.index_put_((local,), acc[local] + g * g)
    table.index_put_((local,), table[local] - lr * g / torch.sqrt(acc[local] + 1e-8))
    return table, acc


def run_sparse_criteo(seed: int, card: str, vocabs=CRITEO_KAGGLE_VOCABS, cfg: dict | None = None,
                      device: str = "cuda", gate: bool = True) -> dict:
    """``build_sparse_embedding_train_step`` (adagrad) on one table holding
    every Criteo Kaggle vocabulary end to end (33,762,577 x 16), each
    feature's ids drawn from its own vocabulary (the JAX example's click
    rule) and offset by the vocabularies before it; the objective is the
    logit ``sum_f <emb_f, W_f>`` under the sigmoid cross-entropy.  The card's
    run and a run whose writes let the last duplicate win (the planted
    fault; three features have 3, 4 and 10 ids, so every batch of 8192
    repeats ids) against the same steps on the CPU (:data:`SPARSE_TOL`)."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.examples.wide_deep import wide_deep_criteo as wdc
    from tensorflowonspark_tpu_torch.models.wide_deep import sigmoid_binary_cross_entropy
    from tensorflowonspark_tpu_torch.parallel import build_sparse_embedding_train_step
    from tensorflowonspark_tpu_torch.parallel import embedding

    cfg = cfg or SPARSE
    V, F, B = sum(vocabs), cfg["embed_dim"], cfg["batch_size"]
    offsets = np.concatenate([[0], np.cumsum(vocabs)[:-1]])
    rng = np.random.default_rng([seed, 15])
    proj = rng.standard_normal((len(vocabs), F)).astype(np.float32)
    batches = []
    for _ in range(cfg["steps"]):
        _, cat, label = wdc._batch(rng, vocabs, B)
        batches.append((cat + offsets, label))
    ids_all = np.unique(np.concatenate([ids.reshape(-1) for ids, _ in batches]))
    table0 = torch.empty(V, F).normal_(0.0, 0.02, generator=torch.Generator().manual_seed(seed))

    def run(dev, fault=False):
        dev = torch.device(dev)
        w = torch.from_numpy(proj).to(dev)
        step = build_sparse_embedding_train_step(
            None, lambda e, y: sigmoid_binary_cross_entropy((e * w).sum((1, 2)), y).mean(),
            lr=cfg["lr"], optimizer="adagrad")
        cuda = dev.type == "cuda"
        base = torch.cuda.memory_allocated() if cuda else 0
        table, slot = table0.to(dev, copy=True), torch.zeros(V, F, device=dev)
        saved = embedding._sparse_rows_update
        if fault:
            embedding._sparse_rows_update = _last_duplicate_wins
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        try:
            for ids, y in batches:
                t0 = time.perf_counter()
                table, slot, loss = step(table, slot, torch.from_numpy(ids).to(dev),
                                         torch.from_numpy(y).to(dev))
                losses.append(float(loss))
                ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            embedding._sparse_rows_update = saved
        peak = (torch.cuda.max_memory_allocated() - base) / 1e6 if cuda else None
        return losses, ms, peak, table, slot

    losses, ms, peak, table, slot = run(device)
    t0 = time.perf_counter()
    c_losses, _, _, c_table, c_slot = run("cpu")
    replay_s = time.perf_counter() - t0
    steady = statistics.median(ms[1:])
    out = {"rows": V, "step_ms": steady, "examples_per_s": B / steady * 1e3, "peak_MB": peak,
           "lookups_per_s": B * len(vocabs) / steady * 1e3, "touched_rows": int(len(ids_all))}
    log(f"sparse Criteo step on {card}: one {V:,} x {F} table (all 26 Kaggle vocabularies), "
        f"batch {B} x {len(vocabs)} ids, {len(ids_all):,} rows touched in {cfg['steps']} "
        f"steps; median step {steady:.3f} ms = {1e3 / steady:.1f} steps/s, "
        f"{out['examples_per_s']:,.0f} examples/s, {out['lookups_per_s']:,.0f} "
        f"lookups+updates/s; peak memory {peak or 0:,.0f} MB (table and slot "
        f"{2 * V * F * 4 / 1e6:,.0f} MB); CPU replay {replay_s:.1f} s")
    t = torch.zeros(V, dtype=torch.bool)
    t[torch.from_numpy(ids_all)] = True
    fault = run(device, fault=True)
    verdicts = {}
    for name, (ls, tab, sl) in (("card", (losses, table, slot)),
                                ("card, last duplicate wins (planted fault)",
                                 (fault[0], fault[3], fault[4]))):
        tab, sl = tab.cpu(), sl.cpu()
        r = {"loss": max(abs(a - b) / abs(b) for a, b in zip(ls, c_losses)),
             "rows": ((tab[t] - c_table[t]).norm() / (c_table[t] - table0[t]).norm()).item(),
             "slot": ((sl[t] - c_slot[t]).norm() / c_slot[t].norm()).item(),
             "untouched_equal": torch.equal(tab[~t], table0[~t]) and not sl[~t].any()}
        verdicts[name] = within(r, SPARSE_TOL) and r["untouched_equal"]
        log(f"sparse gate, {name} vs the CPU replay: loss {r['loss']:.3g}; touched rows "
            f"{r['rows']:.3g}; slot {r['slot']:.3g}; untouched rows and slot unchanged "
            f"{r['untouched_equal']}")
        out[name] = r
    _gate(gate, "sparse Criteo step", SPARSE_TOL, verdicts)
    return out


def conv_macs(model, x, **kwargs) -> int:
    """Multiply-adds of one forward of ``model`` on ``x`` (convolutions,
    transposed convolutions and Dense layers, from their output shapes),
    counted on the meta device: nothing is computed."""
    import copy

    import torch
    from torch import nn

    from tensorflowonspark_tpu_torch.models.resnet import Conv
    from tensorflowonspark_tpu_torch.models.unet import ConvTranspose

    total = [0]

    def hook(mod, inputs, out):
        out = out[0] if isinstance(out, tuple) else out
        w = mod.weight
        if isinstance(mod, nn.Linear):
            total[0] += out.numel() * w.shape[1]
        elif isinstance(mod, ConvTranspose):
            total[0] += inputs[0].numel() * w.shape[1] * w.shape[2] * w.shape[3]
        else:
            total[0] += out.numel() * w[0].numel()

    meta = copy.deepcopy(model).to("meta")
    for mod in meta.modules():
        if isinstance(mod, (Conv, nn.Conv2d, nn.Linear, ConvTranspose)):
            mod.register_forward_hook(hook)
    with torch.no_grad():
        meta(x.to("meta"), **kwargs)
    return total[0]


def image_gate_readings(card: dict, cpu: dict) -> dict:
    """A card step's outputs against the CPU's: ``{name: tensor}`` of
    ``logits``/``aux``/``loss``, ``grad/<param>`` and ``buffer/<name>``
    (with ``buffer0/<name>`` the values before the step), as
    :data:`INCEPTION_TOL` and :data:`UNET_TOL` read them."""
    import numpy as np

    r = {}
    for k in ("logits", "aux"):
        if k in cpu:
            r[k] = ((card[k].cpu().float() - cpu[k]).abs().max() / cpu[k].abs().max()).item()
    r["loss"] = abs(card["loss"] - cpu["loss"])
    rel = {n: ((card[n].cpu() - g).norm() / g.norm()).item()
           for n, g in cpu.items() if n.startswith("grad/") and g.norm() > 0}
    worst = max(rel, key=rel.get)
    r.update(max=rel[worst], worst=worst[5:], median=float(np.median(list(rel.values()))))
    bufs = [((card[n].cpu() - b).norm() / (b - cpu["buffer0/" + n[7:]]).norm()).item()
            for n, b in cpu.items() if n.startswith("buffer/")]
    if bufs:
        r["buffers"] = max(bufs)
    return r


def image_step(model, x, y, device: str, loss_fn) -> dict:
    """One train-mode forward and backward of ``model`` on ``device``: the
    outputs :func:`image_gate_readings` compares."""
    import torch

    dev = torch.device(device)
    model = model.to(dev)
    x = x.to(dev)
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
        x = x.contiguous(memory_format=torch.channels_last)
    bufs0 = {n: b.detach().clone() for n, b in model.named_buffers() if "running" in n}
    out = loss_fn(model, x, y.to(dev))
    out["loss"].backward()
    res = {k: v.detach() for k, v in out.items() if k != "loss"}
    res["loss"] = out["loss"].item()
    res.update({"grad/" + n: p.grad.detach() for n, p in model.named_parameters()})
    res.update({"buffer/" + n: b.detach() for n, b in model.named_buffers() if "running" in n})
    res.update({"buffer0/" + n: b for n, b in bufs0.items()})
    return res


#: phase 16's gate, one train-mode step at 299 px, batch 2, aux head on,
#: dropout 0, BatchNorm scales from U(0.5, 1.5), against the port's CPU
#: path: max |logit diff| over max |logit| (logits and aux logits), the
#: loss's |diff|, ||g - g_cpu|| / ||g_cpu|| over the parameters (max and
#: median), and ||b - b_cpu|| / ||b_cpu - b0|| of the BatchNorm buffers
#: (max).  At init the train-mode network is chaotic: its gradients through
#: ~94 batch-normalised layers amplify rounding by ~1e7 (float32 card
#: against float32 CPU: gradients max 1.1, median 0.41, where the forward
#: agrees to 4e-5), so the gradients are gated in float64 on both sides
#: (cuDNN's float64 convolutions on the card), the float32 step's forward
#: quantities (logits, loss, buffers) in float32, and the bf16 step is
#: logged only; the planted fault (the 1x7 / 7x1 kernels with their axes
#: swapped) must fall outside the float64 gate.  Readings at seeds 0-2:
#: PERF.md
INCEPTION_TOL = {"float64": {"logits": 1e-6, "aux": 1e-6, "loss": 1e-6, "max": 1e-4,
                             "median": 1e-6, "buffers": 1e-6},
                 "float32": {"logits": 1e-3, "aux": 1e-3, "loss": 1e-3, "buffers": 1e-3}}
INCEPTION = {"image_size": 299, "gate_batch": 2, "batch_size": 32, "steps": 4,
             "num_samples": 128, "num_classes": 1000, "lr": 0.045}


def _inception_loss(model, x, y):
    import torch.nn.functional as F

    logits, aux = model(x, train=True)
    return {"logits": logits, "aux": aux,
            "loss": F.cross_entropy(logits, y) + 0.3 * F.cross_entropy(aux, y)}


def _swap_rect_kernels(model):
    """The planted fault: every 1x7 / 7x1 (and 1x3 / 3x1) kernel with its
    spatial axes swapped."""
    import torch

    from tensorflowonspark_tpu_torch.models.resnet import Conv

    for mod in model.modules():
        if isinstance(mod, Conv) and mod.weight.shape[2] != mod.weight.shape[3]:
            mod.weight = torch.nn.Parameter(mod.weight.detach().transpose(2, 3).contiguous())
    return model


def image_gate(what: str, fault: str, build, loss_fn, x, y, device: str, variants: list,
               gate: bool) -> dict:
    """One train-mode step on the card per ``(dtype, tol, with_fault)`` of
    ``variants`` against the port's CPU path in float64 (for a float64
    card run) or float32 (the others), same weights and batch; each held to
    ``tol`` (:func:`image_gate_readings`; ``None``: logged only), and with
    ``with_fault`` the planted ``fault`` (``build(dtype, fault=True)``) must
    fall outside it."""
    import torch

    # one step a variant: cuDNN's autotuning (left on by phase 8) would only
    # add its search to every convolution's first call
    torch.backends.cudnn.benchmark = False
    ref = {}
    verdicts, out = {}, {}
    for dtype, tol, with_fault in variants:
        ref_dtype = torch.float64 if dtype == torch.float64 else torch.float32
        if ref_dtype not in ref:
            ref[ref_dtype] = image_step(build(ref_dtype), x, y, "cpu", loss_fn)
        kind = str(dtype)[6:]
        runs = [(f"card {kind}", False)] + (
            [(f"card {kind}, {fault} (planted fault)", True)] if with_fault else [])
        for name, planted in runs:
            r = image_gate_readings(image_step(build(dtype, planted), x, y, device, loss_fn),
                                    ref[ref_dtype])
            out[name] = r
            if tol is not None:
                verdicts[name] = within(r, tol)
            log(f"{what} gate, {name} vs the CPU {str(ref_dtype)[6:]} path: "
                + ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                            for k, v in r.items())
                + (f" (gate {tol})" if tol is not None else " (logged, not gated)"))
    _gate(gate, what, {str(d)[6:]: t for d, t, _ in variants}, verdicts)
    return out


def check_inception(seed: int, card: str, cfg: dict | None = None, device: str = "cuda",
                    gate: bool = True) -> dict:
    """Phase 16's gate (:data:`INCEPTION_TOL`)."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.models import inception

    cfg = cfg or INCEPTION
    size, B, C = cfg["image_size"], cfg["gate_batch"], cfg["num_classes"]
    rng = np.random.default_rng([seed, 16])
    x = torch.from_numpy(rng.random((B, 3, size, size), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, C, B))

    def build(dtype, fault=False):
        f64 = dtype == torch.float64
        model = inception.InceptionV3(C, aux_logits=True, dropout_rate=0.0, dtype=dtype,
                                      image_size=size,
                                      norm_dtype=torch.float64 if f64 else torch.float32)
        model.load_state_dict(inception.init_params(model, seed, scales=(0.5, 1.5)))
        model = model.double() if f64 else model
        return _swap_rect_kernels(model) if fault else model

    log(f"Inception-v3 gate, seed {seed}: {size} px, batch {B}, aux head, train mode")
    return image_gate("Inception-v3", "1x7 axes swapped", build, _inception_loss, x, y, device,
                      [(torch.float64, INCEPTION_TOL["float64"], True),
                       (torch.float32, INCEPTION_TOL["float32"], False),
                       (torch.bfloat16, None, False)], gate)


def run_inception(seed: int, card: str, wd: str, cfg: dict | None = None,
                  device: str = "cuda", gate: bool = True) -> dict:
    """Phase 16: the gate, then the port's ``inception_imagenet.py``
    through ``TPUCluster.run`` for ``steps`` steps at full width (aux head,
    RMSProp under the decay): finite losses, every RMSProp momentum buffer
    moved (read from the chief's checkpoint); images/s and the model's FLOP
    share of 989 TFLOP/s (2 FLOPs a multiply-add, x3 for the backward)."""
    import torch

    from tensorflowonspark_tpu_torch.checkpoint import restore_checkpoint
    from tensorflowonspark_tpu_torch.cluster import InputMode, TPUCluster
    from tensorflowonspark_tpu_torch.examples.imagenet import inception_imagenet as ii
    from tensorflowonspark_tpu_torch.models import inception

    cfg = cfg or INCEPTION
    gate = check_inception(seed, card, cfg, device, gate)
    model_dir = os.path.join(wd, "inception_model")
    args = argparse.Namespace(cluster_size=1, batch_size=cfg["batch_size"], steps=cfg["steps"],
                              lr=cfg["lr"], image_size=cfg["image_size"],
                              num_classes=cfg["num_classes"], num_samples=cfg["num_samples"],
                              seed=seed, data_dir="", model_dir=model_dir,
                              cpu=device == "cpu", device=device)
    t0 = time.perf_counter()
    cluster = TPUCluster.run(ii.main_fun, args, 1, input_mode=InputMode.TENSORFLOW,
                             reservation_timeout=600, working_dir=os.path.join(wd, "inception"))
    cluster.shutdown(timeout=900)
    wall = time.perf_counter() - t0
    with open(os.path.join(cluster.working_dir, "inception_stats.0.json")) as f:
        st = json.load(f)
    if len(st["losses"]) != cfg["steps"] or not all(map(math.isfinite, st["losses"])):
        raise SystemExit(f"Inception-v3 example losses: {st['losses']}")
    saved = restore_checkpoint(model_dir)
    traces = [s["trace"] for s in saved["optim"]["state"].values()]
    if saved["step"] != cfg["steps"] or not traces or not all(t.abs().max() > 0 for t in traces):
        raise SystemExit("the Inception-v3 checkpoint lacks its step or a moved RMSProp "
                         "momentum")
    size = cfg["image_size"]
    model = inception.InceptionV3(cfg["num_classes"], aux_logits=True, dropout_rate=0.0,
                                  image_size=size)
    flops = 3 * 2 * conv_macs(model, torch.zeros(1, 3, size, size), train=True)
    steady = statistics.median(st["step_ms"][1:])
    ips = cfg["batch_size"] / steady * 1e3
    share = flops * ips / H100_BF16_FLOPS
    log(f"Inception-v3 example through TPUCluster.run on {card}: {cfg['steps']} steps of "
        f"{cfg['batch_size']} x {size} px (aux head, RMSProp), {wall:.1f} s wall; losses "
        f"{[round(x, 4) for x in st['losses']]}; {len(traces)} momentum buffers moved; median "
        f"step {steady:.2f} ms over steps 2..{cfg['steps']} (all "
        f"{[round(x, 1) for x in st['step_ms']]}) = {ips:.1f} images/s; "
        f"{flops / 1e9:.2f} GFLOP an image (train) = {share:.4f} of 989 TFLOP/s; peak memory "
        f"{(st['peak_bytes'] or 0) / 1e6:,.0f} MB")
    return {"gate": gate, "images_per_s": ips, "step_ms": steady, "flop_share": share,
            "gflop_per_image": flops / 1e9, "peak_MB": (st["peak_bytes"] or 0) / 1e6}


#: phase 17's gate, one train-mode step of the default-width U-Net (64,
#: 128, 256, 512) at 256 px, batch 1 (the float32 CPU path's time; GroupNorm
#: is per image): the card in float32 and in bf16 against the CPU's float32
#: as :data:`INCEPTION_TOL` reads (no aux, no buffers); readings at seeds
#: 0-2 and the planted fault (the transposed kernels without flax's flip):
#: PERF.md
UNET_TOL = {"float32": {"logits": 1e-3, "loss": 1e-3, "max": 2e-2, "median": 5e-3},
            "bfloat16": {"logits": 5e-2, "loss": 2e-2, "max": 0.6, "median": 0.3}}
UNET = {"image_size": 256, "gate_batch": 1, "batch_size": 8, "steps": 6, "num_samples": 64,
        "features": (64, 128, 256, 512), "lr": 1e-3}


def _unet_loss(model, x, y):
    import torch.nn.functional as F

    logits = model(x)
    return {"logits": logits, "loss": F.cross_entropy(logits, y)}


def check_unet(seed: int, card: str, cfg: dict | None = None, device: str = "cuda",
               gate: bool = True) -> dict:
    """Phase 17's gate (:data:`UNET_TOL`)."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.models import unet

    cfg = cfg or UNET
    size, B = cfg["image_size"], cfg["gate_batch"]
    rng = np.random.default_rng([seed, 17])
    x = torch.from_numpy(rng.random((B, 3, size, size), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 2, (B, size, size)))

    def build(dtype, fault=False):
        model = unet.UNet(2, cfg["features"], dtype=dtype)
        sd = unet.init_params(model, seed)
        sd.update({k: torch.from_numpy(np.random.default_rng([seed, 1, i]).uniform(
            0.5, 1.5, v.shape).astype(np.float32)) for i, (k, v) in enumerate(sd.items())
            if ".norms." in k and k.endswith("weight")})
        if fault:                       # the transposed kernels without flax's flip
            sd = {k: v.flip(2, 3) if k.startswith("ups.") and k.endswith("weight") else v
                  for k, v in sd.items()}
        model.load_state_dict(sd)
        return model

    log(f"U-Net gate, seed {seed}: {size} px, batch {B}, widths {cfg['features']}")
    return image_gate("U-Net", "unflipped transposed kernels", build, _unet_loss, x, y, device,
                      [(torch.float32, UNET_TOL["float32"], True),
                       (torch.bfloat16, UNET_TOL["bfloat16"], True)], gate)


def run_unet(seed: int, card: str, wd: str, cfg: dict | None = None,
             device: str = "cuda", gate: bool = True) -> dict:
    """Phase 17: the gate, then the port's ``unet_segmentation.py`` through
    ``TPUCluster.run`` at the default widths, ``batch_size`` x
    ``image_size``: finite losses, IoU read; images/s and FLOP share."""
    import torch

    from tensorflowonspark_tpu_torch.cluster import InputMode, TPUCluster
    from tensorflowonspark_tpu_torch.examples.segmentation import unet_segmentation as us
    from tensorflowonspark_tpu_torch.models import unet

    cfg = cfg or UNET
    gate = check_unet(seed, card, cfg, device, gate)
    size = cfg["image_size"]
    args = argparse.Namespace(cluster_size=1, batch_size=cfg["batch_size"], steps=cfg["steps"],
                              lr=cfg["lr"], image_size=size, num_samples=cfg["num_samples"],
                              features=",".join(map(str, cfg["features"])), seed=seed,
                              data_dir="", model_dir="", cpu=device == "cpu", device=device)
    t0 = time.perf_counter()
    cluster = TPUCluster.run(us.main_fun, args, 1, input_mode=InputMode.TENSORFLOW,
                             reservation_timeout=600, working_dir=os.path.join(wd, "unet"))
    cluster.shutdown(timeout=900)
    wall = time.perf_counter() - t0
    with open(os.path.join(cluster.working_dir, "unet_stats.0.json")) as f:
        st = json.load(f)
    if len(st["losses"]) != cfg["steps"] or not all(map(math.isfinite, st["losses"])):
        raise SystemExit(f"U-Net example losses: {st['losses']}")
    flops = 3 * 2 * conv_macs(unet.UNet(2, cfg["features"]), torch.zeros(1, 3, size, size))
    steady = statistics.median(st["step_ms"][1:])
    ips = cfg["batch_size"] / steady * 1e3
    share = flops * ips / H100_BF16_FLOPS
    log(f"U-Net example through TPUCluster.run on {card}: {cfg['steps']} steps of "
        f"{cfg['batch_size']} x {size} px, widths {cfg['features']}, {wall:.1f} s wall; losses "
        f"{[round(x, 4) for x in st['losses']]}, IoU {[round(x, 3) for x in st['iou']]}; "
        f"median step {steady:.2f} ms over steps 2..{cfg['steps']} = {ips:.1f} images/s; "
        f"{flops / 1e9:.1f} GFLOP an image (train) = {share:.4f} of 989 TFLOP/s; peak memory "
        f"{(st['peak_bytes'] or 0) / 1e6:,.0f} MB")
    return {"gate": gate, "images_per_s": ips, "step_ms": steady, "flop_share": share,
            "peak_MB": (st["peak_bytes"] or 0) / 1e6}


#: phase 18: BERT-base sequence classification, remat on, the flash
#: kernels, AdamW at bert_squad.py's rate; the gate is :data:`TRAIN_TOL`
#: against a plain-attention replay; remat's gradients against no remat's
#: from the same generator: max ||g - g_no_remat|| / ||g_no_remat||
#: (:data:`REMAT_TOL`; a recomputation on fresh dropout masks, the planted
#: fault, must fall outside both)
BERT_CLS = {"seq_len": 128, "batch_size": 32, "num_classes": 3, "steps": 8,
            "no_remat_steps": 4}
REMAT_TOL = 1e-3


def _naive_remat(block, x, train, rng, **kwargs):
    """The planted fault: checkpointing on the live generator, so the
    recomputation draws fresh dropout masks."""
    import torch

    return torch.utils.checkpoint.checkpoint(
        lambda t: block(t, train=train, rng=rng, **kwargs), x, use_reentrant=False)


def bert_cls_batches(seed: int, cfg: dict, vocab: int, n: int):
    """``n`` classification batches ``(ids, mask, types, labels)`` of
    ``batch_size`` x ``seq_len``, lengths from half to all of ``seq_len``."""
    import numpy as np

    rng = np.random.default_rng([seed, 18])
    B, T = cfg["batch_size"], cfg["seq_len"]
    out = []
    for _ in range(n):
        lens = rng.integers(T // 2, T + 1, B)
        mask = np.arange(T)[None, :] < lens[:, None]
        ids = np.where(mask, rng.integers(1, vocab, (B, T)), 0)
        types = (np.arange(T)[None, :] >= lens[:, None] // 2).astype(np.int64) * mask
        out.append((ids.astype(np.int64), mask, types, rng.integers(0, cfg["num_classes"], B)))
    return out


def run_bert_cls(seed: int, card: str, cfg: dict | None = None, width: dict | None = None,
                 device: str = "cuda", gate: bool = True) -> dict:
    """Phase 18: BERT-base ``BertForSequenceClassification`` (``width``:
    the BERT-base config) with ``remat=True``, dropout 0.1, AdamW, trained
    ``steps`` steps through the strategy with the flash kernels (K1 12
    times a step and 12 more in the recomputation, K2 and K3 12 times);
    every loss and the final weights against a plain-attention replay
    (:data:`TRAIN_TOL`), where a remat on fresh masks must fall outside;
    remat's gradients against no remat's (:data:`REMAT_TOL`); step time and
    peak memory with and without remat."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from tensorflowonspark_tpu_torch import bert_inference as bi
    from tensorflowonspark_tpu_torch import bert_train as bt
    from tensorflowonspark_tpu_torch.models import bert
    from tensorflowonspark_tpu_torch.ops.flash_attention import flash_attention as flash
    from tensorflowonspark_tpu_torch.parallel import DataParallelStrategy

    cfg = cfg or BERT_CLS
    width = width or bi.BERT_BASE
    dev = torch.device(device)
    width = {k: v for k, v in width.items() if k != "dtype"}
    base = bert.BertConfig(**width, dropout_rate=TRAIN_DROPOUT, dtype=torch.bfloat16,
                           attention_fn=flash, remat=True)
    layers, steps = base.num_layers, cfg["steps"]
    sd = bert.init_params(base, seed, num_classes=cfg["num_classes"])
    batches = [tuple(torch.from_numpy(a).to(dev) for a in b)
               for b in bert_cls_batches(seed, cfg, base.vocab_size, steps)]

    def loss_fn(model, batch, rng=None):
        ids, mask, types, labels = batch
        return F.cross_entropy(model(ids, mask, types, train=True, rng=rng), labels)

    def train(attention, n=steps, remat=True):
        held = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        c = dataclasses.replace(base, attention_fn=attention, remat=remat)
        model = bert.BertForSequenceClassification(c, cfg["num_classes"])
        model.load_state_dict(sd)
        strategy = DataParallelStrategy(dev, seed=seed)
        state = strategy.init_state(model, bt.adamw(TRAIN_LR))
        w0 = {k: v.detach().clone() for k, v in state.module.state_dict().items()}
        step = strategy.build_train_step(loss_fn)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        for b in batches[:n]:
            t0 = time.perf_counter()
            state, metrics = step(state, b)
            losses.append(float(metrics["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = ((torch.cuda.max_memory_allocated() - held) / 1e6 if dev.type == "cuda"
                else None)
        return losses, ms, peak, state.module.state_dict(), w0

    zero_launch_counts()                   # counts start at 0 for the main path
    losses, ms, peak, w, w0 = train(flash)
    launches = bt.kernel_launches()
    want = {"flash_attention_fwd": 2 * layers * steps, "flash_attention_dq": layers * steps,
            "flash_attention_dkv": layers * steps}
    _, nr_ms, nr_peak, _, _ = train(flash, cfg["no_remat_steps"], remat=False)
    T, B = cfg["seq_len"], cfg["batch_size"]
    med, nr_med = statistics.median(ms[1:]), statistics.median(nr_ms[1:])
    log(f"BERT-base classification (T {T}, batch {B}, {cfg['num_classes']} classes, remat, "
        f"dropout {TRAIN_DROPOUT}, AdamW) on {card}: launches {launches} (expected {want}: "
        f"K1 once in the forward and once in the recomputation a layer); losses "
        f"{[round(x, 5) for x in losses]}; median step {med:.2f} ms, peak memory "
        f"{peak or 0:,.0f} MB; without remat {nr_med:.2f} ms, {nr_peak or 0:,.0f} MB "
        f"(steps 2..{cfg['no_remat_steps']})")
    if device == "cuda" and launches != want:
        raise SystemExit("the BERT classification path did not go through each kernel "
                         "once a layer and step (K1 also in the recomputation)")
    if not all(map(math.isfinite, losses)):
        raise SystemExit(f"non-finite BERT classification loss: {losses}")

    plain, _, _, w_plain, _ = train(attention_fn("plain", "plain"))
    keys = {n for n in w_plain if n.endswith("attn.key.bias")}
    saved = bert._remat
    bert._remat = _naive_remat
    try:
        f_losses, _, _, w_fault, _ = train(flash)
    finally:
        bert._remat = saved
    verdicts, out = {}, {"launches": launches, "step_ms": med, "peak_MB": peak,
                         "no_remat_step_ms": nr_med, "no_remat_peak_MB": nr_peak}
    for name, (ls, ww) in (("kernels, remat", (losses, w)),
                           ("kernels, remat on fresh masks (planted fault)", (f_losses, w_fault))):
        r = weight_readings(ww, w_plain, w0, zero=keys, lr_steps=TRAIN_LR * steps)
        r["loss"] = max(abs(a - b) for a, b in zip(ls, plain))
        verdicts[name] = within(r, TRAIN_TOL)
        out[name] = r
        log(f"BERT classification, {name} vs the plain-attention replay: loss {r['loss']:.4g}; "
            f"weights max {r['max']:.4g} ({r['worst']}), median {r['median']:.4g}; key "
            f"biases {r['noise']:.3g} x lr x steps")

    # remat's gradients against no remat's, one batch, the same generator
    def grads(remat_fn, remat=True):
        bert._remat = remat_fn
        try:
            c = dataclasses.replace(base, remat=remat)
            model = bert.BertForSequenceClassification(c, cfg["num_classes"]).to(dev)
            model.load_state_dict(sd)
            gen = torch.Generator(device=dev).manual_seed(seed)
            loss_fn(model, batches[0], gen).backward()
            return {n: p.grad for n, p in model.named_parameters()}
        finally:
            bert._remat = saved

    ref = grads(saved, remat=False)
    for name, fn in (("remat", saved), ("remat on fresh masks (planted fault)", _naive_remat)):
        g = grads(fn)
        rel = max(((g[n] - r).norm() / r.norm()).item() for n, r in ref.items()
                  if n not in keys and r.norm() > 0)
        verdicts[f"gradients, {name}"] = rel <= REMAT_TOL
        log(f"BERT classification gradients, {name} vs no remat (same generator): max "
            f"||g - g_no_remat|| / ||g_no_remat|| {rel:.3g} (gate {REMAT_TOL})")
    _gate(gate, "BERT classification", TRAIN_TOL, verdicts)
    return out


def run_new_models(seed: int, card: str, wd: str, gate: bool = True, examples: bool = True,
                   phase_s: dict | None = None) -> dict:
    """Phases 15-18 (the other models), each timed into ``phase_s``; with
    ``examples=False`` only the gates (the calibration's later seeds)."""
    import torch

    from tensorflowonspark_tpu_torch import bench_embedding

    phase_s = {} if phase_s is None else phase_s
    out = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        r = fn(*a, **kw)
        phase_s[name] = time.perf_counter() - t0
        log(f"phase {name}: {phase_s[name]:.1f} s")
        torch.cuda.empty_cache()
        return r

    out["wide_deep"] = timed("15 Wide&Deep dense", run_wide_deep, seed, card, wd, gate=gate)
    out["sparse"] = timed("15 Wide&Deep sparse", run_sparse_criteo, seed, card, gate=gate)
    if examples:
        t0 = time.perf_counter()
        print(json.dumps(bench_embedding.bench(seed=seed)), flush=True)
        phase_s["15 embedding bench"] = time.perf_counter() - t0
        out["inception"] = timed("16 Inception-v3", run_inception, seed, card, wd, gate=gate)
        out["unet"] = timed("17 U-Net", run_unet, seed, card, wd, gate=gate)
    else:
        timed("16 Inception-v3 gate", check_inception, seed, card, gate=gate)
        timed("17 U-Net gate", check_unet, seed, card, gate=gate)
    out["bert_cls"] = timed("18 BERT classification", run_bert_cls, seed, card, gate=gate)
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0, help="weights and data seed")
    p.add_argument("--calibrate-resnet", action="store_true",
                   help="only log the ResNet-50 gate's readings at the scales of "
                        "RESNET_CALIBRATION_SCALES, batches 8 and 2, and exit (no result)")
    p.add_argument("--calibrate-slice9", action="store_true",
                   help="only build the kernels and log the gates of phases 15-18 at seeds "
                        "--seed..--seed+2 (the examples and benches at --seed), and exit "
                        "(no result)")
    p.add_argument("--calibrate-serving", action="store_true",
                   help="only build the kernels, train phase 13's model at seeds "
                        "--seed..--seed+2 and log phase 19's readings on each (the bf16 tie "
                        "margins among them), and exit (no result)")
    p.add_argument("--calibrate-continual", action="store_true",
                   help="only build the kernels, train phase 13's model at seeds "
                        "--seed..--seed+2 and log phase 23b's offline-gate readings on each, "
                        "and exit (no result)")
    p.add_argument("--calibrate-long-context", action="store_true",
                   help="only build the kernels and log phase 24's gate readings (the sound "
                        "arms, the planted faults, Ulysses over the plain versions) at seeds "
                        "--seed..--seed+2, and exit (no result)")
    p.add_argument("--calibrate-parallel", action="store_true",
                   help="only build the kernels and log phase 25's gate readings (the sound "
                        "arms and the planted faults) at seeds --seed..--seed+2, and exit "
                        "(no result)")
    p.add_argument("--calibrate-sharded", action="store_true",
                   help="only build the kernels, train phase 13's model at --seed, run phase "
                        "19's schedule solo and log phase 26's readings (26a and 26b, the "
                        "planted faults) at phase 19's whole budgets, and exit (no result)")
    p.add_argument("--calibrate-gpt", action="store_true",
                   help="only build the kernels and log phase 13's and 13b's gate readings "
                        "at seeds --seed..--seed+2, at GPT_LR and at gpt_tiny's own rate "
                        "(GPT_TINY_LR), and exit (no result)")
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs a CUDA card", file=sys.stderr)
        return 2
    try:
        from tensorflowonspark_tpu_torch.ops.flash_attention import build_kernels
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        return 2
    from tensorflowonspark_tpu_torch.util import strict_matmul_precision

    strict_matmul_precision()
    if args.calibrate_resnet:
        for batch in (RESNET_GATE_BATCH, 2):
            for scales in RESNET_CALIBRATION_SCALES:
                check_resnet_grads(args.seed, batch, scales, gate=False)
        return 0

    from tensorflowonspark_tpu_torch.device_info import card_name_and_limit

    if args.calibrate_gpt:
        build_kernels()
        card = card_name_and_limit()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as wd:
            for lr in (GPT_LR, GPT_TINY_LR):
                for seed in range(args.seed, args.seed + 3):
                    for variant in (None, LLAMA_VARIANT):
                        t0 = time.perf_counter()
                        del run_gpt_training(seed, card, wd, variant, gate=False,
                                             lr=lr)["params"]
                        log(f"calibration Adam {lr:g} seed {seed} "
                            f"{'llama' if variant else 'gpt2'}: {time.perf_counter() - t0:.1f} s")
        return 0

    if args.calibrate_long_context:
        build_kernels()
        card = card_name_and_limit()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as wd:
            for seed in range(args.seed, args.seed + 3):
                t0 = time.perf_counter()
                run_long_context(seed, card, wd, gate=False, arms=LONG_CONTEXT_CALIBRATION_ARMS)
                log(f"calibration seed {seed}: {time.perf_counter() - t0:.1f} s")
        return 0

    if args.calibrate_parallel:
        build_kernels()
        card = card_name_and_limit()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as wd:
            for seed in range(args.seed, args.seed + 3):
                t0 = time.perf_counter()
                run_parallel_training(seed, card, wd, gate=False)
                log(f"calibration seed {seed}: {time.perf_counter() - t0:.1f} s")
        return 0

    if args.calibrate_serving:
        build_kernels()
        card = card_name_and_limit()
        from tensorflowonspark_tpu_torch.examples.gpt import gpt_tiny

        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as wd:
            for seed in range(args.seed, args.seed + 3):
                t0 = time.perf_counter()
                out = gpt_tiny.train(gpt_args(seed, os.path.join(wd, f"gpt_{seed}")),
                                     torch.device("cuda"))
                check_serving(seed, card, out, gate=False)
                del out
                torch.cuda.empty_cache()
                log(f"calibration seed {seed}: {time.perf_counter() - t0:.1f} s")
        return 0

    if args.calibrate_sharded:
        build_kernels()
        card = card_name_and_limit()
        from tensorflowonspark_tpu_torch.examples.gpt import gpt_tiny

        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as wd:
            t0 = time.perf_counter()
            out = gpt_tiny.train(gpt_args(args.seed, os.path.join(wd, "gpt")),
                                 torch.device("cuda"))
            main, _ = serving_schedules(args.seed, out["cfg"].vocab_size)
            solo = solo_streams(serving_config(out), out["params"], main)
            log(f"calibration: phase 13's model and phase 19's solo streams in "
                f"{time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            run_sharded_serving(args.seed, card, wd, out, {"main": main, "solo": solo},
                                gate=False, max_new=None)
            log(f"calibration seed {args.seed}: phase 26 in {time.perf_counter() - t0:.1f} s")
        return 0

    if args.calibrate_continual:
        build_kernels()
        from tensorflowonspark_tpu_torch.examples.gpt import gpt_tiny

        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as wd:
            for seed in range(args.seed, args.seed + 3):
                t0 = time.perf_counter()
                out = gpt_tiny.train(gpt_args(seed, os.path.join(wd, f"gpt_{seed}")),
                                     torch.device("cuda"))
                continual_readings(seed, out, wd)
                del out
                torch.cuda.empty_cache()
                log(f"calibration seed {seed}: {time.perf_counter() - t0:.1f} s")
        return 0

    if args.calibrate_slice9:
        build_kernels()
        card = card_name_and_limit()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as wd:
            for seed in range(args.seed, args.seed + 3):
                t0 = time.perf_counter()
                run_new_models(seed, card, wd, gate=False, examples=seed == args.seed)
                log(f"calibration seed {seed}: {time.perf_counter() - t0:.1f} s")
        return 0

    t_start = time.perf_counter()
    # 1. device
    kind = torch.cuda.get_device_name(0)
    card = card_name_and_limit()
    log(f"device: {kind}; nvidia-smi: {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; count {torch.cuda.device_count()}")

    # 2. build, every source at once
    t0 = time.perf_counter()
    libs = build_kernels()
    log(f"build: {', '.join(os.path.relpath(p) for p in libs.values())} in "
        f"{time.perf_counter() - t0:.1f} s")
    for so in libs.values():
        with open(so[:-3] + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line or "Compiling" in line:
                    log("  ptxas: " + line.strip())
    sass = check_sass(libs)
    from tensorflowonspark_tpu_torch import tfrecord

    t0 = time.perf_counter()
    codec = tfrecord.build_native()               # raises if g++ fails: no Python fallback
    if tfrecord._native() is None:
        raise SystemExit("the native TFRecord codec did not load")
    log(f"build: {os.path.relpath(codec)} (g++) in {time.perf_counter() - t0:.1f} s")

    # 3. kernels against their plain versions, and their times
    flash = check_flash(args.seed)
    log(f"flash_attention_fwd at {flash['shape']} on {card}: kernel "
        f"{flash['ms']:.6f} ms, SDPA {flash['library_ms']:.6f} ms (in turns), plain "
        f"{flash['plain_ms']:.6f} ms, bound {flash['bound_ms']:.6f} ms "
        f"({flash['bound_by']}), {flash['achieved_tflops']:.2f} TFLOP/s")
    dq, dkv = check_flash_bwd(args.seed)
    for e in (dq, dkv):
        log(f"{e['name']} at {e['shape']} on {card}: kernel {e['ms']:.6f} ms, plain "
            f"{e['plain_ms']:.6f} ms, bound "
            f"{e['bound_ms']:.6f} ms ({e['bound_by']}), {e['achieved_tflops']:.2f} TFLOP/s")
    log(f"backward at {dq['shape']} on {card}: dq + dkv kernels {dq['ms'] + dkv['ms']:.6f} ms, "
        f"SDPA backward {dq['library_ms']:.6f} ms (in turns), plain "
        f"{dq['plain_ms'] + dkv['plain_ms']:.6f} ms")
    for shape in ("gpt_shape", "bert_shape", "ulysses_shape", "pipeline_shape"):
        for e in (flash, dq, dkv):
            b = e[shape]
            log(f"{e['name']} at {b['shape']} on {card}: kernel {b['ms']:.6f} ms, SDPA "
                f"{b['library_ms']:.6f} ms (in turns), plain {b['plain_ms']:.6f} ms, bound "
                f"{b['bound_ms']:.6f} ms ({b['bound_by']}), {b['achieved_tflops']:.2f} TFLOP/s")
        log(f"backward at {dq[shape]['shape']} on {card}: dq + dkv kernels "
            f"{dq[shape]['ms'] + dkv[shape]['ms']:.6f} ms, SDPA backward "
            f"{dq[shape]['library_ms']:.6f} ms (in turns)")
    for e in (flash, dq, dkv):
        log(f"{e['name']}: host {e['host_us']:.1f} us a call (wrapper, no sync)")
    for e, kernel in ((flash, "flash_fwd_tma_kernel<64"), (dq, "flash_dq_tma_kernel<64"),
                      (dkv, "flash_dkv_tma_kernel<64")):
        e["sass"] = next(c for k, c in sass.items() if k.startswith(kernel))
    padded = time_padded_head_dims(args.seed)
    for D, t in padded.items():
        log(f"head dim {D} (padded to {t['padded_to']}) at B=16 T={SEQ_LEN} H=12 bf16 on "
            f"{card}, in turns: forward {t['fwd']:.6f} ms vs SDPA {t['sdpa_fwd']:.6f} ms; "
            f"dq + dkv {t['bwd']:.6f} ms vs SDPA backward {t['sdpa_bwd']:.6f} ms")
    flash["padded_head_dims"] = padded

    phase_s = {"1-3 device, build, kernels": time.perf_counter() - t_start}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t0
        log(f"phase {name}: {phase_s[name]:.1f} s")
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as wd:
        # 4. model gradients through the kernels against the plain versions
        timed("4 model gradients", check_model_grads, args.seed)

        # 5. the inference main path (forward kernel only)
        inference = timed("5 inference", run_main_path, args.seed, card, ROWS, BATCH_SIZE)

        # 6. the training main path (all three kernels), checkpoint and export
        training, weights, replay = timed("6 training", run_training_path, args.seed, card, wd)

        # 6b. serving from the training path's export (K1 inside the program)
        export_serving = timed("6b export serving", run_export_serving, args.seed, card, wd,
                               weights)
        del weights

        # 7. ResNet-50 on the card against the port's CPU path
        timed("7 ResNet-50 gradients", check_resnet_grads, args.seed)

        # 8. ResNet-50 from TFRecords with a resume (TENSORFLOW mode, no kernel of the repo)
        resnet = timed("8 ResNet-50 training", run_resnet_training, args.seed, card, wd)

        # 9. MNIST from TFRecords, with its exports (SPARK mode, no kernel of the repo)
        mnist = timed("9 MNIST", run_mnist_training, args.seed, card, wd)

        # 11. BASELINE config 3 through the pipeline: TFEstimator.fit -> TFModel.transform
        pipeline = timed("11 pipeline", run_pipeline_path, args.seed, card, wd, replay)
        del replay

        # 12. the Estimator under run_with_recovery, one lost worker
        recovery = timed("12 recovery", run_estimator_recovery, args.seed, card, wd)

        # 13. the decoder: gpt_tiny's flow at GPT-124M width, the kernels causal
        gpt_train = timed("13 GPT training", run_gpt_training, args.seed, card, wd)

        # 13b. the llama-class variant (RoPE, RMSNorm, SwiGLU, GQA, a window), 4 layers
        llama = timed("13b llama training", run_gpt_training, args.seed, card, wd,
                      LLAMA_VARIANT)
        del llama["params"]

        # 14. generation, int8 weights and the int8 export on phase 13's weights
        generation = timed("14 generation", check_gpt_generation, args.seed, card, wd,
                           gpt_train)

        from tensorflowonspark_tpu_torch import bench_gpt_decode

        t0 = time.perf_counter()
        # one timed decode of 64 tokens a row after the warm-up (the module's
        # defaults are 3 of 128): cut for time
        print(json.dumps(bench_gpt_decode.bench(seed=args.seed, new_tokens=64, iters=1)),
              flush=True)
        phase_s["14 decode bench"] = time.perf_counter() - t0

        # 15-18. the other models: Wide&Deep at Criteo scale, Inception-v3,
        # U-Net, BERT classification with remat through the kernels
        t0 = time.perf_counter()
        new_models = run_new_models(args.seed, card, wd, phase_s=phase_s)
        phase_s["15-18 total"] = time.perf_counter() - t0
        torch.cuda.empty_cache()

        # 19. the serving engine on phase 13's weights: float32 exact, bf16 tie-aware
        serving = timed("19 serving engine", check_serving, args.seed, card, gpt_train)
        torch.cuda.empty_cache()

        # 20. the cluster path: cluster.inference into a worker hosting the batcher
        cluster_serving = timed("20 cluster serving", run_cluster_serving, args.seed, card, wd)
        from tensorflowonspark_tpu_torch import bench_batcher

        t0 = time.perf_counter()
        # 8 requests (the module's default is 16): cut for time
        print(json.dumps(bench_batcher.bench(seed=args.seed, n_req=8)), flush=True)
        phase_s["19-20 batcher bench"] = time.perf_counter() - t0
        torch.cuda.empty_cache()

        # 21. the online tier on phase 13's weights: replicas and a warm
        # standby behind the TCP frontend, their sites captured, one killed
        serving_tier = timed("21 serving tier", run_serving_tier, args.seed, card, wd, gpt_train)

        # 22. the rest of the tier on phase 13's weights: the registry, a
        # canary rollout, the autoscaler, a driver crash resumed from the
        # journal (tier A); disaggregated prefill/decode pools (tier B)
        rest_of_tier = timed("22 rollout and disagg tiers", run_rest_of_tier, args.seed, card,
                             wd, gpt_train, serving_tier)
        torch.cuda.empty_cache()
        continual = rest_of_tier["rollout"]["continual"]
        phase_s["23b continual loop (in 22)"] = rest_of_tier["rollout"]["continual_s"]

        # 23a. the batch plane: phase 6's BERT-base QA through a BatchJob whose
        # worker is killed and relaunched (23b ran on phase 22's tier A)
        batch_plane = timed("23a batch plane", run_batch_plane, args.seed, card, wd)
        batch_and_continual = {k: batch_plane[k] + continual["launches"]["trainer"][k]
                               + continual["launches"]["eval"][k] for k in KERNEL_NAMES}
        torch.cuda.empty_cache()

        # 24. sequence parallelism through the reference's front door: a host
        # agent, TFCluster.run(None, ...) and two workers training the
        # long-context LM at BERT-base width over sp = 2 (Ulysses and ring)
        long_context = timed("24 long context", run_long_context, args.seed, card, wd)
        torch.cuda.empty_cache()

        with host_agent(os.path.join(wd, "agent_logs")) as agent:
            # 25. pipeline and expert parallelism: two workers train GPT-124M
            # over pp = 2 (GPipe and 1F1B, K1-K3 inside the stages) and
            # Switch-Base-8 over ep = 2
            parallel = timed("25 pipeline and expert parallelism", run_parallel_training,
                             args.seed, card, wd, agent)
            torch.cuda.empty_cache()

            # 26. mesh-sharded serving: a tp 2 gang of phase 13's GPT-124M
            # through the batcher (26a, on the agent), then two gangs behind
            # ServingCluster.run(mesh=...) with a member killed (26b)
            sharded = timed("26 sharded serving", run_sharded_serving, args.seed, card, wd,
                            gpt_train, serving, agent)
        del gpt_train["params"]
        torch.cuda.empty_cache()

    # 10. the bench
    from tensorflowonspark_tpu_torch import bench_resnet

    t0 = time.perf_counter()
    print(json.dumps(bench_resnet.bench(seed=args.seed)), flush=True)
    phase_s["10 bench"] = time.perf_counter() - t0

    flash["launches"] = new_models["bert_cls"]["launches"]["flash_attention_fwd"]
    flash["launches_by_path"] = {"inference": inference,
                                 "training": training["flash_attention_fwd"],
                                 "export_serving": export_serving,
                                 "pipeline_transform": pipeline["transform"]}
    for e in (dq, dkv):
        e["launches"] = new_models["bert_cls"]["launches"][e["name"]]
        e["launches_by_path"] = {"training": training[e["name"]]}
    for e in (flash, dq, dkv):
        e["launches_by_path"].update({"resnet_training": resnet[e["name"]],
                                      "mnist_training": mnist[e["name"]],
                                      "pipeline_training": pipeline["fit"][e["name"]],
                                      "estimator_recovery": recovery[e["name"]],
                                      "gpt_training": gpt_train["launches"][e["name"]],
                                      "llama_training": llama["launches"][e["name"]],
                                      "gpt_generation": generation[e["name"]],
                                      "serving_engine": serving[e["name"]],
                                      "cluster_serving": cluster_serving[e["name"]],
                                      "serving_tier": serving_tier[e["name"]],
                                      "rollout_and_disagg_tiers": rest_of_tier[e["name"]],
                                      "batch_and_continual": batch_and_continual[e["name"]],
                                      "long_context": long_context["launches"][e["name"]],
                                      "pipeline": parallel["launches"][e["name"]],
                                      "sharded_serving": sharded["launches"][e["name"]],
                                      "bert_cls_training":
                                          new_models["bert_cls"]["launches"][e["name"]]})
    log("phase seconds: " + "; ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [flash, dq, dkv]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
