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
   the main path's shapes and at edge cases (single TMA tiles, boxes that
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
   measurement, its JSON line printed on a line of its own.

The ResNet and MNIST paths run none of the repo's hand-written kernels
(their convolutions are cuDNN's); the summary's ``launches_by_path`` shows
each kernel's launches on every path.  The line before the last is the
card's name and power limit; the line before that is the ``{"kernels":
[...]}`` summary; the last line is ``{"ok": true, "device": {...}}``.
Exits non-zero, with no result line, without a CUDA card or outside a
checkout.
"""

from __future__ import annotations

import argparse
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
    atol).  The first is the main path's shape: BERT-base at T=384 in
    batches of 16, with ragged key padding and one fully masked row."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    bert_lens = [int(x) for x in rng.integers(192, 385, 16)]
    bert_lens[5] = 0                                   # a fully masked row
    bf16, f32 = torch.bfloat16, torch.float32
    return [
        ("bert_bf16", 16, 384, 384, 12, 64, bf16, bert_lens, False, None, 2e-2),
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

    summary = None
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
        if i > 0:
            continue
        # main path's shape: the kernel and SDPA in turns, the plain version
        # SDPA returns NaN on a fully masked row: give that row its keys back
        sdpa_mask = mask.clone()
        sdpa_mask[lens.index(0)] = True
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kernel = lambda: flash_attention_fwd(q, k, v, mask=mask)  # noqa: E731
        turns = time_in_turns({"kernel": kernel, "sdpa": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=sdpa_mask[:, None, None, :])}, KERNEL_REPS)
        kernel_ms, library_ms = turns["kernel"], turns["sdpa"]
        plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, mask=mask), KERNEL_REPS)
        elt = q.element_size()
        bytes_moved = (3 * B * Tk * H * D * elt + B * Tq * H * D * elt   # q k v in, out
                       + B * H * Tq * 4 + B * Tk)                        # lse out, mask in
        flops = 4 * B * H * Tq * Tk * D            # no causal trim on this path
        summary = {
            "name": "flash_attention_fwd", "route": "cuda", "source": FLASH_SOURCE,
            "replaces": FLASH_REPLACES, "design": HOPPER_DESIGN, "launches": None,
            "max_abs_err": err, "tolerance": atol, "ms": kernel_ms, "plain_ms": plain_ms,
            "host_us": host_us(kernel), "library_timed": "in turns with the kernel",
            **bound(bytes_moved, flops), "library_ms": library_ms,
            "shape": f"B={B} T={Tq} H={H} D={D} bf16",
            "achieved_tflops": flops / (kernel_ms * 1e-3) / 1e12,
        }
    return summary


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

    entries = None
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
        if i > 0:
            continue
        # main path's shape: time each kernel, the plain backward and SDPA's
        delta = (out.float() * g.float()).sum(-1).transpose(1, 2).contiguous()
        sdpa_mask = mask.clone()                     # SDPA: NaN on a fully masked row
        sdpa_mask[lens.index(0)] = True
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=sdpa_mask[:, None, None, :])
        gt = g.transpose(1, 2)
        dq_fn = lambda: flash_attention_dq(q, k, v, mask, g, lse, delta)  # noqa: E731
        dkv_fn = lambda: flash_attention_dkv(q, k, v, mask, g, lse, delta)  # noqa: E731
        turns = time_in_turns({"dq": dq_fn, "dkv": dkv_fn, "sdpa": lambda: torch.autograd.grad(
            sdpa_out, (qt, kt, vt), gt, retain_graph=True)}, KERNEL_REPS)
        dq_ms, dkv_ms, library_ms = turns["dq"], turns["dkv"], turns["sdpa"]
        dq_plain_ms = time_ms(lambda: flash_attention_dq_reference(q, k, v, mask, g, lse,
                                                                   delta), KERNEL_REPS)
        dkv_plain_ms = time_ms(lambda: flash_attention_dkv_reference(q, k, v, mask, g, lse,
                                                                     delta), KERNEL_REPS)
        elt = q.element_size()
        tensor = B * Tq * H * D * elt                # one of q, k, v, dO, dq, dk, dv
        rows = 2 * B * H * Tq * 4 + B * Tk           # lse and delta (f32), the mask
        prod = 2 * B * H * Tq * Tk * D               # one T x T x D product
        shape = f"B={B} T={Tq} H={H} D={D} bf16"
        common = {"route": "cuda", "source": BWD_SOURCE, "launches": None,
                  "tolerance": rel, "tolerance_relative_to": "max |plain gradient|",
                  "library_ms": library_ms, "library_timed": "in turns with both kernels",
                  "shape": shape,
                  "library_note": "scaled_dot_product_attention backward: dq, dk and dv "
                                  "in one call; compare with dq ms + dkv ms"}
        entries = [
            {"name": "flash_attention_dq", "replaces": DQ_REPLACES, "design": HOPPER_DESIGN,
             "max_abs_err": errs["dq"], "ms": dq_ms, "plain_ms": dq_plain_ms,
             "host_us": host_us(dq_fn), **common,
             **bound(5 * tensor + rows, 3 * prod),
             "achieved_tflops": 3 * prod / (dq_ms * 1e-3) / 1e12},
            {"name": "flash_attention_dkv", "replaces": DKV_REPLACES, "design": HOPPER_DESIGN,
             "max_abs_err": max(errs["dk"], errs["dv"]), "ms": dkv_ms,
             "plain_ms": dkv_plain_ms, "host_us": host_us(dkv_fn), **common,
             **bound(6 * tensor + rows, 4 * prod),
             "achieved_tflops": 4 * prod / (dkv_ms * 1e-3) / 1e12},
        ]
    return entries


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
    """A BERT ``attention_fn`` whose forward is K1 (``"kernel"``) or its
    plain version (``"plain"``) and whose backward is K2 + K3 or the plain
    backward.  ``dk_scale`` scales dK: 0 plants a fault (the keys get no
    gradient) that every gradient and weight gate must catch."""
    import torch

    from tensorflowonspark_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_reference, flash_attention_fwd,
        flash_attention_reference)

    forward = {"kernel": flash_attention_fwd, "plain": flash_attention_reference}[fwd]
    backward = {"kernel": flash_attention_bwd, "plain": flash_attention_bwd_reference}[bwd]

    class Attention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, mask):
            out, lse = forward(q, k, v, mask)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.mask = mask
            return out

        @staticmethod
        def backward(ctx, grad_out):
            q, k, v, out, lse = ctx.saved_tensors
            dq, dk, dv = backward(q, k, v, ctx.mask, out, lse, grad_out)
            return dq, dk * dk_scale, dv, None

    return lambda q, k, v, mask=None: Attention.apply(q, k, v, mask)


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


def zero_in_theory(name: str) -> bool:
    """Parameters whose gradient is zero in exact arithmetic and rounding
    noise in bf16: the QA-head bias and the last LayerNorm bias (the
    start/end softmax gradients sum to zero over positions) and the key
    biases (softmax ignores a per-row shift)."""
    return (name in ("qa_head.bias", f"bert.layers.{BERT_LAYERS - 1}.ln_mlp.bias")
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


def zero_launch_counts() -> None:
    from tensorflowonspark_tpu_torch.ops.flash_attention import (flash_attention,
                                                                 flash_attention_bwd)

    flash_attention.launches = 0
    flash_attention_bwd.launches_dq = flash_attention_bwd.launches_dkv = 0


def run_training_path(seed: int, card: str, wd: str) -> tuple[dict, dict]:
    """Fine-tune full-width BERT-base QA for ``TRAIN_STEPS`` steps through
    the port's cluster, checkpointing into ``<wd>/bert_model`` and
    exporting to ``<wd>/bert_export``; check each kernel launched 12 times
    a step and that every step's loss and the checkpoint's final weights
    agree with a plain-attention replay in this process
    (:data:`TRAIN_TOL`), and that the same gate rejects a replay through
    the kernels with dK zeroed; then checkpoint the replay's live state
    (sync and async) and restore it on the CPU bit for bit.  Returns the
    worker's launches of each kernel and the final weights (CPU)."""
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
    return launches, weights


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


def weight_readings(w: dict, w_plain: dict, w0: dict) -> dict:
    """Final weights ``w`` against the replay's ``w_plain`` (both from
    ``w0``) as :data:`TRAIN_TOL` reads them.  A zero-in-theory parameter
    moves by Adam's noise-driven steps in both runs, so it is held only to
    Adam's bound, in units of ``lr x steps``."""
    import numpy as np

    rel = {n: ((w[n] - p).norm() / (p - w0[n]).norm()).item()
           for n, p in w_plain.items() if not zero_in_theory(n)}
    worst = max(rel, key=rel.get)
    return {"max": rel[worst], "worst": worst, "median": float(np.median(list(rel.values()))),
            "params": len(rel),
            "noise": max((w[n] - p).abs().max().item() for n, p in w_plain.items()
                         if zero_in_theory(n)) / (TRAIN_LR * TRAIN_STEPS)}


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
    from tensorflowonspark_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint

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
    fault_dir = os.path.join(wd, "resnet_model_no_momentum")
    save_checkpoint(fault_dir, {**saved, "optim": {**saved["optim"], "state": {}}},
                    step=steps // 2)
    fault_run, fault_w, _ = run("resnet_fault", model_dir=fault_dir)
    fault = resnet_train_readings(first["losses"] + fault_run["losses"], replay, fault_w,
                                  w_replay, w0)
    buffers = [n for n in w_replay if "running" in n]
    unmoved = [n for n in buffers if torch.equal(weights[n], w0[n])]
    log(f"ResNet-50 replay (unbroken, same records): losses {[round(x, 5) for x in replay]}")
    for name, r, ls in (("resumed run", sound, losses),
                        ("resumed without momentum (planted fault)", fault,
                         first["losses"] + fault_run["losses"])):
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


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0, help="weights and data seed")
    p.add_argument("--calibrate-resnet", action="store_true",
                   help="only log the ResNet-50 gate's readings at the scales of "
                        "RESNET_CALIBRATION_SCALES, batches 8 and 2, and exit (no result)")
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

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as wd:
        # 4. model gradients through the kernels against the plain versions
        check_model_grads(args.seed)

        # 5. the inference main path (forward kernel only)
        inference = run_main_path(args.seed, card, ROWS, BATCH_SIZE)

        # 6. the training main path (all three kernels), checkpoint and export
        training, weights = run_training_path(args.seed, card, wd)

        # 6b. serving from the training path's export (K1 inside the program)
        export_serving = run_export_serving(args.seed, card, wd, weights)
        del weights

        # 7. ResNet-50 on the card against the port's CPU path
        check_resnet_grads(args.seed)

        # 8. ResNet-50 from TFRecords with a resume (TENSORFLOW mode, no kernel of the repo)
        resnet = run_resnet_training(args.seed, card, wd)

        # 9. MNIST from TFRecords, with its exports (SPARK mode, no kernel of the repo)
        mnist = run_mnist_training(args.seed, card, wd)

    # 10. the bench
    from tensorflowonspark_tpu_torch import bench_resnet

    print(json.dumps(bench_resnet.bench(seed=args.seed)), flush=True)

    flash["launches"] = training["flash_attention_fwd"]
    flash["launches_by_path"] = {"inference": inference,
                                 "training": training["flash_attention_fwd"],
                                 "export_serving": export_serving}
    for e in (dq, dkv):
        e["launches"] = training[e["name"]]
        e["launches_by_path"] = {"training": training[e["name"]]}
    for e in (flash, dq, dkv):
        e["launches_by_path"].update({"resnet_training": resnet[e["name"]],
                                      "mnist_training": mnist[e["name"]]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [flash, dq, dkv]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
