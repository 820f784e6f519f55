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
   (``UTMALDG``) in every bf16 K1 and K3 kernel;
3. kernels: the forward (K1) and the dQ (K2) and dK/dV (K3) backward
   kernels each held against their plain PyTorch versions on the card, at
   the main path's shapes and at edge cases (single TMA tiles, boxes that
   overhang ragged edges, D = 128), then timed beside their bound, their
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
   full-width BERT-base QA for 8 steps (AdamW, dropout 0.1) in one worker;
   each kernel must launch 12 times a step, and every step's loss and the
   chief's final weights must agree with a replay in this process through
   the plain attention (forward and backward) from the same seed, batches
   and generators, where a replay with dK zeroed must not.

The line before the last is the card's name and power limit; the line
before that is the ``{"kernels": [...]}`` summary; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result line,
without a CUDA card or outside a checkout.
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

#: the bf16 K1 and K3 kernels, which must show wgmma and TMA in SASS (at
#: D = 64 and 128 each)
HOPPER_KERNELS = ("flash_fwd_tma_kernel", "flash_dkv_tma_kernel")
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


def gpu_name_and_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


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
    """Every bf16 K1 and K3 kernel must issue wgmma (``HGMMA``) and TMA
    loads (``UTMALDG``) in its SASS; K2 keeps ``mma.sync`` (``HMMA``).
    Returns the counts of each kernel."""
    counts = sass_counts(libs)
    for key, c in sorted(counts.items()):
        log(f"  sass: {key}: HGMMA {c['HGMMA']}, UTMALDG {c['UTMALDG']}, HMMA {c['HMMA']}")
    hopper = {k: c for k, c in counts.items() if k.startswith(HOPPER_KERNELS)}
    missing = [k for k, c in hopper.items() if not (c["HGMMA"] and c["UTMALDG"])]
    if len(hopper) != 2 * len(HOPPER_KERNELS) or missing:
        raise SystemExit(f"the bf16 K1/K3 kernels lack wgmma or TMA in SASS: {missing or hopper}")
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
    ]


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
        out, lse = flash_attention_fwd(q, k, v, mask=mask, causal=causal, window=window)
        torch.cuda.synchronize()
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
        got = flash_attention_bwd(q, k, v, mask, out, lse, g, causal=causal, window=window)
        torch.cuda.synchronize()
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
            {"name": "flash_attention_dq", "replaces": DQ_REPLACES, "design": "mma.sync",
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


def run_training_path(seed: int, card: str) -> dict:
    """Fine-tune full-width BERT-base QA for ``TRAIN_STEPS`` steps through
    the port's cluster; check each kernel launched 12 times a step and
    that every step's loss and the chief's final weights agree with a
    plain-attention replay in this process (:data:`TRAIN_TOL`), and that
    the same gate rejects a replay through the kernels with dK zeroed.
    Returns the worker's launches of each kernel."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch import bert_inference as bi
    from tensorflowonspark_tpu_torch import bert_train as bt
    from tensorflowonspark_tpu_torch.parallel import DataParallelStrategy

    rows = bt.make_train_rows(TRAIN_STEPS * BATCH_SIZE, SEQ_LEN,
                              bi.BERT_BASE["vocab_size"], seed)
    torch.cuda.empty_cache()
    zero_launch_counts()                   # counts start at 0 for the main path
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as wd:
        t0 = time.perf_counter()
        stats, weights = bt.run_training(
            rows, bi.BERT_BASE, seed=seed, batch_size=BATCH_SIZE, steps=TRAIN_STEPS,
            lr=TRAIN_LR, dropout=TRAIN_DROPOUT, num_workers=1, device="cuda",
            working_dir=wd, timeout=600)
        wall = time.perf_counter() - t0
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
        return losses, w0, state.module.state_dict()

    plain, w0, w_plain = replay("reference")
    if any(bt.kernel_launches().values()):
        raise SystemExit("the plain-attention replay launched a kernel")
    readings = {"kernels (worker)": (st["losses"], {n: t.cuda() for n, t in weights.items()})}
    fault_name = "kernels with dK x 0 (planted fault)"
    fault_losses, _, fault_w = replay(attention_fn("kernel", "kernel", dk_scale=0.0))
    readings[fault_name] = (fault_losses, fault_w)
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
    return launches


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


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0, help="weights and data seed")
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

    # 1. device
    kind = torch.cuda.get_device_name(0)
    card = gpu_name_and_limit()
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
    for e, kernel in ((flash, "flash_fwd_tma_kernel<64"), (dkv, "flash_dkv_tma_kernel<64")):
        e["sass"] = next(c for k, c in sass.items() if k.startswith(kernel))

    # 4. model gradients through the kernels against the plain versions
    check_model_grads(args.seed)

    # 5. the inference main path (forward kernel only)
    inference = run_main_path(args.seed, card, ROWS, BATCH_SIZE)

    # 6. the training main path (all three kernels)
    training = run_training_path(args.seed, card)

    flash["launches"] = training["flash_attention_fwd"]
    flash["launches_by_path"] = {"inference": inference,
                                 "training": training["flash_attention_fwd"]}
    for e in (dq, dkv):
        e["launches"] = training[e["name"]]
        e["launches_by_path"] = {"training": training[e["name"]]}
    print(json.dumps({"kernels": [flash, dq, dkv]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
