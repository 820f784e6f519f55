"""Tiny GPT: train a causal LM with the estimator, then generate.

Port of ``examples/gpt/gpt_tiny.py``: the decoder family end to end —
``Estimator`` + ``train_and_evaluate`` (Adam, an eval every half of the
budget), TensorBoard curves under ``model_dir``, then KV-cache greedy
generation and prompt-lookup decoding, which must give the greedy tokens.
The corpus is arithmetic-progression rows ``(t, t+1, t+2, ...) mod V``
drawn from ``--seed``: next-token prediction is exactly "+1", so a model
that learns shows it.

Run:

    python -m tensorflowonspark_tpu_torch.examples.gpt.gpt_tiny --cpu --max_steps 60

Besides the reference's flags: ``--seed`` (weights and corpus), the widths
(``--num_layers``, ``--num_heads``, ``--num_kv_heads``,
``--max_position_embeddings``, default ``2 * --seq_len``, and
``--sliding_window``), ``--bf16`` (bf16 compute on float32 parameters),
``--flash`` (the attention runs the CUDA flash kernels, causal, on the
card) and ``--lr`` (Adam's rate, the reference's 3e-3 by default).  :func:`train` is the flow without the generation demo; it returns
every step's loss and time, the eval metrics and the final weights.
"""

import argparse
import os


def model_config(args):
    """The example's ``GPTConfig``: gpt2-class (learned positions,
    LayerNorm, GELU) or llama-class (RoPE, RMSNorm, SwiGLU, grouped-query
    attention), FFN 4x hidden."""
    import torch

    from tensorflowonspark_tpu_torch.models.gpt import GPTConfig
    from tensorflowonspark_tpu_torch.ops import flash_attention

    modern = args.arch == "llama"
    kv_heads = getattr(args, "num_kv_heads", None)
    return GPTConfig(vocab_size=args.vocab, hidden_size=args.hidden,
                     num_layers=getattr(args, "num_layers", 2),
                     num_heads=getattr(args, "num_heads", 4),
                     num_kv_heads=kv_heads or (2 if modern else None),
                     pos_encoding="rope" if modern else "learned",
                     norm="rmsnorm" if modern else "layernorm",
                     mlp="swiglu" if modern else "gelu",
                     intermediate_size=args.hidden * 4,
                     max_position_embeddings=getattr(args, "max_position_embeddings", None)
                     or args.seq_len * 2,
                     sliding_window=getattr(args, "sliding_window", None),
                     dtype=torch.bfloat16 if getattr(args, "bf16", False) else torch.float32,
                     attention_fn=flash_attention if getattr(args, "flash", False) else None)


def corpus(args):
    """``input_fn`` over the "+1" corpus: each call yields 8 batches of
    ``{"ids": [batch_size, seq_len] int32}``, drawn from one generator
    seeded by ``--seed``, so later calls continue the stream."""
    import numpy as np

    rng = np.random.default_rng(getattr(args, "seed", 0))

    def input_fn():
        for _ in range(8):
            start = rng.integers(0, args.vocab, size=(args.batch_size, 1))
            ramp = np.arange(args.seq_len)[None, :]
            yield {"ids": ((start + ramp) % args.vocab).astype(np.int32)}

    return input_fn


def next_token_loss(model, ids, chunked_xent: bool = False, chunk_size: int | None = None):
    """Mean next-token cross-entropy of ``ids`` under ``model``: the
    logits and ``F.cross_entropy``, or ``ops.tied_softmax_xent`` over the
    final hidden states (no ``[B, T, V]`` logits; chunk default V // 2)."""
    import torch.nn.functional as F

    from tensorflowonspark_tpu_torch.ops import tied_softmax_xent

    V = model.cfg.vocab_size
    if chunked_xent:
        h = model.hidden(ids)
        return tied_softmax_xent(h[:, :-1], model.tok_emb.weight, ids[:, 1:],
                                 chunk_size=chunk_size or max(1, V // 2)).mean()
    return F.cross_entropy(model(ids)[:, :-1].reshape(-1, V).float(), ids[:, 1:].reshape(-1))


def build_model(cfg, seed: int, state_dict=None):
    """``GPT(cfg)`` holding ``state_dict`` or weights drawn from ``seed``."""
    import torch

    from tensorflowonspark_tpu_torch.models.gpt import GPT, init_params

    with torch.device("meta"):
        model = GPT(cfg)
    model.load_state_dict(state_dict if state_dict is not None else init_params(cfg, seed),
                          assign=True)
    return model


def train(args, device, cfg=None, state_dict=None) -> dict:
    """``train_and_evaluate`` of the example's model on ``device``.
    Returns ``{"final": last eval metrics, "losses": every train step's
    loss, "batches": every train step's ids (on the device), "eval_batches":
    the count of eval batches, "step_ms": the time from each step's start
    to the next one's (CUDA events on the card, the host clock elsewhere),
    "params": the final state dict, "cfg"}``."""
    import time

    import torch

    from tensorflowonspark_tpu_torch.estimator import (Estimator, EvalSpec, TrainSpec,
                                                       train_and_evaluate)
    from tensorflowonspark_tpu_torch.parallel.strategy import DataParallelStrategy, adam

    cfg = cfg or model_config(args)
    input_fn = corpus(args)
    losses, batches, marks, evals = [], [], [], [0]

    def loss_fn(model, batch):
        ids = batch["ids"].long()
        if not model.training:  # an eval batch (eval runs in eval mode)
            evals[0] += 1
            return next_token_loss(model, ids, args.chunked_xent)
        if device.type == "cuda":
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        else:
            marks.append(time.perf_counter())
        loss = next_token_loss(model, ids, args.chunked_xent)
        losses.append(loss.detach())
        batches.append(ids)
        return loss

    with Estimator(build_model(cfg, getattr(args, "seed", 0), state_dict), loss_fn,
                   adam(getattr(args, "lr", 3e-3)), args.model_dir,
                   strategy=DataParallelStrategy(device),
                   save_every_steps=50) as est:
        final = train_and_evaluate(
            est, TrainSpec(input_fn=input_fn, max_steps=args.max_steps),
            EvalSpec(input_fn=input_fn, steps=2, throttle_steps=max(1, args.max_steps // 2)))
        params = {n: t.detach() for n, t in est.params.items()}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    return {"final": final, "losses": [float(x) for x in losses], "batches": batches,
            "eval_batches": evals[0], "step_ms": step_ms, "params": params, "cfg": cfg}


def main(args):
    import numpy as np

    from tensorflowonspark_tpu_torch.models.gpt import greedy_generate, lookup_generate
    from tensorflowonspark_tpu_torch.util import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    out = train(args, device)
    final, params, cfg = out["final"], out["params"], out["cfg"]
    print(f"gpt_tiny: eval loss {final['loss']:.4f} at step {final['global_step']}", flush=True)

    # generate: prompt [7, 8, 9] should continue 10, 11, ... (the count is
    # clamped to the position table; skipped when nothing fits)
    L = cfg.max_position_embeddings
    n_gen = min(5, L - 3)
    if n_gen < 1:
        print("gpt_tiny: seq_len too small for the generation demo; skipping", flush=True)
    else:
        prompt = (np.arange(3)[None, :] + 7) % args.vocab
        seq = greedy_generate(cfg, params, prompt, n_gen)[0].tolist()
        print(f"gpt_tiny: generated {seq}", flush=True)
        expect = [(7 + i) % args.vocab for i in range(3 + n_gen)]
        acc = np.mean([a == b for a, b in zip(seq, expect)])
        print(f"gpt_tiny: continuation accuracy {acc:.2f}", flush=True)

    # prompt-lookup speculative decoding: the greedy tokens in fewer
    # forwards (the count-up data is as repetitive as text gets); prompt +
    # new + draft_len must fit the position table
    t0 = max(4, args.seq_len // 2)
    new = max(2, args.seq_len // 4)
    dl = L - t0 - new
    if dl < 1:
        print("gpt_tiny: seq_len too small for the speculative-decode demo; skipping",
              flush=True)
    else:
        dl = min(dl, max(2, args.seq_len // 2 - 2))
        longp = (np.arange(t0)[None, :] + 3) % args.vocab
        want = greedy_generate(cfg, params, longp, new)
        got, stats = lookup_generate(cfg, params, longp, new, draft_len=dl, return_stats=True)
        if not bool((got == want).all()):
            raise SystemExit("gpt_tiny: speculative decode differs from greedy")
        print(f"gpt_tiny: speculative decode matched greedy in {stats['forwards']} forwards "
              f"for {new} tokens", flush=True)
    print("gpt_tiny: done", flush=True)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--vocab", type=int, default=32)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--seq_len", type=int, default=16)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--max_steps", type=int, default=60)
    p.add_argument("--arch", choices=["gpt2", "llama"], default="gpt2",
                   help="gpt2 = learned pos + layernorm + gelu; llama = "
                        "rope + rmsnorm + swiglu + grouped-query attention")
    p.add_argument("--chunked_xent", action="store_true",
                   help="train with ops.tied_softmax_xent (no [B,T,V] logits)")
    p.add_argument("--model_dir", default=os.path.join(os.getcwd(), "gpt_tiny_model"))
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--num_heads", type=int, default=4)
    p.add_argument("--num_kv_heads", type=int, default=None)
    p.add_argument("--max_position_embeddings", type=int, default=None)
    p.add_argument("--sliding_window", type=int, default=None)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--flash", action="store_true")
    p.add_argument("--lr", type=float, default=3e-3)
    main(p.parse_args())
