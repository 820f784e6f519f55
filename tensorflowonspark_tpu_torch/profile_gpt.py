"""Where a GPT training step, or a decode, spends its time on the card.

    python -m tensorflowonspark_tpu_torch.profile_gpt [--seed 0] [--calls 3] [--train]

Without ``--train``: one bf16 greedy decode of ``bench_gpt_decode``'s
config (GPT-124M-class, batch 8, a 128-token prompt, 128 new tokens),
reported per generated token.  With ``--train``: one training step of
``chip_smoke.py``'s phase 13 (the same width, batch 8 at T = 1024 on
``gpt_tiny``'s "+1" corpus, the flash kernels causal, Adam 1e-4), the loss
read back each step.  Either warms up, times ``--calls`` calls with the
profiler off, then traces as many with ``torch.profiler``
(``devtime.profile_calls``): device time by kernel family, the device's
idle share of the traced and of the unprofiled wall, and one JSON line
with the same numbers.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json


def train_step(seed: int, device):
    """One training step at phase 13's shape (forward, backward through
    the flash kernels, Adam), as a callable."""
    import argparse as ap

    import torch

    from tensorflowonspark_tpu_torch.bench_gpt_decode import decode_config
    from tensorflowonspark_tpu_torch.examples.gpt import gpt_tiny
    from tensorflowonspark_tpu_torch.ops import flash_attention
    from tensorflowonspark_tpu_torch.parallel.strategy import adam

    cfg = decode_config(attention_fn=flash_attention)
    model = gpt_tiny.build_model(cfg, seed).to(device)
    opt = adam(1e-4)(model.parameters())
    args = ap.Namespace(vocab=cfg.vocab_size, batch_size=8, seq_len=1024, seed=seed)
    ids = torch.from_numpy(next(gpt_tiny.corpus(args)())["ids"]).long().to(device)

    def run():
        opt.zero_grad(set_to_none=True)
        loss = gpt_tiny.next_token_loss(model, ids)
        loss.backward()
        opt.step()
        float(loss.detach())
    return run


def decode(seed: int, device):
    """One bf16 greedy decode of ``bench_gpt_decode``'s config, as a
    callable (the ids read back to the host)."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.bench_gpt_decode import B, NEW, T0, decode_config
    from tensorflowonspark_tpu_torch.models.gpt import greedy_generate, init_params

    cfg = decode_config()
    params = {n: t.to(device) for n, t in init_params(cfg, seed).items()}
    prompt = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (B, T0))).to(device)
    return lambda: greedy_generate(cfg, params, prompt, NEW).cpu()


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--calls", type=int, default=3)
    p.add_argument("--train", action="store_true",
                   help="profile a training step instead of a decode")
    args = p.parse_args()

    from tensorflowonspark_tpu_torch.bench_gpt_decode import NEW
    from tensorflowonspark_tpu_torch.device_info import card_name_and_limit
    from tensorflowonspark_tpu_torch.devtime import profile_calls
    from tensorflowonspark_tpu_torch.util import resolve_device, strict_matmul_precision

    device = resolve_device("cuda")
    strict_matmul_precision()
    card = card_name_and_limit()
    if args.train:
        print(f"profile_gpt on {card}: training steps of 8 x 1024")
        out = profile_calls(train_step(args.seed, device), args.calls, "training step")
    else:
        print(f"profile_gpt on {card}: greedy decodes of 8 rows, 128 + {NEW} tokens")
        out = profile_calls(decode(args.seed, device), args.calls, "decode")
        out["device_busy_ms_per_token"] = out["device_busy_ms"] / NEW
        out["wall_ms_per_token_unprofiled"] = out["wall_ms_unprofiled"] / NEW
    print(json.dumps({"card": card, "mode": "train" if args.train else "decode", **out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
