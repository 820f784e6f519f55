"""Continuous batching against static batching, on one card.

    python -m tensorflowonspark_tpu_torch.bench_batcher [--seed 0] [--profile] [--graphs]

The port's counterpart of ``scripts/tpu_sweep.py::stage_serving`` at its
full-size settings: GPT-124M-class width (vocab 32000, hidden 768, 12
layers, 12 heads, FFN 3072, 1024 positions), bf16 compute on float32
parameters drawn from ``--seed``; 16 requests of 16-token prompts with
budgets of 32-128 tokens, 4 slots.  Every number comes from the batcher's
public counters and the host clock (each drain ends with the tokens read
back, so the card has finished):

- ``steady``: every request queued at once (draining a backlog);
- ``bursty``: waves of 4 requests every 80 steps, landing mid-decode;
- ``blocked``: the steady backlog with ``decode_block_steps`` 16;
- ``spec``: prompt-lookup speculation (k 4) on repetitive prompts, against
  the plain batcher on the same traffic;
- ``static``: arrival-order groups of 4 through ``greedy_generate``, each
  padded to its longest budget.

Per pattern: tokens/s, decode occupancy (useful decode slot-steps over
decode steps x slots), the share of wall time spent admitting (prefill and
row copies), and prefill and decode calls; for ``spec`` the tokens a
verify call commits and the acceptance.  Each batcher first drains a
short warm-up round (admission groups of 1, 2 and 4, with budgets that
take decode blocks of 16, 8 and 4 steps), then each pattern runs once,
timed.  ``--profile``
also traces the batcher's decode step with all 4 slots live
(``devtime.profile_calls``): device ms by kernel family and the idle
share.  ``--graphs`` runs the whole bench twice in one call, eager and
then with every batcher's sites captured as CUDA graphs
(``serving/aot.py``; the warm-up rounds pay the captures), and adds the
captured run's ``aot_stats`` and the card's reserved bytes after it.

Prints one JSON line on stdout (logs go to stderr), with the card's name
and power limit from ``nvidia-smi``.  Raises without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

N_REQ, PROMPT, LO, HI, SLOTS = 16, 16, 32, 128, 4
BLOCK, SPEC_K = 16, 4
PROFILE_CALLS = 20


def log(*a) -> None:
    print("bench_batcher:", *a, file=sys.stderr, flush=True)


def bench(seed: int = 0, cfg=None, device="cuda", n_req: int = N_REQ, prompt_len: int = PROMPT,
          lo: int = LO, hi: int = HI, slots: int = SLOTS, block: int = BLOCK,
          spec_k: int = SPEC_K, profile: bool = False, graphs: bool = False,
          capture=None) -> dict:
    """Run the measurements above; returns the JSON line's dict (with
    ``graphs``: ``{"eager": ..., "captured": ...}``).  ``cfg``, ``device``,
    the sizes and ``capture`` (the cache's test seam) exist to rehearse the
    bench at a tiny size on the CPU; the defaults are the measurement."""
    kw = dict(seed=seed, cfg=cfg, device=device, n_req=n_req, prompt_len=prompt_len, lo=lo,
              hi=hi, slots=slots, block=block, spec_k=spec_k, profile=profile)
    if not graphs:
        return _bench(**kw)
    from tensorflowonspark_tpu_torch.serving.aot import AOTExecutableCache

    eager = _bench(**kw)
    cache = AOTExecutableCache(None, capture=capture)
    captured = _bench(**kw, aot_cache=cache)
    captured["aot_stats"] = cache.stats()
    out = {"eager": eager, "captured": captured, "device": eager["device"],
           "card": eager["card"]}
    for k in ("steady_tps", "bursty_tps", "blocked_tps", "spec_tps", "nospec_tps_same_traffic"):
        out[f"captured_over_eager_{k}"] = captured[k] / eager[k]
    log(f"captured / eager tok/s: steady {out['captured_over_eager_steady_tps']:.3f}, bursty "
        f"{out['captured_over_eager_bursty_tps']:.3f}, spec "
        f"{out['captured_over_eager_spec_tps']:.3f}; aot {captured['aot_stats']}")
    return out


def _bench(seed, cfg, device, n_req, prompt_len, lo, hi, slots, block, spec_k, profile,
           aot_cache=None) -> dict:
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.bench_gpt_decode import decode_config
    from tensorflowonspark_tpu_torch.models import ContinuousBatcher, greedy_generate
    from tensorflowonspark_tpu_torch.models.gpt import init_params
    from tensorflowonspark_tpu_torch.util import resolve_device, strict_matmul_precision

    device = resolve_device(device)
    strict_matmul_precision()
    cfg = cfg or decode_config()
    card = device.type
    if device.type == "cuda":
        from tensorflowonspark_tpu_torch.device_info import card_name_and_limit

        card = card_name_and_limit()
    log(f"card {card}; {n_req} requests, prompt {prompt_len}, budgets {lo}-{hi}, {slots} slots")
    params = {n: t.to(device) for n, t in init_params(cfg, seed).items()}

    def batcher(**kw):
        """A batcher warmed up on groups of 1, 2 and all slots, with budgets
        that take decode blocks of ``block``, ``block // 2`` and ``block //
        4`` steps (with ``aot_cache``: its sites captured)."""
        b = ContinuousBatcher(cfg, params, max_batch=slots, aot_cache=aot_cache, **kw)
        warm = [(0, (reqs[0][0], block + 3))]
        warm += [(block + 4, (p, block // 2 + 1)) for p, _ in reqs[:2]]
        warm += [(2 * block + 8, (p, block // 4 + 1)) for p, _ in reqs[:slots]]
        drain(b, warm, sum(n for _, (_, n) in warm))
        return b

    rng = np.random.default_rng(seed)
    # one shared prompt length: one prefill bucket; the budgets vary
    reqs = [(rng.integers(0, cfg.vocab_size, (prompt_len,)).astype(np.int32),
             int(rng.integers(lo, hi + 1))) for _ in range(n_req)]
    total_tokens = sum(n for _, n in reqs)

    def drain(b, schedule, tokens):
        """Drive ``b`` against ``[(arrive_at_step, request)]``; returns the
        admission seconds and the counter deltas of this drain."""
        admit_s = [0.0]
        orig_admit = b._admit

        def timed_admit():
            t = time.perf_counter()
            try:
                return orig_admit()
            finally:
                admit_s[0] += time.perf_counter() - t

        b._admit = timed_admit
        c0 = (b.prefill_dispatches, b.decode_dispatches, b.decode_steps, b.spec_accepted,
              b.spec_proposed)
        try:
            todo = sorted(schedule, key=lambda x: x[0])
            rids, live, steps = [], set(), 0
            while todo or live:
                while todo and todo[0][0] <= steps:
                    _, (p, n) = todo.pop(0)
                    rid = b.submit(p, n)
                    rids.append(rid)
                    live.add(rid)
                live.difference_update(b.step())
                steps += 1
            b.run()
            # no eos: this drain's requests produce exactly their budgets
            got = sum(len(b.result(r, pop=True)) for r in rids)
            assert got == tokens, (got, tokens)
        finally:
            b._admit = orig_admit
        c1 = (b.prefill_dispatches, b.decode_dispatches, b.decode_steps, b.spec_accepted,
              b.spec_proposed)
        return (steps, admit_s[0], *(y - x for x, y in zip(c0, c1)))

    def measure(b, schedule, label, requests, tokens):
        t0 = time.perf_counter()
        steps, admit_s, prefills, decodes, dsteps, acc, prop = drain(b, schedule, tokens)
        dt = time.perf_counter() - t0
        row = {f"{label}_tps": tokens / dt, f"{label}_steps": steps,
               # each request's FIRST token comes from its prefill, so a
               # budget-n request fills n - 1 decode slot-steps
               f"{label}_occupancy": (tokens - len(requests)) / (dsteps * slots),
               f"{label}_admission_frac": admit_s / dt,
               f"{label}_prefill_dispatches": prefills,
               f"{label}_decode_dispatches": decodes, f"{label}_decode_steps": dsteps}
        log(f"{label}: {tokens / dt:.1f} tok/s, occupancy {row[f'{label}_occupancy']:.3f}, "
            f"{prefills} prefill and {decodes} decode calls ({dsteps} steps), admission "
            f"{admit_s / dt:.3f} of {dt:.3f} s")
        return row, dt, decodes, acc, prop

    result = {"requests": n_req, "prompt": prompt_len, "slots": slots, "budgets": f"{lo}-{hi}",
              "useful_tokens": total_tokens,
              "model": f"gpt {cfg.num_layers}x{cfg.hidden_size} vocab {cfg.vocab_size} "
                       f"{str(cfg.dtype).removeprefix('torch.')}",
              "graphs": aot_cache is not None,
              "device": torch.cuda.get_device_name(device) if device.type == "cuda"
              else "cpu", "card": card}
    b = batcher()
    steady = [(0, r) for r in reqs]
    # waves of `slots` requests every (lo + hi) // 2 steps: past the shortest
    # budget, so short tenants have retired while long ones still decode
    bursty = [((lo + hi) // 2 * (i // slots), r) for i, r in enumerate(reqs)]
    result.update(measure(b, steady, "steady", reqs, total_tokens)[0])
    result.update(measure(b, bursty, "bursty", reqs, total_tokens)[0])
    blocked = batcher(decode_block_steps=block)
    result.update(measure(blocked, steady, "blocked", reqs, total_tokens)[0])
    result["blocked_steps_per_dispatch"] = \
        result["blocked_decode_steps"] / max(result["blocked_decode_dispatches"], 1)
    del blocked

    # speculation on repetitive prompts (4 tokens tiled to the prompt length)
    rng_s = np.random.default_rng(seed + 7)
    rep = [(np.tile(rng_s.integers(0, cfg.vocab_size, (4,)).astype(np.int32),
                    -(-prompt_len // 4))[:prompt_len], int(rng_s.integers(lo, hi + 1)))
           for _ in range(n_req)]
    rep_tokens = sum(n for _, n in rep)
    sched = [(0, r) for r in rep]
    _, dt_spec, disp, acc, prop = measure(batcher(speculative_k=spec_k), sched, "spec", rep,
                                          rep_tokens)
    _, dt_plain, _, _, _ = measure(batcher(), sched, "nospec", rep, rep_tokens)
    result.update({"spec_k": spec_k, "spec_tps": rep_tokens / dt_spec,
                   "nospec_tps_same_traffic": rep_tokens / dt_plain,
                   "spec_speedup": dt_plain / dt_spec,
                   # decode-only, as the occupancy: first tokens come from prefill
                   "spec_tokens_per_dispatch": (rep_tokens - n_req) / max(disp, 1),
                   "spec_acceptance": acc / max(prop, 1)})

    def run_static():
        got = 0
        for i in range(0, n_req, slots):
            group = reqs[i:i + slots]
            n = max(m for _, m in group)
            greedy_generate(cfg, params, np.stack([p for p, _ in group]), n).cpu()
            got += sum(m for _, m in group)
        assert got == total_tokens

    t0 = time.perf_counter()
    run_static()
    dt_static = time.perf_counter() - t0
    # sequential calls: each group's prefill plus max_budget - 1 decode steps
    stat_dispatches = sum(max(m for _, m in reqs[i:i + slots]) for i in range(0, n_req, slots))
    n_groups = -(-n_req // slots)
    result.update({"static_tps": total_tokens / dt_static,
                   "static_occupancy": (total_tokens - n_req)
                   / ((stat_dispatches - n_groups) * slots),
                   "speedup_steady": result["steady_tps"] * dt_static / total_tokens,
                   "speedup_bursty": result["bursty_tps"] * dt_static / total_tokens,
                   "dispatches_continuous": result["steady_steps"]
                   + result["steady_prefill_dispatches"],
                   "dispatches_static": stat_dispatches})
    log(f"static {result['static_tps']:.1f} tok/s, occupancy {result['static_occupancy']:.3f}; "
        f"spec {result['spec_tps']:.1f} tok/s ({result['spec_speedup']:.3f}x the plain batcher, "
        f"{result['spec_tokens_per_dispatch']:.2f} tokens a verify, acceptance "
        f"{result['spec_acceptance']:.3f})")

    if profile:
        from tensorflowonspark_tpu_torch import devtime

        # every slot live for the warm-up, the timed and the traced steps
        budget = 2 * PROFILE_CALLS + 8
        b = batcher()
        for p, _ in reqs[:slots]:
            b.submit(p, budget)
        b.step()                                     # the admission
        result["decode_profile"] = devtime.profile_calls(b.step, PROFILE_CALLS, "decode step")
        log(f"decode step: {result['decode_profile']['wall_ms_unprofiled']:.3f} ms, idle share "
            f"{result['decode_profile']['idle_share_unprofiled']:.3f}")
    if device.type == "cuda":
        result["reserved_bytes"] = torch.cuda.memory_reserved(device)
    return result


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", action="store_true",
                   help="also trace the decode step (device ms by family, idle share)")
    p.add_argument("--graphs", action="store_true",
                   help="run the bench eager and then with the sites captured as CUDA graphs")
    a = p.parse_args()
    print(json.dumps(bench(seed=a.seed, profile=a.profile, graphs=a.graphs)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
