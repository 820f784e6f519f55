"""Disaggregated prefill/decode: specialized gang pools with KV-page handoff.

Port of ``tensorflowonspark_tpu/serving/disagg.py``.  A pool member is a
single-process replica or, with ``mesh=``, a tensor-parallel gang
(``serving/sharded.py``).  A session's K/V pages cross processes as host
arrays, always UNSHARDED: a prefill gang's leader gathers its members'
heads before the handoff, and every rank of a decode gang verifies the
whole session and seats its own heads.  The decode batcher writes them
into its pool in place, so a captured (CUDA-graph) decode batcher reads
them from the storage its graphs hold.

The JAX package's serving artifacts said it plainly: the decode loop,
not compute, bounds serving throughput
(``bench_artifacts/sharded_serving.json``), and a
long prompt's prefill stalling decode steps is the remaining
head-of-line blocker a unified replica cannot fix (``prefix_serving.
json``: prefill dominates TTFT when it cannot be amortized).  This
module specializes the tier the way every large-scale serving system
converges (DistServe/Splitwise-shaped): **prefill pools** compute a
prompt's KV exactly once and never decode-step; **decode pools** only
ever step; the session moves between them as a first-class **KV-page
transfer** on the existing queue/shm data plane.

Request lifecycle in a disaggregated tier (docs/serving.md has the
picture and the wire schemas):

1. The scheduler routes the prompt (``op="gen"``) to the least-loaded
   PREFILL gang.  Its ``ContinuousBatcher(prefill_only=True)`` admits it
   through the ordinary paged machinery — shared prefix index, chunked
   streaming, batched bucket dispatches — emits the FIRST token back
   immediately (TTFT closes at prefill completion), and exports the
   session: prompt KV pages (per-page content-hashed), first token,
   sampler state.
2. The session rides back to the driver as a ``handoff`` response and is
   dispatched (``op="adopt"``) to the DECODE gang with the fewest
   outstanding requests, tie-broken toward MORE free KV pages.  The
   decode batcher verifies the hashes (corrupt or raced transfers are
   rejected loudly, never seated), imports only the pages its own
   prefix index doesn't already hold, and decode-steps from token two
   on — zero prompt positions recomputed, zero prefill dispatches ever
   issued on a decode gang.
3. Failover stays requeue-once ACROSS the boundary: the adopt hop
   continues the prefill dispatch's attempt, so a prefill gang dying
   mid-prefill or a decode gang dying post-handoff each leave exactly
   one replay (gen → prefill → handoff → adopt), skip-dedup keeping the
   client stream oracle-exact.

Pools scale independently: ``ServingCluster.run(disagg={"prefill": P,
"decode": D}, autoscale={"prefill": {...}, "decode": {...}})`` runs one
role-filtered autoscaler per pool — TTFT-p95/prompt-queue pressure
drives prefill, handoff-queue depth + outstanding drives decode (the
device-weighted signals from the gang tier apply per pool unchanged).

This module owns the role arithmetic shared by the driver and every
worker; the engine halves live in ``models/serving.py``
(``prefill_only`` / ``adopt_session``) and ``models/kv_pages.py``
(``KVPagePool.adopt``), the routing in ``serving/scheduler.py``.
"""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)

#: the two pool specializations a disaggregated tier runs
ROLES = ("prefill", "decode")


def validate_disagg(disagg: dict) -> dict:
    """Normalize + validate a ``disagg=`` spec: at least one gang per
    pool (a tier missing either pool could never complete a request),
    only known keys (typo'd pool names must not silently boot a
    half-configured tier)."""
    spec = dict(disagg)
    known = set(ROLES) | {f"{r}_kwargs" for r in ROLES}
    unknown = set(spec) - known
    if unknown:
        raise ValueError(f"unknown disagg key(s) {sorted(unknown)}; "
                         f"valid keys: {sorted(known)}")
    p, d = int(spec.get("prefill", 0)), int(spec.get("decode", 0))
    if p < 1 or d < 1:
        raise ValueError(
            f"disagg needs at least one gang per pool, got prefill={p} "
            f"decode={d} — a tier missing either pool cannot serve")
    spec["prefill"], spec["decode"] = p, d
    return spec


def role_for_executor(disagg: dict, executor_id: int,
                      gang_size: int = 1) -> str:
    """The pool a worker belongs to: the first ``prefill`` gang blocks
    (contiguous, gang_size-aligned — the scheduler's gang arithmetic)
    are the prefill pool, the rest decode.  Computed identically by the
    driver building the scheduler's role map and by every worker
    picking its serve posture, so the two can never disagree."""
    gang_index = int(executor_id) // max(1, int(gang_size))
    return "prefill" if gang_index < int(disagg["prefill"]) else "decode"


def boot_roles(disagg: dict, gang_size: int = 1) -> dict[int, str]:
    """Leader-eid → role for the founding pools (the scheduler's
    ``roles=`` map)."""
    gsz = max(1, int(gang_size))
    n = int(disagg["prefill"]) + int(disagg["decode"])
    return {i * gsz: role_for_executor(disagg, i * gsz, gsz)
            for i in range(n)}


def serve_disagg_replica(args, ctx) -> None:
    """The disaggregated-tier ``map_fun``: resolve this worker's role
    (``serve_role`` when the driver pinned it — live additions and
    replacements — else positional via :func:`role_for_executor`), then
    delegate to the ordinary replica loop, which specializes on the
    role (``serving/replica.py``: prefill-only batcher + session flush,
    or adopt intake) — a gang's through ``serve_sharded_replica``."""
    role = args.get("serve_role")
    if role is None:
        role = role_for_executor(args["serve_disagg"], ctx.executor_id,
                                 int(args.get("serve_gang_size") or 1))
        args = dict(args, serve_role=role)
    logger.info("disagg worker %d: role %s", ctx.executor_id, role)
    if args.get("serve_mesh"):
        from tensorflowonspark_tpu_torch.serving.sharded import serve_sharded_replica

        serve_sharded_replica(args, ctx)
        return
    from tensorflowonspark_tpu_torch.serving.replica import serve_replica

    serve_replica(args, ctx)
