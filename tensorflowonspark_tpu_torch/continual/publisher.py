"""Checkpoint publication: the continual loop's EMIT stage.

Port of ``tensorflowonspark_tpu/continual/publisher.py``.  A training
cluster periodically turns durable checkpoints into REGISTRY CANDIDATES:
the chief's :class:`CheckpointPublisher` hooks off ``CheckpointManager``
saves (``add_save_listener``), flattens the state dict into host numpy
keyed by state-dict names (or diffs it against a pristine base into an
adapter delta), and
enqueues ONE message on its own queue server's ``publish`` queue.  The
driver's :class:`PublicationCollector` drains those queues over the
normal queue/shm/bulk plane — multi-MB weight payloads ride the bulk
tier like any tensor traffic — verifies each message's content digest,
and hands deduplicated :class:`Publication` records to the
:class:`~tensorflowonspark_tpu_torch.continual.pipeline.ContinualPipeline`.

Atomicity: the unit of publication is one queue message.  A trainer
SIGKILLed mid-export either never enqueued (nothing to collect — the
queue died with the process) or died while the driver was mid-``get``
(a torn wire stream, surfaced as a connection error and discarded).  The
digest is belt-and-braces on top: a payload that does not hash to its
``digest`` field is dropped and counted
(``tfos_continual_publications_total{outcome="corrupt"}``) — a partial
version can never register.

Boot the training cluster with ``queues=CONTINUAL_QUEUES`` so the extra
``publish`` queue exists on every worker.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import logging
import time
from collections.abc import Mapping

import numpy as np

from tensorflowonspark_tpu_torch import metrics as _metrics

logger = logging.getLogger(__name__)

#: the queue the publisher emits on (present when the cluster boots with
#: ``queues=CONTINUAL_QUEUES``)
PUBLISH_QUEUE = "publish"
#: ``TPUCluster.run(queues=...)`` value for a publishing training cluster
CONTINUAL_QUEUES = ("input", "output", "error", PUBLISH_QUEUE)


def _publications_counter():
    return _metrics.get_registry().counter(
        "tfos_continual_publications_total",
        "Checkpoint publications by ingest outcome.",
        labelnames=("outcome",))


def _named_leaves(params, prefix: str = ""):
    """``(name, leaf)`` over a state dict; nested mappings join their keys
    with ``"."``, the state-dict grammar."""
    for key, leaf in params.items():
        name = f"{prefix}{key}"
        if isinstance(leaf, Mapping):
            yield from _named_leaves(leaf, name + ".")
        else:
            yield name, leaf


def _host_array(name: str, leaf) -> np.ndarray:
    """A leaf as a host numpy array that owns its memory (training goes on
    updating the live tensors while the publication waits on its queue)."""
    if hasattr(leaf, "detach"):                   # a torch tensor, on any device
        import torch

        if leaf.dtype == torch.bfloat16:
            raise TypeError(
                f"parameter {name!r} is bfloat16, which numpy cannot hold — "
                "publish the float32 master parameters")
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def flatten_params(params) -> dict[str, np.ndarray]:
    """Host-numpy copy of a state dict keyed by its names
    (``"layers.0.attn.query.weight"``; nested mappings joined with
    ``"."``) — the same key grammar
    :func:`~tensorflowonspark_tpu_torch.serving.rollout.apply_adapter`
    consumes.  Tensors may live on the card; bfloat16 ones raise."""
    return {name: _host_array(name, leaf) for name, leaf in _named_leaves(params)}


def diff_params(base, params, atol: float = 0.0) -> dict[str, np.ndarray]:
    """The adapter delta ``{name: params_leaf - base_leaf}`` restricted to
    leaves that actually changed (beyond ``atol``) — what a
    delta-publishing trainer ships instead of full weights.  The state
    dicts must agree on names and shapes (a delta against the wrong base
    would serve garbage under a fresh version label)."""
    b = flatten_params(base)
    p = flatten_params(params)
    if set(b) != set(p):
        raise ValueError(
            f"diff_params trees disagree on paths: only-base="
            f"{sorted(set(b) - set(p))[:3]} only-params="
            f"{sorted(set(p) - set(b))[:3]}")
    out: dict[str, np.ndarray] = {}
    for path, leaf in p.items():
        if leaf.shape != b[path].shape:
            raise ValueError(f"diff_params shape mismatch at {path!r}: "
                             f"{leaf.shape} vs base {b[path].shape}")
        d = leaf - b[path]
        if d.size and float(np.max(np.abs(d))) > atol:
            out[path] = d
    return out


def payload_digest(payload: dict) -> str:
    """Content hash of a flat ``{path: array}`` payload (sorted paths;
    dtype and shape are hashed too, so a reshaped array never collides)."""
    h = hashlib.sha256()
    for path in sorted(payload):
        arr = np.ascontiguousarray(payload[path])
        h.update(path.encode("utf-8"))
        h.update(str(arr.dtype).encode("ascii"))
        h.update(repr(arr.shape).encode("ascii"))
        h.update(arr.tobytes())
    return h.hexdigest()


def payload_nbytes(payload: dict) -> int:
    return int(sum(np.asarray(a).nbytes for a in payload.values()))


def replace_leaves(params, flat: dict):
    """Rebuild a state dict with leaves REPLACED from a flat ``{name:
    array}`` view (the full-flavor publication applied over the base
    builder's structure): each leaf keeps its base entry's dtype and
    device.  Every name must be present in ``flat`` — a full publication
    that misses leaves would silently serve stale base weights for
    them."""
    def rebuild(tree, prefix):
        out = {}
        for key, leaf in tree.items():
            name = f"{prefix}{key}"
            if isinstance(leaf, Mapping):
                out[key] = rebuild(leaf, name + ".")
                continue
            if name not in flat:
                raise ValueError(f"published full payload misses leaf {name!r}")
            arr = np.asarray(flat[name])
            if tuple(arr.shape) != tuple(np.shape(leaf)):
                raise ValueError(f"published leaf {name!r} has shape "
                                 f"{tuple(arr.shape)}, base structure expects "
                                 f"{tuple(np.shape(leaf))}")
            if hasattr(leaf, "detach"):
                import torch

                out[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(
                    device=leaf.device, dtype=leaf.dtype)
            else:
                out[key] = arr.astype(np.asarray(leaf).dtype, copy=False)
        return out

    return rebuild(params, "")


def build_published_full(args):
    """Worker-side builder for a FULL published version: the base builder
    provides the config and the tree STRUCTURE, the published flat
    payload (``args["serve_published_params"]``) provides every leaf.
    Top level so registry spawn/swap payloads pickle it by reference."""
    cfg, base = args["serve_base_builder"](args)
    return cfg, replace_leaves(base, args["serve_published_params"])


@dataclasses.dataclass
class Publication:
    """One digest-verified candidate as the collector hands it over."""

    model: str
    version: str
    flavor: str              # "adapter" | "full"
    step: int
    payload: dict            # {path: array}: delta (adapter) or all leaves
    serve_args: dict
    metadata: dict
    digest: str
    src: int                 # publishing executor id
    seq: int                 # publisher-local sequence number

    @property
    def nbytes(self) -> int:
        return payload_nbytes(self.payload)


class CheckpointPublisher:
    """Worker-side emit hook: checkpoints become registry candidates.

    Built inside the training ``map_fun``::

        pub = CheckpointPublisher(ctx, "m", base=base_params)
        pub.attach(ckpt_mngr, transform=lambda state: state["params"])

    - ``base=``: a pristine base parameter tree — saves publish
      ``flavor="adapter"`` deltas (:func:`diff_params`), the
      delta-only wire shape the serving tier re-applies over its own
      pristine base.  Without it, saves publish ``flavor="full"``
      (every leaf, applied over the base builder's structure via
      :func:`build_published_full`).
    - Only the CHIEF publishes (every process saves —
      ``torch.distributed.checkpoint`` coordinates the distributed write —
      but one candidate per step must emerge).
    - ``publish`` enqueues exactly ONE message on this worker's own
      queue server: delivery is whole-or-nothing (see module docstring).
    """

    def __init__(self, ctx, model_id: str, *, qname: str = PUBLISH_QUEUE,
                 base=None, version_fmt: str = "step-{step}",
                 serve_args: dict | None = None,
                 metadata: dict | None = None, atol: float = 0.0,
                 timeout: float = 600.0):
        if getattr(ctx, "mgr", None) is None:
            raise RuntimeError(
                "CheckpointPublisher needs the worker queue server "
                "(InputMode.SPARK clusters only)")
        self.ctx = ctx
        self.model_id = str(model_id)
        self.qname = str(qname)
        self.base = base
        self.version_fmt = version_fmt
        self.serve_args = dict(serve_args or {})
        self.metadata = dict(metadata or {})
        self.atol = float(atol)
        self.timeout = float(timeout)
        self._seq = 0
        self._m_pubs = _publications_counter()

    def attach(self, ckpt_manager, transform=None) -> "CheckpointPublisher":
        """Hook this publisher off a
        :class:`~tensorflowonspark_tpu_torch.checkpoint.CheckpointManager`:
        every successful save publishes ``transform(state)`` (default:
        the state itself) as a candidate."""
        def _on_save(step, state):
            params = transform(state) if transform is not None else state
            self.publish(step, params)

        ckpt_manager.add_save_listener(_on_save)
        return self

    def publish(self, step: int, params) -> str | None:
        """Publish ``params`` as the candidate for ``step``; returns the
        version id, or None on a non-chief worker (which publishes
        nothing)."""
        if not self.ctx.is_chief:
            return None
        if self.base is not None:
            payload = diff_params(self.base, params, atol=self.atol)
            flavor = "adapter"
        else:
            payload = flatten_params(params)
            flavor = "full"
        version = self.version_fmt.format(step=int(step))
        msg = {"op": "publish", "model": self.model_id, "version": version,
               "flavor": flavor, "step": int(step), "seq": self._seq,
               "src": int(self.ctx.executor_id),
               "serve_args": dict(self.serve_args),
               "metadata": dict(self.metadata),
               "payload": payload, "digest": payload_digest(payload),
               "nbytes": payload_nbytes(payload), "t": time.time()}
        # ONE atomic enqueue — the whole point (module docstring)
        self.ctx.mgr.queue_put(self.qname, msg, timeout=self.timeout)
        self._m_pubs.inc(outcome="published")
        logger.info("published candidate %s@%s (%s, %d bytes, step %d)",
                    self.model_id, version, flavor, msg["nbytes"],
                    int(step))
        self._seq += 1
        return version


class PublicationCollector:
    """Driver-side drain of every worker's ``publish`` queue.

    Owns its queue clients (one per worker, lazily built from the
    cluster's reservation info — separate from the feed path's cached
    clients so a multi-MB weight stream never serializes behind data
    feeding).  ``poll()`` is non-blocking: it drains whatever is queued,
    digest-verifies, de-duplicates on ``(model, version)``, and treats a
    dead worker (connection error mid-stream — the SIGKILL-mid-export
    case) as "nothing published"."""

    def __init__(self, cluster, qname: str = PUBLISH_QUEUE):
        self.cluster = cluster
        self.qname = str(qname)
        self._clients: dict[int, object] = {}
        self._seen: set[tuple[str, str]] = set()
        self._m_pubs = _publications_counter()

    def _client(self, executor_id: int):
        cli = self._clients.get(executor_id)
        if cli is None:
            from tensorflowonspark_tpu_torch.queues import QueueClient

            info = next(n for n in self.cluster.cluster_info
                        if n["executor_id"] == executor_id)
            meta = self.cluster.cluster_meta
            cli = QueueClient(info["addr"], info["authkey"],
                              shm=meta.get("queue_shm"),
                              bulk=meta.get("queue_bulk"))
            self._clients[executor_id] = cli
        return cli

    def poll(self) -> list[Publication]:
        """Drain available publications from every live worker."""
        out: list[Publication] = []
        for node in sorted(self.cluster.cluster_info,
                           key=lambda n: n["executor_id"]):
            eid = node["executor_id"]
            try:
                cli = self._client(eid)
                # qsize replies ("ERR", ...) unchecked for an unknown
                # queue; normalize to the ValueError the config-error
                # branch below reports
                while int(cli._check_err(cli.qsize(self.qname),
                                         self.qname)) > 0:
                    msg = cli.try_get(self.qname, timeout=1.0)
                    if msg is None:
                        break
                    pub = self._ingest(msg)
                    if pub is not None:
                        out.append(pub)
            except ValueError as e:
                # the server answered but refused: the publish queue does
                # not exist — a config error, not a dead worker
                raise RuntimeError(
                    f"worker {eid} has no {self.qname!r} queue — boot the "
                    "training cluster with queues=CONTINUAL_QUEUES") from e
            except (ConnectionError, EOFError, OSError):
                # dead / mid-crash worker: a torn stream publishes nothing
                # (crash-atomicity); drop the client, recovery respawns
                cli = self._clients.pop(eid, None)
                if cli is not None:
                    with contextlib.suppress(OSError):
                        cli.close()
                continue
        return out

    def _ingest(self, msg) -> Publication | None:
        if not isinstance(msg, dict) or msg.get("op") != "publish":
            logger.warning("collector: non-publication message on %r "
                           "dropped", self.qname)
            return None
        payload = msg.get("payload") or {}
        if payload_digest(payload) != msg.get("digest"):
            self._m_pubs.inc(outcome="corrupt")
            logger.warning("collector: digest mismatch for %s@%s — partial"
                           "/corrupt publication dropped",
                           msg.get("model"), msg.get("version"))
            return None
        key = (str(msg.get("model")), str(msg.get("version")))
        if key in self._seen:
            self._m_pubs.inc(outcome="duplicate")
            return None
        self._seen.add(key)
        self._m_pubs.inc(outcome="accepted")
        return Publication(
            model=key[0], version=key[1],
            flavor=str(msg.get("flavor") or "full"),
            step=int(msg.get("step") or 0), payload=dict(payload),
            serve_args=dict(msg.get("serve_args") or {}),
            metadata=dict(msg.get("metadata") or {}),
            digest=str(msg.get("digest")), src=int(msg.get("src") or -1),
            seq=int(msg.get("seq") or 0))

    def mark_seen(self, model: str, version: str) -> None:
        """Pre-seed the dedupe set (a resumed pipeline marks journaled
        candidates so a re-publishing trainer can't double-ingest)."""
        self._seen.add((str(model), str(version)))

    def close(self) -> None:
        for cli in self._clients.values():
            with contextlib.suppress(OSError):
                cli.close()
        self._clients.clear()
