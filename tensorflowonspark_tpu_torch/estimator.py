"""Estimator-style training: the ``tf.estimator.train_and_evaluate`` surface.

Port of ``tensorflowonspark_tpu/estimator.py``.  The reference's estimator
example (``examples/mnist/estimator/``) wraps a model in
``tf.estimator.Estimator`` and drives it with
``tf.estimator.train_and_evaluate(est, TrainSpec, EvalSpec)``: a
``model_dir``-centric loop that trains, periodically evaluates,
checkpoints, and resumes from the latest checkpoint on restart.  Here:

- the model is the pair every strategy in :mod:`.parallel.strategy`
  consumes: a module (or a function building one) with ``optimizer_fn``
  for ``init_state``, and ``loss_fn(model, batch[, rng])`` for
  ``build_train_step``, so one definition serves the estimator and the
  lower-level APIs;
- training runs through :class:`~.parallel.strategy.DataParallelStrategy`
  (DDP across the processes of the default group);
- checkpoint/resume is ``torch.distributed.checkpoint`` behind
  ``model_dir`` (:class:`~.checkpoint.CheckpointManager`), restored on
  construction exactly like ``tf.estimator`` resumes from ``model_dir``;
- ``train_and_evaluate`` interleaves train and eval by step budget
  (``EvalSpec.throttle_steps`` ~ the reference's throttle_secs, expressed
  in steps: deterministic).

Usage::

    est = Estimator(model, loss_fn, adam(1e-3), model_dir="/tmp/m",
                    eval_metrics_fn=metrics_fn)
    final = train_and_evaluate(
        est,
        TrainSpec(input_fn=lambda: train_ds, max_steps=1000),
        EvalSpec(input_fn=lambda: eval_ds, steps=10, throttle_steps=200))

The estimator runs on its strategy's device: the card unless the caller
passes ``strategy=DataParallelStrategy("cpu")``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional

import torch

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainSpec:
    """What to train on.  ``input_fn() -> iterable of batches`` (a
    :class:`~.data.Dataset` or any iterable; re-invoked per epoch when the
    iterable is exhausted before ``max_steps``)."""

    input_fn: Callable[[], object]
    max_steps: int


@dataclasses.dataclass
class EvalSpec:
    """How to evaluate.  ``steps`` batches from ``input_fn`` per round;
    a round runs every ``throttle_steps`` train steps (and once at the
    end).

    Early stopping (the ``tf.estimator.experimental.stop_if_no_decrease_
    hook`` analogue): with ``early_stopping_patience=N``, training stops
    after N consecutive eval rounds without ``metric`` improving
    (decreasing when ``higher_is_better=False``, the loss default).
    """

    input_fn: Callable[[], object]
    steps: int = 10
    throttle_steps: int = 100
    early_stopping_patience: int | None = None
    metric: str = "loss"
    higher_is_better: bool = False
    min_delta: float = 0.0

    def __post_init__(self):
        if self.throttle_steps < 1:
            raise ValueError(
                f"throttle_steps must be >= 1, got {self.throttle_steps} "
                "(0 would make train_and_evaluate spin forever)")
        if self.early_stopping_patience is not None \
                and self.early_stopping_patience < 1:
            raise ValueError(
                f"early_stopping_patience must be >= 1, got "
                f"{self.early_stopping_patience}")
        if self.min_delta < 0:
            raise ValueError(
                f"min_delta must be >= 0, got {self.min_delta} (a negative "
                "delta would count degradations as improvements)")


def _is_chief() -> bool:
    """Rank 0 of the default process group, or no group."""
    from tensorflowonspark_tpu_torch.parallel.strategy import _rank

    return _rank() == 0


def _single_process() -> bool:
    from tensorflowonspark_tpu_torch.parallel.strategy import _world_size

    return _world_size() == 1


def _to_host(metrics: dict):
    """Start copying a step's metrics to the host without waiting for the
    step: ``(host metrics, event)``.  On the card each tensor is copied
    into pinned memory behind the step's kernels and ``event`` marks the
    copy's end; elsewhere the event is None (the values are ready)."""
    host, cuda = {}, False
    for k, v in metrics.items():
        if torch.is_tensor(v):
            cuda = cuda or v.is_cuda
            v = v.detach().to("cpu", non_blocking=True)
        host[k] = v
    event = None
    if cuda:
        event = torch.cuda.Event()
        event.record()
    return host, event


def _wait(pending) -> None:
    """Block until ``pending`` (a :func:`_to_host` pair) is on the host."""
    if pending[1] is not None:
        pending[1].synchronize()


class _Apply(torch.nn.Module):
    """``fn(module, *args)`` as a module whose only submodule is ``module``,
    so ``torch.func.functional_call`` can run ``fn`` over other weights
    (prefixed ``inner.``)."""

    def __init__(self, module, fn):
        super().__init__()
        self.inner = module
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.inner, *args)


def _call_with(module, fn, params, *args):
    """``fn(module, *args)`` with ``module``'s weights replaced by the
    state dict ``params`` for this call only."""
    return torch.func.functional_call(
        _Apply(module, fn), {f"inner.{k}": v for k, v in params.items()}, args)


class Estimator:
    """``model_dir``-centric trainer (reference:
    ``tf.estimator.Estimator`` in ``examples/mnist/estimator/``).

    Args:
      model_or_fn: an ``nn.Module``, or ``() -> nn.Module``; moved to the
        strategy's device (``DataParallelStrategy.init_state``).
      loss_fn: ``(model, batch[, rng]) -> scalar`` (or ``(scalar, aux)``
        with ``loss_fn.has_aux = True``) — same contract as
        ``DataParallelStrategy.build_train_step``.
      optimizer_fn: ``parameters -> torch.optim.Optimizer`` (e.g.
        :func:`~.parallel.strategy.adam`).
      model_dir: checkpoint directory; if it holds a checkpoint, training
        resumes from it (the tf.estimator restart contract).
      strategy: a :class:`~.parallel.strategy.DataParallelStrategy`;
        default one on the card.
      eval_metrics_fn: optional ``(model, batch) -> dict`` of scalar
        metrics; defaults to reporting eval loss (``loss_fn(model, batch)``,
        no generator).  Runs under ``torch.no_grad`` with the model in
        eval mode.
      save_every_steps: checkpoint cadence during ``train``.
      handle_preemption: install a :class:`~.preemption.PreemptionGuard`
        around training (default True): SIGTERM — the spot/preemptible
        reclaim warning — finishes the in-flight step, writes a final
        checkpoint, and returns early instead of dying mid-step.
      summary_dir: TensorBoard event-file directory (default
        ``model_dir/tensorboard`` when ``model_dir`` is set; pass "" to
        disable).  Train metrics land under ``train/`` every
        ``log_every_steps`` steps, eval metrics under ``eval/``.
      profile_steps: optional ``(start, stop)`` global-step range traced
        with ``torch.profiler`` into ``summary_dir/plugins/profile`` — the
        trace appears in TensorBoard's profiler plugin (chief only).
      checkpoint_input_state: save the input pipeline's position — (epoch,
        batches consumed) — in a JSON sidecar beside each checkpoint and,
        on resume, skip the already-trained prefix of ``input_fn``'s first
        epoch instead of re-training it (the tf.data iterator-checkpoint
        analogue; exact for deterministic pipelines).  Default True.
        Caveat: the sidecar is also written when a ``train()`` call ends
        normally (the preemption path needs it), but in-process
        continuation (e.g. ``train_and_evaluate``'s next throttle
        segment) intentionally starts ``input_fn`` fresh at batch 0 —
        so a segment that runs after a process restart skips the
        recorded prefix while the same segment in an uninterrupted run
        does not.  Restarted and uninterrupted runs therefore see the
        same steps but a (benignly) different data schedule; pipelines
        that must be restart-invariant should key shuffling on the
        global step rather than the within-epoch position.
      warm_start_from: another model_dir to initialise the MODEL's weights
        from (the ``tf.estimator.WarmStartSettings`` analogue) when
        ``model_dir`` itself holds no checkpoint yet: the donor's latest
        weights are loaded, optimizer state and global step start fresh.
        A resumed job (checkpoint present) ignores it.
    """

    def __init__(self, model_or_fn, loss_fn, optimizer_fn, model_dir: str, *,
                 strategy=None, eval_metrics_fn: Optional[Callable] = None,
                 save_every_steps: int = 100, max_to_keep: int = 5,
                 handle_preemption: bool = True,
                 summary_dir: Optional[str] = None,
                 log_every_steps: int = 10,
                 profile_steps: Optional[tuple] = None,
                 checkpoint_input_state: bool = True,
                 warm_start_from: Optional[str] = None):
        import os

        from tensorflowonspark_tpu_torch.checkpoint import CheckpointManager
        from tensorflowonspark_tpu_torch.observability import GoodputRecorder
        from tensorflowonspark_tpu_torch.parallel.strategy import DataParallelStrategy

        self.strategy = strategy or DataParallelStrategy()
        self.loss_fn = loss_fn
        self.eval_metrics_fn = eval_metrics_fn
        self.model_dir = model_dir
        self.save_every_steps = save_every_steps
        self._goodput = GoodputRecorder()
        with self._goodput.time("init"):
            self._ckpt = CheckpointManager(model_dir, max_to_keep=max_to_keep)
            self._state = self.strategy.init_state(model_or_fn, optimizer_fn)
            latest = self._ckpt.latest_step()
            # Pending restart-resume position {"epoch": int, "batches": int}:
            # consumed by the FIRST epoch of the next train() call.  Only a
            # process restart sets it — in-process train() calls keep the
            # fresh-input_fn-per-call contract (replaying an ever-growing
            # prefix at every eval round would go quadratic).
            self._pending_input_resume = None
            self._ckpt_input_state = checkpoint_input_state
            if latest is not None:
                self._state.load_state_dict(self._ckpt.restore(latest))
                logger.info("estimator: resumed from %s step %d",
                            model_dir, latest)
                if checkpoint_input_state:
                    self._pending_input_resume = self._load_input_state(latest)
            elif warm_start_from:
                with CheckpointManager(warm_start_from) as donor:
                    if donor.latest_step() is None:
                        raise ValueError(
                            f"warm_start_from={warm_start_from!r} holds no "
                            "checkpoint")
                    # no target: tensors on the CPU, so the donor's
                    # OPTIMIZER never has to match this estimator's (the
                    # weights are all we take — fresh optimizer state and
                    # step 0, the tf.estimator warm-start contract);
                    # load_state_dict casts to this model's dtypes
                    self._state.module.load_state_dict(donor.restore()["model"])
                    logger.info("estimator: warm-started the model from %s "
                                "step %d", warm_start_from, donor.latest_step())
        # the step count of the last dispatched step, kept on the host
        self._host_step = int(self._state.step)
        self._train_step = None
        self._eval_step = None
        self._handle_preemption = handle_preemption
        self.log_every_steps = max(1, log_every_steps)
        # TensorBoard scalars, tf.estimator style (events under model_dir —
        # in a subdir so the checkpoint step scan never sees foreign
        # files).  Chief-only: every process of the group would write the
        # same curves.
        if summary_dir is None and model_dir:
            summary_dir = os.path.join(model_dir, "tensorboard")
        self._summary = None
        self._pending_log = None  # (host metrics, event, step), one round late
        self._summary_dir = summary_dir
        self._profile_steps = profile_steps
        self._profiler = None
        if summary_dir and _is_chief():
            from tensorflowonspark_tpu_torch.observability import SummaryWriter

            self._summary = SummaryWriter(summary_dir)

    @property
    def _profiling(self) -> bool:
        return self._profiler is not None

    # ------------------------------------------------------------------
    def _input_state_path(self, step: int) -> str:
        from tensorflowonspark_tpu_torch import filesystem as fsutil

        return fsutil.join(self.model_dir, "input_state", f"{step}.json")

    def _save_input_state(self, step: int, epoch: int, batches: int) -> None:
        """JSON sidecar beside the checkpoint (own subdir so the step scan
        never sees foreign files; works on gs:// via filesystem)."""
        import json

        from tensorflowonspark_tpu_torch import filesystem as fsutil

        if not self._ckpt_input_state or not self.model_dir:
            return
        if not _is_chief():
            return
        path = self._input_state_path(step)
        side_dir = fsutil.join(self.model_dir, "input_state")
        fsutil.makedirs(side_dir)
        with fsutil.open_output(path, "wb") as f:
            f.write(json.dumps({"epoch": epoch, "batches": batches}).encode())
        # prune sidecars whose checkpoints CheckpointManager already dropped
        try:
            keep = set(self._ckpt.all_steps()) | {step}
            for name in fsutil.listdir(side_dir):
                base = name.rsplit("/", 1)[-1]
                if base.endswith(".json") and base[:-5].isdigit() \
                        and int(base[:-5]) not in keep:
                    fsutil.remove(fsutil.join(side_dir, base))
        # best-effort sidecar pruning; fsspec backends raise non-OSErrors
        # and a failed prune must not fail a save
        except Exception:
            pass

    def _load_input_state(self, step: int):
        import json

        from tensorflowonspark_tpu_torch import filesystem as fsutil

        try:
            with fsutil.open_file(self._input_state_path(step), "rb") as f:
                state = json.loads(f.read().decode())
            logger.info("estimator: input pipeline resumes at epoch %d, "
                        "batch %d", state["epoch"], state["batches"])
            return state
        except (OSError, ValueError, KeyError):
            return None

    @property
    def global_step(self) -> int:
        return self._host_step

    @property
    def params(self) -> dict:
        """The model's state dict (the live tensors)."""
        return self._state.module.state_dict()

    def train(self, input_fn, max_steps: int) -> int:
        """Train until ``global_step == max_steps`` (tf.estimator's
        ``max_steps`` semantics: a budget on the TOTAL step count, so a
        resumed job does only the remainder).

        With ``handle_preemption`` (default), SIGTERM finishes the
        in-flight step, writes a final checkpoint, and returns early; a
        relaunched job resumes from it.
        """
        import contextlib
        import time

        from tensorflowonspark_tpu_torch.data import CheckpointableIterator, device_prefetch
        from tensorflowonspark_tpu_torch.preemption import PreemptionGuard

        if self._train_step is None:
            self._train_step = self.strategy.build_train_step(self.loss_fn)
        guard = PreemptionGuard() if self._handle_preemption else None
        _END = object()
        prev = None  # the previous step's metrics on their way to the host
        epoch, batches = 0, 0  # input position within THIS train call
        resumed_skip = False  # this epoch began with a restart-resume skip
        entered = False  # loop ran at all (else the sidecar must survive)
        with guard if guard is not None else contextlib.nullcontext():
            while self._host_step < max_steps:
                entered = True
                made_progress = False
                # device_prefetch keeps transfers ahead of compute; epoch
                # setup (input_fn itself) is data badput too
                with self._goodput.time("data"):
                    base = iter(input_fn())
                    if self._pending_input_resume is not None:
                        # restart resume: skip this epoch's already-trained
                        # prefix (deterministic replay; counted in "data")
                        resume = self._pending_input_resume
                        self._pending_input_resume = None  # first epoch only
                        epoch = int(resume.get("epoch", 0))
                        skip = int(resume.get("batches", 0))
                        base = CheckpointableIterator(
                            base, {"elements_consumed": skip})
                        batches = base.position  # < skip if source shrank
                        resumed_skip = skip > 0
                    it = device_prefetch(base, depth=2, device=self.strategy.device)
                while True:
                    with self._goodput.time("data"):
                        b = next(it, _END)
                    if b is _END or self._host_step >= max_steps or \
                            (guard is not None and guard.preempted):
                        break
                    self._maybe_profile(start=True)
                    with self._goodput.time("step"):
                        # dispatch step k, then wait for step k-1's metrics:
                        # device time lands in "step" while one step of
                        # pipelining (and the prefetch overlap) survives
                        self._state, metrics = self._train_step(self._state, b)
                        pending = _to_host(metrics)
                        if prev is not None:
                            _wait(prev)
                        prev = pending
                    self._host_step += 1
                    batches += 1  # executed batches, not prefetched pulls
                    self._maybe_profile(start=False)
                    made_progress = True
                    if self._host_step % self.save_every_steps == 0:
                        with self._goodput.time("checkpoint"):
                            self._ckpt.save(self._host_step, self._state.state_dict())
                            self._save_input_state(self._host_step,
                                                   epoch, batches)
                    if self._summary is not None and \
                            self._host_step % self.log_every_steps == 0:
                        # write the PREVIOUS boundary's metrics (on the host
                        # by now) and stash this one's: reading the step
                        # just dispatched would stall the pipeline
                        if self._pending_log is not None:
                            self._flush_log()
                        self._pending_log = (*pending, self._host_step)
                if guard is not None and guard.preempted:
                    logger.warning("estimator: preempted at step %d; saving "
                                   "and stopping", self._host_step)
                    break
                if not made_progress and not resumed_skip:
                    raise ValueError("input_fn yielded no batches")
                # a resume skip that consumed the whole epoch (checkpoint
                # fell on an epoch boundary) rolls to the next epoch
                resumed_skip = False
                if self._host_step < max_steps:  # epoch exhausted: next one
                    epoch, batches = epoch + 1, 0
        if prev is not None:
            t0 = time.monotonic()
            _wait(prev)  # drain the pipeline
            # the drain is the LAST step's device time, not an extra step
            self._goodput.record("step", time.monotonic() - t0, count=False)
        if self._profiling:
            # training ended (or was preempted) inside the profile window
            self._stop_profile()
        if self._pending_log is not None:
            self._flush_log()
        with self._goodput.time("checkpoint"):
            self._ckpt.save(self._host_step, self._state.state_dict())
            if entered:
                # zero-step calls (target already reached) must not clobber
                # the saved position with this call's unused local zeros
                self._save_input_state(self._host_step, epoch, batches)
            self._ckpt.wait()
        return self._host_step

    def _flush_log(self) -> None:
        host, event, step = self._pending_log
        self._pending_log = None
        _wait((host, event))
        self._write_scalars("train", host, step)

    def evaluate(self, input_fn, steps: int | None = None) -> dict:
        """Mean metrics over ``steps`` batches (all batches when None),
        under ``torch.no_grad`` with the model in eval mode (restored
        afterwards).  In a process group the means are averaged over the
        processes, so every process sees the same metrics."""
        from tensorflowonspark_tpu_torch.parallel.strategy import cross_replica_mean

        if self._eval_step is None:
            metrics_fn = self.eval_metrics_fn
            if metrics_fn is None:
                def metrics_fn(model, batch):
                    out = self.loss_fn(model, batch)
                    loss = out[0] if isinstance(out, tuple) else out
                    return {"loss": loss}
            self._eval_step = metrics_fn
        module = self._state.module
        was_training = module.training
        module.eval()
        totals: dict = {}
        n = 0
        try:
            with torch.no_grad():
                for batch in input_fn():
                    if steps is not None and n >= steps:
                        break
                    m = self._eval_step(module, self.strategy.shard_batch(batch))
                    for k, v in m.items():
                        totals[k] = totals.get(k, 0.0) + float(v)
                    n += 1
        finally:
            module.train(was_training)
        if n == 0:
            raise ValueError("eval input_fn yielded no batches")
        out = {k: v / n for k, v in totals.items()}
        if not _single_process():
            keys = sorted(out)
            mean = cross_replica_mean(torch.tensor(
                [out[k] for k in keys], dtype=torch.float64, device=self.strategy.device))
            out = dict(zip(keys, mean.tolist()))
        if self._summary is not None:
            self._write_scalars("eval", out)
        out["global_step"] = self.global_step
        return out

    def export(self, export_dir: str, serve_fn, example_inputs,
               is_chief: bool = True, **export_kwargs) -> str | None:
        """Write a serving export of the trained model (the tf.estimator
        ``export_saved_model`` step, chief-only).

        ``serve_fn(model, *inputs)`` is the inference function —
        typically ``lambda m, x: m(x)`` — traced with ``torch.export`` over
        the model's state dict via :func:`~.checkpoint.export_model`, so
        ``TFModel`` can serve it with no model code.
        """
        from tensorflowonspark_tpu_torch.checkpoint import export_model

        module = self._state.module
        with self._goodput.time("checkpoint"):
            return export_model(
                export_dir, lambda p, *xs: _call_with(module, serve_fn, p, *xs),
                self.params, example_inputs, is_chief=is_chief, **export_kwargs)

    def _maybe_profile(self, start: bool) -> None:
        """Start/stop ``torch.profiler`` at the configured step range."""
        if self._profile_steps is None or self._summary is None:
            return
        lo, hi = self._profile_steps
        if start and not self._profiling and self._host_step == lo:
            import os

            from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

            trace_dir = os.path.join(self._summary_dir, "plugins", "profile")
            activities = [ProfilerActivity.CPU]
            if self.strategy.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=activities,
                                     on_trace_ready=tensorboard_trace_handler(trace_dir))
            self._profiler.start()
            logger.info("estimator: profiling steps %d..%d", lo, hi)
        elif not start and self._profiling and self._host_step >= hi:
            self._stop_profile()

    def _stop_profile(self) -> None:
        if self.strategy.device.type == "cuda":
            torch.cuda.synchronize(self.strategy.device)
        self._profiler.stop()
        self._profiler = None

    def goodput(self) -> dict:
        """Badput accounting for this estimator's lifetime: wall time split
        into init, data waits, productive step time, checkpoint stalls,
        and idle."""
        return self._goodput.summary()

    def predict(self, input_fn, predict_fn=None, *, params=None):
        """Yield per-batch predictions (tf.estimator's ``predict``).

        ``predict_fn(model, batch) -> predictions`` is the forward
        function (a missing ``predict_fn`` raises: metrics aren't
        predictions).  Batches go to the strategy's device; outputs come
        back as host numpy (nested as returned), one yield per input
        batch, computed under ``torch.no_grad``.

        ``params`` overrides the trained weights for this call only — a
        grid-search trial's candidate, averaged weights, or a donor
        checkpoint — without touching the estimator's state: a state dict
        of the model's names (those it lacks keep the trained values).

        Input waits land in :meth:`goodput` under ``data`` and device
        time under ``step``, exactly like ``train``.
        """
        from tensorflowonspark_tpu_torch.data import _tree_map

        if predict_fn is None:
            raise ValueError("predict needs predict_fn(model, batch)")
        module = self._state.module
        _END = object()
        with self._goodput.time("data"):
            it = iter(input_fn())
        while True:
            with self._goodput.time("data"):
                batch = next(it, _END)
            if batch is _END:
                return
            with self._goodput.time("step"), torch.no_grad():
                batch = self.strategy.shard_batch(batch)
                out = (predict_fn(module, batch) if params is None
                       else _call_with(module, predict_fn, params, batch))
                host = _tree_map(lambda t: t.detach().cpu().numpy()
                                 if torch.is_tensor(t) else t, out)
            yield host

    def _write_scalars(self, prefix: str, metrics: dict,
                       step: int | None = None) -> None:
        scalars = {}
        for k, v in metrics.items():
            try:
                scalars[f"{prefix}/{k}"] = float(v)
            except (TypeError, ValueError, RuntimeError):
                continue  # non-scalar aux (arrays etc.) aren't curve data
        if scalars:
            self._summary.scalars(
                scalars, self._host_step if step is None else step)

    def close(self) -> None:
        if self._summary is not None:
            self._summary.close()
        self._ckpt.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def train_and_evaluate(estimator: Estimator, train_spec: TrainSpec,
                       eval_spec: EvalSpec) -> dict:
    """Interleaved train/eval loop (reference:
    ``tf.estimator.train_and_evaluate``): train ``throttle_steps``, eval,
    repeat until ``max_steps``, with a final eval.  Returns the last eval
    metrics.  Restart-safe: a relaunched job resumes from ``model_dir``'s
    latest checkpoint and completes only the remaining budget."""
    import contextlib
    import json

    from tensorflowonspark_tpu_torch import filesystem as fsutil
    from tensorflowonspark_tpu_torch import preemption
    from tensorflowonspark_tpu_torch.preemption import PreemptionGuard

    # Guard the WHOLE loop, not just train(): a SIGTERM landing during an
    # eval round must latch too, not hit the default handler and kill us.
    guard = PreemptionGuard() if estimator._handle_preemption else None
    metrics: dict = {}
    best, stale = None, 0
    sign = 1.0 if eval_spec.higher_is_better else -1.0
    # Early-stop state survives restarts (tf.estimator's hook reads eval
    # event files; here a JSON sidecar in model_dir): patience does not
    # reset on relaunch, and a run that already stopped stays stopped.
    # Multi-process runs skip the sidecar: a per-host file read that can
    # fail on one host but not another would diverge the processes'
    # control flow (mismatched collectives -> hang).  In-memory patience
    # still works; only restart persistence is single-process.
    es_path = None
    if eval_spec.early_stopping_patience is not None and estimator.model_dir:
        if _single_process():
            es_path = fsutil.join(estimator.model_dir, "early_stop",
                                  "state.json")  # own subdir: the step
            # scan must never see foreign files in model_dir itself
        else:
            logger.info("estimator: early-stop state not persisted in "
                        "multi-process runs (restart resets patience)")
    es_cfg = [eval_spec.metric, eval_spec.higher_is_better,
              eval_spec.min_delta]
    if es_path and estimator.global_step > 0:
        try:
            with fsutil.open_file(es_path, "rb") as f:
                saved = json.loads(f.read().decode())
            if not isinstance(saved, dict) or saved.get("config") != es_cfg:
                saved = None  # different metric/direction: start fresh
        # best-effort resume state: fsspec raises non-OSErrors too; a
        # corrupt sidecar just restarts the count
        except Exception:
            saved = None
        if saved:
            best, stale = saved.get("best"), int(saved.get("stale", 0))
            if saved.get("stopped"):
                logger.info("estimator: early stop already latched at step "
                            "%d; skipping training", saved.get("step"))
                return estimator.evaluate(eval_spec.input_fn, eval_spec.steps)

    def save_es(stopped: bool) -> None:
        if es_path is None:
            return
        try:
            fsutil.makedirs(fsutil.join(estimator.model_dir, "early_stop"))
            with fsutil.open_output(es_path, "wb") as f:
                f.write(json.dumps(
                    {"best": best, "stale": stale, "stopped": stopped,
                     "step": estimator.global_step,
                     "config": es_cfg}).encode())
        # best-effort persistence of the early-stop latch; losing it never
        # kills a training run
        except Exception:
            pass
    with guard if guard is not None else contextlib.nullcontext():
        while estimator.global_step < train_spec.max_steps:
            target = min(estimator.global_step + eval_spec.throttle_steps,
                         train_spec.max_steps)
            estimator.train(train_spec.input_fn, target)
            if preemption.is_preempted():
                # checkpoint is written; the grace window is for exiting,
                # not for one more eval round
                logger.warning("estimator: preempted; skipping further "
                               "train/eval rounds")
                return metrics
            metrics = estimator.evaluate(eval_spec.input_fn, eval_spec.steps)
            logger.info("estimator: step %d eval %s", estimator.global_step,
                        {k: round(v, 4) for k, v in metrics.items()})
            if eval_spec.early_stopping_patience is not None:
                if eval_spec.metric not in metrics:
                    raise ValueError(
                        f"EvalSpec.metric {eval_spec.metric!r} not in eval "
                        f"metrics {sorted(metrics)} — set eval_metrics_fn "
                        "or pick one of these keys")
                score = sign * float(metrics[eval_spec.metric])
                if best is None or score > best + eval_spec.min_delta:
                    best, stale = score, 0
                else:
                    stale += 1
                if stale >= eval_spec.early_stopping_patience:
                    logger.info(
                        "estimator: early stop at step %d — %r did not "
                        "improve for %d eval rounds",
                        estimator.global_step, eval_spec.metric, stale)
                    save_es(stopped=True)
                    return metrics
                save_es(stopped=False)
        if not metrics:
            # resumed already at (or past) max_steps: the promised final
            # eval still happens
            metrics = estimator.evaluate(eval_spec.input_fn, eval_spec.steps)
    return metrics
