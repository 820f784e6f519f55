"""Data-parallel training strategy over ``torch.distributed``.

Port of ``tensorflowonspark_tpu/parallel/strategy.py`` (``TrainState``,
``DataParallelStrategy``, its ``MultiWorkerMirroredStrategy`` alias and
the collective helpers).  A user's ``map_fun`` keeps the same shape::

    strategy = MultiWorkerMirroredStrategy(device, seed=0)  # = DataParallelStrategy
    state = strategy.init_state(model, lambda params: torch.optim.AdamW(params, lr))
    step = strategy.build_train_step(loss_fn)
    state, metrics = step(state, strategy.shard_batch(batch))

In JAX the strategy is a mesh plus ``jit`` shardings and XLA inserts the
gradient all-reduce.  Here each process holds a replica of the model
(wrapped in ``DistributedDataParallel`` when the process group has more
than one member) and its own local batch; DDP averages the gradients over
the processes during ``backward``.  Meshes, partition rules and
``FSDPStrategy`` are not ported yet (ROADMAP A6).
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tensorflowonspark_tpu_torch.util import resolve_device


def _world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


@dataclasses.dataclass
class TrainState:
    """Model (a DDP wrapper when the group has more than one process),
    optimizer, step count and extras (e.g. BatchNorm statistics)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    extras: dict = dataclasses.field(default_factory=dict)

    @property
    def module(self) -> nn.Module:
        """The model itself, unwrapped from DDP."""
        return getattr(self.model, "module", self.model)


def step_generator(seed: int, step: int, device, rank: int = 0,
                   micro: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, step, rank, micro)``:
    the counterpart of ``fold_in(key(seed), step)`` (and ``fold_in(..,
    i)`` for microbatch ``i``).  The same tuple gives the same stream; any
    other tuple an independent one.

    JAX draws one step's dropout masks over the global sharded batch, so
    every row's masks are independent; here each process draws for its
    local batch only, so the process's ``rank`` is folded in as well (or
    every replica would repeat the others' masks row for row)."""
    entropy = np.random.SeedSequence([seed, step, rank, micro]).generate_state(
        2, np.uint32)
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(entropy[0]) << 32 | int(entropy[1]))
    return gen


def _signature(loss_fn) -> tuple[bool, bool]:
    """``(takes_extras, takes_rng)`` as the JAX strategy infers them: extras
    only from an explicit third positional parameter named ``extras``
    (unless ``loss_fn.takes_extras`` says), rng from a parameter named
    ``rng``."""
    try:
        params = inspect.signature(loss_fn).parameters
    except (TypeError, ValueError):
        params = {}
    takes_extras = getattr(loss_fn, "takes_extras", None)
    if takes_extras is None:
        plist = list(params.values())
        takes_extras = (
            len(plist) >= 3 and plist[2].name == "extras"
            and plist[2].kind in (inspect.Parameter.POSITIONAL_ONLY,
                                  inspect.Parameter.POSITIONAL_OR_KEYWORD))
    return bool(takes_extras), "rng" in params


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class DataParallelStrategy:
    """Synchronous data parallelism: one model replica per process.

    The reference's ``MultiWorkerMirroredStrategy``.  ``device`` is where
    this process's replica lives (``None``: the card, raising without
    one); ``seed`` is the base of the per-step generators handed to a
    ``loss_fn`` that takes ``rng``.
    """

    def __init__(self, device=None, seed: int = 0):
        self.device = resolve_device(device)
        self.seed = int(seed)

    @property
    def num_replicas_in_sync(self) -> int:
        """tf.distribute parity: the number of processes in the group."""
        return _world_size()

    # -- state -------------------------------------------------------------
    def init_state(self, model_or_fn, optimizer_fn) -> TrainState:
        """Move the model (or the one ``model_or_fn()`` builds) to the
        device, wrap it in ``DistributedDataParallel`` when the process
        group has more than one member, and build the optimizer with
        ``optimizer_fn(parameters)``.  DDP broadcasts rank 0's parameters,
        so every replica starts from the same weights."""
        model = model_or_fn if isinstance(model_or_fn, nn.Module) else model_or_fn()
        model = model.to(self.device)
        if _world_size() > 1:
            cuda = self.device.type == "cuda"
            model = nn.parallel.DistributedDataParallel(
                model, device_ids=[self.device.index if self.device.index is not None
                                   else torch.cuda.current_device()] if cuda else None)
        return TrainState(model=model, optimizer=optimizer_fn(model.parameters()))

    # -- data --------------------------------------------------------------
    def shard_batch(self, batch):
        """This process's batch (numpy arrays or tensors, nested in
        tuples/lists/dicts) as tensors on the device.

        Each process keeps its local batch and DDP averages the gradients
        of the local mean losses.  That is the JAX strategy's gradient of
        the mean over the global sharded batch when every process's batch
        has the same size."""
        def put(x):
            t = torch.from_numpy(np.asarray(x)) if not torch.is_tensor(x) else x
            return t.to(self.device, non_blocking=True)
        return _tree_map(put, batch)

    # -- step --------------------------------------------------------------
    def build_train_step(self, loss_fn, accum_steps: int = 1):
        """``step(state, batch) -> (state, metrics)``.

        ``loss_fn(model, batch) -> loss`` or ``(loss, aux)`` when
        ``loss_fn.has_aux``.  A three-argument ``loss_fn(model, batch,
        extras)`` also receives ``state.extras``; an ``"extras"`` key in
        ``aux`` is written back.  A ``rng`` parameter receives a
        ``torch.Generator`` on the device seeded from ``(seed,
        state.step, rank)`` (:func:`step_generator`), so a resumed run draws
        the same dropout masks and no two replicas draw the same.

        ``accum_steps > 1`` splits the batch's leading dim into that many
        microbatches (microbatch ``i`` gets the generator of ``(seed, step,
        rank, i)``), averages their gradients (DDP's ``no_sync`` for all but the
        last, so the replicas all-reduce once) and makes one optimizer
        step.  ``metrics`` is ``{"loss": mean loss, **aux}`` (the last
        microbatch's aux) with the loss a detached tensor.  The state is
        updated in place and returned.
        """
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        has_aux = getattr(loss_fn, "has_aux", False)
        takes_extras, takes_rng = _signature(loss_fn)
        device, seed = self.device, self.seed

        def one(model, batch, extras, gen):
            args = (model, batch, extras) if takes_extras else (model, batch)
            out = loss_fn(*args, **({"rng": gen} if takes_rng else {}))
            loss, aux = out if has_aux else (out, {})
            if isinstance(aux, dict) and "extras" in aux:
                aux = dict(aux)
                extras = aux.pop("extras")
            return loss, aux, extras

        def split(x):
            if x.shape[0] % accum_steps:
                raise ValueError(f"batch size {x.shape[0]} not divisible by "
                                 f"accum_steps={accum_steps}")
            return x.chunk(accum_steps)

        def step(state: TrainState, batch):
            state.optimizer.zero_grad(set_to_none=True)
            extras = state.extras
            rank = _rank()
            if accum_steps == 1:
                gen = step_generator(seed, state.step, device, rank) if takes_rng else None
                loss, aux, extras = one(state.model, batch, extras, gen)
                loss.backward()
                loss = loss.detach()
            else:
                micro = [_tree_map(lambda x, i=i: split(x)[i], batch)
                         for i in range(accum_steps)]
                total = torch.zeros((), device=device)
                for i, mb in enumerate(micro):
                    gen = (step_generator(seed, state.step, device, rank, i)
                           if takes_rng else None)
                    last = i == accum_steps - 1
                    sync = (contextlib.nullcontext() if last or not hasattr(
                        state.model, "no_sync") else state.model.no_sync())
                    with sync:
                        loss_i, aux, extras = one(state.model, mb, extras, gen)
                        (loss_i / accum_steps).backward()
                    total += loss_i.detach()
                loss = total / accum_steps
            state.optimizer.step()
            state.step += 1
            state.extras = extras
            return state, {"loss": loss, **aux}

        return step


# tf.distribute-parity alias: the strategy name reference users know.
MultiWorkerMirroredStrategy = DataParallelStrategy


def sgd(lr: float, momentum: float = 0.9):
    """``optax.sgd(lr, momentum)`` as ``optimizer_fn``: optax keeps the
    trace ``t = g + momentum * t`` and steps by ``-lr * t``, which is
    ``torch.optim.SGD`` with ``dampening=0`` (the first step's trace is
    the gradient itself in both)."""
    return lambda params: torch.optim.SGD(params, lr=lr, momentum=momentum,
                                          dampening=0.0, nesterov=False)


def adam(lr: float):
    """``optax.adam(lr)`` as ``optimizer_fn``: the same moments, bias
    corrections and eps outside the square root."""
    return lambda params: torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def cross_replica_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean of ``x`` over the process group (all-reduce, then divide by
    the world size); ``x`` itself without a group."""
    world = _world_size()
    if world == 1:
        return x
    y = x.clone()
    dist.all_reduce(y)
    return y / world


def all_gather_batch(x: torch.Tensor) -> torch.Tensor:
    """Every process's ``x`` concatenated on dim 0 in rank order; ``x``
    itself without a group."""
    world = _world_size()
    if world == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts, dim=0)
